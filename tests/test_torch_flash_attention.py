"""Kernel 3's plain version against the JAX package's flash-attention
forward kernel in interpret mode: causal GQA, f32, on ``out`` and the
logsumexp rows.  The CUDA kernel runs only on the card (``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitorch_engine_tpu.ops.pallas.flash_attention import _fwd_call
from bitorch_engine_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_ref,
)


def _inputs(b, nh, nkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, nh, s, d), (b, nkv, s, d), (b, nkv, s, d))]


def _pallas(q, k, v, causal):
    """The JAX forward kernel as its public wrapper calls it (d zero-padded
    to 128 lanes, batch folded into heads); lse read from lane 0."""
    b, nh, s, d = q.shape
    nkv = k.shape[1]
    pad = ((0, 0), (0, 0), (0, 0), (0, 128 - d))
    qp, kp, vp = (jnp.pad(jnp.asarray(a), pad) for a in (q, k, v))
    out, lse = _fwd_call(
        qp.reshape(b * nh, s, 128), kp.reshape(b * nkv, s, 128), vp.reshape(b * nkv, s, 128),
        causal=causal, sm_scale=1.0 / math.sqrt(d), bq=128, bk=128, interpret=True,
    )
    return (np.asarray(out).reshape(b, nh, s, 128)[..., :d],
            np.asarray(lse)[..., 0].reshape(b, nh, s))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_forward(causal):
    """Tolerances of the JAX kernel test: the two sum in another order."""
    q, k, v = _inputs(1, 4, 2, 256, 64)
    want_out, want_lse = _pallas(q, k, v, causal)
    out, lse = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), want_out, atol=3e-6, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 1, 128, 32, seed=1))
    out, lse = flash_attention(q, k, v, causal=True, sm_scale=0.3)
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal=True, sm_scale=0.3)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_attention.launches == 0


def test_rejects_mismatched_heads():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 3, 2, 128, 64))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
