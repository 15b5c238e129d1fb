"""Kernel 3's plain version against the JAX package's flash-attention
forward kernel in interpret mode: causal GQA on ``out`` and the logsumexp
rows, in f32 (the algorithm) and in bf16 (where ``p`` rounds to bf16 against
the running max of the reference's key tile).  The CUDA kernel runs only on
the card (``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops.pallas.flash_attention import _fwd_call, _pick_block
from bitorch_engine_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_ref,
    pick_block,
)


def _inputs(b, nh, nkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, nh, s, d), (b, nkv, s, d), (b, nkv, s, d))]


def _pallas(q, k, v, causal, block=128, dtype=jnp.float32):
    """The JAX forward kernel as its public wrapper calls it (d zero-padded
    to 128 lanes, batch folded into heads, ``bq = bk = block``); out as
    f32, lse read from lane 0."""
    b, nh, s, d = q.shape
    nkv = k.shape[1]
    pad = ((0, 0), (0, 0), (0, 0), (0, 128 - d))
    qp, kp, vp = (jnp.pad(jnp.asarray(a, dtype), pad) for a in (q, k, v))
    out, lse = _fwd_call(
        qp.reshape(b * nh, s, 128), kp.reshape(b * nkv, s, 128), vp.reshape(b * nkv, s, 128),
        causal=causal, sm_scale=1.0 / math.sqrt(d), bq=block, bk=block, interpret=True,
    )
    return (np.asarray(out.astype(jnp.float32)).reshape(b, nh, s, 128)[..., :d],
            np.asarray(lse)[..., 0].reshape(b, nh, s))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_forward(causal):
    """Tolerances of the JAX kernel test: the two sum in another order."""
    q, k, v = _inputs(1, 4, 2, 256, 64)
    want_out, want_lse = _pallas(q, k, v, causal)
    out, lse = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), want_out, atol=3e-6, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s", [128, 256, 384, 512, 1024, 2048, 2560])
def test_pick_block_is_the_reference_rule(s):
    assert pick_block(s) == _pick_block(s)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_k", [None, 128])
def test_bf16_plain_rounds_p_where_jax_rounds(causal, block_k):
    """bf16, as the model runs: the plain version against the JAX forward
    kernel on the same bf16 inputs, at the model's tile rule (s 256: one
    256-key tile) and at 128-key tiles (two tiles, so the running max moves
    between them).  Both round ``p`` to bf16 against the tile's running max,
    so only f32 summation order differs, which moves a few elements by one
    bf16 step: at most 1% of the elements differ and max|d|/max|ref| <= 4e-3
    (one bf16 step of the largest).  With the cast left out ~35% differ."""
    q, k, v = _inputs(1, 4, 2, 256, 64, seed=11)
    want_out, want_lse = _pallas(q, k, v, causal, block=block_k or _pick_block(256),
                                 dtype=jnp.bfloat16)
    out, lse = flash_attention_ref(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                   causal=causal, block_k=block_k)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = out.float().numpy()
    differing = np.mean(got != want_out)
    rel = np.abs(got - want_out).max() / np.abs(want_out).max()
    assert differing <= 1e-2 and rel <= 4e-3, (differing, rel)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 1, 128, 32, seed=1))
    out, lse = flash_attention(q, k, v, causal=True, sm_scale=0.3)
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal=True, sm_scale=0.3)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_attention.launches == 0


def test_rejects_a_block_that_does_not_divide_the_sequence():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 256, 64))
    with pytest.raises(ValueError, match="does not divide"):
        flash_attention(q, k, v, block_k=96)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        flash_attention_ref(q[:, :, :192], k[:, :, :192], v[:, :, :192])


def test_rejects_mismatched_heads():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 3, 2, 128, 64))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
