"""Act-order GPTQ tensors through the port's MPQ linear, against the JAX
package.

A checkpoint exported with ``desc_act`` is canonicalized at ingest
(``q_perm`` set, rows stored sorted by group).  The port's routes, chosen up
front from the tensor (``ops.mpq_linear.mpq_route``): kernels 1 and 5 on the
stored rows after a gather of the activations, kernel 2 on the stored rows
followed by a scatter back by ``q_perm``, and for a ragged ``g_idx`` the
plain dequantize.  On the CPU the wrappers run their plain versions; the
results are held against the JAX package's Pallas kernel in interpret mode
and its XLA path at the tolerances of ``tests/test_ingest_checkpoint.py``
(rtol 2e-3, atol 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import mpq_linear as jlin
from bitorch_engine_tpu.ops import packing as jpacking
from bitorch_engine_tpu.ops import quant as jquant
from bitorch_engine_tpu.ops.pallas.dequant_matmul import mpq_matmul_pallas, relayout_tpu
from bitorch_engine_tpu.utils import ingest as jingest
from bitorch_engine_tpu_torch.ops import mpq_linear as tlin
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as tdm
from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import mpq_matmul, prepare_for_kernel
from bitorch_engine_tpu_torch.ops.quant import concat_mpq, dequantize_mpq
from bitorch_engine_tpu_torch.qtensor import MPQTensor
from bitorch_engine_tpu_torch.utils import ingest as tingest

K, N, GS, WB = 512, 256, 128, 4
TOL = dict(rtol=2e-3, atol=5e-4)


def _act_order(seed=3, ragged=False):
    """An act-order GPTQ export of an RTN-quantized weight (as
    ``test_act_order_gptq_reaches_fused_kernel`` makes it), ingested by both
    packages; ``ragged`` gives group 0 four rows more than the others."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    base = jquant.quantize_mpq(jnp.asarray(w), w_bit=WB, group_size=GS, asym=True)
    if ragged:
        g_idx = np.repeat(np.arange(K // GS), GS).astype(np.int32)
        g_idx[GS : GS + 4] = 0
        g_idx = rng.permutation(g_idx).astype(np.int32)
    else:
        g_idx = rng.permutation(np.arange(K) // GS).astype(np.int32)
    order = np.argsort(g_idx, kind="stable")
    codes = np.asarray(jpacking.unpack_rows(base.packed, WB))
    shuffled = np.empty_like(codes)
    shuffled[order] = codes
    tensors = (np.asarray(jpacking.pack_rows(jnp.asarray(shuffled), WB)), np.asarray(base.zeros),
               np.asarray(base.scales), g_idx)
    ref = jingest.mpq_from_gptq(*tensors, w_bit=WB, group_size=GS)
    got = tingest.mpq_from_gptq(*tensors, w_bit=WB, group_size=GS, device="cpu")
    return ref, got, rng


def _x(rng, m):
    return rng.standard_normal((m, K)).astype(np.float32)


def test_kernel1_route_matches_pallas_interpret():
    """m 8: the port's linear and its kernel-1 route (gather, then the
    kernel's plain version on the stored rows) against the Pallas kernel."""
    ref, qt, rng = _act_order()
    assert qt.q_perm is not None and qt.g_idx is None
    x = _x(rng, 8)
    want = np.asarray(mpq_matmul_pallas(jnp.asarray(x), ref, interpret=True))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tlin.mpq_linear(xt, qt).numpy(), want, **TOL)
    kform = prepare_for_kernel(qt)
    routed = mpq_matmul(tlin._gather(xt, kform), tlin._stored(kform))
    np.testing.assert_allclose(routed.numpy(), want, **TOL)


def test_reconstruct_route_matches_xla_path():
    """m 1024 (past both kernels' rows): the weight reconstructed, then
    ``torch.matmul``, against the JAX package's XLA path."""
    ref, qt, rng = _act_order(seed=4)
    x = _x(rng, 1024)
    want = np.asarray(jlin.mpq_linear(jnp.asarray(x), ref))
    assert tlin.mpq_route(qt, 1024, "cuda") == "reconstruct"
    np.testing.assert_allclose(tlin.mpq_linear(torch.from_numpy(x), qt).numpy(), want, **TOL)


def test_a8_route_matches_jax():
    """m 8 in the A8 regime (bf16 metadata): the gathered activations through
    kernel 5's plain version on the stored rows, against the JAX package's
    XLA simulation and its Pallas kernel in interpret mode."""
    ref, qt, rng = _act_order(seed=5)
    x = _x(rng, 8)
    jq = relayout_tpu(ref, meta_dtype=jnp.bfloat16, act_bits=8)
    tq = prepare_for_kernel(qt, torch.bfloat16, act_bits=8)
    assert tq.act_bits == 8 and tq.q_perm is not None
    counts = dict(tlin.act_order_counts)
    got = tlin.mpq_linear(torch.from_numpy(x), tq).numpy()
    assert tlin.act_order_counts["gather"] == counts["gather"] + 1
    np.testing.assert_allclose(got, np.asarray(jlin.mpq_linear(jnp.asarray(x), jq)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(mpq_matmul_pallas(jnp.asarray(x), jq, interpret=True)), **TOL)


def test_ragged_g_idx_takes_the_plain_route():
    ref, qt, rng = _act_order(seed=6, ragged=True)
    assert qt.g_idx is not None and qt.q_perm is None
    assert tlin.mpq_route(qt, 8, "cuda") == "reconstruct"
    assert tlin.mpq_route(qt.replace(act_bits=8), 8, "cuda") == "a8_plain"
    x = _x(rng, 8)
    plain = tlin.act_order_counts["plain"]
    got = tlin.mpq_linear(torch.from_numpy(x), qt).numpy()
    assert tlin.act_order_counts["plain"] == plain + 1
    np.testing.assert_allclose(got, np.asarray(jlin.mpq_linear(jnp.asarray(x), ref)), **TOL)


@pytest.mark.parametrize(
    "act_bits, m, device, act_order, route",
    [
        (16, 1, "cuda", "q_perm", "a16"),
        (16, 64, "cuda", "q_perm", "a16"),
        (16, 65, "cuda", "q_perm", "reconstruct"),
        (16, 8, "cpu", "q_perm", "reconstruct"),
        (8, 512, "cuda", "q_perm", "a8"),
        (8, 513, "cuda", "q_perm", "reconstruct"),
        (8, 8, "cpu", "q_perm", "a8"),
        (16, 8, "cuda", "g_idx", "reconstruct"),
        (8, 8, "cuda", "g_idx", "a8_plain"),
        (8, 600, "cuda", "g_idx", "reconstruct"),
    ],
)
def test_routes_follow_the_jax_branch_rules(act_bits, m, device, act_order, route):
    perm = torch.arange(K, dtype=torch.int32)
    qt = MPQTensor(packed=torch.zeros(K // 8, N, dtype=torch.int32), scales=torch.ones(4, N),
                   zeros=torch.zeros(4, N), w_bit=4, group_size=GS, act_bits=act_bits,
                   **{act_order: perm})
    assert tlin.mpq_route(qt, m, device) == route


def test_card_reconstruction_scatters_kernel2_rows(monkeypatch):
    """The card's route of kernel 2 (stood in for by its plain version,
    which checks what the kernel checks): one call on the tensor with its
    ``q_perm``, whose rows the kernel writes back in place, gives the plain
    dequantize bit for bit; a ragged tensor skips the kernel."""
    _, qt, _ = _act_order(seed=7)
    _, ragged, _ = _act_order(seed=8, ragged=True)
    qt = prepare_for_kernel(qt)
    calls = []

    def kernel2(t, dtype, exact_asym=False):
        tdm._check_dequant(t, torch.device("cpu"))
        assert t.q_perm is not None and t.g_idx is None
        calls.append(t)
        return tdm.dequant_mpq_ref(t, dtype, exact_asym)

    monkeypatch.setattr(tlin, "dequant_mpq", kernel2)
    monkeypatch.setattr(MPQTensor, "device", property(lambda self: torch.device("cuda")))
    before = dict(tlin.act_order_counts)
    w = tlin.reconstruct_weight(qt, torch.float32)
    assert torch.equal(w, dequantize_mpq(qt, torch.float32)) and len(calls) == 1
    assert tlin.act_order_counts["scatter"] == before["scatter"] + 1
    w = tlin.reconstruct_weight(ragged, torch.float32)
    assert torch.equal(w, dequantize_mpq(ragged, torch.float32)) and len(calls) == 1
    assert tlin.act_order_counts["plain"] == before["plain"] + 1


def test_kernels_refuse_act_order_tensors():
    """``_check_weight`` (kernels 1, 5 and 7) raises for a tensor that still
    carries ``q_perm`` or ``g_idx``, kernel 2's check for a ``g_idx``;
    ``concat_mpq`` refuses act-order parts (they load unfused)."""
    _, qt, _ = _act_order(seed=9)
    _, ragged, _ = _act_order(seed=10, ragged=True)
    for t in (prepare_for_kernel(qt), prepare_for_kernel(ragged)):
        with pytest.raises(ValueError, match="q_perm"):
            tdm._check_weight(t, torch.device("cpu"))
    tdm._check_weight(tlin._stored(prepare_for_kernel(qt)), torch.device("cpu"))
    tdm._check_dequant(prepare_for_kernel(qt), torch.device("cpu"))
    with pytest.raises(ValueError, match="g_idx"):
        tdm._check_dequant(prepare_for_kernel(ragged), torch.device("cpu"))
    with pytest.raises(ValueError, match="act-order"):
        concat_mpq([qt, qt])


def test_backward_matches_jax_vjp():
    """The input gradient of an act-order linear reconstructs the logical
    weight (the scatter route), as ``jax.vjp`` of the JAX linear."""
    ref, qt, rng = _act_order(seed=11)
    x, g = _x(rng, 8), rng.standard_normal((8, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jlin.mpq_linear(a, ref), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    tlin.mpq_linear(xt, qt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
