"""Asym MPQ tensors on the card's kernel routes, against the JAX package.

On the card an asym tensor computes the JAX package's TPU arithmetic
(``mpq_matmul_pallas`` / ``dequant_mpq_pallas`` through ``relayout_tpu``:
``zeros = (s · z) in the scales' dtype``, ``w = q·s − zeros``): kernels 1
and 5 run its stored rows rewritten on the fly (``_kernel_form``:
``prepare_for_kernel``'s asym→sym rewrite), and kernel 2 receives the asym
tensor itself, ``q_perm`` and all, and reads its packed zeros in that form.
Here the kernels' plain versions stand in for them, fed what the card's
routes feed the kernels, and each is held **bit for bit** to the JAX
package's ``dequantize_mpq(relayout_tpu(qt))``, for w 2/4/8, with and
without ``q_perm``:

* kernel 2's route (``reconstruct_weight``: one call on the asym tensor,
  its rows written back through ``q_perm``);
* kernel 1's plain version on the gathered activations and the kernel form;
* kernel 5's plain version (the A8 regime; an 8-bit tensor takes kernel
  1, the A16 branch its TPU kernel runs).

The JAX package's Pallas dequant kernel in interpret mode (no ``q_perm``:
it refuses one) reads the same weight: its distance to the port's kernel
form is printed and held within ``PALLAS_REL`` of its largest element (its
TPU layouts fold a bias into the zeros, one rounding more).  A symmetric gptq
tensor passes the rewrite untouched (no ``prepare_for_kernel`` call, no
``torch.equal`` host sync), kernel 2's route rewrites nothing, and
``_check_weight`` still refuses an asym tensor handed to kernels 1 and 5
directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import quant as jquant
from bitorch_engine_tpu.ops.pallas.dequant_matmul import dequant_mpq_pallas, relayout_tpu
from bitorch_engine_tpu_torch.ops import mpq_linear as tlin
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as tdm
from bitorch_engine_tpu_torch.ops.cuda.quad_matmul import mpq_matmul_a8_ref, quantize_activations_ref
from bitorch_engine_tpu_torch.ops.quant import dequantize_mpq
from bitorch_engine_tpu_torch.qtensor import MPQTensor
from bitorch_engine_tpu_torch.utils.convert import _mpq

K, N, GS, M = 512, 128, 128, 8
# the Pallas kernel's TPU layouts fold a bias into the zeros (the pair
# layout's 128 · s) and round once more: w2 1.8e-6, w4 5.8e-7, w8 0 relative
PALLAS_REL = 1e-5


def _pair(w_bit, perm, act_bits=16, seed=0):
    """One asym tensor in both packages (``perm``: give it a ``q_perm``)."""
    rng = np.random.default_rng(seed + w_bit)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    jqt = jquant.quantize_mpq(jnp.asarray(w), w_bit=w_bit, group_size=GS, asym=True)
    if perm:
        jqt = jqt.replace(q_perm=jnp.asarray(rng.permutation(K).astype(np.int32)))
    jqt = jqt.replace(act_bits=act_bits)
    return jqt, _mpq(jqt, "cpu"), rng


def _jax_weight(jqt):
    """The TPU's arithmetic: ``dequantize_mpq(relayout_tpu(qt))`` in f32,
    logical rows."""
    return torch.from_numpy(np.asarray(jquant.dequantize_mpq(relayout_tpu(jqt), dtype=jnp.float32)))


def _stored_rows(w, qt):
    return w if qt.q_perm is None else w[qt.q_perm.long()]


@pytest.fixture
def on_card(monkeypatch):
    """The card's kernel-2 route with its plain version in the kernel's
    place (which checks what the kernel checks)."""
    calls = []

    def kernel2(t, dtype, exact_asym=False):
        tdm._check_dequant(t, torch.device("cpu"))
        calls.append(t)
        return tdm.dequant_mpq_ref(t, dtype, exact_asym)

    monkeypatch.setattr(tlin, "dequant_mpq", kernel2)
    monkeypatch.setattr(MPQTensor, "device", property(lambda self: torch.device("cuda")))
    return calls


@pytest.mark.parametrize("perm", [False, True], ids=["no_perm", "q_perm"])
@pytest.mark.parametrize("w_bit", [2, 4, 8])
def test_kernel2_route_on_the_kernel_form_is_the_tpu_arithmetic(on_card, w_bit, perm):
    jqt, qt, _ = _pair(w_bit, perm)
    got = tlin.reconstruct_weight(qt, torch.float32)
    assert len(on_card) == 1 and on_card[0].asym
    assert (on_card[0].q_perm is not None) == perm and on_card[0].packed is qt.packed
    assert torch.equal(got, _jax_weight(jqt))
    # the CPU's plain route keeps s·(q − z): the JAX CPU path's numbers
    want_cpu = torch.from_numpy(np.asarray(jquant.dequantize_mpq(jqt, dtype=jnp.float32)))
    assert torch.equal(dequantize_mpq(qt, torch.float32), want_cpu)


@pytest.mark.parametrize("perm", [False, True], ids=["no_perm", "q_perm"])
@pytest.mark.parametrize("w_bit", [2, 4, 8])
def test_kernel1_plain_version_on_the_kernel_form(w_bit, perm):
    jqt, qt, rng = _pair(w_bit, perm)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    kform = tlin._kernel_form(qt)
    assert not kform.asym and kform.q_perm is None and kform.layout == "gptq"
    tdm._check_weight(kform, torch.device("cpu"))
    xg = tlin._gather(x, qt)
    got = tdm.mpq_matmul_ref(xg, kform, torch.float32)
    want = xg @ _stored_rows(_jax_weight(jqt), qt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("perm", [False, True], ids=["no_perm", "q_perm"])
@pytest.mark.parametrize("w_bit", [2, 4, 8])
def test_kernel5_plain_version_on_the_kernel_form(w_bit, perm):
    jqt, qt, rng = _pair(w_bit, perm, act_bits=8)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    kform = tlin._kernel_form(qt)
    xg = tlin._gather(x, qt)
    w = _stored_rows(_jax_weight(jqt), qt)
    if w_bit == 8:
        # an 8-bit tensor runs its TPU kernel's A16 branch: the route takes kernel 1
        assert kform.act_bits == 16
        assert torch.equal(tdm.mpq_matmul_ref(xg, kform, torch.float32), xg @ w)
        return
    assert kform.act_bits == relayout_tpu(jqt).act_bits == 8
    qx, _ = quantize_activations_ref(xg)
    assert torch.equal(mpq_matmul_a8_ref(xg, kform, accumulator=True), qx @ w)


@pytest.mark.parametrize("w_bit", [2, 4, 8])
def test_distance_to_the_jax_pallas_dequant(w_bit):
    """The JAX package's kernel 2 in interpret mode (it takes no ``q_perm``)
    against the port's kernel form, in f32."""
    jqt, qt, _ = _pair(w_bit, perm=False)
    pallas = torch.from_numpy(np.asarray(dequant_mpq_pallas(jqt, dtype=jnp.float32,
                                                           interpret=True)))
    got = tdm.dequant_mpq_ref(qt, torch.float32)  # the asym tensor in kernel 2's kernel form
    dist = float((got - pallas).abs().max() / pallas.abs().max())
    print(f"w{w_bit}: max|port kernel form - JAX Pallas interpret| / max|w| = {dist:.3e}")
    assert dist <= PALLAS_REL, f"w{w_bit}: {dist:.3e} > {PALLAS_REL}"


def test_only_asym_and_tpu_layouts_are_rewritten(monkeypatch, on_card):
    """A symmetric gptq tensor reaches kernels 1 and 5 as it is: no
    ``prepare_for_kernel``, no ``torch.equal`` (a host sync on the card);
    an asym one is rewritten once a call.  Kernel 2's route rewrites
    neither: the kernel receives the asym ``q_perm`` tensor."""
    rewrites, syncs = [], []
    real_prepare, real_equal = tlin.prepare_for_kernel, torch.equal
    monkeypatch.setattr(tlin, "prepare_for_kernel",
                        lambda t, *a, **k: rewrites.append(t) or real_prepare(t, *a, **k))
    monkeypatch.setattr(torch, "equal", lambda a, b: syncs.append(1) or real_equal(a, b))
    _, asym, _ = _pair(4, perm=True)
    for act_bits in (16, 8):
        sym = tdm.prepare_for_kernel(asym.replace(act_bits=act_bits))
        syncs.clear()
        kform = tlin._kernel_form(sym)
        assert kform.packed is sym.packed and kform.zeros is sym.zeros
        assert not rewrites and not syncs
    kform = tlin._kernel_form(asym)
    assert len(rewrites) == 1 and not kform.asym and kform.q_perm is None
    rewrites.clear()
    tlin.reconstruct_weight(asym, torch.bfloat16)
    assert not rewrites and not syncs
    assert len(on_card) == 1 and on_card[0].asym and on_card[0].q_perm is asym.q_perm


def test_check_weight_still_refuses_asym():
    """Kernels 1 and 5 refuse an asym tensor; kernel 2 takes it, ``q_perm``
    included."""
    _, qt, _ = _pair(4, perm=False)
    with pytest.raises(ValueError, match="symmetric"):
        tdm._check_weight(qt, torch.device("cpu"))
    with pytest.raises(ValueError, match="symmetric"):
        tdm._check_weight(qt.replace(act_bits=8), torch.device("cpu"), act_bits=(8,))
    _, perm, _ = _pair(4, perm=True)
    for t in (qt, perm):
        tdm._check_dequant(t, torch.device("cpu"))
