"""Kernel 2 (the streaming dequant) as it reads every MPQ tensor itself:
its plain version against the JAX package in each zero form, what the
wrapper and the loader refuse, and the card's routes through it (the
kernel stood in for by its plain version, which checks what the kernel
checks).

* ``dequant_mpq_ref`` is held **bit for bit** to the JAX package for w
  2/4/8, f32 and bf16 metadata, with and without ``q_perm``, in f32 and
  bf16 output: a sym tensor (random float zeros) to the jitted
  ``dequantize_mpq``; an asym one in the kernel form to the jitted
  ``dequantize_mpq(relayout_tpu(qt))`` (the TPU wrapper's arithmetic) and,
  with ``exact_asym``, to the jitted ``dequantize_mpq`` (``s·(q − z)``,
  DiodeMix's update).
* A loaded ``q_perm`` must be a permutation of the input rows (kernel 2
  writes through it), and ``_check_dequant`` refuses what kernel 2 does
  not read.
* On a simulated card ``reconstruct_weight`` makes one kernel-2 call for
  sym, asym and ``q_perm`` tensors, with no ``prepare_for_kernel``, no
  ``index_select`` and no ``torch.equal``; DiodeMix's asym update goes
  through it (``exact_asym``) and equals the plain ``dequantize_mpq``
  route bit for bit, fsdp column parts included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.pallas.dequant_matmul import relayout_tpu
from bitorch_engine_tpu_torch.layers.linear import MPQLinear
from bitorch_engine_tpu_torch.ops import mpq_linear as tlin
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as tdm
from bitorch_engine_tpu_torch.ops.quant import dequantize_mpq
from bitorch_engine_tpu_torch.optim import DiodeHyperParams, DiodeMix
from bitorch_engine_tpu_torch.optim import diode as tdiode
from bitorch_engine_tpu_torch.qtensor import MPQTensor
from bitorch_engine_tpu_torch.utils.convert import _mpq, prepare_for_training

K, N, GS = 512, 128, 64
_jit_dequant = jax.jit(jq.dequantize_mpq, static_argnames="dtype")


def _pair(w_bit, asym, meta, perm, seed=0):
    """One tensor in both packages: sym with random float zeros, or asym;
    ``meta`` its metadata dtype; ``perm``: a seeded ``q_perm``."""
    rng = np.random.default_rng(seed + 10 * w_bit + asym)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    jqt = jq.quantize_mpq(jnp.asarray(w), w_bit=w_bit, group_size=GS, asym=asym)
    if not asym:
        jqt = jqt.replace(zeros=jnp.asarray(rng.standard_normal(jqt.zeros.shape)
                                            .astype(np.float32) * 0.05))
    if meta == "bfloat16":
        jqt = jqt.replace(scales=jqt.scales.astype(jnp.bfloat16),
                          zeros=jqt.zeros if asym else jqt.zeros.astype(jnp.bfloat16))
    if perm:
        jqt = jqt.replace(q_perm=jnp.asarray(rng.permutation(K).astype(np.int32)))
    return jqt, _mpq(jax.tree_util.tree_map(np.asarray, jqt), "cpu")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _jax(a, dtype):
    a = np.array(a.astype(jnp.float32))
    return torch.from_numpy(a).to(dtype)  # exact: bf16 values round-trip through f32


@pytest.mark.parametrize("perm", [False, True], ids=["no_perm", "q_perm"])
@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bit", [2, 4, 8])
@pytest.mark.parametrize("form", ["sym", "asym_kernel", "asym_exact"])
def test_ref_matches_jax_bit_for_bit(form, w_bit, meta, perm):
    jqt, qt = _pair(w_bit, form != "sym", meta, perm)
    exact = form == "asym_exact"
    assert tdm.zero_form(qt, exact) == form
    want_qt = relayout_tpu(jqt) if form == "asym_kernel" else jqt
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = _jax(_jit_dequant(want_qt, dtype=jdtype), dtype)
        got = tdm.dequant_mpq_ref(qt, dtype, exact_asym=exact)
        assert got.dtype == dtype and got.shape == (K, N)
        assert torch.equal(_bits(got), _bits(want)), f"{form} w{w_bit} {meta} {dtype}"
        # the wrapper on a CPU tensor is its plain version
        assert torch.equal(_bits(tdm.dequant_mpq(qt, dtype, exact)), _bits(got))


def test_forms_differ_where_the_kernel_form_rounds():
    """bf16 scales: the kernel form's ``s·z`` rounded to bf16 moves weights
    off ``s·(q − z)``, so the two asym forms are different functions."""
    _, qt = _pair(4, True, "bfloat16", False)
    kernel = tdm.dequant_mpq_ref(qt, torch.float32)
    exact = tdm.dequant_mpq_ref(qt, torch.float32, exact_asym=True)
    assert torch.equal(exact, dequantize_mpq(qt, torch.float32))
    assert not torch.equal(kernel, exact)


def _leaf(jqt, **changes):
    return jax.tree_util.tree_map(np.asarray, jqt.replace(**changes))


@pytest.mark.parametrize("row_map", ["repeat", "past_k", "negative", "short"])
def test_load_refuses_a_row_map_that_is_not_a_permutation(row_map):
    """A record loaded with a ``q_perm`` that names a row twice, names one
    outside ``[0, K)`` or has the wrong length is refused at load: kernel 2
    would leave rows unwritten (or write outside the weight)."""
    jqt, _ = _pair(4, True, "float32", True)
    perm = np.arange(K, dtype=np.int32)
    bad = {"repeat": np.concatenate([perm[:-1], perm[:1]]),
           "past_k": np.concatenate([perm[:-1], [K]]).astype(np.int32),
           "negative": np.concatenate([[-1], perm[1:]]).astype(np.int32),
           "short": perm[:-1]}[row_map]
    with pytest.raises(ValueError, match="permutation"):
        _mpq(_leaf(jqt, q_perm=jnp.asarray(bad)), "cpu")


def test_load_takes_a_permutation():
    jqt, qt = _pair(4, True, "float32", True)
    assert torch.equal(qt.q_perm, torch.from_numpy(np.array(jqt.q_perm)))
    assert _mpq(_leaf(jqt, q_perm=None), "cpu").q_perm is None


@pytest.mark.parametrize("fault", ["g_idx", "tpu_layout", "perm_int64", "perm_length",
                                   "asym_zeros_dtype", "packed_shape"])
def test_check_dequant_refuses(fault):
    """What kernel 2 does not read raises before a launch."""
    _, qt = _pair(4, True, "float32", True)
    bad = {
        "g_idx": lambda: qt.replace(q_perm=None,
                                    g_idx=(torch.arange(K) // GS).to(torch.int32)),
        "tpu_layout": lambda: qt.replace(layout="tpu_pair"),
        "perm_int64": lambda: qt.replace(q_perm=qt.q_perm.long()),
        "perm_length": lambda: qt.replace(q_perm=qt.q_perm[:-1]),
        "asym_zeros_dtype": lambda: qt.replace(zeros=qt.zeros.float()),
        "packed_shape": lambda: qt.replace(scales=qt.scales[:, :-4]),
    }[fault]()
    with pytest.raises(ValueError):
        tdm._check_dequant(bad, torch.device("cpu"))
    tdm._check_dequant(qt, torch.device("cpu"))


@pytest.fixture
def on_card(monkeypatch):
    """The card's kernel-2 route with its plain version in the kernel's
    place (which checks what the kernel checks); every
    ``prepare_for_kernel``, ``index_select`` and ``torch.equal`` outside
    the stand-in recorded."""
    calls, outside = [], []
    inside = [False]

    def kernel2(t, dtype, exact_asym=False):
        tdm._check_dequant(t, torch.device("cpu"))
        calls.append((t, exact_asym))
        inside[0] = True
        try:
            return tdm.dequant_mpq_ref(t, dtype, exact_asym)
        finally:
            inside[0] = False

    def watch(name, fn):
        def wrapped(*a, **k):
            if not inside[0]:
                outside.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tlin, "dequant_mpq", kernel2)
    monkeypatch.setattr(tlin, "prepare_for_kernel", watch("prepare_for_kernel",
                                                          tlin.prepare_for_kernel))
    monkeypatch.setattr(tdm, "prepare_for_kernel", watch("prepare_for_kernel",
                                                         tdm.prepare_for_kernel))
    monkeypatch.setattr(torch.Tensor, "index_select", watch("index_select",
                                                            torch.Tensor.index_select))
    monkeypatch.setattr(torch, "equal", watch("torch.equal", torch.equal))
    monkeypatch.setattr(MPQTensor, "device", property(lambda self: torch.device("cuda")))
    return calls, outside


@pytest.mark.parametrize("perm", [False, True], ids=["no_perm", "q_perm"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_reconstruct_weight_is_one_kernel2_call(on_card, asym, perm):
    calls, outside = on_card
    _, qt = _pair(4, asym, "bfloat16", perm)
    before = dict(tlin.act_order_counts)
    for exact in (False, True):
        calls.clear()
        outside.clear()
        got = tlin.reconstruct_weight(qt, torch.bfloat16, exact_asym=exact)
        assert len(calls) == 1 and calls[0][0] is qt and calls[0][1] == exact
        assert not outside, outside
        assert torch.equal(_bits(got), _bits(tdm.dequant_mpq_ref(qt, torch.bfloat16, exact)))
    assert tlin.act_order_counts["scatter"] - before["scatter"] == (2 if perm else 0)
    assert tlin.act_order_counts["plain"] == before["plain"]


def _asym_layer(seed):
    rng = np.random.default_rng(seed)
    layer = MPQLinear(K, N, w_bit=4, group_size=GS, asym=True, dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    layer.set_qweight(layer.qweight.replace(
        q_perm=torch.from_numpy(rng.permutation(K).astype(np.int32))))
    model = prepare_for_training(nn.Sequential(layer))
    return model, layer, torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))


@pytest.fixture
def asym_layers():
    """Two copies of one asym act-order layer in training (built before
    ``on_card`` patches the tensors' device)."""
    return [_asym_layer(3) for _ in range(2)]


def test_diode_asym_update_through_kernel2_equals_the_plain_route(asym_layers, on_card,
                                                                  monkeypatch):
    """Two DiodeMix steps (zeros refreshed each step) of an asym act-order
    layer on the simulated card's kernel-2 route, and of the same layer with
    the reconstruction the plain ``dequantize_mpq`` (the route before kernel
    2 read asym zeros): packed codes and integer zeros bit-equal; every
    reconstruction a kernel-2 call in the exact form, none plain."""
    calls, outside = on_card
    hp = DiodeHyperParams(lr=0.05, zeros_update_interval=1)
    start = asym_layers[0][1].packed.clone()
    states = []
    for route, (model, layer, grad) in zip(("kernel", "plain"), asym_layers):
        opt = DiodeMix(model, hp)
        calls.clear()
        outside.clear()
        before = dict(tdiode.update_counts)
        with monkeypatch.context() as m:
            if route == "plain":
                m.setattr(tdiode, "reconstruct_weight",
                          lambda qt, dtype, exact_asym=False: dequantize_mpq(qt, dtype))
            for i in range(2):
                layer.grad_shadow.grad = grad * (i + 1)
                opt.step()
        if route == "kernel":
            assert len(calls) == 2 and all(exact and t.asym and t.q_perm is not None
                                           for t, exact in calls)
            assert not outside, outside
            assert tdiode.update_counts["kernel"] - before["kernel"] == 2
            assert tdiode.update_counts["plain"] == before["plain"]
        states.append((layer.packed.clone(), layer.zeros.clone()))
    (pk, zk), (pp, zp) = states
    assert torch.equal(pk, pp) and torch.equal(zk, zp)
    assert not torch.equal(pk, start)  # the steps moved codes


def test_fsdp_column_part_reaches_kernel2(on_card):
    """An fsdp rank's column share of an asym act-order tensor (whole zero
    words) takes kernel 2 in the exact form, equal to the plain dequantize
    of the share."""
    calls, _ = on_card
    _, qt = _pair(4, True, "float32", True)
    part = tdiode._mpq_part(qt, (1, 0, N // 2))
    got = tlin.reconstruct_weight(part, torch.float32, exact_asym=True)
    assert len(calls) == 1 and calls[0][0].asym and calls[0][0].q_perm is not None
    assert torch.equal(got, dequantize_mpq(part, torch.float32))
    assert torch.equal(got, dequantize_mpq(qt, torch.float32)[:, : N // 2])


@pytest.mark.parametrize("act_bits", [16, 8])
def test_tpu_layout_reaches_kernel2_in_gptq_rows(on_card, act_bits):
    """A tensor loaded in one of the JAX package's TPU row layouts (pair,
    tiled, quad) is repacked in gptq order for kernel 2, its zeros as they
    are: one call, the plain dequantize's weight."""
    calls, _ = on_card
    jqt, _ = _pair(2, False, "bfloat16", False)
    qt = _mpq(jax.tree_util.tree_map(np.asarray, relayout_tpu(jqt, act_bits=act_bits)), "cpu")
    assert qt.layout != "gptq"
    got = tlin.reconstruct_weight(qt, torch.float32)
    assert len(calls) == 1 and calls[0][0].layout == "gptq" and calls[0][0].zeros is qt.zeros
    assert torch.equal(got, dequantize_mpq(qt, torch.float32))
