"""DiodeMix and ``repack_mpq`` of the port against the JAX package's on the
CPU.  ``repack_mpq`` bit for bit (sym, asym, act-order ``q_perm``, odd
code widths).  DiodeMix against the JAX package's jitted ``diode_update``
over 6 steps, so that the step-5 zeros refresh runs, on fp leaves (a
matrix and a vector), MPQ layers (sym and asym) and an MBWQ layer fed the
same gradients, with and without GaLore.  Tolerances: the moments and fp
parameters rtol 1e-5 (both sides compute in f32; XLA fuses and may
contract multiply-adds, PyTorch rounds each operation), the sym zeros rtol
1e-5, and at most 0.1% of the packed codes differing, each by one step (a
weight that lands on a rounding boundary may round the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu import qtensor as jqtensor
from bitorch_engine_tpu.ops import mbwq_linear as jmb
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.optim import GaLoreConfig as JGaLore
from bitorch_engine_tpu.optim import diode_init, diode_update
from bitorch_engine_tpu_torch.layers.linear import MBWQLinear, MPQLinear
from bitorch_engine_tpu_torch.models.llama import LlamaModel, tiny_llama
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.ops import quant as tq
from bitorch_engine_tpu_torch.optim import DiodeHyperParams, DiodeMix, GaLoreConfig
from bitorch_engine_tpu_torch.utils.convert import _mbwq, _mpq, prepare_for_training

STEPS = 6
S_42 = {"bits": [4, 2], "bits_prop": [0.5, 0.5], "group_size": {"4": 32, "2": 32}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("w_bit,asym,perm,code_bits,given_zeros", [
    (4, False, False, None, False), (2, True, False, None, False), (8, False, True, None, False),
    (4, True, True, None, True), (4, False, False, 3, False),
])
def test_repack_mpq_is_bit_exact(w_bit, asym, perm, code_bits, given_zeros):
    rng = np.random.default_rng(w_bit + 3 * asym + 5 * perm)
    k, n = 256, 64
    jqt = jq.quantize_mpq(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)),
                          w_bit=w_bit, group_size=64, asym=asym, code_bits=code_bits)
    if perm:
        jqt = jqt.replace(q_perm=jnp.asarray(rng.permutation(k).astype(np.int32)))
    w = rng.standard_normal((k, n)).astype(np.float32) * 1.5
    zeros = None
    if given_zeros:
        zeros = rng.integers(1, 2 ** w_bit + 1, (k // 64, n)).astype(np.float32)
    want = jq.repack_mpq(jnp.asarray(w), jqt,
                         unpacked_zeros=None if zeros is None else jnp.asarray(zeros))
    got = tq.repack_mpq(torch.from_numpy(w), _mpq(_np(jqt), "cpu"),
                        unpacked_zeros=None if zeros is None else torch.from_numpy(zeros))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Leaves(nn.Module):
    """One module per regime, holding the JAX parameters' values."""

    def __init__(self, jparams):
        super().__init__()
        p = _np(jparams)
        for name in ("mpq_sym", "mpq_asym"):
            setattr(self, name, MPQLinear(1, 1, dtype=torch.float32,
                                          qweight=_mpq(p[name], "cpu")))
        self.mbwq = MBWQLinear(1, 1, dtype=torch.float32, qweight=_mbwq(p["mbwq"], "cpu"))
        self.fp_mat = nn.Parameter(torch.from_numpy(p["fp_mat"].copy()))
        self.fp_vec = nn.Parameter(torch.from_numpy(p["fp_vec"].copy()))


def _jax_params(rng):
    def w(k, n):
        return jnp.asarray((rng.standard_normal((k, n)) * 0.1).astype(np.float32))

    return {
        "mpq_sym": jq.quantize_mpq(w(128, 96), w_bit=4, group_size=32),
        "mpq_asym": jq.quantize_mpq(w(128, 64), w_bit=2, group_size=32, asym=True),
        "mbwq": jmb.quantize_mbwq(w(256, 64), S_42),
        "fp_mat": w(64, 96),
        "fp_vec": jnp.asarray(rng.standard_normal(64).astype(np.float32)),
    }


def _grad(rng, shape, galore):
    """A random gradient; under GaLore one of rank 8 with well-separated
    singular values plus noise, so that the rank-8 factor is well
    conditioned (a near-tie at the rank boundary would make the two LAPACK
    builds pick visibly different subspaces)."""
    if not galore or len(shape) == 1:
        return rng.standard_normal(shape).astype(np.float32)
    u = np.linalg.qr(rng.standard_normal((shape[0], 8)))[0]
    vt = np.linalg.qr(rng.standard_normal((shape[1], 8)))[0].T
    g = (u * np.arange(40, 0, -5)) @ vt + 0.05 * rng.standard_normal(shape)
    return g.astype(np.float32)


def _codes(mod):
    if isinstance(mod, MBWQLinear):
        return np.concatenate([_codes(s) for s in mod.segments])
    return tpk.unpack_rows(mod.packed, mod._w_bit).numpy()


def _jax_codes(qt):
    if isinstance(qt, jqtensor.MBWQTensor):
        return np.concatenate([_jax_codes(s) for s in qt.segments])
    return tpk.unpack_rows(torch.from_numpy(np.array(qt.packed)), qt.w_bit).numpy()


def _codes_close(got, want):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("galore", [False, True])
def test_diode_mix_matches_diode_update(galore):
    rng = np.random.default_rng(11 + galore)
    jparams = _jax_params(rng)
    model = prepare_for_training(_Leaves(jparams))
    jparams = {k: jqtensor.with_grad_shadow(v) if isinstance(v, jqtensor.QTensorBase) else v
               for k, v in jparams.items()}
    # one refresh of the projection only (step 1): a later refresh may
    # flip a singular vector's sign on one side and not on the other
    jhp = JHP(lr=5e-3, galore=JGaLore(rank=8) if galore else None)
    hp = DiodeHyperParams(lr=5e-3, galore=GaLoreConfig(rank=8) if galore else None)
    jstate = diode_init(jparams, hp=jhp)
    opt = DiodeMix(model, hp)
    assert [n for n, _ in opt.mpq] == ["mpq_sym", "mpq_asym"] and opt.mbwq[0][0] == "mbwq"
    assert [n for n, _ in opt.fp] == ["fp_mat", "fp_vec"]
    update = jax.jit(lambda g, s, p: diode_update(g, s, p, jhp))
    for _ in range(STEPS):
        grads = {}
        for name, leaf in jparams.items():
            shape = leaf.logical_shape if isinstance(leaf, jqtensor.QTensorBase) else leaf.shape
            g = _grad(rng, shape, galore)
            target = getattr(model, name)
            if isinstance(leaf, jqtensor.QTensorBase):
                grads[name] = leaf.replace(grad_shadow=jnp.asarray(g))
                target.grad_shadow.grad = torch.from_numpy(g)
            else:
                grads[name] = jnp.asarray(g)
                target.grad = torch.from_numpy(g)
        jparams, jstate = update(grads, jstate, jparams)
        opt.step()
    assert opt.step_count == STEPS and int(jstate.step) == STEPS
    for name in ("fp_mat", "fp_vec"):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(), np.asarray(jparams[name]),
                                   rtol=1e-5, atol=1e-7)
    for name, st in opt.state.items():
        assert ("galore" in st) == (galore and name in ("mpq_sym", "mpq_asym", "fp_mat"))
        for key in ("exp_avg_l", "exp_avg_s"):
            got, want = st[key].numpy(), np.asarray(jstate.leaf_states[name][key])
            if "galore" in st and key == "exp_avg_l":
                # projected moments: a singular vector's sign is the LAPACK
                # build's choice, the restored update is not
                got, want = np.abs(got), np.abs(want)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{name} {key}")
    for name in ("mpq_sym", "mpq_asym", "mbwq"):
        _codes_close(_codes(getattr(model, name)), _jax_codes(jparams[name]))
    np.testing.assert_allclose(model.mpq_sym.zeros.numpy(), np.asarray(jparams["mpq_sym"].zeros),
                               rtol=1e-5, atol=1e-7)
    for seg, jseg in zip(model.mbwq.segments, jparams["mbwq"].segments):
        np.testing.assert_allclose(seg.zeros.numpy(), np.asarray(jseg.zeros), rtol=1e-5, atol=1e-7)
    z_got = tpk.unpack_cols(model.mpq_asym.zeros, 2).numpy()
    z_want = tpk.unpack_cols(torch.from_numpy(np.array(jparams["mpq_asym"].zeros)), 2).numpy()
    assert np.abs(z_got - z_want).max() <= 1 and (z_got != z_want).mean() <= 1e-2
    assert not model.mpq_sym._zeros_mid


def test_diode_mix_state_dict_round_trip():
    gen = torch.Generator().manual_seed(0)
    layer = prepare_for_training(nn.Sequential(
        MPQLinear(64, 32, group_size=32, dtype=torch.float32, device="cpu", generator=gen)))
    opt = DiodeMix(layer, DiodeHyperParams(galore=GaLoreConfig(rank=4)))
    layer[0].grad_shadow.grad = torch.randn(64, 32, generator=gen)
    opt.step()
    sd = opt.state_dict()
    assert sd["step"] == 1 and sd["state"]["0"]["galore"]["ortho"].shape == (4, 32)
    fresh = DiodeMix(layer, DiodeHyperParams(galore=GaLoreConfig(rank=4)))
    fresh.load_state_dict(sd)
    assert fresh.step_count == 1
    assert torch.equal(fresh.state["0"]["exp_avg_s"], opt.state["0"]["exp_avg_s"])
    assert torch.equal(fresh.state["0"]["galore"].ortho, opt.state["0"]["galore"].ortho)
    opt.zero_grad()
    assert layer[0].grad_shadow.grad is None


def test_diode_mix_refuses_what_it_cannot_train():
    """A quantized layer without its grad shadow, and an integer weight that
    no regime updates (the int8 embedding), raise."""
    model = LlamaModel(tiny_llama(dtype=torch.float32, num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="prepare_for_training"):
        DiodeMix(model)
    model = prepare_for_training(
        LlamaModel(tiny_llama(dtype=torch.float32, num_layers=1, quantize_embed=True), device="cpu"))
    with pytest.raises(NotImplementedError, match="embed.data: .*not a bare integer weight"):
        DiodeMix(model)
