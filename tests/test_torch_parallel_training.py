"""dp / fsdp DiodeMix training in the port against the JAX package's
``test_optimizer_state_sharding`` and against the port's unsharded step.
One gloo world of 4 CPU processes (``_torch_worlds.training_world``):

* the optimizer-state case (``tests/test_sharding.py:102``): a w4 g32 128 ×
  256 MPQ weight, one DiodeMix step on ``mean((x W - y)²)``, its packed
  codes equal to the JAX package's unsharded step's, with the record cut
  to tp 4 columns (moments ``P(None, 'tp')``, as the JAX specs) and with
  the moments' rows over fsdp 4 (``P('fsdp', 'tp')``);
* the tiny f32 Llama trained 5 DiodeMix steps (the zeros refresh at step
  5) against the unsharded step in the same process: fsdp 4 (the whole
  batch on every rank) gives every packed code, zero and parameter bit for
  bit; dp 2 × fsdp 2 and dp 4 (the gradients summed over ranks in another
  order) every packed code, the zeros and parameters within f32 rounding
  (rtol 1e-5, atol 1e-6; they read 3e-7), the losses within 1e-6;
* every DiodeMix regime under fsdp 4 (MPQ split by rows and, where the
  rows do not hold whole groups, by columns, sym and asym; MBWQ; binary;
  IntQ at 4 and 8 bits; the binary embedding; fp matrices and vectors),
  with and without GaLore (rank 8), fed the same gradients for 6 steps
  from the JAX package's initial moments: every weight bit-equal to the
  unsharded port step's, and held to the JAX package's ``diode_update``
  on the same fsdp 4 mesh (moments ``optimizer_partition_specs``) with
  ``test_torch_diode.py``'s tolerances (fp rtol 1e-5 / atol 1e-7; at most
  0.1% of MPQ / MBWQ / IntQ codes one step apart; the binary signs equal);
* a weight that splits in neither rows nor columns raises, as do GaLore
  moments whose rows do not split (act-order weights split their columns:
  ``test_torch_act_order_training.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import Mesh, NamedSharding
from torch import nn

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import start_world
from bitorch_engine_tpu import qtensor as jqtensor
from bitorch_engine_tpu.ops import embedding as jemb
from bitorch_engine_tpu.ops import mbwq_linear as jmb
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.mpq_linear import mpq_linear as jmpq_linear
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.optim import GaLoreConfig as JGaLore
from bitorch_engine_tpu.optim import diode_init, diode_update
from bitorch_engine_tpu.parallel.sharding import optimizer_partition_specs as jopt_specs
from bitorch_engine_tpu.qtensor import with_grad_shadow as jwith_grad_shadow
from bitorch_engine_tpu_torch.layers.embedding import BinaryEmbedding
from bitorch_engine_tpu_torch.layers.linear import BinaryLinear, MBWQLinear, MPQLinear, Q4Linear, Q8Linear
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.utils.convert import _mbwq, _mpq, _qat_record
from test_sharding import _mk_qt

REGIME_STEPS, REGIME_LR = 6, 5e-3
S_42 = {"bits": [4, 2], "bits_prop": [0.5, 0.5], "group_size": {"4": 32, "2": 32}}
# each leaf's split at fsdp 4: (dim, size of a share)
REGIME_SPLITS = {"mpq_rows": (0, 32), "mpq_cols": (1, 24), "mpq_asym_cols": (1, 16),
                 "mbwq": (1, 16), "binary": (0, 16), "q4": (0, 16), "q8": (0, 16),
                 "bemb": (0, 16), "fp_mat": (0, 16)}


def _regime_params(rng):
    """One JAX leaf a regime, in training mode."""
    def w(k, n):
        return jnp.asarray((rng.standard_normal((k, n)) * 0.1).astype(np.float32))

    params = {
        "mpq_rows": jq.quantize_mpq(w(128, 96), w_bit=4, group_size=32),
        "mpq_cols": jq.quantize_mpq(w(128, 96), w_bit=4, group_size=64),
        "mpq_asym_cols": jq.quantize_mpq(w(128, 64), w_bit=2, group_size=64, asym=True),
        "mbwq": jmb.quantize_mbwq(w(256, 64), S_42),
        "binary": jq.init_binary_weight(w(64, 96)),
        "q4": jq.init_nbit_weight(w(64, 96), 4),
        "q8": jq.init_nbit_weight(w(64, 96), 8),
        "bemb": jemb.quantize_binary_embedding(w(64, 96)),
        "fp_mat": w(64, 96),
        "fp_vec": jnp.asarray(rng.standard_normal(64).astype(np.float32)),
    }
    return {k: jqtensor.with_grad_shadow(v) if isinstance(v, jqtensor.QTensorBase) else v
            for k, v in params.items()}


def _shape(leaf):
    return leaf.logical_shape if isinstance(leaf, jqtensor.QTensorBase) else leaf.shape


def _regime_grads(rng, params):
    """Each step's gradients: rank-8 with well-separated singular values
    plus noise for a matrix (GaLore's factor well conditioned, as in
    ``test_torch_diode.py``), a binary embedding's with zero rows (rows no
    token read)."""
    steps = []
    for _ in range(REGIME_STEPS):
        grads = {}
        for name, leaf in params.items():
            shape = _shape(leaf)
            if len(shape) == 1:
                g = rng.standard_normal(shape)
            else:
                u = np.linalg.qr(rng.standard_normal((shape[0], 8)))[0]
                vt = np.linalg.qr(rng.standard_normal((shape[1], 8)))[0].T
                g = (u * np.arange(40, 0, -5)) @ vt + 0.05 * rng.standard_normal(shape)
            if name == "bemb":
                g[rng.random(shape[0]) < 0.5] = 0.0
            grads[name] = g.astype(np.float32)
        steps.append(grads)
    return steps


class _RegimeLeaves(nn.Module):
    """The port's layer for each JAX leaf."""

    def __init__(self, params):
        super().__init__()
        p = jax.tree_util.tree_map(np.asarray, params)
        for name in ("mpq_rows", "mpq_cols", "mpq_asym_cols"):
            setattr(self, name, MPQLinear(1, 1, dtype=torch.float32, qweight=_mpq(p[name], "cpu")))
        self.mbwq = MBWQLinear(1, 1, dtype=torch.float32, qweight=_mbwq(p["mbwq"], "cpu"))
        for name, cls in (("binary", BinaryLinear), ("q4", Q4Linear), ("q8", Q8Linear)):
            setattr(self, name, cls(96, 64, qweight=_qat_record(p[name], "cpu")))
        self.bemb = BinaryEmbedding(64, 96, qweight=_qat_record(p["bemb"], "cpu"))
        for name in ("fp_mat", "fp_vec"):
            setattr(self, name, nn.Parameter(torch.from_numpy(p[name].copy())))


def _moments(state):
    """A JAX DiodeState's moments, ``{leaf: {key: tensor}}``."""
    return {name: {k: torch.from_numpy(np.array(v)) for k, v in st.items()
                   if k in ("exp_avg_l", "exp_avg_s")}
            for name, st in state.leaf_states.items()}


@functools.lru_cache(maxsize=None)
def _regime_setup():
    rng = np.random.default_rng(31)
    params = _regime_params(rng)
    return params, _regime_grads(rng, params)


def _jax_hp(galore):
    return JHP(lr=REGIME_LR, galore=JGaLore(rank=8) if galore else None)


@pytest.fixture(scope="module")
def pending_world(tmp_path_factory):
    params, grads = _regime_setup()
    path = str(tmp_path_factory.mktemp("regimes") / "regimes.pt")
    torch.save({"module": _RegimeLeaves(params),
                "grads": [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads],
                "moments": _moments(diode_init(params, hp=_jax_hp(False))),
                "galore_moments": _moments(diode_init(params, hp=_jax_hp(True)))}, path)
    return start_world("training_world", 4, regimes=path)


@pytest.fixture(scope="module")
def jax_regimes(pending_world):
    """The JAX package's ``diode_update`` over the same leaves and
    gradients on an fsdp 4 mesh, with and without GaLore."""
    params0, grads = _regime_setup()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4, 1), ("fsdp", "tp"))
    out = {}
    for galore in (False, True):
        hp = _jax_hp(galore)
        params, state = params0, diode_init(params0, hp=hp)
        specs = jopt_specs(state, params, fsdp_axis="fsdp")
        with mesh:
            state = jax.device_put(state, jax.tree_util.tree_map(
                lambda s: NamedSharding(mesh, s), specs))
            update = jax.jit(lambda g, s, p: diode_update(g, s, p, hp))
            for step in grads:
                g = {k: params[k].replace(grad_shadow=jnp.asarray(v))
                     if isinstance(params[k], jqtensor.QTensorBase) else jnp.asarray(v)
                     for k, v in step.items()}
                params, state = update(g, state, params)
        out[galore] = jax.tree_util.tree_map(np.asarray, params)
    return out


@pytest.fixture(scope="module")
def jax_side(pending_world):
    """``test_optimizer_state_sharding``'s unsharded JAX step and its specs
    (fsdp_axis None)."""
    qt = jwith_grad_shadow(_mk_qt(k=128, n=256, gs=32))
    params = {"q": qt}
    hp = JHP(lr=1e-3)
    state = diode_init(params, hp=hp)
    x = jnp.asarray(np.random.default_rng(7).standard_normal((8, 128)).astype(np.float32))
    y = jnp.asarray(np.random.default_rng(8).standard_normal((8, 256)).astype(np.float32))

    def step(params, opt_state):
        grads = jax.grad(lambda p: jnp.mean((jmpq_linear(x, p["q"]) - y) ** 2),
                         allow_int=True)(params)
        return diode_update(grads, opt_state, params, hp)

    ref_p, _ = jax.jit(step)(params, state)
    specs = jopt_specs(state, params, fsdp_axis=None).leaf_states["q"]
    return dict(packed=np.asarray(ref_p["q"].packed),
                specs=[[str(a) for a in specs[k]] for k in ("exp_avg_l", "exp_avg_s")])


@pytest.fixture(scope="module")
def world(pending_world, jax_side):
    return pending_world.result()


@pytest.mark.parametrize("key", ["tp4", "fsdp4"])
def test_optimizer_state_sharding(world, jax_side, key):
    for r in range(4):
        np.testing.assert_array_equal(world[r][f"opt_{key}_packed"], jax_side["packed"])


def test_moment_specs_and_shapes(world, jax_side):
    """tp: the JAX package's ``P(None, 'tp')`` on each rank's 64 columns;
    fsdp: ``P('fsdp', 'tp')``, each rank keeping 32 of the 128 rows."""
    assert world[0]["opt_tp4_specs"].tolist() == jax_side["specs"]
    assert world[0]["opt_fsdp4_specs"].tolist() == [["fsdp", "tp"]] * 2
    assert world[0]["opt_tp4_moment_shape"].tolist() == [128, 64]
    assert world[0]["opt_fsdp4_moment_shape"].tolist() == [32, 256]


@pytest.mark.parametrize("key", ["fsdp4", "dp2_fsdp2", "dp4"])
def test_llama_steps_match_the_unsharded_steps(world, key):
    """The global losses of 5 steps within 1e-6, every packed code equal;
    fsdp 4 bit-equal in every zero and parameter too."""
    names = [k.removeprefix("llama_none_") for k in world[0] if k.startswith("llama_none_")
             and not k.endswith("losses")]
    for r in range(4):
        out = world[r]
        np.testing.assert_allclose(out[f"llama_{key}_losses"], out["llama_none_losses"], rtol=1e-6)
        for name in names:
            got, want = out[f"llama_{key}_{name}"], out[f"llama_none_{name}"]
            if key == "fsdp4" or name.endswith("packed"):
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_fsdp_moments_keep_their_rows(world):
    assert int(world[0]["llama_fsdp4_moment_rows"]) == 512 // 4
    assert int(world[0]["llama_dp2_fsdp2_moment_rows"]) == 512 // 2


@pytest.mark.parametrize("what,match", [
    ("groups", "ValueError: .* do not split over fsdp=4"),
    ("galore", "ValueError: layer_0.mlp.gate_proj: GaLore's 3 projected rows do not split"),
])
def test_shapes_that_do_not_split_raise(world, what, match):
    import re

    assert re.search(match, str(world[0][f"raises_{what}"])), world[0][f"raises_{what}"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loss_share_stays_on_the_logits_device(device):
    """With a mesh the label count is summed where the logits are (NCCL
    takes no host tensor, and a host copy syncs every step); a meta tensor
    has no host copy at all.  On one process the share is the mean."""
    from bitorch_engine_tpu_torch.parallel import make_axes_mesh
    from bitorch_engine_tpu_torch.training import cross_entropy_loss

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 6, 11, generator=gen)
    labels = torch.randint(0, 11, (2, 6), generator=gen)
    labels[0, :2] = -100
    mesh = make_axes_mesh(dp=1, sp=1)
    got = cross_entropy_loss(logits.to(device), labels.to(device), mesh)
    assert got.device.type == device and got.dtype == torch.float32
    if device == "cpu":
        torch.testing.assert_close(got, cross_entropy_loss(logits, labels), rtol=1e-6, atol=0)


def _regime_names(out, tag):
    head = f"regime_{tag}_none_"
    return [k[len(head):] for k in out if k.startswith(head)]


@pytest.mark.parametrize("galore", [False, True], ids=["plain", "galore"])
def test_every_regime_under_fsdp_is_the_unsharded_step(world, galore):
    tag = "galore" if galore else "plain"
    names = _regime_names(world[0], tag)
    assert {n.split(".")[0] for n in names} == set(REGIME_SPLITS) | {"fp_vec"}
    for r in range(4):
        for name in names:
            np.testing.assert_array_equal(world[r][f"regime_{tag}_fsdp4_{name}"],
                                          world[r][f"regime_{tag}_none_{name}"],
                                          err_msg=f"rank {r} {name}")


def test_every_regime_splits_as_planned(world):
    """Rows where they hold whole groups and words, else columns; MBWQ
    by columns; fp_vec whole."""
    for r in range(4):
        splits = {row[0]: tuple(int(v) for v in row[1:])
                  for row in world[r]["regime_plain_fsdp4_splits"]}
        assert splits == {name: (dim, r * n, (r + 1) * n)
                          for name, (dim, n) in REGIME_SPLITS.items()}


def _codes_close(got, want, what):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (what, diff.max(), (diff > 0).mean())


def _mpq_codes(packed, w_bit):
    return tpk.unpack_rows(torch.from_numpy(np.asarray(packed)), w_bit).numpy()


@pytest.mark.parametrize("galore", [False, True], ids=["plain", "galore"])
def test_every_regime_under_fsdp_holds_to_the_jax_step(world, jax_regimes, galore):
    tag = f"regime_{'galore' if galore else 'plain'}_fsdp4"
    want = jax_regimes[galore]
    for r in range(4):
        out = world[r]
        for name in ("mpq_rows", "mpq_cols", "mpq_asym_cols"):
            w_bit = want[name].w_bit
            _codes_close(_mpq_codes(out[f"{tag}_{name}.packed"], w_bit),
                         _mpq_codes(want[name].packed, w_bit), name)
        np.testing.assert_allclose(out[f"{tag}_mpq_rows.zeros"], want["mpq_rows"].zeros,
                                   rtol=1e-5, atol=1e-7)
        for i, seg in enumerate(want["mbwq"].segments):
            _codes_close(_mpq_codes(out[f"{tag}_mbwq.segments.{i}.packed"], seg.w_bit),
                         _mpq_codes(seg.packed, seg.w_bit), f"mbwq segment {i}")
            np.testing.assert_allclose(out[f"{tag}_mbwq.segments.{i}.zeros"], seg.zeros,
                                       rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(out[f"{tag}_binary.data"], want["binary"].data)
        np.testing.assert_array_equal(np.asarray(out[f"{tag}_bemb.data"]).view(np.uint32),
                                      np.asarray(want["bemb"].data).view(np.uint32))
        for name in ("q4", "q8"):
            _codes_close(out[f"{tag}_{name}.data"], want[name].data, name)
        for name in ("fp_mat", "fp_vec"):
            np.testing.assert_allclose(out[f"{tag}_{name}"], want[name], rtol=1e-5, atol=1e-7,
                                       err_msg=name)
