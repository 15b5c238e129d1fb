"""Act-order MPQ weights trained under fsdp and under tp, in one gloo world
of 4 CPU processes (``_torch_worlds.act_order_training_world``).

* fsdp: the tiny f32 Llama, sym and asym, with a seeded ``q_perm`` on every
  projection, trained 3 DiodeMix steps with the zeros refreshed every
  step.  An act-order weight splits its N columns over fsdp (asym: whole
  words of zeros); ``q_perm`` stays whole.  fsdp 4 equals the unsharded
  step bit for bit in every packed word, zero and parameter, and dp 2 ×
  fsdp 2 equals dp 2 alone (a dp 2 × tp 2 mesh, the model not cut) bit for bit (both sum the gradients over the
  same two dp ranks; the unsharded step sums them in another order);
* tp: a layer with a ragged ``g_idx`` (unequal group sizes, drawn from a
  seed) and one with ``q_perm``, sym and asym, cut into tp 2 row shards
  (``row_shard``), one DiodeMix step at a refresh from the same gradient:
  every shard's codes equal the unsharded layer's rows and its zeros the
  unsharded zeros (the ragged shard holds all of them) bit for bit.  The
  same step by the JAX package's ``diode_update`` jitted on the 8 virtual
  devices, the record row-sharded over ``tp`` (GSPMD's one program), gives
  the same codes, and the zeros within ``test_torch_tp_training.py``'s
  split-sum bars (rtol 1e-5, atol 1e-6; asym integer zeros equal).  A
  gradient whose sign is constant down each column moves the integer
  zeros, so the refresh is seen to run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import start_world
from bitorch_engine_tpu.ops import quant as jquant
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.optim import diode_init, diode_update
from bitorch_engine_tpu.qtensor import with_grad_shadow as jwith_grad_shadow
from bitorch_engine_tpu_torch.ops import packing as tpk

K, N, GS, LR = 256, 128, 32, 0.6
RECORDS = ("ragged_sym", "ragged_asym", "perm_sym", "perm_asym")


@functools.lru_cache(maxsize=None)
def _records():
    """The act-order records (JAX), the gradient, and the port's fields."""
    rng = np.random.default_rng(41)
    recs = {}
    for asym in (False, True):
        w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
        base = jquant.quantize_mpq(jnp.asarray(w), w_bit=4, group_size=GS, asym=asym)
        counts = np.full(K // GS, GS)
        for _ in range(6):  # move rows between groups: unequal sizes
            a, b = rng.choice(K // GS, 2, replace=False)
            moved = int(rng.integers(1, 5))
            counts[a], counts[b] = counts[a] - moved, counts[b] + moved
        g_idx = rng.permutation(np.repeat(np.arange(K // GS), counts)).astype(np.int32)
        tag = "asym" if asym else "sym"
        recs[f"ragged_{tag}"] = base.replace(g_idx=jnp.asarray(g_idx))
        recs[f"perm_{tag}"] = base.replace(q_perm=jnp.asarray(rng.permutation(K).astype(np.int32)))
    sign = np.where(rng.random(N) < 0.5, -1.0, 1.0)
    grad = (0.3 * rng.standard_normal((K, N)) + sign).astype(np.float32)
    return recs, grad


def _fields(jqt):
    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    return dict(packed=t(jqt.packed), scales=t(jqt.scales), zeros=t(jqt.zeros), g_idx=t(jqt.g_idx),
                q_perm=t(jqt.q_perm), w_bit=jqt.w_bit, group_size=jqt.group_size, asym=jqt.asym)


@pytest.fixture(scope="module")
def pending_world(tmp_path_factory):
    recs, grad = _records()
    path = str(tmp_path_factory.mktemp("act_order") / "records.pt")
    torch.save({"records": {n: _fields(q) for n, q in recs.items()},
                "grad": torch.from_numpy(grad), "lr": LR}, path)
    return start_world("act_order_training_world", 4, records=path)


@pytest.fixture(scope="module")
def jax_gspmd(pending_world):
    """Each record's DiodeMix step by the JAX package, row-sharded over tp
    on a (4, 2) mesh of the virtual devices, jitted: GSPMD's program."""
    recs, grad = _records()
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    hp = JHP(lr=LR, zeros_update_interval=1)
    out = {}
    for name, qt in recs.items():
        qt = jwith_grad_shadow(qt)
        spec = qt.replace(packed=JP("tp", None), scales=JP(), zeros=JP(),
                          g_idx=None if qt.g_idx is None else JP("tp"),
                          q_perm=None if qt.q_perm is None else JP("tp"),
                          grad_shadow=JP("tp", None))
        params = {"w": qt}
        with mesh:
            params = jax.device_put(params, {"w": jax.tree_util.tree_map(
                lambda s: NamedSharding(mesh, s), spec)})
            state = diode_init(params, hp=hp)
            grads = {"w": params["w"].replace(grad_shadow=jnp.asarray(grad))}
            new, _ = jax.jit(lambda g, s, p: diode_update(g, s, p, hp))(grads, state, params)
        out[name] = (np.asarray(new["w"].packed), np.asarray(new["w"].zeros))
    return out


@pytest.fixture(scope="module")
def world(pending_world, jax_gspmd):
    return pending_world.result()


def _names(out, tag):
    head = f"{tag}_"
    return [k[len(head):] for k in out if k.startswith(head) and not k.endswith(("losses", "splits"))]


@pytest.mark.parametrize("mesh,ref", [("fsdp4", "none"), ("dp2_fsdp2", "dp2_tp2")])
@pytest.mark.parametrize("asym", ["sym", "asym"])
def test_act_order_fsdp_is_bit_equal(world, asym, mesh, ref):
    names = _names(world[0], f"{asym}_{ref}")
    assert any(n.endswith("packed") for n in names) and any(n.endswith("zeros") for n in names)
    for r in range(4):
        out = world[r]
        np.testing.assert_array_equal(out[f"{asym}_{mesh}_losses"], out[f"{asym}_{ref}_losses"])
        for name in names:
            np.testing.assert_array_equal(out[f"{asym}_{mesh}_{name}"], out[f"{asym}_{ref}_{name}"],
                                          err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("asym", ["sym", "asym"])
def test_act_order_splits_are_columns(world, asym):
    """Every act-order projection of layer 0 splits its N columns at fsdp 4
    (asym: whole words of 8 codes); the fp parameters keep their rows."""
    widths = {"q_proj": 256, "k_proj": 128, "v_proj": 128, "o_proj": 256, "gate_proj": 512,
              "up_proj": 512, "down_proj": 256}
    for r in range(4):
        splits = {row[0]: tuple(int(v) for v in row[1:]) for row in world[r][f"{asym}_fsdp4_splits"]}
        for name, n in widths.items():
            key = [k for k in splits if k.endswith(name)]
            assert len(key) == 1, (name, splits)
            share = n // 4
            assert splits[key[0]] == (1, r * share, (r + 1) * share)
            assert asym == "sym" or share % 8 == 0


def _tp_parts(world, name):
    """The unsharded step's codes and zeros, and the tp 2 shards' put back
    together (rank order; the ragged shard's zeros are every group's)."""
    by_coord = {int(world[r]["tp_coord"]): world[r] for r in range(4)}
    packed = np.concatenate([by_coord[c][f"tp_{name}_tp2_packed"] for c in (0, 1)])
    if name.startswith("ragged"):
        for c in (0, 1):
            np.testing.assert_array_equal(by_coord[c][f"tp_{name}_tp2_zeros"],
                                          by_coord[0][f"tp_{name}_none_zeros"])
        zeros = by_coord[0][f"tp_{name}_tp2_zeros"]
    else:
        zeros = np.concatenate([by_coord[c][f"tp_{name}_tp2_zeros"] for c in (0, 1)])
    return (by_coord[0][f"tp_{name}_none_packed"], by_coord[0][f"tp_{name}_none_zeros"],
            packed, zeros)


@pytest.mark.parametrize("name", RECORDS)
def test_tp_row_shard_refresh_is_the_unsharded_step(world, name):
    ref_packed, ref_zeros, packed, zeros = _tp_parts(world, name)
    np.testing.assert_array_equal(tpk.unpack_rows(torch.from_numpy(np.array(packed)), 4),
                                  tpk.unpack_rows(torch.from_numpy(np.array(ref_packed)), 4))
    np.testing.assert_array_equal(zeros, ref_zeros)
    groups = int(world[0][f"tp_{name}_tp2_groups"])
    assert groups == (K // GS if name.startswith("ragged") else K // GS // 2)
    # the refresh moved the zeros
    recs, _ = _records()
    assert not np.array_equal(zeros, np.asarray(recs[name].zeros))


@pytest.mark.parametrize("name", RECORDS)
def test_tp_row_shard_matches_jax_gspmd(world, jax_gspmd, name):
    _, _, packed, zeros = _tp_parts(world, name)
    want_packed, want_zeros = jax_gspmd[name]
    np.testing.assert_array_equal(tpk.unpack_rows(torch.from_numpy(np.array(packed)), 4),
                                  tpk.unpack_rows(torch.from_numpy(want_packed), 4))
    if name.endswith("asym"):
        np.testing.assert_array_equal(zeros, want_zeros)
    else:
        np.testing.assert_allclose(zeros, want_zeros, rtol=1e-5, atol=1e-6)
