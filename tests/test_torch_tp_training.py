"""Tensor parallelism inside the port's train step against the JAX
package's GSPMD step (``__graft_entry__.dryrun_multichip``'s step on the
same ``(dp, fsdp, tp)`` mesh shape): the tiny f32 Llama of
``__graft_entry__._tiny_cfg`` with an untied w4 head, prepared for
training, its parameters sharded by ``llama_partition_specs``, its DiodeMix
moments by ``optimizer_partition_specs``, ``jax.jit`` of ``value_and_grad``
+ ``diode_update``, 3 steps with the zeros refreshed at step 3.

The port takes the JAX start weights (``load_jax_params``, saved with
``save_checkpoint``), cuts them with ``shard_llama_params`` and trains the
same 3 steps with ``make_train_step(mesh=)`` at tp 4, dp 2 × tp 2 and fsdp
2 × tp 2, in one gloo world of 4 CPU processes
(``_torch_worlds.tp_training_world``).  The JAX moments start at zero in
these regimes (MPQ and fp, checked), as the port's do.  Held, on every
rank:

* the global losses within 1e-5 relative;
* the first step's gradients: each rank's shard (its columns of q, k, v,
  gate, up and the head, its rows of o and down, the whole fp gradients)
  against the JAX gradient's slice within rtol 1e-4 / atol 1e-6 (f32 sums
  in other orders);
* after 3 steps every packed code equal to the JAX step's and to the
  port's own unsharded step's (run in the same world); the zeros within
  rtol 1e-5 / atol 1e-6 of both; the fp parameters within rtol 1e-5 /
  atol 1e-5 of both.  The fp bar is wider than the zeros' because a few
  embedding entries move by up to 3.5e-6 under any change of f32 sum
  order: the unsharded port against the JAX step reads 3.5e-6, tp against
  the unsharded port 2.7e-6 (the embedding's gradients, up to 0.5, agree
  to ~1e-6; AdamW's ``eps`` = 1e-6 amplifies that where a gradient is
  small).

The act-order row shard (its activation gathered over tp, the gather's
backward a reduce-scatter) gives the unsharded layer's output and
gradients: the activation's slice and the weight gradient's ``tp_rows``.
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
from _torch_worlds import TP_MESHES, start_world
from bitorch_engine_tpu import training as jtraining
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.models.llama_sharding import llama_partition_specs as jspecs
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.optim import diode_init, diode_update
from bitorch_engine_tpu.parallel.sharding import optimizer_partition_specs as jopt_specs
from bitorch_engine_tpu.utils.convert import prepare_for_training as jax_prepare_for_training
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.utils.checkpoint import save_checkpoint
from bitorch_engine_tpu_torch.utils.convert import load_jax_params

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=8,
            num_kv_heads=8, max_seq_len=64, group_size=32, head_w_bit=4)
STEPS, BATCH, SEQ, LR, INTERVAL = 3, 4, 16, 1e-3, 3
COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
ROW = ("o_proj", "down_proj")


def _batches():
    rng = np.random.default_rng(21)
    return [rng.integers(0, 256, (BATCH, SEQ + 1)).astype(np.int64) for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _start():
    model = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **TINY))
    params = jax_prepare_for_training(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, params


@functools.lru_cache(maxsize=None)
def _jax_run(key):
    """The GSPMD step at mesh ``key``: losses, the first step's gradients
    and the parameters after the last step (numpy trees)."""
    model, params = _start()
    sizes = TP_MESHES[key]
    shape = tuple(sizes.get(a, 1) for a in ("dp", "fsdp", "tp"))
    mesh = Mesh(np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape),
                ("dp", "fsdp", "tp"))
    hp = JHP(lr=LR, zeros_update_interval=INTERVAL)
    state = diode_init(params, hp=hp)
    moments = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.leaf_states)]
    assert all(not m.any() for m in moments), "the JAX moments start at zero"

    def put(tree, specs):
        return jax.device_put(tree, jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs))

    fsdp_axis = "fsdp" if shape[1] > 1 else None
    p = put(params, jspecs(params))
    state = put(state, jopt_specs(state, params, fsdp_axis=fsdp_axis))
    data = NamedSharding(mesh, JP("dp", None))

    def step(p, st, toks, labels):
        def loss_fn(q):
            return jtraining.cross_entropy_loss(model.apply(q, toks)[0], labels)

        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(p)
        new_p, new_st = diode_update(grads, st, p, hp)
        return new_p, new_st, loss, grads

    losses, grads0 = [], None
    with mesh:
        jstep = jax.jit(step)
        for toks in _batches():
            t = jax.device_put(jnp.asarray(toks[:, :-1], jnp.int32), data)
            lab = jax.device_put(jnp.asarray(toks[:, 1:], jnp.int32), data)
            p, state, loss, grads = jstep(p, state, t, lab)
            losses.append(float(loss))
            if grads0 is None:
                grads0 = jax.tree_util.tree_map(np.asarray, grads)
    return np.asarray(losses), grads0, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def pending_world(tmp_path_factory):
    _, params = _start()
    tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **TINY), device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    ckpt = str(tmp_path_factory.mktemp("tp_training") / "start")
    save_checkpoint(ckpt, tmodel)
    return start_world("tp_training_world", 4, ckpt=ckpt, cfg_kw=TINY,
                       batches=[b.tolist() for b in _batches()], lr=LR, interval=INTERVAL)


@pytest.fixture(scope="module")
def jax_side(pending_world):
    return {key: _jax_run(key) for key in TP_MESHES}


@pytest.fixture(scope="module")
def world(pending_world, jax_side):
    return pending_world.result()


def _leaf(tree, name):
    """The JAX tree's value for the port's parameter or buffer ``name``."""
    node = tree["params"]
    *path, last = name.split(".")
    for k in path:
        node = node[k]
    if last in ("packed", "zeros", "scales", "grad_shadow"):
        return getattr(node["qweight"], last)
    return node[last]


def _slice(name, want, key, rank):
    """The JAX array ``want`` of ``name`` cut to ``rank``'s tp shard (the
    ranks are laid out ``(dp, fsdp, tp)``, tp fastest)."""
    tp = TP_MESHES[key]["tp"]
    r = rank % tp
    proj = name.split(".")[-2] if "." in name else ""
    if proj in COLUMN:
        n = want.shape[1] // tp
        return want[:, r * n : (r + 1) * n]
    if proj in ROW:
        k = want.shape[0] // tp
        return want[r * k : (r + 1) * k]
    return want


def _names(out, key, prefix=""):
    head = f"{key}_{prefix}"
    return [k[len(head):] for k in out if k.startswith(head)]


@pytest.mark.parametrize("key", list(TP_MESHES))
def test_losses_match_the_gspmd_step(world, jax_side, key):
    for r in range(4):
        np.testing.assert_allclose(world[r][f"{key}_losses"], jax_side[key][0], rtol=1e-5)


@pytest.mark.parametrize("key", list(TP_MESHES))
def test_first_step_gradients_are_the_gspmd_slices(world, jax_side, key):
    grads = jax_side[key][1]
    names = _names(world[0], key, "grad_")
    assert len(names) == 2 * 7 + 2 * 2 + 1 + 1 + 1  # shadows, norms, embed, final norm, head
    for r in range(4):
        for name in names:
            got = world[r][f"{key}_grad_{name}"]
            want = _slice(name, np.asarray(_leaf(grads, name)), key, r)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("key", list(TP_MESHES))
def test_codes_zeros_and_parameters_after_three_steps(world, jax_side, key):
    end = jax_side[key][2]
    names = [n for n in _names(world[0], key) if not n.startswith(("grad_", "losses"))]
    packed = [n for n in names if n.endswith("packed")]
    assert len(packed) == 2 * 7 + 1
    for r in range(4):
        out = world[r]
        for name in names:
            got = np.asarray(out[f"{key}_{name}"])
            want = _slice(name, np.asarray(_leaf(end, name)), key, r)
            port = _slice(name, np.asarray(out[f"none_{name}"]), key, r)
            if name.endswith("packed"):
                for ref in (want, port):
                    np.testing.assert_array_equal(tpk.unpack_rows(torch.from_numpy(got), 4),
                                                  tpk.unpack_rows(torch.from_numpy(ref), 4),
                                                  err_msg=f"rank {r} {name}")
            elif got.dtype.kind == "f":
                atol = 1e-6 if name.endswith("zeros") else 1e-5
                for ref in (want, port):
                    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol,
                                               err_msg=f"rank {r} {name}")


def test_act_order_row_shard_backward(world):
    """The gather's backward sums the ranks' cotangents and keeps this
    rank's columns; the shard's weight gradient is the unsharded one's
    rows ``tp_rows``."""
    for r in range(4):
        out = world[r]
        np.testing.assert_allclose(out["act_order_sharded_y"], out["act_order_unsharded_y"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["act_order_sharded_x_grad"],
                                   out["act_order_unsharded_x_grad"][:, r * 64 : (r + 1) * 64],
                                   rtol=1e-5, atol=1e-5)
        rows = out["act_order_rows"]
        np.testing.assert_allclose(out["act_order_sharded_w_grad"],
                                   out["act_order_unsharded_w_grad"][rows], rtol=1e-6, atol=1e-6)
