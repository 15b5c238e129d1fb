"""Sequence parallelism in the port's Llama against the JAX package's
(``tests/test_llama.py:554-592``): ``tiny_llama(dtype=float32)`` at sp 4,
ring and Ulysses, on 4 gloo CPU processes (``_torch_worlds.sp_world``).

* the logits of each rank's quarter of the sequence (positions at its
  global offset) against the JAX single-device model, atol / rtol 2e-4 as
  the JAX test;
* one training step's loss (each rank's share of the global mean, summed)
  and its gradients, summed over sp, against ``jax.grad`` of the JAX
  single-device model's next-token loss (f32: rtol 1e-4, atol 1e-5 of the
  largest gradient);
* a DiodeMix step at dp 2 × sp 2 (ring, remat on) against the port's
  unsharded step: the loss within 1e-6 and every packed code equal.

The JAX parameters (after ``prepare_for_training``) are carried over with
``load_jax_params`` and saved with ``save_checkpoint`` for the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import lm_batch, lm_loss, start_world
from bitorch_engine_tpu import training as jtraining
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.utils.convert import prepare_for_training as jprepare
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.optim import DiodeHyperParams
from bitorch_engine_tpu_torch.training import make_train_step
from bitorch_engine_tpu_torch.utils.checkpoint import save_checkpoint
from bitorch_engine_tpu_torch.utils.convert import load_jax_params, prepare_for_training

KINDS = ("ring", "ulysses")


def _port_names(tree, prefix=""):
    """A JAX parameter (or gradient) tree by the port's parameter names:
    a record's ``grad_shadow`` as ``<layer>.grad_shadow``."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_port_names(val, name))
        elif hasattr(val, "grad_shadow"):
            out[name.removesuffix(".qweight") + ".grad_shadow"] = np.asarray(val.grad_shadow)
        else:
            out[name] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jl.tiny_llama(dtype=jnp.float32, use_flash_attention=False)
    model = jl.LlamaModel(cfg)
    toks = jax.random.randint(jax.random.PRNGKey(0), (2, 32), 0, cfg.vocab_size)
    params = jprepare(jax.jit(model.init)(jax.random.PRNGKey(1), toks))
    start = jax.tree_util.tree_map(np.asarray, params)
    tmodel = load_jax_params(tl.LlamaModel(tl.tiny_llama(dtype=torch.float32), device="cpu"),
                             start)
    path = str(tmp_path_factory.mktemp("sp") / "ckpt")
    save_checkpoint(path, tmodel)
    return model, params, np.asarray(toks), start, path


@pytest.fixture(scope="module")
def pending_world(setup):
    return start_world("sp_world", 4, ckpt=setup[4], tokens=setup[2].tolist())


@pytest.fixture(scope="module")
def jax_side(setup, pending_world):
    model, params, toks, _, _ = setup

    def loss_fn(p):
        logits, _ = model.apply(p, toks)
        return jtraining.cross_entropy_loss(logits[:, :-1], toks[:, 1:])

    logits = np.asarray(jax.jit(model.apply)(params, toks)[0])
    loss, grads = jax.jit(jax.value_and_grad(loss_fn, allow_int=True))(params)
    return dict(logits=logits, loss=float(loss), grads=_port_names(grads["params"]))


@pytest.fixture(scope="module")
def world(pending_world, jax_side):
    return pending_world.result()


@pytest.mark.parametrize("kind", KINDS)
def test_logits_match_the_jax_single_device_model(world, jax_side, kind):
    got = np.concatenate([world[r][f"{kind}_logits"] for r in range(4)], axis=1)
    np.testing.assert_allclose(got, jax_side["logits"], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_gradients_match_jax_grad(world, jax_side, kind):
    """The global loss and the gradients summed over sp: every rank holds
    the same, within f32 reordering of ``jax.grad``'s."""
    for r in range(4):
        np.testing.assert_allclose(float(world[r][f"{kind}_loss"]), jax_side["loss"], rtol=1e-6)
    names = [k.removeprefix(f"{kind}_grad_") for k in world[0] if k.startswith(f"{kind}_grad_")]
    assert sorted(names) == sorted(jax_side["grads"])
    for name in names:
        want = jax_side["grads"][name]
        for r in range(4):
            np.testing.assert_allclose(world[r][f"{kind}_grad_{name}"], want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{name} rank {r}")


def test_sp_step_matches_the_unsharded_step(setup, world):
    """dp 2 × sp 2 (ring, remat): the global loss of the unsharded step and,
    after DiodeMix, its packed codes."""
    start = setup[3]
    model = prepare_for_training(load_jax_params(
        tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, remat=True), device="cpu"), start))
    step = make_train_step(model, lm_loss(None), DiodeHyperParams(lr=1e-3))
    want = float(step(lm_batch(setup[2]))["loss"])
    for r in range(4):
        np.testing.assert_allclose(float(world[r]["dp2_sp2_loss"]), want, rtol=1e-6)
    packed = {n: b.numpy() for n, b in model.named_buffers() if n.endswith("packed")}
    for name, b in packed.items():
        for r in range(4):
            np.testing.assert_array_equal(world[r][f"dp2_sp2_after_{name}"], b, err_msg=name)


def test_a_missing_sp_axis_raises():
    """An ``sp_axis`` that ``sp_mesh`` does not lay out would run every rank
    as a world of one over positions 0..s-1: the config is refused."""
    from bitorch_engine_tpu_torch.parallel import make_axes_mesh

    cfg = tl.tiny_llama(dtype=torch.float32, sequence_parallel="ring",
                        sp_mesh=make_axes_mesh(sp=1), sp_axis="seq")
    with pytest.raises(ValueError, match="sp_axis 'seq' is not an axis of sp_mesh"):
        tl.LlamaModel(cfg, device="cpu")


@pytest.mark.parametrize("call", ["size", "coord", "group", "all_reduce"])
def test_an_axis_the_mesh_does_not_name_raises(call):
    """As the JAX ``mesh.shape[axis]``: a misnamed axis is no world of one."""
    from bitorch_engine_tpu_torch.parallel import make_axes_mesh
    from bitorch_engine_tpu_torch.parallel.comm import all_reduce

    mesh = make_axes_mesh(sp=1)
    fn = (lambda: all_reduce(mesh, torch.ones(2), "seq")) if call == "all_reduce" else (
        lambda: getattr(mesh, call)("seq"))
    with pytest.raises(KeyError, match="the mesh has no axis 'seq'"):
        fn()
