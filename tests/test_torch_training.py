"""The port's training step against the JAX package's on the CPU: a tiny
f32 Llama (the shape of ``__graft_entry__._tiny_cfg``: vocab 256, hidden
256, 2 layers, 8 MHA heads, w4 g32) trained 6 steps (so the step-5 zeros
refresh runs) by both packages' ``make_train_step`` with DiodeMix, from the
same weights (``load_jax_params`` of the JAX tree after its
``prepare_for_training``) on the same token batches.  The losses agree
within 1e-6 relative (f32 on both sides, sums in another order; they read
~9e-8) and after 6 steps every packed code is equal.  Remat on and off
give the port the same gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu import training as jtraining
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.utils.convert import prepare_for_training as jax_prepare_for_training
from bitorch_engine_tpu_torch import training
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.optim import DiodeHyperParams
from bitorch_engine_tpu_torch.utils.convert import (
    load_jax_params,
    prepare_for_inference,
    prepare_for_training,
    quantized_layers,
)

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=8,
            num_kv_heads=8, max_seq_len=64, group_size=32)
STEPS, BATCH, SEQ, LR = 6, 2, 32, 1e-3


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (BATCH, SEQ + 1)).astype(np.int32) for _ in range(STEPS)]


def _jax_run():
    model = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **TINY))
    params = jax_prepare_for_training(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    start = jax.tree_util.tree_map(np.asarray, params)

    def loss_fn(p, toks):
        logits, _ = model.apply(p, toks[:, :-1])
        return jtraining.cross_entropy_loss(logits, toks[:, 1:])

    hp = JHP(lr=LR)
    step = jtraining.make_train_step(loss_fn, hp)
    state = jtraining.create_train_state(params, hp)
    losses = []
    for toks in _batches():
        state, metrics = step(state, jnp.asarray(toks))
        losses.append(float(metrics["loss"]))
    return start, losses, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run()


def _port_model(start, **cfg):
    model = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **TINY, **cfg), device="cpu")
    return load_jax_params(model, start)


def _loss_fn(model, toks):
    logits, _ = model(toks[:, :-1])
    return training.cross_entropy_loss(logits, toks[:, 1:])


def test_training_matches_jax(jax_run):
    start, want_losses, end = jax_run
    end = end["params"]
    model = _port_model(start)
    assert all(mod.grad_shadow is not None for mod in quantized_layers(model))
    prepare_for_training(model)
    step = training.make_train_step(model, _loss_fn, DiodeHyperParams(lr=LR))
    losses = [float(step(torch.from_numpy(t).long())["loss"]) for t in _batches()]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    assert step.optimizer.step_count == STEPS
    for i in range(TINY["num_layers"]):
        for part, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                            ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                got = tpk.unpack_rows(getattr(getattr(model.layers[i], part), name).packed, 4)
                want = tpk.unpack_rows(
                    torch.from_numpy(np.array(end[f"layer_{i}"][part][name]["qweight"].packed)), 4)
                assert torch.equal(got, want), f"layer {i} {name}: packed codes differ"
    np.testing.assert_allclose(model.embed.detach().numpy(), end["embed"], rtol=1e-4, atol=1e-6)


def test_remat_gives_the_same_gradients(jax_run):
    start = jax_run[0]
    toks = torch.from_numpy(_batches()[0]).long()
    grads = []
    for remat in (False, True):
        model = prepare_for_training(_port_model(start, remat=remat))
        _loss_fn(model, toks).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) == 20
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-8, msg=name)


def test_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 64)).astype(np.float32) * 3
    labels = rng.integers(0, 64, (2, 16)).astype(np.int32)
    labels[0, :5] = logits[0, :5].argmax(-1)  # some hits
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(training.cross_entropy_loss(t_logits, t_labels)),
                               float(jtraining.cross_entropy_loss(logits, labels)), rtol=1e-6)
    assert float(training.accuracy(t_logits, t_labels)) == float(jtraining.accuracy(logits, labels))


def test_inference_mode_drops_the_shadows(jax_run):
    model = prepare_for_inference(_port_model(jax_run[0]))
    assert all(mod.grad_shadow is None for mod in quantized_layers(model))
    assert not any(p.requires_grad for p in model.parameters())
    logits, _ = model(torch.zeros((1, 8), dtype=torch.long))
    assert not logits.requires_grad
