"""The fine-tune of a GPTQ-format checkpoint, on the CPU: asym MPQ
projections with an act-order ``q_perm`` trained by the port's train step
against the JAX package's.

A tiny f32 Llama (``test_torch_training.py``'s shape: vocab 256, hidden
256, 2 layers, 8 MHA heads, w4 g32) built with ``asym=True``, every
projection given a seeded ``q_perm`` (its rows stored permuted, as an
ingested act-order export holds them), prepared for training and trained 3
DiodeMix steps with ``zeros_update_interval=1`` (the integer zeros refreshed
every step) by both packages' ``make_train_step``, from the same parameters
(``load_jax_params``) and moments (``load_jax_diode_state``) on the same
batches.  The bars are the sym train-step test's: the losses within 1e-6
relative (f32 on both sides, sums in another order), and after the steps
every packed code and every integer zero equal.  DiodeMix reconstructs
each asym weight with the JAX update's arithmetic, ``s·(q − z)``, on
``reconstruct_weight``'s kernel route (``exact_asym``: kernel 2 on the
card, the plain dequantize here): its route counter says so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu import training as jtraining
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.qtensor import MPQTensor as JMPQTensor
from bitorch_engine_tpu.utils.convert import prepare_for_training as jax_prepare_for_training
from bitorch_engine_tpu_torch import training
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.optim import DiodeHyperParams
from bitorch_engine_tpu_torch.optim import diode as tdiode
from bitorch_engine_tpu_torch.utils.convert import (
    load_jax_diode_state,
    load_jax_params,
    prepare_for_training,
)

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=8,
            num_kv_heads=8, max_seq_len=64, group_size=32, asym=True)
STEPS, BATCH, SEQ, LR = 3, 2, 32, 1e-3
PROJ = (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
        ("mlp", ("gate_proj", "up_proj", "down_proj")))


def _batches():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (BATCH, SEQ + 1)).astype(np.int32) for _ in range(STEPS)]


def _with_q_perm(params):
    """Every projection's record given a seeded permutation of its rows."""
    rng = np.random.default_rng(6)

    def perm(leaf):
        if not isinstance(leaf, JMPQTensor):
            return leaf
        k = leaf.logical_shape[0]
        return leaf.replace(q_perm=jnp.asarray(rng.permutation(k).astype(np.int32)))

    return jax.tree_util.tree_map(perm, params, is_leaf=lambda x: isinstance(x, JMPQTensor))


def _jax_run():
    model = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **TINY))
    params = jax_prepare_for_training(model.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32)))
    params = _with_q_perm(params)
    hp = JHP(lr=LR, zeros_update_interval=1)
    state = jtraining.create_train_state(params, hp)
    start = jax.tree_util.tree_map(np.asarray, params)
    moments = jax.tree_util.tree_map(np.asarray, state.opt_state)

    def loss_fn(p, toks):
        logits, _ = model.apply(p, toks[:, :-1])
        return jtraining.cross_entropy_loss(logits, toks[:, 1:])

    step = jtraining.make_train_step(loss_fn, hp)
    losses = []
    for toks in _batches():
        state, metrics = step(state, jnp.asarray(toks))
        losses.append(float(metrics["loss"]))
    return start, moments, losses, jax.tree_util.tree_map(np.asarray, state.params)


def _loss_fn(model, toks):
    logits, _ = model(toks[:, :-1])
    return training.cross_entropy_loss(logits, toks[:, 1:])


def test_asym_act_order_training_matches_jax():
    start, moments, want_losses, end = _jax_run()
    model = prepare_for_training(load_jax_params(
        tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **TINY), device="cpu"), start))
    projections = [getattr(getattr(layer, part), name) for layer in model.layers
                   for part, names in PROJ for name in names]
    assert all(p.qweight.asym and p.q_perm is not None and p.grad_shadow is not None
               for p in projections)
    step = training.make_train_step(model, _loss_fn, DiodeHyperParams(lr=LR, zeros_update_interval=1))
    load_jax_diode_state(step.optimizer, moments)
    before = dict(tdiode.update_counts)
    losses = [float(step(torch.from_numpy(t).long())["loss"]) for t in _batches()]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    assert tdiode.update_counts["kernel"] - before["kernel"] == STEPS * len(projections)
    assert tdiode.update_counts["plain"] == before["plain"]
    end = end["params"]
    for i, layer in enumerate(model.layers):
        for part, names in PROJ:
            for name in names:
                mod = getattr(getattr(layer, part), name)
                want = end[f"layer_{i}"][part][name]["qweight"]
                assert torch.equal(tpk.unpack_rows(mod.packed, 4),
                                   tpk.unpack_rows(torch.from_numpy(np.array(want.packed)), 4)), \
                    f"layer {i} {name}: packed codes differ"
                assert torch.equal(tpk.unpack_cols(mod.zeros, 4),
                                   tpk.unpack_cols(torch.from_numpy(np.array(want.zeros)), 4)), \
                    f"layer {i} {name}: integer zeros differ"
    np.testing.assert_allclose(model.embed.detach().numpy(), end["embed"], rtol=1e-4, atol=1e-6)
