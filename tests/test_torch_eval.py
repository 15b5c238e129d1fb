"""The port's evaluation harness (``models/eval.py``) against the JAX
package's: the deterministic byte corpus bit-equal, the chunked sequence
NLL on carried parameters within f32 rel 1e-5 (fp and quantized), one
``torch.optim.AdamW`` step against ``optax.adamw`` within 1e-6, and the
port's own perplexity gate within ``tests/test_ppl_gate.py``'s bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.models import eval as jeval
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.models import llama_loader as jloader
from bitorch_engine_tpu_torch.models import eval as teval
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.models import llama_loader as tloader
from bitorch_engine_tpu_torch.training import cross_entropy_loss
from bitorch_engine_tpu_torch.utils.convert import load_jax_params


def test_corpus_matches_jax():
    for seed in (1, 2):
        np.testing.assert_array_equal(teval.expand_corpus(5000, seed), jeval.expand_corpus(5000, seed))
    np.testing.assert_array_equal(teval.byte_corpus("train", train_bytes=10_000),
                                  jeval.byte_corpus("train", train_bytes=10_000))
    np.testing.assert_array_equal(teval.byte_corpus("eval"), jeval.byte_corpus("eval"))


FP_KW = dict(dtype=jnp.float32, quantized=False, max_seq_len=256)


@functools.lru_cache(maxsize=None)
def _jax_fp_params():
    """The JAX package's untrained fp parameters, initialized once a module
    (JAX arrays are immutable; the port copies them in)."""
    jcfg = jl.tiny_llama(**FP_KW)
    return jcfg, jl.LlamaModel(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


def _fp_pair():
    jcfg, params = _jax_fp_params()
    model = tl.LlamaModel(tl.tiny_llama(**{**FP_KW, "dtype": torch.float32}), device="cpu", seed=1)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, model


def test_sequence_nll_and_delta_match_jax():
    """Chunks of 100 predictions over 300 tokens (a short last chunk), fp and
    w4g64, on the same parameters."""
    jcfg, params, model = _fp_pair()
    tokens = np.asarray(teval.byte_corpus("eval")[:300]).reshape(1, -1)
    jmodel = jl.LlamaModel(jcfg)
    want = jeval.sequence_nll(jmodel, params, jnp.asarray(tokens), chunk=100)
    got = teval.sequence_nll(model, torch.from_numpy(tokens), chunk=100)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    qkw = dict(quantized=True, w_bit=4, group_size=64, max_seq_len=256)
    jq_cfg = jl.tiny_llama(dtype=jnp.float32, **qkw)
    jq = jloader.quantize_llama_params(params, jq_cfg)
    tq = tloader.quantize_llama_params(model, tl.tiny_llama(dtype=torch.float32, **qkw),
                                       device="cpu")
    want = jeval.perplexity_delta(jmodel, params, jl.LlamaModel(jq_cfg), jq, jnp.asarray(tokens))
    got = teval.perplexity_delta(model, tq, torch.from_numpy(tokens))
    for key in ("ppl_fp", "ppl_quant"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert got["rel_delta"] == (got["ppl_quant"] - got["ppl_fp"]) / got["ppl_fp"]


def test_adamw_step_matches_optax():
    """Two steps of ``torch.optim.AdamW(lr, weight_decay=0.01)`` on the byte
    LM's parameters against ``optax.adamw`` fed the same gradients."""
    _, _, model = _fp_pair()
    for p in model.parameters():
        p.requires_grad_(True)
    named = dict(model.named_parameters())
    tx = optax.adamw(3e-3, weight_decay=0.01)
    ref = {k: jnp.asarray(v.detach().numpy()) for k, v in named.items()}
    state = tx.init(ref)
    opt = torch.optim.AdamW(named.values(), lr=3e-3, weight_decay=0.01)
    data = teval.byte_corpus("train", train_bytes=10_000)
    for step in range(2):
        toks = torch.from_numpy(data[step * 65 : step * 65 + 2 * 65].reshape(2, 65).copy())
        opt.zero_grad()
        cross_entropy_loss(model(toks[:, :-1])[0], toks[:, 1:]).backward()
        grads = {k: jnp.asarray(v.grad.numpy()) for k, v in named.items()}
        updates, state = tx.update(grads, state, ref)
        ref = optax.apply_updates(ref, updates)
        opt.step()
    for k, v in named.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.fixture
def one_thread():
    """One intra-op thread: the trained model depends on the order of f32
    sums, which depends on the thread count, so one thread gives every
    machine the same model (and spares the other test workers' cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ppl_gate_trained_model(one_thread):
    """The port's gate on the CPU, at ``tests/test_ppl_gate.py``'s size and
    bounds: a trained model, w4 within 15% of fp, damage ordered by bits,
    bf16 metadata adding only noise."""
    out = teval.run_ppl_gate(hidden=128, layers=2, steps=250, device="cpu")
    assert out["ppl_fp"] < 30, out
    assert out["rel_delta_w4g64"] < 0.15, out
    assert out["rel_delta_w2g32"] < 1.0, out
    assert out["rel_delta_mbwq_2p5"] < 0.8, out
    assert 0.0 < out["rel_delta_w4g64"] < out["rel_delta_mbwq_2p5"] < out["rel_delta_w2g32"], out
    assert abs(out["rel_delta_w4g64_bf16meta"] - out["rel_delta_w4g64"]) < 0.02, out
    assert {f"ppl_{arm}_a8" for arm in teval.A8_ARMS} <= set(out)
