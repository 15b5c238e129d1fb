"""The port's MoE slice against the JAX package's (``tests/test_moe.py``'s
inputs): ``moe_mlp`` in both expert forms over top-k, renormalization and
capacity, the tie rule, router gradients, and a tiny f32 MoE Llama loaded
from the JAX parameters (logits, greedy tokens, the sown losses, the
checkpoint, fusing, ``generate`` and ``ContinuousBatcher``); and the
grouped expert route against the per-expert loop it replaces where the
weights are rebuilt (the loop stays the reference).

``moe_mlp`` is held to atol 1e-5 / rtol 1e-4 (``y``) and 1e-6 (``aux``,
``dropped``): both sides compute in f32 with sums in other orders.  The
Llama is held as ``test_torch_llama.py`` holds it (rtol 1e-4, an absolute
floor of 1e-4 of the largest logit), its tokens exactly.
"""

import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.models import generate as jg
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.ops import moe as jmoe
from bitorch_engine_tpu.utils import checkpoint as jckpt
from bitorch_engine_tpu_torch.models import generate as tg
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.ops import moe as tmoe
from bitorch_engine_tpu_torch.parallel.mesh import Mesh, make_axes_mesh
from bitorch_engine_tpu_torch.qtensor import MPQTensor
from bitorch_engine_tpu_torch.utils import profiling
from bitorch_engine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from bitorch_engine_tpu_torch.utils.convert import (
    load_jax_params, params_tree, prepare_for_training, quantized_layers,
)
from bitorch_engine_tpu_torch.utils.ingest import as_tensor

E, D, I = 4, 64, 128
MOE_KW = dict(moe_num_experts=4, kv_cache_dtype="int8")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ops here are tiny, and under the test
    workers' load more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record(jqt) -> MPQTensor:
    """A JAX MPQ record (numpy fields) as the port's."""
    return MPQTensor(**{f.name: as_tensor(getattr(jqt, f.name), "cpu")
                        if isinstance(getattr(jqt, f.name), np.ndarray) else getattr(jqt, f.name)
                        for f in dataclasses.fields(MPQTensor)})


def _port_experts(jexperts):
    jexperts = jax.tree_util.tree_map(np.asarray, jexperts)
    if isinstance(jexperts, tuple):
        return tuple({k: _record(v) for k, v in e.items()} for e in jexperts)
    return {k: _record(v) for k, v in jexperts.items()}


@pytest.fixture(scope="module")
def setup():
    """``tests/test_moe.py``'s experts, router and tokens, both forms."""
    experts = jmoe.init_moe_experts(jax.random.PRNGKey(0), E, D, I, w_bit=4, group_size=32,
                                    stack=False)
    router = jax.random.normal(jax.random.PRNGKey(1), (D, E), jnp.float32) * 0.5
    x = jax.random.normal(jax.random.PRNGKey(2), (16, D), jnp.float32)
    forms = {"tuple": experts, "stacked": jmoe.stack_experts(experts)}
    return forms, router, x


def _run_both(jexperts, router, x, **kw):
    jy, jaux, jdrop = jmoe.moe_mlp(x, router, jexperts, **kw)
    ty, taux, tdrop = tmoe.moe_mlp(torch.from_numpy(np.array(x)),
                                   torch.from_numpy(np.array(router)), _port_experts(jexperts), **kw)
    return (np.asarray(jy), float(jaux), float(jdrop)), (ty.numpy(), float(taux), float(tdrop))


def _assert_moe_close(want, got):
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-4)
    assert abs(got[1] - want[1]) <= 1e-6
    assert abs(got[2] - want[2]) <= 1e-6


@pytest.mark.parametrize("form", ["tuple", "stacked"])
@pytest.mark.parametrize("capacity", [None, 1.0, 0.5], ids=["dropfree", "cf1.0", "cf0.5"])
@pytest.mark.parametrize("renormalize", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_jax(setup, top_k, renormalize, capacity, form):
    forms, router, x = setup
    want, got = _run_both(forms[form], router, x, top_k=top_k, capacity_factor=capacity,
                          renormalize=renormalize)
    _assert_moe_close(want, got)
    if capacity is None:
        assert got[2] == 0.0


def test_stack_experts_matches_jax(setup):
    """The port's stacking of the tuple form is the JAX stacked form, bit for
    bit, and its slices give the tuple back; static fields must agree."""
    forms, _, _ = setup
    stacked = tmoe.stack_experts(_port_experts(forms["tuple"]))
    want = _port_experts(forms["stacked"])
    assert tmoe.num_experts(stacked) == tmoe.num_experts(forms["tuple"]) == E
    for name in tmoe.EXPERT_PROJS:
        for f in ("packed", "scales", "zeros"):
            assert torch.equal(getattr(stacked[name], f), getattr(want[name], f))
    one = tmoe._expert_slice(stacked, 2)["down"]
    assert torch.equal(one.packed, _port_experts(forms["tuple"])[2]["down"].packed)
    tup = _port_experts(forms["tuple"])
    bad = list(tup)
    bad[1] = dict(bad[1], up=bad[1]["up"].replace(group_size=64))
    with pytest.raises(ValueError, match="group_size"):
        tmoe.stack_experts(bad)


def test_init_moe_experts_forms():
    gen = torch.Generator().manual_seed(0)
    stacked = tmoe.init_moe_experts(gen, 3, D, I, w_bit=4, group_size=32, device="cpu")
    assert stacked["gate"].packed.shape == (3, D // 8, I)
    assert stacked["down"].packed.shape == (3, I // 8, D)
    tup = tmoe.init_moe_experts(gen, 3, D, I, w_bit=2, group_size=32, stack=False, device="cpu")
    assert len(tup) == 3 and tup[0]["up"].w_bit == 2 and tup[0]["up"].logical_shape == (D, I)
    meta = tmoe.init_moe_experts(None, 2, D, I, stack=False, device="meta")
    assert meta[0]["gate"].packed.is_meta


def test_skewed_router_drops_only_under_capacity():
    """``tests/test_moe.py``'s adversarial skew: every token to experts 0
    and 1; drop-free capacity drops nothing, capacity 1.0 drops routes, as
    in the JAX package."""
    experts = jmoe.init_moe_experts(jax.random.PRNGKey(3), E, D, I, w_bit=4, group_size=32,
                                    stack=False)
    router = jnp.zeros((D, E), jnp.float32).at[:, 0].set(0.2).at[:, 1].set(0.1)
    x = jax.random.normal(jax.random.PRNGKey(4), (32, D), jnp.float32)
    want, got = _run_both(experts, router, x, top_k=2, capacity_factor=None)
    _assert_moe_close(want, got)
    assert got[2] == 0.0
    want, got = _run_both(experts, router, x, top_k=2, capacity_factor=1.0)
    _assert_moe_close(want, got)
    assert got[2] > 0.0


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_tied_probabilities_pick_the_lower_expert(setup, top_k):
    """A router with tied columns (0 = 1, 2 = 3, and every column equal on
    half the tokens): ``lax.top_k`` takes the lower index first, so the
    selected experts, their capacity slots and the drops follow it."""
    forms, _, x = setup
    rng = np.random.default_rng(5)
    col = rng.normal(size=(D, 1)).astype(np.float32) * 0.3
    router = np.concatenate([col, col, -col, -col], axis=1)
    xt = np.asarray(x).copy()
    xt[::2] = 0.0  # all four probabilities equal on these tokens
    for cap in (None, 0.5):
        want, got = _run_both(forms["tuple"], jnp.asarray(router), jnp.asarray(xt), top_k=top_k,
                              capacity_factor=cap)
        _assert_moe_close(want, got)
    # the zero tokens route to experts 0 .. k-1
    idx = tmoe.route(torch.from_numpy(xt[:2]), torch.from_numpy(router), top_k)[1][0]
    assert idx.tolist() == list(range(top_k))


def test_router_gradients_match_jax(setup):
    forms, router, x = setup

    def jloss(rw):
        y, aux, _ = jmoe.moe_mlp(x, rw, forms["tuple"], top_k=2, capacity_factor=None)
        return jnp.mean(y ** 2) + 0.01 * aux

    want = np.asarray(jax.grad(jloss)(router))
    rw = torch.from_numpy(np.array(router)).requires_grad_(True)
    y, aux, _ = tmoe.moe_mlp(torch.from_numpy(np.array(x)), rw, _port_experts(forms["tuple"]),
                             top_k=2, capacity_factor=None)
    (torch.mean(y ** 2) + 0.01 * aux).backward()
    got = rw.grad.numpy()
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The grouped expert route against the per-expert loop
# ---------------------------------------------------------------------------

# the loop's reference tolerance, set from the dtype: the batched GEMM may
# sum in another order than the loop's torch.matmul (f32: a few ulps; bf16:
# an intermediate may round one bf16 ulp, 2^-8, the other way)
GROUPED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _with_q_perm(experts, seed):
    """The experts with a random act-order row permutation on every record."""
    rng = np.random.default_rng(seed)
    return tuple({name: qt.replace(q_perm=torch.from_numpy(
        rng.permutation(qt.in_features).astype(np.int32))) for name, qt in e.items()}
        for e in experts)


def _loop(monkeypatch):
    """Force the per-expert loop (what every call ran before the grouped route)."""
    monkeypatch.setattr(tmoe, "_grouped_experts", lambda *a: None)


def _counted(fn):
    with profiling.annotate("bie.test.moe") as rec:
        out = fn()
    return out, rec.counts


@pytest.mark.parametrize("mesh", [None, "ep"])
@pytest.mark.parametrize("q_perm", [False, True], ids=["stored", "q_perm"])
@pytest.mark.parametrize("capacity", [None, 1.0], ids=["dropfree", "cf1.0"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_route_equals_the_loop(setup, monkeypatch, dtype, top_k, capacity, q_perm, mesh):
    forms, router, x = setup
    experts = _port_experts(forms["tuple"])
    if q_perm:
        experts = _with_q_perm(experts, 7)
    mesh = make_axes_mesh(ep=1) if mesh else None
    xt = torch.from_numpy(np.array(x)).to(dtype)
    rw = torch.from_numpy(np.array(router))

    def run():
        return tmoe.moe_mlp(xt, rw, experts, top_k=top_k, capacity_factor=capacity, mesh=mesh)

    (y, aux, dropped), counts = _counted(run)
    assert counts["moe_grouped_rows"] == counts["moe_computed_rows"] > 0
    _loop(monkeypatch)
    (want, want_aux, want_dropped), counts = _counted(run)
    assert counts["moe_grouped_rows"] == 0
    tol = GROUPED_TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), want.float().numpy(), rtol=tol,
                               atol=tol * want.float().abs().max().item())
    assert float(aux) == float(want_aux) and float(dropped) == float(want_dropped)


def _one_hot_slots(flat_e, num_experts):
    """The slots as the route computed them before: the cumsum of the
    (T·k, E) one-hot."""
    onehot = torch.nn.functional.one_hot(flat_e, num_experts).to(torch.int32)
    return (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat_e[:, None])[:, 0]


@pytest.mark.parametrize("routes", ["random", "skewed"])
def test_slots_equal_the_one_hot_cumsum(routes):
    rng = np.random.default_rng(11)
    for n, e in ((1, 4), (37, 4), (512, 8), (2048, 8)):
        if routes == "random":
            flat = rng.integers(0, e, n)
        else:  # most routes to one expert, some experts never routed to
            flat = np.where(rng.random(n) < 0.9, e - 1, rng.integers(0, 2, n))
        flat_e = torch.from_numpy(flat.astype(np.int64))
        got = tmoe._slots(flat_e, e)
        assert got.dtype == torch.int64
        assert torch.equal(got, _one_hot_slots(flat_e, e))


@pytest.mark.parametrize("route", ["grouped", "loop"])
def test_route_is_called_once_a_call_and_its_indices_combined(setup, monkeypatch, route):
    """The harness logs each layer's experts by wrapping ``ops.moe.route``:
    every ``moe_mlp`` call calls it once by that name, on both routes, and
    combines the experts it returns (here a fixed choice, not the router's)."""
    forms, router, x = setup
    experts = _port_experts(forms["tuple"])
    xt, rw = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(router))
    choice = torch.tensor([[3, 1], [0, 2]]).repeat(xt.shape[0] // 2, 1)
    real_route, calls = tmoe.route, []

    def fixed_route(x2, router_w, top_k):
        calls.append(x2.shape)
        return real_route(x2, router_w, top_k)[0], choice

    monkeypatch.setattr(tmoe, "route", fixed_route)
    if route == "loop":
        _loop(monkeypatch)
    (y, _, _), counts = _counted(lambda: tmoe.moe_mlp(xt, rw, experts, top_k=2,
                                                        capacity_factor=None))
    assert calls == [xt.shape]
    assert (counts["moe_grouped_rows"] > 0) == (route == "grouped")
    probs = torch.softmax(xt @ rw, dim=-1)
    gates = probs.gather(1, choice)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    want = sum(gates[:, j:j + 1] * torch.cat([tmoe._expert_mlp(experts[int(e)], xt[t:t + 1])
                                                for t, e in enumerate(choice[:, j])])
               for j in range(2))
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["grouped", "autograd", "tp"])
def test_grouped_rows_count_only_on_the_grouped_route(setup, case):
    """Under autograd (a grad shadow that needs a gradient) and on a tp
    mesh the loop runs and ``moe_grouped_rows`` counts 0; on the grouped
    route it counts ``E_local·C``."""
    forms, router, x = setup
    experts = _port_experts(forms["tuple"])
    xt, rw = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(router))
    mesh = None
    if case == "autograd":
        shadow = torch.zeros(experts[2]["up"].logical_shape, requires_grad=True)
        experts = tuple(dict(e, up=e["up"].replace(grad_shadow=shadow)) if i == 2 else e
                        for i, e in enumerate(experts))
    elif case == "tp":
        # a tp axis of two whose collectives are identities: every "shard"
        # is the whole expert, so the loop computes the unsharded MLP
        mesh = Mesh(shape={"tp": 2}, rank=0, groups={"tp": None}, ranks={"tp": (0, 1)})
    (y, _, _), counts = _counted(lambda: tmoe.moe_mlp(xt, rw, experts, top_k=2,
                                                        capacity_factor=0.5, mesh=mesh))
    c = math.ceil(xt.shape[0] * 2 / E * 0.5)
    assert counts["moe_computed_rows"] == E * c
    assert counts["moe_grouped_rows"] == (E * c if case == "grouped" else 0)
    if case == "autograd":
        y.sum().backward()
        assert shadow.grad is not None and shadow.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# The tiny MoE Llama
# ---------------------------------------------------------------------------


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _variables():
    """The JAX package's variables of the tiny MoE Llama (``params`` and the
    sown ``losses``), initialized once (jitted: half the time of eager)."""
    jmodel = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **MOE_KW))
    return jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


@functools.lru_cache(maxsize=None)
def _models(**kw):
    """Both packages' tiny MoE Llama with the same parameters (``kw`` only
    changes routing fields, which hold no parameters)."""
    kw = {**MOE_KW, **kw}
    params = _variables()
    jmodel = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **kw))
    tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **kw), device="cpu", seed=1)
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _tokens(seed, b=2, s=12):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _sown(state):
    losses = state["losses"]
    return {key: [float(losses[f"layer_{i}"]["mlp"][key]) for i in range(len(losses))]
            for key in ("moe_aux", "moe_dropped")}


def _assert_losses(tmodel, want):
    got = tl.moe_losses(tmodel)
    for key in ("moe_aux", "moe_dropped"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            assert abs(float(g) - w) <= 1e-6, key


def test_moe_llama_blocks():
    _, _, tmodel = _models()
    for layer in tmodel.layers:
        assert isinstance(layer.mlp, tl.QuantMoEMLP) and len(layer.mlp.experts) == 4
    assert len(quantized_layers(tmodel)) == 2 * (1 + 3 + 4 * 3)  # q k v o + experts


def test_moe_llama_prefill_and_decode_match_jax():
    """Prefill 12 tokens into an int8 cache, then 3 greedy decode steps on
    each side: logits close, tokens identical, every layer's sown aux and
    dropped share equal to the JAX package's."""
    jmodel, params, tmodel = _models()
    b, s, cache = 2, 12, 32
    toks = _tokens(0, b, s)
    japply = jax.jit(functools.partial(jmodel.apply, mutable=["losses"]))
    jcaches = jl.init_kv_caches(jmodel.cfg, b, cache)
    (jlog, jcaches), state = japply(params, jnp.asarray(toks), kv_caches=jcaches,
                                    cache_len=jnp.zeros((), jnp.int32))
    tcaches = tl.init_kv_caches(tmodel.cfg, b, cache, device="cpu")
    with torch.no_grad():
        tlog, tcaches = tmodel(torch.from_numpy(toks).long(), kv_caches=tcaches, cache_len=0)
    _close(tlog.numpy(), jlog)
    _assert_losses(tmodel, _sown(state))
    jtok = np.asarray(jlog[:, -1].argmax(-1))
    ttok = tlog[:, -1].argmax(-1).numpy()
    assert (jtok == ttok).all()
    for i in range(3):
        pos = s + i
        (jlog, jcaches), state = japply(
            params, jnp.asarray(jtok[:, None]), positions=jnp.full((b, 1), pos, jnp.int32),
            kv_caches=jcaches, cache_len=jnp.asarray(pos, jnp.int32))
        tlog, tcaches = tl.decode_step(tmodel, torch.from_numpy(ttok[:, None]).long(), tcaches, pos)
        _close(tlog.numpy(), jlog[:, -1])
        _assert_losses(tmodel, _sown(state))
        jtok, ttok = np.asarray(jlog[:, -1].argmax(-1)), tlog.argmax(-1).numpy()
        assert (jtok == ttok).all()


def test_moe_llama_capacity_drops_are_sown():
    """A Switch capacity (0.5) drops routes in a prefill: the port's
    ``moe_losses`` report the JAX package's dropped shares."""
    jmodel, params, tmodel = _models(moe_capacity_factor=0.5)
    toks = _tokens(1, 2, 16)
    (jlog, _), state = jax.jit(functools.partial(jmodel.apply, mutable=["losses"]))(
        params, jnp.asarray(toks))
    with torch.no_grad():
        tlog, _ = tmodel(torch.from_numpy(toks).long())
    _close(tlog.numpy(), jlog)
    want = _sown(state)
    assert all(d > 0 for d in want["moe_dropped"])
    _assert_losses(tmodel, want)


def test_moe_aux_trains_the_router():
    """``moe_losses``' aux keeps its graph: a loss that adds it sends
    gradients to every router and to the experts' grad shadows."""
    _, _, base = _models()
    model = tl.LlamaModel(base.cfg, device="cpu", seed=2)
    prepare_for_training(model)
    logits, _ = model(torch.from_numpy(_tokens(2, 2, 8)).long())
    loss = logits.float().pow(2).mean() + 0.01 * sum(tl.moe_losses(model)["moe_aux"])
    loss.backward()
    for layer in model.layers:
        assert layer.mlp.router.grad.abs().max() > 0
        assert layer.mlp.experts[0].down.grad_shadow.grad.abs().max() > 0


def test_params_tree_round_trip_and_checkpoint(tmp_path):
    """``params_tree`` gives the JAX tree's shape (experts a tuple of
    ``{gate, up, down}`` records), loads back into a ``meta`` skeleton, and
    the checkpoint's spec is the JAX ``_spec_of`` of the same parameters;
    a save → load is bit-equal."""
    jmodel, params, tmodel = _models()
    toks = torch.from_numpy(_tokens(3, 1, 8)).long()
    want = tmodel(toks)[0]
    tree = params_tree(tmodel)
    experts = tree["layer_0"]["mlp"]["experts"]
    assert isinstance(experts, tuple) and len(experts) == 4
    assert set(experts[0]) == {"gate", "up", "down"}
    assert isinstance(experts[0]["gate"], MPQTensor)
    again = load_jax_params(tl.LlamaModel(tmodel.cfg, device="meta"), tree, device="cpu")
    assert torch.equal(again(toks)[0], want)

    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, tmodel)
    with open(os.path.join(path, "qtensor_spec.json")) as f:
        spec = json.load(f)
    assert spec == json.loads(json.dumps(jckpt._spec_of({"params": params["params"]})))
    restored = load_jax_params(tl.LlamaModel(tmodel.cfg, device="meta"), load_checkpoint(path),
                               device="cpu")
    assert torch.equal(restored(toks)[0], want)
    for got, ref in zip(restored.state_dict().values(), tmodel.state_dict().values()):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


def test_fuse_llama_params_leaves_experts_alone():
    """Fusing a MoE model fuses each attention's q|k|v and leaves the
    experts as they are: logits unchanged, as the JAX package's fused tree."""
    jmodel, params, _ = _models()
    model = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **MOE_KW), device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    toks = _tokens(4, 2, 8)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(toks))[0])
    experts = [layer.mlp.experts for layer in model.layers]
    fused = tl.fuse_llama_params(model)
    assert hasattr(fused.layer_0.attn, "qkv_proj") and not hasattr(fused.layer_0.attn, "q_proj")
    assert [layer.mlp.experts for layer in fused.layers] == experts
    _close(fused(torch.from_numpy(toks).long())[0].numpy(), ref)
    jfused = jl.fuse_llama_params(params["params"])
    assert isinstance(jfused["layer_0"]["mlp"]["experts"], tuple)
    tfused = tl.LlamaModel(fused.cfg, device="meta")
    load_jax_params(tfused, jax.tree_util.tree_map(np.asarray, jfused), device="cpu")
    _close(tfused(torch.from_numpy(toks).long())[0].numpy(), ref)


def test_generate_matches_jax():
    jmodel, params, tmodel = _models()
    prompt = _tokens(5, 2, 6)
    want = np.asarray(jg.generate(jmodel, params, jnp.asarray(prompt), max_new_tokens=5))
    got = tg.generate(tmodel, torch.from_numpy(prompt).long(), max_new_tokens=5)
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batcher_tokens_equal_alone_and_jax(paged):
    """Each request of a mixed queue gets the tokens it gets served alone
    (drop-free routing makes a row's output independent of the others), and
    (dense caches) the JAX package's batcher's."""
    jmodel, params, tmodel = _models()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 8, 3, 7)]
    kw = dict(num_slots=2, max_len=32)
    if paged:
        kw.update(kv_pages=9, kv_page_size=8)

    def serve(batcher, queue):
        for p in queue:
            batcher.submit(p, max_new_tokens=5)
        return [r.generated for r in sorted(batcher.run(), key=lambda r: r.uid)]

    got = serve(tg.ContinuousBatcher(tmodel, **kw), prompts)
    assert all(len(g) == 5 for g in got)
    assert got == [serve(tg.ContinuousBatcher(tmodel, **kw), [p])[0] for p in prompts]
    if not paged:
        assert got == serve(jg.ContinuousBatcher(jmodel, params, **kw), prompts)


def test_moe_model_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.tiny_llama(dtype=torch.float32, moe_num_experts=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.LlamaModel(cfg)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tmoe.init_moe_experts(None, 2, D, I)
    assert isinstance(tl.LlamaModel(cfg, device="cpu").layer_0.mlp, tl.QuantMoEMLP)


def test_mixtral_configs():
    """``mixtral_8x7b`` is the JAX package's; the serving form keeps
    Mixtral's widths with the bench's serving fields."""
    jcfg, tcfg = jl.mixtral_8x7b(), tl.mixtral_8x7b()
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    serving = tl.mixtral_8x7b_serving()
    assert (serving.hidden_size, serving.intermediate_size, serving.num_layers) == (4096, 14336, 32)
    assert (serving.moe_num_experts, serving.moe_top_k, serving.moe_capacity_factor) == (8, 2, None)
    assert (serving.w_bit, serving.group_size) == (4, 128)
    assert (serving.head_w_bit, serving.head_pad_to) == (4, 2048)
    assert serving.kv_cache_dtype == "int8" and serving.quantize_embed and serving.fuse_qkv
    assert serving.dtype == torch.bfloat16 and serving.max_seq_len == 1024
    skeleton = tl.LlamaModel(serving.replace(num_layers=1), device="meta")
    assert skeleton.layer_0.mlp.experts[7].down.packed.shape == (14336 // 8, 4096)


def _jax_at(tree, name):
    """The leaf of a JAX tree at the port's dotted ``name`` (a tuple's
    items by index: ``experts.<i>``)."""
    for key in name.split("."):
        tree = tree[int(key)] if isinstance(tree, (tuple, list)) else tree[key]
    return tree


def test_moe_diode_state_loads_and_steps_as_jax():
    """The tiny MoE Llama's DiodeMix state from the JAX package
    (``diode_init``'s tree, the experts a tuple; its moments replaced by
    random ones so that the load decides the step) and one step, the zeros
    refreshed, fed the same random gradients in each package: every packed
    code and zero of every expert and projection equal, the moments and fp
    parameters within rtol 1e-5 (f32 on both sides; XLA may contract
    multiply-adds)."""
    from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
    from bitorch_engine_tpu.optim import diode_init, diode_update
    from bitorch_engine_tpu.utils.convert import prepare_for_training as jprepare
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams, DiodeMix
    from bitorch_engine_tpu_torch.ops import packing as tpk
    from bitorch_engine_tpu_torch.utils.convert import load_jax_diode_state

    from bitorch_engine_tpu.qtensor import QTensorBase

    params = jprepare({"params": _variables()["params"]})
    rng = np.random.default_rng(4)

    def rand(shape, scale):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale)

    grads = jax.tree_util.tree_map(
        lambda x: x.replace(grad_shadow=rand(x.grad_shadow.shape, 1e-2))
        if isinstance(x, QTensorBase) else rand(x.shape, 1e-2),
        params, is_leaf=lambda x: isinstance(x, QTensorBase))
    hp = JHP(lr=1e-3, zeros_update_interval=1)  # the zeros refresh in this step
    state = diode_init(params, hp=hp)
    state = state._replace(leaf_states=jax.tree_util.tree_map(
        lambda m: jnp.abs(rand(m.shape, 1e-4)), state.leaf_states))
    new_params, new_state = jax.jit(lambda g, s, p: diode_update(g, s, p, hp))(grads, state, params)
    new_params = jax.tree_util.tree_map(np.asarray, new_params)["params"]
    new_state = jax.tree_util.tree_map(np.asarray, new_state)

    model = load_jax_params(tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **MOE_KW),
                                          device="cpu"), jax.tree_util.tree_map(np.asarray, params))
    opt = DiodeMix(prepare_for_training(model), DiodeHyperParams(lr=1e-3, zeros_update_interval=1))
    load_jax_diode_state(opt, jax.tree_util.tree_map(np.asarray, state))
    assert any(".experts." in name for name in opt.state)
    jgrads = jax.tree_util.tree_map(np.asarray, grads)["params"]
    for name, mod in opt.mpq:
        mod.grad_shadow.grad = torch.from_numpy(np.array(_jax_at(jgrads, name)["qweight"].grad_shadow
                                                         if "experts" not in name else
                                                         _jax_at(jgrads, name).grad_shadow))
    for name, p in opt.fp:
        p.grad = torch.from_numpy(np.array(_jax_at(jgrads, name)))
    opt.step()
    n_experts = 0
    for name, mod in opt.mpq:
        want = _jax_at(new_params, name)
        want = want if "experts" in name else want["qweight"]
        n_experts += ".experts." in name
        assert torch.equal(tpk.unpack_rows(mod.packed, 4),
                           tpk.unpack_rows(torch.from_numpy(np.array(want.packed)), 4)), name
        np.testing.assert_allclose(mod.zeros.numpy(), want.zeros, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert n_experts == 2 * 4 * 3
    for name, p in opt.fp:
        np.testing.assert_allclose(p.detach().numpy(), _jax_at(new_params, name), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for name, st in opt.state.items():
        jst = _jax_at(new_state.leaf_states["params"], name)
        jst = jst.get("qweight", jst) if isinstance(jst, dict) and "exp_avg_s" not in jst else jst
        for key in ("exp_avg_l", "exp_avg_s"):
            np.testing.assert_allclose(st[key].numpy(), jst[key], rtol=1e-5,
                                       atol=1e-6 * np.abs(jst[key]).max(), err_msg=f"{name} {key}")
