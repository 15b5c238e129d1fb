"""Tensor-parallel Llama in the port against the JAX package's
(``tests/test_llama_sharding.py``): the Megatron specs, the tp forward, and
decode over dp/tp-sharded caches on ``tiny_llama(dtype=float32)``, against
JAX's sharded result and the port's unsharded one at 5e-4; the fused model
against the unfused one; a padded model (``proj_pad_to=384``) and a MoE
model (4 experts, each cut as the dense MLP) at tp 2 and tp 4 against the
JAX ``apply`` on dp 2 × tp 4 sharded parameters, at the same 5e-4; an
MBWQ model refused (the JAX package's row rule cannot take one either).

The JAX parameters are carried over with ``load_jax_params`` and saved with
``save_checkpoint``; a gloo world of 4 CPU processes loads them, cuts each
rank's part with ``shard_llama_params`` at tp 2 (a dp 2 × tp 2 mesh) and tp
4 (4 query heads, 2 KV heads: each KV head on two ranks), once for the
module (``_torch_worlds.llama_world``).  The JAX side runs on the 8 virtual
CPU devices, jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import start_world
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.models.llama_sharding import llama_partition_specs as jspecs
from bitorch_engine_tpu.models.llama_sharding import kv_cache_shardings as jkv_shardings
from bitorch_engine_tpu.models.llama_sharding import shard_llama_params as jshard
from bitorch_engine_tpu.parallel import make_mesh as jmake_mesh
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.models.llama_sharding import (
    kv_cache_shardings,
    llama_partition_specs,
    paged_kv_shardings,
)
from bitorch_engine_tpu_torch.models.paged_kv import init_paged_kv_caches
from bitorch_engine_tpu_torch.parallel import P
from bitorch_engine_tpu_torch.parallel.mesh import Mesh
from bitorch_engine_tpu_torch.utils.checkpoint import save_checkpoint
from bitorch_engine_tpu_torch.utils.convert import load_jax_params

TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jl.tiny_llama(dtype=jnp.float32)
    model = jl.LlamaModel(cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0, cfg.vocab_size)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), tokens)
    tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32), device="cpu", seed=1)
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return cfg, model, np.asarray(tokens), params, tmodel, tmp_path_factory.mktemp("llama_tp")


@pytest.fixture(scope="module")
def jax_side(setup, pending_world):
    """The JAX package's forward on tp-sharded parameters (dp 2 × tp 4) and
    its decode step over dp/fsdp/tp-sharded caches (dp 2 × fsdp 2 × tp 2),
    computed while the world runs."""
    cfg, model, tokens, params, _, _ = setup
    out = {}
    mesh = jmake_mesh(dp=2, tp=4)
    with mesh:
        out["forward"] = np.asarray(jax.jit(model.apply)(jshard(params, mesh), tokens)[0])
    mesh = jmake_mesh(dp=2, fsdp=2, tp=2)
    caches = [
        (jax.device_put(k, sk), jax.device_put(v, sv))
        for (k, v), (sk, sv) in zip(jl.init_kv_caches(cfg, 2, 16),
                                    jkv_shardings(mesh, cfg.num_layers))
    ]
    sharded = jshard(params, mesh)
    with mesh:
        _, caches = jax.jit(lambda p, t, c: jl.prefill(model, p, t, c))(sharded, tokens[:, :4], caches)
        step, _ = jax.jit(lambda p, t, c: jl.decode_step(model, p, t, c, jnp.asarray(4, jnp.int32)))(
            sharded, tokens[:, 4:5], caches)
    out["decode"] = np.asarray(step)
    return out


@pytest.fixture(scope="module")
def port_side(setup, pending_world):
    """The port's unsharded forward and decode step on the same parameters."""
    cfg, _, tokens, _, tmodel, _ = setup
    toks = torch.tensor(tokens).long()
    with torch.no_grad():
        out = {"forward": tmodel(toks)[0].numpy()}
        caches = tl.init_kv_caches(tmodel.cfg, 2, 16, device="cpu")
        _, caches = tl.prefill(tmodel, toks[:, :4], caches)
        out["decode"] = tl.decode_step(tmodel, toks[:, 4:5], caches, 4)[0].numpy()
    return out


VARIANTS = {"padded": dict(proj_pad_to=384), "moe": dict(moe_num_experts=4)}


@pytest.fixture(scope="module")
def variants(setup):
    """Each variant's JAX model and parameters, saved for the world."""
    _, _, tokens, _, _, tmp = setup
    out = {}
    for name, kw in VARIANTS.items():
        model = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **kw))
        params = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.asarray(tokens))
        tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **kw), device="cpu")
        load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
        save_checkpoint(str(tmp / name), tmodel)
        out[name] = (model, params, str(tmp / name))
    return out


@pytest.fixture(scope="module")
def pending_world(setup, variants):
    _, _, tokens, _, tmodel, tmp = setup
    save_checkpoint(str(tmp / "unfused"), tmodel)
    fused = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32), device="cpu", seed=1)
    fused.load_state_dict(tmodel.state_dict())
    save_checkpoint(str(tmp / "fused"), tl.fuse_llama_params(fused))
    return start_world("llama_world", 4, ckpt=str(tmp / "unfused"),
                       ckpt_fused=str(tmp / "fused"), tokens=tokens.tolist(),
                       variants={name: (VARIANTS[name], path)
                                 for name, (_, _, path) in variants.items()})


@pytest.fixture(scope="module")
def jax_variants(setup, variants, pending_world):
    """Each variant's JAX forward on dp 2 × tp 4 sharded parameters."""
    tokens = setup[2]
    mesh = jmake_mesh(dp=2, tp=4)
    out = {}
    with mesh:
        for name, (model, params, _) in variants.items():
            out[name] = np.asarray(jax.jit(model.apply)(jshard(params, mesh), tokens)[0])
    return out


@pytest.fixture(scope="module")
def world(pending_world, jax_side, port_side):
    return pending_world.result()


def test_specs_follow_megatron_layout(setup):
    *_, tmodel, _ = setup
    p = llama_partition_specs(tmodel)["layer_0"]
    assert p["attn"]["q_proj"]["qweight"].packed == P(None, "tp")
    assert p["attn"]["o_proj"]["qweight"].packed == P("tp", None)
    assert p["mlp"]["gate_proj"]["qweight"].packed == P(None, "tp")
    assert p["mlp"]["down_proj"]["qweight"].packed == P("tp", None)


def test_specs_are_the_jax_packages(setup):
    """Every record field's spec, every fp leaf's: the JAX package's."""
    _, _, _, params, tmodel, _ = setup
    want = jspecs(params)["params"]
    got = llama_partition_specs(tmodel)

    def walk(g, w, path):
        if isinstance(g, dict):
            assert set(g) == set(w), path
            for k in g:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(g, P):
            assert tuple(g) == tuple(w), path
        else:
            for f in ("packed", "scales", "zeros"):
                assert tuple(getattr(g, f)) == tuple(getattr(w, f)), (path, f)

    walk(got, want, "")


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
@pytest.mark.parametrize("against", ["jax_sharded", "port_unsharded"])
def test_tp_forward_matches_single_device(world, jax_side, port_side, tp, against):
    want = (jax_side if against == "jax_sharded" else port_side)["forward"]
    for rank in world:
        np.testing.assert_allclose(rank[f"forward_{tp}"], want, **TOL)


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
def test_local_heads(world, tp):
    """tp 2: 2 query heads and 1 KV head a rank; tp 4: 1 query head and the
    KV head it reads; the caches hold those heads and the dp share."""
    heads = {"tp2": (2, 1), "tp4": (1, 1)}[tp]
    batch = {"tp2": 1, "tp4": 2}[tp]
    for rank in world:
        assert tuple(rank[f"heads_{tp}"]) == heads
        assert tuple(rank[f"cache_shape_{tp}"]) == (batch, 16, heads[1], 64)


def test_fused_matches_unfused(world):
    """The fused q|k|v and gate|up, cut per part and re-fused on the rank,
    give the unfused tp model's logits."""
    for rank in world:
        np.testing.assert_allclose(rank["forward_tp2_fused"], rank["forward_tp2"], **TOL)


def test_fp_projections_shard(world):
    """A model of fp projections (flax ``Dense``) cut the same way: its tp
    logits are its unsharded ones."""
    for rank in world:
        np.testing.assert_allclose(rank["fp_forward_tp2"], rank["fp_forward"], **TOL)


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
@pytest.mark.parametrize("against", ["jax_sharded", "port_unsharded"])
def test_tp_decode_with_sharded_caches(world, jax_side, port_side, tp, against):
    want = (jax_side if against == "jax_sharded" else port_side)["decode"]
    for rank in world:
        np.testing.assert_allclose(rank[f"decode_{tp}"], want, **TOL)


def stand_in_mesh(dp: int, tp: int, rank: int = 0):
    """A rank's view of a dp × tp layout without a process group: enough
    for the cache builders, which only read sizes and coordinates."""
    grid = np.arange(dp * tp).reshape(dp, 1, tp)
    ranks = dict(dp=tuple(grid[:, 0, rank % tp]), fsdp=(rank,), tp=tuple(grid[rank // tp, 0]))
    return Mesh(shape=dict(dp=dp, fsdp=1, tp=tp), rank=rank,
                groups={a: None for a in ranks}, ranks=ranks)


def test_cache_specs():
    """Pools split KV heads over tp; slots and the page table over dp; the
    int8 scale caches keep a rank's own heads.  The builders cut the caches
    by these specs: at dp 2 × tp 2 each rank holds half the slots and half
    the KV heads (the int8 scale halves at its head count), and at tp 4 on
    2 KV heads one head."""
    dense = kv_cache_shardings(2, "int8")
    assert len(dense) == 2 and dense[0][0] == P("dp", None, "tp", None)
    assert dense[0][2] == P("dp", None, "tp")
    cfg = tl.tiny_llama(dtype=torch.float32, kv_cache_dtype="int8")
    specs = paged_kv_shardings(init_paged_kv_caches(cfg, 5, 8, 2, 2, device="cpu"))
    assert specs[0].k_pool == P(None, None, "tp") and specs[0].page_table == P("dp", None)
    assert specs[0].k_scale == P("dp", None, "tp")
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    for (dp, tp), heads in (((2, 2), nkv // 2), ((1, 4), 1)):
        mesh = stand_in_mesh(dp, tp)
        k, v, s = tl.init_kv_caches(cfg, 4, 16, device="cpu", mesh=mesh)[0]
        assert k.shape == v.shape == (4 // dp, 16, heads, hd)
        assert s.shape == (4 // dp, 16, 2 * heads)
        c = init_paged_kv_caches(cfg, 5, 8, 4, 2, device="cpu", mesh=mesh)[0]
        assert c.k_pool.shape == c.v_pool.shape == (5, 8, heads * hd)
        assert c.k_scale.shape == c.v_scale.shape == (4 // dp, 16, heads)
        assert c.page_table.shape == (4 // dp, 2) and c.kv_heads == heads


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_padded_and_moe_models_shard(world, jax_variants, variant, tp):
    """A padded model's shards hold logical columns only (no ``out_slice``
    left); a MoE model's experts are cut as the dense MLP.  Both give the
    JAX package's sharded logits."""
    for rank in world:
        np.testing.assert_allclose(rank[f"{variant}_forward_{tp}"], jax_variants[variant], **TOL)
        assert int(rank[f"{variant}_out_slices_{tp}"]) == 0


def test_mbwq_model_is_refused(world):
    for rank in world:
        assert "MBWQ projections is not a feature of the JAX package" in str(rank["mbwq_raises"])
