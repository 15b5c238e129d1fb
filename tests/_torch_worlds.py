"""Rank functions of the port's parallel tests, each run in a gloo world of
CPU processes by ``bitorch_engine_tpu_torch.parallel.multiprocess
.launch_world`` (one world per test module; the JAX side of each
comparison runs in the test process).  This module imports no JAX: every
rank is a fresh interpreter that loads only torch and the port.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from bitorch_engine_tpu_torch.parallel.multiprocess import launch_world

TESTS = os.path.dirname(os.path.abspath(__file__))


def run_world(target: str, world_size: int, timeout: float = 240.0, **kwargs):
    """Each rank's results of ``target`` (a function of this module)."""
    return launch_world(f"_torch_worlds:{target}", world_size, kwargs, timeout=timeout,
                        python_path=[TESTS])


def start_world(target: str, world_size: int, **kwargs) -> Future:
    """:func:`run_world` in a thread (the ranks are processes): the test
    computes its JAX side meanwhile and reads ``.result()``."""
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(run_world, target, world_size, **kwargs)
    finally:
        pool.shutdown(wait=False)


def fail_on_rank_1():
    """Rank 1 raises; rank 0 waits in a collective rank 1 never joins."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails here")
    dist.barrier()
    return {}


def load_model(cfg, ckpt):
    """A port Llama from a checkpoint written by ``save_checkpoint``."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel
    from bitorch_engine_tpu_torch.utils.checkpoint import load_checkpoint
    from bitorch_engine_tpu_torch.utils.convert import load_jax_params

    return load_jax_params(LlamaModel(cfg, device="meta"), load_checkpoint(ckpt), device="cpu")


def mk_qt(k=256, n=256, gs=64, seed=0, w_bit=4):
    """``tests/test_sharding.py``'s ``_mk_qt``, quantized by the port."""
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq

    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.02
    return quantize_mpq(torch.from_numpy(w), w_bit=w_bit, group_size=gs)


def normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@torch.no_grad()
def sharding_world():
    """Column- and row-parallel MPQ products at tp=4 (``test_sharding.py``),
    and the row shard of an act-order tensor."""
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear
    from bitorch_engine_tpu_torch.models.llama import _row_parallel
    from bitorch_engine_tpu_torch.models.llama_sharding import row_shard
    from bitorch_engine_tpu_torch.ops.mpq_linear import mpq_linear
    from bitorch_engine_tpu_torch.parallel import make_mesh, mpq_row_parallel_spec, shard_params
    from bitorch_engine_tpu_torch.parallel.comm import all_gather, all_reduce
    from bitorch_engine_tpu_torch.parallel.sharding import shard_record

    mesh = make_mesh(tp=4)
    r = mesh.coord("tp")
    qt = mk_qt()
    out = {}
    x = normal(1, (8, 256))
    local = shard_params({"q": qt}, mesh)["q"]
    out["column_packed_shape"] = np.asarray(local.packed.shape)
    out["column"] = all_gather(mesh, mpq_linear(x, local), "tp")
    x = normal(2, (8, 256))
    rows = shard_record(qt, mpq_row_parallel_spec(qt, "tp", n_shards=4), mesh)
    out["row_packed_shape"] = np.asarray(rows.packed.shape)
    part = mpq_linear(x[:, r * 64 : (r + 1) * 64].contiguous(), rows, out_dtype=torch.float32)
    out["row"] = all_reduce(mesh, part, "tp")
    perm = torch.from_numpy(np.random.default_rng(3).permutation(256).astype(np.int32))
    layer = MPQLinear(256, 256, dtype=torch.float32, qweight=qt.replace(q_perm=perm))
    out["act_order_ref"] = layer(x)
    shard = row_shard(layer, mesh, "tp", "act_order")
    out["act_order"] = _row_parallel(shard, x[:, r * 64 : (r + 1) * 64], mesh)
    # a ragged g_idx: every group's scales and zeros, this rank's rows' g_idx
    g_idx = torch.from_numpy((np.random.default_rng(4).permutation(256) // 64).astype(np.int32))
    layer = MPQLinear(256, 256, dtype=torch.float32, qweight=qt.replace(g_idx=g_idx))
    out["ragged_ref"] = layer(x)
    shard = row_shard(layer, mesh, "tp", "ragged")
    out["ragged_scales_shape"] = np.asarray(shard.scales.shape)
    out["ragged"] = _row_parallel(shard, x[:, r * 64 : (r + 1) * 64], mesh)
    return out


@torch.no_grad()
def llama_world(ckpt, ckpt_fused, tokens, variants):
    """The tp forward at tp 2 (a dp 2 × tp 2 mesh) and tp 4 (fewer KV heads
    than ranks), fused and unfused, and prefill + one decode step over
    dp/tp-sharded dense caches (``test_llama_sharding.py``); the padded
    and MoE models of ``variants`` (name → ``(cfg_kw, ckpt)``) at tp 2 and
    tp 4; the refusal of an MBWQ model."""
    from bitorch_engine_tpu_torch.models.llama import (
        LlamaModel, decode_step, init_kv_caches, prefill, tiny_llama,
    )
    from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.parallel.comm import all_gather

    cfg = tiny_llama(dtype=torch.float32)
    tokens = torch.tensor(tokens)
    meshes = {"tp2": make_mesh(dp=2, tp=2), "tp4": make_mesh(tp=4)}
    out = {}
    for key, mesh in meshes.items():
        model = shard_llama_params(load_model(cfg, ckpt), mesh)
        out[f"forward_{key}"] = model(tokens)[0]
        out[f"heads_{key}"] = np.asarray([model.layers[0].attn.n_heads,
                                          model.layers[0].attn.n_kv_heads])
        # the batch over dp, the heads over tp
        b = tokens.shape[0] // mesh.size("dp")
        rows = tokens[mesh.coord("dp") * b :][:b]
        caches = init_kv_caches(cfg, 2, 16, device="cpu", mesh=mesh)
        out[f"cache_shape_{key}"] = np.asarray(caches[0][0].shape)
        _, caches = prefill(model, rows[:, :4], caches)
        logits, _ = decode_step(model, rows[:, 4:5], caches, 4)
        out[f"decode_{key}"] = all_gather(mesh, logits, "dp", dim=0)
    fused = shard_llama_params(load_model(cfg.replace(fuse_qkv=True, fuse_gate_up=True),
                                          ckpt_fused), meshes["tp2"])
    out["forward_tp2_fused"] = fused(tokens)[0]
    # fp projections (flax Dense layers), the port's own seeded model
    fp = LlamaModel(cfg.replace(quantized=False), device="cpu", seed=3)
    out["fp_forward"] = fp(tokens)[0]
    out["fp_forward_tp2"] = shard_llama_params(fp, meshes["tp2"])(tokens)[0]
    for name, (kw, path) in variants.items():
        for key, mesh in meshes.items():
            model = shard_llama_params(load_model(tiny_llama(dtype=torch.float32, **kw), path), mesh)
            out[f"{name}_forward_{key}"] = model(tokens)[0]
            out[f"{name}_out_slices_{key}"] = np.asarray(sum(
                getattr(m, "out_slice", None) is not None for m in model.modules()))
    mbwq = LlamaModel(tiny_llama(dtype=torch.float32, mbwq_strategy=((4, 0.5), (2, 0.5)),
                                 group_size=32), device="cpu")
    try:
        shard_llama_params(mbwq, meshes["tp2"])
        out["mbwq_raises"] = np.asarray("")
    except NotImplementedError as e:
        out["mbwq_raises"] = np.asarray(str(e))
    return out


def _serve(batcher, prompts, n_new=5):
    for p in prompts:
        batcher.submit(p, max_new_tokens=n_new)
    ids = {r.uid: r.generated for r in batcher.run()}
    return np.asarray([ids[u] for u in sorted(ids)], np.int32)


SERVING_MESHES = {"2x2": dict(dp=2, tp=2), "2x1": dict(dp=2, fsdp=2, tp=1),
                  "1x2": dict(fsdp=2, tp=2)}


@torch.no_grad()
def serving_world(prompts):
    """``test_serving_sharded.py``: the batcher's tokens at (dp, tp) = (2,
    2), (2, 1) and (1, 2) over dense caches (bf16 and int8 KV), over int8
    paged pools at (2, 2) with decode chunks 1 and 4, the pages each dp
    group held, and a slot count dp does not divide.  Slots split over dp (the fourth rank of
    a dp 2 × tp 1 layout is a second copy on the fsdp axis, which serving
    leaves alone)."""
    from bitorch_engine_tpu_torch.models.generate import ContinuousBatcher
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, tiny_llama
    from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params
    from bitorch_engine_tpu_torch.parallel import make_mesh

    meshes = {key: make_mesh(**kw) for key, kw in SERVING_MESHES.items()}
    out = {}
    for kv in ("bf16", "int8"):
        cfg = tiny_llama(dtype=torch.float32, kv_cache_dtype=kv)
        for key, mesh in meshes.items():
            model = shard_llama_params(LlamaModel(cfg, device="cpu", seed=0), mesh)
            kw = dict(num_slots=4, max_len=32, mesh=mesh)
            out[f"{kv}_dense_{key}"] = _serve(ContinuousBatcher(model, **kw), prompts)
            if key != "2x2" or kv != "int8":  # the paged runs: the serving form's int8 pools
                continue
            paged = dict(kw, kv_pages=17, kv_page_size=8)
            for chunk in (1, 4):
                out[f"{kv}_paged{chunk}_{key}"] = _serve(
                    ContinuousBatcher(model, decode_chunk=chunk, **paged), prompts)
            b = ContinuousBatcher(model, **paged)
            for p in prompts:
                b.submit(p, max_new_tokens=5)
            b._admit()
            out[f"{kv}_table"] = b.allocator.table.copy()
            b.run()
            try:
                ContinuousBatcher(model, num_slots=3, max_len=32, mesh=mesh)
                out[f"{kv}_bad_split"] = np.asarray(0)
            except ValueError as e:
                out[f"{kv}_bad_split"] = np.asarray(int("divisible by dp" in str(e)))
    return out


@torch.no_grad()
def overlap_world():
    """``test_overlap.py``: the ring against dense at (w_bit, tp) = (4, 4),
    (2, 4), (8, 2), its event order, its collectives, and its refusals."""
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.parallel.comm import reset_comm_counts
    from bitorch_engine_tpu_torch.parallel.overlap import ring_row_parallel_mpq

    meshes = {4: make_mesh(tp=4), 2: make_mesh(dp=2, tp=2)}
    out = {}
    for w_bit, tp in ((4, 4), (2, 4), (8, 2)):
        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.standard_normal((1024, 512)).astype(np.float32) * 0.02)
        qt = quantize_mpq(w, w_bit=w_bit, group_size=32)
        x = torch.from_numpy(rng.standard_normal((4, 1024)).astype(np.float32))
        mesh = meshes[tp]
        trace = []
        reset_comm_counts(mesh)
        out[f"ring_w{w_bit}_tp{tp}"] = ring_row_parallel_mpq(x, qt, mesh, trace=trace)
        codes = {"product": 0, "send": 1, "recv": 2}
        out[f"trace_w{w_bit}_tp{tp}"] = np.asarray([(codes[k], s) for k, s in trace])
        out[f"comm_w{w_bit}_tp{tp}"] = np.asarray(
            [mesh.comm_counts.get(k, {}).get("calls", 0) for k in ("ring_send", "all_gather")])
    bad = {"split": quantize_mpq(torch.ones(128, 128), w_bit=4, group_size=64)}
    bad["act_order"] = mk_qt(256, 128).replace(q_perm=torch.arange(256, dtype=torch.int32))
    for name, qt in bad.items():
        try:
            ring_row_parallel_mpq(torch.ones(2, qt.in_features), qt, meshes[4])
            out[f"raises_{name}"] = np.asarray(0)
        except ValueError:
            out[f"raises_{name}"] = np.asarray(1)
    return out


# (name, kind, ranks, seed, b, h, L, d): tests/test_ring_attention.py's inputs
# at 2 and 4 ranks (L = 8 per rank), and its ring-vs-Ulysses input
ATTENTION_CASES = [
    *[(f"ring{n}", "ring", n, 0, 2, 4, 8 * n, 32) for n in (2, 4)],
    *[(f"ulysses{n}", "ulysses", n, 3, 2, 8, 8 * n, 32) for n in (2, 4)],
    *[(f"agree_{kind}", kind, 4, 4, 1, 8, 64, 16) for kind in ("ring", "ulysses")],
]


def attention_inputs(seed, b, h, L, d):
    """q, k, v as the JAX test draws them, and a cotangent for the vjp."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(3)]
    return qkv + [np.random.default_rng(seed + 100).standard_normal((b, h, L, d)).astype(np.float32)]


def attention_world():
    """``test_torch_ring_attention.py``: each case's output shard and the
    shards of its q / k / v gradients (the vjp of the cotangent) on a
    4-rank world, ``sp`` 4 or ``sp`` 2 (a dp 2 × sp 2 mesh: ranks 0 and 1
    hold the first group); Ulysses with heads the axis does not divide."""
    from bitorch_engine_tpu_torch.parallel import make_axes_mesh, ring_attention, ulysses_attention

    meshes = {4: make_axes_mesh(sp=4), 2: make_axes_mesh(dp=2, sp=2)}
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    out = {}
    for name, kind, n, seed, b, h, L, d in ATTENTION_CASES:
        mesh = meshes[n]
        i, per = mesh.coord("sp"), L // n
        q, k, v, g = (torch.from_numpy(a[:, :, i * per : (i + 1) * per].copy())
                      for a in attention_inputs(seed, b, h, L, d))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        y = fns[kind](q, k, v, mesh)
        y.backward(g)
        out[f"{name}_out"], out[f"{name}_dq"] = y.detach(), q.grad
        out[f"{name}_dk"], out[f"{name}_dv"] = k.grad, v.grad
    try:
        x = torch.zeros(1, 6, 8, 4)
        ulysses_attention(x, x, x, meshes[4])
        out["ulysses_heads_raise"] = np.asarray(0)
    except ValueError as e:
        out["ulysses_heads_raise"] = np.asarray(int("not divisible" in str(e)))
    return out


def lm_batch(tokens):
    """``(tokens, labels)``: each position's next token, the last -100 (no
    label), so a split of both along the sequence keeps every label."""
    tokens = torch.from_numpy(np.array(tokens)).long()
    return tokens, torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)], dim=1)


def lm_loss(mesh):
    from bitorch_engine_tpu_torch.training import cross_entropy_loss

    def loss_fn(model, batch):
        return cross_entropy_loss(model(batch[0])[0], batch[1], mesh)

    return loss_fn


def sp_world(ckpt, tokens):
    """``test_torch_sequence_parallel.py`` on 4 ranks: the tiny f32 Llama
    at sp 4, ring and Ulysses: its logits shard, and one DiodeMix step's
    loss and summed gradients; then a dp 2 × sp 2 ring step with remat
    (its packed codes after the step)."""
    from bitorch_engine_tpu_torch.models.llama import tiny_llama
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.parallel import make_axes_mesh
    from bitorch_engine_tpu_torch.training import make_train_step
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    batch = lm_batch(tokens)
    out = {}
    for key, kind, mesh, kw in (
        ("ring", "ring", make_axes_mesh(sp=4), {}),
        ("ulysses", "ulysses", make_axes_mesh(sp=4), {}),
        ("dp2_sp2", "ring", make_axes_mesh(dp=2, sp=2), {"remat": True}),
    ):
        cfg = tiny_llama(dtype=torch.float32, sequence_parallel=kind, sp_mesh=mesh, **kw)
        model = load_model(cfg, ckpt)
        if key != "dp2_sp2":
            with torch.no_grad():
                out[f"{key}_logits"] = model(shard_seq(batch[0], mesh))[0]
        model = prepare_for_training(model)
        step = make_train_step(model, lm_loss(mesh), DiodeHyperParams(lr=1e-3), mesh=mesh)
        out[f"{key}_loss"] = step(batch)["loss"]
        for name, p in model.named_parameters():
            out[f"{key}_grad_{name}"] = p.grad
        for name, b in model.named_buffers():
            if name.endswith("packed"):
                out[f"{key}_after_{name}"] = b
    return out


def shard_seq(t, mesh):
    """This rank's positions (dim 1) of ``t`` over ``sp``."""
    n, i = mesh.size("sp"), mesh.coord("sp")
    per = t.shape[1] // n
    return t[:, i * per : (i + 1) * per]


def pipeline_stages(case):
    """``tests/test_pipeline.py``'s stages and input, case ``outputs``,
    ``grads`` or ``quantized`` (the JAX test's draws, in its order)."""
    if case == "outputs":
        rng = np.random.default_rng(0)
        stages = [{"w": rng.standard_normal((16, 16)).astype(np.float32) * 0.3,
                   "b": rng.standard_normal(16).astype(np.float32)} for _ in range(4)]
        return stages, rng.standard_normal((8, 16)).astype(np.float32)
    if case == "grads":
        rng = np.random.default_rng(1)
        stages = [{"w": rng.standard_normal((8, 8)).astype(np.float32) * 0.3} for _ in range(4)]
        return stages, rng.standard_normal((8, 8)).astype(np.float32)
    rng = np.random.default_rng(2)
    stages = [rng.standard_normal((64, 64)).astype(np.float32) * 0.2 for _ in range(4)]
    return stages, rng.standard_normal((4, 64)).astype(np.float32)


def _stage_fns():
    import torch.nn.functional as F

    from bitorch_engine_tpu_torch.ops.mpq_linear import mpq_linear

    return {"outputs": lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
            "grads": lambda p, x: torch.tanh(x @ p["w"]),
            "quantized": lambda qt, x: F.gelu(mpq_linear(x, qt), approximate="tanh")}


def pipeline_world(tiny_tokens):
    """``test_torch_pipeline.py`` on 4 ranks: the JAX test's three cases at
    pp 4 (the output on every rank; this rank's stage gradients), and the
    tiny f32 Llama through ``pipeline_forward`` at pp 2 (a dp 2 × pp 2
    mesh) against the same model unpipelined: logits, loss gradients."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, pipeline_forward, tiny_llama
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq
    from bitorch_engine_tpu_torch.parallel import (
        make_axes_mesh, pipeline_apply, stack_stages, stage_shardings,
    )
    from bitorch_engine_tpu_torch.training import cross_entropy_loss
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    mesh = make_axes_mesh(pp=4)
    fns, out = _stage_fns(), {}
    for case, micro in (("outputs", 4), ("grads", 2), ("quantized", 4)):
        stages, x = pipeline_stages(case)
        if case == "quantized":
            stages = [quantize_mpq(torch.from_numpy(w), w_bit=4, group_size=32) for w in stages]
        else:
            stages = [{k: torch.from_numpy(v) for k, v in st.items()} for st in stages]
        mine = stage_shardings(mesh, stack_stages(stages))
        if case == "grads":
            mine["w"].requires_grad_()
        y = pipeline_apply(fns[case], mine, torch.from_numpy(x), mesh, num_microbatches=micro)
        out[f"{case}_out"] = y.detach()
        if case == "grads":
            torch.mean(y ** 2).backward()
            out["grads_w"] = mine["w"].grad

    mesh2 = make_axes_mesh(dp=2, pp=2)
    tokens, labels = lm_batch(tiny_tokens)
    model = prepare_for_training(LlamaModel(tiny_llama(dtype=torch.float32), device="cpu", seed=5))
    for key, fwd in (("plain", lambda: model(tokens)[0]),
                     ("piped", lambda: pipeline_forward(model, tokens, mesh2, num_microbatches=2))):
        model.zero_grad(set_to_none=True)
        logits = fwd()
        cross_entropy_loss(logits, labels).backward()
        out[f"llama_{key}_logits"] = logits.detach()
        for name, p in model.named_parameters():
            out[f"llama_{key}_grad_{name}"] = np.zeros(0) if p.grad is None else p.grad
    out["llama_stage"] = np.asarray(mesh2.coord("pp"))
    return out


def failing_world(where):
    """Rank 1 raises inside the pipeline's schedule (its second
    microbatch) or the ring's backward (its first block, before it sends
    its dK/dV on), while rank 0 waits on it in a collective or a receive."""
    import importlib

    from bitorch_engine_tpu_torch.parallel import make_axes_mesh, pipeline_apply, ring_attention

    # the module (the package attribute of the same name is the function)
    ring_mod = importlib.import_module("bitorch_engine_tpu_torch.parallel.ring_attention")
    rank = torch.distributed.get_rank()
    calls = []

    def fail_at(n, fn):
        def wrapped(*args, **kw):
            calls.append(1)
            if rank == 1 and len(calls) == n:
                raise RuntimeError(f"rank 1 fails in the {where}")
            return fn(*args, **kw)
        return wrapped

    if where == "pipeline":
        mesh = make_axes_mesh(pp=2)
        pipeline_apply(fail_at(2, lambda p, x: x * p), torch.tensor(2.0), torch.ones(4, 3), mesh,
                       num_microbatches=4)
    else:
        mesh = make_axes_mesh(sp=2)
        ring_mod._fa.flash_attention_bwd = fail_at(1, ring_mod._fa.flash_attention_bwd)
        x = torch.ones(1, 2, 8, 4, requires_grad=True)
        ring_attention(x, x, x, mesh).sum().backward()
    return {}


def _mpq_step(qt, x, y, mesh, hp, cut):
    """``test_optimizer_state_sharding``'s step on this rank: ``cut`` the
    record (``"tp"``: its columns; ``None``: whole, the moments' rows over
    fsdp), the loss share ``sum((x @ W - y)²) / (8 · 256)`` over its
    columns, one DiodeMix step; the packed codes gathered whole, and the
    moments' specs."""
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear
    from bitorch_engine_tpu_torch.parallel import optimizer_partition_specs, shard_params
    from bitorch_engine_tpu_torch.parallel.comm import all_gather
    from bitorch_engine_tpu_torch.optim import DiodeMix
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    local = shard_params({"q": qt}, mesh)["q"] if cut == "tp" else qt
    layer = prepare_for_training(MPQLinear(local.in_features, local.out_features,
                                           dtype=torch.float32, qweight=local))
    opt = DiodeMix(layer, hp, mesh=mesh)
    n = local.out_features
    cols = slice(mesh.coord("tp") * n, (mesh.coord("tp") + 1) * n)
    (torch.sum((layer(x) - y[:, cols]) ** 2) / y.numel()).backward()
    opt.step()
    packed = all_gather(mesh, layer.packed, "tp", dim=1)
    specs = optimizer_partition_specs(opt, fsdp_axis="fsdp" if cut is None else None)
    return packed, specs, opt.state[""]["exp_avg_l"].shape


def _regime_runs(path):
    """DiodeMix over every regime's leaves (``path``: a ``torch.save`` of
    ``{"module", "grads", "moments", "galore"}``), with and without GaLore,
    unsharded and at fsdp 4, from the JAX package's initial moments, fed
    the saved gradients; each leaf's weight after the last step."""
    import types

    from bitorch_engine_tpu_torch.optim import DiodeHyperParams, DiodeMix, GaLoreConfig
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.utils.convert import load_jax_diode_state, prepare_for_training

    payload = torch.load(path, weights_only=False)
    fsdp4 = make_mesh(fsdp=4, tp=1)
    out = {}
    for galore in (False, True):
        hp = DiodeHyperParams(lr=5e-3, galore=GaLoreConfig(rank=8) if galore else None)
        moments = payload["galore_moments" if galore else "moments"]
        for key, mesh in (("none", None), ("fsdp4", fsdp4)):
            module = prepare_for_training(torch.load(path, weights_only=False)["module"])
            for name, p in module.named_parameters():
                if name.endswith(("scale_a", "bias_a")):  # the JAX leaves have none
                    p.requires_grad_(False)
            opt = DiodeMix(module, hp, mesh=mesh)
            load_jax_diode_state(opt, types.SimpleNamespace(leaf_states=moments, step=0))
            for grads in payload["grads"]:
                for name, g in grads.items():
                    target = getattr(module, name)
                    if isinstance(target, torch.nn.Parameter):
                        target.grad = g.clone()
                    else:
                        target.grad_shadow.grad = g.clone()
                opt.step()
            tag = f"regime_{'galore' if galore else 'plain'}_{key}"
            for name, t in list(module.named_buffers()) + list(module.named_parameters()):
                if not name.endswith("grad_shadow"):
                    out[f"{tag}_{name}"] = t.detach()
            if mesh is not None:
                out[f"{tag}_splits"] = np.asarray(
                    [[n, *map(str, sp)] for n, sp in sorted(opt.splits.items())])
    return out


def training_world(regimes):
    """``test_torch_parallel_training.py`` on 4 ranks: the optimizer-state
    case at tp 4 (columns) and fsdp 4 (moment rows); the tiny f32 Llama
    trained 5 steps (the zeros refresh at step 5) at dp 2 × fsdp 2, fsdp 4
    and dp 4, and unsharded in the same process; every DiodeMix regime
    unsharded and at fsdp 4 (:func:`_regime_runs`); the refusals."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, tiny_llama
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams, DiodeMix, GaLoreConfig
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.training import make_train_step
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    out = {}
    hp = DiodeHyperParams(lr=1e-3)
    qt = mk_qt(k=128, n=256, gs=32)
    x, y = normal(7, (8, 128)), normal(8, (8, 256))
    for key, mesh, cut in (("tp4", make_mesh(tp=4), "tp"), ("fsdp4", make_mesh(fsdp=4, tp=1), None)):
        packed, specs, shape = _mpq_step(qt, x, y, mesh, hp, cut)
        out[f"opt_{key}_packed"] = packed
        out[f"opt_{key}_specs"] = np.asarray([list(specs["state"][""][k]) for k in
                                              ("exp_avg_l", "exp_avg_s")], dtype=object).astype(str)
        out[f"opt_{key}_moment_shape"] = np.asarray(shape)

    rng = np.random.default_rng(9)
    batches = [lm_batch(rng.integers(0, 256, (4, 16))) for _ in range(5)]
    meshes = {"none": None, "dp2_fsdp2": make_mesh(dp=2, fsdp=2, tp=1),
              "fsdp4": make_mesh(fsdp=4, tp=1), "dp4": make_mesh(dp=4, tp=1)}
    for key, mesh in meshes.items():
        model = prepare_for_training(LlamaModel(tiny_llama(dtype=torch.float32), device="cpu", seed=4))
        step = make_train_step(model, lm_loss(mesh), hp, mesh=mesh)
        out[f"llama_{key}_losses"] = np.asarray([float(step(b)["loss"]) for b in batches])
        for name, t in list(model.named_buffers()) + list(model.named_parameters()):
            if name.endswith(("packed", "zeros", "embed", "weight")):
                out[f"llama_{key}_{name}"] = t.detach()
        if mesh is not None and mesh.size("fsdp") > 1:
            out[f"llama_{key}_moment_rows"] = np.asarray(
                step.optimizer.state["layer_0.mlp.down_proj"]["exp_avg_l"].shape[0])

    out.update(_regime_runs(regimes))

    from bitorch_engine_tpu_torch.layers.linear import MPQLinear

    fsdp4 = meshes["fsdp4"]
    refusals = {
        # 256 rows: 64 a rank, not whole groups of 128; 198 columns: not 4 equal shares
        "groups": lambda: DiodeMix(prepare_for_training(MPQLinear(
            256, 198, group_size=128, dtype=torch.float32, device="cpu")), hp, mesh=fsdp4),
        # gate_proj (256, 512) projects on the left: 3 rows of moments
        "galore": lambda: DiodeMix(prepare_for_training(LlamaModel(
            tiny_llama(dtype=torch.float32), device="cpu")),
            DiodeHyperParams(galore=GaLoreConfig(rank=3)), mesh=fsdp4),
    }
    for name, fn in refusals.items():
        try:
            fn()
            out[f"raises_{name}"] = np.asarray("")
        except (ValueError, NotImplementedError) as e:
            out[f"raises_{name}"] = np.asarray(f"{type(e).__name__}: {e}")
    return out


def _experts_from(path, static):
    """The stacked experts saved by ``test_torch_expert_parallel.py``: one
    record a projection from its ``<proj>.<field>`` arrays."""
    from bitorch_engine_tpu_torch.qtensor import MPQTensor

    with np.load(path) as f:
        arrays = {k: torch.from_numpy(f[k]) for k in f.files}
    experts = {name: MPQTensor(**{k.split(".", 1)[1]: v for k, v in arrays.items()
                                  if k.startswith(name + ".")}, **static)
               for name in ("gate", "up", "down")}
    return experts, arrays["router"], arrays["x"]


def expert_world(path, static):
    """``test_torch_expert_parallel.py`` on 4 ranks: ``moe_mlp`` at ep 4
    (stacked and tuple forms) beside the unsharded call; a tiny f32 MoE
    Llama at ep 2 (a dp 2 × ep 2 mesh): logits, a decode step over caches
    and the gradients of a loss, before and after ``shard_llama_params``;
    the same model at ep 2 × tp 2: logits and gradients."""
    from bitorch_engine_tpu_torch.models.llama import (
        LlamaModel, decode_step, init_kv_caches, prefill, tiny_llama,
    )
    from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params
    from bitorch_engine_tpu_torch.ops.moe import _expert_slice, expert_shardings, moe_mlp
    from bitorch_engine_tpu_torch.parallel import make_axes_mesh
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    experts, router, x = _experts_from(path, static)
    mesh = make_axes_mesh(ep=4)
    forms = {"stacked": experts, "tuple": tuple(_expert_slice(experts, e) for e in range(4))}
    out = {}
    for form, ex in forms.items():
        out[f"{form}_unsharded"] = moe_mlp(x, router, ex, top_k=2, capacity_factor=None)[0]
        y, aux, dropped = moe_mlp(x, router, expert_shardings(mesh, ex), top_k=2,
                                  capacity_factor=None, mesh=mesh)
        out[f"{form}_ep"], out[f"{form}_aux"], out[f"{form}_dropped"] = y, aux, dropped

    mesh2 = make_axes_mesh(dp=2, ep=2)
    model = prepare_for_training(LlamaModel(tiny_llama(dtype=torch.float32, moe_num_experts=4),
                                            device="cpu", seed=7))
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, 256, (2, 8)))
    for key in ("unsharded", "ep"):
        if key == "ep":
            shard_llama_params(model, mesh2)
            out["experts_a_layer"] = np.asarray(len(model.layer_0.mlp.experts))
        model.zero_grad(set_to_none=True)
        logits = model(toks)[0]
        (logits ** 2).mean().backward()
        out[f"llama_{key}_logits"] = logits.detach()
        for name, p in model.named_parameters():
            if p.grad is not None and "experts" not in name:
                out[f"llama_{key}_grad_{name}"] = p.grad
        if key == "unsharded":
            out["llama_unsharded_up_grads"] = torch.stack(
                [ex.up.grad_shadow.grad for ex in model.layer_0.mlp.experts])
        e0 = mesh2.coord("ep") * 2
        for e in range(2):  # this rank's experts: 2 of 4 (global e0, e0 + 1)
            mine = model.layer_0.mlp.experts[e if key == "ep" else e0 + e]
            out[f"llama_{key}_expert{e}_grad"] = mine.up.grad_shadow.grad
        with torch.no_grad():
            caches = init_kv_caches(model.cfg, 2, 16, device="cpu")
            _, caches = prefill(model, toks[:, :6], caches)
            out[f"llama_{key}_decode"] = decode_step(model, toks[:, 6:7], caches, 6)[0]

    # ep 2 × tp 2: this rank's 2 experts, each cut over tp, and tp attention
    mesh3 = make_axes_mesh(ep=2, tp=2)
    model = shard_llama_params(prepare_for_training(LlamaModel(
        tiny_llama(dtype=torch.float32, moe_num_experts=4), device="cpu", seed=7)), mesh3)
    logits = model(toks)[0]
    (logits ** 2).mean().backward()
    out["llama_ep_tp_logits"] = logits.detach()
    for name, p in model.named_parameters():
        if p.grad is not None and "experts" not in name and "_proj" not in name:
            out[f"llama_ep_tp_grad_{name}"] = p.grad
    for e in range(2):
        out[f"llama_ep_tp_expert{e}_grad"] = model.layer_0.mlp.experts[e].up.grad_shadow.grad
    out["llama_ep_tp_inter"] = np.asarray(model.layer_0.mlp.experts[0].up.qweight.out_features)
    return out


TP_MESHES = {"tp4": dict(tp=4), "dp2_tp2": dict(dp=2, tp=2), "fsdp2_tp2": dict(fsdp=2, tp=2)}


def tp_training_world(ckpt, cfg_kw, batches, lr, interval):
    """``test_torch_tp_training.py`` on 4 ranks: the tiny f32 Llama (JAX
    start weights from ``ckpt``) prepared for training, cut by
    ``shard_llama_params`` and trained ``len(batches)`` DiodeMix steps at
    each layout of :data:`TP_MESHES` (one ``(dp, fsdp, tp)`` mesh for the
    model and the step) and unsharded (``none``): the losses, the first
    step's gradients and the shards after the last step; then the act-order row shard's backward at
    tp 4 beside the unsharded layer's."""
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear
    from bitorch_engine_tpu_torch.models.llama import _row_parallel, tiny_llama
    from bitorch_engine_tpu_torch.models.llama_sharding import row_shard, shard_llama_params
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.training import make_train_step
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    cfg = tiny_llama(dtype=torch.float32, **cfg_kw)
    hp = DiodeHyperParams(lr=lr, zeros_update_interval=interval)
    out = {}
    for key, sizes in [("none", None)] + list(TP_MESHES.items()):
        mesh = None if sizes is None else make_mesh(**sizes)
        model = prepare_for_training(load_model(cfg, ckpt))
        if mesh is not None:
            shard_llama_params(model, mesh)
        step = make_train_step(model, lm_loss(mesh), hp, mesh=mesh)
        losses = []
        for i, toks in enumerate(batches):
            toks = torch.tensor(toks)
            losses.append(float(step((toks[:, :-1], toks[:, 1:]))["loss"]))
            if i == 0:
                for name, p in model.named_parameters():
                    out[f"{key}_grad_{name}"] = p.grad
        out[f"{key}_losses"] = np.asarray(losses)
        for name, t in list(model.named_buffers()) + list(model.named_parameters()):
            if not name.endswith("grad_shadow"):
                out[f"{key}_{name}"] = t.detach()

    mesh, x = make_mesh(tp=4), normal(11, (8, 256))
    r = mesh.coord("tp")
    perm = torch.from_numpy(np.random.default_rng(12).permutation(256).astype(np.int32))
    layer = prepare_for_training(MPQLinear(256, 256, dtype=torch.float32,
                                           qweight=mk_qt(seed=13).replace(q_perm=perm)))
    c = normal(14, (8, 256))
    xs = {"unsharded": x.clone().requires_grad_(),
          "sharded": x[:, r * 64 : (r + 1) * 64].clone().requires_grad_()}
    for key, xi in xs.items():
        mod = layer if key == "unsharded" else row_shard(layer, mesh, "tp", "act_order")
        y = mod(xi) if key == "unsharded" else _row_parallel(mod, xi, mesh)
        (y * c).sum().backward()
        out[f"act_order_{key}_x_grad"] = xi.grad
        out[f"act_order_{key}_w_grad"] = mod.grad_shadow.grad
        out[f"act_order_{key}_y"] = y.detach()
    out["act_order_rows"] = row_shard(layer, mesh, "tp", "act_order").tp_rows
    return out


def _act_order_llama(asym):
    """The tiny f32 Llama (``asym`` projections) with a seeded ``q_perm`` on
    every projection (an ingested act-order export's stored rows), prepared
    for training."""
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, tiny_llama
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    model = LlamaModel(tiny_llama(dtype=torch.float32, asym=asym), device="cpu", seed=4)
    rng = np.random.default_rng(15)
    for mod in model.modules():
        if isinstance(mod, MPQLinear):
            perm = rng.permutation(mod.qweight.in_features).astype(np.int32)
            mod.set_qweight(mod.qweight.replace(q_perm=torch.from_numpy(perm)))
    return prepare_for_training(model)


ACT_ORDER_MESHES = {"none": None, "fsdp4": dict(fsdp=4), "dp2_tp2": dict(dp=2, tp=2),
                    "dp2_fsdp2": dict(dp=2, fsdp=2)}


def act_order_training_world(records):
    """``test_torch_act_order_training.py`` on 4 ranks.

    * fsdp: the act-order tiny Llama, sym and asym, trained 3 steps with the
      zeros refreshed every step, unsharded, at fsdp 4, at dp 2 (a dp 2 × tp
      2 mesh, the model not cut: tp ranks are replicas) and at dp 2 × fsdp
      2; every packed word, zero and parameter after the steps, the losses
      and layer 0's splits;
    * tp: each act-order record of ``records`` (a ``torch.save`` of
      ``{"records": {name: fields}, "grad", "lr"}``) as one layer, one
      DiodeMix step at a refresh, unsharded and as this rank's tp 2 row
      shard (``row_shard`` on a dp 2 × tp 2 mesh) fed its rows of the same
      gradient."""
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear
    from bitorch_engine_tpu_torch.models.llama_sharding import row_shard
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams, DiodeMix
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.qtensor import MPQTensor
    from bitorch_engine_tpu_torch.training import make_train_step
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    out = {}
    hp = DiodeHyperParams(lr=1e-3, zeros_update_interval=1)
    rng = np.random.default_rng(16)
    batches = [lm_batch(rng.integers(0, 256, (4, 16))) for _ in range(3)]
    for asym in (False, True):
        for key, sizes in ACT_ORDER_MESHES.items():
            tag = f"{'asym' if asym else 'sym'}_{key}"
            mesh = None if sizes is None else make_mesh(**sizes)
            model = _act_order_llama(asym)
            step = make_train_step(model, lm_loss(mesh), hp, mesh=mesh)
            out[f"{tag}_losses"] = np.asarray([float(step(b)["loss"]) for b in batches])
            for name, t in list(model.named_buffers()) + list(model.named_parameters()):
                if not name.endswith("grad_shadow"):
                    out[f"{tag}_{name}"] = t.detach()
            out[f"{tag}_splits"] = np.asarray(
                [[n, *map(str, sp)] for n, sp in sorted(step.optimizer.splits.items())
                 if n.startswith("layer_0.")])

    payload = torch.load(records, weights_only=False)
    mesh = make_mesh(dp=2, tp=2)
    r = mesh.coord("tp")
    out["tp_coord"] = np.asarray(r)
    hp = DiodeHyperParams(lr=payload["lr"], zeros_update_interval=1)
    grad = payload["grad"]
    for name, fields in payload["records"].items():
        for key in ("none", "tp2"):
            # a fresh copy: the step writes the layer's buffers in place
            qt = MPQTensor(**{f: v.clone() if isinstance(v, torch.Tensor) else v
                              for f, v in fields.items()})
            layer = prepare_for_training(MPQLinear(qt.in_features, qt.out_features,
                                                   dtype=torch.float32, qweight=qt))
            if key == "tp2":
                layer = row_shard(layer, mesh, "tp", name)
                rows = getattr(layer, "tp_rows", None)
                k = layer.qweight.in_features
                layer.grad_shadow.grad = (grad[r * k : (r + 1) * k] if rows is None
                                          else grad[rows]).clone()
            else:
                layer.grad_shadow.grad = grad.clone()
            DiodeMix(layer, hp, mesh=mesh if key == "tp2" else None).step()
            out[f"tp_{name}_{key}_packed"] = layer.packed.clone()
            out[f"tp_{name}_{key}_zeros"] = layer.zeros.clone()
            out[f"tp_{name}_{key}_groups"] = np.asarray(layer.scales.shape[0])
    return out
