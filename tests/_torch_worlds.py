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
    return out


@torch.no_grad()
def llama_world(ckpt, ckpt_fused, tokens):
    """The tp forward at tp 2 (a dp 2 × tp 2 mesh) and tp 4 (fewer KV heads
    than ranks), fused and unfused, and prefill + one decode step over
    dp/tp-sharded dense caches (``test_llama_sharding.py``)."""
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
