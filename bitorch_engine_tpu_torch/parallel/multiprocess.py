"""Process worlds over ``torch.distributed``: the counterpart of
``bitorch_engine_tpu/parallel/multiprocess.py``.

* :func:`launch_world` spawns an N-process world (fresh interpreters, never
  forks: a forked child cannot use CUDA), each rank running one function
  ``"module:function"`` after ``init_process_group`` through a ``file://``
  store in a fresh directory, and returns each rank's results.  It joins
  under a deadline: on a failed rank or a timeout it kills the world and
  raises with every rank's log (a collective one rank skips hangs the
  others).
* :func:`multiprocess_payload` is the JAX package's battery (the tp MPQ
  linear, dp DiodeMix training of the 1-bit MLP, the tp tiny-Llama
  forward, the sharded paged batcher), whose results agree between any
  world and one process.
* :func:`launch_workers` runs the payload in a local world;
  ``python -m bitorch_engine_tpu_torch.parallel.multiprocess`` is one rank.

The JAX package's ``global_put`` has no counterpart: every rank builds the
same host values and keeps its own shard (``parallel/sharding.py``).
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["free_port", "launch_world", "launch_workers", "multiprocess_payload", "run_worker"]

PAYLOAD = "bitorch_engine_tpu_torch.parallel.multiprocess:payload_worker"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def run_worker(target: str, init_method: str, world_size: int, rank: int, out_path: str,
               kwargs: Optional[dict] = None, backend: str = "gloo",
               timeout_s: float = 300.0) -> None:
    """One rank: join the world, run ``target(**kwargs)`` (a dict of
    arrays), save its results to ``out_path`` (``.npz``), leave the world."""
    import torch.distributed as dist

    from .mesh import multihost_initialize

    torch.set_num_threads(1)
    multihost_initialize(backend=backend, init_method=init_method, world_size=world_size,
                         rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        module, name = target.split(":")
        results = getattr(importlib.import_module(module), name)(**(kwargs or {}))
        np.savez(out_path, **{k: _numpy(v) for k, v in results.items()})
    except BaseException:
        # into the log now: a peer's failure may get this rank killed in teardown
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.destroy_process_group()


def launch_world(target: str, world_size: int, kwargs: Optional[dict] = None,
                 timeout: float = 300.0, backend: str = "gloo",
                 python_path: Sequence[str] = (),
                 collective_timeout: Optional[float] = None) -> List[Dict[str, np.ndarray]]:
    """Run ``target`` (``"module:function"``, importable with the repo and
    ``python_path`` on the path) on every rank of a fresh ``world_size``
    world; returns each rank's results in rank order.  ``timeout`` bounds
    the whole world; ``collective_timeout`` (default ``timeout``) one
    collective's wait."""
    tmp = tempfile.mkdtemp(prefix="bitorch_world_")
    init = "file://" + os.path.join(tmp, "store")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO_ROOT, *python_path, env.get("PYTHONPATH", "")])
    env.setdefault("OMP_NUM_THREADS", "1")
    procs, logs = [], []
    try:
        for rank in range(world_size):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bitorch_engine_tpu_torch.parallel.multiprocess",
                 "--target", target, "--init", init, "--world-size", str(world_size),
                 "--rank", str(rank), "--out", os.path.join(tmp, f"rank{rank}.npz"),
                 "--kwargs", json.dumps(kwargs or {}), "--backend", backend,
                 "--timeout", str(collective_timeout or timeout)],
                env=env, stdout=log, stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout:.0f} s"
            elif any(p.poll() not in (None, 0) for p in procs):
                failed = "a rank failed"
            else:
                time.sleep(0.05)
        if failed is None and any(p.returncode != 0 for p in procs):
            failed = "a rank failed"
        if failed is not None:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()
            report = []
            for rank, p in enumerate(procs):
                with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                    report.append(f"rank {rank} rc={p.returncode}:\n{f.read()[-4000:]}")
            raise RuntimeError(f"world of {world_size} ({target}): {failed}\n" + "\n".join(report))
        out = []
        for rank in range(world_size):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as f:
                out.append(dict(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _load_llama(cfg, ckpt: Optional[str], seed: int, device):
    from ..models.llama import LlamaModel
    from ..utils.checkpoint import load_checkpoint
    from ..utils.convert import load_jax_params

    if ckpt is None:
        return LlamaModel(cfg, device=device, seed=seed)
    return load_jax_params(LlamaModel(cfg, device="meta"), load_checkpoint(ckpt), device=device)


def _train_mlp(X, Y, world: int, mlp_state: Optional[str], device) -> np.ndarray:
    """Item 2: the 1-bit ``QuantMLP`` (32 → 32 → 10) trained 3 DiodeMix
    steps (lr 1e-2) with the batch split over every rank (dp); the three
    global losses."""
    from ..models.mlp import QuantMLP
    from ..optim import DiodeHyperParams
    from ..training import cross_entropy_loss, make_train_step
    from ..utils.convert import prepare_for_training
    from .mesh import make_mesh

    mesh = make_mesh(dp=world)
    x, y = torch.from_numpy(X).to(device), torch.from_numpy(Y).long().to(device)
    mlp = prepare_for_training(QuantMLP(32, 32, 10, bits=1, device=device, seed=3, sample=x[:1]))
    step = make_train_step(mlp, lambda m, b: cross_entropy_loss(m(b[0]), b[1], mesh),
                           DiodeHyperParams(lr=1e-2), mesh=mesh)
    if mlp_state is not None:
        start = torch.load(mlp_state, map_location=device)
        mlp.load_state_dict(start["model"])
        step.optimizer.load_state_dict(start["diode"])
    return np.asarray([float(step((x, y))["loss"]) for _ in range(3)], np.float64)


@torch.no_grad()
def multiprocess_payload(mesh, llama_ckpt: Optional[str] = None,
                         serving_ckpt: Optional[str] = None, mlp_state: Optional[str] = None,
                         device=None) -> Dict[str, np.ndarray]:
    """The JAX package's battery on ``mesh`` (every rank returns the same
    values; so does a one-process mesh):

    1. a tp column-parallel MPQ linear (w4 g64, 256 × 128), gathered:
       ``mpq_y``, beside the plain product ``mpq_ref``;
    2. the 1-bit ``QuantMLP`` trained 3 DiodeMix steps on a batch of 64
       split over every rank of the world (dp): ``train_losses``;
    3. a tp tiny-Llama forward (f32): ``llama_logits``;
    4. the sharded paged ``ContinuousBatcher`` (int8 KV, 4 slots, 17 pages
       of 8) over six prompts: ``serving_ids``.

    The draws follow the JAX payload's generator, so the inputs are the
    same; the models come from the JAX parameters saved by
    ``utils.checkpoint.save_checkpoint`` at ``llama_ckpt`` /
    ``serving_ckpt`` and the MLP's and its DiodeMix state's ``torch.save``
    at ``mlp_state`` (``{"model", "diode"}`` state dicts), or from seeds 1,
    2 and 3.  ``device=None`` means ``cuda``; pass ``"cpu"`` for the plain
    path."""
    from ..device import resolve_device
    from ..models.generate import ContinuousBatcher
    from ..models.llama import tiny_llama
    from ..models.llama_sharding import shard_llama_params
    from ..ops.mpq_linear import mpq_linear
    from ..ops.quant import dequantize_mpq, quantize_mpq
    from .comm import all_gather
    from .sharding import mpq_column_parallel_spec, shard_record

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    out: Dict[str, np.ndarray] = {}

    # --- 1: tp-sharded MPQ linear -----------------------------------------
    w = (rng.standard_normal((256, 128)) * 0.02).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32)).to(device)
    qt = quantize_mpq(torch.from_numpy(w).to(device), w_bit=4, group_size=64)
    shard = shard_record(qt, mpq_column_parallel_spec(qt), mesh)
    out["mpq_y"] = all_gather(mesh, mpq_linear(x, shard), "tp")
    out["mpq_ref"] = x @ dequantize_mpq(qt, torch.float32)

    # --- 2: dp DiodeMix training ------------------------------------------
    X = rng.standard_normal((64, 32)).astype(np.float32)
    Y = np.argmax(X[:, :10], -1)
    with torch.enable_grad():
        out["train_losses"] = _train_mlp(X, Y, int(np.prod(list(mesh.shape.values()))),
                                         mlp_state, device)

    # --- 3: tp-sharded tiny-llama forward ----------------------------------
    cfg = tiny_llama(dtype=torch.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int64)
    model = shard_llama_params(_load_llama(cfg, llama_ckpt, 1, device), mesh)
    out["llama_logits"] = model(torch.from_numpy(toks))[0]

    # --- 4: the serving stack across the world ------------------------------
    cfg_s = tiny_llama(dtype=torch.float32, kv_cache_dtype="int8")
    model_s = shard_llama_params(_load_llama(cfg_s, serving_ckpt, 2, device), mesh)
    prompts = [rng.integers(0, cfg_s.vocab_size, size=n).tolist() for n in (4, 6, 3, 5, 7, 4)]
    batcher = ContinuousBatcher(model_s, num_slots=4, max_len=32, mesh=mesh, kv_pages=17,
                                kv_page_size=8)
    for p in prompts:
        batcher.submit(p, max_new_tokens=5)
    ids = {r.uid: r.generated for r in batcher.run()}
    out["serving_ids"] = np.asarray([ids[uid] for uid in sorted(ids)], np.int32)
    return out


def payload_worker(dp: int = 1, **kwargs) -> Dict[str, np.ndarray]:
    """One rank of :func:`launch_workers`: the payload on a ``(dp, 1,
    world / dp)`` mesh."""
    from .mesh import make_mesh

    return multiprocess_payload(make_mesh(dp=dp), **kwargs)


def launch_workers(n_processes: int = 2, timeout: float = 300.0, **kwargs) -> list:
    """The payload in a local ``n_processes`` world (``kwargs`` go to
    :func:`payload_worker`: ``device="cpu"`` for the plain path, else the
    card); each rank's results."""
    return launch_world(PAYLOAD, n_processes, kwargs, timeout=timeout)


def _main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default=PAYLOAD)
    ap.add_argument("--init", required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--kwargs", default="{}")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    run_worker(args.target, args.init, args.world_size, args.rank, args.out,
               json.loads(args.kwargs), args.backend, args.timeout)


if __name__ == "__main__":
    _main()
