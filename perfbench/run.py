"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process is one run: it makes the weights and the traffic from the
seed, sets up the system under test (``bitorch_engine_tpu_torch``), warms
up every shape the cell's traffic uses, measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON object as the last line of its standard output.  With ``--trace 1``
it profiles a fixed stretch of the window and reports the cell's per-layer
metrics in place of its end-to-end ones.

It refuses to measure without a CUDA card, and refuses to print a result
if JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# the JAX side of the repository: never loaded by the benchmark's process
FORBIDDEN = ("jax", "jaxlib", "flax", "bitorch_engine_tpu")


def _cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(out: dict, device_info: dict) -> dict:
    """The result line printed last on standard output: ``checks`` (each
    compared number and its limit) comes last."""
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device_info}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None, device: str = "cuda") -> int:
    args = parse(argv)
    _cache_env()
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.lib.bench import plan as make_plan
    from perfbench.lib.cells import run_cell

    plan = make_plan(args.workload, ROOT)
    if device == "cuda":
        if not torch.cuda.is_available():
            print("perfbench: no CUDA device; this benchmark measures the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < plan.chips:
            print(f"perfbench: {args.workload} needs {plan.chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
    out = run_cell(plan, args.seed, args.seconds, bool(args.trace), device, T_START)
    info = {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name() if device == "cuda" else "cpu",
            "count": plan.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if device == "cuda":
        info["power_limit"] = power_limit()
    if args.trace:
        info["busy_s"], info["window_s"] = out["busy_s"], out["window_s"]
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result_line(out, info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
