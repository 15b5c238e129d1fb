"""Readings that set a cell's limits: the program's, the control's, a fault's.

    python3 perfbench/tools/control.py --workload <cell> --seeds a,b,c --seconds 10 [--fault F]

For each seed, in one process (set-up is long), runs the cell as the
benchmark does (a short window at the cell's own load and sizes) and
prints one JSON line with every number the check compares:

* a serving cell: the program's served-token and routing numbers, and the
  control's (the fp8 reference routing itself, its first token at each
  position of the same prompts and tokens, judged by the f32 reference
  along its routes);
* a training cell: the program's ``loss``, ``grad``, ``moments`` and
  ``change`` gaps, and the same four for the control (the fp8 reference
  in the program's place; skipped with ``--no-control``) against the f32
  reference; ``--fault half_batch`` runs the
  program on half of each batch (the mean over the rest), ``--fault
  frozen`` with an optimizer step that leaves the state unchanged.

The benchmark's own runs never run the control.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def serve_readings(plan, seed, seconds):
    from perfbench.lib.cells import check_serve, run_serve

    raw = run_serve(plan, seed, seconds, False, "cuda", time.perf_counter(), check=False)
    c = check_serve(plan, seed, raw["data"], raw["window"], "cuda", control=True)
    return {k: v["value"] for k, v in c.items()}


def plant(fault) -> None:
    """Break the timed path underneath, once for the process."""
    from perfbench.lib import train_cell as tc

    if fault == "half_batch":
        full = tc.lm_loss
        tc.lm_loss = lambda model, toks: full(model, toks[: toks.shape[0] // 2])
    elif fault == "frozen":
        from bitorch_engine_tpu_torch.optim.diode import DiodeMix

        DiodeMix.step = lambda self: None


def train_readings(plan, seed, seconds, fault, control):
    from perfbench.lib import train_cell as tc

    raw = tc.run_train(plan, seed, seconds, False, "cuda", time.perf_counter(), check=False)
    d = raw["data"]
    ref = tc.reference_readings(plan, seed, "cuda")
    prog = tc.check_train(plan, seed, d["losses"], d["first"], d["moments"], d["after"], "cuda",
                          ref=ref)
    out = {k: v["value"] for k, v in prog.items()}
    if fault is None and control:
        ctl = tc.reference_readings(plan, seed, "cuda", "fp8")
        out.update({f"control_{k}": v["value"] for k, v in tc.compare(ctl, ref, plan.limits).items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=("half_batch", "frozen"), default=None)
    ap.add_argument("--no-control", action="store_true",
                    help="a training cell: the program's readings alone")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.lib.bench import plan as make_plan

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    plan = make_plan(args.workload, ROOT)
    plant(args.fault)
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        if plan.mix["kind"] == "closed_loop":
            out = serve_readings(plan, seed, args.seconds)
        else:
            out = train_readings(plan, seed, args.seconds, args.fault, not args.no_control)
        out.update(workload=args.workload, seed=seed, fault=args.fault,
                   seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
