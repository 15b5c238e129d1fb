"""The perplexity gate: fp against w4 / w2 / MBWQ-2.5 on the trained byte LM.

    python -m bitorch_engine_tpu_torch.tools.ppl_gate [--hidden 512] [--layers 4]
        [--steps 800] [--cpu]

The counterpart of ``tools/ppl_gate.py``: it runs ``models.eval.run_ppl_gate``
(on the card unless given ``--cpu``), prints its results as JSON, then holds
them to the JAX script's bounds at its full size (hidden 512, 4 layers, 800
steps):

* ``rel_delta_w4g64 < 0.05`` and w4 below both low-bit configurations;
* MBWQ-2.5 within a 1% noise band of w2g32;
* the A8 arms within 1% of their A16 twins; the gs-64 MBWQ A8 arm within
  w2g32 + 1%; uniform w2 at g64 / g128 within w2g32 + 1.5% / + 3%.

It prints ``PPL GATE PASSED: ...`` when every bound holds, else ``PPL GATE
FAILED: ...`` with every bound that does not (the JAX script stops at the
first), and exits 1.  Smaller models than the full size may fail the bounds
(w4 costs ~8% at hidden 128, 2 layers, 250 steps).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from ..models.eval import run_ppl_gate

# (the bound, the JAX script's message when it does not hold)
BOUNDS = (
    (lambda o: o["rel_delta_w4g64"] < 0.05, lambda o: f"w4 gate FAILED: {o['rel_delta_w4g64']}"),
    (lambda o: 0.0 < o["rel_delta_w4g64"] < o["rel_delta_mbwq_2p5"], lambda o: "w4 !< mbwq2.5"),
    (lambda o: o["rel_delta_w4g64"] < o["rel_delta_w2g32"], lambda o: "w4 !< w2"),
    (lambda o: o["rel_delta_mbwq_2p5"] < o["rel_delta_w2g32"] + 0.01,
     lambda o: "mbwq2.5 exceeds w2 beyond the noise band"),
    (lambda o: o["rel_delta_mbwq_2p5_a8"] < o["rel_delta_mbwq_2p5"] + 0.01,
     lambda o: "A8 activations exceed the noise band over A16 (mbwq2.5)"),
    (lambda o: o["rel_delta_w2g32_a8"] < o["rel_delta_w2g32"] + 0.01,
     lambda o: "A8 activations exceed the noise band over A16 (w2g32)"),
    (lambda o: o["rel_delta_mbwq_2p5g64_a8"] < o["rel_delta_w2g32"] + 0.01,
     lambda o: "mbwq-2.5 gs64 exceeds the uniform-w2g32 damage band"),
    (lambda o: o["rel_delta_w2g64"] < o["rel_delta_w2g32"] + 0.015,
     lambda o: "uniform w2g64 exceeds the w2g32+1.5% damage band"),
    (lambda o: o["rel_delta_w2g128"] < o["rel_delta_w2g32"] + 0.03,
     lambda o: "uniform w2g128 exceeds the w2g32+3% damage band"),
    (lambda o: o["rel_delta_w2g64_a8"] < o["rel_delta_w2g64"] + 0.01,
     lambda o: "A8 activations exceed the noise band over A16 (w2g64)"),
    (lambda o: o["rel_delta_w2g128_a8"] < o["rel_delta_w2g128"] + 0.01,
     lambda o: "A8 activations exceed the noise band over A16 (w2g128)"),
)


def failures(out: Dict[str, float]) -> List[str]:
    """The messages of the bounds that ``out`` does not hold."""
    return [msg(out) for ok, msg in BOUNDS if not ok(out)]


def main(argv=None) -> Dict[str, float]:
    """Run the gate, print its JSON and verdict; returns the results."""
    p = argparse.ArgumentParser(prog="bitorch_engine_tpu_torch.tools.ppl_gate")
    p.add_argument("--chip", action="store_true", help="run on the card (the default)")
    p.add_argument("--cpu", action="store_true", help="run the plain path on the CPU")
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--steps", type=int, default=800)
    args = p.parse_args(argv)

    out = run_ppl_gate(hidden=args.hidden, layers=args.layers, steps=args.steps,
                       device="cpu" if args.cpu else None)
    print(json.dumps(out, indent=1))
    failed = failures(out)
    if failed:
        print("PPL GATE FAILED: " + "; ".join(failed))
    else:
        print("PPL GATE PASSED: w4 delta "
              f"{100*out['rel_delta_w4g64']:.2f}% < 5%; w4 < mbwq2.5 ~ w2; "
              f"A8 delta +{100*(out['rel_delta_mbwq_2p5_a8']-out['rel_delta_mbwq_2p5']):.2f}% vs A16")
    return out


if __name__ == "__main__":
    sys.exit(1 if failures(main()) else 0)
