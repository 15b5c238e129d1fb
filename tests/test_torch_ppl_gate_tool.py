"""The port's perplexity-gate tool (``tools/ppl_gate.py``) at its smallest
settings on the CPU: it runs ``run_ppl_gate`` (held against the JAX
package in ``test_torch_eval.py``), prints its results as JSON and the JAX
script's verdict; and its bounds are the JAX script's."""

import json

import pytest
import _torch_threads  # noqa: F401  (one torch thread a test process)

from bitorch_engine_tpu_torch.models import eval as teval
from bitorch_engine_tpu_torch.tools import ppl_gate


def test_tool_runs_and_prints_its_verdict(capsys):
    out = ppl_gate.main(["--hidden", "128", "--layers", "1", "--steps", "1", "--cpu"])
    text = capsys.readouterr().out
    body, verdict = text.rsplit("}\n", 1)
    assert json.loads(body + "}") == out
    assert {"train_loss", "ppl_fp", "rel_delta_w4g64", "rel_delta_w4g64_bf16meta"} <= set(out)
    assert {f"rel_delta_{arm}_a8" for arm in teval.A8_ARMS} <= set(out)
    failed = ppl_gate.failures(out)
    if failed:
        assert verdict == "PPL GATE FAILED: " + "; ".join(failed) + "\n"
    else:
        assert verdict.startswith("PPL GATE PASSED: w4 delta ")


def _passing():
    out = {f"rel_delta_{k}": 0.02 for k in (
        "mbwq_2p5", "mbwq_2p5_a8", "w2g32_a8", "mbwq_2p5g64_a8", "w2g64", "w2g128", "w2g64_a8",
        "w2g128_a8")}
    out.update(rel_delta_w4g64=0.01, rel_delta_w2g32=0.03)
    return out


@pytest.mark.parametrize("change, message", [
    ({"rel_delta_w4g64": 0.06}, "w4 gate FAILED: 0.06"),
    ({"rel_delta_w4g64": -0.01}, "w4 !< mbwq2.5"),
    ({"rel_delta_mbwq_2p5": 0.05}, "mbwq2.5 exceeds w2 beyond the noise band"),
    ({"rel_delta_w2g32_a8": 0.045}, "A8 activations exceed the noise band over A16 (w2g32)"),
    ({"rel_delta_w2g128": 0.07}, "uniform w2g128 exceeds the w2g32+3% damage band"),
])
def test_bounds_are_the_jax_scripts(change, message):
    assert ppl_gate.failures(_passing()) == []
    assert message in ppl_gate.failures({**_passing(), **change})
