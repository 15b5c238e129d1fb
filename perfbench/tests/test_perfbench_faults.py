"""A run drives its check to the end: sound, it comes out correct; with the
timed path broken underneath, not correct.  Tiny cells on the CPU; the
harness's look for a card is skipped (``run_cell`` on ``cpu``).  Serving
runs on the tiny cell's own clock (``tiny.tick``), so a seed checks the
same requests on every CPU."""

import pytest
import torch

from perfbench.lib import cells
from perfbench.lib.bench import plan
from perfbench.lib.cells import run_cell

from .tiny import tick, workspace

SEED = 2**33 + 21


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return workspace(tmp_path_factory.mktemp("faults"))


@pytest.fixture
def ticked(monkeypatch):
    tick(monkeypatch)


def run(root, cell, seconds=1.0, tracing=False):
    return run_cell(plan(cell, root), SEED, seconds, tracing, "cpu", cells.clock())


def test_serving_sound_run_is_correct(root, ticked):
    out = run(root, "tiny-rag")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ttft_p90_ms", "itl_p90_ms", "setup_s"}


def test_serving_altered_token_is_caught(root, ticked, monkeypatch):
    from bitorch_engine_tpu_torch.models import generate

    real = generate.sample_token

    def altered(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(generate, "sample_token", altered)
    out = run(root, "tiny-rag")
    assert not out["correct"], out["checks"]


def test_serving_traced_run_reads_its_metrics(root, ticked):
    out = run(root, "tiny-rag", tracing=True)
    assert out["correct"]
    got = set(out["metrics"])
    # no device on the CPU: the device-trace readers find nothing to read
    assert {"decode_step_ms.rag", "serve_mfu.rag"} <= got
    assert "prefill_matmul_roofline.rag" not in got


def test_training_sound_run_is_correct(root):
    out = run(root, "tiny-ft")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_tok_s", "setup_s"}


def test_training_frozen_state_is_caught(root, monkeypatch):
    from bitorch_engine_tpu_torch.optim.diode import DiodeMix

    monkeypatch.setattr(DiodeMix, "step", lambda self: None)
    out = run(root, "tiny-ft")
    assert not out["correct"], out["checks"]
    assert out["checks"]["change"]["value"] > out["checks"]["change"]["limit"]


def test_training_half_batch_is_caught(root, monkeypatch):
    from perfbench.lib import train_cell

    full = train_cell.lm_loss
    monkeypatch.setattr(train_cell, "lm_loss",
                        lambda model, toks: full(model, toks[: toks.shape[0] // 2]))
    out = run(root, "tiny-ft")
    assert not out["correct"], out["checks"]


def test_serving_control_is_not_correct(root, ticked):
    """The fp8 control in the program's place fails a limit the program
    keeps (tiny limits, set from tiny readings as PERF.md sets the cell's)."""
    from perfbench.lib.cells import check_serve, correct_of, run_serve

    p = plan("tiny-rag", root)
    raw = run_serve(p, SEED, 1.5, False, "cpu", cells.clock(), check=False)
    c = check_serve(p, SEED, raw["data"], raw["window"], "cpu", control=True)
    mine = {k: v for k, v in c.items() if not k.startswith("control_")}
    ctl = {k[len("control_"):]: v for k, v in c.items() if k.startswith("control_")}
    assert correct_of(mine), mine
    assert not correct_of(ctl), ctl


def test_training_control_is_not_correct(root):
    from perfbench.lib import train_cell as tc

    p = plan("tiny-ft", root)
    ref = tc.reference_readings(p, SEED, "cpu")
    ctl = tc.compare(tc.reference_readings(p, SEED, "cpu", "fp8"), ref, p.limits)
    assert any(v["value"] > v["limit"] for v in ctl.values()), ctl


def test_traced_run_fails_on_an_unclaimed_kernel(root, ticked, monkeypatch):
    """A kernel that no pattern under ``kernels/`` claims (here a fused expert kernel
    launched by no aten operator) stops a traced run: a roofline would
    leave its time out."""
    from perfbench.lib import trace as trace_lib

    real = trace_lib.load_events

    def with_mystery(path):
        events = real(path)
        span = next(e for e in events if e.get("name", "").startswith(trace_lib.SPAN_PREFIX))
        ts = float(span["ts"]) + 1.0
        events += [
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1.0,
             "args": {"correlation": 987654}},
            {"ph": "X", "cat": "kernel", "name": "void fused_moe_expert_kernel<128>(float*)",
             "ts": ts + 2.0, "dur": 5.0, "args": {"correlation": 987654}},
        ]
        return events

    monkeypatch.setattr(trace_lib, "load_events", with_mystery)
    with pytest.raises(RuntimeError, match="fused_moe_expert_kernel.*claimed by no pattern"):
        run(root, "tiny-rag", tracing=True)
