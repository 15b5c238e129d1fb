"""The port's profiling module (``utils/profiling.py``, over
``torch.profiler``) against the JAX package's: the same roofline
arithmetic, and the port's own trace, annotation and trace-table paths on
the CPU."""

import json
import os

import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread a test process)

from bitorch_engine_tpu.utils import profiling as jp
from bitorch_engine_tpu_torch.utils import profiling as tp

# (name, seconds, bytes, flops): JAX test_profiling.py's memory-bound GEMV
# and compute-bound matmul, and a record with neither
RECORDS = [
    ("bf16_gemv", 47.4e-6, 4096 * 4096 * 2, 2 * 8 * 4096 * 4096),
    ("mm", 150e-6, 50e6, 17.2e9),
    ("empty", 0.0, 0, 0),
    ("balanced", 1e-3, 50_000_000, 1_000_000_000),
]


def _report(mod, chip):
    r = mod.RooflineReport(chip=chip)
    for rec in RECORDS:
        r.add(*rec)
    return r


def test_roofline_summary_matches_jax():
    got, want = _report(tp, "cpu"), _report(jp, "cpu")
    assert got.summary() == want.summary()
    assert json.loads(got.dump()) == json.loads(want.dump())
    bounds = {s["name"]: s["bound"] for s in got.summary()}
    assert bounds["mm"] == "compute" and bounds["empty"] == "memory"


def test_roofline_on_the_card_peaks(tmp_path):
    """The H100 entry: 33.5 MB in 12.5 us is ~2684 GB/s, memory-bound, ~80%
    of 3350 GB/s; 17.2 GFLOP in 25 us is compute-bound at ~70% of 989."""
    assert tp.CHIP_SPECS["h100"] == {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                                     "int8_tops": 1979.0}
    assert tp.CHIP_SPECS["cpu"] == jp.CHIP_SPECS["cpu"]
    assert set(tp.CHIP_SPECS) == {"h100", "cpu"}
    r = tp.RooflineReport(chip="h100")
    r.add("gemv", 12.5e-6, bytes_accessed=4096 * 4096 * 2, flops=2 * 8 * 4096 * 4096)
    r.add("mm", 25e-6, bytes_accessed=50e6, flops=17.2e9)
    gemv, mm = r.summary()
    assert gemv["bound"] == "memory" and 79 < gemv["pct_of_roofline"] < 81
    assert mm["bound"] == "compute" and 69 < mm["pct_of_roofline"] < 71
    path = str(tmp_path / "r.json")
    r.dump(path)
    assert json.load(open(path))["chip"] == "h100"


def test_detect_chip_is_cpu_here():
    assert tp.detect_chip() == "cpu"
    assert tp.RooflineReport().chip == "cpu"


def _events(logdir):
    (name,) = os.listdir(logdir)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(logdir, name)) as f:
        return json.load(f)["traceEvents"]


def test_annotate_nests_under_trace(tmp_path):
    logdir = str(tmp_path / "tr")
    with tp.trace(logdir) as prof:
        with tp.annotate("outer_phase"):
            with tp.annotate("inner_phase"):
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    names = [e.name for e in prof.events()]
    assert "outer_phase" in names and "inner_phase" in names
    spans = {e["name"]: e for e in _events(logdir) if e.get("name") in ("outer_phase",
                                                                          "inner_phase")}
    outer, inner = spans["outer_phase"], spans["inner_phase"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # a CPU-only trace has host rows and no kernel rows
    assert tp.device_op_table(logdir) == []


def _kernel(name, ts, dur, grid=(4, 1, 1)):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts,
            "dur": dur, "args": {"grid": list(grid), "block": [128, 1, 1]}}


def test_device_op_table_reads_kernel_events(tmp_path):
    """A trace with kernel events, the host rows of the same launches
    (operator and runtime events) and a metadata row: only the kernels
    count, grouped by name, by device time."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        _kernel("mbwq_mma_kernel(bf16 const*, ...)", 10, 5.0),
        _kernel("mbwq_mma_kernel(bf16 const*, ...)", 20, 7.0, grid=(8, 1, 1)),
        _kernel("dequant_kernel", 30, 20.0),
        _kernel("flash_fwd_kernel", 60, 3.0),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 9,
         "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 9, "dur": 4.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7, "ts": 10},
    ]
    logdir = tmp_path / "t"
    (logdir / "sub").mkdir(parents=True)
    (logdir / "sub" / "a.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    rows = tp.device_op_table(str(logdir), top=None)
    assert rows == [
        {"key": "dequant_kernel", "us": 20.0, "count": 1, "example": "grid [4, 1, 1] block [128, 1, 1]"},
        {"key": "mbwq_mma_kernel(bf16 const*, ...)", "us": 12.0, "count": 2,
         "example": "grid [4, 1, 1] block [128, 1, 1]"},
        {"key": "flash_fwd_kernel", "us": 3.0, "count": 1, "example": "grid [4, 1, 1] block [128, 1, 1]"},
    ]
    assert [r["key"] for r in tp.device_op_table(str(logdir), top=2)] == [
        "dequant_kernel", "mbwq_mma_kernel(bf16 const*, ...)"]
    with pytest.raises(FileNotFoundError):
        tp.device_op_table(str(tmp_path / "none"))


def test_device_summary_on_a_cpu_profile():
    with tp.profiler() as prof:
        torch.ones(16, 16) @ torch.ones(16, 16)
    s = tp.device_summary(prof, wall_s=0.5, calls=2)
    assert s == dict(wall_ms_per_call=250.0, device_busy_ms_per_call=0.0, idle_share=1.0,
                     launches_per_call=0.0, top_kernels=[])


def test_host_profile_counts_calls():
    def work():
        for _ in range(4):
            sorted(range(100))

    wall, rows = tp.host_profile(work, calls=4)
    assert wall > 0
    (key,) = [k for k in rows if k.endswith("(work)")]
    assert rows[key][0] == 0.25  # one call of work() over 4 calls measured
    calls, own_ms, cum_ms = rows["~:0(<built-in method builtins.sorted>)"]
    assert calls == 1.0 and 0 <= own_ms <= cum_ms
