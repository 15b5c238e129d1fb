"""The readers of the program's spans and counts: on a synthetic record of
spans (the program's ``records()`` replaced), and on a tiny traced serving
run on the CPU, where they agree with the harness's own record."""

import gzip
import json
import time
import types

import pytest
import torch

from bitorch_engine_tpu_torch.utils import profiling
from perfbench.lib import reading
from perfbench.lib.bench import load_reader, plan, PERFBENCH
from perfbench.lib.cells import run_cell
from perfbench.lib.serve import Iter
from perfbench.lib.trace import Span, Trace

from .tiny import workspace

NEW = [
    ("decode_host_ms.rag", "ms", "lower", "program_span", "model step", "itl_p90_ms"),
    ("prefill_chunk_host_ms.rag", "ms", "lower", "program_span", "model step", "ttft_p90_ms"),
    ("prefill_useful_share.rag", "%", "higher", "program_counter", "serving engine",
     "ttft_p90_ms"),
    ("moe_useful_rows.rag", "%", "higher", "program_counter", "model step", "ttft_p90_ms"),
    ("idle_gc_share.rag", "%", "lower", "program_span", "device", "ttft_p90_ms"),
]
SEED = 2**33 + 5


def reader(name):
    return load_reader(PERFBENCH / "metrics" / f"{name}.py")


def rec(rid, name, start, end, parent=0, **counts):
    """A record as the program keeps it (``profiling.SpanRecord``'s fields)."""
    return types.SimpleNamespace(name=name, id=rid, parent=parent, start=start, end=end,
                                 counts=counts, uids=())


# two iterations, the second profiled; times in seconds
RECORDS = [
    rec(1, "bie.batcher.admit", 10.0, 10.5),
    rec(2, "bie.batcher.wave", 10.0, 10.5, 1, bucket=1024, rows=2, true_tokens=1500,
        padded_tokens=2048),
    rec(3, "bie.batcher.chunk", 10.1, 10.2, 2, moe_routed_rows=10, moe_computed_rows=40),
    rec(4, "bie.batcher.chunk", 10.2, 10.4, 2, moe_routed_rows=10, moe_computed_rows=40),
    rec(5, "bie.batcher.read", 10.4, 10.5, 2),
    rec(6, "bie.batcher.step", 10.5, 11.0, moe_routed_rows=2, moe_computed_rows=8),
    rec(7, "bie.batcher.read", 10.8, 11.0, 6),
    rec(8, "bie.batcher.admit", 11.0, 11.2),
    rec(9, "bie.batcher.wave", 11.0, 11.2, 8, bucket=2048, rows=1, true_tokens=1100,
        padded_tokens=2048),
    rec(10, "bie.batcher.chunk", 11.0, 11.15, 9),
    rec(11, "bie.moe.dispatch", 11.01, 11.02, 10, moe_routed_rows=4),
    rec(12, "bie.moe.experts", 11.02, 11.1, 10, moe_computed_rows=16),
    rec(13, "bie.batcher.step", 11.2, 11.9),
    rec(14, "bie.batcher.read", 11.3, 11.9, 13),
    rec(15, "bie.gc", 11.4, 11.5, 13, generation=2),
    rec(16, "bie.batcher.step", 20.0, 21.0),  # after the window
]


@pytest.fixture
def synthetic(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "records", lambda name=None: list(RECORDS))
    monkeypatch.setattr(profiling, "_clock_pairs", [(0, 0)])  # trace µs = seconds × 1e6
    cache = tmp_path / ".perfbench_cache"
    cache.mkdir()
    with gzip.open(cache / "trace-x.json.gz", "wt") as fh:
        json.dump({"schemaVersion": 1, "baseTimeNanoseconds": 0, "traceEvents": []}, fh)
    iters = [Iter((10.0, 10.5), [], (10.5, 11.0)), Iter((11.0, 11.2), [], (11.2, 11.9), True)]
    # the traced step: device busy 11.2-11.3 and 11.6-11.9 s; idle 11.3-11.6, of which gc 0.1 s
    trace = Trace([Span("perfbench.admit", 11.0e6, 11.2e6), Span("perfbench.step", 11.2e6, 11.9e6)],
                  [(11.0e6, 11.2e6), (11.2e6, 11.3e6), (11.6e6, 11.9e6)], [], [])
    return types.SimpleNamespace(window=(9.0, 12.0), data={"iters": iters}, trace=trace,
                                 plan=types.SimpleNamespace(root=tmp_path, workload="x"))


def test_readers_on_a_synthetic_record(synthetic):
    run = synthetic
    assert reader("decode_host_ms.rag")(run) == pytest.approx(300.0)  # 0.5 s less its 0.2 s read
    assert reader("prefill_chunk_host_ms.rag")(run) == pytest.approx(150.0)  # chunks 3 and 4
    assert reader("prefill_useful_share.rag")(run) == pytest.approx(100 * 2600 / 4096)
    assert reader("moe_useful_rows.rag")(run) == pytest.approx(100 * 26 / 104)
    assert reader("idle_gc_share.rag")(run) == pytest.approx(100 * 0.1 / 0.3)


def test_readers_report_nothing_without_the_programs_records(synthetic, monkeypatch):
    monkeypatch.delattr(profiling, "records")
    for name, *_ in NEW:
        assert reader(name)(synthetic) is None


def test_gc_share_needs_the_clocks_to_agree(synthetic, monkeypatch):
    """Step records that land outside the trace's step spans (a clock off
    by a second) give no reading rather than a wrong one."""
    monkeypatch.setattr(profiling, "_clock_pairs", [(0, 10**9)])
    assert reader("idle_gc_share.rag")(synthetic) is None


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    torch.set_num_threads(2)
    root = workspace(tmp_path_factory.mktemp("spans"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"] += [{"name": n, "unit": u, "better": b, "source": s, "layer": layer,
                            "moves": moves, "workloads": ["tiny-rag"]}
                           for n, u, b, s, layer, moves in NEW]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return run_cell(plan("tiny-rag", root), SEED, 1.0, True, "cpu", time.perf_counter())


def test_a_traced_cpu_run_reads_the_programs_spans(traced):
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    run = traced["run"]
    assert traced["correct"]
    # 4 experts, top 2, drop-free
    assert m["moe_useful_rows.rag"] == 50.0
    waves = [w for it in run.data["iters"] for w in it.waves]
    true = sum(sum(lens) for _, lens in waves)
    assert m["prefill_useful_share.rag"] == pytest.approx(100 * true / reading.padded_tokens(waves))
    assert 0 < m["decode_host_ms.rag"] <= m["decode_step_ms.rag"]
    assert m["prefill_chunk_host_ms.rag"] > 0
    assert "idle_gc_share.rag" not in m  # no device on the CPU
