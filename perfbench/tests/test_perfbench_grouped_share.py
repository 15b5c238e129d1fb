"""The reader of ``moe_grouped_share.rag``: on a synthetic record of spans
(the program's ``records()`` replaced) and on a tiny traced serving run
on the CPU, where every expert weight is rebuilt, so every row groups."""

import json
import types

import pytest
import torch

from bitorch_engine_tpu_torch.utils import profiling
from perfbench.lib import cells
from perfbench.lib.bench import PERFBENCH, load_reader, plan
from perfbench.lib.cells import run_cell

from .tiny import tick, workspace

NAME = "moe_grouped_share.rag"
SEED = 2**33 + 23


def rec(rid, name, start, end, parent=0, **counts):
    """A record as the program keeps it (``profiling.SpanRecord``'s fields)."""
    return types.SimpleNamespace(name=name, id=rid, parent=parent, start=start, end=end,
                                 counts=counts, uids=())


# two chunk forwards (grouped), a decode step (the loop: 0 grouped rows), a
# profiled chunk whose count lands on its fine span, one record after the
# window; times in seconds
RECORDS = [
    rec(1, "bie.batcher.chunk", 10.1, 10.2, moe_computed_rows=40, moe_grouped_rows=40),
    rec(2, "bie.batcher.chunk", 10.2, 10.4, moe_computed_rows=40, moe_grouped_rows=40),
    rec(3, "bie.batcher.step", 10.5, 11.0, moe_computed_rows=8, moe_grouped_rows=0),
    rec(4, "bie.batcher.chunk", 11.0, 11.15),
    rec(5, "bie.moe.experts", 11.02, 11.1, 4, moe_computed_rows=16, moe_grouped_rows=16),
    rec(6, "bie.batcher.chunk", 20.0, 21.0, moe_computed_rows=40, moe_grouped_rows=0),
]


def read(run):
    return load_reader(PERFBENCH / "metrics" / f"{NAME}.py")(run)


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda name=None: list(RECORDS))
    return types.SimpleNamespace(window=(9.0, 12.0))


def test_the_share_of_the_rows_that_group(synthetic):
    assert read(synthetic) == pytest.approx(100 * 96 / 104)


@pytest.mark.parametrize("program", ["no_grouped_count", "no_records"])
def test_nothing_from_a_program_without_the_count(synthetic, monkeypatch, program):
    """A program that counts no grouped rows (one without the grouped
    route) or keeps no records gives no reading, not 0."""
    if program == "no_records":
        monkeypatch.delattr(profiling, "records")
    else:
        without = [rec(r.id, r.name, r.start, r.end, r.parent,
                       **{k: v for k, v in r.counts.items() if k != "moe_grouped_rows"})
                   for r in RECORDS]
        monkeypatch.setattr(profiling, "records", lambda name=None: without)
    assert read(synthetic) is None


def test_a_traced_cpu_run_reads_every_row_grouped(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    tick(monkeypatch)
    root = workspace(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append("tiny-rag")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell(plan("tiny-rag", root), SEED, 1.0, True, "cpu", cells.clock())
    assert out["correct"]
    assert out["metrics"][NAME]["value"] == 100.0
