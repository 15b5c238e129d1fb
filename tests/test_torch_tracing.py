"""The port's spans and counts (``utils/profiling.annotate``) inside the
serving loop, the MoE layer and the train step, on the CPU: nesting,
parent ids and request uids on a paged ``ContinuousBatcher`` with chunked
prefill; the waves' token counts and the MoE's row counts; fine spans only
under a profiler, where each record lies on its trace event after
conversion to the trace's clock; the collector's span; and the served
tokens the same as an unprofiled run's."""

import gc
import json
import os
import statistics

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread a test process)

from bitorch_engine_tpu_torch.models import generate as tg
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.ops import moe as tmoe
from bitorch_engine_tpu_torch.optim import DiodeHyperParams
from bitorch_engine_tpu_torch.training import cross_entropy_loss, make_train_step
from bitorch_engine_tpu_torch.utils import prepare_for_training
from bitorch_engine_tpu_torch.utils import profiling as tp

MOE_KW = dict(moe_num_experts=4, kv_cache_dtype="int8")
PROMPTS = (5, 20, 12, 30, 9)
PAGE, CHUNK = 8, 8
FINE = ("bie.moe.route", "bie.moe.dispatch", "bie.moe.experts", "bie.moe.combine",
        "bie.train.forward", "bie.train.backward", "bie.train.optimizer",
        "bie.diode.reconstruct", "bie.diode.update", "bie.diode.repack", "bie.gc")


@pytest.fixture(scope="module")
def model():
    return tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **MOE_KW), device="cpu", seed=1)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, n).tolist() for n in PROMPTS]


def serve(model):
    """A paged, chunked batcher run: (the batcher, {uid: prompt}, tokens
    by uid, the records it closed)."""
    before = {r.id for r in tp.records()}
    b = tg.ContinuousBatcher(model, num_slots=2, max_len=48, kv_pages=7, kv_page_size=PAGE,
                             prefill_chunk=CHUNK)
    prompts = {b.submit(p, max_new_tokens=4): p for p in _prompts()}
    done = {r.uid: list(r.generated) for r in b.run()}
    return b, prompts, done, [r for r in tp.records() if r.id not in before]


def _by_id(recs):
    return {r.id: r for r in recs}


def test_batcher_spans_nest_with_parents_and_uids(model):
    _, prompts, _, recs = serve(model)
    by_id = _by_id(recs)
    names = {r.name for r in recs}
    assert {"bie.batcher.admit", "bie.batcher.wave", "bie.batcher.reserve", "bie.batcher.chunk",
            "bie.batcher.step", "bie.batcher.read"} <= names
    assert not names & set(FINE)
    parent = {r.id: by_id[r.parent].name if r.parent in by_id else None for r in recs}
    want = {"bie.batcher.admit": {None}, "bie.batcher.step": {None},
            "bie.batcher.wave": {"bie.batcher.admit"}, "bie.batcher.reserve": {"bie.batcher.wave"},
            "bie.batcher.chunk": {"bie.batcher.wave"},
            "bie.batcher.read": {"bie.batcher.wave", "bie.batcher.step"}}
    for r in recs:
        assert parent[r.id] in want[r.name], (r, parent[r.id])
        if r.parent in by_id:
            p = by_id[r.parent]
            assert p.start <= r.start <= r.end <= p.end
    # every request in exactly one wave; each step serves requests of the run
    waves = [r for r in recs if r.name == "bie.batcher.wave" and r.counts["rows"]]
    assert sorted(u for w in waves for u in w.uids) == sorted(prompts)
    for c in (r for r in recs if r.name == "bie.batcher.chunk"):
        assert c.uids == by_id[c.parent].uids
    steps = [r for r in recs if r.name == "bie.batcher.step"]
    assert steps and all(s.uids and set(s.uids) <= set(prompts) for s in steps)
    # each step and each wave ends in exactly one host read
    for s in steps + waves:
        assert sum(r.parent == s.id and r.name == "bie.batcher.read" for r in recs) == 1


def test_wave_counts_are_the_waves_prompts(model):
    b, prompts, _, recs = serve(model)
    waves = [r for r in recs if r.name == "bie.batcher.wave" and r.counts["rows"]]
    for w in waves:
        lens = [len(prompts[u]) for u in w.uids]
        bucket = b._bucket(lens[0])
        assert {b._bucket(n) for n in lens} == {bucket}
        assert w.counts["bucket"] == bucket and w.counts["rows"] == len(lens)
        assert w.counts["true_tokens"] == sum(lens)
        assert w.counts["padded_tokens"] == bucket * len(lens)
        chunks = sorted((r for r in recs if r.parent == w.id and r.name == "bie.batcher.chunk"),
                        key=lambda r: r.counts["index"])
        assert [c.counts["index"] for c in chunks] == list(range(max(1, bucket // CHUNK)))
        assert sum(c.counts["true_tokens"] for c in chunks) == sum(lens)
        (res,) = [r for r in recs if r.parent == w.id and r.name == "bie.batcher.reserve"]
        need = [min(n + 4, b.max_len) for n in lens]
        assert res.counts["pages"] == w.counts["pages"] == sum(-(-n // PAGE) for n in need)


def test_moe_counts_are_the_routed_and_computed_rows(model):
    """Every chunk and step forward counts T·k routed and E·C computed rows
    per MoE layer (drop-free: C = T), and a capacity cuts C; the grouped
    route counts its E·C rows."""
    _, _, _, recs = serve(model)
    by_id = _by_id(recs)
    layers, k, e = model.cfg.num_layers, model.cfg.moe_top_k, MOE_KW["moe_num_experts"]
    for r in recs:
        if r.name == "bie.batcher.chunk":
            wave = by_id[r.parent].counts
            t = wave["rows"] * min(wave["bucket"], CHUNK)
            assert r.counts["moe_routed_rows"] == layers * t * k
            assert r.counts["moe_computed_rows"] == layers * e * t
            assert r.counts["moe_grouped_rows"] == layers * e * t  # every C groups on the CPU
        elif r.name == "bie.batcher.step":
            assert r.counts["moe_routed_rows"] == layers * 2 * k  # every slot decodes
            assert r.counts["moe_computed_rows"] == layers * e * 2
    gen = torch.Generator().manual_seed(0)
    experts = tmoe.init_moe_experts(gen, 4, 64, 128, device="cpu")
    x = torch.randn(3, 5, 64, generator=gen)
    router = torch.randn(64, 4, generator=gen)
    for cap, c in ((None, 15), (1.25, 10)):
        with tp.annotate("bie.test.moe") as rec:
            tmoe.moe_mlp(x, router, experts, top_k=2, capacity_factor=cap)
        assert rec.counts == {"moe_routed_rows": 30, "moe_computed_rows": 4 * c,
                              "moe_grouped_rows": 4 * c}


def test_no_profiler_no_fine_span_and_no_record_function(model, monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(tp, "_trace_enter", refuse)
    _, _, _, recs = serve(model)
    recs += train_records(steps=1)
    assert recs and not {r.name for r in recs} & set(FINE)
    assert tp._gc_hook not in gc.callbacks


def _trace_events(logdir):
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        data = json.load(f)
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


def test_fine_records_lie_on_their_trace_events(model, tmp_path):
    """Under a CPU profiler every span is recorded and traced.  Once put on
    the trace's clock, each fine record holds its ``bie.*`` trace event
    (stamped before the event opens and after it closes, within 10 us of
    clock error), and they agree within 50 us at the median: a span's entry
    preempted on a loaded machine can take longer, but never cuts the
    event."""
    with tp.trace(str(tmp_path / "warm")):  # a process's first traced span is slow
        serve(model)
    logdir = str(tmp_path / "tr")
    before = {r.id for r in tp.records()}
    with tp.trace(logdir):
        serve(model)
        train_records(steps=1)
    recs = [r for r in tp.records() if r.id not in before and r.name in FINE]
    events, base = _trace_events(logdir)
    assert {r.name for r in recs} >= set(FINE) - {"bie.gc"}
    gaps = []
    for name in {r.name for r in recs}:
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.start)
        theirs = sorted((e for e in events if e.get("name") == name and e.get("ph") == "X"),
                        key=lambda e: e["ts"])
        assert len(mine) == len(theirs), name
        for r, ev in zip(mine, theirs):
            early = ev["ts"] - tp.to_trace_us(r.start, base)
            late = tp.to_trace_us(r.end, base) - ev["ts"] - ev["dur"]
            assert early > -10 and late > -10, (name, r, ev)
            gaps += [abs(early), abs(late)]
    assert statistics.median(gaps) < 50, sorted(gaps)[-10:]


def test_a_collection_under_a_profiler_is_one_gc_record(tmp_path):
    was = gc.isenabled()
    gc.disable()  # no collection but the one asked for
    try:
        before = len(tp.records("bie.gc"))
        with tp.trace(str(tmp_path / "tr")):
            with tp.annotate("bie.test.outer") as outer:
                gc.collect()
        gcs = tp.records("bie.gc")[before:]
        assert len(gcs) == 1
        assert gcs[0].counts["generation"] == 2 and gcs[0].parent == outer.id
        assert outer.start <= gcs[0].start <= gcs[0].end <= outer.end
        with tp.annotate("bie.test.after"):  # the first span with no profiler unhooks
            gc.collect()
        assert tp._gc_hook not in gc.callbacks
        assert len(tp.records("bie.gc")) == before + 1
    finally:
        if was:
            gc.enable()


def test_served_tokens_equal_an_unprofiled_run(model, tmp_path):
    _, _, plain, _ = serve(model)
    with tp.trace(str(tmp_path / "tr")):
        _, _, traced, recs = serve(model)
    assert traced == plain and len(plain) == len(PROMPTS)
    assert {"bie.moe.route", "bie.moe.experts"} <= {r.name for r in recs}


def train_records(steps=1):
    torch.manual_seed(0)
    model = prepare_for_training(tl.LlamaModel(tl.tiny_llama(dtype=torch.float32), device="cpu"))
    toks = torch.randint(0, 256, (2, 17))

    def loss_fn(m, batch):
        logits, _ = m(batch[:, :-1])
        return cross_entropy_loss(logits, batch[:, 1:])

    step = make_train_step(model, loss_fn, DiodeHyperParams(lr=1e-3))
    before = {r.id for r in tp.records()}
    for _ in range(steps):
        step(toks)
    return [r for r in tp.records() if r.id not in before]


def test_a_traced_train_step_holds_its_six_spans(tmp_path):
    with tp.trace(str(tmp_path / "tr")):
        recs = train_records(steps=1)
    by_id = _by_id(recs)
    (step,) = [r for r in recs if r.name == "bie.train.step"]

    def under(r, name):
        while r.parent in by_id:
            r = by_id[r.parent]
            if r.name == name:
                return True
        return False

    for name in ("bie.train.forward", "bie.train.backward", "bie.train.optimizer"):
        (r,) = [r for r in recs if r.name == name]
        assert r.parent == step.id
    for name in ("bie.diode.reconstruct", "bie.diode.update", "bie.diode.repack"):
        got = [r for r in recs if r.name == name]
        assert got and all(under(r, "bie.train.optimizer") for r in got)
    # unprofiled, the step alone is recorded
    assert {r.name for r in train_records(steps=1)} == {"bie.train.step"}


def test_trace_clock_takes_the_latest_sample(monkeypatch):
    """A stamp is placed with the clock offset sampled last before it."""
    monkeypatch.setattr(tp, "_clock_pairs", [(1_000_000_000, 5_000), (3_000_000_000, 9_000)])
    assert tp.to_trace_us(0.5) == (500_000_000 + 5_000) / 1e3
    assert tp.to_trace_us(2.0, base_ns=1_000) == (2_000_000_000 + 5_000 - 1_000) / 1e3
    assert tp.to_trace_us(3.0) == (3_000_000_000 + 9_000) / 1e3


def test_counts_land_on_the_innermost_recorded_span():
    with tp.annotate("bie.test.coarse", uids=[7, 8], n=1) as coarse:
        with tp.annotate("bie.test.fine", fine=True) as fine:
            tp.count("n", 2)
        tp.count("m")
    assert fine is None  # no profiler
    assert coarse.counts == {"n": 3, "m": 1} and coarse.uids == (7, 8)
    tp.count("nowhere")  # no span open: nothing, no error
