"""A tiny copy of the benchmark for the CPU tests: the real ``perfbench/``
tree copied under a temporary root, with a tiny MoE serving configuration
and mix, and a tiny GPTQ fine-tune configuration and mix, added as files
and entries the way a later change adds a cell."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# a serving run's clock tick: a 1 s window holds about ten loop iterations
# (and no whole number of ticks, so no window ends on a tie)
TICK = 1 / 55.5

# the serving cell's metrics, as a change that adds a serving cell adds them
SERVE_E2E = [
    {"name": "ttft_p90_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock"},
    {"name": "itl_p90_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock"},
]
SERVE_PER_LAYER = [
    ("decode_step_ms.rag", "ms", "lower", "host_clock", "model step", "itl_p90_ms"),
    ("serve_mfu.rag", "%", "higher", "host_clock", "model step", "ttft_p90_ms"),
    ("prefill_matmul_roofline.rag", "%", "higher", "device_trace", "kernels", "ttft_p90_ms"),
    ("launches_per_decode_step.rag", "launches", "lower", "device_trace", "device", "itl_p90_ms"),
    ("idle_share.rag", "%", "lower", "device_trace", "device", "ttft_p90_ms"),
]

TINY = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=512)


def _load(rel):
    return json.loads((REPO / rel).read_text())


def workspace(tmp: Path, limits_serve=None, limits_ft=None) -> Path:
    root = tmp / "root"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "perfbench"
    moe = _load("perfbench/configs/mixtral-8x7b-w4.json")
    moe.update(TINY, num_local_experts=4)
    moe["port"]["head_pad_to"] = 256
    (pb / "configs/tiny-moe.json").write_text(json.dumps(moe))
    ft = _load("perfbench/configs/mistral-7b-gptq-ft.json")
    ft.update(TINY)
    (pb / "configs/tiny-gptq.json").write_text(json.dumps(ft))
    mix = _load("perfbench/mixes/rag-closed-32.json")
    mix.update(clients=4, set_size=8,
               prompt={"dist": "lognormal", "median": 48, "sigma": 0.4, "min": 24, "max": 96},
               batcher={"num_slots": 4, "kv_page_size": 16, "prefill_chunk": 16, "decode_chunk": 1},
               check={"requests": 4}, trace={"start_share": 0.3, "iterations": 3})
    (pb / "mixes/tiny-rag.json").write_text(json.dumps(mix))
    fmix = _load("perfbench/mixes/ft-4x2048.json")
    fmix.update(batch=2, seq_len=64)
    (pb / "mixes/tiny-ft.json").write_text(json.dumps(fmix))
    bench = _load("BENCHMARK.json")
    bench["configs"] += [
        {"name": "tiny-moe", "source": "tiny", "file": "perfbench/configs/tiny-moe.json",
         "reduced": [], "why": "tiny"},
        {"name": "tiny-gptq", "source": "tiny", "file": "perfbench/configs/tiny-gptq.json",
         "reduced": [], "why": "tiny"}]
    bench["workloads"] += [
        {"name": "tiny-rag", "config": "tiny-moe", "traffic": "tiny-rag", "chips": 1, "why": "tiny"},
        {"name": "tiny-ft", "config": "tiny-gptq", "traffic": "tiny-ft", "chips": 1, "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "mistral7b-ft" in m["workloads"]:
            m["workloads"].append("tiny-ft")
    bench["end_to_end"] += [dict(m, workloads=["tiny-rag"]) for m in SERVE_E2E]
    bench["per_layer"] += [
        {"name": n, "unit": u, "better": b, "source": src, "layer": layer, "moves": moves,
         "workloads": ["tiny-rag"]} for n, u, b, src, layer, moves in SERVE_PER_LAYER]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # set from 15 seeds at windows of 6-20 iterations (PERF.md §6): sound
    # runs read served_gap_mean up to 1.04e-3, a served token 0.012 under
    # the best and route_gap_mean up to 1.11e-5; the fp8 control as low as
    # 0, 0 and 2.98e-5, so route_gap_mean alone holds it here; tokens
    # altered where they are produced read 0.87 or more, widest 1.33 or more
    (pb / "limits/tiny-rag.json").write_text(json.dumps(limits_serve or {"served_gap_mean": 3e-3, "served_far": 0, "far_gap": 3e-2, "route_gap_mean": 2e-5}))
    (pb / "limits/tiny-ft.json").write_text(json.dumps(
        limits_ft or {"loss": 1e-3, "grad": 0.05, "moments": 0.05, "change": 0.05}))
    return root


def tick(mp) -> None:
    """Run serving on a clock of its own (``mp``: a ``pytest.MonkeyPatch``).
    Each reading the harness takes advances it by ``TICK``, each stamp of
    the program's spans by a millionth of that, so a window of ``seconds``
    holds the same loop iterations on any CPU.  With no think time the
    closed loop's schedule turns only on the order of completions: a seed
    then finishes the same requests, and its check samples the same ones,
    every run.  It starts a million seconds past the real clock and past
    every span record the program holds, so the records of other runs in
    this process never fall in its window."""
    from bitorch_engine_tpu_torch.utils import profiling
    from perfbench.lib import cells, serve

    now = [max([time.perf_counter()] + [r.end for r in profiling.records()]) + 1e6]

    def harness():
        now[0] += TICK
        return now[0]

    def program():
        now[0] += TICK * 1e-6
        return now[0]

    mp.setattr(cells, "clock", harness)
    mp.setattr(serve, "clock", harness)
    mp.setattr(profiling, "_clock", program)
