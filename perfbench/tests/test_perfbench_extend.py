"""A later change adds a configuration, a mix, a per-layer metric and a
kernel family as new files and new entries: the harness finds and plans
them, and no existing file changes."""

import hashlib
import json

from perfbench.lib.bench import plan

from .tiny import workspace


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file()}


def test_new_files_are_found_without_an_edit(tmp_path):
    root = workspace(tmp_path)
    before = digests(root)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs/tiny-moe.json").read_text())
    cfg["num_local_experts"] = 8
    (pb / "configs/tiny-moe-8.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "mixes/tiny-rag.json").read_text())
    mix["clients"] = 2
    (pb / "mixes/tiny-rag-2.json").write_text(json.dumps(mix))
    (pb / "metrics/waves_per_iteration.new.py").write_text(
        "def read(run):\n    return 42.0\n")
    (pb / "kernels/new-gemm.json").write_text(
        json.dumps({"class": "matmul", "patterns": ["\\\\bnew_gemm_kernel\\\\b"]}))
    (pb / "limits/tiny-new.json").write_text(json.dumps({"served_gap": 0.1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moe-8", "source": "tiny",
                             "file": "perfbench/configs/tiny-moe-8.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": "tiny-new", "config": "tiny-moe-8",
                               "traffic": "tiny-rag-2", "chips": 1, "why": "tiny"})
    bench["per_layer"].append({"name": "waves_per_iteration.new", "unit": "waves",
                               "better": "lower", "source": "program_counter",
                               "layer": "serving engine", "moves": "ttft_p90_ms",
                               "workloads": ["tiny-new"]})
    for m in bench["end_to_end"]:
        if "tiny-rag" in m.get("workloads", []):
            m["workloads"].append("tiny-new")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = plan("tiny-new", root)
    assert p.config["num_local_experts"] == 8 and p.mix["clients"] == 2
    assert {m.name for m in p.end_to_end} == {"ttft_p90_ms", "itl_p90_ms", "setup_s"}
    assert [m.name for m in p.per_layer] == ["waves_per_iteration.new"]
    assert p.reader(p.per_layer[0])(None) == 42.0
    assert p.kernel_class("void new_gemm_kernel<4>(int const*)") == "matmul"
    assert p.kernel_class("dequant_kernel") == "matmul"
    assert p.kernel_class("flash_bwd_dq_kernel") == "attention_backward"
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())
    # the old cells plan as before
    assert [m.name for m in plan("tiny-rag", root).per_layer] == [
        "decode_step_ms.rag", "serve_mfu.rag", "prefill_matmul_roofline.rag",
        "launches_per_decode_step.rag", "idle_share.rag"]
