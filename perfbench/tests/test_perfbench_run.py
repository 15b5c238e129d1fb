"""run.py refuses to measure without a CUDA card, and in a directory that
holds only the benchmark."""

import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "mistral7b-ft", "--seed", str(2**33 + 3), "--seconds", "1",
        "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        return  # this machine has a card: the refusal is the CPU machine's to show
    out = run(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    """Without the program beside it the run fails, on the CPU path too."""
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    assert run(tmp_path).returncode != 0
    code = ("import sys; sys.path.insert(0, 'perfbench'); import run; "
            f"sys.exit(run.main({ARGS!r}, device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "bitorch_engine_tpu_torch" in out.stderr
