"""The port's CLI (``tools/cli.py``) against the JAX package's on the same
safetensors file: the same tensor names, dtypes, shapes and bytes from
``quantize`` (sym and ``--asym``; a tensor whose rows are not
group-aligned, a 1-D tensor and a name without the suffix copied), the same
``inspect`` lines, and an output that ingests back within JAX
``tests/test_cli.py``'s error."""

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread a test process)
from safetensors.numpy import load_file, save_file

from bitorch_engine_tpu.tools import cli as jcli
from bitorch_engine_tpu_torch.ops.quant import dequantize_mpq
from bitorch_engine_tpu_torch.tools import cli as tcli
from bitorch_engine_tpu_torch.utils import ingest


def _input(path):
    rng = np.random.default_rng(0)
    save_file({
        "blk.w.weight": rng.standard_normal((256, 128)).astype(np.float32) * 0.05,
        "blk.v.weight": rng.standard_normal((384, 64)).astype(np.float32) * 0.05,
        "blk.ragged.weight": rng.standard_normal((200, 64)).astype(np.float32),
        "blk.norm.weight": np.ones(128, np.float32),
        "blk.w.bias": rng.standard_normal((256, 128)).astype(np.float32),
        "ids": np.arange(12, dtype=np.int32).reshape(3, 4),
    }, str(path))


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_quantize_matches_jax(tmp_path, capsys, asym):
    src = tmp_path / "in.safetensors"
    _input(src)
    flags = ["--asym"] if asym else []
    j_dst, t_dst = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    assert jcli.main(["quantize", "--input", str(src), "--output", j_dst, *flags]) == 0
    j_line = capsys.readouterr().out
    assert tcli.main(["quantize", "--input", str(src), "--output", t_dst, *flags,
                      "--device", "cpu"]) == 0
    t_line = capsys.readouterr().out
    assert t_line.replace(t_dst, "") == j_line.replace(j_dst, "")
    assert t_line.startswith("quantized 2 weights")
    want, got = load_file(j_dst), load_file(t_dst)
    zeros = "qzeros" if asym else "zeros"
    assert set(got) == set(want) == {
        "blk.w.qweight", "blk.w.scales", f"blk.w.{zeros}", "blk.v.qweight", "blk.v.scales",
        f"blk.v.{zeros}", "blk.ragged.weight", "blk.norm.weight", "blk.w.bias", "ids"}
    for name, w in want.items():
        g = got[name]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        assert g.tobytes() == w.tobytes(), name


def test_inspect_prints_the_jax_lines(tmp_path, capsys):
    src = tmp_path / "in.safetensors"
    _input(src)
    dst = str(tmp_path / "q.safetensors")
    assert tcli.main(["quantize", "--input", str(src), "--output", dst, "--device", "cpu"]) == 0
    capsys.readouterr()
    for path in (str(src), dst):
        assert jcli.main(["inspect", "--input", path]) == 0
        want = capsys.readouterr().out
        assert tcli.main(["inspect", "--input", path]) == 0
        assert capsys.readouterr().out == want
        assert want.splitlines()[-1].startswith("total: ")
    # a bf16 tensor (numpy has no bf16: the line names it as ml_dtypes does)
    bf = str(tmp_path / "bf.safetensors")
    ingest.save_safetensors(bf, {"e.weight": torch.ones(128, 8, dtype=torch.bfloat16)})
    assert tcli.main(["inspect", "--input", bf]) == 0
    assert capsys.readouterr().out.splitlines() == [
        f"{'e.weight':60s} bfloat16 (128, 8)", "total: 0.0 MB, 1 tensors"]


def test_quantized_output_ingests_back(tmp_path):
    """JAX ``tests/test_cli.py``: the port's output read back through
    ``mpq_from_gba`` dequantizes within rel 0.15 of the fp weight."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 128)).astype(np.float32) * 0.05
    src, dst = str(tmp_path / "in.safetensors"), str(tmp_path / "out.safetensors")
    ingest.save_safetensors(src, {"blk.w.weight": w, "blk.norm.weight": np.ones(128, np.float32)})
    assert tcli.main(["quantize", "--input", src, "--output", dst, "--device", "cpu"]) == 0
    out = ingest.load_safetensors(dst)
    assert set(out) == {"blk.w.qweight", "blk.w.scales", "blk.w.zeros", "blk.norm.weight"}
    qt = ingest.mpq_from_gba(out["blk.w.qweight"],
                             {"scales": out["blk.w.scales"], "zeros": out["blk.w.zeros"]},
                             w_bit=4, group_size=128, device="cpu")
    w_hat = dequantize_mpq(qt, torch.float32).numpy()
    rel = np.linalg.norm(w_hat - w) / np.linalg.norm(w)
    assert rel < 0.15, rel


def test_quantize_needs_a_gpu_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.safetensors"
    _input(src)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tcli.main(["quantize", "--input", str(src), "--output", str(tmp_path / "o")])
