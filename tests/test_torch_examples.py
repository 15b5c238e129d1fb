"""The PyTorch twins of ``examples/`` (``examples_torch/``), run in process
through ``main(argv)`` on the CPU at small sizes: their data loaders equal
the JAX scripts' array for array; quantize-and-generate gives the JAX
package's greedy ids on a seeded tiny f32 HF-layout file; the serve twin's
ids are the same with and without ``--mesh 1,2`` (one gloo world of two CPU
processes); the MNIST, CIFAR and bring-your-own-trainer twins train, log,
checkpoint and resume.  The fine-tune twin is in
``test_torch_examples_finetune.py`` (its own world)."""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread a test process)
from test_torch_llama_loader import _hf_fp_tensors

from bitorch_engine_tpu.models import generate as jgen
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.models import llama_loader as jloader
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.utils.ingest import save_safetensors
from examples_torch.cifar import train_cifar
from examples_torch.llm import quantize_and_generate, serve
from examples_torch.mnist import train_lightning_style, train_mnist

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_example(rel):
    """A JAX example script as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{pathlib.Path(rel).stem}",
                                                  ROOT / "examples" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_data_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert (gx.dtype, gy.dtype) == (wx.dtype, wy.dtype)


def test_loaders_match_the_jax_scripts(tmp_path):
    jm = _jax_example("mnist/train_mnist.py")
    jc = _jax_example("cifar/train_cifar.py")
    _assert_data_equal(train_mnist.synthetic_digits(), jm.synthetic_digits())
    _assert_data_equal(train_mnist.synthetic_digits(500, 100, seed=3),
                       jm.synthetic_digits(500, 100, seed=3))
    _assert_data_equal(train_mnist.load_sklearn_digits(), jm.load_sklearn_digits())
    _assert_data_equal(train_cifar.natural_patches(256, 64), jc.natural_patches(256, 64))
    assert train_mnist.load_mnist(str(tmp_path)) is None and jm.load_mnist(str(tmp_path)) is None
    assert train_cifar.load_cifar10(str(tmp_path)) is None
    # an npz MNIST is read as the JAX script reads it
    rng = np.random.default_rng(0)
    arrays = dict(x_train=rng.integers(0, 256, (6, 28, 28), dtype=np.uint8),
                  y_train=np.arange(6), x_test=rng.integers(0, 256, (2, 28, 28), dtype=np.uint8),
                  y_test=np.arange(2))
    np.savez(tmp_path / "mnist.npz", **arrays)
    _assert_data_equal(train_mnist.load_mnist(str(tmp_path)), jm.load_mnist(str(tmp_path)))


def test_quantize_and_generate_matches_jax(tmp_path):
    """A seeded tiny f32 HF-layout file: the twin's greedy ids equal the JAX
    package's ``load_llama_from_safetensors`` + ``generate`` on it."""
    path = str(tmp_path / "tiny.safetensors")
    save_safetensors(path, _hf_fp_tensors(tl.tiny_llama()))
    got = quantize_and_generate.main(["--checkpoint", path, "--config", "tiny", "--cpu",
                                      "--prompt-ids", "1,2,3,4;9,8,7,6"])
    jcfg = jl.tiny_llama(w_bit=4, group_size=128, dtype=jnp.float32)
    params = jloader.load_llama_from_safetensors(path, jcfg, jnp.float32)
    prompt = jnp.asarray([[1, 2, 3, 4], [9, 8, 7, 6]], jnp.int32)
    want = np.asarray(jgen.generate(jl.LlamaModel(jcfg), params, prompt, max_new_tokens=16))
    assert got.shape == (2, 20)
    np.testing.assert_array_equal(got, want)


def test_quantize_and_generate_demo(capsys):
    ids = quantize_and_generate.main(["--demo", "--max-new-tokens", "4"])
    assert ids.shape == (1, 8) and ids[0, :4].tolist() == [1, 2, 3, 4]
    assert capsys.readouterr().out == f"generated ids: {ids[0].tolist()}\n"


def test_serve_sharded_ids_equal_unsharded(capsys):
    """The JAX verify recipe's check of the serve script: ``--mesh 1,2``
    (tp 2 over two processes) prints the unsharded run's ids."""
    argv = ["--demo", "--page-size", "32", "--prefill-chunk", "16"]
    one = serve.main(argv)
    text = capsys.readouterr().out
    two = serve.main(argv + ["--mesh", "1,2"])
    assert one["generated"].shape == (32, 32)
    np.testing.assert_array_equal(two["generated"], one["generated"])
    assert text.splitlines()[0].startswith("served 32 requests in ")
    assert text.splitlines()[1] == f"first request output ids: {one['generated'][0][:16].tolist()}"


def test_train_mnist_runs():
    out = train_mnist.main(["--epochs", "1", "--hidden", "64", "--cpu"])
    assert np.isfinite(out["loss"]) and 0.0 <= out["test_acc"] <= 1.0
    assert out["test_acc"] > 0.5  # sklearn's digits, 11 steps


def test_train_cifar_runs(monkeypatch):
    small = train_cifar.synthetic_patches(n_train=256, n_test=64)
    monkeypatch.setattr(train_cifar, "load_cifar10", lambda data_dir: None)
    monkeypatch.setattr(train_cifar, "natural_patches", lambda: small)
    out = train_cifar.main(["--epochs", "1", "--cpu"])
    assert np.isfinite(out["loss"]) and 0.0 <= out["test_acc"] <= 1.0


def test_lightning_style_logs_checkpoints_and_resumes(tmp_path, capsys):
    out = train_lightning_style.main(["--epochs", "1", "--cpu", "--out", str(tmp_path)])
    assert out["reload_max_abs_diff"] == 0.0 and out["reload_tensors"] == 9
    # the JAX example passes metrics.csv / metrics.jsonl as the loggers'
    # directories, so each is a directory holding the file of that name
    csv_file = tmp_path / "metrics.csv" / "metrics.csv"
    jsonl = [json.loads(line) for line in (tmp_path / "metrics.jsonl" / "metrics.jsonl")
             .read_text().splitlines()]
    header = csv_file.read_text().splitlines()[0]
    assert header == "step,time,loss,acc,test_acc,resumed,test_acc_resumed"
    assert sum(1 for r in jsonl if r.get("resumed") == 1.0) == 5
    assert jsonl[-1] == {"step": jsonl[-1]["step"], "test_acc_resumed": out["resumed_acc"]}
    assert (tmp_path / "ckpt" / "params.safetensors").exists()
    assert "final (resumed) test acc" in capsys.readouterr().out


def test_twins_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: train_mnist.main(["--epochs", "1"]),
                lambda: serve.main(["--requests", "1"]),
                lambda: quantize_and_generate.main(["--checkpoint", "missing.safetensors"])):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            run()
