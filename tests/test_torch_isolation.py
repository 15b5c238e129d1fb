"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
import bitorch_engine_tpu_torch
from bitorch_engine_tpu_torch import device as tdevice
from bitorch_engine_tpu_torch.layers.linear import MBWQLinear, MPQLinear
from bitorch_engine_tpu_torch.models import generate as tg
from bitorch_engine_tpu_torch.models import llama as tl

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(bitorch_engine_tpu_torch.__file__).parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "bitorch_engine_tpu"}
# the port, its twins of examples/ and chip_smoke
SOURCES = (sorted(PKG.rglob("*.py")) + sorted((ROOT / "examples_torch").rglob("*.py"))
           + [ROOT / "chip_smoke.py"])


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_port_imports_with_jax_blocked():
    """Import every module of the port (its ``tools`` and ``native``
    subpackages included), of ``examples_torch`` and chip_smoke, with the
    JAX packages made unimportable."""
    code = f"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {sorted(FORBIDDEN)!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
import bitorch_engine_tpu_torch as pkg
import examples_torch
seen = set()
for top in (pkg, examples_torch):
    for mod in pkgutil.walk_packages(top.__path__, top.__name__ + "."):
        importlib.import_module(mod.name)
        seen.add(mod.name)
for name in ("bitorch_engine_tpu_torch.tools.cli", "bitorch_engine_tpu_torch.tools.ppl_gate",
             "bitorch_engine_tpu_torch.native", "bitorch_engine_tpu_torch.utils.profiling",
             "bitorch_engine_tpu_torch.utils.metrics", "examples_torch.llm.serve",
             "examples_torch.mnist.train_lightning_style", "examples_torch.cifar.train_cifar"):
    assert name in seen, name
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.tiny_llama(dtype=torch.float32, num_layers=1)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.LlamaModel(cfg)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tl.init_kv_caches(cfg, 1)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        MPQLinear(128, 64)
    layer = MPQLinear(128, 64, device="cpu")
    assert layer.packed.device.type == "cpu"
    fused = MPQLinear(128, 64, qweight=layer.qweight)  # lives where its tensor does
    assert fused.packed.device.type == "cpu"
    model = tl.LlamaModel(cfg, device="cpu")
    assert model.device.type == "cpu"
    out = tg.generate(model, torch.tensor([[1, 2]]), max_new_tokens=2)
    assert out.shape == (1, 4)


def test_serving_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    """The paged caches and the batcher resolve a default device to cuda
    and raise without a GPU; a CPU model serves on the CPU."""
    from bitorch_engine_tpu_torch.models import paged_kv as tpk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.tiny_llama(dtype=torch.float32, num_layers=1)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tpk.init_paged_kv_caches(cfg, 5, 8, 2, 2)
    model = tl.LlamaModel(cfg, device="cpu")
    model.device = torch.device("cuda")  # as a default-device model has it
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tg.ContinuousBatcher(model, num_slots=2, max_len=32, kv_pages=5, kv_page_size=8)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tg.ContinuousBatcher(model, num_slots=2, max_len=32)
    model.device = torch.device("cpu")
    b = tg.ContinuousBatcher(model, num_slots=2, max_len=32, kv_pages=5, kv_page_size=8)
    assert b.caches[0].k_pool.device.type == "cpu"
    b.submit([1, 2, 3], max_new_tokens=2)
    assert len(b.run()[0].generated) == 2


def test_mbwq_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    """The sub-4-bit slice's entry points: an MBWQ layer or model with the
    default device raises without a GPU; asked for the CPU it runs there,
    in both regimes."""
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        MBWQLinear(256, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.LlamaModel(tl.llama2_7b_mbwq_serving())
    layer = MBWQLinear(256, 64, device="cpu")
    assert all(s.packed.device.type == "cpu" for s in layer.qweight.segments)
    assert MBWQLinear(256, 64, qweight=layer.qweight).q_perm.device.type == "cpu"
    cfg = tl.tiny_llama(dtype=torch.float32, num_layers=1, mbwq_strategy=((4, 0.5), (2, 0.5)),
                        group_size=32)
    model = tl.LlamaModel(cfg, device="cpu")
    for act_bits_map in (None, {2: 8}):
        prepare_params_for_cuda(model, act_bits_map=act_bits_map)
        out = tg.generate(model, torch.tensor([[1, 2]]), max_new_tokens=2)
        assert out.shape == (1, 4)


def test_qat_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    """The binary / QAT slice's models and layers resolve a default device
    to cuda and raise without a GPU; asked for the CPU they train, pack and
    serve there."""
    from bitorch_engine_tpu_torch.layers.attention import BMHA, LearnableBias, Q4MatMul
    from bitorch_engine_tpu_torch.layers.basic import Conv, Dense, LayerNorm
    from bitorch_engine_tpu_torch.layers.conv import BinaryConv2d, Q4Conv2d
    from bitorch_engine_tpu_torch.layers.embedding import BinaryEmbedding, BinaryEmbeddingBag
    from bitorch_engine_tpu_torch.layers.linear import BinaryLinear, Q4Linear, Q8Linear
    from bitorch_engine_tpu_torch.models.cnn import QuantConvNet
    from bitorch_engine_tpu_torch.models.mlp import QuantMLP
    from bitorch_engine_tpu_torch.training import cross_entropy_loss, make_train_step
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_inference, prepare_for_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: QuantMLP(), lambda: QuantConvNet(), lambda: BinaryLinear(64, 32),
                  lambda: Q4Linear(64, 32), lambda: Q8Linear(64, 32), lambda: BinaryConv2d(8, 16),
                  lambda: Q4Conv2d(8, 16), lambda: BinaryEmbedding(10, 32),
                  lambda: BinaryEmbeddingBag(10, 32), lambda: BMHA(32, 4), lambda: Q4MatMul(),
                  lambda: LearnableBias(8), lambda: Dense(8, 4), lambda: Conv(3, 8),
                  lambda: LayerNorm(8)):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            build()
    x = torch.randn(4, 28, 28, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([1, 2, 3, 4])
    model = prepare_for_training(QuantMLP(hidden=64, device="cpu", sample=x))
    assert model.quant.data.device.type == "cpu"
    step = make_train_step(model, lambda m, b: cross_entropy_loss(m(b[0]), b[1]))
    assert step((x, y))["aux"] is None
    prepare_for_inference(model)
    assert model.quant._packed and model(x[:2]).shape == (2, 10)
    net = QuantConvNet(widths=(8, 16), device="cpu", sample=torch.randn(2, 8, 8, 3))
    assert net(torch.randn(2, 8, 8, 3)).shape == (2, 10)
