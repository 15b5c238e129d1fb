"""The port's checkpoint save and load (``utils/checkpoint.py``).

A checkpoint is one safetensors file of the model's flax-style tree plus
``qtensor_spec.json`` in the JAX package's schema.  Held here: the round
trip is bit-exact (every tensor, dtype and static field; the restored
model's logits equal), the restore needs no template (a skeleton on
``meta`` is filled), the spec equals the JAX package's ``_spec_of`` for the
same parameters, and ``pack=True`` saves packed binary weights without
grad shadows and leaves the model as it was.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.utils import checkpoint as jckpt
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.models.mlp import QuantMLP
from bitorch_engine_tpu_torch.qtensor import BinaryQTensor
from bitorch_engine_tpu_torch.utils import ingest
from bitorch_engine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from bitorch_engine_tpu_torch.utils.convert import (
    load_jax_params, params_tree, prepare_for_inference, prepare_for_training,
    prepare_params_for_cuda,
)

TOKENS = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])


def _act_order_model():
    """A tiny Llama whose layer-0 q projection is an act-order GPTQ tensor."""
    model = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, num_layers=1), device="cpu", seed=4)
    rng = np.random.default_rng(4)
    k, n, gs = 256, 256, 64
    qt = ingest.mpq_from_gptq(
        rng.integers(-(2**31), 2**31, (k // 8, n), dtype=np.int64).astype(np.int32),
        rng.integers(-(2**31), 2**31, (k // gs, n // 8), dtype=np.int64).astype(np.int32),
        rng.uniform(0.001, 0.01, (k // gs, n)).astype(np.float16),
        rng.permutation(np.arange(k) // gs).astype(np.int32), device="cpu")
    model.layer_0.attn.q_proj.set_qweight(qt)
    return model


MODELS = {
    "serving_bf16_meta": lambda: prepare_params_for_cuda(tl.LlamaModel(tl.tiny_llama(
        dtype=torch.float32, kv_cache_dtype="int8", quantize_embed=True, head_w_bit=4,
        head_pad_to=384, fuse_qkv=True, fuse_gate_up=True), device="cpu", seed=1), torch.bfloat16),
    "mbwq_a8": lambda: prepare_params_for_cuda(tl.LlamaModel(tl.tiny_llama(
        dtype=torch.float32, group_size=32, mbwq_strategy=((4, 0.25), (2, 0.75))), device="cpu",
        seed=2), torch.bfloat16, act_bits_map={2: 8}),
    "fp_bf16": lambda: tl.LlamaModel(tl.tiny_llama(quantized=False, attn_qkv_bias=True),
                                     device="cpu", seed=3),
    "act_order": _act_order_model,
}


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _assert_same_tree(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_same_tree(x, y, f"{path}/{i}")
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a) is type(b), path
        for name in a.__dataclass_fields__:
            _assert_same_tree(getattr(a, name), getattr(b, name), f"{path}.{name}")
    else:
        assert a == b, path


@pytest.mark.parametrize("name", list(MODELS))
def test_round_trip_is_bit_exact(tmp_path, name):
    model = MODELS[name]()
    want = model(TOKENS)[0]
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, model)
    assert sorted(os.listdir(path)) == ["params.safetensors", "qtensor_spec.json"]
    tree = load_checkpoint(path)
    _assert_same_tree(tree["params"], params_tree(model))
    # no template: a skeleton on meta takes every tensor from the tree
    restored = load_jax_params(tl.LlamaModel(model.cfg, device="meta"), tree, device="cpu")
    assert restored.device.type == "cpu"
    assert torch.equal(restored(TOKENS)[0], want)
    # and an existing model with other weights is overwritten to the same logits
    other = load_jax_params(MODELS[name]().requires_grad_(False), load_checkpoint(path))
    assert torch.equal(other(TOKENS)[0], want)


def test_spec_matches_the_jax_schema(tmp_path):
    """For parameters made by the JAX package and carried over, the port's
    ``qtensor_spec.json`` is the JAX package's ``_spec_of`` of them."""
    kw = dict(quantize_embed=True, head_w_bit=4, fuse_qkv=True, fuse_gate_up=True)
    params = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    model = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **kw), device="cpu", seed=1)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, model)
    with open(os.path.join(path, "qtensor_spec.json")) as f:
        spec = json.load(f)
    assert spec == json.loads(json.dumps(jckpt._spec_of(params)))


def test_a_spec_is_needed(tmp_path):
    with pytest.raises(FileNotFoundError, match="qtensor_spec.json"):
        load_checkpoint(str(tmp_path))


def test_pack_saves_packed_binary_weights(tmp_path):
    """``pack=True`` saves what ``prepare_for_inference`` leaves (binary
    linears packed, no grad shadows) and does not touch the model;
    ``pack=False`` saves the training form."""
    gen = torch.Generator().manual_seed(0)
    sample = torch.randn(4, 784, generator=gen)
    model = prepare_for_training(QuantMLP(bits=1, device="cpu", sample=sample))
    record = model.BinaryLinear_0.qweight
    assert not record.packed and record.grad_shadow is not None
    packed_path, train_path = os.path.join(tmp_path, "packed"), os.path.join(tmp_path, "train")
    save_checkpoint(packed_path, model)
    save_checkpoint(train_path, model, pack=False)
    assert not model.BinaryLinear_0.qweight.packed  # the model is unchanged
    saved = load_checkpoint(packed_path)["params"]["BinaryLinear_0"]["qweight"]
    assert isinstance(saved, BinaryQTensor) and saved.packed and saved.grad_shadow is None
    assert saved.data.dtype == torch.int32 and saved.data.shape == (1024, 1024 // 32)
    kept = load_checkpoint(train_path)["params"]["BinaryLinear_0"]["qweight"]
    assert not kept.packed and kept.grad_shadow is not None
    served = prepare_for_inference(model)
    fresh = prepare_for_inference(QuantMLP(bits=1, device="cpu", seed=5, sample=sample))
    restored = load_jax_params(fresh, load_checkpoint(packed_path))
    x = torch.randn(8, 784, generator=gen)
    assert torch.equal(restored(x), served(x))
