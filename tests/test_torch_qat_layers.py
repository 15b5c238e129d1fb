"""The binary / QAT slice's DiodeMix regimes and its later layers against
the JAX package, on the CPU (f32).

DiodeMix: the binary (a linear and a conv), IntQ (4 and 8 bits) and
binary-embedding regimes, beside the layers' fp scales and shifts, against
the JAX package's jitted ``diode_update`` over 6 steps, fed the same
gradients (the embedding's with untouched rows) from the same moments
(``load_jax_diode_state``).  The sign flips and the binary embedding's
words are equal; the IntQ codes equal but at most 0.1% one step apart (a
weight on a rounding boundary may round the other way: XLA may contract
the AdamW multiply-adds); moments and fp parameters within rtol 1e-5.

Layers: the binary embedding (the lookup exact, the dense table gradient
within rtol 1e-6 with untouched rows exactly 0) and its bag in both modes,
``q4_matmul`` (exact forward; backward against ``jax.vjp`` within rtol
1e-5) and ``BMHA`` in its three attention modes (forward and every
parameter's gradient within rtol 1e-4 of the largest: softmax and f32 sums
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu import qtensor as jqt
from bitorch_engine_tpu.layers.attention import BMHA as JBMHA
from bitorch_engine_tpu.ops import embedding as jemb
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.qat_matmul import q4_matmul as jq4_matmul
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.optim import diode_init, diode_update
from bitorch_engine_tpu.utils.convert import prepare_for_training as jprepare_for_training
from bitorch_engine_tpu_torch.layers.attention import BMHA
from bitorch_engine_tpu_torch.layers.conv import BinaryConv2d
from bitorch_engine_tpu_torch.layers.embedding import BinaryEmbedding, BinaryEmbeddingBag
from bitorch_engine_tpu_torch.layers.linear import BinaryLinear, Q4Linear, Q8Linear
from bitorch_engine_tpu_torch.ops import embedding as temb
from bitorch_engine_tpu_torch.ops.qat_matmul import q4_matmul
from bitorch_engine_tpu_torch.optim import DiodeHyperParams, DiodeMix
from bitorch_engine_tpu_torch.utils.convert import (
    load_jax_diode_state,
    load_jax_params,
    prepare_for_training,
)

STEPS = 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_records(rng):
    def w(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.05)

    conv = jq.init_binary_weight(w(32, 3 * 3 * 8))
    return {
        "bin": jq.init_binary_weight(w(32, 64)),
        "q4": jq.init_nbit_weight(w(32, 64), 4),
        "q8": jq.init_nbit_weight(w(24, 40), 8),
        "conv": jqt.BinaryQTensor(data=conv.data.T.reshape(3, 3, 8, 32), scale_w=conv.scale_w),
        "emb": jemb.quantize_binary_embedding(w(50, 40)),
    }


def _port_model(records):
    model = nn.Module()
    model.bin = BinaryLinear(64, 32, device="cpu")
    model.q4 = Q4Linear(64, 32, device="cpu")
    model.q8 = Q8Linear(40, 24, device="cpu")
    model.conv = BinaryConv2d(8, 32, device="cpu")
    model.emb = BinaryEmbedding(50, 40, device="cpu")
    tree = {name: {"qweight": rec} for name, rec in records.items()}
    for name in ("bin", "q4", "q8"):
        mod = getattr(model, name)
        tree[name]["scale_a"] = np.float32(0.5)
        tree[name]["bias_a"] = np.zeros(mod.bias_a.shape, np.float32)
    tree["conv"]["scale_a"] = np.float32(0.5)
    return load_jax_params(model, _np(tree)), tree


def test_diode_mix_quantized_regimes_match_jax():
    rng = np.random.default_rng(0)
    records = _jax_records(rng)
    model, tree = _port_model(records)
    # the JAX side: its prepare_for_training, the conv's shadow at full shape
    jparams = jprepare_for_training(jax.tree_util.tree_map(jnp.asarray, tree))
    jparams["conv"]["qweight"] = jparams["conv"]["qweight"].replace(
        grad_shadow=jnp.zeros((3, 3, 8, 32), jnp.float32))
    prepare_for_training(model)
    hp = JHP(lr=1e-3)
    jstate = diode_init(jparams, seed=0, hp=hp)
    opt = DiodeMix(model, DiodeHyperParams(lr=1e-3))
    assert [n for n, _ in opt.binary] == ["bin", "conv"] and [n for n, _ in opt.intq] == ["q4", "q8"]
    assert [n for n, _ in opt.bemb] == ["emb"]
    load_jax_diode_state(opt, _np(jstate))
    update = jax.jit(lambda g, s, p: diode_update(g, s, p, hp))
    for step in range(STEPS):
        grads, port_grads = {}, {}
        for name, sub in jparams.items():
            grads[name] = {}
            for key, leaf in sub.items():
                shape = (leaf.grad_shadow.shape if isinstance(leaf, jqt.QTensorBase)
                         else np.shape(leaf))
                g = np.asarray(rng.standard_normal(shape) * (0.1 + step), np.float32)
                if name == "emb":
                    g[rng.random(shape[0]) < 0.5] = 0.0  # rows not looked up
                port_grads[name if key == "qweight" else f"{name}.{key}"] = g
                grads[name][key] = (leaf.replace(grad_shadow=jnp.asarray(g))
                                    if isinstance(leaf, jqt.QTensorBase) else jnp.asarray(g))
        jparams, jstate = update(grads, jstate, jparams)
        for name, g in port_grads.items():
            target = model.get_submodule(name).grad_shadow if "." not in name else \
                model.get_parameter(name)
            target.grad = torch.from_numpy(np.asarray(g))
        opt.step()
    end = _np(jparams)
    for name in ("bin", "conv"):
        np.testing.assert_array_equal(getattr(model, name).data.numpy(), end[name]["qweight"].data)
    np.testing.assert_array_equal(model.emb.data.numpy(), end["emb"]["qweight"].data.view(np.int32))
    for name in ("q4", "q8"):
        diff = np.abs(getattr(model, name).data.numpy().astype(int)
                      - end[name]["qweight"].data.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (name, diff.max(), (diff > 0).mean())
        np.testing.assert_allclose(getattr(model, name).scale_a.item(), end[name]["scale_a"],
                                   rtol=1e-5)
    flipped = (model.bin.data.numpy() != records["bin"].data).mean()
    assert 0 < flipped < 1
    js = _np(jstate.leaf_states)
    for name, st in opt.state.items():
        path = name.split(".") if "." in name else [name, "qweight"]
        want = js
        for key in path:
            want = want[key]
        for key, val in st.items():
            np.testing.assert_allclose(val.numpy(), want[key], rtol=1e-5,
                                       atol=1e-6 * np.abs(want[key]).max(), err_msg=f"{name}/{key}")


def test_binary_embedding_and_bag_match_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((30, 40)).astype(np.float32)
    jrec = jemb.quantize_binary_embedding(jnp.asarray(w))
    trec = temb.quantize_binary_embedding(torch.from_numpy(w))
    np.testing.assert_array_equal(trec.data.numpy(), np.asarray(jrec.data).view(np.int32))
    np.testing.assert_allclose(trec.scale.numpy(), np.asarray(jrec.scale), rtol=1e-6)
    trec = trec.replace(scale=torch.from_numpy(np.array(jrec.scale)))
    idx = rng.integers(0, 20, (4, 6)).astype(np.int32)  # rows 20-29 never looked up
    g = rng.standard_normal((4, 6, 40)).astype(np.float32)
    jshadowed = jrec.replace(grad_shadow=jnp.zeros((30, 40), jnp.float32))
    jout, vjp = jax.vjp(lambda q: jemb.binary_embedding(jnp.asarray(idx), q), jshadowed)
    layer = BinaryEmbedding(30, 40, device="cpu", qweight=trec)
    prepare_for_training(layer)
    out = layer(torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(torch.from_numpy(g))
    want = np.asarray(vjp(jnp.asarray(g))[0].grad_shadow)
    np.testing.assert_allclose(layer.grad_shadow.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not layer.grad_shadow.grad[20:].any()
    for mode in ("mean", "majority"):
        bag = BinaryEmbeddingBag(30, 40, mode=mode, device="cpu", qweight=trec)
        np.testing.assert_allclose(
            bag(torch.from_numpy(idx)).numpy(),
            np.asarray(jemb.binary_embedding_bag(jnp.asarray(idx), jrec, mode)), rtol=1e-6)


def test_q4_matmul_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    y = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    xc, yc = np.float32(0.3), np.float32(0.2)
    g = rng.standard_normal((2, 3, 8, 5)).astype(np.float32)
    jout, vjp = jax.jit(lambda *a: jax.vjp(jq4_matmul, *a))(x, y, xc, yc)
    jgrads = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, y, xc, yc)]
    out = q4_matmul(*ts)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(torch.from_numpy(g))
    for t, jg in zip(ts, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5, atol=1e-6 * np.abs(jg).max())
    with pytest.raises(ValueError, match="batched"):
        q4_matmul(ts[0][0, 0], ts[1][0, 0], ts[2], ts[3])


@pytest.mark.parametrize("mode", ["fp", "binary", "q4"])
def test_bmha_matches_jax(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    kw = dict(binary_attention=mode == "binary", q4_attention=mode == "q4")
    jm = JBMHA(hidden=32, num_heads=4, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    g = rng.standard_normal((2, 6, 32)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x)) * g)

    jout = np.asarray(jm.apply(params, jnp.asarray(x)))
    jgrads = _np(jax.grad(loss, allow_int=True)(params))["params"]
    model = load_jax_params(BMHA(32, 4, device="cpu", **kw), _np(params))
    out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0, atol=1e-5 * np.abs(jout).max())
    (out * torch.from_numpy(g)).sum().backward()
    for name, p in model.named_parameters():
        want = jgrads
        for key in name.split("."):
            want = want[key]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-12), err_msg=name)


def test_quantize_params_matches_jax_quantized_apply():
    """A plain model's fp linears swapped for MPQ linears: the port's
    ``quantize_params`` against the JAX package's ``quantize_params`` +
    ``quantized_apply`` (codes and scales bit-exact; outputs within 1e-5 of
    the largest: f32 products in another order)."""
    from flax import linen as fnn

    from bitorch_engine_tpu.utils.convert import quantize_params as jquantize_params
    from bitorch_engine_tpu.utils.convert import quantized_apply
    from bitorch_engine_tpu_torch.layers.basic import Dense
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear
    from bitorch_engine_tpu_torch.utils.convert import get_mpq_config, quantize_params

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            h = jax.nn.relu(fnn.Dense(128)(x))
            return fnn.Dense(10)(h)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(256, 128, device="cpu")
            self.Dense_1 = Dense(128, 10, device="cpu")

        def forward(self, x):
            return self.Dense_1(torch.relu(self.Dense_0(x)))

    x = np.random.default_rng(4).standard_normal((6, 256)).astype(np.float32)
    params = JNet().init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: a + 0.01, params)  # nonzero biases
    want = np.asarray(quantized_apply(JNet(), jquantize_params(params, strategy="4-128-256"),
                                      jnp.asarray(x)))
    model = quantize_params(load_jax_params(Net(), _np(params)), strategy="4-128-256")
    assert isinstance(model.Dense_0, MPQLinear) and model.Dense_0.bias is not None
    jq0 = jquantize_params(params, strategy="4-128-256")["params"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(model.Dense_0.packed.numpy(), np.asarray(jq0.packed))
    np.testing.assert_array_equal(model.Dense_0.scales.numpy(), np.asarray(jq0.scales))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # an nn.Linear (weight (out, in)) quantizes its transpose: the same codes
    lin = nn.Sequential(nn.Linear(256, 128))
    with torch.no_grad():
        lin[0].weight.copy_(torch.from_numpy(np.array(params["params"]["Dense_0"]["kernel"])).T)
        lin[0].bias.copy_(torch.from_numpy(np.array(params["params"]["Dense_0"]["bias"])))
    quantize_params(lin, strategy="4-128-256")
    assert isinstance(lin[0], MPQLinear)
    np.testing.assert_array_equal(lin[0].packed.numpy(), model.Dense_0.packed.numpy())
    torch.testing.assert_close(lin(torch.from_numpy(x)), model.Dense_0(torch.from_numpy(x)))
    assert get_mpq_config("2-32-32") == {"w_bit": 2, "group_size": 32, "dq_group_size": 32}
    with pytest.raises(ValueError, match="unknown strategy"):
        get_mpq_config("3-64-128")
