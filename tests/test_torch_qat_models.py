"""The binary / QAT models of the port trained and served against the JAX
package, on the CPU (f32).

``QuantMLP`` (784 → 128 → 128 → 10, the MNIST example's model at hidden
128) at 1, 4 and 8 bits: both packages train 6 DiodeMix steps (lr 1e-3,
batch 32, seeded synthetic digits by the recipe of
``examples/mnist/train_mnist.py``) from the same weights (``load_jax_params``
of the JAX tree) and the same optimizer state (``load_jax_diode_state``:
the binary regime's random initial moments decide its flips).  The losses
agree within 1e-6 relative (f32 sums in another order; they read ~2e-7)
and every quantized code is equal after the 6 steps.  Then both pack for
inference and the logits at batch 8 and 32 agree within 1e-5 of their
largest magnitude (the fp ``Dense`` products in another order; the packed
binary layer's integers are exact).  The JAX package's flax model refuses
its own packed tree (its init-shape check), so its logits come from its
ops on that tree.

``QuantConvNet`` (widths (16, 32, 32), 16×16 inputs): at 4 bits the forward
agrees within 1e-5 and 2 train steps give equal losses (1e-6) and codes.
At 1 bit, LayerNorm over a binary conv's integer outputs meets ties: a
channel whose exact value is the channel mean normalises to ±1e-8 or so,
whose sign depends on the order of the f32 sum (XLA's or PyTorch's).  The
test checks that every sign the two packages disagree on at a binary
conv's input is such a tie (|x| < 1e-6), that each layer fed the JAX
package's own input gives its output (the binary conv bit for bit), and,
over 2 steps, losses within 1e-2 relative and equal binary codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu import qtensor as jqt
from bitorch_engine_tpu import training as jtraining
from bitorch_engine_tpu.models.cnn import QuantConvNet as JConvNet
from bitorch_engine_tpu.models.mlp import QuantMLP as JMLP
from bitorch_engine_tpu.ops.binary_linear import binary_linear as jbinary_linear
from bitorch_engine_tpu.ops.qat_linear import qat_linear as jqat_linear
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.utils.convert import count_quantized_bytes as jcount_quantized_bytes
from bitorch_engine_tpu.utils.convert import prepare_for_inference as jprepare_for_inference
from bitorch_engine_tpu.utils.convert import prepare_for_training as jprepare_for_training
from bitorch_engine_tpu_torch import training
from bitorch_engine_tpu_torch.layers.linear import init_activation_scales
from bitorch_engine_tpu_torch.models.cnn import QuantConvNet
from bitorch_engine_tpu_torch.models.mlp import QuantMLP
from bitorch_engine_tpu_torch.optim import DiodeHyperParams
from bitorch_engine_tpu_torch.utils.convert import (
    count_quantized_bytes,
    load_jax_diode_state,
    load_jax_params,
    prepare_for_inference,
    prepare_for_training,
)

HIDDEN, BATCH, STEPS, LR = 128, 32, 6, 1e-3
QNAME = {1: "BinaryLinear_0", 4: "Q4Linear_0", 8: "Q8Linear_0"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def synthetic_digits(rng, n):
    """``train_mnist.synthetic_digits``: prototype digits + noise."""
    protos = np.random.default_rng(0).standard_normal((10, 784)).astype(np.float32)
    y = rng.integers(0, 10, n)
    x = protos[y] + rng.standard_normal((n, 784)).astype(np.float32) * 0.8
    return x.reshape(n, 28, 28), y.astype(np.int32)


def _batches():
    rng = np.random.default_rng(1)
    return [synthetic_digits(rng, BATCH) for _ in range(STEPS)]


def _jax_mlp_run(bits):
    model = JMLP(hidden=HIDDEN, bits=bits)
    batches = _batches()
    params = jprepare_for_training(model.init(jax.random.PRNGKey(0), jnp.asarray(batches[0][0])))
    hp = JHP(lr=LR)

    def loss_fn(p, batch):
        logits = model.apply(p, batch[0])
        return jtraining.cross_entropy_loss(logits, batch[1]), jtraining.accuracy(logits, batch[1])

    step = jtraining.make_train_step(loss_fn, hp)
    state = jtraining.create_train_state(params, hp)
    start, opt_start = _np(params), _np(state.opt_state)
    losses, accs = [], []
    for x, y in batches:
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["aux"]))
    return start, opt_start, losses, accs, state.params


@pytest.fixture(scope="module", params=[1, 4, 8])
def mlp_run(request):
    return request.param, _jax_mlp_run(request.param)


def _loss_fn(model, batch):
    logits = model(batch[0])
    return training.cross_entropy_loss(logits, batch[1]), training.accuracy(logits, batch[1])


def _port_mlp(bits, start):
    model = QuantMLP(784, HIDDEN, bits=bits, device="cpu")
    return load_jax_params(model, start)


def _jax_logits(params, bits, x):
    """The JAX package's packed forward, op by op (``QuantMLP.apply``
    refuses the packed tree)."""
    p = params["params"]
    h = jax.nn.hard_tanh(x.reshape(x.shape[0], -1) @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
    q = p[QNAME[bits]]
    if bits == 1:
        h = jbinary_linear(h, q["qweight"], q["scale_a"], q["bias_a"])
    else:
        h = jqat_linear(h + q["bias_a"], q["qweight"], q["scale_a"])
    return jax.nn.hard_tanh(h) @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]


def test_quant_mlp_trains_and_serves_like_jax(mlp_run):
    bits, (start, opt_start, want_losses, want_accs, jparams) = mlp_run
    model = prepare_for_training(_port_mlp(bits, start))
    step = training.make_train_step(model, _loss_fn, DiodeHyperParams(lr=LR))
    load_jax_diode_state(step.optimizer, opt_start)
    out = [step((torch.from_numpy(x), torch.from_numpy(y))) for x, y in _batches()]
    np.testing.assert_allclose([float(o["loss"]) for o in out], want_losses, rtol=1e-6)
    assert [float(o["aux"]) for o in out] == want_accs  # (loss, aux): the accuracy
    assert want_losses[-1] < 0.5 * want_losses[0]
    jq = _np(jparams)["params"][QNAME[bits]]["qweight"]
    np.testing.assert_array_equal(model.quant.data.numpy(), np.asarray(jq.data))

    jpacked = jprepare_for_inference(jparams)
    prepare_for_inference(model)
    if bits == 1:
        assert model.quant._packed and model.quant.data.dtype == torch.int32
        np.testing.assert_array_equal(
            model.quant.data.numpy(),
            np.asarray(jpacked["params"][QNAME[1]]["qweight"].data).view(np.int32))
    assert model.quant.grad_shadow is None and not any(p.requires_grad for p in model.parameters())
    rng = np.random.default_rng(9)
    for batch in (8, 32):
        x, _ = synthetic_digits(rng, batch)
        want = np.asarray(_jax_logits(jpacked, bits, jnp.asarray(x)))
        got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_quantized_bytes_count_like_jax(mlp_run):
    """Grad shadows counted in training mode; the packed binary weight
    takes one bit a weight, 8x less than its int8 QAT form."""
    bits, (start, *_rest) = mlp_run
    model = _port_mlp(bits, start)
    assert count_quantized_bytes(model) == jcount_quantized_bytes(start)
    prepare_for_inference(model)
    after = count_quantized_bytes(model)
    assert after == jcount_quantized_bytes(_np(jprepare_for_inference(start)))
    assert after["packed_bytes"] == HIDDEN * HIDDEN // (8 if bits == 1 else 1) + 4


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_activation_scale_init_matches_flax_init(bits):
    """``init_activation_scales`` sets ``scale_a`` from the layer's input on
    a sample batch, as flax's init-time forward (rtol 1e-6: the mean's sum
    in another order); ``QuantMLP(sample=...)`` runs it."""
    x = torch.from_numpy(_batches()[0][0])
    jparams = _np(JMLP(hidden=HIDDEN, bits=bits).init(jax.random.PRNGKey(0), x.numpy()))
    model = _port_mlp(bits, jparams)
    model.quant.scale_a.data.fill_(1.0)
    init_activation_scales(model, x)
    np.testing.assert_allclose(model.quant.scale_a.item(),
                               float(jparams["params"][QNAME[bits]]["scale_a"]), rtol=1e-6)
    seeded = QuantMLP(784, HIDDEN, bits=bits, device="cpu", sample=x)
    assert seeded.quant.scale_a.item() != 1.0 and not seeded.quant._calibrating


CONV_X = np.random.default_rng(0).standard_normal((4, 16, 16, 3)).astype(np.float32)
CONV_Y = np.random.default_rng(1).integers(0, 10, 4).astype(np.int32)


def _full_shadows(params):
    """The JAX package's trees with a grad shadow of each weight's full
    shape (its ``with_grad_shadow`` gives a binary conv ``(KH, KW)``)."""
    def f(leaf):
        if isinstance(leaf, jqt.QTensorBase):
            return leaf.replace(grad_shadow=jnp.zeros(leaf.data.shape, jnp.float32))
        return leaf

    return jax.tree_util.tree_map(f, params, is_leaf=lambda v: isinstance(v, jqt.QTensorBase))


@pytest.mark.parametrize("bits", [1, 4])
def test_quant_convnet_matches_jax(bits):
    jmodel = JConvNet(bits=bits, widths=(16, 32, 32))
    params = _full_shadows(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(CONV_X)))
    model = load_jax_params(QuantConvNet(bits=bits, widths=(16, 32, 32), device="cpu"), _np(params))
    assert model.qconv_0.grad_shadow.shape == model.qconv_0.data.shape

    # each layer fed the JAX package's own input gives its output
    _, inter = jmodel.apply(params, jnp.asarray(CONV_X), capture_intermediates=True,
                            mutable=["intermediates"])
    inter = _np(inter["intermediates"])
    h = torch.from_numpy(CONV_X)
    for name in ("Conv_0", "LayerNorm_0", "qconv_0", "LayerNorm_1", "qconv_1", "LayerNorm_2"):
        want = inter[name]["__call__"][0]
        got = getattr(model, name)(h).detach().numpy()
        if name.startswith("qconv"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)
        h = torch.from_numpy(np.array(want))
        if name.startswith("LayerNorm"):
            h = torch.clamp(h, -1, 1)
            if name == "LayerNorm_2":
                h = torch.nn.functional.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

    # end to end: sign disagreements at the quantized convs' inputs are ties
    seen = []
    hooks = [getattr(model, f"LayerNorm_{i}").register_forward_hook(
        lambda m, i, o: seen.append(o.detach().numpy())) for i in range(2)]
    got = model(torch.from_numpy(CONV_X)).detach().numpy()
    for hk in hooks:
        hk.remove()
    want = np.asarray(jmodel.apply(params, jnp.asarray(CONV_X)))
    for i, port_in in enumerate(seen):
        jax_in = inter[f"LayerNorm_{i}"]["__call__"][0]
        flips = (port_in >= 0) != (jax_in >= 0)
        assert not flips.any() or np.abs(jax_in[flips]).max() < 1e-6
    if bits == 4:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    hp = JHP(lr=LR)
    jstep = jtraining.make_train_step(
        lambda p, b: jtraining.cross_entropy_loss(jmodel.apply(p, b[0]), b[1]), hp)
    state = jtraining.create_train_state(params, hp)
    opt_start = _np(state.opt_state)
    want_losses = []
    for _ in range(2):
        state, metrics = jstep(state, (jnp.asarray(CONV_X), jnp.asarray(CONV_Y)))
        want_losses.append(float(metrics["loss"]))
    step = training.make_train_step(
        model, lambda m, b: training.cross_entropy_loss(m(b[0]), b[1]), DiodeHyperParams(lr=LR))
    load_jax_diode_state(step.optimizer, opt_start)
    batch = (torch.from_numpy(CONV_X), torch.from_numpy(CONV_Y))
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6 if bits == 4 else 1e-2)
    end = _np(state.params)["params"]
    for i in range(2):
        np.testing.assert_array_equal(getattr(model, f"qconv_{i}").data.numpy(),
                                      np.asarray(end[f"qconv_{i}"]["qweight"].data))
