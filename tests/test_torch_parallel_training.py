"""dp / fsdp DiodeMix training in the port against the JAX package's
``test_optimizer_state_sharding`` and against the port's unsharded step.
One gloo world of 4 CPU processes (``_torch_worlds.training_world``):

* the optimizer-state case (``tests/test_sharding.py:102``): a w4 g32 128 ×
  256 MPQ weight, one DiodeMix step on ``mean((x W - y)²)``, its packed
  codes equal to the JAX package's unsharded step's, with the record cut
  to tp 4 columns (moments ``P(None, 'tp')``, as the JAX specs) and with
  the moments' rows over fsdp 4 (``P('fsdp', 'tp')``);
* the tiny f32 Llama trained 5 DiodeMix steps (the zeros refresh at step
  5) against the unsharded step in the same process: fsdp 4 (the whole
  batch on every rank) gives every packed code, zero and parameter bit for
  bit; dp 2 × fsdp 2 and dp 4 (the gradients summed over ranks in another
  order) every packed code, the zeros and parameters within f32 rounding
  (rtol 1e-5, atol 1e-6; they read 3e-7), the losses within 1e-6;
* K rows that do not split into whole groups raise, and so does GaLore
  under fsdp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_worlds import start_world
from bitorch_engine_tpu.ops.mpq_linear import mpq_linear as jmpq_linear
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.optim import diode_init, diode_update
from bitorch_engine_tpu.parallel.sharding import optimizer_partition_specs as jopt_specs
from bitorch_engine_tpu.qtensor import with_grad_shadow as jwith_grad_shadow
from test_sharding import _mk_qt


@pytest.fixture(scope="module")
def pending_world():
    return start_world("training_world", 4)


@pytest.fixture(scope="module")
def jax_side(pending_world):
    """``test_optimizer_state_sharding``'s unsharded JAX step and its specs
    (fsdp_axis None)."""
    qt = jwith_grad_shadow(_mk_qt(k=128, n=256, gs=32))
    params = {"q": qt}
    hp = JHP(lr=1e-3)
    state = diode_init(params, hp=hp)
    x = jnp.asarray(np.random.default_rng(7).standard_normal((8, 128)).astype(np.float32))
    y = jnp.asarray(np.random.default_rng(8).standard_normal((8, 256)).astype(np.float32))

    def step(params, opt_state):
        grads = jax.grad(lambda p: jnp.mean((jmpq_linear(x, p["q"]) - y) ** 2),
                         allow_int=True)(params)
        return diode_update(grads, opt_state, params, hp)

    ref_p, _ = jax.jit(step)(params, state)
    specs = jopt_specs(state, params, fsdp_axis=None).leaf_states["q"]
    return dict(packed=np.asarray(ref_p["q"].packed),
                specs=[[str(a) for a in specs[k]] for k in ("exp_avg_l", "exp_avg_s")])


@pytest.fixture(scope="module")
def world(pending_world, jax_side):
    return pending_world.result()


@pytest.mark.parametrize("key", ["tp4", "fsdp4"])
def test_optimizer_state_sharding(world, jax_side, key):
    for r in range(4):
        np.testing.assert_array_equal(world[r][f"opt_{key}_packed"], jax_side["packed"])


def test_moment_specs_and_shapes(world, jax_side):
    """tp: the JAX package's ``P(None, 'tp')`` on each rank's 64 columns;
    fsdp: ``P('fsdp', 'tp')``, each rank keeping 32 of the 128 rows."""
    assert world[0]["opt_tp4_specs"].tolist() == jax_side["specs"]
    assert world[0]["opt_fsdp4_specs"].tolist() == [["fsdp", "tp"]] * 2
    assert world[0]["opt_tp4_moment_shape"].tolist() == [128, 64]
    assert world[0]["opt_fsdp4_moment_shape"].tolist() == [32, 256]


@pytest.mark.parametrize("key", ["fsdp4", "dp2_fsdp2", "dp4"])
def test_llama_steps_match_the_unsharded_steps(world, key):
    """The global losses of 5 steps within 1e-6, every packed code equal;
    fsdp 4 bit-equal in every zero and parameter too."""
    names = [k.removeprefix("llama_none_") for k in world[0] if k.startswith("llama_none_")
             and not k.endswith("losses")]
    for r in range(4):
        out = world[r]
        np.testing.assert_allclose(out[f"llama_{key}_losses"], out["llama_none_losses"], rtol=1e-6)
        for name in names:
            got, want = out[f"llama_{key}_{name}"], out[f"llama_none_{name}"]
            if key == "fsdp4" or name.endswith("packed"):
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_fsdp_moments_keep_their_rows(world):
    assert int(world[0]["llama_fsdp4_moment_rows"]) == 512 // 4
    assert int(world[0]["llama_dp2_fsdp2_moment_rows"]) == 512 // 2


@pytest.mark.parametrize("what,match", [("groups", "ValueError: .* do not split over fsdp=4"),
                                        ("galore", "NotImplementedError: GaLore under fsdp")])
def test_shapes_that_do_not_split_raise(world, what, match):
    import re

    assert re.search(match, str(world[0][f"raises_{what}"])), world[0][f"raises_{what}"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loss_share_stays_on_the_logits_device(device):
    """With a mesh the label count is summed where the logits are (NCCL
    takes no host tensor, and a host copy syncs every step); a meta tensor
    has no host copy at all.  On one process the share is the mean."""
    from bitorch_engine_tpu_torch.parallel import make_axes_mesh
    from bitorch_engine_tpu_torch.training import cross_entropy_loss

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 6, 11, generator=gen)
    labels = torch.randint(0, 11, (2, 6), generator=gen)
    labels[0, :2] = -100
    mesh = make_axes_mesh(dp=1, sp=1)
    got = cross_entropy_loss(logits.to(device), labels.to(device), mesh)
    assert got.device.type == device and got.dtype == torch.float32
    if device == "cpu":
        torch.testing.assert_close(got, cross_entropy_loss(logits, labels), rtol=1e-6, atol=0)
