"""Expert parallelism in the port against the JAX package's
(``tests/test_moe.py::test_moe_expert_parallel_sharded``): ``moe_mlp`` with
the 4 experts cut over ep 4 (``expert_shardings``), x replicated, against
the JAX sharded call (atol 1e-5, rtol 1e-4: f32 sums in other orders) and
bit for bit against the port's unsharded call (the expert outputs are
gathered before the combine, which keeps its order); and a tiny f32 MoE
Llama cut with ``shard_llama_params`` at ep 2 against itself unsharded:
logits, a decode step and the gradients bit for bit; and at ep 2 × tp 2
(each rank's 2 experts cut over tp, the JAX package runs this layout too:
its GSPMD logits read 7e-7 from its unsharded ones) within rtol 1e-5 /
atol 1e-6 (the tp sums in f32 in another order).  One gloo world of 4 CPU
processes (``_torch_worlds.expert_world``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import start_world
from bitorch_engine_tpu.ops import moe as jmoe

E, D, I = 4, 64, 128
STATIC = dict(w_bit=4, group_size=32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """``tests/test_moe.py``'s experts (stacked), router and tokens, saved
    for the ranks."""
    experts = jmoe.init_moe_experts(jax.random.PRNGKey(0), E, D, I, w_bit=4, group_size=32)
    router = jax.random.normal(jax.random.PRNGKey(1), (D, E), jnp.float32) * 0.5
    x = jax.random.normal(jax.random.PRNGKey(2), (16, D), jnp.float32)
    arrays = {"router": np.asarray(router), "x": np.asarray(x)}
    for name, qt in experts.items():
        assert (qt.w_bit, qt.group_size, qt.layout) == (4, 32, "gptq")
        for f in dataclasses.fields(qt):
            v = getattr(qt, f.name)
            if v is not None and not isinstance(v, (int, str, bool)):
                arrays[f"{name}.{f.name}"] = np.asarray(v)
    path = str(tmp_path_factory.mktemp("ep") / "experts.npz")
    np.savez(path, **arrays)
    return experts, router, x, path


@pytest.fixture(scope="module")
def pending_world(setup):
    return start_world("expert_world", 4, path=setup[3], static=STATIC)


@pytest.fixture(scope="module")
def jax_side(setup, pending_world):
    experts, router, x, _ = setup
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("ep",))
    experts_sh = jax.device_put(experts, jmoe.expert_shardings(mesh, experts))
    x_sh = jax.device_put(x, NamedSharding(mesh, P()))
    with mesh:
        y, aux, dropped = jax.jit(lambda ex, xx: jmoe.moe_mlp(
            xx, router, ex, top_k=2, capacity_factor=None))(experts_sh, x_sh)
    return dict(y=np.asarray(y), aux=float(aux), dropped=float(dropped))


@pytest.fixture(scope="module")
def world(pending_world, jax_side):
    return pending_world.result()


@pytest.mark.parametrize("form", ["stacked", "tuple"])
def test_moe_expert_parallel_sharded(world, jax_side, form):
    for r in range(4):
        np.testing.assert_allclose(world[r][f"{form}_ep"], jax_side["y"], atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(world[r][f"{form}_ep"], world[r][f"{form}_unsharded"])
        np.testing.assert_allclose(float(world[r][f"{form}_aux"]), jax_side["aux"], rtol=1e-6)
        assert float(world[r][f"{form}_dropped"]) == jax_side["dropped"] == 0.0


def test_moe_llama_at_ep2_equals_unsharded(world):
    """2 of the 4 experts a rank; logits, a decode step over dense caches,
    and the loss gradients of the router, attention, norms, embedding and
    this rank's experts, bit for bit."""
    for r in range(4):
        out = world[r]
        assert int(out["experts_a_layer"]) == 2
        for key in ("logits", "decode", "expert0_grad", "expert1_grad"):
            np.testing.assert_array_equal(out[f"llama_ep_{key}"], out[f"llama_unsharded_{key}"],
                                          err_msg=key)
        grads = [k.removeprefix("llama_unsharded_grad_") for k in out
                 if k.startswith("llama_unsharded_grad_")]
        assert any("router" in g for g in grads) and len(grads) > 10
        for name in grads:
            np.testing.assert_array_equal(out[f"llama_ep_grad_{name}"],
                                          out[f"llama_unsharded_grad_{name}"], err_msg=name)


def test_moe_llama_at_ep2_tp2_matches_unsharded(world):
    """Logits and the gradients of the replicated parameters (router,
    norms, embedding) and of this rank's experts' up columns."""
    for r in range(4):
        out = world[r]
        ep, tp = r // 2, r % 2
        inter = int(out["llama_ep_tp_inter"])
        assert inter == 512 // 2  # tiny_llama: intermediate 512
        np.testing.assert_allclose(out["llama_ep_tp_logits"], out["llama_unsharded_logits"],
                                   rtol=1e-5, atol=1e-6)
        grads = [k.removeprefix("llama_ep_tp_grad_") for k in out
                 if k.startswith("llama_ep_tp_grad_")]
        assert any("router" in g for g in grads) and any("norm" in g for g in grads)
        for name in grads:
            np.testing.assert_allclose(out[f"llama_ep_tp_grad_{name}"],
                                       out[f"llama_unsharded_grad_{name}"], rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        for e in range(2):
            want = out["llama_unsharded_up_grads"][ep * 2 + e][:, tp * inter : (tp + 1) * inter]
            np.testing.assert_allclose(out[f"llama_ep_tp_expert{e}_grad"], want, rtol=1e-5,
                                       atol=1e-6)
