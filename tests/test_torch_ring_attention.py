"""Ring and Ulysses sequence-parallel attention in the port against the JAX
package's (``tests/test_ring_attention.py``'s inputs): the outputs at 2 and
4 ranks, their q / k / v gradients against ``jax.vjp`` of the JAX
functions, the ring against Ulysses, and Ulysses' refusal of a head count
the axis does not divide.

One gloo world of 4 CPU processes runs every case
(``_torch_worlds.attention_world``: each rank's shard of the output and of
the gradients); the JAX side runs on the virtual CPU devices meanwhile.  f32
on both sides, at the JAX test's tolerance (rtol 2e-4, atol 2e-5); the
port's blocks run kernels 3 and 4's plain versions (one tile a block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import ATTENTION_CASES, attention_inputs, start_world
from bitorch_engine_tpu.parallel.ring_attention import ring_attention as jring
from bitorch_engine_tpu.parallel.ulysses import ulysses_attention as julysses

TOL = dict(rtol=2e-4, atol=2e-5)
JAX_FNS = {"ring": jring, "ulysses": julysses}


@pytest.fixture(scope="module")
def pending_world():
    return start_world("attention_world", 4)


@pytest.fixture(scope="module")
def jax_side(pending_world):
    """Each case's JAX output and vjp on an ``sp`` mesh of its rank count."""
    out = {}
    for name, kind, n, seed, b, h, L, d in ATTENTION_CASES:
        mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("sp",))
        q, k, v, g = (jnp.asarray(a) for a in attention_inputs(seed, b, h, L, d))

        def fwd_vjp(q, k, v, g, kind=kind, mesh=mesh):
            y, vjp = jax.vjp(lambda q, k, v: JAX_FNS[kind](q, k, v, mesh), q, k, v)
            return (y, *vjp(g))

        out[name] = dict(zip(("out", "dq", "dk", "dv"),
                             map(np.asarray, jax.jit(fwd_vjp)(q, k, v, g))))
    return out


@pytest.fixture(scope="module")
def world(pending_world, jax_side):
    return pending_world.result()


def _gathered(world, name, key, n):
    """The case's full tensor: ranks 0..n-1 hold its sequence shards."""
    return np.concatenate([world[r][f"{name}_{key}"] for r in range(n)], axis=2)


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=[c[0] for c in ATTENTION_CASES])
@pytest.mark.parametrize("key", ["out", "dq", "dk", "dv"])
def test_matches_the_jax_function(world, jax_side, case, key):
    name, n = case[0], case[2]
    np.testing.assert_allclose(_gathered(world, name, key, n), jax_side[name][key], **TOL)


def test_second_sp_group_agrees(world):
    """On the dp 2 × sp 2 mesh ranks 2 and 3 form the second sp group and
    compute the same as ranks 0 and 1."""
    for name in ("ring2", "ulysses2"):
        for r in (0, 1):
            np.testing.assert_array_equal(world[r + 2][f"{name}_out"], world[r][f"{name}_out"])


@pytest.mark.parametrize("key", ["out", "dq", "dk", "dv"])
def test_ring_agrees_with_ulysses(world, key):
    np.testing.assert_allclose(_gathered(world, "agree_ring", key, 4),
                               _gathered(world, "agree_ulysses", key, 4), **TOL)


def test_ulysses_refuses_heads_the_axis_does_not_divide(world):
    assert all(int(r["ulysses_heads_raise"]) == 1 for r in world)
    with pytest.raises(ValueError, match="not divisible"):
        mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("sp",))
        x = jnp.zeros((1, 6, 8, 4))
        julysses(x, x, x, mesh)
