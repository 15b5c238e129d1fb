"""``utils/benchmark.py``'s ``time_op`` and ``time_fn_pytree`` against the
JAX package's helpers of the same names, on the CPU: the same number of
executions of ``f`` for the same ``iters``, ``warmup`` and ``reps`` (the
JAX side counted at run time by a ``jax.debug.callback`` inside ``f``),
each execution's input chained on the previous output, ``time_fn_pytree``
threading its arguments, and a positive, finite result in seconds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.utils import benchmark as jbench
from bitorch_engine_tpu_torch.utils import time_fn_pytree, time_op


def _jax_executions(run):
    """How many times the JAX helper ran ``f`` (``run(f)`` calls it)."""
    count = [0]

    def bump():
        count[0] += 1

    def f(*args):
        jax.debug.callback(bump)
        return args[0] if len(args) == 1 else args[0] @ args[1]

    run(f)
    jax.effects_barrier()
    return count[0]


@pytest.mark.parametrize("iters,warmup,reps", [(10, 1, 3), (25, 2, 2), (3, 0, 1)])
def test_time_op_runs_f_as_often_as_jax(iters, warmup, reps):
    x, w = np.ones((2, 4), np.float32), np.ones((4, 3), np.float32)
    want = _jax_executions(lambda f: jbench.time_op(f, jnp.asarray(x), jnp.asarray(w), iters=iters,
                                                    warmup=warmup, reps=reps))
    calls = []

    def f(xi, wi):
        calls.append(1)
        return xi @ wi

    secs = time_op(f, torch.from_numpy(x), torch.from_numpy(w), iters=iters, warmup=warmup, reps=reps)
    assert len(calls) == want
    assert math.isfinite(secs) and secs > 0


@pytest.mark.parametrize("iters,warmup", [(20, 1), (7, 3)])
def test_time_fn_pytree_runs_f_as_often_as_jax(iters, warmup):
    want = _jax_executions(lambda f: jbench.time_fn_pytree(
        lambda a: (f(a[0]) + 1.0, a[1]), (jnp.zeros(3), jnp.ones(2)), iters=iters, warmup=warmup))
    calls = []

    def f(a):
        calls.append(1)
        return a[0] + 1.0, a[1]

    secs = time_fn_pytree(f, (torch.zeros(3), torch.ones(2)), iters=iters, warmup=warmup)
    assert len(calls) == want
    assert math.isfinite(secs) and secs > 0


def test_time_op_chains_each_input_on_the_previous_output():
    """The whole output is consumed: ``x_next = x + 1e-30 · sum(f(x))``,
    exactly (``f`` scales by 1e30, so the chain moves ``x``)."""
    seen = []

    def f(x):
        seen.append(x.clone())
        return x * 1e30

    x0 = torch.tensor([1.0, 2.0])
    time_op(f, x0, iters=4, warmup=1, reps=1)
    runs, i = [], 0
    while i < len(seen):  # each run restarts at x0
        assert torch.equal(seen[i], x0)
        j = i + 1
        while j < len(seen) and not torch.equal(seen[j], x0):
            s = (seen[j - 1] * 1e30).sum(dtype=torch.float32)
            assert torch.equal(seen[j], seen[j - 1] + (s * 1e-30).to(seen[j].dtype))
            j += 1
        runs.append(j - i)
        i = j
    assert runs == [2, 4, 2, 4]  # warm-up lo, hi; then the timed lo, hi


def test_time_fn_pytree_threads_its_args():
    seen = []

    def f(a):
        seen.append({k: v.clone() for k, v in a.items()})
        return {"x": a["x"] * 2.0, "n": a["n"] + 1}

    time_fn_pytree(f, {"x": torch.ones(2), "n": torch.zeros((), dtype=torch.int64)}, iters=5)
    starts = [i for i, a in enumerate(seen) if int(a["n"]) == 0]
    assert len(starts) == 4  # warm-up lo, hi; the timed lo, hi
    for i in range(1, len(seen)):
        if i not in starts:
            assert int(seen[i]["n"]) == int(seen[i - 1]["n"]) + 1
            assert torch.equal(seen[i]["x"], seen[i - 1]["x"] * 2.0)


def test_time_fn_pytree_refuses_another_structure():
    with pytest.raises(ValueError, match="same structure"):
        time_fn_pytree(lambda a: (a[0],), (torch.ones(2), torch.ones(2)), iters=2)
