"""The GPipe pipeline in the port against the JAX package's
(``tests/test_pipeline.py``'s three cases at pp 4): the output against the
sequential stages (atol / rtol 1e-6), the stages' gradients against
``jax.grad`` of the sequential model (the JAX test's 1e-5: the output's
cotangent reaches the last stage once, not summed over the 4 ranks), and
quantized ``mpq_linear`` stages against the JAX package's pipeline (1e-5);
then the tiny f32 Llama through ``models.llama.pipeline_forward`` at pp 2
against the same model unpipelined, and a rank that fails inside the
schedule.  One gloo world of 4 CPU processes
(``_torch_worlds.pipeline_world``); the JAX side on the virtual devices.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import TESTS, pipeline_stages, start_world
from bitorch_engine_tpu.ops.mpq_linear import mpq_linear as jmpq_linear
from bitorch_engine_tpu.ops.quant import quantize_mpq as jquantize
from bitorch_engine_tpu.parallel.pipeline import pipeline_apply as jpipeline
from bitorch_engine_tpu.parallel.pipeline import stack_stages as jstack
from bitorch_engine_tpu_torch.parallel.multiprocess import launch_world

TINY_TOKENS = np.random.default_rng(6).integers(0, 256, (4, 16)).tolist()


@pytest.fixture(scope="module")
def pending_world():
    return start_world("pipeline_world", 4, tiny_tokens=TINY_TOKENS)


@pytest.fixture(scope="module")
def jax_side(pending_world):
    """The sequential references and the JAX quantized pipeline."""
    out = {}
    stages, x = pipeline_stages("outputs")
    ref = x
    for p in stages:
        ref = np.tanh(ref @ p["w"] + p["b"])
    out["outputs"] = ref

    stages, x = pipeline_stages("grads")

    def loss_seq(ws):
        h = jnp.asarray(x)
        for w in ws:
            h = jnp.tanh(h @ w)
        return jnp.mean(h ** 2)

    out["grads"] = [np.asarray(g) for g in jax.grad(loss_seq)([jnp.asarray(p["w"]) for p in stages])]

    stages, x = pipeline_stages("quantized")
    qts = [jquantize(jnp.asarray(w), w_bit=4, group_size=32) for w in stages]
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("pp",))
    out["quantized"] = np.asarray(jax.jit(lambda sp, xx: jpipeline(
        lambda qt, h: jax.nn.gelu(jmpq_linear(h, qt)), sp, xx, mesh, num_microbatches=4))(
        jstack(qts), jnp.asarray(x)))
    return out


@pytest.fixture(scope="module")
def world(pending_world, jax_side):
    return pending_world.result()


def test_pipeline_matches_sequential(world, jax_side):
    for r in range(4):
        np.testing.assert_allclose(world[r]["outputs_out"], jax_side["outputs"], atol=1e-6, rtol=1e-6)


def test_pipeline_gradients_match_sequential(world, jax_side):
    """Rank r holds stage r's gradient."""
    for r in range(4):
        np.testing.assert_allclose(world[r]["grads_w"], jax_side["grads"][r], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(world[r]["grads_out"], world[0]["grads_out"])


def test_pipeline_quantized_stages(world, jax_side):
    for r in range(4):
        np.testing.assert_allclose(world[r]["quantized_out"], jax_side["quantized"], atol=1e-5,
                                   rtol=1e-5)


def test_llama_pipeline_matches_unpipelined(world):
    """pp 2 (a dp 2 × pp 2 mesh): the logits, and each rank's gradients of
    its own stage's block, the embedding and the final norm, against the
    unpipelined model's; the other stage's block has none."""
    for r in range(4):
        out, stage = world[r], int(world[r]["llama_stage"])
        np.testing.assert_allclose(out["llama_piped_logits"], out["llama_plain_logits"],
                                   rtol=1e-5, atol=1e-5)
        names = [k.removeprefix("llama_plain_grad_") for k in out if k.startswith("llama_plain_grad_")]
        for name in names:
            got, want = out[f"llama_piped_grad_{name}"], out[f"llama_plain_grad_{name}"]
            if name.startswith(f"layer_{1 - stage}."):
                assert got.size == 0, name
                continue
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)


@pytest.mark.parametrize("where", ["pipeline", "ring"])
def test_a_rank_failing_inside_the_schedule_ends_the_world(where):
    """Rank 1 raises at its second microbatch (or in the ring's backward)
    while rank 0 waits for it: the world is killed with both logs well
    before the collective's own timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a rank failed") as err:
        launch_world("_torch_worlds:failing_world", 2, {"where": where}, timeout=120,
                     python_path=[TESTS], collective_timeout=600)
    assert time.monotonic() - t0 < 120
    assert f"rank 1 fails in the {where}" in str(err.value)
