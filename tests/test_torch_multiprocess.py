"""The port's process worlds (``tests/test_multiprocess.py``): the payload's
four items (the tp MPQ linear, the 1-bit MLP's DiodeMix losses with the
batch split over the ranks, the tp tiny-Llama forward, the sharded paged
batcher) agree between a 2-process gloo world (tp 2; dp 2 for item 2) and
one process, and with the JAX package's numbers on the same inputs and
parameters (the JAX parameters saved with ``save_checkpoint``, the MLP's
and its DiodeMix state's with ``torch.save``, loaded by every rank)."""

import functools
import re
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import TESTS
from bitorch_engine_tpu import training as jtraining
from bitorch_engine_tpu.models import generate as jg
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.models.mlp import QuantMLP as JMLP
from bitorch_engine_tpu.ops import quant as jquant
from bitorch_engine_tpu.ops.mpq_linear import mpq_linear as jmpq_linear
from bitorch_engine_tpu.optim import DiodeHyperParams as JHP
from bitorch_engine_tpu.utils.convert import prepare_for_training as jprepare_for_training
from bitorch_engine_tpu_torch import training
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.models.mlp import QuantMLP
from bitorch_engine_tpu_torch.optim import DiodeHyperParams
from bitorch_engine_tpu_torch.parallel import make_mesh
from bitorch_engine_tpu_torch.parallel.multiprocess import (
    free_port,
    launch_world,
    launch_workers,
    multiprocess_payload,
)
from bitorch_engine_tpu_torch.utils.checkpoint import save_checkpoint
from bitorch_engine_tpu_torch.utils.convert import (
    load_jax_diode_state,
    load_jax_params,
    prepare_for_training,
)

KEYS = ("mpq_y", "train_losses", "llama_logits", "serving_ids")


def _mlp_run(X, Y, path):
    """Item 2 in the JAX package: the 1-bit MLP (init key 0) trained 3
    DiodeMix steps (lr 1e-2) on the whole batch; its losses.  Its starting
    parameters and DiodeMix state are saved at ``path`` for the port."""
    mlp = JMLP(hidden=32, n_classes=10, bits=1)
    params = jprepare_for_training(mlp.init(jax.random.PRNGKey(0), jnp.asarray(X[:1])))
    hp = JHP(lr=1e-2)
    state = jtraining.create_train_state(params, hp)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    model = prepare_for_training(load_jax_params(QuantMLP(32, 32, 10, bits=1, device="cpu"),
                                                 np_tree(params)))
    step = training.make_train_step(model, lambda m, b: training.cross_entropy_loss(m(b[0]), b[1]),
                                    DiodeHyperParams(lr=1e-2))
    load_jax_diode_state(step.optimizer, np_tree(state.opt_state))
    torch.save({"model": model.state_dict(), "diode": step.optimizer.state_dict()}, path)
    jstep = jtraining.make_train_step(
        lambda p, b: jtraining.cross_entropy_loss(mlp.apply(p, b[0]), b[1]), hp)
    losses = []
    for _ in range(3):
        state, metrics = jstep(state, (jnp.asarray(X), jnp.asarray(Y)))
        losses.append(float(metrics["loss"]))
    return np.asarray(losses)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX payload's inputs and parameters (its generator's draws, keys
    1 and 2), its numbers for items 1, 3 and 4 (item 4 as the unsharded
    paged batcher, which the JAX test holds its payload to), and the
    2-process world, started on the parameters saved for the port as soon
    as they exist and run while the JAX package computes."""
    tmp = tmp_path_factory.mktemp("payload")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((256, 128)) * 0.02).astype(np.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    qt = jquant.quantize_mpq(jnp.asarray(w), w_bit=4, group_size=64)
    out = {"mpq_y": np.asarray(jmpq_linear(jnp.asarray(x), qt)),
           "mpq_ref": x @ np.asarray(jquant.dequantize_mpq(qt, jnp.float32))}
    X = rng.standard_normal((64, 32)).astype(np.float32)
    Y = np.argmax(X[:, :10], -1).astype(np.int32)
    out["train_losses"] = _mlp_run(X, Y, str(tmp / "mlp.pt"))
    cfg = jl.tiny_llama(dtype=jnp.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    model = jl.LlamaModel(cfg)
    lp = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(toks))
    cfg_s = jl.tiny_llama(dtype=jnp.float32, kv_cache_dtype="int8")
    model_s = jl.LlamaModel(cfg_s)
    sp = jax.jit(model_s.init)(jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))
    for name, params, kw in (("llama", lp, {}), ("serving", sp, {"kv_cache_dtype": "int8"})):
        tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **kw), device="cpu")
        load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
        save_checkpoint(str(tmp / name), tmodel)
    out["ckpts"] = dict(llama_ckpt=str(tmp / "llama"), serving_ckpt=str(tmp / "serving"),
                        mlp_state=str(tmp / "mlp.pt"), device="cpu")
    pool = ThreadPoolExecutor(max_workers=1)
    out["world"] = pool.submit(launch_workers, n_processes=2, timeout=240, **out["ckpts"])
    pool.shutdown(wait=False)
    out["llama_logits"] = np.asarray(jax.jit(model.apply)(lp, jnp.asarray(toks))[0])
    prompts = [rng.integers(0, cfg_s.vocab_size, size=n).tolist() for n in (4, 6, 3, 5, 7, 4)]
    b = jg.ContinuousBatcher(model_s, sp, num_slots=4, max_len=32, kv_pages=17, kv_page_size=8)
    for p in prompts:
        b.submit(p, max_new_tokens=5)
    ids = {r.uid: r.generated for r in b.run()}
    out["serving_ids"] = np.asarray([ids[u] for u in sorted(ids)], np.int32)
    return out


@pytest.fixture(scope="module")
def single(jax_side):
    return multiprocess_payload(make_mesh(), **jax_side["ckpts"])


@pytest.fixture(scope="module")
def world(jax_side, single):
    return jax_side["world"].result()


def test_payload_self_consistent_single_process(single):
    np.testing.assert_array_equal(np.asarray(single["mpq_y"]), np.asarray(single["mpq_ref"]))
    assert np.isfinite(np.asarray(single["llama_logits"])).all()
    assert single["serving_ids"].shape == (6, 5)
    assert single["train_losses"].shape == (3,) and np.isfinite(single["train_losses"]).all()


@pytest.mark.parametrize("key", KEYS)
def test_two_process_world_matches_single_process(world, single, key):
    """Both ranks of the tp 2 world equal each other and the one-process
    payload (row sums in another order: 1e-6)."""
    assert len(world) == 2
    np.testing.assert_array_equal(world[0][key], world[1][key])
    np.testing.assert_allclose(world[0][key], np.asarray(single[key]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key", KEYS)
def test_payload_matches_the_jax_packages(world, jax_side, key):
    np.testing.assert_allclose(world[0][key], jax_side[key], rtol=1e-4, atol=1e-4)


def test_payload_runs_on_the_card_unless_asked(jax_side):
    """``device=None`` means the card: without one the payload raises
    rather than run on the CPU."""
    ckpts = {k: v for k, v in jax_side["ckpts"].items() if k != "device"}
    if torch.cuda.is_available():
        out = multiprocess_payload(make_mesh(), **ckpts)
        np.testing.assert_allclose(out["mpq_y"], jax_side["mpq_y"], rtol=1e-2, atol=1e-3)
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            multiprocess_payload(make_mesh(), **ckpts)


def test_failed_world_raises_with_its_logs():
    """A rank that raises ends the world at once, with every rank's log:
    rank 1 raises while rank 0 waits in a collective that rank 1 never
    joins, and the world is killed well before that wait would time out."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a rank failed") as err:
        launch_world("_torch_worlds:fail_on_rank_1", 2, timeout=240, python_path=[TESTS],
                     collective_timeout=600)
    assert time.monotonic() - t0 < 240
    assert "rank 1 fails here" in str(err.value) and "rank 0 rc=" in str(err.value)
    # rank 1 exits by itself, or is killed in teardown once rank 0 has failed
    assert re.search(r"rank 1 rc=(1|-9):", str(err.value))
    assert 1024 <= free_port() < 65536
