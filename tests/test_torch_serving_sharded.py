"""The port's sharded serving engine (``tests/test_serving_sharded.py``):
the ``ContinuousBatcher`` on a dp × tp mesh gives the unsharded batcher's
tokens, request by request, over dense caches (bf16 and int8 KV) at (dp,
tp) = (2, 2), (2, 1) and (1, 2), and over paged int8 caches at (2, 2)
with decode chunks of 1 and 4; each dp group's slots hold pages of its
own range only; a slot count dp does not divide raises.

The sharded runs are ranks of one gloo world of 4 CPU processes
(``_torch_worlds.serving_world``: a (2, 1) or (1, 2) layout leaves its
second copy on the fsdp axis, which serving does not use); the unsharded
batcher over dense caches, the reference, runs in this process on the same
seeded model (the port's unsharded batcher, dense and paged, is held to
the JAX package's in ``test_torch_batcher.py``)."""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import SERVING_MESHES, start_world
from bitorch_engine_tpu_torch.models.generate import ContinuousBatcher
from bitorch_engine_tpu_torch.models.llama import LlamaModel, tiny_llama

PROMPTS = [np.random.default_rng(21).integers(0, 256, size=n).tolist() for n in (4, 6, 3, 5, 7, 4)]
KV = ["bf16", "int8"]


@pytest.fixture(scope="module")
def pending_world():
    return start_world("serving_world", 4, prompts=PROMPTS)


@pytest.fixture(scope="module")
def world(pending_world, refs):
    return pending_world.result()


@pytest.fixture(scope="module")
def refs(pending_world):
    """The unsharded batcher's tokens, computed while the world runs (its
    paged and chunked runs give the dense run's tokens:
    ``test_torch_batcher.py``)."""
    return {kv: _unsharded(kv) for kv in KV}


def _unsharded(kv, **kw):
    model = LlamaModel(tiny_llama(dtype=torch.float32, kv_cache_dtype=kv), device="cpu", seed=0)
    b = ContinuousBatcher(model, num_slots=4, max_len=32, **kw)
    for p in PROMPTS:
        b.submit(p, max_new_tokens=5)
    ids = {r.uid: r.generated for r in b.run()}
    return np.asarray([ids[u] for u in sorted(ids)], np.int32)


@pytest.mark.parametrize("mesh_shape", list(SERVING_MESHES))
@pytest.mark.parametrize("kv", KV)
def test_sharded_batcher_matches_unsharded_dense(world, refs, kv, mesh_shape):
    ref = refs[kv]
    assert ref.shape == (6, 5)
    for rank in world:
        np.testing.assert_array_equal(rank[f"{kv}_dense_{mesh_shape}"], ref)


@pytest.mark.parametrize("chunk", [1, 4])
def test_sharded_batcher_matches_unsharded_paged(world, refs, chunk):
    """Paged int8 pools (tp-sharded heads, dp-grouped page ranges) and a
    dp-sharded page table, with and without chunked decode."""
    for rank in world:
        np.testing.assert_array_equal(rank[f"int8_paged{chunk}_2x2"], refs["int8"])


def test_sharded_paged_allocation_stays_in_dp_group(world):
    """Slots 0-1 (dp group 0) hold pages of group 0's range only, slots 2-3
    of group 1's: no page gather crosses dp groups."""
    for rank in world:
        tbl = rank["int8_table"]
        g0, g1 = tbl[:2][tbl[:2] > 0], tbl[2:][tbl[2:] > 0]
        assert g0.size and g1.size
        assert g0.max() <= 8 and g1.min() >= 9


def test_sharded_batcher_rejects_bad_slot_split(world):
    for rank in world:
        assert int(rank["int8_bad_split"]) == 1
