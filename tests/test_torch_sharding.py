"""The port's sharding rules and sharded MPQ products against the JAX
package's (``tests/test_sharding.py``).

The JAX side runs in this process on the 8 virtual CPU devices (dp 2 × tp
4), jitted; the port's side in a gloo world of 4 CPU processes (tp 4), run
once for the module (``_torch_worlds.sharding_world``).  Both quantize the
same seeded weights (the port's ``quantize_mpq`` is bit-exact with the
JAX package's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import mk_qt, start_world
from bitorch_engine_tpu.ops import quant as jquant
from bitorch_engine_tpu.ops.mpq_linear import mpq_linear as jmpq_linear
from bitorch_engine_tpu.parallel import make_mesh as jmake_mesh
from bitorch_engine_tpu.parallel import mpq_row_parallel_spec as jrow_spec
from bitorch_engine_tpu.parallel import shard_params as jshard_params
from bitorch_engine_tpu.parallel import sharding as jsharding
from bitorch_engine_tpu_torch.ops import quant as tquant
from bitorch_engine_tpu_torch.parallel import (
    P,
    make_sharding_rules,
    mpq_row_parallel_spec,
    partition_specs,
)
from bitorch_engine_tpu_torch.parallel import sharding as tsharding


def _jqt(k=256, n=256, gs=64, seed=0):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
    return jquant.quantize_mpq(w, w_bit=4, group_size=gs)


def _x(seed):
    return np.random.default_rng(seed).standard_normal((8, 256)).astype(np.float32)


@pytest.fixture(scope="module")
def pending_world():
    return start_world("sharding_world", 4)


@pytest.fixture(scope="module")
def world(pending_world, jax_side):
    return pending_world.result()


@pytest.fixture(scope="module")
def jax_side(pending_world):
    """The JAX package's unsharded and sharded products (dp 2 × tp 4),
    computed while the world runs."""
    mesh = jmake_mesh(dp=2, tp=4)
    qt = _jqt()
    out = {"qt": qt}
    x1, x2 = jnp.asarray(_x(1)), jnp.asarray(_x(2))
    out["column_ref"] = np.asarray(jmpq_linear(x1, qt))
    out["column"] = np.asarray(jax.jit(jmpq_linear)(x1, jshard_params({"q": qt}, mesh)["q"]))
    spec = jrow_spec(qt, "tp", n_shards=4)
    qt_row = jax.device_put(qt, jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), spec))
    out["row_ref"] = np.asarray(jmpq_linear(x2, qt))
    out["row"] = np.asarray(jax.jit(jmpq_linear)(x2, qt_row))
    # a ragged g_idx under the JAX row spec: GSPMD reads the groups across shards
    g_idx = jnp.asarray((np.random.default_rng(4).permutation(256) // 64).astype(np.int32))
    ragged = qt.replace(g_idx=g_idx)
    spec = jrow_spec(ragged, "tp", n_shards=4)
    put = jax.device_put(ragged, jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), spec))
    out["ragged"] = np.asarray(jax.jit(jmpq_linear)(x2, put))
    return out


def test_quantized_weights_are_the_jax_packages(jax_side):
    qt, jqt = mk_qt(), jax_side["qt"]
    np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(jqt.packed).view(np.int32))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(jqt.scales))


@pytest.mark.parametrize("against", ["unsharded", "sharded"])
def test_column_parallel_matmul_matches(world, jax_side, against):
    want = jax_side["column_ref" if against == "unsharded" else "column"]
    for rank in world:
        np.testing.assert_allclose(rank["column"], want, rtol=1e-5, atol=1e-5)
        assert tuple(rank["column_packed_shape"]) == (32, 64)


@pytest.mark.parametrize("against", ["unsharded", "sharded"])
def test_row_parallel_matmul_matches(world, jax_side, against):
    want = jax_side["row_ref" if against == "unsharded" else "row"]
    for rank in world:
        np.testing.assert_allclose(rank["row"], want, rtol=1e-4, atol=1e-5)
        assert tuple(rank["row_packed_shape"]) == (8, 256)


def test_row_shard_of_an_act_order_tensor(world):
    """Stored rows cut whole; each shard reads the gathered activations at
    the logical rows it holds."""
    for rank in world:
        np.testing.assert_allclose(rank["act_order"], rank["act_order_ref"], rtol=1e-5, atol=1e-5)


def test_row_shard_of_a_ragged_g_idx_tensor(world, jax_side):
    """Each shard keeps every group's scales and zeros and its rows'
    ``g_idx``: the unsharded layer's product and the JAX package's under
    its row spec."""
    for rank in world:
        assert tuple(rank["ragged_scales_shape"]) == (4, 256)
        np.testing.assert_allclose(rank["ragged"], rank["ragged_ref"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rank["ragged"], jax_side["ragged"], rtol=1e-4, atol=1e-5)


def test_row_parallel_rejects_unalignable():
    qt = mk_qt(k=256, n=256, gs=64)  # 32 packed rows, 4 groups
    with pytest.raises(ValueError):
        mpq_row_parallel_spec(qt, "tp", n_shards=8)  # 4 groups % 8 != 0
    with pytest.raises(ValueError):
        jrow_spec(_jqt(), "tp", n_shards=8)


def test_rule_based_specs():
    qt = mk_qt()
    params = {"layer_0": {"o_proj": {"qweight": qt}, "q_proj": {"qweight": qt}}}
    rules = make_sharding_rules({r"o_proj": "row", r"q_proj": "column"})
    specs = partition_specs(params, rules)
    assert specs["layer_0"]["o_proj"]["qweight"].packed == P("tp", None)
    assert specs["layer_0"]["q_proj"]["qweight"].packed == P(None, "tp")


def _records():
    """(port record, JAX record) pairs of every record type, with and
    without their optional fields."""
    from bitorch_engine_tpu.ops import mbwq_linear as jmbwq
    from bitorch_engine_tpu.qtensor import BinaryEmbeddingQTensor as JBE
    from bitorch_engine_tpu.qtensor import with_grad_shadow as jshadow
    from bitorch_engine_tpu_torch.ops import mbwq_linear as tmbwq
    from bitorch_engine_tpu_torch.qtensor import BinaryEmbeddingQTensor as TBE
    from bitorch_engine_tpu_torch.qtensor import with_grad_shadow as tshadow

    w = np.random.default_rng(5).standard_normal((256, 128)).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    perm = np.random.default_rng(6).permutation(256).astype(np.int32)
    strategy = {"bits": [4, 2], "bits_prop": [0.5, 0.5], "group_size": {"4": 64, "2": 64}}
    return {
        "mpq": (tquant.quantize_mpq(tw, 4, 64), jquant.quantize_mpq(jw, 4, 64)),
        "mpq_asym": (tquant.quantize_mpq(tw, 4, 64, asym=True),
                     jquant.quantize_mpq(jw, 4, 64, asym=True)),
        "mpq_act_order": (tquant.quantize_mpq(tw, 4, 64).replace(q_perm=torch.from_numpy(perm)),
                          jquant.quantize_mpq(jw, 4, 64).replace(q_perm=jnp.asarray(perm))),
        "mpq_shadow": (tshadow(tquant.quantize_mpq(tw, 4, 64)),
                       jshadow(jquant.quantize_mpq(jw, 4, 64))),
        "binary": (tquant.init_binary_weight(tw.T), jquant.init_binary_weight(jw.T)),
        "intq": (tquant.init_nbit_weight(tw.T, 4), jquant.init_nbit_weight(jw.T, 4)),
        "binary_embedding": (
            TBE(data=torch.zeros(64, 4, dtype=torch.int32), scale=torch.ones(64, 1), dim=128),
            JBE(data=jnp.zeros((64, 4), jnp.uint32), scale=jnp.ones((64, 1)), dim=128)),
        "mbwq": (tmbwq.quantize_mbwq(tw, strategy), jmbwq.quantize_mbwq(jw, strategy)),
    }


def _spec_fields(spec):
    """Field → spec as a plain tuple (None where the field is absent)."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if isinstance(v, tuple) and v and not isinstance(v, (P, JP)) and not isinstance(v[0], (str, type(None))):
            out[f.name] = tuple(_spec_fields(s) for s in v)
        elif isinstance(v, (P, JP)):
            out[f.name] = tuple(v)
        elif v is None:
            out[f.name] = None
    return out


KINDS = ["mpq", "mpq_asym", "mpq_act_order", "mpq_shadow", "binary", "intq", "binary_embedding",
         "mbwq"]
# row-parallel specs are MPQ records' only (as in the JAX rules)
SPEC_CASES = [(k, c) for k in KINDS for c in ("column", "replicated")] + \
    [(k, "row") for k in KINDS if k.startswith("mpq")]


@pytest.mark.parametrize("kind,choice", SPEC_CASES)
def test_record_spec_is_the_jax_packages(kind, choice):
    """Each record type's spec under a rule equals the JAX package's, field
    by field."""
    tqt, jqt = _records()[kind]
    want = jsharding.make_sharding_rules({"w": choice})("w", jqt)
    got = make_sharding_rules({"w": choice})("w", tqt)
    assert type(got) is type(tqt)
    jf = _spec_fields(want)
    tf = _spec_fields(got)
    for name, spec in tf.items():
        assert spec == jf.get(name, spec), (name, spec, jf.get(name))
    shared = set(jf) & set(tf)
    assert {n for n in jf if jf[n] is not None} <= shared | {"grad_shadow"}


def test_default_specs_and_shards():
    """``partition_specs`` without rules: records column-parallel, tensors
    replicated; ``shard_params`` on a one-process mesh leaves them whole."""
    from bitorch_engine_tpu_torch.parallel import make_mesh, shard_params

    qt = mk_qt()
    params = {"a": {"qweight": qt}, "b": torch.ones(3)}
    specs = partition_specs(params)
    assert specs["a"]["qweight"].scales == P(None, "tp") and specs["b"] == P()
    out = shard_params(params, make_mesh())
    assert torch.equal(out["a"]["qweight"].packed, qt.packed) and torch.equal(out["b"], params["b"])
    assert tsharding.shard_tensor(torch.arange(8).reshape(2, 4), P(None, None), make_mesh()).shape == (2, 4)
