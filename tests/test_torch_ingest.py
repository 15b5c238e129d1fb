"""The port's checkpoint ingestion against the JAX package's.

The same inputs, made from a seed with numpy, go through both packages'
``utils/ingest.py``: GPTQ (plain, act-order canonicalized, ragged), GBA
double-quantized (sym and asym, ``dq_mode`` 1 and 2) and exl2 (every width,
odd ones in containers, with ``q_invperm``) records must come out bit-equal,
field by field, and dequantize bit-equal.  The port's safetensors reader
and writer are held against the ``safetensors`` package in both
directions.
"""

import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import mbwq_linear as jmbwq
from bitorch_engine_tpu.ops import quant as jquant
from bitorch_engine_tpu.utils import ingest as jingest
from bitorch_engine_tpu_torch.ops import mbwq_linear as tmbwq
from bitorch_engine_tpu_torch.ops import quant as tquant
from bitorch_engine_tpu_torch.utils import ingest as tingest


def assert_records_equal(port, ref):
    """Every tensor field bit-equal and every static field equal (a JAX
    record's numpy arrays against the port's tensors)."""
    assert type(port).__name__ == type(ref).__name__
    for name in ("packed", "scales", "zeros", "g_idx", "q_perm", "channel_scale", "block_perm"):
        if not hasattr(ref, name):
            continue
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if b is not None:
            b = np.array(b)
            b = b.view(np.int32) if b.dtype == np.uint32 else b
            assert a.dtype == torch.from_numpy(b).dtype, (name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    for name in ("w_bit", "group_size", "asym", "code_bits", "layout", "act_bits", "zeros_mid",
                 "perm_block"):
        if hasattr(ref, name):
            assert getattr(port, name) == getattr(ref, name), name
    if hasattr(ref, "segments"):
        assert len(port.segments) == len(ref.segments)
        for s_port, s_ref in zip(port.segments, ref.segments):
            assert_records_equal(s_port, s_ref)


def _gptq(rng, k, n, gs, wb):
    g = k // gs
    qweight = rng.integers(-(2**31), 2**31, (k // 32 * wb, n), dtype=np.int64).astype(np.int32)
    qzeros = rng.integers(-(2**31), 2**31, (g, n // 32 * wb), dtype=np.int64).astype(np.int32)
    scales = rng.uniform(0.01, 0.1, (g, n)).astype(np.float16)
    return qweight, qzeros, scales


def _g_idx(rng, kind, k, gs):
    if kind == "plain":
        return (np.arange(k) // gs).astype(np.int32)
    if kind == "act_order":
        return rng.permutation(np.arange(k) // gs).astype(np.int32)
    g_idx = np.zeros(k, np.int32)  # ragged: gs + 4 rows in group 0
    g_idx[gs + 4 :] = 1 + (np.arange(k - gs - 4) // gs)
    g_idx[-1] = g_idx[-2]
    return rng.permutation(g_idx).astype(np.int32)


@pytest.mark.parametrize("kind", ["plain", "act_order", "ragged"])
def test_mpq_from_gptq_matches_jax(kind):
    rng = np.random.default_rng({"plain": 0, "act_order": 1, "ragged": 2}[kind])
    k, n, gs, wb = 256, 64, 32, 4
    qweight, qzeros, scales = _gptq(rng, k, n, gs, wb)
    g_idx = _g_idx(rng, kind, k, gs)
    ref = jingest.mpq_from_gptq(qweight, qzeros, scales, g_idx)
    got = tingest.mpq_from_gptq(qweight, qzeros, scales, g_idx, device="cpu")
    assert_records_equal(got, ref)
    assert (got.q_perm is not None) == (kind == "act_order")
    assert (got.g_idx is not None) == (kind == "ragged")
    np.testing.assert_array_equal(tquant.dequantize_mpq(got, torch.float32).numpy(),
                                  np.asarray(jquant.dequantize_mpq(ref, jnp.float32)))
    # torch inputs ingest the same as numpy ones
    again = tingest.mpq_from_gptq(*(torch.from_numpy(a) for a in (qweight, qzeros, scales, g_idx)),
                                  device="cpu")
    assert_records_equal(again, ref)


def _gba_tensors(rng, g, n, dqg, dq_mode, asym, wb):
    pair = (1, n, 1) if dq_mode == 1 else (g, n // dqg, 1)
    t = {
        "qscales_zeros": rng.uniform(0, 2, pair).astype(np.float32),
        "qscales_scales": rng.uniform(0.5, 1.5, pair).astype(np.float32),
    }
    if asym:
        t["qscales"] = rng.integers(0, 16, (g, n // dqg, dqg), dtype=np.int64).astype(np.uint8)
        t["qzeros"] = rng.integers(-(2**31), 2**31, (g, n // 32 * wb),
                                   dtype=np.int64).astype(np.int32)
    else:
        t["qstatistic"] = rng.integers(0, 256, (g, n // dqg, dqg), dtype=np.int64).astype(np.uint8)
        t["qzeros_zeros"] = rng.uniform(0, 2, (g, n // dqg, 1)).astype(np.float32)
        t["qzeros_scales"] = rng.uniform(0.5, 1.5, (g, n // dqg, 1)).astype(np.float32)
    return t


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("dq_mode", [1, 2])
def test_mpq_from_gba_matches_jax(asym, dq_mode):
    rng = np.random.default_rng(10 * dq_mode + asym)
    k, n, gs, wb, dqg = 128, 64, 32, 4, 32
    qweight = rng.integers(-(2**31), 2**31, (k // 32 * wb, n), dtype=np.int64).astype(np.int32)
    t = _gba_tensors(rng, k // gs, n, dqg, dq_mode, asym, wb)
    ref = jingest.mpq_from_gba(qweight, t, w_bit=wb, group_size=gs, asym=asym, dq_mode=dq_mode)
    got = tingest.mpq_from_gba(qweight, t, w_bit=wb, group_size=gs, asym=asym, dq_mode=dq_mode,
                               device="cpu")
    assert_records_equal(got, ref)


def test_mpq_from_gba_precomputed_scales_match_jax():
    rng = np.random.default_rng(5)
    k, n, gs, wb = 512, 32, 256, 4
    qweight = rng.integers(-(2**31), 2**31, (k // 32 * wb, n), dtype=np.int64).astype(np.int32)
    t = {"scales": rng.uniform(0.01, 0.1, (2, n)).astype(np.float16),
         "zeros": rng.uniform(-0.1, 0.1, (2, n)).astype(np.float16)}
    ref = jingest.mpq_from_gba(qweight, t, w_bit=wb, group_size=gs, asym=True)
    got = tingest.mpq_from_gba(qweight, t, w_bit=wb, group_size=gs, asym=True, device="cpu")
    assert_records_equal(got, ref)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
def test_unpack_exl2_bitstream_matches_jax(bits):
    rng = np.random.default_rng(bits)
    qr = 3 * bits  # a whole number of 32-value runs, straddling words at odd widths
    words = rng.integers(-(2**31), 2**31, (qr, 16), dtype=np.int64).astype(np.int32)
    ref = jingest.unpack_exl2_bitstream(words, bits)
    got = tingest.unpack_exl2_bitstream(words, bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _exl2(rng, n, layout, gs):
    """exl2 tensors: groups of ``gs`` rows, ``layout`` = [(bits, groups)]."""
    total = sum(ng for _, ng in layout)
    q_scale = rng.integers(-(2**31), 2**31, (total, n // 8), dtype=np.int64).astype(np.int32)
    q_scale_max = rng.uniform(0.01, 0.2, total).astype(np.float32)
    q_groups, parts, qrow = [], [], 0
    for bits, ng in layout:
        for _ in range(ng):
            rows = gs * bits // 32
            parts.append(rng.integers(-(2**31), 2**31, (rows, n), dtype=np.int64).astype(np.int32))
            q_groups += [bits, qrow]
            qrow += rows
    return np.concatenate(parts), q_scale, q_scale_max, np.asarray(q_groups, np.int32)


@pytest.mark.parametrize("perm", ["none", "random", "blocks"])
def test_mbwq_from_exl2_matches_jax(perm):
    rng = np.random.default_rng({"none": 3, "random": 4, "blocks": 5}[perm])
    n, gs = 64, 64
    layout = [(8, 1), (6, 1), (5, 2), (4, 2), (3, 1), (2, 1)]
    q_weight, q_scale, q_scale_max, q_groups = _exl2(rng, n, layout, gs)
    k = gs * sum(ng for _, ng in layout)
    invperm = None
    if perm == "random":
        invperm = rng.permutation(k).astype(np.int32)
    elif perm == "blocks":
        invperm = (rng.permutation(k // 64)[:, None] * 64 + np.arange(64)).reshape(-1)
        invperm = invperm.astype(np.int32)
    cs = rng.uniform(0.5, 1.5, k).astype(np.float32)
    ref = jingest.mbwq_from_exl2(q_weight, q_scale, q_scale_max, q_groups, invperm, cs)
    got = tingest.mbwq_from_exl2(q_weight, q_scale, q_scale_max, q_groups, invperm, cs,
                                 device="cpu")
    assert_records_equal(got, ref)
    assert got.bit_widths == (8, 6, 5, 4, 3, 2)
    assert [s.w_bit for s in got.segments] == [8, 8, 8, 4, 4, 2]
    assert got.perm_block == {"none": 0, "random": 0, "blocks": 64}[perm]
    np.testing.assert_array_equal(tmbwq.dequantize_mbwq(got).numpy(),
                                  np.asarray(jmbwq.dequantize_mbwq(ref, jnp.float32)))
    np.testing.assert_array_equal(tingest.exl2_group_map(q_groups, q_weight.shape[0]).numpy(),
                                  jingest.exl2_group_map(q_groups, q_weight.shape[0]))


@pytest.mark.parametrize("kind", ["identity", "blocks128", "blocks32", "unaligned", "random"])
def test_detect_perm_block_matches_jax(kind):
    rng = np.random.default_rng(7)
    k = 512
    perm = {
        "identity": np.arange(k),
        "blocks128": (rng.permutation(4)[:, None] * 128 + np.arange(128)).reshape(-1),
        "blocks32": (rng.permutation(16)[:, None] * 32 + np.arange(32)).reshape(-1),
        "unaligned": np.roll(np.arange(k), 16),
        "random": rng.permutation(k),
    }[kind].astype(np.int32)
    assert tingest.detect_perm_block(perm) == jingest.detect_perm_block(perm)
    assert tingest.detect_perm_block(torch.from_numpy(perm)) == jingest.detect_perm_block(perm)


def _st_arrays(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "i32": rng.integers(-9, 9, (2, 3, 2), dtype=np.int64).astype(np.int32),
        "i64": rng.integers(-9, 9, (7,), dtype=np.int64),
        "u8": rng.integers(0, 255, (9,), dtype=np.int64).astype(np.uint8),
        "i8": rng.integers(-128, 127, (5, 1), dtype=np.int64).astype(np.int8),
        "bool": rng.integers(0, 2, (3,)).astype(bool),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


def test_safetensors_reads_the_library_files(tmp_path):
    arrays = _st_arrays(np.random.default_rng(0))
    path = os.path.join(tmp_path, "lib.safetensors")
    st_numpy.save_file(arrays, path, metadata={"format": "np"})
    got = tingest.load_safetensors(path)
    assert set(got) == set(arrays)
    for name, a in arrays.items():
        assert got[name].device.type == "cpu"
        np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)


def test_safetensors_files_read_by_the_library(tmp_path):
    arrays = _st_arrays(np.random.default_rng(1))
    path = os.path.join(tmp_path, "port.safetensors")
    tingest.save_safetensors(path, {k: torch.from_numpy(v) for k, v in arrays.items()},
                             metadata={"format": "pt"})
    back = st_numpy.load_file(path)
    assert set(back) == set(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_safetensors_bf16_round_trip(tmp_path):
    """bf16 (no numpy dtype) keeps its bits through the port's writer and
    reader; numpy arrays are written as they are."""
    t = {"w": torch.randn(6, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16),
         "n": np.arange(4, dtype=np.int32)}
    path = os.path.join(tmp_path, "bf16.safetensors")
    tingest.save_safetensors(path, t)
    got = tingest.load_safetensors(path)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t["w"])
    np.testing.assert_array_equal(got["n"].numpy(), t["n"])


def test_safetensors_unaligned_offsets_read(tmp_path):
    """The format allows a tensor at an offset its element size does not
    divide (the writers here align); such a tensor is copied out of the
    mapping, the others stay views of it."""
    header = {"a": {"dtype": "U8", "shape": [1], "data_offsets": [0, 1]},
              "b": {"dtype": "F32", "shape": [2], "data_offsets": [1, 9]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = tmp_path / "unaligned.safetensors"
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + b"\x07"
                     + np.array([1.5, -2.0], np.float32).tobytes())
    got = tingest.load_safetensors(str(path))
    assert got["a"].tolist() == [7] and got["b"].tolist() == [1.5, -2.0]
    np.testing.assert_array_equal(st_numpy.load_file(str(path))["b"], got["b"].numpy())
