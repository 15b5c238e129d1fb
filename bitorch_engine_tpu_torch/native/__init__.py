"""ctypes bindings for the host-side bitpack library (``bitpack.cpp``).

The counterpart of ``bitorch_engine_tpu/native``, with its entry points:
numpy arrays in, numpy arrays out, the same bits as the port's torch
packing ops (``ops/packing.py``).  The library is built with ``g++`` at
first use into ``bitorch_engine_tpu_torch/build/`` (git-ignored), named
after the hash of its source, the compiler and the flags, so a changed
source is rebuilt and an unchanged one loaded as it is.  Nothing is built
at import time.

Unlike the JAX package, whose entry points return ``None`` when the build
fails, these raise ``RuntimeError`` with the compiler's log; ``available()``
says whether the library can be built and loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.packing import SUPPORTED_BITS

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "bitpack.cpp"
BUILD_DIR = _HERE.parent / "build"
CXX = "g++"
# no -march=native: a library left in build/ must load on any x86-64 host
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libbitpack-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"bitpack build failed: {CXX}: {e}") from e
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"bitpack build failed ({CXX} exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)


def _load() -> ctypes.CDLL:
    """The library, built first if missing; raises with the build's log
    (the first failure is kept: later calls raise it again)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        so = lib_path()
        try:
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            raise RuntimeError(_error) from e
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64, c_int = ctypes.c_int64, ctypes.c_int
        lib.repack_gptq_to_tpu_tiled.argtypes = [i32p, i32p, i64, i64, c_int, c_int]
        lib.unpack_gptq_codes.argtypes = [i32p, u8p, i64, i64, c_int]
        lib.pack_gptq_codes.argtypes = [u8p, i32p, i64, i64, c_int]
        lib.pack_signs_f32.argtypes = [f32p, u32p, i64, i64]
        for fn in (lib.repack_gptq_to_tpu_tiled, lib.unpack_gptq_codes, lib.pack_gptq_codes,
                   lib.pack_signs_f32):
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _check_rows(k: int, multiple: int, what: str) -> None:
    if k % multiple:
        raise ValueError(f"{what}: {k} rows is not a multiple of {multiple}")


def _ppw(w_bit: int) -> int:
    """Values per int32 word; the widths the packed words take."""
    if w_bit not in SUPPORTED_BITS:
        raise ValueError(f"w_bit={w_bit} unsupported; the packed words take {SUPPORTED_BITS}")
    return 32 // w_bit


def repack_gptq_to_tpu_tiled(packed: np.ndarray, w_bit: int, group_size: int) -> np.ndarray:
    """GPTQ-order packed int32 ``(K/ppw, N)`` → the tpu_tiled order."""
    ppw = _ppw(w_bit)
    lib = _load()
    packed = np.ascontiguousarray(packed, np.int32)
    kw, n = packed.shape
    k = kw * ppw
    _check_rows(k, group_size, "repack_gptq_to_tpu_tiled")
    _check_rows(group_size, ppw, "repack_gptq_to_tpu_tiled group")
    out = np.empty_like(packed)
    lib.repack_gptq_to_tpu_tiled(packed, out, k, n, w_bit, group_size)
    return out


def unpack_gptq_codes(packed: np.ndarray, w_bit: int) -> np.ndarray:
    """GPTQ-order packed int32 ``(K/ppw, N)`` → uint8 codes ``(K, N)``."""
    ppw = _ppw(w_bit)
    lib = _load()
    packed = np.ascontiguousarray(packed, np.int32)
    kw, n = packed.shape
    k = kw * ppw
    out = np.empty((k, n), np.uint8)
    lib.unpack_gptq_codes(packed, out, k, n, w_bit)
    return out


def pack_gptq_codes(codes: np.ndarray, w_bit: int) -> np.ndarray:
    """uint8 codes ``(K, N)`` → GPTQ-order packed int32 ``(K/ppw, N)``."""
    ppw = _ppw(w_bit)
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint8)
    k, n = codes.shape
    _check_rows(k, ppw, "pack_gptq_codes")
    out = np.empty((k // ppw, n), np.int32)
    lib.pack_gptq_codes(codes, out, k, n, w_bit)
    return out


def pack_signs(x: np.ndarray) -> np.ndarray:
    """f32 ``(rows, cols)`` → uint32 sign words ``(rows, cols/32)``: bit j of
    word w set iff ``x[:, 32 w + j] >= 0``."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    rows, cols = x.shape
    if cols % 32:
        raise ValueError(f"pack_signs: last axis {cols} is not a multiple of 32")
    out = np.empty((rows, cols // 32), np.uint32)
    lib.pack_signs_f32(x, out, rows, cols)
    return out
