"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, for ``sm_90a``
only.  A library is named after the hash of its source, the package's
headers and the flags, so a changed source is rebuilt and an unchanged one
is loaded as it is.  The output goes to ``bitorch_engine_tpu_torch/build/``,
which git ignores; each build's compiler log (``-Xptxas -v``: registers,
shared memory, spills) is kept beside its library.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's "
        "kernels are compiled from bitorch_engine_tpu_torch/csrc at first use"
    )


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            lib = _lib_path(src)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((src, lib, tmp, proc))
        failures = []
        for src, lib, tmp, proc in jobs:
            log, _ = proc.communicate()
            lib.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {src.name}:\n{log}")
                continue
            os.replace(tmp, lib)
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building all first)."""
    with _lock:
        if stem not in _libs:
            src = CSRC / f"{stem}.cu"
            if not _lib_path(src).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(src)))
            lib.bte_error_string.argtypes = [ctypes.c_int]
            lib.bte_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return _libs[stem]


def function(stem: str, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point of library ``stem`` with its argument types set.

    Every pointer and the stream are ``c_void_p`` (ctypes would otherwise
    pass a Python int as a 32-bit int); every entry point returns the
    launch's ``cudaGetLastError()``."""
    fn = getattr(load(stem), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the launch rules
    size clusters by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(stem: str, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = load(stem).bte_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
