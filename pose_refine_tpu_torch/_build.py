"""Build the port's CUDA kernels at first use.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. Nothing
includes PyTorch's headers, so a build takes seconds. The library lands in
``_build/<hash>/`` inside the package (git-ignored); the hash covers the
sources and the flags, so an edited kernel rebuilds and an unchanged one
loads from disk. Only sources in the repository are compiled, and a failed
build raises with nvcc's own messages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libprt_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in nvcc.log
)

# C entry points: name -> (argtypes, restype). Pointers and the stream are
# c_void_p: a bare Python int would be passed as a 32-bit int.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "prt_rasterize": ((_P, _I, _I, _P, _I, _I, _I, _I, _I, _P), _I),
    "prt_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_loaded = None  # (ctypes.CDLL, build info dict) once built


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit (set CUDA_HOME)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build_info_key() -> str:
    """Hash of every kernel source and the compile flags."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> dict:
    nvcc = _nvcc()
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (out_dir / "nvcc.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out_dir / LIB_NAME)
    return {"seconds": seconds, "log": log}


def load_kernels():
    """(ctypes.CDLL, info) of the kernel library, building it on first use.

    info: {"path", "built" (False when loaded from an earlier build),
    "seconds" (compile time, 0 when loaded), "log" (nvcc/ptxas output)}."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        out_dir = BUILD_ROOT / build_info_key()
        lib_path = out_dir / LIB_NAME
        info = {"path": str(lib_path), "built": False, "seconds": 0.0, "log": ""}
        if not lib_path.exists():
            info.update(_compile(out_dir), built=True)
        lib = ctypes.CDLL(str(lib_path))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded = (lib, info)
        return _loaded
