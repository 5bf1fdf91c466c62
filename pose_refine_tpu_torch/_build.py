"""Build the port's CUDA kernels at first use.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds. The library lands in
``_build/<hash>/`` inside the package (git-ignored); the hash covers the
sources and the flags, so an edited kernel rebuilds and an unchanged one
loads from disk. Only sources in the repository are compiled, and a failed
build raises with nvcc's own messages.

Every launch from Python goes through ``launch``: it decides the device and
the stream a kernel runs on (the device's current stream) and turns a C
entry's error code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libprt_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in nvcc.log
)

# C entry points: name -> (argtypes, restype). Pointers and the stream are
# c_void_p: a bare Python int would be passed as a 32-bit int.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "prt_rasterize": ((_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P), _I),
    "prt_raster_setup": ((_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P), _I),
    "prt_nn_flash": ((_P, _I, _P, _I, _P, _P, _I, _F, _I, _P, _I, _I, _P, _P, _P, _P), _I),
    "prt_nn_mxu_split": ((_P, _I, _P, _P, _P), _I),
    "prt_nn_mxu": ((_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P), _I),
    "prt_nn_kdtree": ((_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P), _I),
    "prt_gather_rows": ((_P, _L, _P, _I, _L, _P, _P), _I),
    "prt_icp_iterate": ((_P, _P, _I, _I, _P, _L, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P, _F,
                         _F, _I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _I, _P), _I),
    "prt_sin_cos": ((_P, _I, _P, _P, _P), _I),
    "prt_window_lift": ((_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P), _I),
    "prt_scene_table": ((_P, _I, _I, _I, _P, _P, _P), _I),
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


def _run_all(cmds):
    """Run the commands in parallel; [(cmd, returncode, output)]."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(c, p.returncode, out) for c, p, out in zip(cmds, procs, outs)]


def _compile(out_dir: Path) -> dict:
    nvcc = _nvcc()
    cu = [p for p in _sources() if p.suffix == ".cu"]
    out_dir.mkdir(parents=True, exist_ok=True)
    objs = [out_dir / f".{p.stem}.{os.getpid()}.o" for p in cu]  # nvcc links only *.o
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    steps = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(o), str(p)]
                      for p, o in zip(cu, objs)])
    if all(rc == 0 for _c, rc, _out in steps):
        steps += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                            "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    log = "".join(" ".join(c) + "\n" + out for c, _rc, out in steps)
    (out_dir / "nvcc.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [rc for _c, rc, _out in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{log}")
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


def launch(lib, entry: str, device, args, what: str) -> None:
    """Call the C entry ``entry`` of ``lib`` (load_kernels' library, or a
    library of another build with the same interface) with ``args`` and,
    appended, the current stream of ``device``, inside that device, without
    synchronising. Raises RuntimeError("<what> kernel launch failed: CUDA
    error N (message)") on a non-zero return."""
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.prt_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")
