"""Native (C++) host components, bound with ctypes (a copy of the JAX
package's ``pose_refine_tpu/native``: the two sources are its files,
unchanged).

``kdtree_builder.cpp`` is the kd-tree build of the NN scene (the reference's
pcd_scene.cpp:45-184), with the numpy builder's output bit for bit;
``cpu_baseline.cpp`` is the reference algorithm on the CPU (a scanline
renderer and projective point-to-plane ICP, OpenMP over poses), the
baseline a card run's verdicts are held against.

Both are compiled with ``g++ -O3 -march=native -fopenmp`` at first use into
``_build/native-<key>/`` inside the package (git-ignored, beside the CUDA
builds of ``_build.py``). The key hashes the sources, the flags, the
compiler's version and the target ``-march=native`` resolves to on this
host, so a checkout moved to another CPU rebuilds. Each process compiles to
a file of its own and renames it into place, so processes that build at
once (test workers) never load a half-written library. Without a compiler
everything reports unavailable: ``native_available()`` is False and
``build_kdtree(backend="auto")`` takes the numpy builder.

The functions take and return numpy arrays; a caller moves card tensors to
the host itself. The library links the OpenMP runtime by its soname,
``libgomp.so.1``; in a process that has imported torch, whose wheel ships
that runtime, the loader binds the one torch already loaded.
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

NATIVE_DIR = Path(__file__).resolve().parent
SOURCES = ("kdtree_builder.cpp", "cpu_baseline.cpp")
BUILD_ROOT = NATIVE_DIR.parent / "_build"
LIB_NAME = "_prt_native.so"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_I, _F = ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "prt_build_kdtree": ((_f32p, _I, _I, _i32p, _i32p, _i32p, _f32p, _f32p, _i32p, _i64p), _I),
    "cpu_render": ((_f32p, _I, _f32p, _I, _f32p, _I, _I, _i32p), None),
    "cpu_icp": ((_f32p, _u8p, _I, _I, _f32p, _f32p, _I, _I, _f32p, _F, _I, _F, _F,
                 _f32p, _f32p, _f32p), None),
    "cpu_threads": ((), _I),
}

_lock = threading.Lock()
_state = {"lib": None, "error": None}  # the loaded CDLL, or why it failed


def build_key(cxx: str = "g++") -> str:
    """Hash of the sources, the flags, the compiler's version and the
    target that ``-march=native`` resolves to here."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    for probe in ([cxx, "--version"], [cxx, "-march=native", "-Q", "--help=target"]):
        h.update(subprocess.run(probe, capture_output=True, check=True).stdout)
    return h.hexdigest()[:16]


def build(root: Path = BUILD_ROOT, cxx: str = "g++") -> Path:
    """The library's path under ``root``, compiling it first if it is not
    there: into a temporary file of this process, then renamed into place
    (atomic), so concurrent builders each rename a whole library. Raises
    with the compiler's messages on failure."""
    out_dir = Path(root) / f"native-{build_key(cxx)}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                           *(str(NATIVE_DIR / s) for s in SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with every entry point's signature set."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once a process; None if it cannot be
    (the reason is kept for ``unavailable_reason``)."""
    with _lock:
        if _state["lib"] is None and _state["error"] is None:
            try:
                _state["lib"] = load(build())
            except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
                _state["error"] = f"{type(e).__name__}: {e}"
        return _state["lib"]


def native_available() -> bool:
    return _lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    _lib()
    return _state["error"]


def build_kdtree_native(points: np.ndarray, leaf_size: int = 10):
    """C++ kd-tree build with the numpy builder's outputs and semantics.

    Returns (order, parent, child, split_dim, split_v, bbox, bounds, n_nodes)
    or None when the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    cap = max(2 * n, 16)
    parent = np.full(cap, -1, np.int32)
    child = np.full((cap, 2), -1, np.int32)
    split_dim = np.zeros(cap, np.int32)
    split_v = np.zeros(cap, np.float32)
    bbox = np.zeros((cap, 6), np.float32)
    bounds = np.zeros((cap, 2), np.int32)
    order = np.zeros(n, np.int64)
    m = int(lib.prt_build_kdtree(
        pts.ctypes.data_as(_f32p), n, int(leaf_size),
        parent.ctypes.data_as(_i32p), child.ctypes.data_as(_i32p),
        split_dim.ctypes.data_as(_i32p), split_v.ctypes.data_as(_f32p),
        bbox.ctypes.data_as(_f32p), bounds.ctypes.data_as(_i32p),
        order.ctypes.data_as(_i64p)))
    return (order, parent[:m].copy(), child[:m].copy(), split_dim[:m].copy(),
            split_v[:m].copy(), bbox[:m].copy(), bounds[:m].copy(), m)


def cpu_render_baseline(tris, poses, proj, width: int, height: int):
    """Reference-algorithm CPU renderer (OpenMP over poses): (T, 3, 3)
    tris, (N, 4, 4) poses, (4, 4) proj -> (N, height, width) int32 mm, or
    None if native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, np.float32)
    poses = np.ascontiguousarray(poses, np.float32)
    proj = np.ascontiguousarray(proj, np.float32)
    out = np.zeros((len(poses), height, width), np.int32)
    lib.cpu_render(tris.ctypes.data_as(_f32p), len(tris), poses.ctypes.data_as(_f32p),
                   len(poses), proj.ctypes.data_as(_f32p), int(width), int(height),
                   out.ctypes.data_as(_i32p))
    return out


def cpu_icp_baseline(clouds, valid, scene_pcd, scene_nrm, K,
                     max_dist=0.1, max_iter=30, rel_fit=1e-5, rel_rmse=1e-5):
    """Reference-algorithm projective point-to-plane ICP on the CPU (OpenMP
    over poses). clouds (N, P, 3) float32 meters, valid (N, P), the scene's
    (H, W, 3) point and normal images, K (3, 3). Returns (T (N, 4, 4),
    fitness (N,), rmse (N,)) or None.

    The native code moves the clouds in place, so it is handed a private
    copy: ``Tensor.numpy()`` shares the tensor's memory, and moving that
    buffer would change the caller's tensor."""
    lib = _lib()
    if lib is None:
        return None
    clouds = np.array(clouds, np.float32, copy=True, order="C")
    valid = np.ascontiguousarray(valid, np.uint8)
    scene_pcd = np.ascontiguousarray(scene_pcd, np.float32)
    scene_nrm = np.ascontiguousarray(scene_nrm, np.float32)
    K = np.ascontiguousarray(K, np.float32)
    n_poses, n_pts = clouds.shape[:2]
    sh, sw = scene_pcd.shape[:2]
    T = np.zeros((n_poses, 4, 4), np.float32)
    fit = np.zeros(n_poses, np.float32)
    rmse = np.zeros(n_poses, np.float32)
    lib.cpu_icp(clouds.ctypes.data_as(_f32p), valid.ctypes.data_as(_u8p), n_poses, n_pts,
                scene_pcd.ctypes.data_as(_f32p), scene_nrm.ctypes.data_as(_f32p), sh, sw,
                K.ctypes.data_as(_f32p), float(max_dist), int(max_iter), float(rel_fit),
                float(rel_rmse), T.ctypes.data_as(_f32p), fit.ctypes.data_as(_f32p),
                rmse.ctypes.data_as(_f32p))
    return T, fit, rmse


def cpu_threads() -> int:
    """OpenMP threads the baseline runs on (0 without the library)."""
    lib = _lib()
    return int(lib.cpu_threads()) if lib is not None else 0
