#!/usr/bin/env python3
"""Time another revision's csrc/rasterize.cu against this checkout's, on one
CUDA card, at the raster's shapes.

    git show <rev>:pose_refine_tpu_torch/csrc/rasterize.cu > _local/parent/rasterize.cu
    python3 compare_raster.py _local/parent/rasterize.cu [--shape NAME ...] [--rounds N]

OTHER is built alone with this checkout's nvcc flags into its own library
under the git-ignored ``_build/``. Two interfaces are understood:

  * the coefficient-table kernel of before the redesign,
    ``prt_rasterize(coef, n_pose, n_tri, fb, out_h, out_w, height, rx, ry,
    stream)``: OTHER's path is then the whole old render - the per-pose
    gather of an indexed table (``index_select``, as MultiModelRefiner did),
    ``triangle_setup`` in torch (the (N, 16, T) table, ~157 launches) and
    OTHER's kernel (fill, atomicMin raster, finalize);
  * this checkout's interface (``prt_rasterize(table, ids, ...)``): a
    variant of the current kernel, e.g. an edited copy under ``_local/``.

The shapes are chip_smoke.py's [kernel] shapes (``raster_shapes``): scene,
hypotheses, per-pose, render-100, render-256, render-100-roi, multimodel
(default: all). Rounds alternate other, this, this, other; a round is one
kernel-alone time (chip_smoke.alone_ms: 20 renders between one pair of
CUDA events, queued behind a busy card so the host's enqueue is hidden).
Prints every round, then each build's median, min and max per render, the
bound and each build's share of it, and exits 1 if the two builds' outputs
differ at any shape.
"""

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PARENT = os.path.join(REPO, "_local", "parent", "rasterize.cu")
# the old coefficient-table interface
_P, _I = ctypes.c_void_p, ctypes.c_int
COEF_SIGNATURE = ((_P, _I, _I, _P, _I, _I, _I, _I, _I, _P), _I)


class OtherRaster:
    """Another revision's rasterize.cu, built alone; ``render(tris, poses,
    width, height, proj, roi)`` takes what ops.rasterize_cuda.rasterize
    takes (CUDA tensors) and renders through it."""

    def __init__(self, src: str):
        from pose_refine_tpu_torch import _build

        text = open(src).read()
        self.coef_interface = re.search(r"prt_rasterize\s*\(\s*const float\s*\*\s*coef", text) is not None
        out_dir = _build.BUILD_ROOT / "compare"
        out_dir.mkdir(parents=True, exist_ok=True)
        # a library name per source: the loader hands back an already loaded
        # library of the same path
        lib = out_dir / f"libother_raster_{hashlib.sha256(text.encode()).hexdigest()[:12]}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), src]
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{run.stdout}{run.stderr}")
        self.ptxas = [ln.strip() for ln in (run.stdout + run.stderr).splitlines()
                      if "registers" in ln or "spill" in ln]
        self.lib = ctypes.CDLL(str(lib))
        sig = COEF_SIGNATURE if self.coef_interface else _build.SIGNATURES["prt_rasterize"]
        self.lib.prt_rasterize.argtypes, self.lib.prt_rasterize.restype = sig
        self.what = ("old path: torch triangle_setup + the coefficient-table kernel"
                     if self.coef_interface else "a variant of this interface")

    def render(self, tris, poses, width, height, proj, roi):
        import torch

        from pose_refine_tpu_torch.ops import rasterize_cuda as RC
        from pose_refine_tpu_torch.ops.rasterize import roi_shape

        out_w, out_h = roi_shape(width, height, roi)
        n = poses.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        fb = torch.empty((n, out_h, out_w), dtype=torch.int32, device=poses.device)
        if self.coef_interface:
            if isinstance(tris, RC.IndexedTris):
                tris = tris.gathered()
            coef = RC.triangle_setup(tris, poses, proj, width, height, roi)
            err = self.lib.prt_rasterize(coef.data_ptr(), n, coef.shape[2], fb.data_ptr(), out_h,
                                         out_w, height, int(roi[0]), int(roi[1]), stream)
        else:
            if isinstance(tris, RC.IndexedTris):
                table, ids = tris
            else:
                table, ids = (tris[None] if tris.dim() == 3 else tris), None
            m, t = table.shape[:2]
            scratch = torch.empty(max(4 * n * (-(-t // 32) + -(-t // 256)), 4),
                                  device=poses.device)
            err = self.lib.prt_rasterize(
                table.data_ptr(), None if ids is None else ids.data_ptr(), m, t, poses.data_ptr(),
                n, proj.data_ptr(), width, height, int(roi[0]), int(roi[1]), out_w, out_h,
                fb.data_ptr(), scratch.data_ptr(), stream)
        if err:
            raise SystemExit(f"other rasterize.cu: launch failed, CUDA error {err}")
        return fb


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", default=PARENT, help="the other revision's rasterize.cu")
    ap.add_argument("--shape", action="append", help="a shape of chip_smoke.raster_shapes "
                    "(repeatable; default all)")
    ap.add_argument("--rounds", type=int, default=3, help="ABBA groups of rounds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_raster: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import _build, geometry, mesh
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[compare] card: {smi.stdout.strip()}", flush=True)
    _build.load_kernels()
    other = OtherRaster(args.other)
    print(f"[compare] other: {args.other} ({other.what}); {other.ptxas}", flush=True)
    shapes = CS.raster_shapes(torch, ptt, geometry, mesh, torch.device("cuda"))[0]
    names = args.shape or list(shapes)
    same_all = True
    for name in names:
        tris, poses, width, height, proj, roi = shapes[name]
        fns = {"other": lambda: other.render(tris, poses, width, height, proj, roi),
               "this": lambda: RC.rasterize(tris, poses, width, height, proj, roi=roi)}
        outs = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        same_all &= same
        times = {"other": [], "this": []}
        for r in range(args.rounds):
            for k in ("other", "this", "this", "other"):
                times[k].append(CS.alone_ms(torch, fns[k], rounds=1))
        b = CS.raster_bound(torch, RC, tris, poses, width, height, proj, roi)
        med = {k: float(np.median(t)) for k, t in times.items()}
        print(f"[compare] {name}: N={poses.shape[0]} out={tuple(outs['this'].shape[1:])} "
              f"outputs_equal={same} bound_ms={b['bound_ms']} ({b['bound_by']})", flush=True)
        for k, t in times.items():
            print(f"[compare]   {k}: median_ms={med[k]} min_ms={min(t)} max_ms={max(t)} "
                  f"share_of_bound={b['bound_ms'] / med[k]} rounds={[round(x, 5) for x in t]}",
                  flush=True)
        print(f"[compare]   this / other = {med['this'] / med['other']}", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
