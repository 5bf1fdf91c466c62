#!/usr/bin/env python3
"""Time another revision's csrc/nn_flash.cu against this checkout's, on one
CUDA card, at the single-frame gated kernel's main shape.

    python3 compare_nn_flash.py OTHER/pose_refine_tpu_torch/csrc/nn_flash.cu

OTHER's source has the single-frame C interface, prt_nn_flash(queries, nq,
table, s_pad, boxes, balls, n_balls, gate2, prune, idx, dist, scanned,
stream). It is built alone with this checkout's nvcc flags into its own
library under the git-ignored ``_build/``; this checkout's kernels load as
usual. The input is chip_smoke.py's [nn-kernel] one: the 524,288
first-pass queries of the bench NN refine against the 2 mm voxel scene at
the 0.1 m gate. Rounds alternate other, this, this, other; a round is the
CUDA-event time of 20 back-to-back launches over 20. Prints every round,
then each build's median, min and max per launch, and checks that both
builds return the same idx and dist^2.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LAUNCHES = 20


def build_other(src: str) -> ctypes.CDLL:
    from pose_refine_tpu_torch import _build

    out_dir = _build.BUILD_ROOT / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libother_nn_flash.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), src]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{run.stdout}{run.stderr}")
    other = ctypes.CDLL(str(lib))
    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    other.prt_nn_flash.argtypes = (_P, _I, _P, _I, _P, _P, _I, _F, _I, _P, _P, _P, _P)
    other.prt_nn_flash.restype = _I
    return other


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other revision's nn_flash.cu")
    ap.add_argument("--rounds", type=int, default=6, help="ABBA groups of rounds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_nn_flash: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import _build, geometry, mesh
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC
    from pose_refine_tpu_torch.pipeline import refine_poses
    from pose_refine_tpu_torch.scene import nn_flash as NF
    from pose_refine_tpu_torch.scene.nn import SceneNN

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[compare] card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    this, _info = _build.load_kernels()
    other = build_other(args.other)

    # chip_smoke.py's [nn-kernel] input
    model, tris_np, truth, poses_np = CS.workload(geometry, mesh)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, CS.WIDTH, CS.HEIGHT, device=dev)
    scene = RC.rasterize(torch.as_tensor(tris_np, device=dev), torch.as_tensor(truth[None],
                         device=dev), CS.WIDTH, CS.HEIGHT, proj)[0].cpu().numpy()
    ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn_bruteforce", scene_voxel_mm=2.0,
                          **CS.CFG)
    ref.set_scene_depth(scene)
    seen = []

    def capture(src):
        seen.append(src.reshape(-1, 3).contiguous().clone())
        return ref.scene.query(src)

    refine_poses(ref.tris, torch.as_tensor(poses_np, device=dev), ref.scene, ref.proj,
                 ref._K_render_t, width=ref.render_w, height=ref.render_h,
                 max_points=ref.max_points, criteria=ptt.ICPConvergenceCriteria(max_iteration=0),
                 window=ref.window, stride=ref.stride, roi=ref.roi, query=capture)
    q = seen[0]
    sc = SceneNN.from_depth(scene, K, 0.1, voxel_mm=2.0, device=dev)
    table, boxes, balls = sc.flash_table, sc.flash_boxes, sc.flash_balls
    nq, s_pad, n_balls, g2 = q.shape[0], table.shape[1], balls.shape[1], NF.gate_sq(0.1)
    outs = {name: (torch.empty(nq, dtype=torch.int32, device=dev),
                   torch.empty(nq, dtype=torch.float32, device=dev)) for name in ("other", "this")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (q.data_ptr(), nq, table.data_ptr(), s_pad, boxes.data_ptr(), balls.data_ptr(),
            n_balls, g2, 1)

    def launch(name):
        idx, dist = outs[name]
        if name == "other":
            err = other.prt_nn_flash(*head, idx.data_ptr(), dist.data_ptr(), None, stream)
        else:
            err = this.prt_nn_flash(*head, None, 1, 0, idx.data_ptr(), dist.data_ptr(), None,
                                    stream)
        if err:
            raise SystemExit(f"{name}: launch failed, CUDA error {err}")

    def round_ms(name):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(LAUNCHES):
            launch(name)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / LAUNCHES

    for name in ("other", "this"):  # warm
        round_ms(name)
    same = torch.equal(outs["other"][0], outs["this"][0]) and torch.equal(outs["other"][1],
                                                                         outs["this"][1])
    times = {"other": [], "this": []}
    for r in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            times[name].append(round_ms(name))
            print(f"[compare] round {r} {name}: {times[name][-1]} ms", flush=True)
    print(f"[compare] B3 single frame, {nq} queries x {s_pad} columns ({n_balls} balls), "
          f"gate 0.1 m: outputs_equal={same}", flush=True)
    for name, t in times.items():
        print(f"[compare] {name}: median_ms={float(np.median(t))} min_ms={min(t)} "
              f"max_ms={max(t)} rounds={len(t)}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
