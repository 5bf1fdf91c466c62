#!/usr/bin/env python3
"""Time the refine cells of another checkout of the port against this
checkout's, on one CUDA card: what a change of the main path's launches
(such as the window lift kernel L1) does end to end.

    git archive <rev> | tar -x -C _local/parent_tree
    python3 compare_lift.py _local/parent_tree [--rounds N] [--reps N]

Each round runs one child process a checkout, in turns (rounds=2: other,
this, this, other). A child imports the package of its checkout, builds its
kernels, builds the workloads with this checkout's chip_smoke.py helpers
(the same seeds for both), and prints one JSON line a cell: wall ms (median,
min and max of --reps calls after a warm one), CUDA-event ms, and from
torch.profiler around one call the device kernels, their summed ms and the
busy share (that sum over the median wall; of three profiled calls, taken
before the timed ones, the one that recorded the most kernels and holds
B1's and L1's kernels to their launch counters, chip_smoke.checked_kernels).
Cells: slice-bench-256,
kd-2mm-256, multiscene-proj-4x64, multimodel-256, track-proj-16 (one tracked
frame with the covariance and the packed session buffer) and
coarse-serving-512x4 (4 x refine_async(512) then fence; ms a batch). Then
each cell's median over the rounds for each checkout, and this / other.
Imports no JAX.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever checkout is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: str, reps: int) -> int:
    """The child: every cell against the package of ``tree``."""
    import torch

    if not torch.cuda.is_available():
        print("compare_lift: needs a CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import geometry, mesh
    from pose_refine_tpu_torch.ops import lift_cuda as LC
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC

    if not os.path.abspath(ptt.__file__).startswith(tree + os.sep):
        raise SystemExit(f"pose_refine_tpu_torch imported from {ptt.__file__}, not {tree}")
    CS = _chip_smoke()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model, tris_np, truth, poses_np = CS.workload(geometry, mesh)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, CS.WIDTH, CS.HEIGHT, device=dev)

    def raster(tris, p):
        return RC.rasterize(torch.as_tensor(tris, device=dev), torch.as_tensor(p, device=dev),
                            CS.WIDTH, CS.HEIGHT, proj)

    scene = raster(tris_np, truth[None])[0].cpu().numpy()
    poses = torch.as_tensor(poses_np, device=dev)
    crit = ptt.ICPConvergenceCriteria(max_iteration=CS.ITERS)
    cells = {}

    ref = ptt.PoseRefiner(model, K=K, device="cuda", **CS.CFG)
    ref.set_scene_depth(scene)
    cells["slice-bench-256"] = (lambda: ref.refine(poses, crit), 1)
    kd = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn", scene_voxel_mm=2.0, **CS.CFG)
    kd.set_scene_depth(scene)
    cells["kd-2mm-256"] = (lambda: kd.refine(poses, crit), 1)
    ms_mesh, _truths, ms_frames, ms_hyps, ms_ids = CS.multiscene_workload(geometry, mesh, raster)
    ms = ptt.PoseRefiner(ms_mesh, K=K, device="cuda", **CS.CFG)
    ms.set_scene_depths(ms_frames)
    ms_hyps, ms_ids = torch.as_tensor(ms_hyps, device=dev), torch.as_tensor(ms_ids, device=dev)
    cells["multiscene-proj-4x64"] = (lambda: ms.refine(ms_hyps, crit, scene_ids=ms_ids), 1)
    mm = ptt.MultiModelRefiner([model, mesh.make_bumpy_sphere(radius=60.0, subdivisions=4)],
                               K=K, device="cuda", render_scale=2, max_points=2048, window=128,
                               stride=2, decimate_mm=2.0)
    mm.set_scene_depth(scene)
    mm_ids = np.array([0, 1] * (CS.N_POSES // 2), np.int32)
    cells["multimodel-256"] = (lambda: mm.refine(mm_ids, poses, criteria=crit), 1)
    _truths, frames = CS.track_frames(geometry, lambda p: raster(tris_np, p), truth)
    hyps = torch.as_tensor(CS.first_hypotheses(ptt, truth), device=dev)
    tr = ptt.PoseRefiner(model, K=K, device="cuda", **CS.CFG)
    crit_t = ptt.ICPConvergenceCriteria()  # the session's criteria
    cells[f"track-proj-{CS.N_HYP}"] = (lambda: tr.track(frames[0], hyps, crit_t,
                                                        with_covariance=True,
                                                        _pack_outputs=True), 1)
    serving = ptt.PoseRefiner(model, K=K, device="cuda", coarse_iters=CS.COARSE[0],
                              coarse_stride=CS.COARSE[1], **CS.CFG)
    serving.set_scene_depth(scene)
    poses512 = torch.as_tensor(np.concatenate([poses_np, poses_np]), device=dev)
    cells["coarse-serving-512x4"] = (
        lambda: ptt.fence(*[serving.refine_async(poses512, crit) for _ in range(4)]), 4)
    setup_s = time.perf_counter() - t0

    # every cell's device kernels first, while the process's profiler still
    # records every launch (ROADMAP C7), held to the B1 / L1 launch counters
    # (checked_kernels warms each cell first: builds, the ROI, the tracked
    # scene's pool)
    profiled = {cell: CS.checked_kernels(torch, fn, RC, LC) for cell, (fn, _per) in cells.items()}
    for cell, (fn, per) in cells.items():
        rows = profiled[cell]
        walls, dev_ms = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3 / per)
            dev_ms.append(a.elapsed_time(b) / per)
        wall = float(np.median(walls))
        kernel_ms = sum(r[1] for r in rows) / per
        print(json.dumps(dict(
            tree=tree, cell=cell, wall_ms=wall, wall_min=min(walls), wall_max=max(walls),
            event_ms=float(np.median(dev_ms)), device_kernels=sum(r[2] for r in rows) / per,
            kernel_sum_ms=kernel_ms, busy_share=kernel_ms / wall,
            top=[(n[:40], round(t, 4), c) for n, t, c in rows[:4]], setup_s=setup_s,
            device=torch.cuda.get_device_name(0))), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="another checkout of the repository (a directory)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        return measure(args.other, args.reps)
    other = os.path.abspath(args.other)
    if not os.path.isdir(os.path.join(other, "pose_refine_tpu_torch")):
        raise SystemExit(f"{other} holds no pose_refine_tpu_torch package")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    seen = {}
    for r in range(args.rounds):
        for tree in ((other, REPO) if r % 2 == 0 else (REPO, other)):
            done = subprocess.run([sys.executable, os.path.abspath(__file__), tree, "--measure",
                                   "--reps", str(args.reps)],
                                  cwd=REPO, capture_output=True, text=True)
            if done.returncode != 0:
                print(done.stdout + done.stderr[-4000:])
                raise SystemExit(f"the child for {tree} failed (exit {done.returncode})")
            for line in done.stdout.splitlines():
                if line.startswith("{"):
                    row = json.loads(line)
                    name = "this" if tree == REPO else "other"
                    print(f"[round {r}] {name} {line}", flush=True)
                    seen.setdefault(row["cell"], {}).setdefault(name, []).append(row)
    for cell, by in seen.items():
        med = {name: {k: float(np.median([row[k] for row in rows]))
                      for k in ("wall_ms", "event_ms", "device_kernels", "kernel_sum_ms",
                                "busy_share")}
               for name, rows in by.items()}
        ratio = med["this"]["wall_ms"] / med["other"]["wall_ms"]
        print(f"[summary] {cell}: other {med['other']} | this {med['this']} | "
              f"this / other wall={ratio}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
