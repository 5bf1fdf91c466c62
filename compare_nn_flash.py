#!/usr/bin/env python3
"""Time another revision's csrc/nn_flash.cu against this checkout's, on one
CUDA card, at a main path's shape.

    python3 compare_nn_flash.py OTHER/nn_flash.cu [--shape 2mm|raw|track]
                                [--kernel gated|packed|stacked] [--rounds N]

OTHER's source has this checkout's C interface, prt_nn_flash(queries, nq,
table, s_pad, boxes, balls, n_balls, gate2, prune, frame_id, frames,
per_pose, idx, dist, scanned, stream). It is built alone with this
checkout's nvcc flags into its own library under the git-ignored
``_build/``; this checkout's kernels load as usual. The inputs are
chip_smoke.py's:

  --shape 2mm | raw   the 524,288 first-pass queries of the bench NN refine
                      against the 2 mm voxel scene (3,809 points) or the raw
                      cloud (29,440), gate 0.1 m ([nn-kernel]);
  --shape track       the 32,768 first-pass queries of the tracking
                      workload's first frame against the scene built from
                      that frame on the card ([track]);
  --kernel stacked    the gated kernel over the 4-frame 2 mm stack of
                      [multiscene-nn] with one frame id per pose (--shape
                      is not read);
  --kernel packed     the full scan instead of the gated kernel.

Rounds alternate other, this, this, other; a round is the CUDA-event time of
20 back-to-back launches over 20. Prints every round, then each build's
median, min and max per launch, and checks that both builds return the same
idx and dist^2.
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
    for line in (run.stdout + run.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[compare] other build: {line.strip()}", flush=True)
    other = ctypes.CDLL(str(lib))
    other.prt_nn_flash.argtypes, other.prt_nn_flash.restype = _build.SIGNATURES["prt_nn_flash"]
    return other


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other revision's nn_flash.cu")
    ap.add_argument("--shape", choices=("2mm", "raw", "track"), default="2mm")
    ap.add_argument("--kernel", choices=("gated", "packed", "stacked"), default="gated")
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

    model, tris_np, truth, poses_np = CS.workload(geometry, mesh)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, CS.WIDTH, CS.HEIGHT, device=dev)
    def render(t, p):
        return RC.rasterize(torch.as_tensor(t, device=dev), torch.as_tensor(p, device=dev),
                            CS.WIDTH, CS.HEIGHT, proj)

    fid, frames, per_pose = None, 1, 0
    if args.kernel == "stacked":
        # chip_smoke.py's [multiscene-nn] stack and first-pass queries
        ms_mesh, _truths, ms_frames, ms_hyps, ms_ids = CS.multiscene_workload(geometry, mesh, render)
        ref = ptt.PoseRefiner(ms_mesh, K=K, device="cuda", scene="nn_bruteforce",
                              scene_voxel_mm=2.0, **CS.CFG)
        ref.set_scene_depths(ms_frames)
        sc, ids = ref.scene, torch.as_tensor(ms_ids, device=dev)
        seen, q_at = [], ref.scene.query_at(ids)

        def capture(src):
            seen.append(src.clone())
            return q_at(src)

        refine_poses(ref.tris, torch.as_tensor(ms_hyps, device=dev), sc, ref.proj,
                     ref._K_render_t, width=ref.render_w, height=ref.render_h,
                     max_points=ref.max_points,
                     criteria=ptt.ICPConvergenceCriteria(max_iteration=0), window=ref.window,
                     stride=ref.stride, roi=ref.roi, scene_ids=ids, query=capture)
        q = seen[0].reshape(-1, 3).contiguous()
        fid, frames, per_pose = ids.to(torch.int32).contiguous(), sc.n_scenes, seen[0].shape[1]
        what = f"stacked B3, {frames} frames x {sc.frame_rows} rows"
    elif args.shape == "track":
        # chip_smoke.py's [track] NN workload: its first frame and hypotheses
        ref = ptt.PoseRefiner(model, K=K, device="cuda", **dict(CS.TRACK_CONFIGS)["nn"], **CS.CFG)
        _truths, track = CS.track_frames(geometry, lambda p: render(tris_np, p), truth)
        hyps = CS.first_hypotheses(ptt, truth)
        ref.track(track[0], hyps)  # plans the ROI and resolves the scene's pool
        pool = ref._scene_pool_cache
        sc = SceneNN.from_depth_device(
            torch.as_tensor(track[0], device=dev), ref._K_t, ref.max_dist_diff,
            perm=ref._scene_perm(track[0].shape, pool), pool=pool)
        q = CS.first_pass_clouds(ptt, refine_poses, ref, sc,
                                 torch.as_tensor(hyps, device=dev))[0].reshape(-1, 3)
        what = f"tracking shape (device-built scene, pool {pool})"
    else:
        # chip_smoke.py's [nn-kernel] input
        scene = render(tris_np, truth[None])[0].cpu().numpy()
        ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn_bruteforce",
                              scene_voxel_mm=2.0, **CS.CFG)
        ref.set_scene_depth(scene)
        q = CS.first_pass_clouds(ptt, refine_poses, ref, ref.scene,
                                 torch.as_tensor(poses_np, device=dev))[0].reshape(-1, 3)
        sc = SceneNN.from_depth(scene, K, 0.1, voxel_mm=2.0 if args.shape == "2mm" else 0.0,
                                device=dev)
        what = f"{args.shape} scene"
    table, boxes, balls = sc.flash_table, sc.flash_boxes, sc.flash_balls
    prune = args.kernel != "packed"
    nq, s_pad, n_balls = q.shape[0], table.shape[1], balls.shape[1]
    outs = {name: (torch.empty(nq, dtype=torch.int32, device=dev),
                   torch.empty(nq, dtype=torch.float32, device=dev)) for name in ("other", "this")}
    n_tiles = -(-nq // NF.Q_TILE) if fid is None else fid.shape[0] * -(-per_pose // NF.Q_TILE)
    scanned = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (q.data_ptr(), nq, table.data_ptr(), s_pad, boxes.data_ptr(), balls.data_ptr(),
            n_balls, NF.gate_sq(sc.max_dist_diff), int(prune),
            None if fid is None else fid.data_ptr(), frames, per_pose)
    libs = {"other": other, "this": this}

    def launch(name, count=None):
        idx, dist = outs[name]
        err = libs[name].prt_nn_flash(*head, idx.data_ptr(), dist.data_ptr(),
                                      None if count is None else count.data_ptr(), stream)
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
    skipped = "all chunks scanned"
    if prune:
        launch("this", scanned)
        torch.cuda.synchronize()
        share = 1.0 - float(scanned.sum()) / (n_tiles * (s_pad // NF.S_CHUNK // frames))
        skipped = f"chunks_skipped={share}"
    times = {"other": [], "this": []}
    for r in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            times[name].append(round_ms(name))
            print(f"[compare] round {r} {name}: {times[name][-1]} ms", flush=True)
    print(f"[compare] kernel={args.kernel} {what}: {nq} queries x {s_pad} columns "
          f"({n_balls} balls), gate {sc.max_dist_diff} m, {skipped}: outputs_equal={same}",
          flush=True)
    for name, t in times.items():
        print(f"[compare] {name}: median_ms={float(np.median(t))} min_ms={min(t)} "
              f"max_ms={max(t)} rounds={len(t)}", flush=True)
    med = {name: float(np.median(t)) for name, t in times.items()}
    print(f"[compare] this / other = {med['this'] / med['other']}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
