#!/usr/bin/env python3
"""Stage times and device profile of the port's refine on one CUDA card.

    python3 profile_port.py

Runs chip_smoke.py's cells on its bench workload (256 hypotheses at
640x480, render_scale 2, window 128 / stride 2, 2048 points): the
projective refine and the three NN configurations. For each cell it
prints one line with the host scene build, the refine's wall and
CUDA-event ms (median of 5), the raster, lift and ICP stages each timed
alone by CUDA events (median of 5; a cascade's ICP stage is its
full-resolution pass), one association pass, and, from ``torch.profiler``
around one refine, the number of device kernels, their summed time and
its share of the unprofiled wall time (the device busy share); then the
eight kernels with the most device time.

Then the tracking cells, one frame of bench.py's tracking workload (16
hypotheses, chip_smoke.TRACK_CONFIGS: projective, and NN with a 2 mm
voxel): the whole track() (with the covariance and the packed session
buffer) as above, and its stages timed alone: the scene build on the card,
raster, lift, ICP (30 iterations, the session's default) and the
information pass (pose_information + pose_covariance). Imports no JAX.
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def event_ms(torch, fn, reps=5):
    """Median CUDA-event ms of fn() after one warm call, and its output."""
    out = fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts)), out


def device_kernels(torch, fn):
    """[(name, device ms, calls)] of the device kernels of one fn() call,
    most time first, from torch.profiler."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        d = getattr(e, "self_device_time_total", None)
        if d is None:
            d = getattr(e, "self_cuda_time_total", 0)
        if d > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, d / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def print_kernels(torch, cell, fn, wall_ms, line):
    """Profile one fn() call; print ``line`` with the device kernel count,
    their summed time and the busy share, then the eight largest kernels."""
    rows = device_kernels(torch, fn)
    kernel_ms = sum(r[1] for r in rows)
    print(f"[profile] {cell}: {line} device_kernels={sum(r[2] for r in rows)} "
          f"kernel_sum_ms={kernel_ms} busy_share={kernel_ms / wall_ms}", flush=True)
    for name, ms, calls in rows[:8]:
        print(f"[profile]   {ms:.3f} ms {calls:5d}x {name[:90]}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import geometry, icp, mesh
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC
    from pose_refine_tpu_torch.ops.depth_to_cloud import compact_topk, window_cloud_batched
    from pose_refine_tpu_torch.scene.nn import SceneNN
    from pose_refine_tpu_torch.scene.projective import SceneProjective

    def lift_fn(ref, depth, nn: bool):
        win, stride = ref.window, ref.stride
        wh = -(-min(win, depth.shape[1]) // stride)
        ww = -(-min(win, depth.shape[2]) // stride)

        def lift():
            c, v, _ = window_cloud_batched(depth, ref._K_render_t, window=win, stride=stride,
                                           tl_x=ref.roi[0], tl_y=ref.roi[1])
            return compact_topk(c, v, ref.max_points, order_shape=(wh, ww) if nn else None)
        return lift

    dev = torch.device("cuda")
    model, tris_np, truth, poses_np = CS.workload(geometry, mesh)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, CS.WIDTH, CS.HEIGHT, device=dev)
    scene = RC.rasterize(torch.as_tensor(tris_np, device=dev),
                         torch.as_tensor(truth[None], device=dev),
                         CS.WIDTH, CS.HEIGHT, proj)[0].cpu().numpy()
    poses = torch.as_tensor(poses_np, device=dev)
    cells = [("projective", dict(), CS.ITERS)]
    cells += [(f"nn-{label}", dict(scene="nn_bruteforce", **kw), iters)
              for label, kw, iters in CS.NN_CONFIGS]

    for cell, kw, iters in cells:
        ref = ptt.PoseRefiner(model, K=K, device="cuda", **kw, **CS.CFG)
        t0 = time.perf_counter()
        ref.set_scene_depth(scene)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        crit = ptt.ICPConvergenceCriteria(max_iteration=iters)
        ref.refine(poses, crit)  # warm
        wall_ms, span_ms = CS.refine_ms(torch, lambda: ref.refine(poses, crit))

        rw, rh = ref.render_w, ref.render_h
        raster_ms, depth = event_ms(
            torch, lambda: RC.rasterize(ref.tris, poses, rw, rh, ref.proj, roi=ref.roi))
        lift_ms, (clouds, valids, _) = event_ms(torch, lift_fn(ref, depth, cell != "projective"))
        icp_ms, _ = event_ms(torch, lambda: icp._icp_run(clouds, valids, ref.scene.query, crit))
        query_ms, _ = event_ms(torch, lambda: ref.scene.query(clouds), reps=10)
        pts = getattr(ref.scene, "points", None)
        size = f"{pts.shape[0]} points" if pts is not None else "projective"
        print_kernels(torch, cell, lambda: ref.refine(poses, crit), wall_ms,
                      f"scene {size}, build_ms={build_ms} wall_ms={wall_ms} "
                      f"device_span_ms={span_ms} poses_per_s={CS.N_POSES / wall_ms * 1e3} "
                      f"raster_ms={raster_ms} lift_ms={lift_ms} icp_ms={icp_ms} "
                      f"one_query_ms={query_ms}")

    # the tracking cells: one frame of bench.py's tracking workload
    _truths, frames = CS.track_frames(
        geometry, lambda p: RC.rasterize(torch.as_tensor(tris_np, device=dev),
                                         torch.as_tensor(p, device=dev), CS.WIDTH, CS.HEIGHT,
                                         proj), truth)
    frame = frames[0]
    frame_t = torch.as_tensor(frame, device=dev)
    hyps = torch.as_tensor(CS.first_hypotheses(ptt, truth), device=dev)
    crit = ptt.ICPConvergenceCriteria()  # the session's criteria
    for label, kw in CS.TRACK_CONFIGS:
        cell = f"track-{label[:4]}-{CS.N_HYP}"
        ref = ptt.PoseRefiner(model, K=K, device="cuda", **kw, **CS.CFG)

        def track():
            return ref.track(frame, hyps, crit, with_covariance=True, _pack_outputs=True)

        track()  # warm: plans the ROI and resolves the NN scene's pool
        wall_ms, span_ms = CS.refine_ms(torch, track)
        nn = label != "projective"
        if nn:
            pool = ref._scene_pool_cache
            perm = ref._scene_perm(frame.shape, pool)
            build_ms, sc = event_ms(torch, lambda: SceneNN.from_depth_device(
                frame_t, ref._K_t, ref.max_dist_diff, perm=perm, pool=pool))
            size = f"{sc.points.shape[0]} points (pool {pool})"
        else:
            build_ms, sc = event_ms(torch, lambda: SceneProjective.from_depth(
                frame_t, ref._K_t, ref.max_dist_diff, device=dev))
            size = "projective"
        raster_ms, depth = event_ms(torch, lambda: RC.rasterize(
            ref.tris, hyps, ref.render_w, ref.render_h, ref.proj, roi=ref.roi))
        lift_ms, (clouds, valids, _) = event_ms(torch, lift_fn(ref, depth, nn))
        icp_ms, (_res, final) = event_ms(torch, lambda: icp._icp_run(clouds, valids, sc.query,
                                                                     crit))

        def information():
            info, sigma2, _count = icp.pose_information(final, valids, sc.query)
            return icp.pose_covariance(info, sigma2)

        info_ms, _ = event_ms(torch, information)
        print_kernels(torch, cell, track, wall_ms,
                      f"scene {size}, {CS.N_HYP} hypotheses, roi={ref.roi}: "
                      f"wall_ms={wall_ms} device_span_ms={span_ms} scene_build_ms={build_ms} "
                      f"raster_ms={raster_ms} lift_ms={lift_ms} icp_ms={icp_ms} "
                      f"information_ms={info_ms}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
