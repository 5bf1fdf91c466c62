#!/usr/bin/env python3
"""Stage times and device profile of the port's refine on one CUDA card.

    python3 profile_port.py

Runs chip_smoke.py's cells on its bench workload (256 hypotheses at
640x480, render_scale 2, window 128 / stride 2, 2048 points): the
projective refine, the three NN configurations on the gated flash kernel
(scene="nn_bruteforce") and the kd cells kd-2mm-256 and kd-raw-256
(scene="nn", the kd traversal K1 on the card). For each cell it
prints one line with the host scene build, the refine's wall and
CUDA-event ms (median of 5), the raster, lift (the pipeline's
``_window_lift``: the kernel L1 on the card) and ICP stages each timed
alone by CUDA events (median of 5; a cascade's ICP stage is its
full-resolution pass) with the raster's device kernel count, one
association query, and, from ``torch.profiler``
around one refine, the number of device kernels, their summed time and
its share of the unprofiled wall time (the device busy share); then the
eight kernels with the most device time. A kd cell also prints a
``[passes]`` line: K1's launches in one profiled refine, their sum, its
share of the refine's device kernel time, and each pass's ms.

Then the stacked-scene cells multiscene-proj-4x64 and multiscene-nn-4x64
(chip_smoke.py's [multiscene] workload: 4 frames x 64 hypotheses in one
refine with scene ids) and the multi-model cell multimodel-256 (256
hypotheses of two meshes against the bench scene), with the same line.

Then the tracking cells, one frame of bench.py's tracking workload (16
hypotheses, chip_smoke.TRACK_CONFIGS: projective, and NN with a 2 mm
voxel): the whole track() (with the covariance and the packed session
buffer) as above, and its stages timed alone: the scene build on the card,
raster, lift, ICP (30 iterations, the session's default) and the
information pass (pose_information + pose_covariance).

Then ``[async]`` lines for slice-bench-256 and a tracked projective frame:
how long ``refine_async`` / ``track_async`` take to return, against the
time until the PendingResult's ``wait()`` returns (median of 7, after a
warm call). Imports no JAX.
"""

import os
import sys
import time

import numpy as np

import chip_smoke as CS

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


def print_kernels(torch, cell, fn, wall_ms, line):
    """Profile one fn() call; print ``line`` with the device kernel count,
    their summed time and the busy share, then the eight largest kernels."""
    rows = CS.device_kernels(torch, fn)
    kernel_ms = sum(r[1] for r in rows)
    print(f"[profile] {cell}: {line} device_kernels={sum(r[2] for r in rows)} "
          f"kernel_sum_ms={kernel_ms} busy_share={kernel_ms / wall_ms}", flush=True)
    for name, ms, calls in rows[:8]:
        print(f"[profile]   {ms:.3f} ms {calls:5d}x {name[:90]}", flush=True)


def print_passes(torch, cell, key, fn):
    """The [passes] line of one cell: each launch of the device kernels
    whose name holds ``key`` in one profiled fn() call, in launch order -
    their count, summed ms, share of all the call's device kernel time, and
    each launch's ms."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    every = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    ms = [e.time_range.elapsed_us() / 1e3 for e in evs if key in e.name]
    print(f"[passes] {cell}: {key} launches={len(ms)} sum_ms={sum(ms)} share_of_kernel_sum="
          f"{sum(ms) / every} per_launch_ms={[round(x, 4) for x in ms]}", flush=True)


def print_async(torch, cell, enqueue, reps=7):
    """The [async] line of one cell: host ms until enqueue() (a
    refine_async / track_async call) returns, against ms until its
    PendingResult's wait() returns, median, min and max of ``reps`` after a
    warm call, each from an idle card."""
    enqueue().wait()
    ret, done = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = enqueue()
        t1 = time.perf_counter()
        pending.wait()
        done.append((time.perf_counter() - t0) * 1e3)
        ret.append((t1 - t0) * 1e3)
    med_r, med_d = float(np.median(ret)), float(np.median(done))
    print(f"[async] {cell}: returns after ms median={med_r} min={min(ret)} max={max(ret)}; "
          f"wait() returns after ms median={med_d} min={min(done)} max={max(done)}; "
          f"return / wait={med_r / med_d}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import geometry, icp, mesh
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC
    from pose_refine_tpu_torch.pipeline import _window_lift
    from pose_refine_tpu_torch.scene.nn import SceneNN
    from pose_refine_tpu_torch.scene.projective import SceneProjective

    def lift_fn(ref, scene, depth):
        """The refine's lift of ``depth`` against ``scene``: L1 on the card."""
        return lambda: _window_lift(depth, ref._K_render_t, scene, ref.max_points, ref.window,
                                    ref.stride, ref.roi)

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
    # scene="nn": the kd traversal K1 on the card
    cells += [("kd-2mm-256", dict(scene="nn", scene_voxel_mm=2.0), CS.ITERS),
              ("kd-raw-256", dict(scene="nn"), CS.ITERS)]

    def refine_cell(cell, ref, build_ms, refine, tris, hyps, query, crit, scene_ids=None):
        """One refine cell's lines: wall, device span, stages, profile."""
        refine()  # warm
        wall_ms, span_ms = CS.refine_ms(torch, refine)
        rw, rh = ref.render_w, ref.render_h
        def raster():
            return RC.rasterize(tris, hyps, rw, rh, ref.proj, roi=ref.roi)

        raster_ms, depth = event_ms(torch, raster)
        raster_kernels = sum(calls for _n, _ms, calls in CS.device_kernels(torch, raster))
        lift_ms, (clouds, valids) = event_ms(torch, lift_fn(ref, ref.scene, depth))
        iterate = ref.scene.iterate if scene_ids is None else ref.scene.iterate_at(scene_ids)
        assoc = icp.Association(query, iterate)
        icp_ms, _ = event_ms(torch, lambda: icp._icp_run(clouds, valids, assoc, crit))
        query_ms, _ = event_ms(torch, lambda: query(clouds), reps=10)
        pts = getattr(ref.scene, "points", None)
        size = f"{pts.shape[0]} points" if pts is not None else "projective"
        print_kernels(torch, cell, refine, wall_ms,
                      f"scene {size}, build_ms={build_ms} wall_ms={wall_ms} "
                      f"device_span_ms={span_ms} poses_per_s={hyps.shape[0] / wall_ms * 1e3} "
                      f"raster_ms={raster_ms} raster_kernels={raster_kernels} "
                      f"lift_ms={lift_ms} icp_ms={icp_ms} "
                      f"one_query_ms={query_ms}")

    def built(ref, build):
        """(refiner, host ms of build(refiner), its scene build)."""
        t0 = time.perf_counter()
        build(ref)
        torch.cuda.synchronize()
        return ref, (time.perf_counter() - t0) * 1e3

    for cell, kw, iters in cells:
        ref, build_ms = built(ptt.PoseRefiner(model, K=K, device="cuda", **kw, **CS.CFG),
                              lambda r: r.set_scene_depth(scene))
        crit = ptt.ICPConvergenceCriteria(max_iteration=iters)
        refine_cell(cell, ref, build_ms, lambda: ref.refine(poses, crit), ref.tris, poses,
                    ref.scene.query, crit)
        if cell == "projective":
            print_async(torch, "slice-bench-256", lambda: ref.refine_async(poses, crit))
        if cell.startswith("kd-"):
            print_passes(torch, cell, "nn_kdtree", lambda: ref.refine(poses, crit))

    # the stacked-scene and multi-model cells (chip_smoke.py's [multiscene],
    # [multiscene-nn] and [multimodel])
    crit = ptt.ICPConvergenceCriteria(max_iteration=CS.ITERS)
    ms_mesh, _truths, ms_frames, ms_hyps, ms_ids = CS.multiscene_workload(
        geometry, mesh, lambda tris, p: RC.rasterize(
            torch.as_tensor(tris, device=dev), torch.as_tensor(p, device=dev), CS.WIDTH,
            CS.HEIGHT, proj))
    ms_hyps, ms_ids = torch.as_tensor(ms_hyps, device=dev), torch.as_tensor(ms_ids, device=dev)
    for cell, kw in (("multiscene-proj-4x64", dict()),
                     ("multiscene-nn-4x64", dict(scene="nn_bruteforce", scene_voxel_mm=2.0))):
        ref, build_ms = built(ptt.PoseRefiner(ms_mesh, K=K, device="cuda", **kw, **CS.CFG),
                              lambda r: r.set_scene_depths(ms_frames))
        refine_cell(cell, ref, build_ms, lambda: ref.refine(ms_hyps, crit, scene_ids=ms_ids),
                    ref.tris, ms_hyps, ref.scene.query_at(ms_ids), crit, scene_ids=ms_ids)
    other = mesh.make_bumpy_sphere(radius=60.0, subdivisions=4)
    mm_ids = np.array([0, 1] * (CS.N_POSES // 2), np.int32)
    ref, build_ms = built(ptt.MultiModelRefiner(
        [model, other], K=K, device="cuda", render_scale=2, max_points=2048, window=128,
        stride=2, decimate_mm=2.0), lambda r: r.set_scene_depth(scene))
    mm_tris = ref._per_pose_tris(mm_ids, poses)[0]
    refine_cell("multimodel-256", ref, build_ms, lambda: ref.refine(mm_ids, poses, criteria=crit),
                mm_tris, poses, ref.scene.query, crit)

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
        def raster():
            return RC.rasterize(ref.tris, hyps, ref.render_w, ref.render_h, ref.proj,
                                roi=ref.roi)

        raster_ms, depth = event_ms(torch, raster)
        raster_kernels = sum(calls for _n, _ms, calls in CS.device_kernels(torch, raster))
        lift_ms, (clouds, valids) = event_ms(torch, lift_fn(ref, sc, depth))
        icp_ms, (_res, final) = event_ms(torch, lambda: icp._icp_run(
            clouds, valids, icp.Association(sc.query, sc.iterate), crit))

        def information():
            info, sigma2, _count = icp.pose_information(final, valids, sc.query)
            return icp.pose_covariance(info, sigma2)

        info_ms, _ = event_ms(torch, information)
        print_kernels(torch, cell, track, wall_ms,
                      f"scene {size}, {CS.N_HYP} hypotheses, roi={ref.roi}: "
                      f"wall_ms={wall_ms} device_span_ms={span_ms} scene_build_ms={build_ms} "
                      f"raster_ms={raster_ms} raster_kernels={raster_kernels} lift_ms={lift_ms} "
                      f"icp_ms={icp_ms} information_ms={info_ms}")

        if not nn:
            print_async(torch, cell, lambda: ref.track_async(frame, hyps, crit,
                                                             with_covariance=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
