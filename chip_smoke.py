#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (pose_refine_tpu_torch) once on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases, one line each; any failure exits
non-zero without printing a result:

  1. card   - torch.cuda.is_available(), and nvidia-smi's name and power limit
  2. build  - nvcc builds csrc/*.cu for sm_90a from the checkout (timed)
  2b. census - the device kernels of the later phases' profiled calls
              ([sharded], [coarse], [schedule], [compact], [renderer];
              late_cells), profiled in a fresh child process
              (``chip_smoke.py --census``): after tens of seconds of
              launches a process's torch.profiler stops recording the
              kernels launched with <<<>>> (B1, L1). Every profiled call,
              here and in the in-process census of [slice], [lift] and
              [track] taken before [kernel], holds its B1 (bin_kernel,
              raster_kernel) and L1 (window_lift_kernel) rows to the
              wrappers' launch counters for that call (checked_kernels).
  3. kernel - the raster kernel against its plain PyTorch version on the card
              at every shape of raster_shapes(): the observed-scene render
              (1 pose, 640x480), the 256 hypothesis renders (the decimated
              mesh in the auto ROI), the same batch as a per-pose (N, T, 3,
              3) table, bench.py:181-183's render benchmark (100 and 256
              poses at 640x480, 100 in a 320x240 ROI, the full mesh) and,
              after phase 13, multimodel-256's indexed table. Mismatch
              fraction must stay below 1e-4 (measured 0); one render counted
              and at most 2 device kernels a render. Times: alone, with the
              wrapper, the plain version, the old path's setup alone and,
              when the parent's source sits at compare_raster.PARENT, the
              whole old path alone (its output must equal the kernel's);
              the bound and the share of it.
  4. slice  - PoseRefiner.set_scene_depth + refine on the bench workload
              (256 hypotheses +-10 deg/axis +-20 mm around the reference
              viewpoint, render_scale 2, decimate 4 mm, window 128 / stride 2,
              2048 points, 24 ICP iterations) through the kernels; the raster
              counter must rise and the ICP loop be one launch of the
              iteration kernel. Wall and device time, poses/s. The same
              refine through the plain raster must agree; so must the one
              through the plain query and the iteration kernel's plain
              version (hold_paths). The line prints the device kernels of one
              refine (torch.profiler); the lift must be one L1 launch.
  4b. lift  - the window lift L1 (csrc/lift.cu) against its plain version
              (ops.depth_to_cloud.window_lift) on the card, projective and
              Morton order: the slice's renders (the bench shape), the bench
              hypotheses at 640x480 under a full-resolution render's auto
              window (480 / stride 2: P = 57,600, 8,192 points) and
              probes/lift_cases.py's renders (empty, border-clipped, holes,
              ROI offsets) at each of its shapes; clouds bit for bit, valid
              equal, one launch a call. Times alone, with the wrapper and
              plain at the first two, the bound; pipeline._window_lift of
              the bench renders must be one device kernel.
  4c. scene-table - the projective scene table's kernel
              (csrc/scene_table.cu) against its plain version
              (scene/projective.py::_build_projective_table_plain) on the
              card: probes/scene_table_cases.py's frames (holes, steps of
              exactly +-49 / +-50 mm, depths at and over 2,000 mm, the
              interior's edges, random depths) at each of its shapes and
              their stacks, bit for bit, one launch a call; at a rendered
              640x480 frame and a stack of 4 the kernel alone, with its
              wrapper, the plain version, the bound and its share, and the
              host's whole build from a numpy frame (upload, allocation,
              launch) against the same build through the plain version,
              with the device kernels of each; the launch counter across
              set_scene_depth, set_scene_depths, a tracked frame and two
              session steps (1, 1, 1, 2). ``chip_smoke.py --scene-table``
              runs [card], [build] and this phase alone.
  5. golden - the reference acceptance recipe (10 deg/axis + 20 mm) on a
              bumpy sphere at 640x480 recovers to under 1 degree, and agrees
              with the same refine through the plain versions.
  6. nn-kernel - the flash-NN kernels nn_flash_packed (full scan) and
              nn_flash_gated (chunk pruning) against their plain PyTorch
              versions on the card, on the 524,288 lifted, morton-ordered
              hypothesis points of one NN refine's first pass, against the
              raw scene cloud and its 2 mm voxel twin, at gates 0.1 m and
              5 mm: idx and dist^2 bit for bit (every query for the full
              scan, the in-gate ones for the gated kernel), validity
              everywhere, gated == full scan in the gate; queries whose
              rounded dist^2 lies within float32 rounding of the gate are
              counted apart (see gate_band). Median times of
              kernel and plain, and the share of chunks the gated kernel
              skipped. Then the tie-stress inputs of probes/nn_ties.py
              (equal scores across the scan's group, warp-part and chunk
              boundaries, scores of +-0, pad columns, partial tiles) through
              nn_flash_packed, nn_flash_gated and the stacked nn_flash_gated:
              bit for bit.
  6b. kd-kernel - the kd traversal kernel K1 (csrc/nn_kdtree.cu) against its
              plain version at its four shapes (kd_shapes_at: the 524,288
              queries of the NN refine's first pass and of a late pass, at
              the poses a scene="nn" refine returns, against the 2 mm and raw
              bench clouds): idx, dist^2 and steps bit for bit; against B2:
              every neighbour at the same distance, other indices at equal
              distances counted as ties; on the raw first pass's queries
              also the two trees that straddle the kernel's shared-memory
              cap (the largest prefix of the raw cloud staged whole, one
              point more walked through L1); edge queries (NaN,
              overflowing, far, scene points) and a single-leaf tree. Times
              with the wrapper, alone (the refine's launcher), the plain
              version, B2 and B3 at the same shape, and the parent's kernel alone
              when its source sits at compare_kdtree.PARENT (its outputs
              must be equal); step, leaf-point, far-child-test and box-read
              counts, the walk's warp efficiency, the bound from the counts.
  7. nn-slice - PoseRefiner(scene="nn_bruteforce") on the bench workload in
              bench.py's three NN configurations (2 mm voxel scene, raw
              cloud, cascade (2.0, 16) + 4 full-resolution iterations); the
              gated kernel's launch counter must rise, the poses stay
              finite, mean fitness > 0.9, median translation error < 0.25 x
              the start. Wall and device time, poses/s, scene points. The
              2 mm refine through the plain NN must agree with the kernel
              path, and the same refine against a full-scan scene
              (SceneNN backend "flash") drives nn_flash_packed.
  8. nn-golden - the golden recipe of phase 5 with scene="nn_bruteforce":
              fitness > 0.7; prints the rotation error.
  8b. kd-slice - PoseRefiner(scene="nn") on the bench workload (2 mm and raw
              clouds), the NN main path on the card: K1 and the iteration
              kernel once a pass (nn_kdtree = icp_iterate = 25, no gated
              launch), [nn-slice]'s accuracy bar, hold_paths against the
              plain path; against [nn-slice]'s B3 refines printed (ties may
              differ). Wall and device ms.
  8c. p2p   - estimation="point_to_point", robust_delta=0.005 with each
              estimation, on the 2 mm NN slice: [nn-slice]'s accuracy bar,
              hold_paths against the plain path; the golden recipe point to
              point (120 iterations): fitness > 0.7, the plain path agrees.
  8d. bracket - tests/test_second_mesh.py's recipe (10 deg/axis + 20 mm,
              160x120, auto lift sizes) on the asymmetric thin L-bracket
              (tests/data/bracket.ply): projective point to plane, held to
              the test's bar (< 4 deg, < 6 mm, fitness > 0.7); scene="nn"
              (K1) point to plane and point to point, printed against the
              bar; every refine held to its plain path.
  9. gather - the association's row-gather kernel against its plain
              version at three shapes: the bench projective scene (307,200
              rows) at the 524,288 first-pass pixels, the raw NN scene
              (29,440 rows) and the device-built 640x480 NN scene (307,200
              rows) at the 524,288 first-pass neighbours; after phase 10 at
              the shape the main path launches it, a tracked frame's
              information pass (projective and NN). Bit for bit; times
              alone and median times of kernel, plain version and
              index_select.
 10. track  - bench.py's tracking workload (bench.py:258-304): 12
              pre-rendered frames drifting +-0.035 rad / +-5 mm per frame,
              TrackingSession(n_hypotheses=16, process_noise=(2 deg, 5 mm))
              with step_async + flush (median of 3 sessions after a warm
              one) and with step, for scene="projective" and for
              scene="nn_bruteforce" with scene_voxel_mm=2 (auto scene_pool).
              Launch counts of every kernel in one session, the synchronizing
              CUDA calls of one steady-state step_async, n_rejected, final
              errors; the first frame through the kernels must agree with
              the same frame through the plain versions (raster, NN, gather).
              For the NN scene, nn_flash_gated alone at the tracking shape
              (the first frame's first-pass queries against its device-built
              scene): against its plain version, time, chunks skipped, bound.
 11. track-golden - tests/test_tracking.py's drift recipe on the bumpy
              sphere at 640x480, 5 frames, both scene kinds: every frame
              accepted, final rotation error < 1 deg, translation < 6 mm.
 12. multiscene - scripts/verify_multiscene.py --full's 4 frames (bumpy
              sphere, truths +-0.4 rad / +-20 mm around z = 400 mm) stacked
              by set_scene_depths, 64 hypotheses per frame (+-0.12 rad /
              +-10 mm), one refine with scene ids on the card, bench
              refiner: the script's bar (< 4 deg, < 4 mm, fitness > 0.5),
              the plain path and per-frame refines within the slice bounds.
     multiscene-nn - the same with scene="nn_bruteforce", scene_voxel_mm=2:
              stacked B3 against its plain version and against single-frame
              B3 on each frame's columns at the refine's first-pass queries.
 13. multimodel - scripts/demo_multi.py's two models (the benchmark model
              and a bumpy sphere (60, 4)), 256 hypotheses [0, 1] * 128
              against the bench scene: rank-1 is model 0 within 2 mm; the
              plain path agrees.
 14. multi-track - tests/test_tracking.py's two objects at 640x480 in 12
              composite frames, MultiObjectSession with 16 hypotheses each
              and a start prior of one frame's motion: every step accepted
              and within 6 mm at every frame, through step_async and through
              step(), ms per frame, 0 synchronizing calls in a steady-state
              step_async; the first frame's track through the plain versions
              agrees. Printed, not held: the same sessions under the
              filter's default 5 deg / 20 mm prior over 8 seeds.

A kernel path is held against a plain path (the plain version of every
kernel, the ICP iteration's among them) by hold_paths(): 100% verdict
agreement and every pose within 0.1 deg, 0.2 mm and 5e-3 of fitness. Misses
are collected and fail the run at its end.
 15. icp-iterate - the ICP iteration kernel (ops/icp_reduce.py,
              icp_iterate_*) against its plain version (icp_iterate_plain
              over the front end's plain query): the whole projective loop
              at the slice shape (24 iterations) in every mode, at the
              serving ceiling's fine shape (512 x 2,048: 128-thread CTAs),
              at the tracking shape (16 x 2,048, 8-CTA clusters, 30
              iterations) and on the stacked table; one indexed iteration on B3's output (2
              mm, every mode) and on K1's (2 mm, raw) at 256 x 2,048; an NN
              loop of 4 iterations through B3 and through K1 against the
              plain NN (64 poses). T, fitness, rmse, done and the cloud bit
              for bit, two runs bit for bit, one launch a loop. First a
              line holding the tail's sinf / cosf equal to torch.sin /
              torch.cos at the slice's solve angles and over [-40, 40].
              Times alone and with the wrapper (an indexed iteration also
              with its checks, and beside it the scoring-only last
              iteration alone on the same inputs), the plain version's, the
              bound: the bytes once a launch, the operations of this run's
              pose-iterations; the
              kernel's registers, local bytes, threads, CTAs an SM and waves
              and its tail alone at the case's poses (probes/icp_tail.py,
              built beside the phases; [coarse] prints the same).
              [build] prints ptxas's registers of each instantiation.
 16. mxu    - P1 on its probe (probes/mxu_nn.py, scripts/probe_mxu_nn.py's
              262,144 queries x 29,440 points): idx and dist^2 equal to B2's
              kernel and to P1's plain version bit for bit, also on the tie
              lattice (probes/mxu_nn.tie_lattice: 16^3 integer points, 30,000
              queries with 2, 4 or 8 points at one distance). Times with the
              wrapper, P1 and B2 alone in turns, the prologue alone, the
              bound; eps_q's constant, the re-scored pairs a query (mean,
              max) and the largest |screen - B2 score| / eps_q seen.
 17. coarse - bench.py:305-327's serving ceiling: the bench refiner with
              coarse_iters=16, coarse_stride=4, 4 x refine_async of bench.py's
              512 hypotheses (its 256 twice) then fence, median of 7 after a
              warm round (wall and CUDA-event ms a batch, poses/s, busy
              share), in turns with the same rounds without the schedule
              ([slice]'s refiner); 2 iteration-kernel launches a refine (the
              coarse phase with the hand-off, then the rest); verdict flips
              against the batch without the schedule (printed); the refine
              held to its plain path. The coarse launch alone against icp_coarse_plain +
              handoff_plain, bit for bit, at 512 x 2,048 (coarse rows 512)
              and one coarse iteration on K1's output (kd-2mm): times alone,
              with the wrapper, plain, bound. A scene="nn" coarse refine (K1
              on the strided copy): 25 K1 and 25 iteration launches, held to
              its plain path.
 18. schedule - tests/test_pipeline.py:104-126's levels [(0.4, 15), (0.1,
              20), (0.03, 15)] from its 25 deg / 40 mm start (row 0) and the
              bench hypotheses, projective and scene="nn" (2 mm): each
              level's gate (float32) and launches recorded, held to the
              plain path (each level through the plain versions against the
              same gated scene).
 19. compact - the slice-bench-256 refine with lift="compact" at
              render_scale 1, 32,768 points: wall and device ms;
              compact_points on the card == on the CPU bit for bit.
 20. renderer - PoseRenderer.render_depth_mask at bench.py:181-183's
              render-256 and render-100-roi, full size and down_sample 2,
              against rasterize_plain + the converters (< 1e-4 of pixels):
              renders/s, wall and device ms, one launch a call.
 21. native - the native C++ kd builder (native/, built with g++ at first
              use) must be available; it and the numpy builder build the
              trees of slice-bench-256's 2 mm, raw and full-frame 640x480
              clouds (the scene in front of a wall) with equal bits, both
              times printed with the host CPU; set_scene_depth of
              scene="nn" on the raw cloud with each builder, and the refines
              on the two trees equal bit for bit (25 K1 launches); the
              reference-algorithm verdict agreement (bench.py:379-440:
              native/cpu_baseline.cpp's render + ICP) on slice-bench-256's
              first 16 hypotheses and on 64 of the bumpy sphere (50, 5) at
              +-10 deg / +-20 mm, with each side's recovered count.
 22. serialize - utils.serialization on the card: a projective scene, a
              projective and an NN stack, the kd SceneNN of the raw cloud, a
              device-built SceneNN (pool 4), a KDTree and [slice]'s
              RegistrationResult saved and loaded back onto the card;
              refines against each reloaded scene equal the originals' bit
              for bit (the tree: arrays and K1's walk), and TrackingSessions
              (both scene kinds) and a MultiObjectSession saved after 4
              frames and reloaded with a fresh refiner track the next 4
              frames as the uninterrupted session, bit for bit.
 23. sharded - devices=["cuda:0", "cuda:0"]: slice-bench-256 at 255 poses
              (one pad row) and the stacked refine of phase 12 at 255
              poses, split into two shards on two streams of the card,
              equal the single-device refines bit for bit (wall and device
              ms of each); devices=None on one card is the single-device
              path with [slice]'s launches.
 24. jax-names - the JAX package's names on the card at slice-bench-256's
              configuration: refine_poses_jit(use_pallas=True, chunk_iters=8)
              and PoseRefiner built positionally in JAX's order
              (use_pallas=None, chunk_iters=8) equal refine_poses / [slice]'s
              refiner bit for bit with the same launches (B1 1, L1 1, the
              iteration kernel 1); use_pallas=False (JAX's scatter raster,
              ops.rasterize.rasterize_scatter) launches no B1, its renders
              stay under 1e-4 of pixels from B1's and its verdicts agree
              100% with the kernel path (wall ms of both printed); at the
              tracking shape track_poses_jit / track_poses_nn_jit equal
              track_poses / track_poses_nn bit for bit with equal launches;
              a device-built NN scene of a crop of the frame (tl_x / tl_y)
              pooled at pool_depth_tol=0.003 refines as its plain path does
              (hold_paths).

Each kernel is timed by CUDA events (median of 20 launches, the wrapper's
host time included; plain versions fewer; B1, P2 and the iteration kernel
also alone, 20 launches between one pair of events behind a busy card) beside its
bound: the least time the card could take for the same
work, from the bytes it must move and the operations it must do on this
run's inputs at the H100's published peaks (see bound()).

The two lines before the last are the card line from nvidia-smi and a JSON
object of the nine kernels (rasterize with [renderer]'s renders,
window_lift with its cases, scene_table with its timed inputs,
nn_flash_packed, nn_flash_gated with its stacked launches apart,
gather_rows, icp_iterate with its cases and its coarse mode, nn_kdtree,
nn_flash_mxu); the last line is {"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import dataclasses
import functools
import json
import logging
import os
import pathlib
import platform
import re
import subprocess
import sys
import tempfile
import time
import traceback
import types
import unittest.mock
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_POSES = 256
WIDTH, HEIGHT = 640, 480
# the reference demo viewpoint (test.cpp:29-38), as in scripts/_workload.py
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)
CFG = dict(render_scale=2, max_points=2048, window=128, stride=2, decimate_mm=4.0)
ITERS = 24
VERDICT_DEG = 3.0
MISMATCH_GATE = 1e-4
# bench.py:305-327's serving ceiling: (coarse_iters, coarse_stride)
COARSE = (16, 4)
# tests/test_pipeline.py:104-126's gate schedule: (max_dist m, iterations)
SCHEDULE = [(0.4, 15), (0.1, 20), (0.03, 15)]
# kernel path vs plain path (tests/test_torch_slice.py bounds)
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
# bench.py:354-358: (label, refiner options, ICP iterations)
NN_CONFIGS = (
    ("2mm", dict(scene_voxel_mm=2.0), ITERS),
    ("raw", dict(), ITERS),
    ("cascade", dict(scene_cascade=(2.0, 16)), 4),
)
NN_GATES = (0.1, 0.005)
# bench.py:265-296's tracking workload: frames, hypotheses, drift, noise
N_TRACK, N_HYP, TRACK_SEED = 12, 16, 9
TRACK_DRIFT = (0.035, 5.0)  # rad per Euler axis, mm per axis, per frame
TRACK_NOISE = (float(np.radians(2.0)), 0.005)
TRACK_CONFIGS = (
    ("projective", dict(scene="projective")),
    ("nn", dict(scene="nn_bruteforce", scene_voxel_mm=2.0)),
)
# scripts/verify_multiscene.py --full: 4 frames, truths +-0.4 rad / +-20 mm
# around z = 400 mm (seed 7); 64 hypotheses per frame +-0.12 rad / +-10 mm
MS_FRAMES, MS_PER_FRAME = 4, 64
# tests/test_tracking.py:187-227's two objects, drifting per frame (seed 13)
MT_FRAMES, MT_HYP, MT_DRIFT = 12, 16, (0.015, 2.0)
# the sessions start from the poses of the frame before the first, so their
# prior is one frame's motion (the filter's per-frame process noise, 1 deg /
# 5 mm), not the filter's default prior for a detector's pose (5 deg / 20 mm)
MT_INIT_COV = np.diag([np.radians(1.0) ** 2] * 3 + [0.005 ** 2] * 3)
# the card's peak rates (H100 SXM data sheet, 700 W): HBM bytes/s, FP32
# lane instructions/s (67 TFLOP/s counts an FMA as 2), TF32 tensor flop/s
HBM_BPS, FP32_IPS, TF32_FLOPS = 3.35e12, 67e12 / 2, 495e12


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def median_ms(torch, fn, reps, warm=1):
    """Median device time of fn() in ms by CUDA events, plus its output."""
    out = None
    for _ in range(warm):
        out = fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts)), out


def alone_ms(torch, fn, launches=20, rounds=5):
    """A kernel's time alone in ms: ``launches`` calls of fn() between one
    pair of CUDA events, queued behind matrix products that keep the card
    busy for longer than the host takes to enqueue the calls (measured
    first), so every launch is enqueued before the first one starts and
    the host's time is not in the span; median of ``rounds``. The inputs
    stay in the L2 cache between launches, as the ICP loop finds them."""
    busy = torch.ones((4096, 4096), device="cuda")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    busy @ busy
    b.record()
    torch.cuda.synchronize()
    mm_ms = a.elapsed_time(b)
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    n_busy = min(400, 2 + int(np.ceil(1.5 * host_ms / mm_ms)))
    ts = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        for _ in range(n_busy):
            busy @ busy
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / launches)
    return float(np.median(ts))


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


# the device kernels of B1 (one render: bin_kernel, then raster_kernel) and
# L1, by name, and the wrapper counter (ops/rasterize_cuda.launches,
# ops/lift_cuda.launches) that counts their launches
COUNTED_KERNELS = (("bin_kernel", "rasterize"), ("raster_kernel", "rasterize"),
                   ("window_lift_kernel", "window_lift"))


def checked_kernels(torch, fn, RC, LC, tries=3):
    """device_kernels of one fn() call (after a warm call), held to the
    launch counters: each profiled call starts from zero counts, and its
    rows must hold as many bin_kernel, raster_kernel and window_lift_kernel
    calls as the wrappers counted for it. Of ``tries`` profiles, the one
    that holds them and records the most device kernels (the profiler now
    and then records a call's device activity in part); none holding them
    fails the run - a process that has launched for tens of seconds records
    no more <<<>>> launches (ROADMAP C7), so such counts are taken early or
    in a fresh process (census_main)."""
    fn()
    best, seen = None, []
    for _ in range(tries):
        RC.launches = LC.launches = 0
        rows = device_kernels(torch, fn)
        launched = {"rasterize": RC.launches, "window_lift": LC.launches}
        got = {k: sum(calls for name, _ms, calls in rows if re.search(rf"\b{k}\b", name))
               for k, _c in COUNTED_KERNELS}
        want = {k: launched[c] for k, c in COUNTED_KERNELS}
        seen.append(got)
        if got == want and (best is None or sum(r[2] for r in rows) > sum(r[2] for r in best)):
            best = rows
    check(best is not None, f"the profiler's B1 / L1 kernels {seen} fall short of the "
          f"launch counters {want}")
    return best


def kernels_line(rows) -> str:
    """The device kernels of one call: count, summed ms, the longest four."""
    return (f"device_kernels={sum(calls for _n, _ms, calls in rows)} "
            f"kernel_sum_ms={sum(ms for _n, ms, _c in rows)} "
            f"top={[(name[:40], round(ms, 4), calls) for name, ms, calls in rows[:4]]}")


def busy_line(rows, wall_ms):
    """Where one call's device time goes: its device kernels (checked_kernels'
    rows: count, summed ms), their share of ``wall_ms`` (the call's
    unprofiled wall: the busy share; 1 - it is the idle share) and the three
    longest kernels by name."""
    total = sum(ms for _name, ms, _calls in rows)
    top = [(name[:48], round(ms, 4), calls) for name, ms, calls in rows[:3]]
    return (f"device_kernels={sum(calls for _n, _m, calls in rows)} kernel_sum_ms={total} "
            f"busy_share={total / wall_ms} top={top}")


# the profiled calls of the later phases, built alike in those phases and in
# the census child (late_cells): [schedule]'s refiners, [compact]'s and
# [renderer]'s renders (label, copies of the truth, down_sample, roi)
SCHEDULE_CONFIGS = (("projective", dict()), ("scene='nn' 2 mm", dict(scene="nn",
                                                                     scene_voxel_mm=2.0)))
COMPACT_KW = dict(lift="compact", render_scale=1, max_points=32768, decimate_mm=CFG["decimate_mm"])
RENDER_CELLS = (("render-256", 256, 1, (0, 0, 0, 0)),
                ("render-256, down_sample 2", 256, 2, (0, 0, 0, 0)),
                ("render-100-roi", 100, 1, (160, 80, 320, 240)),
                ("render-100-roi, down_sample 2", 100, 2, (80, 40, 160, 120)))


def schedule_starts(geometry, truth, poses_np):
    """[schedule]'s starts: the bench hypotheses with row 0 at
    tests/test_pipeline.py:111's 25 deg / 40 mm."""
    big = np.float32(25.0 / 180.0 * np.pi)
    starts = poses_np.copy()
    starts[0] = geometry.pose_from_Rt(
        geometry.euler_to_rotation(np.array([big, big, big], np.float32)).numpy()
        @ truth[:3, :3], truth[:3, 3] + np.float32(40.0)).numpy()
    return starts


def late_cells(torch, ptt, geometry, mesh, RC, dev):
    """{cell: fn} of the calls the later phases profile, built as they build
    them: [sharded]'s single and split refines at 255 poses, [coarse]'s 4 x
    refine_async(512) + fence, [schedule]'s two refines, [compact]'s refine
    and [renderer]'s four renders."""
    model, _tris, truth, poses_np = workload(geometry, mesh)
    K = geometry.LINEMOD_K
    scene = RC.rasterize(torch.as_tensor(model.tris[mesh.morton_order(model.tris)], device=dev),
                         torch.as_tensor(truth[None], device=dev), WIDTH, HEIGHT,
                         geometry.compute_proj(K, WIDTH, HEIGHT, device=dev))[0].cpu().numpy()
    crit = ptt.ICPConvergenceCriteria(max_iteration=ITERS)
    poses = torch.as_tensor(poses_np, device=dev)
    n = poses.shape[0] - 1
    one = ptt.PoseRefiner(model, K=K, device="cuda", **CFG).set_scene_depth(scene)
    two = ptt.PoseRefiner(model, K=K, devices=["cuda:0", "cuda:0"], **CFG).set_scene_depth(scene)
    coarse = ptt.PoseRefiner(model, K=K, device="cuda", coarse_iters=COARSE[0],
                             coarse_stride=COARSE[1], **CFG).set_scene_depth(scene)
    poses512 = torch.cat([poses, poses])
    cells = {"sharded single": lambda: one.refine(poses[:n], crit),
             "sharded split": lambda: two.refine(poses[:n], crit),
             "coarse": lambda: ptt.fence(*[coarse.refine_async(poses512, crit)
                                           for _ in range(4)])}
    starts = torch.as_tensor(schedule_starts(geometry, truth, poses_np), device=dev)
    for label, kw in SCHEDULE_CONFIGS:
        s_ref = ptt.PoseRefiner(model, K=K, device="cuda", **kw, **CFG).set_scene_depth(scene)
        cells[f"schedule {label}"] = functools.partial(s_ref.refine, starts, crit,
                                                       schedule=SCHEDULE)
    cm = ptt.PoseRefiner(model, K=K, device="cuda", **COMPACT_KW).set_scene_depth(scene)
    cells["compact"] = lambda: cm.refine(poses, crit)
    renderer = ptt.PoseRenderer(model, K=K, device="cuda")
    for label, n_r, ds, roi in RENDER_CELLS:
        r_poses = torch.as_tensor(np.tile(truth, (n_r, 1, 1)), device=dev)
        cells[f"renderer {label}"] = functools.partial(renderer.render_depth_mask, r_poses, ds,
                                                       roi)
    return cells


def census_main():
    """``chip_smoke.py --census``: checked_kernels of every late_cells call
    in this fresh process, printed as one JSON object {cell: rows}."""
    import torch

    sys.path.insert(0, REPO)
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import geometry, mesh
    from pose_refine_tpu_torch.ops import lift_cuda as LC
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC

    logging.getLogger("pose_refine_tpu_torch").setLevel(logging.ERROR)
    cells = late_cells(torch, ptt, geometry, mesh, RC, torch.device("cuda"))
    print(json.dumps({name: checked_kernels(torch, fn, RC, LC) for name, fn in cells.items()}))
    return 0


def late_census():
    """The census child's rows ([census]); a failed child fails the run."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--census"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"census child exited {out.returncode}: {out.stderr[-3000:]}")
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    phase("census", f"{len(rows)} calls of the later phases profiled in a fresh process, B1 / "
          f"L1 held to the launch counters: {({k: sum(r[2] for r in v) for k, v in rows.items()})} "
          f"device kernels; seconds={time.perf_counter() - t0}")
    return rows


def workload(geometry, mesh):
    """(model, full-res tris, truth, 256 hypotheses): scripts/_workload.py's
    construction with the same seed and draw order."""
    model = mesh.load_benchmark_model()
    tris = model.tris[mesh.morton_order(model.tris)]
    truth = geometry.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)).numpy()
    rng = np.random.default_rng(0)
    d_rot = geometry.euler_to_rotation(
        rng.uniform(-0.17, 0.17, (N_POSES, 3)).astype(np.float32)).numpy()
    d_t = rng.uniform(-20, 20, (N_POSES, 3)).astype(np.float32)
    poses = geometry.pose_from_Rt(
        np.einsum("nij,jk->nik", d_rot, truth[:3, :3]), truth[:3, 3] + d_t).numpy()
    return model, tris, truth, poses


def raster_shapes(torch, ptt, geometry, mesh, dev):
    """B1's shapes: ({name: (tris, poses, width, height, proj, roi)}, bench
    refiner with its scene set, multi-model refiner with its scene set, the
    scene depth (H, W) int32 mm, truth). The observed scene render (1 pose,
    640x480, the full mesh); the 256 hypotheses in the refiner's auto ROI
    (the decimated mesh), shared and as a per-pose (N, T, 3, 3) table;
    bench.py:181-183's render benchmark (the reference's, test.cpp:63-91:
    100 and 256 copies of the truth pose at 640x480 and 100 in the ROI
    (160, 80, 320, 240), full mesh); multimodel-256's indexed table
    (scripts/demo_multi.py's two meshes, ids [0, 1] * 128)."""
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC

    model, tris_np, truth, poses_np = workload(geometry, mesh)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, WIDTH, HEIGHT, device=dev)
    tris = torch.as_tensor(tris_np, device=dev)
    full = (0, 0, 0, 0)
    scene = RC.rasterize(tris, torch.as_tensor(truth[None], device=dev), WIDTH, HEIGHT,
                         proj)[0].cpu().numpy()
    refiner = ptt.PoseRefiner(model, K=K, device="cuda", **CFG)
    refiner.set_scene_depth(scene)
    mm_ref = ptt.MultiModelRefiner([model, mesh.make_bumpy_sphere(radius=60.0, subdivisions=4)],
                                   K=K, device="cuda", render_scale=2, max_points=2048,
                                   window=128, stride=2, decimate_mm=2.0)
    mm_ref.set_scene_depth(scene)
    poses = torch.as_tensor(poses_np, device=dev)
    mm_ids = np.array([0, 1] * (N_POSES // 2), np.int32)
    rw, rh, rp, rroi = refiner.render_w, refiner.render_h, refiner.proj, refiner.roi

    def copies(n):
        return torch.as_tensor(np.tile(truth, (n, 1, 1)), device=dev)

    shapes = {
        "scene": (tris, torch.as_tensor(truth[None], device=dev), WIDTH, HEIGHT, proj, full),
        "hypotheses": (refiner.tris, poses, rw, rh, rp, rroi),
        "per-pose": (refiner.tris.expand(N_POSES, *refiner.tris.shape).contiguous(), poses, rw,
                     rh, rp, rroi),
        "render-100": (tris, copies(100), WIDTH, HEIGHT, proj, full),
        "render-256": (tris, copies(256), WIDTH, HEIGHT, proj, full),
        "render-100-roi": (tris, copies(100), WIDTH, HEIGHT, proj, (160, 80, 320, 240)),
        "multimodel": (mm_ref._per_pose_tris(mm_ids, poses)[0], poses, mm_ref.render_w,
                       mm_ref.render_h, mm_ref.proj, mm_ref.roi),
    }
    return shapes, refiner, mm_ref, scene, truth


def raster_phase(torch, RC, name, tris, poses, width, height, proj, roi, old=None):
    """The [kernel] line of one shape: the kernel against its plain version
    (mismatch fraction, max |diff|); the render through the wrapper (median
    of 20) and alone; the plain version's time; the old path's setup
    (torch triangle_setup, after the per-pose gather of an indexed table)
    alone and, given ``old`` (compare_raster.OtherRaster of the parent's
    source), the whole old path alone and its output against the kernel's;
    launches counted and device kernels per render; the bound and the
    kernel's share of it."""
    from pose_refine_tpu_torch.ops.rasterize import roi_shape

    out_w, out_h = roi_shape(width, height, roi)

    def render():
        return RC.rasterize(tris, poses, width, height, proj, roi=roi)

    def old_setup():
        t = tris
        if isinstance(t, RC.IndexedTris):
            t = t.gathered()
        return RC.triangle_setup(t, poses, proj, width, height, roi)

    before = RC.launches
    k = render()
    torch.cuda.synchronize()
    per_render = RC.launches - before
    n_dev = 0
    for _ in range(5):  # the profiler now and then records no device activity
        n_dev = sum(calls for _name, _ms, calls in device_kernels(torch, render))
        if n_dev:
            break
    k_ms, _ = median_ms(torch, render, 20)
    a_ms = alone_ms(torch, render)
    p_ms, p = median_ms(torch, lambda: RC.rasterize_plain(tris, poses, width, height, proj,
                                                          roi=roi), 1, warm=0)
    setup_ms = alone_ms(torch, old_setup, launches=5, rounds=3)
    old_ms = old_same = None
    if old is not None:
        old_same = bool(torch.equal(old.render(tris, poses, width, height, proj, roi), k))
        old_ms = alone_ms(torch, lambda: old.render(tris, poses, width, height, proj, roi),
                          launches=5, rounds=3)
    mism = (k != p).float().mean().item()
    err = (k.to(torch.int64) - p.to(torch.int64)).abs().max().item()
    covered = int((p > 0).sum())
    r_bound = raster_bound(torch, RC, tris, poses, width, height, proj, roi)
    share = r_bound["bound_ms"] / a_ms
    t = (tris.table if isinstance(tris, RC.IndexedTris) else tris).shape[-3]
    phase("kernel", f"{name}: N={poses.shape[0]} T={t} out={out_w}x{out_h} roi={roi} "
          f"covered_px={covered} mismatch={mism} max_abs_err={err} "
          f"kernel_alone_ms={a_ms} kernel_ms={k_ms} (with the wrapper) plain_ms={p_ms} "
          f"old_path_alone_ms={old_ms} old_equal={old_same} old_setup_alone_ms={setup_ms} "
          f"bound_ms={r_bound['bound_ms']} ({r_bound['bound_by']}) share_of_bound={share} "
          f"launches_per_render={per_render} device_kernels_per_render={n_dev}")
    check(covered > 0, f"{name}: empty render")
    check(mism < MISMATCH_GATE, f"{name}: kernel/plain mismatch {mism}")
    check(per_render == 1 and n_dev <= 2, f"{name}: {per_render} launches counted, "
          f"{n_dev} device kernels a render")
    check(old_same in (None, True), f"{name}: the old path's render differs from the kernel's")
    return k, dict(mismatch=mism, max_abs_err=err, ms=k_ms, alone_ms=a_ms, plain_ms=p_ms,
                   old_alone_ms=old_ms, old_setup_alone_ms=setup_ms, share_of_bound=share,
                   **r_bound)


def refine_ms(torch, fn, reps=5):
    """Median wall ms and CUDA-event ms of fn() over reps runs."""
    walls, dev_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        dev_ms.append(a.elapsed_time(b))
    return float(np.median(walls)) * 1e3, float(np.median(dev_ms))


def agreement(rotation_angle_deg, truth, a, b, fit_a, fit_b):
    """Two refines of the same hypotheses side by side: the share of poses
    with equal verdicts (rotation < 3 deg and translation < 2 mm of
    ``truth``, one (4, 4) pose or one per row), and over the poses the
    (median, max) of the rotation (deg), translation (mm, worst axis) and
    fitness deltas."""
    err_a = rotation_angle_deg(a, truth) < VERDICT_DEG
    err_b = rotation_angle_deg(b, truth) < VERDICT_DEG
    mm_a = np.linalg.norm(a[:, :3, 3] - truth[..., :3, 3], axis=-1) < 2.0
    mm_b = np.linalg.norm(b[:, :3, 3] - truth[..., :3, 3], axis=-1) < 2.0

    def spread(x):
        return float(np.median(x)), float(np.max(x))

    return dict(agree=float(((err_a == err_b) & (mm_a == mm_b)).mean()),
                rot=spread(rotation_angle_deg(a, b)),
                t=spread(np.abs(a[:, :3, 3] - b[:, :3, 3]).max(axis=-1)),
                fit=spread(np.abs(fit_a - fit_b)))


def hold_paths(name, what, stats, failures, extra=""):
    """Print one comparison of two paths (agreement()'s values) and hold it
    to the bounds of a kernel path against a plain path at every pose: 100%
    verdict agreement, the largest rotation delta within MAX_DROT_DEG, the
    largest translation delta within MAX_DT_MM, the largest fitness delta
    within MAX_DFIT. The plain version of every kernel computes its
    kernel's function bit for bit or to the last bits (the ICP iteration:
    term by term in the kernel's summation order), so the two paths run the
    same ICP, at the hypotheses that do not converge too. A miss is
    appended to ``failures``, so one run shows every comparison before it
    fails."""
    phase(name, f"{what}: {extra}verdict_agreement={stats['agree']} (median, max) "
          f"drot_deg={stats['rot']} dt_mm={stats['t']} dfit={stats['fit']}")
    if not (stats["agree"] == 1.0 and stats["rot"][1] <= MAX_DROT_DEG
            and stats["t"][1] <= MAX_DT_MM and stats["fit"][1] <= MAX_DFIT):
        failures.append(f"{name}: {what}: the two paths disagree")


def gate_band(queries, dist_sq, g2):
    """Queries whose rounded dist^2 lies within 2^-20 |q|^2 of the squared
    gate (a bound on the score's float32 rounding error, about 16 ULPs of
    |q|^2). There the rounded score, not the true distance, decides
    validity, and the gated kernel - the JAX one as this one - prunes by
    true distance: a query 0.6 um outside a 5 mm gate can score inside it
    and lose its neighbour's chunk. Both kernels are exact outside this
    band."""
    qq = (queries * queries).sum(dim=-1)
    return (dist_sq - g2).abs() <= qq * 2.0 ** -20


def first_pass_clouds(ptt, refine_poses, ref, scene, poses, scene_ids=None):
    """The (N, max_points, 3) lifted clouds and (N, max_points) valid masks
    that ``ref``'s refine of ``poses`` hands to its first ICP pass against
    ``scene`` (captured through the association's iterate, which returns
    the start state: nothing iterates)."""
    from pose_refine_tpu_torch import icp

    seen = []
    query = scene.query if scene_ids is None else scene.query_at(scene_ids)

    def capture(state, valid, *_args, **_modes):
        seen.append((state.cloud.clone(), valid.clone()))
        return state

    refine_poses(ref.tris, poses, scene, ref.proj, ref._K_render_t, width=ref.render_w,
                 height=ref.render_h, max_points=ref.max_points,
                 criteria=ptt.ICPConvergenceCriteria(max_iteration=0), window=ref.window,
                 stride=ref.stride, roi=ref.roi, scene_ids=scene_ids,
                 query=icp.Association(query, capture))
    return seen[0]


def kd_shapes(torch, ptt, geometry, mesh, dev):
    """K1's four shapes on the bench workload (kd_shapes_at)."""
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC

    model, tris_np, truth, poses_np = workload(geometry, mesh)
    proj = geometry.compute_proj(geometry.LINEMOD_K, WIDTH, HEIGHT, device=dev)
    scene = RC.rasterize(torch.as_tensor(tris_np, device=dev),
                         torch.as_tensor(truth[None], device=dev), WIDTH, HEIGHT,
                         proj)[0].cpu().numpy()
    return kd_shapes_at(ptt, model, geometry.LINEMOD_K, scene,
                        torch.as_tensor(poses_np, device=dev))


def kd_shapes_at(ptt, model, K, scene, poses):
    """{name: (SceneNN, (N * 2048, 3) queries)}: the queries of the NN
    refine's first pass and of a late pass (the first pass at the poses a
    24-iteration scene="nn" refine returns), against the 2 mm voxel cloud and
    the raw cloud of the scene depth: 2mm-first, 2mm-late, raw-first,
    raw-late."""
    from pose_refine_tpu_torch.pipeline import refine_poses

    out = {}
    for label, kw in (("2mm", dict(scene_voxel_mm=2.0)), ("raw", dict())):
        ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn", **kw, **CFG)
        ref.set_scene_depth(scene)
        first, _ = first_pass_clouds(ptt, refine_poses, ref, ref.scene, poses)
        refined, _ = ref.refine(poses, ptt.ICPConvergenceCriteria(max_iteration=ITERS))
        late, _ = first_pass_clouds(ptt, refine_poses, ref, ref.scene, refined)
        out[f"{label}-first"] = (ref.scene, first.reshape(-1, 3).contiguous())
        out[f"{label}-late"] = (ref.scene, late.reshape(-1, 3).contiguous())
    return out


def gated_kernel_check(torch, NF, name, label, queries, sc, gate, full=None):
    """B3 against its plain version on one (queries, scene, gate): idx and
    dist^2 bit for bit on the in-gate queries outside the gate's rounding
    band, validity outside it, and (with ``full`` = B2's (idx, dist^2))
    gated == full scan in the gate. Prints one [name] line; returns the
    kernel's stats, its bound from the chunks it scanned, and max_abs_err."""
    table, boxes, balls = sc.flash_table, sc.flash_boxes, sc.flash_balls
    nq, n_chunks, g2 = queries.shape[0], table.shape[1] // NF.S_CHUNK, NF.gate_sq(gate)
    scanned = torch.empty(-(-nq // NF.Q_TILE), dtype=torch.int32, device=queries.device)
    gk_ms, (gi, gd) = median_ms(torch, lambda: NF.nn_flash_gated_cuda(
        queries, table, boxes, balls, gate, scanned=scanned), 20)
    gp_ms, (qi, qd) = median_ms(torch, lambda: NF.nn_flash_gated_plain(queries, table, gate), 1,
                                warm=0)
    # the band is drawn around the ungated dist^2: the full scan's where
    # given, else the plain gated one (BIG outside the gate, never in the band)
    band = gate_band(queries, qd if full is None else full[1], g2)
    inside = (qd < g2) & ~band
    n_in = int(inside.sum())
    err = float((gd[inside] - qd[inside]).abs().max()) if n_in else 0.0
    idx_bad = int((gi[inside] != qi[inside]).sum())
    valid_bad = int((((gd < g2) != (qd < g2)) & ~band).sum())
    band_diff = int((band & ((gi != qi) | ((gd < g2) != (qd < g2)))).sum())
    skipped = 1.0 - float(scanned.sum()) / (scanned.numel() * n_chunks)
    g_bound = nn_bound(nq, float(scanned.sum()) * NF.S_CHUNK * NF.Q_TILE, balls.shape[1])
    vs_full = ""
    if full is not None:
        n_full = int((gi[inside] != full[0][inside]).sum() + (gd[inside] != full[1][inside]).sum())
        vs_full = f"vs_full_scan_mismatch={n_full} "
        check(n_full == 0, f"nn_flash_gated {label} {gate}: gated != full scan in the gate")
    phase(name, f"nn_flash_gated {label}, {table.shape[1]} columns ({n_chunks} chunks) x {nq} "
          f"queries, gate {gate} m: in_gate={n_in}/{nq} "
          f"gate_band={int(band.sum())} (of which differ {band_diff}) "
          f"idx_mismatch={idx_bad} validity_mismatch={valid_bad} {vs_full}max_abs_err={err} "
          f"chunks_skipped={skipped} kernel_ms={gk_ms} plain_ms={gp_ms} "
          f"bound_ms={g_bound['bound_ms']}")
    check(0 < n_in, f"nn_flash_gated {label} {gate}: no in-gate query")
    check(idx_bad == 0 and err == 0.0 and valid_bad == 0,
          f"nn_flash_gated {label} {gate}: kernel != plain")
    return dict(ms=gk_ms, plain_ms=gp_ms, max_abs_err=err, chunks_skipped=skipped, **g_bound)


def nn_kernel_phase(torch, NF, SceneNN, K, scene_depth, queries):
    """Both flash-NN kernels against their plain versions on the first-pass
    queries; returns {kernel name: stats of the 2 mm scene at the 0.1 m
    gate, with max_abs_err over every comparison and the raw scene's time
    and bound as raw_ms / raw_bound_ms}."""
    dev = queries.device
    nq = queries.shape[0]
    out = {}
    max_err = {"nn_flash_packed": 0.0, "nn_flash_gated": 0.0}
    raw = {}
    for label, voxel in (("raw", 0.0), ("2mm", 2.0)):
        sc = SceneNN.from_depth(scene_depth, K, 0.1, voxel_mm=voxel, device=dev)
        table = sc.flash_table
        n_chunks = table.shape[1] // NF.S_CHUNK
        p_ms, (pi, pd) = median_ms(torch, lambda: NF.nn_flash_packed_plain(queries, table), 1,
                                   warm=0)
        k_ms, (ki, kd) = median_ms(torch, lambda: NF.nn_flash_packed_cuda(queries, table), 20)
        err = float((kd - pd).abs().max())
        idx_bad = int((ki != pi).sum())
        max_err["nn_flash_packed"] = max(max_err["nn_flash_packed"], err)
        p_bound = nn_bound(nq, float(nq) * table.shape[1])
        phase("nn-kernel", f"nn_flash_packed {label} scene: {sc.points.shape[0]} points "
              f"({n_chunks} chunks) x {nq} queries: idx_mismatch={idx_bad} "
              f"max_abs_err={err} kernel_ms={k_ms} plain_ms={p_ms} "
              f"bound_ms={p_bound['bound_ms']}")
        check(torch.equal(ki, pi) and torch.equal(kd, pd),
              f"nn_flash_packed {label}: kernel != plain")
        if label == "2mm":
            out["nn_flash_packed"] = dict(ms=k_ms, plain_ms=p_ms, **p_bound)
        else:
            raw["nn_flash_packed"] = dict(raw_ms=k_ms, raw_bound_ms=p_bound["bound_ms"])
        for gate in NN_GATES:
            g = gated_kernel_check(torch, NF, "nn-kernel", f"{label} scene", queries, sc, gate,
                                   full=(ki, kd))
            max_err["nn_flash_gated"] = max(max_err["nn_flash_gated"], g.pop("max_abs_err"))
            g.pop("chunks_skipped")
            if label == "2mm" and gate == 0.1:
                out["nn_flash_gated"] = g
            elif gate == 0.1:
                raw["nn_flash_gated"] = dict(raw_ms=g["ms"], raw_bound_ms=g["bound_ms"])
    for name, e in max_err.items():
        out[name].update(raw[name], max_abs_err=e)
    return out


def nn_tie_phase(torch, NF, nn_ties, dev):
    """The tie-stress inputs (probes/nn_ties.py) through B2, B3 and stacked
    B3 against their plain versions: idx and dist^2 bit for bit on every
    query (the gate holds them all, none within its rounding band)."""
    gate, g2 = nn_ties.GATE_M, NF.gate_sq(nn_ties.GATE_M)
    done = []
    for name, (table, q) in nn_ties.cases().items():
        table, q = table.to(dev), q.to(dev)
        both = nn_ties.stacked(table)
        pairs = q.reshape(2, -1, 3)
        fid = torch.tensor([0, 1], dtype=torch.int32, device=dev)
        runs = {
            "packed": (NF.nn_flash_packed(q, table), NF.nn_flash_packed_plain(q, table)),
            "gated": (NF.nn_flash_gated(q, table, NF.chunk_boxes(table), NF.ball_table(table),
                                        gate),
                      NF.nn_flash_gated_plain(q, table, gate)),
            "stacked": (NF.nn_flash_gated(pairs, both, NF.chunk_boxes(both), NF.ball_table(both),
                                          gate, frame_id=fid, frames=2),
                        NF.nn_flash_gated_plain(pairs, both, gate, frame_id=fid, frames=2)),
        }
        torch.cuda.synchronize()
        for kernel, ((ki, kd), (pi, pd)) in runs.items():
            check(bool((pd < g2).all()) and not bool(gate_band(q, pd.reshape(-1), g2).any()),
                  f"tie-stress {name}: a query outside the gate or in its band")
            check(torch.equal(ki, pi) and torch.equal(kd.view(torch.int32), pd.view(torch.int32)),
                  f"tie-stress {name}: {kernel} kernel != plain "
                  f"({int((ki != pi).sum())} idx, {int((kd != pd).sum())} dist^2 differ)")
        done.append(f"{name} ({table.shape[1]} columns x {q.shape[0]} queries)")
    phase("nn-kernel", f"tie-stress inputs, B2 / B3 / stacked B3 == plain bit for bit on idx and "
          f"dist^2: {', '.join(done)}")


def gather_phase(torch, G, tables):
    """The row-gather kernel against its plain version on each (label,
    table, idx): bit for bit, times alone, with the wrapper, plain and
    index_select's. Returns the stats of the first (the bench projective
    association) with max_abs_err over all and every shape's stats under
    "shapes"."""
    out, max_err, shapes = None, 0.0, {}
    for label, table, idx in tables:
        k_ms, k = median_ms(torch, lambda: G.gather_rows_cuda(table, idx), 20)
        a_ms = alone_ms(torch, lambda: G.gather_rows_cuda(table, idx))
        p_ms, p = median_ms(torch, lambda: G.gather_rows_plain(table, idx), 20)
        # one PyTorch call of the same function: index_select of the
        # clamped indices (clamped here where the flash kernels' guard
        # index lies past the table)
        in_range = bool(((idx >= 0) & (idx < table.shape[0])).all())
        lib_idx = (idx if in_range else idx.clamp(0, table.shape[0] - 1)).reshape(-1)
        lib_ms, _ = median_ms(torch, lambda: table.index_select(0, lib_idx), 20)
        lib_alone = alone_ms(torch, lambda: table.index_select(0, lib_idx))
        err = float((k - p).abs().max())
        n = idx.numel()
        mbytes = n * (2 * 4 * G.ROW + idx.element_size()) / 1e6
        # the least traffic: the indices read, the rows written, and each
        # table row that this run's indices name read once
        n_read = int(idx.clamp(0, table.shape[0] - 1).unique().numel())
        g_bound = bound(n_bytes=n * (4 * G.ROW + idx.element_size()) + n_read * 4 * G.ROW)
        phase("gather", f"{label}: table {tuple(table.shape)} x {n} {idx.dtype} indices "
              f"(in range: {in_range}, distinct rows {n_read}): "
              f"equal={torch.equal(k, p)} max_abs_err={err} kernel_ms={k_ms} "
              f"kernel_alone_ms={a_ms} plain_ms={p_ms} "
              f"index_select_ms={lib_ms} index_select_alone_ms={lib_alone} "
              f"bound_ms={g_bound['bound_ms']} share_of_bound={g_bound['bound_ms'] / a_ms} "
              f"traffic_MB={mbytes} kernel_GB_s={mbytes / k_ms} plain_GB_s={mbytes / p_ms}")
        check(torch.equal(k, p), f"gather {label}: kernel != plain")
        max_err = max(max_err, err)
        shapes[label] = dict(ms=k_ms, alone_ms=a_ms, plain_ms=p_ms, library_ms=lib_ms,
                             library_alone_ms=lib_alone, rows=int(table.shape[0]), indices=n,
                             **g_bound)
        if out is None:
            out = dict(ms=k_ms, alone_ms=a_ms, plain_ms=p_ms, library_ms=lib_ms,
                       library_alone_ms=lib_alone, **g_bound)
    out["max_abs_err"] = max_err
    out["shapes"] = shapes
    return out


# FP32 operations of a kept valid point (z: convert, product; x and y: convert,
# difference, quotient, product), and of a pixel's box test (a compare)
LIFT_POINT_OPS = 2 + 2 * 4


def lift_bound(depth, clouds, valid):
    """L1's bound at one input: the framebuffer and K read once, the kept
    rows (12 + 1 bytes) written once; a compare a pixel and LIFT_POINT_OPS a
    valid kept point."""
    n_valid = int(valid.sum())
    return bound(n_bytes=depth.numel() * 4 + 36 + valid.numel() * 13,
                 n_instr=depth.numel() + LIFT_POINT_OPS * n_valid)


def lift_phase(torch, LC, window_lift, cases, timed):
    """[lift]: L1 (ops/lift_cuda.py) against its plain version
    (ops.depth_to_cloud.window_lift) on the card at each (label, depth, K,
    window, stride, max_points, (tl_x, tl_y)), both orders (projective,
    Morton): clouds bit for bit (as int32 views), valid equal, one launch a
    call. At the ``timed`` labels: with the wrapper (median of 20), alone,
    the plain version (median of 5), the bound and its share. Returns
    {label/order: stats}."""
    out = {}
    for label, depth, K, window, stride, k, tl in cases:
        for morton in (False, True):
            kw = dict(window=window, stride=stride, max_points=k, morton=morton, tl_x=tl[0],
                      tl_y=tl[1])
            before = LC.launches
            got = LC.window_lift_cuda(depth, K, **kw)
            torch.cuda.synchronize()
            launched = LC.launches - before
            want = window_lift(depth, K, **kw)
            same = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                    and torch.equal(got[1], want[1]))
            err = float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0
            key = f"{label}, {'morton' if morton else 'projective'}"
            st = dict(equal_bits=same, max_abs_err=err, launches=launched,
                      shape=[*depth.shape], rows=int(got[1].shape[1]),
                      valid_rows=int(got[1].sum()), **lift_bound(depth, *got))
            line = ""
            if label in timed:
                st["ms"], _ = median_ms(torch, lambda: LC.window_lift_cuda(depth, K, **kw), 20)
                st["alone_ms"] = alone_ms(torch, lambda: LC.window_lift_cuda(depth, K, **kw))
                st["plain_ms"], _ = median_ms(torch, lambda: window_lift(depth, K, **kw), 5)
                st["share_of_bound"] = st["bound_ms"] / st["alone_ms"]
                line = (f" kernel_ms={st['ms']} kernel_alone_ms={st['alone_ms']} "
                        f"plain_ms={st['plain_ms']} bound_ms={st['bound_ms']} "
                        f"({st['bound_by']}) share_of_bound={st['share_of_bound']}")
            phase("lift", f"{key}: {tuple(depth.shape)} window {window} / stride {stride}, "
                  f"max_points {k}, tl {tl}: rows={st['rows']} valid_rows={st['valid_rows']} "
                  f"equal_bits={same} max_abs_err={err} launches={launched}{line}")
            check(same and launched == 1, f"lift {key}: kernel != plain or {launched} launches")
            out[key] = st
    return out


def scene_table_bound(frames):
    """The scene table's bound at one input: the int32 frames and K read
    once, 32 bytes a pixel written once (its ~70 operations a pixel are far
    below the FP32 rate)."""
    return bound(n_bytes=frames.numel() * (4 + 32) + 36)


def scene_table_phase(torch, ptt, geometry, mesh, RC, dev):
    """[scene-table]: the projective scene table's kernel
    (ops/scene_table.py) against its plain version
    (scene/projective.py::_build_projective_table_plain) on the card; see
    the module docstring, phase 4c. Returns {"cases", "timed", "launches",
    "device_kernels"}."""
    from pose_refine_tpu_torch.ops import scene_table as ST
    from pose_refine_tpu_torch.probes import scene_table_cases
    from pose_refine_tpu_torch.scene import projective as SP

    t0 = time.perf_counter()

    def bits(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    def host_ms(fn, reps=20):
        """Medians of the call's own host time (what the prt.scene.build
        span reads) and of the time to its end on the card, in ms."""
        issue, done = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            a = time.perf_counter()
            fn()
            b = time.perf_counter()
            torch.cuda.synchronize()
            issue.append((b - a) * 1e3)
            done.append((time.perf_counter() - a) * 1e3)
        return float(np.median(issue[1:])), float(np.median(done[1:]))

    K = torch.as_tensor(geometry.LINEMOD_K, dtype=torch.float32, device=dev)
    n_frames = 0
    for name, (h, w) in scene_table_cases.SHAPES.items():
        frames = torch.as_tensor(scene_table_cases.stack(h, w, seed=11), device=dev)
        for i, kind in enumerate(scene_table_cases.KINDS):
            before = ST.launches
            got = ST.scene_table_cuda(frames[i], K)
            torch.cuda.synchronize()
            launched = ST.launches - before
            check(bits(got, SP._build_projective_table_plain(frames[i], K)) and launched == 1,
                  f"scene table {name} {kind}: kernel != plain or {launched} launches")
            n_frames += 1
        check(bits(ST.scene_table_cuda(frames, K), SP._build_projective_table_plain(frames, K)),
              f"scene table {name}, the stack: kernel != plain")
    phase("scene-table", f"{n_frames} frames ({', '.join(scene_table_cases.KINDS)}) at shapes "
          f"{list(scene_table_cases.SHAPES.values())} and their stacks: bit for bit with the "
          f"plain version, one launch a call")

    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    proj = geometry.compute_proj(geometry.LINEMOD_K, WIDTH, HEIGHT, device=dev)
    truths = np.stack([geometry.pose_from_Rt(R_REN, np.array([20 * i, 0, 300 + 15 * i],
                                                             np.float32)).numpy()
                       for i in range(4)])
    renders = RC.rasterize(m.tris, truths, WIDTH, HEIGHT, proj, device="cuda")
    timed_stats, kernels = {}, {}
    for label, frames in (("frame", renders[0].contiguous()), ("stack4", renders)):
        same = bits(ST.scene_table_cuda(frames, K), SP._build_projective_table_plain(frames, K))
        st = dict(equal_bits=same, shape=[*frames.shape], **scene_table_bound(frames))
        st["alone_ms"] = alone_ms(torch, lambda: ST.scene_table_cuda(frames, K))
        st["ms"], _ = median_ms(torch, lambda: ST.scene_table_cuda(frames, K), 20)
        st["plain_ms"], _ = median_ms(
            torch, lambda: SP._build_projective_table_plain(frames, K), 5)
        st["share_of_bound"] = st["bound_ms"] / st["alone_ms"]
        host = frames.cpu().numpy()
        build = (SP.SceneProjective.from_depth if frames.dim() == 2
                 else SP.SceneProjectiveStack.from_depths)
        run = lambda: build(host, geometry.LINEMOD_K, device=dev)  # noqa: E731
        st["host_build_ms"], st["host_build_done_ms"] = host_ms(run)
        kernels[label] = device_kernels(torch, run)
        with unittest.mock.patch.object(SP, "_build_projective_table",
                                        SP._build_projective_table_plain):
            st["host_build_plain_ms"], st["host_build_plain_done_ms"] = host_ms(run)
            kernels[label + " plain"] = device_kernels(torch, run)
        st["device_kernels"] = sum(r[2] for r in kernels[label])
        st["device_kernels_plain"] = sum(r[2] for r in kernels[label + " plain"])
        phase("scene-table", f"{label} {tuple(frames.shape)}: equal_bits={same} "
              f"kernel_alone_ms={st['alone_ms']} kernel_ms={st['ms']} "
              f"plain_ms={st['plain_ms']} bound_ms={st['bound_ms']} ({st['bound_by']}) "
              f"share_of_bound={st['share_of_bound']}; the build from a numpy frame "
              f"(from_depth{'s' if frames.dim() == 3 else ''}): host {st['host_build_ms']} ms, "
              f"to its end {st['host_build_done_ms']} ms, device kernels "
              f"{st['device_kernels']} {[(r[0][:48], r[2]) for r in kernels[label]]}; through "
              f"the plain version host {st['host_build_plain_ms']} ms, to its end "
              f"{st['host_build_plain_done_ms']} ms, device kernels "
              f"{st['device_kernels_plain']}")
        check(same, f"scene table {label}: kernel != plain")
        timed_stats[label] = st

    ref = ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda")
    hyps = ptt.sample_hypotheses(truths[0], 16, rot_deg=6.0, trans_mm=10.0, rng=1)
    host = renders.cpu().numpy()
    session = ptt.TrackingSession(ref, truths[0], n_hypotheses=16, seed=1)
    launches = {}
    for what, fn in (("set_scene_depth", lambda: ref.set_scene_depth(host[0])),
                     ("set_scene_depths", lambda: ref.set_scene_depths(host)),
                     ("track", lambda: ref.track(renders[0], hyps)),
                     ("session_2_steps", lambda: [session.step(renders[i]) for i in (0, 1)])):
        before = ST.launches
        fn()
        torch.cuda.synchronize()
        launches[what] = ST.launches - before
    phase("scene-table", f"launches={launches}; phase seconds={time.perf_counter() - t0}")
    check(list(launches.values()) == [1, 1, 1, 2],
          f"the scene builds are not one launch each: {launches}")
    return {"cases": n_frames, "timed": timed_stats, "launches": launches,
            "device_kernels": {k: [(r[0], r[2]) for r in v] for k, v in kernels.items()}}


def scene_table_main():
    """``chip_smoke.py --scene-table``: [card], [build] and [scene-table]
    alone; the phase's numbers as the last line's JSON."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import _build, geometry, mesh
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC

    logging.getLogger("pose_refine_tpu_torch").setLevel(logging.ERROR)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    phase("card", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi.stdout.strip()}")
    t0 = time.perf_counter()
    _lib, info = _build.load_kernels()
    log = info["log"] or (pathlib.Path(info["path"]).parent / "nvcc.log").read_text()
    regs, name = [], None
    for ln in log.splitlines():
        entry = re.search(r"entry function '(\S+)'", ln)
        name = entry.group(1) if entry else name
        if name and "scene_table" in name and "Used" in ln:
            regs.append(ln.strip())
    phase("build", f"ok in {time.perf_counter() - t0:.3f} s (nvcc {info['seconds']:.3f} s, "
          f"built={info['built']}); scene table kernel: {regs}")
    stats = scene_table_phase(torch, ptt, geometry, mesh, RC, torch.device("cuda"))
    print(json.dumps({"ok": True, "scene_table": stats, "device": torch.cuda.get_device_name(0)}))
    return 0


# the iteration kernel's tail a pose and iteration, FP32 operations
# (csrc/icp_reduce.cu::iteration_tail, a division, a root and a sine count
# one): the scores and latch 10, the damping 6, the Cholesky factor 91, two
# solves 144, the residual 72, the refinement 6, the twist 27 (6 of them
# sinf / cosf), T <- upd @ T 84; and the move, 18 a point
TAIL_OPS, MOVE_OPS = 440, 18
# the iteration kernel's state a pose: read T (64), fitness, rmse, done and
# the fitness divisor; written T, fitness, rmse, done
STATE_IN_BYTES, STATE_OUT_BYTES = 64 + 4 + 4 + 1 + 4, 64 + 4 + 4 + 1


def icp_registers(log):
    """{kernel<threads, front end, terms, index type>: registers} of
    csrc/icp_reduce.cu's iteration kernel, from ptxas's -v report in the
    build log."""
    out, name = {}, None
    for ln in log.splitlines():
        entry = re.search(r"entry function '(\S+)'", ln)
        if entry:
            name = entry.group(1)
        used = re.search(r"Used (\d+) registers", ln)
        inst = used and name and re.search(
            r"(icp_iterate_kernel)ILi(\d+)ELb([01])ELb([01])E([ix])E", name)
        if inst:
            kernel, threads, proj, p2p, idx = inst.groups()
            key = (f"{kernel}<{threads},{'proj' if proj == '1' else 'indexed'},"
                   f"{'p2p' if p2p == '1' else 'plane'},{'int' if idx == 'i' else 'int64'}>")
            out[key] = int(used.group(1))
    return out


def host_cpu() -> str:
    """The host CPU's model (lscpu's, else /proc/cpuinfo's), architecture
    and core count, beside host build times."""
    names = []
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        names = [line.split(":", 1)[1].strip() for line in out.splitlines()
                 if line.startswith(("Model name", "Vendor ID"))]
    except (OSError, subprocess.SubprocessError):
        pass
    if not names:
        try:
            with open("/proc/cpuinfo") as f:
                names = [line.split(":", 1)[1].strip() for line in f
                         if line.startswith("model name")][:1]
        except OSError:
            pass
    return f"{' / '.join(names) or 'unknown CPU'}, {platform.machine()}, {os.cpu_count()} cores"


def timed(fn, reps=1):
    """(median ms of reps calls of fn(), the last call's result)."""
    ms, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), out


def full_frame(scene):
    """slice-bench-256's scene in front of a tilted wall at 600-800 mm:
    every pixel valid, a 640x480 cloud of 307,200 points."""
    yy, xx = np.mgrid[0:scene.shape[0], 0:scene.shape[1]]
    wall = (600 + 0.25 * xx + 0.1 * yy).astype(np.int32)
    return np.where(scene > 0, scene, wall)


def reference_agreement(native, rotation_angle_deg, tris, poses, proj, scene, K, truth, card_ok):
    """bench.py:379-440's verdict agreement against the reference algorithm
    in C++ (native/cpu_baseline.cpp: a scanline render of each hypothesis,
    its full scan-order cloud up to 32,768 points, projective point-to-plane
    ICP of 30 iterations against the projective ``scene``'s point and normal
    images, OpenMP over poses): the share of poses whose verdict (rotation <
    3 deg of ``truth``) equals the card refine's ``card_ok``, with how many
    each side recovered, so that a constant verdict shows."""
    t0 = time.perf_counter()
    depths = native.cpu_render_baseline(tris, poses, proj, scene.width, scene.height)
    render_ms = (time.perf_counter() - t0) * 1e3
    n_pts = 32768
    clouds = np.zeros((len(poses), n_pts, 3), np.float32)
    valid = np.zeros((len(poses), n_pts), bool)
    for i, d in enumerate(depths):
        vs, us = np.nonzero(d > 0)  # row-major: scan order
        z = d[vs, us].astype(np.float32) / 1000.0
        pts = np.stack([(us.astype(np.float32) - K[0, 2]) / K[0, 0] * z,
                        (vs.astype(np.float32) - K[1, 2]) / K[1, 1] * z, z], -1)[:n_pts]
        clouds[i, :len(pts)] = pts
        valid[i, :len(pts)] = True
    t0 = time.perf_counter()
    T, fit, _rmse = native.cpu_icp_baseline(clouds, valid, scene.pcd.cpu().numpy(),
                                            scene.normal.cpu().numpy(), K)
    icp_ms = (time.perf_counter() - t0) * 1e3
    T_mm = T.copy()
    T_mm[:, :3, 3] *= 1000.0
    ref_ok = rotation_angle_deg(T_mm @ poses, truth) < VERDICT_DEG
    return dict(hypotheses=len(poses), agreement=float((ref_ok == card_ok).mean()),
                card_recovered=int(card_ok.sum()), reference_recovered=int(ref_ok.sum()),
                reference_mean_fitness=float(fit.mean()), reference_render_ms=render_ms,
                reference_icp_ms=icp_ms, threads=native.cpu_threads())


TREE_FIELDS = ("points", "normals", "parent", "child", "split_dim", "split_v", "bbox", "bounds")


def native_phase(c):
    """[native]: the native C++ kd builder against the numpy builder on the
    2 mm, raw and full-frame clouds of slice-bench-256's scene (equal bits,
    both build times); set_scene_depth of scene="nn" on the raw cloud with
    each builder, and the refines on the two trees (equal bits); the
    reference-algorithm verdict agreement on slice-bench-256's first 16
    hypotheses and on 64 of the bumpy sphere (50, 5). Sets c.kd_raw (the
    scene="nn" refiner) and c.nat_scene (its natively built raw scene)."""
    t0 = time.perf_counter()
    native, tkd = c.native, c.tkd
    check(native.native_available(),
          f"native: the C++ library did not build: {native.unavailable_reason()}")
    raw_p, raw_n, raw_m = c._depth_scene_arrays_host(c.scene, c.K)
    ff_p, ff_n, ff_m = c._depth_scene_arrays_host(full_frame(c.scene), c.K)
    c.raw_cloud = (raw_p[raw_m], raw_n[raw_m])
    clouds = {"2mm": c.voxel_downsample(*c.raw_cloud, 0.002), "raw": c.raw_cloud,
              "full-frame": (ff_p[ff_m], ff_n[ff_m])}
    for label, (pts, nrm) in clouds.items():
        nat_ms, nat_tree = timed(lambda: tkd.build_kdtree(pts, nrm, backend="native"), reps=3)
        np_ms, np_tree = timed(lambda: tkd.build_kdtree(pts, nrm, backend="numpy"),
                               reps=1 if len(pts) > 100000 else 3)
        equal = all(np.array_equal(getattr(nat_tree, f), getattr(np_tree, f))
                    for f in TREE_FIELDS)
        phase("native", f"kd build, {label} cloud: {len(pts)} points, {nat_tree.n_nodes} "
              f"nodes: native_ms={nat_ms} numpy_ms={np_ms} (x{np_ms / nat_ms}) "
              f"equal_bits={equal} ({native.cpu_threads()} OpenMP threads; {host_cpu()})")
        check(equal, f"native: the {label} tree differs from the numpy builder's")
    c.kd_raw = kd_raw = c.ptt.PoseRefiner(c.model, K=c.K, device=c.dev, scene="nn", **CFG)

    def set_depth():
        kd_raw.set_scene_depth(c.scene)
        c.sync()
        return kd_raw.scene

    nat_set_ms, c.nat_scene = timed(set_depth, reps=3)
    with unittest.mock.patch.object(native, "build_kdtree_native", return_value=None):
        np_set_ms, np_scene = timed(set_depth, reps=3)
    c.reset_counts()
    nat_out = kd_raw.refine(c.poses, c.crit, _scene=c.nat_scene)
    c.sync()
    kd_counts = c.counts()
    kd_equal = same_bits(nat_out, kd_raw.refine(c.poses, c.crit, _scene=np_scene))
    phase("native", f"set_scene_depth of scene='nn' on the raw cloud "
          f"({c.nat_scene.points.shape[0]} points): native_ms={nat_set_ms} numpy_builder_ms="
          f"{np_set_ms}; refine on the native tree == on the numpy tree: {kd_equal} "
          f"launches={kd_counts}")
    check(kd_equal and kd_counts["nn_kdtree"] == c.crit.max_iteration + 1,
          f"native: scene='nn' refines on the two trees differ ({kd_equal}) or missed K1: "
          f"{kd_counts}")
    proj = c.proj.cpu().numpy()
    agree = {"slice-bench-16": reference_agreement(
        native, c.rotation_angle_deg, c.tris_np, c.poses_np[:16], proj, c.refiner.scene, c.K,
        c.truth, c.err_deg[:16] < VERDICT_DEG)}
    b_hyps = c.ptt.sample_hypotheses(c.pose2, 64, rot_deg=10.0, trans_mm=20.0, rng=0)
    b_ref = c.ptt.PoseRefiner(c.bumpy, K=c.K, device=c.dev, **CFG).set_scene_depth(c.depth2)
    b_refined = b_ref.refine(b_hyps, c.crit)[0].cpu().numpy()
    agree["bumpy-64"] = reference_agreement(
        native, c.rotation_angle_deg, c.bumpy.tris, b_hyps, proj, b_ref.scene, c.K, c.pose2,
        c.rotation_angle_deg(b_refined, c.pose2) < VERDICT_DEG)
    for label, st in agree.items():
        phase("native", f"verdict agreement with the reference algorithm (bench.py:379-440), "
              f"{label}: " + " ".join(f"{k}={v}" for k, v in st.items()))
        check(st["reference_mean_fitness"] > 0.5,
              f"native: the reference ICP fitted nothing on {label} ({st})")
    phase("native", f"phase seconds={time.perf_counter() - t0}")


def serialize_phase(c):
    """[serialize]: a projective scene, a projective and an NN stack, the kd
    SceneNN of the raw cloud, a device-built SceneNN, a KDTree and a
    RegistrationResult saved and loaded back on the card: every refine
    against a reloaded scene equals the refine against the original bit
    for bit (the tree: its arrays and K1's walk; the result: its arrays);
    a TrackingSession of each scene kind and a MultiObjectSession saved
    after 4 frames and reloaded with a fresh refiner track 4 more frames as
    the uninterrupted session does, bit for bit."""
    t0 = time.perf_counter()
    ptt, ser, crit = c.ptt, c.serialization, c.crit
    stats = {}
    with tempfile.TemporaryDirectory(prefix="prt_serialize_") as tmp:

        def round_trip(obj, name):
            path = os.path.join(tmp, f"{name}.npz")
            ser.save(path, obj)
            return ser.load(path, device=c.dev)

        def hold_reload(label, fn, obj):
            want = fn(obj)
            loaded = round_trip(obj, f"scene{len(stats)}")
            c.reset_counts()
            got = fn(loaded)
            c.sync()
            stats[label] = dict(equal_bits=same_bits(got, want), launches=c.counts())
            phase("serialize", f"{label}: {type(obj).__name__} reloaded on "
                  f"{loaded.table.device}: refine equal_bits={stats[label]['equal_bits']} "
                  f"launches={stats[label]['launches']}")

        hold_reload("projective scene", lambda s: c.refiner.refine(c.poses, crit, _scene=s),
                    c.refiner.scene)
        for label, kw in (("projective stack", dict(scene="projective")),
                          ("NN stack (B3)", dict(scene="nn_bruteforce", scene_voxel_mm=2.0))):
            st_ref = ptt.PoseRefiner(c.ms_mesh, K=c.K, device=c.dev, **kw, **CFG)
            st_ref.set_scene_depths(c.ms_frames)
            hold_reload(label, lambda s, r=st_ref: r.refine(c.ms_hyps_t, crit,
                                                           scene_ids=c.ms_ids_t, _scene=s),
                        st_ref.scene)
        hold_reload("kd SceneNN, raw cloud (K1)",
                    lambda s: c.kd_raw.refine(c.poses, crit, _scene=s), c.nat_scene)
        dev_scene = c.SceneNN.from_depth_device(c.torch.as_tensor(c.scene, device=c.dev), c.K_t,
                                                0.1, pool=4)
        hold_reload("device-built SceneNN, pool 4 (B3)",
                    lambda s: c.nn_ref.refine(c.poses, crit, _scene=s), dev_scene)
        tree = c.tkd.build_kdtree(*c.raw_cloud)
        tree_back = round_trip(tree, "kdtree")
        walk = [c.KD.nn_kdtree(c.queries, c.KDTreeDevice.from_tree(t, c.dev))
                for t in (tree, tree_back)]
        stats["KDTree"] = dict(equal_bits=same_bits(*walk) and all(
            np.array_equal(getattr(tree, f), getattr(tree_back, f)) for f in TREE_FIELDS))
        stats["RegistrationResult"] = dict(equal_bits=same_bits(round_trip(c.res, "res"),
                                                                    c.res))
        phase("serialize", f"KDTree of the raw cloud: arrays and K1's walk of the "
              f"{c.queries.shape[0]} first-pass queries {stats['KDTree']}; RegistrationResult "
              f"of [slice] {stats['RegistrationResult']}")

        def resume(label, make_ref, make_session, stream, k=4):
            """A session over 2k frames against one saved after k frames and
            reloaded with a fresh refiner: the last k frames' poses."""
            def poses_of(step):
                return [s.pose for s in step] if isinstance(step, list) else [step.pose]

            whole = make_session(make_ref())
            want = [poses_of(whole.step(f)) for f in stream[:2 * k]][k:]
            part = make_session(make_ref())
            for f in stream[:k]:
                part.step(f)
            path = os.path.join(tmp, f"session{len(stats)}.npz")
            ser.save(path, part)
            resumed = ser.load(path, refiner=make_ref())
            c.reset_counts()
            got = [poses_of(resumed.step(f)) for f in stream[k:2 * k]]
            c.sync()
            equal = all(np.array_equal(a, b) for w, g in zip(want, got) for a, b in zip(w, g))
            stats[label] = dict(equal_bits=equal, launches=c.counts())
            phase("serialize", f"{label}: saved after {k} frames, reloaded with a fresh "
                  f"refiner, the next {k} frames == the uninterrupted session's: {equal} "
                  f"launches={stats[label]['launches']}")

        level = c.pkg_log.level
        c.pkg_log.setLevel(logging.ERROR)  # the once-per-frame lift-budget warning
        try:
            for label, kw in TRACK_CONFIGS:
                resume(f"TrackingSession {label}",
                       lambda kw=kw: ptt.PoseRefiner(c.model, K=c.K, device=c.dev, **kw, **CFG),
                       lambda r: ptt.TrackingSession(r, c.truth, n_hypotheses=N_HYP,
                                                     process_noise=TRACK_NOISE,
                                                     seed=TRACK_SEED), c.frames)
            resume("MultiObjectSession",
                   lambda: ptt.MultiModelRefiner([c.bumpy40, c.ico30], K=c.K, device=c.dev,
                                                 **CFG),
                   lambda r: ptt.MultiObjectSession(r, [(0, c.starts[0]), (1, c.starts[1])],
                                                    n_hypotheses=MT_HYP, seed=13,
                                                    init_cov=MT_INIT_COV), c.mt_frames)
        finally:
            c.pkg_log.setLevel(level)
    bad = [label for label, st in stats.items() if not st["equal_bits"]]
    check(not bad, f"serialize: reloaded objects differ: {bad}")
    check(stats["NN stack (B3)"]["launches"]["nn_flash_gated_stacked"] > 0
          and stats["kd SceneNN, raw cloud (K1)"]["launches"]["nn_kdtree"]
          == crit.max_iteration + 1,
          f"serialize: reloaded NN scenes missed their kernels: {stats}")
    phase("serialize", f"phase seconds={time.perf_counter() - t0}")


def sharded_phase(c):
    """[sharded]: slice-bench-256 at 255 poses (so one pad row) and the
    stacked refine of [multiscene] at 255 poses, each with the batch split
    over c.two (two shards on the one card), against the single-device
    refine: equal bits, wall and device ms of each; devices=None on one
    card: the single-device path, [slice]'s launches."""
    t0 = time.perf_counter()
    ptt, crit = c.ptt, c.crit
    split = ptt.PoseRefiner(c.model, K=c.K, devices=c.two, **CFG).set_scene_depth(c.scene)
    n = c.poses.shape[0] - 1
    sh_poses = c.poses[:n]
    want = c.refiner.refine(sh_poses, crit)
    c.reset_counts()
    got = split.refine(sh_poses, crit)
    c.sync()
    sh_counts = c.counts()
    equal = same_bits(got, want)
    one_ms = refine_ms(c.torch, lambda: c.refiner.refine(sh_poses, crit))
    two_ms = refine_ms(c.torch, lambda: split.refine(sh_poses, crit))
    phase("sharded", f"slice-bench-{n}, devices={c.two} (2 shards of {(n + 1) // 2}, 1 pad "
          f"row): equal_bits={equal} single (wall_ms, device_ms)={one_ms} split={two_ms} "
          f"launches={sh_counts}; profile single: "
          f"{busy_line(c.census['sharded single'], one_ms[0])}; "
          f"split: {busy_line(c.census['sharded split'], two_ms[0])}")
    check(equal and sh_counts["icp_iterate"] == 2
          and sh_counts["rasterize"] == 2 * c.slice_counts["rasterize"],
          f"sharded: the split refine differs ({equal}) or its launches {sh_counts}")
    st_one = ptt.PoseRefiner(c.ms_mesh, K=c.K, device=c.dev, **CFG).set_scene_depths(c.ms_frames)
    st_two = ptt.PoseRefiner(c.ms_mesh, K=c.K, devices=c.two, **CFG)
    st_two.set_scene_depths(c.ms_frames)
    n_st = c.ms_hyps_t.shape[0] - 1
    args, kw = (c.ms_hyps_t[:n_st], crit), dict(scene_ids=c.ms_ids_t[:n_st])
    st_equal = same_bits(st_two.refine(*args, **kw), st_one.refine(*args, **kw))
    st_one_ms = refine_ms(c.torch, lambda: st_one.refine(*args, **kw))
    st_two_ms = refine_ms(c.torch, lambda: st_two.refine(*args, **kw))
    phase("sharded", f"stacked refine, {n_st} poses routed to their frames by scene_ids, "
          f"devices={c.two}: equal_bits={st_equal} single (wall_ms, device_ms)={st_one_ms} "
          f"split={st_two_ms}")
    check(st_equal, "sharded: the split stacked refine differs from the single-device one")
    auto = ptt.PoseRefiner(c.model, K=c.K, **CFG).set_scene_depth(c.scene)  # both defaults
    c.reset_counts()
    auto.refine(c.poses, crit)
    c.sync()
    auto_counts = c.counts()
    cards = c.torch.cuda.device_count()
    phase("sharded", f"devices=None on {cards} card(s): devices={auto.devices} "
          f"launches={auto_counts} ([slice]: {c.slice_counts})")
    check(cards > 1 or (auto.devices is None and auto_counts == c.slice_counts),
          f"sharded: devices=None on one card is not the single-device path: {auto_counts}")
    phase("sharded", f"phase seconds={time.perf_counter() - t0}")


def jax_names_phase(c):
    """[jax-names]: the JAX package's entry points and keywords on the card
    (see the module docstring, 24); returns the raster's use_pallas=False
    numbers for the kernels line."""
    t0 = time.perf_counter()
    torch, ptt, crit, ref = c.torch, c.ptt, c.crit, c.refiner
    from pose_refine_tpu_torch import pipeline as PL

    def run(fn):
        c.reset_counts()
        out = fn()
        c.sync()
        return out, c.counts()

    main = ("rasterize", "window_lift", "icp_iterate")
    plan = dict(width=ref.render_w, height=ref.render_h, max_points=ref.max_points,
                window=ref.window, stride=ref.stride, roi=ref.roi)
    args = (ref.tris, c.poses, ref.scene, ref.proj, ref._K_render_t)
    want, want_n = run(lambda: PL.refine_poses(*args, criteria=crit, **plan))
    got, got_n = run(lambda: ptt.refine_poses_jit(*args, None, criteria=crit, use_pallas=True,
                                                  chunk_iters=8, **plan))
    # JAX's positional order through chunk_iters, render_scale, decimate_mm
    named = ptt.PoseRefiner(c.model, c.K, WIDTH, HEIGHT, "projective", CFG["max_points"], 0.1,
                            None, "window", CFG["window"], CFG["stride"], True, 0.35, 8,
                            CFG["render_scale"], CFG["decimate_mm"], device=c.dev)
    named.set_scene_depth(c.scene)
    r_want, r_want_n = run(lambda: ref.refine(c.poses, crit))
    r_got, r_got_n = run(lambda: named.refine(c.poses, crit))
    ones = {k: 1 for k in main}
    jit_ok = same_bits(got, want) and got_n == want_n and {k: got_n[k] for k in main} == ones
    ref_ok = same_bits(r_got, r_want) and r_got_n == r_want_n \
        and {k: r_got_n[k] for k in main} == ones
    phase("jax-names", f"slice-bench-{N_POSES}: refine_poses_jit(use_pallas=True, chunk_iters=8)"
          f" == refine_poses: {jit_ok} launches={got_n}; PoseRefiner(use_pallas=None, "
          f"chunk_iters=8, JAX's positional order) == [slice]'s refiner: {ref_ok} "
          f"launches={r_got_n}")
    check(jit_ok and ref_ok, "jax-names: the JAX-named refine differs from the port's")

    # use_pallas=False: JAX's scatter raster, no B1 launch
    s_out, s_n = run(lambda: ptt.refine_poses_jit(*args, criteria=crit, use_pallas=False,
                                                  chunk_iters=8, **plan))
    scatter_ref = ptt.PoseRefiner(c.model, K=c.K, use_pallas=False, device=c.dev, **CFG)
    s_ref_out, s_ref_n = run(lambda: scatter_ref.set_scene_depth(c.scene).refine(c.poses, crit))
    b1 = c.RC.rasterize(ref.tris, c.poses, ref.render_w, ref.render_h, ref.proj, roi=ref.roi)
    sc = PL._scatter_raster(ref.tris, c.poses, ref.render_w, ref.render_h, ref.proj, ref.roi)
    mism = float((b1 != sc).float().mean())
    stats = agreement(c.rotation_angle_deg, c.truth, want[0].cpu().numpy(),
                      s_out[0].cpu().numpy(), want[1].fitness.cpu().numpy(),
                      s_out[1].fitness.cpu().numpy())
    b1_ms = refine_ms(torch, lambda: PL.refine_poses(*args, criteria=crit, **plan))
    sc_ms = refine_ms(torch, lambda: ptt.refine_poses_jit(
        *args, criteria=crit, use_pallas=False, chunk_iters=8, **plan))
    render_ms = refine_ms(torch, lambda: PL._scatter_raster(
        ref.tris, c.poses, ref.render_w, ref.render_h, ref.proj, ref.roi))
    phase("jax-names", f"use_pallas=False (rasterize_scatter): launches={s_n}; its renders "
          f"against B1's: mismatch={mism} (gate {MISMATCH_GATE}); against the kernel path: "
          f"verdict_agreement={stats['agree']} (median, max) drot_deg={stats['rot']} "
          f"dt_mm={stats['t']} dfit={stats['fit']}; (wall_ms, device_ms) scatter refine "
          f"{sc_ms}, B1 refine {b1_ms}, scatter render alone {render_ms}; "
          f"PoseRefiner(use_pallas=False) equal: {same_bits(s_ref_out, s_out)}")
    check(s_n["rasterize"] == 0 and s_ref_n["rasterize"] == 0 and mism < MISMATCH_GATE
          and stats["agree"] == 1.0 and same_bits(s_ref_out, s_out),
          f"jax-names: use_pallas=False launched B1 ({s_n}), split from B1 (mismatch {mism}) "
          f"or from the kernel path's verdicts ({stats['agree']})")

    # the tracking shape: track_poses_jit / track_poses_nn_jit, positional
    hyps = torch.as_tensor(c.hyps0, dtype=torch.float32, device=c.dev)
    frame = torch.as_tensor(c.frames[0], device=c.dev)
    track_eq = {}
    for label, kw in TRACK_CONFIGS:
        t_ref = ptt.PoseRefiner(c.model, K=c.K, device=c.dev, **kw, **CFG)
        t_ref.track(c.frames[0], c.hyps0, with_covariance=True)  # plans the ROI and the pool
        base = (t_ref.tris, hyps, frame, t_ref.proj, t_ref._K_render_t, t_ref._K_t,
                t_ref.max_dist_diff)
        sizes = (t_ref.render_w, t_ref.render_h, t_ref.max_points)
        opts = (t_ref.lift, t_ref.window, t_ref.stride, t_ref.roi, 8)
        t_kw = dict(width=sizes[0], height=sizes[1], max_points=sizes[2], criteria=crit,
                    lift=t_ref.lift, window=t_ref.window, stride=t_ref.stride, roi=t_ref.roi,
                    with_information=True)
        if label == "projective":
            t_want, t_want_n = run(lambda: PL.track_poses(*base, **t_kw))
            t_got, t_got_n = run(lambda: PL.track_poses_jit(*base, *sizes, crit, True, *opts,
                                                            with_information=True))
        else:
            pool = t_ref._scene_pool_cache
            perm = t_ref._scene_perm(c.frames[0].shape, pool)
            t_want, t_want_n = run(lambda: PL.track_poses_nn(
                *base, perm, scene_stride=t_ref.scene_stride, scene_pool=pool, **t_kw))
            t_got, t_got_n = run(lambda: PL.track_poses_nn_jit(
                *base, perm, *sizes, crit, True, *opts, 0.0, t_ref.scene_stride, pool,
                with_information=True))
        track_eq[label] = (same_bits(t_got, t_want) and t_got_n == t_want_n, t_got_n)
    phase("jax-names", f"tracking shape ({N_HYP} hypotheses, frame 0): "
          f"track_poses_jit / track_poses_nn_jit == track_poses / track_poses_nn bit for bit, "
          f"launches: {track_eq}")
    check(all(ok for ok, _n in track_eq.values()),
          f"jax-names: a JAX-named tracking step differs: {track_eq}")

    # a device-built NN scene of a crop, ROI offsets and pool_depth_tol
    crop, tl = c.scene[96:416, 128:512], (128, 96)
    scn = c.SceneNN.from_depth_device(torch.as_tensor(np.ascontiguousarray(crop), device=c.dev),
                                      ref._K_t, 0.1, 1, *tl, None, 4, 0.003)
    nn_poses = c.poses[:64]
    k_out, k_n = run(lambda: c.nn_ref.refine(nn_poses, crit, _scene=scn))
    nr = c.nn_ref
    p_out = PL.refine_poses(
        nr.tris, nn_poses, scn, nr.proj, nr._K_render_t, width=nr.render_w, height=nr.render_h,
        max_points=nr.max_points, criteria=crit, window=nr.window, stride=nr.stride, roi=nr.roi,
        raster=c.RC.rasterize_plain, lifter=c.window_lift,
        query=c.icp.plain_association(functools.partial(scn.query, plain=True)))
    hold_paths("jax-names", f"device-built SceneNN of a {crop.shape[1]}x{crop.shape[0]} crop at "
               f"tl={tl}, pool 4, pool_depth_tol=0.003 ({scn.points.shape[0]} rows), "
               f"{nn_poses.shape[0]} poses through the plain versions",
               agreement(c.rotation_angle_deg, c.truth, k_out[0].cpu().numpy(),
                         p_out[0].cpu().numpy(), k_out[1].fitness.cpu().numpy(),
                         p_out[1].fitness.cpu().numpy()), c.path_failures,
               extra=f"launches={k_n} ")
    check(k_n["nn_flash_gated"] == ITERS + 1 and k_n["icp_iterate"] == ITERS + 1,
          f"jax-names: the cropped device scene's refine launches {k_n}")
    phase("jax-names", f"phase seconds={time.perf_counter() - t0}")
    return dict(launches=s_n["rasterize"], mismatch_vs_b1=mism, verdict_agreement=stats["agree"],
                refine_wall_ms=sc_ms[0], b1_refine_wall_ms=b1_ms[0], render_ms=render_ms[1])


def same_bits(a, b) -> bool:
    """Equal tensors (or tuples / NamedTuples of them, None fields alike,
    as two refines' outputs); float NaN where the other is NaN."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())
    return bool((a == b).all()) and a.shape == b.shape


# what [icp-iterate] and [coarse] print of a case beside its times
RESIDENCY = ("tail_alone_ms", "registers", "local_bytes", "threads", "slabs", "ctas_per_sm",
             "waves")


def icp_residency(IR, icp_tail, probe, sms, n, rows, idx_bytes=0, iters=2):
    """The iteration kernel's residency at a launch of n poses x ``rows``
    points (probes/icp_tail.py, this checkout's source): registers and
    local bytes a thread, threads a CTA, slabs a pose, CTAs an SM (with the
    launch's dynamic shared memory: the slab when it runs more than one
    iteration) and waves of the grid."""
    slabs, threads = IR.geometry(n, rows)
    slab_bytes = 12 * -(-rows // slabs)
    smem = slab_bytes if iters > 1 and slab_bytes <= 200 * 1024 else 0
    res = icp_tail.residency(probe, idx_bytes, False, threads, smem)
    return dict(registers=res["registers"], local_bytes=res["local_bytes"], threads=threads,
                slabs=slabs, ctas_per_sm=res["ctas_per_sm"],
                waves=icp_tail.waves(n * slabs, res["ctas_per_sm"], sms))


def icp_iterate_phase(torch, IR, icp, cases, tail):
    """The ICP iteration kernel (ops/icp_reduce.py) against its plain
    version on each case, a dict of: label; cloud, valid (the loop's input,
    anchored by icp._icp_start); crit; modes = (robust_delta,
    point_to_point); plain_query, the front end's plain version;
    kernel(state, valid, n_total) -> state, the kernel path, and iters, the
    iterations it runs (crit's max_iteration + 1 for a loop, 1 for an
    indexed step, which is iteration 0); make(state, valid, n_total) -> a
    launcher whose (0, 1, *nearest) call is the step, for the step's
    per-launch times; rows, the scene rows the first pass names;
    point_bytes / pose_bytes, the bytes the front end reads a point and a
    pose beyond the 13 of cloud and mask, and instr, its FP32 instructions
    a point; launches, the kernel launches a kernel() call; timed
    False for a loop through the NN kernels (held, not timed). T,
    fitness, rmse, done and the cloud must equal the plain version's bit
    for bit, and two runs each other.

    The bound counts the bytes the function must move once a launch, as
    the kernel keeps a pose's slab on chip across its iterations: the
    cloud, valid mask, front-end inputs and state of every pose read once,
    the cloud of every pose that moves and every pose's state written
    once, the rows the first pass names read once; and the operations of
    every pose-iteration the latch lets run (the body a point, TAIL_OPS a
    pose) and of every move (MOVE_OPS a point). ``tail`` = (probe module,
    probe library, SMs): each timed case also gets the kernel's residency
    (icp_residency) and the tail alone at its poses (the probe: one CTA a
    pose, on the first pass's sums). Returns {label: stats}."""
    out = {}
    for c in cases:
        label, cloud, valid, crit = c["label"], c["cloud"], c["valid"], c["crit"]
        modes, iters = c.get("modes", (0.0, False)), c["iters"]
        state0, valid, n_total = icp._icp_start(cloud, valid)
        n, p = cloud.shape[:2]
        dev = cloud.device

        def fresh():
            return IR.ICPState(*(t.clone() for t in state0))

        # the plain version, iteration by iteration: the pose-iterations
        # the latch lets run, and those that move the cloud
        st, active, moving = fresh(), 0, 0
        moved = torch.zeros_like(st.done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(iters):
            nxt = IR.icp_iterate_plain(st, valid, n_total, c["plain_query"], it,
                                       crit.max_iteration, crit.relative_fitness,
                                       crit.relative_rmse, *modes)
            active += int((~st.done).sum())
            if it < crit.max_iteration:
                moving += int((~nxt.done).sum())
                moved |= ~nxt.done
            st = nxt
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        before = IR.iterate_launches
        got = c["kernel"](fresh(), valid, n_total)
        torch.cuda.synchronize()
        k = IR.iterate_launches - before
        check(k == c["launches"], f"icp-iterate {label}: {k} launches, not {c['launches']}")
        again = c["kernel"](fresh(), valid, n_total)
        same = {f: same_bits(a, b) for f, a, b in zip(IR.ICPState._fields, got, st)}
        finite = [(a.float() - b.float())[torch.isfinite(a.float()) & torch.isfinite(b.float())]
                  for a, b in zip(got, st)]
        err = max(float(d.abs().max()) if d.numel() else 0.0 for d in finite)
        bits = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)
                   for a, b in zip(got, again))
        stats = {}
        if not c.get("timed", True):
            phase("icp-iterate", f"{label}: {n} poses x {p} points, {iters} iterations (NN "
                  f"kernel and iteration kernel a pass, against the plain NN and the plain "
                  f"iteration): {active} pose-iterations, {moving} moves; equals_plain_bit_for_"
                  f"bit={same} two_runs_bit_equal={bits} launches={k} plain_ms={p_ms}")
            check(all(same.values()) and bits, f"icp-iterate {label}: {same}, {bits}")
            out[label] = dict(launches=k, max_abs_err=err)
            continue
        if "make" in c:
            # one indexed iteration: launch alone, the launch of a built
            # launcher (the per-iteration host cost of the loop), and the
            # first launch with its checks
            pool = iter([c["make"](fresh(), valid, n_total) for _ in range(150)])
            stats["alone_ms"] = alone_ms(torch, lambda: next(pool)(0, 1, *c["nearest"]))
            stats["ms"], _ = median_ms(torch, lambda: next(pool)(0, 1, *c["nearest"]), 20)
            states = iter([fresh() for _ in range(25)])
            stats["first_ms"], _ = median_ms(
                torch, lambda: c["make"](next(states), valid, n_total)(0, 1, *c["nearest"]), 20)
            # where the iteration's time goes beyond the pass: the same
            # iteration launch as the scoring-only last iteration (the pass,
            # the scores and the latch; no solve, twist, compose or move)
            last = crit.max_iteration
            pool = iter([c["make"](fresh(), valid, n_total) for _ in range(150)])
            stats["score_only_alone_ms"] = alone_ms(
                torch, lambda: next(pool)(last, last + 1, *c["nearest"]))
        else:
            states = iter([fresh() for _ in range(150)])
            stats["alone_ms"] = alone_ms(torch, lambda: c["kernel"](next(states), valid, n_total))
            stats["ms"], _ = median_ms(torch, lambda: c["kernel"](next(states), valid, n_total),
                                       20)
        icp_tail, probe, sms = tail
        idx_bytes = c["nearest"][0].element_size() if "nearest" in c else 0
        stats.update(icp_residency(IR, icp_tail, probe, sms, n, p, idx_bytes, iters))
        sums = IR.assoc_reduce_plain(state0.cloud, valid, c["plain_query"], *modes)
        stats["tail_alone_ms"] = icp_tail.tail_ms(probe, sums, icp_tail.start_state(n, dev))
        n_bytes = (n * (p * (13 + c["point_bytes"]) + c["pose_bytes"] + STATE_IN_BYTES
                        + STATE_OUT_BYTES) + int(moved.sum()) * p * 12 + c["rows"] * 32)
        stats.update(bound(n_bytes=n_bytes,
                           n_instr=active * (p * c["instr"] + TAIL_OPS) + moving * p * MOVE_OPS))
        stats.update(plain_ms=p_ms, library_ms=None, launches=k, iterations=iters, max_abs_err=err,
                     pose_iterations=active, moves=moving,
                     share_of_bound=stats["bound_ms"] / stats["alone_ms"])
        extra = "".join(f" {k}={stats[k]}" for k in (
            "first_ms", "score_only_alone_ms") + RESIDENCY if k in stats)
        phase("icp-iterate", f"{label}: {n} poses x {p} points, {IR.slabs_for(n, p)} CTAs a "
              f"pose, {iters} iteration(s): {active} pose-iterations, {moving} moves; "
              f"equals_plain_bit_for_bit={same} two_runs_bit_equal={bits} launches={k} "
              f"kernel_alone_ms={stats['alone_ms']} kernel_ms={stats['ms']}{extra} "
              f"plain_ms={p_ms} bound_ms={stats['bound_ms']} ({stats['bound_by']}, "
              f"{stats['share_of_bound']} of it alone) library=none")
        check(all(same.values()), f"icp-iterate {label}: the kernel differs from its plain "
              f"version: {same}")
        check(bits, f"icp-iterate {label}: two runs differ")
        check(float(got.fitness.max()) > 0, f"icp-iterate {label}: no inlier")
        out[label] = stats
    return out


# the coarse tail a pose and iteration: TAIL_OPS less the scores and latch
COARSE_TAIL_OPS = TAIL_OPS - 10


def coarse_launch_phase(torch, IR, icp, c, tail):
    """The iteration kernel's coarse mode alone on one case ``c`` (a dict):
    label; cloud, valid (a refine's first-pass clouds, anchored here by
    icp._icp_start); crit; iters, the coarse iterations; stride; front, the
    launcher's front-end keywords; plain_query, the front end's plain
    version on the strided copy; rows, the scene rows its first pass
    names; point_bytes / instr as for [icp-iterate]; nearest, for the
    indexed front end, the NN output (idx, dist_sq) of the strided copy
    (one iteration then). The launch - its coarse iterations, then the
    hand-off of the full clouds - against icp_coarse_plain + handoff_plain:
    the strided clouds, T and the full clouds bit for bit, two runs bit for
    bit. Times alone and with the wrapper (the launcher built and run, as
    the scenes' iterate runs it), the plain version's, and the bound: the
    bytes once a launch (the strided copy, its valid mask and front-end
    inputs read once, the copy of every pose that moves written once, T
    read and written, the full clouds read and written once by the
    hand-off, the rows the first pass names read once) and the operations
    of the pose-iterations that run (the body a point, COARSE_TAIL_OPS a
    pose; a held pose leaves the loop), of every move (MOVE_OPS a point)
    and of the hand-off (MOVE_OPS a full-cloud point). ``tail`` as for
    icp_iterate_phase (the coarse tail alone). Returns the stats."""
    label, iters, stride = c["label"], c["iters"], c["stride"]
    state0, valid, n_total = icp._icp_start(c["cloud"], c["valid"])
    cstate0, cvalid = IR.coarse_start(state0, valid, stride)
    n, p = state0.cloud.shape[:2]
    pc = cstate0.cloud.shape[1]
    nearest = c.get("nearest")

    def fresh():
        st = IR.ICPState(*(t.clone() for t in cstate0))
        return st._replace(T=st.T.clone()), state0.cloud.clone()

    def make(pair):
        st, full = pair
        return IR._IterateLaunch(st, cvalid, n_total, c["crit"], coarse=True, handoff=full,
                                 **c["front"])

    def run(launcher):
        if nearest is None:
            return launcher(0, iters, handoff=True)
        for it in range(iters):
            launcher(it, it + 1, *nearest, handoff=it == iters - 1)
        return launcher.state

    # the plain version, timed; then its counts a coarse iteration, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_cloud, p_T = IR.icp_coarse_plain(cstate0.cloud, state0.T, cvalid, c["plain_query"], iters,
                                       *c.get("modes", (0.0, False)))
    p_full = IR.handoff_plain(p_T, state0.cloud)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    held = torch.zeros(n, dtype=torch.bool, device=p_T.device)
    moved = torch.zeros_like(held)
    cl, T, active, moving = cstate0.cloud, state0.T, 0, 0
    for _ in range(iters):
        count = IR.unpack_sums(IR.assoc_reduce_plain(cl, cvalid, c["plain_query"],
                                                     *c.get("modes", (0.0, False))))[2]
        active += int((~held).sum())
        held |= count == 0
        moving += int((~held).sum())
        moved |= ~held
        cl, T = IR.icp_coarse_plain(cl, T, cvalid, c["plain_query"], 1,
                                    *c.get("modes", (0.0, False)))
    before = IR.iterate_launches
    pair = fresh()
    k_state = run(make(pair))
    torch.cuda.synchronize()
    k = IR.iterate_launches - before
    again_pair = fresh()
    again = run(make(again_pair))
    torch.cuda.synchronize()
    got = (k_state.cloud, k_state.T, pair[1])
    same = {name: same_bits(a, b) for name, a, b in zip(("cloud", "T", "full cloud"), got,
                                                        (p_cloud, p_T, p_full))}
    bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, (again.cloud, again.T, again_pair[1])))
    err = max(float((a - b)[torch.isfinite(a) & torch.isfinite(b)].abs().max())
              for a, b in zip(got, (p_cloud, p_T, p_full)))
    pool = iter([make(fresh()) for _ in range(150)])
    stats = dict(alone_ms=alone_ms(torch, lambda: run(next(pool))))
    pairs = iter([fresh() for _ in range(25)])
    stats["ms"], _ = median_ms(torch, lambda: run(make(next(pairs))), 20)
    icp_tail, probe, sms = tail
    stats.update(icp_residency(IR, icp_tail, probe, sms, n, pc,
                               0 if nearest is None else nearest[0].element_size(), iters))
    sums = IR.assoc_reduce_plain(cstate0.cloud, cvalid, c["plain_query"],
                                 *c.get("modes", (0.0, False)))
    stats["tail_alone_ms"] = icp_tail.tail_ms(probe, sums, icp_tail.start_state(n, p_T.device),
                                              coarse=True)
    n_bytes = (n * (pc * (13 + c["point_bytes"]) + 128 + 24 * p)
               + int(moved.sum()) * pc * 12 + c["rows"] * 32)
    stats.update(bound(n_bytes=n_bytes, n_instr=active * (pc * c["instr"] + COARSE_TAIL_OPS)
                       + moving * pc * MOVE_OPS + n * p * MOVE_OPS))
    stats.update(plain_ms=p_ms, library_ms=None, launches=k, iterations=iters, max_abs_err=err,
                 pose_iterations=active, moves=moving,
                 share_of_bound=stats["bound_ms"] / stats["alone_ms"])
    phase("coarse", f"{label}: {n} poses x {p} points, coarse rows {pc} (stride {stride}), "
          f"{IR.slabs_for(n, pc)} CTAs a pose, {iters} coarse iteration(s) and the hand-off: "
          f"{active} pose-iterations, {moving} moves, {int(held.sum())} poses held; "
          f"equals_plain_bit_for_bit={same} two_runs_bit_equal={bits} launches={k} "
          f"kernel_alone_ms={stats['alone_ms']} kernel_ms={stats['ms']} (with the wrapper) "
          f"plain_ms={p_ms} bound_ms={stats['bound_ms']} ({stats['bound_by']}, "
          f"{stats['share_of_bound']} of it alone) library=none"
          + "".join(f" {k}={stats[k]}" for k in RESIDENCY if k in stats))
    check(all(same.values()), f"coarse {label}: the kernel differs from its plain version: "
          f"{same}")
    check(bits, f"coarse {label}: two runs differ")
    check(k == (1 if nearest is None else iters), f"coarse {label}: {k} launches")
    return stats


def track_frames(geometry, raster, truth):
    """bench.py's pre-rendered tracking frames: the truth drifts by up to
    TRACK_DRIFT per frame (rng seed 9); (truths, (H, W) int32 mm numpy
    frames) rendered by ``raster`` (a pose batch -> depth batch)."""
    rng = np.random.default_rng(TRACK_SEED)
    t, truths, frames = truth.copy(), [], []
    rot, mm = TRACK_DRIFT
    for _ in range(N_TRACK):
        d = geometry.euler_to_rotation(rng.uniform(-rot, rot, 3).astype(np.float32)).numpy()
        t = geometry.pose_from_Rt(d @ t[:3, :3],
                                  t[:3, 3] + rng.uniform(-mm, mm, 3).astype(np.float32)).numpy()
        truths.append(t.copy())
        frames.append(raster(t[None])[0].cpu().numpy())
    return truths, frames


def track_session(ptt, refiner, start, frames, pipelined=True):
    """One TrackingSession over every frame, as bench.py runs it: (ms per
    frame over the whole loop, session, last TrackStep)."""
    session = ptt.TrackingSession(refiner, start, n_hypotheses=N_HYP,
                                  process_noise=TRACK_NOISE, seed=TRACK_SEED)
    t0 = time.perf_counter()
    if pipelined:
        for f in frames:
            session.step_async(f)
        last = session.flush()
    else:
        for f in frames:
            last = session.step(f)
    return (time.perf_counter() - t0) * 1e3 / len(frames), session, last


def first_hypotheses(ptt, start):
    """The hypotheses a TrackingSession of track_session samples for its
    first frame."""
    tracker = ptt.PoseTracker(start, process_noise=TRACK_NOISE)
    tracker.predict()
    return tracker.hypotheses(N_HYP, seed=np.random.default_rng(TRACK_SEED))


def sync_sites(torch, fn):
    """Run fn() under torch.cuda.set_sync_debug_mode("warn"): the
    synchronizing CUDA calls it made, as a Counter of the call chain inside
    this checkout ('file:line <- file:line ...', innermost first). Only the
    mode's own per-call warning counts (its one-time notice that it is a
    prototype does not)."""
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            chain = [f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"
                     for f in reversed(traceback.extract_stack())
                     if f.filename.startswith(REPO + os.sep)]
            sites[" <- ".join(chain[1:4]) or f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def bound(n_bytes=0.0, n_instr=0.0, n_tensor_flop=0.0):
    """The least time in ms the card could take: bytes moved (each input
    read once, each output written once) over HBM_BPS, FP32 instructions
    over FP32_IPS, tensor-core flop over TF32_FLOPS; the largest, and
    which of bytes or operations it is."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = max(n_instr / FP32_IPS, n_tensor_flop / TF32_FLOPS)
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# the triangle setup's FP32 operations per (pose, triangle), from the plain
# version's operation list (ops/rasterize.py::screen_fields, one a torch
# op, addcmul one fused multiply-add; ops/rasterize_cuda.py::triangle_setup
# with each edge difference taken once): per vertex 3 x 4 (camera) + 2 x 4
# (projection) + 2 x 3 (screen) = 26, x 3; area 7, 1 / area 1, the six
# barycentric coefficients 12, 1 / z and its differences 5, the 1 / z
# plane 10, the clamped box 16, the degenerate mask 7. A division counts as
# one; nan_to_num counts nothing (a kernel that takes finite meshes needs
# none).
SETUP_OPS = 3 * 26 + 7 + 1 + 12 + 5 + 10 + 16 + 7


def raster_bound(torch, RC, tris, poses, width, height, proj, roi):
    """B1's bound at one input: the function's bytes - the triangle table
    (and ids), the poses and the projection read once, the int32
    framebuffer written once - against SETUP_OPS FP32 operations per (pose,
    triangle) plus 8 (beta, gamma, alpha) per pixel of every clamped
    triangle box inside the ROI, counted on this input's boxes."""
    from pose_refine_tpu_torch.ops.rasterize import roi_shape

    out_w, out_h = roi_shape(width, height, roi)
    if isinstance(tris, RC.IndexedTris):
        in_bytes = tris.table.numel() * 4 + tris.ids.numel() * 4
        per_pose = tris.gathered()
    else:
        in_bytes, per_pose = tris.numel() * 4, tris
    n, t = poses.shape[0], per_pose.shape[-3]
    coef = RC.triangle_setup(per_pose, poses, proj, width, height, roi)
    rx, ry = roi[0], roi[1]
    xs, ys, xm, ym = coef[:, 9], coef[:, 10], coef[:, 11], coef[:, 12]
    x0, x1 = xs.clamp(min=rx).ceil(), xm.clamp(max=rx + out_w - 1).floor()
    y0 = ys.clamp(min=height - ry - out_h).ceil()
    y1 = ym.clamp(max=height - 1 - ry).floor()
    ok = (xs <= xm) & (ys <= ym)
    area = ((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0) * ok).double().sum()
    n_bytes = in_bytes + n * 64 + 64 + n * out_w * out_h * 4
    return bound(n_bytes=n_bytes, n_instr=8 * float(area) + SETUP_OPS * float(n) * t)


def nn_bound(nq, pairs, n_balls=0):
    """B2/B3's bound: 4 FP32 instructions per scored (query, point) pair,
    what the least kernel of this function must issue: |s|^2 - 2 q.s as 3
    FMAs (-2q taken once) and one min of the score. A strict-`<` argmin
    needs no compare or select per pair (the same argument as for
    nn_flash_mxu's 2 a pair): the compare that finds the groups that improve
    the minimum is shared by a group of points (csrc/nn_flash.cu spends 2
    instructions per 16 pairs on it, 0.125 a pair) and goes to nothing as
    the group grows, so it is the kernel's cost and not the bound's. So is
    the fourth arithmetic instruction of the bit-exact kernel, which rounds
    q'y*sy apart as the reference does (FMUL, 2 FFMA, FADD). For B3, 8 more
    per (query, ball) of the first pass; the queries read and the outputs
    written are bytes the operations dwarf. A kernel that reads under this
    bound means the bound is wrong."""
    return bound(n_bytes=nq * (12 + 8), n_instr=4 * pairs + 8 * nq * n_balls)


# the kd walk's FP32 operations (csrc/nn_kdtree.cu): a step picks its
# child from the node's record (a subtraction, a compare, the selects of near
# and far child and of the next node, the leaf and mode tests: 8); a scanned
# leaf point 3 subtractions, a product, 2 FMAs and a compare (7); a far child
# tested by its split plane a product and a compare (2); a far box read, where
# the plane does not settle the test, 6 subtractions, 6 maxima, 3 adds, a
# product, 2 FMAs and a compare (19)
KD_STEP_OPS, KD_POINT_OPS, KD_PLANE_OPS, KD_BOX_OPS = 8, 7, 2, 19


def kd_bound(nq, steps, scanned, tested, box_reads, tree_bytes):
    """K1's bound on this run's queries: the queries read, idx and dist^2
    written and the tree's arrays read once, against the operations of the
    walks these queries take (the plain version's step, leaf-point,
    far-child-test and box-read counts). The walk's dependent loads, which
    bound the kernel, are latency and count in neither."""
    return bound(n_bytes=nq * (12 + 8) + tree_bytes,
                 n_instr=KD_STEP_OPS * steps + KD_POINT_OPS * scanned + KD_PLANE_OPS * tested
                 + KD_BOX_OPS * box_reads)


def warp_efficiency(steps) -> float:
    """The walk's warp efficiency with one query a lane: the sum of the
    steps over 32 x the sum over 32-query warps (consecutive queries, the
    lanes of a one-query-a-thread kernel's warp) of the warp's longest
    walk; padding queries count 0."""
    s = steps.double().cpu().numpy()
    s = np.concatenate([s, np.zeros((-s.size) % 32)]).reshape(-1, 32)
    return float(s.sum() / (32.0 * s.max(axis=1).sum()))


def kd_walk(launch) -> str:
    """Which of K1's kernels a KDLaunch runs."""
    return "whole tree in shared memory" if launch.whole else "grid through L1"


def kd_cap_clouds(KD, pts):
    """The two prefixes of ``pts`` whose trees straddle K1's shared-memory
    cap: n points give a table the kernel stages whole, n + 1 one it walks
    through L1 (bisection over n)."""
    from pose_refine_tpu_torch.scene.kdtree import build_kdtree

    def fits(n):
        t = build_kdtree(pts[:n], pts[:n])
        return 16 * (3 * t.n_nodes + n) <= KD.STAGE_CAP_BYTES

    lo, hi = 1, len(pts)
    check(fits(lo) and not fits(hi), "kd-kernel: the raw cloud does not straddle the cap")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return pts[:lo], pts[:hi]


def kd_kernel_phase(torch, NF, KD, SceneNN, shapes):
    """K1, the kd traversal kernel, against its plain version at its four
    shapes (kd_shapes: the first and a late pass against the 2 mm and raw
    bench clouds): idx, dist^2 and steps bit for bit; against B2 on the same
    queries: both neighbours' distances evaluated alike (in float64 from the
    float32 points) are equal, or within B2's scoring error (2^-20 |q|^2,
    gate_band's bound: B2 ranks by |s|^2 - 2 q.s, K1 by the fused sum of
    squares, so where two points lie that close each may pick its own);
    other indices at equal distances are counted as ties, at near-equal
    ones as near-ties. On the raw first pass's queries also the two trees
    that straddle the kernel's shared-memory cap (the largest prefix of the
    raw cloud whose table it stages whole, and one point more, walked
    through L1), bit for bit with the plain version. Edge queries (NaN,
    overflowing, far, scene points) and a single-leaf tree bit for bit.
    Times: the kernel with the wrapper (a KDLaunch built a call) and alone
    (the refine's launcher), the plain version, B2 and B3 at the same shape,
    and the parent's kernel alone when its source sits at
    compare_kdtree.PARENT (its outputs must be equal); step, leaf-point,
    far-child-test and box-read counts, the walk's warp efficiency, the
    bound from the counts. Returns the 2 mm first pass's stats, and all four
    under "shapes"."""
    import compare_kdtree

    old = None
    if os.path.exists(compare_kdtree.PARENT):
        old = compare_kdtree.OtherKD(compare_kdtree.PARENT)
        phase("kd-kernel", f"parent's kernel: {compare_kdtree.PARENT} ({old.what}); {old.ptxas}")
    out = {"shapes": {}}
    for name, (sc, queries) in shapes.items():
        dev = queries.device
        nq = queries.shape[0]
        tree = sc.kd
        launch = KD.KDLaunch(tree, (nq,), dev)
        steps = torch.empty(nq, dtype=torch.int32, device=dev)
        k_ms, (ki, kd) = median_ms(torch, lambda: KD.nn_kdtree_cuda(queries, tree, steps=steps),
                                   20)
        a_ms = alone_ms(torch, lambda: launch(queries))
        p_ms, (pi, pd, ps, scanned, tested, box_reads) = median_ms(
            torch, lambda: KD.nn_kdtree_plain(queries, tree, return_steps=True, return_work=True),
            1, warm=0)
        n_bad = [int((ki != pi).sum()), int((kd.view(torch.int32) != pd.view(torch.int32)).sum()),
                 int((steps != ps).sum())]
        b2_ms, (bi, _bd) = median_ms(torch, lambda: NF.nn_flash_packed_cuda(queries,
                                                                             sc.flash_table), 20)
        b3_ms, _ = median_ms(torch, lambda: NF.nn_flash_gated_cuda(
            queries, sc.flash_table, sc.flash_boxes, sc.flash_balls, sc.max_dist_diff), 20)
        pts, qd = tree.points[:, :3].double(), queries.double()
        d_k = ((pts[ki.long()] - qd) ** 2).sum(-1)
        d_b = ((pts[bi.long()] - qd) ** 2).sum(-1)
        band = (d_k - d_b).abs() <= (qd * qd).sum(-1) * 2.0 ** -20
        off = int((~band).sum())
        ties = int(((ki != bi) & (d_k == d_b)).sum())
        near = int(((d_k != d_b) & band).sum())
        tree_bytes = 4 * tree.table.numel()
        n_steps, n_scan, n_test, n_box = (float(x.double().sum())
                                          for x in (ps, scanned, tested, box_reads))
        k_bound = kd_bound(nq, n_steps, n_scan, n_test, n_box, tree_bytes)
        eff = warp_efficiency(ps)
        old_part, old_ms = "", None
        if old is not None:
            o_steps = torch.empty(nq, dtype=torch.int32, device=dev)
            oi, od = old(queries, tree, o_steps)
            o_same = torch.equal(oi, ki) and torch.equal(od.view(torch.int32),
                                                         kd.view(torch.int32)) \
                and torch.equal(o_steps, steps)
            old_ms = alone_ms(torch, lambda: old(queries, tree))
            old_part = (f"parent_kernel_alone_ms={old_ms} parent_equal={o_same} "
                        f"new/parent={a_ms / old_ms} ")
            check(o_same, f"nn_kdtree {name}: the parent's kernel and this one differ")
        phase("kd-kernel", f"nn_kdtree {name}: {sc.points.shape[0]} points, {tree.n_nodes} nodes "
              f"(leaf_cap {tree.leaf_cap}, {tree_bytes} bytes) x {nq} queries, "
              f"{kd_walk(launch)}: mismatch (idx, dist^2, steps)={n_bad} steps mean="
              f"{n_steps / nq} max={int(ps.max())} leaf_points mean={n_scan / nq} "
              f"far_child_tests mean={n_test / nq} box_reads mean={n_box / nq} "
              f"warp_efficiency={eff}; vs B2: other_distance={off} "
              f"ties={ties} near_ties={near}; kernel_ms={k_ms} kernel_alone_ms={a_ms} "
              f"{old_part}plain_ms={p_ms} B2_ms={b2_ms} B3_ms={b3_ms} "
              f"bound_ms={k_bound['bound_ms']} ({k_bound['bound_by']}) share_of_bound="
              f"{k_bound['bound_ms'] / a_ms}")
        check(n_bad == [0, 0, 0], f"nn_kdtree {name}: kernel != plain {n_bad}")
        check(off == 0, f"nn_kdtree {name}: {off} neighbours at another distance than B2's")
        out["shapes"][name] = dict(
            ms=k_ms, alone_ms=a_ms, parent_alone_ms=old_ms, plain_ms=p_ms, b2_ms=b2_ms,
            b3_ms=b3_ms, steps_mean=n_steps / nq, leaf_points_mean=n_scan / nq,
            far_child_tests_mean=n_test / nq, box_reads_mean=n_box / nq,
            warp_efficiency=eff, ties_vs_b2=ties, near_ties_vs_b2=near, **k_bound)
        if name != "raw-first":
            continue
        for label, cloud in zip(("largest tree staged whole", "one point more, through L1"),
                                kd_cap_clouds(KD, tree.points[:, :3].cpu().numpy())):
            t = SceneNN.from_cloud(cloud, cloud, 0.1, device=dev).kd
            cap = KD.KDLaunch(t, (nq,), dev)
            t_steps = torch.empty(nq, dtype=torch.int32, device=dev)
            got = (*cap(queries, t_steps), t_steps)
            want = KD.nn_kdtree_plain(queries, t, return_steps=True)
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want))
            phase("kd-kernel", f"nn_kdtree {name} queries, {label} ({cloud.shape[0]} points, "
                  f"{t.n_nodes} nodes, {4 * t.table.numel()} bytes, cap "
                  f"{KD.STAGE_CAP_BYTES}; {kd_walk(cap)}): kernel == plain bit for bit (idx, "
                  f"dist^2, steps): {same}; "
                  f"kernel_alone_ms={alone_ms(torch, lambda: cap(queries))}")
            check(same, f"nn_kdtree {name} {label}: kernel != plain")
            check(cap.whole == label.startswith("largest"),
                  f"nn_kdtree {label}: the tree does not straddle the cap")
        raw_pts = tree.points[:, :3]
        edge = torch.tensor([[float("nan"), 0.0, 0.3], [0.0, float("nan"), float("nan")],
                             [1e30, 1e30, 1e30], [-1e30, 0.0, 0.3], [10.0, 10.0, 10.0]],
                            device=dev)
        edge = torch.cat([edge, raw_pts[::97], raw_pts[:64]])
        few = raw_pts[:5].cpu().numpy()
        one = SceneNN.from_cloud(few, few, 0.1, device=dev).kd
        for what, t, q in (("edge", tree, edge), ("single leaf", one, queries[:4096])):
            st = torch.empty(q.shape[0], dtype=torch.int32, device=dev)
            got = (*KD.nn_kdtree_cuda(q.contiguous(), t, steps=st), st)
            want = KD.nn_kdtree_plain(q, t, return_steps=True)
            check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                      for g, w in zip(got, want)), f"nn_kdtree {what}: kernel != plain")
        phase("kd-kernel", f"edge queries (NaN, overflowing, far, {edge.shape[0] - 5} scene "
              f"points) and a single-leaf tree ({one.n_nodes} node) x 4096 queries: kernel "
              f"== plain bit for bit (idx, dist^2, steps)")
    out.update(out["shapes"]["2mm-first"])
    out["max_abs_err"] = 0.0  # bit for bit, checked above
    return out


def multiscene_workload(geometry, mesh, raster):
    """scripts/verify_multiscene.py --full's frames with MS_PER_FRAME
    hypotheses per frame: (bumpy sphere (50, 3), truths (4, 4, 4), (4, H, W)
    int32 mm frames rendered by ``raster`` (a pose batch -> depth batch),
    hypotheses (256, 4, 4), scene ids (256,)), the script's draw order."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    rng = np.random.default_rng(7)
    base = geometry.pose_from_Rt(np.eye(3, dtype=np.float32), np.float32([0, 0, 400])).numpy()
    truths = []
    for _ in range(MS_FRAMES):
        d_rot = geometry.euler_to_rotation(rng.uniform(-0.4, 0.4, 3).astype(np.float32)).numpy()
        t = base[:3, 3] + rng.uniform(-20, 20, 3).astype(np.float32)
        truths.append(geometry.pose_from_Rt(d_rot @ base[:3, :3], t).numpy())
    truths = np.stack(truths)
    frames = raster(m.tris, truths).cpu().numpy()
    hyps, ids = [], []
    for k, truth in enumerate(truths):
        for _ in range(MS_PER_FRAME):
            d = geometry.euler_to_rotation(rng.uniform(-0.12, 0.12, 3).astype(np.float32)).numpy()
            hyps.append(geometry.pose_from_Rt(
                d @ truth[:3, :3], truth[:3, 3] + rng.uniform(-10, 10, 3).astype(np.float32)
            ).numpy())
            ids.append(k)
    return m, truths, frames, np.stack(hyps).astype(np.float32), np.asarray(ids, np.int32)


def worst_errors(rotation_angle_deg, refined, truths):
    """verify_multiscene.py's bar terms: the worst rotation error (deg) and
    the worst per-axis translation error (mm) against per-row truths."""
    return (float(rotation_angle_deg(refined, truths).max()),
            float(np.abs(refined[:, :3, 3] - truths[:, :3, 3]).max()))


def stacked_nn_kernel_phase(torch, NF, stack, src, ids):
    """Stacked B3 against its plain version and against single-frame B3 on
    each frame's own table (its columns of the stack, indices offset by
    k * frame_rows), at the (N, P, 3) first-pass queries of an NN refine
    with per-pose frame ids: returns the kernel's stats and bound."""
    n, p = src.shape[:2]
    flat = src.reshape(-1, 3).contiguous()
    table, boxes, balls = stack.flash_table, stack.flash_boxes, stack.flash_balls
    gate, k_frames, rows = stack.max_dist_diff, stack.n_scenes, stack.frame_rows
    g2 = NF.gate_sq(gate)
    fid = ids.to(torch.int32).contiguous()
    scanned = torch.empty(n * -(-p // NF.Q_TILE), dtype=torch.int32, device=src.device)
    k_ms, (gi, gd) = median_ms(torch, lambda: NF.nn_flash_gated_cuda(
        flat, table, boxes, balls, gate, scanned=scanned, frame_id=fid, frames=k_frames,
        per_pose=p), 20)
    p_ms, (qi, qd) = median_ms(torch, lambda: NF.nn_flash_gated_plain(
        src, table, gate, frame_id=fid, frames=k_frames), 1, warm=0)
    qi, qd = qi.reshape(-1), qd.reshape(-1)
    band = gate_band(flat, qd, g2)
    inside = (qd < g2) & ~band
    n_in = int(inside.sum())
    err = float((gd[inside] - qd[inside]).abs().max()) if n_in else 0.0
    idx_bad = int((gi[inside] != qi[inside]).sum())
    valid_bad = int((((gd < g2) != (qd < g2)) & ~band).sum())
    single_bad = 0
    per_frame_chunks, cb = rows // NF.S_CHUNK, rows // NF.UB_BALL
    for k in range(k_frames):
        poses_k = (ids == k).nonzero()[:, 0]
        if not len(poses_k):
            continue
        qk = src[poses_k].reshape(-1, 3).contiguous()
        si, sd = NF.nn_flash_gated_cuda(
            qk, table[:, k * rows:(k + 1) * rows].contiguous(),
            boxes[k * per_frame_chunks:(k + 1) * per_frame_chunks].contiguous(),
            balls[:, k * cb:(k + 1) * cb].contiguous(), gate)
        ins = inside.reshape(n, p)[poses_k].reshape(-1)
        gk, dk = gi.reshape(n, p)[poses_k].reshape(-1), gd.reshape(n, p)[poses_k].reshape(-1)
        single_bad += int((gk[ins] != si[ins] + k * rows).sum() + (dk[ins] != sd[ins]).sum())
    skipped = 1.0 - float(scanned.sum()) / (scanned.numel() * per_frame_chunks)
    pairs = float(scanned.sum()) * NF.S_CHUNK * NF.Q_TILE
    phase("multiscene-nn", f"stacked nn_flash_gated: {k_frames} frames x {rows} rows, {n} poses x "
          f"{p} queries, gate {gate} m: in_gate={n_in}/{n * p} gate_band={int(band.sum())} "
          f"idx_mismatch={idx_bad} validity_mismatch={valid_bad} "
          f"vs_single_frame_mismatch={single_bad} max_abs_err={err} chunks_skipped={skipped} "
          f"kernel_ms={k_ms} plain_ms={p_ms}")
    check(0 < n_in, "stacked nn_flash_gated: no in-gate query")
    check(idx_bad == 0 and err == 0.0 and valid_bad == 0, "stacked nn_flash_gated: kernel != plain")
    check(single_bad == 0, "stacked nn_flash_gated != single-frame nn_flash_gated on its frame")
    return dict(stacked_ms=k_ms, stacked_plain_ms=p_ms, stacked_max_abs_err=err,
                stacked_bound_ms=nn_bound(n * p, pairs, cb)["bound_ms"])


def composite(torch, depths):
    """Min-nonzero composite of (K, H, W) depth renders: several objects in
    one sensor frame (tests/test_tracking.py:178)."""
    big = torch.iinfo(depths.dtype).max
    out = torch.where(depths > 0, depths, big).amin(dim=0)
    return torch.where(out == big, 0, out)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import compare_raster
    import pose_refine_tpu_torch as ptt

    check(os.path.dirname(os.path.dirname(os.path.abspath(ptt.__file__))) == REPO,
          f"pose_refine_tpu_torch imported from {ptt.__file__}, not from this checkout")
    from pose_refine_tpu_torch import _build, geometry, icp, mesh
    from pose_refine_tpu_torch.ops import gather as G
    from pose_refine_tpu_torch.ops import icp_reduce as IR
    from pose_refine_tpu_torch.ops import lift_cuda as LC
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC
    from pose_refine_tpu_torch.ops import scene_table as ST
    from pose_refine_tpu_torch.ops.depth_to_cloud import window_lift
    from pose_refine_tpu_torch.pipeline import _window_lift, refine_poses
    from pose_refine_tpu_torch.probes import icp_tail, lift_cases, mxu_nn, nn_ties
    from pose_refine_tpu_torch.scene import nn_flash as NF
    from pose_refine_tpu_torch.scene import nn_kdtree as KD
    from pose_refine_tpu_torch.scene import nn_mxu as NM
    from pose_refine_tpu_torch import native
    from pose_refine_tpu_torch.scene import kdtree as tkd
    from pose_refine_tpu_torch.scene.kdtree import KDTreeDevice
    from pose_refine_tpu_torch.scene.nn import (
        SceneNN,
        _depth_scene_arrays_host,
        _rows_in_gate,
        voxel_downsample,
    )
    from pose_refine_tpu_torch.utils import serialization
    from pose_refine_tpu_torch.scene.projective import SceneProjective, _project_gate
    from pose_refine_tpu_torch.scene import nn as scene_nn
    from pose_refine_tpu_torch.scene import projective as scene_projective

    def reset_counts():
        RC.launches = NF.packed_launches = NF.gated_launches = G.launches = 0
        NF.stacked_launches = NM.launches = KD.launches = 0
        IR.iterate_launches = LC.launches = ST.launches = 0

    def counts():
        return {"rasterize": RC.launches, "window_lift": LC.launches,
                "scene_table": ST.launches,
                "nn_flash_packed": NF.packed_launches,
                "nn_flash_gated": NF.gated_launches,
                "nn_flash_gated_stacked": NF.stacked_launches, "gather_rows": G.launches,
                "icp_iterate": IR.iterate_launches,
                "nn_flash_mxu": NM.launches, "nn_kdtree": KD.launches}

    def body_instr(modes):
        """FP32 instructions a point of the reduction body, no fused
        multiply-add (each term rounds as the plain version's; a division
        or a root counts as one). Plane: 3 diff, 5 residual, 9 cross, 7
        weight products, 21 + 6 products and as many adds, 5 for the
        squared distance, 3 more (86); point to point: 3 diff, 5 squared
        distance, 7 weight products, 9 for the 3 diagonal pairs, 9 single
        products, 18 for J^T e (a cross entry is a product, 2 FMAs, an add
        and the w^2 product), 21 adds to the sums, 3 more (75); Huber: 6
        (max, divide, min, root, product, the mask's product; 7 with the
        norm's root point to point)."""
        robust_delta, p2p = modes
        return (75 if p2p else 86) + ((7 if p2p else 6) if robust_delta > 0 else 0)

    iterate_cases = []

    def rows_named(s, cloud, base=None):
        """The scene rows a projective pass over ``cloud`` names."""
        seen = []

        def gather(table, idx):
            seen.append(idx)
            return G.gather_rows_plain(table, idx)

        _project_gate(s.table, s.K, s.max_dist_diff, s.height, s.width, cloud,
                      base=0 if base is None else base[:, None], gather=gather)
        return int(seen[0].unique().numel())

    def loop_case(label, iterate, plain_query, cloud, valid, crit, rows, modes=(0.0, False),
                  pose_bytes=0):
        """An [icp-iterate] case of a projective refine's whole loop, one
        launch of ``iterate`` (a scene's iterate or iterate_at)."""
        iterate_cases.append(dict(
            label=label, cloud=cloud, valid=valid, crit=crit, modes=modes,
            plain_query=plain_query, iters=crit.max_iteration + 1, launches=1, rows=rows,
            point_bytes=0, pose_bytes=pose_bytes, instr=11 + body_instr(modes),
            kernel=lambda st, v, nt: iterate(st, v, nt, crit, robust_delta=modes[0],
                                             point_to_point=modes[1])))

    def step_case(label, s, cloud, valid, nearest, modes=(0.0, False)):
        """An [icp-iterate] case of one indexed iteration (iteration 0) on
        the NN kernels' ``nearest`` = (idx, dist_sq) of ``cloud``."""
        idx, dist_sq = nearest
        crit_s = ptt.ICPConvergenceCriteria(max_iteration=ITERS)

        def make(st, v, nt):
            return IR._IterateLaunch(st, v, nt, crit_s, s.table, idx=idx, dist_sq=dist_sq,
                                     gate_sq=NF.gate_sq(s.max_dist_diff), robust_delta=modes[0],
                                     point_to_point=modes[1])

        iterate_cases.append(dict(
            label=label, cloud=cloud, valid=valid, crit=crit_s, modes=modes, iters=1,
            plain_query=lambda c: _rows_in_gate(s.table, idx, dist_sq, s.max_dist_diff,
                                                plain=True),
            launches=1, rows=int(idx.clamp(0, s.table.shape[0] - 1).unique().numel()),
            point_bytes=idx.element_size() + 4, pose_bytes=0, instr=1 + body_instr(modes),
            make=make, nearest=nearest,
            kernel=lambda st, v, nt: make(st, v, nt)(0, 1, idx, dist_sq)))

    def nn_loop_case(label, s, cloud, valid, iters=4):
        """An [icp-iterate] case of an NN refine's loop through the NN
        kernel and the iteration kernel against the plain NN and the plain
        iteration (held, not timed)."""
        crit_l = ptt.ICPConvergenceCriteria(max_iteration=iters - 1)
        iterate_cases.append(dict(
            label=label, cloud=cloud, valid=valid, crit=crit_l, iters=iters, launches=iters,
            plain_query=functools.partial(s.query, plain=True), timed=False,
            kernel=lambda st, v, nt: s.iterate(st, v, nt, crit_l)))
    from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("card", f"{kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card_line}")
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    _lib, info = _build.load_kernels()
    nvcc_log = info["log"] or (pathlib.Path(info["path"]).parent / "nvcc.log").read_text()
    phase("build", f"ok in {time.perf_counter() - t0:.3f} s (nvcc {info['seconds']:.3f} s, "
          f"built={info['built']}) -> {os.path.relpath(info['path'], REPO)}; registers of "
          f"csrc/icp_reduce.cu's kernels: {icp_registers(nvcc_log)}")
    # the iteration kernel's probe ([icp-iterate]: the tail alone, the
    # residency), compiled by nvcc on the host while the phases run
    probe_build = concurrent.futures.ThreadPoolExecutor(1)
    probe_lib = probe_build.submit(icp_tail.build)
    probe_build.shutdown(wait=False)

    # 2b. the later phases' device-kernel counts, from a fresh process
    census = late_census()

    # 3. kernel vs plain at the raster's shapes (the old path beside it when
    # the parent's source is at compare_raster.PARENT)
    model, tris_np, truth, poses_np = workload(geometry, mesh)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, WIDTH, HEIGHT, device=dev)
    tris = torch.as_tensor(tris_np, device=dev)
    shapes, refiner, mm_ref, scene, _truth = raster_shapes(torch, ptt, geometry, mesh, dev)
    check(scene.max() > 0 and 200 < scene[scene > 0].min() < 300, "implausible scene depth")
    poses = torch.as_tensor(poses_np, device=dev)
    crit = ptt.ICPConvergenceCriteria(max_iteration=ITERS)
    truths, frames = track_frames(
        geometry, lambda p: RC.rasterize(tris, torch.as_tensor(p, device=dev), WIDTH, HEIGHT,
                                         proj), truth)
    hyps0 = first_hypotheses(ptt, truth)
    # the device kernels of one refine ([slice]), one tracked frame of each
    # scene kind ([track]) and the pipeline's lift of the bench renders
    # ([lift]), profiled now: once the plain rasters of [kernel] have run
    # (tens of seconds of launches), this process's profiler no longer
    # records the port's kernels launched with <<<>>> (ROADMAP C7); the
    # later phases' calls were profiled by the census child ([census])
    bench_depth = RC.rasterize(refiner.tris, poses, refiner.render_w, refiner.render_h,
                               refiner.proj, roi=refiner.roi)
    census["slice"] = checked_kernels(torch, lambda: refiner.refine(poses, crit), RC, LC)
    census["lift"] = checked_kernels(torch, lambda: _window_lift(
        bench_depth, refiner._K_render_t, refiner.scene, refiner.max_points, refiner.window,
        refiner.stride, refiner.roi), RC, LC)
    for label, kw in TRACK_CONFIGS:
        t_ref = ptt.PoseRefiner(model, K=K, device="cuda", **kw, **CFG)
        t_ref.track(frames[0], hyps0, with_covariance=True)  # plans the ROI and the pool
        census[label] = checked_kernels(
            torch, lambda: t_ref.track(frames[0], hyps0, with_covariance=True), RC, LC)
    old = None
    if os.path.exists(compare_raster.PARENT):
        old = compare_raster.OtherRaster(compare_raster.PARENT)
        phase("kernel", f"old path: {compare_raster.PARENT} ({old.what}); {old.ptxas}")
    raster_stats = {}
    for name, args in shapes.items():
        if name == "multimodel":
            continue  # after the multi-model refine, phase 13
        out, raster_stats[name] = raster_phase(torch, RC, name, *args, old=old)
        if name == "scene":
            check(torch.equal(out[0].cpu(), torch.as_tensor(scene)), "scene render not repeatable")
    hyp_stats = raster_stats["hypotheses"]
    rw, rh = refiner.render_w, refiner.render_h

    # 4. the slice end to end through the kernel
    reset_counts()
    refined, res = refiner.refine(poses, crit)
    torch.cuda.synchronize()
    slice_counts = counts()
    launches = slice_counts["rasterize"]
    check(launches > 0 and slice_counts["icp_iterate"] == 1 and slice_counts["window_lift"] == 1
          and slice_counts["gather_rows"] == 0,
          f"refine did not launch the raster kernel, the lift as one L1 launch and the ICP loop "
          f"as one iteration-kernel launch: {slice_counts}")
    refined_np = refined.cpu().numpy()
    check(refined_np.shape == (N_POSES, 4, 4) and np.isfinite(refined_np).all(),
          "refined poses not finite (N, 4, 4)")
    fit = res.fitness.cpu().numpy()
    check(((fit >= 0) & (fit <= 1)).all() and np.isfinite(res.inlier_rmse.cpu().numpy()).all(),
          "fitness/rmse out of range")
    # the bench verdict (rotation < 3 deg), and the translation error: on
    # the icosphere stand-in for obj_06 only the translation is observable
    err_deg = rotation_angle_deg(refined_np, truth)
    recovered = float((err_deg < VERDICT_DEG).mean())
    err_mm = np.linalg.norm(refined_np[:, :3, 3] - truth[:3, 3], axis=-1)
    start_mm = np.linalg.norm(poses_np[:, :3, 3] - truth[:3, 3], axis=-1)
    walls, dev_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        refiner.refine(poses, crit)
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        dev_ms.append(a.elapsed_time(b))
    wall = float(np.median(walls))
    phase("slice", f"{N_POSES} poses, roi={refiner.roi}, window={refiner.window}, "
          f"max_points={refiner.max_points}, tris={refiner.tris.shape[0]}: "
          f"wall_ms={wall * 1e3} device_ms={float(np.median(dev_ms))} "
          f"poses_per_s={N_POSES / wall} recovered<{VERDICT_DEG}deg={recovered} "
          f"translation_err_mm median={float(np.median(err_mm))} "
          f"p90={float(np.percentile(err_mm, 90))} (start median "
          f"{float(np.median(start_mm))}) mean_fitness={float(fit.mean())} "
          f"launches={slice_counts}; one refine (profiled before [kernel]): "
          f"{kernels_line(census['slice'])}")
    check(float(fit.mean()) > 0.9, f"mean fitness {float(fit.mean())} too low")
    check(float(np.median(err_mm)) < 0.25 * float(np.median(start_mm)),
          "the refine did not pull the translations toward the truth")

    # the same refine with the plain raster in place of the kernel
    t0 = time.perf_counter()
    p_refined, p_res = refine_poses(
        refiner.tris, poses, refiner.scene, refiner.proj,
        torch.as_tensor(refiner.K_render, device=dev),
        width=rw, height=rh, max_points=refiner.max_points, criteria=crit,
        window=refiner.window, stride=refiner.stride, roi=refiner.roi,
        raster=RC.rasterize_plain, lifter=window_lift)
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t0
    p_np = p_refined.cpu().numpy()
    d_rot = float(rotation_angle_deg(refined_np, p_np).max())
    d_t = float(np.abs(refined_np[:, :3, 3] - p_np[:, :3, 3]).max())
    d_fit = float(np.abs(fit - p_res.fitness.cpu().numpy()).max())
    p_err_mm = np.linalg.norm(p_np[:, :3, 3] - truth[:3, 3], axis=-1)
    agree = float((
        ((rotation_angle_deg(p_np, truth) < VERDICT_DEG) == (err_deg < VERDICT_DEG))
        & ((p_err_mm < 2.0) == (err_mm < 2.0))
    ).mean())
    phase("slice", f"plain raster and lift path: wall_ms={p_wall * 1e3} verdict_agreement={agree} "
          f"max_drot_deg={d_rot} max_dt_mm={d_t} max_dfit={d_fit}")
    check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
          "kernel path and plain path disagree")
    # the same refine through the plain versions of the association and of
    # the iteration
    path_failures = []
    rp = functools.partial(
        refine_poses, refiner.tris, poses, refiner.scene, refiner.proj, refiner._K_render_t,
        width=rw, height=rh, max_points=refiner.max_points, criteria=crit,
        window=refiner.window, stride=refiner.stride, roi=refiner.roi)
    plain_query = functools.partial(refiner.scene.query, plain=True)
    a_refined, a_res = rp(query=icp.plain_association(plain_query))
    hold_paths("slice", "through the plain query and the plain iteration",
               agreement(rotation_angle_deg, truth, refined_np, a_refined.cpu().numpy(), fit,
                         a_res.fitness.cpu().numpy()), path_failures)

    # 4b. the window lift L1 against its plain version: the slice's renders
    # (the bench shape), the bench hypotheses at 640x480 under the auto
    # window of a full-resolution render (480 / stride 2: P = 57,600, 8,192
    # points), and lift_cases' renders at each of its regimes
    t0 = time.perf_counter()
    roi = refiner.roi
    full_depth = RC.rasterize(refiner.tris, poses, WIDTH, HEIGHT, proj)
    lift_inputs = [("bench", bench_depth, refiner._K_render_t, refiner.window, refiner.stride,
                    refiner.max_points, (roi[0], roi[1])),
                   ("full-frame p57600", full_depth, torch.as_tensor(K, device=dev), 480, 2,
                    8192, (0, 0))]
    for l_name, (l_h, l_w, *l_args) in lift_cases.SHAPES.items():
        K_case = np.asarray(K, np.float32).copy()
        K_case[0] *= l_w / WIDTH
        K_case[1] *= l_h / HEIGHT
        lift_inputs.append((l_name, torch.as_tensor(lift_cases.renders(l_h, l_w, seed=2),
                                                    device=dev),
                            torch.as_tensor(K_case, device=dev), *l_args))
    lift_stats = lift_phase(torch, LC, window_lift, lift_inputs,
                            timed=("bench", "full-frame p57600"))
    # the pipeline's lift of the bench renders: one L1 launch, no other kernel
    lift_kernels = census["lift"]
    phase("lift", f"pipeline._window_lift of the bench renders: device kernels {lift_kernels}; "
          f"phase seconds={time.perf_counter() - t0}")
    check(len(lift_kernels) == 1 and lift_kernels[0][2] == 1
          and "window_lift" in lift_kernels[0][0],
          f"the pipeline's lift is not one L1 launch: {lift_kernels}")

    # 4c. the projective scene table's kernel against its plain version
    scene_table_stats = scene_table_phase(torch, ptt, geometry, mesh, RC, dev)

    # 5. golden recovery (tests/test_icp.py:22-39 recipe) on the bumpy sphere
    ang = np.float32(10.0 / 180.0 * 3.14)
    rot = geometry.euler_to_rotation(np.array([ang, ang, ang], np.float32)).numpy()
    pose1 = geometry.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)).numpy()
    pose2 = geometry.pose_from_Rt(rot @ R_REN, np.array([20, 20, 320], np.float32)).numpy()
    bumpy = mesh.make_bumpy_sphere(radius=50.0, subdivisions=5)
    depth2 = RC.rasterize(bumpy.tris, pose2[None], WIDTH, HEIGHT, proj, device="cuda")[0]
    golden = ptt.PoseRefiner(bumpy, K=K, device="cuda")
    golden.set_scene_depth(depth2)
    g_pose, g_res = golden.refine(pose1)
    g_err = float(rotation_angle_deg(g_pose.cpu().numpy(), pose2))
    g_dt = float(np.abs(g_pose.cpu().numpy()[:3, 3] - pose2[:3, 3]).max())
    phase("golden", f"bumpy sphere 640x480: rotation error {g_err} deg (start "
          f"{float(rotation_angle_deg(pose1, pose2))}), translation error {g_dt} mm, "
          f"fitness {float(g_res.fitness)}")
    check(g_err < 1.0, f"golden recovery error {g_err} deg >= 1")

    def golden_plain(ref, criteria=ptt.ICPConvergenceCriteria()):
        """ref's refine of the golden start through the plain versions
        (raster, NN, gather, the ICP iteration), against ref.refine."""
        k_pose, k_res = ref.refine(pose1[None], criteria)
        p_pose, p_res = refine_poses(
            ref.tris, torch.as_tensor(pose1[None], device=dev), ref.scene, ref.proj,
            ref._K_render_t, width=ref.render_w, height=ref.render_h,
            max_points=ref.max_points, criteria=criteria,
            window=ref.window, stride=ref.stride, roi=ref.roi, raster=RC.rasterize_plain,
            lifter=window_lift,
            query=icp.plain_association(functools.partial(ref.scene.query, plain=True)),
            robust_delta=ref.robust_delta, estimation=ref.estimation)
        return agreement(rotation_angle_deg, pose2, k_pose.cpu().numpy(), p_pose.cpu().numpy(),
                         k_res.fitness.cpu().numpy(), p_res.fitness.cpu().numpy())

    hold_paths("golden", "through the plain versions", golden_plain(golden), path_failures)

    # 6. the flash-NN kernels against their plain versions on the queries
    # of one NN refine's first association pass (captured through the
    # query override; 0 iterations = the scoring pass alone)
    nn_ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn_bruteforce",
                             scene_voxel_mm=2.0, **CFG)
    nn_ref.set_scene_depth(scene)
    nn_cloud, nn_valid = first_pass_clouds(ptt, refine_poses, nn_ref, nn_ref.scene, poses)
    queries = nn_cloud.reshape(-1, 3)
    check(queries.shape == (N_POSES * nn_ref.max_points, 3) and bool(torch.isfinite(queries).all()),
          f"first-pass queries {tuple(queries.shape)}")
    nn_stats = nn_kernel_phase(torch, NF, SceneNN, K, scene, queries)
    nn_tie_phase(torch, NF, nn_ties, dev)

    # 6b. the kd traversal kernel against its plain version and against B2
    t0 = time.perf_counter()
    kd_stats = kd_kernel_phase(torch, NF, KD, SceneNN,
                               kd_shapes_at(ptt, model, K, scene, poses))
    phase("kd-kernel", f"phase seconds={time.perf_counter() - t0}")

    # 7. the NN slice end to end through the gated kernel
    nn_launches = {}
    nn_runs = {}  # label -> (poses, fitness) of the B3 refine, for [kd-slice]
    for label, kw, iters in NN_CONFIGS:
        ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn_bruteforce", **kw, **CFG)
        t0 = time.perf_counter()
        ref.set_scene_depth(scene)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        crit_nn = ptt.ICPConvergenceCriteria(max_iteration=iters)
        reset_counts()
        nn_refined, nn_res = ref.refine(poses, crit_nn)
        torch.cuda.synchronize()
        c = counts()
        check(c["nn_flash_gated"] > 0 and c["rasterize"] > 0
              and c["icp_iterate"] == c["nn_flash_gated"],
              f"nn-slice {label}: launches {c}")
        if label == "2mm":
            nn_launches["nn_flash_gated"] = c["nn_flash_gated"]
            nn_launches["icp_iterate"] = c["icp_iterate"]
        nn_np = nn_refined.cpu().numpy()
        check(nn_np.shape == (N_POSES, 4, 4) and np.isfinite(nn_np).all(),
              f"nn-slice {label}: refined poses not finite (N, 4, 4)")
        nn_fit = nn_res.fitness.cpu().numpy()
        nn_runs[label] = (nn_np, nn_fit)
        nn_mm = np.linalg.norm(nn_np[:, :3, 3] - truth[:3, 3], axis=-1)
        wall_ms, dev_ms = refine_ms(torch, lambda: ref.refine(poses, crit_nn))
        n_pts = ref.scene.points.shape[0]
        coarse = "" if ref._scene_coarse is None else \
            f" (coarse twin {ref._scene_coarse.points.shape[0]})"
        phase("nn-slice", f"{label}: {N_POSES} poses, scene {n_pts} points{coarse}, "
              f"build_ms={build_ms} iters={iters}: wall_ms={wall_ms} device_ms={dev_ms} "
              f"poses_per_s={N_POSES / wall_ms * 1e3} translation_err_mm median="
              f"{float(np.median(nn_mm))} (start {float(np.median(start_mm))}) "
              f"recovered<{VERDICT_DEG}deg={float((rotation_angle_deg(nn_np, truth) < VERDICT_DEG).mean())} "
              f"mean_fitness={float(nn_fit.mean())} launches={c}")
        check(float(nn_fit.mean()) > 0.9, f"nn-slice {label}: mean fitness {float(nn_fit.mean())}")
        check(float(np.median(nn_mm)) < 0.25 * float(np.median(start_mm)),
              f"nn-slice {label}: the refine did not pull the translations toward the truth")
        if label != "2mm":
            continue
        # the same refine through the plain NN, and against a full-scan scene
        rp = functools.partial(
            refine_poses, ref.tris, poses, width=ref.render_w, height=ref.render_h,
            max_points=ref.max_points, criteria=crit_nn, window=ref.window, stride=ref.stride,
            roi=ref.roi, proj=ref.proj, K=ref._K_render_t)
        t0 = time.perf_counter()
        nn_plain = functools.partial(ref.scene.query, plain=True)
        p_refined, p_res = rp(scene=ref.scene, lifter=window_lift,
                              query=icp.plain_association(nn_plain))
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t0) * 1e3
        hold_paths("nn-slice", "2mm through the plain NN and the plain iteration",
                   agreement(rotation_angle_deg, truth, nn_np, p_refined.cpu().numpy(), nn_fit,
                             p_res.fitness.cpu().numpy()),
                   path_failures, extra=f"wall_ms={p_wall} ")
        flash = SceneNN.from_depth(scene, K, ref.max_dist_diff, voxel_mm=2.0,
                                   backend="flash", device=dev)
        reset_counts()
        f_refined, f_res = rp(scene=flash)
        torch.cuda.synchronize()
        c = counts()
        nn_launches["nn_flash_packed"] = c["nn_flash_packed"]
        check(c["nn_flash_packed"] > 0, f"nn-slice full-scan scene: launches {c}")
        f_wall, f_dev = refine_ms(torch, lambda: rp(scene=flash))
        # both scenes feed equal neighbours to the same iteration kernel
        hold_paths("nn-slice", "2mm against the full-scan scene (nn_flash_packed)",
                   agreement(rotation_angle_deg, truth, nn_np, f_refined.cpu().numpy(), nn_fit,
                             f_res.fitness.cpu().numpy()),
                   path_failures, extra=f"wall_ms={f_wall} device_ms={f_dev} launches={c} ")

    # 8. golden recovery against an NN scene
    nn_golden = ptt.PoseRefiner(bumpy, K=K, device="cuda", scene="nn_bruteforce")
    nn_golden.set_scene_depth(depth2)
    ng_pose, ng_res = nn_golden.refine(pose1)
    ng_err = float(rotation_angle_deg(ng_pose.cpu().numpy(), pose2))
    ng_dt = float(np.abs(ng_pose.cpu().numpy()[:3, 3] - pose2[:3, 3]).max())
    phase("nn-golden", f"bumpy sphere 640x480, scene {nn_golden.scene.points.shape[0]} points: "
          f"rotation error {ng_err} deg, translation error {ng_dt} mm, "
          f"fitness {float(ng_res.fitness)}")
    check(np.isfinite(ng_err) and float(ng_res.fitness) > 0.7,
          f"nn golden fitness {float(ng_res.fitness)} <= 0.7")
    hold_paths("nn-golden", "through the plain versions", golden_plain(nn_golden), path_failures)

    def nn_refine_lines(name, label, ref, build_ms):
        """One NN refine of the bench hypotheses through the kernels, held
        to [nn-slice]'s accuracy bar and, at every pose, to the same refine
        through the plain versions (hold_paths). Returns (poses, fitness,
        launch counts, wall ms, device ms)."""
        reset_counts()
        r_poses, r_res = ref.refine(poses, crit)
        torch.cuda.synchronize()
        c = counts()
        r_np, r_fit = r_poses.cpu().numpy(), r_res.fitness.cpu().numpy()
        check(r_np.shape == (N_POSES, 4, 4) and np.isfinite(r_np).all(),
              f"{name} {label}: refined poses not finite (N, 4, 4)")
        r_mm = np.linalg.norm(r_np[:, :3, 3] - truth[:3, 3], axis=-1)
        wall_ms, dev_ms = refine_ms(torch, lambda: ref.refine(poses, crit))
        phase(name, f"{label}: {N_POSES} poses, scene {ref.scene.points.shape[0]} points, "
              f"build_ms={build_ms}: wall_ms={wall_ms} device_ms={dev_ms} poses_per_s="
              f"{N_POSES / wall_ms * 1e3} translation_err_mm median={float(np.median(r_mm))} "
              f"(start {float(np.median(start_mm))}) recovered<{VERDICT_DEG}deg="
              f"{float((rotation_angle_deg(r_np, truth) < VERDICT_DEG).mean())} "
              f"mean_fitness={float(r_fit.mean())} launches={c}")
        check(float(r_fit.mean()) > 0.9, f"{name} {label}: mean fitness {float(r_fit.mean())}")
        check(float(np.median(r_mm)) < 0.25 * float(np.median(start_mm)),
              f"{name} {label}: the refine did not pull the translations toward the truth")
        t0 = time.perf_counter()
        p_poses, p_res = refine_poses(
            ref.tris, poses, ref.scene, ref.proj, ref._K_render_t, width=ref.render_w,
            height=ref.render_h, max_points=ref.max_points, criteria=crit, window=ref.window,
            stride=ref.stride, roi=ref.roi, robust_delta=ref.robust_delta,
            estimation=ref.estimation,
            lifter=window_lift,
            query=icp.plain_association(functools.partial(ref.scene.query, plain=True)))
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t0) * 1e3
        hold_paths(name, f"{label} through the plain versions", agreement(
            rotation_angle_deg, truth, r_np, p_poses.cpu().numpy(), r_fit,
            p_res.fitness.cpu().numpy()), path_failures, extra=f"wall_ms={p_wall} ")
        return r_np, r_fit, c, wall_ms, dev_ms

    # 8b. the NN slice on its default path: scene="nn" is the kd traversal
    # on the card; against the plain path and against [nn-slice]'s refines
    # on B3
    t0 = time.perf_counter()
    kd_slice = {}
    for label, kw in (("2mm", dict(scene_voxel_mm=2.0)), ("raw", dict())):
        ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn", **kw, **CFG)
        t1 = time.perf_counter()
        ref.set_scene_depth(scene)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t1) * 1e3
        check(ref.scene.backend == "kdtree", f"kd-slice: scene='nn' took {ref.scene.backend}")
        kd_np, kd_fit, c, wall_ms, dev_ms = nn_refine_lines("kd-slice", f"{label} scene='nn'",
                                                            ref, build_ms)
        check(c["nn_kdtree"] == ITERS + 1 and c["icp_iterate"] == ITERS + 1
              and c["nn_flash_gated"] == 0 and c["gather_rows"] == 0,
              f"kd-slice {label}: not one kd launch and one iteration launch an iteration: {c}")
        kd_slice[label] = dict(launches=c, wall_ms=wall_ms, device_ms=dev_ms)
        b_np, b_fit = nn_runs[label]
        st = agreement(rotation_angle_deg, truth, kd_np, b_np, kd_fit, b_fit)
        phase("kd-slice", f"{label} against scene='nn_bruteforce' (B3, [nn-slice]), printed, "
              f"held to the accuracy bar only (ties may differ): verdict_agreement="
              f"{st['agree']} (median, max) drot_deg={st['rot']} dt_mm={st['t']} "
              f"dfit={st['fit']}")
    phase("kd-slice", f"phase seconds={time.perf_counter() - t0}")

    # 8c. point-to-point and Huber ICP on the NN slice (B3 scenes, 2 mm),
    # and the golden recipe point to point
    t0 = time.perf_counter()
    p2p_stats = {}
    for label, kw in (("point_to_point", dict(estimation="point_to_point")),
                      ("point_to_point huber 5mm",
                       dict(estimation="point_to_point", robust_delta=0.005)),
                      ("point_to_plane huber 5mm", dict(robust_delta=0.005))):
        ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn_bruteforce",
                              scene_voxel_mm=2.0, **kw, **CFG)
        ref.set_scene_depth(scene)
        _np, _fit, c, wall_ms, dev_ms = nn_refine_lines("p2p", label, ref, 0.0)
        check(c["nn_flash_gated"] == ITERS + 1 and c["icp_iterate"] == ITERS + 1,
              f"p2p {label}: launches {c}")
        p2p_stats[label] = dict(wall_ms=wall_ms, device_ms=dev_ms)
    # tests/test_icp_p2p.py:121's criteria (point to point converges slower)
    p2p_crit = ptt.ICPConvergenceCriteria(1e-6, 1e-7, 120)
    p2p_golden = ptt.PoseRefiner(bumpy, K=K, device="cuda", scene="nn_bruteforce",
                                 estimation="point_to_point")
    p2p_golden.set_scene_depth(depth2)
    pg_pose, pg_res = p2p_golden.refine(pose1, p2p_crit)
    pg_err = float(rotation_angle_deg(pg_pose.cpu().numpy(), pose2))
    pg_dt = float(np.abs(pg_pose.cpu().numpy()[:3, 3] - pose2[:3, 3]).max())
    phase("p2p", f"golden, bumpy sphere 640x480, point to point, 120 iterations: rotation "
          f"error {pg_err} deg, translation error {pg_dt} mm, fitness {float(pg_res.fitness)}")
    check(np.isfinite(pg_err) and float(pg_res.fitness) > 0.7,
          f"p2p golden fitness {float(pg_res.fitness)} <= 0.7")
    hold_paths("p2p", "golden through the plain versions", golden_plain(p2p_golden, p2p_crit),
               path_failures)
    phase("p2p", f"phase seconds={time.perf_counter() - t0}")

    # 8d. the second real shape, the thin L-bracket (tests/data/bracket.ply,
    # asymmetric): tests/test_second_mesh.py's recipe at 160x120 with the
    # auto lift sizes, projective as the test runs it (held to its bar), then
    # through scene="nn" (K1) point to plane and point to point (printed
    # against the bar); every refine held to its plain path
    t0 = time.perf_counter()
    bracket = mesh.Model.load(os.path.join(REPO, "tests", "data", "bracket.ply"), verbose=False)
    k_br = np.array(K, np.float32)
    k_br[:2] *= 0.25
    bw, bh = 160, 120
    br_depth = RC.rasterize(bracket.tris, pose2[None], bw, bh,
                            geometry.compute_proj(k_br, bw, bh, device=dev), device="cuda")[0]
    bracket_stats = {}
    for label, kw in (("projective point to plane", dict()),
                      ("scene='nn' point to plane", dict(scene="nn")),
                      ("scene='nn' point to point", dict(scene="nn",
                                                         estimation="point_to_point"))):
        ref = ptt.PoseRefiner(bracket, K=k_br, width=bw, height=bh, window="auto",
                              max_points="auto", device="cuda", **kw)
        ref.set_scene_depth(br_depth)
        reset_counts()
        b_pose, b_res = ref.refine(pose1)
        torch.cuda.synchronize()
        c = counts()
        b_np = b_pose.cpu().numpy()
        b_err = float(rotation_angle_deg(b_np, pose2))
        b_dt = float(np.abs(b_np[:3, 3] - pose2[:3, 3]).max())
        b_fit = float(b_res.fitness)
        meets = b_err < 4.0 and b_dt < 6.0 and b_fit > 0.7
        phase("bracket", f"{label}: window={ref.window} max_points={ref.max_points} rotation "
              f"error {b_err} deg, translation error {b_dt} mm, fitness {b_fit}; "
              f"tests/test_second_mesh.py's bar (< 4 deg, < 6 mm, fitness > 0.7): {meets} "
              f"launches={c}")
        check(np.isfinite(b_np).all(), f"bracket {label}: pose not finite")
        if "nn" in kw.get("scene", ""):
            check(c["nn_kdtree"] > 0 and c["nn_flash_gated"] == 0,
                  f"bracket {label}: scene='nn' did not take K1: {c}")
        else:
            check(meets, f"bracket {label}: misses the test's bar")
        bracket_stats[label] = dict(rotation_deg=b_err, translation_mm=b_dt, fitness=b_fit,
                                    meets_bar=meets)
        hold_paths("bracket", f"{label} through the plain versions", golden_plain(ref),
                   path_failures)
    phase("bracket", f"phase seconds={time.perf_counter() - t0}")

    # 9. the association's row gather against its plain version: the bench
    # scene at the first-pass queries' pixels, and the raw and the
    # device-built NN scenes at their nearest neighbours
    K_t = torch.as_tensor(K, device=dev)
    pixels = []

    def capture_pixels(table, idx):
        pixels.append(idx)
        return G.gather_rows_plain(table, idx)

    sc = refiner.scene
    _project_gate(sc.table, sc.K, sc.max_dist_diff, sc.height, sc.width, queries,
                  gather=capture_pixels)
    raw_nn = SceneNN.from_depth(scene, K, 0.1, backend="bruteforce", device=dev)
    frame_nn = SceneNN.from_depth_device(torch.as_tensor(scene, device=dev), K_t, 0.1)

    def neighbours(s):
        return NF.nn_flash_gated(queries, s.flash_table, s.flash_boxes, s.flash_balls,
                                 s.max_dist_diff)[0]

    gather_stats = gather_phase(torch, G, [
        ("bench projective scene", sc.table, pixels[0]),
        ("raw NN scene", raw_nn.table, neighbours(raw_nn)),
        ("device-built 640x480 NN scene", frame_nn.table, neighbours(frame_nn)),
    ])
    # the iteration kernel's cases at the slice shape ([icp-iterate], below)
    slice_cloud, slice_valid = first_pass_clouds(ptt, refine_poses, refiner, sc, poses)
    slice_rows = rows_named(sc, slice_cloud)
    sc_plain = functools.partial(sc.query, plain=True)
    loop_case("slice shape, whole loop", sc.iterate, sc_plain, slice_cloud, slice_valid, crit,
              slice_rows)
    # the serving ceiling's fine shape: 512 poses (bench.py's 256 twice), the
    # slice's scene; 128-thread CTAs, four an SM, one wave
    fine_cloud, fine_valid = first_pass_clouds(ptt, refine_poses, refiner, sc,
                                               torch.cat([poses, poses]))
    loop_case("serving fine shape, 512 x 2,048, whole loop", sc.iterate, sc_plain, fine_cloud,
              fine_valid, crit, rows_named(sc, fine_cloud))
    for m_label, modes in (("huber 5mm", (0.005, False)), ("point to point", (0.0, True)),
                           ("point to point huber 5mm", (0.005, True))):
        loop_case(f"slice shape, whole loop, {m_label}", sc.iterate, sc_plain, slice_cloud,
                  slice_valid, crit, slice_rows, modes=modes)
        step_case(f"2 mm NN scene (B3), one iteration, {m_label}", nn_ref.scene, nn_cloud,
                  nn_valid, nn_ref.scene._nearest(nn_cloud), modes=modes)
    kd2 = dataclasses.replace(nn_ref.scene, backend="kdtree")
    step_case("2 mm NN scene (B3), one iteration", nn_ref.scene, nn_cloud, nn_valid,
              nn_ref.scene._nearest(nn_cloud))
    step_case("2 mm NN scene (K1), one iteration", kd2, nn_cloud, nn_valid,
              kd2._nearest(nn_cloud))
    nn_loop_case("2 mm NN scene through B3, 64 poses", nn_ref.scene, nn_cloud[:64],
                 nn_valid[:64])
    nn_loop_case("2 mm NN scene through K1, 64 poses", kd2, nn_cloud[:64], nn_valid[:64])
    raw_kd = dataclasses.replace(raw_nn, backend="kdtree")
    step_case("raw NN scene (K1), one iteration", raw_kd, nn_cloud, nn_valid,
              raw_kd._nearest(nn_cloud))

    # 10. bench.py's tracking workload through TrackingSession
    control = sync_sites(torch, lambda: torch.ones(1, device=dev).item())
    check(sum(control.values()) >= 1, f"the sync counter missed an .item(): {dict(control)}")
    track_counts, track_gathers = {}, {}
    pkg_log = logging.getLogger("pose_refine_tpu_torch")
    for label, kw in TRACK_CONFIGS:
        ref = ptt.PoseRefiner(model, K=K, device="cuda", **kw, **CFG)
        level = pkg_log.level
        pkg_log.setLevel(logging.ERROR)  # the once-per-frame lift-budget warning
        try:
            track_session(ptt, ref, truth, frames)  # warm
            reset_counts()
            _ms, session, last = track_session(ptt, ref, truth, frames)
            torch.cuda.synchronize()
            c = track_counts[label] = counts()
            a_ms = sorted(track_session(ptt, ref, truth, frames)[0] for _ in range(3))[1]
            s_ms = sorted(track_session(ptt, ref, truth, frames, pipelined=False)[0]
                          for _ in range(3))[1]
            probe = ptt.TrackingSession(ref, truth, n_hypotheses=N_HYP,
                                        process_noise=TRACK_NOISE, seed=TRACK_SEED)
            probe.step_async(frames[0])
            probe.step_async(frames[1])
            syncs = sync_sites(torch, lambda: probe.step_async(frames[2]))
            probe.flush()
        finally:
            pkg_log.setLevel(level)
        t_err = float(np.linalg.norm(last.pose[:3, 3] - truths[-1][:3, 3]))
        r_err = float(rotation_angle_deg(last.pose, truths[-1]))
        pool = "" if label == "projective" else f" scene_pool={ref._scene_pool_cache}"
        phase("track", f"{label}: {N_TRACK} frames x {N_HYP} hypotheses, roi={ref.roi} "
              f"window={ref.window} max_points={ref.max_points}{pool}: "
              f"step_async_ms_per_frame={a_ms} step_ms_per_frame={s_ms} "
              f"n_rejected={session.n_rejected} final_translation_err_mm={t_err} "
              f"final_rotation_err_deg={r_err} (icosphere: rotation unobservable) "
              f"launches={c} syncs_in_one_step_async={sum(syncs.values())} {dict(syncs)}; "
              f"one frame (profiled before [kernel]): {kernels_line(census[label])}")
        # a frame: the ICP loop through the iteration kernel (one launch
        # against the projective scene, one a pass - 30 iterations and the
        # scoring pass - against the NN scene), the information pass
        # through the row gather
        check(c["rasterize"] > 0 and c["gather_rows"] == N_TRACK
              and c["window_lift"] == N_TRACK
              and c["icp_iterate"] == (1 if label == "projective" else 31) * N_TRACK
              and (label == "projective" or c["nn_flash_gated"] > 0),
              f"track {label}: launches {c}")
        check(np.isfinite(last.pose).all() and t_err < 20.0,
              f"track {label}: final translation error {t_err} mm")
        # the first frame through the kernels against the plain versions;
        # its information pass's row gather (table, indices) is kept for
        # [gather]'s tracked-frame shape
        captured = []

        def capture_gather(table, idx, _gather=G.gather_rows):
            captured.append((table, idx))
            return _gather(table, idx)

        with unittest.mock.patch.object(scene_projective, "gather_rows", capture_gather), \
                unittest.mock.patch.object(scene_nn, "gather_rows", capture_gather):
            k_out = ref.track(frames[0], hyps0, with_covariance=True)
        check(len(captured) == 1, f"track {label}: {len(captured)} row gathers in a frame")
        track_gathers[label] = captured[0]
        p_out = ref.track(frames[0], hyps0, with_covariance=True, _plain=True)
        d_cov = float(((k_out[2].covariance - p_out[2].covariance).abs().amax(dim=(1, 2))
                       / p_out[2].covariance.abs().amax(dim=(1, 2))).max())
        hold_paths("track", f"{label}: first frame through the plain versions", agreement(
            rotation_angle_deg, truths[0], k_out[0].cpu().numpy(), p_out[0].cpu().numpy(),
            k_out[1].fitness.cpu().numpy(), p_out[1].fitness.cpu().numpy()),
            path_failures, extra=f"max_rel_dcov={d_cov} ")
        if label == "projective":
            track_scene = SceneProjective.from_depth(torch.as_tensor(frames[0], device=dev),
                                                     ref._K_t, ref.max_dist_diff, device=dev)
            track_cloud, track_valid = first_pass_clouds(
                ptt, refine_poses, ref, track_scene, torch.as_tensor(hyps0, device=dev))
            # the session's criteria: 30 iterations and the scoring pass
            loop_case("tracking shape, whole loop", track_scene.iterate,
                      functools.partial(track_scene.query, plain=True), track_cloud,
                      track_valid, ptt.ICPConvergenceCriteria(),
                      rows_named(track_scene, track_cloud))
            continue
        # B3 at the tracking shape: the first frame's first-pass queries
        # against the scene the tracker builds from that frame on the card
        pool = ref._scene_pool_cache
        track_scene = SceneNN.from_depth_device(
            torch.as_tensor(frames[0], device=dev), ref._K_t, ref.max_dist_diff,
            perm=ref._scene_perm(frames[0].shape, pool), pool=pool)
        track_q = first_pass_clouds(ptt, refine_poses, ref, track_scene,
                                    torch.as_tensor(hyps0, device=dev))[0].reshape(-1, 3)
        check(track_q.shape == (N_HYP * ref.max_points, 3), f"track queries {track_q.shape}")
        track_b3 = gated_kernel_check(
            torch, NF, "track", f"tracking shape (pool {pool})", track_q, track_scene,
            ref.max_dist_diff, full=NF.nn_flash_packed_cuda(track_q, track_scene.flash_table))

    # 9b. the row gather at the shape a tracked frame launches it: the
    # information pass of the first frame above
    gather_track = gather_phase(torch, G, [
        (f"tracked frame's information pass, {label}", *track_gathers[label])
        for label, _kw in TRACK_CONFIGS])["shapes"]

    # 11. tests/test_tracking.py's drift recipe on the bumpy sphere at 640x480
    rng = np.random.default_rng(7)
    g_truth, g_truths, g_frames = pose2.copy(), [], []
    for _ in range(5):
        d = geometry.euler_to_rotation(rng.uniform(-0.02, 0.02, 3).astype(np.float32)).numpy()
        g_truth = geometry.pose_from_Rt(
            d @ g_truth[:3, :3], g_truth[:3, 3] + rng.uniform(-3, 3, 3).astype(np.float32)).numpy()
        g_truths.append(g_truth)
        g_frames.append(RC.rasterize(bumpy.tris, g_truth[None], WIDTH, HEIGHT, proj,
                                     device="cuda")[0].cpu().numpy())
    for label, scene_kind in (("projective", "projective"), ("nn", "nn_bruteforce")):
        session = ptt.TrackingSession(
            ptt.PoseRefiner(bumpy, K=K, device="cuda", scene=scene_kind, max_points=4096),
            pose2, n_hypotheses=3, seed=1)
        steps = [session.step(f) for f in g_frames]
        accepted = [s.accepted for s in steps]
        r_err = float(rotation_angle_deg(steps[-1].pose, g_truths[-1]))
        t_err = float(np.abs(steps[-1].pose[:3, 3] - g_truths[-1][:3, 3]).max())
        phase("track-golden", f"{label}: bumpy sphere 640x480, 5 frames x 3 hypotheses: "
              f"accepted={accepted} fitness={[round(s.fitness, 4) for s in steps]} "
              f"final rotation error {r_err} deg, translation error {t_err} mm")
        check(all(accepted) and r_err < 1.0 and t_err < 6.0,
              f"track-golden {label}: accepted {accepted}, {r_err} deg, {t_err} mm")

    # 12. stacked scenes: verify_multiscene.py --full's frames, one refine
    # of 256 hypotheses routed to their frames by scene ids on the card
    render = functools.partial(RC.rasterize, width=WIDTH, height=HEIGHT, proj=proj, device=dev)
    ms_mesh, ms_truths, ms_frames, ms_hyps, ms_ids = multiscene_workload(
        geometry, mesh, lambda tris, p: render(tris, torch.as_tensor(p, device=dev)))
    ms_hyps_t = torch.as_tensor(ms_hyps, device=dev)
    ms_ids_t = torch.as_tensor(ms_ids, device=dev)
    ms_rows = ms_truths[ms_ids]
    stacked_stats, ms_launches = {}, {}
    for label, kw in (("multiscene", dict(scene="projective")),
                      ("multiscene-nn", dict(scene="nn_bruteforce", scene_voxel_mm=2.0))):
        ref = ptt.PoseRefiner(ms_mesh, K=K, device="cuda", **kw, **CFG)
        t0 = time.perf_counter()
        ref.set_scene_depths(ms_frames)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        stack = ref.scene
        reset_counts()
        ms_refined, ms_res = ref.refine(ms_hyps_t, crit, scene_ids=ms_ids_t)
        torch.cuda.synchronize()
        c = ms_launches[label] = counts()
        check(c["rasterize"] > 0
              and c["icp_iterate"] == (1 if label == "multiscene" else ITERS + 1)
              and (label == "multiscene" or c["nn_flash_gated_stacked"] > 0),
              f"{label}: launches {c}")
        ms_np = ms_refined.cpu().numpy()
        ms_fit = ms_res.fitness.cpu().numpy()
        check(ms_np.shape == (len(ms_ids), 4, 4) and np.isfinite(ms_np).all(),
              f"{label}: refined poses not finite")
        w_deg, w_mm = worst_errors(rotation_angle_deg, ms_np, ms_rows)
        wall_ms, dev_ms = refine_ms(torch, lambda: ref.refine(ms_hyps_t, crit, scene_ids=ms_ids_t))
        phase(label, f"{MS_FRAMES} frames x {MS_PER_FRAME} hypotheses, one refine, roi={ref.roi} "
              f"window={ref.window} max_points={ref.max_points}, scene build_ms={build_ms}: "
              f"wall_ms={wall_ms} device_ms={dev_ms} poses_per_s={len(ms_ids) / wall_ms * 1e3} "
              f"worst_rotation_err_deg={w_deg} worst_translation_err_mm={w_mm} "
              f"min_fitness={float(ms_fit.min())} launches={c}")
        check(w_deg < 4.0 and w_mm < 4.0 and float(ms_fit.min()) > 0.5,
              f"{label}: verify_multiscene's bar missed ({w_deg} deg, {w_mm} mm, "
              f"fitness {float(ms_fit.min())})")
        rp = functools.partial(
            refine_poses, ref.tris, ms_hyps_t, stack, ref.proj, ref._K_render_t,
            width=ref.render_w, height=ref.render_h, max_points=ref.max_points,
            window=ref.window, stride=ref.stride, roi=ref.roi, scene_ids=ms_ids_t)
        ms_cloud, ms_valid = first_pass_clouds(ptt, refine_poses, ref, stack, ms_hyps_t,
                                               scene_ids=ms_ids_t)
        if label == "multiscene-nn":
            stacked_stats = stacked_nn_kernel_phase(torch, NF, stack, ms_cloud, ms_ids_t)
        else:
            loop_case("stacked projective table, 4 frames, whole loop",
                      stack.iterate_at(ms_ids_t), stack.query_at(ms_ids_t, plain=True), ms_cloud,
                      ms_valid, crit, rows_named(stack, ms_cloud, stack._base(ms_ids_t)),
                      pose_bytes=8)
        # the same refine through the plain versions (raster, NN, gather,
        # the ICP iteration)
        t0 = time.perf_counter()
        p_refined, p_res = rp(criteria=crit, raster=RC.rasterize_plain,
                              lifter=window_lift,
                              query=icp.plain_association(stack.query_at(ms_ids_t, plain=True)))
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t0) * 1e3
        hold_paths(label, "through the plain versions",
                   agreement(rotation_angle_deg, ms_rows, ms_np, p_refined.cpu().numpy(), ms_fit,
                             p_res.fitness.cpu().numpy()),
                   path_failures, extra=f"wall_ms={p_wall} ")
        if label != "multiscene":
            continue
        # every frame's hypotheses refined against that frame alone (a lane
        # of the stack; the same plan and the same batch, so the iteration
        # kernel splits the poses over as many CTAs and sums in the same order)
        lanes = np.empty_like(ms_np)
        lane_fit = np.empty_like(ms_fit)
        for k in range(MS_FRAMES):
            rows = ms_ids == k
            l_ref, l_res = ref.refine(ms_hyps_t, crit, _scene=stack.lane(k))
            lanes[rows] = l_ref.cpu().numpy()[rows]
            lane_fit[rows] = l_res.fitness.cpu().numpy()[rows]
        hold_paths(label, "against per-frame refines",
                   agreement(rotation_angle_deg, ms_rows, ms_np, lanes, ms_fit, lane_fit),
                   path_failures)

    # 13. several meshes in one batch: scripts/demo_multi.py's two models,
    # 256 hypotheses of models [0, 1] * 128 against the bench scene
    mm_ids = np.array([0, 1] * (N_POSES // 2), np.int32)
    reset_counts()
    mm_refined, mm_res = mm_ref.refine(mm_ids, poses, criteria=crit)
    torch.cuda.synchronize()
    mm_launches = counts()
    check(mm_launches["rasterize"] > 0 and mm_launches["icp_iterate"] == 1,
          f"multimodel: launches {mm_launches}")
    mm_np = mm_refined.cpu().numpy()
    mm_fit = mm_res.fitness.cpu().numpy()
    check(np.isfinite(mm_np).all(), "multimodel: refined poses not finite")
    best = int(ptt.PoseRefiner.rank(mm_res)[0])
    best_mm = float(np.linalg.norm(mm_np[best, :3, 3] - truth[:3, 3]))
    wall_ms, dev_ms = refine_ms(torch, lambda: mm_ref.refine(mm_ids, poses, criteria=crit))
    mm_tris, _p, _sq = mm_ref._per_pose_tris(mm_ids, poses)
    phase("multimodel", f"{N_POSES} hypotheses of 2 models (table "
          f"{tuple(mm_tris.table.shape)} read by id), roi={mm_ref.roi}: wall_ms={wall_ms} "
          f"device_ms={dev_ms} "
          f"poses_per_s={N_POSES / wall_ms * 1e3} mean_fitness model 0 "
          f"{float(mm_fit[mm_ids == 0].mean())} model 1 {float(mm_fit[mm_ids == 1].mean())}; "
          f"rank-1 is model {mm_ids[best]} with translation error {best_mm} mm "
          f"(icosphere: rotation unobservable) launches={mm_launches}")
    check(mm_ids[best] == 0 and best_mm < 2.0,
          f"multimodel: rank-1 is model {mm_ids[best]}, {best_mm} mm")
    p_refined, p_res = refine_poses(
        mm_tris, poses, mm_ref.scene, mm_ref.proj, mm_ref._K_render_t, width=mm_ref.render_w,
        height=mm_ref.render_h, max_points=mm_ref.max_points, criteria=crit,
        window=mm_ref.window, stride=mm_ref.stride, roi=mm_ref.roi, raster=RC.rasterize_plain,
        lifter=window_lift,
        query=icp.plain_association(functools.partial(mm_ref.scene.query, plain=True)))
    hold_paths("multimodel", "through the plain versions",
               agreement(rotation_angle_deg, truth, mm_np, p_refined.cpu().numpy(), mm_fit,
                         p_res.fitness.cpu().numpy()), path_failures)
    _, raster_stats["multimodel"] = raster_phase(torch, RC, "multimodel", *shapes["multimodel"],
                                                 old=old)

    # 14. two objects in one stream: MultiObjectSession, one track per frame
    bumpy40 = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    ico30 = mesh.make_icosphere(radius=30.0, subdivisions=3)
    starts = np.stack([pose2, pose2])
    starts[0, :3, 3], starts[1, :3, 3] = [-45.0, 0.0, 300.0], [45.0, 0.0, 300.0]
    rng = np.random.default_rng(13)
    mt_truths, mt_frames, cur = [], [], starts.copy()
    rot, mm = MT_DRIFT
    for _ in range(MT_FRAMES):
        for i in range(2):
            d = geometry.euler_to_rotation(rng.uniform(-rot, rot, 3).astype(np.float32)).numpy()
            cur[i] = geometry.pose_from_Rt(
                d @ cur[i][:3, :3], cur[i][:3, 3] + rng.uniform(-mm, mm, 3).astype(np.float32)
            ).numpy()
        mt_truths.append(cur.copy())
        mt_frames.append(composite(torch, torch.cat([
            render(m.tris, torch.as_tensor(t[None], device=dev))
            for m, t in zip((bumpy40, ico30), cur)])).cpu().numpy())
    mt_ref = ptt.MultiModelRefiner([bumpy40, ico30], K=K, device="cuda", **CFG)

    def multi_session(pipelined=True, seed=13, init_cov=MT_INIT_COV):
        """(ms per frame, [steps of both objects per frame]) of one session."""
        session = ptt.MultiObjectSession(mt_ref, [(0, starts[0]), (1, starts[1])],
                                         n_hypotheses=MT_HYP, seed=seed, init_cov=init_cov)
        t0 = time.perf_counter()
        if pipelined:
            steps = [session.step_async(f) for f in mt_frames][1:] + [session.flush()]
        else:
            steps = [session.step(f) for f in mt_frames]
        return (time.perf_counter() - t0) * 1e3 / MT_FRAMES, steps

    level = pkg_log.level
    pkg_log.setLevel(logging.ERROR)
    try:
        multi_session()  # warm
        reset_counts()
        _ms, mt_steps = multi_session()
        torch.cuda.synchronize()
        mt_launches = counts()
        a_ms = sorted(multi_session()[0] for _ in range(3))[1]
        stepped = [multi_session(pipelined=False) for _ in range(3)]
        s_ms = sorted(ms for ms, _steps in stepped)[1]
        # the same sessions under the filter's default prior (5 deg / 20 mm)
        diffuse = [multi_session(seed=seed, init_cov=None)[1] for seed in range(13, 21)]
        probe = ptt.MultiObjectSession(mt_ref, [(0, starts[0]), (1, starts[1])],
                                       n_hypotheses=MT_HYP, seed=13, init_cov=MT_INIT_COV)
        probe.step_async(mt_frames[0])
        probe.step_async(mt_frames[1])
        syncs = sync_sites(torch, lambda: probe.step_async(mt_frames[2]))
        probe.flush()
    finally:
        pkg_log.setLevel(level)
    accepted = [[s.accepted for s in steps] for steps in mt_steps]

    def lost_mm(session_steps):
        """Per frame, the worse object's translation error (mm)."""
        return [max(float(np.linalg.norm(s.pose[:3, 3] - t[:3, 3])) for s, t in zip(steps, truths))
                for steps, truths in zip(session_steps, mt_truths)]

    def strayed(session_steps):
        """Frames in which an object's winning hypothesis lies more than
        half the objects' distance (45 mm) from its truth: it has locked
        onto the other object."""
        return sum(float(np.linalg.norm(s.refined[s.best][:3, 3] - t[:3, 3])) > 45.0
                   for steps, truths in zip(session_steps, mt_truths)
                   for s, t in zip(steps, truths))

    t_errs, s_errs = lost_mm(mt_steps), lost_mm(stepped[0][1])
    phase("multi-track", f"2 objects x {MT_HYP} hypotheses, {MT_FRAMES} frames, one track per "
          f"frame, roi={mt_ref.roi}: step_async_ms_per_frame={a_ms} step_ms_per_frame={s_ms} "
          f"all_accepted={all(map(all, accepted))} max_translation_err_mm={max(t_errs)} "
          f"final={t_errs[-1]} through_step_max={max(s_errs)} "
          f"(icosphere: rotation unobservable) launches={mt_launches} "
          f"syncs_in_one_step_async={sum(syncs.values())} {dict(syncs)}")
    # not held: under the default prior a hypothesis drawn tens of mm off
    # can settle on the other object with every point an inlier, and the
    # ranking puts fitness before rmse, so it wins whenever no hypothesis on
    # the right object keeps all its points
    phase("multi-track", f"the same sessions under the filter's default prior (5 deg / 20 mm), "
          f"seeds 13-20, step_async: max_translation_err_mm per seed="
          f"{[max(lost_mm(d)) for d in diffuse]} frames won by a hypothesis on the other "
          f"object per seed={[strayed(d) for d in diffuse]}")
    check(mt_launches["rasterize"] > 0 and mt_launches["gather_rows"] == MT_FRAMES
          and mt_launches["icp_iterate"] == MT_FRAMES,
          f"multi-track: launches {mt_launches}")
    stepped_ok = all(s.accepted for steps in stepped[0][1] for s in steps)
    check(all(map(all, accepted)) and stepped_ok and max(t_errs) < 6.0 and max(s_errs) < 6.0
          and strayed(mt_steps) == 0,
          f"multi-track: accepted {accepted} / {stepped_ok}, translation errors {t_errs} "
          f"(step_async), {s_errs} (step)")
    check(sum(syncs.values()) == 0, f"multi-track: synchronizing calls in step_async {dict(syncs)}")
    # the first frame's hypotheses through the kernels and the plain versions
    mt_hyps, mt_ids = [], []
    for i in range(2):
        tracker = ptt.PoseTracker(starts[i], init_cov=MT_INIT_COV)
        tracker.predict()
        mt_hyps.append(tracker.hypotheses(MT_HYP, seed=np.random.default_rng(i)))
        mt_ids += [i] * MT_HYP
    mt_hyps, mt_ids = np.concatenate(mt_hyps), np.asarray(mt_ids, np.int32)
    k_out = mt_ref.track(mt_frames[0], mt_ids, mt_hyps, with_covariance=True)
    p_out = mt_ref.track(mt_frames[0], mt_ids, mt_hyps, with_covariance=True, _plain=True)
    hold_paths("multi-track", "first frame through the plain versions", agreement(
        rotation_angle_deg, mt_truths[0][mt_ids], k_out[0].cpu().numpy(), p_out[0].cpu().numpy(),
        k_out[1].fitness.cpu().numpy(), p_out[1].fitness.cpu().numpy()), path_failures)

    # 15. the ICP iteration kernel against its plain version; its sinf /
    # cosf against torch's at the solve's angles of the slice's first pass
    t0 = time.perf_counter()
    st0, v0, _nt = icp._icp_start(slice_cloud, slice_valid)
    AtA0, Atb0, _c, _m = IR.unpack_sums(IR.assoc_reduce_plain(st0.cloud, v0, sc_plain))
    angles = IR.solve_damped_plain(AtA0, Atb0)[:, :3].reshape(-1)
    wide = torch.linspace(-40.0, 40.0, 1 << 20, device=dev)
    trig_same = []
    for xs in (angles.contiguous(), wide):
        s_k, c_k = IR.sin_cos_cuda(xs)
        trig_same.append(torch.equal(s_k, torch.sin(xs)) and torch.equal(c_k, torch.cos(xs)))
    phase("icp-iterate", f"the tail's sinf / cosf against torch.sin / torch.cos on the card: "
          f"{angles.numel()} solve angles of the slice's first pass (|x| <= "
          f"{float(angles.abs().max())}) equal={trig_same[0]}; {wide.numel()} angles in "
          f"[-40, 40] equal={trig_same[1]}")
    check(all(trig_same), "icp-iterate: the kernel's sinf / cosf differ from torch's")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    probe_tail = (icp_tail, probe_lib.result(), sms)
    iterate_stats = icp_iterate_phase(torch, IR, icp, iterate_cases, probe_tail)
    phase("icp-iterate", f"phase seconds={time.perf_counter() - t0}")

    # 17. [coarse] the serving ceiling (bench.py:305-327): the bench
    # refiner with the coarse-to-fine point schedule, 4 x refine_async of
    # bench.py's 512 hypotheses (its 256 twice) in flight, one fence
    t0 = time.perf_counter()
    coarse_ref = ptt.PoseRefiner(model, K=K, device="cuda", coarse_iters=COARSE[0],
                                 coarse_stride=COARSE[1], **CFG)
    coarse_ref.set_scene_depth(scene)
    poses512_np = np.concatenate([poses_np, poses_np])
    poses512 = torch.as_tensor(poses512_np, device=dev)
    reset_counts()
    c_refined, c_res = coarse_ref.refine(poses512, crit)
    torch.cuda.synchronize()
    coarse_counts = counts()
    check(coarse_counts["icp_iterate"] == 2 and coarse_counts["rasterize"] == 1,
          f"coarse: not one render and two iteration launches a refine: {coarse_counts}")
    c_np, c_fit = c_refined.cpu().numpy(), c_res.fitness.cpu().numpy()
    check(np.isfinite(c_np).all() and float(c_fit.mean()) > 0.9,
          f"coarse: poses not finite or mean fitness {float(c_fit.mean())}")
    c_mm = np.linalg.norm(c_np[:, :3, 3] - truth[:3, 3], axis=-1)
    # rounds of 4 in flight, the schedule's refiner and [slice]'s (no
    # schedule) in turns, after a warm round of each
    walls, dev_ms, u_walls = [], [], []
    for ref_ in (coarse_ref, refiner):
        ptt.fence(*[ref_.refine_async(poses512, crit) for _ in range(4)])
    for _ in range(7):
        for ref_, out_ in ((coarse_ref, walls), (refiner, u_walls)):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            a.record()
            done_ = ptt.fence(*[ref_.refine_async(poses512, crit) for _ in range(4)])
            b.record()
            torch.cuda.synchronize()
            out_.append((time.perf_counter() - t1) * 1e3 / 4)
            if ref_ is coarse_ref:
                done = done_
                dev_ms.append(a.elapsed_time(b) / 4)
    check(len(done) == 4 and all(torch.equal(d[0], c_refined) for d in done),
          "coarse: a fenced batch differs from the synchronous refine")
    s_wall, s_dev = float(np.median(walls)), float(np.median(dev_ms))
    s_busy = busy_line(census["coarse"], 4 * s_wall)
    phase("coarse", f"serving ceiling: 4 x refine_async(512) then fence, coarse_iters="
          f"{COARSE[0]}, coarse_stride={COARSE[1]}, {ITERS} iterations: wall_ms_per_batch median="
          f"{s_wall} (min {min(walls)}, max {max(walls)}) device_ms_per_batch={s_dev} "
          f"poses_per_s={512 / s_wall * 1e3} translation_err_mm median={float(np.median(c_mm))} "
          f"mean_fitness={float(c_fit.mean())} launches_per_refine={coarse_counts}; one round of "
          f"4: {s_busy}; the same rounds without the schedule ([slice]'s refiner, in turns): "
          f"wall_ms_per_batch median={float(np.median(u_walls))} (min {min(u_walls)}, max "
          f"{max(u_walls)}) poses_per_s={512 / float(np.median(u_walls)) * 1e3}")
    # the same batch without the schedule ([slice]'s refiner): verdict flips
    u_refined, u_res = refiner.refine(poses512, crit)
    u_np = u_refined.cpu().numpy()
    u_mm = np.linalg.norm(u_np[:, :3, 3] - truth[:3, 3], axis=-1)
    flips_t = float(((c_mm < 2.0) != (u_mm < 2.0)).mean())
    flips_r = float(((rotation_angle_deg(c_np, truth) < VERDICT_DEG)
                     != (rotation_angle_deg(u_np, truth) < VERDICT_DEG)).mean())
    st = agreement(rotation_angle_deg, truth, c_np, u_np, c_fit, u_res.fitness.cpu().numpy())
    phase("coarse", f"against the same 512 refined without the schedule (printed, not held; "
          f"bench.py expects ~4-5% of borderline verdicts to flip): verdict flips "
          f"{1 - st['agree']} "
          f"(translation < 2 mm: {flips_t}, rotation < {VERDICT_DEG} deg: {flips_r}) "
          f"(median, max) drot_deg={st['rot']} dt_mm={st['t']} dfit={st['fit']}")
    # the kernel path against the plain path, whole refine
    t1 = time.perf_counter()
    cp_refined, cp_res = refine_poses(
        coarse_ref.tris, poses512, coarse_ref.scene, coarse_ref.proj, coarse_ref._K_render_t,
        width=coarse_ref.render_w, height=coarse_ref.render_h,
        max_points=coarse_ref.max_points, criteria=crit, window=coarse_ref.window,
        stride=coarse_ref.stride, roi=coarse_ref.roi, coarse_iters=COARSE[0],
        coarse_stride=COARSE[1], raster=RC.rasterize_plain,
        lifter=window_lift,
        query=icp.plain_association(functools.partial(coarse_ref.scene.query, plain=True)))
    torch.cuda.synchronize()
    hold_paths("coarse", "serving refine through the plain versions", agreement(
        rotation_angle_deg, truth, c_np, cp_refined.cpu().numpy(), c_fit,
        cp_res.fitness.cpu().numpy()), path_failures,
        extra=f"wall_ms={(time.perf_counter() - t1) * 1e3} ")
    # the coarse launch alone: 512 x 2,048 (coarse rows 512), projective,
    # and one coarse iteration on K1's output for the strided 2 mm queries
    c_cloud, c_valid = first_pass_clouds(ptt, refine_poses, coarse_ref, coarse_ref.scene,
                                         poses512)
    csc = coarse_ref.scene
    c_front = dict(table=csc.table, K=csc.K, gate=csc.max_dist_diff, height=csc.height,
                   width=csc.width)
    c_anchor, c_v, _nt = icp._icp_start(c_cloud, c_valid)
    coarse_stats = {"serving, 512 x 2,048, projective": coarse_launch_phase(torch, IR, icp, dict(
        label="serving shape, 512 x 2,048, projective", cloud=c_cloud, valid=c_valid,
        crit=crit, iters=COARSE[0], stride=COARSE[1], front=c_front,
        plain_query=functools.partial(csc.query, plain=True),
        rows=rows_named(csc, IR.coarse_start(c_anchor, c_v, COARSE[1])[0].cloud),
        point_bytes=0, instr=11 + body_instr((0.0, False))), probe_tail)}
    kd_cstate, kd_cvalid = IR.coarse_start(*icp._icp_start(nn_cloud, nn_valid)[:2], COARSE[1])
    kd_near = kd2._nearest(kd_cstate.cloud)
    coarse_stats["kd-2mm, 256 x 2,048, one iteration"] = coarse_launch_phase(torch, IR, icp, dict(
        label="kd-2mm, 256 x 2,048 (K1 on the strided copy), one coarse iteration",
        cloud=nn_cloud, valid=nn_valid, crit=crit, iters=1, stride=COARSE[1],
        front=dict(table=kd2.table, idx=kd_near[0], dist_sq=kd_near[1],
                   gate_sq=NF.gate_sq(kd2.max_dist_diff)),
        plain_query=lambda q: _rows_in_gate(kd2.table, *kd_near, kd2.max_dist_diff, plain=True),
        rows=int(kd_near[0].clamp(0, kd2.table.shape[0] - 1).unique().numel()),
        point_bytes=8, instr=1 + body_instr((0.0, False)), nearest=kd_near), probe_tail)
    # a scene="nn" coarse refine: K1 on the strided copy, one coarse launch a
    # coarse pass, then the fine passes
    kd_ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn", scene_voxel_mm=2.0,
                             coarse_iters=COARSE[0], coarse_stride=COARSE[1], **CFG)
    kd_ref.set_scene_depth(scene)
    reset_counts()
    kc_refined, kc_res = kd_ref.refine(poses, crit)
    torch.cuda.synchronize()
    kd_coarse_counts = counts()
    check(kd_coarse_counts["nn_kdtree"] == ITERS + 1
          and kd_coarse_counts["icp_iterate"] == ITERS + 1,
          f"coarse: scene='nn' launches {kd_coarse_counts}")
    kc_wall, kc_dev = refine_ms(torch, lambda: kd_ref.refine(poses, crit))
    kp_refined, kp_res = refine_poses(
        kd_ref.tris, poses, kd_ref.scene, kd_ref.proj, kd_ref._K_render_t, width=kd_ref.render_w,
        height=kd_ref.render_h, max_points=kd_ref.max_points, criteria=crit,
        window=kd_ref.window, stride=kd_ref.stride, roi=kd_ref.roi, coarse_iters=COARSE[0],
        coarse_stride=COARSE[1],
        lifter=window_lift,
        query=icp.plain_association(functools.partial(kd_ref.scene.query, plain=True)))
    hold_paths("coarse", "scene='nn' 2 mm coarse refine (256) through the plain versions",
               agreement(rotation_angle_deg, truth, kc_refined.cpu().numpy(),
                         kp_refined.cpu().numpy(), kc_res.fitness.cpu().numpy(),
                         kp_res.fitness.cpu().numpy()), path_failures,
               extra=f"wall_ms={kc_wall} device_ms={kc_dev} launches={kd_coarse_counts} ")
    phase("coarse", f"phase seconds={time.perf_counter() - t0}")

    # 18. [schedule] tests/test_pipeline.py:104-126's three levels, from its
    # 25 deg / 40 mm start (row 0) and the bench hypotheses, projective and
    # scene="nn" on the 2 mm cloud; each level's scene carries its gate
    t0 = time.perf_counter()
    sched_starts = torch.as_tensor(schedule_starts(geometry, truth, poses_np), device=dev)
    schedule_stats = {}
    from pose_refine_tpu_torch import pipeline as PL

    for label, kw in SCHEDULE_CONFIGS:
        s_ref = ptt.PoseRefiner(model, K=K, device="cuda", **kw, **CFG)
        s_ref.set_scene_depth(scene)
        gates, level_counts = [], []
        inner = PL.refine_poses

        def recording(tris, init, s_scene, *args, **kwargs):
            out = inner(tris, init, s_scene, *args, **kwargs)
            torch.cuda.synchronize()
            gates.append(float(s_scene.max_dist_diff))
            level_counts.append(counts())
            reset_counts()
            return out

        PL.refine_poses = recording
        try:
            reset_counts()
            s_poses, s_res = s_ref.refine(sched_starts, crit, schedule=SCHEDULE)
        finally:
            PL.refine_poses = inner
        want_gates = [float(np.float32(g)) for g, _ in SCHEDULE]
        check(gates == want_gates, f"schedule {label}: level gates {gates}, not {want_gates}")
        per_pass = "nn_kdtree" if "nn" in label else None
        for (g, iters), lc in zip(SCHEDULE, level_counts):
            want = iters + 1 if per_pass else 1
            check(lc["rasterize"] == 1 and lc["icp_iterate"] == want
                  and (per_pass is None or lc[per_pass] == iters + 1),
                  f"schedule {label}: level {g} launches {lc}")
        s_np, s_fit = s_poses.cpu().numpy(), s_res.fitness.cpu().numpy()
        single, _res1 = s_ref.refine(sched_starts, crit)
        s_mm = np.linalg.norm(s_np[:, :3, 3] - truth[:3, 3], axis=-1)
        one_mm = np.linalg.norm(single.cpu().numpy()[:, :3, 3] - truth[:3, 3], axis=-1)
        wall_ms, dev_ms = refine_ms(torch, lambda: s_ref.refine(sched_starts, crit,
                                                                schedule=SCHEDULE))
        s_busy = busy_line(census[f"schedule {label}"], wall_ms)
        phase("schedule", f"{label}: {N_POSES} starts (row 0 tests/test_pipeline.py:111's 25 "
              f"deg / 40 mm), schedule {SCHEDULE}: wall_ms={wall_ms} device_ms={dev_ms} "
              f"level gates {gates} launches per level {level_counts}; translation_err_mm "
              f"median={float(np.median(s_mm))} (one level {float(np.median(one_mm))}), the far "
              f"start {float(s_mm[0])} mm (one level {float(one_mm[0])}) "
              f"mean_fitness={float(s_fit.mean())}; {s_busy}")
        check(np.isfinite(s_np).all() and float(s_fit.mean()) > 0.9,
              f"schedule {label}: poses not finite or mean fitness {float(s_fit.mean())}")
        # the plain path: each level through the plain raster and the plain
        # association against the same gated scene
        p_poses = sched_starts
        t1 = time.perf_counter()
        for g, iters in SCHEDULE:
            g_scene = PL._scene_with_gate(s_ref.scene, g)
            p_poses, p_res = refine_poses(
                s_ref.tris, p_poses, g_scene, s_ref.proj, s_ref._K_render_t,
                width=s_ref.render_w, height=s_ref.render_h, max_points=s_ref.max_points,
                criteria=ptt.ICPConvergenceCriteria(crit.relative_fitness, crit.relative_rmse,
                                                    iters),
                window=s_ref.window, stride=s_ref.stride, roi=s_ref.roi, raster=RC.rasterize_plain,
                lifter=window_lift,
                query=icp.plain_association(functools.partial(g_scene.query, plain=True)))
        torch.cuda.synchronize()
        hold_paths("schedule", f"{label} through the plain versions", agreement(
            rotation_angle_deg, truth, s_np, p_poses.cpu().numpy(), s_fit,
            p_res.fitness.cpu().numpy()), path_failures,
            extra=f"wall_ms={(time.perf_counter() - t1) * 1e3} ")
        schedule_stats[label] = dict(wall_ms=wall_ms, device_ms=dev_ms, launches=level_counts)
    phase("schedule", f"phase seconds={time.perf_counter() - t0}")

    # 19. [compact] the slice-bench-256 refine with lift="compact" at full
    # resolution, 32,768 points: every valid render pixel in scan order
    t0 = time.perf_counter()
    cm_ref = ptt.PoseRefiner(model, K=K, device="cuda", **COMPACT_KW)
    cm_ref.set_scene_depth(scene)
    reset_counts()
    cm_refined, cm_res = cm_ref.refine(poses, crit)
    torch.cuda.synchronize()
    cm_counts = counts()
    check(cm_counts["rasterize"] == 1 and cm_counts["icp_iterate"] == 1,
          f"compact: launches {cm_counts}")
    cm_np, cm_fit = cm_refined.cpu().numpy(), cm_res.fitness.cpu().numpy()
    cm_mm = np.linalg.norm(cm_np[:, :3, 3] - truth[:3, 3], axis=-1)
    cm_wall, cm_dev = refine_ms(torch, lambda: cm_ref.refine(poses, crit))
    cm_busy = busy_line(census["compact"], cm_wall)
    cm_depth = RC.rasterize(cm_ref.tris, poses, cm_ref.render_w, cm_ref.render_h, cm_ref.proj,
                            roi=cm_ref.roi)
    from pose_refine_tpu_torch.ops.depth_to_cloud import compact_points, depth_image_to_points

    pts_img, mask_img = depth_image_to_points(cm_depth, cm_ref._K_render_t, tl_x=cm_ref.roi[0],
                                              tl_y=cm_ref.roi[1])
    on_card = compact_points(pts_img, mask_img, cm_ref.max_points)
    on_cpu = compact_points(pts_img.cpu(), mask_img.cpu(), cm_ref.max_points)
    cm_same = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    cp_ms, _ = median_ms(torch, lambda: compact_points(pts_img, mask_img, cm_ref.max_points), 20)
    phase("compact", f"lift='compact', render_scale 1, roi={cm_ref.roi}, max_points="
          f"{cm_ref.max_points}: {N_POSES} poses, n_points median="
          f"{float(cm_res.n_points.median())} max={float(cm_res.n_points.max())}: wall_ms="
          f"{cm_wall} device_ms={cm_dev} poses_per_s={N_POSES / cm_wall * 1e3} "
          f"translation_err_mm median={float(np.median(cm_mm))} mean_fitness="
          f"{float(cm_fit.mean())} launches={cm_counts}; compact_points on the card == on the "
          f"CPU bit for bit: {cm_same} (card ms {cp_ms}); {cm_busy}")
    check(cm_same, "compact: compact_points on the card differs from the CPU's")
    check(np.isfinite(cm_np).all() and float(cm_fit.mean()) > 0.9,
          f"compact: poses not finite or mean fitness {float(cm_fit.mean())}")
    phase("compact", f"phase seconds={time.perf_counter() - t0}")

    # 20. [renderer] PoseRenderer at bench.py:181-183's renders: 256 and 100
    # copies of the truth at 640x480, 100 in the ROI, full size and
    # down_sample 2, against the plain raster of the truth + the converters
    t0 = time.perf_counter()
    renderer = ptt.PoseRenderer(model, K=K, device="cuda")
    renderer_stats = {}
    from pose_refine_tpu_torch.ops import convert

    for label, n_r, ds, roi in RENDER_CELLS:
        r_poses = torch.as_tensor(np.tile(truth, (n_r, 1, 1)), device=dev)
        reset_counts()
        r_depth, r_mask = renderer.render_depth_mask(r_poses, ds, roi)
        torch.cuda.synchronize()
        r_counts = counts()
        w_r, h_r = int(WIDTH / ds), int(HEIGHT / ds)
        plain = RC.rasterize_plain(renderer.tris, r_poses[:1], w_r, h_r, renderer.proj_mat,
                                   roi=roi)
        p_depth, p_mask = convert.raw_to_depth_mask(plain)
        mism = max(float((r_depth.to(torch.int32) != p_depth.to(torch.int32)).float().mean()),
                   float((r_mask != p_mask).float().mean()))
        r_wall, r_dev = refine_ms(torch, lambda: renderer.render_depth_mask(r_poses, ds, roi))
        r_busy = busy_line(census[f"renderer {label}"], r_wall)
        renderer_stats[label] = dict(wall_ms=r_wall, device_ms=r_dev, mismatch=mism,
                                     renders_per_s=n_r / r_wall * 1e3)
        phase("renderer", f"{label}: PoseRenderer.render_depth_mask of {n_r} poses, out "
              f"{tuple(r_depth.shape[1:])} {r_depth.dtype} / {r_mask.dtype}: mismatch against "
              f"rasterize_plain + convert={mism} covered_px={int((p_mask > 0).sum())} "
              f"wall_ms={r_wall} device_ms={r_dev} renders_per_s={n_r / r_wall * 1e3} "
              f"launches={r_counts}; {r_busy}")
        check(mism < MISMATCH_GATE and int((p_mask > 0).sum()) > 0,
              f"renderer {label}: mismatch {mism}")
        check(r_counts["rasterize"] == 1, f"renderer {label}: launches {r_counts}")
    phase("renderer", f"phase seconds={time.perf_counter() - t0}")

    # 16. P1 on its probe: scripts/probe_mxu_nn.py's workload at full size,
    # then the kernel alone beside B2 alone (in turns), its prologue alone
    # and the tie lattice
    t0 = time.perf_counter()
    reset_counts()
    mxu = mxu_nn.run(device=dev)
    phase("mxu", " ".join(f"{k}={v}" for k, v in mxu.items()))
    check(mxu["launches"]["nn_flash_mxu"] > 0 and mxu["launches"]["nn_flash_packed"] > 0,
          f"mxu: launches {mxu['launches']}")
    check(mxu["vs_b2"]["equal"] and mxu["vs_plain"]["equal"] and mxu["stats_build_equal"],
          f"mxu: P1 is not B2 bit for bit: against B2 {mxu['vs_b2']}, against its plain "
          f"version {mxu['vs_plain']}, instrumented build equal {mxu['stats_build_equal']}")
    mxu_obj, mxu_q = mxu_nn.workload(device=dev)
    mxu_b2_t = NF.pack_scene(mxu_obj).to(dev)
    mxu_t = NM.pack_scene_mxu(mxu_obj).to(dev)
    mxu_alone = {"b2": [], "p1": []}
    for name in ("b2", "p1", "p1", "b2"):
        fn = ((lambda: NF.nn_flash_packed_cuda(mxu_q, mxu_b2_t)) if name == "b2"
              else (lambda: NM.nn_flash_mxu_cuda(mxu_q, mxu_t)))
        mxu_alone[name].append(alone_ms(torch, fn, launches=10, rounds=3))
    prologue_ms = alone_ms(torch, lambda: NM.split_scene_cuda(mxu_t))
    lat_pts, lat_q = mxu_nn.tie_lattice(16, 30000, seed=5)
    lat_q = torch.as_tensor(lat_q, device=dev)
    lat_t = NM.pack_scene_mxu(lat_pts).to(dev)
    li, ld = NM.nn_flash_mxu_cuda(lat_q, lat_t)
    lat = {"vs_b2": mxu_nn.compare(li, ld, *NF.nn_flash_packed_cuda(
               lat_q, NF.pack_scene(lat_pts).to(dev))),
           "vs_plain": mxu_nn.compare(li, ld, *NM.nn_flash_mxu_plain(lat_q, lat_t))}
    mxu_pairs = float(mxu["queries"]) * mxu["table_columns"]
    # the least argmin work a pair needs on the CUDA cores: one min of the
    # score and one compare to find the rare pairs that improve it, against
    # the 3xTF32 product's 3 x 4 useful MACs a pair on the tensor cores
    mxu_bound = bound(n_instr=2 * mxu_pairs, n_tensor_flop=24 * mxu_pairs)
    p1_alone, b2_alone = float(np.median(mxu_alone["p1"])), float(np.median(mxu_alone["b2"]))
    phase("mxu", f"alone ms (turns B2, P1, P1, B2): P1 {mxu_alone['p1']} B2 {mxu_alone['b2']} "
          f"P1 / B2 {p1_alone / b2_alone} prologue_alone_ms={prologue_ms} "
          f"bound_ms={mxu_bound['bound_ms']} ({mxu_bound['bound_by']}) share_of_bound="
          f"{mxu_bound['bound_ms'] / p1_alone} eps_q = {NM.EPS_C} M_q, re-scored pairs a query "
          f"mean {mxu['rescored_mean']} max {mxu['rescored_max']}, largest |screen - B2| / "
          f"eps_q {mxu['screen_err_over_eps_max']}; tie lattice {tuple(lat_pts.shape)} points x "
          f"{lat_q.shape[0]} queries: {lat}; phase seconds={time.perf_counter() - t0}")
    check(lat["vs_b2"]["equal"] and lat["vs_plain"]["equal"],
          f"mxu: P1 is not B2 bit for bit on the tie lattice: {lat}")

    # 21-23. the native kd builder and the reference baseline, save / load
    # on the card, the pose batch split over devices
    c = types.SimpleNamespace(**locals(), sync=torch.cuda.synchronize, two=["cuda:0", "cuda:0"])
    native_phase(c)
    serialize_phase(c)
    sharded_phase(c)
    scatter = jax_names_phase(c)

    check(not path_failures, "; ".join(path_failures))
    print(card_line)
    max_err = max(s["max_abs_err"] for s in raster_stats.values())
    nn_sources = dict(route="cuda", source="pose_refine_tpu_torch/csrc/nn_flash.cu",
                      library_ms=None)
    print(json.dumps({"kernels": [{
        "name": "rasterize",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/rasterize.cu",
        "replaces": "pose_refine_tpu/ops/rasterize_pallas.py:282",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": hyp_stats["ms"],
        "alone_ms": hyp_stats["alone_ms"],
        "plain_ms": hyp_stats["plain_ms"],
        "bound_ms": hyp_stats["bound_ms"],
        "bound_by": hyp_stats["bound_by"],
        "library_ms": None,
        "launches_multimodel": mm_launches["rasterize"],
        # [jax-names]' use_pallas=False: JAX's scatter raster in B1's place
        # (plain PyTorch, 0 B1 launches)
        "use_pallas_false": scatter,
        # the render-only path: PoseRenderer ([renderer]), one launch a call
        "renderer": renderer_stats,
        # every [kernel] shape: alone, with the wrapper, the old path (setup
        # + coefficient-table kernel) alone when its source was given, the
        # bound of the function
        "shapes": {name: {k: st[k] for k in ("alone_ms", "ms", "old_alone_ms",
                                             "old_setup_alone_ms", "bound_ms", "bound_by")}
                   for name, st in raster_stats.items()},
    }, {
        "name": "window_lift",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/lift.cu",
        # XLA code, not a Pallas kernel: window_cloud_batched, compact_topk
        # and morton_key as the JAX pipeline composes them
        "replaces": "pose_refine_tpu/ops/depth_to_cloud.py:101,198 + "
                    "pose_refine_tpu/pipeline.py:111-146",
        "launches": slice_counts["window_lift"],
        "launches_track": track_counts["projective"]["window_lift"],
        "launches_track_nn": track_counts["nn"]["window_lift"],
        "max_abs_err": max(st["max_abs_err"] for st in lift_stats.values()),
        **{k: lift_stats["bench, projective"][k]
           for k in ("ms", "alone_ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")},
        "library_ms": None,
        "library": "none: no one PyTorch call computes the crop, the selection and the order",
        # every [lift] case: bit for bit; the timed ones alone, with the
        # wrapper, plain, the bound
        "cases": {key: {k: st[k] for k in ("equal_bits", "rows", "valid_rows", "alone_ms", "ms",
                                           "plain_ms", "bound_ms", "bound_by", "share_of_bound")
                        if k in st}
                  for key, st in lift_stats.items()},
    }, {
        "name": "scene_table",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/scene_table.cu",
        # XLA code, not a Pallas kernel: dep2pcd, the LINEMOD normals and
        # the zero pad as the JAX scene composes them
        "replaces": "pose_refine_tpu/scene/projective.py:26",
        # a set_scene_depth, set_scene_depths, a tracked frame, two session
        # steps; one projective tracked session of [track]
        "launches": scene_table_stats["launches"],
        "launches_track": track_counts["projective"]["scene_table"],
        "cases_bit_for_bit": scene_table_stats["cases"],
        **{k: scene_table_stats["timed"]["frame"][k]
           for k in ("ms", "alone_ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")},
        "library_ms": None,
        "library": "none: no one PyTorch call computes the points and the LINEMOD normals",
        "timed": scene_table_stats["timed"],
    }, {
        "name": "nn_flash_packed", **nn_sources,
        "replaces": "pose_refine_tpu/scene/nn_pallas.py:101",
        "launches": nn_launches["nn_flash_packed"], **nn_stats["nn_flash_packed"],
    }, {
        "name": "nn_flash_gated", **nn_sources,
        "replaces": "pose_refine_tpu/scene/nn_pallas.py:326",
        "launches": nn_launches["nn_flash_gated"], **nn_stats["nn_flash_gated"],
        "launches_stacked": ms_launches["multiscene-nn"]["nn_flash_gated_stacked"],
        **stacked_stats,
        "launches_track": track_counts["nn"]["nn_flash_gated"],
        "track_ms": track_b3["ms"], "track_bound_ms": track_b3["bound_ms"],
        "track_chunks_skipped": track_b3["chunks_skipped"],
    }, {
        "name": "gather_rows",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/gather.cu",
        "replaces": "scripts/probe_pallas_gather.py:29",
        # the information pass of every tracked frame; the ICP passes
        # look their rows up inside icp_iterate
        "launches": track_counts["projective"]["gather_rows"],
        **gather_stats,
        # the tracked frame's information pass: the shape the main path
        # launches (1 a frame)
        "track": gather_track,
    }, {
        "name": "icp_iterate",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/icp_reduce.cu",
        # the port's own kernel: a whole ICP iteration - the row gather
        # fused with the packed reduction of pose_refine_tpu/icp.py:215,
        # then the solve, twist, move and latch of JAX
        # pose_refine_tpu/icp.py:398-428 (XLA code) - a refine's whole loop
        # in one launch against a projective scene
        "replaces": "pose_refine_tpu/icp.py:398",
        "launches": slice_counts["icp_iterate"],
        "max_abs_err": max(st["max_abs_err"] for st in iterate_stats.values()),
        **{k: iterate_stats["slice shape, whole loop"][k]
           for k in ("ms", "alone_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "share_of_bound", "pose_iterations")},
        "launches_track": track_counts["projective"]["icp_iterate"],
        "launches_track_nn": track_counts["nn"]["icp_iterate"],
        "launches_nn": nn_launches["icp_iterate"],
        "launches_stacked": ms_launches["multiscene"]["icp_iterate"],
        "launches_multimodel": mm_launches["icp_iterate"],
        "launches_kd": kd_slice["2mm"]["launches"]["icp_iterate"],
        # the coarse mode (the point schedule): launches of the iteration
        # kernel on each path (the serving refine: the coarse launch and the
        # fine one; scene="nn": one a pass), and the coarse launch alone,
        # with the wrapper, plain, bound and share
        "coarse": {
            "launches_serving": coarse_counts["icp_iterate"],
            "launches_kd": kd_coarse_counts["icp_iterate"],
            "launches_schedule": {label: [lc["icp_iterate"] for lc in st["launches"]]
                                  for label, st in schedule_stats.items()},
            "launches_compact": cm_counts["icp_iterate"],
            "cases": {label: {k: st[k] for k in ("alone_ms", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "share_of_bound", "launches",
                                                 "pose_iterations", "max_abs_err") + RESIDENCY
                                if k in st}
                      for label, st in coarse_stats.items()},
        },
        # every timed case: alone, with the wrapper, the bound, the tail
        # alone and the residency
        "cases": {label: {k: st[k] for k in ("alone_ms", "ms", "first_ms", "score_only_alone_ms",
                                             "bound_ms", "bound_by",
                                             "share_of_bound") + RESIDENCY if k in st}
                  for label, st in iterate_stats.items() if "alone_ms" in st},
    }, {
        "name": "nn_kdtree",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/nn_kdtree.cu",
        # XLA code, not a Pallas kernel: the JAX package's kd traversal
        "replaces": "pose_refine_tpu/scene/nn.py:638",
        # the main path: a scene="nn" refine ([kd-slice])
        "launches": kd_slice["2mm"]["launches"]["nn_kdtree"],
        "launches_raw": kd_slice["raw"]["launches"]["nn_kdtree"],
        **kd_stats,
        "library_ms": None,
        "library": "none: no PyTorch call computes a nearest neighbour by a tree walk "
                   "(torch.cdist + argmin is a dense scan, B2's function)",
    }, {
        "name": "nn_flash_mxu",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/nn_mxu.cu",
        "replaces": "scripts/probe_mxu_nn.py:57",
        "launches": mxu["launches"]["nn_flash_mxu"],
        "max_abs_err": mxu["max_abs_err"],
        "ms": mxu["p1_ms"],
        "alone_ms": p1_alone,
        "plain_ms": mxu["p1_plain_ms"],
        **mxu_bound,
        "library_ms": None,
        "library": "none: no PyTorch call computes B2's argmin (torch.cdist + argmin rounds "
                   "otherwise)",
        "b2_alone_ms": b2_alone,
        "prologue_alone_ms": prologue_ms,
        "eps_c": NM.EPS_C,
        "rescored_mean": mxu["rescored_mean"],
        "rescored_max": mxu["rescored_max"],
        "screen_err_over_eps_max": mxu["screen_err_over_eps_max"],
        "equal_to_b2": mxu["vs_b2"]["equal"] and lat["vs_b2"]["equal"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(census_main() if sys.argv[1:] == ["--census"]
             else scene_table_main() if sys.argv[1:] == ["--scene-table"] else main())
