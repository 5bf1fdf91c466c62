#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (pose_refine_tpu_torch) once on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases, one line each; any failure exits
non-zero without printing a result:

  1. card   - torch.cuda.is_available(), and nvidia-smi's name and power limit
  2. build  - nvcc builds csrc/*.cu for sm_90a from the checkout (timed)
  3. kernel - the raster kernel against its plain PyTorch version on the card
              at the slice's shapes: the observed-scene render (1 pose,
              640x480), the 256 hypothesis renders (320x240 in the auto ROI),
              and the same batch as a per-pose (N, T, 3, 3) table. Mismatch
              fraction must stay below 1e-4; median times of both, and the
              kernel alone (see alone_ms).
  4. slice  - PoseRefiner.set_scene_depth + refine on the bench workload
              (256 hypotheses +-10 deg/axis +-20 mm around the reference
              viewpoint, render_scale 2, decimate 4 mm, window 128 / stride 2,
              2048 points, 24 ICP iterations) through the kernels; the launch
              counters of the raster and of the fused ICP pass must rise.
              Wall and device time, poses/s. The same refine through the
              plain raster must agree; so must the one through the plain
              query and the fused pass's plain version (hold_paths). The loop
              of before the fused pass (own query=, matrix products) is
              printed beside it, verdicts held (report_old_loop).
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
  9. gather - the association's row-gather kernel against its plain
              version at three shapes: the bench projective scene (307,200
              rows) at the 524,288 first-pass pixels, the raw NN scene
              (29,440 rows) and the device-built 640x480 NN scene (307,200
              rows) at the 524,288 first-pass neighbours. Bit for bit;
              median times of both, and the kernel alone.
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
kernel, the fused ICP pass's among them) by hold_paths(): 100% verdict
agreement and every pose within 0.1 deg, 0.2 mm and 5e-3 of fitness. Misses
are collected and fail the run at its end.
 15. assoc-reduce - the fused association + reduction kernel of an ICP pass
              (ops/icp_reduce.py) against its plain version at the slice
              shape (256 x 2,048 against the 307,200-row table), the tracking
              shape (16 x 2,048), a stacked projective table with a row
              offset per pose (4 frames), the indexed front end on the gated
              flash-NN kernel's output for the 2 mm and raw bench clouds and
              a stacked NN table, and edge inputs (a pose with no valid
              point, points at z = 0, behind the camera and NaN, border
              pixels, a gate that rejects everything): every sum equal to
              the plain version's bit for bit (so the count exactly), each
              float sum within 2e-6 x the sum of its absolute terms of its
              float64 value, two launches bit for bit. Times with the
              wrapper and alone.
 16. mxu    - P1 on its probe (probes/mxu_nn.py, scripts/probe_mxu_nn.py's
              262,144 queries): B2 and P1 times, P1 against its plain version
              and against B2 up to near-ties.

Each kernel is timed by CUDA events (median of 20 launches, the wrapper's
host time included; plain versions fewer; B1, P2 and the fused pass also
alone, 20 launches between one pair of events behind a busy card) beside its
bound: the least time the card could take for the same
work, from the bytes it must move and the operations it must do on this
run's inputs at the H100's published peaks (see bound()).

The two lines before the last are the card line from nvidia-smi and a JSON
object of the six kernels (rasterize, nn_flash_packed, nn_flash_gated with
its stacked launches apart, gather_rows, assoc_reduce, nn_flash_mxu); the
last line is
{"ok": true, "device": {...}}.
"""

import collections
import functools
import json
import logging
import os
import subprocess
import sys
import time
import traceback
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
# the fused ICP pass: each float sum against its float64 value, relative to
# the sum of its absolute terms
SUMS_BAR = 2e-6


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
    busy for a few ms, so every launch is enqueued before the first one
    starts and the wrapper's host time is not in the span; median of
    ``rounds``. The inputs stay in the L2 cache between launches, as the ICP
    loop finds them."""
    busy = torch.ones((4096, 4096), device="cuda")
    ts = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        busy @ busy
        busy @ busy
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / launches)
    return float(np.median(ts))


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


def compare_raster(torch, RC, name, tris, poses, width, height, proj, roi, plain_reps):
    """Kernel vs plain on one input: mismatch fraction, max |diff|, times."""
    from pose_refine_tpu_torch.ops.rasterize import roi_shape

    out_w, out_h = roi_shape(width, height, roi)
    coef = RC.triangle_setup(tris, poses, proj, width, height, roi)
    setup_ms, _ = median_ms(torch, lambda: RC.triangle_setup(tris, poses, proj, width, height, roi), 10)
    k_ms, k = median_ms(torch, lambda: RC.raster_coef_cuda(coef, out_w, out_h, height, roi), 20)
    a_ms = alone_ms(torch, lambda: RC.raster_coef_cuda(coef, out_w, out_h, height, roi))
    p_ms, p = median_ms(torch, lambda: RC.raster_coef_plain(coef, out_w, out_h, height, roi),
                        plain_reps, warm=0)
    mism = (k != p).float().mean().item()
    err = (k.to(torch.int64) - p.to(torch.int64)).abs().max().item()
    covered = int((p > 0).sum())
    r_bound = raster_bound(coef, out_w, out_h, height, roi)
    phase("kernel", f"{name}: N={poses.shape[0]} T={coef.shape[2]} out={out_w}x{out_h} "
          f"roi={roi} covered_px={covered} mismatch={mism} max_abs_err={err} "
          f"kernel_ms={k_ms} kernel_alone_ms={a_ms} plain_ms={p_ms} setup_ms={setup_ms} "
          f"bound_ms={r_bound['bound_ms']} "
          f"({r_bound['bound_by']})")
    check(covered > 0, f"{name}: empty render")
    check(mism < MISMATCH_GATE, f"{name}: kernel/plain mismatch {mism}")
    return k, dict(mismatch=mism, max_abs_err=err, ms=k_ms, alone_ms=a_ms, plain_ms=p_ms,
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
    kernel's function bit for bit or to the last bits (the fused ICP pass:
    term by term in the kernel's summation order), so the two paths run the
    same ICP, at the hypotheses that do not converge too. A miss is
    appended to ``failures``, so one run shows every comparison before it
    fails."""
    phase(name, f"{what}: {extra}verdict_agreement={stats['agree']} (median, max) "
          f"drot_deg={stats['rot']} dt_mm={stats['t']} dfit={stats['fit']}")
    if not (stats["agree"] == 1.0 and stats["rot"][1] <= MAX_DROT_DEG
            and stats["t"][1] <= MAX_DT_MM and stats["fit"][1] <= MAX_DFIT):
        failures.append(f"{name}: {what}: the two paths disagree")


def report_old_loop(name, stats, failures):
    """Print how far the loop of before the fused pass (a bare ``query=``:
    query, row gather, each pass reduced by matrix products) lands from the
    default loop on the same hypotheses, and hold the verdicts. Its float
    sums differ from the fused pass's in their last bits, and an ICP turns
    that into whole iterations at the hypotheses that do not converge (a
    pixel that flips its association, the 1e-5 latch): the deltas are this
    workload's sensitivity to summation order, not an error of either."""
    phase(name, f"the loop of before the fused pass (own query=, matrix products) against "
          f"the default: verdict_agreement={stats['agree']} (median, max) "
          f"drot_deg={stats['rot']} dt_mm={stats['t']} dfit={stats['fit']}")
    if stats["agree"] != 1.0:
        failures.append(f"{name}: the loop of before the fused pass changes a verdict")


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
    ``scene`` (captured through the association's fused reduce; 0 iterations
    = the scoring pass alone)."""
    from pose_refine_tpu_torch import icp

    seen = []
    query, reduce = (scene.query, scene.reduce) if scene_ids is None else \
        (scene.query_at(scene_ids), scene.reduce_at(scene_ids))

    def capture(cloud, valid):
        seen.append((cloud.clone(), valid.clone()))
        return reduce(cloud, valid)

    refine_poses(ref.tris, poses, scene, ref.proj, ref._K_render_t, width=ref.render_w,
                 height=ref.render_h, max_points=ref.max_points,
                 criteria=ptt.ICPConvergenceCriteria(max_iteration=0), window=ref.window,
                 stride=ref.stride, roi=ref.roi, scene_ids=scene_ids,
                 query=icp.Association(query, capture))
    return seen[0]


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
    table, idx); returns the stats of the first (the bench projective
    association) with max_abs_err over all."""
    out, max_err = None, 0.0
    for label, table, idx in tables:
        k_ms, k = median_ms(torch, lambda: G.gather_rows_cuda(table, idx), 20)
        a_ms = alone_ms(torch, lambda: G.gather_rows_cuda(table, idx))
        p_ms, p = median_ms(torch, lambda: G.gather_rows_plain(table, idx), 20)
        # one PyTorch call of the same function: the indices are in range
        check(bool(((idx >= 0) & (idx < table.shape[0])).all()), f"gather {label}: index range")
        lib_ms, _ = median_ms(torch, lambda: table.index_select(0, idx), 20)
        err = float((k - p).abs().max())
        n = idx.numel()
        mbytes = n * (2 * 4 * G.ROW + idx.element_size()) / 1e6
        # the least traffic: the indices read, the rows written, and each
        # table row that this run's indices name read once
        n_read = int(idx.unique().numel())
        g_bound = bound(n_bytes=n * (4 * G.ROW + idx.element_size()) + n_read * 4 * G.ROW)
        phase("gather", f"{label}: table {tuple(table.shape)} x {n} {idx.dtype} indices: "
              f"equal={torch.equal(k, p)} max_abs_err={err} kernel_ms={k_ms} "
              f"kernel_alone_ms={a_ms} plain_ms={p_ms} "
              f"index_select_ms={lib_ms} bound_ms={g_bound['bound_ms']} "
              f"traffic_MB={mbytes} kernel_GB_s={mbytes / k_ms} plain_GB_s={mbytes / p_ms}")
        check(torch.equal(k, p), f"gather {label}: kernel != plain")
        max_err = max(max_err, err)
        if out is None:
            out = dict(ms=k_ms, alone_ms=a_ms, plain_ms=p_ms, library_ms=lib_ms, **g_bound)
    out["max_abs_err"] = max_err
    return out


def assoc_reduce_phase(torch, IR, cases):
    """The fused association + reduction kernel against its plain version
    (bit for bit, and both against float64) on each case, a dict of: label; kernel(cloud, valid) -> (N, 29), a
    binding of one of ops/icp_reduce.py's _cuda entry points; assoc(cloud)
    -> (dst, normal, valid, row indices), the front end's plain version;
    cloud, valid; the bytes the front end reads a point and a pose beyond
    the 13 of cloud and mask; its FP32 instructions a point; the count it
    must find (None: any but 0). Returns {label: stats}, the first with
    max_abs_err and max_f64_err over all cases."""
    out, max_abs, max_f64 = {}, 0.0, 0.0
    for c in cases:
        label, kernel, cloud, valid = c["label"], c["kernel"], c["cloud"], c["valid"]
        n, p = cloud.shape[:2]

        def plain():
            dst, nrm, q_valid, rows = c["assoc"](cloud)
            return (dst, nrm, q_valid), rows, IR.packed_sums_plain(cloud, valid, dst, nrm, q_valid)

        before = IR.launches
        k_ms, k = median_ms(torch, lambda: kernel(cloud, valid), 20)
        check(IR.launches == before + 21, f"assoc-reduce {label}: launches not counted")
        again = kernel(cloud, valid)
        a_ms = alone_ms(torch, lambda: kernel(cloud, valid))
        p_ms, (assoc, rows, want) = median_ms(torch, plain, 3)
        count_equal, k_err = IR.sums_error(k, cloud, valid, *assoc)
        _, p_err = IR.sums_error(want, cloud, valid, *assoc)
        counts_match = count_equal and torch.equal(k[:, 28], want[:, 28])
        finite = torch.isfinite(k) & torch.isfinite(want)
        abs_err = float((k - want)[finite].abs().max())
        bits = torch.equal(k.view(torch.int32), again.view(torch.int32))
        same = bool(((k == want) | (k.isnan() & want.isnan())).all())
        n_rows = int(rows.unique().numel())
        # the least traffic: cloud, mask and the front end's own inputs read
        # once, each scene row that this run names read once, 29 sums a pose
        r_bound = bound(n_bytes=n * p * (13 + c["point_bytes"]) + n * (116 + c["pose_bytes"])
                        + n_rows * 32, n_instr=n * p * c["instr"])
        total = float(k[:, 28].sum())
        phase("assoc-reduce", f"{label}: {n} poses x {p} points, table "
              f"{c['rows']} rows ({n_rows} named), {IR.slabs_for(n, p)} CTAs a pose: "
              f"count_equal={counts_match} inliers={total} max_f64_err={k_err} "
              f"(plain f32 {p_err}; bar {SUMS_BAR}) max_abs_err={abs_err} "
              f"equals_plain_bit_for_bit={same} two_launches_bit_equal={bits} kernel_ms={k_ms} kernel_alone_ms={a_ms} "
              f"plain_ms={p_ms} bound_ms={r_bound['bound_ms']} ({r_bound['bound_by']}) "
              f"library=none")
        check(counts_match, f"assoc-reduce {label}: the count differs from the plain version's")
        check(k_err <= SUMS_BAR, f"assoc-reduce {label}: a sum lies {k_err} from its float64 "
              f"value (plain float32: {p_err})")
        check(same, f"assoc-reduce {label}: the kernel's sums are not the plain version's bit "
              f"for bit (max_abs_err {abs_err})")
        check(bits, f"assoc-reduce {label}: two launches differ")
        want_count = c.get("count")
        check(total > 0 if want_count is None else total == want_count,
              f"assoc-reduce {label}: {total} inliers")
        max_abs, max_f64 = max(max_abs, abs_err), max(max_f64, k_err)
        out[label] = dict(ms=k_ms, alone_ms=a_ms, plain_ms=p_ms, library_ms=None, **r_bound)
    out[cases[0]["label"]].update(max_abs_err=max_abs, max_f64_err=max_f64)
    return out


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


def raster_bound(coef, out_w, out_h, height, roi):
    """B1's bound at one input: the coefficient table read and the int32
    framebuffer written, against 8 FP32 instructions (beta, gamma, alpha)
    at every pixel of every clamped triangle box the kernel walks."""
    rx, ry = roi[0], roi[1]
    xs, ys, xm, ym = coef[:, 9], coef[:, 10], coef[:, 11], coef[:, 12]
    x0, x1 = xs.clamp(min=rx).ceil(), xm.clamp(max=rx + out_w - 1).floor()
    y0 = ys.clamp(min=height - ry - out_h).ceil()
    y1 = ym.clamp(max=height - 1 - ry).floor()
    ok = (xs <= xm) & (ys <= ym)
    area = ((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0) * ok).double().sum()
    n_px = coef.shape[0] * out_w * out_h
    return bound(n_bytes=coef.numel() * 4 + n_px * 4, n_instr=8 * float(area))


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
    import pose_refine_tpu_torch as ptt

    check(os.path.dirname(os.path.dirname(os.path.abspath(ptt.__file__))) == REPO,
          f"pose_refine_tpu_torch imported from {ptt.__file__}, not from this checkout")
    from pose_refine_tpu_torch import _build, geometry, icp, mesh
    from pose_refine_tpu_torch.ops import gather as G
    from pose_refine_tpu_torch.ops import icp_reduce as IR
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC
    from pose_refine_tpu_torch.pipeline import refine_poses
    from pose_refine_tpu_torch.probes import mxu_nn, nn_ties
    from pose_refine_tpu_torch.scene import nn_flash as NF
    from pose_refine_tpu_torch.scene import nn_mxu as NM
    from pose_refine_tpu_torch.scene.nn import SceneNN, _rows_in_gate
    from pose_refine_tpu_torch.scene.projective import SceneProjective, _project_gate

    def reset_counts():
        RC.launches = NF.packed_launches = NF.gated_launches = G.launches = 0
        NF.stacked_launches = NM.launches = IR.launches = 0

    def counts():
        return {"rasterize": RC.launches, "nn_flash_packed": NF.packed_launches,
                "nn_flash_gated": NF.gated_launches,
                "nn_flash_gated_stacked": NF.stacked_launches, "gather_rows": G.launches,
                "assoc_reduce": IR.launches, "nn_flash_mxu": NM.launches}

    reduce_cases = []

    def projective_case(label, sc, cloud, valid, base=None, count=None):
        """An [assoc-reduce] case of the projective front end."""
        def assoc(c):
            seen = []

            def gather(table, idx):
                seen.append(idx)
                return G.gather_rows_plain(table, idx)

            out = _project_gate(sc.table, sc.K, sc.max_dist_diff, sc.height, sc.width, c,
                                base=0 if base is None else base[:, None], gather=gather)
            return (*out, seen[0])

        reduce_cases.append(dict(
            label=label, cloud=cloud, valid=valid, assoc=assoc, rows=sc.table.shape[0],
            kernel=functools.partial(
                IR.assoc_reduce_projective_cuda, table=sc.table, K=sc.K,
                max_dist_diff=sc.max_dist_diff, height=sc.height, width=sc.width, base=base),
            # pcd2dep (2 divides, 2 products, 4 sums), the gate (3) and the
            # 86 of the reduction body (see indexed_case)
            point_bytes=0, pose_bytes=0 if base is None else 8, instr=97, count=count))

    def indexed_case(label, table, gate, cloud, valid, nearest):
        """An [assoc-reduce] case of the indexed front end on the flash-NN
        kernels' ``nearest`` = (idx, dist_sq) of ``cloud``."""
        idx, dist_sq = nearest
        reduce_cases.append(dict(
            label=label, cloud=cloud, valid=valid, rows=table.shape[0],
            assoc=lambda c: (*_rows_in_gate(table, idx, dist_sq, gate, plain=True),
                             idx.clamp(0, table.shape[0] - 1)),
            kernel=functools.partial(IR.assoc_reduce_indexed_cuda, table=table, idx=idx,
                                     dist_sq=dist_sq, gate_sq=NF.gate_sq(gate)),
            # the reduction body, no fused multiply-add (each term rounds as
            # the plain version's): 3 diff, 5 residual, 9 cross, 7 mask
            # products, 21 + 6 products and as many adds, 6 for the squared
            # distance, 2 more adds; 1 gate
            point_bytes=idx.element_size() + 4, pose_bytes=0, instr=87))
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
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    phase("build", f"ok in {time.perf_counter() - t0:.3f} s (nvcc {info['seconds']:.3f} s, "
          f"built={info['built']}) -> {os.path.relpath(info['path'], REPO)}; {regs}")

    # 3. kernel vs plain at the slice's shapes
    model, tris_np, truth, poses_np = workload(geometry, mesh)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, WIDTH, HEIGHT, device=dev)
    tris = torch.as_tensor(tris_np, device=dev)
    scene_t, scene_stats = compare_raster(
        torch, RC, "observed scene", tris, torch.as_tensor(truth[None], device=dev),
        WIDTH, HEIGHT, proj, (0, 0, 0, 0), plain_reps=3)
    scene = scene_t[0].cpu().numpy()
    check(scene.max() > 0 and 200 < scene[scene > 0].min() < 300, "implausible scene depth")

    refiner = ptt.PoseRefiner(model, K=K, device="cuda", **CFG)
    refiner.set_scene_depth(scene)
    poses = torch.as_tensor(poses_np, device=dev)
    rw, rh = refiner.render_w, refiner.render_h
    _, hyp_stats = compare_raster(
        torch, RC, "hypotheses", refiner.tris, poses, rw, rh, refiner.proj, refiner.roi,
        plain_reps=3)
    per_pose = refiner.tris.expand(N_POSES, *refiner.tris.shape).contiguous()
    _, pp_stats = compare_raster(
        torch, RC, "hypotheses, per-pose (N,T,3,3) table", per_pose, poses, rw, rh,
        refiner.proj, refiner.roi, plain_reps=1)

    # 4. the slice end to end through the kernel
    crit = ptt.ICPConvergenceCriteria(max_iteration=ITERS)
    reset_counts()
    refined, res = refiner.refine(poses, crit)
    torch.cuda.synchronize()
    slice_counts = counts()
    launches = slice_counts["rasterize"]
    check(launches > 0 and slice_counts["assoc_reduce"] == ITERS + 1
          and slice_counts["gather_rows"] == 0,
          f"refine did not launch the raster kernel and one fused pass an iteration: "
          f"{slice_counts}")
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
          f"launches={slice_counts}")
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
        raster=RC.rasterize_plain)
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
    phase("slice", f"plain raster path: wall_ms={p_wall * 1e3} verdict_agreement={agree} "
          f"max_drot_deg={d_rot} max_dt_mm={d_t} max_dfit={d_fit}")
    check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
          "kernel path and plain path disagree")
    # the same refine through the plain versions of the association and of
    # the fused pass, and through the loop of before the fused pass
    path_failures = []
    rp = functools.partial(
        refine_poses, refiner.tris, poses, refiner.scene, refiner.proj, refiner._K_render_t,
        width=rw, height=rh, max_points=refiner.max_points, criteria=crit,
        window=refiner.window, stride=refiner.stride, roi=refiner.roi)
    plain_query = functools.partial(refiner.scene.query, plain=True)
    a_refined, a_res = rp(query=icp.plain_association(plain_query))
    hold_paths("slice", "through the plain query and the plain fused pass",
               agreement(rotation_angle_deg, truth, refined_np, a_refined.cpu().numpy(), fit,
                         a_res.fitness.cpu().numpy()), path_failures)
    m_refined, m_res = rp(query=plain_query)
    report_old_loop("slice", agreement(rotation_angle_deg, truth, refined_np,
                                       m_refined.cpu().numpy(), fit,
                                       m_res.fitness.cpu().numpy()), path_failures)

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

    def golden_plain(ref):
        """ref's refine of the golden start through the plain versions
        (raster, NN, gather, fused pass), against ref.refine."""
        k_pose, k_res = ref.refine(pose1[None])
        p_pose, p_res = refine_poses(
            ref.tris, torch.as_tensor(pose1[None], device=dev), ref.scene, ref.proj,
            ref._K_render_t, width=ref.render_w, height=ref.render_h,
            max_points=ref.max_points, criteria=ptt.ICPConvergenceCriteria(),
            window=ref.window, stride=ref.stride, roi=ref.roi, raster=RC.rasterize_plain,
            query=icp.plain_association(functools.partial(ref.scene.query, plain=True)))
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

    # 7. the NN slice end to end through the gated kernel
    nn_launches = {}
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
              and c["assoc_reduce"] == c["nn_flash_gated"],
              f"nn-slice {label}: launches {c}")
        if label == "2mm":
            nn_launches["nn_flash_gated"] = c["nn_flash_gated"]
            nn_launches["assoc_reduce"] = c["assoc_reduce"]
        nn_np = nn_refined.cpu().numpy()
        check(nn_np.shape == (N_POSES, 4, 4) and np.isfinite(nn_np).all(),
              f"nn-slice {label}: refined poses not finite (N, 4, 4)")
        nn_fit = nn_res.fitness.cpu().numpy()
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
        p_refined, p_res = rp(scene=ref.scene, query=icp.plain_association(nn_plain))
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t0) * 1e3
        hold_paths("nn-slice", "2mm through the plain NN and the plain fused pass",
                   agreement(rotation_angle_deg, truth, nn_np, p_refined.cpu().numpy(), nn_fit,
                             p_res.fitness.cpu().numpy()),
                   path_failures, extra=f"wall_ms={p_wall} ")
        m_refined, m_res = rp(scene=ref.scene, query=ref.scene.query)
        report_old_loop("nn-slice", agreement(
            rotation_angle_deg, truth, nn_np, m_refined.cpu().numpy(), nn_fit,
            m_res.fitness.cpu().numpy()), path_failures)
        flash = SceneNN.from_depth(scene, K, ref.max_dist_diff, voxel_mm=2.0,
                                   backend="flash", device=dev)
        reset_counts()
        f_refined, f_res = rp(scene=flash)
        torch.cuda.synchronize()
        c = counts()
        nn_launches["nn_flash_packed"] = c["nn_flash_packed"]
        check(c["nn_flash_packed"] > 0, f"nn-slice full-scan scene: launches {c}")
        f_wall, f_dev = refine_ms(torch, lambda: rp(scene=flash))
        # both scenes feed equal neighbours to the same fused pass
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
    raw_nn = SceneNN.from_depth(scene, K, 0.1, device=dev)
    frame_nn = SceneNN.from_depth_device(torch.as_tensor(scene, device=dev), K_t, 0.1)

    def neighbours(s):
        return NF.nn_flash_gated(queries, s.flash_table, s.flash_boxes, s.flash_balls,
                                 s.max_dist_diff)[0]

    gather_stats = gather_phase(torch, G, [
        ("bench projective scene", sc.table, pixels[0]),
        ("raw NN scene", raw_nn.table, neighbours(raw_nn)),
        ("device-built 640x480 NN scene", frame_nn.table, neighbours(frame_nn)),
    ])
    # the fused pass's cases at the slice shape ([assoc-reduce], below)
    slice_cloud, slice_valid = first_pass_clouds(ptt, refine_poses, refiner, sc, poses)
    projective_case("slice shape", sc, slice_cloud, slice_valid)
    for label, s_nn in (("2 mm NN scene", nn_ref.scene), ("raw NN scene", raw_nn)):
        indexed_case(label, s_nn.table, s_nn.max_dist_diff, nn_cloud, nn_valid,
                     s_nn._nearest(nn_cloud))
    # edge inputs: a pose with no valid point, points at z = 0, behind the
    # camera and NaN, points that project onto the frame's border pixels
    # (trunc(v + 0.5) steps at -1 and at the frame's size), a masked row
    edge_cloud, edge_valid = slice_cloud.clone(), slice_valid.clone()
    edge_valid[0] = False
    edge_cloud[1, :3] = torch.tensor([[0.01, 0.01, 0.0], [0.01, 0.01, -0.3],
                                      [float("nan"), 0.0, 0.3]], device=dev)
    edge_valid[1, :3] = True
    fx, fy, cx, cy = (float(K[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    for i, (u, v) in enumerate(((-1.0, 100.0), (-0.99999, 100.0), (WIDTH, 100.0),
                                (WIDTH - 1e-4, 100.0), (100.0, -1.0), (100.0, -0.99999),
                                (100.0, HEIGHT), (100.0, HEIGHT - 1e-4))):
        edge_cloud[2, i] = torch.tensor([(u - 0.5 - cx) / fx * 0.3, (v - 0.5 - cy) / fy * 0.3,
                                         0.3], device=dev)
        edge_valid[2, i] = True
    projective_case("edge inputs", sc, edge_cloud, edge_valid)
    shut = SceneProjective(table=sc.table, K=sc.K, height=sc.height, width=sc.width,
                           max_dist_diff=torch.full((), -1.0, device=dev))
    projective_case("a gate that rejects everything", shut, slice_cloud, slice_valid, count=0.0)

    # 10. bench.py's tracking workload through TrackingSession
    truths, frames = track_frames(
        geometry, lambda p: RC.rasterize(tris, torch.as_tensor(p, device=dev), WIDTH, HEIGHT,
                                         proj), truth)
    hyps0 = first_hypotheses(ptt, truth)
    control = sync_sites(torch, lambda: torch.ones(1, device=dev).item())
    check(sum(control.values()) >= 1, f"the sync counter missed an .item(): {dict(control)}")
    track_counts = {}
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
              f"launches={c} syncs_in_one_step_async={sum(syncs.values())} {dict(syncs)}")
        # a frame: 30 iterations and the scoring pass through the fused
        # kernel, the information pass through the row gather
        check(c["rasterize"] > 0 and c["gather_rows"] == N_TRACK
              and c["assoc_reduce"] == 31 * N_TRACK
              and (label == "projective" or c["nn_flash_gated"] > 0),
              f"track {label}: launches {c}")
        check(np.isfinite(last.pose).all() and t_err < 20.0,
              f"track {label}: final translation error {t_err} mm")
        # the first frame through the kernels against the plain versions
        k_out = ref.track(frames[0], hyps0, with_covariance=True)
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
            projective_case("tracking shape", track_scene, *first_pass_clouds(
                ptt, refine_poses, ref, track_scene, torch.as_tensor(hyps0, device=dev)))
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
        check(c["rasterize"] > 0 and c["assoc_reduce"] == ITERS + 1
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
            indexed_case("stacked NN table, 4 frames", stack.table, stack.max_dist_diff,
                         ms_cloud, ms_valid,
                         stack._nearest_at(stack._frame_ids(ms_ids_t), ms_cloud))
        else:
            projective_case("stacked projective table, 4 frames", stack, ms_cloud, ms_valid,
                            base=stack._base(ms_ids_t))
        # the same refine through the plain versions (raster, NN, gather,
        # fused pass)
        t0 = time.perf_counter()
        p_refined, p_res = rp(criteria=crit, raster=RC.rasterize_plain,
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
        # of the stack; the same plan and the same batch, so the fused pass
        # splits the poses over as many CTAs and sums in the same order)
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
    other = mesh.make_bumpy_sphere(radius=60.0, subdivisions=4)
    mm_ref = ptt.MultiModelRefiner([model, other], K=K, device="cuda", render_scale=2,
                                   max_points=2048, window=128, stride=2, decimate_mm=2.0)
    mm_ref.set_scene_depth(scene)
    mm_ids = np.array([0, 1] * (N_POSES // 2), np.int32)
    reset_counts()
    mm_refined, mm_res = mm_ref.refine(mm_ids, poses, criteria=crit)
    torch.cuda.synchronize()
    mm_launches = counts()
    check(mm_launches["rasterize"] > 0 and mm_launches["assoc_reduce"] == ITERS + 1,
          f"multimodel: launches {mm_launches}")
    mm_np = mm_refined.cpu().numpy()
    mm_fit = mm_res.fitness.cpu().numpy()
    check(np.isfinite(mm_np).all(), "multimodel: refined poses not finite")
    best = int(ptt.PoseRefiner.rank(mm_res)[0])
    best_mm = float(np.linalg.norm(mm_np[best, :3, 3] - truth[:3, 3]))
    wall_ms, dev_ms = refine_ms(torch, lambda: mm_ref.refine(mm_ids, poses, criteria=crit))
    mm_tris, _p, _sq = mm_ref._per_pose_tris(mm_ids, poses)
    phase("multimodel", f"{N_POSES} hypotheses of 2 models (per-pose table "
          f"{tuple(mm_tris.shape)}), roi={mm_ref.roi}: wall_ms={wall_ms} device_ms={dev_ms} "
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
        query=icp.plain_association(functools.partial(mm_ref.scene.query, plain=True)))
    hold_paths("multimodel", "through the plain versions",
               agreement(rotation_angle_deg, truth, mm_np, p_refined.cpu().numpy(), mm_fit,
                         p_res.fitness.cpu().numpy()), path_failures)

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
          and mt_launches["assoc_reduce"] == 31 * MT_FRAMES,
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

    # 15. the fused association + reduction pass against its plain version
    reduce_stats = assoc_reduce_phase(torch, IR, reduce_cases)

    # 16. P1 on its probe: scripts/probe_mxu_nn.py's workload at full size
    reset_counts()
    mxu = mxu_nn.run(device=dev)
    phase("mxu", " ".join(f"{k}={v}" for k, v in mxu.items()))
    check(mxu["launches"]["nn_flash_mxu"] > 0 and mxu["launches"]["nn_flash_packed"] > 0,
          f"mxu: launches {mxu['launches']}")
    check(mxu["b2_near_ties"] and mxu["b2_dist_in_band"] and mxu["plain_near_ties"]
          and mxu["plain_dist_in_band"], "mxu: a disagreement outside the near-tie band")
    mxu_pairs = float(mxu["queries"]) * mxu["table_columns"]

    check(not path_failures, "; ".join(path_failures))
    print(card_line)
    max_err = max(s["max_abs_err"] for s in (scene_stats, hyp_stats, pp_stats))
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
        # look their rows up inside assoc_reduce
        "launches": track_counts["projective"]["gather_rows"],
        **gather_stats,
    }, {
        "name": "assoc_reduce",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/icp_reduce.cu",
        # the port's own kernel: the row gather fused with the packed
        # reduction of pose_refine_tpu/icp.py:215
        "replaces": "scripts/probe_pallas_gather.py:29",
        "launches": slice_counts["assoc_reduce"],
        **reduce_stats["slice shape"],
        "launches_track": track_counts["projective"]["assoc_reduce"],
        "track_ms": reduce_stats["tracking shape"]["ms"],
        "track_alone_ms": reduce_stats["tracking shape"]["alone_ms"],
        "track_bound_ms": reduce_stats["tracking shape"]["bound_ms"],
        "launches_nn": nn_launches["assoc_reduce"],
        "launches_stacked": ms_launches["multiscene"]["assoc_reduce"],
        "launches_multimodel": mm_launches["assoc_reduce"],
    }, {
        "name": "nn_flash_mxu",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/nn_mxu.cu",
        "replaces": "scripts/probe_mxu_nn.py:57",
        "launches": mxu["launches"]["nn_flash_mxu"],
        "max_abs_err": mxu["max_abs_err"],
        "ms": mxu["p1_ms"],
        "plain_ms": mxu["p1_plain_ms"],
        # the least argmin work a pair needs on the CUDA cores: one min of
        # the score and one compare to find the rare chunks that improve it
        # (the index update runs only there), against the 3xTF32 product's
        # 3 x 4 useful MACs a pair on the tensor cores
        **bound(n_instr=2 * mxu_pairs, n_tensor_flop=24 * mxu_pairs),
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
