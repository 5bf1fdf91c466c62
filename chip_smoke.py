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
              fraction must stay below 1e-4; median times of both.
  4. slice  - PoseRefiner.set_scene_depth + refine on the bench workload
              (256 hypotheses +-10 deg/axis +-20 mm around the reference
              viewpoint, render_scale 2, decimate 4 mm, window 128 / stride 2,
              2048 points, 24 ICP iterations) through the kernel; the launch
              counter must rise. Wall and device time, poses/s. The same
              refine through the plain raster must agree.
  5. golden - the reference acceptance recipe (10 deg/axis + 20 mm) on a
              bumpy sphere at 640x480 recovers to under 1 degree.
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
              skipped.
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
              median times of both.
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
              composite frames, MultiObjectSession with 16 hypotheses each:
              every step accepted within 6 mm, ms per frame, 0 synchronizing
              calls in a steady-state step_async; the first frame's track
              through the plain versions agrees.
 15. mxu    - P1 on its probe (probes/mxu_nn.py, scripts/probe_mxu_nn.py's
              262,144 queries): B2 and P1 times, P1 against its plain version
              and against B2 up to near-ties.

Each kernel is timed by CUDA events (median of 20 launches; plain versions
fewer) beside its bound: the least time the card could take for the same
work, from the bytes it must move and the operations it must do on this
run's inputs at the H100's published peaks (see bound()).

The two lines before the last are the card line from nvidia-smi and a JSON
object of the five kernels (rasterize, nn_flash_packed, nn_flash_gated with
its stacked launches apart, gather_rows, nn_flash_mxu); the last line is
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
    p_ms, p = median_ms(torch, lambda: RC.raster_coef_plain(coef, out_w, out_h, height, roi),
                        plain_reps, warm=0)
    mism = (k != p).float().mean().item()
    err = (k.to(torch.int64) - p.to(torch.int64)).abs().max().item()
    covered = int((p > 0).sum())
    r_bound = raster_bound(coef, out_w, out_h, height, roi)
    phase("kernel", f"{name}: N={poses.shape[0]} T={coef.shape[2]} out={out_w}x{out_h} "
          f"roi={roi} covered_px={covered} mismatch={mism} max_abs_err={err} "
          f"kernel_ms={k_ms} plain_ms={p_ms} setup_ms={setup_ms} bound_ms={r_bound['bound_ms']} "
          f"({r_bound['bound_by']})")
    check(covered > 0, f"{name}: empty render")
    check(mism < MISMATCH_GATE, f"{name}: kernel/plain mismatch {mism}")
    return k, dict(mismatch=mism, max_abs_err=err, ms=k_ms, plain_ms=p_ms, **r_bound)


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
    """Verdict agreement (rotation < 3 deg and translation < 2 mm) and the
    largest rotation, translation and fitness deltas between two refines;
    ``truth`` is one (4, 4) pose or one per row."""
    err_a = rotation_angle_deg(a, truth) < VERDICT_DEG
    err_b = rotation_angle_deg(b, truth) < VERDICT_DEG
    mm_a = np.linalg.norm(a[:, :3, 3] - truth[..., :3, 3], axis=-1) < 2.0
    mm_b = np.linalg.norm(b[:, :3, 3] - truth[..., :3, 3], axis=-1) < 2.0
    agree = float(((err_a == err_b) & (mm_a == mm_b)).mean())
    return (agree, float(rotation_angle_deg(a, b).max()),
            float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max()), float(np.abs(fit_a - fit_b).max()))


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


def nn_kernel_phase(torch, NF, SceneNN, K, scene_depth, queries):
    """Both flash-NN kernels against their plain versions on the first-pass
    queries; returns {kernel name: stats of the 2 mm scene at the 0.1 m
    gate, with max_abs_err over every comparison}."""
    dev = queries.device
    nq = queries.shape[0]
    out = {}
    max_err = {"nn_flash_packed": 0.0, "nn_flash_gated": 0.0}
    for label, voxel in (("raw", 0.0), ("2mm", 2.0)):
        sc = SceneNN.from_depth(scene_depth, K, 0.1, voxel_mm=voxel, device=dev)
        table, boxes, balls = sc.flash_table, sc.flash_boxes, sc.flash_balls
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
        for gate in NN_GATES:
            g2 = NF.gate_sq(gate)
            scanned = torch.empty(-(-nq // NF.Q_TILE), dtype=torch.int32, device=dev)
            gk_ms, (gi, gd) = median_ms(torch, lambda: NF.nn_flash_gated_cuda(
                queries, table, boxes, balls, gate, scanned=scanned), 20)
            gp_ms, (qi, qd) = median_ms(torch, lambda: NF.nn_flash_gated_plain(
                queries, table, gate), 1, warm=0)
            band = gate_band(queries, pd, g2)
            inside = (qd < g2) & ~band
            n_in = int(inside.sum())
            err = float((gd[inside] - qd[inside]).abs().max()) if n_in else 0.0
            idx_bad = int((gi[inside] != qi[inside]).sum())
            valid_bad = int((((gd < g2) != (qd < g2)) & ~band).sum())
            vs_full = int((gi[inside] != ki[inside]).sum() + (gd[inside] != kd[inside]).sum())
            band_diff = int((band & ((gi != qi) | ((gd < g2) != (qd < g2)))).sum())
            skipped = 1.0 - float(scanned.sum()) / (scanned.numel() * n_chunks)
            pairs = float(scanned.sum()) * NF.S_CHUNK * NF.Q_TILE
            g_bound = nn_bound(nq, pairs, balls.shape[1])
            max_err["nn_flash_gated"] = max(max_err["nn_flash_gated"], err)
            phase("nn-kernel", f"nn_flash_gated {label} scene, gate {gate} m: in_gate={n_in}/{nq} "
                  f"gate_band={int(band.sum())} (of which differ {band_diff}) "
                  f"idx_mismatch={idx_bad} validity_mismatch={valid_bad} "
                  f"vs_full_scan_mismatch={vs_full} max_abs_err={err} "
                  f"chunks_skipped={skipped} kernel_ms={gk_ms} plain_ms={gp_ms} "
                  f"bound_ms={g_bound['bound_ms']}")
            check(0 < n_in, f"nn_flash_gated {label} {gate}: no in-gate query")
            check(idx_bad == 0 and err == 0.0 and valid_bad == 0,
                  f"nn_flash_gated {label} {gate}: kernel != plain")
            check(vs_full == 0, f"nn_flash_gated {label} {gate}: gated != full scan in the gate")
            if label == "2mm" and gate == 0.1:
                out["nn_flash_gated"] = dict(ms=gk_ms, plain_ms=gp_ms, **g_bound)
    for name, e in max_err.items():
        out[name]["max_abs_err"] = e
    return out


def gather_phase(torch, G, tables):
    """The row-gather kernel against its plain version on each (label,
    table, idx); returns the stats of the first (the bench projective
    association) with max_abs_err over all."""
    out, max_err = None, 0.0
    for label, table, idx in tables:
        k_ms, k = median_ms(torch, lambda: G.gather_rows_cuda(table, idx), 20)
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
              f"equal={torch.equal(k, p)} max_abs_err={err} kernel_ms={k_ms} plain_ms={p_ms} "
              f"index_select_ms={lib_ms} bound_ms={g_bound['bound_ms']} "
              f"traffic_MB={mbytes} kernel_GB_s={mbytes / k_ms} plain_GB_s={mbytes / p_ms}")
        check(torch.equal(k, p), f"gather {label}: kernel != plain")
        max_err = max(max_err, err)
        if out is None:
            out = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, **g_bound)
    out["max_abs_err"] = max_err
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
    """B2/B3's bound: 6 FP32 instructions per scored (query, point) pair
    (|s|^2 - 2 q.s as 3 FMAs with -2q taken once, the compare, the selects
    of score and index) and, for B3, 8 per (query, ball) of the first pass;
    the queries read and the outputs written are bytes the operations
    dwarf."""
    return bound(n_bytes=nq * (12 + 8), n_instr=6 * pairs + 8 * nq * n_balls)


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
    from pose_refine_tpu_torch import _build, geometry, mesh
    from pose_refine_tpu_torch.ops import gather as G
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC
    from pose_refine_tpu_torch.pipeline import refine_poses
    from pose_refine_tpu_torch.probes import mxu_nn
    from pose_refine_tpu_torch.scene import nn_flash as NF
    from pose_refine_tpu_torch.scene import nn_mxu as NM
    from pose_refine_tpu_torch.scene.nn import SceneNN
    from pose_refine_tpu_torch.scene.projective import _project_gate

    def reset_counts():
        RC.launches = NF.packed_launches = NF.gated_launches = G.launches = 0
        NF.stacked_launches = NM.launches = 0

    def counts():
        return {"rasterize": RC.launches, "nn_flash_packed": NF.packed_launches,
                "nn_flash_gated": NF.gated_launches,
                "nn_flash_gated_stacked": NF.stacked_launches, "gather_rows": G.launches,
                "nn_flash_mxu": NM.launches}
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
    check(launches > 0 and slice_counts["gather_rows"] > 0,
          f"refine did not launch the raster and gather kernels: {slice_counts}")
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

    # 6. the flash-NN kernels against their plain versions on the queries
    # of one NN refine's first association pass (captured through the
    # query override; 0 iterations = the scoring pass alone)
    nn_ref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn_bruteforce",
                             scene_voxel_mm=2.0, **CFG)
    nn_ref.set_scene_depth(scene)
    seen = []

    def capture(src):
        seen.append(src.reshape(-1, 3).clone())
        return nn_ref.scene.query(src)

    refine_poses(nn_ref.tris, poses, nn_ref.scene, nn_ref.proj, nn_ref._K_render_t,
                 width=nn_ref.render_w, height=nn_ref.render_h, max_points=nn_ref.max_points,
                 criteria=ptt.ICPConvergenceCriteria(max_iteration=0), window=nn_ref.window,
                 stride=nn_ref.stride, roi=nn_ref.roi, query=capture)
    queries = seen[0]
    check(queries.shape == (N_POSES * nn_ref.max_points, 3) and bool(torch.isfinite(queries).all()),
          f"first-pass queries {tuple(queries.shape)}")
    nn_stats = nn_kernel_phase(torch, NF, SceneNN, K, scene, queries)

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
        check(c["nn_flash_gated"] > 0 and c["rasterize"] > 0 and c["gather_rows"] > 0,
              f"nn-slice {label}: launches {c}")
        if label == "2mm":
            nn_launches["nn_flash_gated"] = c["nn_flash_gated"]
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
        p_refined, p_res = rp(scene=ref.scene, query=functools.partial(ref.scene.query, plain=True))
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t0) * 1e3
        agree, d_rot, d_t, d_fit = agreement(rotation_angle_deg, truth, nn_np,
                                             p_refined.cpu().numpy(), nn_fit,
                                             p_res.fitness.cpu().numpy())
        phase("nn-slice", f"2mm through the plain NN: wall_ms={p_wall} verdict_agreement={agree} "
              f"max_drot_deg={d_rot} max_dt_mm={d_t} max_dfit={d_fit}")
        check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
              "nn-slice: kernel path and plain path disagree")
        flash = SceneNN.from_depth(scene, K, ref.max_dist_diff, voxel_mm=2.0,
                                   backend="flash", device=dev)
        reset_counts()
        f_refined, f_res = rp(scene=flash)
        torch.cuda.synchronize()
        c = counts()
        nn_launches["nn_flash_packed"] = c["nn_flash_packed"]
        check(c["nn_flash_packed"] > 0, f"nn-slice full-scan scene: launches {c}")
        agree, d_rot, d_t, d_fit = agreement(rotation_angle_deg, truth, nn_np,
                                             f_refined.cpu().numpy(), nn_fit,
                                             f_res.fitness.cpu().numpy())
        f_wall, f_dev = refine_ms(torch, lambda: rp(scene=flash))
        phase("nn-slice", f"2mm against the full-scan scene (nn_flash_packed): wall_ms={f_wall} "
              f"device_ms={f_dev} verdict_agreement={agree} max_drot_deg={d_rot} "
              f"max_dt_mm={d_t} max_dfit={d_fit} launches={c}")
        check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
              "nn-slice: the gated and the full-scan scene disagree")

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
        check(c["rasterize"] > 0 and c["gather_rows"] > 0
              and (label == "projective" or c["nn_flash_gated"] > 0),
              f"track {label}: launches {c}")
        check(np.isfinite(last.pose).all() and t_err < 20.0,
              f"track {label}: final translation error {t_err} mm")
        # the first frame through the kernels against the plain versions
        k_out = ref.track(frames[0], hyps0, with_covariance=True)
        p_out = ref.track(frames[0], hyps0, with_covariance=True, _plain=True)
        agree, d_rot, d_t, d_fit = agreement(
            rotation_angle_deg, truths[0], k_out[0].cpu().numpy(), p_out[0].cpu().numpy(),
            k_out[1].fitness.cpu().numpy(), p_out[1].fitness.cpu().numpy())
        d_cov = float(((k_out[2].covariance - p_out[2].covariance).abs().amax(dim=(1, 2))
                       / p_out[2].covariance.abs().amax(dim=(1, 2))).max())
        phase("track", f"{label}: first frame through the plain versions: "
              f"verdict_agreement={agree} max_drot_deg={d_rot} max_dt_mm={d_t} "
              f"max_dfit={d_fit} max_rel_dcov={d_cov}")
        check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
              f"track {label}: kernel path and plain path disagree")

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
        check(c["rasterize"] > 0 and c["gather_rows"] > 0
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
        if label == "multiscene-nn":
            seen = []
            q_at = stack.query_at(ms_ids_t)

            def capture(src):
                seen.append(src.clone())
                return q_at(src)

            rp(criteria=ptt.ICPConvergenceCriteria(max_iteration=0), query=capture)
            stacked_stats = stacked_nn_kernel_phase(torch, NF, stack, seen[0], ms_ids_t)
        # the same refine through the plain versions (raster, NN, gather)
        t0 = time.perf_counter()
        p_refined, p_res = rp(criteria=crit, raster=RC.rasterize_plain,
                              query=stack.query_at(ms_ids_t, plain=True))
        torch.cuda.synchronize()
        p_wall = (time.perf_counter() - t0) * 1e3
        agree, d_rot, d_t, d_fit = agreement(rotation_angle_deg, ms_rows, ms_np,
                                             p_refined.cpu().numpy(), ms_fit,
                                             p_res.fitness.cpu().numpy())
        phase(label, f"through the plain versions: wall_ms={p_wall} verdict_agreement={agree} "
              f"max_drot_deg={d_rot} max_dt_mm={d_t} max_dfit={d_fit}")
        check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
              f"{label}: kernel path and plain path disagree")
        if label != "multiscene":
            continue
        # every frame's hypotheses refined against that frame alone (a lane
        # of the stack; the same plan and the same batch, so the ICP sums
        # run the same kernels: a batch of 64 reduces in another order)
        lanes = np.empty_like(ms_np)
        lane_fit = np.empty_like(ms_fit)
        for k in range(MS_FRAMES):
            rows = ms_ids == k
            l_ref, l_res = ref.refine(ms_hyps_t, crit, _scene=stack.lane(k))
            lanes[rows] = l_ref.cpu().numpy()[rows]
            lane_fit[rows] = l_res.fitness.cpu().numpy()[rows]
        agree, d_rot, d_t, d_fit = agreement(rotation_angle_deg, ms_rows, ms_np, lanes, ms_fit,
                                             lane_fit)
        phase(label, f"against per-frame refines: verdict_agreement={agree} max_drot_deg={d_rot} "
              f"max_dt_mm={d_t} max_dfit={d_fit}")
        check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
              "multiscene: the stacked refine and the per-frame refines disagree")

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
    check(mm_launches["rasterize"] > 0 and mm_launches["gather_rows"] > 0,
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
        query=functools.partial(mm_ref.scene.query, plain=True))
    agree, d_rot, d_t, d_fit = agreement(rotation_angle_deg, truth, mm_np, p_refined.cpu().numpy(),
                                         mm_fit, p_res.fitness.cpu().numpy())
    phase("multimodel", f"through the plain versions: verdict_agreement={agree} "
          f"max_drot_deg={d_rot} max_dt_mm={d_t} max_dfit={d_fit}")
    check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
          "multimodel: kernel path and plain path disagree")

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

    def multi_session(pipelined=True):
        session = ptt.MultiObjectSession(mt_ref, [(0, starts[0]), (1, starts[1])],
                                         n_hypotheses=MT_HYP, seed=13)
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
        s_ms = sorted(multi_session(pipelined=False)[0] for _ in range(3))[1]
        probe = ptt.MultiObjectSession(mt_ref, [(0, starts[0]), (1, starts[1])],
                                       n_hypotheses=MT_HYP, seed=13)
        probe.step_async(mt_frames[0])
        probe.step_async(mt_frames[1])
        syncs = sync_sites(torch, lambda: probe.step_async(mt_frames[2]))
        probe.flush()
    finally:
        pkg_log.setLevel(level)
    accepted = [[s.accepted for s in steps] for steps in mt_steps]
    t_errs = [max(float(np.linalg.norm(s.pose[:3, 3] - t[:3, 3])) for s, t in zip(steps, truths))
              for steps, truths in zip(mt_steps, mt_truths)]
    phase("multi-track", f"2 objects x {MT_HYP} hypotheses, {MT_FRAMES} frames, one track per "
          f"frame, roi={mt_ref.roi}: step_async_ms_per_frame={a_ms} step_ms_per_frame={s_ms} "
          f"all_accepted={all(map(all, accepted))} max_translation_err_mm={max(t_errs)} "
          f"final={t_errs[-1]} (icosphere: rotation unobservable) launches={mt_launches} "
          f"syncs_in_one_step_async={sum(syncs.values())} {dict(syncs)}")
    check(mt_launches["rasterize"] > 0 and mt_launches["gather_rows"] > 0,
          f"multi-track: launches {mt_launches}")
    check(all(map(all, accepted)) and max(t_errs) < 6.0,
          f"multi-track: accepted {accepted}, translation errors {t_errs}")
    check(sum(syncs.values()) == 0, f"multi-track: synchronizing calls in step_async {dict(syncs)}")
    # the first frame's hypotheses through the kernels and the plain versions
    mt_hyps, mt_ids = [], []
    for i in range(2):
        tracker = ptt.PoseTracker(starts[i])
        tracker.predict()
        mt_hyps.append(tracker.hypotheses(MT_HYP, seed=np.random.default_rng(i)))
        mt_ids += [i] * MT_HYP
    mt_hyps, mt_ids = np.concatenate(mt_hyps), np.asarray(mt_ids, np.int32)
    k_out = mt_ref.track(mt_frames[0], mt_ids, mt_hyps, with_covariance=True)
    p_out = mt_ref.track(mt_frames[0], mt_ids, mt_hyps, with_covariance=True, _plain=True)
    agree, d_rot, d_t, d_fit = agreement(
        rotation_angle_deg, mt_truths[0][mt_ids], k_out[0].cpu().numpy(), p_out[0].cpu().numpy(),
        k_out[1].fitness.cpu().numpy(), p_out[1].fitness.cpu().numpy())
    phase("multi-track", f"first frame through the plain versions: verdict_agreement={agree} "
          f"max_drot_deg={d_rot} max_dt_mm={d_t} max_dfit={d_fit}")
    check(agree == 1.0 and d_rot <= MAX_DROT_DEG and d_t <= MAX_DT_MM and d_fit <= MAX_DFIT,
          "multi-track: kernel path and plain path disagree")

    # 15. P1 on its probe: scripts/probe_mxu_nn.py's workload at full size
    reset_counts()
    mxu = mxu_nn.run(device=dev)
    phase("mxu", " ".join(f"{k}={v}" for k, v in mxu.items()))
    check(mxu["launches"]["nn_flash_mxu"] > 0 and mxu["launches"]["nn_flash_packed"] > 0,
          f"mxu: launches {mxu['launches']}")
    check(mxu["b2_near_ties"] and mxu["b2_dist_in_band"] and mxu["plain_near_ties"]
          and mxu["plain_dist_in_band"], "mxu: a disagreement outside the near-tie band")
    mxu_pairs = float(mxu["queries"]) * mxu["table_columns"]

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
    }, {
        "name": "gather_rows",
        "route": "cuda",
        "source": "pose_refine_tpu_torch/csrc/gather.cu",
        "replaces": "scripts/probe_pallas_gather.py:29",
        "launches": track_counts["projective"]["gather_rows"],
        **gather_stats,
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
