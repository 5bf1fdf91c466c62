"""Probe: exact NN through a tensor-core screen (P1, ``csrc/nn_mxu.cu``)
against the elementwise flash-NN kernel (B2, ``csrc/nn_flash.cu``), on a
real depth-cloud workload (PyTorch port of ``scripts/probe_mxu_nn.py``).

    python -m pose_refine_tpu_torch.probes.mxu_nn [--queries N] [--scale S] [--device D]

The workload is the script's: the benchmark model rendered by the raster
kernel at the reference rotation and t = (0, 0, 300) mm at 640x480, every
valid pixel lifted and lexsorted (z, then y, then x), and N = 262,144
queries drawn with ``np.random.default_rng(0)`` (a choice of cloud points,
then N(0, 3 mm) noise). Structured data is where rounding-level score
differences flip argmin near-ties; P1 computes B2's function, so the probe
holds P1's idx and dist^2 equal to B2's and to P1's plain version, bit for
bit, and counts the queries that differ. ``--scale`` divides the
resolution and the focal lengths (a tiny workload for the CPU). On a card
it times both kernels with CUDA events (median of ``--reps`` launches) and
runs P1's instrumented build once: the pairs it re-scored a query and the
largest |screen - B2 score| / eps_q among them; on the CPU the kernels'
plain versions run and no time is taken. ``tie_lattice`` makes the exact
ties that the tests and chip_smoke.py add to the workload.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

N_QUERIES = 262144
WIDTH, HEIGHT = 640, 480
R1 = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)


def workload(n_queries: int = N_QUERIES, scale: int = 1, device=None):
    """(object cloud (S, 3) float32 numpy, queries (n_queries, 3) float32
    tensor on ``device``) of probe_mxu_nn.py:93-105."""
    from pose_refine_tpu_torch import geometry, mesh
    from pose_refine_tpu_torch.device import resolve_device
    from pose_refine_tpu_torch.ops.depth_to_cloud import depth_image_to_points
    from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    model = mesh.load_benchmark_model()
    tris = model.tris[mesh.morton_order(model.tris)]
    K = geometry.LINEMOD_K.copy()
    K[:2] /= scale
    w, h = WIDTH // scale, HEIGHT // scale
    truth = geometry.pose_from_Rt(R1, np.array([0, 0, 300], np.float32))
    depth = rasterize(tris, truth[None], w, h, geometry.compute_proj(K, w, h), device=dev)[0]
    pts, mask = depth_image_to_points(depth, K)
    obj = pts.reshape(-1, 3)[mask.reshape(-1)].cpu().numpy()
    obj = obj[np.lexsort((obj[:, 0], obj[:, 1], obj[:, 2]))]
    q = obj[rng.choice(len(obj), n_queries, replace=True)] \
        + rng.normal(0, 0.003, (n_queries, 3)).astype(np.float32)
    return obj, torch.as_tensor(q, device=dev)


def tie_lattice(n: int = 8, n_queries: int = 2000, seed: int = 0):
    """(points (n^3, 3), queries (n_queries, 3)) float32 numpy: an integer
    lattice (millimetre units around 300) in a seeded random column order,
    and queries at lattice points, edge and face midpoints and cell centres
    (offsets 0 or 1/2 an axis), so most have 2, 4 or 8 points at exactly
    the same distance. Every score and dist^2 is exact in float32 (integers
    and halves below 2^23), so the smallest index among the minimal scores
    is the only right answer."""
    rng = np.random.default_rng(seed)
    g = np.arange(n, dtype=np.float32) + 296.0
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[rng.permutation(len(pts))]
    base = rng.integers(0, n - 1, (n_queries, 3)).astype(np.float32) + 296.0
    q = base + 0.5 * rng.integers(0, 2, (n_queries, 3)).astype(np.float32)
    return np.ascontiguousarray(pts), q.astype(np.float32)


def compare(i_a, d_a, i_b, d_b) -> dict:
    """Bit-for-bit comparison of two NN results: queries whose idx differ,
    whose dist^2 bits differ, and whether both are 0."""
    n_idx = int((i_a.reshape(-1) != i_b.reshape(-1)).sum())
    n_dist = int((d_a.reshape(-1).view(torch.int32) != d_b.reshape(-1).view(torch.int32)).sum())
    return {"idx_differ": n_idx, "dist_differ": n_dist, "equal": n_idx == 0 and n_dist == 0}


def _median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def run(n_queries: int = N_QUERIES, scale: int = 1, device=None, reps: int = 20) -> dict:
    """The probe: both kernels on the workload, P1 against B2 and against
    P1's plain version, bit for bit. Returns the numbers main() prints;
    times and the screen's counts are None off a card."""
    from pose_refine_tpu_torch.scene import nn_flash as NF
    from pose_refine_tpu_torch.scene import nn_mxu as NM

    obj, q = workload(n_queries, scale, device)
    dev = q.device
    t_b2 = NF.pack_scene(obj).to(dev)
    t_p1 = NM.pack_scene_mxu(obj).to(dev)
    b2 = lambda: NF.nn_flash_packed(q, t_b2)  # noqa: E731
    p1 = lambda: NM.nn_flash_mxu(q, t_p1)  # noqa: E731
    out = {"device": str(dev), "points": len(obj), "table_columns": t_p1.shape[1],
           "queries": n_queries, "eps_c": NM.EPS_C, "b2_ms": None, "p1_ms": None,
           "p1_plain_ms": None, "rescored_mean": None, "rescored_max": None,
           "screen_err_over_eps_max": None}
    before = NF.packed_launches, NM.launches
    i0, d0 = b2()
    i1, d1 = p1()
    # the kernels' launches of the probe's one measured pass (0 on the CPU)
    out["launches"] = {"nn_flash_packed": NF.packed_launches - before[0],
                       "nn_flash_mxu": NM.launches - before[1]}
    if dev.type == "cuda":
        out["b2_ms"], out["p1_ms"] = _median_ms(b2, reps), _median_ms(p1, reps)
        si, sd, rescored, ratio = NM.nn_flash_mxu_cuda(q, t_p1, stats=True)
        out.update(rescored_mean=float(rescored.double().mean()),
                   rescored_max=int(rescored.max()),
                   screen_err_over_eps_max=float(ratio.max()),
                   stats_build_equal=compare(si, sd, i1, d1)["equal"])
    out["vs_b2"] = compare(i1, d1, i0, d0)
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    ip, dp = NM.nn_flash_mxu_plain(q, t_p1)
    if dev.type == "cuda":
        b.record()
        torch.cuda.synchronize()
        out["p1_plain_ms"] = a.elapsed_time(b)
    out["vs_plain"] = compare(i1, d1, ip, dp)
    out["max_abs_err"] = float((d1 - dp).abs().max())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=N_QUERIES)
    ap.add_argument("--scale", type=int, default=1, help="divide 640x480 and the focal lengths")
    ap.add_argument("--device", default=None, help="cuda (default when present) or cpu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    out = run(args.queries, args.scale, args.device, args.reps)
    ms = lambda v: "not measured (no card)" if v is None else f"{v:.4f} ms"  # noqa: E731
    print(f"B2 kernel: {ms(out['b2_ms'])}   P1 kernel: {ms(out['p1_ms'])}   "
          f"({out['points']} points x {out['queries']} queries on {out['device']})")
    for name, key in (("B2", "vs_b2"), ("its plain version", "vs_plain")):
        c = out[key]
        print(f"P1 vs {name}: equal bit for bit: {c['equal']} ({c['idx_differ']} idx, "
              f"{c['dist_differ']} dist^2 differ)")
    if out["rescored_mean"] is not None:
        print(f"re-scored pairs a query: mean {out['rescored_mean']:.2f}, max "
              f"{out['rescored_max']}; largest |screen - B2| / eps_q "
              f"{out['screen_err_over_eps_max']:.3e} (eps_q = {out['eps_c']:.3e} M_q)")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
