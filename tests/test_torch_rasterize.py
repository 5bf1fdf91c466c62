"""The port's rasterizer against the JAX package's (CPU, no card needed).

Inputs are made with numpy from fixed seeds and fed to both packages. The
port's plain version of the CUDA kernel is held against the Pallas kernel
run in interpret mode, the way tests/test_rasterize.py runs it. The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_device.py, marker ``cuda``, and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import pose_refine_tpu.ops.rasterize as JR
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu.ops.rasterize_pallas import rasterize_pallas
from pose_refine_tpu_torch.ops import rasterize as TR
from pose_refine_tpu_torch.ops import rasterize_cuda as TC
from pose_refine_tpu_torch.utils.interop import proj_from_numpy, tris_from_numpy

torch.set_num_threads(2)

W, H = 160, 120
# the JAX suite's own gate for two raster implementations
# (tests/test_rasterize.py:158): triangle-edge pixels may flip where the
# two evaluate coverage with differently rounded arithmetic
MISMATCH_GATE = 1e-4


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def make_poses(n, seed, z=300.0):
    rng = np.random.default_rng(seed)
    thetas = rng.uniform(-np.pi, np.pi, size=(n, 3)).astype(np.float32)
    R3 = np.asarray(jgeo.euler_to_rotation(thetas))
    t = np.stack(
        [rng.uniform(-20, 20, n), rng.uniform(-20, 20, n), rng.uniform(z * 0.8, z * 1.2, n)],
        axis=-1,
    ).astype(np.float32)
    return np.asarray(jgeo.pose_from_Rt(R3, t))


@pytest.fixture(scope="module")
def setup():
    m = mesh.make_icosphere(radius=40.0, subdivisions=2)  # 320 tris
    tris = m.tris[mesh.morton_order(m.tris)]
    proj = np.asarray(jgeo.compute_proj(small_K(), W, H))
    return tris, proj, make_poses(4, 42)


def _offscreen_case():
    m = mesh.make_icosphere(radius=10.0, subdivisions=1)
    pose = np.asarray(jgeo.pose_from_Rt(np.eye(3, dtype=np.float32),
                                        np.array([5000, 0, 300], np.float32)))
    return m.tris, pose[None]


@pytest.mark.parametrize("case", ["full", "roi", "per_pose", "offscreen"])
def test_plain_matches_pallas_interpret(setup, case):
    tris, proj, poses = setup
    roi = (0, 0, 0, 0)
    if case == "roi":
        roi = (40, 20, 64, 64)
    elif case == "per_pose":
        # (N, T, 3, 3): pose 0 renders the sphere, pose 1 a smaller bumpy one
        other = mesh.make_bumpy_sphere(radius=25.0, subdivisions=2).tris
        tris = np.stack([tris, other[mesh.morton_order(other)]])
        poses = poses[:2]
    elif case == "offscreen":
        tris, poses = _offscreen_case()
    want = np.asarray(rasterize_pallas(tris, poses, W, H, proj, roi=roi, interpret=True))
    got = TC.rasterize_plain(tris, poses, W, H, proj, roi=roi, device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    assert (got != want).mean() < MISMATCH_GATE
    if case == "offscreen":
        assert (got == 0).all()
    else:
        assert (want > 0).sum() > 500  # the comparison covers real content


def test_rasterize_dispatches_to_plain_on_cpu(setup):
    """On a CPU tensor the production entry point is the plain version,
    bit for bit, and launches no kernel."""
    tris, proj, poses = setup
    before = TC.launches
    got = TC.rasterize(tris_from_numpy(tris, "cpu"), torch.as_tensor(poses), W, H,
                       proj_from_numpy(proj, "cpu"))
    want = TC.rasterize_plain(tris, poses, W, H, proj, device="cpu")
    assert torch.equal(got, want)
    assert TC.launches == before


@pytest.mark.parametrize("roi", [(0, 0, 0, 0), (40, 20, 64, 64)])
def test_dense_matches_jax_dense(setup, roi):
    tris, proj, poses = setup
    want = np.asarray(JR.rasterize_dense(tris, poses, W, H, proj, roi=roi))
    got = TR.rasterize_dense(tris, poses, W, H, proj, roi=roi).numpy()
    assert got.shape == want.shape
    assert (got != want).mean() < MISMATCH_GATE


def test_screen_fields_match_jax_within_1ulp():
    """The vertex transform feeds every coverage test: a 1-ULP budget (XLA
    contracts the 3-term dots into FMAs; the port chains the same
    multiply-adds)."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    proj = np.asarray(jgeo.compute_proj(small_K(), W, H))
    poses = make_poses(4, 3)
    want = JR.screen_fields(m.tris, poses, proj, W, H)
    got = TR.screen_fields(m.tris, poses, proj, W, H)
    for w_, g_ in zip(want, got):
        w_ = np.asarray(w_)
        g_ = g_.numpy()
        ulp = np.abs(w_.view(np.int32).astype(np.int64) - g_.view(np.int32).astype(np.int64))
        assert ulp.max() <= 1


def test_triangle_setup_degenerate_triangles_never_cover(setup):
    """Zero-area and non-finite triangles get an empty box, as in the
    Pallas setup (rasterize_pallas.py:119-124)."""
    tris, proj, poses = setup
    bad = np.zeros((3, 3, 3), np.float32)
    bad[1] = [[5, 5, 0], [5, 5, 0], [9, 1, 0]]  # two coincident vertices
    bad[2] = [[np.nan, 0, 0], [1, 0, 0], [0, 1, 0]]
    coef = TC.triangle_setup(torch.as_tensor(bad), torch.as_tensor(poses[:1]),
                             torch.as_tensor(proj), W, H, (0, 0, 0, 0))
    assert coef.shape == (1, 16, 3)
    assert (coef[0, 9] == TC.BIG).all() and (coef[0, 11] == -TC.BIG).all()
    assert (TC.raster_coef_plain(coef, W, H, H, (0, 0, 0, 0)) == 0).all()


# ---------------------------------------------------------------------------
# The tile culling of csrc/rasterize.cu, emulated in torch. These cases test
# the algorithm (which triangles reach a tile), not the compiled kernel; the
# kernel's gate is the ``cuda``-marked cases of tests/test_torch_device.py
# and chip_smoke.py's [kernel] lines.

from pathlib import Path  # noqa: E402
import re  # noqa: E402

from pose_refine_tpu_torch.probes import raster_edges  # noqa: E402

CU = Path(TC.__file__).resolve().parents[1] / "csrc" / "rasterize.cu"


def kernel_constants():
    """The tile shapes, kBlock, kSuper and kChunk as the .cu defines them."""
    src = CU.read_text()
    out = {}
    for name in ("kTileW", "kTileH", "kWideW", "kWideH", "kBlock", "kSuper", "kChunk"):
        m = re.search(rf"\b{name}\s*=\s*(\d+)", src)
        assert m, name
        out[name] = int(m.group(1))
    return out


def _unions(xs, ys, xm, ym, group):
    """(N, G, 4) union boxes of ``group`` consecutive triangles; a partial
    last group is padded with empty boxes, as the kernel's idle lanes."""
    n, t = xs.shape
    pad = (-t) % group

    def g(a, fill, red):
        a = torch.cat([a, torch.full((n, pad), fill)], 1).reshape(n, -1, group)
        a = torch.where(a.isnan(), torch.full_like(a, fill), a)  # fminf / fmaxf drop a NaN
        return red(a, dim=2).values

    return torch.stack([g(xs, TC.BIG, torch.min), g(ys, TC.BIG, torch.min),
                        g(xm, -TC.BIG, torch.max), g(ym, -TC.BIG, torch.max)], -1)


def _meets(box, x_lo, x_hi, y_lo, y_hi):
    return (box[..., 0] <= x_hi) & (box[..., 2] >= x_lo) & (box[..., 1] <= y_hi) & (
        box[..., 3] >= y_lo)


def cover_boxes(tris, poses, proj, width, height, roi):
    """The kernel's culling boxes (cover_box in the .cu), in float32 torch:
    screen_fields' projection with px * reciprocal(z) in place of px / z,
    widened by 1 + |x| 2^-18 and half a pixel below the start, clamped to
    the ROI; fmin / fmax drop a NaN as fminf / fmaxf do. (4, N, T)."""
    tris, poses = torch.as_tensor(tris), torch.as_tensor(poses)
    proj = torch.as_tensor(proj)
    R, t = poses[:, :3, :3], poses[:, :3, 3]

    def dot3(a0, a1, a2, x0, x1, x2):
        return torch.addcmul(torch.addcmul(a0 * x0, a1, x1), a2, x2)

    sx, sy = [], []
    for v in range(3):
        X, Y, Z = (tris[None, :, v, i] for i in range(3))
        cam = [dot3(R[:, i, 0:1], R[:, i, 1:2], R[:, i, 2:3], X, Y, Z) + t[:, i:i + 1]
               for i in range(3)]
        px = dot3(proj[0, 0], proj[0, 1], proj[0, 2], *cam) + proj[0, 3]
        py = dot3(proj[1, 0], proj[1, 1], proj[1, 2], *cam) + proj[1, 3]
        rz = torch.reciprocal(cam[2])
        sx.append(px * rz * (width / 2.0) + width / 2.0)
        sy.append(py * rz * (height / 2.0) + height / 2.0)
    (cmin_x, cmin_y), (cmax_x, cmax_y) = TR._clamp_bounds(width, height, roi)
    out = []
    for s, cmin, cmax in ((sx, cmin_x, cmax_x), (sy, cmin_y, cmax_y)):
        lo = torch.fmin(torch.fmin(s[0], s[1]), s[2])
        hi = torch.fmax(torch.fmax(s[0], s[1]), s[2])
        m = 1.0 + torch.fmax(lo.abs(), hi.abs()) * 2.0 ** -18
        out.append((torch.fmax(lo - m, torch.tensor(cmin)) - 0.5,
                    torch.fmin(hi + m, torch.tensor(cmax))))
    (xs, xm), (ys, ym) = out
    return xs, ys, xm, ym


def tile_lists(coef, cover, out_w, out_h, height, roi, tw, th):
    """{(tile row, tile col): (N, T) bool} - the triangles that reach each
    tw x th tile: the superblock, then the block union of the ``cover``
    boxes meets the tile, then the triangle's own box (``coef``) meets it
    (clipped to the ROI) in at least one integer pixel."""
    c = kernel_constants()
    blk, sup = c["kBlock"], c["kSuper"]
    xs, ys, xm, ym = coef[:, 9], coef[:, 10], coef[:, 11], coef[:, 12]
    n, t = xs.shape
    blocks = _unions(*cover, blk)           # (N, NB, 4)
    supers = _unions(*cover, blk * sup)     # (N, NSB, 4)
    lists = {}
    for ty in range(-(-out_h // th)):
        for tx in range(-(-out_w // tw)):
            x_lo = float(roi[0] + tx * tw)
            x_hi = float(roi[0] + min((tx + 1) * tw, out_w) - 1)
            y_hi = float(height - 1 - roi[1] - ty * th)
            y_lo = float(height - roi[1] - min((ty + 1) * th, out_h))
            sb = _meets(supers, x_lo, x_hi, y_lo, y_hi).repeat_interleave(blk * sup, 1)[:, :t]
            bb = _meets(blocks, x_lo, x_hi, y_lo, y_hi).repeat_interleave(blk, 1)[:, :t]
            x0, x1 = xs.clamp(min=x_lo).ceil(), xm.clamp(max=x_hi).floor()
            y0, y1 = ys.clamp(min=y_lo).ceil(), ym.clamp(max=y_hi).floor()
            own = (xs <= xm) & (ys <= ym) & (x0 <= x1) & (y0 <= y1)
            lists[ty, tx] = sb & bb & own
    return lists


def coverage(coef, out_w, out_h, height, roi):
    """(N, T, out_h, out_w): which triangle writes a depth at which pixel,
    by the plain version's arithmetic (raster_coef_plain)."""
    px = (torch.arange(out_w, dtype=torch.float32) + roi[0])[None, :]
    py = ((height - 1 - roi[1]) - torch.arange(out_h, dtype=torch.float32))[:, None]
    c = coef[:, :, :, None, None]
    kbx, kby, kb0, kgx, kgy, kg0, ddx, ddy, dd0 = (c[:, i] for i in range(9))
    beta = kbx * px + kby * py + kb0
    gamma = kgx * px + kgy * py + kg0
    alpha = 1.0 - beta - gamma
    d = torch.reciprocal(ddx * px + ddy * py + dd0)
    return ((beta >= 0.0) & (gamma >= 0.0) & (alpha >= 0.0)
            & (px >= c[:, 9]) & (px <= c[:, 11]) & (py >= c[:, 10]) & (py <= c[:, 12])
            & (d < TC.BIG))


def edge_case(name, roi):
    tris, poses = raster_edges.cases()[name]
    proj = proj_from_numpy(np.asarray(jgeo.compute_proj(raster_edges.camera_k(),
                                                        raster_edges.WIDTH,
                                                        raster_edges.HEIGHT)), "cpu")
    coef = TC.triangle_setup(torch.as_tensor(tris), torch.as_tensor(poses), proj,
                             raster_edges.WIDTH, raster_edges.HEIGHT, roi)
    cover = cover_boxes(tris, poses, proj, raster_edges.WIDTH, raster_edges.HEIGHT, roi)
    out_w, out_h = TR.roi_shape(raster_edges.WIDTH, raster_edges.HEIGHT, roi)
    return tris, poses, proj, coef, cover, out_w, out_h


@pytest.mark.parametrize("tile", ["narrow", "wide"])
@pytest.mark.parametrize("roi", [(0, 0, 0, 0), raster_edges.ROI], ids=["frame", "roi"])
@pytest.mark.parametrize("name", sorted(raster_edges.cases()))
def test_tile_culling_keeps_every_covering_triangle(name, roi, tile):
    """Every triangle that writes a depth at a pixel of a tile reaches that
    tile's list through the superblock, block and triangle tests; and the
    tiles rendered from their lists alone equal the plain version. Both
    tile shapes the kernel launches."""
    _tris, _poses, _proj, coef, cover, out_w, out_h = edge_case(name, roi)
    h = raster_edges.HEIGHT
    cov = coverage(coef, out_w, out_h, h, roi)
    want = TC.raster_coef_plain(coef, out_w, out_h, h, roi)
    c = kernel_constants()
    tw, th = (c["kTileW"], c["kTileH"]) if tile == "narrow" else (c["kWideW"], c["kWideH"])
    got = torch.zeros_like(want)
    kept = 0
    for (ty, tx), keep in tile_lists(coef, cover, out_w, out_h, h, roi, tw, th).items():
        rows = slice(ty * th, (ty + 1) * th)
        cols = slice(tx * tw, (tx + 1) * tw)
        covering = cov[:, :, rows, cols].any(-1).any(-1)  # (N, T)
        assert not (covering & ~keep).any(), (ty, tx)
        kept += int(keep.sum())
        sub = coef.clone()
        sub[:, 9][~keep], sub[:, 11][~keep] = TC.BIG, -TC.BIG  # culled: an empty box
        tile = TC.raster_coef_plain(sub, out_w, out_h, h, roi)
        got[:, rows, cols] = tile[:, rows, cols]
    assert torch.equal(got, want)
    if name.startswith("empty"):
        assert kept == 0 and not want.any()
    else:
        n_tiles = -(-out_w // tw) * -(-out_h // th)
        assert 0 < kept < n_tiles * coef.shape[0] * coef.shape[2]  # the tests cull
        assert (want != 0).any()


def warp_walk(boxes, chunk):
    """The kernel's walk of one warp's kept boxes, emulated: boxes is a list
    of 32 (ix0, iy1, w, h) or None (a lane whose triangle missed the tile).
    The boxes are cut into chunks of ``chunk`` consecutive pixels and the
    kept ones compacted in lane order; in the round of chunks k0 .. k0 + 31,
    lane l's chunk k0 + l belongs to kept box ``before + popcount(starts
    up to bit l) - 1`` (``before``: boxes starting before k0; bit p of
    ``starts``: a box starts at k0 + p); the row of a chunk's first pixel
    is (local + 0.5) * (1 / w) in float32, truncated, and the lane steps
    along the row from there, wrapping to the next. Returns the visited
    (box, ix, iy)."""
    area = np.array([0 if b is None else b[2] * b[3] for b in boxes])
    chunks = -(-area // chunk)
    first = np.cumsum(chunks) - chunks
    total = int(chunks.sum())
    kept = [j for j in range(32) if chunks[j] > 0]
    seen = []
    for k0 in range(0, total, 32):
        before = sum(1 for j in kept if first[j] < k0)
        starts = 0
        for j in kept:
            if 0 <= first[j] - k0 < 32:
                starts |= 1 << int(first[j] - k0)
        for lane in range(32):
            if k0 + lane >= total:
                continue
            upto = starts & ((2 << lane) - 1)
            j = kept[before + bin(upto).count("1") - 1]
            ix0, iy1, w, _h = boxes[j]
            inv_w = np.float32(1.0) / np.float32(w)
            px0 = (k0 + lane - int(first[j])) * chunk
            r = int(np.float32(np.float32(px0) + np.float32(0.5)) * inv_w)
            col = px0 - r * w
            for e in range(chunk):
                if e < min(chunk, area[j] - px0):
                    seen.append((j, ix0 + col, iy1 - r))
                col += 1
                if col == w:
                    col, r = 0, r + 1
    return seen


@pytest.mark.parametrize("seed", range(4))
def test_warp_walk_visits_every_box_pixel_once(seed):
    """The walk covers each pixel of each kept box exactly once, whatever
    the boxes' sizes (1 pixel to the whole wide tile) and whichever lanes
    missed the tile (at the ends, in runs, all of them)."""
    c = kernel_constants()
    tw, th = c["kWideW"], c["kWideH"]
    rng = np.random.default_rng(seed)
    for trial in range(25):
        boxes = []
        for lane in range(32):
            if rng.random() < (0.3 if trial else 1.0):
                boxes.append(None)
                continue
            w = int(rng.choice([1, 2, 3, 9, tw, int(rng.integers(1, tw + 1))]))
            h = int(rng.choice([1, 2, th, int(rng.integers(1, th + 1))]))
            boxes.append((int(rng.integers(0, 100)), int(rng.integers(0, 100)), w, h))
        want = sorted((j, b[0] + x, b[1] - y) for j, b in enumerate(boxes) if b is not None
                      for y in range(b[3]) for x in range(b[2]))
        assert sorted(warp_walk(boxes, c["kChunk"])) == want


def order_key(v):
    """The kernel's order_key: float32 -> int32 of the same order."""
    b = np.asarray(v, np.float32).view(np.int32)
    return np.where(b >= 0, b, b ^ np.int32(0x7FFFFFFF))


def test_order_key_min_is_the_least_rounded_depth():
    """The tile keeps the least order_key of depth + 0.5 and truncates it
    once: that is the least trunc(depth + 0.5) over the covering triangles,
    for depths of either sign, -0.0 and the clamp limits, and no key is
    INT_MAX (the empty pixel)."""
    rng = np.random.default_rng(0)
    lim = np.float32(2147483520.0)
    special = np.array([0.0, -0.0, 0.5, -0.5, 1e-30, -1e-30, 2.5, -2.5, lim, -lim], np.float32)
    for _trial in range(200):
        k = int(rng.integers(1, 9))
        d = np.concatenate([rng.normal(0, 10.0 ** rng.integers(0, 9), k).astype(np.float32),
                            rng.choice(special, 2)])
        v = (np.clip(d, -lim, lim) + np.float32(0.5)).astype(np.float32)
        keys = order_key(v)
        assert (keys != np.iinfo(np.int32).max).all()
        least = keys.min()
        back = np.int32(least if least >= 0 else least ^ np.int32(0x7FFFFFFF))
        got = int(np.trunc(back.view(np.float32)))
        assert got == int(np.trunc(v).min()) == int(np.trunc(v.min()))


@pytest.mark.parametrize("roi", [(0, 0, 0, 0), (40, 20, 64, 64)])
def test_indexed_table_matches_gathered_and_pallas(setup, roi):
    """An (M, T, 3, 3) table with a row id per pose (IndexedTris, what
    MultiModelRefiner hands the raster) through the plain version equals the
    gathered per-pose table bit for bit, and JAX's Pallas kernel (interpret)
    on that per-pose table within the JAX suite's gate."""
    tris, proj, poses = setup
    other = mesh.make_bumpy_sphere(radius=25.0, subdivisions=2).tris
    table = np.stack([tris, other[mesh.morton_order(other)]]).astype(np.float32)
    ids = np.array([1, 0, 1, 1], np.int32)
    per_pose = table[ids]
    got = TC.rasterize_plain(TC.IndexedTris(torch.as_tensor(table), torch.as_tensor(ids)),
                             poses, W, H, proj, roi=roi, device="cpu")
    gathered = TC.rasterize_plain(per_pose, poses, W, H, proj, roi=roi, device="cpu")
    assert torch.equal(got, gathered)
    assert torch.equal(got, TC.rasterize(TC.IndexedTris(table, ids), torch.as_tensor(poses), W,
                                         H, proj_from_numpy(proj, "cpu"), roi=roi))
    want = np.asarray(rasterize_pallas(per_pose, poses, W, H, proj, roi=roi, interpret=True))
    assert (got.numpy() != want).mean() < MISMATCH_GATE
    assert (want > 0).sum() > 500


@pytest.mark.parametrize("roi", [(0, 0, 0, 0), raster_edges.ROI], ids=["frame", "roi"])
@pytest.mark.parametrize("name", sorted(raster_edges.cases()) + ["bumpy"])
def test_cover_boxes_hold_the_exact_boxes(name, roi):
    """The culling boxes of bin_kernel hold every triangle's exact clamped
    box where that box is not empty (``bumpy``: a bumpy sphere under 64
    random poses, some close to the camera)."""
    if name == "bumpy":
        m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
        tris = m.tris[mesh.morton_order(m.tris)]
        rng = np.random.default_rng(12)
        R3 = np.asarray(jgeo.euler_to_rotation(rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)))
        t = np.stack([rng.uniform(-80, 80, 64), rng.uniform(-80, 80, 64),
                      rng.uniform(20, 600, 64)], -1).astype(np.float32)
        poses = np.asarray(jgeo.pose_from_Rt(R3, t))
        proj = proj_from_numpy(np.asarray(jgeo.compute_proj(raster_edges.camera_k(),
                                                            raster_edges.WIDTH,
                                                            raster_edges.HEIGHT)),
                               "cpu")
        coef = TC.triangle_setup(torch.as_tensor(tris), torch.as_tensor(poses), proj,
                                 raster_edges.WIDTH, raster_edges.HEIGHT, roi)
        cover = cover_boxes(tris, poses, proj, raster_edges.WIDTH, raster_edges.HEIGHT, roi)
    else:
        _tris, _poses, _proj, coef, cover, _w, _h = edge_case(name, roi)
    xs, ys, xm, ym = coef[:, 9], coef[:, 10], coef[:, 11], coef[:, 12]
    live = (xs <= xm) & (ys <= ym)
    assert bool(live.any()) != name.startswith("empty")
    cxs, cys, cxm, cym = cover
    assert bool(((cxs <= xs) & (cys <= ys) & (cxm >= xm) & (cym >= ym))[live].all())
