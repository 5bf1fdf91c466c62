"""The port's lift (window crop + top-k compaction), normals and projective
scene against the JAX package's, on identical numpy-made inputs."""

import jax
import numpy as np
import pytest
import torch

import pose_refine_tpu.ops.rasterize as JR
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu.ops import depth_to_cloud as jd2c
from pose_refine_tpu.ops.normals import estimate_normals as j_normals
from pose_refine_tpu.scene import projective as jproj
from pose_refine_tpu_torch import geometry as tgeo
from pose_refine_tpu_torch.ops import depth_to_cloud as td2c
from pose_refine_tpu_torch.ops.normals import estimate_normals as t_normals
from pose_refine_tpu_torch.scene import projective as tproj
from pose_refine_tpu_torch.utils.interop import scene_from_numpy

torch.set_num_threads(2)

W, H = 160, 120


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def assert_within_ulp(got, want, ulps=1):
    """float32 arrays equal up to ``ulps`` units in the last place (XLA
    contracts multiply-adds into FMAs where the port rounds each op)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    # +0.0 and -0.0 are one value
    d[(got == 0) & (want == 0)] = 0
    assert d.max() <= ulps


def blob_depths(n, seed, h=H, w=W):
    """(n, h, w) int32 depth batch: one random elliptical blob per image at
    250-400 mm, plus an empty image (the r0 = h, r1 = -1 case)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((n, h, w), np.int32)
    for i in range(n - 1):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        ry, rx = rng.uniform(15, 40), rng.uniform(15, 40)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        out[i][inside] = rng.integers(250, 400, size=inside.sum())
    return out


def distinct_ranks(p):
    r = np.arange(p, dtype=np.int64)
    prod = (r * (2654435761 & 0x7FFFFFFF)) & 0xFFFFFFFF
    prod = np.where(prod >= 2 ** 31, prod - 2 ** 32, prod)
    return len(np.unique(np.mod(prod, p)))


def test_geometry_matches_jax():
    rng = np.random.default_rng(4)
    K = small_K()
    np.testing.assert_array_equal(tgeo.compute_proj(K, W, H).numpy(),
                                  np.asarray(jgeo.compute_proj(K, W, H)))
    v6 = rng.uniform(-0.3, 0.3, (5, 6)).astype(np.float32)
    T_j = np.asarray(jgeo.twist_to_mat4(v6))
    T_t = tgeo.twist_to_mat4(v6).numpy()
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-6)  # sin/cos libraries
    pts = rng.normal(size=(5, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.transform_points(T_j, pts).numpy(),
                               np.asarray(jgeo.transform_points(T_j, pts)), rtol=0, atol=1e-6)
    xs, ys = rng.integers(0, W, 200), rng.integers(0, H, 200)
    dep = rng.integers(0, 900, 200).astype(np.int32)
    pcd_j = np.asarray(jgeo.dep2pcd(xs, ys, dep, K, 3, 2))
    assert_within_ulp(tgeo.dep2pcd(xs, ys, dep, K, 3, 2).numpy(), pcd_j)
    # pcd2dep truncates toward zero, out-of-range values saturate like XLA
    pcd = np.concatenate([pcd_j[dep > 0], np.float32([[0.5, -0.2, 1e-12], [-1, 1, -0.3]])])
    np.testing.assert_array_equal(tgeo.pcd2dep(pcd, K).numpy(), np.asarray(jgeo.pcd2dep(pcd, K)))


def test_hash_rank_collides_off_powers_of_two():
    """The compaction key is a permutation only for power-of-two P; the
    window sizes below exercise both regimes."""
    assert distinct_ranks(4096) == 4096
    assert distinct_ranks(2500) == 2179
    assert distinct_ranks(2304) < 2304


@pytest.mark.parametrize("p", [4096, 2500, 2304])
def test_compact_topk_keeps_the_same_indices(p):
    """Identical kept index sets, in the same order, including where hash
    ranks collide: column 0 of the points carries the row index."""
    rng = np.random.default_rng(p)
    pts = rng.normal(size=(3, p, 3)).astype(np.float32)
    pts[..., 0] = np.arange(p, dtype=np.float32)
    valid = rng.uniform(size=(3, p)) < np.array([[0.9], [0.3], [0.0]])
    k = 700
    j_out = [jd2c.compact_topk(pts[i], valid[i], k) for i in range(3)]
    t_pts, t_v, t_n = td2c.compact_topk(torch.as_tensor(pts), torch.as_tensor(valid), k)
    for i in range(3):
        jp, jv, jn = (np.asarray(a) for a in j_out[i])
        np.testing.assert_array_equal(t_v[i].numpy(), jv)
        np.testing.assert_array_equal(t_pts[i].numpy(), jp)  # a pure gather
        assert int(t_n[i]) == int(jn)


def test_compact_topk_morton_order_matches_jax():
    rng = np.random.default_rng(7)
    sh, sw = 48, 48
    pts = rng.normal(size=(sh * sw, 3)).astype(np.float32)
    pts[:, 0] = np.arange(sh * sw, dtype=np.float32)
    valid = rng.uniform(size=sh * sw) < 0.5
    jp, jv, _ = jd2c.compact_topk(pts, valid, 900, order_shape=(sh, sw))
    tp, tv, _ = td2c.compact_topk(torch.as_tensor(pts), torch.as_tensor(valid), 900,
                                  order_shape=(sh, sw))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_morton_key_matches_jax():
    idx = np.arange(37 * 53, dtype=np.int32)
    want = np.asarray(jd2c.morton_key(jax.numpy.asarray(idx), 37, 53))
    got = td2c.morton_key(torch.as_tensor(idx), 37, 53).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "window,stride,max_points",
    [(64, 1, 1500),    # P = 4096, a permutation
     (100, 2, 500),    # P = 2500, colliding ranks
     (96, 2, 4096)],   # P = 2304 <= max_points: no compaction
)
def test_window_lift_matches_jax(window, stride, max_points):
    """window_cloud_batched + compact_topk fed the same int32 depth batch:
    identical valid masks and kept points, coordinates within 1 ULP."""
    depth = blob_depths(5, seed=window)
    K = small_K()
    tl = (8, 4)
    jp, jv, jn = jd2c.window_cloud_batched(depth, K, window=window, stride=stride,
                                           tl_x=tl[0], tl_y=tl[1])
    tp, tv, tn = td2c.window_cloud_batched(torch.as_tensor(depth), torch.as_tensor(K),
                                           window=window, stride=stride,
                                           tl_x=tl[0], tl_y=tl[1])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert_within_ulp(tp.numpy(), jp)
    p = tp.shape[1]
    if max_points < p:
        jc = jax.vmap(lambda a, b: jd2c.compact_topk(a, b, max_points))(jp, jv)
        tc = td2c.compact_topk(tp, tv, max_points)
        np.testing.assert_array_equal(tc[1].numpy(), np.asarray(jc[1]))
        assert_within_ulp(tc[0].numpy(), jc[0])
        assert (tc[1].sum(dim=1) == torch.clamp(tn, max=max_points)).all()


@pytest.fixture(scope="module")
def rendered_scene():
    """A rendered bumpy-sphere scene depth and its JAX projective scene."""
    m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    K = small_K()
    proj = jgeo.compute_proj(K, W, H)
    R = np.asarray(jgeo.euler_to_rotation(np.array([0.3, -0.2, 0.5], np.float32)))
    pose = np.asarray(jgeo.pose_from_Rt(R, np.array([5, -3, 300], np.float32)))
    depth = np.asarray(JR.rasterize_dense(m.tris, pose[None], W, H, proj))[0]
    return depth, K, jproj.SceneProjective.from_depth(depth, K)


def test_estimate_normals_matches_jax(rendered_scene):
    depth, K, _ = rendered_scene
    want = np.asarray(j_normals(depth, K))
    got = t_normals(torch.as_tensor(depth), torch.as_tensor(K)).numpy()
    # unit vectors; XLA fuses the norm's multiply-adds, so a few ULP apart
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (np.linalg.norm(want, axis=-1) > 0.5).sum() > 1000


def test_projective_table_matches_jax(rendered_scene):
    depth, K, jscene = rendered_scene
    tscene = tproj.SceneProjective.from_depth(depth, K, device="cpu").to("cpu")
    assert (tscene.height, tscene.width) == (H, W)
    np.testing.assert_allclose(tscene.table.numpy(), np.asarray(jscene.table),
                               rtol=0, atol=1e-6)


def test_project_gate_matches_jax(rendered_scene):
    """Same points, same table: identical valid masks, and identical rows
    where valid (one gather at the same pixel)."""
    depth, K, jscene = rendered_scene
    rng = np.random.default_rng(11)
    pcd = np.asarray(jscene.pcd).reshape(-1, 3)
    surf = pcd[pcd[:, 2] > 0]
    src = surf[rng.integers(0, len(surf), 3000)]
    src = src + rng.normal(scale=0.004, size=src.shape).astype(np.float32)
    far = surf[:50] + np.float32([0, 0, 0.3])         # outside the 0.1 m gate
    off = rng.uniform(-1, 1, size=(50, 3)).astype(np.float32) + np.float32([0, 0, 0.3])
    src = np.concatenate([src, far, off]).astype(np.float32)

    jd, jn, jv = (np.asarray(a) for a in jscene.query(src))
    tscene = scene_from_numpy(np.asarray(jscene.table), K, 0.1, H, W, device="cpu")
    td, tn, tv = (a.numpy() for a in tscene.query(torch.as_tensor(src)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td[tv], jd[jv])
    np.testing.assert_array_equal(tn[tv], jn[jv])
    assert 0.5 * len(src) < tv.sum() < len(src)  # both gate outcomes occur
