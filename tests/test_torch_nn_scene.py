"""The port's NN scene (scene/kdtree.py, scene/nn.py) against the JAX
package's, on the same numpy-made inputs: the kd reorder, the host scene
arrays and every scene table bit for bit, and the query against JAX's CPU
queries. Also the out-of-gate query tile: finite rows, no NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu.ops.rasterize as JR
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu.scene import kdtree as jkd
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu.scene import nn_pallas as JP
from pose_refine_tpu_torch.scene import kdtree as tkd
from pose_refine_tpu_torch.scene import nn as tnn
from pose_refine_tpu_torch.scene import nn_flash as NF

torch.set_num_threads(2)

W, H = 320, 240
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)
TREE_FIELDS = ("points", "normals", "parent", "child", "split_dim", "split_v", "bbox", "bounds")
SCENE_FIELDS = ("points", "normals", "table", "flash_table", "flash_boxes")


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.5
    return K


@pytest.fixture(scope="module")
def scene_depth():
    """The bumpy sphere at the reference viewpoint, 320x240 (the
    test_torch_slice.py scene)."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    proj = jgeo.compute_proj(small_K(), W, H)
    return np.asarray(JR.rasterize_dense(m.tris, truth[None], W, H, proj))[0]


@pytest.mark.parametrize("backend", ["numpy", "auto"])
def test_kdtree_matches_jax(backend):
    """The kd reorder decides every flash chunk's content. Coordinates are
    quantised to 1 mm so that the tie-alternation rule is exercised."""
    rng = np.random.default_rng(3)
    pts = (np.round(rng.normal(size=(3000, 3)) * 50.0) / 1000.0).astype(np.float32)
    nrm = rng.normal(size=(3000, 3)).astype(np.float32)
    want = jkd.build_kdtree(pts, nrm, 10, backend=backend)
    got = tkd.build_kdtree(pts, nrm, 10, backend=backend)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.max_leaf_points() == want.max_leaf_points()


def test_kdtree_refuses_what_it_cannot_build(monkeypatch):
    """backend="native" builds the tree (tests/test_torch_native.py holds it
    to JAX's); without the native library it raises, as JAX's does, while
    "auto" takes the numpy builder. An unknown backend and an empty cloud
    raise."""
    pts = np.zeros((4, 3))
    assert tkd.build_kdtree(pts, pts, backend="native").n_nodes == 1
    with pytest.raises(ValueError, match="unknown kd-tree backend"):
        tkd.build_kdtree(pts, pts, backend="cuda")
    with pytest.raises(ValueError, match="empty cloud"):
        tkd.build_kdtree(np.zeros((0, 3)), np.zeros((0, 3)))
    from pose_refine_tpu_torch import native

    monkeypatch.setattr(native, "build_kdtree_native", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="native kd-tree builder unavailable"):
        tkd.build_kdtree(pts, pts, backend="native")
    assert tkd.build_kdtree(pts, pts).n_nodes == 1


def test_host_scene_arrays_and_voxels_match_jax(scene_depth):
    K = small_K()
    want = jnn._depth_scene_arrays_host(scene_depth, K)
    got = tnn._depth_scene_arrays_host(scene_depth, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pts, nrm, mask = got
    p, n = pts[mask], nrm[mask]
    for vm in (2.0, 4.0):
        for g, w in zip(tnn.voxel_downsample(p, n, vm / 1000.0),
                        jnn.voxel_downsample(p, n, vm / 1000.0)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("voxel_mm", [0.0, 2.0])
def test_scene_tables_match_jax(scene_depth, voxel_mm):
    K = small_K()
    want = jnn.SceneNN.from_depth(scene_depth, K, 0.1, voxel_mm=voxel_mm)
    got = tnn.SceneNN.from_depth(scene_depth, K, 0.1, voxel_mm=voxel_mm, device="cpu")
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.flash_balls.shape == (4, got.flash_table.shape[1] // NF.UB_BALL)
    # the JAX package's default backend, the kd traversal
    assert isinstance(got.max_dist_diff, float) and got.backend == want.backend == "kdtree"
    # from_cloud on the same cloud gives the same tables
    pts, nrm, mask = tnn._depth_scene_arrays_host(scene_depth, K)
    if voxel_mm == 0.0:
        again = tnn.SceneNN.from_cloud(pts[mask], nrm[mask], 0.1, device="cpu")
        for f in SCENE_FIELDS:
            assert torch.equal(getattr(again, f), getattr(got, f)), f


def queries_near(scene_pts, rng, n=1024):
    """Scene points jittered by 20 mm, so some queries lie beyond a 20 mm gate."""
    pick = scene_pts[rng.integers(0, len(scene_pts), n)]
    return (pick + rng.normal(0, 0.02, (n, 3))).astype(np.float32)


def test_query_matches_jax(scene_depth):
    """In-gate rows and validity against the JAX scene: bit for bit against
    its flash backend (the Pallas kernel in interpret mode), and against its
    CPU bruteforce query up to near-ties. That query scores
    |q|^2 - 2 q.s + |s|^2 with a matmul, whose float32 rounding error is a
    few ULPs of |q|^2 (cancellation); where the picks differ, their float64
    distances agree within 4 ULPs of |q|^2."""
    K = small_K()
    gate = 0.02
    jflash = jnn.SceneNN.from_depth(scene_depth, K, gate, backend="flash")
    jbrute = jnn.SceneNN.from_depth(scene_depth, K, gate, backend="bruteforce")
    scene = tnn.SceneNN.from_depth(scene_depth, K, gate, backend="bruteforce", device="cpu")
    q = queries_near(np.asarray(jflash.points), np.random.default_rng(4))
    dst, nrm, valid = scene.query(torch.as_tensor(q))
    jd, jn, jv = map(np.asarray, jflash.query(jnp.asarray(q)))
    dst, nrm, valid = dst.numpy(), nrm.numpy(), valid.numpy()
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(dst[valid], jd[valid])
    np.testing.assert_array_equal(nrm[valid], jn[valid])
    assert np.isfinite(dst).all() and np.isfinite(nrm).all()

    bd, _bn, bv = map(np.asarray, jbrute.query(jnp.asarray(q)))
    both = valid & bv
    assert (valid != bv).sum() <= 2  # only at the gate's edge
    differ = both & (np.abs(dst - bd).max(-1) > 0)
    qd = q[differ].astype(np.float64)
    d_port = ((dst[differ] - qd) ** 2).sum(-1)
    d_jax = ((bd[differ] - qd) ** 2).sum(-1)
    tol = 4 * np.finfo(np.float32).eps * (qd ** 2).sum(-1)
    assert (np.abs(d_port - d_jax) <= tol).all()
    assert differ.sum() <= 0.01 * both.sum()


def test_out_of_gate_tile_gives_finite_rows(scene_depth):
    """A whole query tile farther than the gate from the scene. The JAX
    gated kernel scans no chunk for it and returns its initial state: idx
    0 and dist^2 = BIG (its guard value IBIG - 1 = 2**30 - 1 is not
    reached), so the JAX query reads a finite row 0 with valid False. Had
    it returned the guard value, jnp.take would read NaN rows (fill mode),
    and a CUDA gather would assert. The port's query clamps every index
    into the table before its gather, and gives finite rows, valid False."""
    K = small_K()
    gate = 0.05
    jscene = jnn.SceneNN.from_depth(scene_depth, K, gate, backend="bruteforce")
    rng = np.random.default_rng(9)
    far = (rng.normal(0, 0.01, (JP.GQ_TILE, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
    idx, dist = map(np.asarray, JP.nn_flash_gated(
        far, jscene.flash_table, jscene.flash_boxes, gate, interpret=True))
    assert (idx == 0).all() and (dist == np.float32(JP.BIG)).all()
    assert np.isnan(np.asarray(jnp.take(jscene.table, jnp.array([JP.IBIG - 1]), axis=0))).all()

    scene = tnn.SceneNN.from_depth(scene_depth, K, gate, backend="bruteforce", device="cpu")
    dst, nrm, valid = scene.query(torch.as_tensor(far))
    assert not valid.any()
    assert torch.isfinite(dst).all() and torch.isfinite(nrm).all()
    rows = tnn.gather_rows(scene.table, torch.tensor([[NF.IBIG - 1, -1, 0]], dtype=torch.int32))
    assert rows.shape == (1, 3, 8) and torch.isfinite(rows).all()
    assert torch.equal(rows[0, 0], scene.table[-1]) and torch.equal(rows[0, 1], scene.table[0])
