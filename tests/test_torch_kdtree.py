"""The port's kd traversal (scene/nn_kdtree.py) against the JAX package's
``_nn_kdtree`` on the CPU, and the NN kinds that use it: ``SceneNN(backend=
"kdtree")``, ``PoseRefiner(scene="nn_kdtree")`` and ``scene="nn"`` on the
CPU, where both packages pick the kd traversal.

The plain traversal rounds dist^2 and the box distance as XLA's CPU backend
does (fused multiply-adds, see scene/nn_kdtree.py), so idx, dist^2 and the
step count equal JAX's bit for bit on every query, ties and NaN queries
included. The kernel is held against the plain version on the card
(tests/test_torch_device.py, chip_smoke.py's [kd-kernel]).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize as JR
import pose_refine_tpu.ops.rasterize_pallas as JRP
import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu_torch.scene import kdtree as tkd
from pose_refine_tpu_torch.scene import nn as tnn
from pose_refine_tpu_torch.scene import nn_kdtree as TK
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 320, 240
# tests/test_torch_nn_slice.py's scaled bench configuration and bounds
CFG = dict(render_scale=2, max_points=768, window=64, stride=2, decimate_mm=4.0)
ITERS = 24
VERDICT_DEG = 3.0
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.5
    return K


def random_cloud(rng, n=3000):
    """tests/test_kdtree.py's cloud: uniform in a 0.4 m cube at z = 0.5."""
    pts = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


def clouds(name):
    """(points, normals, queries) of one case: test_kdtree.py's clouds and
    queries, a cloud quantised to 1 mm (equal distances, duplicate points),
    a cloud of 64 copies of one point, a single-leaf tree, and edge queries
    (NaN, far enough to overflow every dist^2, duplicates of scene
    points)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "uniform":
        pts, nrm = random_cloud(rng, 3000)
        q = rng.uniform(-0.3, 0.3, size=(1000, 3)).astype(np.float32)
        q[:, 2] += 0.5
    elif name == "quantised":
        pts = (np.round(rng.normal(size=(2000, 3)) * 30.0) / 1000.0).astype(np.float32)
        pts[:, 2] += 0.4
        nrm = np.tile(np.float32([[0, 0, 1]]), (len(pts), 1))
        q = (np.round(rng.normal(size=(800, 3)) * 30.0) / 1000.0 + [0.0005, 0, 0.4])
        q = q.astype(np.float32)
    elif name == "duplicates":
        pts = np.tile(np.float32([[0.1, 0.2, 0.5]]), (64, 1))
        nrm = np.tile(np.float32([[0, 0, -1.0]]), (64, 1))
        q = (rng.normal(size=(50, 3)) * 0.01 + [0.1, 0.2, 0.5]).astype(np.float32)
    else:  # single leaf: fewer points than a leaf holds
        pts, nrm = random_cloud(rng, 5)
        q = rng.uniform(-0.1, 0.1, (20, 3)).astype(np.float32)
    edge = np.float32([[np.nan, 0.0, 0.5], [0.0, np.nan, np.nan], [1e30, 1e30, 1e30],
                       [-1e30, 0.0, 0.5], [10.0, 10.0, 10.0]])
    q = np.concatenate([q, edge, pts[:5]]).astype(np.float32)
    return pts, nrm, q


@pytest.mark.parametrize("name", ["uniform", "quantised", "duplicates", "single_leaf"])
def test_plain_traversal_matches_jax(name):
    """idx, dist^2 and steps bit for bit against JAX _nn_kdtree, and the
    tree arrays of the device form against the JAX scene's."""
    pts, nrm, q = clouds(name)
    js = jnn.SceneNN.from_cloud(pts, nrm, 10.0)
    tree = tkd.KDTreeDevice.from_tree(tkd.build_kdtree(pts, nrm, 10), "cpu")
    for f in ("parent", "child", "split_dim", "split_v", "bbox", "bounds"):
        np.testing.assert_array_equal(getattr(tree, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    assert (tree.leaf_cap, tree.max_steps) == (js.leaf_cap, js.max_steps)
    ji, jd, jst = map(np.asarray, jnn._nn_kdtree(jnp.asarray(q), js, return_steps=True))
    ti, td, tst = TK.nn_kdtree_plain(torch.as_tensor(q), tree, return_steps=True)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy().view(np.int32), jd.view(np.int32))
    np.testing.assert_array_equal(tst.numpy(), jst)
    # NaN and overflowing queries keep the initial state; a far finite one
    # finds a neighbour; a scene point is its own neighbour at distance 0
    assert (ti.numpy()[-10:-6] == 0).all() and (td.numpy()[-10:-6] == TK.FLT_MAX).all()
    assert td.numpy()[-6] < TK.FLT_MAX and (td.numpy()[-5:] == 0).all()
    # batch shape and the wrapper's CPU dispatch
    bi, bd = TK.nn_kdtree(torch.as_tensor(q).reshape(1, -1, 3), tree)
    assert bi.shape == (1, len(q)) and torch.equal(bi[0], ti) and torch.equal(bd[0], td)


def test_plain_traversal_rounds_as_xla():
    """The order of the sum of squares matters: three separately rounded
    products added left to right give other dist^2 bits than JAX on this
    cloud, so the bit-for-bit test above does tell the orders apart."""
    pts, nrm, q = clouds("uniform")
    js = jnn.SceneNN.from_cloud(pts, nrm, 10.0)
    tree = tkd.KDTreeDevice.from_tree(tkd.build_kdtree(pts, nrm, 10), "cpu")
    _ji, jd = map(np.asarray, jnn._nn_kdtree(jnp.asarray(q), js))
    idx, _ = TK.nn_kdtree_plain(torch.as_tensor(q), tree)
    d = tree.points[idx.long(), :3] - torch.as_tensor(q)
    unfused = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]).numpy()
    fin = np.isfinite(q).all(-1) & (np.abs(q) < 1e10).all(-1)
    assert (unfused[fin].view(np.int32) != jd[fin].view(np.int32)).sum() > 0


def test_traversal_matches_scipy_ckdtree():
    """An anchor independent of both packages (tests/test_kdtree.py:324):
    dist^2 against scipy's cKDTree in float64 to float32 evaluation error,
    and more than 99% of the indices the same point."""
    rng = np.random.default_rng(21)
    pts = rng.uniform(-0.2, 0.2, (4000, 3)).astype(np.float32)
    nrm = np.tile(np.float32([[0, 0, 1]]), (4000, 1))
    scene = tnn.SceneNN.from_cloud(pts, nrm, device="cpu")
    q = rng.uniform(-0.25, 0.25, (1000, 3)).astype(np.float32)
    d_ref, i_ref = cKDTree(scene.points.numpy().astype(np.float64)).query(q.astype(np.float64))
    idx, dsq = TK.nn_kdtree(torch.as_tensor(q), scene.kd)
    np.testing.assert_allclose(dsq.numpy(), d_ref ** 2, rtol=2e-3, atol=3e-8)
    assert (idx.numpy() == i_ref).mean() > 0.99


def test_scene_query_kdtree_matches_jax():
    """SceneNN(backend="kdtree").query against the JAX scene's (its default
    backend) on scene points jittered by 20 mm: rows and validity bit for
    bit, some queries beyond the 20 mm gate; the CUDA entry point refuses
    CPU tensors."""
    pts, nrm, _ = clouds("uniform")
    rng = np.random.default_rng(4)
    q = (pts[rng.integers(0, len(pts), 1024)] + rng.normal(0, 0.02, (1024, 3)))
    q = q.astype(np.float32)
    js = jnn.SceneNN.from_cloud(pts, nrm, 0.02)
    ts = tnn.SceneNN.from_cloud(pts, nrm, 0.02, device="cpu")
    assert ts.backend == js.backend == "kdtree"
    got = [x.numpy() for x in ts.query(torch.as_tensor(q))]
    want = [np.asarray(x) for x in js.query(jnp.asarray(q))]
    assert got[2].any() and not got[2].all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    plain = ts.query(torch.as_tensor(q), plain=True)
    assert all(torch.equal(a, torch.as_tensor(b)) for a, b in zip(plain, got))
    with pytest.raises(ValueError, match="CUDA"):
        TK.nn_kdtree_cuda(torch.as_tensor(q), ts.kd)


def test_kd_validation():
    """The JAX package's refusals: no stacked kd scene (JAX nn.py:351-355),
    no kd scene from the device build; an unknown backend."""
    pts, nrm, _ = clouds("uniform")
    with pytest.raises(ValueError, match="the kd traversal binds per-scene trees"):
        tnn.SceneNNStack.from_clouds([pts], [nrm], backend="kdtree", device="cpu")
    with pytest.raises(ValueError, match="unknown SceneNN backend"):
        tnn.SceneNN.from_cloud(pts, nrm, backend="kd", device="cpu")
    grid = tnn.SceneNN.from_depth_device(torch.full((8, 8), 300, dtype=torch.int32),
                                         torch.as_tensor(small_K()))
    assert grid.backend == "bruteforce" and grid.kd is None
    with pytest.raises(ValueError, match="no kd tree"):
        dataclasses.replace(grid, backend="kdtree").query(torch.zeros(4, 3))


def test_nn_backend_choice():
    """_nn_backend (JAX pipeline.py:821-833's rule, the fastest exact
    backend of the runtime): "nn" is the kd traversal on the CPU and on a
    card; the other two kinds name theirs."""
    m = mesh.make_icosphere(40.0, 1)
    want = {"nn": ("kdtree", "kdtree"), "nn_kdtree": ("kdtree", "kdtree"),
            "nn_bruteforce": ("bruteforce", "bruteforce")}
    for kind, (cpu, card) in want.items():
        ref = ptt.PoseRefiner(m, K=small_K(), width=W, height=H, device="cpu", scene=kind)
        assert ref._nn_backend() == cpu
        ref.device = torch.device("cuda")  # the choice only, nothing runs
        assert ref._nn_backend() == card


def bench_clouds():
    """(points, normals) of the bench scene at 320x240 (the icosphere
    stand-in for obj_06 at the reference viewpoint, JAX's dense raster): raw
    and voxelised at 2 mm, the clouds of the kd cells at a quarter of their
    pixels."""
    m = mesh.load_benchmark_model()
    K = small_K()
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    depth = np.asarray(JR.rasterize_dense(m.tris, truth[None], W, H,
                                          jgeo.compute_proj(K, W, H)))[0]
    out = {}
    for label, voxel in (("raw", 0.0), ("2mm", 2.0)):
        [(p, n)] = tnn._host_clouds([depth], K, voxel)
        out[label] = (p, n)
    return out


@pytest.mark.parametrize("name", ["raw", "2mm", "single_leaf", "quantised"])
def test_packed_records_match_jax_scene(name):
    """The 16-byte records (interior [parent, child0, split_v, split_dim],
    leaf [parent, -1, left, right]) and the box rows give back the JAX
    SceneNN's arrays through the field views - child, parent, split_dim,
    split_v, bounds (an interior node's derived from its children's) and
    bbox - on the bench clouds, a single-leaf tree and a quantised cloud
    with equal coordinates; the table's parts are where the kernel reads
    them."""
    if name in ("raw", "2mm"):
        pts, nrm = bench_clouds()[name]
    else:
        pts, nrm, _q = clouds(name)
    js = jnn.SceneNN.from_cloud(pts, nrm, 10.0)
    tree = tnn.SceneNN.from_cloud(pts, nrm, 10.0, device="cpu").kd
    m, p = tree.n_nodes, len(pts)
    assert tree.table.shape == (3 * m + p, 4) and tree.table.dtype == torch.float32
    for f in ("parent", "child", "split_dim", "split_v", "bbox", "bounds"):
        got, want = getattr(tree, f).numpy(), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    rec = tree.records.numpy()
    leaf = np.asarray(js.child)[:, 0] < 0
    np.testing.assert_array_equal(rec[leaf, 2:4], np.asarray(js.bounds)[leaf])
    assert (rec[leaf, 1] == -1).all() and (rec[~leaf, 1] > 0).all()
    np.testing.assert_array_equal(tree.points.numpy()[:, :3], np.asarray(js.points))
    assert (tree.points.numpy()[:, 3] == 0).all() and (tree.boxes.numpy()[:, 3::4] == 0).all()
    assert (tree.leaf_cap, tree.max_steps) == (js.leaf_cap, js.max_steps)
    if name == "single_leaf":
        assert m == 1 and rec.tolist() == [[-1, -1, 0, p]]


@pytest.mark.parametrize("case", ["as_built", "split_at_child0_max", "siblings",
                                  "split_below_child0", "split_above_child1"])
def test_packed_records_refuse_what_the_kernel_cannot_walk(case):
    """KDTreeDevice.from_tree takes a tree only where the kernel's walk is
    JAX's: siblings consecutive, and every split_v between its children's
    boxes on split_dim (the kernel skips a far box by the split plane,
    csrc/nn_kdtree.cu); the builder's trees qualify, a split_v on child 0's
    face still does, one a float32 step past either face does not."""
    pts, nrm, _q = clouds("uniform")
    tree = tkd.build_kdtree(pts, nrm, 10)
    inner = np.flatnonzero(tree.child[:, 0] >= 0)
    node = inner[len(inner) // 2]
    c0, sd = tree.child[node, 0], tree.split_dim[node]
    lo1, hi0 = tree.bbox[c0 + 1, 2 * sd], tree.bbox[c0, 2 * sd + 1]
    if case == "siblings":
        tree.child[node, 1] = c0 + 2
    elif case == "split_at_child0_max":
        tree.split_v[node] = hi0
    elif case == "split_below_child0":
        tree.split_v[node] = np.nextafter(hi0, np.float32(-np.inf))
    elif case == "split_above_child1":
        tree.split_v[node] = np.nextafter(lo1, np.float32(np.inf))
    if case in ("as_built", "split_at_child0_max"):
        assert tkd.KDTreeDevice.from_tree(tree, "cpu").n_nodes == tree.n_nodes
    else:
        with pytest.raises(ValueError, match="siblings" if case == "siblings" else "split_v"):
            tkd.KDTreeDevice.from_tree(tree, "cpu")


@pytest.mark.parametrize("name", ["uniform", "quantised"])
def test_plain_work_counts(name):
    """The work counts of the plain walk, which give K1's bound: leaf
    points scanned are the leaves' sizes, and of the far children tested
    only those the split plane does not settle read their box - fewer than
    all on these clouds; the counts change nothing of the walk."""
    pts, nrm, q = clouds(name)
    tree = tkd.KDTreeDevice.from_tree(tkd.build_kdtree(pts, nrm, 10), "cpu")
    qt = torch.as_tensor(q)
    i, d, st, scanned, tested, box_reads = TK.nn_kdtree_plain(qt, tree, return_steps=True,
                                                              return_work=True)
    i0, d0, st0 = TK.nn_kdtree_plain(qt, tree, return_steps=True)
    assert torch.equal(i, i0) and torch.equal(d, d0) and torch.equal(st, st0)
    assert (box_reads <= tested).all() and (tested <= st).all()
    assert int(box_reads.sum()) < int(tested.sum())
    fin = torch.isfinite(qt).all(-1) & (qt.abs() < 1e10).all(-1)
    assert (scanned[fin] >= 1).all() and (scanned <= st * tree.leaf_cap).all()


@pytest.fixture(scope="module")
def workload():
    """tests/test_torch_nn_slice.py's workload: the bumpy sphere's scene
    depth at the reference viewpoint and 12 hypotheses, 4 of them with 3.5x
    the rotation."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    K = small_K()
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    rng = np.random.default_rng(0)
    ang = rng.uniform(-0.17, 0.17, (12, 3)).astype(np.float32)
    ang[8:] *= 3.5
    d_rot = np.asarray(jgeo.euler_to_rotation(ang))
    d_t = rng.uniform(-20, 20, (12, 3)).astype(np.float32)
    poses = np.zeros((12, 4, 4), np.float32)
    poses[:, :3, :3] = np.einsum("nij,jk->nik", d_rot, truth[:3, :3])
    poses[:, :3, 3] = truth[:3, 3] + d_t
    poses[:, 3, 3] = 1.0
    proj = jgeo.compute_proj(K, W, H)
    scene = np.asarray(JR.rasterize_dense(m.tris, truth[None], W, H, proj))[0]
    return m, K, truth, poses, scene


@pytest.fixture
def pallas_raster(monkeypatch):
    """The JAX refiner's use_pallas=True raster, in interpret mode on the
    CPU (refine_poses_jit imports rasterize_pallas when it traces)."""
    monkeypatch.setattr(JRP, "rasterize_pallas",
                        functools.partial(JRP.rasterize_pallas, interpret=True))


@pytest.mark.parametrize("kind", ["nn_kdtree", "nn"])
def test_kd_refiner_matches_jax(workload, pallas_raster, kind):
    """PoseRefiner(scene=kind) on the CPU against the JAX refiner of the
    same kind on its CPU: both take the kd traversal (for "nn" this closes
    the divergence ROADMAP C recorded, when the port took the flash kernel
    there), and both render through the Pallas raster's function. 100%
    verdict agreement, and tests/test_torch_nn_slice.py's bounds at every
    pose."""
    m, K, truth, poses, scene = workload
    kw = dict(scene=kind, scene_voxel_mm=2.0, width=W, height=H, **CFG)
    jref = prt.PoseRefiner(m, K=K, use_pallas=True, **kw)
    jref.set_scene_depth(scene)
    jposes, jres = jref.refine(poses, prt.ICPConvergenceCriteria(max_iteration=ITERS))
    tref = ptt.PoseRefiner(m, K=K, device="cpu", **kw)
    tref.set_scene_depth(scene)
    assert tref.scene.backend == jref.scene.backend == "kdtree"
    assert tref.scene.points.shape[0] == jref.scene.points.shape[0]
    tposes, tres = tref.refine(poses, ptt.ICPConvergenceCriteria(max_iteration=ITERS))
    jposes, tposes = np.asarray(jposes), tposes.numpy()
    j_ok = rotation_angle_deg(jposes, truth) < VERDICT_DEG
    np.testing.assert_array_equal(rotation_angle_deg(tposes, truth) < VERDICT_DEG, j_ok)
    assert j_ok.sum() >= 8
    assert rotation_angle_deg(tposes, jposes).max() <= MAX_DROT_DEG
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() <= MAX_DT_MM
    assert np.abs(tres.fitness.numpy() - np.asarray(jres.fitness)).max() <= MAX_DFIT
    np.testing.assert_array_equal(tres.n_points.numpy(), np.asarray(jres.n_points))


def test_kd_refiner_refusals_match_jax(workload):
    """scene="nn_kdtree" cannot stack frames or track (JAX
    pipeline.py:931-935, 1253-1258): the same ValueErrors."""
    m, K, truth, poses, scene = workload
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", scene="nn_kdtree", **CFG)
    with pytest.raises(ValueError, match="cannot use scene='nn_kdtree'"):
        ref.set_scene_depths(np.stack([scene, scene]))
    with pytest.raises(ValueError, match="cannot fuse a kd-tree scene build"):
        ref.track(scene, poses)
    jref = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=False, scene="nn_kdtree",
                           **CFG)
    with pytest.raises(ValueError, match="cannot fuse a kd-tree scene build"):
        jref.track(scene, poses)
