"""utils.serialization of the port against the JAX package's: every kind of
JAX's ``_KINDS``, saved by one package and loaded by the other, in both
directions, field by field bit for bit (the port's SceneNN through its kd
views); loaded scenes query as the originals do; trees saved before JAX's
round 3 (zero leaf boxes) get their boxes back and find the right
neighbours; a tracking session saved mid-track resumes bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import mesh
from pose_refine_tpu.scene import kdtree as jkd
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu.scene import projective as jproj
from pose_refine_tpu.utils import fusion as jfusion
from pose_refine_tpu.utils import serialization as jser
from pose_refine_tpu_torch.scene import kdtree as tkd
from pose_refine_tpu_torch.scene import nn as tnn
from pose_refine_tpu_torch.scene import projective as tproj
from pose_refine_tpu_torch.utils import fusion as tfusion
from pose_refine_tpu_torch.utils import serialization as tser
from tests.test_torch_session import port_session, session_frames
from tests.test_torch_track import small_K

torch.set_num_threads(2)

JAX_SCENE_NN = ("points", "normals", "table", "flash_table", "flash_boxes", "parent", "child",
                "split_dim", "split_v", "bbox", "bounds", "max_dist_diff")
TREE = ("points", "normals", "parent", "child", "split_dim", "split_v", "bbox", "bounds")


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fields(obj) -> dict:
    """The JAX-named arrays and statics of a JAX or port object."""
    if isinstance(obj, tnn.SceneNN):
        out = {f: host(getattr(obj, f)) for f in JAX_SCENE_NN[:5]}
        if obj.kd is None:
            out.update(max_steps=1, leaf_cap=1)
        else:
            out.update({f: host(getattr(obj.kd, f)) for f in JAX_SCENE_NN[5:11]},
                       max_steps=obj.kd.max_steps, leaf_cap=obj.kd.leaf_cap)
        out.update(max_dist_diff=np.float32(obj.max_dist_diff), backend=obj.backend)
        return out
    if isinstance(obj, jnn.SceneNN):
        out = {f: host(getattr(obj, f)) for f in JAX_SCENE_NN}
        if obj.max_steps == 1:  # device-built: no tree to compare
            out = {f: v for f, v in out.items() if f not in JAX_SCENE_NN[5:11]}
        out.update(max_steps=obj.max_steps, leaf_cap=obj.leaf_cap, backend=obj.backend)
        return out
    if isinstance(obj, tuple):  # RegistrationResult
        return {k: host(v) for k, v in obj._asdict().items() if v is not None}
    out = {}
    for k, v in vars(obj).items():
        if k == "flash_balls":
            continue
        out[k] = v if isinstance(v, (int, str)) else np.float32(host(v)) \
            if k == "max_dist_diff" else host(v)
    return out


def assert_same(a, b):
    fa, fb = fields(a), fields(b)
    if isinstance(b, tnn.SceneNN) and b.kd is None or isinstance(a, tnn.SceneNN) and a.kd is None:
        fa = {k: v for k, v in fa.items() if k not in JAX_SCENE_NN[5:11]}
    assert fa.keys() == fb.keys(), (sorted(fa), sorted(fb))
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
            assert fa[k].dtype == fb[k].dtype, k
        else:
            assert fa[k] == fb[k], k


@pytest.fixture(scope="module")
def inputs():
    """A 60x80 depth of a sphere, two frames of it, and its cloud."""
    K = small_K()
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=2)
    truth = np.asarray(jgeo.pose_from_Rt(np.eye(3, dtype=np.float32),
                                         np.array([0, 0, 300], np.float32)))
    import pose_refine_tpu.ops.rasterize as JR

    depth = np.asarray(JR.rasterize_dense(m.tris, truth[None], 160, 120,
                                          jgeo.compute_proj(K, 160, 120)))[0]
    frames = np.stack([depth, np.roll(depth, 7, axis=1)])
    pts, nrm, mask = tnn._depth_scene_arrays_host(depth, K)
    cloud = (pts[mask], nrm[mask])
    return K, depth, frames, cloud


def jax_objects(inputs):
    K, depth, frames, (pts, nrm) = inputs
    tracker = jfusion.PoseTracker(np.eye(4, dtype=np.float32))
    tracker.predict()
    return {
        "SceneProjective": jproj.SceneProjective.from_depth(depth, K, 0.05),
        "SceneProjectiveStack": jproj.SceneProjectiveStack.from_depths(frames, K, 0.05),
        "SceneNN": jnn.SceneNN.from_cloud(pts, nrm, 0.05),
        "SceneNN-device": jnn.SceneNN.from_depth_device(depth, K, 0.05),
        "SceneNNStack": jnn.SceneNNStack.from_clouds([pts, pts[::2]], [nrm, nrm[::2]], 0.05),
        "KDTree": jkd.build_kdtree(pts, nrm),
        "RegistrationResult": prt.RegistrationResult(
            np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)), np.float32([0.5, 1, 0]),
            np.float32([1e-3, 2e-3, 0]), np.int32([10, 20, 0])),
        "PoseTracker": tracker,
    }


def port_objects(inputs):
    K, depth, frames, (pts, nrm) = inputs
    tracker = tfusion.PoseTracker(np.eye(4, dtype=np.float32))
    tracker.predict()
    cpu = "cpu"
    return {
        "SceneProjective": tproj.SceneProjective.from_depth(depth, K, 0.05, device=cpu),
        "SceneProjectiveStack": tproj.SceneProjectiveStack.from_depths(frames, K, 0.05,
                                                                       device=cpu),
        "SceneNN": tnn.SceneNN.from_cloud(pts, nrm, 0.05, device=cpu),
        "SceneNN-device": tnn.SceneNN.from_depth_device(torch.as_tensor(depth),
                                                        torch.as_tensor(K), 0.05),
        "SceneNNStack": tnn.SceneNNStack.from_clouds([pts, pts[::2]], [nrm, nrm[::2]], 0.05,
                                                     device=cpu),
        "KDTree": tkd.build_kdtree(pts, nrm),
        "RegistrationResult": ptt.RegistrationResult(
            torch.eye(4).repeat(3, 1, 1), torch.tensor([0.5, 1, 0]),
            torch.tensor([1e-3, 2e-3, 0]), torch.tensor([10, 20, 0], dtype=torch.int32)),
        "PoseTracker": tracker,
    }


KINDS = ("SceneProjective", "SceneProjectiveStack", "SceneNN", "SceneNN-device", "SceneNNStack",
         "KDTree", "RegistrationResult", "PoseTracker")


def assert_tracker_same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_loads_in_port(inputs, tmp_path, kind):
    """A file the JAX package saves loads in the port with every array
    (the port's SceneNN: its kd views) bit for bit."""
    obj = jax_objects(inputs)[kind]
    path = str(tmp_path / "x.npz")
    jser.save(path, obj)
    got = tser.load(path, device="cpu")
    if kind == "PoseTracker":
        return assert_tracker_same(got, obj)
    assert_same(got, obj)


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_loads_in_jax_and_port(inputs, tmp_path, kind):
    """A file the port saves loads in the JAX package and in the port,
    each equal to the port's object bit for bit."""
    obj = port_objects(inputs)[kind]
    path = str(tmp_path / "x.npz")
    tser.save(path, obj)
    got_jax, got_port = jser.load(path), tser.load(path, device="cpu")
    if kind == "PoseTracker":
        assert_tracker_same(got_jax, obj)
        return assert_tracker_same(got_port, obj)
    assert_same(obj, got_jax)
    assert_same(got_port, obj)
    if kind.startswith("SceneNN"):
        # the derived table the file does not carry
        torch.testing.assert_close(got_port.flash_balls, obj.flash_balls, rtol=0, atol=0)


def test_port_and_jax_scenes_save_the_same_file(inputs, tmp_path):
    """The two packages write the same arrays for the same NN scene."""
    j, t = jax_objects(inputs)["SceneNN"], port_objects(inputs)["SceneNN"]
    jser.save(str(tmp_path / "j.npz"), j)
    tser.save(str(tmp_path / "t.npz"), t)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for name in zj.files:
            if name != "__meta__":
                np.testing.assert_array_equal(zt[name], zj[name], err_msg=name)


@pytest.mark.parametrize("kind", ["SceneProjective", "SceneNN", "SceneNN-device", "SceneNNStack"])
def test_reloaded_scene_queries_as_the_original(inputs, tmp_path, kind):
    obj = port_objects(inputs)[kind]
    path = str(tmp_path / "x.npz")
    tser.save(path, obj)
    got = tser.load(path, device="cpu")
    rng = np.random.default_rng(0)
    src = torch.as_tensor(host(obj.points if kind != "SceneProjective" else obj.pcd.reshape(-1, 3))
                          [rng.integers(0, 500, 64)] + rng.normal(0, 2e-3, (64, 3)),
                          dtype=torch.float32)
    if kind == "SceneNNStack":
        want, out = obj.query_at(torch.tensor(1))(src), got.query_at(torch.tensor(1))(src)
    else:
        want, out = obj.query(src), got.query(src)
    for a, b in zip(want, out):
        assert torch.equal(a, b)


def zero_leaf_boxes(bbox, child):
    bbox = np.array(bbox, copy=True)
    bbox[np.asarray(child)[:, 0] < 0] = 0.0
    return bbox


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pre_round3_tree_gets_its_leaf_boxes(inputs, tmp_path, writer):
    """A tree saved with zeroed leaf boxes (files from before the JAX
    package's round 3) loads with the boxes rebuilt from its points, and
    its SceneNN's kd traversal finds the exact neighbours."""
    _K, _d, _f, (pts, nrm) = inputs
    tree = tkd.build_kdtree(pts, nrm)
    stale = dataclasses.replace(tree, bbox=zero_leaf_boxes(tree.bbox, tree.child))
    jscene = jnn.SceneNN.from_cloud(pts, nrm, 0.05)
    jstale = dataclasses.replace(jscene, bbox=zero_leaf_boxes(jscene.bbox, jscene.child))
    (jser if writer == "jax" else tser).save(str(tmp_path / "t.npz"), stale)
    jser.save(str(tmp_path / "s.npz"), jstale)
    got = tser.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(got.bbox, tree.bbox)
    np.testing.assert_array_equal(tkd.ensure_leaf_bboxes(tree.points, tree.child, tree.bounds,
                                                         stale.bbox), tree.bbox)
    scene = tser.load(str(tmp_path / "s.npz"), device="cpu")
    np.testing.assert_array_equal(host(scene.kd.bbox), tree.bbox)
    rng = np.random.default_rng(1)
    q = torch.as_tensor(pts[rng.integers(0, len(pts), 200)] + rng.normal(0, 5e-3, (200, 3)),
                        dtype=torch.float32)
    idx, d2 = tnn.nn_kdtree_plain(q, scene.kd)
    want = ((q[:, None, :].double() - scene.points[None].double()) ** 2).sum(-1).min(dim=1)
    np.testing.assert_allclose(d2.numpy(), want.values.numpy(), rtol=1e-5, atol=1e-12)


def test_session_file_resumes_bit_exact(tmp_path):
    """A TrackingSession saved to .npz after one frame and reloaded with a
    fresh refiner tracks the next frames as the uninterrupted session."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    start, _truths, frames = session_frames(m, n=3, seed=11)
    session = port_session(m, start, seed=5, max_innovation=(0.5, 0.05))
    session.step(frames[0])
    path = str(tmp_path / "s.npz")
    tser.save(path, session)
    want = [session.step(f).pose for f in frames[1:]]
    fresh = port_session(m, start, seed=0).refiner
    resumed = tser.load(path, refiner=fresh)
    assert resumed.n_frames == 1 and resumed.max_innovation == (0.5, 0.05)
    for f, w in zip(frames[1:], want):
        np.testing.assert_array_equal(resumed.step(f).pose, w)
    with pytest.raises(ValueError, match="refiner"):
        tser.load(path)


@pytest.mark.parametrize("kind", ["TrackingSession", "MultiObjectSession"])
def test_session_files_cross_packages(tmp_path, kind):
    """Sessions saved by either package load in the other with the same
    state: filters, rng stream, loop configuration."""
    m = mesh.make_icosphere(40.0, 1)
    K = small_K()
    start = np.asarray(jgeo.pose_from_Rt(np.eye(3, dtype=np.float32),
                                         np.array([0, 0, 300], np.float32)))
    kw = dict(width=160, height=120, max_points=512, window=64)
    if kind == "TrackingSession":
        jref = prt.PoseRefiner(m, K=K, **kw)
        tref = ptt.PoseRefiner(m, K=K, device="cpu", **kw)
        jses = prt.TrackingSession(jref, start, n_hypotheses=4, seed=3,
                                   max_innovation=(0.4, 0.04))
        tses = ptt.TrackingSession(tref, start, n_hypotheses=4, seed=3,
                                   max_innovation=(0.4, 0.04))
    else:
        jref = prt.MultiModelRefiner([m, m], K=K, **kw)
        tref = ptt.MultiModelRefiner([m, m], K=K, device="cpu", **kw)
        objs = [(0, start), (1, start)]
        jses = prt.MultiObjectSession(jref, objs, n_hypotheses=4, seed=3)
        tses = ptt.MultiObjectSession(tref, objs, n_hypotheses=4, seed=3)
    for s in [t.tracker if hasattr(t, "tracker") else None for t in (jses, tses)]:
        if s is not None:
            s.predict()
    jser.save(str(tmp_path / "j.npz"), jses)
    tser.save(str(tmp_path / "t.npz"), tses)
    from_jax = tser.load(str(tmp_path / "j.npz"), refiner=tref)
    from_port = jser.load(str(tmp_path / "t.npz"), refiner=jref)
    assert_state_equal(from_jax.state_dict(), tses.state_dict())
    assert_state_equal(from_port.state_dict(), jses.state_dict())


def assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            assert_state_equal(va, vb)
        elif isinstance(va, list) and va and isinstance(va[0], dict):
            for ea, eb in zip(va, vb):
                assert_state_equal(ea, eb)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, k


def test_unknown_kinds_raise(tmp_path):
    with pytest.raises(TypeError, match="serialize"):
        tser.save(str(tmp_path / "x.npz"), object())
