"""devices= data parallelism of the port (parallel/sharding.py) on the CPU:
the padding helpers against the JAX package's on the same numpy inputs,
and the sharded refine, stacked refine, multi-model refine and tracked frame
against the single-device ones bit for bit, over a device list that names
the CPU several times (one shard an entry, as JAX's tests use virtual CPU
devices). The batches do not divide by the shard count, so the padding
runs."""

import numpy as np
import pytest
import torch

import pose_refine_tpu_torch as ptt
from pose_refine_tpu.parallel import sharding as jsh
from pose_refine_tpu_torch import geometry, mesh, pipeline
from pose_refine_tpu_torch.ops import icp_reduce as IR
from pose_refine_tpu_torch.ops.rasterize_cuda import IndexedTris, rasterize_plain
from pose_refine_tpu_torch.parallel import sharding as tsh
from pose_refine_tpu_torch.pipeline import refine_poses

torch.set_num_threads(2)

W, H = 160, 120
CFG = dict(width=W, height=H, render_scale=2, max_points=384, window=48, stride=2)
CPU3 = ["cpu", "cpu", "cpu"]
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)


def small_K():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


@pytest.fixture(scope="module")
def workload():
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=2)
    truth = geometry.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)).numpy()
    proj = geometry.compute_proj(small_K(), W, H)
    depth = rasterize_plain(torch.as_tensor(m.tris), torch.as_tensor(truth[None]), W, H,
                            proj)[0].numpy()
    poses = ptt.sample_hypotheses(truth, 7, rng=0)
    return m, depth, poses


def same(a, b):
    """Equal bit for bit: tensors, or tuples / NamedTuples of them."""
    if isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_pad_and_unpad_match_jax():
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(5, 4, 4)).astype(np.float32)
    tris = rng.normal(size=(5, 6, 3, 3)).astype(np.float32)
    jp, jt, jn = jsh.pad_to_devices(4, poses, tris)
    tp, tt, tn = tsh.pad_to_devices(4, torch.as_tensor(poses), torch.as_tensor(tris))
    assert jn == tn == 5
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    ids = IndexedTris(torch.zeros(2, 6, 3, 3), torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32))
    _p, ti, _n = tsh.pad_to_devices(4, poses, ids)
    assert ti.ids.tolist() == [1, 0, 1, 1, 0, 1, 1, 1] and ti.table is ids.table
    # a shared (T, 3, 3) mesh and a divisible batch are left alone
    shared = torch.zeros(6, 3, 3)
    p4, t4, n4 = tsh.pad_to_devices(5, poses, shared)
    assert p4.shape[0] == 5 and t4 is shared and n4 == 5
    res = ptt.RegistrationResult(tp.clone(), torch.arange(8.0), torch.arange(8.0), None)
    jres = jsh.unpad_results(5, jp, jp)
    out = tsh.unpad_results(5, tp, res)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jres[0]))
    assert out[1].fitness.tolist() == [0, 1, 2, 3, 4] and out[1].n_points is None
    assert tsh.unpad_results(8, tp, res)[1] is res


def test_shard_pose_batch_and_mesh():
    shards = tsh.shard_pose_batch(CPU3, torch.zeros(6, 4, 4))
    assert [s.shape[0] for s in shards] == [2, 2, 2]
    with pytest.raises(ValueError, match="pad_to_devices"):
        tsh.shard_pose_batch(CPU3, torch.zeros(5, 4, 4))
    if not torch.cuda.is_available():
        assert tsh.make_mesh() == []
        with pytest.raises(ValueError, match="CUDA cards present"):
            tsh.make_mesh(2)


def test_order_batch_keeps_the_whole_batch_order():
    """The iteration kernel's sums depend on the batch's size (slabs_for: 40
    poses of 4,096 points sum in 4 slabs, 20 in 8); a shard summed with
    order_batch=40 equals the whole batch's sums bit for bit, and without
    it does not."""
    rng = np.random.default_rng(2)
    terms = torch.as_tensor(rng.normal(size=(40, 4096, 29)).astype(np.float32))
    assert IR.slabs_for(40, 4096) == 4 and IR.slabs_for(20, 4096) == 8
    whole = IR.ordered_sum(terms)
    half = torch.cat([IR.ordered_sum(terms[:20], 40), IR.ordered_sum(terms[20:], 40)])
    assert torch.equal(half, whole)
    assert not torch.equal(torch.cat([IR.ordered_sum(terms[:20]), IR.ordered_sum(terms[20:])]),
                           whole)


def test_plain_split_refine_keeps_the_whole_batch_order():
    """The kernels' plain versions (refine_poses_split(plain=True)) of 40
    poses of 4,096 points over two shards: a shard alone would sum a pose
    in 8 slabs, the whole batch in 4; each shard's iteration is handed the
    whole batch's size, and the split refine equals the single one bit for
    bit."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=2)
    K = torch.as_tensor(small_K())
    truth = geometry.pose_from_Rt(R_REN, np.array([0, 0, 150], np.float32)).numpy()
    proj = geometry.compute_proj(small_K(), W, H)
    tris = torch.as_tensor(m.tris)
    depth = rasterize_plain(tris, torch.as_tensor(truth[None]), W, H, proj)[0]
    scene = ptt.SceneProjective.from_depth(depth.numpy(), small_K(), 0.02, device="cpu")
    poses = torch.as_tensor(ptt.sample_hypotheses(truth, 40, rng=0))
    kw = dict(width=W, height=H, max_points=4096, window=128, stride=1,
              criteria=ptt.ICPConvergenceCriteria(max_iteration=2))
    want = refine_poses(tris, poses, scene, proj, K, raster=rasterize_plain,
                        query=pipeline._association(scene, None, False, plain=True), **kw)
    assert int(want[1].n_points.min()) == 4096
    assert IR.slabs_for(40, 4096) != IR.slabs_for(20, 4096)
    same(pipeline.refine_poses_split(["cpu", "cpu"], tris, poses, scene, proj, K, plain=True,
                                     **kw), want)


def test_replicas_are_made_once_a_scene():
    """run_sharded keeps each shared object's replica in the caller's memo
    while the object is the same, and replaces it when a new one comes."""
    scene = ptt.SceneProjective.from_depth(np.full((8, 8), 300.0, np.float32), small_K(), 0.01,
                                           device="cpu")
    memo = {}

    def fn(tris, poses, s):
        return poses

    poses, tris = torch.zeros(4, 4, 4), torch.zeros(2, 3, 3)
    tsh.run_sharded(["cpu", "cpu"], fn, tris, poses, (scene,), replicas=memo)
    first = memo[(0, torch.device("cpu"))]
    assert first[0] is scene and memo[("tris", torch.device("cpu"))][0] is tris
    tsh.run_sharded(["cpu", "cpu"], fn, tris, poses, (scene,), replicas=memo)
    assert memo[(0, torch.device("cpu"))][1] is first[1]
    other = scene.to("cpu")
    tsh.run_sharded(["cpu", "cpu"], fn, tris, poses, (other,), replicas=memo)
    assert memo[(0, torch.device("cpu"))][0] is other and len(memo) == 2


@pytest.mark.parametrize("scene", ["projective", "nn"])
def test_sharded_refine_equals_single(workload, scene):
    """refine (with its covariance) and refine_async through devices=
    equal the single-device refine bit for bit."""
    m, depth, poses = workload
    kw = dict(CFG, scene=scene, scene_voxel_mm=2.0 if scene == "nn" else 0.0)
    one = ptt.PoseRefiner(m, K=small_K(), device="cpu", **kw).set_scene_depth(depth)
    split = ptt.PoseRefiner(m, K=small_K(), devices=CPU3, **kw).set_scene_depth(depth)
    assert split.device.type == "cpu" and len(split.devices) == 3
    crit = ptt.ICPConvergenceCriteria(max_iteration=8)
    same(split.refine(poses, crit, with_covariance=True),
         one.refine(poses, crit, with_covariance=True))
    same(split.refine_async(poses, crit).wait(), one.refine(poses, crit))
    # one (4, 4) pose: a batch of one padded to three, squeezed back
    same(split.refine(poses[0], crit), one.refine(poses[0], crit))


def test_sharded_stacked_and_multimodel_refines_equal_single(workload):
    """scene_ids and per-pose meshes are padded and split with their poses."""
    m, depth, poses = workload
    frames = np.stack([depth, np.roll(depth, 3, axis=1)])
    ids = np.array([0, 1, 1, 0, 1, 0, 0], np.int32)
    crit = ptt.ICPConvergenceCriteria(max_iteration=8)
    one = ptt.PoseRefiner(m, K=small_K(), device="cpu", **CFG).set_scene_depths(frames)
    split = ptt.PoseRefiner(m, K=small_K(), devices=["cpu", "cpu"], **CFG)
    split.set_scene_depths(frames)
    same(split.refine(poses, crit, scene_ids=ids), one.refine(poses, crit, scene_ids=ids))
    other = mesh.make_icosphere(45.0, 2)
    mm_one = ptt.MultiModelRefiner([m, other], K=small_K(), device="cpu", **CFG)
    mm_split = ptt.MultiModelRefiner([m, other], K=small_K(), devices=CPU3, **CFG)
    for ref in (mm_one, mm_split):
        ref.set_scene_depth(depth)
    same(mm_split.refine(ids, poses, criteria=crit), mm_one.refine(ids, poses, criteria=crit))
    # a per-pose (N, T, 3, 3) table through refine_poses_sharded
    tris = IndexedTris(mm_one.tris_table, torch.as_tensor(ids)).gathered()
    kw = dict(width=mm_one.render_w, height=mm_one.render_h, max_points=mm_one.max_points,
              criteria=crit, window=mm_one.window, stride=mm_one.stride, roi=mm_one.roi)
    same(tsh.refine_poses_sharded(tris, torch.as_tensor(poses), mm_one.scene, mm_one.proj,
                                  mm_one._K_render_t, mesh=CPU3, **kw),
         refine_poses(tris, torch.as_tensor(poses), mm_one.scene, mm_one.proj,
                      mm_one._K_render_t, **kw))


@pytest.mark.parametrize("scene", ["projective", "nn_bruteforce"])
def test_sharded_track_equals_single(workload, scene):
    """track() (its scene built on every shard's device, the covariance, the
    packed session buffer) through devices= equals the single device's."""
    m, depth, poses = workload
    kw = dict(CFG, scene=scene, scene_pool=2 if scene != "projective" else "auto")
    one = ptt.PoseRefiner(m, K=small_K(), device="cpu", **kw)
    split = ptt.PoseRefiner(m, K=small_K(), devices=CPU3, **kw)
    crit = ptt.ICPConvergenceCriteria(max_iteration=8)
    same(split.track(depth, poses, crit, with_covariance=True),
         one.track(depth, poses, crit, with_covariance=True))
    same(split.track_packed_async(depth, poses, crit).wait(),
         one.track_packed_async(depth, poses, crit).wait())


def test_devices_resolution(workload):
    m, _depth, _poses = workload
    for d in (None, 1, False, ["cpu"]):
        assert ptt.PoseRefiner(m, K=small_K(), device="cpu", devices=d, **CFG).devices is None
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA cards present"):
            ptt.PoseRefiner(m, K=small_K(), device="cpu", devices=2, **CFG)
