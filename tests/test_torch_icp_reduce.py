"""One ICP pass as association + 29-float reduction (ops/icp_reduce.py,
kernel csrc/icp_reduce.cu) on the CPU: the kernel's plain version against
the JAX package's ``_normal_equations_packed`` and ``_normal_equations`` on
the same numpy inputs, for a projective scene, a stacked projective scene
with ids and an NN scene; ``icp_point_to_plane(reduction="packed")`` against
JAX's and against the port's "matmul"; and a torch emulation of the kernel's
summation order (thread, warp butterfly, warps, slabs) against the float64
sums - it tests the order's accuracy, not the compiled kernel, whose gate is
the ``cuda``-marked cases of tests/test_torch_device.py and chip_smoke.py's
``[assoc-reduce]``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu.ops.rasterize as JR
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import icp as jicp
from pose_refine_tpu import mesh
from pose_refine_tpu.ops import depth_to_cloud as jd2c
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu.scene import projective as jproj
from pose_refine_tpu_torch import icp as ticp
from pose_refine_tpu_torch.ops import icp_reduce as IR
from pose_refine_tpu_torch.scene import nn as tnn
from pose_refine_tpu_torch.scene import projective as tproj
from pose_refine_tpu_torch.utils.interop import results_to_numpy, scene_from_numpy
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 160, 120
GATE = 0.03
# the two packages sum the same float32 terms in different orders: each sum
# against the other relative to the sum of its absolute terms
SUM_RTOL = 1e-5
# the kernel's order against float64 (chip_smoke.py's bar on the card)
ORDER_BAR = 2e-6


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def frames_and_clouds(n=6, p=384, seed=21):
    """Three 120x160 depth frames around 0.3 m (a band of empty pixels),
    and n clouds of p points around them: some outside the frame, beyond
    the gate, at z <= 0, and masked rows."""
    rng = np.random.default_rng(seed)
    depths = rng.integers(285, 315, (3, H, W)).astype(np.int32)
    depths[:, :, :15] = 0
    src = (rng.normal(size=(n, p, 3)) * [0.045, 0.035, 0.015] + [0, 0, 0.3]).astype(np.float32)
    src[0, :3] = [[0.01, 0.01, 0.0], [0.01, -0.01, -0.3], [3.0, 0.0, 0.3]]
    valid = rng.uniform(size=(n, p)) > 0.15
    valid[n - 1] = False  # a pose with no valid point
    return depths, src, valid


def jax_sums(cloud, valid, query):
    """(packed (29,), matmul (AtA, Atb, count, mse)) of one pose from the
    JAX package's two formulations."""
    c, v = jnp.asarray(cloud), jnp.asarray(valid)
    AtA, Atb, count, mse = jicp._normal_equations_packed(c, v, query)
    packed = IR.pack_sums(*(torch.as_tensor(np.asarray(x)) for x in (AtA, Atb, count, mse)))
    matmul = tuple(np.asarray(x) for x in jicp._normal_equations(c, v, query))
    return packed.numpy(), matmul


def check_against_jax(got, scale, jqueries, src, valid):
    """The port's (N, 29) plain sums against JAX's per pose: the count
    exactly, every other sum within SUM_RTOL of the sum of its absolute
    terms, for both JAX formulations."""
    got, scale = got.numpy(), scale.numpy()
    assert got[:, 28].sum() > 0 and got[-1, 28] == 0
    for i, query in enumerate(jqueries):
        packed, (AtA, Atb, count, mse) = jax_sums(src[i], valid[i], query)
        assert packed[28] == got[i, 28] == count
        assert (np.abs(packed - got[i]) <= SUM_RTOL * scale[i] + 1e-30).all()
        g_AtA, g_Atb, _g_count, g_mse = (x.numpy() for x in IR.unpack_sums(torch.as_tensor(got[i])))
        s_AtA, s_Atb, _s_count, s_mse = (x.numpy() for x in
                                         IR.unpack_sums(torch.as_tensor(scale[i])))
        assert (np.abs(AtA - g_AtA) <= SUM_RTOL * s_AtA + 1e-30).all()
        assert (np.abs(Atb - g_Atb) <= SUM_RTOL * s_Atb + 1e-30).all()
        assert abs(mse - g_mse) <= SUM_RTOL * s_mse + 1e-30


def plain_and_scale(cloud, valid, plain_query):
    """assoc_reduce_plain's sums and the float64 sums of their absolute
    terms."""
    sums = IR.assoc_reduce_plain(cloud, valid, plain_query)
    dst, nrm, q_valid = plain_query(cloud)
    terms = IR.packed_terms(cloud.double(), valid, dst.double(), nrm.double(), q_valid)
    return sums, terms.abs().sum(dim=-2)


def test_plain_matches_jax_projective():
    depths, src, valid = frames_and_clouds()
    K = small_K()
    jscene = jproj.SceneProjective.from_depth(depths[0], K, GATE)
    scene = scene_from_numpy(np.asarray(jscene.table), K, GATE, H, W, device="cpu")
    cloud, mask = torch.as_tensor(src), torch.as_tensor(valid)
    sums, scale = plain_and_scale(cloud, mask, functools.partial(scene.query, plain=True))
    check_against_jax(sums, scale, [jscene.query] * len(src), src, valid)
    # the scene's reduce is the kernel alone: CPU tensors raise and count no launch
    before = IR.launches
    with pytest.raises(ValueError, match="CUDA"):
        scene.reduce(cloud, mask)
    assert IR.launches == before


def test_plain_matches_jax_stacked_projective():
    depths, src, valid = frames_and_clouds()
    K = small_K()
    jstack = jproj.SceneProjectiveStack.from_depths(depths, K, GATE)
    stack = tproj.SceneProjectiveStack(
        table=torch.as_tensor(np.asarray(jstack.table)), K=torch.as_tensor(K),
        max_dist_diff=torch.tensor(GATE), height=H, width=W, n_scenes=3)
    ids = np.array([0, 2, 1, 5, -1, 1], np.int32)  # 5 and -1 clamp to frames 2 and 0
    cloud, mask = torch.as_tensor(src), torch.as_tensor(valid)
    sums, scale = plain_and_scale(cloud, mask, stack.query_at(torch.as_tensor(ids), plain=True))
    check_against_jax(sums, scale, [jstack.query_at(int(i)) for i in ids], src, valid)
    with pytest.raises(ValueError, match="CUDA"):
        stack.reduce_at(torch.as_tensor(ids))(cloud, mask)
    # a pose routed to frame 2 differs from the same pose against frame 0
    other = IR.assoc_reduce_plain(cloud, mask, stack.query_at(0, plain=True))
    assert not torch.equal(other[1], sums[1]) and torch.equal(other[0], sums[0])


def test_plain_matches_jax_nn():
    """Against the JAX scene's flash backend (the Pallas kernel in
    interpret mode), whose indices the port's plain NN equals bit for bit."""
    depths, src, valid = frames_and_clouds(n=4, p=256)
    K = small_K()
    jscene = jnn.SceneNN.from_depth(depths[0], K, 0.01, backend="flash")
    scene = tnn.SceneNN.from_depth(depths[0], K, 0.01)
    cloud, mask = torch.as_tensor(src), torch.as_tensor(valid)
    sums, scale = plain_and_scale(cloud, mask, functools.partial(scene.query, plain=True))
    check_against_jax(sums, scale, [jscene.query] * len(src), src, valid)
    with pytest.raises(ValueError, match="CUDA"):
        scene.reduce(cloud, mask)


def test_pack_and_unpack_are_inverse():
    rng = np.random.default_rng(1)
    sums = torch.as_tensor(rng.normal(size=(3, 2, 29)).astype(np.float32))
    AtA, Atb, count, mse = IR.unpack_sums(sums)
    assert AtA.shape == (3, 2, 6, 6) and torch.equal(AtA, AtA.transpose(-1, -2))
    assert torch.equal(AtA[..., 0, :], sums[..., :6]) and torch.equal(AtA[..., 5, 5], sums[..., 20])
    assert torch.equal(count, sums[..., 28]) and torch.equal(mse, sums[..., 27])
    assert torch.equal(IR.pack_sums(AtA, Atb, count, mse), sums)


def test_association_on_cpu_takes_the_query():
    """An Association on CPU tensors reduces its query by the chosen plain
    formulation, bit for bit what the bare callable gives; its fused reduce
    is for CUDA tensors alone."""
    depths, src, valid = frames_and_clouds(n=3, p=200)
    scene = tproj.SceneProjective.from_depth(depths[0], small_K(), GATE, device="cpu")
    cloud, mask = torch.as_tensor(src), torch.as_tensor(valid)

    def no_kernel(_cloud, _valid):
        raise AssertionError("the fused reduce was called for CPU tensors")

    assoc = ticp.Association(scene.query, no_kernel)
    for reduction in ticp.REDUCTIONS:
        for a, b in zip(ticp._normal_equations(cloud, mask, assoc, reduction),
                        ticp._normal_equations(cloud, mask, scene.query, reduction)):
            assert torch.equal(a, b)
    # "packed" is the fused pass's plain version, which plain_association
    # hands to the loop as its reduce
    packed = ticp._normal_equations(cloud, mask, scene.query, "packed")
    plain = ticp.plain_association(functools.partial(scene.query, plain=True))
    for a, b in zip(packed, plain.reduce(cloud, mask)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def clouds_and_scene():
    """The scene of tests/test_torch_icp.py (a bumpy sphere at the demo's
    perturbed pose) and seven source clouds lifted by the JAX window lift +
    compaction: four starts jittered +-0.03 rad / +-3 mm around the scene's
    pose, then tests/test_torch_icp.py's three far starts (the demo start,
    10 deg per axis + 20 mm away, and two jitters of it). Also the true
    cloud -> scene transforms in meters."""
    m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    K = small_K()
    proj = jgeo.compute_proj(K, W, H)
    R_ren = np.array(
        [[0.34768538, 0.93761126, 0.0],
         [0.70540612, -0.26157897, -0.65877056],
         [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    ang = np.float32(10.0 / 180.0 * 3.14)
    rot = np.asarray(jgeo.euler_to_rotation(np.array([ang, ang, ang])))
    pose1 = np.asarray(jgeo.pose_from_Rt(R_ren, np.array([0, 0, 300], np.float32)))
    pose2 = np.asarray(jgeo.pose_from_Rt(rot @ R_ren, np.array([20, 20, 320], np.float32)))
    rng = np.random.default_rng(5)

    def jitter(pose, rad, mm):
        d = np.asarray(jgeo.euler_to_rotation(rng.uniform(-rad, rad, 3).astype(np.float32)))
        return np.asarray(jgeo.pose_from_Rt(
            d @ pose[:3, :3], pose[:3, 3] + rng.uniform(-mm, mm, 3).astype(np.float32)))

    far = [pose1, jitter(pose1, 0.05, 5), jitter(pose1, 0.05, 5)]
    starts = [jitter(pose2, 0.03, 3) for _ in range(N_NEAR)] + far
    depth = np.asarray(JR.rasterize_dense(m.tris, np.stack(starts + [pose2]), W, H, proj))
    clouds, valids, _ = jd2c.window_cloud_batched(depth[:-1], K, window=96, stride=1)
    clouds, valids, _ = zip(*(jd2c.compact_topk(c, v, 2048) for c, v in zip(clouds, valids)))
    scene = jproj.SceneProjective.from_depth(depth[-1], K)

    def meters(pose):
        out = pose.astype(np.float64).copy()
        out[:3, 3] /= 1000.0
        return out

    truths = np.stack([meters(pose2) @ np.linalg.inv(meters(s)) for s in starts])
    return np.stack(clouds), np.stack(valids), scene, K, truths


N_NEAR = 4


def verdicts(T, truths):
    """The bench's verdict per pose, at this frame size: rotation < 3 deg
    and translation < 8 mm of the truth (transforms in meters; a pixel of
    the 160x120 frame is 2 mm at the object, four times the bench's)."""
    return ((rotation_angle_deg(T, truths) < 3.0)
            & (np.linalg.norm(T[:, :3, 3] - truths[:, :3, 3], axis=-1) < 8e-3))


def test_packed_icp_matches_jax_and_matmul(clouds_and_scene):
    """reduction="packed" against the JAX package's with the same option,
    and against the port's "matmul", verdicts agreeing on every cloud.

    Starts near the scene's pose converge, and the formulations land within
    0.02 deg and 0.004 mm of each other (the whole-slice test's residue of
    reduction-order ULPs). The far starts stall some degrees short, where
    association pixels flip from pass to pass and amplify those ULPs: there
    the JAX package's own two formulations split by 7e-4 on the transform
    (0.04 deg / 0.2 mm) on these inputs, so the far starts are held to
    verdicts, 5e-3 of fitness and 2e-3 on the transform, against JAX and
    between the port's two formulations alike."""
    clouds, valids, jscene, K, truths = clouds_and_scene
    tscene = scene_from_numpy(np.asarray(jscene.table), K, 0.1, H, W, device="cpu")
    crit = ticp.ICPConvergenceCriteria(max_iteration=30)
    runs = {}
    for reduction in ("packed", "matmul"):
        res, _cloud = ticp.icp_point_to_plane(torch.as_tensor(clouds), torch.as_tensor(valids),
                                              tscene.query, crit, reduction=reduction)
        runs[reduction] = results_to_numpy(res)
    jT, jfit = [], []
    for c, v in zip(clouds, valids):
        jres, _ = jicp.icp_point_to_plane(c, v, jscene.query,
                                          jicp.ICPConvergenceCriteria(max_iteration=30),
                                          reduction="packed", chunk_iters=31)
        jT.append(np.asarray(jres.transformation))
        jfit.append(float(jres.fitness))
    jT, jfit = np.stack(jT), np.asarray(jfit)
    packed, matmul = runs["packed"], runs["matmul"]
    assert (packed.fitness > 0.7).all()
    ok = verdicts(packed.transformation, truths)
    assert ok[:N_NEAR].all() and not ok[N_NEAR:].any()  # the far starts stall 11-20 mm short
    near, far = slice(0, N_NEAR), slice(N_NEAR, None)
    for name, T, fit in (("jax packed", jT, jfit),
                         ("port matmul", matmul.transformation, matmul.fitness)):
        assert (ok == verdicts(T, truths)).all(), name
        assert rotation_angle_deg(packed.transformation[near], T[near]).max() <= 0.02, name
        assert np.abs(packed.transformation[near, :3, 3] - T[near, :3, 3]).max() <= 0.004e-3, name
        assert np.abs(packed.fitness - fit).max() <= 5e-3, name
    for T in (jT, matmul.transformation):
        np.testing.assert_allclose(packed.transformation[far], T[far], rtol=0, atol=2e-3)


def test_unknown_reduction_raises():
    q = lambda src: (src, src, torch.ones(src.shape[:-1], dtype=torch.bool))  # noqa: E731
    with pytest.raises(ValueError, match="unknown reduction"):
        ticp.icp_point_to_plane(torch.zeros(8, 3), torch.ones(8, dtype=torch.bool), q,
                                reduction="tree")


def emulate_kernel_order(terms: torch.Tensor) -> torch.Tensor:
    """The sums of (N, P, 29) float32 terms in the order of
    csrc/icp_reduce.cu, written after the kernel and apart from
    ops/icp_reduce.py::ordered_sum: a pose's points split into
    slabs_for(N, P) slabs; in a slab, thread t of 256 adds points t, t +
    256, ... in rising order; a warp's 32 sums merge by an xor butterfly
    (steps 16, 8, 4, 2, 1); the 8 warps are added in warp order; the slabs
    in slab order. One float32 add a step."""
    n, p, k = terms.shape
    slabs = IR.slabs_for(n, p)
    per_slab = -(-p // slabs)
    lanes = torch.arange(32)
    total = None
    for s in range(slabs):
        seg = terms[:, s * per_slab:min((s + 1) * per_slab, p)]
        seg = torch.nn.functional.pad(seg, (0, 0, 0, (-seg.shape[1]) % IR.KERNEL_THREADS))
        seg = seg.reshape(n, -1, IR.KERNEL_THREADS, k)
        acc = torch.zeros((n, IR.KERNEL_THREADS, k))
        for step in range(seg.shape[1]):
            acc = acc + seg[:, step]
        acc = acc.reshape(n, IR.KERNEL_THREADS // 32, 32, k)
        for step in (16, 8, 4, 2, 1):
            acc = acc + acc[:, :, lanes ^ step]
        assert torch.equal(acc[:, :, 0], acc[:, :, 31])  # every lane ends with the warp's sum
        cta = torch.zeros((n, k))
        for w in range(acc.shape[1]):
            cta = cta + acc[:, w, 0]
        total = cta if total is None else total + cta
    return total


@pytest.mark.parametrize("n,p,slabs", [(4, 5000, 8), (16, 2048, 8), (5, 1500, 4),
                                       (140, 300, 1), (256, 2048, 1)])
def test_kernel_summation_order_against_float64(n, p, slabs):
    """The kernel's summation order on the terms of a projective
    association: the plain version's ordered_sum equals an emulation of the
    kernel's butterfly bit for bit, and every sum lies within ORDER_BAR of
    its float64 value relative to the sum of its absolute terms (a thread
    adds at most a few points in a row before the tree takes over, so the
    order is at least as accurate as a running sum), the count exactly."""
    assert IR.slabs_for(n, p) == slabs
    depths, src, valid = frames_and_clouds(n=n, p=p, seed=n + p)
    scene = tproj.SceneProjective.from_depth(depths[0], small_K(), GATE, device="cpu")
    cloud, mask = torch.as_tensor(src), torch.as_tensor(valid)
    dst, nrm, q_valid = scene.query(cloud)
    terms = IR.packed_terms(cloud, mask, dst, nrm, q_valid)
    sums = emulate_kernel_order(terms)
    plain = IR.packed_sums_plain(cloud, mask, dst, nrm, q_valid)
    assert torch.equal(plain, sums) and torch.equal(IR.ordered_sum(terms), sums)
    count_equal, err = IR.sums_error(sums, cloud, mask, dst, nrm, q_valid)
    assert count_equal and err <= ORDER_BAR
    assert torch.equal(terms.sum(dim=1)[:, 28], sums[:, 28]) and float(sums[:, 28].sum()) > 0
    _, running_err = IR.sums_error(terms.cumsum(dim=1)[:, -1], cloud, mask, dst, nrm, q_valid)
    assert err <= max(running_err, 2e-7)


def test_packed_terms_are_the_formulation_of_the_reference():
    """packed_terms writes every product and sum out one operation at a
    time; against the vector form of the same formulation (cross product,
    dot product, outer product) the terms agree to float32 rounding, and
    leading batch axes are kept."""
    depths, src, valid = frames_and_clouds(n=4, p=300, seed=3)
    scene = tproj.SceneProjective.from_depth(depths[0], small_K(), GATE, device="cpu")
    cloud, mask = torch.as_tensor(src).reshape(2, 2, 300, 3), torch.as_tensor(valid).reshape(2, 2, 300)
    dst, nrm, q_valid = scene.query(cloud)
    terms = IR.packed_terms(cloud, mask, dst, nrm, q_valid)
    assert terms.shape == (2, 2, 300, 29)
    v = (q_valid & mask).double()
    c, d, n = cloud.double(), dst.double(), nrm.double()
    arow = torch.cat([torch.linalg.cross(c, n, dim=-1), n], dim=-1) * v[..., None]
    outer = arow[..., :, None] * arow[..., None, :]
    iu = torch.triu_indices(6, 6)
    b = ((d - c) * n).sum(dim=-1) * v
    want = torch.cat([outer[..., iu[0], iu[1]], arow * b[..., None],
                      (((d - c) ** 2).sum(dim=-1) * v)[..., None], v[..., None]], dim=-1)
    torch.testing.assert_close(terms.double(), want, rtol=1e-4, atol=1e-7)
    assert IR.packed_sums_plain(cloud, mask, dst, nrm, q_valid).shape == (2, 2, 29)
