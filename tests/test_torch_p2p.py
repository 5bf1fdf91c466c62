"""Point-to-point ICP and Huber weights (robust_delta) in the port against
the JAX package on the CPU: icp_point_to_point, _p2p_equations,
pose_information, the iteration kernel's plain pass in its four modes, and
PoseRefiner(estimation=..., robust_delta=...), on tests/test_icp_p2p.py's
inputs (fixed correspondences, a Kabsch anchor, a gross outlier) and
tests/test_torch_nn_slice.py's refine workload."""

import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize as JR
import pose_refine_tpu.ops.rasterize_pallas as JRP
import pose_refine_tpu_torch as ptt
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import icp as jicp
from pose_refine_tpu import mesh
from pose_refine_tpu_torch import icp as ticp
from pose_refine_tpu_torch.ops import icp_reduce as IR
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

MODES = [(0.0, False), (0.02, False), (0.0, True), (0.02, True)]
MODE_IDS = ["plane", "plane-huber", "p2p", "p2p-huber"]


def kabsch(src, dst):
    """Closed-form rigid alignment minimising sum |R p + t - q|^2 (SVD form,
    independent of both packages; tests/test_icp_p2p.py:24)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    U, _S, Vt = np.linalg.svd((src - mu_s).T @ (dst - mu_d))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    Rm = Vt.T @ D @ U.T
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = Rm, mu_d - Rm @ mu_s
    return T


def fixed_case(seed, n=400, outlier=False):
    """tests/test_icp_p2p.py's inputs: n points in a 0.2 m cube at z = 0.5,
    the target = the points moved by a small twist (plus one 0.5 m outlier),
    unit normals, all valid."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 0.1, size=(n, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    truth = np.asarray(jgeo.twist_to_mat4(
        np.array([0.05, -0.03, 0.06, 0.012, -0.02, 0.017], np.float32)))
    target = (pts @ truth[:3, :3].T + truth[:3, 3]).astype(np.float32)
    if outlier:
        target[0] += np.float32([0.0, 0.5, 0.0])
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, target, nrm, truth


def queries(target, nrm):
    """The same fixed-correspondence query for both packages (dst does not
    depend on the moving cloud)."""
    def jq(src):
        return jnp.asarray(target), jnp.asarray(nrm), jnp.ones(src.shape[0], bool)

    def tq(src):
        t = torch.as_tensor(target).expand(src.shape)
        return t, torch.as_tensor(nrm).expand(src.shape), torch.ones(src.shape[:-1],
                                                                     dtype=torch.bool)
    return jq, tq


def test_icp_point_to_point_matches_jax_and_kabsch():
    """Exact correspondences: the Gauss-Newton point-to-point ICP lands on
    the Kabsch optimum (0.02 deg, 5e-5 m, tests/test_icp_p2p.py:54), and on
    the JAX package's result to 1e-5 (float32 sums in another order)."""
    pts, target, nrm, _truth = fixed_case(0)
    jq, tq = queries(target, nrm)
    crit = dict(max_iteration=50)
    jres, jcloud = jicp.icp_point_to_point(pts, np.ones(len(pts), bool), jq,
                                           jicp.ICPConvergenceCriteria(**crit))
    tres, tcloud = ticp.icp_point_to_point(torch.as_tensor(pts), torch.ones(len(pts), dtype=bool),
                                           tq, ticp.ICPConvergenceCriteria(**crit))
    T = tres.transformation.double().numpy()
    np.testing.assert_allclose(T, np.asarray(jres.transformation), atol=1e-5)
    np.testing.assert_allclose(tcloud.numpy(), np.asarray(jcloud), atol=1e-5)
    K = kabsch(pts.astype(np.float64), target.astype(np.float64))
    cos = (np.trace(T[:3, :3] @ K[:3, :3].T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.02
    np.testing.assert_allclose(T[:3, 3], K[:3, 3], atol=5e-5)
    assert float(tres.fitness) == 1.0 and float(tres.inlier_rmse) < 1e-4


@pytest.mark.parametrize("robust_delta", [0.0, 0.02])
def test_p2p_equations_match_jax(robust_delta):
    """One point-to-point pass (_p2p_equations) against JAX's on a cloud 2
    mm off its target with a 0.5 m outlier: count and mse equal, J^T J and
    J^T e within 1e-5 of their largest entry (float32 sums in another
    order); Huber weights shrink the outlier's pull. The packed form (the
    iteration kernel's plain pass) agrees with the matrix products to the
    same bar."""
    pts, target, nrm, _ = fixed_case(1, n=300, outlier=True)
    rng = np.random.default_rng(2)
    cloud = (target + rng.normal(0, 0.002, target.shape)).astype(np.float32)
    cloud[0, 1] -= 0.5  # point 0's neighbour lies 0.5 m off: the outlier
    jq, tq = queries(target, nrm)
    valid = np.ones(len(cloud), bool)
    valid[1::17] = False
    want = [np.asarray(x) for x in jicp._p2p_equations(jnp.asarray(cloud), jnp.asarray(valid), jq,
                                                       robust_delta=robust_delta)]
    got = ticp._p2p_equations(torch.as_tensor(cloud), torch.as_tensor(valid), tq, robust_delta)
    packed = ticp._normal_equations(torch.as_tensor(cloud), torch.as_tensor(valid), tq,
                                    "packed", robust_delta, "point_to_point")
    for g in (got, packed):
        assert float(g[2]) == float(want[2])
        np.testing.assert_allclose(float(g[3]), float(want[3]), rtol=1e-5)
        for a, w in zip(g[:2], want[:2]):
            assert np.abs(a.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    if robust_delta:
        plain = jicp._p2p_equations(jnp.asarray(cloud), jnp.asarray(valid), jq)
        assert np.abs(want[1]).max() < 0.5 * np.abs(np.asarray(plain[1])).max()


@pytest.mark.parametrize("estimation", ["point_to_plane", "point_to_point"])
def test_robust_delta_downweights_outliers_as_jax(estimation):
    """tests/test_icp_p2p.py:186: a 10 mm shift and one 0.5 m outlier. With
    Huber weights (20 mm) the recovered shift stays within 0.5 mm of the
    truth, within a fifth of the unweighted error; the port's result equals
    JAX's to 1e-5 in both estimations."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.1, 0.1, size=(200, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    target = pts.copy()
    target[:, 0] += 0.01
    target[0] += np.float32([0.0, 0.5, 0.0])
    nrm = rng.normal(size=(200, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    jq, tq = queries(target, nrm)
    crit = dict(max_iteration=30)
    jfn = jicp.icp_point_to_point if estimation == "point_to_point" else jicp.icp_point_to_plane
    tfn = ticp.icp_point_to_point if estimation == "point_to_point" else ticp.icp_point_to_plane
    valid = np.ones(len(pts), bool)
    t = {}
    for rd in (0.0, 0.02):
        jres, _ = jfn(pts, valid, jq, jicp.ICPConvergenceCriteria(**crit), robust_delta=rd)
        tres, _ = tfn(torch.as_tensor(pts), torch.as_tensor(valid), tq,
                      ticp.ICPConvergenceCriteria(**crit), robust_delta=rd)
        np.testing.assert_allclose(tres.transformation.numpy(), np.asarray(jres.transformation),
                                   atol=1e-5)
        t[rd] = tres.transformation.numpy()[:3, 3]
    if estimation == "point_to_point":  # the plane form sees only n . e
        expect = np.array([0.01, 0.0, 0.0])
        assert np.linalg.norm(t[0.02] - expect) < 0.2 * np.linalg.norm(t[0.0] - expect)
        np.testing.assert_allclose(t[0.02], expect, atol=5e-4)


@pytest.mark.parametrize("robust_delta", [0.0, 0.02])
def test_p2p_pose_information_matches_jax(robust_delta):
    """pose_information(estimation="point_to_point") against JAX's: count
    exact, info within 1e-5 of its largest entry, sigma2 = rss / (3n - 6)
    within 1e-5; with zero residuals the translation block is n I
    (tests/test_icp_p2p.py:208)."""
    pts, target, nrm, _ = fixed_case(4, n=256, outlier=True)
    rng = np.random.default_rng(5)
    cloud = (target + rng.normal(0, 0.001, target.shape)).astype(np.float32)
    jq, tq = queries(target, nrm)
    valid = np.ones(len(cloud), bool)
    kw = dict(robust_delta=robust_delta, estimation="point_to_point")
    want = jicp.pose_information(jnp.asarray(cloud), jnp.asarray(valid), jq, **kw)
    info, sigma2, count = ticp.pose_information(torch.as_tensor(cloud), torch.as_tensor(valid),
                                                tq, **kw)
    assert float(count) == float(want[2]) == len(cloud)
    w = np.asarray(want[0])
    assert np.abs(info.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    np.testing.assert_allclose(float(sigma2), float(want[1]), rtol=1e-5)
    jq0, tq0 = queries(cloud, nrm)
    info0, sigma0, count0 = ticp.pose_information(torch.as_tensor(cloud), torch.as_tensor(valid),
                                                  tq0, **kw)
    np.testing.assert_allclose(info0[3:, 3:].numpy(), float(count0) * np.eye(3), rtol=1e-6)
    assert float(sigma0) == 0.0


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_packed_terms_modes_against_float64(mode):
    """The iteration kernel's plain pass in each mode: the ordered float32
    sums within 2e-6 of float64 (relative to the sum of absolute terms; the
    kernel's sums equal them bit for bit), equal to the matrix-product
    formulation within 1e-5 of its largest entry, with masked points, NaN
    coordinates under the mask and points with no neighbour."""
    robust_delta, p2p = mode
    rng = np.random.default_rng(6)
    n, p = 3, 700
    cloud = torch.as_tensor((rng.normal(0, 0.05, (n, p, 3)) + [0, 0, 0.4]).astype(np.float32))
    dst = cloud + torch.as_tensor(rng.normal(0, 0.01, (n, p, 3)).astype(np.float32))
    nrm = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(n, p, 3))
                                                        .astype(np.float32)), dim=-1)
    valid = torch.as_tensor(rng.uniform(size=(n, p)) > 0.1)
    q_valid = torch.as_tensor(rng.uniform(size=(n, p)) > 0.2)
    sums = IR.packed_sums_plain(cloud, valid, dst, nrm, q_valid, robust_delta, p2p)
    count_equal, err = IR.sums_error(sums, cloud, valid, dst, nrm, q_valid, robust_delta, p2p)
    assert count_equal and err <= 2e-6
    AtA, Atb, count, mse = IR.unpack_sums(sums)
    est = "point_to_point" if p2p else "point_to_plane"
    mm = ticp._normal_equations(cloud, valid, lambda c: (dst, nrm, q_valid), "matmul",
                                robust_delta, est)
    for a, b in zip((AtA, Atb, mse), (mm[0], mm[1], mm[3])):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.equal(count, mm[2])
    # residuals along the points' rays, as projective association gives
    # them: p x diff cancels, and each cross entry is taken to one rounding
    ray = cloud * torch.as_tensor(1.0 + rng.normal(0, 0.01, (n, p, 1)).astype(np.float32))
    sums = IR.packed_sums_plain(cloud, valid, ray, nrm, q_valid, robust_delta, p2p)
    count_equal, err = IR.sums_error(sums, cloud, valid, ray, nrm, q_valid, robust_delta, p2p)
    assert count_equal and err <= 2e-6
    # a NaN coordinate under the mask poisons the sums it enters, as the
    # kernel's; the count stays exact
    cloud[0, 5] = float("nan")
    valid[0, 5] = False
    sums = IR.packed_sums_plain(cloud, valid, dst, nrm, q_valid, robust_delta, p2p)
    count_equal, err = IR.sums_error(sums, cloud, valid, dst, nrm, q_valid, robust_delta, p2p)
    assert count_equal and err <= 2e-6 and bool(sums[0, :27].isnan().any())


def test_plane_mode_without_huber_is_unchanged():
    """robust_delta = 0 (or below) in plane mode is the term list of
    before the modes, bit for bit: the formula below is packed_terms as it
    was (JAX tests/test_icp.py:318 holds the same for JAX)."""
    rng = np.random.default_rng(7)
    cloud = torch.as_tensor((rng.normal(0, 0.05, (2, 300, 3)) + [0, 0, 0.4]).astype(np.float32))
    dst = cloud + torch.as_tensor(rng.normal(0, 0.01, (2, 300, 3)).astype(np.float32))
    nrm = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(2, 300, 3))
                                                        .astype(np.float32)), dim=-1)
    valid = torch.as_tensor(rng.uniform(size=(2, 300)) > 0.1)
    q_valid = torch.as_tensor(rng.uniform(size=(2, 300)) > 0.2)
    v = (q_valid & valid).to(cloud.dtype)
    px, py, pz = cloud.unbind(dim=-1)
    nx, ny, nz = nrm.unbind(dim=-1)
    dx, dy, dz = (dst - cloud).unbind(dim=-1)
    bv = ((dx * nx + dy * ny) + dz * nz) * v
    row = [(py * nz - pz * ny) * v, (pz * nx - px * nz) * v, (px * ny - py * nx) * v,
           nx * v, ny * v, nz * v]
    before = torch.stack([row[i] * row[j] for i in range(6) for j in range(i, 6)]
                         + [r * bv for r in row] + [((dx * dx + dy * dy) + dz * dz) * v, v],
                         dim=-1)
    for rd in (0.0, -1.0):
        now = IR.packed_terms(cloud, valid, dst, nrm, q_valid, robust_delta=rd)
        assert torch.equal(now.view(torch.int32), before.view(torch.int32))


# -------------------------------------------------------------- the refiner

W, H = 320, 240
CFG = dict(render_scale=2, max_points=768, window=64, stride=2, decimate_mm=4.0)
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.5
    return K


@pytest.fixture(scope="module")
def workload():
    """tests/test_torch_nn_slice.py's workload (bumpy sphere, 12
    hypotheses, 4 of them with 3.5x the rotation)."""
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


@pytest.mark.parametrize("kw", [dict(estimation="point_to_point"), dict(robust_delta=0.002),
                                dict(estimation="point_to_point", robust_delta=0.005)],
                         ids=["p2p", "huber", "p2p-huber"])
def test_refiner_options_match_jax(workload, monkeypatch, kw):
    """PoseRefiner(scene="nn_kdtree", estimation=..., robust_delta=...) on
    the CPU against the JAX refiner with the same options, both on the kd
    traversal (equal associations) and the Pallas raster's function: 100%
    verdict agreement and tests/test_torch_nn_slice.py's bounds at every
    pose (0.1 deg, 0.2 mm, 5e-3). Point to point recovers no rotation to
    3 deg in 24 iterations here, in either package (no tangential sliding),
    so its verdicts agree trivially; it still pulls every translation
    toward the truth. Huber weights slow the far steps down to the 1e-5
    latch, which makes a refine sensitive to the last bits of its sums: on
    the gated flash scenes at 5 mm one hypothesis of this workload splits
    by 0.92 deg between the packages (as JAX's own two formulations split,
    tests/test_torch_icp.py), so the plane Huber case runs at 2 mm."""
    monkeypatch.setattr(JRP, "rasterize_pallas",
                        functools.partial(JRP.rasterize_pallas, interpret=True))
    m, K, truth, poses, scene = workload
    cfg = dict(scene="nn_kdtree", scene_voxel_mm=2.0, width=W, height=H, **CFG, **kw)
    jref = prt.PoseRefiner(m, K=K, use_pallas=True, **cfg)
    jref.set_scene_depth(scene)
    jposes, jres = jref.refine(poses, prt.ICPConvergenceCriteria(max_iteration=24))
    tref = ptt.PoseRefiner(m, K=K, device="cpu", **cfg)
    tref.set_scene_depth(scene)
    tposes, tres = tref.refine(poses, ptt.ICPConvergenceCriteria(max_iteration=24))
    jposes, tposes = np.asarray(jposes), tposes.numpy()
    j_ok = rotation_angle_deg(jposes, truth) < 3.0
    np.testing.assert_array_equal(rotation_angle_deg(tposes, truth) < 3.0, j_ok)
    assert rotation_angle_deg(tposes, jposes).max() <= 0.1
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() <= 0.2
    assert np.abs(tres.fitness.numpy() - np.asarray(jres.fitness)).max() <= 5e-3
    start = np.linalg.norm(poses[:, :3, 3] - truth[:3, 3], axis=-1)
    end = np.linalg.norm(tposes[:, :3, 3] - truth[:3, 3], axis=-1)
    assert (end < start).all()
    if "estimation" not in kw:
        assert j_ok.sum() >= 8


def test_estimation_validation_and_projective_warning(caplog):
    """tests/test_icp_p2p.py:260: an unknown estimation is refused; point
    to point with a projective scene warns (ill-posed), with an NN scene
    not."""
    m = mesh.make_icosphere(radius=40.0, subdivisions=1)
    K = small_K()
    with pytest.raises(ValueError, match="estimation"):
        ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", estimation="icp")
    with pytest.raises(ValueError, match="estimation"):
        ticp.pose_information(torch.zeros(4, 3), torch.ones(4, dtype=torch.bool),
                              lambda s: (s, s, torch.ones(4, dtype=torch.bool)), estimation="icp")
    with caplog.at_level(logging.WARNING, logger="pose_refine_tpu_torch"):
        ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", estimation="point_to_point")
    assert any("ill-posed" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="pose_refine_tpu_torch"):
        ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", scene="nn_bruteforce",
                        estimation="point_to_point")
    assert not any("ill-posed" in r.message for r in caplog.records)
