"""The port's batched point-to-plane ICP against the JAX package's, on the
same clouds, valid masks and scene table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu.ops.rasterize as JR
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import icp as jicp
from pose_refine_tpu import mesh
from pose_refine_tpu.ops import depth_to_cloud as jd2c
from pose_refine_tpu.scene.projective import SceneProjective
from pose_refine_tpu_torch import icp as ticp
from pose_refine_tpu_torch.utils.interop import results_to_numpy, scene_from_numpy

torch.set_num_threads(2)

W, H = 160, 120
# The JAX suite's own tolerances for two implementations of this ICP
# (tests/test_icp.py:122-124, jitted vs numpy loop): the reductions sum in
# a different order, and the 1e-5 convergence latch turns 1-ULP
# differences into ~1e-4 pose deltas.
T_ATOL, FIT_ATOL, RMSE_ATOL = 1e-3, 1e-3, 1e-4


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def demo_poses():
    """The reference acceptance recipe (test.cpp:29-44): a LINEMOD
    viewpoint and that pose perturbed by 10 deg per Euler axis + 20 mm."""
    R_ren = np.array(
        [[0.34768538, 0.93761126, 0.0],
         [0.70540612, -0.26157897, -0.65877056],
         [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    ang = np.float32(10.0 / 180.0 * 3.14)
    rot = np.asarray(jgeo.euler_to_rotation(np.array([ang, ang, ang])))
    pose1 = np.asarray(jgeo.pose_from_Rt(R_ren, np.array([0, 0, 300], np.float32)))
    pose2 = np.asarray(jgeo.pose_from_Rt(rot @ R_ren, np.array([20, 20, 320], np.float32)))
    return pose1, pose2


@pytest.fixture(scope="module")
def clouds_and_scene():
    """Three source clouds (the demo start pose and two jittered starts,
    lifted by the JAX window lift + compaction) and the scene at the
    perturbed pose."""
    m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    K = small_K()
    proj = jgeo.compute_proj(K, W, H)
    pose1, pose2 = demo_poses()
    rng = np.random.default_rng(5)
    starts = [pose1]
    for _ in range(2):
        d = np.asarray(jgeo.euler_to_rotation(rng.uniform(-0.05, 0.05, 3).astype(np.float32)))
        starts.append(np.asarray(jgeo.pose_from_Rt(
            d @ pose1[:3, :3], pose1[:3, 3] + rng.uniform(-5, 5, 3).astype(np.float32))))
    depth = np.asarray(JR.rasterize_dense(m.tris, np.stack(starts + [pose2]), W, H, proj))
    clouds, valids, _ = jd2c.window_cloud_batched(depth[:3], K, window=96, stride=1)
    clouds, valids, _ = zip(*(jd2c.compact_topk(c, v, 2048) for c, v in zip(clouds, valids)))
    scene = SceneProjective.from_depth(depth[3], K)
    return np.stack(clouds), np.stack(valids), scene, K


def test_icp_matches_jax(clouds_and_scene):
    clouds, valids, jscene, K = clouds_and_scene
    crit_j = jicp.ICPConvergenceCriteria(max_iteration=30)
    tscene = scene_from_numpy(np.asarray(jscene.table), K, 0.1, H, W, device="cpu")
    tres, tcloud = ticp.icp_point_to_plane(
        torch.as_tensor(clouds), torch.as_tensor(valids), tscene.query,
        ticp.ICPConvergenceCriteria(max_iteration=30))
    tres = results_to_numpy(tres)
    for i in range(len(clouds)):
        jres, _ = jicp.icp_point_to_plane(clouds[i], valids[i], jscene.query, crit_j,
                                          chunk_iters=31)
        np.testing.assert_allclose(tres.transformation[i], np.asarray(jres.transformation),
                                   rtol=0, atol=T_ATOL)
        assert abs(tres.fitness[i] - float(jres.fitness)) < FIT_ATOL
        assert abs(tres.inlier_rmse[i] - float(jres.inlier_rmse)) < RMSE_ATOL
        assert tres.n_points[i] == float(jres.n_points)
        assert tres.fitness[i] > 0.7  # a real registration, not a trivial one


def test_icp_single_cloud_equals_batch_row(clouds_and_scene):
    clouds, valids, jscene, K = clouds_and_scene
    tscene = scene_from_numpy(np.asarray(jscene.table), K, 0.1, H, W, device="cpu")
    crit = ticp.ICPConvergenceCriteria(max_iteration=10)
    batch, _ = ticp.icp_point_to_plane(torch.as_tensor(clouds), torch.as_tensor(valids),
                                       tscene.query, crit)
    one, cloud = ticp.icp_point_to_plane(torch.as_tensor(clouds[1]),
                                         torch.as_tensor(valids[1]), tscene.query, crit)
    assert one.transformation.shape == (4, 4) and cloud.shape == clouds[1].shape
    # a batch of 1 and a batch of 3 reduce through differently blocked
    # matrix products, so the same latch amplification applies
    torch.testing.assert_close(one.transformation, batch.transformation[1],
                               rtol=0, atol=T_ATOL)


def test_solve_damped_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(4, 50, 6)).astype(np.float32)
    AtA = np.einsum("npi,npj->nij", A, A).astype(np.float32)
    Atb = rng.normal(size=(4, 6)).astype(np.float32)
    got = ticp._solve_damped(torch.as_tensor(AtA), torch.as_tensor(Atb)).numpy()
    for i in range(4):
        want = np.asarray(jicp._solve_damped(jnp.asarray(AtA[i]), jnp.asarray(Atb[i])))
        # f32 Cholesky + one refinement step on both sides
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6)


def test_icp_empty_association_returns_identity():
    """count == 0 aborts (icp.cpp:156): identity, zero scores."""
    cloud = np.random.default_rng(0).uniform(-0.05, 0.05, (2, 256, 3)).astype(np.float32)
    cloud[..., 2] += 10.0

    def query(src):
        z = torch.zeros_like(src)
        return z, z, torch.zeros(src.shape[:-1], dtype=torch.bool)

    res, _ = ticp.icp_point_to_plane(torch.as_tensor(cloud), torch.ones(2, 256, dtype=torch.bool),
                                     query)
    assert torch.equal(res.transformation, torch.eye(4).expand(2, 4, 4))
    assert (res.fitness == 0).all() and (res.inlier_rmse == 0).all()


@pytest.mark.parametrize("reduction", ["packed", "matmul"])
def test_icp_robust_delta_matches_jax(clouds_and_scene, reduction):
    """robust_delta (Huber IRLS, JAX icp.py:102-125) in both formulations.
    One pass against the JAX package's same formulation on the same
    association: count exact, AtA and Atb within 1e-5 of their largest
    entry (float32 sums in another order). The whole ICP: Huber weights at
    2 mm slow the far starts' steps down to the 1e-5 latch, which then
    stops them at an iteration that depends on the sums' last bits; the
    JAX package's own two formulations split there by up to 9.7e-3 on a
    start. So the port is held to T_ATOL plus twice that witness, and to
    the fitness and rmse tolerances."""
    clouds, valids, jscene, K = clouds_and_scene
    tscene = scene_from_numpy(np.asarray(jscene.table), K, 0.1, H, W, device="cpu")
    delta = 0.002
    got = ticp._normal_equations(torch.as_tensor(clouds), torch.as_tensor(valids), tscene.query,
                                 reduction, robust_delta=delta)
    jfn = jicp._normal_equations_packed if reduction == "packed" else jicp._normal_equations
    for i in range(len(clouds)):
        want = jfn(jnp.asarray(clouds[i]), jnp.asarray(valids[i]), jscene.query,
                   robust_delta=delta)
        assert float(got[2][i]) == float(want[2]) > 0
        for g, w in zip(got[:2], want[:2]):
            w = np.asarray(w)
            assert np.abs(g[i].numpy() - w).max() <= 1e-5 * np.abs(w).max()
        # Huber weights change the equations (the scores, count and mse, not)
        plain = jfn(jnp.asarray(clouds[i]), jnp.asarray(valids[i]), jscene.query)
        assert np.abs(np.asarray(plain[0]) - np.asarray(want[0])).max() \
            > 1e-2 * np.abs(np.asarray(want[0])).max()
    crit = ticp.ICPConvergenceCriteria(max_iteration=30)
    tres, _ = ticp.icp_point_to_plane(torch.as_tensor(clouds), torch.as_tensor(valids),
                                      tscene.query, crit, reduction=reduction, robust_delta=delta)
    tres = results_to_numpy(tres)
    for i in range(len(clouds)):
        jres = {r: jicp.icp_point_to_plane(clouds[i], valids[i], jscene.query,
                                           jicp.ICPConvergenceCriteria(max_iteration=30),
                                           reduction=r, chunk_iters=31, robust_delta=delta)[0]
                for r in ("packed", "matmul")}
        witness = np.abs(np.asarray(jres["packed"].transformation)
                         - np.asarray(jres["matmul"].transformation)).max()
        j = jres[reduction]
        assert np.abs(tres.transformation[i] - np.asarray(j.transformation)).max() \
            <= T_ATOL + 2.0 * witness
        assert abs(tres.fitness[i] - float(j.fitness)) < FIT_ATOL
        assert abs(tres.inlier_rmse[i] - float(j.inlier_rmse)) < RMSE_ATOL
        assert tres.fitness[i] > 0.7
