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
    got = TC.rasterize(tris_from_numpy(tris), torch.as_tensor(poses), W, H,
                       proj_from_numpy(proj))
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
