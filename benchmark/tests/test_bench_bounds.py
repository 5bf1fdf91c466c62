"""The frozen bound arithmetic: the peaks, the operation counts, and the
work of a fixed input counted alike every time (B1's pixel term from
covered pixels, K1's bound from bytes alone)."""

import numpy as np
import pytest
import torch

from core import bounds, check
from reference.geometry import compute_proj
from reference.icp import icp
from reference.render import render
from reference.scene import ProjectiveScene
from reference.lift import window_lift

K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]],
             np.float32)


def test_peaks_and_counts():
    assert bounds.HBM_BPS == 3.35e12 and bounds.FP32_IPS == 33.5e12
    assert bounds.RASTER_SETUP_OPS == 136 and bounds.RASTER_PIXEL_OPS == 8
    assert bounds.LIFT_POINT_OPS == 10 and bounds.TAIL_OPS == 440 and bounds.MOVE_OPS == 18
    assert bounds.BODY_OPS + bounds.PROJECTIVE_FRONT_OPS == 97


def test_bound_is_the_larger_term():
    assert bounds.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert bounds.bound_s(0, 33.5e12) == pytest.approx(1.0)
    assert bounds.bound_s(3.35e12, 67e12) == pytest.approx(2.0)


def test_formulas():
    assert bounds.raster(2, 10, 100, 8, 4) == (10 * 36 + 2 * 64 + 64 + 2 * 32 * 4,
                                               136 * 20 + 800)
    assert bounds.lift(2, 8, 4, 16, 20) == (2 * 32 * 4 + 36 + 2 * 16 * 13, 64 + 200)
    b, o = bounds.iterate(2, 16, 3, 8, 1, 100, 10, 50)
    assert b == 3 * 2 * (16 * 21 + 77 + 73) and o == 100 * 87 + 10 * 440 + 50 * 18
    assert bounds.nearest(100, 50, 2) == (2 * (1200 + 600 + 800), 0)


def _work():
    """The work of one request of a fixed input, as the traced run counts it."""
    torch.manual_seed(0)
    tris = torch.tensor([[[-20.0, -20.0, 0.0], [20.0, -20.0, 0.0], [0.0, 20.0, 10.0]],
                         [[-20.0, -20.0, 0.0], [0.0, 20.0, 10.0], [-25.0, 15.0, -5.0]]])
    poses = torch.eye(4).repeat(3, 1, 1)
    poses[:, 2, 3] = torch.tensor([300.0, 320.0, 340.0])
    poses[1, 0, 3] = 5.0
    proj = compute_proj(K, 640, 480)
    Kr = K.copy()
    Kr[:2] /= 2
    roi = (64, 40, 256, 160)
    depth, covered = render(tris, poses, 320, 240, proj, roi)
    cloud, valid = window_lift(depth, Kr, 128, 2, 2048, False, roi[0], roi[1])
    frame, _ = render(tris, poses[:1], 640, 480, proj)
    res = icp(cloud, valid, ProjectiveScene(frame[0], K, 0.1).query, 4)

    class Ref:
        rw, rh = 320, 240
    return check.refine_work(Ref, tris.shape[0], 3, roi[2], roi[3], valid, covered, res, 0, 4)


def test_work_repeats_exactly():
    a, b = _work(), _work()
    assert a == b
    (rb, ro), (lb, lo) = a["rasterize"], a["window_lift"]
    assert ro > 136 * 3 * 2 and rb == 2 * 36 + 3 * 64 + 64 + 3 * 256 * 160 * 4
    assert lb == 3 * 256 * 160 * 4 + 36 + 3 * 2048 * 13
    assert a["icp_iterate"][1] > 0 and "nn_kdtree" not in a
