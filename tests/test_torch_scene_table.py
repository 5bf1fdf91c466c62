"""The projective scene table's plain version (scene/projective.py::
_build_projective_table_plain, the plain version of csrc/scene_table.cu)
against the JAX package's SceneProjective.from_depth table, on the edge
frames of probes/scene_table_cases.py, and the dispatch of
_build_projective_table on the CPU. The kernel itself is held to the
plain version on the card by tests/test_torch_device.py (``-m cuda``)."""

import numpy as np
import pytest
import torch

from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu.scene import projective as jproj
from pose_refine_tpu_torch import geometry as tgeo
from pose_refine_tpu_torch import mesh
from pose_refine_tpu_torch.ops import scene_table as ST
from pose_refine_tpu_torch.pipeline import PoseRefiner
from pose_refine_tpu_torch.probes import scene_table_cases as cases
from pose_refine_tpu_torch.scene import projective as tproj

torch.set_num_threads(2)

K = jgeo.LINEMOD_K.astype(np.float32)
# XLA contracts the points' and the norm's multiply-adds into FMAs, where
# the port rounds each operation alone: a few units in the last place
# apart (measured: 3 on points, 4 on normals)
POINT_ULPS, NORMAL_ULPS = 4, 6


def ulps(got, want):
    """Per-element distance in units in the last place; +0 and -0 are one
    value."""
    g = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    w = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    g = np.where(g < 0, np.int64(-(2 ** 31)) - g, g)  # order the negatives
    w = np.where(w < 0, np.int64(-(2 ** 31)) - w, w)
    return np.abs(g - w)


def assert_table_matches_jax(got, want):
    """The port's (H*W, 8) table against JAX's: the same valid points and
    the same pixels with a normal exactly (the integer gates), each value
    within a few ULPs, the pad zero."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.array_equal(got[:, 2] > 0, want[:, 2] > 0)
    assert np.array_equal((got[:, 3:6] != 0).any(1), (want[:, 3:6] != 0).any(1))
    assert ulps(got[:, 0:3], want[:, 0:3]).max() <= POINT_ULPS
    assert ulps(got[:, 3:6], want[:, 3:6]).max() <= NORMAL_ULPS
    assert not got[:, 6:8].any()


def jax_table(depth):
    return np.asarray(jproj.SceneProjective.from_depth(depth, K).table)


@pytest.mark.parametrize("kind", cases.KINDS)
@pytest.mark.parametrize("shape", sorted(cases.SHAPES))
def test_plain_table_matches_jax(shape, kind):
    h, w = cases.SHAPES[shape]
    depth = cases.frame(kind, h, w, seed=7)
    got = tproj._build_projective_table_plain(torch.as_tensor(depth), torch.as_tensor(K))
    assert got.shape == (h * w, 8)
    assert_table_matches_jax(got.numpy(), jax_table(depth))


@pytest.mark.parametrize("shape", ["odd", "small", "one-row"])
def test_plain_stack_matches_jax_per_frame(shape):
    """The (K, H, W) form: frame k's rows are JAX's table of frame k alone,
    and the stack is the frames' plain tables end to end, bit for bit."""
    h, w = cases.SHAPES[shape]
    frames = cases.stack(h, w, seed=3)
    got = tproj._build_projective_table_plain(torch.as_tensor(frames), torch.as_tensor(K))
    assert got.shape == (len(frames) * h * w, 8)
    for k, depth in enumerate(frames):
        rows = got[k * h * w:(k + 1) * h * w]
        assert_table_matches_jax(rows.numpy(), jax_table(depth))
        alone = tproj._build_projective_table_plain(torch.as_tensor(depth), torch.as_tensor(K))
        assert torch.equal(rows.view(torch.int32), alone.view(torch.int32))


@pytest.mark.parametrize("kind", ["mixed", "steps"])
def test_one_frame_stack_equals_the_frame(kind):
    h, w = cases.SHAPES["odd"]
    depth = cases.frame(kind, h, w, seed=1)
    one = tproj.SceneProjectiveStack.from_depths(depth[None], K, device="cpu")
    alone = tproj.SceneProjective.from_depth(depth, K, device="cpu")
    assert one.n_scenes == 1 and (one.height, one.width) == (h, w)
    assert torch.equal(one.table.view(torch.int32), alone.table.view(torch.int32))
    assert_table_matches_jax(alone.table.numpy(), jax_table(depth))


def test_stack_scene_matches_jax_stack():
    h, w = cases.SHAPES["small"]
    frames = cases.stack(h, w, seed=9)
    got = tproj.SceneProjectiveStack.from_depths(frames, K, device="cpu")
    want = jproj.SceneProjectiveStack.from_depths(frames, K)
    assert got.n_scenes == want.n_scenes == len(frames)
    assert_table_matches_jax(got.table.numpy(), np.asarray(want.table))


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.int64])
def test_cpu_frames_take_the_plain_version(dtype):
    """CPU frames build through the plain version whatever their integer
    type, and no kernel is launched: set_scene_depth, set_scene_depths and
    a tracked frame on the CPU leave scene_table.launches where it was."""
    h, w = cases.SHAPES["small"]
    depth = np.abs(cases.frame("mixed", h, w, seed=2)).astype(dtype)
    before = ST.launches
    want = tproj._build_projective_table_plain(torch.as_tensor(depth.astype(np.int32)),
                                               torch.as_tensor(K))
    got = tproj._build_projective_table(torch.as_tensor(depth), torch.as_tensor(K))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    m = mesh.make_icosphere(30.0, 1)
    ref = PoseRefiner(m, K=K, device="cpu", render_scale=4)
    ref.set_scene_depth(depth)
    assert torch.equal(ref.scene.table.view(torch.int32), want.view(torch.int32))
    ref.set_scene_depths(np.stack([depth, depth]))
    assert ref.scene.n_scenes == 2
    pose = np.asarray(tgeo.pose_from_Rt(np.eye(3, dtype=np.float32),
                                        np.array([0, 0, 900], np.float32)))
    ref.track(depth, pose[None])
    assert ST.launches == before


@pytest.mark.parametrize("shape", [(), (640,), (2, 3, 48, 64)], ids=["rank0", "rank1", "rank4"])
def test_build_raises_on_wrong_rank(shape):
    depth = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(H, W\) frame or \(K, H, W\) frames"):
        tproj._build_projective_table(depth, torch.as_tensor(K))
    with pytest.raises(ValueError, match=r"\(H, W\) frame or \(K, H, W\) frames"):
        ST.scene_table_cuda(depth, torch.as_tensor(K))


@pytest.mark.parametrize("bad_k", [np.eye(4, dtype=np.float32), np.ones(9, np.float32)],
                         ids=["4x4", "flat"])
def test_build_raises_on_wrong_camera(bad_k):
    depth = torch.zeros((12, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="K must be 3 x 3"):
        tproj._build_projective_table(depth, torch.as_tensor(bad_k))
    with pytest.raises(ValueError, match="K must be 3 x 3"):
        ST.scene_table_cuda(depth, torch.as_tensor(bad_k))


def test_kernel_wrapper_refuses_host_frames():
    """scene_table_cuda launches its kernel or raises; it never computes on
    the CPU itself, and counts nothing it did not launch."""
    before = ST.launches
    for depth in (torch.zeros((12, 16), dtype=torch.int32),
                  np.zeros((12, 16), np.int32)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ST.scene_table_cuda(depth, torch.as_tensor(K))
    assert ST.launches == before
