"""The window lift L1 on the CPU: its plain version
(``ops.depth_to_cloud.window_lift``) against the JAX package's pipeline lift
(pipeline.py:111-146: window_cloud_batched, then compact_topk under
jax.vmap or the Morton permutation), and a numpy model of the kernel's
ranking (``csrc/lift.cu``: bucket counts, a scan, buckets ordered by slot,
Morton ranks counted level by level, one scan over the Morton ranks) against
JAX's compact_topk and morton_key. The kernel itself runs only on a card
(tests/test_torch_device.py's ``cuda`` cases, chip_smoke.py's [lift])."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu.ops import depth_to_cloud as jd2c
from pose_refine_tpu_torch.ops import depth_to_cloud as td2c
from pose_refine_tpu_torch.ops import lift_cuda as LC
from pose_refine_tpu_torch.pipeline import _window_lift
from pose_refine_tpu_torch.probes.lift_cases import SHAPES, renders
from pose_refine_tpu_torch.scene.nn import SceneNN
from pose_refine_tpu_torch.scene.projective import SceneProjective

torch.set_num_threads(2)

HASH_MUL = 2654435761 & 0x7FFFFFFF
CPU_SHAPES = [name for name in SHAPES if name != "p65536"]


def camera(h, w):
    """LINEMOD's K scaled to an (h, w) render."""
    K = np.asarray(jgeo.LINEMOD_K, np.float32).copy()
    K[0] *= w / 640.0
    K[1] *= h / 480.0
    return K


def jax_lift(depth, K, window, stride, max_points, morton, tl):
    """JAX pipeline.py:111-146, the window branch of refine_poses_jit."""
    wh = -(-min(window, depth.shape[1]) // stride)
    ww = -(-min(window, depth.shape[2]) // stride)
    clouds, valids, _n = jd2c.window_cloud_batched(depth, K, window=window, stride=stride,
                                                   tl_x=tl[0], tl_y=tl[1])
    if max_points < wh * ww:
        clouds, valids, _n = jax.vmap(lambda p, v: jd2c.compact_topk(
            p, v, max_points, order_shape=(wh, ww) if morton else None))(clouds, valids)
    elif morton:
        perm = jnp.argsort(jd2c.morton_key(jnp.arange(wh * ww, dtype=jnp.int32), wh, ww))
        clouds = jnp.take(clouds, perm, axis=1)
        valids = jnp.take(valids, perm, axis=1)
    return np.asarray(clouds), np.asarray(valids)


def assert_within_ulp(got, want, ulps=1):
    """float32 arrays equal up to ``ulps`` units in the last place (the CPU
    divides the depth by 1000 where XLA multiplies by its reciprocal); +0
    and -0 are one value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    d[(got == 0) & (want == 0)] = 0
    assert d.max() <= ulps


def case(name, seed=0):
    h, w, window, stride, k, tl = SHAPES[name]
    return renders(h, w, seed), camera(h, w), window, stride, k, tl


@pytest.mark.parametrize("morton", [False, True], ids=["projective", "morton"])
@pytest.mark.parametrize("name", CPU_SHAPES)
def test_window_lift_matches_jax_pipeline_lift(name, morton):
    """window_lift == JAX's pipeline lift on the same int32 renders: valid
    masks equal, the same slot in every row (a valid pixel's depth is
    unique, so z names it), coordinates within 1 ULP."""
    depth, K, window, stride, k, tl = case(name)
    jc, jv = jax_lift(depth, K, window, stride, k, morton, tl)
    tc, tv = td2c.window_lift(torch.as_tensor(depth), torch.as_tensor(K), window=window,
                              stride=stride, max_points=k, morton=morton, tl_x=tl[0],
                              tl_y=tl[1])
    sh, sw = td2c.window_grid(depth.shape[1], depth.shape[2], window, stride)
    assert tc.shape == (depth.shape[0], min(k, sh * sw), 3) and tv.dtype == torch.bool
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(np.rint(tc[..., 2].numpy() * 1000), np.rint(jc[..., 2] * 1000))
    assert_within_ulp(tc.numpy(), jc)
    assert not tc.numpy()[~tv.numpy()].any()  # invalid rows are zero


def test_pipeline_lift_on_the_cpu_is_the_plain_version():
    """pipeline._window_lift of CPU renders is window_lift, in Morton order
    exactly for the NN scenes."""
    depth, K, window, stride, k, tl = case("p4096", seed=3)
    d = torch.as_tensor(depth)
    proj_scene = object.__new__(SceneProjective)
    nn_scene = object.__new__(SceneNN)
    for scene, morton in ((proj_scene, False), (nn_scene, True)):
        got = _window_lift(d, torch.as_tensor(K), scene, k, window, stride, (tl[0], tl[1], 0, 0))
        want = td2c.window_lift(d, torch.as_tensor(K), window=window, stride=stride,
                                max_points=k, morton=morton, tl_x=tl[0], tl_y=tl[1])
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# --- a numpy model of csrc/lift.cu's ranking ---------------------------------

def hash_rank(p):
    r = np.arange(p, dtype=np.int64)
    prod = (r * HASH_MUL) & 0xFFFFFFFF
    prod = np.where(prod >= 2 ** 31, prod - 2 ** 32, prod)
    return np.mod(prod, p)  # Python-sign remainder, as the kernel corrects C's


def morton_rank(p, sh, sw):
    """The kernel's morton_rank for every slot: at each 2-bit digit of the
    code, the grid cells of the quadrants before the slot's own."""
    r = np.arange(p)
    row, col = r // sw, r % sw
    levels = int(np.ceil(np.log2(max(sh, sw)))) if max(sh, sw) > 1 else 0
    count = np.zeros(p, np.int64)
    rb = np.zeros(p, np.int64)
    cb = np.zeros(p, np.int64)
    for lv in range(levels - 1, -1, -1):
        side = 1 << lv
        digit = (((row >> lv) & 1) << 1) | ((col >> lv) & 1)
        for t in range(3):
            br, bc = rb + ((t >> 1) << lv), cb + ((t & 1) << lv)
            cells = np.clip(sh - br, 0, side) * np.clip(sw - bc, 0, side)
            count += np.where(t < digit, cells, 0)
        rb += (digit >> 1) << lv
        cb += (digit & 1) << lv
    return count


def model_order(valid, k, morton, sh, sw, rng):
    """The window slots of one pose in L1's output order, as the kernel
    finds them: P' slot indices."""
    p = valid.shape[0]
    if k >= p:
        return np.argsort(morton_rank(p, sh, sw)) if morton else np.arange(p)
    rank = hash_rank(p)
    vslots = np.nonzero(valid)[0]
    # bucket counts and their exclusive scan: each bucket's start
    cnt = np.bincount(rank[vslots], minlength=p)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    # the atomic fill takes no set order; then each bucket ordered by slot
    cursor = start.copy()
    lists = np.empty(len(vslots), np.int64)
    for r in rng.permutation(vslots):
        lists[cursor[rank[r]]] = r
        cursor[rank[r]] += 1
    for q in np.nonzero(cnt > 1)[0]:
        lists[start[q]:start[q] + cnt[q]] = np.sort(lists[start[q]:start[q] + cnt[q]])
    kept_valid = lists[:k]
    # the first k - n_valid invalid slots, by a scan over slots
    invalid = np.nonzero(~valid)[0]
    kept_invalid = invalid[:max(0, k - len(vslots))]
    if not morton:
        return np.concatenate([kept_valid, kept_invalid])
    # each kept slot at its Morton rank, then one scan over the ranks
    mr = morton_rank(p, sh, sw)
    slot_at = np.full(p, -1)
    slot_at[mr[kept_valid]] = kept_valid
    slot_at[mr[kept_invalid]] = kept_invalid
    walk = slot_at[slot_at >= 0]
    return np.concatenate([walk[valid[walk]], walk[~valid[walk]]])


@pytest.mark.parametrize("name", ["p4096", "p2500", "p2304-k1000", "p2304-all", "narrow",
                                  "p57600", "thin"])
def test_morton_rank_counts_equal_jax_morton_order(name):
    """The kernel's level-by-level Morton rank equals the rank of JAX's
    morton_key among the grid's codes (the order argsort gives), on square,
    non-square and thin grids."""
    if name == "thin":
        sh, sw = 3, 1000
    else:
        h, w, window, stride, _k, _tl = SHAPES[name]
        sh, sw = td2c.window_grid(h, w, window, stride)
    p = sh * sw
    code = np.asarray(jd2c.morton_key(jnp.arange(p, dtype=jnp.int32), sh, sw))
    want = np.empty(p, np.int64)
    want[np.argsort(code, kind="stable")] = np.arange(p)
    np.testing.assert_array_equal(morton_rank(p, sh, sw), want)


@pytest.mark.parametrize("morton", [False, True], ids=["projective", "morton"])
@pytest.mark.parametrize("name", CPU_SHAPES)
def test_lift_kernel_model_keeps_jax_compact_topk_slots(name, morton):
    """The numpy model of L1's ranking picks JAX's slots in JAX's order:
    compact_topk (and the Morton permutation) on the window's points, the
    slot index carried in column 0; the valid pattern equal, the model's
    slot at every valid row equal to JAX's. Also equal, row for row, to
    window_lift applied to the same renders."""
    depth, K, window, stride, k, tl = case(name, seed=1)
    sh, sw = td2c.window_grid(depth.shape[1], depth.shape[2], window, stride)
    p = sh * sw
    _pts, valid, _n = td2c.window_cloud_batched(torch.as_tensor(depth), torch.as_tensor(K),
                                                window=window, stride=stride)
    valid = valid.numpy()
    carried = np.zeros((p, 3), np.float32)
    carried[:, 0] = np.arange(p)
    if k < p:
        jo, jv, _ = jax.vmap(lambda v: jd2c.compact_topk(
            jnp.asarray(carried), v, k, order_shape=(sh, sw) if morton else None))(valid)
    else:
        jo, jv = np.broadcast_to(carried, (len(valid), p, 3)), valid
        if morton:
            perm = np.asarray(jnp.argsort(jd2c.morton_key(jnp.arange(p, dtype=jnp.int32), sh, sw)))
            jo, jv = jo[:, perm], valid[:, perm]
    jo, jv = np.asarray(jo), np.asarray(jv)
    tc, tv = td2c.window_lift(torch.as_tensor(depth), torch.as_tensor(K), window=window,
                              stride=stride, max_points=k, morton=morton, tl_x=tl[0],
                              tl_y=tl[1])
    full, _v, _n = td2c.window_cloud_batched(torch.as_tensor(depth), torch.as_tensor(K),
                                             window=window, stride=stride, tl_x=tl[0],
                                             tl_y=tl[1])
    rng = np.random.default_rng(p)
    for i in range(len(valid)):
        order = model_order(valid[i], k, morton, sh, sw, rng)
        assert order.shape == (min(k, p),) and len(np.unique(order)) == len(order)
        np.testing.assert_array_equal(valid[i][order], jv[i])
        np.testing.assert_array_equal(order[jv[i]], jo[i][jv[i], 0].astype(np.int64))
        assert torch.equal(full[i][torch.as_tensor(order)], tc[i])
        assert torch.equal(torch.as_tensor(valid[i][order]), tv[i])


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """window_lift_cuda takes CUDA int32 renders only, and raises for a
    Morton window beyond morton_key's 14-bit grid (before any launch); the
    scratch is sized where the selection's arrays leave shared memory."""
    depth = torch.zeros((2, 40, 50), dtype=torch.int32)
    K = torch.eye(3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        LC.window_lift_cuda(depth, K, window=32, stride=2, max_points=100, morton=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        LC.window_lift_cuda(depth.numpy(), K, window=32, stride=2, max_points=100,
                            morton=True)
    with pytest.raises(ValueError, match="14-bit morton"):
        td2c.window_lift(torch.zeros((1, 2, 20000), dtype=torch.int32), K, window=20000,
                         stride=1, max_points=100, morton=True)
    assert LC.scratch_ints(4096, 2048) == 0  # 32 KB in shared memory
    assert LC.scratch_ints(28672, 100) == 0 and LC.scratch_ints(28673, 100) == 2 * 28673
    assert LC.scratch_ints(57600, 8192) == 2 * 57600
    assert LC.scratch_ints(57600, 57600) == 0  # no selection, no arrays
