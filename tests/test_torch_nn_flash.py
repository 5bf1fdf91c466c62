"""The flash-NN module of the port (scene/nn_flash.py) against the JAX
package's Pallas kernels in interpret mode (scene/nn_pallas.py), on the
same numpy-made inputs: the scene tables bit for bit, and the plain
versions of B2 (nn_flash_packed) and B3 (nn_flash_gated) bit for bit on
every idx and dist^2 the JAX kernels promise (all of them for B2; the
in-gate queries for B3, and validity everywhere)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_refine_tpu.scene import nn_pallas as JP
from pose_refine_tpu_torch.scene import nn_flash as NF

torch.set_num_threads(2)


def sorted_cloud(rng, n, scale, offset=0.0):
    s = (rng.normal(size=(n, 3)) * scale + offset).astype(np.float32)
    return s[np.lexsort((s[:, 0], s[:, 1], s[:, 2]))]  # spatially coherent order


def random_case():
    """tests/test_property.py:88: 1,500 queries against 5,000 points."""
    rng = np.random.default_rng(11)
    S = sorted_cloud(rng, 5000, 0.1)
    Q = (rng.normal(size=(1500, 3)) * 0.1).astype(np.float32)
    return S, Q, 0.05


def clustered_case():
    """tests/test_property.py:117: clustered query tiles around two slabs,
    an exact tie across distant chunks, and a whole tile with no in-gate
    neighbour."""
    rng = np.random.default_rng(23)
    a = rng.normal(size=(3000, 3)).astype(np.float32) * 0.05
    b = rng.normal(size=(3000, 3)).astype(np.float32) * 0.05 + [0.5, 0.0, 0.0]
    S = np.concatenate([a, b]).astype(np.float32)
    S = S[np.lexsort((S[:, 0], S[:, 1], S[:, 2]))]
    S[4500] = S[100]
    t = JP.GQ_TILE
    q0 = (rng.normal(size=(t, 3)) * 0.01).astype(np.float32)
    q0[7] = S[100]
    q1 = (rng.normal(size=(t, 3)) * 0.01 + [0.5, 0, 0]).astype(np.float32)
    q2 = (rng.normal(size=(t, 3)) * 0.01 + [0, 5.0, 0]).astype(np.float32)
    return S, np.concatenate([q0, q1, q2]).astype(np.float32), 0.06


def ragged_case():
    """tests/test_property.py:160: a query count that pads every tile."""
    rng = np.random.default_rng(47)
    S = sorted_cloud(rng, 4000, 0.1)
    Q = (rng.normal(size=(1100, 3)) * 0.1).astype(np.float32)
    return S, Q, 0.05


CASES = {"random": random_case, "clustered": clustered_case, "ragged": ragged_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    S, Q, gate = CASES[request.param]()
    table = JP.pack_scene(S)
    boxes = JP.chunk_boxes(table)
    i0, d0 = map(np.asarray, JP.nn_flash_packed(Q, table, interpret=True))
    i1, d1 = map(np.asarray, JP.nn_flash_gated(Q, table, boxes, gate, interpret=True))
    return dict(name=request.param, S=S, Q=Q, gate=gate, table=np.array(table),
                boxes=np.asarray(boxes), jax_packed=(i0, d0), jax_gated=(i1, d1))


def test_scene_tables_match_jax(case):
    table = NF.pack_scene(case["S"])
    assert torch.equal(table, torch.as_tensor(case["table"]))
    assert torch.equal(NF.chunk_boxes(table), torch.as_tensor(case["boxes"]))


def test_ball_table_matches_jax(case):
    """The balls of the gated kernel's pass 1, as nn_flash_gated derives
    them inside its jitted body (nn_pallas.py:400-404): centres bit for
    bit; radii within 1 ULP, because XLA's CPU float32 sqrt is not
    correctly rounded (about 2% of these radii sit 1 ULP above the IEEE
    square root that torch and the CUDA kernel take). The balls only
    bound which chunks the kernel scans, never its result."""

    @jax.jit
    def jax_balls(scene_table):
        sub = scene_table[:3].reshape(3, -1, JP.UB_BALL)
        blo, bhi = sub.min(axis=2), sub.max(axis=2)
        ctr = (0.5 * (blo + bhi)).T
        rad = 0.5 * jnp.linalg.norm((bhi - blo).T, axis=1, keepdims=True)
        return jnp.concatenate([ctr, rad], axis=1).T

    want = np.asarray(jax_balls(jnp.asarray(case["table"])))
    got = NF.ball_table(torch.as_tensor(case["table"])).numpy()
    assert got.shape == want.shape == (4, case["table"].shape[1] // NF.UB_BALL)
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_array_max_ulp(got[3], want[3], maxulp=1)


def test_plain_packed_matches_jax(case):
    i0, d0 = case["jax_packed"]
    idx, dist = NF.nn_flash_packed(torch.as_tensor(case["Q"]), torch.as_tensor(case["table"]))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), i0)
    np.testing.assert_array_equal(dist.numpy(), d0)


def test_plain_gated_matches_jax_in_gate(case):
    i0, d0 = case["jax_packed"]
    i1, d1 = case["jax_gated"]
    gate = case["gate"]
    table = torch.as_tensor(case["table"])
    idx, dist = NF.nn_flash_gated(torch.as_tensor(case["Q"]), table,
                                  torch.as_tensor(case["boxes"]), NF.ball_table(table), gate)
    idx, dist = idx.numpy(), dist.numpy()
    inside = d0 < np.float32(gate) * np.float32(gate)
    assert inside.any() and not inside.all()  # both populations are covered
    np.testing.assert_array_equal(idx[inside], i1[inside])
    np.testing.assert_array_equal(dist[inside], d1[inside])
    g2 = np.float32(gate) * np.float32(gate)
    np.testing.assert_array_equal(dist < g2, d1 < g2)  # validity everywhere
    assert (dist[~inside] == np.float32(NF.BIG)).all()
    if case["name"] == "clustered":
        t = JP.GQ_TILE
        assert inside[:t].all() and not inside[2 * t:].any()
        assert idx[7] == 100 == i1[7]  # the tie keeps the smaller index


def test_addcmul_is_a_fused_multiply_add():
    """The plain versions' CPU FMA (torch.addcmul) rounds once, as the
    exact emulation the card's plain version uses does."""
    rng = np.random.default_rng(5)
    a, b, c = (torch.as_tensor((rng.normal(size=200_000) * s).astype(np.float32))
               for s in (0.3, 0.3, 0.05))
    fused = torch.addcmul(c, a, b)
    assert torch.equal(fused, NF._fma_exact(a, b, c))
    # the separately rounded form differs somewhere: the check has teeth
    assert not torch.equal(fused, a * b + c)


def test_fma_exact_handles_double_rounding():
    """a*b + c whose float64 sum rounds onto a float32 midpoint: rounded
    twice, it ties to the wrong neighbour; the emulation does not."""
    a = torch.tensor([2.0 ** -12 * (1 + 2.0 ** -18)], dtype=torch.float32)
    b = torch.tensor([2.0 ** -12 * (1 - 2.0 ** -18)], dtype=torch.float32)
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    # exactly 1 + 2^-23 + 2^-24 - 2^-60: just below the float32 midpoint
    # 1 + 2^-23 + 2^-24, so it rounds down to c
    twice = (a.double() * b.double() + c.double()).float()
    assert twice.item() == 1 + 2.0 ** -22  # the double-rounding error
    assert NF._fma_exact(a, b, c).item() == 1 + 2.0 ** -23


def test_wrappers_refuse_what_they_cannot_launch():
    table = NF.pack_scene(np.zeros((10, 3), np.float32))
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        NF.nn_flash_packed_cuda(q, table)
    with pytest.raises(ValueError, match="CUDA tensors"):
        NF.nn_flash_gated_cuda(q, table, NF.chunk_boxes(table), NF.ball_table(table), 0.1)
    # frames=2 without frame_id windows to frame 0, JAX's default fid
    # (nn_pallas.py:444-446): a stack whose frame 1 holds the queries'
    # points finds nothing for them in the gate
    near = np.full((128, 3), 0.3, np.float32)
    stacked = torch.cat([table, NF.pack_scene(near)], dim=1)
    q = torch.full((4, 3), 0.3)
    idx, dist = NF.nn_flash_gated(q, stacked, NF.chunk_boxes(stacked), NF.ball_table(stacked),
                                  0.1, frames=2)
    assert (dist == NF.BIG).all()
    idx, dist = NF.nn_flash_gated(q, stacked, NF.chunk_boxes(stacked), NF.ball_table(stacked),
                                  0.1, frame_id=1, frames=2)
    assert (idx == 128).all() and (dist == 0.0).all()
