"""The association's row gather (ops/gather.py, kernel csrc/gather.cu) on
the CPU: its plain version against ``jnp.take``, the reference of the Pallas
gather probe (scripts/probe_pallas_gather.py:44), bit for bit - a gather
rounds nothing. Out-of-range indices are clamped into the table, as
``jnp.take(..., mode="clip")`` does. Both association call sites go
through it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu.scene import projective as jproj
from pose_refine_tpu_torch.ops import gather as G
from pose_refine_tpu_torch.scene import projective as tproj

torch.set_num_threads(2)


def table_and_idx(seed, rows, shape, dtype, spill=0):
    """A random (rows, 8) table and indices of ``shape``; ``spill`` > 0
    draws them from [-spill, rows + spill) so some fall outside."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, 8)).astype(np.float32)
    idx = rng.integers(-spill, rows + spill, shape).astype(dtype)
    return table, idx


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("rows,shape", [(1, (7,)), (300, (1000,)), (4096, (6, 512)),
                                        (29440, (3, 64, 32))])
def test_plain_equals_jnp_take(rows, shape, dtype):
    table, idx = table_and_idx(rows, rows, shape, dtype)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    got = G.gather_rows_plain(torch.as_tensor(table), torch.as_tensor(idx))
    assert got.shape == shape + (8,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatching wrapper takes the plain version for CPU tensors
    before = G.launches
    assert torch.equal(G.gather_rows(torch.as_tensor(table), torch.as_tensor(idx)), got)
    assert G.launches == before


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_out_of_range_indices_clamp(dtype):
    """Indices below 0 read row 0 and indices past the table its last row -
    jnp.take's clip mode; the fill mode jnp.take defaults to reads NaN
    rows there, which an ICP reduction would spread."""
    table, idx = table_and_idx(5, 100, (2000,), dtype, spill=50)
    idx[:3] = [np.iinfo(np.int32).min, -1, 2 ** 30 - 1]
    assert (idx < 0).any() and (idx >= 100).any()
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0, mode="clip"))
    got = G.gather_rows(torch.as_tensor(table), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], table[0])
    np.testing.assert_array_equal(got[2], table[-1])
    assert np.isnan(np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))).any()


@pytest.mark.parametrize(
    "table,idx,match",
    [(torch.zeros((4, 6)), torch.zeros(3, dtype=torch.int64), r"\(R, 8\)"),
     (torch.zeros((0, 8)), torch.zeros(3, dtype=torch.int64), r"\(R, 8\)"),
     (torch.zeros((4, 8)), torch.zeros(3), "int32 or int64")],
)
def test_refuses_what_it_cannot_gather(table, idx, match):
    with pytest.raises(ValueError, match=match):
        G.gather_rows(table, idx)


def test_projective_query_goes_through_the_gather(monkeypatch):
    """The projective association gathers through gather_rows: validity
    equals the JAX scene's query, and the rows agree within 1e-6, the
    rounding of the two scene tables (their normals are computed in
    another order, tests/test_torch_lift_scene.py); plain=True takes the
    plain version."""
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.25
    rng = np.random.default_rng(3)
    depth = rng.integers(280, 320, (120, 160)).astype(np.int32)
    depth[:, :20] = 0
    src = (rng.normal(size=(4, 300, 3)) * [0.04, 0.03, 0.01] + [0, 0, 0.3]).astype(np.float32)
    jscene = jproj.SceneProjective.from_depth(depth, K, 0.1)
    scene = tproj.SceneProjective.from_depth(depth, K, 0.1, device="cpu")
    calls = []
    real = G.gather_rows

    def spy(table, idx):
        calls.append(idx.shape)
        return real(table, idx)

    monkeypatch.setattr(tproj, "gather_rows", spy)
    dst, nrm, valid = scene.query(torch.as_tensor(src))
    assert calls == [(4, 300)]
    jd, jn, jv = map(np.asarray, jscene.query(jnp.asarray(src)))
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert 0 < jv.sum() < jv.size
    np.testing.assert_allclose(dst.numpy(), jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(nrm.numpy(), jn, rtol=0, atol=1e-6)
    plain = scene.query(torch.as_tensor(src), plain=True)
    assert calls == [(4, 300)]
    for a, b in zip(plain, (dst, nrm, valid)):
        assert torch.equal(a, b)
