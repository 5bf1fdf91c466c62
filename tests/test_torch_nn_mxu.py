"""P1 of the port (``scene/nn_mxu.py``: exact NN with the score as a matrix
product) on the CPU against the JAX probe ``scripts/probe_mxu_nn.py`` on
the same numpy inputs.

The probe runs its whole TPU workload when imported, so the test reads its
``pack_scene_mxu``, ``_kernel_mxu`` and ``nn_flash_mxu`` out of the file
with ``ast`` and runs them with ``pl.pallas_call(..., interpret=True)`` and
the probe's own block specs (the script itself is not touched).

Tolerances: the table bit for bit. The kernel's score rounds otherwise than
any fixed float32 expression (XLA's HIGHEST-precision dot on one side, a
float64 product rounded once on the other), so indices agree up to
near-ties: every disagreement must be two candidates whose float64 squared
distances lie within ``near_tie_band`` (16 float32 ULPs of |q|^2, ~1.2e-7
m^2 at 0.3 m), and every dist^2 within the same band.
"""

import ast
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pose_refine_tpu.scene import nn_pallas as JP
from pose_refine_tpu_torch.probes import mxu_nn as probe
from pose_refine_tpu_torch.scene import nn_flash as NF
from pose_refine_tpu_torch.scene import nn_mxu as NM

torch.set_num_threads(2)

PROBE = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "probe_mxu_nn.py"


@pytest.fixture(scope="module")
def jax_probe():
    """The probe's pack_scene_mxu, _kernel_mxu and nn_flash_mxu, compiled
    from its source, with pallas_call in interpret mode."""
    tree = ast.parse(PROBE.read_text())
    wanted = {"pack_scene_mxu", "_kernel_mxu", "nn_flash_mxu"}
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert {d.name for d in defs} == wanted
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, ds=pl.ds, multiple_of=pl.multiple_of)
    ns = dict(jax=jax, jnp=jnp, np=np, functools=functools, pl=shim, pltpu=pltpu,
              pack_scene=JP.pack_scene, Q_TILE=JP.Q_TILE, S_CHUNK=JP.S_CHUNK, BIG=JP.BIG,
              IBIG=JP.IBIG)
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(PROBE), "exec"), ns)
    return types.SimpleNamespace(**{k: ns[k] for k in wanted})


def structured_case(seed, n_pts=1000, n_q=700):
    """A lexsorted surface-like cloud (the probe's "structured data, where
    ULP-level score differences could flip argmin ties") with exact
    duplicate points, and queries drawn from it with 3 mm noise, exact
    scene points among them."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.05, 0.05, (n_pts, 2))
    pts = np.stack([uv[:, 0], uv[:, 1], 0.3 + 0.02 * np.sin(40 * uv[:, 0])], 1).astype(np.float32)
    pts[n_pts // 2:n_pts // 2 + 20] = pts[:20]  # exact ties across chunks
    pts = pts[np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2]))]
    q = pts[rng.integers(0, n_pts, n_q)] + rng.normal(0, 0.003, (n_q, 3)).astype(np.float32)
    q[:30] = pts[rng.integers(0, n_pts, 30)]
    return pts, q.astype(np.float32)


@pytest.mark.parametrize("n_pts", [1000, 1024])
def test_pack_scene_mxu_matches_probe(jax_probe, n_pts):
    pts, _q = structured_case(0, n_pts)
    want = np.asarray(jax_probe.pack_scene_mxu(pts))
    got = NM.pack_scene_mxu(pts)
    assert got.shape == want.shape and got.shape[1] % 128 == 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_matches_jax_kernel_in_band(jax_probe, seed):
    """Plain P1 against the probe's Pallas kernel in interpret mode: indices
    equal up to near-ties (the disagreements counted), dist^2 within the
    band, ties at exact duplicate points to the smallest index."""
    pts, q = structured_case(seed)
    ji, jd = map(np.asarray, jax_probe.nn_flash_mxu(q, jax_probe.pack_scene_mxu(pts)))
    ti, td = NM.nn_flash_mxu(torch.as_tensor(q), NM.pack_scene_mxu(pts))
    assert ti.dtype == torch.int32 and ti.shape == (len(q),) and (td >= 0).all()
    n_diff, ties_ok, dist_ok = NM.near_ties(torch.as_tensor(q), pts, ti, td,
                                            torch.as_tensor(ji), torch.as_tensor(jd))
    assert ties_ok and dist_ok and n_diff <= len(q) // 100
    exact = (pts[None, :, :] == q[:30, None, :]).all(-1)
    np.testing.assert_array_equal(ti[:30].numpy(), exact.argmax(1))
    np.testing.assert_array_equal(ti[:30].numpy(), ji[:30])


def test_plain_matches_b2_up_to_near_ties():
    """Plain P1 against plain B2 (the elementwise score) on a structured
    cloud: every disagreement a near-tie, every dist^2 within the band."""
    pts, q = structured_case(3, 3000, 2000)
    qt = torch.as_tensor(q)
    pi, pd = NM.nn_flash_mxu(qt, NM.pack_scene_mxu(pts))
    bi, bd = NF.nn_flash_packed(qt, NF.pack_scene(pts))
    n_diff, ties_ok, dist_ok = NM.near_ties(qt, pts, pi, pd, bi, bd)
    assert ties_ok and dist_ok and n_diff <= len(q) // 100


def test_near_ties_flags_a_wrong_neighbour():
    """The comparison refuses a disagreement that is not a near-tie."""
    pts, q = structured_case(4, 500, 200)
    qt = torch.as_tensor(q)
    i, d = NM.nn_flash_mxu(qt, NM.pack_scene_mxu(pts))
    far = torch.as_tensor(np.argmax(((pts[None] - q[:, None]) ** 2).sum(-1), 1).astype(np.int32))
    n_diff, ties_ok, dist_ok = NM.near_ties(qt, pts, i, d, far, d)
    assert n_diff > 0 and not ties_ok and dist_ok


def test_probe_main_runs_on_cpu(capsys):
    """The probe end to end at a tiny size on the CPU (80x60, 1,500
    queries): plain versions, no times, P1 against B2 and its plain
    version up to near-ties."""
    out = probe.main(["--queries", "1500", "--scale", "8", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "not measured" in printed and "idx agreement" in printed
    assert out["b2_ms"] is None and out["points"] > 100 and out["queries"] == 1500
    assert out["b2_near_ties"] and out["b2_dist_in_band"] and out["agreement"] > 0.99
    assert out["plain_disagree"] == 0 and out["max_abs_err"] == 0.0
