"""P1 of the port (``scene/nn_mxu.py``: exact NN through a tensor-core
screen, B2's function) on the CPU against the JAX probe
``scripts/probe_mxu_nn.py`` and against B2's plain version on the same
numpy inputs.

The probe runs its whole TPU workload when imported, so the test reads its
``pack_scene_mxu``, ``_kernel_mxu`` and ``nn_flash_mxu`` out of the file
with ``ast`` and runs them with ``pl.pallas_call(..., interpret=True)`` and
the probe's own block specs (the script itself is not touched).

Tolerances: the table bit for bit; P1's plain version against B2's plain
version bit for bit in idx and dist^2, and on the tie lattice against an
exact float64 argmin (every score there is exact in float32). The JAX
probe's HIGHEST-precision dot rounds otherwise than B2's elementwise
score, so against it indices agree up to near-ties: every disagreement must
be two candidates whose float64 squared distances lie within
``near_tie_band`` (16 float32 ULPs of |q|^2, ~1.2e-7 m^2 at 0.3 m), and
every dist^2 within the same band.
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
    band. Queries at exact duplicate points: the probe's product takes the
    duplicate of smallest index; P1 takes B2's rounding, under which a point
    a near-tie away may score below the query's own point (seed 1, query 0:
    27 um away, one float32 ULP of the score). So on each such query P1
    takes the duplicate of smallest index, or a point whose B2 score is
    below the duplicate's, or equal to it at a smaller index."""
    pts, q = structured_case(seed)
    ji, jd = map(np.asarray, jax_probe.nn_flash_mxu(q, jax_probe.pack_scene_mxu(pts)))
    ti, td = NM.nn_flash_mxu(torch.as_tensor(q), NM.pack_scene_mxu(pts))
    assert ti.dtype == torch.int32 and ti.shape == (len(q),) and (td >= 0).all()
    n_diff, ties_ok, dist_ok = NM.near_ties(torch.as_tensor(q), pts, ti, td,
                                            torch.as_tensor(ji), torch.as_tensor(jd))
    assert ties_ok and dist_ok and n_diff <= len(q) // 100
    exact = (pts[None, :, :] == q[:30, None, :]).all(-1)
    np.testing.assert_array_equal(ji[:30], exact.argmax(1))
    table = NM.pack_scene_mxu(pts)
    sc = NF._score(torch.as_tensor(q[:30]), *(table[k][None, :] for k in range(4)))
    rows = torch.arange(30)
    pick, dup = ti[:30].long(), torch.as_tensor(exact.argmax(1))
    s_pick, s_dup = sc[rows, pick], sc[rows, dup]
    ok = (pick == dup) | (s_pick < s_dup) | ((s_pick == s_dup) & (pick < dup))
    assert ok.all(), np.flatnonzero(~ok.numpy())


def test_plain_matches_b2_up_to_near_ties():
    """Plain P1 against plain B2 (the elementwise score) on a structured
    cloud: since P1 computes B2's function, no disagreement at all - within
    the band a fortiori."""
    pts, q = structured_case(3, 3000, 2000)
    qt = torch.as_tensor(q)
    pi, pd = NM.nn_flash_mxu(qt, NM.pack_scene_mxu(pts))
    bi, bd = NF.nn_flash_packed(qt, NF.pack_scene(pts))
    n_diff, ties_ok, dist_ok = NM.near_ties(qt, pts, pi, pd, bi, bd)
    assert ties_ok and dist_ok and n_diff == 0


def lattice_argmin(pts, q):
    """The exact answer on the tie lattice: every score |s|^2 - 2 q.s is an
    integer or a half below 2^23, exact in float64 and float32, so the
    first index of the float64 minimum is the smallest index of the
    minimal B2 score; also the number of points at that minimum."""
    p64, q64 = pts.astype(np.float64), q.astype(np.float64)
    sc = (p64 ** 2).sum(1)[None, :] - 2.0 * q64 @ p64.T
    best = sc.min(1)
    return sc.argmin(1), best + (q64 ** 2).sum(1), (sc == best[:, None]).sum(1)


@pytest.mark.parametrize("case", ["lattice", "lattice-wide", "cloud-1", "cloud-2", "structured"])
def test_plain_equals_b2_bit_for_bit(case):
    """P1's plain version is B2's function: idx and dist^2 equal
    nn_flash_packed_plain's bit for bit, on the tie lattice (most queries
    with 2, 4 or 8 points at the same distance, where the smallest index
    must win: held against the exact argmin too) and on seeded random
    clouds (metre scale, around 0.3 m, a cloud not a multiple of 128)."""
    if case.startswith("lattice"):
        pts, q = probe.tie_lattice(8 if case == "lattice" else 12, 1500, seed=len(case))
    elif case == "structured":
        pts, q = structured_case(7, 2000, 1500)
    else:
        rng = np.random.default_rng(int(case[-1]))
        pts = (rng.normal(size=(1700, 3)) * [0.05, 0.05, 0.02] + [0, 0, 0.3]).astype(np.float32)
        q = (pts[rng.integers(0, 1700, 1200)]
             + rng.normal(0, 0.003, (1200, 3))).astype(np.float32)
    qt = torch.as_tensor(q)
    pi, pd = NM.nn_flash_mxu(qt, NM.pack_scene_mxu(pts))
    bi, bd = NF.nn_flash_packed_plain(qt, NF.pack_scene(pts))
    assert probe.compare(pi, pd, bi, bd) == {"idx_differ": 0, "dist_differ": 0, "equal": True}
    if case.startswith("lattice"):
        want_i, want_d, n_min = lattice_argmin(pts, q)
        assert (n_min >= 2).mean() > 0.5 and n_min.max() == 8
        np.testing.assert_array_equal(pi.numpy(), want_i)
        np.testing.assert_array_equal(pd.numpy(), want_d.astype(np.float32))


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
    version bit for bit."""
    out = probe.main(["--queries", "1500", "--scale", "8", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "not measured" in printed and "P1 vs B2: equal bit for bit: True" in printed
    assert out["b2_ms"] is None and out["points"] > 100 and out["queries"] == 1500
    assert out["vs_b2"]["equal"] and out["vs_plain"]["equal"]
    assert out["rescored_mean"] is None and out["max_abs_err"] == 0.0
