"""Device rules of the port: a CUDA request never runs on the CPU, kernel
wrappers refuse what they cannot launch, the package imports without jax,
and (on a machine with a card) the CUDA kernel matches its plain version.

This file imports no jax, so its ``cuda`` tests run on a GPU machine that
has no jax installed:
    python -m pytest --noconftest tests/test_torch_device.py -q -m cuda
"""

import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pose_refine_tpu_torch as ptt
from pose_refine_tpu_torch import _build, geometry, mesh
from pose_refine_tpu_torch.ops import gather as G
from pose_refine_tpu_torch.ops import icp_reduce as IR
from pose_refine_tpu_torch.ops import lift_cuda as LC
from pose_refine_tpu_torch.ops import rasterize_cuda as RC
from pose_refine_tpu_torch.ops import scene_table as ST
from pose_refine_tpu_torch.ops.depth_to_cloud import window_lift
from pose_refine_tpu_torch.probes import lift_cases, nn_ties, raster_edges, scene_table_cases
from pose_refine_tpu_torch.scene import nn_flash as NF
from pose_refine_tpu_torch.scene import nn_kdtree as KD
from pose_refine_tpu_torch.scene import nn_mxu as NM
from pose_refine_tpu_torch.scene.nn import SceneNN, SceneNNStack
from pose_refine_tpu_torch.scene import projective as SP
from pose_refine_tpu_torch.scene.projective import SceneProjective, SceneProjectiveStack
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rules do not apply")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_resolve_device_refuses_cuda_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ptt.resolve_device("cuda")
    assert ptt.resolve_device("cpu").type == "cpu"


def test_default_device_raises_without_card(no_card):
    """device=None is the card: with none present it raises, it does not
    fall back to the CPU - in resolve_device and at the entry points."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ptt.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ptt.resolve_device()
    m = mesh.make_icosphere(40.0, 1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ptt.PoseRefiner(m, K=geometry.LINEMOD_K)
    pts = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SceneNN.from_cloud(pts, pts)
    proj = geometry.compute_proj(geometry.LINEMOD_K, 64, 48, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        RC.rasterize(m.tris, np.eye(4, dtype=np.float32)[None], 64, 48, proj)


def test_refiner_on_cuda_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ptt.PoseRefiner(mesh.make_icosphere(40.0, 1), K=geometry.LINEMOD_K, device="cuda")


def test_rasterize_on_cuda_raises_without_card(no_card):
    m = mesh.make_icosphere(40.0, 1)
    pose = geometry.pose_from_Rt(torch.eye(3), torch.tensor([0.0, 0.0, 300.0]))[None]
    proj = geometry.compute_proj(geometry.LINEMOD_K, 64, 48)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        RC.rasterize(m.tris, pose, 64, 48, proj, device="cuda")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrappers launch their kernel or raise; they never compute on the
    CPU themselves."""
    table, poses, proj = torch.zeros((1, 4, 3, 3)), torch.eye(4)[None], torch.eye(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        RC.raster_cuda(table, None, poses, proj, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        RC.triangle_setup_cuda(table, None, poses, proj, 8, 8)
    table = NF.pack_scene(torch.zeros((5, 3)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        NF.nn_flash_packed_cuda(torch.zeros((3, 3)), table)
    with pytest.raises(ValueError, match="CUDA tensors"):
        G.gather_rows_cuda(torch.zeros((4, 8)), torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        NM.nn_flash_mxu_cuda(torch.zeros((3, 3)), NM.pack_scene_mxu(torch.zeros((5, 3))))
    with pytest.raises(ValueError, match="CUDA tensors"):
        LC.window_lift_cuda(torch.zeros((2, 8, 8), dtype=torch.int32), torch.eye(3), window=4,
                            stride=2, max_points=3, morton=False)


def test_nn_scene_on_cuda_raises_without_card(no_card):
    pts = torch.rand((50, 3))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SceneNN.from_cloud(pts, pts, device="cuda")


def test_build_without_nvcc_raises(no_card):
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_kernels()


def test_build_key_covers_sources_and_flags():
    key = _build.build_info_key()
    assert len(key) == 16 and key == _build.build_info_key()
    assert [p.name for p in _build._sources()] == ["gather.cu", "icp_reduce.cu", "lift.cu",
                                                   "nn_flash.cu", "nn_kdtree.cu", "nn_mxu.cu",
                                                   "rasterize.cu", "scene_table.cu"]


def test_package_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['pose_refine_tpu'] = None; "
        "import pose_refine_tpu_torch, pose_refine_tpu_torch.utils.interop; "
        "print(sorted(m for m, v in sys.modules.items() if m.startswith('jax') and v))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_module_of_the_port_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|pose_refine_tpu)(\.|\s|$)")
    for path in (REPO / "pose_refine_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not pattern.match(line), f"{path}: {line}"


def test_profile_port_needs_a_card(no_card):
    """The profiling script exits non-zero on a machine without a card;
    like chip_smoke.py it imports no jax."""
    sys.path.insert(0, str(REPO))
    import profile_port

    assert profile_port.main() == 2
    pattern = re.compile(r"^\s*(import|from)\s+(jax|pose_refine_tpu)(\.|\s|$)")
    for name in ("profile_port.py", "chip_smoke.py"):
        assert not any(pattern.match(ln) for ln in (REPO / name).read_text().splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "roi", "per_pose"])
def test_kernel_matches_plain_on_card(card, case):
    """The CUDA kernel against its plain version on the same inputs: the
    two evaluate the same rounded arithmetic, so every pixel agrees."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    tris = torch.as_tensor(m.tris[mesh.morton_order(m.tris)], device=card)
    rng = np.random.default_rng(1)
    R = geometry.euler_to_rotation(rng.uniform(-np.pi, np.pi, (6, 3)).astype(np.float32))
    t = np.stack([rng.uniform(-30, 30, 6), rng.uniform(-30, 30, 6),
                  rng.uniform(250, 400, 6)], -1).astype(np.float32)
    poses = geometry.pose_from_Rt(R, t).to(card)
    roi = (0, 0, 0, 0)
    if case == "roi":
        roi = (200, 120, 256, 200)
    elif case == "per_pose":
        other = mesh.make_icosphere(radius=30.0, subdivisions=4).tris
        tris = torch.stack([tris, torch.as_tensor(other, device=card)]).repeat(3, 1, 1, 1)
    proj = geometry.compute_proj(geometry.LINEMOD_K, 640, 480, device=card)
    before = RC.launches
    got = RC.rasterize(tris, poses, 640, 480, proj, roi=roi)
    torch.cuda.synchronize()
    assert RC.launches == before + 1
    want = RC.rasterize_plain(tris, poses, 640, 480, proj, roi=roi)
    assert got.shape == want.shape and got.dtype == torch.int32
    assert (got > 0).sum() > 10000
    assert torch.equal(got, want)


SETUP_FIELDS = ("kbx", "kby", "kb0", "kgx", "kgy", "kg0", "ddx", "ddy", "dd0",
                "x_start", "y_start", "x_max", "y_max", "zero", "zero", "zero")


def raster_edge_inputs(card, name):
    """probes/raster_edges.py's case on the card: (tris, poses, proj);
    ``<case>-wide``: its three poses repeated to 600, a batch that takes
    the kernel's wide tiles."""
    if name.endswith("-wide"):
        tris, poses = raster_edges.cases()[name.replace("-wide", "-n3")]
        poses = np.tile(poses, (200, 1, 1))
    else:
        tris, poses = raster_edges.cases()[name]
    proj = geometry.compute_proj(raster_edges.camera_k(), raster_edges.WIDTH,
                                 raster_edges.HEIGHT, device=card)
    return torch.as_tensor(tris, device=card), torch.as_tensor(poses, device=card), proj


@pytest.mark.cuda
@pytest.mark.parametrize("roi", [(0, 0, 0, 0), raster_edges.ROI], ids=["frame", "roi"])
@pytest.mark.parametrize("name", sorted(raster_edges.cases()) + ["mixed-wide", "crowded-wide"])
def test_raster_kernel_matches_plain_on_edge_inputs_on_card(card, name, roi):
    """The kernel against its plain version on the edge inputs (a triangle
    wider than the frame, 1-pixel triangles on tile corners, boxes across
    the ROI's edges, zero-area rows, NaN / infinite vertices, a vertex
    behind the camera, boxes that fill whole tiles), at N = 1 and 3 (narrow
    tiles) and 600 (wide tiles), T not a multiple of 32: bit for bit, one
    render counted."""
    tris, poses, proj = raster_edge_inputs(card, name)
    before = RC.launches
    got = RC.rasterize(tris, poses, raster_edges.WIDTH, raster_edges.HEIGHT, proj, roi=roi)
    torch.cuda.synchronize()
    assert RC.launches == before + 1
    want = RC.rasterize_plain(tris, poses, raster_edges.WIDTH, raster_edges.HEIGHT, proj,
                              roi=roi)
    assert got.shape == want.shape and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert bool((want != 0).any()) != name.startswith("empty")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(raster_edges.cases()) + ["bumpy-100"])
def test_raster_setup_matches_plain_per_field_on_card(card, name):
    """The setup the kernel computes in registers (written out by the
    test-only prt_raster_setup) against triangle_setup on the card, field by
    field, so a rounding mismatch names its field; ``bumpy-100``: a bumpy
    sphere under 100 random poses through the ROI."""
    roi = raster_edges.ROI
    if name == "bumpy-100":
        m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
        tris = torch.as_tensor(m.tris[mesh.morton_order(m.tris)], device=card)
        rng = np.random.default_rng(8)
        R = geometry.euler_to_rotation(rng.uniform(-np.pi, np.pi, (100, 3)).astype(np.float32))
        t = np.stack([rng.uniform(-40, 40, 100), rng.uniform(-40, 40, 100),
                      rng.uniform(150, 500, 100)], -1).astype(np.float32)
        poses = geometry.pose_from_Rt(R, t).to(card)
        proj = geometry.compute_proj(raster_edges.camera_k(), raster_edges.WIDTH,
                                     raster_edges.HEIGHT, device=card)
    else:
        tris, poses, proj = raster_edge_inputs(card, name)
    w, h = raster_edges.WIDTH, raster_edges.HEIGHT
    got = RC.triangle_setup_cuda(tris[None], None, poses, proj, w, h, roi)
    want = RC.triangle_setup(tris, poses, proj, w, h, roi)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    for i, field in enumerate(SETUP_FIELDS):
        same = got[:, i] == want[:, i]
        assert bool(same.all()), (f"field {field}: {int((~same).sum())} of {same.numel()} differ, "
                                  f"first kernel {got[:, i][~same][:3].tolist()} plain "
                                  f"{want[:, i][~same][:3].tolist()}")


@pytest.mark.cuda
def test_raster_kernel_reads_an_indexed_table_on_card(card):
    """An (M, T, 3, 3) table with a row id per pose (IndexedTris), ids out of
    range included (clamped, as in the plain version): bit for bit, and
    equal to the render of the gathered per-pose table."""
    mixed, poses, proj = raster_edge_inputs(card, "mixed-n3")
    crowded = torch.as_tensor(raster_edges.cases()["crowded-n1"][0], device=card)
    pad = crowded[:1, :1].expand(mixed.shape[0] - crowded.shape[0], 3, 3)
    table = torch.stack([mixed, torch.cat([crowded, pad])]).contiguous()
    poses = torch.cat([poses, poses[:1]]).contiguous()
    ids = torch.tensor([1, 0, 7, -2], dtype=torch.int32, device=card)
    w, h = raster_edges.WIDTH, raster_edges.HEIGHT
    got = RC.rasterize(RC.IndexedTris(table, ids), poses, w, h, proj)
    torch.cuda.synchronize()
    want = RC.rasterize_plain(RC.IndexedTris(table, ids), poses, w, h, proj)
    assert torch.equal(got, want)
    gathered = RC.rasterize(table[[1, 0, 1, 0]].contiguous(), poses, w, h, proj)
    assert torch.equal(got, gathered)


def _lmo_frame512_case(card):
    """The lmo-frame512 cell's refiner on the card (``benchmark/configs/
    lmo-proj.json``: 8 stand-ins, 4 mm decimation, the padded table) with
    one of its frames set, and its 512 hypotheses with their model ids, made
    by the cell's kind from a seed."""
    import importlib.util
    import json

    bench = REPO / "benchmark"
    sys.path.insert(0, str(bench))
    spec = importlib.util.spec_from_file_location("bench_kind_multirefine",
                                                  bench / "kinds" / "multirefine.py")
    kind = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kind)
    cfg = json.loads((bench / "configs" / "lmo-proj.json").read_text())
    mix = json.loads((bench / "mixes" / "lmo8x64.json").read_text())
    tr = kind.Traffic(ptt, cfg, dict(mix, frames=1, hypothesis_batches=1), 3_000_000_513,
                      [str(card)])
    tr.refiner.set_scene_depth(tr.frames[0])
    return tr


@pytest.mark.cuda
def test_indexed_raster_at_the_lmo_cell_matches_gathered_on_card(card):
    """B1 through the lmo-frame512 cell's padded (8, T_max, 3, 3) table with
    a model id a pose, at its 512 poses in its ROI: bit for bit the kernel's
    render of the gathered (512, T_max, 3, 3) per-pose table, and at two
    poses of each model the plain version's; every model's pixels drawn."""
    tr = _lmo_frame512_case(card)
    ref = tr.refiner
    table = ref.tris_table
    ids = torch.as_tensor(tr.ids, device=card)
    poses = torch.as_tensor(tr.batches[0], device=card)
    assert table.shape[0] == 8 and len(set(ref.model_tris.tolist())) == 8 and len(ids) == 512
    w, h = ref.render_w, ref.render_h
    got = RC.rasterize(RC.IndexedTris(table, ids), poses, w, h, ref.proj, ref.roi)
    gathered = RC.rasterize(table[ids.long()].contiguous(), poses, w, h, ref.proj, ref.roi)
    torch.cuda.synchronize()
    assert torch.equal(got, gathered)
    some = torch.arange(0, 512, 32, device=card)
    plain = RC.rasterize_plain(RC.IndexedTris(table, ids[some]), poses[some], w, h, ref.proj,
                               ref.roi)
    assert torch.equal(got[some], plain)
    drawn = (got > 0).flatten(1).sum(1).reshape(8, 64)
    assert bool((drawn > 0).all())


@pytest.mark.cuda
def test_raster_kernel_refuses_what_it_cannot_launch_on_card(card):
    table = torch.zeros((2, 8, 3, 3), device=card)
    poses = torch.eye(4, device=card).expand(3, 4, 4).contiguous()
    proj = torch.eye(4, device=card)
    with pytest.raises(ValueError, match="needs ids"):
        RC.raster_cuda(table, None, poses, proj, 16, 16)
    with pytest.raises(ValueError, match="ids must be"):
        RC.raster_cuda(table, torch.zeros(3, dtype=torch.int64, device=card), poses, proj, 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        RC.raster_cuda(table[:1], None, torch.eye(4, device=card).expand(3, 4, 4), proj, 16, 16)
    with pytest.raises(ValueError, match="poses must be"):
        RC.raster_cuda(table[:1], None, poses.cpu(), proj, 16, 16)


def nn_case(card, seed=2, n_scene=20000, n_query=70000):
    """A kd-ordered random scene and clustered queries around it, some
    beyond a 5 mm gate, with a partial last query tile."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n_scene, 3)) * [0.05, 0.05, 0.02] + [0, 0, 0.3]).astype(np.float32)
    scene = SceneNN.from_cloud(pts, pts, 0.005, backend="bruteforce", device=card)
    q = pts[rng.integers(0, n_scene, n_query)] + rng.normal(0, 0.004, (n_query, 3))
    q[:300] += 1.0  # whole tiles with no in-gate neighbour
    return scene, torch.as_tensor(q.astype(np.float32), device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [0.1, 0.005])
def test_nn_kernels_match_plain_on_card(card, gate):
    """Both flash-NN kernels against their plain versions: the full scan
    bit for bit on every query, the gated kernel on every in-gate query
    and on validity everywhere."""
    scene, q = nn_case(card)
    table = scene.flash_table
    before = (NF.packed_launches, NF.gated_launches)
    ki, kd = NF.nn_flash_packed(q, table)
    gi, gd = NF.nn_flash_gated(q, table, scene.flash_boxes, scene.flash_balls, gate)
    torch.cuda.synchronize()
    assert (NF.packed_launches, NF.gated_launches) == (before[0] + 1, before[1] + 1)
    pi, pd = NF.nn_flash_packed_plain(q, table)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    g2 = NF.gate_sq(gate)
    # outside the band where float32 rounding of the score, not the true
    # distance, puts a query in or out of the gate (chip_smoke.gate_band)
    sure = (pd - g2).abs() > (q * q).sum(-1) * 2.0 ** -20
    inside = (pd < g2) & sure
    assert 0 < int(inside.sum()) < q.shape[0]
    assert torch.equal(gi[inside], pi[inside]) and torch.equal(gd[inside], pd[inside])
    assert torch.equal((gd < g2)[sure], (pd < g2)[sure])


@pytest.mark.cuda
def test_nn_query_through_kernel_on_card(card):
    scene, q = nn_case(card, seed=3, n_query=5000)
    before = NF.gated_launches
    dst, nrm, valid = scene.query(q.reshape(50, 100, 3))
    torch.cuda.synchronize()
    assert NF.gated_launches == before + 1
    pdst, pnrm, pvalid = scene.query(q.reshape(50, 100, 3), plain=True)
    assert not bool(valid.reshape(-1)[:300].any()) and int((valid != pvalid).sum()) <= 2
    both = valid & pvalid
    assert torch.equal(dst[both], pdst[both]) and torch.equal(nrm[both], pnrm[both])
    assert bool(torch.isfinite(dst).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dtype,n,offset", [
    (307200, torch.int64, 256 * 2048, 0), (29440, torch.int32, 256 * 2048, 0),
    (5, torch.int64, 256 * 2048, 0),
    # lengths that are no multiple of a CTA's rows, index views at an odd offset
    (19200, torch.int32, 32768 + 7, 1), (19200, torch.int64, 32768 + 7, 1),
    (307200, torch.int32, 3, 3), (307200, torch.int64, 1, 1), (1000, torch.int32, 8 * 25 + 5, 0)])
def test_gather_kernel_matches_plain_on_card(card, rows, dtype, n, offset):
    """The row gather at the bench association's shapes (a 640x480
    projective table, the raw NN scene; 256 x 2048 indices), on a tiny
    table with out-of-range indices, and at ragged lengths with index views
    that start ``offset`` elements into their storage, off a 16-byte
    boundary (the wrapper's alignment check takes them, since each is
    aligned to its element size, and the kernel reads them as they are): a
    gather rounds nothing, so the kernel equals its plain version bit for
    bit."""
    gen = torch.Generator(device=card).manual_seed(rows + n)
    table = torch.randn((rows, 8), generator=gen, device=card)
    idx = torch.randint(-3, rows + 3, (n + offset,), generator=gen, device=card).to(dtype)
    idx = idx[offset:]
    if n == 256 * 2048:
        idx = idx.view(256, 2048)
    before = G.launches
    got = G.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert G.launches == before + 1
    assert got.shape == tuple(idx.shape) + (8,)
    assert torch.equal(got, G.gather_rows_plain(table, idx))


def scene_case(card, case):
    """The scene of one front end of the iteration kernel, its ids (None for
    a single scene), plain query, clouds (N, P, 3) and valid (N, P): a
    120x160 depth frame around 0.3 m, and clouds around it with points at
    z = 0, behind the camera, NaN, outside the frame, on its border pixels,
    beyond the gate, and masked rows. "slabs16" is the tracking shape, 16
    poses x 2,048 points (8-CTA clusters); "poses512" the serving ceiling's
    fine shape, 512 x 2,048 (128-thread CTAs, four an SM; two waves before
    they were)."""
    rng = np.random.default_rng(11)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    depths = rng.integers(280, 320, (3, 120, 160)).astype(np.int32)
    depths[:, :, :12] = 0
    # 4 CTAs a pose; "slabs": 8 ragged slabs of 625; "one_slab": a full card
    n, p = {"slabs": (3, 5000), "one_slab": (140, 300), "slabs16": (16, 2048),
            "poses512": (512, 2048)}.get(case, (5, 1500))
    src = (rng.normal(size=(n, p, 3)) * [0.045, 0.035, 0.02] + [0, 0, 0.3]).astype(np.float32)
    src[0, :7] = [[0, 0, 0], [0.01, 0.01, -0.3], [np.nan, 0, 0.3], [0, np.inf, 0.3],
                  [1e30, 0, 1e-30], [0, 0, 0.9], [-3e9, 1, 1e-9]]
    # border pixels: x / z * fx + cx + 0.5 within an ulp of 0 and of the width
    fx, cx = K[0, 0], K[0, 2]
    for i, u in enumerate((0.0, -1e-7, 160.0, 159.99999)):
        src[1, i] = [np.float32((u - 0.5 - cx) / fx * 0.3), 0.0, 0.3]
    valid = rng.uniform(size=(n, p)) > 0.1
    valid[0, 2:4] = False  # the non-finite points are masked: they poison both versions alike
    valid[2] = False       # a pose with no valid point
    cloud = torch.as_tensor(src, device=card)
    valid = torch.as_tensor(valid, device=card)
    ids = torch.arange(n, device=card) % 5 - 1  # -1 and 3 clamp into the 3 frames
    if case in ("projective", "slabs", "one_slab", "slabs16", "poses512"):
        sc = SceneProjective.from_depth(depths[0], K, 0.03, device=card)
        return sc, None, lambda c: sc.query(c, plain=True), cloud, valid
    if case == "stacked":
        sc = SceneProjectiveStack.from_depths(depths, K, 0.03, device=card)
        return sc, ids, sc.query_at(ids, plain=True), cloud, valid
    # the NN kernels take finite queries, and a far one overflows no float32 square
    cloud = torch.nan_to_num(cloud, nan=0.0, posinf=0.0).clamp(-10.0, 10.0)
    if case in ("nn", "kd"):
        backend = "bruteforce" if case == "nn" else "kdtree"
        sc = SceneNN.from_depth(depths[0], K, 0.01, backend=backend, device=card)
        return sc, None, lambda c: sc.query(c, plain=True), cloud, valid
    clouds = [SceneNN.from_depth(d, K, 0.01, device="cpu").points.numpy() for d in depths]
    sc = SceneNNStack.from_clouds(clouds, clouds, 0.01, device=card)
    return sc, ids, sc.query_at(ids, plain=True), cloud, valid


@pytest.mark.cuda
@pytest.mark.parametrize("n_scene", [5, 20000])
def test_nn_kdtree_matches_plain_on_card(card, n_scene):
    """The kd traversal kernel against its plain version: idx, dist^2 and
    the step count bit for bit on every query (clustered queries, scene
    points, NaN and overflowing ones; a single-leaf tree at 5 points), one
    launch counted; the scene query takes its output."""
    rng = np.random.default_rng(n_scene)
    pts = (rng.normal(size=(n_scene, 3)) * [0.05, 0.05, 0.02] + [0, 0, 0.3]).astype(np.float32)
    scene = SceneNN.from_cloud(pts, pts, 0.005, device=card)
    q = pts[rng.integers(0, n_scene, 70000)] + rng.normal(0, 0.004, (70000, 3))
    q[:4] = [[np.nan, 0, 0.3], [1e30, 1e30, 1e30], [-1e30, 0, 0.3], [10.0, 10.0, 10.0]]
    q[4:4 + min(n_scene, 100)] = pts[:100]
    q = torch.as_tensor(q.astype(np.float32), device=card)
    steps = torch.empty(q.shape[0], dtype=torch.int32, device=card)
    before = KD.launches
    ki, kd = KD.nn_kdtree_cuda(q, scene.kd, steps=steps)
    torch.cuda.synchronize()
    assert KD.launches == before + 1
    pi, pd, ps = KD.nn_kdtree_plain(q, scene.kd, return_steps=True)
    assert torch.equal(ki, pi) and torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(steps, ps) and int(steps.max()) < scene.kd.max_steps
    assert float(kd[0]) == KD.FLT_MAX and float(kd[1]) == KD.FLT_MAX
    dst, nrm, valid = scene.query(q)
    want = scene.query(q, plain=True)
    assert all(torch.equal(a, b) for a, b in zip((dst, nrm, valid), want))


def cap_straddling_clouds(pts):
    """The two prefixes of ``pts`` whose trees straddle the kernel's
    shared-memory cap: n points give a table that it stages whole, n + 1 one
    it walks through L1 (bisection over n)."""
    from pose_refine_tpu_torch.scene.kdtree import build_kdtree

    def fits(n):
        t = build_kdtree(pts[:n], pts[:n])
        return 16 * (3 * t.n_nodes + n) <= KD.STAGE_CAP_BYTES

    lo, hi = 1, len(pts)
    assert fits(lo) and not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return pts[:lo], pts[:hi]


@pytest.mark.cuda
@pytest.mark.parametrize("tree_size", ["whole", "grid", "largest_whole", "smallest_grid"])
def test_nn_kdtree_shared_memory_and_grid_on_card(card, tree_size):
    """The kernel's two walks: a tree staged whole in shared memory (3,000
    points) and one too large for it walked through L1 (20,000 points),
    and the pair of trees that straddles the cap (the largest prefix of the
    larger cloud staged whole, one point more walked through L1); each
    equals the plain version bit for bit in idx, dist^2 and steps, twice
    (the tile counters reset)."""
    rng = np.random.default_rng(7)
    n = 3000 if tree_size == "whole" else 20000
    pts = (rng.normal(size=(n, 3)) * [0.05, 0.05, 0.02] + [0, 0, 0.3]).astype(np.float32)
    q = pts[rng.integers(0, n, 40000)] + rng.normal(0, 0.01, (40000, 3))
    if tree_size in ("largest_whole", "smallest_grid"):
        pts = cap_straddling_clouds(pts)[tree_size == "smallest_grid"]
    tree = SceneNN.from_cloud(pts, pts, 0.005, device=card).kd
    q = torch.as_tensor(q.astype(np.float32), device=card)
    launch = KD.KDLaunch(tree, q.shape[:1], card)
    assert launch.whole == (tree_size in ("whole", "largest_whole"))
    steps = torch.empty(q.shape[0], dtype=torch.int32, device=card)
    for _ in range(2):  # the second launch finds the tile counters reset
        ki, kd = launch(q, steps)
        torch.cuda.synchronize()
        pi, pd, ps = KD.nn_kdtree_plain(q, tree, return_steps=True)
        assert torch.equal(ki, pi) and torch.equal(kd.view(torch.int32), pd.view(torch.int32))
        assert torch.equal(steps, ps)
    assert launch.counters.tolist() == [0, 0]


@pytest.mark.cuda
def test_nn_scene_refine_takes_kd_on_card(card):
    """scene="nn" on the card is the kd traversal: a refine launches
    nn_kdtree once a pass and the gated flash kernel never, and equals the
    refine through the plain versions bit for bit; a stack and a tracked
    frame of scene="nn" keep the gated kernel."""
    from pose_refine_tpu_torch import icp
    from pose_refine_tpu_torch.pipeline import refine_poses

    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    R = np.array([[0.34768538, 0.93761126, 0.0],
                  [0.70540612, -0.26157897, -0.65877056],
                  [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = geometry.pose_from_Rt(R, np.array([0, 0, 300], np.float32))
    proj = geometry.compute_proj(geometry.LINEMOD_K, 640, 480, device=card)
    frame = RC.rasterize(m.tris, truth[None], 640, 480, proj, device="cuda")[0]
    rng = np.random.default_rng(2)
    ang = geometry.euler_to_rotation(rng.uniform(-0.1, 0.1, (12, 3)).astype(np.float32))
    hyps = geometry.pose_from_Rt(ang @ truth[:3, :3],
                                 truth[:3, 3] + rng.uniform(-10, 10, (12, 3)).astype(np.float32))
    crit = ptt.ICPConvergenceCriteria(max_iteration=20)
    ref = ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda", scene="nn",
                          scene_voxel_mm=2.0)
    ref.set_scene_depth(frame)
    assert ref.scene.backend == "kdtree"
    before = (KD.launches, NF.gated_launches, IR.iterate_launches)
    refined, res = ref.refine(hyps, crit)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip((KD.launches, NF.gated_launches, IR.iterate_launches),
                                       before)) == (21, 0, 21)
    p_refined, p_res = refine_poses(
        ref.tris, torch.as_tensor(hyps, device=card), ref.scene, ref.proj, ref._K_render_t,
        width=ref.render_w, height=ref.render_h, max_points=ref.max_points, criteria=crit,
        window=ref.window, stride=ref.stride, roi=ref.roi, raster=RC.rasterize_plain,
        lifter=window_lift, query=icp.plain_association(lambda c: ref.scene.query(c, plain=True)))
    assert torch.equal(refined, p_refined) and torch.equal(res.fitness, p_res.fitness)
    assert float(res.fitness.min()) > 0.5
    ref.set_scene_depths(torch.stack([frame, frame]).cpu().numpy())
    assert ref.scene.backend == "bruteforce"
    before = (KD.launches, NF.stacked_launches)
    ref.refine(hyps, crit, scene_ids=np.zeros(12, np.int32))
    torch.cuda.synchronize()
    assert KD.launches == before[0] and NF.stacked_launches > before[1]
    before = (KD.launches, NF.gated_launches)
    ref.track(frame, hyps[:4])
    torch.cuda.synchronize()
    assert KD.launches == before[0] and NF.gated_launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["projective", "nn_bruteforce"])
def test_track_through_kernels_on_card(card, scene):
    """One track() per scene kind on the card: the raster, the iteration
    kernel, the gather (the information pass) and (NN) gated flash-NN
    kernels launch, and the frame through the kernels agrees with the same
    frame through their plain versions (the iteration kernel's plain
    version equals it bit for bit, so the bounds hold at every
    hypothesis)."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    R = np.array([[0.34768538, 0.93761126, 0.0],
                  [0.70540612, -0.26157897, -0.65877056],
                  [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = geometry.pose_from_Rt(R, np.array([0, 0, 300], np.float32))
    proj = geometry.compute_proj(geometry.LINEMOD_K, 640, 480, device=card)
    frame = RC.rasterize(m.tris, truth[None], 640, 480, proj, device="cuda")[0]
    rng = np.random.default_rng(0)
    ang = geometry.euler_to_rotation(rng.uniform(-0.05, 0.05, (8, 3)).astype(np.float32))
    hyps = geometry.pose_from_Rt(ang @ truth[:3, :3],
                                 truth[:3, 3] + rng.uniform(-5, 5, (8, 3)).astype(np.float32))
    ref = ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda", scene=scene,
                          scene_voxel_mm=2.0 if scene != "projective" else 0.0)
    before = (RC.launches, G.launches, NF.gated_launches, IR.iterate_launches)
    refined, res, unc = ref.track(frame.cpu().numpy(), hyps, with_covariance=True)
    torch.cuda.synchronize()
    after = (RC.launches, G.launches, NF.gated_launches, IR.iterate_launches)
    # the ICP loop through the iteration kernel: one launch for the
    # projective scene, one a pass (30 iterations and the scoring pass) for
    # the NN scene; the information pass through the row gather
    assert after[0] > before[0] and after[1] == before[1] + 1
    assert after[3] == before[3] + (1 if scene == "projective" else 31)
    assert (after[2] > before[2]) == (scene != "projective")
    assert refined.is_cuda and bool(torch.isfinite(refined).all())
    assert float(res.fitness.min()) > 0.7 and bool(torch.isfinite(unc.covariance).all())
    p_refined, p_res, _ = ref.track(frame.cpu().numpy(), hyps, with_covariance=True, _plain=True)
    a, b = refined.cpu().numpy(), p_refined.cpu().numpy()
    assert rotation_angle_deg(a, b).max() <= 0.1
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() <= 0.2
    assert float((res.fitness - p_res.fitness).abs().max()) <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [0.1, 0.005])
def test_stacked_nn_kernel_matches_plain_on_card(card, gate):
    """B3 over a stack of three frames of different sizes, 6 poses of 1,000
    queries (not a tile multiple, so a flat grid would mix frames), frame
    ids out of range included (clamped): equal to its plain version on
    every in-gate query outside the gate's rounding band and on validity,
    and to single-frame B3 on each frame's own table, indices offset by
    the frame's first column."""
    rng = np.random.default_rng(4)
    clouds = [(rng.normal(size=(n, 3)) * [0.04, 0.04, 0.02] + [0, 0, 0.3 + 0.01 * k])
              .astype(np.float32) for k, n in enumerate((3000, 5000, 1700))]
    stack = SceneNNStack.from_clouds(clouds, clouds, gate, device=card)
    fid = torch.tensor([0, 1, 2, 1, -4, 9], dtype=torch.int32, device=card)
    src = np.stack([clouds[min(max(int(f), 0), 2)][rng.integers(0, 1700, 1000)]
                    for f in fid.cpu()]) + rng.normal(0, 0.004, (6, 1000, 3))
    src[3, :200] += 1.0  # whole tiles with no in-gate neighbour
    q = torch.as_tensor(src.astype(np.float32), device=card)
    before = (NF.gated_launches, NF.stacked_launches)
    gi, gd = NF.nn_flash_gated(q, stack.flash_table, stack.flash_boxes, stack.flash_balls,
                               gate, frame_id=fid, frames=3)
    torch.cuda.synchronize()
    assert (NF.gated_launches, NF.stacked_launches) == (before[0] + 1, before[1] + 1)
    pi, pd = NF.nn_flash_gated_plain(q, stack.flash_table, gate, frame_id=fid, frames=3)
    g2 = NF.gate_sq(gate)
    sure = (pd - g2).abs() > (q * q).sum(-1) * 2.0 ** -20
    inside = (pd < g2) & sure
    assert 0 < int(inside.sum()) < q[..., 0].numel()
    assert torch.equal(gi[inside], pi[inside]) and torch.equal(gd[inside], pd[inside])
    assert torch.equal((gd < g2)[sure], (pd < g2)[sure])
    rows = stack.frame_rows
    for n, f in enumerate(fid.clamp(0, 2).tolist()):
        one = SceneNN.from_cloud(clouds[f], clouds[f], gate, device=card)
        si, sd = NF.nn_flash_gated(q[n], one.flash_table, one.flash_boxes, one.flash_balls, gate)
        m = inside[n]
        assert torch.equal(gi[n][m], si[m] + f * rows) and torch.equal(gd[n][m], sd[m])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random", "duplicates", "equidistant", "zeros",
                                  "one_chunk_pads"])
def test_nn_kernels_keep_ties_on_card(card, name):
    """The tie-stress inputs (equal scores across the scan's group,
    warp-part and chunk boundaries, scores of +-0, pad columns, partial
    tiles) through B2, B3 and stacked B3: idx and dist^2 equal the plain
    versions bit for bit; the gate holds every query."""
    table, q = (t.to(card) for t in nn_ties.cases()[name])
    gate = nn_ties.GATE_M
    pi, pd = NF.nn_flash_packed_plain(q, table)
    assert bool((pd < NF.gate_sq(gate)).all())
    ki, kd = NF.nn_flash_packed(q, table)
    gi, gd = NF.nn_flash_gated(q, table, NF.chunk_boxes(table), NF.ball_table(table), gate)
    both = nn_ties.stacked(table)
    pairs = q.reshape(2, -1, 3)
    fid = torch.tensor([0, 1], dtype=torch.int32, device=card)
    si, sd = NF.nn_flash_gated(pairs, both, NF.chunk_boxes(both), NF.ball_table(both), gate,
                               frame_id=fid, frames=2)
    torch.cuda.synchronize()
    for i, d in ((ki, kd), (gi, gd)):
        assert torch.equal(i, pi) and torch.equal(d.view(torch.int32), pd.view(torch.int32))
    wi, wd = NF.nn_flash_gated_plain(pairs, both, gate, frame_id=fid, frames=2)
    assert torch.equal(si, wi) and torch.equal(sd.view(torch.int32), wd.view(torch.int32))
    # frame 1 is frame 0 reversed: a lone minimum maps to the mirrored
    # column, a tie to the smallest column of the reversed order
    half = table.shape[1]
    assert bool((si[1] >= half).all()) and bool((si[0] < half).all())


@pytest.mark.cuda
def test_nn_kernel_refuses_an_unaligned_table_on_card(card):
    """The kernel copies the scene table 16 bytes at a time: a contiguous
    table that starts 4 bytes into its storage raises, it is not launched."""
    flat = torch.zeros(8 * 128 + 1, device=card)
    table = flat[1:].view(8, 128)
    assert table.is_contiguous() and table.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        NF.nn_flash_packed(torch.zeros((4, 3), device=card), table)


@pytest.mark.cuda
def test_mxu_kernel_matches_plain_on_card(card):
    """P1 computes B2's function: its idx and dist^2 equal its plain version's
    and B2's kernel's bit for bit, on a structured cloud (20,000 lexsorted
    points, 70,001 queries with 3 mm noise: a partial last CTA) and on the
    tie lattice (16^3 points in a random column order, queries with 2, 4
    or 8 points at exactly the same distance: the smallest index wins). The
    instrumented build returns the same bits and re-scores at least one
    pair a query, with every screened score within eps_q of B2's."""
    from pose_refine_tpu_torch.probes import mxu_nn

    rng = np.random.default_rng(6)
    pts = (rng.normal(size=(20000, 3)) * [0.05, 0.05, 0.02] + [0, 0, 0.3]).astype(np.float32)
    pts = pts[np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2]))]
    q = (pts[rng.integers(0, 20000, 70001)]
         + rng.normal(0, 0.003, (70001, 3))).astype(np.float32)
    for pts, q in ((pts, q), mxu_nn.tie_lattice(16, 30000, seed=5)):
        q = torch.as_tensor(q, device=card)
        table = NM.pack_scene_mxu(pts).to(card)
        before = NM.launches
        ki, kd = NM.nn_flash_mxu(q, table)
        torch.cuda.synchronize()
        assert NM.launches == before + 1 and ki.dtype == torch.int32 and kd.shape == q.shape[:1]
        pi, pd = NM.nn_flash_mxu_plain(q, table)
        assert mxu_nn.compare(ki, kd, pi, pd)["equal"]
        bi, bd = NF.nn_flash_packed(q, NF.pack_scene(pts).to(card))
        assert mxu_nn.compare(ki, kd, bi, bd)["equal"]
        si, sd, rescored, ratio = NM.nn_flash_mxu_cuda(q, table, stats=True)
        assert mxu_nn.compare(si, sd, ki, kd)["equal"]
        assert int(rescored.min()) >= 1 and float(ratio.max()) <= 1.0


@pytest.mark.cuda
def test_padding_triangles_write_no_pixel_on_card(card):
    """A MultiModelRefiner's zero-area padding triangles get an empty box and
    write no pixel in the raster kernel: the smaller mesh rendered through
    its padded row of the (M, T, 3, 3) table equals its own render, for a
    per-pose batch of both models."""
    K = geometry.LINEMOD_K
    big = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    small = mesh.make_icosphere(radius=30.0, subdivisions=2)
    ref = ptt.MultiModelRefiner([big, small], K=K, device=card, decimate_mm=0.0)
    n_small = len(small.tris)
    assert ref.tris_table.shape[1] > n_small
    pose = geometry.pose_from_Rt(np.eye(3, dtype=np.float32),
                                 np.array([0, 0, 300], np.float32)).to(card)
    poses = pose[None].expand(4, 4, 4).contiguous()
    ids = [0, 1, 1, 0]
    tris, _poses, _squeeze = ref._per_pose_tris(ids, poses)
    before = RC.launches
    got = RC.rasterize(tris, poses, 640, 480, ref.proj)
    torch.cuda.synchronize()
    assert RC.launches == before + 1
    alone = RC.rasterize(ref.tris_table[1, :n_small], pose[None], 640, 480, ref.proj)[0]
    assert int((alone > 0).sum()) > 1000
    assert torch.equal(got[1], alone) and torch.equal(got[2], alone)
    assert not torch.equal(got[0], alone)


def same_bits(a, b):
    """Equal float tensors, NaN where the other is NaN (the bits of a NaN
    aside), or equal tensors of another dtype."""
    if a.dtype.is_floating_point:
        return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


MODES = {"plane": (0.0, False), "huber": (0.004, False), "p2p": (0.0, True),
         "p2p-huber": (0.004, True)}


def iterate_both(card, case, crit, mode=(0.0, False), start=None, coarse=(0, 2),
                 valid_map=None):
    """The ICP of scene_case(case)'s clouds through the scene's iteration
    kernel and through plain_association's plain iteration (both through
    icp._icp_run, which anchors the padded rows): (kernel result, kernel
    cloud, plain result, plain cloud, iteration launches of the kernel run).
    ``start`` maps the initial state (the ICPState of _icp_run) for the
    edge cases, on both runs alike; ``coarse`` = (coarse_iters,
    coarse_stride) the point schedule; ``valid_map`` maps the valid mask."""
    from pose_refine_tpu_torch import icp

    sc, ids, plain_query, cloud, valid = scene_case(card, case)
    if valid_map is not None:
        valid = valid_map(valid)
    iterate = sc.iterate if ids is None else sc.iterate_at(ids)
    query = sc.query if ids is None else sc.query_at(ids)
    kw = dict(robust_delta=mode[0], estimation="point_to_point" if mode[1] else "point_to_plane",
              coarse_iters=coarse[0], coarse_stride=coarse[1])

    def wrap(fn):
        if start is None:
            return fn
        return lambda state, *args, **modes: fn(start(state), *args, **modes)

    before = IR.iterate_launches
    k_res, k_cloud = icp._icp_run(cloud, valid, icp.Association(query, wrap(iterate)), crit,
                                  **kw)
    torch.cuda.synchronize()
    n = IR.iterate_launches - before
    plain = icp.plain_association(plain_query)
    p_res, p_cloud = icp._icp_run(cloud, valid, plain._replace(iterate=wrap(plain.iterate)),
                                  crit, **kw)
    return k_res, k_cloud, p_res, p_cloud, n


def assert_same_icp(k_res, k_cloud, p_res, p_cloud):
    for name, a, b in (("T", k_res.transformation, p_res.transformation),
                       ("fitness", k_res.fitness, p_res.fitness),
                       ("rmse", k_res.inlier_rmse, p_res.inlier_rmse),
                       ("cloud", k_cloud, p_cloud)):
        assert same_bits(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", ["projective", "stacked", "slabs", "slabs16", "nn", "kd",
                                  "nn_stacked", "poses512"])
def test_icp_iterate_kernel_matches_plain_on_card(card, case, mode):
    """The iteration kernel against its plain version (icp_loop_plain over
    the scene's plain query), per front end and mode, 12 iterations: T,
    fitness, rmse and the final cloud bit for bit (NaN where the plain
    version's is NaN), including the pose with no valid point (done at
    once, T the identity) and pose 0's points at z = 0, behind the camera,
    overflowing and NaN; one launch a refine against a projective scene,
    one a pass against an NN scene. At 512 poses the kernel runs 128
    threads a CTA (and its plain version adds in that order)."""
    if case == "poses512":
        assert IR.geometry(512, 2048) == (1, IR.NARROW_THREADS)
    crit = ptt.ICPConvergenceCriteria(max_iteration=12)
    k_res, k_cloud, p_res, p_cloud, n = iterate_both(card, case, crit, MODES[mode])
    assert_same_icp(k_res, k_cloud, p_res, p_cloud)
    assert n == (13 if case in ("nn", "kd", "nn_stacked") else 1)
    assert torch.equal(k_res.transformation[2], torch.eye(4, device=card))
    assert float(k_res.fitness[2]) == 0.0
    moved = ~torch.isclose(k_res.transformation, torch.eye(4, device=card)).all(dim=(1, 2))
    assert bool(moved[torch.arange(moved.shape[0], device=card) != 2].all())


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["max_iteration_0", "done_at_start", "one_iteration",
                                  "empty_pose", "done_at_iteration_0", "ill_conditioned"])
@pytest.mark.parametrize("case", ["projective", "slabs16", "nn", "poses512"])
def test_icp_iterate_kernel_edges_on_card(card, case, edge):
    """The kernel's latch and tail at the edges, bit for bit against the
    plain version: max_iteration = 0 (the scoring pass alone: scores set,
    nothing moves), a state whose every pose is done at the start (returned
    as it came, scores 0), one iteration and the scoring pass; a pose with
    no valid point beside pose 2's (T the identity, fitness 0); every pose
    done at iteration 0 (thresholds no change can miss: scored, not moved;
    pose 0 aside where its masked NaN point makes its rmse NaN, which no
    threshold meets);
    and pose 1's cloud on a line at z = 0.3 m, whose damped system is badly
    conditioned (cond > 4e4: the rotation about the line is not seen), as
    tests/test_torch_icp_iterate.py's witness for solve_damped_plain."""
    crit = ptt.ICPConvergenceCriteria(max_iteration=1 if edge == "one_iteration" else 0)
    start, valid_map = None, None
    if edge in ("done_at_start", "empty_pose", "ill_conditioned"):
        crit = ptt.ICPConvergenceCriteria(max_iteration=6)
    if edge == "done_at_iteration_0":
        crit = ptt.ICPConvergenceCriteria(relative_fitness=2.0, relative_rmse=1.0,
                                          max_iteration=6)
    if edge == "done_at_start":

        def start(state):
            state.done.fill_(True)
            return state

    if edge == "empty_pose":

        def valid_map(valid):
            valid = valid.clone()
            valid[1] = False
            return valid

    if edge == "ill_conditioned":
        _sc, _ids, plain_query, cloud, valid = scene_case(card, case)
        p = cloud.shape[1]
        line = torch.zeros((p, 3), device=card)
        line[:, 0] = torch.linspace(-0.09, 0.09, p, device=card)
        line[:, 2] = 0.3
        cloud = cloud.clone()
        cloud[1] = line
        AtA, _Atb, count, _mse = IR.unpack_sums(IR.assoc_reduce_plain(cloud, valid, plain_query))
        M = AtA[1].double().cpu().numpy() + 0.01 * np.eye(6)
        assert float(count[1]) > 100 and np.linalg.cond(M) > 4e4

        def start(state):
            state.cloud[1] = line
            return state

    k_res, k_cloud, p_res, p_cloud, _n = iterate_both(card, case, crit, start=start,
                                                      valid_map=valid_map)
    assert_same_icp(k_res, k_cloud, p_res, p_cloud)
    eye = torch.eye(4, device=card).expand_as(k_res.transformation)
    if edge in ("max_iteration_0", "done_at_start"):
        assert torch.equal(k_res.transformation, eye)
    if edge == "done_at_iteration_0":
        assert torch.equal(k_res.transformation[1:], eye[1:])
    if edge == "done_at_start":
        assert not bool(k_res.fitness.any()) and not bool(k_res.inlier_rmse.any())
    elif edge in ("max_iteration_0", "done_at_iteration_0"):
        assert float(k_res.fitness.max()) > 0.0
    elif edge == "empty_pose":
        assert torch.equal(k_res.transformation[1:3], eye[1:3])
        assert not bool(k_res.fitness[1:3].any())
    elif edge == "ill_conditioned":
        assert not torch.equal(k_res.transformation[1], eye[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plane", "p2p-huber"])
@pytest.mark.parametrize("case", ["projective", "stacked", "slabs16", "nn", "kd", "nn_stacked"])
@pytest.mark.parametrize("coarse", [(5, 2), (1, 3)])
def test_icp_coarse_mode_matches_plain_on_card(card, case, mode, coarse):
    """The point schedule through the iteration kernel's coarse mode against
    its plain version (icp_coarse_plain, handoff_plain, then the ordinary
    iterations), 12 iterations: T, fitness, rmse and the final cloud bit
    for bit. A projective refine is 2 launches (the coarse phase with the
    hand-off, then the rest); an NN refine one a pass, 13. The pose with no
    valid point holds through the coarse phase and stays the identity."""
    crit = ptt.ICPConvergenceCriteria(max_iteration=12)
    k_res, k_cloud, p_res, p_cloud, n = iterate_both(card, case, crit, MODES[mode],
                                                     coarse=coarse)
    assert_same_icp(k_res, k_cloud, p_res, p_cloud)
    assert n == (13 if case in ("nn", "kd", "nn_stacked") else 2)
    assert torch.equal(k_res.transformation[2], torch.eye(4, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["projective", "slabs16", "kd"])
def test_icp_coarse_holds_where_strided_rows_are_invalid_on_card(card, case):
    """Pose 0's rows 0, 2, 4, ... invalid: its coarse phase finds no inlier
    and holds (the kernel leaves its loop, the plain version iterates on:
    equal, as the held cloud associates the same way again), and its fine
    phase starts from the identity; kernel == plain bit for bit, and the
    coarse launch alone leaves pose 0's T the identity."""
    from pose_refine_tpu_torch import icp

    def drop_even(valid):
        valid = valid.clone()
        valid[0, ::2] = False
        return valid

    crit = ptt.ICPConvergenceCriteria(max_iteration=10)
    k_res, k_cloud, p_res, p_cloud, _n = iterate_both(card, case, crit, coarse=(4, 2),
                                                      valid_map=drop_even)
    assert_same_icp(k_res, k_cloud, p_res, p_cloud)
    sc, _ids, plain_query, cloud, valid = scene_case(card, case)
    state, valid, n_total = icp._icp_start(cloud, drop_even(valid))
    cstate, cvalid = IR.coarse_start(state, valid, 2)
    k = sc.iterate(IR.ICPState(*(t.clone() for t in state)), valid, n_total, crit,
                   coarse_iters=4, coarse_stride=2)
    _c, T = IR.icp_coarse_plain(cstate.cloud, state.T, cvalid, plain_query, 4)
    assert torch.equal(T[0], torch.eye(4, device=card))
    assert not torch.equal(T[1], torch.eye(4, device=card))
    assert bool(torch.isfinite(k.T).all())


@pytest.mark.cuda
def test_icp_coarse_refuses_what_it_cannot_launch_on_card(card):
    """The hand-off belongs to a coarse launch and to the state's poses."""
    from pose_refine_tpu_torch import icp

    sc, _ids, _q, cloud, valid = scene_case(card, "projective")
    state, valid, n_total = icp._icp_start(cloud, valid)
    crit = ptt.ICPConvergenceCriteria(max_iteration=4)
    front = dict(K=sc.K, gate=sc.max_dist_diff, height=sc.height, width=sc.width)
    with pytest.raises(ValueError, match="handoff"):
        IR._IterateLaunch(state, valid, n_total, crit, sc.table, handoff=state.cloud, **front)
    with pytest.raises(ValueError, match="handoff"):
        IR._IterateLaunch(state, valid, n_total, crit, sc.table, coarse=True,
                          handoff=state.cloud[:2].contiguous(), **front)
    run = IR._IterateLaunch(state, valid, n_total, crit, sc.table, coarse=True, **front)
    with pytest.raises(ValueError, match="hand-off"):
        run(0, 2, handoff=True)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["projective", "nn", "nn_bruteforce"])
def test_schedule_refine_on_card_matches_cpu(card, scene):
    """refine(schedule=[(0.4, 15), (0.1, 20), (0.03, 15)]) with
    coarse_iters=6 on the card (raster kernel, the NN kernels, the iteration
    kernel's coarse mode) against the same levels through the plain
    versions (each level a refine_poses against the gated scene, the plain
    raster, plain_association's plain iteration), on the card and on the
    CPU: 100% verdicts, every pose within 0.1 deg, 0.2 mm and 5e-3 of
    fitness. The workload is the bench recipe (+-10 deg/axis, +-20 mm) on
    the bumpy sphere (50, 4) at 320x240, where every start converges: the
    CPU path differs from the card's in last bits (torch's CPU sine and
    cosine, and the lift's z, which the card's division by a host scalar
    takes as a product with the rounded reciprocal), and at 160x120 with
    +-17 deg starts three levels of re-renders turned those bits into 0.2-0.7
    deg at poses that converge slowly. Each level's scene carries the
    replaced gate: the card refine against _scene_with_gate equals the one
    against a scene built with that gate, bit for bit."""
    from pose_refine_tpu_torch import icp
    from pose_refine_tpu_torch.pipeline import _scene_with_gate, refine_poses

    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.5
    R = np.array([[0.34768538, 0.93761126, 0.0],
                  [0.70540612, -0.26157897, -0.65877056],
                  [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = geometry.pose_from_Rt(R, np.array([20, 20, 320], np.float32)).numpy()
    rng = np.random.default_rng(4)
    d_rot = geometry.euler_to_rotation(rng.uniform(-0.17, 0.17, (8, 3)).astype(np.float32))
    starts = geometry.pose_from_Rt(d_rot.numpy() @ truth[:3, :3],
                                   truth[:3, 3] + rng.uniform(-20, 20, (8, 3))).numpy()
    proj = geometry.compute_proj(K, 320, 240, device="cpu")
    depth = RC.rasterize_plain(m.tris, truth[None], 320, 240, proj, device="cpu")[0].numpy()
    kw = dict(K=K, width=320, height=240, max_points=2048, coarse_iters=6)
    if scene != "projective":
        kw.update(scene=scene, scene_voxel_mm=2.0)
    sched = [(0.4, 15), (0.1, 20), (0.03, 15)]

    def plain_levels(ref):
        poses = torch.as_tensor(starts, device=ref.device)
        for gate, iters in sched:
            gs = _scene_with_gate(ref.scene, gate)
            poses, res = refine_poses(
                ref.tris, poses, gs, ref.proj, ref._K_render_t, width=ref.render_w,
                height=ref.render_h, max_points=ref.max_points,
                criteria=ptt.ICPConvergenceCriteria(max_iteration=iters), window=ref.window,
                stride=ref.stride, roi=ref.roi, coarse_iters=6, coarse_stride=2,
                raster=RC.rasterize_plain, lifter=window_lift,
                query=icp.plain_association(functools.partial(gs.query, plain=True)))
        return poses.cpu().numpy(), res.fitness.cpu().numpy()

    ref = ptt.PoseRefiner(m, device="cuda", **kw).set_scene_depth(depth)
    poses, res = ref.refine(starts, schedule=sched)
    kp, kf = poses.cpu().numpy(), res.fitness.cpu().numpy()
    cpu = ptt.PoseRefiner(m, device="cpu", **kw).set_scene_depth(depth)
    assert (rotation_angle_deg(kp, truth) < 3.0).all()
    for pp, pf in (plain_levels(ref), plain_levels(cpu)):
        np.testing.assert_array_equal(rotation_angle_deg(kp, truth) < 3.0,
                                      rotation_angle_deg(pp, truth) < 3.0)
        assert rotation_angle_deg(kp, pp).max() <= 0.1
        assert np.abs(kp[:, :3, 3] - pp[:, :3, 3]).max() <= 0.2
        assert np.abs(kf - pf).max() <= 5e-3
    narrow = ptt.PoseRefiner(m, device="cuda", max_dist_diff=0.004, **kw).set_scene_depth(depth)
    crit = ptt.ICPConvergenceCriteria(max_iteration=8)
    got = ref.refine(starts, crit, _scene=_scene_with_gate(ref.scene, 0.004))
    want = narrow.refine(starts, crit)
    wide = ref.refine(starts, crit)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].fitness, want[1].fitness)
    assert not torch.equal(got[0], wide[0])


@pytest.mark.cuda
@pytest.mark.parametrize("down_sample,roi", [(1, (0, 0, 0, 0)), (2, (40, 30, 200, 160))])
def test_pose_renderer_on_card_matches_plain(card, down_sample, roi):
    """PoseRenderer on the card (the raster kernel, one launch a render)
    against the same renderer on the CPU (the kernel's plain version):
    depth and mask equal, the converters run on the card."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    R = np.array([[0.34768538, 0.93761126, 0.0],
                  [0.70540612, -0.26157897, -0.65877056],
                  [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    rng = np.random.default_rng(5)
    d_rot = geometry.euler_to_rotation(rng.uniform(-0.5, 0.5, (6, 3)).astype(np.float32))
    poses = geometry.pose_from_Rt(d_rot.numpy() @ R,
                                  np.array([0, 0, 300], np.float32) + rng.uniform(-20, 20, (6, 3))
                                  ).numpy()
    k = ptt.PoseRenderer(m, K=geometry.LINEMOD_K, device="cuda")
    p = ptt.PoseRenderer(m, K=geometry.LINEMOD_K, device="cpu")
    before = RC.launches
    kd, km = k.render_depth_mask(poses, down_sample, roi)
    torch.cuda.synchronize()
    assert RC.launches == before + 1
    assert kd.device.type == "cuda" and kd.dtype == torch.uint16 and km.dtype == torch.uint8
    pd, pm = p.render_depth_mask(poses, down_sample, roi)
    assert torch.equal(kd.cpu(), pd) and torch.equal(km.cpu(), pm)
    assert int((pm > 0).sum()) > 1000


@pytest.mark.cuda
def test_compact_points_on_card_equals_cpu(card):
    """compact_points on the card equals the CPU's bit for bit on the same
    point images, overflow included; depth_to_cloud's slots and counts are
    equal and its coordinates within 2 ULPs (the card's division of the
    depth by the host scalar 1000 is a product with its rounded reciprocal,
    as XLA's is; the CPU divides)."""
    from pose_refine_tpu_torch.ops.depth_to_cloud import compact_points, depth_image_to_points

    rng = np.random.default_rng(6)
    depth = np.where(rng.uniform(size=(4, 120, 160)) > 0.4,
                     rng.integers(250, 400, (4, 120, 160)), 0).astype(np.int32)
    pts, mask = depth_image_to_points(torch.as_tensor(depth), geometry.LINEMOD_K)
    for budget in (16384, 5000):
        got = compact_points(pts.to(card), mask.to(card), budget)
        want = compact_points(pts, mask, budget)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        lifted = ptt.depth_to_cloud(torch.as_tensor(depth, device=card), geometry.LINEMOD_K,
                                    budget)
        assert torch.equal(lifted[1].cpu(), want[1]) and torch.equal(lifted[2].cpu(), want[2])
        ulps = (lifted[0].cpu().view(torch.int32).long() - want[0].view(torch.int32).long()).abs()
        assert int(ulps.max()) <= 2


@pytest.mark.cuda
def test_refine_is_one_iteration_launch_on_card(card):
    """A projective refine's whole ICP loop is one launch of the iteration
    kernel and no launch of the pass alone; an NN refine launches one NN
    kernel and one iteration kernel a pass; both equal the refine through
    the plain versions bit for bit."""
    from pose_refine_tpu_torch import icp
    from pose_refine_tpu_torch.pipeline import refine_poses

    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    R = np.array([[0.34768538, 0.93761126, 0.0],
                  [0.70540612, -0.26157897, -0.65877056],
                  [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = geometry.pose_from_Rt(R, np.array([0, 0, 300], np.float32))
    proj = geometry.compute_proj(geometry.LINEMOD_K, 640, 480, device=card)
    frame = RC.rasterize(m.tris, truth[None], 640, 480, proj, device="cuda")[0]
    rng = np.random.default_rng(1)
    ang = geometry.euler_to_rotation(rng.uniform(-0.1, 0.1, (12, 3)).astype(np.float32))
    hyps = geometry.pose_from_Rt(ang @ truth[:3, :3],
                                 truth[:3, 3] + rng.uniform(-10, 10, (12, 3)).astype(np.float32))
    crit = ptt.ICPConvergenceCriteria(max_iteration=20)
    for scene in ("projective", "nn_bruteforce"):
        ref = ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda", scene=scene)
        ref.set_scene_depth(frame)
        before = (IR.iterate_launches, NF.gated_launches)
        refined, res = ref.refine(hyps, crit)
        torch.cuda.synchronize()
        it, nn = (a - b for a, b in zip((IR.iterate_launches, NF.gated_launches), before))
        assert (it, nn) == ((1, 0) if scene == "projective" else (21, 21))
        p_refined, p_res = refine_poses(
            ref.tris, torch.as_tensor(hyps, device=card), ref.scene, ref.proj,
            ref._K_render_t, width=ref.render_w, height=ref.render_h,
            max_points=ref.max_points, criteria=crit, window=ref.window, stride=ref.stride,
            roi=ref.roi, raster=RC.rasterize_plain, lifter=window_lift,
            query=icp.plain_association(lambda c: ref.scene.query(c, plain=True)))
        assert torch.equal(refined, p_refined) and torch.equal(res.fitness, p_res.fitness)
        assert float(res.fitness.min()) > 0.5


@pytest.mark.cuda
def test_icp_iterate_refuses_what_it_cannot_launch_on_card(card):
    """The iteration kernel's wrappers check the pass's arguments (valid's
    dtype, a row offset per pose, K's device, idx's dtype, the table's 16-byte
    alignment) and the state: shapes, dtypes and the device of T, the
    scores, the latch and the divisors."""
    from pose_refine_tpu_torch.ops.icp_reduce import ICPState

    sc, _ids, _q, cloud, valid = scene_case(card, "projective")
    n = cloud.shape[0]
    crit = ptt.ICPConvergenceCriteria(max_iteration=3)
    good = ICPState(cloud.clone(), torch.eye(4, device=card).expand(n, 4, 4).clone(),
                    torch.zeros(n, device=card), torch.zeros(n, device=card),
                    torch.zeros(n, dtype=torch.bool, device=card))
    n_total = valid.sum(dim=-1).float()
    for bad, match in ((good._replace(T=good.T[:, :3]), "T must be"),
                       (good._replace(done=good.done.to(torch.uint8)), "done must be"),
                       (good._replace(fitness=good.fitness.cpu()), "fitness must be"),
                       (good._replace(cloud=good.cloud[0]), r"\(N, P, 3\)")):
        with pytest.raises(ValueError, match=match):
            sc.iterate(bad, valid, n_total, crit)
    with pytest.raises(ValueError, match="n_total must be"):
        sc.iterate(good, valid, n_total[:2], crit)
    with pytest.raises(ValueError, match="valid must be"):
        sc.iterate(good, valid[:, 1:], n_total, crit)
    front = (crit, sc.table, sc.K, sc.max_dist_diff, sc.height, sc.width)
    with pytest.raises(ValueError, match="valid must be torch.bool"):
        IR.icp_iterate_projective_cuda(good, valid.to(torch.uint8), n_total, *front)
    with pytest.raises(ValueError, match="one row offset per pose"):
        IR.icp_iterate_projective_cuda(good, valid, n_total, *front,
                                       base=torch.zeros(n + 1, dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="K must be torch.float32 on cuda"):
        IR.icp_iterate_projective_cuda(good, valid, n_total, crit, sc.table, sc.K.cpu(),
                                       sc.max_dist_diff, sc.height, sc.width)
    with pytest.raises(ValueError, match="int32 or int64"):
        IR.icp_iterate_indexed_cuda(good, valid, n_total, crit, sc.table,
                                    lambda c: (torch.zeros(c.shape[:-1], device=card),
                                               torch.zeros(c.shape[:-1], device=card)), 0.01)
    flat = torch.zeros(8 * 64 + 1, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        IR.icp_iterate_projective_cuda(good, valid, n_total, crit, flat[1:].view(64, 8), sc.K,
                                       sc.max_dist_diff, 8, 8)


@pytest.mark.cuda
def test_launch_raises_on_an_error_code_on_card(card):
    """A C entry that refuses its arguments returns a CUDA error code, and
    the launch raises a RuntimeError that names the kernel and the error:
    prt_icp_iterate asked through a bound launcher for iterations past the
    scoring pass (it_end > max_iteration + 1), which only the entry checks.
    Nothing runs and nothing is counted."""
    from pose_refine_tpu_torch.ops.icp_reduce import ICPState

    sc, _ids, _q, cloud, valid = scene_case(card, "projective")
    n = cloud.shape[0]
    crit = ptt.ICPConvergenceCriteria(max_iteration=3)
    eye = torch.eye(4, device=card).expand(n, 4, 4)
    state = ICPState(cloud.clone(), eye.clone(), torch.zeros(n, device=card),
                     torch.zeros(n, device=card), torch.zeros(n, dtype=torch.bool, device=card))
    run = IR._IterateLaunch(state, valid, valid.sum(dim=-1).float(), crit, sc.table, K=sc.K,
                            gate=sc.max_dist_diff, height=sc.height, width=sc.width)
    before = IR.iterate_launches
    with pytest.raises(RuntimeError, match=r"^icp_iterate kernel launch failed: CUDA error 1 "
                                           r"\(invalid argument\)$"):
        run(0, crit.max_iteration + 2)
    torch.cuda.synchronize()
    assert IR.iterate_launches == before
    assert torch.equal(run.state.T, eye) and same_bits(run.state.cloud, cloud)


@pytest.mark.cuda
def test_sin_cos_equal_torch_on_card(card):
    """The tail's sinf / cosf equal torch.sin / torch.cos on the card bit
    for bit, at ICP steps and over a wide range (the plain iteration's
    trigonometry is torch's)."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(np.concatenate([rng.normal(0, 0.03, 100000),
                                        rng.uniform(-10, 10, 100000)]).astype(np.float32),
                        device=card)
    s, c = IR.sin_cos_cuda(x)
    assert torch.equal(s, torch.sin(x)) and torch.equal(c, torch.cos(x))


def _bench_like_case(card, n=12, seed=1):
    """A bumpy sphere at 640x480 rendered on the card at the reference
    viewpoint, and n hypotheses +-6 deg / +-10 mm around it."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    R = np.array([[0.34768538, 0.93761126, 0.0],
                  [0.70540612, -0.26157897, -0.65877056],
                  [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = geometry.pose_from_Rt(R, np.array([0, 0, 300], np.float32))
    proj = geometry.compute_proj(geometry.LINEMOD_K, 640, 480, device=card)
    frame = RC.rasterize(m.tris, truth[None], 640, 480, proj, device="cuda")[0]
    hyps = ptt.sample_hypotheses(truth.numpy(), n, rot_deg=6.0, trans_mm=10.0, rng=seed)
    return m, frame, hyps


@pytest.mark.cuda
def test_native_kdtree_builds_on_card_machine(card):
    """The card machine has the compiler: the native builder is built at
    first use, taken by backend="auto", and equals the numpy builder bit
    for bit on the device-lifted scene cloud; a scene="nn" refine's scene
    is built on it."""
    from pose_refine_tpu_torch import native
    from pose_refine_tpu_torch.scene import kdtree as tkd
    from pose_refine_tpu_torch.scene.nn import _depth_scene_arrays_host

    assert native.native_available(), native.unavailable_reason()
    m, frame, _hyps = _bench_like_case(card)
    pts, nrm, mask = _depth_scene_arrays_host(frame.cpu().numpy(), geometry.LINEMOD_K)
    a = tkd.build_kdtree(pts[mask], nrm[mask], backend="native")
    b = tkd.build_kdtree(pts[mask], nrm[mask], backend="numpy")
    for f in ("points", "normals", "parent", "child", "split_dim", "split_v", "bbox", "bounds"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["projective", "nn", "nn_bruteforce"])
def test_scene_save_load_refines_alike_on_card(card, tmp_path, scene):
    """A card scene saved to .npz and loaded back onto the card refines the
    same hypotheses bit for bit as the original."""
    from pose_refine_tpu_torch.utils import serialization

    m, frame, hyps = _bench_like_case(card)
    ref = ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda", scene=scene,
                          scene_voxel_mm=2.0 if scene != "projective" else 0.0)
    ref.set_scene_depth(frame)
    crit = ptt.ICPConvergenceCriteria(max_iteration=12)
    want = ref.refine(hyps, crit)
    path = str(tmp_path / "scene.npz")
    serialization.save(path, ref.scene)
    loaded = serialization.load(path)
    assert loaded.table.device.type == "cuda"
    got = ref.refine(hyps, crit, _scene=loaded)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["projective", "nn"])
def test_devices_split_equals_single_on_card(card, scene):
    """devices=["cuda:0", "cuda:0"]: the batch padded (133 poses, 2 shards
    of 67; the whole batch sums a pose of 2,048 points in one slab, a shard
    alone would take two), split over two streams of the card and gathered
    equals the single device's refine bit for bit, covariance included,
    and so does a tracked frame's packed session buffer; devices=None on
    one card is the single-device path."""
    m, frame, hyps = _bench_like_case(card, n=133)
    kw = dict(K=geometry.LINEMOD_K, scene=scene, render_scale=2, max_points=2048, window=128,
              scene_voxel_mm=2.0 if scene == "nn" else 0.0)
    one = ptt.PoseRefiner(m, device="cuda", **kw).set_scene_depth(frame)
    split = ptt.PoseRefiner(m, devices=["cuda:0", "cuda:0"], **kw).set_scene_depth(frame)
    assert split.devices == [torch.device("cuda", 0)] * 2
    if torch.cuda.device_count() == 1:
        assert one.devices is None
    assert IR.slabs_for(133, 2048) != IR.slabs_for(67, 2048)
    crit = ptt.ICPConvergenceCriteria(max_iteration=12)
    want = one.refine(hyps, crit, with_covariance=True)
    got = split.refine(hyps, crit, with_covariance=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for a, b in zip((*got[1], *got[2]), (*want[1], *want[2])):
        assert (a is None and b is None) or torch.equal(a, b)
    packed = [r.track_packed_async(frame, hyps, crit).wait()[0] for r in (split, one)]
    assert torch.equal(*packed)


def _lift_bits_equal(got, want):
    """L1's (clouds, valid) equal to the plain version's bit for bit."""
    return (got[0].shape == want[0].shape
            and torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("morton", [False, True], ids=["projective", "morton"])
@pytest.mark.parametrize("name", sorted(lift_cases.SHAPES))
def test_lift_kernel_matches_plain_on_card(card, name, morton):
    """L1 equals window_lift on the card bit for bit on lift_cases' renders
    (blobs, an empty render, border-clipped objects, holes and negative
    pixels, a full render, ROI offsets) at every regime of SHAPES: P a
    power of two, colliding ranks, no selection, a window taller than the
    render, shared memory above 48 KB, the scratch buffer (P = 57,600 and
    65,536); one launch a call, and twice the same bits."""
    h, w, window, stride, k, tl = lift_cases.SHAPES[name]
    depth = torch.as_tensor(lift_cases.renders(h, w, seed=2), device=card)
    K = geometry.LINEMOD_K.copy()
    K[0] *= w / 640.0
    K[1] *= h / 480.0
    K = torch.as_tensor(K, device=card)
    kw = dict(window=window, stride=stride, max_points=k, morton=morton, tl_x=tl[0],
              tl_y=tl[1])
    before = LC.launches
    got = LC.window_lift_cuda(depth, K, **kw)
    again = LC.window_lift_cuda(depth, K, **kw)
    torch.cuda.synchronize()
    assert LC.launches == before + 2
    want = window_lift(depth, K, **kw)
    assert _lift_bits_equal(got, want) and _lift_bits_equal(again, want)
    assert bool(want[1].any()) and not bool(want[1].all())


@pytest.mark.cuda
def test_window_lift_is_one_launch_at_the_bench_shape_on_card(card):
    """The pipeline's lift of CUDA renders is one L1 launch and no other
    device kernel (no sort, gather or argsort), at the bench's shape (the
    decimated mesh's renders in the auto ROI, window 128 / stride 2, 2,048
    points), projective and Morton, bit for bit with window_lift."""
    from pose_refine_tpu_torch.pipeline import _window_lift

    m, frame, hyps = _bench_like_case(card, n=256)
    ref = ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda", render_scale=2,
                          max_points=2048, window=128, stride=2, decimate_mm=4.0)
    ref.set_scene_depth(frame)
    depth = RC.rasterize(ref.tris, torch.as_tensor(hyps, device=card), ref.render_w,
                         ref.render_h, ref.proj, roi=ref.roi)
    proj_scene = object.__new__(SceneProjective)
    nn_scene = object.__new__(SceneNN)
    for scene, morton in ((proj_scene, False), (nn_scene, True)):
        args = (depth, ref._K_render_t, scene, ref.max_points, ref.window, ref.stride, ref.roi)
        got = _window_lift(*args)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for _ in range(5):  # the profiler now and then records no device activity
            before = LC.launches
            with torch.profiler.profile(activities=acts) as prof:
                _window_lift(*args)
                torch.cuda.synchronize()
            assert LC.launches == before + 1
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if kernels:
                break
        assert len(kernels) == 1 and "window_lift" in kernels[0], kernels
        want = window_lift(depth, ref._K_render_t, window=ref.window, stride=ref.stride,
                           max_points=ref.max_points, morton=morton, tl_x=ref.roi[0],
                           tl_y=ref.roi[1])
        assert got[0].shape == (256, 2048, 3) and _lift_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["slice", "nn", "stacked", "multimodel", "track",
                                  "track_nn"])
def test_paths_through_lift_kernel_equal_the_plain_lift_on_card(card, path):
    """Each path that reaches the window lift takes L1 once a refine or
    tracked frame, and equals the same path with the plain lift in L1's
    place bit for bit (every other kernel as it is): L1's order feeds B3's
    pruning and the ICP's sums, so a difference in any row would show. A
    single-scene refine's second run is its CUDA graph's capture, and its
    plain-lift twin runs eagerly (``_scene=ref.scene``): a replay would run
    the lift it captured."""
    import unittest.mock

    from pose_refine_tpu_torch import pipeline

    m, frame, hyps = _bench_like_case(card, n=24)
    kw = dict(K=geometry.LINEMOD_K, render_scale=2, max_points=512, window=96, stride=2)
    crit = ptt.ICPConvergenceCriteria(max_iteration=10)
    if path == "slice":
        ref = ptt.PoseRefiner(m, device="cuda", **kw).set_scene_depth(frame)
        run = lambda: ref.refine(hyps, crit)  # noqa: E731
    elif path == "nn":
        ref = ptt.PoseRefiner(m, device="cuda", scene="nn", scene_voxel_mm=2.0,
                              **kw).set_scene_depth(frame)
        run = lambda: ref.refine(hyps, crit)  # noqa: E731
    elif path == "stacked":
        frames = torch.stack([frame, torch.roll(frame, 12, dims=1)]).cpu().numpy()
        ref = ptt.PoseRefiner(m, device="cuda", scene="nn_bruteforce", scene_voxel_mm=2.0,
                              **kw).set_scene_depths(frames)
        ids = np.arange(24, dtype=np.int32) % 2
        run = lambda: ref.refine(hyps, crit, scene_ids=ids)  # noqa: E731
    elif path == "multimodel":
        ref = ptt.MultiModelRefiner([m, mesh.make_bumpy_sphere(radius=60.0, subdivisions=3)],
                                    device="cuda", **kw)
        ref.set_scene_depth(frame)
        ids = np.arange(24, dtype=np.int32) % 2
        run = lambda: ref.refine(ids, hyps, criteria=crit)  # noqa: E731
    else:
        scene = "projective" if path == "track" else "nn_bruteforce"
        ref = ptt.PoseRefiner(m, device="cuda", scene=scene,
                              scene_voxel_mm=0.0 if scene == "projective" else 2.0, **kw)
        run = lambda: ref.track(frame, hyps, crit, with_covariance=True,  # noqa: E731
                                _pack_outputs=True)
    run()  # plans the ROI (and the tracked NN scene's pool)
    torch.cuda.synchronize()
    before = LC.launches
    got = run()
    torch.cuda.synchronize()
    assert LC.launches == before + 1
    with unittest.mock.patch.object(pipeline, "window_lift_cuda", window_lift):
        want = ref.refine(hyps, crit, _scene=ref.scene) if path in ("slice", "nn") else run()
    torch.cuda.synchronize()
    assert LC.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert (x is None and y is None) or torch.equal(x, y)


def _table_bits_equal(got, want):
    """Two scene tables equal bit for bit (signed zeros included)."""
    return got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


# LINEMOD's camera and one with fractional entries everywhere
_SCENE_TABLE_KS = (geometry.LINEMOD_K,
                   np.array([[600.5, 0, 321.7], [0, 590.25, 239.3], [0, 0, 1]], np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(scene_table_cases.SHAPES))
def test_scene_table_kernel_matches_plain_on_card(card, shape):
    """The scene table kernel equals its plain version run on the card bit
    for bit on scene_table_cases' frames (holes and negative pixels,
    neighbour steps of exactly +-49 / +-50 / +-51 mm, depths around and over
    the 2,000 mm gate, the interior's last rows and columns, random depths)
    at every shape (640 x 480, odd sizes, a frame with one interior row,
    none, a sliver), under two cameras; the stack of those frames equals
    its plain version, a 1-frame stack the frame alone; one launch a call;
    frames of another integer type are converted on the card."""
    h, w = scene_table_cases.SHAPES[shape]
    for cam in _SCENE_TABLE_KS:
        K = torch.as_tensor(cam, dtype=torch.float32, device=card)
        for kind in scene_table_cases.KINDS:
            depth = torch.as_tensor(scene_table_cases.frame(kind, h, w, seed=5), device=card)
            before = ST.launches
            got = ST.scene_table_cuda(depth, K)
            torch.cuda.synchronize()
            assert ST.launches == before + 1
            want = SP._build_projective_table_plain(depth, K)
            assert _table_bits_equal(got, want), (shape, kind, int(
                (got.view(torch.int32) != want.view(torch.int32)).any(1).sum()))
        frames = torch.as_tensor(scene_table_cases.stack(h, w, seed=6), device=card)
        got = ST.scene_table_cuda(frames, K)
        assert _table_bits_equal(got, SP._build_projective_table_plain(frames, K))
        one = ST.scene_table_cuda(frames[1:2].contiguous(), K)
        assert _table_bits_equal(one, ST.scene_table_cuda(frames[1].contiguous(), K))
        for dtype in (torch.int16, torch.int64):
            cast = frames.to(dtype)
            before = ST.launches
            other = SP._build_projective_table(cast, K)
            assert ST.launches == before + 1
            assert _table_bits_equal(other, ST.scene_table_cuda(cast.to(torch.int32), K))
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_scene_table_refuses_what_it_cannot_launch_on_card(card):
    K = torch.as_tensor(geometry.LINEMOD_K, device=card)
    depth = torch.zeros((48, 64), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="contiguous int32"):
        ST.scene_table_cuda(depth.to(torch.int64), K)
    with pytest.raises(ValueError, match="contiguous int32"):
        ST.scene_table_cuda(depth.t(), K)
    with pytest.raises(ValueError, match="exceed the kernel's grid"):
        ST.scene_table_cuda(torch.zeros((ST.MAX_FRAMES + 1, 1, 1), dtype=torch.int32,
                                        device=card), K)
    assert ST.scene_table_cuda(depth[:0], K).shape == (0, 8)


@pytest.mark.cuda
def test_scene_table_one_launch_a_scene_on_card(card):
    """set_scene_depth, set_scene_depths, a tracked frame and each step of a
    TrackingSession build their projective table in one launch of the
    kernel, equal to the plain version's table on the card; a stack's
    frames are the frames' own tables."""
    m, frame, hyps = _bench_like_case(card)
    ref = ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda")
    host = frame.cpu().numpy()
    before = ST.launches
    ref.set_scene_depth(host)
    assert ST.launches == before + 1
    assert _table_bits_equal(ref.scene.table,
                             SP._build_projective_table_plain(frame, ref.scene.K))
    ref.set_scene_depths(np.stack([host, host[::-1].copy(), host]))
    assert ST.launches == before + 2
    hw = host.size
    assert _table_bits_equal(ref.scene.table[:hw], ref.scene.table[2 * hw:])
    assert _table_bits_equal(ref.scene.lane(0).table,
                             SP._build_projective_table_plain(frame, ref.scene.K))
    ref.track(frame, hyps[:4])
    assert ST.launches == before + 3
    session = ptt.TrackingSession(ref, hyps[0], n_hypotheses=4, seed=1)
    session.step(frame)
    session.step(frame)
    torch.cuda.synchronize()
    assert ST.launches == before + 5


@pytest.mark.cuda
def test_refine_and_session_equal_with_the_plain_table_on_card(card, monkeypatch):
    """PoseRefiner.refine against the kernel's table and against the plain
    version's table of the same frame give equal outputs; so do the steps of
    a TrackingSession with its scenes built by the kernel and by the plain
    version (patched in: no kernel launches then)."""
    m, frame, hyps = _bench_like_case(card, n=24)
    crit = ptt.ICPConvergenceCriteria(max_iteration=20)
    ref = ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda")
    ref.set_scene_depth(frame.cpu().numpy())
    got = ref.refine(hyps, crit)
    kernel_scene = ref.scene
    ref.scene = SceneProjective(table=SP._build_projective_table_plain(frame, kernel_scene.K),
                                K=kernel_scene.K, max_dist_diff=kernel_scene.max_dist_diff,
                                height=kernel_scene.height, width=kernel_scene.width)
    want = ref.refine(hyps, crit)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert (a is None and b is None) or torch.equal(a, b)

    def session_steps():
        session = ptt.TrackingSession(ref, hyps[0], n_hypotheses=8, seed=3)
        steps = [session.step(frame) for _ in range(3)]
        return [np.asarray(x) for s in steps
                for x in (s.pose, s.refined, s.covariance, s.results.fitness)]

    kernel_steps = session_steps()
    monkeypatch.setattr(SP, "_build_projective_table", SP._build_projective_table_plain)
    before = ST.launches
    plain_steps = session_steps()
    assert ST.launches == before
    for a, b in zip(kernel_steps, plain_steps):
        assert np.array_equal(a, b)


def _graph_refiner(card, scene, frame, m, **kw):
    """The benchmark cells' refiner (half-resolution renders, 4 mm
    decimation, window 128, stride 2, 2,048 points) on ``frame``."""
    return ptt.PoseRefiner(m, K=geometry.LINEMOD_K, device="cuda", scene=scene, render_scale=2,
                           decimate_mm=4.0, window=128, stride=2, max_points=2048,
                           scene_voxel_mm=0.0 if scene == "projective" else 2.0,
                           **kw).set_scene_depth(frame)


def _graph_batches(card, k, n=256):
    """The mesh, its frame and ``k`` batches of ``n`` hypotheses about it."""
    m, frame, _ = _bench_like_case(card, n=1)
    batches = [_bench_like_case(card, n=n, seed=10 + i)[2] for i in range(k)]
    return m, frame, batches


def _same_refine(got, want):
    """(refined, RegistrationResult) pairs equal bit for bit, every field."""
    return same_bits(got[0], want[0]) and all(
        a is None and b is None or same_bits(a, b) for a, b in zip(got[1], want[1]))


def _eager(ref, hyps, crit):
    """The eager refine of ``hyps``: a refine against the refiner's scene
    handed in as ``_scene``, which no graph slot serves."""
    return ref.refine(hyps, crit, _scene=ref.scene)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["nn", "nn_bruteforce", "projective"])
def test_graph_replay_equals_eager_refine_on_card(card, scene):
    """Six batches of 256 hypotheses at 2,048 points and 24 iterations: the
    first refine runs eagerly, the second captures the refine as a CUDA
    graph, the four after it replay it; each result (refined, T, fitness,
    rmse, n_points) equals the eager refine of its batch bit for bit, and
    the results returned earlier are unchanged by the later replays."""
    from pose_refine_tpu_torch import pipeline

    m, frame, batches = _graph_batches(card, 6)
    ref = _graph_refiner(card, scene, frame, m)
    crit = ptt.ICPConvergenceCriteria(max_iteration=24)
    before = (pipeline.graph_captures, pipeline.graph_replays)
    kept = []
    for b in batches:
        got = ref.refine(b, crit)
        assert _same_refine(got, _eager(ref, b, crit))
        kept.append((got, (got[0].clone(), [t.clone() for t in got[1]])))
    assert (pipeline.graph_captures - before[0], pipeline.graph_replays - before[1]) == (1, 4)
    assert ref._graph.graph is not None
    for got, copy in kept:
        assert _same_refine(got, (copy[0], copy[1]))
    packed = ref._graph.packed.untyped_storage().data_ptr()
    for got, _copy in kept[1:]:
        assert all(t.untyped_storage().data_ptr() != packed for t in (got[0], *got[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["scene", "roi", "N", "criteria"])
def test_graph_miss_refines_as_a_fresh_refiner_on_card(card, change):
    """After a graph stands, a refine with another scene, ROI, batch size
    or criteria misses: it runs eagerly (no replay, the graph dropped) and
    equals a fresh refiner's refine bit for bit."""
    from pose_refine_tpu_torch import pipeline

    m, frame, batches = _graph_batches(card, 4)
    ref = _graph_refiner(card, "nn", frame, m)
    crit = ptt.ICPConvergenceCriteria(max_iteration=24)
    for b in batches[:3]:
        ref.refine(b, crit)
    assert ref._graph.graph is not None
    hyps, other = batches[3], crit
    fresh_frame = frame
    if change == "scene":
        fresh_frame = torch.roll(frame, 6, dims=1)
        ref.set_scene_depth(fresh_frame)
    elif change == "N":
        hyps = hyps[:200]
    elif change == "criteria":
        other = ptt.ICPConvergenceCriteria(max_iteration=16)
    fresh = _graph_refiner(card, "nn", fresh_frame, m)
    if change == "roi":
        x, y, w, h = ref.roi
        ref.roi = fresh.roi = (max(x - 8, 0), y, w, h)
        assert ref.roi != (x, y, w, h)
    replays = pipeline.graph_replays
    got = ref.refine(hyps, other)
    assert pipeline.graph_replays == replays and ref._graph.graph is None
    assert _same_refine(got, fresh.refine(hyps, other))


@pytest.mark.cuda
def test_graph_replay_through_refine_async_on_card(card):
    """refine_async through replays, then one fence: every batch's result
    equals its eager refine bit for bit, the earlier PendingResults intact
    after the later replays."""
    from pose_refine_tpu_torch import pipeline

    m, frame, batches = _graph_batches(card, 6)
    ref = _graph_refiner(card, "nn", frame, m)
    crit = ptt.ICPConvergenceCriteria(max_iteration=24)
    replays = pipeline.graph_replays
    out = ptt.fence(*[ref.refine_async(b, crit) for b in batches])
    assert pipeline.graph_replays - replays == 4
    for b, got in zip(batches, out):
        assert _same_refine(got, _eager(ref, b, crit))


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["nn", "nn_bruteforce", "projective"])
def test_graph_replay_counts_the_eager_launches_on_card(card, scene):
    """A replay advances every launch counter (rasterize_cuda, lift_cuda,
    icp_reduce.iterate_launches, nn_kdtree / nn_flash) by exactly what the
    eager refine advances them by, and so does the capture's refine."""
    from pose_refine_tpu_torch.utils import profiling

    m, frame, batches = _graph_batches(card, 4)
    ref = _graph_refiner(card, scene, frame, m)
    crit = ptt.ICPConvergenceCriteria(max_iteration=24)

    def launched(fn):
        before = profiling.counters()
        fn()
        after = profiling.counters()
        return {k: v - before[k] for k, v in after.items()
                if v != before[k] and not k.startswith("pipeline.")}

    eager = launched(lambda: _eager(ref, batches[0], crit))
    if scene == "nn":
        assert eager == {"rasterize_cuda.launches": 1, "lift_cuda.launches": 1,
                         "icp_reduce.iterate_launches": 25, "nn_kdtree.launches": 25}
    for b in batches:  # eager, capture, replay, replay
        assert launched(lambda: ref.refine(b, crit)) == eager


@pytest.mark.cuda
def test_graph_cascade_replays_both_scenes_on_card(card):
    """scene_cascade: the coarse twin's refine and the scene's each keep a
    graph; from the third refine on both replay, and every result equals a
    fresh refiner's (eager) refine of its batch bit for bit."""
    from pose_refine_tpu_torch import pipeline

    m, frame, batches = _graph_batches(card, 5)
    kw = dict(scene_cascade=(6.0, 8))
    ref = _graph_refiner(card, "nn", frame, m, **kw)
    crit = ptt.ICPConvergenceCriteria(max_iteration=24)
    replays = pipeline.graph_replays
    for b in batches:
        got = ref.refine(b, crit)
        assert _same_refine(got, _graph_refiner(card, "nn", frame, m, **kw).refine(b, crit))
    assert pipeline.graph_replays - replays == 2 * 3
