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
from pose_refine_tpu_torch.ops import rasterize_cuda as RC
from pose_refine_tpu_torch.probes import nn_ties, raster_edges
from pose_refine_tpu_torch.scene import nn_flash as NF
from pose_refine_tpu_torch.scene import nn_kdtree as KD
from pose_refine_tpu_torch.scene import nn_mxu as NM
from pose_refine_tpu_torch.scene.nn import SceneNN, SceneNNStack
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
    cloud, valid = torch.zeros((2, 4, 3)), torch.ones((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        IR.assoc_reduce_projective_cuda(cloud, valid, torch.zeros((12, 8)), torch.eye(3),
                                        torch.tensor(0.1), 3, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        IR.assoc_reduce_indexed_cuda(cloud, valid, torch.zeros((12, 8)),
                                     torch.zeros((2, 4), dtype=torch.int32),
                                     torch.zeros((2, 4)), 0.01)


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
    assert [p.name for p in _build._sources()] == ["gather.cu", "icp_reduce.cu", "nn_flash.cu",
                                                   "nn_kdtree.cu", "nn_mxu.cu", "rasterize.cu"]


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


# the fused pass's float sums against float64 (chip_smoke.py's bar): a
# thread adds at most 16 points in a row before the tree takes over
SUMS_BAR = 2e-6


def reduce_case(card, case):
    """(scene reduce, plain query, clouds (N, P, 3), valid (N, P)) of one
    front end of the fused kernel: a 120x160 depth frame around 0.3 m, and
    clouds around it with points at z = 0, behind the camera, NaN, outside
    the frame, on its border pixels, beyond the gate, and masked rows."""
    sc, ids, plain_query, cloud, valid = scene_case(card, case)
    return (sc.reduce if ids is None else sc.reduce_at(ids)), plain_query, cloud, valid


def scene_case(card, case):
    """reduce_case's scene, its ids (None for a single scene), plain query,
    clouds and valid; "slabs16" is the tracking shape, 16 poses x 2,048
    points (8-CTA clusters)."""
    rng = np.random.default_rng(11)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    depths = rng.integers(280, 320, (3, 120, 160)).astype(np.int32)
    depths[:, :, :12] = 0
    # 4 CTAs a pose; "slabs": 8 ragged slabs of 625; "one_slab": a full card
    n, p = {"slabs": (3, 5000), "one_slab": (140, 300), "slabs16": (16, 2048)}.get(case,
                                                                                 (5, 1500))
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
    if case in ("projective", "slabs", "one_slab", "slabs16"):
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
@pytest.mark.parametrize("case", ["projective", "stacked", "slabs", "one_slab", "nn",
                                  "nn_stacked", "kd"])
def test_assoc_reduce_kernel_matches_plain_on_card(card, case):
    """The fused association + reduction kernel against its plain version,
    per front end: every sum bit for bit (NaN where the plain version's is
    NaN), so the count (the association) exactly; the 28 float sums within
    SUMS_BAR of their float64 values relative to the sum of their absolute
    terms, two launches bit for bit, one launch counted a call."""
    reduce, plain_query, cloud, valid = reduce_case(card, case)
    before = IR.launches
    got = reduce(cloud, valid)
    again = reduce(cloud, valid)
    torch.cuda.synchronize()
    assert IR.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    plain = IR.assoc_reduce_plain(cloud, valid, plain_query)
    packed = IR.pack_sums(*got)
    assert bool(((packed == plain) | (packed.isnan() & plain.isnan())).all())
    want = IR.unpack_sums(plain)
    assert torch.equal(got[2], want[2]) and 0 < float(got[2].sum())
    assert float(got[2][2]) == 0.0 and not bool(got[0][2].any())
    assert torch.equal(got[0][1:], got[0][1:].transpose(-1, -2))  # pose 0 holds NaN points
    dst, nrm, q_valid = plain_query(cloud)
    count_equal, err = IR.sums_error(IR.pack_sums(*got), cloud, valid, dst, nrm, q_valid)
    assert count_equal and err <= SUMS_BAR
    assert IR.slabs_for(*cloud.shape[:2]) == {"slabs": 8, "one_slab": 1}.get(case, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(0.004, False), (0.0, True), (0.004, True)],
                         ids=["huber", "p2p", "p2p-huber"])
@pytest.mark.parametrize("case", ["projective", "stacked", "slabs", "nn", "kd"])
def test_assoc_reduce_modes_match_plain_on_card(card, case, mode):
    """The fused kernel's Huber and point-to-point modes against their plain
    version, per front end: every sum bit for bit (NaN where the plain
    version's is NaN), the count exactly, the float sums within SUMS_BAR of
    float64; Huber weights change the sums of the plain mode."""
    robust_delta, p2p = mode
    reduce, plain_query, cloud, valid = reduce_case(card, case)
    got = IR.pack_sums(*reduce(cloud, valid, robust_delta=robust_delta, point_to_point=p2p))
    torch.cuda.synchronize()
    plain = IR.assoc_reduce_plain(cloud, valid, plain_query, robust_delta, p2p)
    assert bool(((got == plain) | (got.isnan() & plain.isnan())).all())
    base = IR.pack_sums(*reduce(cloud, valid, point_to_point=p2p))
    assert torch.equal(got[:, 27:].view(torch.int32), base[:, 27:].view(torch.int32))
    if robust_delta:
        assert not torch.equal(got[1, :27], base[1, :27])
    dst, nrm, q_valid = plain_query(cloud)
    count_equal, err = IR.sums_error(got, cloud, valid, dst, nrm, q_valid, robust_delta, p2p)
    assert count_equal and err <= SUMS_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("n_scene", [5, 20000])
def test_nn_kdtree_matches_plain_on_card(card, n_scene):
    """The kd traversal kernel against its plain version: idx, dist^2 and
    the step count bit for bit on every query (clustered queries, scene
    points, NaN and overflowing ones; a single-leaf tree at 5 points), one
    launch counted; the scene query and the fused pass take its output."""
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
        query=icp.plain_association(lambda c: ref.scene.query(c, plain=True)))
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
def test_assoc_reduce_refuses_what_it_cannot_launch_on_card(card):
    cloud = torch.zeros((2, 300, 3), device=card)
    valid = torch.ones((2, 300), dtype=torch.bool, device=card)
    table = torch.zeros((120 * 160, 8), device=card)
    K, gate = torch.eye(3, device=card), torch.tensor(0.1, device=card)
    with pytest.raises(ValueError, match="valid must be torch.bool"):
        IR.assoc_reduce_projective_cuda(cloud, valid.to(torch.uint8), table, K, gate, 120, 160)
    with pytest.raises(ValueError, match="one row offset per pose"):
        IR.assoc_reduce_projective_cuda(cloud, valid, table, K, gate, 120, 160,
                                        base=torch.zeros(3, dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="K must be torch.float32 on cuda"):
        IR.assoc_reduce_projective_cuda(cloud, valid, table, K.cpu(), gate, 120, 160)
    with pytest.raises(ValueError, match="int32 or int64"):
        IR.assoc_reduce_indexed_cuda(cloud, valid, table, torch.zeros((2, 300), device=card),
                                     torch.zeros((2, 300), device=card), 0.01)
    flat = torch.zeros(8 * 64 + 1, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        IR.assoc_reduce_projective_cuda(cloud, valid, flat[1:].view(64, 8), K, gate, 8, 8)


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
    before = (RC.launches, G.launches, NF.gated_launches, IR.launches, IR.iterate_launches)
    refined, res, unc = ref.track(frame.cpu().numpy(), hyps, with_covariance=True)
    torch.cuda.synchronize()
    after = (RC.launches, G.launches, NF.gated_launches, IR.launches, IR.iterate_launches)
    # the ICP loop through the iteration kernel: one launch for the
    # projective scene, one a pass (30 iterations and the scoring pass) for
    # the NN scene; the information pass through the row gather
    assert after[0] > before[0] and after[1] == before[1] + 1 and after[3] == before[3]
    assert after[4] == before[4] + (1 if scene == "projective" else 31)
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
    reduce = sc.reduce if ids is None else sc.reduce_at(ids)
    query = sc.query if ids is None else sc.query_at(ids)
    kw = dict(robust_delta=mode[0], estimation="point_to_point" if mode[1] else "point_to_plane",
              coarse_iters=coarse[0], coarse_stride=coarse[1])

    def wrap(fn):
        if start is None:
            return fn
        return lambda state, *args, **modes: fn(start(state), *args, **modes)

    before = IR.iterate_launches
    k_res, k_cloud = icp._icp_run(cloud, valid, icp.Association(query, reduce, wrap(iterate)),
                                  crit, **kw)
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
                                  "nn_stacked"])
def test_icp_iterate_kernel_matches_plain_on_card(card, case, mode):
    """The iteration kernel against its plain version (icp_loop_plain over
    the scene's plain query), per front end and mode, 12 iterations: T,
    fitness, rmse and the final cloud bit for bit (NaN where the plain
    version's is NaN), including the pose with no valid point (done at
    once, T the identity) and pose 0's points at z = 0, behind the camera,
    overflowing and NaN; one launch a refine against a projective scene,
    one a pass against an NN scene."""
    crit = ptt.ICPConvergenceCriteria(max_iteration=12)
    k_res, k_cloud, p_res, p_cloud, n = iterate_both(card, case, crit, MODES[mode])
    assert_same_icp(k_res, k_cloud, p_res, p_cloud)
    assert n == (13 if case in ("nn", "kd", "nn_stacked") else 1)
    assert torch.equal(k_res.transformation[2], torch.eye(4, device=card))
    assert float(k_res.fitness[2]) == 0.0
    moved = ~torch.isclose(k_res.transformation, torch.eye(4, device=card)).all(dim=(1, 2))
    assert bool(moved[torch.arange(moved.shape[0], device=card) != 2].all())


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["max_iteration_0", "done_at_start", "one_iteration"])
@pytest.mark.parametrize("case", ["projective", "slabs16", "nn"])
def test_icp_iterate_kernel_edges_on_card(card, case, edge):
    """The kernel's latch at the edges, bit for bit against the plain
    version: max_iteration = 0 (the scoring pass alone: scores set, nothing
    moves), a state whose every pose is done at the start (returned as it
    came, scores 0), and one iteration and the scoring pass."""
    crit = ptt.ICPConvergenceCriteria(max_iteration=1 if edge == "one_iteration" else 0)
    start = None
    if edge == "done_at_start":
        crit = ptt.ICPConvergenceCriteria(max_iteration=6)

        def start(state):
            state.done.fill_(True)
            return state

    k_res, k_cloud, p_res, p_cloud, _n = iterate_both(card, case, crit, start=start)
    assert_same_icp(k_res, k_cloud, p_res, p_cloud)
    eye = torch.eye(4, device=card).expand_as(k_res.transformation)
    if edge != "one_iteration":
        assert torch.equal(k_res.transformation, eye)
    if edge == "done_at_start":
        assert not bool(k_res.fitness.any()) and not bool(k_res.inlier_rmse.any())
    elif edge == "max_iteration_0":
        assert float(k_res.fitness.max()) > 0.0


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
                raster=RC.rasterize_plain,
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
        before = (IR.iterate_launches, IR.launches, NF.gated_launches)
        refined, res = ref.refine(hyps, crit)
        torch.cuda.synchronize()
        it, passes, nn = (a - b for a, b in zip(
            (IR.iterate_launches, IR.launches, NF.gated_launches), before))
        assert passes == 0
        assert (it, nn) == ((1, 0) if scene == "projective" else (21, 21))
        p_refined, p_res = refine_poses(
            ref.tris, torch.as_tensor(hyps, device=card), ref.scene, ref.proj,
            ref._K_render_t, width=ref.render_w, height=ref.render_h,
            max_points=ref.max_points, criteria=crit, window=ref.window, stride=ref.stride,
            roi=ref.roi, raster=RC.rasterize_plain,
            query=icp.plain_association(lambda c: ref.scene.query(c, plain=True)))
        assert torch.equal(refined, p_refined) and torch.equal(res.fitness, p_res.fitness)
        assert float(res.fitness.min()) > 0.5


@pytest.mark.cuda
def test_icp_iterate_refuses_what_it_cannot_launch_on_card(card):
    """The iteration kernel's wrapper checks the state as well as the
    pass's arguments: shapes, dtypes and the device of T, the scores, the
    latch and the divisors."""
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
