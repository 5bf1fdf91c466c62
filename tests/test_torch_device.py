"""Device rules of the port: a CUDA request never runs on the CPU, kernel
wrappers refuse what they cannot launch, the package imports without jax,
and (on a machine with a card) the CUDA kernel matches its plain version.

This file imports no jax, so its ``cuda`` tests run on a GPU machine that
has no jax installed:
    python -m pytest --noconftest tests/test_torch_device.py -q -m cuda
"""

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
from pose_refine_tpu_torch.probes import nn_ties
from pose_refine_tpu_torch.scene import nn_flash as NF
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
    assert ptt.resolve_device(None).type == "cpu"
    assert ptt.resolve_device("cpu").type == "cpu"


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
    coef = torch.zeros((1, 16, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        RC.raster_coef_cuda(coef, 8, 8, 8, (0, 0, 0, 0))
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
                                                   "nn_mxu.cu", "rasterize.cu"]


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


def nn_case(card, seed=2, n_scene=20000, n_query=70000):
    """A kd-ordered random scene and clustered queries around it, some
    beyond a 5 mm gate, with a partial last query tile."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n_scene, 3)) * [0.05, 0.05, 0.02] + [0, 0, 0.3]).astype(np.float32)
    scene = SceneNN.from_cloud(pts, pts, 0.005, device=card)
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
@pytest.mark.parametrize("rows,dtype", [(307200, torch.int64), (29440, torch.int32),
                                        (5, torch.int64)])
def test_gather_kernel_matches_plain_on_card(card, rows, dtype):
    """The row gather at the bench association's shapes (a 640x480
    projective table, the raw NN scene; 256 x 2048 indices) and on a tiny
    table with out-of-range indices: a gather rounds nothing, so the kernel
    equals its plain version bit for bit."""
    gen = torch.Generator(device=card).manual_seed(rows)
    table = torch.randn((rows, 8), generator=gen, device=card)
    idx = torch.randint(-3, rows + 3, (256, 2048), generator=gen, device=card).to(dtype)
    before = G.launches
    got = G.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert G.launches == before + 1
    assert got.shape == (256, 2048, 8)
    assert torch.equal(got, G.gather_rows_plain(table, idx))


# the fused pass's float sums against float64 (chip_smoke.py's bar): a
# thread adds at most 16 points in a row before the tree takes over
SUMS_BAR = 2e-6


def reduce_case(card, case):
    """(scene reduce, plain query, clouds (N, P, 3), valid (N, P)) of one
    front end of the fused kernel: a 120x160 depth frame around 0.3 m, and
    clouds around it with points at z = 0, behind the camera, NaN, outside
    the frame, on its border pixels, beyond the gate, and masked rows."""
    rng = np.random.default_rng(11)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    depths = rng.integers(280, 320, (3, 120, 160)).astype(np.int32)
    depths[:, :, :12] = 0
    # 4 CTAs a pose; "slabs": 8 ragged slabs of 625; "one_slab": a full card
    n, p = {"slabs": (3, 5000), "one_slab": (140, 300)}.get(case, (5, 1500))
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
    if case in ("projective", "slabs", "one_slab"):
        sc = SceneProjective.from_depth(depths[0], K, 0.03, device=card)
        return sc.reduce, lambda c: sc.query(c, plain=True), cloud, valid
    if case == "stacked":
        sc = SceneProjectiveStack.from_depths(depths, K, 0.03, device=card)
        return sc.reduce_at(ids), sc.query_at(ids, plain=True), cloud, valid
    # the NN kernels take finite queries, and a far one overflows no float32 square
    cloud = torch.nan_to_num(cloud, nan=0.0, posinf=0.0).clamp(-10.0, 10.0)
    if case == "nn":
        sc = SceneNN.from_depth(depths[0], K, 0.01, device=card)
        return sc.reduce, lambda c: sc.query(c, plain=True), cloud, valid
    clouds = [SceneNN.from_depth(d, K, 0.01, device="cpu").points.numpy() for d in depths]
    sc = SceneNNStack.from_clouds(clouds, clouds, 0.01, device=card)
    return sc.reduce_at(ids), sc.query_at(ids, plain=True), cloud, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["projective", "stacked", "slabs", "one_slab", "nn",
                                  "nn_stacked"])
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
    """One track() per scene kind on the card: the raster, the fused pass,
    the gather (the information pass) and (NN) gated flash-NN kernels
    launch, and the frame through the kernels agrees with the same frame
    through their plain versions (the fused pass's plain version equals the
    kernel bit for bit, so the bounds hold at every hypothesis)."""
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
    before = (RC.launches, G.launches, NF.gated_launches, IR.launches)
    refined, res, unc = ref.track(frame.cpu().numpy(), hyps, with_covariance=True)
    torch.cuda.synchronize()
    after = (RC.launches, G.launches, NF.gated_launches, IR.launches)
    # 30 iterations and the scoring pass through the fused kernel, the
    # information pass through the row gather
    assert after[0] > before[0] and after[1] == before[1] + 1 and after[3] == before[3] + 31
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
    """P1 against its plain version (float64 product) and against B2 on a
    structured cloud: every idx disagreement is a near-tie and every dist^2
    within the band (scene/nn_mxu.py). The band is ~1.2e-7 m^2 in dist^2,
    tens of um in distance at a 1 mm neighbour, so disagreements are a
    fraction of a percent here (75 of 70,001 against the plain version on
    an H100); the count bound only catches a kernel gone astray."""
    rng = np.random.default_rng(6)
    pts = (rng.normal(size=(20000, 3)) * [0.05, 0.05, 0.02] + [0, 0, 0.3]).astype(np.float32)
    pts = pts[np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2]))]
    q = torch.as_tensor((pts[rng.integers(0, 20000, 70001)]
                         + rng.normal(0, 0.003, (70001, 3))).astype(np.float32), device=card)
    table = NM.pack_scene_mxu(pts).to(card)
    before = NM.launches
    ki, kd = NM.nn_flash_mxu(q, table)
    torch.cuda.synchronize()
    assert NM.launches == before + 1 and ki.dtype == torch.int32 and kd.shape == (70001,)
    pi, pd = NM.nn_flash_mxu_plain(q, table)
    n_diff, ties_ok, dist_ok = NM.near_ties(q, pts, ki, kd, pi, pd)
    assert ties_ok and dist_ok and n_diff < 700
    bi, bd = NF.nn_flash_packed(q, NF.pack_scene(pts).to(card))
    n_diff, ties_ok, dist_ok = NM.near_ties(q, pts, ki, kd, bi, bd)
    assert ties_ok and dist_ok and n_diff < 700


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
