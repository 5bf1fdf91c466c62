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
from pose_refine_tpu_torch.ops import rasterize_cuda as RC

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
    """The wrapper launches the kernel or raises; it never computes on the
    CPU itself."""
    coef = torch.zeros((1, 16, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        RC.raster_coef_cuda(coef, 8, 8, 8, (0, 0, 0, 0))


def test_build_without_nvcc_raises(no_card):
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_kernels()


def test_build_key_covers_sources_and_flags():
    key = _build.build_info_key()
    assert len(key) == 16 and key == _build.build_info_key()
    assert [p.name for p in _build._sources()] == ["rasterize.cu"]


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
