"""Probe: the ICP iteration kernel's pose tail alone, and its residency,
of ``csrc/icp_reduce.cu`` (or of another revision of that source with the
same C interface).

    python -m pose_refine_tpu_torch.probes.icp_tail [--source FILE] [--poses N ...]

``probes/icp_tail.cu`` is compiled in one unit after the kernel source, so
it runs the source's own tail functions and asks the CUDA runtime about the
source's own instantiations. ``tail_ms`` times the tail of N poses, one CTA
of one warp a pose, as the kernel's rank-0 CTA runs it (the warp, or
thread 0 in a source of before the warp-wide tail); ``residency`` gives
registers, local (spilled) bytes a thread, CTAs an SM and threads a CTA of
one instantiation, and ``waves`` what a grid of so many CTAs makes of them.
The main path does not run the probe; chip_smoke.py's ``[icp-iterate]``
and compare_icp.py print what it measures. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import math
import re
import subprocess
from pathlib import Path

import torch

PROBE = Path(__file__).resolve().parent / "icp_tail.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "prt_probe_tail": ((_P, _P, _I, _I, _I, _P, _P), _I),
    "prt_probe_residency": ((_I, _I, _I, _I, _P), _I),
}


def build(source=None) -> ctypes.CDLL:
    """The probe compiled after ``source`` (default: this checkout's
    csrc/icp_reduce.cu) with the kernel library's nvcc flags, into the
    git-ignored build directory; loaded with its C signatures."""
    from pose_refine_tpu_torch import _build

    source = Path(source or _build.CSRC_DIR / "icp_reduce.cu").resolve()
    text = source.read_text()
    # what the source's signatures are: a tail that takes the lane's sum
    # (run by a warp), kernels that take their thread count
    signs = (("PRT_PROBE_WARP_TAIL", r"iteration_tail\(float sk"),
             ("PRT_PROBE_THREADS_TEMPLATE", r"template <int kThreads, bool kProj"))
    defines = "".join(f"#define {name}\n" for name, sign in signs if re.search(sign, text))
    unit = f'#include "{source}"\n{defines}#include "{PROBE}"\n'
    key = hashlib.sha256((unit + text + PROBE.read_text()
                          + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    out_dir = _build.BUILD_ROOT / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libicp_tail_{key}.so"
    if not lib.exists():
        cu = out_dir / f"icp_tail_{key}.cu"
        cu.write_text(unit)
        tmp = out_dir / f".libicp_tail_{key}.tmp"
        run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent),
                              "-shared", "-o", str(tmp), str(cu)], capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed on the probe of {source}:\n{run.stdout}{run.stderr}")
        tmp.replace(lib)
    dll = ctypes.CDLL(str(lib))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = argtypes, restype
    return dll


def residency(lib, idx_bytes: int = 0, p2p: bool = False, threads: int = 256,
              smem_bytes: int = 0) -> dict:
    """Registers and local bytes a thread, CTAs an SM at ``smem_bytes`` of
    dynamic shared memory, static shared bytes and threads a CTA of the
    iteration kernel, projective front end (``idx_bytes`` 0) or indexed (4 /
    8), plane or point-to-point terms, at ``threads`` a CTA (a source of one
    thread count has only its own)."""
    out = (ctypes.c_int * 5)()
    err = lib.prt_probe_residency(int(idx_bytes), int(p2p), int(threads), int(smem_bytes), out)
    if err:
        raise RuntimeError(f"prt_probe_residency failed: CUDA error {err}")
    return dict(registers=out[0], local_bytes=out[1], ctas_per_sm=out[2], static_smem=out[3],
                threads=out[4])


def waves(ctas: int, ctas_per_sm: int, sms: int) -> int:
    """Waves a grid of ``ctas`` CTAs takes at ``ctas_per_sm`` on ``sms``
    SMs (0 when a CTA cannot be resident)."""
    return math.ceil(ctas / (ctas_per_sm * sms)) if ctas_per_sm else 0


def run_tail(lib, sums, state, reps: int, coarse: bool = False):
    """(n, 32) [step (13) | state (19)] after ``reps`` tails of each pose
    (sums (n, 29), state (n, 19) float32 CUDA tensors), on the current
    stream."""
    sums, state = sums.contiguous(), state.contiguous()
    out = torch.empty((sums.shape[0], 32), dtype=torch.float32, device=sums.device)
    err = lib.prt_probe_tail(sums.data_ptr(), state.data_ptr(), sums.shape[0], int(reps),
                             int(coarse), out.data_ptr(),
                             torch.cuda.current_stream(sums.device).cuda_stream)
    if err:
        raise RuntimeError(f"prt_probe_tail failed: CUDA error {err}")
    return out


def tail_ms(lib, sums, state, coarse: bool = False, reps=(8, 72), rounds: int = 7) -> float:
    """ms of one tail of every pose at once (n poses, n CTAs): the
    difference of two launches of reps[1] and reps[0] repetitions over
    their difference (the launch's own cost cancels), by CUDA events,
    median of ``rounds``."""
    ts = []
    for _ in range(rounds + 1):
        span = []
        for r in reps:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run_tail(lib, sums, state, r, coarse)
            b.record()
            torch.cuda.synchronize()
            span.append(a.elapsed_time(b))
        ts.append((span[1] - span[0]) / (reps[1] - reps[0]))
    return float(sorted(ts[1:])[len(ts[1:]) // 2])


def start_state(n: int, device) -> torch.Tensor:
    """(n, 19): T the identity, fitness, rmse and done 0."""
    state = torch.zeros((n, 19), dtype=torch.float32, device=device)
    state[:, :16] = torch.eye(4, device=device).reshape(16)
    return state


def random_sums(n: int, device, points: int = 2048, seed: int = 0) -> torch.Tensor:
    """(n, 29) sums of ``points`` random plane terms a pose (a cloud at
    0.3 m, residuals of a few mm), every pose with inliers."""
    from pose_refine_tpu_torch.ops import icp_reduce as IR

    g = torch.Generator(device="cpu").manual_seed(seed)
    cloud = torch.randn((n, points, 3), generator=g) * torch.tensor([0.04, 0.03, 0.02])
    cloud[..., 2] += 0.3
    nrm = torch.nn.functional.normalize(torch.randn((n, points, 3), generator=g), dim=-1)
    dst = cloud + torch.randn((n, points, 3), generator=g) * 0.003
    ok = torch.ones((n, points), dtype=torch.bool)
    return IR.packed_terms(cloud, ok, dst, nrm, ok).sum(dim=-2).to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=None, help="an icp_reduce.cu (default: this checkout's)")
    ap.add_argument("--poses", type=int, nargs="+", default=[16, 256, 512])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("icp_tail: needs a CUDA card")
        return 2
    dev = torch.device("cuda")
    lib = build(args.source)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in args.poses:
        sums, state = random_sums(n, dev), start_state(n, dev)
        print(f"[icp-tail] {n} poses: tail_ms={tail_ms(lib, sums, state)} "
              f"coarse_tail_ms={tail_ms(lib, sums, state, coarse=True)}")
    from pose_refine_tpu_torch.ops import icp_reduce as IR

    for n in (256, 512):
        slabs, threads = IR.geometry(n, 2048)
        res = residency(lib, threads=threads, smem_bytes=24576)
        print(f"[icp-tail] iteration kernel, projective, {n} x 2,048: {res}, {sms} SMs, "
              f"{waves(n * slabs, res['ctas_per_sm'], sms)} wave(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
