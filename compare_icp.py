#!/usr/bin/env python3
"""Time other revisions or variants of csrc/icp_reduce.cu against this
checkout's, on one CUDA card, at the ICP iteration kernel's shapes, and say
where an iteration's time goes.

    git show <rev>:pose_refine_tpu_torch/csrc/icp_reduce.cu > _local/parent/icp_reduce.cu
    python3 compare_icp.py [OTHER[@THREADS] ...] [--shape NAME ...] [--rounds N]

Each OTHER (an icp_reduce.cu) is built alone with this checkout's nvcc
flags into its own library under the git-ignored ``_build/``, beside
probes/icp_tail.cu compiled after it. The launches go through this
checkout's launcher (``ops/icp_reduce.py``, its ``geometry``) with the
build's library. Two C interfaces are understood: this checkout's, which
takes the threads a CTA beside the slabs, and the one of before (one thread
count, no such argument), called without it. ``@THREADS`` makes a build of
this interface launch every shape with that many threads a CTA (and so in
that order) in place of geometry's choice.

The shapes: ``slice`` (the bench refine's whole projective loop, 256 poses
x 2,048 points, 24 iterations and the scoring pass), ``fine512`` (the same
at 512 poses: the serving ceiling's fine launch), ``track`` (a tracked
projective frame, 16 x 2,048, 30 iterations, 8-CTA clusters), ``coarse``
(the serving ceiling's coarse launch, 512 x 512 strided rows, 16
iterations and the hand-off of 512 x 2,048) and ``indexed`` (one
iteration at 256 x 2,048 on B3's output against the 2 mm NN scene). The
inputs are chip_smoke.py's, from its helpers and seeds.

For every build and shape it prints the iteration kernel's registers,
local bytes, CTAs an SM and waves (probes/icp_tail.py), and whether its
outputs equal this checkout's bit for bit (this checkout's are also held
to their plain version). The split of this shape's time: the launch alone
(chip_smoke.alone_ms), the iterations until the last pose is done (from the
plain version), and the tail alone at as many poses (the probe, one CTA a
pose); the rest of an iteration is its pass and its frame (merges,
barriers, the move, the latch's exits). Then rounds of the launch alone in
turns (other, this, this, other for every OTHER), each build's median, min
and max, and this / other. Imports no JAX.
"""

import argparse
import concurrent.futures
import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = ("slice", "fine512", "track", "coarse", "indexed")


def build_lib(src: str):
    """``src`` alone, with this checkout's flags, as a library with the
    iteration's C signature: (library, takes_threads)."""
    from pose_refine_tpu_torch import _build

    key = hashlib.sha256(open(src, "rb").read()).hexdigest()[:12]
    out_dir = _build.BUILD_ROOT / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libicp_{key}.so"
    if not lib.exists():
        tmp = out_dir / f".libicp_{key}.{os.getpid()}.tmp"
        run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(tmp), src],
                             capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{run.stdout}{run.stderr}")
        tmp.replace(lib)
    dll = ctypes.CDLL(str(lib))
    takes_threads = b"int slabs, int threads" in open(src, "rb").read()
    fn = dll.prt_icp_iterate
    argtypes, fn.restype = _build.SIGNATURES["prt_icp_iterate"]
    # the interface of before has no threads argument after the slabs
    fn.argtypes = argtypes if takes_threads else argtypes[:7] + argtypes[8:]
    return dll, takes_threads


class _Without:
    """A library of the interface of before, called with this checkout's
    argument lists: the threads argument (index 7) is dropped."""

    def __init__(self, lib):
        self.lib = lib

    def prt_icp_iterate(self, *args):
        return self.lib.prt_icp_iterate(*args[:7], *args[8:])


def make_shapes(torch, wanted):
    """{name: shape dict}: n, p, iters (launch iterations), coarse, the
    inputs (state0, valid, n_total, crit, front keywords, nearest), handoff
    points."""
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import geometry, icp, mesh
    from pose_refine_tpu_torch.ops import icp_reduce as IR
    from pose_refine_tpu_torch.ops import rasterize_cuda as RC
    from pose_refine_tpu_torch.pipeline import refine_poses
    from pose_refine_tpu_torch.scene import nn_flash as NF
    from pose_refine_tpu_torch.scene.projective import SceneProjective

    dev = torch.device("cuda")
    model, tris_np, truth, poses_np = CS.workload(geometry, mesh)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, CS.WIDTH, CS.HEIGHT, device=dev)

    def render(p):
        return RC.rasterize(torch.as_tensor(tris_np, device=dev), torch.as_tensor(p, device=dev),
                            CS.WIDTH, CS.HEIGHT, proj)

    scene = render(truth[None])[0].cpu().numpy()
    poses = torch.as_tensor(poses_np, device=dev)
    crit = ptt.ICPConvergenceCriteria(max_iteration=CS.ITERS)
    out = {}

    def proj_front(s):
        return dict(table=s.table, K=s.K, gate=s.max_dist_diff, height=s.height, width=s.width)

    def add(name, cloud, valid, crit_s, front, plain_query, iters, coarse=0, nearest=None):
        state0, valid, n_total = icp._icp_start(cloud, valid)
        out[name] = dict(state0=state0, valid=valid, n_total=n_total, crit=crit_s, front=front,
                         plain_query=plain_query, iters=iters, coarse=coarse, nearest=nearest,
                         n=cloud.shape[0], p=cloud.shape[1])

    if {"slice", "fine512", "coarse"} & set(wanted):
        ref = ptt.PoseRefiner(model, K=K, device="cuda", **CS.CFG)
        ref.set_scene_depth(scene)
        sc = ref.scene
        plain = functools.partial(sc.query, plain=True)
        if "slice" in wanted:
            cl, va = CS.first_pass_clouds(ptt, refine_poses, ref, sc, poses)
            add("slice", cl, va, crit, proj_front(sc), plain, CS.ITERS + 1)
        poses512 = torch.cat([poses, poses])
        if {"fine512", "coarse"} & set(wanted):
            cl, va = CS.first_pass_clouds(ptt, refine_poses, ref, sc, poses512)
            if "fine512" in wanted:
                add("fine512", cl, va, crit, proj_front(sc), plain, CS.ITERS + 1)
            if "coarse" in wanted:
                add("coarse", cl, va, crit, proj_front(sc), plain, CS.COARSE[0],
                    coarse=CS.COARSE[1])
    if "track" in wanted:
        tref = ptt.PoseRefiner(model, K=K, device="cuda", **dict(CS.TRACK_CONFIGS)["projective"],
                               **CS.CFG)
        _truths, frames = CS.track_frames(geometry, render, truth)
        hyps = CS.first_hypotheses(ptt, truth)
        tref.track(frames[0], hyps)  # plans the ROI
        ts = SceneProjective.from_depth(torch.as_tensor(frames[0], device=dev), tref._K_t,
                                        tref.max_dist_diff, device=dev)
        cl, va = CS.first_pass_clouds(ptt, refine_poses, tref, ts,
                                      torch.as_tensor(hyps, device=dev))
        tcrit = ptt.ICPConvergenceCriteria()
        add("track", cl, va, tcrit, proj_front(ts), functools.partial(ts.query, plain=True),
            tcrit.max_iteration + 1)
    if "indexed" in wanted:
        from pose_refine_tpu_torch.scene.nn import _rows_in_gate

        nref = ptt.PoseRefiner(model, K=K, device="cuda", scene="nn_bruteforce",
                               scene_voxel_mm=2.0, **CS.CFG)
        nref.set_scene_depth(scene)
        s = nref.scene
        cl, va = CS.first_pass_clouds(ptt, refine_poses, nref, s, poses)
        idx, dist_sq = s._nearest(icp._icp_start(cl, va)[0].cloud)
        add("indexed", cl, va, crit, dict(table=s.table, idx=idx, dist_sq=dist_sq,
                                           gate_sq=NF.gate_sq(s.max_dist_diff)),
            lambda c: _rows_in_gate(s.table, idx, dist_sq, s.max_dist_diff, plain=True), 1,
            nearest=(idx, dist_sq))
    return {name: out[name] for name in wanted}


def plain_run(IR, sh):
    """This checkout's plain version of the shape's launch: (final state,
    iterations until the last pose is done, pose-iterations, and for the
    coarse launch the moved strided copy, else None)."""
    st, valid = IR.ICPState(*(t.clone() for t in sh["state0"])), sh["valid"]
    if sh["coarse"]:
        cst, cvalid = IR.coarse_start(st, valid, sh["coarse"])
        cl, T = IR.icp_coarse_plain(cst.cloud, st.T, cvalid, sh["plain_query"], sh["iters"])
        return st._replace(cloud=IR.handoff_plain(T, st.cloud), T=T), sh["iters"], \
            sh["iters"] * sh["n"], cl
    crit, last, active = sh["crit"], 0, 0
    for it in range(sh["iters"]):
        n_active = int((~st.done).sum())
        if n_active:
            last, active = it + 1, active + n_active
        st = IR.icp_iterate_plain(st, valid, sh["n_total"], sh["plain_query"], it,
                                  crit.max_iteration, crit.relative_fitness, crit.relative_rmse)
    return st, last, active, None


class Build:
    """One source: its kernel library, its probe and its geometry."""

    def __init__(self, name, src, libs, threads=None):
        from pose_refine_tpu_torch.ops import icp_reduce as IR

        self.name, self.src = name, src
        (lib, takes_threads), self.probe = libs
        self.lib = lib if takes_threads else _Without(lib)

        def geometry(n, p):
            slabs, t = IR.geometry(n, p)
            return slabs, int(threads or t)
        self.geometry = geometry

    def launcher(self, IR, sh):
        """A bound launcher of the shape on a fresh state, and its run."""
        st = IR.ICPState(*(t.clone() for t in sh["state0"]))
        valid = sh["valid"]
        kw = dict(sh["front"])
        handoff = None
        if sh["coarse"]:
            full = st.cloud
            st, valid = IR.coarse_start(st, valid, sh["coarse"])
            kw.update(coarse=True, handoff=full)
            handoff = full
        run = IR._IterateLaunch(st, valid, sh["n_total"], sh["crit"], **kw)
        run.lib = self.lib
        run.args[6], run.args[7] = self.geometry(sh["n"], run.args[3])
        if sh["nearest"] is not None:
            return run, lambda: run(0, 1, *sh["nearest"])
        if sh["coarse"]:
            return run, lambda: (run(0, sh["iters"], handoff=True), handoff)
        return run, lambda: run(0, sh["iters"])


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="*", help="other icp_reduce.cu sources [@THREADS]")
    ap.add_argument("--shape", nargs="+", choices=SHAPES, default=list(SHAPES))
    ap.add_argument("--rounds", type=int, default=3, help="ABBA groups of rounds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_icp: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from pose_refine_tpu_torch import _build
    from pose_refine_tpu_torch.ops import icp_reduce as IR
    from pose_refine_tpu_torch.probes import icp_tail

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[compare] card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    _build.load_kernels()
    specs = [("this", str(_build.CSRC_DIR / "icp_reduce.cu"), None)]
    for i, spec in enumerate(args.other):
        path, _, threads = spec.partition("@")
        specs.append((f"other{i}" if len(args.other) > 1 else "other", path, threads or None))
    # each distinct source once: its library and its probe, all nvcc runs at once
    sources = {}
    for _name, path, *_geo in specs:
        sources.setdefault(open(path, "rb").read(), path)
    with concurrent.futures.ThreadPoolExecutor(2 * len(sources)) as ex:
        jobs = {text: (ex.submit(build_lib, path), ex.submit(icp_tail.build, path))
                for text, path in sources.items()}
        libs = {text: (lib.result(), probe.result()) for text, (lib, probe) in jobs.items()}
    builds = [Build(name, path, libs[open(path, "rb").read()], *geo)
              for name, path, *geo in specs]
    for b in builds:
        print(f"[compare] {b.name} = {b.src}", flush=True)
    print(f"[compare] built in {time.perf_counter() - t0:.1f} s", flush=True)
    shapes = make_shapes(torch, args.shape)
    same_all = True
    for name, sh in shapes.items():
        n, p = sh["n"], sh["p"]
        p_state, last, active, p_coarse_cloud = plain_run(IR, sh)
        # the bits of every build against this one, and this one against its
        # plain version
        results = {}
        for b in builds:
            run, go = b.launcher(IR, sh)
            got = go()
            torch.cuda.synchronize()
            results[b.name] = (run.state, got[1] if sh["coarse"] else None)
        this_state, this_full = results["this"]
        if sh["coarse"]:
            plain_ok = (CS.same_bits(this_full, p_state.cloud)
                        and CS.same_bits(this_state.T, p_state.T)
                        and CS.same_bits(this_state.cloud, p_coarse_cloud))
        else:
            plain_ok = all(CS.same_bits(a, c) for a, c in zip(this_state, p_state))
        same_all &= plain_ok
        print(f"[{name}] {n} poses x {p} points, {sh['iters']} iteration(s) a launch"
              f"{' (coarse, stride %d, + hand-off)' % sh['coarse'] if sh['coarse'] else ''}: "
              f"the last pose done after {last}, {active} pose-iterations; this equals its plain "
              f"version bit for bit: {plain_ok}", flush=True)
        idx_bytes = 0 if sh["nearest"] is None else sh["nearest"][0].element_size()
        # the tail's input: the first pass's sums of the launch's own cloud
        run, _go = builds[0].launcher(IR, sh)
        sums = IR.assoc_reduce_plain(run.state.cloud, run._keep[0], sh["plain_query"])
        for b in builds:
            st, full = results[b.name]
            eq = all(CS.same_bits(a, c) for a, c in zip(st, this_state))
            if sh["coarse"]:
                eq = eq and CS.same_bits(full, this_full)
            rows = p if not sh["coarse"] else -(-p // sh["coarse"])
            slabs, threads = b.geometry(n, rows)
            slab_bytes = 12 * -(-rows // slabs)
            smem = slab_bytes if sh["iters"] > 1 and slab_bytes <= 200 * 1024 else 0
            res = icp_tail.residency(b.probe, idx_bytes, False, threads, smem)
            state19 = icp_tail.start_state(n, dev)
            tail = icp_tail.tail_ms(b.probe, sums, state19, coarse=bool(sh["coarse"]))
            pool = iter([b.launcher(IR, sh)[1] for _ in range(45)])
            alone = CS.alone_ms(torch, lambda: next(pool)(), launches=10, rounds=3)
            iters = last if not sh["coarse"] else sh["iters"]
            per_it = alone / max(iters, 1)
            print(f"[{name}] {b.name}: equals_this={eq} slabs={slabs} registers="
                  f"{res['registers']} local_bytes={res['local_bytes']} threads={res['threads']} "
                  f"ctas_per_sm={res['ctas_per_sm']} (dynamic smem {smem}) waves="
                  f"{icp_tail.waves(n * slabs, res['ctas_per_sm'], sms)} | alone_ms={alone} "
                  f"per_iteration_ms={per_it} tail_alone_ms={tail} "
                  f"pass_and_frame_ms={per_it - tail}", flush=True)
        times = {b.name: [] for b in builds}
        order = [b for b in builds if b.name != "this"]
        this = builds[0]
        for r in range(args.rounds):
            for b in order + [this, this] + order[::-1]:
                pool = iter([b.launcher(IR, sh)[1] for _ in range(45)])
                times[b.name].append(CS.alone_ms(torch, lambda: next(pool)(), launches=10,
                                                 rounds=3))
        med = {k: float(np.median(v)) for k, v in times.items()}
        for k, v in times.items():
            print(f"[{name}] {k}: median_ms={med[k]} min_ms={min(v)} max_ms={max(v)} "
                  f"rounds={len(v)} this/{k}={med['this'] / med[k]}", flush=True)
    print(f"[compare] seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
