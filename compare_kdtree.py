#!/usr/bin/env python3
"""Time another revision's csrc/nn_kdtree.cu against this checkout's, on one
CUDA card, at the kd traversal's four shapes.

    git show <rev>:pose_refine_tpu_torch/csrc/nn_kdtree.cu > _local/parent/nn_kdtree.cu
    python3 compare_kdtree.py [OTHER ...] [--shape NAME ...] [--rounds N] [--tail]

Each OTHER (default _local/parent/nn_kdtree.cu) is built alone with this
checkout's nvcc flags into its own library under the git-ignored
``_build/``. Two interfaces are understood:

  * the one-thread-a-query kernel of before the redesign, ``prt_nn_kdtree(
    queries, nq, nodes, boxes, points, max_steps, idx, dist, steps,
    stream)`` with 32-byte node records ([child0, child1, parent,
    split_dim, split_v, left, right, 0]), packed here from the tree's field
    views;
  * this checkout's interface (the 16-byte table of
    scene/kdtree.py::KDTreeDevice, the tile counters): a variant of the
    current kernel, e.g. an edited copy under ``_local/``.

The shapes are chip_smoke.py's (``kd_shapes``): the 524,288 queries of the
bench NN refine's first pass and of a late pass (at the refined poses),
against the 2 mm voxel cloud and the raw cloud: 2mm-first, 2mm-late,
raw-first, raw-late (default: all). Rounds alternate other, this, this,
other; a round is one kernel-alone time (chip_smoke.alone_ms: 20 launches
between one pair of CUDA events behind a busy card), the others in turn.
Prints
every round, then each build's median, min and max, the warp efficiency of
the walk (sum of steps over 32 x the sum of each 32-query warp's longest
walk, from the kernel's step counts, which equal the plain version's) and
this / each other; exits 1 if any build's idx, dist^2 or steps differ from this
kernel's at any shape.

``--tail`` instead times each walk: a copy of every build's source that
writes each query's start and end (``%globaltimer``) in place of its idx
and dist^2 is built and run once a shape, and the line prints when 90% and
99% of the walks had ended, the launch's span, the median walk, and the
five longest walks' steps, start and duration: how much of a launch is
its longest walks.
"""

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PARENT = os.path.join(REPO, "_local", "parent", "nn_kdtree.cu")
# the interface of before the 16-byte table
_P, _I = ctypes.c_void_p, ctypes.c_int
NODES_SIGNATURE = ((_P, _I, _P, _P, _P, _I, _P, _P, _P, _P), _I)


# the outputs of a walk in this checkout's source and in the one-thread-a-
# query source of before the 16-byte table, and what
# --tail writes there instead: the walk's duration (ns, as idx), its steps
# (as dist^2's bits) and its start (ns, low 31 bits, as steps)
_TIMER = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"'
_TAIL_START = f"unsigned long long tail_g0; {_TIMER}(tail_g0));"
_TAIL_END = (f"unsigned long long tail_g1; {_TIMER}(tail_g1)); "
             "idx_out[q] = (int)(tail_g1 - tail_g0); dist_out[q] = __int_as_float(steps); "
             "if (steps_out != nullptr) steps_out[q] = (int)(tail_g0 & 0x7fffffffULL);")
_WRITES = ("  idx_out[q] = bi;\n  dist_out[q] = bd;\n"
           "  if (steps_out != nullptr) steps_out[q] = steps;\n")
_TAIL_SITES = (
    ("  const float p0 = __ldg(queries + 3 * q), p1 = __ldg(queries + 3 * q + 1),\n"
     "              p2 = __ldg(queries + 3 * q + 2);\n", _WRITES),
    ("  const float p[3] = {__ldg(queries + 3 * q), __ldg(queries + 3 * q + 1),\n"
     "                      __ldg(queries + 3 * q + 2)};\n", _WRITES),
)


def timed_source(src: str) -> str:
    """A copy of the source at ``src`` whose walks write their timing (see
    _TAIL_END), under the git-ignored _build/compare/."""
    from pose_refine_tpu_torch import _build

    text = open(src).read()
    for start, end in _TAIL_SITES:
        if start in text and end in text:
            text = text.replace(start, start + "  " + _TAIL_START + "\n")
            text = text.replace(end, "  " + _TAIL_END + "\n")
            key = hashlib.sha256(text.encode()).hexdigest()[:12]
            out = _build.BUILD_ROOT / "compare" / f"timed_nn_kdtree_{key}.cu"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(text)
            return str(out)
    raise SystemExit(f"--tail: {src} has no walk this script knows how to time")


def tail_line(torch, name, label, build, q, tree):
    """Run the timed ``build`` once on ``q`` behind a busy card; print when
    the walks ended."""
    dev = q.device
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    start = torch.empty(q.shape[0], dtype=torch.int32, device=dev)
    busy = torch.ones((4096, 4096), device=dev)
    for _ in range(2):
        for _ in range(20):
            busy @ busy
        dur, steps = build(q, tree, start, counters=counters)
    torch.cuda.synchronize()
    dur = dur.double().cpu().numpy()
    steps = steps.view(torch.int32).cpu().numpy()
    start = start.double().cpu().numpy()
    start -= start.min()
    end = start + dur
    longest = [(int(steps[i]), round(start[i] / 1e3, 1), round(dur[i] / 1e3, 1))
               for i in np.argsort(-steps)[:5]]
    print(f"[tail] {name} {label}: span_us={end.max() / 1e3} 90%_ended_us="
          f"{np.percentile(end, 90) / 1e3} 99%_ended_us={np.percentile(end, 99) / 1e3} "
          f"median_walk_us={np.median(dur) / 1e3} longest (steps, start_us, us)={longest} "
          f"ns_a_step_of_the_longest={dur[int(np.argmax(steps))] / steps.max()}", flush=True)


class OtherKD:
    """Another revision's nn_kdtree.cu, built alone; ``(queries, tree,
    steps)`` -> (idx, dist^2) as scene.nn_kdtree.nn_kdtree_cuda, CUDA
    tensors."""

    def __init__(self, src: str):
        from pose_refine_tpu_torch import _build

        text = open(src).read()
        self.nodes_interface = re.search(r"prt_nn_kdtree\s*\([^)]*const void\s*\*\s*nodes",
                                         text) is not None
        out_dir = _build.BUILD_ROOT / "compare"
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / f"libother_kdtree_{hashlib.sha256(text.encode()).hexdigest()[:12]}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), src]
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{run.stdout}{run.stderr}")
        self.ptxas = [ln.strip() for ln in (run.stdout + run.stderr).splitlines()
                      if "registers" in ln or "spill" in ln]
        self.lib = ctypes.CDLL(str(lib))
        sig = NODES_SIGNATURE if self.nodes_interface else _build.SIGNATURES["prt_nn_kdtree"]
        self.lib.prt_nn_kdtree.argtypes, self.lib.prt_nn_kdtree.restype = sig
        self.what = ("one thread a query, 32-byte node records" if self.nodes_interface
                     else "a variant of this interface")
        self._packed = {}

    def packed(self, tree):
        """The old layout of ``tree``: nodes (M, 8) int32 [child0, child1,
        parent, split_dim, split_v bits, left, right, 0], boxes (M, 8),
        points (P, 4), from the field views."""
        import torch

        key = id(tree)
        if key not in self._packed:
            m = tree.n_nodes
            nodes = torch.zeros((m, 8), dtype=torch.int32, device=tree.table.device)
            nodes[:, 0:2] = tree.child
            nodes[:, 2] = tree.parent
            nodes[:, 3] = tree.split_dim
            nodes[:, 4] = tree.split_v.view(torch.int32)
            nodes[:, 5:7] = tree.bounds
            self._packed[key] = (tree, nodes, tree.boxes.contiguous(), tree.points.contiguous())
        return self._packed[key][1:]

    def __call__(self, queries, tree, steps=None, counters=None):
        import torch

        from pose_refine_tpu_torch.scene.nn_kdtree import STAGE_CAP_BYTES

        nq = queries.shape[0]
        idx = torch.empty(nq, dtype=torch.int32, device=queries.device)
        dist = torch.empty(nq, dtype=torch.float32, device=queries.device)
        stream = torch.cuda.current_stream().cuda_stream
        sp = None if steps is None else steps.data_ptr()
        if self.nodes_interface:
            nodes, boxes, points = self.packed(tree)
            err = self.lib.prt_nn_kdtree(queries.data_ptr(), nq, nodes.data_ptr(),
                                         boxes.data_ptr(), points.data_ptr(), tree.max_steps,
                                         idx.data_ptr(), dist.data_ptr(), sp, stream)
        else:
            m = tree.n_nodes
            err = self.lib.prt_nn_kdtree(queries.data_ptr(), nq, tree.table.data_ptr(), m,
                                         tree.table.shape[0] - 3 * m, tree.max_steps,
                                         int(16 * tree.table.shape[0] <= STAGE_CAP_BYTES),
                                         counters.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                                         sp, stream)
        if err:
            raise SystemExit(f"other nn_kdtree.cu: launch failed, CUDA error {err}")
        return idx, dist


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", default=[PARENT],
                    help="other revisions' or variants' nn_kdtree.cu")
    ap.add_argument("--shape", action="append", help="2mm-first, 2mm-late, raw-first or "
                    "raw-late (repeatable; default all)")
    ap.add_argument("--rounds", type=int, default=3, help="ABBA groups of rounds")
    ap.add_argument("--tail", action="store_true", help="time each walk instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kdtree: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    import pose_refine_tpu_torch as ptt
    from pose_refine_tpu_torch import _build, geometry, mesh
    from pose_refine_tpu_torch.scene import nn_kdtree as KD

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[compare] card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    _lib, info = _build.load_kernels()
    this_regs = [ln.strip() for ln in info["log"].splitlines()
                 if "nn_kdtree" in ln and ("registers" in ln or "spill" in ln)]
    print(f"[compare] this: {this_regs}", flush=True)
    if args.tail:
        from pose_refine_tpu_torch import _build as B

        builds = {"this": OtherKD(timed_source(str(B.CSRC_DIR / "nn_kdtree.cu")))}
        builds.update({f"other{i}": OtherKD(timed_source(src))
                       for i, src in enumerate(args.others)})
        shapes = CS.kd_shapes(torch, ptt, geometry, mesh, dev)
        for name in args.shape or list(shapes):
            sc, q = shapes[name]
            for label, build in builds.items():
                tail_line(torch, name, label, build, q, sc.kd)
        return 0
    others = {}
    for i, src in enumerate(args.others):
        name = "other" if len(args.others) == 1 else f"other{i}"
        others[name] = OtherKD(src)
        print(f"[compare] {name}: {src} ({others[name].what}); {others[name].ptxas}", flush=True)
    shapes = CS.kd_shapes(torch, ptt, geometry, mesh, dev)
    names = args.shape or list(shapes)
    same_all = True
    for name in names:
        sc, q = shapes[name]
        tree = sc.kd
        nq = q.shape[0]
        launch = KD.KDLaunch(tree, (nq,), dev)
        counters = torch.zeros(2, dtype=torch.int32, device=dev)
        fns = {k: (lambda o=o: o(q, tree, counters=counters)) for k, o in others.items()}
        fns["this"] = lambda: launch(q)
        outs = {}
        for k in fns:
            st = torch.empty(nq, dtype=torch.int32, device=dev)
            if k in others:
                i, d = others[k](q, tree, st, counters=counters)
            else:
                i, d = launch(q, st)
            outs[k] = (i.clone(), d.clone(), st)
        torch.cuda.synchronize()
        ref = outs["this"]
        same = {k: all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(o, ref)) for k, o in outs.items()}
        same_all &= all(same.values())
        times = {k: [] for k in fns}
        order = [*others, "this"]
        for _r in range(args.rounds):
            for k in (*order, *reversed(order)):
                times[k].append(CS.alone_ms(torch, fns[k], rounds=1))
        med = {k: float(np.median(t)) for k, t in times.items()}
        print(f"[compare] {name}: {sc.points.shape[0]} points, {tree.n_nodes} nodes x {nq} "
              f"queries: outputs_equal={same} steps mean={float(ref[2].double().mean())} "
              f"max={int(ref[2].max())} warp_efficiency={CS.warp_efficiency(ref[2])} "
              f"this={CS.kd_walk(launch)}", flush=True)
        for k, t in times.items():
            print(f"[compare]   {k}: median_ms={med[k]} min_ms={min(t)} max_ms={max(t)} "
                  f"rounds={[round(x, 5) for x in t]}", flush=True)
        for k in others:
            print(f"[compare]   this / {k} = {med['this'] / med[k]}", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
