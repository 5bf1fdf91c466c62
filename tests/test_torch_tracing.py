"""The port's span recorder and counters (utils/profiling.py) on the CPU:
nesting, parents and request ids, threads, the ring's bound, the recorder
off, self times, the spans in a torch.profiler trace on its clock, the
span tree of a refine and of a tracking session with the counters they
advance, and outputs bit for bit equal with the recorder on and off."""

import json
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import pose_refine_tpu_torch as ptt
from pose_refine_tpu_torch.utils import profiling

torch.set_num_threads(2)

PORT = Path(ptt.__file__).parent
W, H = 80, 60
CFG = dict(width=W, height=H, max_points=1024, window=32, stride=1, device="cpu")
CRIT = ptt.ICPConvergenceCriteria(max_iteration=8)
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)


@pytest.fixture(autouse=True)
def recorder_on():
    """Every test starts with the recorder on and an empty ring, and leaves
    it on."""
    was = profiling.tracing(True)
    profiling.clear_spans()
    yield
    profiling.tracing(was)
    profiling.clear_spans()


@pytest.fixture(scope="module")
def scene():
    """(mesh, K, truth pose, int32 depth frame) of a bumpy sphere at 300 mm,
    80x60."""
    m = ptt.make_bumpy_sphere(radius=50.0, subdivisions=1)
    K = ptt.LINEMOD_K.copy()
    K[:2] *= 0.125
    truth = np.eye(4, dtype=np.float32)
    truth[:3, :3] = R_REN
    truth[:3, 3] = (0.0, 0.0, 300.0)
    depth = ptt.PoseRenderer(m, K=K, width=W, height=H, device="cpu").render_depth(truth[None])
    return m, K, truth, depth[0].numpy().astype(np.int32)


def tree(records) -> list:
    """(name, parent, request number from 0 in order of appearance)."""
    ids = {}
    return [(r.name, r.parent, ids.setdefault(r.request, len(ids))) for r in records]


class StepClock:
    """A clock that advances 1 ms a reading."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1_000_000
        return self.t


# ----------------------------------------------------------------- recorder


def test_nesting_parents_and_request_ids():
    with profiling.span("a"):
        with profiling.span("b"):
            with profiling.span("c"):
                pass
        with profiling.span("d"):
            pass
    with profiling.span("e"):
        pass
    recs = profiling.spans()
    assert tree(recs) == [("c", "b", 0), ("b", "a", 0), ("d", "a", 0), ("a", None, 0),
                          ("e", None, 1)]
    assert recs[-1].request > recs[0].request
    assert len({r.thread for r in recs}) == 1
    a, c = recs[3], recs[0]
    assert a.start_ns <= c.start_ns <= c.end_ns <= a.end_ns
    assert profiling.spans("b") == [recs[1]]


def test_two_threads_keep_their_own_stacks():
    """Two threads open a root each and a child inside it while the other's
    root is open: each child's parent is its own thread's root."""
    barrier = threading.Barrier(2)

    def run(tag):
        with profiling.span(f"root.{tag}"):
            barrier.wait()
            with profiling.span(f"child.{tag}"):
                barrier.wait()

    threads = [threading.Thread(target=run, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = {r.name: r for r in profiling.spans()}
    for tag in "xy":
        root, child = recs[f"root.{tag}"], recs[f"child.{tag}"]
        assert root.parent is None and child.parent == root.name
        assert child.request == root.request and child.thread == root.thread
    assert recs["root.x"].request != recs["root.y"].request
    assert recs["root.x"].thread != recs["root.y"].thread


def test_many_threads_lose_no_record():
    """More threads than cores, switching every microsecond: every span is
    recorded once, each root takes its own request id, and each child
    carries its own thread's root."""
    n_threads, n_roots = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run():
            for _ in range(n_roots):
                with profiling.span("root"):
                    with profiling.span("child"):
                        pass

        threads = [threading.Thread(target=run) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = profiling.spans()
    roots = [r for r in recs if r.name == "root"]
    children = [r for r in recs if r.name == "child"]
    assert len(roots) == len(children) == n_threads * n_roots
    assert len({r.request for r in roots}) == len(roots)
    owner = {r.request: r.thread for r in roots}
    assert all(c.parent == "root" and owner[c.request] == c.thread for c in children)


def test_the_ring_keeps_the_last_span_capacity_records():
    n = profiling.SPAN_CAPACITY + 10
    for i in range(n):
        with profiling.span(f"s{i % 3}"):
            pass
    recs = profiling.spans()
    assert len(recs) == profiling.SPAN_CAPACITY
    assert recs[0].request == recs[-1].request - (profiling.SPAN_CAPACITY - 1)
    assert recs[-1].name == f"s{(n - 1) % 3}"
    profiling.clear_spans()
    assert profiling.spans() == []


def test_off_records_nothing_and_returns_the_shared_noop():
    assert profiling.tracing(False) is True
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b and not hasattr(a, "__dict__")
    with a:
        with b:
            pass
    assert profiling.spans() == [] and profiling.span_ms("a") == []
    assert profiling.tracing(True) is False
    assert profiling.span("a") is not profiling.span("a")


def test_span_ms_and_self_time(monkeypatch):
    """On a clock of 1 ms a reading: p (4 readings inside) holds the
    children q (2: 1 ms) and r (which holds s); self time subtracts the
    direct children only."""
    monkeypatch.setattr(profiling, "_clock", StepClock())
    with profiling.span("p"):
        with profiling.span("q"):
            pass
        with profiling.span("r"):
            with profiling.span("s"):
                pass
    with profiling.span("p"):
        pass
    assert profiling.span_ms("q") == [1.0]
    assert profiling.span_ms("s") == [1.0]
    assert profiling.span_ms("r") == [3.0]
    assert profiling.span_ms("r", self_only=True) == [2.0]
    assert profiling.span_ms("p") == [7.0, 1.0]
    assert profiling.span_ms("p", self_only=True) == [3.0, 1.0]
    assert profiling.span_ms("nothing", self_only=True) == []


def test_annotate_is_a_span():
    with profiling.annotate("ann"):
        pass
    assert [r.name for r in profiling.spans()] == ["ann"]


def test_spans_in_the_trace_on_its_clock(tmp_path):
    """Under torch.profiler every span is a user annotation of trace()'s
    Chrome file, nested as in the ring, its duration within 5% or 50 us of
    the ring's (after a first pair of spans that warms the profiler's
    calls)."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("warm.outer"):
            with profiling.span("warm.inner"):
                pass
        with profiling.span("t.outer"):
            with profiling.span("t.inner"):
                time.sleep(0.004)
                torch.ones(64).sum()
            with profiling.span("t.second"):
                time.sleep(0.002)
    events = json.loads(next(tmp_path.glob("trace_*.json")).read_text())["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"
           and e["name"].startswith("t.")}
    recs = {r.name: r for r in profiling.spans() if r.name.startswith("t.")}
    assert set(ann) == set(recs) == {"t.outer", "t.inner", "t.second"}
    for name, r in recs.items():
        ring_us = (r.end_ns - r.start_ns) / 1e3
        assert abs(float(ann[name]["dur"]) - ring_us) <= max(0.05 * ring_us, 50.0), name
        if r.parent is not None:
            p, c = ann[r.parent], ann[name]
            assert float(p["ts"]) <= float(c["ts"])
            assert float(c["ts"]) + float(c["dur"]) <= float(p["ts"]) + float(p["dur"])
    assert float(ann["t.inner"]["ts"]) + float(ann["t.inner"]["dur"]) <= float(
        ann["t.second"]["ts"])


def test_counters_name_every_counter_of_the_port():
    """counters() holds every module-level launch counter of the port under
    <module>.<name>, read where it lives, and the pipeline's nine (four
    requests, the refines a CUDA graph served, and MultiModelRefiner's
    poses, B1 slots and padded slots)."""
    found = set()
    for path in PORT.rglob("*.py"):
        for name in re.findall(r"^(\w*launches) = 0", path.read_text(), re.M):
            found.add(f"{path.stem}.{name}")
    c = profiling.counters()
    assert found and found <= set(c)
    pipeline = {"pipeline.scenes", "pipeline.refines", "pipeline.tracked_frames",
                "pipeline.poses", "pipeline.graph_captures", "pipeline.graph_replays",
                "pipeline.model_poses", "pipeline.model_slots", "pipeline.padded_slots"}
    assert pipeline <= set(c)
    assert set(c) - found == pipeline
    from pose_refine_tpu_torch.ops import rasterize_cuda
    assert c["rasterize_cuda.launches"] == rasterize_cuda.launches
    assert all(isinstance(v, int) for v in c.values())


# ------------------------------------------------------------- the port's


REFINE_TREE = [
    ("prt.plan", "prt.scene.set", 0),
    ("prt.scene.build", "prt.scene.set", 0),
    ("prt.scene.set", None, 0),
    ("prt.refine.render", "prt.refine", 1),
    ("prt.refine.lift", "prt.refine", 1),
    ("prt.refine.icp", "prt.refine", 1),
    ("prt.refine", None, 1),
]


def frame(k):
    """A tracked frame's spans; request k."""
    return [("prt.step.sample", "prt.step", k),
            ("prt.plan", "prt.track", k),
            ("prt.scene.build", "prt.track", k),
            ("prt.refine.render", "prt.track", k),
            ("prt.refine.lift", "prt.track", k),
            ("prt.refine.icp", "prt.track", k),
            ("prt.refine.info", "prt.track", k),
            ("prt.track", "prt.step", k),
            ("prt.track.pin", "prt.step", k)]


def fused(k):
    """The fuse of the frame before, inside request k's step."""
    return [("prt.wait", "prt.step.fuse", k), ("prt.step.fuse", "prt.step", k)]


SESSION_TREE = (frame(0) + [("prt.step", None, 0)]
                + frame(1) + fused(1) + [("prt.step", None, 1)]
                + fused(2) + [("prt.step", None, 2)])


def run_refine(scene, **kw):
    m, K, truth, depth = scene
    ref = ptt.PoseRefiner(m, K=K, **CFG, **kw)
    hyps = ptt.sample_hypotheses(truth, 5, rng=0)
    ref.set_scene_depth(depth)
    poses, res = ref.refine(hyps, CRIT)
    return [poses, res.fitness, res.inlier_rmse, res.transformation]


def run_session(scene):
    m, K, truth, depth = scene
    ref = ptt.PoseRefiner(m, K=K, **CFG)
    session = ptt.TrackingSession(ref, truth, n_hypotheses=3, seed=5)
    steps = [session.step_async(depth), session.step_async(depth), session.flush()]
    assert steps[0] is None
    return [np.asarray(x) for s in steps[1:]
            for x in (s.pose, s.refined, s.covariance, s.results.fitness)]


def test_refine_span_tree_and_counters(scene):
    before = profiling.counters()
    run_refine(scene)
    assert tree(profiling.spans()) == REFINE_TREE
    after = profiling.counters()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"pipeline.scenes": 1, "pipeline.refines": 1, "pipeline.poses": 5}
    assert all(ms >= 0.0 for r in REFINE_TREE for ms in profiling.span_ms(r[0]))


def test_split_refine_spans_each_shard_and_the_gather(scene):
    run_refine(scene, devices=["cpu", "cpu"])
    recs = [r for r in profiling.spans() if r.parent in ("prt.refine", "prt.shard")]
    shard = [("prt.refine.render", "prt.shard"), ("prt.refine.lift", "prt.shard"),
             ("prt.refine.icp", "prt.shard"), ("prt.shard", "prt.refine")]
    assert [(r.name, r.parent) for r in recs] == shard * 2 + [("prt.gather", "prt.refine")]


def test_session_span_tree_and_counters(scene):
    before = profiling.counters()
    run_session(scene)
    assert tree(profiling.spans()) == SESSION_TREE
    after = profiling.counters()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"pipeline.tracked_frames": 2, "pipeline.poses": 6}
    fuse, fuse_self = profiling.span_ms("prt.step.fuse"), profiling.span_ms(
        "prt.step.fuse", self_only=True)
    wait = profiling.span_ms("prt.wait")
    assert fuse_self == pytest.approx([f - w for f, w in zip(fuse, wait)], abs=1e-9)


@pytest.mark.parametrize("run", [run_refine, run_session], ids=["refine", "session"])
def test_outputs_equal_with_the_recorder_on_and_off(scene, run):
    on = run(scene)
    assert profiling.spans()
    profiling.clear_spans()
    profiling.tracing(False)
    off = run(scene)
    assert profiling.spans() == []
    for a, b in zip(on, off):
        a, b = (x.numpy() if isinstance(x, torch.Tensor) else x for x in (a, b))
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
