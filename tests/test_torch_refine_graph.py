"""The CUDA graph of a refine against a standing scene (pipeline._GraphSlot,
pipeline._graph_key, PoseRefiner._refine_graphed), driven on the CPU: the
slot's rule (eager, capture, replay), the key's fields, what drops a graph,
which refines never reach a capture, and a replay's copy-out and counters.
The capture and replay themselves need a card: tests/test_torch_device.py
holds them to the eager refine bit for bit (``-m cuda -k graph``).
"""

import numpy as np
import pytest
import torch

import pose_refine_tpu_torch as ptt
from pose_refine_tpu_torch import geometry, icp, mesh, pipeline
from pose_refine_tpu_torch.ops import rasterize_cuda as RC
from pose_refine_tpu_torch.utils import profiling

W, H = 80, 60
CARD_STREAM = pipeline._card_stream


class FakeGraph:
    """A captured graph's stand-in: counts its replays and resets."""

    def __init__(self, refine=None):
        self.refine = refine
        self.replays = 0
        self.resets = 0

    def replay(self):
        self.replays += 1

    def reset(self):
        self.resets += 1


def drive(slot, keys):
    """slot.decide over ``keys``, a fake graph standing in for each
    capture: the decisions, in order."""
    out = []
    for k in keys:
        mode = slot.decide(k)
        if mode == "capture":
            slot.graph = FakeGraph()
        out.append(mode)
    return out


def test_slot_rule_eager_capture_replay():
    """The first refine of a key is eager, the second in a row captures,
    every later one replays; another key is eager again and captures on
    its own repeat; None (a refine out of scope) is always eager and breaks
    the run."""
    slot = pipeline._GraphSlot()
    a, b = ("a",), ("b",)
    got = drive(slot, [a, a, a, a, b, b, b, a, None, a, a, None, None, a])
    assert got == ["eager", "capture", "replay", "replay", "eager", "capture", "replay",
                   "eager", "eager", "eager", "capture", "eager", "eager", "eager"]


def test_slot_drops_its_graph_on_a_miss():
    """A different key resets the graph (its memory pool goes with it) and
    forgets every buffer of it; the new key is remembered."""
    slot = pipeline._GraphSlot()
    drive(slot, [("a",), ("a",)])
    graph = slot.graph
    slot.hyps, slot.packed, slot.launches, slot.keep = torch.zeros(1), torch.zeros(1), {}, (1,)
    assert slot.decide(("b",)) == "eager"
    assert graph.resets == 1
    assert (slot.graph, slot.hyps, slot.packed, slot.launches, slot.keep) == (None,) * 5
    assert slot.key == ("b",)
    assert slot.decide(None) == "eager" and slot.key is None


def base_key_args():
    """_graph_key's arguments for an in-scope refine (as if on a card)."""
    scene = object()
    tris = torch.zeros((10, 3, 3))
    init = torch.zeros((4, 4, 4))
    kw = dict(width=320, height=240, max_points=2048,
              criteria=icp.ICPConvergenceCriteria(1e-5, 1e-5, 24), window=128, stride=2,
              roi=(0, 0, 256, 200), robust_delta=0.0, estimation="point_to_plane",
              lift="window", coarse_iters=0, coarse_stride=2, raster=None, chunk_iters=25,
              with_information=False, scene_ids=None)
    return dict(scene=scene, generation=1, tris=tris, init=init, kw=kw,
                proj=torch.zeros((4, 4)), K=torch.zeros((3, 3)))


def changed(base, field):
    """``base`` (base_key_args) with one field of the key changed, every
    other argument the same object."""
    a = dict(base)
    kw = dict(a["kw"])
    crit = kw["criteria"]
    edits = {
        "scene": lambda: a.update(scene=object()),
        "generation": lambda: a.update(generation=2),
        "mesh": lambda: a.update(tris=torch.zeros((10, 3, 3))),
        "mesh_shape": lambda: a.update(tris=a["tris"][:5]),
        "N": lambda: a.update(init=torch.zeros((5, 4, 4))),
        "dtype": lambda: a.update(init=torch.zeros((4, 4, 4), dtype=torch.float64)),
        "proj": lambda: a.update(proj=torch.zeros((4, 4))),
        "K": lambda: a.update(K=torch.zeros((3, 3))),
        "roi": lambda: kw.update(roi=(128, 0, 256, 200)),
        "window": lambda: kw.update(window=96),
        "stride": lambda: kw.update(stride=1),
        "max_points": lambda: kw.update(max_points=1024),
        "lift": lambda: kw.update(lift="compact"),
        "render_w": lambda: kw.update(width=640),
        "render_h": lambda: kw.update(height=480),
        "relative_fitness": lambda: kw.update(criteria=crit._replace(relative_fitness=1e-6)),
        "relative_rmse": lambda: kw.update(criteria=crit._replace(relative_rmse=1e-6)),
        "max_iteration": lambda: kw.update(criteria=crit._replace(max_iteration=12)),
        "robust_delta": lambda: kw.update(robust_delta=0.004),
        "estimation": lambda: kw.update(estimation="point_to_point"),
        "coarse_iters": lambda: kw.update(coarse_iters=8),
        "coarse_stride": lambda: kw.update(coarse_stride=4),
    }
    edits[field]()
    a["kw"] = kw
    return a


KEY_FIELDS = ["scene", "generation", "mesh", "mesh_shape", "N", "dtype", "proj", "K", "roi",
              "window", "stride", "max_points", "lift", "render_w", "render_h",
              "relative_fitness", "relative_rmse", "max_iteration", "robust_delta",
              "estimation", "coarse_iters", "coarse_stride"]


@pytest.mark.parametrize("field", KEY_FIELDS + ["stream"])
def test_any_key_field_changed_is_a_miss(monkeypatch, field):
    """Each field the graph freezes is in the key: with one changed, the
    refine misses, runs eagerly and drops the standing graph."""
    monkeypatch.setattr(pipeline, "_card_stream", lambda device: 7)
    base = base_key_args()
    key = pipeline._graph_key(**base)
    assert key is not None and key == pipeline._graph_key(**base)
    if field == "stream":
        monkeypatch.setattr(pipeline, "_card_stream", lambda device: 8)
        other = pipeline._graph_key(**base)
    else:
        other = pipeline._graph_key(**changed(base, field))
    assert other is not None and other != key
    slot = pipeline._GraphSlot()
    assert drive(slot, [key, key, key]) == ["eager", "capture", "replay"]
    graph = slot.graph
    assert slot.decide(other) == "eager"
    assert graph.resets == 1 and slot.graph is None


@pytest.mark.parametrize("scope", ["cpu", "scene_ids", "with_information", "scatter_raster",
                                   "indexed_tris"])
def test_out_of_scope_key_is_none(monkeypatch, scope):
    """A refine the graph does not serve has no key: off the card, against
    a stack (scene_ids), with the information pass, with the scatter
    raster, or with per-pose meshes."""
    if scope != "cpu":
        monkeypatch.setattr(pipeline, "_card_stream", lambda device: 7)
    a = base_key_args()
    kw = a["kw"]
    if scope == "scene_ids":
        kw["scene_ids"] = torch.zeros(4, dtype=torch.int32)
    elif scope == "with_information":
        kw["with_information"] = True
    elif scope == "scatter_raster":
        kw["raster"] = pipeline._scatter_raster
    elif scope == "indexed_tris":
        a["tris"] = RC.IndexedTris(torch.zeros((2, 10, 3, 3)), torch.zeros(4, dtype=torch.int32))
    assert pipeline._graph_key(**a) is None


@pytest.fixture(scope="module")
def small_case():
    """An icosphere, a frame of it rendered by the port's plain raster at
    80x60, and a batch of hypotheses about its pose."""
    m = mesh.make_icosphere(40.0, 2)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.125
    truth = geometry.pose_from_Rt(torch.eye(3), torch.tensor([0.0, 0.0, 300.0]))
    proj = geometry.compute_proj(K, W, H, device="cpu")
    frame = RC.rasterize(m.tris, truth[None], W, H, proj, device="cpu")[0].numpy()
    hyps = geometry.sample_hypotheses(truth.numpy(), 3, rot_deg=5.0, trans_mm=5.0, rng=0)
    return m, K, frame, hyps


@pytest.fixture()
def spy(monkeypatch):
    """Pretend the CPU is a card for the key, and record each capture and
    replay instead of running a graph: a capture keeps the eager refine in
    its fake graph, a replay runs it."""
    calls = []
    monkeypatch.setattr(pipeline, "_card_stream", lambda device: 7)

    def capture(self, refine, init, keep):
        calls.append("capture")
        self.graph = FakeGraph(refine)

    def replay(self, init, first=False):
        calls.append("replay")
        return self.graph.refine(init)

    monkeypatch.setattr(pipeline._GraphSlot, "_capture", capture)
    monkeypatch.setattr(pipeline._GraphSlot, "_replay", replay)
    return calls


CRIT = ptt.ICPConvergenceCriteria(max_iteration=3)


def test_refiner_captures_on_the_repeat(small_case, spy):
    """Through the refiner: eager, capture (and its own run), replays; a
    new scene, then criteria that differ, each start the rule again."""
    m, K, frame, hyps = small_case
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", max_points=256,
                          window=48).set_scene_depth(frame)
    for _ in range(4):
        ref.refine(hyps, CRIT)
    assert spy == ["capture", "replay", "replay", "replay"]
    spy.clear()
    ref.set_scene_depth(frame)
    ref.refine(hyps, CRIT)
    ref.refine(hyps, ptt.ICPConvergenceCriteria(max_iteration=2))
    assert spy == []
    ref.refine(hyps, ptt.ICPConvergenceCriteria(max_iteration=2))
    assert spy == ["capture", "replay"]


@pytest.mark.parametrize("how", ["depth", "depths", "cloud"])
def test_set_scene_drops_the_slot(small_case, how):
    """Every set_scene_* bumps the scene generation and drops both slots,
    resetting their graphs."""
    m, K, frame, _hyps = small_case
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", max_points=256, window=48,
                          scene="nn_bruteforce")
    graphs = []
    for slot in (ref._graph, ref._graph_coarse):
        drive(slot, [("a",), ("a",)])
        graphs.append(slot.graph)
    gen = ref._scene_generation
    if how == "depth":
        ref.set_scene_depth(frame)
    elif how == "depths":
        ref.set_scene_depths(np.stack([frame, frame]))
    else:
        pts = np.random.default_rng(0).random((64, 3)).astype(np.float32)
        ref.set_scene_cloud(pts, pts / np.linalg.norm(pts, axis=1, keepdims=True))
    assert ref._scene_generation == gen + 1
    assert [g.resets for g in graphs] == [1, 1]
    assert all(s.graph is None and s.key is None for s in (ref._graph, ref._graph_coarse))


@pytest.mark.parametrize("scope", ["cpu", "scene_ids", "devices", "schedule",
                                   "with_covariance", "indexed_tris", "scatter_raster"])
def test_out_of_scope_refines_never_capture(small_case, monkeypatch, spy, scope):
    """Refines that stay eager never reach a capture, however often they
    repeat: CPU tensors, stacks (scene_ids), devices=, schedule levels,
    with_covariance=True, MultiModelRefiner's IndexedTris, and the scatter
    raster (use_pallas=False)."""
    m, K, frame, hyps = small_case
    kw = dict(K=K, width=W, height=H, device="cpu", max_points=256, window=48)
    args, call = (hyps, CRIT), {}
    if scope == "cpu":
        monkeypatch.setattr(pipeline, "_card_stream", CARD_STREAM)
    if scope == "devices":
        kw["devices"] = ["cpu", "cpu"]
    if scope == "scatter_raster":
        kw["use_pallas"] = False
    if scope == "indexed_tris":
        ref = ptt.MultiModelRefiner([m, m], **kw).set_scene_depth(frame)
        args = ([0, 1, 0], hyps)
        call = dict(criteria=CRIT)
    elif scope == "scene_ids":
        ref = ptt.PoseRefiner(m, **kw).set_scene_depths(np.stack([frame, frame]))
        call = dict(scene_ids=np.array([0, 1, 0]))
    else:
        ref = ptt.PoseRefiner(m, **kw).set_scene_depth(frame)
    if scope == "schedule":
        call = dict(schedule=[(0.05, 2), (0.02, 2)])
    elif scope == "with_covariance":
        call = dict(with_covariance=True)
    for _ in range(3):
        ref.refine(*args, **call)
    assert spy == []
    assert ref._graph.graph is None


def test_counters_carry_the_graph_counts():
    """profiling.counters() reads pipeline.graph_captures and
    pipeline.graph_replays; advance adds to any counter by its key."""
    c = profiling.counters()
    assert "pipeline.graph_captures" in c and "pipeline.graph_replays" in c
    before = c["icp_reduce.iterate_launches"], c["nn_kdtree.launches"]
    profiling.advance({"icp_reduce.iterate_launches": 25, "nn_kdtree.launches": 25})
    after = profiling.counters()
    assert (after["icp_reduce.iterate_launches"], after["nn_kdtree.launches"]) == \
        (before[0] + 25, before[1] + 25)
    profiling.advance({"icp_reduce.iterate_launches": -25, "nn_kdtree.launches": -25})


@pytest.mark.parametrize("first", [False, True])
def test_replay_copies_out_and_counts(first):
    """A replay copies the hypotheses into the graph's input, launches the
    graph once, and returns views of one fresh copy of the packed outputs
    [refined | T | fitness | rmse | n_points], none of them sharing the
    graph's memory; a replay adds the captured launches and counts itself,
    the capture's own run does neither."""
    n = 3
    slot = pipeline._GraphSlot()
    slot.graph = FakeGraph()
    slot.hyps = torch.zeros((n, 4, 4))
    slot.packed = torch.arange(35 * n, dtype=torch.float32)
    slot.launches = {"rasterize_cuda.launches": 1, "lift_cuda.launches": 1}
    init = torch.rand((n, 4, 4))
    before = profiling.counters()
    refined, res = slot._replay(init, first=first)
    after = profiling.counters()
    assert torch.equal(slot.hyps, init) and slot.graph.replays == 1
    p = slot.packed
    assert torch.equal(refined, p[:16 * n].view(n, 4, 4))
    assert torch.equal(res.transformation, p[16 * n:32 * n].view(n, 4, 4))
    assert torch.equal(res.fitness, p[32 * n:33 * n])
    assert torch.equal(res.inlier_rmse, p[33 * n:34 * n])
    assert torch.equal(res.n_points, p[34 * n:])
    for t in (refined, *res):
        assert t.is_contiguous()
        assert t.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()
    added = 0 if first else 1
    for k in ("rasterize_cuda.launches", "lift_cuda.launches", "pipeline.graph_replays"):
        assert after[k] - before[k] == added, k
    assert after["pipeline.graph_captures"] == before["pipeline.graph_captures"]
    profiling.advance({k: before[k] - after[k] for k in after if after[k] != before[k]})


def test_cascade_keeps_a_slot_a_scene(small_case, spy):
    """scene_cascade refines two standing scenes in one call, the coarse
    twin then the scene: each has its own slot, so both capture on the
    second refine and replay after it instead of thrashing one slot."""
    m, K, frame, hyps = small_case
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", max_points=256, window=48,
                          scene="nn", scene_cascade=(8.0, 2)).set_scene_depth(frame)
    for _ in range(3):
        ref.refine(hyps, CRIT)
    assert spy == ["capture", "replay"] * 2 + ["replay"] * 2
    assert ref._graph.graph is not None and ref._graph_coarse.graph is not None
    assert ref._graph.key != ref._graph_coarse.key
