"""The JAX package's public interface in the port, on the CPU.

A signature test reads every public function, class and method of
``pose_refine_tpu/`` with ``ast`` and holds the port's counterpart to it:
the port's positional parameters start with JAX's, in JAX's order, every
JAX keyword is accepted, the defaults are JAX's, and the port adds no
parameter but the listed exceptions. Behaviour tests call the JAX-named
entry points, positionally where JAX allows it, on the same numpy inputs as
the JAX package, with the slice bounds of tests/test_torch_slice.py (0.1
deg, 0.2 mm, fitness 5e-3, 100% verdicts). The JAX side renders through its
Pallas raster in interpret mode (tests/test_torch_api.py's fixture) and
queries device-built NN scenes on its flash backend
(tests/test_torch_track.py's)."""

import ast
import dataclasses
import functools
import importlib
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose_refine_tpu as prt
import pose_refine_tpu.ops.rasterize as JR
import pose_refine_tpu.ops.rasterize_pallas as JRP
import pose_refine_tpu.pipeline as jpipe
import pose_refine_tpu_torch as ptt
import pose_refine_tpu_torch.pipeline as tpipe
from pose_refine_tpu import geometry as jgeo
from pose_refine_tpu import icp as jicp
from pose_refine_tpu import mesh
from pose_refine_tpu.ops.depth_to_cloud import depth_image_to_points as jd2p
from pose_refine_tpu.ops.normals import estimate_normals as jnormals
from pose_refine_tpu.parallel import sharding as jsh
from pose_refine_tpu.scene import nn as jnn
from pose_refine_tpu_torch import icp as ticp
from pose_refine_tpu_torch.parallel import sharding as tsh
from pose_refine_tpu_torch.scene import nn as tnn
from pose_refine_tpu_torch.utils.metrics import rotation_angle_deg

torch.set_num_threads(2)

W, H = 320, 240
# tests/test_torch_slice.py's configuration and workload
CFG = dict(render_scale=2, max_points=768, window=64, stride=2, decimate_mm=4.0)
ITERS = 24
VERDICT_DEG = 3.0
MAX_DROT_DEG, MAX_DT_MM, MAX_DFIT = 0.1, 0.2, 5e-3
R_REN = np.array(
    [[0.34768538, 0.93761126, 0.0],
     [0.70540612, -0.26157897, -0.65877056],
     [-0.61767070, 0.22904489, -0.75234390]], np.float32)

# ----------------------------------------------------------------- signatures

JAX_ROOT = pathlib.Path(prt.__file__).parent
# What may differ between the packages, and why:
# - no port module: utils/sync.py (the TPU probe fence, ROADMAP A "Do not
#   port") and the *_pallas modules (the Pallas kernels; their ports are
#   csrc/*.cu behind ops/rasterize_cuda.py and scene/nn_flash.py)
NO_COUNTERPART = {"pose_refine_tpu.utils.sync", "pose_refine_tpu.ops.rasterize_pallas",
                  "pose_refine_tpu.scene.nn_pallas"}
# - parameters the port adds: ``device`` (where tables and tensors live;
#   JAX places arrays itself) and the test hook ``plain`` (the kernels'
#   plain versions); ``_``-prefixed parameters are private in both
PORT_ONLY_PARAMS = {"device", "plain"}
# - JAX's matmul precision constant and array type alias: the port computes
#   in float32 without them
JAX_ONLY_NAMES = {"F32", "Array"}
# - defaults that change no result: the dense raster's triangle chunk (the
#   size of a step of an exact min) and the trace directory (None is the
#   same ``pose_refine_trace`` directory under the temporary directory)
OTHER_DEFAULTS = {("pose_refine_tpu.ops.rasterize", "rasterize_dense", "tri_chunk"),
                  ("pose_refine_tpu.utils.profiling", "trace", "logdir")}
JAX_MODULES = sorted(
    ".".join(p.relative_to(JAX_ROOT.parent).with_suffix("").parts).replace(".__init__", "")
    for p in JAX_ROOT.rglob("*.py"))


def _port_name(jax_module: str) -> str:
    return jax_module.replace("pose_refine_tpu", "pose_refine_tpu_torch", 1)


def _jax_params(fn: ast.FunctionDef, is_method: bool):
    """(positional names, keyword-only names, {name: default source}, has
    *args or **kwargs) of a JAX def; a method's self / cls dropped."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    defaults = dict(zip(pos[len(pos) - len(a.defaults):], (ast.unparse(d) for d in a.defaults)))
    defaults.update({x.arg: ast.unparse(d) for x, d in zip(a.kwonlyargs, a.kw_defaults) if d})
    static = any(getattr(d, "id", None) == "staticmethod" for d in fn.decorator_list)
    if is_method and not static:
        pos = pos[1:]
    return pos, [x.arg for x in a.kwonlyargs], defaults, bool(a.vararg or a.kwarg)


def _public_defs(tree: ast.Module):
    """(qualified name, def node, is a method) of every public function and
    public method (with __init__) of a module's public classes."""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            yield node.name, node, False
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    yield f"{node.name}.{sub.name}", sub, True


def _public_names(tree: ast.Module, init: bool):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.Assign):
            yield from (t.id for t in node.targets if isinstance(t, ast.Name))
        elif init and isinstance(node, ast.ImportFrom):
            yield from (a.asname or a.name for a in node.names)


@pytest.mark.parametrize("module", [m for m in JAX_MODULES if m not in NO_COUNTERPART])
def test_signatures_follow_jax(module):
    """Every public name of the JAX module exists in the port's module; every
    public function and method takes JAX's positional parameters first, in
    JAX's order, accepts every JAX keyword with JAX's default, and adds only
    PORT_ONLY_PARAMS (the exceptions above)."""
    src = JAX_ROOT.parent / (module.replace(".", "/") + ".py")
    if not src.exists():
        src = src.with_suffix("") / "__init__.py"
    tree = ast.parse(src.read_text())
    port = importlib.import_module(_port_name(module))
    missing = [n for n in _public_names(tree, src.name == "__init__.py")
               if not n.startswith("_") and not hasattr(port, n)
               and n not in JAX_ONLY_NAMES]
    assert not missing, f"{_port_name(module)} lacks {missing}"
    problems = []
    for qual, node, is_method in _public_defs(tree):
        owner, _, name = qual.rpartition(".")
        raw = inspect.getattr_static(getattr(port, owner), name) if owner else None
        obj = getattr(getattr(port, owner), name) if owner else getattr(port, name)
        if isinstance(raw, property) or not callable(obj):
            continue
        params = inspect.signature(obj).parameters
        ppos = [n for n, p in params.items()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        if is_method and not isinstance(raw, (classmethod, staticmethod)):
            ppos = ppos[1:]
        jpos, jkw, jdef, forwards = _jax_params(node, is_method)
        jpos_public = [n for n in jpos if not n.startswith("_")]
        if ppos[:len(jpos_public)] != jpos_public:
            problems.append(f"{qual}: positional {ppos} does not start with JAX's {jpos_public}")
        takes_any = any(p.kind == p.VAR_KEYWORD for p in params.values())
        for n in jpos_public + [k for k in jkw if not k.startswith("_")]:
            if n not in params and not takes_any:
                problems.append(f"{qual}: JAX keyword {n!r} refused")
        for n, d in jdef.items():
            if n not in params or (module, qual, n) in OTHER_DEFAULTS:
                continue
            want = eval(d, vars(importlib.import_module(module)))  # JAX's default, evaluated
            if params[n].default != want:
                problems.append(f"{qual}: default {n}={params[n].default!r}, JAX's {d}")
        if not forwards:
            extra = [n for n, p in params.items()
                     if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
                     and n not in jpos + jkw and not n.startswith("_")
                     and n not in PORT_ONLY_PARAMS and (n not in ("self", "cls") or not is_method)]
            if extra:
                problems.append(f"{qual}: parameters the JAX package lacks {extra}")
    assert not problems, "\n".join(problems)


@pytest.mark.parametrize("sub", ["ops", "scene", "utils", "parallel"])
def test_subpackages_export_jax_names(sub):
    """``from pose_refine_tpu_torch.<sub> import <each of JAX's names>`` gives
    the port module's own object; ops does not re-bind the depth_to_cloud
    submodule to the function (JAX's note)."""
    tree = ast.parse((JAX_ROOT / sub / "__init__.py").read_text())
    names = [a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
             for a in n.names]
    assert names
    pkg = importlib.import_module(f"pose_refine_tpu_torch.{sub}")
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            home = importlib.import_module(_port_name(node.module))
            for a in node.names:
                got = getattr(pkg, a.asname or a.name)
                assert got is getattr(home, a.name), a.name
    if sub == "ops":
        assert inspect.ismodule(pkg.depth_to_cloud)
    assert ptt.refine_poses_jit is tpipe.refine_poses_jit


# ------------------------------------------------------------------- workload


def small_K():
    K = jgeo.LINEMOD_K.copy()
    K[:2] *= 0.5
    return K


@pytest.fixture(scope="module")
def setup():
    """tests/test_torch_slice.py's workload - the bumpy sphere's scene depth
    at 320x240 and 12 hypotheses (8 at +-10 deg/axis, +-20 mm, 4 at 3.5x the
    rotation) - and the port's refiner for it, whose mesh, projection,
    render intrinsics, sizes and ROI the JAX-named functions take on both
    sides (the JAX refiner plans the same, test_slice_matches_jax)."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    K = small_K()
    truth = np.asarray(jgeo.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32)))
    rng = np.random.default_rng(0)
    ang = rng.uniform(-0.17, 0.17, (12, 3)).astype(np.float32)
    ang[8:] *= 3.5
    d_rot = np.asarray(jgeo.euler_to_rotation(ang))
    d_t = rng.uniform(-20, 20, (12, 3)).astype(np.float32)
    poses = np.zeros((12, 4, 4), np.float32)
    poses[:, :3, :3] = np.einsum("nij,jk->nik", d_rot, truth[:3, :3])
    poses[:, :3, 3] = truth[:3, 3] + d_t
    poses[:, 3, 3] = 1.0
    scene = np.asarray(JR.rasterize_dense(m.tris, truth[None], W, H,
                                          jgeo.compute_proj(K, W, H)))[0]
    ref = ptt.PoseRefiner(m, K=K, width=W, height=H, device="cpu", **CFG)
    return m, K, truth, poses, scene, ref.set_scene_depth(scene)


@pytest.fixture
def jax_kernels(monkeypatch):
    """JAX's Pallas raster in interpret mode and its device-built NN scenes
    on the flash backend, with the jitted entry points' caches cleared
    around the patch."""
    monkeypatch.setattr(JRP, "rasterize_pallas",
                        functools.partial(JRP.rasterize_pallas, interpret=True))
    orig = jnn.SceneNN.__dict__["from_depth_device"].__func__

    def flash(cls, *args, **kwargs):
        return dataclasses.replace(orig(cls, *args, **kwargs), backend="flash")

    monkeypatch.setattr(jnn.SceneNN, "from_depth_device", classmethod(flash))
    fns = (jpipe.refine_poses_jit, jpipe.track_poses_jit, jpipe.track_poses_nn_jit)
    for fn in fns:
        fn.clear_cache()
    yield
    for fn in fns:
        fn.clear_cache()


def t(x):
    return torch.as_tensor(np.asarray(x))


def crit_pair(iters=ITERS):
    return jicp.ICPConvergenceCriteria(max_iteration=iters), ticp.ICPConvergenceCriteria(
        max_iteration=iters)


def planned(ref):
    """The refiner's render size and lift plan, as JAX's keywords."""
    return dict(width=ref.render_w, height=ref.render_h, max_points=ref.max_points,
                window=ref.window, stride=ref.stride, roi=ref.roi)


def arrays(ref):
    """(tris, proj, K_render) of the refiner: the port's tensors and JAX's
    arrays of the same values."""
    port = (ref.tris, ref.proj, ref._K_render_t)
    return port, tuple(jnp.asarray(x.numpy()) for x in port)


def assert_agree(tposes, tres, jposes, jres, truth):
    """The slice bounds, equal point counts and 100% verdict agreement."""
    tposes, jposes = np.asarray(tposes), np.asarray(jposes)
    assert tposes.shape == jposes.shape and np.isfinite(tposes).all()
    np.testing.assert_array_equal(rotation_angle_deg(tposes, truth) < VERDICT_DEG,
                                  rotation_angle_deg(jposes, truth) < VERDICT_DEG)
    assert rotation_angle_deg(tposes, jposes).max() <= MAX_DROT_DEG
    assert np.abs(tposes[..., :3, 3] - jposes[..., :3, 3]).max() <= MAX_DT_MM
    assert np.abs(np.asarray(tres.fitness) - np.asarray(jres.fitness)).max() <= MAX_DFIT
    np.testing.assert_array_equal(np.asarray(tres.n_points), np.asarray(jres.n_points))


def assert_same(got, want):
    """Two refine outputs (tensors and NamedTuples of tensors), bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in (zip(g, w) if isinstance(g, tuple) else [(g, w)]):
            assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------- the JAX-named paths


@pytest.mark.parametrize("use_pallas", [True, False])
def test_refine_poses_jit_matches_jax(setup, jax_kernels, use_pallas):
    """refine_poses_jit with JAX's signature (scene_ids positional, the
    rest keywords) against JAX's: use_pallas=True, chunk_iters=8 is the
    raster kernel's plain version, equal to refine_poses bit for bit;
    use_pallas=False is the scatter raster, as JAX's False."""
    m, K, truth, poses, scene, ref = setup
    jcrit, tcrit = crit_pair()
    (tris, proj, K_r), (jtris, jproj, jK_r) = arrays(ref)
    kw = dict(planned(ref), use_pallas=use_pallas, chunk_iters=8, with_information=True)
    jout = jpipe.refine_poses_jit(jtris, jnp.asarray(poses), prt.SceneProjective.from_depth(
        scene, K), jproj, jK_r, None, criteria=jcrit, **kw)
    tout = ptt.refine_poses_jit(tris, t(poses), ref.scene, proj, K_r, None, criteria=tcrit,
                                **kw)
    assert len(tout) == 3 and tout[2].covariance.shape == (12, 6, 6)
    assert_agree(tout[0], tout[1], jout[0], jout[1], truth)
    if use_pallas:
        assert_same(tout, ptt.refine_poses(tris, t(poses), ref.scene, proj, K_r,
                                           criteria=tcrit, with_information=True,
                                           **planned(ref)))


def test_track_poses_jit_matches_jax(setup, jax_kernels):
    """track_poses_jit called positionally through chunk_iters, as JAX
    allows, against JAX's, and equal to track_poses bit for bit."""
    m, K, truth, poses, scene, ref = setup
    jcrit, tcrit = crit_pair()
    (tris, proj, K_r), (jtris, jproj, jK_r) = arrays(ref)
    p = planned(ref)
    sizes = (p["width"], p["height"], p["max_points"])
    opts = ("window", p["window"], p["stride"], p["roi"], 8)
    jout = jpipe.track_poses_jit(jtris, jnp.asarray(poses), jnp.asarray(scene), jproj, jK_r,
                                 jnp.asarray(K), jnp.float32(0.1), *sizes, jcrit, True, *opts)
    args = (tris, t(poses), t(scene), proj, K_r, t(K), 0.1)
    tout = tpipe.track_poses_jit(*args, *sizes, tcrit, True, *opts)
    assert_agree(tout[0], tout[1], jout[0], jout[1], truth)
    assert_same(tout, tpipe.track_poses(*args, criteria=tcrit, **p))


def test_track_poses_nn_jit_matches_jax(setup, jax_kernels):
    """track_poses_nn_jit called positionally through scene_stride against
    JAX's on the device-built NN scene, and equal to track_poses_nn bit for
    bit; pack_outputs=True is the (N, 71) session buffer of the same run,
    and JAX's ValueError without the information pass. 8 iterations: JAX's
    flash kernel runs in interpret mode."""
    m, K, truth, poses, scene, ref = setup
    jcrit, tcrit = crit_pair(8)
    (tris, proj, K_r), (jtris, jproj, jK_r) = arrays(ref)
    p = planned(ref)
    perm = jnn._grid_morton_perm(H // 4, W // 4)
    sizes = (p["width"], p["height"], p["max_points"])
    opts = ("window", p["window"], p["stride"], p["roi"], 8, 0.0, 4)
    jout = jpipe.track_poses_nn_jit(jtris, jnp.asarray(poses), jnp.asarray(scene), jproj,
                                    jK_r, jnp.asarray(K), jnp.float32(0.1), jnp.asarray(perm),
                                    *sizes, jcrit, True, *opts)
    args = (tris, t(poses), t(scene), proj, K_r, t(K), 0.1, t(perm))
    tout = tpipe.track_poses_nn_jit(*args, *sizes, tcrit, True, *opts)
    assert_agree(tout[0], tout[1], jout[0], jout[1], truth)
    assert_same(tout, tpipe.track_poses_nn(*args, criteria=tcrit, scene_stride=4, **p))
    packed = tpipe.track_poses_nn_jit(*args, *sizes, tcrit, True, *opts, with_information=True,
                                      pack_outputs=True)
    assert packed.shape == (12, 71)
    assert torch.equal(packed[:, :16], tout[0].reshape(12, 16))
    with pytest.raises(ValueError, match="with_information"):
        tpipe.track_poses_nn_jit(*args, *sizes, tcrit, True, *opts, pack_outputs=True)


def test_pose_refiner_positional_matches_jax(setup, jax_kernels):
    """PoseRefiner built positionally through decimate_mm - use_pallas at
    JAX's eighth place, chunk_iters at its fourteenth - against JAX's
    refiner built alike and the default refiner; use_pallas=False (JAX's
    scatter raster) through a MultiModelRefiner, which inherits it, against
    JAX's (the icosphere's rows by translation and fitness: a sphere's
    rotation is free), and its refine_async with criteria as a keyword;
    the chunk_iters each resolves to."""
    m, K, truth, poses, scene, ref = setup
    jcrit, tcrit = crit_pair()
    args = (m, K, W, H, "projective", 768, 0.1, True, "window", 64, 2, True, 0.35, 8, 2, 4.0)
    jref = prt.PoseRefiner(*args).set_scene_depth(scene)
    tref = ptt.PoseRefiner(*args, device="cpu").set_scene_depth(scene)
    assert (tref.use_pallas, tref.chunk_iters, tref.render_scale, tref.decimate_mm) == \
        (True, 8, 2, 4.0)
    assert tref._resolve_chunk_iters(tcrit) == jref._resolve_chunk_iters(jcrit) == 8
    assert (tref.roi, tref.window, tref.max_points) == (jref.roi, jref.window, jref.max_points)
    jposes, jres = jref.refine(poses, jcrit)
    tposes, tres = tref.refine(poses, tcrit)
    assert_agree(tposes, tres, jposes, jres, truth)
    assert ref.use_pallas is True and ref.chunk_iters == "auto"
    assert ref._resolve_chunk_iters(tcrit) == ITERS + 1
    assert_same((tposes, tres), ref.refine(poses, tcrit))
    coarse = ptt.PoseRefiner(m, K, W, H, chunk_iters=2, coarse_iters=4, device="cpu")
    assert coarse._resolve_chunk_iters(tcrit) == ITERS + 1  # JAX's fused loop
    other = mesh.make_icosphere(45.0, 2)
    ids = np.array([0, 1, 0, 1, 0, 0])
    kw = dict(width=W, height=H, use_pallas=False, chunk_iters=8, **CFG)
    jmm = prt.MultiModelRefiner([m, other], K, **kw).set_scene_depth(scene)
    tmm = ptt.MultiModelRefiner([m, other], K, device="cpu", **kw).set_scene_depth(scene)
    assert tmm.use_pallas is False
    jposes, jres = jmm.refine(ids, poses[:6], criteria=jcrit)
    tposes, tres = tmm.refine(ids, poses[:6], criteria=tcrit)
    assert_same(tmm.refine_async(ids, poses[:6], criteria=tcrit).wait(), (tposes, tres))
    bumpy = ids == 0
    assert_agree(tposes[bumpy], ticp.RegistrationResult(*(f[bumpy] for f in tres)),
                 np.asarray(jposes)[bumpy],
                 jicp.RegistrationResult(*(np.asarray(f)[bumpy] for f in jres)), truth)
    assert np.abs(tposes.numpy()[:, :3, 3] - np.asarray(jposes)[:, :3, 3]).max() <= MAX_DT_MM
    assert np.abs(tres.fitness.numpy() - np.asarray(jres.fitness)).max() <= MAX_DFIT


# ------------------------------------------------------------------------ ICP


@pytest.fixture(scope="module")
def clouds(setup):
    """The compact clouds of every other hypothesis' render."""
    m, K, truth, poses, scene, ref = setup
    renders = ptt.rasterize(ref.tris, t(poses[::2]), ref.render_w, ref.render_h, ref.proj)
    c, v, _n = ptt.depth_to_cloud(renders, ref._K_render_t, ref.max_points)
    return c.numpy(), v.numpy()


@pytest.fixture(scope="module")
def nn_scenes(setup):
    """The scene's kd NN scene in both packages (exact NN: the port's kd
    walk equals JAX's, tests/test_torch_kdtree.py)."""
    m, K, truth, poses, scene, ref = setup
    return ptt.SceneNN.from_depth(scene, K, device="cpu"), prt.SceneNN.from_depth(
        scene, K, backend="kdtree")


@pytest.mark.parametrize("fn", ["icp_point_to_plane", "icp_point_to_point"])
def test_icp_positional_chunk_iters_is_jax_order(clouds, nn_scenes, fn):
    """icp_point_to_plane(c, v, q, crit, None, "matmul", 8, 0.01) binds 8 to
    chunk_iters and 0.01 to robust_delta, as in JAX: equal bit for bit to
    the keyword call of Huber 0.01, unlike the unweighted refine, and held
    to JAX's positional call on the NN scene (tests/test_torch_icp.py's
    T_ATOL and FIT_ATOL; the projective association's pixel flips split
    Huber refines between JAX's own formulations, ROADMAP C);
    icp_point_to_plane_batch(..., crit, 8, 0.01) alike."""
    c, v = clouds
    tscene, jscene = nn_scenes
    jcrit, tcrit = crit_pair(10)
    mid = (None, "matmul") if fn == "icp_point_to_plane" else (None,)
    tfn = getattr(ticp, fn)
    got, _ = tfn(t(c), t(v), tscene.query, tcrit, *mid, 8, 0.01)
    kw, _ = tfn(t(c), t(v), tscene.query, tcrit, robust_delta=0.01)
    plain, _ = tfn(t(c), t(v), tscene.query, tcrit)
    assert_same((got,), (kw,))
    assert not torch.equal(got.transformation, plain.transformation)
    one = jax.jit(lambda ci, vi: getattr(jicp, fn)(ci, vi, jscene.query, jcrit, *mid, 11, 0.01))
    for i in range(len(c)):
        want, _ = one(c[i], v[i])
        np.testing.assert_allclose(got.transformation[i].numpy(),
                                   np.asarray(want.transformation), rtol=0, atol=1e-3)
        assert abs(float(got.fitness[i]) - float(want.fitness)) < 1e-3
    if fn == "icp_point_to_plane":
        batch, _ = ticp.icp_point_to_plane_batch(t(c), t(v), tscene, tcrit, 8, 0.01)
        assert_same((batch,), (got,))


@pytest.mark.parametrize("chunk_iters,raises", [(8, True), (24, True), (25, False), (64, False)])
def test_short_chunk_iters_under_coarse_raises_like_jax(setup, clouds, chunk_iters, raises):
    """coarse_iters needs the fused loop: chunk_iters under max_iteration + 1
    is JAX's ValueError (its text) from the ICP functions and from
    refine_poses_jit; a chunk of the whole loop runs."""
    c, v = clouds
    m, K, truth, poses, scene, ref = setup
    jcrit, tcrit = crit_pair()
    jscene = prt.SceneProjective.from_depth(scene, K)
    (tris, proj, K_r), _j = arrays(ref)
    calls = [
        lambda: jicp.icp_point_to_plane(c[0], v[0], jscene.query, jcrit,
                                        chunk_iters=chunk_iters, coarse_iters=4),
        lambda: ticp.icp_point_to_plane(t(c), t(v), ref.scene.query, tcrit,
                                        chunk_iters=chunk_iters, coarse_iters=4),
        lambda: ticp.icp_point_to_point(t(c), t(v), ref.scene.query, tcrit, None, chunk_iters,
                                        coarse_iters=4),
        lambda: ptt.refine_poses_jit(tris, t(poses[:2]), ref.scene, proj, K_r, criteria=tcrit,
                                     chunk_iters=chunk_iters, coarse_iters=4, **planned(ref)),
    ]
    for call in calls:
        if raises:
            with pytest.raises(ValueError, match=r"requires a fused loop \(chunk_iters"):
                call()
        else:
            assert call()[0] is not None


# ----------------------------------------------------------------- the scenes


def test_from_depth_device_roi_and_pool_tol_match_jax(setup, monkeypatch):
    """from_depth_device in JAX's positional order with tl_x, tl_y and
    pool_depth_tol=0.003, on a crop of the frame: on equal lifted grids
    (JAX's lift and normals, to which the port hands its tl_x / tl_y) every
    table equals JAX's bit for bit, pooled in blocks of 4 as
    test_pool_scene_grid_matches_jax holds them; with the port's own lift
    the strided tables agree within 1e-6. The offsets move the points and
    the tolerance changes the kept pixels."""
    m, K, truth, poses, scene, ref = setup
    crop, tl = scene[40:200, 60:260], (60, 40)
    args = (crop, K, 0.02, 1, *tl, None, 2, 0.003)
    want = jnn.SceneNN.from_depth_device(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                           for a in args))
    seen = []

    def jax_lift(depth, K, stride=1, tl_x=0, tl_y=0):
        seen.append((tl_x, tl_y))
        return tuple(t(x) for x in jd2p(jnp.asarray(depth.numpy()), jnp.asarray(K.numpy()),
                                       stride, tl_x, tl_y))

    with monkeypatch.context() as mp:
        mp.setattr(tnn, "depth_image_to_points", jax_lift)
        mp.setattr(tnn, "estimate_normals",
                   lambda d, K: t(jnormals(jnp.asarray(d.numpy()), jnp.asarray(K.numpy()))))
        got = tnn.SceneNN.from_depth_device(*(t(a) if isinstance(a, np.ndarray) else a
                                              for a in args))
    assert seen == [tl]
    for f in ("points", "normals", "table", "flash_table", "flash_boxes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    jw = jnn.SceneNN.from_depth_device(jnp.asarray(crop), jnp.asarray(K), 0.02, 2, *tl)
    tw = tnn.SceneNN.from_depth_device(t(crop), t(K), 0.02, 2, *tl)
    np.testing.assert_allclose(tw.table.numpy(), np.asarray(jw.table), rtol=1e-6, atol=1e-6)
    assert not torch.equal(tnn.SceneNN.from_depth_device(t(crop), t(K), 0.02, 2).points,
                           tw.points)
    at_5mm = tnn.SceneNN.from_depth_device(t(crop), t(K), 0.02, 1, *tl, pool=2)
    at_3mm = tnn.SceneNN.from_depth_device(t(crop), t(K), 0.02, 1, *tl, pool=2,
                                           pool_depth_tol=0.003)
    assert at_5mm.points.shape == at_3mm.points.shape
    assert not torch.equal(at_5mm.points, at_3mm.points)


def test_query_at_sid_keyword_matches_jax(setup):
    """query_at(sid=...) of both stacks against JAX's query_at(sid=...): the
    projective stack within its normals tolerance, the NN stack (the
    stacked flash kernel in interpret mode) bit for bit in the gate; the
    bound reduce and iterate take ``sid`` too."""
    m, K, truth, poses, scene, ref = setup
    frames = np.stack([scene, np.roll(scene, 7, axis=1)])
    rng = np.random.default_rng(1)
    src = (rng.uniform(-0.05, 0.05, (200, 3)) + [0, 0, 0.3]).astype(np.float32)
    pairs = [(ptt.SceneProjectiveStack.from_depths(frames, K, device="cpu"),
              prt.SceneProjectiveStack.from_depths(frames, K), 1e-6),
             (ptt.SceneNNStack.from_depths(frames, K, backend="flash", device="cpu"),
              prt.SceneNNStack.from_depths(frames, K, backend="flash"), 0.0)]
    for tstack, jstack, atol in pairs:
        got = tstack.query_at(sid=torch.tensor(1))(t(src))
        want = jstack.query_at(sid=jnp.int32(1))(jnp.asarray(src))
        v = np.asarray(want[2])
        assert v.any()
        np.testing.assert_array_equal(got[2].numpy(), v)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy()[v], np.asarray(w)[v], rtol=0, atol=atol)
        assert list(inspect.signature(tstack.iterate_at).parameters) == ["sid"]


# ---------------------------------------------------- PendingResult, sharding


def test_pending_result_slots(setup):
    """PendingResult's public slots are JAX's: refined, results and (with
    the covariance) uncertainty; wait() returns them as before, and
    track_packed_async's pinned buffer sits in refined with results None."""
    m, K, truth, poses, scene, ref = setup
    poses = poses[:4]
    assert set(jpipe.PendingResult.__slots__) <= set(ptt.PendingResult.__slots__)
    _jcrit, tcrit = crit_pair(4)
    pending = ref.refine_async(poses, tcrit, with_covariance=True)
    assert pending.uncertainty is not None and pending.results.fitness.shape == (4,)
    out = pending.wait()
    assert out[0] is pending.refined and out[1] is pending.results
    assert out[2] is pending.uncertainty
    assert_same(ptt.fence(ref.refine_async(poses, tcrit))[0],
                (pending.refined, pending.results))
    plain = ref.refine_async(poses, tcrit)
    assert plain.uncertainty is None and len(plain.wait()) == 2
    packed = ref.track_packed_async(scene, poses, tcrit)
    assert packed.results is None and packed.wait() == (packed.refined,)
    assert packed.refined.shape == (4, 71)
    direct = ptt.PendingResult(out[0], out[1])
    assert direct.wait()[0] is out[0] and len(direct.wait()) == 2


def test_sharding_takes_mesh_and_axis(setup):
    """make_mesh / shard_pose_batch / refine_poses_sharded with JAX's mesh
    and axis: the mesh is a device list (here three shards of the CPU) and
    axis a string; the sharded refine, called positionally through
    use_pallas, equals refine_poses_jit bit for bit for each raster, and
    takes refine_poses_jit's chunk_iters default (8: coarse_iters raises)."""
    m, K, truth, poses, scene, ref = setup
    cpu3 = [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        assert tsh.make_mesh(None, "dp") == []
    with pytest.raises(TypeError, match="axis"):
        tsh.make_mesh(axis=0)
    shards = tsh.shard_pose_batch(cpu3, t(poses), "dp")
    assert [s.shape[0] for s in shards] == [4, 4, 4]
    assert list(inspect.signature(jsh.refine_poses_sharded).parameters)[:12] == \
        list(inspect.signature(tsh.refine_poses_sharded).parameters)[:12]
    _jcrit, tcrit = crit_pair(6)
    (tris, proj, K_r), _j = arrays(ref)
    p = planned(ref)
    sizes = (p.pop("width"), p.pop("height"), p.pop("max_points"))
    for use_pallas in (None, False):
        got = tsh.refine_poses_sharded(tris, t(poses[:5]), ref.scene, proj, K_r, *sizes, tcrit,
                                       cpu3, "dp", use_pallas, **p)
        want = ptt.refine_poses_jit(tris, t(poses[:5]), ref.scene, proj, K_r, width=sizes[0],
                                    height=sizes[1], max_points=sizes[2], criteria=tcrit,
                                    use_pallas=use_pallas is None, **p)
        assert_same(got, want)
    with pytest.raises(ValueError, match="fused loop"):
        tsh.refine_poses_sharded(tris, t(poses[:3]), ref.scene, proj, K_r, *sizes,
                                 crit_pair()[1], cpu3, coarse_iters=4, **p)
