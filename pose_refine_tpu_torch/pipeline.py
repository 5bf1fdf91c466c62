"""End-to-end batched pose refinement: render -> lift -> associate -> solve
(PyTorch port of ``pose_refine_tpu/pipeline.py``).

``refine_poses`` is the body of the JAX package's ``refine_poses_jit`` for
the window lift and point-to-plane ICP, with its in-program uncertainty
(``with_information``); ``track_poses`` / ``track_poses_nn`` are
``track_poses_jit`` / ``track_poses_nn_jit``: the per-frame scene build on
the device followed by the refine. ``PoseRefiner`` is the refiner for
projective scenes and nearest-neighbour scenes (``scene="nn"`` /
``"nn_bruteforce"``, with ``scene_voxel_mm``, ``scene_cascade``,
``scene_stride`` and ``scene_pool``), with the same host-side planning (auto
ROI, auto lift sizes, warnings), ``refine``, ``track`` and their enqueueing
twins, and stacked scenes (``set_scene_depths`` + ``refine(scene_ids=)``).
``MultiModelRefiner`` refines hypotheses of several meshes in one batch.
Options the port does not carry yet raise ``NotImplementedError`` naming
the ROADMAP item that will carry them.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Optional, Union

import numpy as np
import torch

from pose_refine_tpu_torch import geometry, icp
from pose_refine_tpu_torch.device import DeviceLike, resolve_device, to_device
from pose_refine_tpu_torch.mesh import Model, morton_order, simplify_vertex_clustering
from pose_refine_tpu_torch.ops.depth_to_cloud import (
    compact_topk,
    morton_key,
    window_cloud_batched,
)
from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize, rasterize_plain
from pose_refine_tpu_torch.scene.nn import (
    SceneNN,
    SceneNNStack,
    _grid_morton_perm,
    voxel_downsample,
)
from pose_refine_tpu_torch.scene.projective import SceneProjective, SceneProjectiveStack

NN_SCENES = ("nn", "nn_kdtree", "nn_bruteforce")
STACKS = (SceneProjectiveStack, SceneNNStack)

logger = logging.getLogger("pose_refine_tpu_torch")


def refine_poses(tris, init_poses, scene: Union[SceneProjective, SceneNN, SceneProjectiveStack,
                                                SceneNNStack], proj, K, *,
                 width: int, height: int, max_points: int,
                 criteria: icp.ICPConvergenceCriteria, window: int = 256,
                 stride: int = 2, roi=(0, 0, 0, 0), with_information: bool = False,
                 scene_ids=None, raster: Optional[Callable] = None,
                 query: Optional[Callable] = None):
    """Render N poses, lift each render to a cloud, run batched ICP.

    All tensors on one device. ``tris`` is (T, 3, 3) or per pose (N, T, 3,
    3). Returns (refined_poses (N, 4, 4), RegistrationResult batch),
    refined = T_icp @ init with the ICP translation rescaled from meters to
    the pose's millimeters. with_information=True appends an
    icp.PoseUncertainty batch from one extra association pass at the final
    clouds (JAX pipeline.py:193-226). A stacked scene takes ``scene_ids``,
    an (N,) integer tensor of each pose's frame: every association pass is
    one batched ``scene.query_at(scene_ids)`` over all poses.
    ``raster`` replaces the rasterizer (default: ops.rasterize_cuda.rasterize,
    the kernel on CUDA tensors) and ``query`` the association. By default
    the ICP loop gets the scene's icp.Association (query + reduce, or
    query_at + reduce_at of scene_ids): on a card every pass is the fused
    kernel of ops/icp_reduce.py. A bare ``query`` callable handed in is
    queried and then reduced by matrix products on any device (the loop of
    before the fused kernel); ``icp.plain_association(plain_query)`` is the
    plain version of the default, which a kernel path is held against.
    """
    raster = rasterize if raster is None else raster
    if query is None and scene_ids is None:
        query = icp.Association(scene.query, scene.reduce)
    elif query is None:
        query = icp.Association(scene.query_at(scene_ids), scene.reduce_at(scene_ids))
    depth = raster(tris, init_poses, width, height, proj, roi=roi)
    out_h, out_w = depth.shape[1:]

    wh = -(-min(window, out_h) // stride)
    ww = -(-min(window, out_w) // stride)
    clouds, valids, _n = window_cloud_batched(
        depth, K, window=window, stride=stride, tl_x=roi[0], tl_y=roi[1]
    )
    # NN scenes take the clouds in morton order of the window grid, so the
    # flash kernel's query tiles are local patches its chunk pruning can
    # bound; projective association is an image gather, order-free
    nn_order = isinstance(scene, (SceneNN, SceneNNStack))
    if max_points < wh * ww:
        clouds, valids, _n = compact_topk(
            clouds, valids, max_points, order_shape=(wh, ww) if nn_order else None)
    elif nn_order:
        code = morton_key(torch.arange(wh * ww, device=clouds.device), wh, ww)
        perm = torch.argsort(code, stable=True)
        clouds, valids = clouds[:, perm], valids[:, perm]

    results, final = icp._icp_run(clouds, valids, query, criteria)
    # ICP acts on camera-space clouds in meters (common.h:53); poses carry
    # mm translations: scale t_icp to mm before left-composing
    T_mm = results.transformation.clone()
    T_mm[:, :3, 3] *= 1000.0
    refined = T_mm @ init_poses
    if not with_information:
        return refined, results
    info, sigma2, count = icp.pose_information(final, valids, query)
    # render-calibrated, not the pure Laplace (icp.RENDER_COV_INFLATION):
    # sigma2 is floored at the depth quantization and at the lateral pixel
    # pitch at the RENDER intrinsics, ~coeff * mean z / fx
    v = valids.to(torch.float32)
    mean_z = (final[..., 2].abs() * v).sum(dim=-1) / v.sum(dim=-1).clamp(min=1.0)
    lateral = icp.LATERAL_QUANT_COEFF * mean_z / K[0, 0]
    cov = icp.pose_covariance(info, sigma2, inflation=icp.RENDER_COV_INFLATION,
                              sigma2_floor=icp.DEPTH_QUANT_SIGMA_M ** 2 + lateral ** 2)
    return refined, results, icp.PoseUncertainty(info, sigma2, count, cov)


def _pack_track_outputs(refined, results: icp.RegistrationResult,
                        unc: icp.PoseUncertainty) -> torch.Tensor:
    """The (N, 71) session buffer [refined 16 | transformation 16 | fitness
    | rmse | n_points | cov 36] (JAX pipeline.py:1411-1433); a session reads
    one frame back in one copy. Host-side inverse:
    tracking._unpack_outputs."""
    n = refined.shape[0]
    return torch.cat([
        refined.reshape(n, 16),
        results.transformation.reshape(n, 16),
        results.fitness[:, None],
        results.inlier_rmse[:, None],
        results.n_points[:, None].to(torch.float32),
        unc.covariance.reshape(n, 36),
    ], dim=1)


def _refine_frame(scene, tris, init_poses, proj, K_render, pack_outputs: bool, plain: bool,
                  **kw):
    """The refine of one tracked frame against its freshly built scene;
    plain=True runs the kernels' plain versions (raster, NN, gather, the
    fused ICP pass)."""
    if plain:
        kw.update(raster=rasterize_plain,
                  query=icp.plain_association(functools.partial(scene.query, plain=True)))
    out = refine_poses(tris, init_poses, scene, proj, K_render, **kw)
    return _pack_track_outputs(*out) if pack_outputs else out


def track_poses(tris, init_poses, frame_depth, proj, K_render, K_full, max_dist: float, *,
                pack_outputs: bool = False, plain: bool = False, **kw):
    """One tracking step against a projective scene (JAX track_poses_jit):
    build the scene from the (H, W) mm ``frame_depth`` on its device, then
    refine. ``kw``: refine_poses' keywords (width, height, max_points,
    criteria, window, stride, roi, with_information). pack_outputs=True
    returns the (N, 71) session buffer instead."""
    scene = SceneProjective.from_depth(frame_depth, K_full, max_dist, device=frame_depth.device)
    return _refine_frame(scene, tris, init_poses, proj, K_render, pack_outputs, plain, **kw)


def track_poses_nn(tris, init_poses, frame_depth, proj, K_render, K_full, max_dist: float,
                   perm, *, scene_stride: int = 1, scene_pool: int = 1,
                   pack_outputs: bool = False, plain: bool = False, **kw):
    """One tracking step against an NN scene built on the device (JAX
    track_poses_nn_jit): SceneNN.from_depth_device with the grid's Morton
    permutation ``perm``, then refine (see track_poses)."""
    scene = SceneNN.from_depth_device(frame_depth, K_full, max_dist, stride=scene_stride,
                                      perm=perm, pool=scene_pool)
    return _refine_frame(scene, tris, init_poses, proj, K_render, pack_outputs, plain, **kw)


class PendingResult:
    """Outputs enqueued on the device's current stream, with a CUDA event
    recorded after the last of them (None on the CPU, where the work is
    done on return). ``wait()`` blocks on that event alone, not on the
    stream, whose later work may belong to the next enqueued frame, and
    returns the outputs."""

    __slots__ = ("outputs", "_event")

    def __init__(self, outputs: tuple, device: torch.device):
        self.outputs = outputs
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def wait(self) -> tuple:
        if self._event is not None:
            self._event.synchronize()
        return self.outputs


def _first(out):
    """Unbatch a tensor or a NamedTuple of tensors (None fields stay)."""
    if isinstance(out, tuple):
        return type(out)(*(None if f is None else f[0] for f in out))
    return out[0]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type == "cuda"


def _unported(name: str, value, default, item: str):
    if value != default:
        raise NotImplementedError(
            f"{name}={value!r} is not ported to pose_refine_tpu_torch yet "
            f"(ROADMAP {item})"
        )


class PoseRefiner:
    """Refine batches of pose hypotheses of one model against a scene depth
    (``scene="projective"``) or a scene cloud searched by exact nearest
    neighbour (``scene="nn"`` / ``"nn_bruteforce"``).

    Example:
        refiner = PoseRefiner("obj_06.ply", K=LINEMOD_K, device="cuda")
        refiner.set_scene_depth(observed_depth_mm)     # builds the scene once
        poses, results = refiner.refine(init_poses)    # (N,4,4) -> (N,4,4)
        best = poses[results.fitness.argmax()]

    Tracking (the scene rebuilt on the device from every frame):
        poses, results = refiner.track(frame_depth_mm, init_poses)
    """

    def __init__(
        self,
        model: Union[str, Model],
        K,
        width: int = 640,
        height: int = 480,
        scene: str = "projective",
        max_points: Union[int, str] = 32768,
        max_dist_diff: float = 0.1,
        lift: str = "window",
        window: Union[int, str] = 256,
        stride: int = 2,
        auto_roi: bool = True,
        roi_margin: float = 0.35,
        render_scale: int = 1,
        decimate_mm: float = 0.0,
        scene_voxel_mm: float = 0.0,
        scene_stride: int = 1,
        scene_pool="auto",
        scene_cascade=None,
        robust_delta: float = 0.0,
        coarse_iters: int = 0,
        estimation: str = "point_to_plane",
        devices=None,
        device: DeviceLike = None,
    ):
        if scene not in ("projective", *NN_SCENES):
            raise ValueError(
                f"unknown scene kind {scene!r}: expected 'projective', "
                "'nn', 'nn_kdtree' or 'nn_bruteforce'"
            )
        if scene == "nn_kdtree":  # the kd traversal
            _unported("scene", scene, "nn", "A9")
        self.scene_kind = scene
        if lift not in ("window", "compact"):
            raise ValueError(f"unknown lift {lift!r}: expected 'window' or 'compact'")
        _unported("lift", lift, "window", "A14")
        # scene_voxel_mm: voxel-downsample the NN scene cloud at build time
        # (exact-NN cost is O(queries x scene)); no effect on projective scenes
        self.scene_voxel_mm = float(scene_voxel_mm)
        # the device-built NN scene of track(): scene_stride subsamples its
        # pixel grid; scene_pool centroid-pools it ("auto": derived once from
        # scene_voxel_mm and the first tracked frame, _resolve_scene_pool)
        self.scene_stride = int(scene_stride)
        if scene_pool != "auto" and int(scene_pool) < 1:
            raise ValueError(f"scene_pool must be >= 1, got {scene_pool}")
        if scene_pool != "auto" and int(scene_pool) > 1 and self.scene_stride > 1:
            raise ValueError(
                f"scene_pool ({scene_pool}) and scene_stride ({self.scene_stride}) are "
                "alternative NN-scene downsamplers - set at most one of them > 1")
        self.scene_pool = scene_pool if scene_pool == "auto" else int(scene_pool)
        self._scene_pool_cache = None
        self._scene_pool_warned = False
        self._scene_perm_cache = None  # (grid shape, Morton permutation on the device)
        # scene_cascade=(coarse_voxel_mm, coarse_iters): refine() first runs
        # coarse_iters against a coarse_voxel_mm-voxelized twin of the NN
        # scene, then the caller's criteria against the full-resolution scene
        if scene_cascade is not None:
            if scene not in NN_SCENES:
                raise ValueError(
                    "scene_cascade is an NN-scene feature (exact-NN cost "
                    "scales with scene size; the projective gather is "
                    f"size-free) - scene={scene!r} does not support it"
                )
            cv, ci = scene_cascade
            if float(cv) <= 0.0 or int(ci) < 1:
                raise ValueError(
                    f"scene_cascade wants (coarse_voxel_mm > 0, "
                    f"coarse_iters >= 1), got {scene_cascade!r}")
            if float(scene_voxel_mm) > 0.0 and float(cv) <= float(scene_voxel_mm):
                raise ValueError(
                    f"scene_cascade coarse voxel ({cv} mm) must be coarser "
                    f"than scene_voxel_mm ({scene_voxel_mm} mm) - otherwise "
                    "the coarse pass is the fine pass")
            scene_cascade = (float(cv), int(ci))
        self.scene_cascade = scene_cascade
        self._scene_coarse = None
        _unported("robust_delta", float(robust_delta), 0.0, "A14")
        _unported("coarse_iters", int(coarse_iters), 0, "A14")
        if estimation not in ("point_to_plane", "point_to_point"):
            raise ValueError(
                f"estimation must be 'point_to_plane' or 'point_to_point', "
                f"got {estimation!r}"
            )
        _unported("estimation", estimation, "point_to_plane", "A14")
        _unported("devices", devices, None, "A13")
        self.device = resolve_device(device)

        self.model = Model.load(model) if isinstance(model, str) else model
        # decimate_mm: vertex-cluster the HYPOTHESIS render mesh (the
        # observed scene is untouched); self.model keeps the original mesh
        self.decimate_mm = float(decimate_mm)
        render_model = self.model
        if self.decimate_mm > 0.0:
            render_model = simplify_vertex_clustering(self.model, self.decimate_mm)
            logger.info(
                "render mesh decimated: %d -> %d tris (%.1f mm cells)",
                self.model.tris.shape[0], render_model.tris.shape[0], self.decimate_mm,
            )
        self.tris = torch.as_tensor(
            render_model.tris[morton_order(render_model.tris)], device=self.device
        )
        self.K = np.asarray(K, np.float32)
        self.width, self.height = int(width), int(height)
        # render_scale: render hypotheses at width/s x height/s; the NDC
        # projection is scale-invariant, so only the raster size and the
        # lift intrinsics change; the observed scene keeps full resolution.
        # window/stride/roi are in RENDER pixels.
        self.render_scale = int(render_scale)
        self.render_w = self.width // self.render_scale
        self.render_h = self.height // self.render_scale
        self.K_render = self.K.copy()
        self.K_render[:2] /= self.render_scale
        if width % self.render_scale or height % self.render_scale:
            # non-divisible scales: floor the render dims and build the
            # projection from the scaled intrinsics so raster and lift agree
            proj = geometry.compute_proj(self.K_render, self.render_w, self.render_h)
            logger.info(
                "render_scale %d does not divide %dx%d: rendering %dx%d "
                "(right/bottom fringe cropped from hypothesis renders)",
                self.render_scale, width, height, self.render_w, self.render_h,
            )
        else:
            proj = geometry.compute_proj(self.K, self.width, self.height)
        self.proj = proj.to(self.device)
        self._K_render_t = torch.as_tensor(self.K_render, device=self.device)
        self._K_t = torch.as_tensor(self.K, device=self.device)
        # window="auto" / max_points="auto": sized from the observed object
        # at set_scene_depth time (see _lift_targets)
        self._auto_window = window == "auto"
        self._auto_points = max_points == "auto"
        self.max_points = 0 if self._auto_points else int(max_points)
        self.max_dist_diff = float(max_dist_diff)
        self.scene = None
        self.window = (
            0 if self._auto_window else int(min(window, self.render_w, self.render_h))
        )
        self.stride = int(stride)
        self.auto_roi = bool(auto_roi)
        self._obj_extent_px = 0
        self.roi_margin = float(roi_margin)
        self.roi = (0, 0, 0, 0)
        # one deferred lift-saturation check per frame (_warn_if_saturated);
        # _suppress_saturation parks it during enqueues without consuming it
        self._check_saturation = False
        self._suppress_saturation = False
        # set once a frame's host planning has run: device-resident track()
        # frames reuse the standing plan after that (_prepare_frame)
        self._frame_planned = False

    def _resolve_scene_pool(self, frame_depth) -> int:
        """scene_pool="auto": the centroid-pooling factor that matches
        scene_voxel_mm at this sensor's scale, derived once from the first
        tracked frame's median object depth (pixel pitch z / fx), capped at
        8 (JAX pipeline.py:538-591). A frame on the card would cost a
        readback: it keeps the full-resolution build, says so once, and
        caches nothing, so a later host frame can still derive the factor."""
        if self.scene_pool != "auto":
            return self.scene_pool
        if self._scene_pool_cache is not None:
            return self._scene_pool_cache
        pool = 1
        if self.scene_voxel_mm > 0.0 and self.scene_stride == 1:
            if _on_card(frame_depth):
                if not self._scene_pool_warned:
                    self._scene_pool_warned = True
                    logger.warning(
                        "track(): scene_voxel_mm=%g set but the frame is on the card - "
                        "cannot derive the pooling factor without a readback; pass "
                        "scene_pool=<int> (e.g. 4 for a 2 mm voxel at 0.3 m) to "
                        "downsample the device-built scene.", self.scene_voxel_mm)
                return pool
            frame = _host(frame_depth)
            d = frame[frame > 0]
            if not d.size:
                logger.warning(
                    "track(): frame has no valid depth - scene_pool derivation deferred "
                    "to the next frame with data (this frame builds the scene at full "
                    "resolution)")
                return pool
            z_med = float(np.median(d)) / 1000.0
            pool = int(round(self.scene_voxel_mm / 1000.0 / (z_med / float(self.K[0, 0]))))
            pool = max(1, min(pool, 8))
            logger.info("track(): scene_voxel_mm=%g mapped to on-device centroid pool=%d "
                        "(median depth %.0f mm)", self.scene_voxel_mm, pool, z_med * 1000.0)
        self._scene_pool_cache = pool
        return pool

    def _scene_perm(self, frame_shape, pool: int = 1) -> torch.Tensor:
        """The Morton permutation of the strided or pooled scene grid on the
        device, cached per grid shape: the NN tracking loop passes it every
        frame."""
        fh, fw = frame_shape
        s = self.scene_stride
        key = (-(-fh // s), -(-fw // s))
        if pool > 1:
            key = (-(-key[0] // pool), -(-key[1] // pool))
        if self._scene_perm_cache is None or self._scene_perm_cache[0] != key:
            perm = torch.as_tensor(_grid_morton_perm(*key), device=self.device)
            self._scene_perm_cache = (key, perm)
        return self._scene_perm_cache[1]

    def _warn_if_saturated(self, results: icp.RegistrationResult):
        """No-silent-caps guard on the hypothesis side: a hypothesis that
        renders much larger than the observed object can fill the
        max_points budget and drop boundary points. Checked once per frame
        (one readback of the per-pose counts), never during an enqueue."""
        if self._suppress_saturation or not self._check_saturation \
                or results.n_points is None:
            return
        self._warn_if_saturated_host(_host(results.n_points))

    def _warn_if_saturated_host(self, n_points_np):
        """The same guard fed host-side counts: a tracking session reads them
        from its packed buffer's n_points column, with no extra readback."""
        if self._suppress_saturation or not self._check_saturation:
            return
        self._check_saturation = False
        peak = int(np.max(n_points_np))
        if self.max_points and peak >= self.max_points:
            logger.warning(
                "lift budget saturated: a hypothesis filled all %d cloud "
                "points - boundary points were likely dropped. Enlarge "
                "max_points (or use max_points='auto' with a margin).",
                self.max_points,
            )

    def _object_stats(self, scene_depth):
        """ONE host scan of the depth image: (ys, xs) of the object pixels,
        shared by ROI planning and auto lift tuning."""
        return np.nonzero(np.asarray(scene_depth) > 0)

    def _compute_roi(self, stats):
        """Crop-while-rendering window around the observed object (the
        reference's ROI, renderer.h:199-202, made automatic), in RENDER
        pixels: width a multiple of 128, height a multiple of 8."""
        ys, xs = stats
        if len(xs) == 0:
            self._obj_extent_px = 0
            return (0, 0, 0, 0)
        s = self.render_scale
        self._obj_extent_px = int(max(xs.max() - xs.min(), ys.max() - ys.min())) // s
        rw, rh = self.render_w, self.render_h
        mx = int(self.roi_margin * self._obj_extent_px) + 16
        x0 = max(int(xs.min()) // s - mx, 0)
        y0 = max(int(ys.min()) // s - mx, 0)
        x1 = min(int(xs.max()) // s + mx, rw)
        y1 = min(int(ys.max()) // s + mx, rh)
        w = min(-(-(x1 - x0) // 128) * 128, rw)
        h = min(-(-(y1 - y0) // 8) * 8, rh)
        x0 = min(x0, rw - w)
        y0 = min(y0, rh - h)
        return (x0, y0, w, h)

    def _lift_targets(self, stats, window=None):
        """(window, max_points) the auto formulas pick for this frame;
        non-auto knobs keep their configured values. ``window`` overrides
        the window used for the max_points candidate bound."""
        ys, xs = stats
        s = self.render_scale
        if len(xs) == 0:
            return (
                self.window or min(256, self.render_w, self.render_h),
                self.max_points or 4096,
            )
        extent = int(max(xs.max() - xs.min(), ys.max() - ys.min())) // s
        if window is None:
            window = self.window
            if self._auto_window:
                w = -(-int(extent * 1.15) // 32) * 32
                window = int(np.clip(w, 32, min(self.render_w, self.render_h)))
        max_points = self.max_points
        if self._auto_points:
            # the window lift strides; budget = strided object pixels
            n_obj = len(xs) // (s * s * self.stride * self.stride)
            cand = (-(-window // self.stride)) ** 2
            mp = min(-(-int(n_obj * 1.3) // 256) * 256, cand)
            max_points = int(max(mp, 256))
        return window, max_points

    def _tune_lift(self, stats):
        """Apply the auto lift sizes with per-knob hysteresis: each knob
        grows immediately but shrinks only past one quantum (32 px / 256
        points), independently of the other."""
        w_t, _ = self._lift_targets(stats)
        if not self.window or w_t > self.window or w_t < self.window - 32:
            new_w = w_t
        else:
            new_w = self.window
        _, mp_t = self._lift_targets(stats, window=new_w)
        if not self.max_points or mp_t > self.max_points or mp_t < self.max_points - 256:
            new_mp = mp_t
        else:
            new_mp = self.max_points
        if (new_w, new_mp) == (self.window, self.max_points):
            return
        self.window, self.max_points = new_w, new_mp
        logger.info("auto lift: window=%d, max_points=%d", self.window, self.max_points)

    def _roi_still_fits(self, stats) -> bool:
        """ROI hysteresis: keep the previous crop while the object still
        sits a guard margin inside it."""
        if self.roi == (0, 0, 0, 0):
            return False
        ys, xs = stats
        if len(xs) == 0:
            return True
        s = self.render_scale
        x0, y0, w, h = self.roi
        extent = int(max(xs.max() - xs.min(), ys.max() - ys.min())) // s
        guard = max(12, (int(self.roi_margin * extent) + 16) // 2)
        return (
            int(xs.min()) // s - guard >= x0
            and int(ys.min()) // s - guard >= y0
            and int(xs.max()) // s + guard <= x0 + w
            and int(ys.max()) // s + guard <= y0 + h
        )

    def _prepare_frame(self, scene_depth, allow_device_skip: bool = False):
        """Per-frame host-side planning: unit sanity, auto lift sizing, ROI
        hysteresis/re-crop, and the no-silent-caps window warning.

        Host frames (numpy, CPU tensors) always plan. A frame on the card
        would pay a full-frame readback, which waits for the card's queued
        work and so serialises track_async's double-buffered loop: on the
        tracking path (allow_device_skip=True) such frames reuse the
        standing plan once one frame has been planned, as the JAX package
        does (pipeline.py:849; ROADMAP C, "stale plans")."""
        if allow_device_skip and self._frame_planned and _on_card(scene_depth):
            self._check_saturation = True
            return
        scene_depth = _host(scene_depth)
        d_max = float(np.max(scene_depth))
        if 0.0 < d_max <= 50.0:
            # a depth image whose farthest point is 5 cm is almost certainly
            # in METERS; everything here is mm
            logger.warning(
                "scene depth max is %.2f - values look like meters; this "
                "pipeline expects millimeters (uint16/int32 mm)", d_max,
            )
        self._check_saturation = True
        stats = self._object_stats(scene_depth)
        ys, xs = stats
        if len(xs):  # extent drives the crop warning, with or without auto_roi
            self._obj_extent_px = int(
                max(xs.max() - xs.min(), ys.max() - ys.min())
            ) // self.render_scale
        if self._auto_window or self._auto_points:
            self._tune_lift(stats)
        if self.auto_roi and not self._roi_still_fits(stats):
            self.roi = self._compute_roi(stats)
            logger.info("auto ROI (x, y, w, h) = %s (render px)", self.roi)
        # the window lift crops a window x window region around the rendered
        # object; a larger object loses boundary points without this check
        if self._obj_extent_px > self.window:
            logger.warning(
                "object extent ~%d render px exceeds the window lift "
                "crop of %d px: boundary points will be cropped. "
                "Enlarge window= or use lift='compact'.",
                self._obj_extent_px, self.window,
            )
        self._frame_planned = True

    def set_scene_depth(self, scene_depth):
        """Build the association structure from an (H, W) mm depth image
        (numpy or tensor). Happens once per frame, not per ICP iteration."""
        host = _host(scene_depth)
        self._prepare_frame(host)
        if self.scene_kind == "projective":
            self.scene = SceneProjective.from_depth(
                host, self.K, self.max_dist_diff, device=self.device
            )
        else:
            # "nn" and "nn_bruteforce" both take the gated flash kernel on
            # every device; the JAX package picks its kd traversal for "nn"
            # on its CPU, which is not ported yet (ROADMAP A9)
            self.scene = SceneNN.from_depth(
                host, self.K, self.max_dist_diff, voxel_mm=self.scene_voxel_mm,
                device=self.device,
            )
            if self.scene_cascade is not None:
                self._scene_coarse = SceneNN.from_depth(
                    host, self.K, self.max_dist_diff, voxel_mm=self.scene_cascade[0],
                    device=self.device,
                )
        logger.info("scene built: kind=%s, %s", self.scene_kind, type(self.scene).__name__)
        return self

    def set_scene_depths(self, scene_depths):
        """Build one stacked scene from (K, H, W) mm depth frames, so that
        one refine() routes each hypothesis to its own frame through
        ``scene_ids`` (JAX pipeline.py:917-964): a SceneProjectiveStack, or
        a SceneNNStack for the NN kinds (with scene_voxel_mm). Planning
        (auto ROI, window, points) uses the union of the frames' objects,
        their max-projection, so every frame's object stays in the crop."""
        if self.scene_cascade is not None and self.scene_kind != "projective":
            raise ValueError(
                "scene_cascade is per-frame (a coarse voxel twin); it does not compose with "
                "stacked NN scenes - drop one of the two")
        frames = _host(scene_depths)
        if frames.ndim != 3 or frames.shape[0] < 1:
            raise ValueError(f"set_scene_depths wants (K, H, W) frames, got {frames.shape}")
        self._prepare_frame(frames.max(axis=0))
        if self.scene_kind == "projective":
            self.scene = SceneProjectiveStack.from_depths(frames, self.K, self.max_dist_diff,
                                                          device=self.device)
        else:
            self.scene = SceneNNStack.from_depths(frames, self.K, self.max_dist_diff,
                                                  voxel_mm=self.scene_voxel_mm,
                                                  device=self.device)
        self._scene_coarse = None
        logger.info("scene built: kind=%s x%d frames (stacked)", self.scene_kind,
                    self.scene.n_scenes)
        return self

    def set_scene_cloud(self, points, normals):
        """NN scene directly from (P, 3) points and normals in meters
        (numpy or tensors), with the refiner's scene_voxel_mm and
        scene_cascade."""
        if self._auto_window or self._auto_points:
            # auto lift sizes come from an observed DEPTH image; a bare
            # cloud gives no object extent to tune from
            raise ValueError(
                "window='auto'/max_points='auto' require set_scene_depth; "
                "pass explicit window/max_points to use set_scene_cloud"
            )
        points, normals = (
            x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (points, normals)
        )
        if self.scene_voxel_mm > 0.0:
            points, normals = voxel_downsample(points, normals, self.scene_voxel_mm / 1000.0)
        self.scene = SceneNN.from_cloud(points, normals, self.max_dist_diff, device=self.device)
        if self.scene_cascade is not None:
            cp, cn = voxel_downsample(points, normals, self.scene_cascade[0] / 1000.0)
            self._scene_coarse = SceneNN.from_cloud(cp, cn, self.max_dist_diff,
                                                    device=self.device)
        self._check_saturation = True
        return self

    def _scene_ids(self, scene, scene_ids, n_poses: int):
        """Validate refine()'s scene_ids against the scene (JAX
        pipeline.py:1055-1092): an (N,) int32 tensor on the refiner's
        device for a stacked scene, None otherwise. Host ids are
        range-checked; ids on the card are checked by shape only (a
        readback would wait for the card) and clamped in query_at."""
        if not isinstance(scene, STACKS):
            if scene_ids is not None:
                raise ValueError(
                    "scene_ids is only valid with a stacked multi-frame scene "
                    "(set_scene_depths); this refiner holds a single scene")
            return None
        if scene_ids is None:
            raise ValueError(
                "the scene is a stacked multi-frame table (set_scene_depths): refine() "
                "needs scene_ids - one frame index per hypothesis")
        if not _on_card(scene_ids):
            ids = np.asarray(_host(scene_ids)).astype(np.int32)
            if ids.size and (ids.min() < 0 or ids.max() >= scene.n_scenes):
                raise ValueError(f"scene_ids must be in [0, {scene.n_scenes}), got "
                                 f"[{ids.min()}, {ids.max()}]")
            scene_ids = ids
        if tuple(scene_ids.shape) not in ((), (n_poses,)):
            raise ValueError(f"scene_ids shape {tuple(scene_ids.shape)} does not match the "
                             f"{n_poses}-pose batch")
        ids = to_device(scene_ids, self.device, torch.int32)
        return ids.expand(n_poses).contiguous()

    def refine(self, init_poses,
               criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria(),
               schedule=None, with_covariance: bool = False, scene_ids=None,
               _scene=None):
        """(N, 4, 4) or (4, 4) hypotheses -> (refined poses, RegistrationResult),
        tensors on the refiner's device; with_covariance=True appends an
        icp.PoseUncertainty batch (render-calibrated Laplace covariance,
        twist [omega, t] in [rad, m]).

        scene_ids: required after :meth:`set_scene_depths` - the frame index
        of each hypothesis, (N,) (or one for all), routing every pose to its
        own frame within the one batch. Host ids are range-checked; ids on
        the card are checked by shape only, and an out-of-range one clamps
        to the nearest frame (it associates against frame 0 or K - 1).

        With ``scene_cascade=(coarse_voxel_mm, coarse_iters)`` a coarse
        pre-pass of coarse_iters iterations against the voxelized twin of
        the scene runs first; ``criteria`` then governs the full-resolution
        pass, which alone computes the covariance. ``_scene`` (internal)
        refines against that scene instead of the refiner's, with no
        pre-pass."""
        return self._refine(self.tris, init_poses, criteria, schedule, with_covariance,
                            scene_ids, _scene)

    def _refine(self, tris, init_poses, criteria=icp.ICPConvergenceCriteria(), schedule=None,
                with_covariance: bool = False, scene_ids=None, _scene=None):
        """refine() rendering ``tris``: the refiner's (T, 3, 3) mesh, or
        MultiModelRefiner's (N, T, 3, 3) per-pose tables."""
        _unported("schedule", schedule, None, "A14")
        scene = self.scene if _scene is None else _scene
        if scene is None:  # usage error: must survive python -O
            raise RuntimeError("set_scene_depth / set_scene_cloud first")
        init = to_device(init_poses, self.device, torch.float32)
        if tuple(init.shape[-2:]) != (4, 4) or init.dim() not in (2, 3):
            raise ValueError(
                f"init_poses must be (4, 4) or (N, 4, 4) model->camera transforms, "
                f"got {tuple(init.shape)}"
            )
        squeeze = init.dim() == 2
        if squeeze:
            init = init[None]
        ids = self._scene_ids(scene, scene_ids, init.shape[0])
        if self._scene_coarse is not None and _scene is None:
            coarse = icp.ICPConvergenceCriteria(
                criteria.relative_fitness, criteria.relative_rmse, self.scene_cascade[1])
            init, _ = self._refine(tris, init, coarse, _scene=self._scene_coarse)
        out = refine_poses(
            tris, init, scene, self.proj, self._K_render_t,
            width=self.render_w, height=self.render_h,
            max_points=self.max_points, criteria=criteria,
            window=self.window, stride=self.stride, roi=self.roi,
            with_information=with_covariance, scene_ids=ids,
        )
        self._warn_if_saturated(out[1])
        return tuple(map(_first, out)) if squeeze else out

    def _enqueue(self, fn, *args, **kwargs) -> PendingResult:
        """fn(*args, **kwargs) (refine or track) without a host
        synchronisation: the once-per-frame saturation readback is parked,
        not consumed, for the next synchronous call."""
        self._suppress_saturation = True
        try:
            out = fn(*args, **kwargs)
        finally:
            self._suppress_saturation = False
        return PendingResult(out, self.device)

    def refine_async(self, *args, **kwargs) -> PendingResult:
        """refine() enqueued: returns a PendingResult (see _enqueue)."""
        return self._enqueue(self.refine, *args, **kwargs)

    def track(self, frame_depth, init_poses,
              criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria(),
              with_covariance: bool = False, _pack_outputs: bool = False,
              _plain: bool = False):
        """One tracking step: rebuild the scene from this (H, W) mm frame on
        the device and refine the (N, 4, 4) or (4, 4) hypotheses against it
        (JAX pipeline.py:1229-1363). Projective scenes build the (H*W, 8)
        table; NN scenes ('nn' / 'nn_bruteforce') the device-built flash
        scene of SceneNN.from_depth_device, with scene_stride / scene_pool.
        Does not touch self.scene. Returns (refined, RegistrationResult),
        plus an icp.PoseUncertainty batch with with_covariance=True.

        ``_pack_outputs`` (sessions) returns the (N, 71) session buffer
        instead; ``_plain`` runs the kernels' plain versions (raster, NN,
        gather, the fused ICP pass), the reference a kernel path is held against."""
        return self._track(self.tris, frame_depth, init_poses, criteria, with_covariance,
                           _pack_outputs, _plain)

    def _track(self, tris, frame_depth, init_poses, criteria=icp.ICPConvergenceCriteria(),
               with_covariance: bool = False, _pack_outputs: bool = False,
               _plain: bool = False):
        """track() rendering ``tris`` (see _refine)."""
        if self.scene_cascade is not None:
            raise ValueError(
                "scene_cascade applies to set_scene_depth/set_scene_cloud + refine (it "
                "builds a coarse voxelized twin of a FIXED scene); track() builds its "
                "scene per frame - use scene_stride or scene_pool for coarse tracking scenes")
        init_shape = tuple(np.shape(init_poses))
        if init_shape[-2:] != (4, 4) or len(init_shape) not in (2, 3):
            raise ValueError(
                f"init_poses must be (4, 4) or (N, 4, 4) model->camera transforms, "
                f"got {init_shape}")
        frame_shape = tuple(np.shape(frame_depth))
        if len(frame_shape) != 2:
            raise ValueError(f"frame_depth must be an (H, W) mm depth image, got {frame_shape}")
        squeeze = len(init_shape) == 2
        if _pack_outputs and (not with_covariance or squeeze):
            # the buffer embeds the covariance and is batch-shaped
            raise ValueError(
                "_pack_outputs needs with_covariance=True and a batched (N, 4, 4) init_poses")
        self._prepare_frame(frame_depth, allow_device_skip=True)
        init = to_device(init_poses, self.device, torch.float32)
        if squeeze:
            init = init[None]
        frame = to_device(frame_depth, self.device)
        kw = dict(width=self.render_w, height=self.render_h, max_points=self.max_points,
                  criteria=criteria, window=self.window, stride=self.stride, roi=self.roi,
                  with_information=with_covariance, pack_outputs=_pack_outputs, plain=_plain)
        args = (tris, init, frame, self.proj, self._K_render_t, self._K_t, self.max_dist_diff)
        if self.scene_kind == "projective":
            out = track_poses(*args, **kw)
        else:
            pool = self._resolve_scene_pool(frame_depth)
            out = track_poses_nn(*args, self._scene_perm(frame_shape, pool),
                                 scene_stride=self.scene_stride, scene_pool=pool, **kw)
        if _pack_outputs:
            # the session checks saturation from the buffer's n_points column
            return out
        self._warn_if_saturated(out[1])
        if squeeze:
            out = tuple(map(_first, out))
        return out if with_covariance else (out[0], out[1])

    def track_async(self, *args, **kwargs) -> PendingResult:
        """track() enqueued: returns a PendingResult, so a loop can enqueue
        frame k+1 before it waits for frame k (see _enqueue)."""
        return self._enqueue(self.track, *args, **kwargs)

    def track_packed_async(self, frame_depth, init_poses,
                           criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria()
                           ) -> PendingResult:
        """track_async for session loops: the frame's (N, 71) session buffer
        (with_covariance implied) is copied to pinned host memory behind the
        frame's work, so ``wait()`` blocks only until that copy lands and
        returns (host buffer,)."""
        return self._pin(self.track(frame_depth, init_poses, criteria, with_covariance=True,
                                    _pack_outputs=True))

    def _pin(self, packed) -> PendingResult:
        """A PendingResult of a card buffer copied to pinned host memory
        behind the work that writes it (a host buffer as it is)."""
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            packed = host
        return PendingResult((packed,), self.device)

    @staticmethod
    def rank(results: icp.RegistrationResult):
        """Hypothesis re-ranking: best-first indices by (fitness, -rmse)
        (icp.h:26-36); tensors or host arrays."""
        return np.lexsort((_host(results.inlier_rmse), -_host(results.fitness)))


class MultiModelRefiner(PoseRefiner):
    """Refine hypotheses of several models against one scene in one batch
    (JAX pipeline.py:1513-1611). Each model is decimated (decimate_mm),
    Morton-ordered and padded with zero-area triangles at its first vertex
    to the largest triangle count; the (M, T, 3, 3) table stays on the
    device, and refine()/track() gather each pose's model by id into the
    (N, T, 3, 3) per-pose table the raster kernel takes. A padding triangle
    has zero area, gets an empty box in triangle_setup and covers no pixel.

    Memory: the per-pose table is N x T x 36 bytes (256 hypotheses of a
    31k-triangle mesh ~ 290 MB): decimate heavy meshes or split the batch.

    Example:
        refiner = MultiModelRefiner([model_a, model_b], K=K, device="cuda")
        refiner.set_scene_depth(depth)
        refined, res = refiner.refine([0, 0, 1, 1], poses)
    """

    def __init__(self, models, K, **kwargs):
        models = [Model.load(m) if isinstance(m, str) else m for m in models]
        if not models:
            raise ValueError("MultiModelRefiner needs at least one model")
        super().__init__(models[0], K, **kwargs)
        self.models = models
        tables = []
        for m in models:
            rm = simplify_vertex_clustering(m, self.decimate_mm) if self.decimate_mm > 0.0 else m
            tables.append(rm.tris[morton_order(rm.tris)])
        tmax = max(t.shape[0] for t in tables)
        padded = [np.concatenate([t, np.broadcast_to(t[:1, :1, :], (tmax - len(t), 3, 3))])
                  for t in tables]
        self.tris_table = torch.as_tensor(np.stack(padded), device=self.device)  # (M, T, 3, 3)

    def _per_pose_tris(self, model_ids, init_poses):
        """Validate (model_ids, poses) and gather the per-pose triangle
        tables: (tris (N, T, 3, 3), poses (N, 4, 4), squeeze). Ids are read
        on the host (a card tensor is read back) and range-checked."""
        ids = np.asarray(_host(model_ids), np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= len(self.models)):
            raise ValueError(f"model_ids must be in [0, {len(self.models)}), got "
                             f"[{ids.min()}, {ids.max()}]")
        poses = to_device(init_poses, self.device, torch.float32)
        squeeze = poses.dim() == 2
        if squeeze:
            poses = poses[None]
        if poses.shape[0] != ids.shape[0]:
            raise ValueError(f"{ids.shape[0]} model ids for {poses.shape[0]} poses")
        tris = self.tris_table.index_select(0, to_device(ids, self.device))
        return tris, poses, squeeze

    def refine(self, model_ids, init_poses=None, **kwargs):
        """(model_ids (N,), init_poses (N, 4, 4)) -> refine()'s outputs; a
        scalar id with one (4, 4) pose returns unbatched results."""
        if init_poses is None:
            raise TypeError("MultiModelRefiner.refine(model_ids, init_poses)")
        tris, poses, squeeze = self._per_pose_tris(model_ids, init_poses)
        out = self._refine(tris, poses, **kwargs)
        return tuple(map(_first, out)) if squeeze else out

    def track(self, frame_depth, model_ids, init_poses=None, **kwargs):
        """track() with per-pose models: (frame_depth, model_ids (N,),
        init_poses (N, 4, 4))."""
        if init_poses is None:
            raise TypeError("MultiModelRefiner.track(frame_depth, model_ids, init_poses)")
        tris, poses, squeeze = self._per_pose_tris(model_ids, init_poses)
        out = self._track(tris, frame_depth, poses, **kwargs)
        return tuple(map(_first, out)) if squeeze else out

    def track_packed_async(self, frame_depth, model_ids, init_poses,
                           criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria()
                           ) -> PendingResult:
        """PoseRefiner.track_packed_async with per-pose models."""
        return self._pin(self.track(frame_depth, model_ids, init_poses, criteria=criteria,
                                    with_covariance=True, _pack_outputs=True))
