"""End-to-end batched pose refinement: render -> lift -> associate -> solve
(PyTorch port of the projective path of ``pose_refine_tpu/pipeline.py``).

``refine_poses`` is the body of the JAX package's ``refine_poses_jit`` for
the window lift and point-to-plane ICP; ``PoseRefiner`` is its refiner for
``scene="projective"``, with the same host-side planning (auto ROI, auto
lift sizes, warnings). Options the port does not carry yet raise
``NotImplementedError`` naming the ROADMAP item that will carry them.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Union

import numpy as np
import torch

from pose_refine_tpu_torch import geometry, icp
from pose_refine_tpu_torch.device import DeviceLike, resolve_device
from pose_refine_tpu_torch.mesh import Model, morton_order, simplify_vertex_clustering
from pose_refine_tpu_torch.ops.depth_to_cloud import compact_topk, window_cloud_batched
from pose_refine_tpu_torch.ops.rasterize_cuda import rasterize
from pose_refine_tpu_torch.scene.projective import SceneProjective

logger = logging.getLogger("pose_refine_tpu_torch")


def refine_poses(tris, init_poses, scene: SceneProjective, proj, K, *,
                 width: int, height: int, max_points: int,
                 criteria: icp.ICPConvergenceCriteria, window: int = 256,
                 stride: int = 2, roi=(0, 0, 0, 0),
                 raster: Optional[Callable] = None):
    """Render N poses, lift each render to a cloud, run batched ICP.

    All tensors on one device. Returns (refined_poses (N, 4, 4),
    RegistrationResult batch), refined = T_icp @ init with the ICP
    translation rescaled from meters to the pose's millimeters.
    ``raster`` replaces the rasterizer (default: ops.rasterize_cuda.rasterize,
    the kernel on CUDA tensors); chip_smoke.py passes the plain version to
    hold the kernel path against it.
    """
    raster = rasterize if raster is None else raster
    depth = raster(tris, init_poses, width, height, proj, roi=roi)
    out_h, out_w = depth.shape[1:]

    wh = -(-min(window, out_h) // stride)
    ww = -(-min(window, out_w) // stride)
    clouds, valids, _n = window_cloud_batched(
        depth, K, window=window, stride=stride, tl_x=roi[0], tl_y=roi[1]
    )
    if max_points < wh * ww:
        # projective association is an image gather: point order does not
        # matter, so no morton reorder (order_shape=None)
        clouds, valids, _n = compact_topk(clouds, valids, max_points)

    results, _clouds = icp._icp_run(clouds, valids, scene.query, criteria)
    # ICP acts on camera-space clouds in meters (common.h:53); poses carry
    # mm translations: scale t_icp to mm before left-composing
    T_mm = results.transformation.clone()
    T_mm[:, :3, 3] *= 1000.0
    return T_mm @ init_poses, results


def _unported(name: str, value, default, item: str):
    if value != default:
        raise NotImplementedError(
            f"{name}={value!r} is not ported to pose_refine_tpu_torch yet "
            f"(ROADMAP {item})"
        )


class PoseRefiner:
    """Refine batches of pose hypotheses of one model against a scene depth.

    Example:
        refiner = PoseRefiner("obj_06.ply", K=LINEMOD_K, device="cuda")
        refiner.set_scene_depth(observed_depth_mm)     # builds the scene once
        poses, results = refiner.refine(init_poses)    # (N,4,4) -> (N,4,4)
        best = poses[results.fitness.argmax()]
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
        scene_cascade=None,
        robust_delta: float = 0.0,
        coarse_iters: int = 0,
        estimation: str = "point_to_plane",
        devices=None,
        device: DeviceLike = None,
    ):
        if scene in ("nn", "nn_kdtree", "nn_bruteforce"):
            _unported("scene", scene, "projective", "A9")
        if scene != "projective":
            raise ValueError(
                f"unknown scene kind {scene!r}: expected 'projective', "
                "'nn', 'nn_kdtree' or 'nn_bruteforce'"
            )
        if lift not in ("window", "compact"):
            raise ValueError(f"unknown lift {lift!r}: expected 'window' or 'compact'")
        _unported("lift", lift, "window", "A14")
        _unported("scene_voxel_mm", float(scene_voxel_mm), 0.0, "A9")
        _unported("scene_cascade", scene_cascade, None, "A9")
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
        # one deferred lift-saturation check per frame (_warn_if_saturated)
        self._check_saturation = False

    def _warn_if_saturated(self, results: icp.RegistrationResult):
        """No-silent-caps guard on the hypothesis side: a hypothesis that
        renders much larger than the observed object can fill the
        max_points budget and drop boundary points. Checked once per frame
        (one readback of the per-pose counts)."""
        if not self._check_saturation or results.n_points is None:
            return
        self._check_saturation = False
        peak = int(results.n_points.max())
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

    def _prepare_frame(self, scene_depth):
        """Per-frame host-side planning: unit sanity, auto lift sizing, ROI
        hysteresis/re-crop, and the no-silent-caps window warning."""
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

    def set_scene_depth(self, scene_depth):
        """Build the association structure from an (H, W) mm depth image
        (numpy or tensor). Happens once per frame, not per ICP iteration."""
        host = (scene_depth.cpu().numpy() if isinstance(scene_depth, torch.Tensor)
                else np.asarray(scene_depth))
        self._prepare_frame(host)
        self.scene = SceneProjective.from_depth(
            host, self.K, self.max_dist_diff, device=self.device
        )
        logger.info("scene built: projective %dx%d", self.scene.width, self.scene.height)
        return self

    def refine(self, init_poses,
               criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria(),
               schedule=None, with_covariance: bool = False, scene_ids=None):
        """(N, 4, 4) or (4, 4) hypotheses -> (refined poses, RegistrationResult),
        tensors on the refiner's device."""
        _unported("schedule", schedule, None, "A14")
        _unported("with_covariance", with_covariance, False, "A14")
        _unported("scene_ids", scene_ids, None, "A15")
        if self.scene is None:  # usage error: must survive python -O
            raise RuntimeError("set_scene_depth first")
        init = torch.as_tensor(init_poses, dtype=torch.float32, device=self.device)
        if tuple(init.shape[-2:]) != (4, 4) or init.dim() not in (2, 3):
            raise ValueError(
                f"init_poses must be (4, 4) or (N, 4, 4) model->camera transforms, "
                f"got {tuple(init.shape)}"
            )
        squeeze = init.dim() == 2
        if squeeze:
            init = init[None]
        refined, results = refine_poses(
            self.tris, init, self.scene, self.proj, self._K_render_t,
            width=self.render_w, height=self.render_h,
            max_points=self.max_points, criteria=criteria,
            window=self.window, stride=self.stride, roi=self.roi,
        )
        self._warn_if_saturated(results)
        if squeeze:
            refined = refined[0]
            results = icp.RegistrationResult(*(f[0] for f in results))
        return refined, results

    @staticmethod
    def rank(results: icp.RegistrationResult):
        """Hypothesis re-ranking: best-first indices by (fitness, -rmse)
        (icp.h:26-36)."""
        fit = results.fitness.cpu().numpy()
        rmse = results.inlier_rmse.cpu().numpy()
        return np.lexsort((rmse, -fit))
