"""The reference refiner of the benchmark's configurations: a depth frame
and pose hypotheses -> refined poses with fitness and rmse, by the plain
pieces of this package, from the configuration's own numbers."""

from __future__ import annotations

import numpy as np
import torch

from reference import icp
from reference.geometry import compute_proj, mm
from reference.lift import window_lift
from reference.plan import decimate
from reference.render import render
from reference.scene import NearestScene, ProjectiveScene


class Refiner:
    """``cfg`` is a configuration file's dict (camera, refiner, criteria);
    vertices and faces the mesh the program loads."""

    def __init__(self, cfg: dict, vertices, faces, device):
        cam, opt = cfg["camera"], cfg["refiner"]
        self.device = device
        self.width, self.height = cam["width"], cam["height"]
        self.K = np.asarray(cam["K"], np.float32)
        self.scale = int(opt.get("render_scale", 1))
        self.rw, self.rh = self.width // self.scale, self.height // self.scale
        self.K_render = self.K.copy()
        self.K_render[:2] /= self.scale
        self.proj = compute_proj(self.K, self.width, self.height)
        self.window, self.stride = int(opt["window"]), int(opt["stride"])
        self.max_points = int(opt["max_points"])
        self.max_dist = float(opt.get("max_dist_diff", 0.1))
        self.kind = opt.get("scene", "projective")
        self.voxel_mm = float(opt.get("scene_voxel_mm", 0.0))
        crit = cfg.get("criteria", {})
        self.thresholds = (float(crit.get("relative_fitness", 1e-5)),
                           float(crit.get("relative_rmse", 1e-5)))
        cell = float(opt.get("decimate_mm", 0.0))
        tris = (decimate(vertices, faces, cell) if cell > 0
                else np.asarray(vertices, np.float32)[np.asarray(faces)])
        self.tris = torch.as_tensor(tris, device=device)

    def scene(self, frame):
        depth = torch.as_tensor(np.asarray(frame), device=self.device)
        if self.kind == "projective":
            return ProjectiveScene(depth, self.K, self.max_dist)
        return NearestScene(depth, self.K, self.max_dist, self.voxel_mm)

    def clouds(self, init, roi):
        """(clouds, valid, covered pixels a pose) of the hypotheses' renders."""
        p = torch.as_tensor(np.asarray(init, np.float32), device=self.device)
        depth, covered = render(self.tris, p, self.rw, self.rh, self.proj, roi)
        cloud, valid = window_lift(depth, self.K_render, self.window, self.stride,
                                   self.max_points, self.kind != "projective",
                                   tl_x=roi[0], tl_y=roi[1])
        return cloud, valid, covered

    def refine(self, scene, init, roi, max_iteration: int):
        """(refined (N, 4, 4) mm, icp.Result, valid, covered) of hypotheses."""
        cloud, valid, covered = self.clouds(init, roi)
        res = icp.icp(cloud, valid, scene.query, max_iteration, *self.thresholds)
        T = res.T.clone()
        T[:, :3, 3] *= 1000.0
        init_t = torch.as_tensor(np.asarray(init, np.float32), device=self.device)
        return mm(T, init_t), res, valid, covered

    def judge(self, scene, init, refined, roi):
        """What the program's answers say, re-scored: the transform each
        answer implies (refined @ init^-1, in meters) applied to the
        reference's lift of its hypothesis. Returns (fitness, rmse, moved
        clouds, valid)."""
        init64 = np.asarray(init, np.float64)
        T = np.asarray(refined, np.float64) @ np.linalg.inv(init64)
        T[:, :3, 3] /= 1000.0
        cloud, valid, _ = self.clouds(init, roi)
        fit, rmse, moved = icp.scores(torch.as_tensor(T, dtype=torch.float32, device=self.device),
                                      cloud, valid, scene.query)
        return fit, rmse, moved, valid

    def covariance(self, scene, moved, valid):
        return icp.covariance(moved, valid, scene.query, self.K_render)
