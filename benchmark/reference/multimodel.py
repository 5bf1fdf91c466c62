"""The reference refiner of a frame that holds several object models: each
hypothesis rendered with its own model's decimated triangles (each model
rendered on its own, for its own poses; no padded table and no shared
index), then the same lift, scene, ICP and re-score as ``refiner.py``.
The ROI is the refiner's plan of the frame (``plan.RoiPlanner``, which
the traffic kinds replay through ``core.check.rois``)."""

from __future__ import annotations

import numpy as np
import torch

from reference import icp
from reference.geometry import mm
from reference.lift import window_lift
from reference.plan import decimate
from reference.refiner import Refiner
from reference.render import render


class MultiRefiner(Refiner):
    """``cfg`` is a configuration file's dict (camera, refiner, criteria);
    ``meshes`` the [(vertices, faces)] of the models the program loads, in
    the order of their model ids."""

    def __init__(self, cfg: dict, meshes, device):
        super().__init__(cfg, *meshes[0], device)
        cell = float(cfg["refiner"].get("decimate_mm", 0.0))
        self.tables = [torch.as_tensor(decimate(v, f, cell) if cell > 0
                                       else np.asarray(v, np.float32)[np.asarray(f)],
                                       device=device) for v, f in meshes]

    def render(self, init, ids, roi):
        """((N, out_h, out_w) int32 renders, (N,) covered pixels) of the
        hypotheses ``init``, pose i with the triangles of model ids[i]."""
        p = torch.as_tensor(np.asarray(init, np.float32), device=self.device)
        ids = np.asarray(ids).reshape(-1)
        depth = covered = None
        for m in np.unique(ids):
            rows = torch.as_tensor(np.flatnonzero(ids == m), device=self.device)
            d, c = render(self.tables[int(m)], p[rows], self.rw, self.rh, self.proj, roi)
            if depth is None:
                depth = torch.zeros((len(ids),) + tuple(d.shape[1:]), dtype=d.dtype,
                                    device=self.device)
                covered = torch.zeros(len(ids), dtype=c.dtype, device=self.device)
            depth[rows], covered[rows] = d, c
        return depth, covered

    def clouds_of(self, init, ids, roi):
        """(clouds, valid, covered pixels a pose) of the hypotheses' renders."""
        depth, covered = self.render(init, ids, roi)
        cloud, valid = window_lift(depth, self.K_render, self.window, self.stride,
                                   self.max_points, self.kind != "projective",
                                   tl_x=roi[0], tl_y=roi[1])
        return cloud, valid, covered

    def refine_models(self, scene, init, ids, roi, max_iteration: int):
        """(refined (N, 4, 4) mm, icp.Result, valid, covered) of hypotheses
        of models ``ids``."""
        cloud, valid, covered = self.clouds_of(init, ids, roi)
        res = icp.icp(cloud, valid, scene.query, max_iteration, *self.thresholds)
        T = res.T.clone()
        T[:, :3, 3] *= 1000.0
        init_t = torch.as_tensor(np.asarray(init, np.float32), device=self.device)
        return mm(T, init_t), res, valid, covered

    def judge_models(self, scene, init, ids, refined, roi):
        """Refiner.judge of answers of models ``ids``: (fitness, rmse)."""
        init64 = np.asarray(init, np.float64)
        T = np.asarray(refined, np.float64) @ np.linalg.inv(init64)
        T[:, :3, 3] /= 1000.0
        cloud, valid, _ = self.clouds_of(init, ids, roi)
        fit, rmse, _ = icp.scores(torch.as_tensor(T, dtype=torch.float32, device=self.device),
                                  cloud, valid, scene.query)
        return fit, rmse
