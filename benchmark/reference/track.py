"""The tracking session's filter and fusion, worked out again: a frozen
copy of the program's stated left-invariant error-state Kalman filter on
SE(3) (random-walk prediction, chi-square innovation gate, fitness gate,
Joseph-form update, belief sampling with row 0 the mean), its ranking of
hypotheses by (fitness, -rmse) and the hypothesis-scatter covariance term.
Host numpy in float64; poses are model->camera with mm translations,
twists [omega (rad), t (m)] applied on the left."""

from __future__ import annotations

import numpy as np

# the ICP iterations of a tracked frame: the session's frames run with the
# convergence criteria's defaults, the reference's max_iteration of 30
# (icp.h:38-50), and its relative thresholds of 1e-5
ITERATIONS = 30
CHI2_6_99 = 16.81
ENSEMBLE_MIN_FITNESS = 0.5
ENSEMBLE_FITNESS_TOL = 0.05
ENSEMBLE_RMSE_TOL = 0.25
DEPTH_QUANT_SIGMA_M = 2.9e-4


def _skew(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def se3_exp(xi):
    xi = np.asarray(xi, np.float64)
    w, t = xi[:3], xi[3:]
    th = float(np.linalg.norm(w))
    W = _skew(w)
    if th < 1e-7:
        R = np.eye(3) + W + 0.5 * (W @ W)
        V = np.eye(3) + 0.5 * W + (W @ W) / 6.0
    else:
        a, b = np.sin(th) / th, (1.0 - np.cos(th)) / (th * th)
        c = (1.0 - a) / (th * th)
        R = np.eye(3) + a * W + b * (W @ W)
        V = np.eye(3) + b * W + c * (W @ W)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ t
    return T


def se3_log(T):
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    th = float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
    if th < 1e-7:
        W = 0.5 * (R - R.T)
        w = np.array([W[2, 1], W[0, 2], W[1, 0]])
        Vinv = np.eye(3) - 0.5 * W + (W @ W) / 12.0
    else:
        if np.pi - th < 1e-6:
            raise ValueError("rotation too close to 180 degrees")
        W = (th / (2.0 * np.sin(th))) * (R - R.T)
        w = np.array([W[2, 1], W[0, 2], W[1, 0]])
        half = th / 2.0
        Vinv = np.eye(3) - 0.5 * W + (1.0 - half / np.tan(half)) / (th * th) * (W @ W)
    return np.concatenate([w, Vinv @ T[:3, 3]])


def _to_m(pose_mm):
    T = np.asarray(pose_mm, np.float64).copy()
    T[:3, 3] /= 1000.0
    return T


def _to_mm(T):
    out = T.copy()
    out[:3, 3] *= 1000.0
    return out.astype(np.float32)


class Filter:
    """One object's belief: pose T (meters) and covariance P."""

    def __init__(self, pose_mm, process_noise, init_cov=None):
        self.T = _to_m(pose_mm)
        if init_cov is None:
            init_cov = np.diag([np.radians(5.0) ** 2] * 3 + [0.02 ** 2] * 3)
        self.P = np.asarray(init_cov, np.float64).copy()
        rot, trans = process_noise
        self.Q = np.diag([rot ** 2] * 3 + [trans ** 2] * 3)

    def copy(self) -> "Filter":
        out = Filter.__new__(Filter)
        out.T, out.P, out.Q = self.T.copy(), self.P.copy(), self.Q.copy()
        return out

    @property
    def pose_mm(self):
        return _to_mm(self.T)

    def predict(self):
        self.P = self.P + self.Q

    def update(self, measured_mm, cov6, quality: float, gate_chi2=CHI2_6_99,
               min_quality=0.6) -> bool:
        if not float(quality) >= float(min_quality):
            return False
        try:
            e = se3_log(_to_m(measured_mm) @ np.linalg.inv(self.T))
        except ValueError:
            return False
        R = np.asarray(cov6, np.float64)
        Sinv = np.linalg.inv(self.P + R)
        if not float(e @ Sinv @ e) <= gate_chi2:
            return False
        K = self.P @ Sinv
        self.T = se3_exp(K @ e) @ self.T
        IK = np.eye(6) - K
        self.P = IK @ self.P @ IK.T + K @ R @ K.T
        return True

    def hypotheses(self, n: int, rng: np.random.Generator, scale: float = 1.0):
        lam, U = np.linalg.eigh(self.P)
        L = U @ np.diag(np.sqrt(np.maximum(lam, 0.0)))
        out = [self.T]
        for _ in range(max(0, int(n) - 1)):
            out.append(se3_exp(scale * (L @ rng.standard_normal(6))) @ self.T)
        return np.stack([_to_mm(T) for T in out])


def rank(fitness, rmse) -> np.ndarray:
    """Best-first order by (fitness, -rmse)."""
    return np.lexsort((np.asarray(rmse), -np.asarray(fitness)))


def ensemble_cov(refined, fitness, rmse, best: int) -> np.ndarray:
    """The scatter about the winner of the hypotheses that reached its basin
    (fitness >= max(0.5, winner's - 0.05), rmse <= winner's + max(25%,
    the depth step)), as twists."""
    ens = np.zeros((6, 6))
    k = 0
    inv_best = np.linalg.inv(_to_m(refined[best]))
    min_fit = max(ENSEMBLE_MIN_FITNESS, float(fitness[best]) - ENSEMBLE_FITNESS_TOL)
    br = float(rmse[best])
    max_rmse = br + max(ENSEMBLE_RMSE_TOL * br, DEPTH_QUANT_SIGMA_M)
    for i in range(len(refined)):
        if i == best or not fitness[i] >= min_fit or not rmse[i] <= max_rmse:
            continue
        try:
            e = se3_log(_to_m(refined[i]) @ inv_best)
        except ValueError:
            continue
        if np.isfinite(e).all():
            ens += np.outer(e, e)
            k += 1
    return ens / k if k else ens
