"""Lane detection as pixel-level proposal + host clustering — the PINet /
LaneNet shape of the paper's analysis: stage 1 proposes lane *pixels*
(variable count, sensitive to pixel distributions — Insight 1's "random
matrix hits lane detection hardest"), stage 2 clusters pixels into lane
instances on the host (cost grows with proposal count).

The port of ``repro/perception/lane.py``; ``cluster_host`` is a NumPy copy
of the reference's.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..models.params import ParamSpec
from .detector import _pool, _unit_luma, backbone_specs, init_detector_params, top_k

__all__ = ["LaneDetector"]


@dataclasses.dataclass
class LaneDetector:
    channels: int = 16
    pixel_thr: float = 0.6
    cluster_dist: float = 12.0

    def specs(self) -> dict:
        c = self.channels
        return {
            "backbone": backbone_specs(c),
            "head": ParamSpec((c, 1), (None, None), scale=1.0),
        }

    def init(self, generator: torch.Generator, device: str | torch.device = "cuda") -> dict:
        return init_detector_params(self.specs(), generator, device)

    def infer_device(self, params, image: torch.Tensor) -> torch.Tensor:
        """Pixel-proposal probability map (fixed shape).

        Lane evidence = bright AND thin: maxpool − avgpool is large for
        2-px-wide bright lines, small for filled object blobs and flat
        background; rain fog compresses the band-pass response.  ``image``
        (H, W, 3) gives (h, w); a batch (B, H, W, 3) gives (B, h, w).
        """
        img = _unit_luma(image)
        band = _pool(img, 8, "max") - _pool(img, 8, "avg")
        return torch.sigmoid(14.0 * (band - 0.33))

    def cluster_host(self, prob: np.ndarray, upsample: int = 4):
        """Greedy single-linkage clustering of proposal pixels into lanes,
        at pixel (not feature) resolution — O(n · lanes) in the
        data-dependent pixel count, exactly the paper's PINet pathology."""
        if upsample > 1:
            prob = np.kron(prob, np.ones((upsample, upsample), prob.dtype))
        ys, xs = np.nonzero(prob > self.pixel_thr)
        n = len(ys)
        lanes: list[list[tuple[float, float]]] = []
        centers: list[np.ndarray] = []
        order = np.argsort(ys)
        for i in order:
            p = np.array((float(ys[i]), float(xs[i])))
            best, best_d = -1, self.cluster_dist
            for li, c in enumerate(centers):
                d = abs(c[1] - p[1]) + 0.2 * abs(c[0] - p[0])
                if d < best_d:
                    best, best_d = li, d
            if best < 0:
                lanes.append([tuple(p)])
                centers.append(p.copy())
            else:
                lanes[best].append(tuple(p))
                centers[best] = 0.8 * centers[best] + 0.2 * p
        # fit a line per lane (least squares) — the paper's lane_fit()
        fits = []
        for pts in lanes:
            a = np.asarray(pts)
            if len(a) >= 4:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    coef = np.polyfit(a[:, 0], a[:, 1], 2)
                fits.append(coef)
        return fits, n

    def static_fit_device(self, prob: torch.Tensor, k: int = 256, n_lanes: int = 4):
        """Static-shape alternative (the framework's mitigation): top-k
        pixels, soft-assign to n_lanes anchors, batched least squares —
        fixed time regardless of scene content.  ``prob`` (h, w) gives fits
        (n_lanes, 3) and a pixel count; a batch (B, h, w) gives them with a
        leading B, each slot on its own.  The (B, n_lanes) 3 × 3 systems are
        solved in one batched call that skips the host check of its result
        (``torch.linalg.solve`` would read its status back to the host: a
        hidden sync inside the inference stage)."""
        *lead, h, w = prob.shape
        top, idx = top_k(prob.reshape(*lead, h * w), k)
        ys = (idx // w).float()
        xs = (idx % w).float()                                                  # (..., k)
        valid = top > self.pixel_thr
        lanes = torch.arange(n_lanes, device=prob.device)
        anchors = (lanes + 1.0) * (w / (n_lanes + 1.0))
        # the first of equally near anchors, as jnp.argmin takes it
        assign = torch.argmin((xs[..., :, None] - anchors).abs(), dim=-1)
        wgt = ((assign[..., None, :] == lanes[:, None]) & valid[..., None, :]).float()  # (..., lanes, k)
        # weighted quadratic fit via normal equations (fixed shape)
        a = torch.stack([ys**2, ys, torch.ones_like(ys)], dim=-1)[..., None, :, :]  # (..., 1, k, 3)
        aw_t = (a * wgt[..., :, :, None]).transpose(-1, -2)                   # (..., lanes, 3, k)
        ata = aw_t @ a + 1e-3 * torch.eye(3, device=prob.device)
        atb = aw_t @ xs[..., None, :, None]                                     # (..., lanes, 3, 1)
        fits, _ = torch.linalg.solve_ex(ata, atb, check_errors=False)
        return fits[..., 0], valid.sum(-1)
