"""Synthetic KITTI-like scene generator (paper §III-A dataset).

Deterministic, seeded scenes for three scenarios — city / residential /
road — whose *object and lane densities* differ the way the paper's
KITTI subsets do (downtown has more objects than the countryside,
Insight 1).  Rain rendering (paper Table IV, after [48]) perturbs pixels
and occludes objects: higher rain rates reduce the number of detectable
objects/lane pixels, which is the mechanism behind the paper's finding
that inference-time mean AND variance drop with rain.

Images are small (96×320×3 float32) so the pipelines run quickly on CPU;
the variance *structure* (counts driving host-side work) is what matters.
A copy of the reference's ``repro/perception/data.py``: the port's scenes
are the reference's bit for bit (the same NumPy ``default_rng`` draws).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np

__all__ = [
    "SceneConfig",
    "Scene",
    "generate_scene",
    "scene_stream",
    "varied_scene_stream",
    "SCENARIOS",
]

H, W = 96, 320

# scenario → (mean objects, mean lanes) — city busiest, road sparsest
SCENARIOS = {
    "city": (12.0, 2.5),
    "residential": (6.0, 3.0),
    "road": (2.5, 4.0),
}


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    scenario: str = "city"
    rain_mm_per_hour: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class Scene:
    image: np.ndarray            # (H, W, 3) float32 in [0, 1]
    boxes: np.ndarray            # (n, 4) ground-truth object boxes (y0,x0,y1,x1)
    lane_pixels: np.ndarray      # (m, 2) ground-truth lane pixel coords
    scenario: str
    rain: float


def _draw_objects(rng, n: int, img: np.ndarray) -> np.ndarray:
    boxes = []
    for _ in range(n):
        h = rng.integers(8, 28)
        w = rng.integers(8, 36)
        y0 = rng.integers(H // 3, H - h)
        x0 = rng.integers(0, W - w)
        shade = 0.55 + 0.4 * rng.random()
        img[y0 : y0 + h, x0 : x0 + w] = shade
        img[y0 : y0 + 2, x0 : x0 + w] = 1.0   # high-contrast edge
        boxes.append((y0, x0, y0 + h, x0 + w))
    return np.asarray(boxes, np.float32).reshape(-1, 4)


def _draw_lanes(rng, n: int, img: np.ndarray) -> np.ndarray:
    pix = []
    for i in range(n):
        x_base = (i + 1) * W / (n + 1) + rng.normal(0, 6)
        curve = rng.normal(0, 0.15)
        for y in range(H // 2, H):
            x = int(x_base + curve * (y - H // 2) ** 1.2)
            if 0 <= x < W - 1:
                img[y, x : x + 2, :] = 0.95
                pix.append((y, x))
    return np.asarray(pix, np.float32).reshape(-1, 2)


def _render_rain(rng, img: np.ndarray, mm_per_hour: float) -> None:
    """Streaks + contrast loss + fog, strength ∝ rain rate (after [48])."""
    if mm_per_hour <= 0:
        return
    strength = min(mm_per_hour / 200.0, 1.0)
    # fog pulls everything toward gray: low-contrast structure disappears
    img *= 1.0 - 0.5 * strength
    img += 0.45 * 0.5 * strength
    # streaks are dim gray smears (NOT bright thin lines — they must not
    # masquerade as lane evidence; the paper's rain *reduces* proposals)
    n_streaks = int(250 * strength)
    for _ in range(n_streaks):
        x = rng.integers(0, W)
        y = rng.integers(0, H - 8)
        img[y : y + 8, x] = 0.5 * img[y : y + 8, x] + 0.27
    img += rng.normal(0.0, 0.05 * strength, img.shape).astype(np.float32)
    np.clip(img, 0.0, 1.0, out=img)


def generate_scene(cfg: SceneConfig, index: int = 0) -> Scene:
    rng = np.random.default_rng(cfg.seed * 100_003 + index)
    mu_obj, mu_lane = SCENARIOS[cfg.scenario]
    img = np.full((H, W, 3), 0.25, np.float32)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)  # sensor noise
    n_obj = int(rng.poisson(mu_obj))
    n_lane = max(int(rng.poisson(mu_lane)), 0)
    lanes = _draw_lanes(rng, n_lane, img)
    boxes = _draw_objects(rng, n_obj, img)
    _render_rain(rng, img, cfg.rain_mm_per_hour)
    np.clip(img, 0.0, 1.0, out=img)
    return Scene(image=img, boxes=boxes, lane_pixels=lanes,
                 scenario=cfg.scenario, rain=cfg.rain_mm_per_hour)


def scene_stream(cfg: SceneConfig, n: int, start: int = 0) -> Iterator[Scene]:
    """``n`` scenes under one stationary config; ``start`` offsets the
    frame index so consecutive calls continue one temporal stream."""
    for i in range(start, start + n):
        yield generate_scene(cfg, i)


def varied_scene_stream(
    configs: Iterable[tuple[SceneConfig, int]],
) -> Iterator[Scene]:
    """Segment-parameterized stream: each element is ``(config, index)``,
    so conditions (scenario, rain, seed) may change frame to frame while
    the index keeps per-frame content evolving.  This is how a
    ``ScenarioTrace`` (``repro.scenarios``) renders a time-varying driving
    episode through the same generator the stationary benchmarks use —
    e.g. ``varied_scene_stream(trace.stream_configs("cam_front"))``."""
    for cfg, i in configs:
        yield generate_scene(cfg, i)
