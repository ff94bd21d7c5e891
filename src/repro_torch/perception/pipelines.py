"""Instrumented perception pipelines — the paper's profiling harness
(Fig. 3 timeline: read → pre-process → inference → post-process) wired to
the synthetic scenes, with both the paper-faithful *dynamic* post-processing
and the static-shape mitigation.

Pipelines are **registry-driven**: each fidelity variant registers a
factory under a name (``PIPELINES``), the single ``run_pipeline`` runner
drives any of them through the identical stage-timed loop, and the legacy
``run_*`` entry points are thin wrappers.  The anytime subsystem
(``repro_torch.anytime``) addresses rungs by these registry names.

Every run returns a ``TimelineRecorder`` whose records carry the stage
breakdown plus metadata (``num_proposals``, ``num_objects``) so the
benchmarks can compute the paper's correlations directly; ``collect=True``
additionally returns per-frame detections in the original image frame so
quality can be scored against ``Scene.boxes``.

The port of ``repro/perception/pipelines.py``.  Every factory and entry
point takes ``device`` (default ``"cuda"``; it raises when no CUDA device
is present and the CPU was not asked for), a CPU ``torch.Generator`` for
the weights (seeded 7 when none is given, as the reference's default key
is ``PRNGKey(7)``), and ``params``, a reference parameter tree of NumPy
arrays that replaces the drawn weights.  The device stage runs eagerly,
op by op (the reference jits it).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.timing import StageTimer, TimelineRecorder, fence, to_host
from .data import H, W, Scene, SceneConfig, generate_scene
from .detector import OneStageDetector, TwoStageDetector, params_from_numpy, resolve_device
from .lane import LaneDetector

__all__ = [
    "FrameOutput",
    "BuiltPipeline",
    "PIPELINES",
    "register_pipeline",
    "build_pipeline",
    "run_frame",
    "run_pipeline",
    "run_one_stage",
    "run_two_stage",
    "run_lane",
    "run_lane_static",
    "preprocess",
    "preprocess_device",
    "gather_index",
]


def _default_generator() -> torch.Generator:
    """Per-build generator, created lazily so importing this module does no
    torch work."""
    return torch.Generator().manual_seed(7)


def preprocess(image: np.ndarray, scale: float = 1.0, pad: bool = True) -> np.ndarray:
    """Resize (λ scaling, paper Fig. 6) + normalize + color juggling —
    the real host work of the paper's pre-processing stage.

    ``pad=True`` (legacy) crops/pads the scaled image back to the model's
    fixed input shape.  ``pad=False`` returns the genuinely smaller scaled
    image — the anytime ladder's λ rungs use it so a lower scale buys a
    proportional inference-FLOP reduction, not just fewer bright pixels.
    """
    img = image
    if scale != 1.0:
        h, w = img.shape[:2]
        nh, nw = max(int(h * scale), 8), max(int(w * scale), 8)
        if not pad:
            # detectors pool in 8-px cells; round the unpadded input down
            # to the cell grid so any λ yields a valid static shape
            nh, nw = max(nh // 8 * 8, 8), max(nw // 8 * 8, 8)
        ys = (np.arange(nh) * (h / nh)).astype(np.int64)
        xs = (np.arange(nw) * (w / nw)).astype(np.int64)
        img = img[ys][:, xs]
        if pad:
            # crop/pad back to the model's fixed input (paper: transpose+crop
            # when the input exceeds the max size — the λ=10 outlier)
            out = np.zeros(image.shape, np.float32)
            ch, cw = min(h, nh), min(w, nw)
            out[:ch, :cw] = img[:ch, :cw]
            img = out
    img = img[..., ::-1]                      # BGR↔RGB convert (paper's cvt)
    img = (img - img.mean()) / (img.std() + 1e-6)
    return img.astype(np.float32)


def gather_index(shape: tuple[int, int], scale: float, pad: bool,
                 device: str | torch.device) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """The λ resize's row and column gather indices for an (H, W) image, on
    ``device``, computed exactly as ``preprocess`` computes them; ``None`` at
    λ = 1.  Made once per (shape, scale, pad, device) and kept: a
    host-to-device copy inside the step would be illegal under CUDA-graph
    capture."""
    if scale == 1.0:
        return None
    h, w = int(shape[0]), int(shape[1])
    nh, nw = max(int(h * scale), 8), max(int(w * scale), 8)
    if not pad:
        nh, nw = max(nh // 8 * 8, 8), max(nw // 8 * 8, 8)
    ys = torch.from_numpy((np.arange(nh) * (h / nh)).astype(np.int64)).to(device)
    xs = torch.from_numpy((np.arange(nw) * (w / nw)).astype(np.int64)).to(device)
    return ys, xs


def preprocess_device(image: torch.Tensor, scale: float = 1.0, pad: bool = True,
                      index: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``preprocess`` as a device computation, stage for stage, on an
    (..., H, W, 3) image: leading dims are slots, each resized and
    standardized on its own (the mean and std are each slot's).  The std is
    the population std (``correction=0``), as NumPy's and ``jnp.std`` are.
    ``index`` is ``gather_index`` for this shape, scale and pad, made ahead
    of time; without it the indices are made here."""
    img = image
    if scale != 1.0:
        h, w = int(img.shape[-3]), int(img.shape[-2])
        ys, xs = index if index is not None else gather_index((h, w), scale, pad, image.device)
        img = img.index_select(-3, ys).index_select(-2, xs)
        if pad:
            # crop/pad back to the model's fixed input: zeros after the
            # scaled image, as the host version's fresh zero frame
            ch, cw = min(h, ys.numel()), min(w, xs.numel())
            img = F.pad(img[..., :ch, :cw, :], (0, 0, 0, w - cw, 0, h - ch))
    img = torch.flip(img, dims=(-1,))
    dims = (-3, -2, -1)
    mean = img.mean(dims, keepdim=True)
    std = img.std(dims, correction=0, keepdim=True)
    img = (img - mean) / (std + 1e-6)
    return img.float()


@dataclasses.dataclass(frozen=True)
class FrameOutput:
    """One frame's host-side result: detections mapped back to the
    original (unscaled) image frame plus the paper's variance covariates."""

    boxes: np.ndarray            # (k, 4) detections, original image coords
    num_objects: float
    num_proposals: float


@dataclasses.dataclass
class BuiltPipeline:
    """A pipeline variant ready to run: a device stage and a host post
    stage, with the weights on ``device``.  The runner owns the timing; this
    owns the compute.

    **Single-readback contract**: ``post`` and ``post_batch`` receive the
    device outputs *already fetched to host* — the runner performs exactly
    ONE readback of the whole output tree per frame (``core.timing.to_host``:
    non-blocking copies into pinned memory, one stream sync), and the post
    stages operate on NumPy arrays.

    ``post_batch`` is the vectorized form of ``post`` for a batched
    multi-camera engine: it takes the fetched batch outputs plus an
    active-slot mask and returns a per-slot ``FrameOutput`` list (``None``
    for inactive slots).  Factories that cannot vectorize their post stage
    leave it ``None``.

    ``infer`` takes one image (H, W, 3) or a batch (B, H, W, 3) and returns
    the same tree with a leading B for a batch: serial and batched serving
    share one device path.  ``device_step`` is the batched engine's fused
    step, device pre-processing then ``infer``, over raw frames."""

    name: str
    scale: float
    infer: Callable[[torch.Tensor], Any]     # device stage
    post: Callable[[Any], FrameOutput]       # host post-processing stage
    device: torch.device
    pad: bool = True                         # False: truly smaller λ input
    post_batch: Optional[Callable[[Any, np.ndarray], list]] = None
    # λ gather indices on the device, per raw (H, W): made at build time
    # for the canonical frame, and once for any other shape
    _index: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def pre_index(self, shape: tuple[int, int]):
        key = (int(shape[0]), int(shape[1]))
        if key not in self._index:
            self._index[key] = gather_index(key, self.scale, self.pad, self.device)
        return self._index[key]

    def device_step(self, raw: torch.Tensor):
        """Pre-processing on the device, then inference, over raw frames
        (B, H, W, 3): the batched engine's step."""
        index = self.pre_index(raw.shape[-3:-1])
        return self.infer(preprocess_device(raw, self.scale, self.pad, index))


PIPELINES: Dict[str, Callable[..., BuiltPipeline]] = {}


def register_pipeline(name: str):
    def deco(factory: Callable[..., BuiltPipeline]):
        PIPELINES[name] = factory
        return factory
    return deco


def build_pipeline(name: str, scale: float = 1.0, generator: Optional[torch.Generator] = None,
                   pad: bool = True, device: str | torch.device = "cuda",
                   params: Optional[Mapping[str, Any]] = None, **det_kw) -> BuiltPipeline:
    if name not in PIPELINES:
        raise KeyError(
            f"unknown pipeline {name!r}; registered: {sorted(PIPELINES)}"
        )
    built = PIPELINES[name](scale=scale, generator=generator, pad=pad, device=device,
                            params=params, **det_kw)
    built.pre_index((H, W))
    return built


def _weights(det, generator, dev: torch.device, params) -> dict:
    if params is not None:
        return params_from_numpy(params, dev)
    return det.init(generator if generator is not None else _default_generator(), dev)


def _effective_scales(scale: float, pad: bool) -> tuple[float, float]:
    """The per-axis scale factors preprocess actually applies to the
    canonical (H, W) scene: integer rounding (and the unpadded 8-px grid
    snap) makes them differ from the nominal λ, and from each other."""
    if scale == 1.0:
        return 1.0, 1.0
    nh, nw = max(int(H * scale), 8), max(int(W * scale), 8)
    if not pad:
        nh, nw = max(nh // 8 * 8, 8), max(nw // 8 * 8, 8)
    return nh / H, nw / W


def _unscale(boxes: np.ndarray, scale: float, pad: bool) -> np.ndarray:
    """Detections on a λ-scaled input live in the shrunk frame; map them
    back (per axis, using the effective scales) so quality is comparable
    across rungs.  Broadcasts over any (..., 4) shape, so the batched
    post paths unscale a whole (B, k, 4) readback in one pass; the
    per-element division is identical either way, so masking kept boxes
    before or after unscaling yields the same floats."""
    sy, sx = _effective_scales(scale, pad)
    if sy == sx == 1.0 or not len(boxes):
        return boxes
    return boxes / np.array([sy, sx, sy, sx], boxes.dtype)


@register_pipeline("one_stage")
def _make_one_stage(scale: float = 1.0, generator=None, pad: bool = True, device="cuda",
                    params=None, **det_kw) -> BuiltPipeline:
    det = OneStageDetector(**det_kw)
    dev = resolve_device(device)
    weights = _weights(det, generator, dev, params)

    def infer(img):
        return det.infer(weights, img)

    def post(host) -> FrameOutput:
        boxes, _, keep = host                 # NumPy after the one readback
        b = _unscale(boxes[keep], scale, pad)
        return FrameOutput(boxes=b, num_objects=float(keep.sum()),
                           num_proposals=float(det.top_k))

    def post_batch(host, active: np.ndarray) -> list:
        boxes, _, kb = host                   # (B, k) keep mask, NumPy
        bb = _unscale(boxes, scale, pad)
        outs: list[Optional[FrameOutput]] = []
        for b in range(kb.shape[0]):
            if not active[b]:
                outs.append(None)
                continue
            outs.append(FrameOutput(
                boxes=bb[b][kb[b]], num_objects=float(kb[b].sum()),
                num_proposals=float(det.top_k)))
        return outs

    return BuiltPipeline("one_stage", scale, infer, post, dev, pad=pad,
                         post_batch=post_batch)


@register_pipeline("early_exit")
def _make_early_exit(scale: float = 1.0, generator=None, pad: bool = True, device="cuda",
                     params=None, **det_kw) -> BuiltPipeline:
    """Truncated-backbone one-stage variant: 1 conv + coarse 16-px grid —
    the anytime ladder's cheapest detection rung."""
    det_kw.setdefault("depth", 1)
    det_kw.setdefault("cell", 16)
    built = _make_one_stage(scale=scale, generator=generator, pad=pad, device=device,
                            params=params, **det_kw)
    return dataclasses.replace(built, name="early_exit")


@register_pipeline("two_stage")
def _make_two_stage(scale: float = 1.0, generator=None, pad: bool = True, device="cuda",
                    params=None, **det_kw) -> BuiltPipeline:
    det = TwoStageDetector(**det_kw)
    dev = resolve_device(device)
    weights = _weights(det, generator, dev, params)

    def infer(img):
        return det.infer_device(weights, img)

    def post(host) -> FrameOutput:
        feat, obj = host                      # NumPy after the one readback
        boxes, n_prop = det.post_host(weights, feat, obj)
        return FrameOutput(boxes=_unscale(boxes, scale, pad),
                           num_objects=float(len(boxes)),
                           num_proposals=float(n_prop))

    def post_batch(host, active: np.ndarray) -> list:
        feat, obj = host
        per_slot = det.post_host_batch(weights, feat, obj, active=active)
        outs: list[Optional[FrameOutput]] = []
        for slot in per_slot:
            if slot is None:
                outs.append(None)
                continue
            boxes, n_prop = slot
            outs.append(FrameOutput(
                boxes=_unscale(boxes, scale, pad),
                num_objects=float(len(boxes)), num_proposals=float(n_prop)))
        return outs

    return BuiltPipeline("two_stage", scale, infer, post, dev, pad=pad,
                         post_batch=post_batch)


_NO_BOXES = np.zeros((0, 4), np.float32)


@register_pipeline("lane")
def _make_lane(scale: float = 1.0, generator=None, pad: bool = True, device="cuda",
               params=None, **det_kw) -> BuiltPipeline:
    det = LaneDetector(**det_kw)
    dev = resolve_device(device)
    weights = _weights(det, generator, dev, params)

    def infer(img):
        return det.infer_device(weights, img)

    def post(host) -> FrameOutput:
        fits, n_pix = det.cluster_host(host)  # NumPy after the one readback
        return FrameOutput(boxes=_NO_BOXES, num_objects=float(len(fits)),
                           num_proposals=float(n_pix))

    return BuiltPipeline("lane", scale, infer, post, dev, pad=pad)


@register_pipeline("lane_static")
def _make_lane_static(scale: float = 1.0, generator=None, pad: bool = True, device="cuda",
                      params=None, **det_kw) -> BuiltPipeline:
    """The mitigation: identical lane pipeline with static-shape top-k
    fitting on device — post-processing variance collapses."""
    det = LaneDetector(**det_kw)
    dev = resolve_device(device)
    weights = _weights(det, generator, dev, params)

    def infer(img):
        return det.static_fit_device(det.infer_device(weights, img))

    def post(host) -> FrameOutput:
        fits, n_pix = host              # fixed-size, NumPy after readback
        return FrameOutput(boxes=_NO_BOXES, num_objects=float(fits.shape[0]),
                           num_proposals=float(n_pix))

    return BuiltPipeline("lane_static", scale, infer, post, dev, pad=pad)


def run_frame(built: BuiltPipeline, scene: Scene):
    """One stage-timed frame through a built pipeline — the Fig. 3 loop
    body every harness (legacy runners, calibration, the anytime loop)
    shares.  Returns ``(StageRecord, FrameOutput)``.

    ``inference`` holds the host-to-device copy and the device pass, ended
    by a fence on its output; ``post_processing`` holds ONE readback of the
    whole output tree (one wait), then the host post stage."""
    timer = StageTimer()
    with timer.stage("read"):
        raw = scene.image.copy()
    with timer.stage("pre_processing"):
        img = preprocess(raw, built.scale, built.pad)
    with timer.stage("inference"):
        dev = built.infer(torch.from_numpy(img).to(built.device))
        fence(dev)
    with timer.stage("post_processing"):
        out = built.post(to_host(dev))
    timer.note("num_objects", out.num_objects)
    timer.note("num_proposals", out.num_proposals)
    return timer.finish(), out


def _scenes(cfg: SceneConfig, n: int, images: Optional[Iterable[np.ndarray]] = None):
    if images is not None:
        for i, im in enumerate(images):
            sc = generate_scene(cfg, i)
            sc.image = im
            yield sc
    else:
        # start at 1: scene 0 is reserved for the synthetic warmup frame,
        # keeping the recorded scene sequence identical to the historical
        # contract (frames 1..n)
        for i in range(1, n + 1):
            yield generate_scene(cfg, i)


def run_pipeline(
    name: str,
    cfg: SceneConfig,
    n: int = 40,
    scale: float = 1.0,
    images: Optional[Iterable[np.ndarray]] = None,
    generator: Optional[torch.Generator] = None,
    collect: bool = False,
    built: Optional[BuiltPipeline] = None,
    pad: bool = True,
    device: str | torch.device = "cuda",
    params: Optional[Mapping[str, Any]] = None,
):
    """Drive any registered pipeline through the stage-timed frame loop.

    The warmup frame (the first-call outlier: lazy CUDA and cuDNN set-up,
    allocator growth) is a *synthetic* scene and is never recorded —
    caller-supplied ``images`` are all real frames, so the recorded count
    always equals the supplied count.  With ``collect=True`` returns
    ``(recorder, [(scene, FrameOutput), ...])`` so callers can score
    detections against ground truth; otherwise just the recorder.
    ``built`` reuses an already-built pipeline (the anytime runner keeps one
    per rung); ``device``, ``generator`` and ``params`` go to
    ``build_pipeline`` when it is not given.
    """
    if built is None:
        built = build_pipeline(name, scale=scale, generator=generator, pad=pad, device=device,
                               params=params)
    # warm up on a synthetic frame, never a caller-supplied one.  The
    # warmup frame takes the first user image's SHAPE, so the set-up for an
    # oddly-sized caller image is not paid inside the recorded loop.
    warm_scene = generate_scene(cfg, 0)
    if images is not None:
        it = iter(images)
        first = next(it, None)
        if first is None:
            return (TimelineRecorder(), []) if collect else TimelineRecorder()
        images = itertools.chain([first], it)
        if first.shape != warm_scene.image.shape:
            warm_scene.image = np.zeros_like(first)
    run_frame(built, warm_scene)                 # warmup, never recorded
    rec = TimelineRecorder()
    outputs: list[tuple[Scene, FrameOutput]] = []
    for scene in _scenes(cfg, n, images):
        record, out = run_frame(built, scene)
        rec.add(record)
        if collect:
            outputs.append((scene, out))
    return (rec, outputs) if collect else rec


# ---------------------------------------------------------------------------
# legacy entry points — thin wrappers over the registry runner
# ---------------------------------------------------------------------------

def run_one_stage(
    cfg: SceneConfig, n: int = 40, scale: float = 1.0,
    images: Optional[Iterable[np.ndarray]] = None, device: str | torch.device = "cuda",
) -> TimelineRecorder:
    return run_pipeline("one_stage", cfg, n=n, scale=scale, images=images, device=device)


def run_two_stage(
    cfg: SceneConfig, n: int = 40, scale: float = 1.0,
    images: Optional[Iterable[np.ndarray]] = None, device: str | torch.device = "cuda",
) -> TimelineRecorder:
    return run_pipeline("two_stage", cfg, n=n, scale=scale, images=images, device=device)


def run_lane(
    cfg: SceneConfig, n: int = 40,
    images: Optional[Iterable[np.ndarray]] = None, device: str | torch.device = "cuda",
) -> TimelineRecorder:
    return run_pipeline("lane", cfg, n=n, images=images, device=device)


def run_lane_static(
    cfg: SceneConfig, n: int = 40,
    images: Optional[Iterable[np.ndarray]] = None, device: str | torch.device = "cuda",
) -> TimelineRecorder:
    return run_pipeline("lane_static", cfg, n=n, images=images, device=device)
