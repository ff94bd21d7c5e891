"""Detection pipelines: one-stage (static work) vs two-stage
(proposal-driven host work) on a shared conv backbone — the paper's model
variability axis (Insight 3), implemented so the *mechanism* is explicit:

* one-stage: grid head → fixed-size tensor → **static-shape** top-k + NMS
  entirely on the device.  Inference-dominated; post-processing time is
  data-independent.
* two-stage: proposal head → host extracts a *variable-length* proposal
  list → per-proposal second stage + O(n²) host NMS.  Post-processing time
  scales with the proposal count — the paper's LaneNet/Faster-R-CNN
  pathology, faithfully reproduced.
* early exit: the one-stage detector truncated after ``depth`` backbone
  convs (remaining stride recovered by average pooling) with a coarser
  objectness grid — the anytime ladder's cheapest rung: less compute,
  coarser localization.

The port of ``repro/perception/detector.py``.  Images and feature maps
keep the reference's channel-last layout, (H, W, 3) and (h, w, C), at
every function's interface; the backbone permutes once into NCHW for the
convolutions and once back.  Conv weights are OIHW here and HWIO in the
reference; ``params_from_numpy`` carries a reference parameter tree
across.  The host stages (``dynamic_nms``, ``post_host``,
``post_host_batch``) are NumPy copies of the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.params import ParamSpec, init_params

__all__ = [
    "backbone_specs",
    "backbone_apply",
    "OneStageDetector",
    "TwoStageDetector",
    "dynamic_nms",
    "static_nms",
    "params_from_numpy",
    "init_detector_params",
    "resolve_device",
    "canonical_device",
]

def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (the perception entry points never fall back to
    the CPU on their own: the CPU runs only when asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} asked for, but no CUDA device is present "
                           "(torch.cuda.is_available() is false); pass device='cpu' to run "
                           "on the CPU")
    return dev


def canonical_device(device: str | torch.device) -> torch.device:
    """``device`` with a CUDA index filled in (the current device), so one
    device compares equal however it was spelled (``cuda`` and ``cuda:0``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def backbone_specs(channels: int = 16) -> dict:
    """The reference's specs, in its HWIO layout (the init's fan-in is
    taken over every dim but the last, so the layout sets the
    distribution); ``init_detector_params`` draws in it and transposes."""
    c = channels
    return {
        "conv1": ParamSpec((3, 3, 3, c), (None, None, None, None), scale=1.4),
        "conv2": ParamSpec((3, 3, c, c), (None, None, None, None), scale=1.4),
        "conv3": ParamSpec((3, 3, c, c), (None, None, None, None), scale=1.4),
    }


def params_from_numpy(tree: Mapping[str, Any], device: str | torch.device) -> dict:
    """The weight bridge: a detector's parameter tree of arrays in the
    reference's layout (NumPy leaves of ``det.init(key)``) → float32
    tensors on ``device``.  A rank-4 leaf is a conv weight, HWIO in the
    reference (NHWC convs), OIHW here (NCHW convs), so ``(3, 3, Cin, Cout)``
    becomes ``(Cout, Cin, 3, 3)``; the ``(C, 4)``, ``(C, 1)`` and ``(C, 5)``
    heads are taken as they are."""
    dev = resolve_device(device)

    def conv(a: Any) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(dev)

    def walk(node: Mapping[str, Any]) -> dict:
        return {k: walk(v) if isinstance(v, Mapping) else conv(v) for k, v in node.items()}

    return walk(tree)


def init_detector_params(specs: Mapping[str, Any], generator: torch.Generator,
                         device: str | torch.device) -> dict:
    """Seeded random weights with the reference's distributions, drawn on
    the CPU (so the same generator gives the same weights on every device)
    from a copy of ``generator``'s state: like a JAX key, one generator gives
    every detector built from it the same weights, and the shared backbone,
    drawn first, is the same in all of them."""
    gen = torch.Generator()
    gen.set_state(generator.get_state())
    tree = init_params(specs, gen, torch.float32, "cpu")
    return params_from_numpy(_numpy_tree(tree), device)


def _numpy_tree(tree: Mapping[str, Any]) -> dict:
    return {k: _numpy_tree(v) if isinstance(v, Mapping) else v.numpy() for k, v in tree.items()}


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one dimension: the output has ceil(n / s)
    rows and the odd row of padding goes after (on an even input at stride
    2 that is 0 before and 1 after, where ``padding=1`` would shift every
    window by one)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B, C, H, W), w (O, I, kh, kw), "SAME" padding."""
    top, bottom = _same_pad(x.shape[2], w.shape[2], stride)
    left, right = _same_pad(x.shape[3], w.shape[3], stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _f32_convs():
    """cuDNN computes float32 convolutions in TF32 unless told not to
    (``torch.backends.cudnn.allow_tf32`` defaults to True).  The reference
    convolves in f32 and the heads read the features, so the backbone asks
    for f32 here, around its own convolutions, rather than through a global
    that the other paths would inherit.  ``flags`` resets every flag it is
    not given, so the others are passed as they stand."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark, benchmark_limit=c.benchmark_limit,
                   deterministic=c.deterministic, allow_tf32=False)


def backbone_apply(params, image: torch.Tensor, depth: int = 3) -> torch.Tensor:
    """(B, 96, 320, 3) → (B, 12, 40, C) feature map.

    ``depth`` backbone convs run (stride 2 each); an early exit (depth < 3)
    recovers the remaining stride by average pooling, so the head always
    sees the canonical (12, 40) grid while skipping most of the FLOPs.
    """
    x = image.permute(0, 3, 1, 2)
    with _f32_convs():
        for name in ("conv1", "conv2", "conv3")[:depth]:
            x = torch.relu(_conv(x, params[name], 2))
    rem = 2 ** (3 - depth)
    if rem > 1:
        # kernel = stride = rem, no padding: crops to the tile grid first
        x = F.avg_pool2d(x, rem)
    return x.permute(0, 2, 3, 1)


def _pool(img: torch.Tensor, size: int, mode: str = "avg") -> torch.Tensor:
    """(..., H, W, 3) → (..., H//size, W//size) pooled luma, each slot of the
    leading dims on its own (border cropped to the tile grid, so any input
    shape is valid).

    The means are sums in a fixed order, written out as elementwise adds:
    the luma is (r + g + b) · (1/3), as XLA computes the reference's
    ``mean(-1)``, and a tile's pixels are summed pairwise (halving the
    tile's pixel vector ``log2(size²)`` times).  Every device then gives
    the same bits, and every tile the same order, so tiles with equal pixels
    tie exactly (top-k ranks ties by index).  ``Tensor.mean`` sums in an
    order that depends on the device and the layout: it moves scores by up
    to 4e-6 from the reference's and can reorder near-equal cells."""
    luma = (img[..., 0] + img[..., 1] + img[..., 2]) * (1.0 / 3.0)
    *lead, h, w = luma.shape
    gh, gw = h // size, w // size
    tiles = luma[..., : gh * size, : gw * size].reshape(*lead, gh, size, gw, size)
    if mode != "avg":
        return tiles.amax((-3, -1))
    v = tiles.transpose(-3, -2).reshape(*lead, gh, gw, size * size)
    while v.shape[-1] > 1:              # size is a power of two
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0] * (1.0 / (size * size))


# --------------------------------------------------------------------------
# NMS variants
# --------------------------------------------------------------------------

def _iou_matrix(boxes: np.ndarray) -> np.ndarray:
    y0, x0, y1, x1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(y1 - y0, 0) * np.maximum(x1 - x0, 0)
    iy0 = np.maximum(y0[:, None], y0[None, :])
    ix0 = np.maximum(x0[:, None], x0[None, :])
    iy1 = np.minimum(y1[:, None], y1[None, :])
    ix1 = np.minimum(x1[:, None], x1[None, :])
    inter = np.maximum(iy1 - iy0, 0) * np.maximum(ix1 - ix0, 0)
    union = area[:, None] + area[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def dynamic_nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float = 0.5) -> np.ndarray:
    """Host-side greedy NMS over a VARIABLE-length candidate list — O(n²)
    in the data-dependent count (the paper's variance source)."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    iou = _iou_matrix(boxes)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > iou_thr
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last dim and their indices, the lower
    index first among equal values, as ``lax.top_k`` orders them.
    ``torch.topk`` promises no order among ties, and ties are the rule here
    (every cell wholly inside one flat-shaded object pools to the same
    value), so this is the first ``k`` of a stable sort."""
    if k > x.shape[-1]:
        raise ValueError(f"top_k: k = {k} is larger than the {x.shape[-1]} values")
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def static_nms(boxes: torch.Tensor, scores: torch.Tensor, k: int, iou_thr: float = 0.5):
    """Fixed-shape device NMS: top-k candidates, then a greedy suppression
    pass of fixed length — identical result on the top-k set, ZERO
    data-dependent time (the framework's mitigation).  ``boxes`` (..., n, 4)
    and ``scores`` (..., n): leading dims are slots, each suppressed on its
    own.  The pass runs on the device without a host sync: two launches per
    candidate, whatever the number of slots."""
    n = boxes.shape[-2]
    k = min(k, n)
    top_scores, idx = top_k(scores, k)
    top_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))

    y0, x0, y1, x1 = top_boxes.unbind(-1)
    area = (y1 - y0).clamp_min(0) * (x1 - x0).clamp_min(0)
    iy0 = torch.maximum(y0[..., :, None], y0[..., None, :])
    ix0 = torch.maximum(x0[..., :, None], x0[..., None, :])
    iy1 = torch.minimum(y1[..., :, None], y1[..., None, :])
    ix1 = torch.minimum(x1[..., :, None], x1[..., None, :])
    inter = (iy1 - iy0).clamp_min(0) * (ix1 - ix0).clamp_min(0)
    iou = inter / (area[..., :, None] + area[..., None, :] - inter).clamp_min(1e-9)

    # sup[..., i, j]: box i, if kept, suppresses the later box j
    order = torch.arange(k, device=boxes.device)
    sup = (iou > iou_thr) & (order[None, :] > order[:, None])
    keep = top_scores > -math.inf
    for i in range(k):
        # keep & ~(sup[i] & keep[i])
        keep = keep > (sup[..., i, :] & keep[..., i, None])
    return top_boxes, top_scores, keep, idx


# --------------------------------------------------------------------------
# detectors
# --------------------------------------------------------------------------

def _unit_luma(image: torch.Tensor) -> torch.Tensor:
    """De-normalize: pipelines standardize the image; recover 0-1 luma.
    ``image`` (..., H, W, 3): the min and max are each slot's own."""
    dims = (-3, -2, -1)
    img = image - image.amin(dims, keepdim=True)
    return img / img.amax(dims, keepdim=True).clamp_min(1e-6)


@dataclasses.dataclass
class OneStageDetector:
    """YOLO-ish: grid head predicting (dy, dx, dh, dw) box refinements per
    cell.  Post-processing is static_nms on the fixed grid — constant time.

    Objectness is the same matched filter the two-stage RPN uses (pooled
    brightness above the scene floor) so detections line up with the
    synthetic ground truth and the anytime ladder can score quality
    against ``Scene.boxes``; the conv head supplies only box refinements.

    ``depth`` < 3 truncates the backbone (early exit) and ``cell`` > 8
    coarsens the objectness grid — cheaper inference, coarser boxes.
    """

    channels: int = 16
    top_k: int = 32
    score_thr: float = 0.5
    depth: int = 3               # backbone convs used (< 3 = early exit)
    cell: int = 8                # objectness grid granularity in pixels
    obj_thr: float = -1.0        # matched-filter floor; <0 = derive from cell

    def __post_init__(self) -> None:
        # cell//8 must divide the feature grid; powers of two always do,
        # e.g. cell=24 (factor 3) would not divide the 40-wide grid
        if self.cell not in (8, 16, 32):
            raise ValueError(f"cell must be 8, 16, or 32 (got {self.cell})")
        if not 1 <= self.depth <= 3:
            raise ValueError(f"depth must be in [1, 3] (got {self.depth})")
        if self.obj_thr < 0:
            # a coarser cell dilutes an object's brightness with background:
            # lower the floor so part-covered cells still fire
            self.obj_thr = 0.55 - 0.13 * math.log2(self.cell / 8)

    def specs(self) -> dict:
        c = self.channels
        return {
            "backbone": backbone_specs(c),
            "head": ParamSpec((c, 4), (None, None), scale=1.0),
        }

    def init(self, generator: torch.Generator, device: str | torch.device = "cuda") -> dict:
        return init_detector_params(self.specs(), generator, device)

    def infer(self, params, image: torch.Tensor):
        """Device path: features → grid preds → static top-k+NMS.  ``image``
        (H, W, 3) returns fixed-shape (boxes (k,4), scores (k,), keep (k,));
        a batch (B, H, W, 3) returns them with a leading B, each slot on its
        own (one image is the batch of one)."""
        if image.ndim == 3:
            return tuple(t[0] for t in self.infer(params, image[None]))
        feat = backbone_apply(params["backbone"], image, depth=self.depth)
        preds = feat @ params["head"]                 # bhwc,co->bhwo
        img = _unit_luma(image)
        obj2d = torch.sigmoid(12.0 * (_pool(img, self.cell, "avg") - self.obj_thr))
        b, gh, gw = obj2d.shape
        f = self.cell // 8
        if f > 1:       # coarsen the head to the objectness grid
            preds = preds[:, : gh * f, : gw * f]
            preds = preds.reshape(b, gh, f, gw, f, 4).mean((2, 4))
        else:
            preds = preds[:, :gh, :gw]
        obj = obj2d.reshape(b, -1)
        preds = preds.reshape(b, gh * gw, 4)
        gy, gx = torch.meshgrid(torch.arange(gh, device=image.device),
                                torch.arange(gw, device=image.device), indexing="ij")
        cell = float(self.cell)
        cy = (gy.reshape(-1) + 0.5) * cell + preds[..., 0]
        cx = (gx.reshape(-1) + 0.5) * cell + preds[..., 1]
        bh = 1.8 * cell * torch.exp(preds[..., 2].clamp(-1, 1))
        bw = 2.4 * cell * torch.exp(preds[..., 3].clamp(-1, 1))
        boxes = torch.stack([cy - bh / 2, cx - bw / 2, cy + bh / 2, cx + bw / 2], -1)
        tb, ts, keep, _ = static_nms(boxes, obj, self.top_k)
        keep = keep & (ts > self.score_thr)
        return tb, ts, keep


@dataclasses.dataclass
class TwoStageDetector:
    """Faster-R-CNN-ish: stage 1 proposes variable-count regions (host
    extraction), stage 2 refines each on host — O(n) + O(n²) NMS in the
    proposal count."""

    channels: int = 16
    proposal_thr: float = 0.55
    refine_flops: int = 24           # per-proposal host work (feature dot)
    # host copy of params["refine"], keyed on the tensor object: without it
    # every post_host call would read the refinement head back from the
    # device once per frame
    _refine_src: object = dataclasses.field(
        default=None, repr=False, compare=False)
    _refine_host: object = dataclasses.field(
        default=None, repr=False, compare=False)

    def _refine(self, params) -> np.ndarray:
        dev = params["refine"]
        if self._refine_src is not dev:
            self._refine_src = dev
            self._refine_host = dev.cpu().numpy()
        return self._refine_host

    def specs(self) -> dict:
        c = self.channels
        return {
            "backbone": backbone_specs(c),
            "rpn": ParamSpec((c, 1), (None, None), scale=1.0),
            "refine": ParamSpec((c, 5), (None, None), scale=1.0),
        }

    def init(self, generator: torch.Generator, device: str | torch.device = "cuda") -> dict:
        return init_detector_params(self.specs(), generator, device)

    def infer_device(self, params, image: torch.Tensor):
        """Stage 1 on device: objectness map + features (fixed shape).

        Objectness is a matched filter for object-like blobs — pooled
        brightness above the scene floor (objects are bright filled
        rectangles; lanes are thin and dilute under 8×8 pooling; rain fog
        pulls cells toward gray and below threshold).  The conv features
        feed the stage-2 refinement.  ``image`` (H, W, 3) or a batch
        (B, H, W, 3), whose outputs lead with B.
        """
        if image.ndim == 3:
            feat, obj = self.infer_device(params, image[None])
            return feat[0], obj[0]
        img = _unit_luma(image)
        obj = torch.sigmoid(12.0 * (_pool(img, 8, "avg") - 0.55))
        feat = backbone_apply(params["backbone"], image)
        return feat, obj

    def post_host(self, params, feat: np.ndarray, obj: np.ndarray):
        """Host post-processing whose cost scales with the proposal count
        (the paper's Fig. 5/11 mechanism). Returns (boxes, n_proposals)."""
        ys, xs = np.nonzero(obj > self.proposal_thr)       # variable length!
        n = len(ys)
        refine = self._refine(params)
        boxes = np.zeros((n, 4), np.float32)
        scores = np.zeros((n,), np.float32)
        for i in range(n):                                  # per-proposal work
            f = feat[ys[i], xs[i]]
            # RoI refinement: a few feature-space iterations per proposal
            for _ in range(8):
                f = np.tanh(f + 0.1 * (f @ refine[:, :1]) * refine[:, 0])
            out = f @ refine                                # (5,)
            cy = (ys[i] + 0.5) * 8.0 + out[1]
            cx = (xs[i] + 0.5) * 8.0 + out[2]
            # box prior matched to the scene generator's object statistics
            # (the refinement head supplies residuals around it)
            bh = 16.0 * np.exp(np.clip(out[3], -1, 1))
            bw = 20.0 * np.exp(np.clip(out[4], -1, 1))
            boxes[i] = (cy - bh / 2, cx - bw / 2, cy + bh / 2, cx + bw / 2)
            scores[i] = 1.0 / (1.0 + np.exp(-out[0]))
        if n:
            keep = dynamic_nms(boxes, scores)
            boxes = boxes[keep]
        return boxes, n

    def post_host_batch(
        self,
        params,
        feat: np.ndarray,
        obj: np.ndarray,
        active: Optional[np.ndarray] = None,
    ):
        """``post_host`` over a (B, ...) batch in one vectorized pass.

        Proposals from every active slot are gathered into a single
        (N, C) matrix, the per-proposal RoI refinement runs as N-row
        matrix ops instead of a Python loop, and only the O(n²) NMS stays
        per image.  Same math as the serial path (same dtypes, same
        reduction axis), so outputs match ``post_host`` per slot.

        Returns a list of length B: ``(boxes, n_proposals)`` per active
        slot, ``None`` for inactive ones.
        """
        B = obj.shape[0]
        if active is None:
            active = np.ones(B, bool)
        masked = np.where(active[:, None, None], obj, -np.inf)
        bidx, ys, xs = np.nonzero(masked > self.proposal_thr)
        refine = self._refine(params)
        f = feat[bidx, ys, xs]                          # (N, C)
        for _ in range(8):
            f = np.tanh(f + 0.1 * (f @ refine[:, :1]) * refine[:, 0])
        out = f @ refine                                # (N, 5)
        cy = (ys + 0.5) * 8.0 + out[:, 1]
        cx = (xs + 0.5) * 8.0 + out[:, 2]
        bh = 16.0 * np.exp(np.clip(out[:, 3], -1, 1))
        bw = 20.0 * np.exp(np.clip(out[:, 4], -1, 1))
        boxes = np.stack(
            [cy - bh / 2, cx - bw / 2, cy + bh / 2, cx + bw / 2], -1
        ).astype(np.float32)
        scores = (1.0 / (1.0 + np.exp(-out[:, 0]))).astype(np.float32)
        results: list = []
        for b in range(B):
            if not active[b]:
                results.append(None)
                continue
            m = bidx == b
            bxs, n = boxes[m], int(m.sum())
            if n:
                bxs = bxs[dynamic_nms(bxs, scores[m])]
            results.append((bxs, n))
        return results
