# Single-stage anchor-free object detector (YOLO-family architecture).
#
# Counterpart of aiko_services_tpu/models/detector.py (config, parameters,
# forward, box decode, NMS, detect and the single-object train step).  Same parameter tree (HWIO conv weights), same casts: a conv
# backbone to stride 16 in NHWC (layers.conv2d), an anchor-free head
# (cx, cy, w, h, objectness, classes per cell), box decode and fixed-size
# exact greedy NMS, run eagerly on the device the tensors lie on.
#
# The NMS keeps the JAX package's formulation -- greedy NMS as the fixed
# point of a Jacobi iteration over the score-sorted candidates -- for all
# images of the batch at once on a (B, T, T) mask.  Rounds past the fixed
# point change nothing, so the host checks for it only once every
# _ROUNDS_PER_CHECK rounds.  lax.top_k puts the lower index first on ties;
# torch.topk makes no such promise, so candidates are ranked by a stable
# descending sort.

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.device import resolve_device
from .layers import conv2d, init_conv
from .optim import apply_updates, value_and_grad

__all__ = ["DetectorConfig", "init_detector_params", "detect",
           "detector_forward", "decode_boxes", "non_max_suppression",
           "make_detector_train_step"]

_ROUNDS_PER_CHECK = 4


@dataclass(frozen=True)
class DetectorConfig:
    n_classes: int = 16
    base_channels: int = 32
    image_size: int = 256          # square input, multiple of 16
    stride: int = 16
    max_detections: int = 32
    score_threshold: float = 0.25
    iou_threshold: float = 0.45
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def grid_size(self) -> int:
        return self.image_size // self.stride


def init_detector_params(config: DetectorConfig, generator: torch.Generator,
                         device="cuda") -> dict:
    """Random parameters drawn on the CPU from `generator`, cast to
    config.dtype and placed on `device` (the JAX package's distributions,
    not its numbers)."""
    device = resolve_device(device)
    c = config.base_channels
    dtype = config.torch_dtype
    stages = {
        "stem": (3, c, 3), "stage1": (c, c * 2, 3),
        "block1": (c * 2, c * 2, 3), "stage2": (c * 2, c * 4, 3),
        "block2": (c * 4, c * 4, 3), "stage3": (c * 4, c * 8, 3),
        "block3": (c * 8, c * 8, 3),
        "head": (c * 8, 5 + config.n_classes, 1),
    }
    return {name: init_conv(generator, c_in, c_out, kernel, dtype,
                            device=device)
            for name, (c_in, c_out, kernel) in stages.items()}


def detector_forward(params: dict, config: DetectorConfig, images):
    """images (B, 3, H, W) in [0, 1] -> raw head (B, 5+C, H/16, W/16):
    channels-first at the boundary, NHWC inside."""
    x = images.to(config.torch_dtype).permute(0, 2, 3, 1)     # -> NHWC
    x = F.silu(conv2d(params["stem"], x, stride=2))
    x = F.silu(conv2d(params["stage1"], x, stride=2))
    x = x + F.silu(conv2d(params["block1"], x))
    x = F.silu(conv2d(params["stage2"], x, stride=2))
    x = x + F.silu(conv2d(params["block2"], x))
    x = F.silu(conv2d(params["stage3"], x, stride=2))
    x = x + F.silu(conv2d(params["block3"], x))
    return conv2d(params["head"], x).permute(0, 3, 1, 2)     # -> NCHW


def decode_boxes(raw, config: DetectorConfig):
    """raw (B, 5+C, G, G) -> boxes (B, G*G, 4) xyxy in pixels f32,
    scores (B, G*G) f32, classes (B, G*G) int32."""
    batch, _, grid_h, grid_w = raw.shape
    raw = raw.float()
    stride = float(config.stride)
    cell_x = torch.arange(grid_w, dtype=torch.float32,
                          device=raw.device)[None, :]
    cell_y = torch.arange(grid_h, dtype=torch.float32,
                          device=raw.device)[:, None]
    center_x = (torch.sigmoid(raw[:, 0]) + cell_x) * stride
    center_y = (torch.sigmoid(raw[:, 1]) + cell_y) * stride
    width = torch.exp(torch.clamp(raw[:, 2], -8, 8)) * stride
    height = torch.exp(torch.clamp(raw[:, 3], -8, 8)) * stride
    objectness = torch.sigmoid(raw[:, 4])
    class_probs = torch.sigmoid(raw[:, 5:])            # (B, C, G, G)
    # torch.max returns the first maximum on ties, as jnp.argmax
    class_score, class_ids = torch.max(class_probs, dim=1)
    class_ids = class_ids.to(torch.int32)
    scores = (objectness * class_score).reshape(batch, -1)
    boxes = torch.stack([
        center_x - width / 2, center_y - height / 2,
        center_x + width / 2, center_y + height / 2], dim=-1)
    return (boxes.reshape(batch, -1, 4), scores,
            class_ids.reshape(batch, -1))


def _pairwise_iou(boxes):
    """(B, N, 4) xyxy -> (B, N, N) IoU."""
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    intersection = wh[..., 0] * wh[..., 1]
    areas = ((boxes[..., 2] - boxes[..., 0])
             * (boxes[..., 3] - boxes[..., 1]))
    union = areas[:, :, None] + areas[:, None, :] - intersection
    return intersection / torch.clamp_min(union, 1e-9)


def _top(scores, count: int):
    """lax.top_k on the last axis: the `count` largest, the lower index
    first among equal scores.  Returns (values, indices)."""
    values, order = torch.sort(scores, dim=-1, descending=True,
                               stable=True)
    return values[..., :count], order[..., :count]


def _gather_rows(values, order):
    """values (B, N, ...) indexed per image by order (B, K)."""
    rows = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[rows, order]


def _nms(boxes, scores, classes, config: DetectorConfig):
    """Batched exact greedy NMS: (B, N, 4), (B, N), (B, N) -> per image
    the top max_detections (boxes, scores, classes, valid), suppressed
    and below-threshold entries zeroed."""
    batch = scores.shape[0]
    deficit = config.max_detections - scores.shape[1]
    if deficit > 0:  # fewer candidates than output slots: zero-pad
        boxes = torch.cat([boxes, boxes.new_zeros((batch, deficit, 4))], 1)
        scores = torch.cat([scores, scores.new_zeros((batch, deficit))], 1)
        classes = torch.cat([classes,
                             classes.new_zeros((batch, deficit))], 1)
    top = min(config.max_detections * 4, scores.shape[1])
    top_scores, order = _top(scores, top)
    top_boxes = _gather_rows(boxes, order)
    top_classes = _gather_rows(classes, order)

    iou = _pairwise_iou(top_boxes.float())
    same_class = top_classes[:, :, None] == top_classes[:, None, :]
    index = torch.arange(top, device=scores.device)
    earlier = index[None, :] < index[:, None]
    # dominated[b, i, j]: higher-priority j suppresses i (when j is alive)
    dominated = (iou > config.iou_threshold) & same_class & earlier
    alive = torch.ones((batch, top), dtype=torch.bool,
                       device=scores.device)
    while True:
        for _ in range(_ROUNDS_PER_CHECK):
            previous = alive
            alive = ~torch.any(dominated & alive[:, None, :], dim=2)
        if torch.equal(alive, previous):
            break
    kept = torch.where(alive, top_scores, torch.zeros_like(top_scores))
    final_scores, final_order = _top(kept, config.max_detections)
    valid = final_scores > config.score_threshold
    return (_gather_rows(top_boxes, final_order) * valid[..., None],
            final_scores * valid,
            _gather_rows(top_classes, final_order) * valid,
            valid)


def non_max_suppression(boxes, scores, classes, config: DetectorConfig):
    """Fixed-size exact greedy NMS on one image: (N, 4), (N,), (N,) ->
    the top max_detections (boxes, scores, classes, valid), suppressed
    entries zeroed."""
    return tuple(value[0] for value in _nms(
        boxes[None], scores[None], classes[None], config))


def _sigmoid_binary_cross_entropy(logits, labels):
    """optax.sigmoid_binary_cross_entropy, elementwise:
    -labels log sigmoid(x) - (1 - labels) log sigmoid(-x)."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def make_detector_train_step(config: DetectorConfig, optimizer):
    """Returns train_step(params, opt_state, images, targets) -> (params,
    opt_state, loss) for single-object supervision; targets {"box": (B, 4)
    xyxy pixels, "class": (B,) int}.  The cell holding the box center is
    the positive: L2 on (sigmoid offsets, log sizes) there, objectness BCE
    over every cell (5x), class BCE at the positive.  The update is
    written into params and opt_state in place (the JAX step donates
    both)."""

    def loss_fn(params, images, boxes, classes):
        raw = detector_forward(params, config, images).float()
        batch, _, grid_h, grid_w = raw.shape
        stride = float(config.stride)
        center_x = (boxes[:, 0] + boxes[:, 2]) / 2.0
        center_y = (boxes[:, 1] + boxes[:, 3]) / 2.0
        cell_x = torch.clamp(torch.floor(center_x / stride).to(torch.int64),
                             0, grid_w - 1)
        cell_y = torch.clamp(torch.floor(center_y / stride).to(torch.int64),
                             0, grid_h - 1)
        rows = torch.arange(batch, device=raw.device)
        positive = raw[rows, :, cell_y, cell_x]              # (B, 5+C)
        target_dx = center_x / stride - cell_x.float()
        target_dy = center_y / stride - cell_y.float()
        target_w = torch.log(torch.clamp_min(
            (boxes[:, 2] - boxes[:, 0]) / stride, 1e-3))
        target_h = torch.log(torch.clamp_min(
            (boxes[:, 3] - boxes[:, 1]) / stride, 1e-3))
        box_loss = ((torch.sigmoid(positive[:, 0]) - target_dx) ** 2
                    + (torch.sigmoid(positive[:, 1]) - target_dy) ** 2
                    + (positive[:, 2] - target_w) ** 2
                    + (positive[:, 3] - target_h) ** 2)
        objectness = raw[:, 4]                               # (B, G, G)
        positive_mask = torch.zeros_like(objectness)
        positive_mask[rows, cell_y, cell_x] = 1.0
        objectness_loss = torch.mean(
            _sigmoid_binary_cross_entropy(objectness, positive_mask))
        class_targets = (classes.long()[:, None] == torch.arange(
            config.n_classes, device=raw.device)).float()
        class_loss = torch.mean(_sigmoid_binary_cross_entropy(
            positive[:, 5:], class_targets))
        return torch.mean(box_loss) + 5.0 * objectness_loss + class_loss

    def train_step(params, opt_state, images, targets):
        loss, grads = value_and_grad(
            loss_fn, params, images, targets["box"].float(),
            targets["class"])
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


@torch.no_grad()
def detect(params: dict, config: DetectorConfig, images):
    """images (B, 3, H, W) -> dict of per-image fixed-size detections:
    boxes (B, D, 4) f32, scores (B, D) f32, classes (B, D) int32, valid
    (B, D) bool."""
    raw = detector_forward(params, config, images)
    boxes, scores, classes = decode_boxes(raw, config)
    final_boxes, final_scores, final_classes, valid = _nms(
        boxes, scores, classes, config)
    return {"boxes": final_boxes, "scores": final_scores,
            "classes": final_classes, "valid": valid}
