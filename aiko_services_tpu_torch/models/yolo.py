# YOLOv8 (CSP backbone, PAN neck, decoupled DFL head) with ultralytics
# checkpoint ingestion.
#
# Counterpart of aiko_services_tpu/models/yolo.py: the config and the v8
# family, random init, BatchNorm folded into the convolutions at load time
# (in numpy f32, in the JAX package's order, so that both packages load
# bit-identical parameters from one file), the architecture read off a
# checkpoint's own shapes, the forward, the DFL box decode and detection
# through the native detector's NMS.  Same parameter tree (HWIO conv
# weights; the repeated C2f bottlenecks and the head's three scales in
# lists), NHWC activations (layers.conv2d), run eagerly on the device the
# tensors lie on.  The convolutions are cuDNN's, as the JAX package's are
# XLA's: no Pallas kernel there either.

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.device import resolve_device
from .detector import _nms
from .layers import conv2d, init_conv

__all__ = ["YoloV8Config", "YOLOV8N", "YOLO_VARIANTS",
           "init_yolo_params", "infer_yolov8_config",
           "load_yolov8_params", "yolo_forward", "yolo_detect"]

_BN_EPS = 1e-3  # ultralytics Conv uses BatchNorm2d(eps=0.001)


@dataclass(frozen=True)
class YoloV8Config:
    n_classes: int = 80
    # channels after: stem(P1), P2, P3, P4, P5
    width: tuple = (16, 32, 64, 128, 256)
    # C2f bottleneck repeats at P2..P5 (the neck's C2fs repeat
    # neck_repeats times)
    repeats: tuple = (1, 2, 2, 1)
    neck_repeats: int = 1
    reg_max: int = 16
    strides: tuple = (8, 16, 32)
    image_size: int = 640
    max_detections: int = 300
    score_threshold: float = 0.25
    iou_threshold: float = 0.45
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_box_channels(self) -> int:
        return 4 * self.reg_max

    @property
    def head_cls_hidden(self) -> int:
        # ultralytics Detect: c3 = max(ch[0], min(nc, 100))
        return max(self.width[2], min(self.n_classes, 100))

    @property
    def head_box_hidden(self) -> int:
        # ultralytics Detect: c2 = max(16, ch[0] // 4, reg_max * 4)
        return max(16, self.width[2] // 4, self.reg_max * 4)


YOLOV8N = YoloV8Config()

# the published v8 family (ultralytics width/depth multiples on the base
# (64, 128, 256, 512, 1024) channel ladder with per-variant
# max_channels; repeats = round(base (3, 6, 6, 3) * depth))
YOLO_VARIANTS = {
    "n": YoloV8Config(),
    "s": YoloV8Config(width=(32, 64, 128, 256, 512)),
    "m": YoloV8Config(width=(48, 96, 192, 384, 576),
                      repeats=(2, 4, 4, 2), neck_repeats=2),
    "l": YoloV8Config(width=(64, 128, 256, 512, 512),
                      repeats=(3, 6, 6, 3), neck_repeats=3),
    "x": YoloV8Config(width=(80, 160, 320, 640, 640),
                      repeats=(3, 6, 6, 3), neck_repeats=3),
}


# -- parameter construction --------------------------------------------------

def init_yolo_params(config: YoloV8Config, generator: torch.Generator,
                     device="cuda") -> dict:
    """Random parameters with the exact structure the ultralytics loader
    produces, drawn on the CPU from `generator` (N(0, 1/fan_in) weights,
    zero biases: the JAX package's distributions, not its numbers), cast
    to config.dtype and placed on `device`."""
    device = resolve_device(device)
    dtype = config.torch_dtype

    def conv(c_in, c_out, kernel):
        return init_conv(generator, c_in, c_out, kernel, dtype,
                         device=device)

    def c2f(c_in, c_out, n):
        half = c_out // 2
        return {"cv1": conv(c_in, c_out, 1),
                "cv2": conv((2 + n) * half, c_out, 1),
                "m": [{"cv1": conv(half, half, 3), "cv2": conv(half, half, 3)}
                      for _ in range(n)]}

    w, r, nr = config.width, config.repeats, config.neck_repeats
    params = {
        "m0": conv(3, w[0], 3), "m1": conv(w[0], w[1], 3),
        "m2": c2f(w[1], w[1], r[0]), "m3": conv(w[1], w[2], 3),
        "m4": c2f(w[2], w[2], r[1]), "m5": conv(w[2], w[3], 3),
        "m6": c2f(w[3], w[3], r[2]), "m7": conv(w[3], w[4], 3),
        "m8": c2f(w[4], w[4], r[3]),
        "m9": {"cv1": conv(w[4], w[4] // 2, 1), "cv2": conv(w[4] * 2, w[4], 1)},
        "m12": c2f(w[4] + w[3], w[3], nr),
        "m15": c2f(w[3] + w[2], w[2], nr),
        "m16": conv(w[2], w[2], 3),
        "m18": c2f(w[3] + w[2], w[3], nr),
        "m19": conv(w[3], w[3], 3),
        "m21": c2f(w[4] + w[3], w[4], nr),
    }
    box_c, cls_c = config.head_box_hidden, config.head_cls_hidden
    head = {"cv2": [], "cv3": []}
    for c_in in (w[2], w[3], w[4]):
        head["cv2"].append([conv(c_in, box_c, 3), conv(box_c, box_c, 3),
                            conv(box_c, config.head_box_channels, 1)])
        head["cv3"].append([conv(c_in, cls_c, 3), conv(cls_c, cls_c, 3),
                            conv(cls_c, config.n_classes, 1)])
    params["m22"] = head
    return params


# -- ultralytics checkpoint ingestion ----------------------------------------

def _fold_bn(weight, gamma, beta, mean, var) -> dict:
    """Fold BatchNorm into the conv, in numpy f32 as the JAX package
    does: w' = w * g/sqrt(v+eps) per output channel, b' = beta - mean *
    g/sqrt(v+eps), torch (O, I, kh, kw) -> HWIO.  Left in f32: the cast
    to the compute dtype comes last, once."""
    scale = gamma / np.sqrt(var + _BN_EPS)
    folded = weight * scale[:, None, None, None]
    bias = beta - mean * scale
    return {"w": np.ascontiguousarray(folded.transpose(2, 3, 1, 0)),
            "b": bias}


def _ultralytics_prefix(index) -> str:
    prefix = "" if "model.0.conv.weight" in index else "model."
    if prefix + "model.0.conv.weight" not in index:
        raise KeyError("not an ultralytics YOLOv8 checkpoint: missing "
                       "model.0.conv.weight")
    return prefix


def infer_yolov8_config(paths, **overrides) -> YoloV8Config:
    """The family layout (width ladder, C2f repeats, n_classes, reg_max)
    read off an ultralytics checkpoint's own tensor shapes: any v8 variant
    (or custom width) loads without naming it.  `overrides` set the
    non-architectural fields (image_size, thresholds, dtype)."""
    from .weights import open_checkpoint
    with open_checkpoint(paths) as (index, _raw):
        prefix = _ultralytics_prefix(index)

        def out_channels(name):
            return index[prefix + name].shape(prefix + name)[0]

        def repeats_of(module):
            count = 0
            while (f"{prefix}model.{module}.m.{count}.cv1.conv.weight"
                   in index):
                count += 1
            return max(count, 1)

        return YoloV8Config(
            width=tuple(out_channels(f"model.{i}.conv.weight")
                        for i in (0, 1, 3, 5, 7)),
            repeats=(repeats_of(2), repeats_of(4), repeats_of(6),
                     repeats_of(8)),
            neck_repeats=repeats_of(12),
            n_classes=out_channels("model.22.cv3.0.2.weight"),
            reg_max=out_channels("model.22.cv2.0.2.weight") // 4,
            **overrides)


def load_yolov8_params(paths, config: YoloV8Config, device="cuda") -> dict:
    """Ultralytics YOLOv8 naming ("model.0.conv.weight",
    "model.2.m.0.cv1.bn.running_mean", "model.22.cv3.1.2.bias"; an extra
    "model." prefix is handled) -> this module's tree, BatchNorm folded,
    in config.dtype on `device` (CUDA unless the caller asks for the
    CPU).  The fixed DFL conv is an arange and is not read."""
    from .weights import open_checkpoint
    device = resolve_device(device)
    dtype = config.torch_dtype
    with open_checkpoint(paths) as (index, fetch):
        prefix = _ultralytics_prefix(index)
        name = prefix + "model.0.conv.weight"
        stem_out = index[name].shape(name)[0]
        if stem_out != config.width[0]:
            variants = {cfg.width[0]: variant
                        for variant, cfg in YOLO_VARIANTS.items()}
            hint = variants.get(stem_out)
            raise ValueError(
                f"checkpoint stem has {stem_out} channels but the config "
                f"expects width {config.width}"
                + (f" -- this looks like yolov8{hint}; set the "
                   f"yolo_variant parameter (or YOLO_VARIANTS[{hint!r}])"
                   if hint else ""))

        def raw(stem):
            return fetch(prefix + stem).float().numpy()

        def placed(entry):
            return {key: torch.from_numpy(value).to(device=device,
                                                    dtype=dtype)
                    for key, value in entry.items()}

        def conv_bn(stem):
            return placed(_fold_bn(
                raw(f"{stem}.conv.weight"), raw(f"{stem}.bn.weight"),
                raw(f"{stem}.bn.bias"), raw(f"{stem}.bn.running_mean"),
                raw(f"{stem}.bn.running_var")))

        def plain_conv(stem):
            return placed({"w": np.ascontiguousarray(
                raw(f"{stem}.weight").transpose(2, 3, 1, 0)),
                "b": raw(f"{stem}.bias")})

        def c2f(module, n):
            return {"cv1": conv_bn(f"model.{module}.cv1"),
                    "cv2": conv_bn(f"model.{module}.cv2"),
                    "m": [{"cv1": conv_bn(f"model.{module}.m.{i}.cv1"),
                           "cv2": conv_bn(f"model.{module}.m.{i}.cv2")}
                          for i in range(n)]}

        r, nr = config.repeats, config.neck_repeats
        params = {
            "m0": conv_bn("model.0"), "m1": conv_bn("model.1"),
            "m2": c2f(2, r[0]), "m3": conv_bn("model.3"),
            "m4": c2f(4, r[1]), "m5": conv_bn("model.5"),
            "m6": c2f(6, r[2]), "m7": conv_bn("model.7"),
            "m8": c2f(8, r[3]),
            "m9": {"cv1": conv_bn("model.9.cv1"),
                   "cv2": conv_bn("model.9.cv2")},
            "m12": c2f(12, nr), "m15": c2f(15, nr),
            "m16": conv_bn("model.16"),
            "m18": c2f(18, nr), "m19": conv_bn("model.19"),
            "m21": c2f(21, nr),
        }
        head = {"cv2": [], "cv3": []}
        for scale in range(3):
            head["cv2"].append([conv_bn(f"model.22.cv2.{scale}.0"),
                                conv_bn(f"model.22.cv2.{scale}.1"),
                                plain_conv(f"model.22.cv2.{scale}.2")])
            head["cv3"].append([conv_bn(f"model.22.cv3.{scale}.0"),
                                conv_bn(f"model.22.cv3.{scale}.1"),
                                plain_conv(f"model.22.cv3.{scale}.2")])
        params["m22"] = head
        return params


# -- forward -----------------------------------------------------------------

def _conv(params, x, stride=1):
    return F.silu(conv2d(params, x, stride=stride))


def _c2f_forward(params, x, shortcut: bool):
    y = _conv(params["cv1"], x)
    half = y.shape[-1] // 2
    parts = [y[..., :half], y[..., half:]]
    for bottleneck in params["m"]:
        h = _conv(bottleneck["cv2"], _conv(bottleneck["cv1"], parts[-1]))
        parts.append(parts[-1] + h if shortcut else h)
    return _conv(params["cv2"], torch.cat(parts, dim=-1))


def _max_pool5(x):
    """reduce_window(max, 5x5, stride 1, "SAME", init -inf) on NHWC: a
    5x5 max pool padded by 2 on every side (max_pool2d pads with -inf),
    taken on the channels-last NCHW view."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=5, stride=1,
                        padding=2).permute(0, 2, 3, 1)


def _sppf_forward(params, x):
    y = _conv(params["cv1"], x)
    pools = [y]
    for _ in range(3):
        pools.append(_max_pool5(pools[-1]))
    return _conv(params["cv2"], torch.cat(pools, dim=-1))


def _upsample2(x):
    """Nearest-neighbour 2x upsampling of NHWC."""
    batch, height, width, channels = x.shape
    x = x[:, :, None, :, None, :].expand(batch, height, 2, width, 2,
                                         channels)
    return x.reshape(batch, height * 2, width * 2, channels)


def yolo_forward(params: dict, config: YoloV8Config, images):
    """images (B, 3, H, W) in [0, 1] -> per-scale raw heads
    [(B, Hs, Ws, 4*reg_max + nc)] for strides 8/16/32 (NHWC inside)."""
    height, width = images.shape[2], images.shape[3]
    if height % 32 or width % 32:
        raise ValueError(
            f"yolov8 needs H and W divisible by 32 (5 stride-2 stages + "
            f"exact 2x upsampling), got {height}x{width}; resize or pad "
            f"first (e.g. the ImageResize element)")
    x = images.to(config.torch_dtype).permute(0, 2, 3, 1)
    x = _conv(params["m0"], x, stride=2)                     # P1
    x = _conv(params["m1"], x, stride=2)                     # P2
    x = _c2f_forward(params["m2"], x, shortcut=True)
    x = _conv(params["m3"], x, stride=2)                     # P3
    p3 = _c2f_forward(params["m4"], x, shortcut=True)
    x = _conv(params["m5"], p3, stride=2)                    # P4
    p4 = _c2f_forward(params["m6"], x, shortcut=True)
    x = _conv(params["m7"], p4, stride=2)                    # P5
    x = _c2f_forward(params["m8"], x, shortcut=True)
    p5 = _sppf_forward(params["m9"], x)

    # PAN neck: top-down then bottom-up
    n4 = _c2f_forward(params["m12"], torch.cat([_upsample2(p5), p4], -1),
                      shortcut=False)
    n3 = _c2f_forward(params["m15"], torch.cat([_upsample2(n4), p3], -1),
                      shortcut=False)
    d4 = _c2f_forward(params["m18"], torch.cat(
        [_conv(params["m16"], n3, stride=2), n4], -1), shortcut=False)
    d5 = _c2f_forward(params["m21"], torch.cat(
        [_conv(params["m19"], d4, stride=2), p5], -1), shortcut=False)

    outputs = []
    for scale, feature in enumerate((n3, d4, d5)):
        branches = []
        for name in ("cv2", "cv3"):                 # box, class
            h = feature
            for index, stage in enumerate(params["m22"][name][scale]):
                # the last conv of each branch has no activation
                h = _conv(stage, h) if index < 2 else conv2d(stage, h)
            branches.append(h)
        outputs.append(torch.cat(branches, dim=-1))
    return outputs


def _decode_scale(raw, stride: float, config: YoloV8Config):
    """raw (B, H, W, 4*reg_max + nc) -> boxes (B, H*W, 4) xyxy pixels,
    scores (B, H*W), classes (B, H*W) int32.  DFL: a softmax over reg_max
    bins (f32) gives the expected l/t/r/b distance from the cell center,
    in stride units."""
    batch, height, width, _ = raw.shape
    reg_max = config.reg_max
    box_logits = raw[..., :4 * reg_max].float().reshape(
        batch, height, width, 4, reg_max)
    bins = torch.arange(reg_max, dtype=torch.float32, device=raw.device)
    distances = torch.sum(torch.softmax(box_logits, dim=-1) * bins, dim=-1)
    cx = (torch.arange(width, dtype=torch.float32, device=raw.device)
          + 0.5)[None, :]
    cy = (torch.arange(height, dtype=torch.float32, device=raw.device)
          + 0.5)[:, None]
    boxes = torch.stack([(cx - distances[..., 0]) * stride,
                         (cy - distances[..., 1]) * stride,
                         (cx + distances[..., 2]) * stride,
                         (cy + distances[..., 3]) * stride], dim=-1)
    class_probs = torch.sigmoid(raw[..., 4 * reg_max:].float())
    # torch.max returns the first maximum on ties, as jnp.argmax
    scores, classes = torch.max(class_probs, dim=-1)
    return (boxes.reshape(batch, -1, 4), scores.reshape(batch, -1),
            classes.to(torch.int32).reshape(batch, -1))


@torch.no_grad()
def yolo_detect(params: dict, config: YoloV8Config, images):
    """images (B, 3, H, W) -> the detector's fixed-size contract: boxes
    (B, D, 4) f32, scores (B, D) f32, classes (B, D) int32, valid (B, D)
    bool, through the same exact greedy NMS (detector._nms)."""
    decoded = [_decode_scale(raw, float(stride), config)
               for raw, stride in zip(yolo_forward(params, config, images),
                                      config.strides)]
    boxes, scores, classes = (torch.cat(parts, dim=1)
                              for parts in zip(*decoded))
    final_boxes, final_scores, final_classes, valid = _nms(
        boxes, scores, classes, config)
    return {"boxes": final_boxes, "scores": final_scores,
            "classes": final_classes, "valid": valid}
