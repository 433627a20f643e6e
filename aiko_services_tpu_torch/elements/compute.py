# Source, toy compute and boundary elements for compute pipelines: seeded
# tensor and token sources, the multi-modal (audio + image) source that
# drives the config-5 graph, the two smallest ComputeElements (JaxScale,
# JaxMLP: examples/pipeline_compute.json names them, so they keep the JAX
# package's class names) and the device -> host boundary.
#
# Counterpart of aiko_services_tpu/elements/compute.py.  The host paths
# are the JAX package's numpy code, so both packages emit the same
# frames.  JaxMLP draws its weights from a torch.Generator seeded with
# `seed` (jax.random's numbers cannot be reproduced); it computes what the
# JAX element computes on the same weights (gelu is jax.nn.gelu's tanh
# approximation).  With
# `on_device: true` MultiModalSource synthesizes its batch on the
# element's device (the `device` parameter, CUDA unless the definition
# asks for the CPU): the tones are the same f32 formula, the images come
# from a torch.Generator seeded per row with the row's seed -- the JAX
# package's jax.random bits cannot be reproduced, so on-device images
# differ from its images (and from the host path's).

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.device import resolve_device
from ..parallel.mesh import Sharded, unshard
from ..pipeline import ComputeElement, StreamEvent
from .common_io import DataSource

__all__ = ["ArraySource", "TokenSource", "MultiModalSource", "JaxScale",
           "JaxMLP", "ToHost"]


class ArraySource(DataSource):
    """Emits {"tensor": ndarray} frames; data_sources items give shapes,
    e.g. [[8, 16], [8, 16]] emits two 8x16 arrays (seeded, deterministic)."""

    def read_item(self, stream, item) -> dict:
        shape = tuple(int(size) for size in item)
        rng = np.random.default_rng(
            int(self.get_parameter("seed", 0, stream))
            + self.emission_index(stream))
        return {"tensor": rng.standard_normal(shape, dtype=np.float32)}


class TokenSource(DataSource):
    """Emits {"tokens": (B, L) int32} frames: data_sources [[batch, seq]],
    repeated `count` times (load-generator for LM pipelines/benchmarks)."""

    def start_stream(self, stream, stream_id):
        items = self.get_parameter("data_sources", [[8, 128]], stream)
        shapes = [tuple(int(size) for size in item) for item in items]
        count = int(self.get_parameter("count", 1, stream))
        name = self.definition.name
        stream.variables[f"{name}.shapes"] = shapes
        stream.variables[f"{name}.remaining"] = count
        rate = self.get_parameter("rate", None, stream)
        self.create_frames(stream, self._generate,
                           rate=float(rate) if rate else None)
        return StreamEvent.OKAY, None

    def _generate(self, stream, frame_id):
        import time
        name = self.definition.name
        remaining = stream.variables[f"{name}.remaining"]
        if remaining <= 0:
            return StreamEvent.STOP, {"diagnostic": "count exhausted"}
        stream.variables[f"{name}.remaining"] = remaining - 1
        shapes = stream.variables[f"{name}.shapes"]
        index = self.emission_index(stream)
        shape = shapes[index % len(shapes)]  # cycle all configured shapes
        vocab = int(self.get_parameter("vocab_size", 8192, stream))
        rng = np.random.default_rng(
            int(self.get_parameter("seed", 0, stream)) + index)
        # t0 rides the swag so consumers can measure true frame latency
        # (declare a "t0" output port to propagate it)
        return StreamEvent.OKAY, {
            "tokens": rng.integers(0, vocab, shape, dtype=np.int32),
            "t0": time.time()}


class MultiModalSource(DataSource):
    """Emits {"audio", "image"} frames: items are [frequency_hz, seconds]
    tone specs plus a synthetic image (parameter image_shape, default
    [3, 32, 32]) -- the hermetic source for multi-modal pipelines.

    `on_device: false` (the default): numpy on the host, bit-identical to
    the JAX package's frames.  `on_device: true`: the whole row batch is
    synthesized on the element's device (read_batch) -- tones in f32, and
    each row's image from a torch.Generator seeded with that row's seed
    (not the JAX package's jax.random bits)."""

    def _device(self) -> torch.device:
        return resolve_device(self.get_parameter("device", "cuda"))

    def read_item(self, stream, item) -> dict:
        from .audio_io import synthesize_tone, synthesize_tone_on_device
        from .image_io import synthesize_image, synthesize_image_on_device
        shape = self.get_parameter("image_shape", [3, 32, 32], stream)
        seed = (int(self.get_parameter("seed", 0, stream))
                + self.emission_index(stream))
        if self.get_parameter("on_device", False, stream):
            device = self._device()
            return {
                "audio": synthesize_tone_on_device(
                    float(item[0]), float(item[1]), device=device),
                "image": synthesize_image_on_device(shape, seed, device),
            }
        return {
            "audio": synthesize_tone(float(item[0]), float(item[1])),
            "image": synthesize_image(shape, seed),
        }

    def read_batch(self, stream, items) -> dict | None:
        """Whole-row-batch synthesis on the device: (B, samples) tones in
        one call and one generator-seeded image per row.  The host path
        and ragged tone lengths fall back to per-item reads."""
        from .audio_io import synthesize_tone_on_device
        from .image_io import synthesize_image_on_device
        if not self.get_parameter("on_device", False, stream):
            return None
        seconds = float(items[0][1])
        if any(float(item[1]) != seconds for item in items):
            return None  # ragged lengths cannot stack
        shape = tuple(int(size) for size in self.get_parameter(
            "image_shape", [3, 32, 32], stream))
        base_seed = int(self.get_parameter("seed", 0, stream))
        seeds = [base_seed + self.emission_index(stream) for _ in items]
        device = self._device()
        audio = synthesize_tone_on_device(
            [float(item[0]) for item in items], seconds, device=device)
        image = torch.stack([synthesize_image_on_device(shape, seed, device)
                             for seed in seeds])
        return {"audio": audio, "image": image}


class JaxScale(ComputeElement):
    """tensor -> tensor * scale + offset: a stateless ComputeElement.
    scale/offset are dynamic parameters, so live updates (dashboard, EC
    share, stream overrides) apply to the next frame."""

    def dynamic_parameters(self, stream):
        return {"scale": float(self.get_parameter("scale", 2.0, stream)),
                "offset": float(self.get_parameter("offset", 0.0, stream))}

    def compute(self, state, tensor, scale, offset):
        return {"tensor": tensor * scale + offset}


class JaxMLP(ComputeElement):
    """Two-layer MLP over the last axis: a stateful ComputeElement whose
    params live on the element's mesh (definition "sharding" block).
    Weights N(0, 1/fan_in) from a torch.Generator seeded with `seed`,
    biases zero, as the JAX element draws them (not its numbers)."""

    def setup(self):
        features = int(self.get_parameter("features", 16))
        hidden = int(self.get_parameter("hidden", 32))
        generator = torch.Generator().manual_seed(
            int(self.get_parameter("seed", 0)))
        w1 = torch.randn((features, hidden), generator=generator)
        w2 = torch.randn((hidden, features), generator=generator)
        return {
            "w1": (w1 / np.sqrt(features)).to(self.device),
            "b1": torch.zeros((hidden,), device=self.device),
            "w2": (w2 / np.sqrt(hidden)).to(self.device),
            "b2": torch.zeros((features,), device=self.device),
        }

    @staticmethod
    def _mlp(state, tensor):
        state = {name: leaf.to(tensor.device) for name, leaf in state.items()}
        hidden = F.gelu(tensor @ state["w1"] + state["b1"],
                        approximate="tanh")
        return hidden @ state["w2"] + state["b2"]

    def compute(self, state, tensor):
        if isinstance(tensor, Sharded):
            # an input cut over the mesh's "data" axis: each block on its
            # position's device, the output whole on the mesh's home (as
            # the model paths return theirs)
            return {"tensor": unshard(tensor.map(
                lambda block: self._mlp(state, block)))}
        return {"tensor": self._mlp(state, tensor)}


class ToHost(ComputeElement):
    """Device -> host boundary: returns the tensor as numpy (the explicit
    sink-side transfer point; everything upstream stays on the device)."""

    def process_frame(self, stream, tensor):
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().cpu()
        return StreamEvent.OKAY, {"tensor": np.asarray(tensor)}
