# Toy pipeline elements: arithmetic diamonds, inspection, metrics.
#
# Counterpart of aiko_services_tpu/elements/toys.py, with the same class
# names, parameters and outputs (PE_0..PE_4-style arithmetic for fan-out
# and fan-in graphs, PE_Inspect, PE_Metrics, the seeded sources).  Two
# elements meet tensors: PE_Busy multiplies a tensor input where it lies
# (a CUDA tensor stays on the card, so micro-batching coalesces it as in
# the JAX package), and PE_Sum reads a tensor back to the host before
# numpy's sum (np.sum on a CUDA tensor raises), so both packages give the
# same float for the same values.

from __future__ import annotations

import time

import numpy as np

from ..pipeline import PipelineElement, StreamEvent
from ..utils import get_logger
from .common_io import DataSource, host_array

__all__ = ["PE_Number", "PE_Add", "PE_Busy", "PE_Multiply", "PE_Sum2",
           "PE_Inspect", "PE_Metrics", "PE_RandomIntegers",
           "PE_RandomTensor", "PE_Sum"]

_LOGGER = get_logger("toys")


class PE_Number(DataSource):
    """Emits frames {"number": n} from data_sources items."""

    def read_item(self, stream, item) -> dict:
        return {"number": int(item)}


class PE_Add(PipelineElement):
    def process_frame(self, stream, number):
        constant = int(self.get_parameter("constant", 1, stream))
        return StreamEvent.OKAY, {"number": int(number) + constant}


class PE_Multiply(PipelineElement):
    def process_frame(self, stream, number):
        constant = int(self.get_parameter("constant", 2, stream))
        return StreamEvent.OKAY, {"number": int(number) * constant}


class PE_Busy(PipelineElement):
    """PE_Multiply with a FIXED host cost per frame (`work_ms`): models
    a replica's service time, so capacity-sensitive benches and tests
    control the floor classification (compute vs queue wait) instead of
    the host machine.  Output stays deterministic (number x constant).
    Array and tensor inputs multiply elementwise where they lie
    (shape-preserving), so the element coalesces under micro-batching;
    scalar ints stay exact integers."""

    def process_frame(self, stream, number):
        time.sleep(  # the modelled service time  # aiko: allow
            float(self.get_parameter("work_ms", 2, stream)) / 1000.0)
        constant = int(self.get_parameter("constant", 3, stream))
        if hasattr(number, "shape"):
            return StreamEvent.OKAY, {"number": number * constant}
        return StreamEvent.OKAY, {"number": int(number) * constant}


class PE_Sum2(PipelineElement):
    """Fan-in join: sums two inputs (use with map_in for diamond graphs)."""

    def process_frame(self, stream, a, b):
        return StreamEvent.OKAY, {"number": int(a) + int(b)}


class PE_Inspect(PipelineElement):
    """Dump chosen swag keys to the log and a stream variable."""

    def process_frame(self, stream, **inputs):
        inspected = stream.variables.setdefault("inspected", [])
        inspected.append(dict(inputs))
        if self.get_parameter("log", False, stream):
            _LOGGER.info("%s inspect: %s", self.definition.name, inputs)
        return StreamEvent.OKAY, dict(inputs)


class PE_Metrics(PipelineElement):
    """Report per-element frame timings, read from the frame metrics the
    pipeline engine accumulates."""

    def process_frame(self, stream, **inputs):
        frame = stream.frames.get(max(stream.frames) if stream.frames
                                  else None)
        metrics = dict(frame.metrics) if frame else {}
        history = stream.variables.setdefault("metrics_history", [])
        history.append(metrics)
        if self.get_parameter("log", False, stream):
            _LOGGER.info("metrics: %s", metrics)
        return StreamEvent.OKAY, {}


class PE_RandomIntegers(DataSource):
    """Deterministic pseudo-random integer source: data_sources items are
    seeds; emits {"number": value}."""

    def read_item(self, stream, item) -> dict:
        seed = int(item)
        value = (seed * 1103515245 + 12345) % 2147483648
        return {"number": value % 100}


class PE_RandomTensor(DataSource):
    """Tensor source for data-plane load tests: data_sources items are
    element counts; emits {"values": float32 array} (deterministic)."""

    def read_item(self, stream, item) -> dict:
        count = int(item)
        rng = np.random.default_rng(count)
        return {"values": rng.standard_normal(count).astype(np.float32)}


class PE_Sum(PipelineElement):
    """Reduce a tensor input to its scalar sum (numpy's, on the host)."""

    def process_frame(self, stream, values):
        return StreamEvent.OKAY, {
            "number": float(np.sum(host_array(values)))}
