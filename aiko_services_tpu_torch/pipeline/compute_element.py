# ComputeElement: the device compute contract for pipeline elements.
#
# Counterpart of aiko_services_tpu/pipeline/tpu_element.py.  Element math
# is a PyTorch function over tensors on the element's device:
#
#   class MyElement(ComputeElement):
#       def setup(self) -> state:            # build params (a dict tree) once
#       def compute(self, state, **inputs):  # tensors in -> outputs dict
#       def dynamic_parameters(self, stream) -> dict   # optional: per-frame
#           # values passed to compute as 0-d tensors
#
# The device is the `device` parameter (element, else pipeline), "cuda"
# unless the definition asks for "cpu"; asking for CUDA where there is none
# raises when the element is built.  There is no jit: compute runs
# eagerly.  Variable axes still pad to power-of-two buckets (bucket_axes)
# and outputs are un-padded afterwards, so shapes stay those the JAX
# package sees.  Outputs stay on the device (torch.Tensor in the swag), so
# a downstream ComputeElement never touches the host.
#
# Not ported yet: the mesh (`sharding` block), which raises.

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from ..ops.device import as_device_array, resolve_device
from ..utils import get_logger
from ..utils.padding import bucket_length, pad_axis_to  # noqa: F401
from ..utils.tree import tree_map
from .definition import DefinitionError
from .element import PipelineElement
from .stream import Stream, StreamEvent

__all__ = ["ComputeElement", "bucket_length", "pad_axis_to"]

_LOGGER = get_logger("compute_element")


class ComputeElement(PipelineElement):
    """PipelineElement whose math is a PyTorch function on one device.

    Definition parameters understood by the engine:
      device:          "cuda" (default), "cuda:N" or "cpu"
      bucket_axes:     {input_name: axis_index} -- pad that axis to a bucket
      bucket_min:      minimum bucket size (default 16)
      buckets:         explicit bucket ladder, e.g. [128, 512, 2048]
      unpad_outputs:   slice bucket padding off outputs whose bucketed axis
                       matches the padded input size (default True)
      blocking_metrics: bool -- synchronize the device inside the timing
                       window

    If compute() declares a `lengths` keyword, the engine passes a dict
    {input_name: int32 0-d tensor} of pre-padding lengths so kernels can
    mask padded positions.
    """

    def __init__(self, process, pipeline, definition):
        super().__init__(process, pipeline, definition)
        if definition.sharding:
            raise DefinitionError(
                f"{definition.name}: the `sharding` block (device mesh) is "
                f"not yet ported to the torch port")
        self.device = resolve_device(self.get_parameter("device", "cuda"))
        self._bucket_axes = dict(
            self.get_parameter("bucket_axes", {}) or {})
        self._bucket_min = int(self.get_parameter("bucket_min", 16))
        self._buckets = self.get_parameter("buckets", None)
        self._unpad_outputs = bool(
            self.get_parameter("unpad_outputs", True))
        self._blocking_metrics = bool(
            self.get_parameter("blocking_metrics", False))
        self.state = None
        self._ready = False
        self._accepts_lengths = False
        self._group_kernel_fn = None

    # -- the compute contract (override these) -----------------------------

    def setup(self):
        """Build the element's device state (a dict tree of tensors on
        self.device); called lazily before the first frame.  Return None
        for stateless elements."""
        return None

    def compute(self, state, **inputs) -> dict:
        """Tensors in, dict of outputs out.  No side effects."""
        raise NotImplementedError

    def dynamic_parameters(self, stream: Stream) -> dict:
        """Per-frame parameter values passed to compute as 0-d tensors.
        Read get_parameter(...) here for live-updatable values."""
        return {}

    # -- engine ------------------------------------------------------------

    def configure(self) -> None:
        """Idempotent pre-state configuration hook: build self.config here
        (NOT in setup) so the checkpoint RESTORE path -- which installs
        state without calling setup() -- still configures the element."""

    def _ensure_ready(self):
        if self._ready:
            return
        self.configure()
        if self.state is None:  # restore_state may have installed it
            self.state = self.setup()
        signature = inspect.signature(self.compute)
        self._accepts_lengths = "lengths" in signature.parameters
        self._ready = True

    def _call(self, dynamic: dict, inputs: dict) -> dict:
        outputs = self.compute(self.state, **dynamic, **inputs)
        if not isinstance(outputs, dict):
            raise TypeError(
                f"{self.definition.name}.compute must return a dict")
        return outputs

    def _dynamic(self, stream) -> dict:
        return {key: torch.as_tensor(value, device=self.device)
                for key, value in self.dynamic_parameters(stream).items()}

    def _place_inputs(self, inputs: dict) -> tuple[dict, dict]:
        """Returns (placed inputs, padding info {name: (axis, original)}).
        Arrays and tensors move to the element's device, keeping their
        dtype; other values pass through."""
        placed, padding = {}, {}
        for name, value in inputs.items():
            if isinstance(value, (np.ndarray, torch.Tensor)):
                axis = self._bucket_axes.get(name)
                if axis is not None:
                    original = value.shape[int(axis)]
                    target = bucket_length(
                        original, self._bucket_min, self._buckets)
                    if target != original:
                        value = pad_axis_to(value, int(axis), target)
                        padding[name] = (int(axis), original)
                if isinstance(value, np.ndarray):
                    value = torch.from_numpy(np.ascontiguousarray(value))
                value = as_device_array(value, value.dtype, self.device)
            placed[name] = value
        return placed, padding

    def _unpad(self, outputs: dict, inputs: dict, padding: dict) -> dict:
        """Slice bucket padding back off: any output tensor whose bucketed
        axis has exactly the padded input's size is restored to the
        original length (opt out with unpad_outputs=false)."""
        if not padding or not self._unpad_outputs:
            return outputs
        result = {}
        for name, value in outputs.items():
            # every padded axis is restored (an output may carry several
            # bucketed axes, e.g. an outer product of two padded inputs)
            sliced_axes: set = set()
            for input_name, (axis, original) in padding.items():
                padded_size = inputs[input_name].shape[axis]
                if (hasattr(value, "shape") and value.ndim > axis
                        and axis not in sliced_axes
                        and value.shape[axis] == padded_size):
                    index = [slice(None)] * value.ndim
                    index[axis] = slice(0, original)
                    value = value[tuple(index)]
                    sliced_axes.add(axis)
            result[name] = value
        return result

    def group_kernel(self, stream: Stream):
        """Fused whole-group execution: compute() as a batch-in/batch-out
        kernel, so the micro-batch scheduler runs concat+pad+compute+split
        as one call (PipelineElement.group_kernel contract).  State and
        dynamic parameters ride the `context`.  Elements whose engine path
        does host-side per-frame work fall back to the chained path:
        bucket padding and `lengths` masks depend on pre-padding sizes,
        blocking_metrics promises an in-window synchronize, and a custom
        process_frame override means compute() alone would not reproduce
        the element's behavior."""
        if self._bucket_axes or self._blocking_metrics:
            return None
        if (type(self).process_frame is not ComputeElement.process_frame
                or type(self).compute is ComputeElement.compute):
            return None
        self._ensure_ready()
        if self._accepts_lengths:
            return None
        if self._group_kernel_fn is None:
            def kernel(context, **batch):
                state, dynamic = context
                placed, _ = self._place_inputs(batch)
                outputs = self.compute(state, **dynamic, **placed)
                if not isinstance(outputs, dict):
                    raise TypeError(
                        f"{self.definition.name}.compute must return "
                        f"a dict")
                return outputs

            self._group_kernel_fn = kernel
        return self._group_kernel_fn, (self.state, self._dynamic(stream))

    def eval_kernel(self):
        """Static-analyzer hook: None, because the analyzer's `eval` pass
        (jax.eval_shape in the JAX package) is not ported yet."""
        return None

    def _cached_group_kernel(self, key, build):
        """Per-static-parameter-value kernel cache for group_kernel
        overrides (e.g. one kernel per max_tokens): a STABLE kernel
        identity per value keeps the scheduler's fused-program cache
        entry across groups."""
        kernels = getattr(self, "_group_kernels", None)
        if kernels is None:
            kernels = self._group_kernels = {}
        kernel = kernels.get(key)
        if kernel is None:
            kernel = kernels[key] = build()
        return kernel

    def restore_state(self, state) -> None:
        """Install checkpointed state (a tree of numpy arrays or tensors)
        on the element's device, BEFORE _ensure_ready so setup() never
        allocates a second copy of the parameters."""
        self.configure()
        if state is not None:
            self.state = tree_map(
                lambda leaf: torch.as_tensor(leaf, device=self.device),
                state)
        self._ensure_ready()

    def process_frame(self, stream: Stream, **inputs) -> tuple:
        self._ensure_ready()
        host_start = time.perf_counter()
        placed, padding = self._place_inputs(inputs)
        dynamic = self._dynamic(stream)
        if self._accepts_lengths:
            dynamic["lengths"] = {
                name: torch.tensor(inputs[name].shape[int(axis)],
                                   dtype=torch.int32, device=self.device)
                for name, axis in self._bucket_axes.items()
                if name in inputs}
        try:
            # record_function: per-element spans in torch.profiler traces
            with torch.profiler.record_function(
                    f"element:{self.definition.name}"):
                outputs = self._call(dynamic, placed)
        except TypeError as error:
            bad = {name: type(value).__name__
                   for name, value in placed.items()
                   if not hasattr(value, "shape")
                   and not isinstance(value, (bool, int, float, complex,
                                              list, tuple))}
            if bad:
                raise TypeError(
                    f"{self.definition.name}: inputs {bad} are not "
                    f"tensors; ComputeElement inputs must be arrays or "
                    f"numbers (route strings/objects around compute "
                    f"elements with map_in/map_out)") from error
            raise
        outputs = self._unpad(outputs, placed, padding)
        block_elapsed = None
        if self._blocking_metrics:
            block_start = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            block_elapsed = time.perf_counter() - block_start
        elapsed = time.perf_counter() - host_start
        telemetry = getattr(self.pipeline, "telemetry", None)
        if telemetry is None or telemetry.enabled:
            stream.variables.setdefault("compute_seconds", {})[
                self.definition.name] = elapsed
        if telemetry is not None:
            telemetry.record_device(self.definition.name, elapsed,
                                    block_elapsed)
        return StreamEvent.OKAY, outputs
