# Device choice and tensor coercion shared by every element that takes
# tensor input.  Counterpart of aiko_services_tpu/ops/device.py.
#
# The port runs on CUDA unless the caller asks for the CPU.  Asking for
# CUDA where there is none raises: the port never carries on quietly on
# the CPU.

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["as_device_array", "counted_flags", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """torch.device for a definition's `device` parameter; raises when a
    CUDA device is asked for and none is available."""
    resolved = torch.device(device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but CUDA is not "
            f"available; pass device \"cpu\" to run on the CPU")
    return resolved


def as_device_array(value, dtype, device) -> torch.Tensor:
    """Coerce an element input to a tensor of `dtype` on `device`.  A
    tensor already there passes through with no host round trip; a numpy
    array (or anything numpy can read) is copied to `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)


def counted_flags(read, write, value):
    """A context manager that holds process-wide flags at `value` while
    any of its scopes is open, in any thread: the first scope to open
    saves read() and writes `value`, the last to close writes the saved
    flags back.  The scopes of all threads share one count, so no
    thread's work runs with the flags restored by another thread's exit
    (two engines on one card)."""
    lock = threading.Lock()
    state = {"depth": 0, "previous": None}

    @contextlib.contextmanager
    def scope():
        with lock:
            if state["depth"] == 0:
                state["previous"] = read()
                write(value)
            state["depth"] += 1
        try:
            yield
        finally:
            with lock:
                state["depth"] -= 1
                if state["depth"] == 0:
                    write(state["previous"])

    return scope
