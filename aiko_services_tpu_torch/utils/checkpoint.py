# Checkpoint/restore for model state and stream cursors.
#
# Counterpart of aiko_services_tpu/utils/checkpoint.py, with its API
# (save, restore, steps, latest_step, max_to_keep) and its guarantees: a
# step is written into a hidden staging directory that is renamed into
# place, a metadata-only step carries a `no_state` marker, metadata is
# encoded before the state is written, a corrupt newest step falls back
# to an older intact one, and pruning keeps max_to_keep steps.
#
# Orbax is replaced by the port's own safetensors writer and reader
# (models/weights.py): a step's state/ holds tensors.safetensors (every
# tensor leaf under its index, in its own dtype: bf16, int8 and f32
# scales round-trip as stored) and tree.json, the tree's structure --
# dicts, lists, tuples, None and JSON scalars (an optimizer's step count)
# -- with each tensor leaf naming its index.  A Sharded leaf is gathered
# whole (parallel.unshard) and restored whole; an element's restore_state
# places it into the element's layout.  On a mesh over several processes
# unshard is a collective, so every process calls save for the same step
# with the same tree.

from __future__ import annotations

import json
import shutil
from pathlib import Path

from . import get_logger

__all__ = ["Checkpointer"]

_LOGGER = get_logger("checkpoint")

_TENSORS = "tensors.safetensors"
_TREE = "tree.json"


def _encode(node, tensors: dict):
    """The JSON structure of `node`; tensor leaves go into `tensors`
    under their index.  Returns (structure, number of leaves)."""
    import numpy as np
    import torch
    from ..parallel.mesh import Sharded, unshard
    if isinstance(node, Sharded):
        node = unshard(node)
    if isinstance(node, torch.Tensor):
        key = str(len(tensors))
        tensors[key] = node
        return {"tensor": key}, 1
    if isinstance(node, (np.ndarray, np.generic)):
        key = str(len(tensors))
        tensors[key] = np.asarray(node)
        return {"ndarray": key}, 1
    if node is None:
        return {"none": True}, 0
    if isinstance(node, (bool, int, float, str)):
        return {"value": node}, 1
    if isinstance(node, dict):
        items, count = [], 0
        for key, value in node.items():
            if not isinstance(key, (str, int)):
                raise TypeError(f"checkpoint keys must be str or int, "
                                f"not {type(key).__name__}")
            encoded, leaves = _encode(value, tensors)
            items.append([key, encoded])
            count += leaves
        return {"dict": items}, count
    if isinstance(node, (list, tuple)):
        items, count = [], 0
        for value in node:
            encoded, leaves = _encode(value, tensors)
            items.append(encoded)
            count += leaves
        return {"tuple" if isinstance(node, tuple) else "list": items}, count
    raise TypeError(f"cannot checkpoint a {type(node).__name__} leaf")


def _decode(node, reader, device):
    if "tensor" in node:
        return reader.get(node["tensor"]).to(device)
    if "ndarray" in node:
        return reader.get(node["ndarray"]).numpy()
    if "none" in node:
        return None
    if "value" in node:
        return node["value"]
    if "dict" in node:
        return {key: _decode(value, reader, device)
                for key, value in node["dict"]}
    if "list" in node:
        return [_decode(value, reader, device) for value in node["list"]]
    return tuple(_decode(value, reader, device) for value in node["tuple"])


class Checkpointer:
    """Step-indexed pytree checkpoints + a JSON metadata sidecar.

    save(step, pytree, metadata) / restore(step=None) -> (pytree, metadata);
    keeps the newest max_to_keep steps.  Works for any tree of dicts,
    lists and tuples over tensors, numpy arrays, None and JSON scalars:
    model params, optimizer state, KV caches; metadata carries small JSON
    state (stream cursors, frame ids, config echoes).  Restored tensors
    land on `device` (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, directory, max_to_keep: int = 3, device="cuda"):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.device = device

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:012d}"

    def steps(self) -> list[int]:
        found = []
        for path in self.directory.glob("step_*"):
            try:
                found.append(int(path.name.split("_", 1)[1]))
            except ValueError:
                continue
        return sorted(found)

    def save(self, step: int, pytree, metadata: dict | None = None) -> Path:
        """Atomic: state + metadata land in a hidden staging dir that is
        rename()d into place, so a preemption mid-save can never leave a
        half-written newest step for restore() to pick up."""
        from ..models.weights import write_safetensors
        # encode metadata BEFORE the heavy state save so a non-JSON value
        # (numpy array, bytes) fails fast instead of aborting after the
        # tensors have been written
        metadata_text = json.dumps(metadata or {}, sort_keys=True)
        tensors: dict = {}
        structure, leaves = _encode(pytree, tensors)
        staging = self.directory / f".staging_step_{step}"
        if staging.exists():
            shutil.rmtree(staging)
        if leaves > 0:
            (staging / "state").mkdir(parents=True)
            write_safetensors(staging / "state" / _TENSORS, tensors)
            (staging / "state" / _TREE).write_text(json.dumps(structure))
        else:
            # a metadata-only checkpoint (e.g. stream cursors with no
            # ComputeElement state) is still valid -- marked explicitly so
            # restore() can tell it apart from a LOST state payload
            staging.mkdir(parents=True, exist_ok=True)
            (staging / "no_state").touch()
        (staging / "metadata.json").write_text(metadata_text)
        target = self._step_dir(step)
        if target.exists():
            shutil.rmtree(target)
        staging.rename(target)
        self._prune()
        _LOGGER.info("Checkpoint saved: %s", target)
        return target

    @staticmethod
    def _read_state(state: Path, device):
        from ..models.weights import SafetensorsFile
        structure = json.loads((state / _TREE).read_text())
        reader = SafetensorsFile(state / _TENSORS)
        try:
            return _decode(structure, reader, device)
        finally:
            reader.close()

    def restore(self, step: int | None = None):
        """Returns (pytree, metadata); (None, {}) when nothing exists.
        With step=None, falls back to older steps if the newest is
        unreadable."""
        from ..ops.device import resolve_device
        device = resolve_device(self.device)  # no card: raise, not "corrupt"
        steps = self.steps()
        if not steps:
            return None, {}
        candidates = [step] if step is not None else list(reversed(steps))
        last_error = None
        for candidate in candidates:
            target = self._step_dir(candidate)
            try:
                if (target / "state").exists():
                    pytree = self._read_state(target / "state", device)
                elif (target / "no_state").exists():
                    pytree = None  # legit metadata-only checkpoint
                else:
                    # state payload lost: treat the step as corrupt so
                    # step=None falls back to an older intact step
                    raise FileNotFoundError(
                        f"state payload missing in {target}")
                metadata = json.loads(
                    (target / "metadata.json").read_text())
            except Exception as error:  # corrupt step: try the previous
                last_error = error
                _LOGGER.warning("Checkpoint %s unreadable: %s",
                                target, error)
                continue
            return pytree, metadata
        raise RuntimeError(
            f"No readable checkpoint in {self.directory}") from last_error

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        steps = self.steps()
        while len(steps) > self.max_to_keep:
            victim = self._step_dir(steps.pop(0))
            shutil.rmtree(victim, ignore_errors=True)
