# Weight ingestion: safetensors read/write + checkpoint -> parameter tree.
#
# Counterpart of aiko_services_tpu/models/weights.py (the container and
# the save/load of parameter trees; the HuggingFace whisper/llama name
# maps are not ported yet).  The container is parsed in numpy: 8-byte
# little-endian header length, JSON header of {name: {dtype, shape,
# data_offsets}}, flat data buffer, read through mmap.  numpy has no
# bfloat16, so BF16 tensors are read as their raw uint16 bits and viewed
# as torch.bfloat16 (the JAX package used ml_dtypes).

from __future__ import annotations

import json
import mmap
from pathlib import Path

import numpy as np
import torch

from ..ops.device import resolve_device

__all__ = ["read_safetensors", "write_safetensors", "SafetensorsFile",
           "save_pytree", "load_pytree"]

# safetensors dtype -> (numpy dtype of the stored bits, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_TORCH_NAMES = {torch_dtype: name
                for name, (_, torch_dtype) in _DTYPES.items()}


class SafetensorsFile:
    """mmap-backed lazy reader: tensors materialize on get()."""

    def __init__(self, path):
        self.path = Path(path)
        with open(self.path, "rb") as handle:
            header_len = int.from_bytes(handle.read(8), "little")
            header = json.loads(handle.read(header_len))
            self._data_start = 8 + header_len
        self.metadata = header.pop("__metadata__", {})
        self._entries = header
        self._mmap = None

    def keys(self):
        return list(self._entries.keys())

    def __contains__(self, name):
        return name in self._entries

    def shape(self, name) -> tuple:
        return tuple(self._entries[name]["shape"])

    def get(self, name: str) -> torch.Tensor:
        """The tensor `name` on the CPU (a copy: it outlives close())."""
        entry = self._entries[name]
        if self._mmap is None:
            with open(self.path, "rb") as handle:
                self._mmap = mmap.mmap(handle.fileno(), 0,
                                       access=mmap.ACCESS_READ)
        start, end = entry["data_offsets"]
        bits_dtype, torch_dtype = _DTYPES[entry["dtype"]]
        buffer = self._mmap[self._data_start + start:self._data_start + end]
        array = np.frombuffer(buffer, dtype=bits_dtype).reshape(
            entry["shape"])
        tensor = torch.from_numpy(array.copy())
        if torch_dtype == torch.bfloat16:
            tensor = tensor.view(torch.bfloat16)
        return tensor

    def close(self):
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None


def read_safetensors(path, names=None) -> dict:
    """Eagerly load {name: CPU tensor} (names=None loads everything)."""
    reader = SafetensorsFile(path)
    try:
        wanted = names if names is not None else reader.keys()
        return {name: reader.get(name) for name in wanted}
    finally:
        reader.close()


def _stored_bits(value) -> tuple:
    """(safetensors dtype name, numpy array of the stored bits)."""
    if isinstance(value, torch.Tensor):
        tensor = value.detach().cpu().contiguous()
        if tensor.dtype not in _TORCH_NAMES:
            raise TypeError(f"unsupported dtype {tensor.dtype}")
        name = _TORCH_NAMES[tensor.dtype]
        if tensor.dtype == torch.bfloat16:
            tensor = tensor.view(torch.uint16)
        return name, tensor.numpy()
    array = np.ascontiguousarray(np.asarray(value))
    for name, (bits_dtype, torch_dtype) in _DTYPES.items():
        if name != "BF16" and array.dtype == np.dtype(bits_dtype):
            return name, array
    raise TypeError(f"unsupported dtype {array.dtype}")


def write_safetensors(path, tensors: dict, metadata: dict = None) -> None:
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    offset = 0
    arrays = {}
    for name, value in tensors.items():
        try:
            dtype_name, array = _stored_bits(value)
        except TypeError as error:
            raise TypeError(f"{name}: {error}") from error
        arrays[name] = array
        header[name] = {
            "dtype": dtype_name,
            "shape": list(array.shape),
            "data_offsets": [offset, offset + array.nbytes],
        }
        offset += array.nbytes
    header_bytes = json.dumps(header).encode("utf-8")
    with open(path, "wb") as handle:
        handle.write(len(header_bytes).to_bytes(8, "little"))
        handle.write(header_bytes)
        for array in arrays.values():
            handle.write(array.tobytes())


# -- parameter trees <-> safetensors -----------------------------------------

def save_pytree(path, tree, metadata: dict = None) -> None:
    """Persist a nested-dict tree of tensors with dotted flat names."""
    flat: dict = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, f"{prefix}.{key}" if prefix else str(key))
        else:
            flat[prefix] = node

    walk(tree, "")
    write_safetensors(path, flat, metadata)


def load_pytree(path, dtype=None, device="cuda") -> dict:
    """Inverse of save_pytree: a nested dict of tensors on `device`
    (CUDA unless the caller asks for the CPU); dtype (a name such as
    "bfloat16", or a torch.dtype) casts every floating-point leaf."""
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    tree: dict = {}
    for name, tensor in read_safetensors(path).items():
        if dtype is not None and tensor.is_floating_point():
            tensor = tensor.to(dtype)
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = tensor.to(device)
    return tree
