# Tensor-aware frame-data codec for CROSS-PROCESS hops only.
#
# In-process, swag values (including torch.Tensor) pass by reference and
# never touch this codec.  When a frame crosses a process boundary:
#
#   large arrays (>= AIKO_TRANSFER_THRESHOLD, default 64 KiB) are staged
#   on the per-process TensorTransferServer and travel as a tiny JSON
#   DESCRIPTOR -- the control plane never carries bulk data (SURVEY.md 5;
#   the reference pushed base64 tensors through the broker:
#   src/aiko_services/examples/pipeline/elements.py:298-324, audio binary
#   topics audio_io.py:520-560 / process.py:180-189);
#
#   small values stay inline as base64 .npy blobs -- a descriptor +
#   socket round-trip costs more than the payload.
#
# Counterpart of aiko_services_tpu/pipeline/tensors.py.  Tensors are
# encoded from host copies; bfloat16 travels as its uint16 bits with a
# "bf16" flag and decodes back to a torch.bfloat16 tensor.

from __future__ import annotations

import base64
import io
import json
import zlib

import numpy as np

from .transfer import (
    TENSOR_REF_KEY, fetch, from_bits, get_transfer_server, host_bits,
    transfer_enabled, transfer_threshold)

__all__ = ["encode_frame_data", "decode_frame_data", "encode_value",
           "decode_value"]

_NDARRAY_KEY = "__ndarray__"
_COMPRESS_THRESHOLD_BYTES = 4096


def encode_value(value):
    if hasattr(value, "__array__") and not isinstance(
            value, (bool, int, float, str, list, tuple, dict)):
        array, dtype_name = host_bits(value)
        if transfer_enabled() and array.nbytes >= transfer_threshold():
            return {TENSOR_REF_KEY: get_transfer_server().offer(value)}
        buffer = io.BytesIO()
        np.save(buffer, array, allow_pickle=False)
        raw = buffer.getvalue()
        compressed = len(raw) >= _COMPRESS_THRESHOLD_BYTES
        if compressed:
            raw = zlib.compress(raw, level=1)
        record = {"z": compressed,
                  "data": base64.b64encode(raw).decode("ascii")}
        if dtype_name == "bfloat16":
            record["bf16"] = True
        return {_NDARRAY_KEY: record}
    if isinstance(value, dict):
        return {key: encode_value(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return [encode_value(item) for item in value]
    return value


def decode_value(value):
    if isinstance(value, dict):
        if TENSOR_REF_KEY in value:
            return fetch(value[TENSOR_REF_KEY])
        if _NDARRAY_KEY in value:
            record = value[_NDARRAY_KEY]
            raw = base64.b64decode(record["data"])
            if record.get("z"):
                raw = zlib.decompress(raw)
            array = np.load(io.BytesIO(raw), allow_pickle=False)
            if record.get("bf16"):
                return from_bits(array.tobytes(), "bfloat16", array.shape)
            return array
        return {key: decode_value(item) for key, item in value.items()}
    if isinstance(value, list):
        return [decode_value(item) for item in value]
    return value


def encode_frame_data(frame_data: dict) -> str:
    return json.dumps(
        {key: encode_value(value) for key, value in frame_data.items()},
        separators=(",", ":"))


def decode_frame_data(text: str) -> dict:
    return {key: decode_value(value)
            for key, value in json.loads(text).items()}
