# Weight ingestion: safetensors read/write + checkpoint -> parameter tree.
#
# Counterpart of aiko_services_tpu/models/weights.py: the container, the
# save/load of parameter trees, the multi-shard index the checkpoint
# loaders read through, and the HuggingFace name maps (llama_name_map /
# load_llama_params for Llama-family checkpoints, whisper_layer_map /
# load_whisper_params for openai/whisper-*).  HF nn.Linear weights are
# stored (out, in); this framework stores (in, out), so the maps' transpose
# flags decide the orientation.  Casts and transposes run on torch tensors
# (a BF16 tensor is read as its raw uint16 bits and viewed as
# torch.bfloat16 -- numpy has no bfloat16, the JAX package used
# ml_dtypes); an f32 -> bf16 cast rounds to nearest even, as ml_dtypes'
# astype does.  load_pytree and load_llama_params with a mesh and a spec
# tree place each tensor into its shards as it is read
# (parallel.shard_pytree leaf by leaf; a per-layer leaf is stacked over
# the layers on the host first), so a sharded model never holds a second
# whole copy of its weights on the device; save_pytree gathers Sharded
# leaves (parallel.unshard) before it writes.  The container is parsed
# in numpy: 8-byte little-endian header length, JSON header of {name:
# {dtype, shape, data_offsets}}, flat data buffer, read through mmap.

from __future__ import annotations

import contextlib
import json
import mmap
from pathlib import Path

import numpy as np
import torch

from ..ops.device import resolve_device
from ..parallel.mesh import Sharded, _spec_leaf, shard_pytree, unshard

__all__ = ["read_safetensors", "write_safetensors", "SafetensorsFile",
           "save_pytree", "load_pytree", "open_checkpoint",
           "load_llama_params", "llama_name_map", "load_whisper_params",
           "whisper_layer_map"]

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
            flat[prefix] = unshard(node) if isinstance(node, Sharded) \
                else node

    walk(tree, "")
    write_safetensors(path, flat, metadata)


def _spec_at(specs, parts: list):
    """The spec shard_pytree would give the leaf at `parts`: a spec where
    the tree has a subtree broadcasts over it, a missing entry
    replicates."""
    node = specs
    for part in parts:
        if _spec_leaf(node):
            return node
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    return node if _spec_leaf(node) else None


def load_pytree(path, dtype=None, device="cuda", mesh=None,
                specs=None) -> dict:
    """Inverse of save_pytree: a nested dict of tensors on `device`
    (CUDA unless the caller asks for the CPU); dtype (a name such as
    "bfloat16", or a torch.dtype) casts every floating-point leaf.  With
    a mesh, each tensor is placed by its spec in `specs` (a spec tree as
    shard_pytree takes it; None replicates) as soon as it is read."""
    if mesh is None:
        device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    tree: dict = {}
    reader = SafetensorsFile(path)
    try:
        for name in reader.keys():
            tensor = reader.get(name)
            if dtype is not None and tensor.is_floating_point():
                tensor = tensor.to(dtype)
            node = tree
            parts = name.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = (
                tensor.to(device) if mesh is None
                else shard_pytree(tensor, mesh, _spec_at(specs, parts)))
    finally:
        reader.close()
    return tree


@contextlib.contextmanager
def open_checkpoint(paths):
    """Multi-shard safetensors index shared by the checkpoint loaders:
    yields (index, raw) where index maps tensor name -> reader and
    raw(name) materializes a CPU tensor (KeyError names the missing
    tensor).  Readers are closed even when a load fails partway."""
    if isinstance(paths, (str, Path)):
        paths = [paths]
    readers = [SafetensorsFile(path) for path in paths]
    index = {name: reader for reader in readers for name in reader.keys()}

    def raw(name: str) -> torch.Tensor:
        reader = index.get(name)
        if reader is None:
            raise KeyError(f"Checkpoint is missing tensor: {name}")
        return reader.get(name)

    try:
        yield index, raw
    finally:
        for reader in readers:
            reader.close()


def _set_path(tree: dict, parts, value) -> None:
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _fetcher(raw, dtype: torch.dtype):
    """fetch(name, transpose) -> the named tensor, transposed when asked
    (HF (out, in) -> (in, out)), contiguous and cast to `dtype`."""
    def fetch(name: str, transpose: bool = False) -> torch.Tensor:
        tensor = raw(name)
        if transpose:
            tensor = tensor.T
        return tensor.contiguous().to(dtype)
    return fetch


def _stacked_layers(fetch, layer_maps: list, place) -> dict:
    """The per-layer tensors of `layer_maps` (one {HF name: (path,
    transpose?)} per layer, all naming the same paths) stacked over the
    layers on the host, leaf by leaf, each handed to place(path, stacked)
    before the next is read."""
    layers: dict = {}
    for index, (parts, transpose) in enumerate(layer_maps[0].values()):
        names = [list(mapping)[index] for mapping in layer_maps]
        stacked = torch.stack([fetch(name, transpose) for name in names])
        _set_path(layers, parts, place(parts, stacked))
    return layers


# -- HuggingFace Llama naming -> framework parameter tree -------------------

def llama_name_map(layer: int) -> dict:
    """HF tensor name -> (path under layers, transpose?) for one decoder
    layer.  HF nn.Linear stores (out, in); this framework stores (in,
    out) so products read x @ w."""
    prefix = f"model.layers.{layer}."
    return {
        prefix + "input_layernorm.weight": (("attn_norm", "scale"), False),
        prefix + "post_attention_layernorm.weight": (
            ("mlp_norm", "scale"), False),
        prefix + "self_attn.q_proj.weight": (("wq", "w"), True),
        prefix + "self_attn.k_proj.weight": (("wk", "w"), True),
        prefix + "self_attn.v_proj.weight": (("wv", "w"), True),
        prefix + "self_attn.o_proj.weight": (("wo", "w"), True),
        prefix + "mlp.gate_proj.weight": (("w_gate", "w"), True),
        prefix + "mlp.up_proj.weight": (("w_up", "w"), True),
        prefix + "mlp.down_proj.weight": (("w_down", "w"), True),
    }


def load_llama_params(paths, config, mesh=None, specs=None,
                      device="cuda") -> dict:
    """The TransformerConfig parameter tree from HF Llama-family
    safetensors shard(s) (one path or a list; names are disjoint across
    shards), cast to config.dtype.  The q/k projections are taken as
    stored (no RoPE permutation), as the JAX package takes them.  An
    `lm_head.weight` (an untied head) becomes params["lm_head"], placed
    by the ("embed", "w") spec.  With mesh + specs (param_specs), every
    leaf is placed into its shards as it is read; else the tree lands on
    `device` (CUDA unless the caller asks for the CPU)."""
    if mesh is None or specs is None:
        mesh, device = None, resolve_device(device)

    def place(parts, tensor):
        if mesh is None:
            return tensor.to(device)
        return shard_pytree(tensor, mesh, _spec_at(specs, list(parts)))

    with open_checkpoint(paths) as (index, raw):
        fetch = _fetcher(raw, config.torch_dtype)
        params: dict = {
            "embed": {"w": place(("embed", "w"),
                                 fetch("model.embed_tokens.weight"))},
            "norm_out": {"scale": place(("norm_out", "scale"),
                                        fetch("model.norm.weight"))},
        }
        if "lm_head.weight" in index:
            # the untied output head: embed's (V, D) layout and spec
            params["lm_head"] = {"w": place(("embed", "w"),
                                            fetch("lm_head.weight"))}
        params["layers"] = _stacked_layers(
            fetch, [llama_name_map(layer)
                    for layer in range(config.n_layers)],
            lambda parts, tensor: place(("layers",) + tuple(parts), tensor))
    return params


# -- HuggingFace Whisper naming -> framework ASR parameter tree -------------

def _attention_map(hf_prefix: str, ours: str) -> dict:
    """One whisper attention block: q/v/out projections carry biases,
    k_proj does not (HF WhisperAttention)."""
    return {
        hf_prefix + "q_proj.weight": ((ours, "wq", "w"), True),
        hf_prefix + "q_proj.bias": ((ours, "wq", "b"), False),
        hf_prefix + "k_proj.weight": ((ours, "wk", "w"), True),
        hf_prefix + "v_proj.weight": ((ours, "wv", "w"), True),
        hf_prefix + "v_proj.bias": ((ours, "wv", "b"), False),
        hf_prefix + "out_proj.weight": ((ours, "wo", "w"), True),
        hf_prefix + "out_proj.bias": ((ours, "wo", "b"), False),
    }


def whisper_layer_map(layer: int, decoder: bool) -> dict:
    """HF tensor name -> (path under enc_layers/dec_layers, transpose?)
    for one whisper transformer layer.  Linear weights are (out, in) in
    HF and (in, out) here; layer norms carry weight and bias."""
    side = "decoder" if decoder else "encoder"
    prefix = f"model.{side}.layers.{layer}."
    mapping = {
        prefix + "fc1.weight": (("mlp", "w1", "w"), True),
        prefix + "fc1.bias": (("mlp", "w1", "b"), False),
        prefix + "fc2.weight": (("mlp", "w2", "w"), True),
        prefix + "fc2.bias": (("mlp", "w2", "b"), False),
        prefix + "final_layer_norm.weight": (("mlp_norm", "scale"), False),
        prefix + "final_layer_norm.bias": (("mlp_norm", "bias"), False),
    }
    if decoder:
        mapping.update(_attention_map(prefix + "self_attn.", "self"))
        mapping.update(_attention_map(prefix + "encoder_attn.", "cross"))
        mapping.update({
            prefix + "self_attn_layer_norm.weight": (
                ("self_norm", "scale"), False),
            prefix + "self_attn_layer_norm.bias": (
                ("self_norm", "bias"), False),
            prefix + "encoder_attn_layer_norm.weight": (
                ("cross_norm", "scale"), False),
            prefix + "encoder_attn_layer_norm.bias": (
                ("cross_norm", "bias"), False),
        })
    else:
        mapping.update(_attention_map(prefix + "self_attn.", "attn"))
        mapping.update({
            prefix + "self_attn_layer_norm.weight": (
                ("attn_norm", "scale"), False),
            prefix + "self_attn_layer_norm.bias": (
                ("attn_norm", "bias"), False),
        })
    return mapping


def load_whisper_params(paths, config, device="cuda") -> dict:
    """The AsrConfig parameter tree from HuggingFace openai/whisper-*
    safetensors naming, cast to config.dtype, on `device` (CUDA unless
    the caller asks for the CPU).  HF conv1/conv2 weights are (d_model,
    in, kernel), this framework's layout already; the position tables
    are sliced to config.max_frames / config.max_text_len; the output
    head is tied to model.decoder.embed_tokens."""
    device = resolve_device(device)
    with open_checkpoint(paths) as (_index, raw):
        fetch = _fetcher(raw, config.torch_dtype)

        def get(name, rows=None):
            tensor = fetch(name)
            return (tensor if rows is None else tensor[:rows]).to(device)

        def layers(count, decoder):
            return _stacked_layers(
                fetch, [whisper_layer_map(layer, decoder)
                        for layer in range(count)],
                lambda parts, tensor: tensor.to(device))

        return {
            "conv1": {"w": get("model.encoder.conv1.weight"),
                      "b": get("model.encoder.conv1.bias")},
            "conv2": {"w": get("model.encoder.conv2.weight"),
                      "b": get("model.encoder.conv2.bias")},
            "enc_positions": get("model.encoder.embed_positions.weight",
                                 config.max_frames),
            "enc_layers": layers(config.enc_layers, decoder=False),
            "enc_norm": {
                "scale": get("model.encoder.layer_norm.weight"),
                "bias": get("model.encoder.layer_norm.bias")},
            "token_embed": {"w": get("model.decoder.embed_tokens.weight")},
            "dec_positions": get("model.decoder.embed_positions.weight",
                                 config.max_text_len),
            "dec_layers": layers(config.dec_layers, decoder=True),
            "dec_norm": {
                "scale": get("model.decoder.layer_norm.weight"),
                "bias": get("model.decoder.layer_norm.bias")},
        }
