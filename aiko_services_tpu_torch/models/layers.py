# Shared neural-net layers as plain functions over parameter dicts.
#
# Counterpart of aiko_services_tpu/models/layers.py: the layers the ASR
# model and the LM use (dense, rms_norm, layer_norm, rotary, swiglu,
# repeat_kv, conv2d and the initialisers), and the megatron dense layers
# on shards (column_parallel, row_parallel over a ShardedCall), the part
# of XLA's partitioning of `dense` the sharded models need.
#
# Conventions, as in the JAX package: weights stored (in_features,
# out_features) so forward is x @ w; attention heads live in the
# last-but-one axis (B, H, L, D); everything computes in the dtype of the
# incoming activations with f32 accumulation.

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.audio import full_f32_convolution
from ..ops.device import counted_flags
from ..parallel.collectives import (
    _entries, _groups, all_gather, axis_index, join_backward, map_shards,
    psum, replicated)
from ..parallel.mesh import Sharded

__all__ = ["dense", "rms_norm", "layer_norm", "rotary_embedding",
           "apply_rotary", "swiglu", "repeat_kv", "init_dense", "init_norm",
           "conv2d", "init_conv", "f32_reduction", "ShardedCall",
           "column_parallel", "row_parallel"]


def _reduction_flags() -> tuple:
    matmul = torch.backends.cuda.matmul
    return (matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_fp16_reduced_precision_reduction)


def _set_reduction_flags(flags) -> None:
    matmul = torch.backends.cuda.matmul
    (matmul.allow_bf16_reduced_precision_reduction,
     matmul.allow_fp16_reduced_precision_reduction) = flags


# bf16 and fp16 matmuls on the card reduce in f32 for the duration of a
# scope (cuBLAS may otherwise sum split-K partials in the narrow type,
# where XLA's dot accumulates in f32 and rounds once); the flags are
# process-wide, so the scopes of all threads share one count
# (device.counted_flags)
f32_reduction = counted_flags(_reduction_flags, _set_reduction_flags,
                              (False, False))


def init_dense(generator: torch.Generator, in_features: int,
               out_features: int, dtype=torch.float32, *, device) -> dict:
    """Normal(0, 1/in_features) weights, drawn on the CPU from
    `generator` (so a seed gives the same weights on every device)."""
    scale = 1.0 / np.sqrt(in_features)
    weight = torch.randn((in_features, out_features), generator=generator,
                         dtype=torch.float32) * scale
    return {"w": weight.to(device=device, dtype=dtype)}


def dense(params: dict, x):
    """x @ w (+ b), accumulated in f32 and cast once to x's dtype.  A
    bf16 product on the card accumulates in f32 inside the matmul, its
    split-K partials too (f32_reduction), and rounds once; a bias is
    added in f32 before that single rounding, as the JAX package does.

    Weight-only int8 (transformer.quantize_weights_int8): the 8-bit codes
    cast to x's dtype (exact), the product is kept in f32 and the
    per-output-channel f32 scale applies after it, before the one
    rounding to x's dtype."""
    w = params["w"]
    if w.dtype == torch.int8:
        out = torch.matmul(x.float(), w.float()) * params["w_scale"].float()
        if "b" in params:
            out = out + params["b"].float()
        return out.to(x.dtype)
    if "b" in params:
        out = torch.matmul(x.float(), w.float()) + params["b"].float()
        return out.to(x.dtype)
    if w.dtype == x.dtype:
        with f32_reduction():
            return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def init_norm(features: int, dtype=torch.float32, *, device) -> dict:
    return {"scale": torch.ones((features,), dtype=dtype, device=device)}


def rms_norm(params: dict, x, eps: float = 1e-6):
    """Normalise in f32, cast to x's dtype, THEN scale: the JAX package's
    cast order."""
    x_f32 = x.float()
    rms = torch.rsqrt(torch.mean(x_f32 * x_f32, dim=-1, keepdim=True) + eps)
    return (x_f32 * rms).to(x.dtype) * params["scale"]


def layer_norm(params: dict, x, eps: float = 1e-5):
    """Normalise in f32, cast to x's dtype, THEN scale (and shift): the
    JAX package's cast order."""
    x_f32 = x.float()
    mean = x_f32.mean(dim=-1, keepdim=True)
    var = x_f32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x_f32 - mean) * torch.rsqrt(var + eps)
    out = out.to(x.dtype) * params["scale"]
    if "bias" in params:
        out = out + params["bias"]
    return out


def rotary_embedding(positions, head_dim: int, theta: float = 10000.0):
    """positions (..., L) int -> cos/sin tables (..., L, head_dim//2)."""
    frequencies = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    angles = positions[..., None].float() * frequencies
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """x (B, H, L, D); cos/sin (L, D//2) or broadcastable (B, 1, L, D//2).
    Rotates in f32 and casts once."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def swiglu(gate_params: dict, up_params: dict, down_params: dict, x):
    return dense(down_params,
                 F.silu(dense(gate_params, x)) * dense(up_params, x))


def repeat_kv(x, repeats: int):
    """Expand grouped KV heads to full head count: (B, Hkv, L, D) ->
    (B, Hkv*repeats, L, D).  Expand, then reshape (a copy); the gradient
    sums over the repeats."""
    if repeats == 1:
        return x
    batch, kv_heads, length, dim = x.shape
    x = x[:, :, None].expand(batch, kv_heads, repeats, length, dim)
    return x.reshape(batch, kv_heads * repeats, length, dim)


def init_conv(generator: torch.Generator, in_channels: int,
              out_channels: int, kernel: int, dtype=torch.float32,
              bias: bool = True, *, device) -> dict:
    """HWIO weights (kernel, kernel, in, out) drawn N(0, 1/fan_in) on the
    CPU from `generator`; a zero bias."""
    fan_in = in_channels * kernel * kernel
    weight = torch.randn((kernel, kernel, in_channels, out_channels),
                         generator=generator,
                         dtype=torch.float32) / np.sqrt(fan_in)
    params = {"w": weight.to(device=device, dtype=dtype)}
    if bias:
        params["b"] = torch.zeros((out_channels,), dtype=dtype,
                                  device=device)
    return params


def _same_padding(size: int, kernel: int, stride: int) -> tuple:
    """XLA's "SAME": total = max((ceil(n/s) - 1) * s + k - n, 0), the
    lower half (rounded down) before, the rest after.  PyTorch's
    padding=k//2 pads both sides alike, which at stride 2 on an even size
    shifts every window by one pixel."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(params: dict, x, stride: int = 1, padding="SAME"):
    """x (B, H, W, C), w (kh, kw, I, O) -> (B, H', W', O): NHWC/HWIO, as
    the JAX package's lax.conv_general_dilated call.

    The NHWC tensor is padded as it lies and handed to F.conv2d as a
    channels-last NCHW view (no copy).  The bias goes into the
    convolution call, so a bf16 convolution rounds its f32 sums plus bias
    once, as the JAX package does; f32 convolutions run with TF32 off
    (cuDNN's default would keep about three decimal digits).  Only the
    "SAME" padding the detector uses is ported."""
    if padding != "SAME":
        raise ValueError(f"conv2d ports padding='SAME' only, got "
                         f"{padding!r}")
    weight = params["w"].to(x.dtype).permute(3, 2, 0, 1)     # -> OIHW
    bias = params["b"].to(x.dtype) if "b" in params else None
    top, bottom = _same_padding(x.shape[1], weight.shape[2], stride)
    left, right = _same_padding(x.shape[2], weight.shape[3], stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    nchw = x.permute(0, 3, 1, 2)
    if x.dtype == torch.float32:
        with full_f32_convolution():
            out = F.conv2d(nchw, weight, bias, stride=stride)
    else:
        out = F.conv2d(nchw, weight, bias, stride=stride)
    return out.permute(0, 2, 3, 1)


# -- dense layers on shards ---------------------------------------------------
#
# Megatron tensor parallelism with FSDP, the layout of the models'
# param_specs: a column-parallel weight (in, out) has its rows (the
# contraction) cut over "fsdp" and its columns over "model"; a row-parallel
# one (in, out) its rows over "model" and its columns over "fsdp".  The
# activation going into either is whole (replicated over fsdp and model)
# for the column-parallel layer and cut by "model" for the row-parallel
# one.  Each position contracts its slice of the activation with its
# block, and the partial sums meet in ONE collective: column-parallel,
# a psum over fsdp gives the position its model block of the output;
# row-parallel, a psum over model then an all_gather over fsdp give the
# whole output.  No weight moves, so the bytes a decode step's
# collectives carry depend on the activations' widths and not on the
# weights' sizes.  With fsdp and model of size 1 both are the plain dense.
#
# Each position's partial is the plain dense of its block (bf16 products
# round to bf16 first; int8 codes give an f32 product times the scale,
# rounded only after the sum); the psum adds partials in f32 and rounds
# once; a bias is added once, after the sum.


class ShardedCall:
    """One sharded model call's view of its mesh: the axis sizes, the
    per-position axis indices, and its parameter leaves as grids
    (parallel/collectives.py) of per-position tensors and of per-position
    parameter dicts."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = {name: mesh.size(name)
                     for name in ("data", "fsdp", "expert", "seq", "model")}
        self.index = {name: axis_index(mesh, name) for name in self.size}
        # the sizes the parameters are cut by (a model sets those of
        # axes its leaves are whole over to 1)
        self.cut = dict(self.size)
        self.home = mesh.home
        # whether the call's batch is cut over "data" (split_batch), and
        # its sequence over "seq" (the sequence-parallel prefill: each
        # position holds its block of the positions)
        self.split = False
        self.seq_split = False

    def grid(self, leaf):
        """A leaf as a grid: a Sharded's blocks, or the whole tensor on
        the device of each position this process computes (one copy per
        device; on a mesh over several processes a replica on each,
        whose gradient sums every process's -- collectives.replicated)."""
        if isinstance(leaf, Sharded):
            if leaf.mesh is not self.mesh:
                raise ValueError(
                    f"a sharded call's leaves must share one mesh: "
                    f"{leaf.mesh!r} is not {self.mesh!r}")
            return leaf.shards
        leaf = replicated(leaf, self.mesh)
        return map_shards(lambda device: leaf.to(device),
                          self.mesh.local_devices)

    def dicts(self, node):
        """A parameter tree with each dict of leaves (a layer's {"w",
        "w_scale", "b"}, a norm's {"scale"}) as a grid of per-position
        dicts; positions whose tensors are the same share the dict."""
        if not isinstance(node, dict):
            return self.grid(node)
        if node and not any(isinstance(value, dict)
                            for value in node.values()):
            names = list(node)
            return map_shards(lambda *tensors: dict(zip(names, tensors)),
                              *[self.grid(node[name]) for name in names])
        return {key: self.dicts(value) for key, value in node.items()}

    def layer(self, stacked, index: int):
        """Layer `index` of a stacked dict-grid tree (views)."""
        if isinstance(stacked, dict):
            return {key: self.layer(value, index)
                    for key, value in stacked.items()}
        return map_shards(lambda entry: (
            {name: tensor[index] for name, tensor in entry.items()}
            if isinstance(entry, dict) else entry[index]), stacked)

    def splits(self, batch: int) -> bool:
        """Whether a batch of `batch` rows splits over "data": when it
        divides (otherwise every data block computes the whole batch, as
        GSPMD replicates an array it cannot cut)."""
        return self.size["data"] > 1 and batch % self.size["data"] == 0

    def split_batch(self, tensor, dim: int = 0):
        """A whole tensor as a grid of its data blocks along `dim` (the
        whole tensor on every position when the batch does not divide by
        "data"); sets self.split."""
        self.split = self.splits(tensor.shape[dim])
        if not self.split:
            return self.grid(tensor)
        block = tensor.shape[dim] // self.size["data"]
        return map_shards(lambda device, index: tensor.narrow(
            dim, index * block, block).to(device),
            self.mesh.local_devices, self.index["data"])

    def psum(self, grid, axis_name: str):
        """psum over an axis the parameters are cut by (the identity
        over one they are whole on)."""
        if self.cut[axis_name] == 1:
            return grid
        return psum(grid, self.mesh, axis_name)

    def all_gather(self, grid, axis_name: str, dim: int = -1):
        if self.cut[axis_name] == 1:
            return grid
        return all_gather(grid, self.mesh, axis_name, dim=dim)

    def slice_axis(self, grid, axis_name: str, dim: int = -1):
        """Each position's block of `dim` along `axis_name` (an activation
        whole on every position, cut to the position's slice)."""
        parts = self.cut[axis_name]
        if parts == 1:
            return grid

        def cut(x, index):
            width = x.shape[dim] // parts
            return x.narrow(dim, index * width, width)
        return map_shards(cut, grid, self.index[axis_name])

    def first(self, grid):
        """The entry of the mesh's first position, where every position
        holds the same (replicated) result.  A process that does not
        hold that position takes its own replica, detached: on a mesh
        over several processes every process computes the loss on the
        result, and only the first position's copy may send its
        cotangent back (the collectives' backward sums what every
        process sends, so a second live copy would count it twice)."""
        if self.mesh.local.flat[0]:
            return grid.flat[0]
        return grid[self.mesh.local][0].detach()

    def gather_home(self, grid, dim: int = 0, seq_dim: int = 1):
        """The whole tensor on the home device: the blocks of `grid`
        concatenated -- along `dim` over "data" when split_batch split
        the batch, along `seq_dim` over "seq" when the sequence is cut
        there (seq_split) -- gathered from other processes (a
        collective), else the first position's entry
        (ShardedCall.first).  Each process's own blocks keep their
        gradient; the blocks gathered from other processes are detached
        on purpose: their owners compute the same loss on them and send
        those rows' cotangents back themselves.  The result carries the
        mesh's chain of cross-process backward collectives
        (collectives.join_backward)."""
        mesh = self.mesh
        cuts = [(name, axis_dim) for name, axis_dim, cut in (
            ("data", dim, self.split), ("seq", seq_dim, self.seq_split))
            if cut]
        if not cuts:
            return join_backward(self.first(grid).to(self.home), mesh)
        shape = [self.size[name] for name, _ in cuts]
        entries = self._line_entries(grid, tuple(name for name, _ in cuts))
        if entries is None:
            raise ValueError("gather_home: this process holds no block of "
                             "the result")
        blocks = np.empty(len(entries), dtype=object)
        for index, entry in enumerate(entries):
            blocks[index] = entry.to(self.home)
        blocks = blocks.reshape(shape)
        for (_, axis_dim) in reversed(cuts):
            joined = np.empty(blocks.shape[:-1], dtype=object)
            for index in np.ndindex(*blocks.shape[:-1]):
                joined[index] = torch.cat(list(blocks[index]), dim=axis_dim)
            blocks = joined
        return join_backward(blocks[()], mesh)

    def _line_entries(self, grid, axes: tuple):
        """The entries of one line of positions along `axes` (in their
        mixed-radix order), gathered from the processes that hold them:
        the line through index 0 of every other axis, or, for a process
        that holds none of its positions, the first line it holds one
        of -- detached then, as in first(): the first line's owners send
        every row's cotangent back, and a second live copy would count
        it twice.  Every process walks the same lines (the plan depends
        on the mesh alone): a line is exchanged when one of its owners
        has no line yet, and then all its owners take part."""
        mesh = self.mesh
        lines = _groups(mesh, axes)
        if mesh.processes is None:
            return _entries(mesh, grid, lines[0])
        owners = mesh.processes.reshape(-1)
        served: set = set()
        mine = None
        for number, members in enumerate(lines):
            ranks = {int(owners[index]) for index in members}
            if ranks <= served:
                continue
            served |= ranks
            entries = _entries(mesh, grid, members)
            if mine is None and entries is not None:
                mine = (entries if number == 0
                        else [entry.detach() for entry in entries])
        return mine


def _dense_partial(params: dict, x):
    """x @ w of one block, without the bias: x's dtype, or f32 (times
    the scale) for int8 codes."""
    w = params["w"]
    if w.dtype == torch.int8:
        return torch.matmul(x.float(), w.float()) * params["w_scale"].float()
    return dense({"w": w}, x)


def _finish(out, bias, x_dtype):
    """Add the bias block (None: no bias) in f32 after the sum; one
    rounding to the activation's dtype."""
    if bias is not None:
        return (out.float() + bias.float()).to(x_dtype)
    return out.to(x_dtype)


def _bias_block(call: ShardedCall, weight, axis_name: str, width: int):
    """Each position's block of a whole (replicated) bias along
    `axis_name`, None without one: a grid that varies only where the
    bias does, so the positions that share a sum share its result."""
    parts = call.cut[axis_name]

    def block(params, index):
        bias = params.get("b")
        if bias is None or parts == 1 or bias.shape[-1] == width:
            return bias
        return bias[..., index * width:(index + 1) * width]
    return map_shards(block, weight, call.index[axis_name])


def column_parallel(call: ShardedCall, weights: list, x) -> list:
    """x @ w for each param-dict grid of `weights` (rows over fsdp,
    columns over model), their partials fused into one psum over fsdp.
    x: a grid of whole activations (..., in).  Returns one grid per
    weight of the position's model block of the output (..., out/M)."""
    x_slice = call.slice_axis(x, "fsdp")

    def partials(x_part, *params):
        outs = [_dense_partial(entry, x_part) for entry in params]
        dtype = (torch.float32 if any(out.dtype == torch.float32
                                      for out in outs) else outs[0].dtype)
        return torch.cat([out.to(dtype) for out in outs], dim=-1)

    summed = call.psum(map_shards(partials, x_slice, *weights), "fsdp")
    widths = [next(entry for entry in grid.flat if entry is not None)["w"]
              .shape[-1] for grid in weights]
    dtype = next(entry for entry in x.flat if entry is not None).dtype
    results = []
    for number, weight in enumerate(weights):
        start, width = sum(widths[:number]), widths[number]
        results.append(map_shards(
            lambda total, bias, start=start, width=width: _finish(
                total[..., start:start + width], bias, dtype),
            summed, _bias_block(call, weight, "model", width)))
    return results


def row_parallel(call: ShardedCall, weight, x):
    """x @ w for a param-dict grid (rows over model, columns over fsdp):
    x is each position's model block of the activation (..., in/M); the
    partials psum over model, the bias block is added, and the fsdp
    blocks gather into the whole output on every position."""
    partial = map_shards(lambda x_part, params: _dense_partial(params, x_part),
                         x, weight)
    summed = call.psum(partial, "model")
    dtype = next(entry for entry in x.flat if entry is not None).dtype
    width = next(entry for entry in summed.flat
                 if entry is not None).shape[-1]
    done = map_shards(lambda total, bias: _finish(total, bias, dtype),
                      summed, _bias_block(call, weight, "fsdp", width))
    return call.all_gather(done, "fsdp")
