# Collectives over a named mesh axis: what XLA's SPMD partitioner inserts
# between the shards of a program, written out.
#
# No counterpart file in the JAX package, where GSPMD places psum,
# all_gather, reduce_scatter, all_to_all and collective_permute itself.
# Here the model code (models/transformer.py, models/asr.py) computes on
# the shards of its Sharded leaves and calls these between the steps.
#
# A GRID is a numpy object array of the mesh's shape holding, at each
# position, that position's local tensor (None for a position of another
# process).  map_shards(fn, *grids) runs fn position by position; the
# collectives take a grid and the axes to work over and return a grid.
# One Python thread issues every shard's work, in the list idiom of
# parallel/attention.py.
#
# Sharing: where two positions' inputs are the very same tensors,
# map_shards computes once and gives both the same result, and a
# collective gives two groups with the same entries the same result.  So
# work that a mesh replicates over an axis runs once per torch device: on
# a mesh that names one card eight times, a norm replicated over "model"
# runs once, and its output stays one tensor.
#
# On a one-process mesh the collectives move tensors with .to(device) and
# torch ops, so autograd carries gradients back through them: a psum's
# backward sends the cotangent to every partial, an all_gather's slices
# it.  Sums reduce in f32 and round once to the entries' dtype, as
# models.layers.f32_reduction does for products.  On a mesh from
# parallel.distributed.global_mesh each group gathers its entries from
# the other processes through torch.distributed (gloo on the CPU, NCCL on
# CUDA) on the group's own process group, then computes as above; no
# gradient crosses processes.
#
# Every collective over an axis whose size exceeds 1 adds one call and
# its bytes -- the bytes of every participating position's input -- to
# the counter of its axes (collective_counts); over axes of size 1 it is
# the identity and counts nothing.  reshard (a leaf moved from one layout
# into another, GSPMD's re-partition of an operand the program wants cut
# otherwise) counts as one call over the axes of both layouts, with the
# bytes of every source position's block; conform reshards only the
# leaves of a tree whose layout differs, so a tree already laid out as
# wanted moves and counts nothing.  Tests and chip_smoke.py read the
# counter as the JAX tests count collectives in the compiled HLO.

from __future__ import annotations

import threading

import numpy as np
import torch

from .mesh import (
    Mesh, Sharded, layout_spec, leaf_layout, named_sharding, shard_pytree,
    spec_layout)

__all__ = ["map_shards", "axis_index", "psum", "all_gather",
           "psum_scatter", "all_to_all", "ppermute", "collective_counts",
           "reset_collective_counts", "collective_totals",
           "sum_replica_grads", "reshard", "conform"]

_COUNTS: dict = {}
_COUNTS_LOCK = threading.Lock()


def collective_counts() -> dict:
    """{axes: {"calls": n, "bytes": n}} since the last reset; `axes` is
    the axis names joined by "+" in mesh order."""
    with _COUNTS_LOCK:
        return {axes: dict(entry) for axes, entry in _COUNTS.items()}


def collective_totals() -> tuple:
    """(calls, bytes) over every axis since the last reset."""
    counts = collective_counts()
    return (sum(entry["calls"] for entry in counts.values()),
            sum(entry["bytes"] for entry in counts.values()))


def reset_collective_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


def _record(axes: tuple, grid: np.ndarray) -> None:
    size = sum(tensor.numel() * tensor.element_size()
               for tensor in grid.flat if tensor is not None)
    with _COUNTS_LOCK:
        entry = _COUNTS.setdefault("+".join(axes), {"calls": 0, "bytes": 0})
        entry["calls"] += 1
        entry["bytes"] += int(size)


def map_shards(function, *grids) -> np.ndarray:
    """function(*entries) at every position where the first grid has an
    entry; positions whose entries are the same objects share one call
    and one result.  Returns the grid of results."""
    out = np.empty(grids[0].size, dtype=object)
    made: dict = {}
    for index, entries in enumerate(zip(*[grid.ravel().tolist()
                                          for grid in grids])):
        if entries[0] is None:
            continue
        key = tuple(map(id, entries))
        result = made.get(key)
        if result is None:
            result = made[key] = function(*entries)
        out[index] = result
    return out.reshape(grids[0].shape)


def axis_index(mesh: Mesh, axis_name: str) -> np.ndarray:
    """The grid of each position's index along `axis_name` (0 everywhere
    when the mesh has no such axis)."""
    out = np.empty(mesh.devices.shape, dtype=object)
    if axis_name not in mesh.axis_names:
        out.fill(0)
        return out
    axis = mesh.axis_names.index(axis_name)
    for position in np.ndindex(mesh.devices.shape):
        out[position] = position[axis]
    return out


def _axes(mesh: Mesh, axis_names) -> tuple:
    """The named axes the mesh has with size above 1, in mesh order."""
    names = (axis_names,) if isinstance(axis_names, str) else axis_names
    return tuple(name for name in mesh.axis_names
                 if name in names and mesh.shape[name] > 1)


def _groups(mesh: Mesh, axes: tuple) -> list:
    """Lists of flat position indices: each one group of the positions
    that differ only along `axes`, in the axes' mixed-radix order (first
    axis major).  Kept on the mesh."""
    groups = mesh.group_cache.get(axes)
    if groups is None:
        shape = mesh.devices.shape
        flat = np.arange(int(np.prod(shape))).reshape(shape)
        moved = np.moveaxis(flat, [mesh.axis_names.index(name)
                                   for name in axes], range(-len(axes), 0))
        groups = mesh.group_cache[axes] = moved.reshape(-1, int(np.prod(
            [mesh.shape[name] for name in axes]))).tolist()
    return groups


def _process_group(mesh: Mesh, ranks: tuple):
    """The torch.distributed group of `ranks`, created on first use.
    Every process walks every group of a collective in the same order and
    calls this for each, so new_group runs everywhere alike."""
    import torch.distributed as dist
    group = mesh.process_groups.get(ranks)
    if group is None:
        group = mesh.process_groups[ranks] = dist.new_group(list(ranks))
    return group


def _entries(mesh: Mesh, grid: np.ndarray, members) -> list | None:
    """The group's entries in group order; on a mesh over several
    processes the other processes' entries are gathered through
    torch.distributed.  None when this process holds no member."""
    flat = grid.reshape(-1)
    if mesh.processes is None:
        return [flat[index] for index in members]
    members = np.asarray(members)
    import torch.distributed as dist
    owners = mesh.processes.reshape(-1)[members]
    ranks = tuple(sorted(set(int(rank) for rank in owners)))
    group = _process_group(mesh, ranks) if len(ranks) > 1 else None
    mine = [index for index, rank in zip(members, owners)
            if rank == mesh.rank]
    if not mine:
        return None
    if group is None:
        return [flat[index] for index in members]
    local = torch.stack([flat[index].detach().contiguous()
                         for index in mine])
    received = [torch.empty_like(local) for _ in ranks]
    dist.all_gather(received, local, group=group)
    taken = {rank: iter(block) for rank, block in zip(ranks, received)}
    return [next(taken[int(rank)]) for rank in owners]


def _collective(mesh: Mesh, grid: np.ndarray, axis_names, compute):
    """Run compute(entries, k, device) -> the result of the group's k-th
    position on `device`, for every local position; groups and
    positions that see the same entries on the same device share
    results."""
    axes = _axes(mesh, axis_names)
    if not axes:
        return grid
    _record(axes, grid)
    out = np.empty(grid.size, dtype=object)
    made: dict = {}
    devices = mesh.devices.ravel().tolist()
    local = mesh.local.ravel().tolist()
    for members in _groups(mesh, axes):
        entries = _entries(mesh, grid, members)
        if entries is None:
            continue
        ids = tuple(map(id, entries))
        for k, index in enumerate(members):
            if not local[index]:
                continue
            device = devices[index]
            key = (ids, k if compute.per_position else None, id(device))
            result = made.get(key)
            if result is None:
                result = made[key] = compute(entries, k, device)
            out[index] = result
    return out.reshape(grid.shape)


def _per_group(function):
    function.per_position = False
    return function


def _per_position(function):
    function.per_position = True
    return function


def _sum(entries, device):
    """The entries summed in f32 on `device`, rounded once to their
    dtype."""
    total = None
    for entry in entries:
        entry = entry.to(device).float()
        total = entry if total is None else total + entry
    return total.to(entries[0].dtype)


def psum(grid: np.ndarray, mesh: Mesh, axis_names) -> np.ndarray:
    """Every position gets the sum of its group's entries over
    `axis_names` (one name or several)."""
    return _collective(mesh, grid, axis_names, _per_group(
        lambda entries, k, device: _sum(entries, device)))


def all_gather(grid: np.ndarray, mesh: Mesh, axis_name: str,
               dim: int) -> np.ndarray:
    """Every position gets its group's entries concatenated along `dim`
    in axis order."""
    return _collective(mesh, grid, axis_name, _per_group(
        lambda entries, k, device: torch.cat(
            [entry.to(device) for entry in entries], dim=dim)))


def psum_scatter(grid: np.ndarray, mesh: Mesh, axis_name: str,
                 dim: int) -> np.ndarray:
    """The group's sum cut along `dim`: position k gets block k."""
    def compute(entries, k, device):
        return torch.chunk(_sum(entries, device), len(entries),
                           dim=dim)[k]
    return _collective(mesh, grid, axis_name, _per_position(compute))


def all_to_all(grid: np.ndarray, mesh: Mesh, axis_name: str,
               split_dim: int, concat_dim: int) -> np.ndarray:
    """Each entry cut into n blocks along `split_dim`; position k gets
    block k of every entry, concatenated along `concat_dim` in axis
    order."""
    def compute(entries, k, device):
        return torch.cat([torch.chunk(entry, len(entries),
                                      dim=split_dim)[k].to(device)
                          for entry in entries], dim=concat_dim)
    return _collective(mesh, grid, axis_name, _per_position(compute))


def ppermute(grid: np.ndarray, mesh: Mesh, axis_name: str,
             perm) -> np.ndarray:
    """perm is a list of (source, destination) axis indices: the
    destination gets the source's entry; a position no pair names gets
    zeros, as in lax.ppermute."""
    sources = {destination: source for source, destination in perm}

    def compute(entries, k, device):
        if k not in sources:
            return torch.zeros_like(entries[k], device=device)
        return entries[sources[k]].to(device)
    return _collective(mesh, grid, axis_name, _per_position(compute))


@torch.no_grad()
def sum_replica_grads(leaf) -> None:
    """A Sharded parameter's gradient summed over its replicas: the
    positions that hold the same block on DIFFERENT devices hold distinct
    tensors, each with the gradient of its own positions' work, and each
    gets the sum (the psum over the axes the block is replicated on), so
    the replicas stay equal after the update.  Replicas on one device
    share their tensor, whose gradient autograd has already summed."""
    copies: dict = {}
    for position, tensor in np.ndenumerate(leaf.shards):
        if tensor is not None:
            group = copies.setdefault(leaf.block(position), {})
            group.setdefault(id(tensor), tensor)
    groups = [list(group.values()) for group in copies.values()
              if len(group) > 1]
    if not groups:
        return
    replicated = tuple(
        name for name in leaf.mesh.axis_names
        if leaf.mesh.shape[name] > 1 and not any(
            name in (entry if isinstance(entry, tuple) else (entry,))
            for entry in leaf.sharding.spec))
    for tensors in groups:
        grads = [tensor.grad if tensor.grad is not None
                 else torch.zeros_like(tensor) for tensor in tensors]
        for tensor in tensors:
            tensor.grad = _sum(grads, tensor.device)
    _record(replicated, leaf.shards)


def reshard(leaf, mesh: Mesh, spec):
    """`leaf` (a whole tensor or a Sharded of any layout) placed by
    `spec` over `mesh`: gathered whole (parallel.unshard; every block
    must be local) and cut again by shard_pytree.  Counted as one
    collective over the axes of both layouts, with the bytes of every
    source position's block (a whole source's bytes once)."""
    sharding = named_sharding(mesh, spec)
    wanted = spec_layout(sharding.spec, mesh, leaf.ndim)
    used = {name for names in leaf_layout(leaf, mesh) + wanted
            for name in names}
    axes = tuple(name for name in mesh.axis_names if name in used)
    if isinstance(leaf, Sharded):
        source = leaf.shards
    else:
        source = np.empty(1, dtype=object)
        source[0] = leaf
    if axes:
        _record(axes, source)
    return shard_pytree(leaf, mesh, sharding.spec)


def conform(tree, specs, mesh: Mesh, sizes: dict):
    """`tree` with every leaf cut as its spec in `specs` (a spec tree; a
    missing entry means whole) cuts it over the axes `sizes` names above
    1: a leaf cut otherwise is resharded into that layout, a leaf already
    so comes back as it is (nothing moves, nothing counts)."""
    if isinstance(tree, dict):
        return {key: conform(value, specs.get(key)
                             if isinstance(specs, dict) else None,
                             mesh, sizes)
                for key, value in tree.items()}
    wanted = spec_layout(specs, mesh, tree.ndim, sizes)
    if leaf_layout(tree, mesh) == wanted:
        return tree
    blocks = tree.unique() if isinstance(tree, Sharded) else [tree]
    if torch.is_grad_enabled() and any(block.requires_grad
                                       for block in blocks):
        # unshard gathers detached blocks: no gradient would reach them
        raise ValueError(
            f"a leaf cut {leaf_layout(tree, mesh)} takes a gradient; the "
            f"sharded path reshards only for inference -- place what "
            f"trains in the model's spec layout ({wanted} on this mesh)")
    return reshard(tree, mesh, layout_spec(wanted))
