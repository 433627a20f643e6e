# Device-mesh management: the placement layer.
#
# Counterpart of aiko_services_tpu/parallel/mesh.py.  A Mesh is a grid of
# torch.devices with named axes; a ComputeElement names its axes in its
# definition's "sharding" block, its state and inputs are placed through
# shard_pytree, and its mesh is the AMBIENT mesh (use_mesh, the
# counterpart of jax.set_mesh) while it computes, so the model's
# sequence-parallel attention finds it without an argument.
#
# Axis convention (the "How to Scale Your Model" recipe):
#   data  -- batch-axis data parallelism
#   fsdp  -- parameter sharding axis (each contraction reduced as partial
#            sums over it; the train step's gradients follow)
#   model -- tensor parallelism (megatron-style matmul sharding)
#   seq   -- sequence/context parallelism (ring attention / Ulysses)
#   expert - expert parallelism for MoE layers
#
# Placement: shard_pytree cuts every leaf whose spec names an axis above 1
# into the blocks the spec names, and puts each block on its mesh
# position's device -- a Sharded leaf: the global shape and dtype, its
# NamedSharding and an object grid of local tensors over the mesh's
# shape.  Positions that hold the same block on the same torch device
# share one tensor, so a mesh that names one card eight times keeps one
# copy of a replicated block, not eight.  A leaf that no axis cuts stays
# one whole tensor on the mesh's first local device (its `home`), as
# before.  unshard() gathers a Sharded leaf back into one tensor.  The
# model code computes on the shards (parallel/collectives.py moves data
# between them); GSPMD's global view holds: a sharded call computes what
# the unsharded one computes.
#
# One process drives every device of a mesh, except on a mesh from
# parallel.distributed.global_mesh, which spans the job's processes: there
# each process holds the shards of its own devices (the others are None)
# and the collectives run over torch.distributed.
#
# The device list defaults to every CUDA device.  set_default_devices
# installs another, which may name one device more than once: the
# counterpart of XLA's forced host device count, so that a {"fsdp": 2,
# "model": 4} mesh runs eight shards on one card (or on the CPU in the
# tests).

from __future__ import annotations

import contextlib
import contextvars
import threading
from collections import OrderedDict

import numpy as np
import torch

__all__ = [
    "MESH_AXIS_ORDER", "Mesh", "PartitionSpec", "NamedSharding", "Sharded",
    "create_mesh", "get_mesh", "named_sharding", "partition_spec",
    "shard_pytree", "tree_shardings", "filter_specs", "default_devices",
    "set_default_devices", "use_mesh", "ambient_mesh", "unshard",
    "sharded_leaves", "spec_layout", "leaf_layout", "layout_matches",
    "layout_spec", "assign",
]

# Ordering matters for interconnect locality: innermost (fastest-varying)
# axes get the most tightly coupled devices.  model/seq want the most
# bandwidth, so they are last (minor-most) in the device grid.
MESH_AXIS_ORDER = ("data", "fsdp", "expert", "pipeline", "seq", "model")

_MESH_CACHE: dict = {}
_MESH_LOCK = threading.Lock()
_DEVICES: list | None = None
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "aiko_ambient_mesh", default=None)


class PartitionSpec(tuple):
    """Per-dimension mesh-axis names of an array: None (not sharded), an
    axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """A grid of torch.devices (a numpy object array) with one name per
    grid axis.  `processes`, on a mesh that spans a job's processes
    (parallel.distributed.global_mesh), is the grid of each position's
    rank; None when this process drives every position."""

    def __init__(self, grid: np.ndarray, axis_names: tuple,
                 processes: np.ndarray | None = None, rank: int = 0):
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.processes = processes
        self.rank = rank
        self.local = (np.ones(grid.shape, dtype=bool) if processes is None
                      else processes == rank)
        # torch.distributed process groups by member ranks, and the
        # position groups of each set of axes (collectives)
        self.process_groups: dict = {}
        self.group_cache: dict = {}
        # across processes (collectives): each process group's count of
        # exchanges, and the chain of backward collectives of the forward
        # in flight (its own while open, a weak reference once joined)
        self.sequence: dict = {}
        self.chain = None
        # calls of a grid function by name (parallel/attention.py): the
        # ring's exchanges carry their call's number in their checked
        # tag, so processes one ring apart fail at once
        self.calls: dict = {}

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def size(self, axis_name: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis_name, 1)

    @property
    def local_devices(self) -> np.ndarray:
        """The device grid with None at other processes' positions: a
        grid built from it (collectives.map_shards) holds entries only
        where this process computes."""
        if self.processes is None:
            return self.devices
        out = np.empty(self.devices.shape, dtype=object)
        out[self.local] = self.devices[self.local]
        return out

    @property
    def process_axes(self) -> tuple:
        """The axes along which positions lie on other processes (none
        on a mesh one process drives)."""
        if self.processes is None:
            return ()
        return tuple(name for axis, name in enumerate(self.axis_names)
                     if (np.diff(self.processes, axis=axis) != 0).any())

    @property
    def home(self) -> torch.device:
        """The first local device: where placed tensors and results
        live."""
        return self.devices[self.local].flat[0]

    def line(self, axis_name: str, position: tuple) -> "Mesh":
        """The 1-D mesh of the positions along `axis_name` through
        `position` (a grid index), named `axis_name`."""
        axis = self.axis_names.index(axis_name)
        index = list(position)
        index[axis] = slice(None)
        return Mesh(self.devices[tuple(index)].copy(), (axis_name,))

    def axis_devices(self, axis_name: str) -> list:
        """The devices along `axis_name`, in axis order, at index 0 of
        every other axis (the only index there is while those axes are
        1)."""
        if axis_name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{axis_name!r} axis")
        axis = self.axis_names.index(axis_name)
        line = np.moveaxis(self.devices, axis, 0).reshape(
            self.devices.shape[axis], -1)[:, 0]
        return list(line)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(device) for device in self.devices.flat]})")


def default_devices() -> list:
    """The device list create_mesh and get_mesh use when given none: the
    list set_default_devices installed, else every CUDA device."""
    if _DEVICES is not None:
        return list(_DEVICES)
    return [torch.device("cuda", index)
            for index in range(torch.cuda.device_count())]


def set_default_devices(device_list) -> None:
    """Install the process's device list (None restores every CUDA
    device).  It may name one device more than once: a {"seq": 4} mesh
    over [cuda:0] * 4 runs four shards on one card."""
    global _DEVICES
    _DEVICES = (None if device_list is None
                else [torch.device(device) for device in device_list])


def _canonical_axes(axes: dict, device_count: int) -> tuple:
    """Order axes by MESH_AXIS_ORDER (unknown names keep given order at the
    end) and resolve a single -1 entry to fill the remaining devices."""
    known = [name for name in MESH_AXIS_ORDER if name in axes]
    unknown = [name for name in axes if name not in MESH_AXIS_ORDER]
    ordered = known + unknown
    sizes = {name: int(axes[name]) for name in ordered}
    fill = [name for name, size in sizes.items() if size == -1]
    if len(fill) > 1:
        raise ValueError(f"Only one mesh axis may be -1, got {fill}")
    if fill:
        fixed = 1
        for name, size in sizes.items():
            if size != -1:
                fixed *= size
        if device_count % fixed != 0:
            raise ValueError(
                f"{device_count} devices not divisible by fixed axes "
                f"{sizes} (product {fixed})")
        sizes[fill[0]] = device_count // fixed
    return tuple((name, sizes[name]) for name in ordered)


def create_mesh(axes: dict | None = None, devices=None) -> Mesh:
    """Build a Mesh from an axis-size mapping, e.g. {"data": 1, "seq": 4}.
    With no axes, the whole device list becomes a 1-D "data" mesh.  The
    grid is the device list reshaped in MESH_AXIS_ORDER."""
    device_list = [torch.device(device) for device in (
        devices if devices is not None else default_devices())]
    axes = dict(axes or {"data": -1})
    canonical = _canonical_axes(axes, len(device_list))
    shape = tuple(size for _, size in canonical)
    names = tuple(name for name, _ in canonical)
    total = int(np.prod(shape))
    if total != len(device_list):
        raise ValueError(
            f"Mesh axes {dict(canonical)} need {total} devices, "
            f"have {len(device_list)}")
    if not device_list:
        raise ValueError("create_mesh: no devices (no CUDA device, and no "
                         "list installed by set_default_devices)")
    # equal devices become one object: the shard code shares work and
    # tensors between positions by identity
    canonical_devices: dict = {}
    grid = np.empty(len(device_list), dtype=object)
    grid[:] = [canonical_devices.setdefault(str(device), device)
               for device in device_list]
    return Mesh(grid.reshape(shape), names)


def get_mesh(axes: dict | None = None, devices=None) -> Mesh:
    """Cached create_mesh: elements naming the same topology share a Mesh."""
    device_list = [torch.device(device) for device in (
        devices if devices is not None else default_devices())]
    axes = dict(axes or {"data": -1})
    key = (tuple(sorted(axes.items())), tuple(device_list))
    with _MESH_LOCK:
        mesh = _MESH_CACHE.get(key)
        if mesh is None:
            mesh = create_mesh(axes, device_list)
            _MESH_CACHE[key] = mesh
        return mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """The ambient mesh for the code inside the block (the counterpart of
    jax.set_mesh): sequence-parallel attention called with mesh=None runs
    on it.  A context variable, so it holds for this thread only: an
    element computing on its own thread never sees another's mesh."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh() -> Mesh | None:
    return _AMBIENT.get()


def partition_spec(spec) -> PartitionSpec:
    """Coerce a user-level spec into a PartitionSpec.

    Accepts: PartitionSpec (passthrough), None (replicated), a single axis
    name ("data" == shard dim 0 on data), or a list whose entries are axis
    names, None, or tuples/lists of axis names, e.g. ["data", None, "seq"]
    or [["data", "fsdp"], None].
    """
    if isinstance(spec, PartitionSpec):
        return spec
    if spec is None:
        return PartitionSpec()
    if isinstance(spec, str):  # bare name, NOT iterated per-character
        return PartitionSpec(spec)
    return PartitionSpec(*(tuple(entry) if isinstance(entry, (list, tuple))
                           else entry for entry in spec))


class NamedSharding:
    """A PartitionSpec over a Mesh."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def _axis_product(self, entry) -> int:
        names = entry if isinstance(entry, tuple) else (entry,)
        product = 1
        for name in names:
            if name is not None:
                if name not in self.mesh.axis_names:
                    raise ValueError(
                        f"PartitionSpec {self.spec} names axis {name!r}, "
                        f"absent from mesh axes {self.mesh.axis_names}")
                product *= self.mesh.shape[name]
        return product

    @property
    def is_fully_replicated(self) -> bool:
        return all(self._axis_product(entry) == 1 for entry in self.spec)

    def shard_shape(self, shape: tuple) -> tuple:
        """The shape of one device's shard; ValueError when the spec has
        more entries than the array has dimensions or a dimension does
        not divide by its axes."""
        if len(self.spec) > len(shape):
            raise ValueError(f"PartitionSpec {self.spec} has more entries "
                             f"than shape {tuple(shape)} has dimensions")
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            parts = self._axis_product(entry)
            if out[dim] % parts:
                raise ValueError(
                    f"dimension {dim} of shape {tuple(shape)} is not "
                    f"divisible by mesh axes {entry} (size {parts})")
            out[dim] //= parts
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named_sharding(mesh: Mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, partition_spec(spec))


class Sharded:
    """A tensor cut into blocks over a mesh: `shape` and `dtype` are the
    global tensor's, `sharding` its NamedSharding, and `shards` an object
    array of the mesh's shape whose entry at each position is that
    position's block, on that position's device (None where the position
    belongs to another process).  Positions holding the same block on
    the same device share one tensor: `unique()` lists each once, and
    the parameter-tree utilities (utils/tree.py) walk those, so an
    optimizer updates each block once."""

    def __init__(self, shape, dtype, sharding: NamedSharding,
                 shards: np.ndarray):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = shards

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def unique(self) -> list:
        """Each distinct local tensor once, in grid order."""
        seen, out = set(), []
        for tensor in self.shards.flat:
            if tensor is not None and id(tensor) not in seen:
                seen.add(id(tensor))
                out.append(tensor)
        return out

    def rebuild(self, tensors: list) -> "Sharded":
        """A Sharded of the same sharding whose distinct blocks are
        `tensors` (in unique() order), shared as this one's are."""
        by_id = {id(old): new for old, new in zip(self.unique(), tensors)}
        grid = np.empty(self.shards.shape, dtype=object)
        for index, tensor in np.ndenumerate(self.shards):
            grid[index] = None if tensor is None else by_id[id(tensor)]
        first = tensors[0]
        return Sharded(self.shape, first.dtype, self.sharding, grid)

    def map(self, function) -> "Sharded":
        return self.rebuild([function(tensor) for tensor in self.unique()])

    @property
    def addressable_shards(self) -> list:
        """The local blocks, one per local position, in grid order."""
        return [tensor for tensor in self.shards.flat if tensor is not None]

    def block(self, position: tuple) -> tuple:
        """The index of the block position `position` holds, per
        dimension."""
        return _block_index(self.sharding, position, len(self.shape))

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec})")


def _entry_names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _block_index(sharding: NamedSharding, position: tuple,
                 ndim: int) -> tuple:
    """Per dimension, the block of the dimension's axes that `position`
    holds (axes listed together count major first, as in JAX)."""
    mesh = sharding.mesh
    blocks = []
    for dim in range(ndim):
        entry = sharding.spec[dim] if dim < len(sharding.spec) else None
        index = 0
        for name in _entry_names(entry):
            axis = mesh.axis_names.index(name)
            index = index * mesh.devices.shape[axis] + position[axis]
        blocks.append(index)
    return tuple(blocks)


def spec_layout(spec, mesh: Mesh, ndim: int, sizes=None) -> tuple:
    """Per dimension, the axes of `spec` that cut it: those the mesh has
    with a size above 1 (in `sizes`, when given, in place of the mesh's
    own).  Two leaves with one layout are placed alike."""
    sizes = dict(mesh.shape) if sizes is None else sizes
    entries = tuple(partition_spec(spec)) if spec is not None else ()
    layout = tuple(tuple(name for name in _entry_names(entry)
                         if name in mesh.shape and sizes.get(name, 1) > 1)
                   for entry in entries)
    return layout + ((),) * (ndim - len(layout))


def leaf_layout(leaf, mesh: Mesh) -> tuple:
    """The layout of a placed leaf: its spec's for a Sharded, no cut for
    a whole tensor."""
    spec = leaf.sharding.spec if isinstance(leaf, Sharded) else None
    return spec_layout(spec, mesh, leaf.ndim)


def layout_matches(tree, specs, mesh: Mesh, sizes: dict) -> bool:
    """Whether every leaf of `tree` is cut as its spec in `specs` (a
    spec tree; a missing entry means whole) cuts it over the axes
    `sizes` names above 1."""
    if isinstance(tree, dict):
        return all(layout_matches(value, specs.get(key)
                                  if isinstance(specs, dict) else None,
                                  mesh, sizes)
                   for key, value in tree.items())
    return leaf_layout(tree, mesh) == spec_layout(specs, mesh, tree.ndim,
                                                  sizes)


def layout_spec(layout: tuple) -> PartitionSpec:
    """The PartitionSpec of a layout (spec_layout's per-dimension axis
    tuples)."""
    return PartitionSpec(*(None if not names else names[0]
                           if len(names) == 1 else names
                           for names in layout))


def assign(target, value) -> None:
    """Copy the whole tensor `value` into `target` in place: a tensor,
    or each local block of a Sharded its block of `value`."""
    with torch.no_grad():
        if not isinstance(target, Sharded):
            target.copy_(value)
            return
        local_shape = target.sharding.shard_shape(tuple(target.shape))
        seen = set()
        for position, block in np.ndenumerate(target.shards):
            if block is None or id(block) in seen:
                continue
            seen.add(id(block))
            block.copy_(value[tuple(
                slice(start * size, (start + 1) * size)
                for start, size in zip(target.block(position),
                                       local_shape))])


def sharded_leaves(tree):
    """The Sharded leaves of a tree of dicts and lists."""
    if isinstance(tree, Sharded):
        yield tree
    elif isinstance(tree, (dict, list)):
        for value in (tree.values() if isinstance(tree, dict) else tree):
            yield from sharded_leaves(value)


@torch.no_grad()
def _place(leaf, sharding: NamedSharding):
    """One leaf checked against its sharding (ValueError when a dimension
    does not divide): whole on the mesh's home device when no axis of its
    spec exceeds 1, else a Sharded of its blocks."""
    if isinstance(leaf, Sharded):
        if (leaf.mesh is sharding.mesh and leaf_layout(leaf, leaf.mesh)
                == spec_layout(sharding.spec, leaf.mesh, leaf.ndim)):
            return leaf  # already placed so
        leaf = unshard(leaf)
    tensor = (leaf if isinstance(leaf, torch.Tensor)
              else torch.as_tensor(np.asarray(leaf)))
    local_shape = sharding.shard_shape(tuple(tensor.shape))
    mesh = sharding.mesh
    if sharding.is_fully_replicated:
        return tensor.to(mesh.home)
    grid = np.empty(mesh.devices.shape, dtype=object)
    made: dict = {}
    for position, device in np.ndenumerate(mesh.devices):
        if not mesh.local[position]:
            continue
        block = _block_index(sharding, position, tensor.ndim)
        key = (block, id(device))
        if key not in made:
            index = tuple(slice(start * size, (start + 1) * size)
                          for start, size in zip(block, local_shape))
            made[key] = tensor[index].to(device).clone(
                memory_format=torch.contiguous_format)
        grid[position] = made[key]
    return Sharded(tensor.shape, tensor.dtype, sharding, grid)


def unshard(leaf) -> torch.Tensor:
    """A Sharded leaf gathered into one tensor on its mesh's home device
    (a plain tensor passes through).

    On a mesh over several processes each process holds only its own
    blocks; the others' are gathered through torch.distributed (the
    collectives' group gather), so unshard is then a COLLECTIVE: every
    process of the mesh must reach it, for the same leaves in the same
    order.  The sharded model paths do (the token grid at entry, the
    cache write-back and the logits at exit, LMForward's output), and so
    must a caller of save_pytree or Checkpointer.save on a sharded
    tree.  The gathered blocks are detached: this is the serving and
    checkpoint gather, and no gradient flows back through it.  The
    collectives' own gather (parallel/collectives.py) is the one that
    carries gradients across processes, and reshard's backward carries a
    gradient back through the unshard it moves a leaf with."""
    if not isinstance(leaf, Sharded):
        return leaf
    mesh = leaf.mesh
    blocks = leaf.shards
    if not mesh.local.all():
        from .collectives import _entries
        entries = _entries(mesh, blocks, list(range(blocks.size)))
        if entries is None:
            raise ValueError("unshard: this process holds no block of "
                             "the leaf's mesh")
        blocks = np.empty(blocks.size, dtype=object)
        for index, entry in enumerate(entries):
            blocks[index] = entry
        blocks = blocks.reshape(leaf.shards.shape)
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=mesh.home)
    local_shape = leaf.sharding.shard_shape(tuple(leaf.shape))
    for position, tensor in np.ndenumerate(blocks):
        index = tuple(slice(start * size, (start + 1) * size)
                      for start, size in zip(leaf.block(position),
                                             local_shape))
        out[index] = tensor.detach().to(mesh.home)
    return out


def _spec_leaf(entry) -> bool:
    """Is `entry` one whole-array spec (vs a structural subtree)?  Axis
    lists like ["data", None] or [("data", "fsdp"), None] count -- they
    BROADCAST over a subtree; per-item spec lists must therefore use
    PartitionSpec objects to stay unambiguous."""
    if entry is None or isinstance(entry, (PartitionSpec, str)):
        return True
    if isinstance(entry, (list, tuple)):
        return all(
            axis is None or isinstance(axis, str)
            or (isinstance(axis, (list, tuple))
                and all(isinstance(name, str) for name in axis))
            for axis in entry)
    return False


def _walk(tree, mesh: Mesh, specs, leaf_fn):
    """leaf_fn(leaf, its NamedSharding) at every leaf of `tree`, the tree
    rebuilt around the results.  specs may be a single spec applied to
    every leaf, or a (possibly PARTIAL) tree: leaves present in `tree`
    but absent from `specs` replicate, and a spec where the tree has a
    subtree broadcasts over it."""
    def build(node, spec_node):
        if isinstance(node, dict):
            if isinstance(spec_node, dict):
                return {key: build(value, spec_node.get(key))
                        for key, value in node.items()}
            broadcast = spec_node if _spec_leaf(spec_node) else None
            return {key: build(value, broadcast)
                    for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            if (isinstance(spec_node, (list, tuple))
                    and not _spec_leaf(spec_node)
                    and len(spec_node) == len(node)):
                built = [build(value, spec)
                         for value, spec in zip(node, spec_node)]
            else:
                broadcast = spec_node if _spec_leaf(spec_node) else None
                built = [build(value, broadcast) for value in node]
            if isinstance(node, tuple):
                # namedtuples take positional fields, not an iterable
                return (type(node)(*built) if hasattr(node, "_fields")
                        else type(node)(built))
            return built
        return leaf_fn(node, named_sharding(
            mesh, spec_node if _spec_leaf(spec_node) else None))

    return build(tree, specs)


def tree_shardings(tree, mesh: Mesh, specs):
    """The NamedSharding shard_pytree gives each leaf of `tree`."""
    return _walk(tree, mesh, specs, lambda leaf, sharding: sharding)


def shard_pytree(tree, mesh: Mesh, specs):
    """Place a tree of tensors (or arrays) by per-leaf PartitionSpecs
    (tree_shardings' semantics): a leaf whose spec names an axis above 1
    becomes a Sharded of its blocks, each on its position's device; any
    other leaf moves whole to the mesh's home device.  ValueError when a
    dimension does not divide by its axes."""
    return _walk(tree, mesh, specs, _place)


def filter_specs(specs, mesh: Mesh):
    """Drop axis names a mesh doesn't have from a tree of PartitionSpecs.

    Model code publishes specs over the full axis vocabulary (data/fsdp/
    seq/model); a deployment that collapses an axis filters rather than
    rewriting every spec.
    """
    names = set(mesh.axis_names)

    def filter_entry(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(name for name in entry if name in names)
            return kept if kept else None
        return entry if entry in names else None

    def walk(node):
        if node is None or isinstance(node, (PartitionSpec, list, str)):
            return PartitionSpec(*(filter_entry(entry)
                                   for entry in partition_spec(node)))
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        if isinstance(node, tuple):
            built = [walk(value) for value in node]
            return (type(node)(*built) if hasattr(node, "_fields")
                    else type(node)(built))
        return node

    return walk(specs)
