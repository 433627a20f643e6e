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
#   fsdp  -- parameter sharding axis (zero-style, all-gather on use)
#   model -- tensor parallelism (megatron-style matmul sharding)
#   seq   -- sequence/context parallelism (ring attention / Ulysses)
#   expert - expert parallelism for MoE layers
#
# Only the seq axis is ported: a mesh with any other axis above 1 raises
# NotImplementedError naming ROADMAP Queue A item 4b (the parameter
# sharding axes, which need an SPMD partitioner of the port's own).
#
# One process drives every device of a mesh.  A torch tensor lives on one
# device, so a placed tensor stays whole on the mesh's first device (its
# `home`); the sequence-parallel functions cut it into per-device shards
# where they run (parallel/attention.py) and gather the results home.
#
# The device list defaults to every CUDA device.  set_default_devices
# installs another, which may name one device more than once: the
# counterpart of XLA's forced host device count, so that a {"seq": 4}
# mesh runs four shards on one card (or on the CPU in the tests).

from __future__ import annotations

import contextlib
import contextvars
import threading
from collections import OrderedDict

import numpy as np
import torch

__all__ = [
    "MESH_AXIS_ORDER", "Mesh", "PartitionSpec", "NamedSharding",
    "create_mesh", "get_mesh", "named_sharding", "partition_spec",
    "shard_pytree", "tree_shardings", "filter_specs", "default_devices",
    "set_default_devices", "use_mesh", "ambient_mesh",
]

# Ordering matters for interconnect locality: innermost (fastest-varying)
# axes get the most tightly coupled devices.  model/seq want the most
# bandwidth, so they are last (minor-most) in the device grid.
MESH_AXIS_ORDER = ("data", "fsdp", "expert", "pipeline", "seq", "model")
# the axes whose size may exceed 1 in this port
_PORTED_AXES = ("seq",)

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
    grid axis."""

    def __init__(self, grid: np.ndarray, axis_names: tuple):
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        """The first device: where placed tensors and results live."""
        return self.devices.flat[0]

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
    unported = {name: size for name, size in canonical
                if size > 1 and name not in _PORTED_AXES}
    if unported:
        raise NotImplementedError(
            f"mesh axes {unported} are not yet ported to the torch port: "
            f"only the 'seq' axis may exceed 1 (ROADMAP Queue A item 4b: "
            f"the parameter-sharding axes data, fsdp, model and expert)")
    grid = np.empty(len(device_list), dtype=object)
    grid[:] = device_list
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


def _place(leaf, sharding: NamedSharding) -> torch.Tensor:
    """One leaf checked against its sharding (ValueError when a dimension
    does not divide) and moved to the mesh's home device."""
    tensor = (leaf if isinstance(leaf, torch.Tensor)
              else torch.as_tensor(np.asarray(leaf)))
    sharding.shard_shape(tuple(tensor.shape))
    return tensor.to(sharding.mesh.home)


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
    """Check a tree of tensors (or arrays) against per-leaf PartitionSpecs
    (tree_shardings' semantics) and move each leaf WHOLE to the mesh's
    home device.  It cuts nothing: the spec only decides whether a leaf
    passes (ValueError when a dimension does not divide by its axes).
    The sequence-parallel functions cut their operands where they run."""
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
