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
# models.layers.f32_reduction does for products.
#
# On a mesh from parallel.distributed.global_mesh each group gathers its
# entries from the other processes through torch.distributed (gloo on the
# CPU, NCCL on CUDA) on the group's own process group, then computes as
# above -- except ppermute, which sends each block only to its
# destination's owner (one all_to_all with the other slots empty, per set
# of ranks; the ring's hops, parallel/attention.py).  Gradients cross the
# processes as XLA's transposes do:
#   - a collective's gather (_Across) hands each process's cotangents of
#     another process's entries back to their owner, which sums them (a
#     reduce-scatter: one all_to_all, summed in f32);
#   - a whole tensor a sharded call uses on every process (a replicated
#     parameter) sums its cotangents over the processes (_Replicated, an
#     all_reduce), and so does the whole gradient of a reshard;
#   - sum_replica_grads adds the gradients of a Sharded block's replicas
#     on other processes (one all_reduce over the block's owners);
#   - a ppermute's backward is the inverse permutation of the
#     cotangents, point to point again (_Permute).
# The processes pair their calls on one process group by order, and the
# autograd engine runs ready nodes in an order the graph alone does not
# fix, so every cross-process backward collective of a mesh takes the
# token the previous one produced (the mesh's chain): its backward then
# runs only after the later ones', in reverse forward order on every
# process.  join_backward ties the chain into a result every process's
# loss uses (ShardedCall.gather_home does for the model paths), so each
# process runs every node of it; from then on the result's graph holds
# the chain and the mesh only a weak reference, so no mesh keeps a graph
# alive.  A later forward's chain starts where a live joined one ended
# (a decoder reading the encoder's memory); begin_backward, called by
# optim.value_and_grad, makes the loss it computes start afresh, so the
# backward of an evaluation run with gradients on never joins a train
# step's.  Each exchange is preceded by a header (a
# per-group sequence number, the size, the members) that every process
# checks: processes out of step fail at once, never pairing two unrelated
# tensors.  gloo moves host tensors: on a gloo group a CUDA block goes
# through host memory, always (staged_bytes counts it).  NCCL moves
# tensors on the card its group is bound to, the process's first
# (distributed.process_card): every exchange's payload and header lie
# there (_wire), whatever card the entries lie on; a payload on another
# card of the process is copied there and its answer back, card to card
# (wire_copy_bytes counts it).  A process with one card a rank copies
# nothing.
#
# Every collective over an axis whose size exceeds 1 adds one call and
# its bytes -- the bytes of every participating position's input -- to
# the counter of its axes (collective_counts); over axes of size 1 it is
# the identity and counts nothing.  reshard (a leaf moved from one layout
# into another, GSPMD's re-partition of an operand the program wants cut
# otherwise) counts as one call over the axes of both layouts, with the
# bytes of every source position's block, and its backward (a gradient
# carried back into the source layout) as one more, with the bytes of
# every destination position's block; conform reshards only the
# leaves of a tree whose layout differs, so a tree already laid out as
# wanted moves and counts nothing.  Tests and chip_smoke.py read the
# counter as the JAX tests count collectives in the compiled HLO.  On a
# mesh over several processes each process counts its own positions'
# bytes; the cross-process sum of a replicated whole tensor's gradient
# counts one call over the axes that span processes, with the tensor's
# bytes, when its backward runs.

from __future__ import annotations

import threading
import weakref
import zlib

import numpy as np
import torch

from .distributed import process_card
from .mesh import (
    Mesh, Sharded, layout_spec, leaf_layout, named_sharding, shard_pytree,
    spec_layout, unshard)

__all__ = ["map_shards", "axis_index", "psum", "pmax", "all_gather",
           "psum_scatter", "all_to_all", "ppermute", "collective_counts",
           "reset_collective_counts", "collective_totals", "staged_bytes",
           "wire_copy_bytes", "sum_replica_grads", "replicated", "reshard",
           "conform", "join_backward", "begin_backward"]

_COUNTS: dict = {}
_STAGED = {"bytes": 0}
_WIRE_COPIED = {"bytes": 0}
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


def staged_bytes() -> int:
    """The bytes the cross-process exchanges copied between a card and
    host memory (to the host and back) since the last reset: gloo moves
    host tensors only."""
    with _COUNTS_LOCK:
        return _STAGED["bytes"]


def wire_copy_bytes() -> int:
    """The bytes the cross-process exchanges copied between two cards of
    this process since the last reset: a payload on another card than
    the NCCL group's (process_card) copied there, and the answer copied
    back to the card the caller named.  Nothing of it goes through host
    memory."""
    with _COUNTS_LOCK:
        return _WIRE_COPIED["bytes"]


def reset_collective_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()
        _STAGED["bytes"] = 0
        _WIRE_COPIED["bytes"] = 0


def _record(axes: tuple, grid: np.ndarray) -> None:
    size = sum(tensor.numel() * tensor.element_size()
               for entry in grid.flat if entry is not None
               for tensor in (entry if isinstance(entry, tuple)
                              else (entry,)))
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


def _mesh_ranks(mesh: Mesh) -> tuple:
    return tuple(sorted(set(int(rank) for rank in mesh.processes.flat)))


# -- moving tensors between processes ------------------------------------------

def _wire(group, device) -> torch.device:
    """Where an exchange over `group` of entries on `device` puts its
    payload and header: on NCCL the process's card (the one its groups
    are bound to), whatever card the entries lie on; on gloo, which
    moves host tensors, the host for a CUDA device, else the device.
    Entries NCCL cannot carry (host tensors) raise: nothing switches to
    gloo."""
    import torch.distributed as dist
    device = torch.device(device)
    if dist.get_backend(group) == "nccl":
        card = process_card()
        if card is None or device.type != "cuda":
            raise RuntimeError(
                f"an NCCL exchange of entries on {device} with the "
                f"process's card {card}: NCCL moves tensors on the card "
                f"initialize_distributed bound")
        return card
    return torch.device("cpu") if device.type == "cuda" else device


def _moved(tensor, device: torch.device):
    """`tensor` on `device`, the copy counted: between a card and the
    host as staged (pinned on the host, where PyTorch's host allocator
    keeps the buffers), between two cards as a wire copy."""
    if tensor.device == device:
        return tensor
    counter = _WIRE_COPIED if device.type == tensor.device.type else _STAGED
    with _COUNTS_LOCK:
        counter["bytes"] += tensor.numel() * tensor.element_size()
    if device.type == "cpu":
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        return host.copy_(tensor)
    return tensor.to(device)


def _payload(pieces: list, wire: torch.device):
    """The pieces flattened and joined into one tensor on the wire:
    where they lie on one device, joined there and moved once; else each
    moved, then joined."""
    flat = [piece.reshape(-1) for piece in pieces]
    if len({piece.device for piece in flat}) == 1:
        return _moved(torch.cat(flat), wire)
    return torch.cat([_moved(piece, wire) for piece in flat])


def _check_step(mesh: Mesh, ranks: tuple, group, numel: int, tag: int,
                device) -> None:
    """Every process of the group at the same exchange: the group's
    sequence number, the size and what is exchanged (`tag`) must agree
    on all of them, else all of them raise -- two processes whose
    collectives ran in different orders never pair unrelated tensors."""
    import torch.distributed as dist
    sequence = mesh.sequence[ranks] = mesh.sequence.get(ranks, 0) + 1
    header = torch.tensor([sequence, numel, tag], dtype=torch.int64,
                          device=device)
    headers = [torch.empty_like(header) for _ in ranks]
    dist.all_gather(headers, header, group=group)
    seen = [tuple(int(value) for value in other) for other in headers]
    if len(set(seen)) != 1:
        raise RuntimeError(
            f"cross-process collectives out of step on ranks {ranks}: "
            f"(sequence, elements, tag) by rank "
            f"{dict(zip(ranks, seen))}")


def _transfer(mesh: Mesh, ranks: tuple, outgoing: dict, incoming: dict,
              dtype, device, numel: int, tag: int) -> dict:
    """One exchange over the process group of `ranks` (one all_to_all
    with empty slots): this process sends outgoing[rank] (a list of
    tensors, flattened and joined) to each rank it names and receives
    from each rank in `incoming` a tensor of that shape and `dtype`; it
    sends nothing to, and receives nothing from, the others.  `numel` is
    the exchange's size every process of the group checks alike
    (_check_step).  The payload crosses on the wire (_wire).  Returns
    {rank: received}, on `device`."""
    import torch.distributed as dist
    group = _process_group(mesh, ranks)
    device = torch.device(device)
    wire = _wire(group, device)
    _check_step(mesh, ranks, group, numel, tag, wire)
    pieces = [piece for rank in ranks for piece in outgoing.get(rank, ())]
    send = (_payload(pieces, wire) if pieces
            else torch.empty(0, dtype=dtype, device=wire))
    sizes = {rank: int(np.prod(shape)) for rank, shape in incoming.items()}
    # staged through the host: pinned, as _moved's copies are
    receive = torch.empty(sum(sizes.values()), dtype=dtype, device=wire,
                          pin_memory=wire.type != device.type)
    dist.all_to_all_single(
        receive, send,
        output_split_sizes=[sizes.get(rank, 0) for rank in ranks],
        input_split_sizes=[sum(piece.numel() for piece in outgoing.get(
            rank, ())) for rank in ranks], group=group)
    receive = _moved(receive, device)
    received, start = {}, 0
    for rank in ranks:
        if rank in sizes:
            received[rank] = receive[start:start + sizes[rank]].view(
                incoming[rank])
            start += sizes[rank]
    return received


def _exchange(mesh: Mesh, ranks: tuple, outgoing: dict, like,
              tag: int) -> dict:
    """One all_to_all over the process group of `ranks`: this process
    sends outgoing[rank] to every other rank and receives from each a
    tensor shaped and typed like `like` (the groups are symmetric).
    Returns {rank: received}, on like's device."""
    others = [rank for rank in ranks if rank != mesh.rank]
    return _transfer(mesh, ranks, {rank: [outgoing[rank]] for rank in others},
                     {rank: like.shape for rank in others}, like.dtype,
                     like.device, like.numel(), tag)


def _all_reduce(mesh: Mesh, ranks: tuple, tensors: list, tag: int) -> list:
    """The sum of each of `tensors` over the processes of `ranks`, in
    f32 (the caller rounds it once to the dtype it wants), each on its
    own tensor's device: one all_reduce of them joined on the wire."""
    import torch.distributed as dist
    group = _process_group(mesh, ranks)
    wire = _wire(group, tensors[0].device)
    parts = [tensor.detach().float() for tensor in tensors]
    total = _payload(parts, wire)
    _check_step(mesh, ranks, group, total.numel(), tag, wire)
    dist.all_reduce(total, group=group)
    sums, start = [], 0
    for part in parts:
        sums.append(_moved(total[start:start + part.numel()].view(
            part.shape), part.device))
        start += part.numel()
    return sums


class _Chain:
    """The chain of cross-process backward collectives of one forward
    on a mesh: `token` the token the last of them produced.  The graph's
    nodes hold only `state` (its `spent`, set once a backward has run
    through one of them), so a chain never keeps itself alive through
    its graph.  `epoch` is the begin_backward count it was made in."""

    def __init__(self, token=None):
        self.token = (torch.zeros((), requires_grad=True) if token is None
                      else token)
        self.state = _ChainState()
        self.epoch = _EPOCH["count"]


class _ChainState:

    def __init__(self):
        self.spent = False


_EPOCH = {"count": 0}


def begin_backward() -> None:
    """A loss is about to be computed and backpropagated as one graph
    (models.optim.value_and_grad): the chains of forwards before it,
    such as an evaluation run with gradients on whose result is still
    held, are not part of it, and no collective continues them."""
    with _COUNTS_LOCK:
        _EPOCH["count"] += 1


def _pending(mesh: Mesh):
    """(the mesh's chain a new collective may continue, whether it is
    still open) or (None, False).  An open chain is the mesh's own until
    join_backward hands it to its result's graph; a joined chain is held
    by that graph alone and the mesh keeps a weak reference, so it lives
    as long as the result does."""
    chain, is_open = mesh.chain, isinstance(mesh.chain, _Chain)
    if chain is not None and not is_open:
        chain = chain()
    if (chain is None or chain.state.spent
            or chain.epoch != _EPOCH["count"]):
        return None, False
    return chain, is_open


def _link(mesh: Mesh):
    """(the chain, the token) a new cross-process backward collective of
    `mesh` takes: the open chain's last token, or a new chain's, which
    starts at a joined chain's last token when that one's result is
    still live (its backward then runs after this one's: the encoder
    memory a decoder reads, or two forwards of one loss), else at a
    fresh one."""
    chain, is_open = _pending(mesh)
    if not is_open:
        mesh.chain = chain = _Chain(None if chain is None else chain.token)
    return chain, chain.token


class _Join(torch.autograd.Function):

    @staticmethod
    def forward(ctx, chain, tensor, token):
        # the result's graph holds the chain from here on (no cycle:
        # nothing the chain reaches leads back to this node)
        ctx.chain = chain
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        ctx.chain.state.spent = True
        return None, grad, torch.zeros(())


def join_backward(tensor, mesh: Mesh):
    """`tensor` (the same values) tied to the mesh's open chain of
    cross-process backward collectives: a loss that uses it runs, on
    every process, the backward of each of them, in one order.  A result
    every process's loss uses carries it (ShardedCall.gather_home).  The
    mesh then keeps only a weak reference to the chain: its graph is the
    result's, and dies with it.  A tensor of a one-process mesh, or with
    no chain open, comes back as it is."""
    chain, is_open = _pending(mesh)
    if not is_open or not torch.is_grad_enabled():
        return tensor
    mesh.chain = weakref.ref(chain)
    return _Join.apply(chain, tensor, chain.token)


def _tag(members) -> int:
    return zlib.crc32(repr(list(members)).encode())


def _gathered(mesh: Mesh, ranks: tuple, local: list, tag: int) -> tuple:
    """(this process's entries stacked, {rank: the stack of each other
    process's entries}) over the process group of `ranks`."""
    stack = torch.stack([tensor.detach().to(local[0].device)
                         for tensor in local])
    return stack, _exchange(mesh, ranks, {rank: stack for rank in ranks},
                            stack, tag)


class _Across(torch.autograd.Function):
    """The cross-process gather of a collective's group: this process's
    entries (a stack) in, the other processes' stacks out, in `ranks`
    order.  The backward is the transpose: each process's cotangents of
    another's entries go to their owner, which sums every process's
    (zeros from a process that did not use them) in f32 -- a
    reduce-scatter through one all_to_all."""

    @staticmethod
    def forward(ctx, mesh, ranks, tag, chain, token, *local):
        stack, received = _gathered(mesh, ranks, local, tag)
        ctx.mesh, ctx.ranks, ctx.tag = mesh, ranks, tag
        ctx.state = chain.state
        ctx.like = (stack.shape, stack.dtype, stack.device)
        ctx.devices = [tensor.device for tensor in local]
        return torch.zeros(()), *received.values()

    @staticmethod
    def backward(ctx, _, *grads):
        ctx.state.spent = True
        mesh = ctx.mesh
        others = [rank for rank in ctx.ranks if rank != mesh.rank]
        shape, dtype, device = ctx.like
        like = torch.zeros(shape, dtype=dtype, device=device)
        outgoing = {rank: like if grad is None else grad
                    for rank, grad in zip(others, grads)}
        total = None
        for received in _exchange(mesh, ctx.ranks, outgoing, like,
                                  ctx.tag).values():
            total = (received.float() if total is None
                     else total + received.float())
        total = total.to(like.dtype)
        return (None, None, None, None, torch.zeros(()),
                *[part.to(device) for part, device
                  in zip(total.unbind(0), ctx.devices)])


def _entries(mesh: Mesh, grid: np.ndarray, members,
             differentiable: bool = False, fetched: dict | None = None):
    """The group's entries in group order: this process's own entries
    are its tensors; on a mesh over several processes the others' are
    gathered through torch.distributed -- detached, unless
    `differentiable` and this process's entries need a gradient
    (_Across).  None when this process holds no member.  Groups of one
    collective whose local entries are the same tensors share one gather
    (`fetched`), as their results are shared."""
    flat = grid.reshape(-1)
    if mesh.processes is None:
        return [flat[index] for index in members]
    members = np.asarray(members)
    owners = mesh.processes.reshape(-1)[members]
    ranks = tuple(sorted(set(int(rank) for rank in owners)))
    if len(ranks) > 1:
        _process_group(mesh, ranks)
    mine = [int(index) for index, rank in zip(members, owners)
            if rank == mesh.rank]
    if not mine:
        return None
    if len(ranks) == 1:
        return [flat[index] for index in members]
    local = [flat[index] for index in mine]
    key = (tuple(map(id, local)), tuple(owners.tolist()))
    received = None if fetched is None else fetched.get(key)
    if received is None:
        tag = _tag(members)
        if (differentiable and torch.is_grad_enabled()
                and any(tensor.requires_grad for tensor in local)):
            chain, token = _link(mesh)
            token, *stacks = _Across.apply(mesh, ranks, tag, chain, token,
                                           *local)
            chain.token = token
            received = dict(zip([rank for rank in ranks
                                 if rank != mesh.rank], stacks))
        else:
            with torch.no_grad():
                received = _gathered(mesh, ranks, local, tag)[1]
        received = {rank: block.unbind(0) for rank, block in received.items()}
        if fetched is not None:
            fetched[key] = received
    taken = {rank: iter(blocks) for rank, blocks in received.items()}
    own = iter(local)
    return [next(own) if rank == mesh.rank else next(taken[int(rank)])
            for rank in owners]


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
    fetched: dict = {}
    devices = mesh.devices.ravel().tolist()
    local = mesh.local.ravel().tolist()
    for members in _groups(mesh, axes):
        entries = _entries(mesh, grid, members, differentiable=True,
                           fetched=fetched)
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


def pmax(grid: np.ndarray, mesh: Mesh, axis_names) -> np.ndarray:
    """Every position gets the elementwise maximum of its group's entries
    over `axis_names` (lax.pmax)."""
    return _collective(mesh, grid, axis_names, _per_group(
        lambda entries, k, device: torch.stack(
            [entry.to(device) for entry in entries]).amax(dim=0)))


def ppermute(grid: np.ndarray, mesh: Mesh, axis_name: str, perm,
             label=None) -> np.ndarray:
    """perm is a list of (source, destination) axis indices: the
    destination gets the source's entry; a position no pair names gets
    zeros, as in lax.ppermute.  Within one process an entry may be a
    tuple of tensors, moved as it is.  Across processes each block goes
    only to its destination's owner (_permute_across); `label` (any
    repr-able value) joins the exchange's checked tag, so that two
    processes at different calls of one collective -- a ring one hop
    out of step -- fail at once."""
    sources = {destination: source for source, destination in perm}
    axes = _axes(mesh, axis_name)
    if not axes:
        return grid
    if set(axes) & set(mesh.process_axes):
        return _permute_across(grid, mesh, axes, sources, label)
    # every group lies in one process: each destination takes its
    # source's entry onto its device (the same object on the same device)
    _record(axes, grid)
    flat = grid.reshape(-1)
    devices = mesh.devices.ravel().tolist()
    local = mesh.local.ravel().tolist()
    out = np.empty(grid.size, dtype=object)
    for members in _groups(mesh, axes):
        if not local[members[0]]:
            continue
        for k, index in enumerate(members):
            device = devices[index]
            if k not in sources:
                out[index] = torch.zeros_like(flat[index], device=device)
                continue
            entry = flat[members[sources[k]]]
            out[index] = (tuple(tensor.to(device) for tensor in entry)
                          if isinstance(entry, tuple) else entry.to(device))
    return out.reshape(grid.shape)


def _permute_across(grid: np.ndarray, mesh: Mesh, axes: tuple,
                    sources: dict, label) -> np.ndarray:
    """ppermute over axes that span processes: a block whose source and
    destination this process both holds is copied; a block for another
    process goes to its owner alone, in one exchange per set of ranks
    (_send_blocks); groups whose local entries are the same tensors
    share one move, as _collective shares its results."""
    _record(axes, grid)
    flat = grid.reshape(-1)
    owners = [int(rank) for rank in mesh.processes.flat]
    devices = mesh.devices.ravel().tolist()
    out = np.empty(grid.size, dtype=object)
    plans: dict = {}
    lines: dict = {}
    aliases = []
    for members in _groups(mesh, axes):
        line = [owners[index] for index in members]
        ranks = tuple(sorted(set(line)))
        if len(ranks) > 1:
            _process_group(mesh, ranks)
        if mesh.rank not in ranks:
            continue
        key = (tuple(id(flat[index]) for index, rank in zip(members, line)
                     if rank == mesh.rank), tuple(line))
        if key in lines:
            aliases.extend(zip(members, lines[key]))
            continue
        lines[key] = members
        plan = plans.setdefault(ranks, {
            "send": {}, "receive": {}, "pairs": 0,
            "like": next(flat[index] for index, rank in zip(members, line)
                         if rank == mesh.rank)})
        for k, index in enumerate(members):
            source = sources.get(k)
            if source is None:
                if line[k] == mesh.rank:
                    out[index] = torch.zeros_like(flat[index],
                                                  device=devices[index])
                continue
            owner, held = line[source], flat[members[source]]
            if owner != line[k]:
                plan["pairs"] += 1
            if owner == mesh.rank and line[k] == mesh.rank:
                out[index] = held.to(devices[index])
            elif owner == mesh.rank:
                plan["send"].setdefault(line[k], []).append(held)
            elif line[k] == mesh.rank:
                plan["receive"].setdefault(owner, []).append(index)
    tag = _tag(("ppermute", axes, sorted(sources.items()), label))
    # alike on every process (each holds its own positions' entries), so
    # that all of them take part in the backward's exchanges
    differentiable = torch.is_grad_enabled() and any(
        tensor.requires_grad for tensor in flat if tensor is not None)
    for ranks in sorted(plans):
        plan = plans[ranks]
        if not plan["pairs"]:
            continue
        counts = {rank: len(plan["send"][rank])
                  for rank in sorted(plan["send"])}
        sent = [tensor for rank in counts for tensor in plan["send"][rank]]
        wanted = {rank: [flat[index].shape for index in plan["receive"][rank]]
                  for rank in sorted(plan["receive"])}
        targets = [index for rank in wanted
                   for index in plan["receive"][rank]]
        like = plan["like"]
        numel = plan["pairs"] * like.numel()
        if differentiable:
            chain, token = _link(mesh)
            token, *received = _Permute.apply(
                mesh, ranks, counts, wanted, (like.dtype, like.device,
                                              numel, tag), chain, token,
                *sent)
            chain.token = token
        else:
            received = _send_blocks(mesh, ranks, counts, sent, wanted,
                                    like.dtype, like.device, numel, tag)
        for index, block in zip(targets, received):
            out[index] = block.to(devices[index])
    for index, first in aliases:
        if owners[index] == mesh.rank:
            out[index] = out[first]
    return out.reshape(grid.shape)


def _send_blocks(mesh: Mesh, ranks: tuple, counts: dict, sent: list,
                 wanted: dict, dtype, device, numel: int, tag: int) -> list:
    """One _transfer of blocks: the first counts[r1] tensors of `sent` go
    to rank r1, the next counts[r2] to r2, ... (in `counts`' order); from
    each rank of `wanted` this process receives one block per shape
    listed.  Returns the received blocks in `wanted`'s order."""
    outgoing, start = {}, 0
    for rank, count in counts.items():
        outgoing[rank] = [tensor.detach() for tensor in
                          sent[start:start + count]]
        start += count
    received = _transfer(mesh, ranks, outgoing, {
        rank: (sum(int(np.prod(shape)) for shape in shapes),)
        for rank, shapes in wanted.items()}, dtype, device, numel, tag)
    out = []
    for rank, shapes in wanted.items():
        start = 0
        for shape in shapes:
            size = int(np.prod(shape))
            out.append(received[rank][start:start + size].view(shape))
            start += size
    return out


class _Permute(torch.autograd.Function):
    """The cross-process moves of a ppermute: this process's blocks for
    other processes in, the blocks they send it out (_send_blocks).  The
    backward is the inverse permutation of the cotangents, point to
    point again: each received block's cotangent goes back to its
    source's owner, which takes it as its block's gradient."""

    @staticmethod
    def forward(ctx, mesh, ranks, counts, wanted, how, chain, token, *sent):
        dtype, device, numel, tag = how
        ctx.mesh, ctx.ranks, ctx.how = mesh, ranks, how
        ctx.counts, ctx.wanted = counts, wanted
        ctx.state = chain.state
        ctx.sent = [(tensor.shape, tensor.device) for tensor in sent]
        return torch.zeros(()), *_send_blocks(mesh, ranks, counts,
                                              list(sent), wanted, dtype,
                                              device, numel, tag)

    @staticmethod
    def backward(ctx, _, *grads):
        ctx.state.spent = True
        dtype, device, numel, tag = ctx.how
        shapes = [shape for rank in ctx.wanted for shape in ctx.wanted[rank]]
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if grad is None else grad
                 for grad, shape in zip(grads, shapes)]
        back, start = {}, 0
        for rank, count in ctx.counts.items():
            back[rank] = [shape for shape, _ in ctx.sent[start:start + count]]
            start += count
        returned = _send_blocks(
            ctx.mesh, ctx.ranks, {rank: len(ctx.wanted[rank])
                                  for rank in ctx.wanted}, grads, back,
            dtype, device, numel, _tag(("ppermute backward", tag)))
        return (None,) * 6 + (torch.zeros(()),) + tuple(
            grad.to(where) for grad, (_, where) in zip(returned, ctx.sent))


@torch.no_grad()
def sum_replica_grads(leaf) -> None:
    """A Sharded parameter's gradient summed over its replicas: the
    positions that hold the same block on DIFFERENT devices hold distinct
    tensors, each with the gradient of its own positions' work, and each
    gets the sum (the psum over the axes the block is replicated on), so
    the replicas stay equal after the update.  Replicas on one device
    share their tensor, whose gradient autograd has already summed.  On
    a mesh over several processes the replicas on the others join the
    sum through one all_reduce per set of owners, over their process
    group (DDP's gradient all-reduce, on a data axis across processes);
    the sum runs in f32 and rounds once."""
    mesh = leaf.mesh
    copies: dict = {}
    owners: dict = {}
    for position, tensor in np.ndenumerate(leaf.shards):
        block = leaf.block(position)
        if mesh.processes is not None:
            owners.setdefault(block, set()).add(int(mesh.processes[position]))
        if tensor is not None:
            copies.setdefault(block, {}).setdefault(id(tensor), tensor)
    across = {block: tuple(sorted(ranks)) for block, ranks in owners.items()
              if len(ranks) > 1}
    if not across and all(len(group) == 1 for group in copies.values()):
        return
    sums = {}
    for block, group in copies.items():
        if len(group) > 1 or block in across:
            device = next(iter(group.values())).device
            sums[block] = sum(
                (tensor.grad if tensor.grad is not None
                 else torch.zeros_like(tensor)).to(device).float()
                for tensor in group.values())
    for ranks in sorted(set(across.values())):
        _process_group(mesh, ranks)
        if mesh.rank not in ranks:
            continue
        blocks = sorted(block for block, held in across.items()
                        if held == ranks)
        totals = _all_reduce(mesh, ranks, [sums[block] for block in blocks],
                             _tag(("replicas", ranks)))
        sums.update(zip(blocks, totals))
    for block, total in sums.items():
        for tensor in copies[block].values():
            tensor.grad = total.to(device=tensor.device, dtype=tensor.dtype)
    replicated = tuple(
        name for name in mesh.axis_names
        if mesh.shape[name] > 1 and not any(
            name in (entry if isinstance(entry, tuple) else (entry,))
            for entry in leaf.sharding.spec))
    _record(replicated, leaf.shards)


class _Replicated(torch.autograd.Function):
    """A whole tensor a sharded call uses on every process of a mesh:
    the same values; the backward sums the processes' cotangents (an
    all_reduce in f32), so every process's copy takes the whole
    gradient, as GSPMD's transpose of a replicated operand does.
    Counted as one call over the axes that span processes, with the
    tensor's bytes.  The sum lies in the graph, not in sum_replica_grads'
    pass after the backward: a whole tensor may also reach the loss
    outside the sharded call, computed alike on every process (a penalty
    on the weight), and that share is every process's already; summed
    after the backward it would count once per process."""

    @staticmethod
    def forward(ctx, mesh, chain, token, tensor):
        ctx.mesh, ctx.state = mesh, chain.state
        ctx.like = (tensor.shape, tensor.dtype, tensor.device)
        return torch.zeros(()), tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, _, grad):
        ctx.state.spent = True
        shape, dtype, device = ctx.like
        if grad is None:
            grad = torch.zeros(shape, dtype=dtype, device=device)
        mesh = ctx.mesh
        ranks = _mesh_ranks(mesh)
        total, = _all_reduce(mesh, ranks, [grad], _tag(("whole", shape)))
        total = total.to(grad.dtype)
        _record(mesh.process_axes, _source_grid(total))
        return None, None, torch.zeros(()), total


def replicated(tensor, mesh: Mesh):
    """A whole tensor as a sharded call on `mesh` uses it: on a mesh over
    several processes, while it needs a gradient, one whose gradient
    sums every process's (_Replicated); else the tensor itself."""
    if (mesh.processes is None or not torch.is_grad_enabled()
            or not tensor.requires_grad):
        return tensor
    chain, token = _link(mesh)
    chain.token, out = _Replicated.apply(mesh, chain, token, tensor)
    return out


def _blocks(leaf) -> list:
    """(tensor, index into the global tensor) for each distinct local
    tensor of a placed leaf, in unique() order; a whole tensor is one."""
    if not isinstance(leaf, Sharded):
        return [(leaf, (slice(None),) * leaf.ndim)]
    local_shape = leaf.sharding.shard_shape(tuple(leaf.shape))
    seen, out = set(), []
    for position, tensor in np.ndenumerate(leaf.shards):
        if tensor is None or id(tensor) in seen:
            continue
        seen.add(id(tensor))
        out.append((tensor, tuple(
            slice(start * size, (start + 1) * size)
            for start, size in zip(leaf.block(position), local_shape))))
    return out


def _first_holders(leaf) -> set:
    """The ids of the local tensors that hold a block at the first
    position of the mesh (every process's positions, in grid order)
    holding that block; a whole tensor is its own."""
    if not isinstance(leaf, Sharded):
        return {id(leaf)}
    first: dict = {}
    for position in np.ndindex(leaf.shards.shape):
        first.setdefault(leaf.block(position), position)
    return {id(leaf.shards[position]) for position in first.values()
            if leaf.shards[position] is not None}


def _source_grid(leaf) -> np.ndarray:
    if isinstance(leaf, Sharded):
        return leaf.shards
    grid = np.empty(1, dtype=object)
    grid[0] = leaf
    return grid


class _Reshard(torch.autograd.Function):
    """reshard with a backward: the placed leaf's distinct blocks in, the
    new layout's distinct blocks out (the new leaf itself goes to
    `holder`).  The backward adds the blocks' gradients into the whole
    tensor's (replicas on distinct tensors each carry their own
    positions' share, as sum_replica_grads expects) and cuts it back
    into the caller's layout: each source block gets its slice at the
    tensor holding it at its first position (sum_replica_grads then
    hands it to the replicas) and zeros at the others.  On a mesh over
    several processes the processes' wholes are summed first (an
    all_reduce, in the chain of cross-process backward collectives), so
    each takes every process's share.  The backward's move counts as
    one call over the same axes, with the bytes of every destination
    position's block."""

    @staticmethod
    def forward(ctx, leaf, mesh, sharding, axes, holder, chain, token,
                *tensors):
        if axes:
            _record(axes, _source_grid(leaf))
        placed = shard_pytree(unshard(leaf), mesh, sharding.spec)
        holder["placed"] = placed
        firsts = _first_holders(leaf)
        ctx.source = [(tensor.device, tensor.dtype, index,
                       id(tensor) in firsts)
                      for tensor, index in _blocks(leaf)]
        ctx.grid = _source_grid(placed)
        ctx.mesh, ctx.axes = mesh, axes
        ctx.state = None if chain is None else chain.state
        ctx.shape, ctx.dtype = leaf.shape, leaf.dtype
        blocks = _blocks(placed)
        ctx.indices = [index for _, index in blocks]
        inputs = {id(tensor) for tensor in tensors}
        return (None if token is None else torch.zeros(()),
                *(tensor.clone() if id(tensor) in inputs else tensor
                  for tensor, _ in blocks))

    @staticmethod
    def backward(ctx, _, *grads):
        if ctx.axes:
            _record(ctx.axes, ctx.grid)
        mesh = ctx.mesh
        home = mesh.home
        whole = None
        for grad, index in zip(grads, ctx.indices):
            if grad is None:
                continue
            if whole is None:
                whole = torch.zeros(ctx.shape, dtype=grad.dtype, device=home)
            whole[index] += grad.to(home)
        none = (None,) * 7
        if ctx.state is not None:
            ctx.state.spent = True
            if whole is None:
                whole = torch.zeros(ctx.shape, dtype=ctx.dtype, device=home)
            whole = _all_reduce(mesh, _mesh_ranks(mesh), [whole], _tag(
                ("reshard", tuple(ctx.shape))))[0].to(whole.dtype)
            none = none[:-1] + (torch.zeros(()),)
        if whole is None:
            return none + (None,) * len(ctx.source)
        return none + tuple(
            whole[index].to(device=device, dtype=dtype) if first
            else torch.zeros_like(whole[index], device=device, dtype=dtype)
            for device, dtype, index, first in ctx.source)


def reshard(leaf, mesh: Mesh, spec):
    """`leaf` (a whole tensor or a Sharded of any layout) placed by
    `spec` over `mesh`: gathered whole (parallel.unshard, a collective
    on a mesh over several processes) and cut again by shard_pytree.
    Counted as one collective over the axes of both layouts, with the
    bytes of every source position's block (a whole source's bytes
    once).  A gradient flows back through the move into the caller's
    layout (_Reshard), and the backward's move counts too."""
    sharding = named_sharding(mesh, spec)
    wanted = spec_layout(sharding.spec, mesh, leaf.ndim)
    used = {name for names in leaf_layout(leaf, mesh) + wanted
            for name in names}
    axes = tuple(name for name in mesh.axis_names if name in used)
    holder: dict = {}
    tensors = [tensor for tensor, _ in _blocks(leaf)]
    chain = token = None
    if (mesh.processes is not None and torch.is_grad_enabled()
            and any(tensor.requires_grad for tensor in tensors)):
        chain, token = _link(mesh)
    token, *blocks = _Reshard.apply(leaf, mesh, sharding, axes, holder,
                                    chain, token, *tensors)
    if chain is not None:
        chain.token = token
    placed = holder["placed"]
    if isinstance(placed, Sharded):
        return placed.rebuild(list(blocks))
    return blocks[0]


def conform(tree, specs, mesh: Mesh, sizes: dict):
    """`tree` with every leaf cut as its spec in `specs` (a spec tree; a
    missing entry means whole) cuts it over the axes `sizes` names above
    1: a leaf cut otherwise is resharded into that layout (a gradient
    flows back through the move), a leaf already so comes back as it is
    (nothing moves, nothing counts)."""
    if isinstance(tree, dict):
        return {key: conform(value, specs.get(key)
                             if isinstance(specs, dict) else None,
                             mesh, sizes)
                for key, value in tree.items()}
    wanted = spec_layout(specs, mesh, tree.ndim, sizes)
    if leaf_layout(tree, mesh) == wanted:
        return tree
    return reshard(tree, mesh, layout_spec(wanted))
