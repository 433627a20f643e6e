# Multi-process runtime: torch.distributed initialization + global meshes.
#
# Counterpart of aiko_services_tpu/parallel/distributed.py.  The broker
# keeps carrying CONTROL traffic; the data plane between the processes of
# one job is torch.distributed: initialize_distributed joins every process
# to the job's default process group (gloo for CPU devices, NCCL for CUDA
# ones), and a mesh built by global_mesh spans every process's devices, so
# the collectives of parallel/collectives.py move shards between
# processes.
#
# Deployment contract (the JAX package's):
#   AIKO_COORDINATOR   host:port of process 0 (the tcp:// rendezvous)
#   AIKO_NUM_PROCESSES total framework Processes in the job
#   AIKO_PROCESS_ID    this process's rank
#
# Nothing tells a program of a cluster: with none of these set, the
# deployment is one process and initialize_distributed does nothing.

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from .mesh import Mesh, _canonical_axes, default_devices

__all__ = [
    "initialize_distributed", "shutdown_distributed", "is_distributed",
    "global_mesh", "process_index", "process_count",
]

_LOCK = threading.Lock()
_INITIALIZED = False


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None, backend: str | None = None,
                           timeout_seconds: float = 300.0) -> bool:
    """Join this process to the job's process group.

    Arguments default to the AIKO_* contract above; with nothing set
    anywhere (a one-process deployment) this does nothing and returns
    False.  Idempotent: later calls after a successful join return True.
    local_device_ids picks this process's devices (CUDA indices) for
    global_mesh, the same index more than once for several positions on
    one card; backend defaults to NCCL when CUDA is available, else gloo
    (which moves host tensors: on a gloo job the collectives stage CUDA
    blocks through host memory, as two processes on one card need, since
    NCCL takes one rank per card).

    On NCCL the process's card is the first of local_device_ids (by
    default the process id modulo the visible cards): it becomes the
    current device and the group's device_id before the first
    collective, so every NCCL call of this process runs there.  Two
    ranks of one NCCL job on one physical card (one UUID, whatever CUDA
    index each sees it as) raise ValueError on every rank, before any
    NCCL call (the ranks compare their cards through the rendezvous
    store); nothing falls back to gloo."""
    global _INITIALIZED, _LOCAL_DEVICE_IDS
    with _LOCK:
        if _INITIALIZED:
            return True
        coordinator_address = (coordinator_address
                               or os.environ.get("AIKO_COORDINATOR"))
        if num_processes is None and "AIKO_NUM_PROCESSES" in os.environ:
            num_processes = int(os.environ["AIKO_NUM_PROCESSES"])
        if process_id is None and "AIKO_PROCESS_ID" in os.environ:
            process_id = int(os.environ["AIKO_PROCESS_ID"])
        if coordinator_address is None and num_processes is None:
            return False  # one-process deployment
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "initialize_distributed needs the coordinator address, the "
                "number of processes and this process's id (arguments or "
                "AIKO_COORDINATOR / AIKO_NUM_PROCESSES / AIKO_PROCESS_ID)")
        import datetime

        import torch.distributed as dist
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        world, rank = int(num_processes), int(process_id)
        timeout = datetime.timedelta(seconds=timeout_seconds)
        init_method = f"tcp://{coordinator_address}"
        if backend == "nccl":
            if local_device_ids is None:
                local_device_ids = [rank % max(torch.cuda.device_count(), 1)]
            card = torch.device("cuda", int(local_device_ids[0]))
            store, _, _ = next(dist.rendezvous(
                init_method, rank, world, timeout=timeout))
            store.set_timeout(timeout)
            _claim_card(store, rank, world, card)
            torch.cuda.set_device(card)
            # the prefix init_process_group gives a store it makes itself
            dist.init_process_group(
                backend, store=dist.PrefixStore("default_pg", store),
                world_size=world, rank=rank, timeout=timeout,
                device_id=card)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world, rank=rank,
                                    timeout=timeout)
        _LOCAL_DEVICE_IDS = (None if local_device_ids is None
                             else [int(index) for index in local_device_ids])
        _INITIALIZED = True
        return True


def _claim_card(store, rank: int, world: int, card) -> None:
    """Every rank of an NCCL job publishes its card in the rendezvous
    store and reads every other's; two ranks on one physical card raise
    ValueError on all of them (NCCL takes one rank per card).  A card is
    named by its host and its UUID, not its CUDA index: a job that gives
    each rank its own card through CUDA_VISIBLE_DEVICES sees every card
    as cuda:0.  The index stays for the message."""
    import socket
    claim = {"host": socket.gethostname(), "card": _card_identity(card),
             "index": card.index}
    store.set(f"aiko_card/{rank}", json.dumps(claim))
    claims = [json.loads(store.get(f"aiko_card/{other}").decode())
              for other in range(world)]
    owners: dict = {}
    for other, claim in enumerate(claims):
        owners.setdefault((claim["host"], claim["card"]), []).append(other)
    shared = [ranks for ranks in owners.values() if len(ranks) > 1]
    if shared:
        # the store lives in rank 0: it leaves only once every rank has
        # read the claims, so each rank raises this error, not a lost
        # connection
        store.set(f"aiko_card_read/{rank}", "1")
        if rank == 0:
            try:
                store.wait([f"aiko_card_read/{other}"
                            for other in range(1, world)])
            except RuntimeError:
                pass  # a rank that never read: raise all the same
        raise ValueError(
            "NCCL takes one rank per card, but ranks share cards: "
            + "; ".join(
                f"ranks {ranks} on card {claims[ranks[0]]['card']} of "
                f"{claims[ranks[0]]['host']} (as cuda:"
                + "/".join(str(claims[other]["index"]) for other in ranks)
                + ")" for ranks in shared)
            + " (give each rank its own card in local_device_ids, or "
              "backend='gloo' for several ranks on one card)")


def _card_identity(card) -> str:
    """The card's UUID, else its PCI address: the same physical card
    gives the same string in every process, whatever its CUDA index
    there."""
    properties = torch.cuda.get_device_properties(card)
    uuid = getattr(properties, "uuid", None)
    if uuid:
        return str(uuid)
    return "pci {}:{}:{}".format(*(
        getattr(properties, name, "?") for name in
        ("pci_domain_id", "pci_bus_id", "pci_device_id")))


_LOCAL_DEVICE_IDS: list | None = None


def shutdown_distributed() -> None:
    global _INITIALIZED
    with _LOCK:
        if _INITIALIZED:
            import torch.distributed as dist
            dist.destroy_process_group()
            _INITIALIZED = False


def is_distributed() -> bool:
    """True once this process has joined a job of several processes.  It
    initializes nothing (the `if not is_distributed():
    initialize_distributed()` idiom has to stay safe)."""
    if _INITIALIZED:
        return True
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    if not is_distributed():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def process_count() -> int:
    if not is_distributed():
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def _local_devices() -> list:
    """This process's devices: the CUDA devices initialize_distributed
    was given, else the default device list (every CUDA device, or the
    list set_default_devices installed), else the CPU.  Equal devices
    are one object, as in create_mesh: the shard code shares work and
    tensors between positions by identity, so local_device_ids=[0, 0]
    gives two positions on one card that share what they compute
    alike."""
    if _LOCAL_DEVICE_IDS is not None:
        devices = [torch.device("cuda", index)
                   for index in _LOCAL_DEVICE_IDS]
    else:
        devices = default_devices() or [torch.device("cpu")]
    canonical: dict = {}
    return [canonical.setdefault(str(device), device) for device in devices]


def global_mesh(axes: dict | None = None) -> Mesh:
    """A mesh over the JOB's devices -- every process's local devices, in
    rank order -- not just this process's.  Axis sizes follow
    create_mesh ({"data": -1, "model": 4}, one -1 fills).  Each process
    computes on its own positions; the collectives between processes run
    over torch.distributed.  One process (no job joined): create_mesh
    over the local devices."""
    local = _local_devices()
    count, rank = process_count(), process_index()
    if count == 1:
        from .mesh import create_mesh
        return create_mesh(axes, devices=local)
    import torch.distributed as dist
    sizes = [None] * count
    dist.all_gather_object(sizes, len(local))
    if len(set(sizes)) != 1:
        raise ValueError(f"global_mesh needs the same number of devices in "
                         f"every process, got {sizes}")
    devices, ranks = [], []
    for owner in range(count):
        for device in local:
            devices.append(device)
            ranks.append(owner)
    canonical = _canonical_axes(dict(axes or {"data": -1}), len(devices))
    shape = tuple(size for _, size in canonical)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"Mesh axes {dict(canonical)} need "
                         f"{int(np.prod(shape))} devices, have "
                         f"{len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    processes = np.asarray(ranks).reshape(shape)
    return Mesh(grid.reshape(shape), tuple(name for name, _ in canonical),
                processes=processes, rank=rank)
