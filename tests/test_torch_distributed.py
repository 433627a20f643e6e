# The port's multi-process runtime (parallel/distributed.py) on the CPU:
# two OS processes join one job over gloo (torch.distributed's CPU
# backend, through the AIKO_* contract's tcp:// rendezvous on localhost),
# global_mesh spans both, and a collective of parallel/collectives.py
# reduces across them -- the counterpart of the JAX package's
# tests/test_transfer.py::TestJaxDistributed.  Each worker has its own
# time limit; the test kills any worker still running.

import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os
    import sys
    import torch
    from aiko_services_tpu_torch.parallel import (
        global_mesh, initialize_distributed, is_distributed, map_shards,
        process_count, process_index, psum, shard_pytree,
        shutdown_distributed)
    from aiko_services_tpu_torch.parallel.mesh import PartitionSpec as P
    assert not is_distributed()
    assert initialize_distributed(timeout_seconds=60)
    assert is_distributed() and process_count() == 2
    mesh = global_mesh({"data": -1})
    assert dict(mesh.shape) == {"data": 2}
    sharded = shard_pytree(torch.arange(16.0), mesh, P("data"))
    mine = sharded.addressable_shards
    assert len(mine) == 1 and mine[0].tolist() == [
        8.0 * process_index() + i for i in range(8)]
    total = psum(map_shards(torch.sum, sharded.shards), mesh, "data")
    value = [entry for entry in total.flat if entry is not None]
    print(f"rank {process_index()} total {float(value[0])}", flush=True)
    shutdown_distributed()
    assert not is_distributed()
""")


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def test_two_process_global_mesh_psum():
    """Two processes join through AIKO_COORDINATOR / AIKO_NUM_PROCESSES /
    AIKO_PROCESS_ID; global_mesh({"data": -1}) spans them, each holds
    its half of a data-sharded arange(16), and a psum of the halves'
    sums gives 120 on both ranks."""
    coordinator = f"127.0.0.1:{_free_port()}"
    workers = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   AIKO_COORDINATOR=coordinator, AIKO_NUM_PROCESSES="2",
                   AIKO_PROCESS_ID=str(rank))
        workers.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True))
    outputs = []
    try:
        for worker in workers:
            out, _ = worker.communicate(timeout=120)
            outputs.append(out)
            assert worker.returncode == 0, out
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
    for rank, out in enumerate(outputs):
        assert f"rank {rank} total 120.0" in out, out


def test_is_distributed_initializes_nothing():
    """is_distributed() on a process that joined no job is False and
    leaves torch.distributed uninitialized, so initialize_distributed can
    still run after it; with no AIKO_* contract, initialize_distributed
    does nothing and process_index / process_count describe one
    process."""
    child = textwrap.dedent("""
        import torch.distributed as dist
        from aiko_services_tpu_torch.parallel import (
            initialize_distributed, is_distributed, process_count,
            process_index)
        assert is_distributed() is False
        assert not dist.is_initialized()
        assert initialize_distributed() is False
        assert not dist.is_initialized()
        assert (process_index(), process_count()) == (0, 1)
        print("clean", flush=True)
    """)
    env = {key: value for key, value in os.environ.items()
           if not key.startswith("AIKO_")}
    env["PYTHONPATH"] = REPO
    result = subprocess.run([sys.executable, "-c", child],
                            capture_output=True, text=True, env=env,
                            timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr
    assert "clean" in result.stdout
