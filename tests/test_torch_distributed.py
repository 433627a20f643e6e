# The port's multi-process runtime (parallel/distributed.py) on the CPU:
# two OS processes join one job over gloo (torch.distributed's CPU
# backend, through the AIKO_* contract's tcp:// rendezvous on localhost),
# global_mesh spans both, and a collective of parallel/collectives.py
# reduces across them -- the counterpart of the JAX package's
# tests/test_transfer.py::TestJaxDistributed.  Each worker has its own
# time limit; the test kills any worker still running.
#
# The sharded serving path across the two processes: a llama-family
# config of two narrow layers, its weights placed on a {"model": 2} or an
# {"fsdp": 2} global mesh as they are read (each process holds its
# blocks only), then forward and greedy generate.  unshard gathers the
# other process's blocks, so the logits come back whole on both ranks,
# held against the JAX package's unsharded forward at
# tests/test_torch_sharding.py's tolerance (atol/rtol 1e-5, f32), and the
# tokens equal the JAX package's generate on both ranks.

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from aiko_services_tpu.models import save_pytree as jax_save_pytree
from aiko_services_tpu.models import transformer as jax_lm

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


SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, max_seq_len=64, dtype="float32")

SHARDED_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models import load_pytree
    from aiko_services_tpu_torch.models import transformer as lm
    from aiko_services_tpu_torch.parallel import (
        global_mesh, initialize_distributed, process_index,
        shutdown_distributed)
    from aiko_services_tpu_torch.parallel import mesh as torch_mesh
    axes, config, weights, out = json.loads(sys.argv[1])
    assert initialize_distributed(timeout_seconds=60)
    mesh = global_mesh(axes)
    assert not mesh.local.all()
    config = lm.TransformerConfig(**config)
    params = load_pytree(weights, mesh=mesh, specs=torch_mesh.filter_specs(
        lm.param_specs(config), mesh))
    wq = params["layers"]["wq"]["w"]
    assert isinstance(wq, torch_mesh.Sharded)
    assert len(wq.addressable_shards) == 1  # this process's block only
    tokens = torch.from_numpy(np.load(weights + ".tokens.npy"))
    with torch_mesh.use_mesh(mesh):
        logits = lm.forward(params, config, tokens)
        generated, _ = lm.generate(params, config, tokens, 6)
    whole = torch_mesh.unshard(wq)
    rank = process_index()
    np.save(f"{out}.{rank}.logits.npy", logits.numpy())
    np.save(f"{out}.{rank}.tokens.npy", generated.numpy())
    np.save(f"{out}.{rank}.wq.npy", whole.numpy())
    print(f"rank {rank} served", flush=True)
    shutdown_distributed()
""")


@pytest.fixture(scope="module")
def llama_weights(tmp_path_factory):
    """(weights path, JAX params, JAX config, tokens): the JAX package's
    random parameters written by its save_pytree, and a prompt."""
    config = jax_lm.TransformerConfig(**SMALL)
    params = jax_lm.init_params(config, jax.random.PRNGKey(5))
    path = str(tmp_path_factory.mktemp("lm") / "lm.safetensors")
    jax_save_pytree(path, params)
    tokens = np.random.default_rng(0).integers(3, 120, (2, 8)).astype(
        np.int32)
    np.save(path + ".tokens.npy", tokens)
    return path, params, config, tokens


@pytest.mark.parametrize("axes", [{"model": 2}, {"fsdp": 2}])
def test_two_process_sharded_forward_and_generate(llama_weights, axes,
                                                  tmp_path):
    """The serving path on a mesh over two processes: both ranks'
    logits equal JAX's unsharded forward (1e-5), their greedy tokens
    JAX's generate, and unshard gives both ranks the whole weight."""
    path, params, config, tokens = llama_weights
    out = str(tmp_path / "out")
    coordinator = f"127.0.0.1:{_free_port()}"
    argument = json.dumps([axes, SMALL, path, out])
    workers = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   AIKO_COORDINATOR=coordinator, AIKO_NUM_PROCESSES="2",
                   AIKO_PROCESS_ID=str(rank))
        workers.append(subprocess.Popen(
            [sys.executable, "-c", SHARDED_WORKER, argument],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    try:
        for rank, worker in enumerate(workers):
            output, _ = worker.communicate(timeout=180)
            assert worker.returncode == 0, output
            assert f"rank {rank} served" in output, output
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
    logits = jax_lm.forward(params, config, tokens)
    generated, _ = jax_lm.generate(params, config, tokens, 6)
    for rank in range(2):
        np.testing.assert_allclose(np.load(f"{out}.{rank}.logits.npy"),
                                   np.asarray(logits), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(np.load(f"{out}.{rank}.tokens.npy"),
                                      np.asarray(generated))
        np.testing.assert_array_equal(
            np.load(f"{out}.{rank}.wq.npy"),
            np.asarray(params["layers"]["wq"]["w"]))
