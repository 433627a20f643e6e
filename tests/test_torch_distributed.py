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

# Training across the two processes: the collectives' gather carries
# each process's cotangents of the other's entries back to their owner
# (parallel/collectives.py), so a collective's gradients on a global mesh
# equal the one-process mesh's of the same axes and those of the same
# lax collective under jax.shard_map (atol 1e-6, f32), and a
# llama or MoE train step on every mesh axis gives the loss and every
# gradient leaf of jax.value_and_grad of the JAX package's train-step
# loss (atol 1e-6, f32: test_torch_sharding.py's bound).  Two adam steps
# are then held three ways on both ranks: each step's gradients, as the
# optimizer received them, against jax.value_and_grad at the port's own
# parameters before that step (1e-6); the parameters after them against
# optax.adam applied in the test to those same gradients (the bound of
# test_torch_optim.py::test_five_steps_match_optax); and end to end
# against the JAX package's make_train_step (atol 1e-5) at every element
# whose first-step JAX gradient exceeds 1e-6 in magnitude.  Adam divides
# a gradient by its own root mean square: at an element whose gradient is
# about its eps (1e-8) the f32 noise of the forward's sums, which
# depends on the BLAS thread count, moves the update by a fraction of
# the learning rate, so such elements are held through the gradients
# and the optax replay, not through the end-to-end parameters.
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


# -- training across processes ------------------------------------------------
#
# The collective cases run in both the workers (on a global mesh) and the
# test (on a one-process mesh of the same axes): one source, executed in
# each.  Every position's block is drawn from its flat index, the loss is
# the sum over positions of output * a seeded weight, so each process's
# loss is its positions' share of the one-process loss, and each block's
# gradient is the whole loss's.  _jax_collective computes the same case
# in JAX, independently of the port.

GRAD_CASES = textwrap.dedent("""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.parallel import collectives
    from aiko_services_tpu_torch.parallel.mesh import PartitionSpec as P
    from aiko_services_tpu_torch.parallel.mesh import shard_pytree

    COLLECTIVES = {
        "psum": lambda grid, mesh: collectives.psum(
            grid, mesh, ("data", "model")),
        "all_gather": lambda grid, mesh: collectives.all_gather(
            grid, mesh, "data", dim=1),
        "psum_scatter": lambda grid, mesh: collectives.psum_scatter(
            grid, mesh, "data", dim=0),
        "all_to_all": lambda grid, mesh: collectives.all_to_all(
            grid, mesh, "data", 0, 1),
        "ppermute": lambda grid, mesh: collectives.ppermute(
            grid, mesh, "data", [(0, 1)]),
    }

    def block(index, shape, seed):
        return torch.from_numpy(np.random.default_rng([seed, index])
                                .standard_normal(shape).astype(np.float32))

    def weighted_loss(grid, mesh):
        loss = sum((entry * block(index, entry.shape, 2)).sum()
                   for index, entry in enumerate(grid.flat)
                   if entry is not None)
        return collectives.join_backward(loss, mesh)

    def gradient(tensor):
        return (tensor.grad if tensor.grad is not None
                else torch.zeros_like(tensor)).numpy()

    def collective_grads(name, mesh):
        \"\"\"{flat position: [output, its block's gradient]} at this
        process's positions.\"\"\"
        grid = np.empty(mesh.devices.size, dtype=object)
        for index, local in enumerate(mesh.local.flat):
            if local:
                grid[index] = block(index, (4, 6), 1).requires_grad_()
        grid = grid.reshape(mesh.devices.shape)
        out = COLLECTIVES[name](grid, mesh)
        weighted_loss(out, mesh).backward()
        return {index: [out.flat[index].detach().numpy(),
                        gradient(grid.flat[index])]
                for index, local in enumerate(mesh.local.flat) if local}

    def whole_grads(mesh):
        \"\"\"A whole tensor w as a sharded call uses it (ShardedCall.grid),
        times each position's block, plus a penalty every process
        computes alike on w: {flat position: [w * block, w's gradient]}
        -- the call's share of the gradient is summed over the
        processes, the penalty's counted once.\"\"\"
        from aiko_services_tpu_torch.models.layers import ShardedCall
        weight = block(77, (4, 6), 4).requires_grad_()
        grid = np.empty(mesh.devices.size, dtype=object)
        for index, local in enumerate(mesh.local.flat):
            if local:
                grid[index] = block(index, (4, 6), 1)
        grid = grid.reshape(mesh.devices.shape)
        out = collectives.map_shards(lambda w, x: w * x,
                                     ShardedCall(mesh).grid(weight), grid)
        (weighted_loss(out, mesh) + (weight ** 2).sum()).backward()
        return {index: [out.flat[index].detach().numpy(),
                        weight.grad.numpy()]
                for index, local in enumerate(mesh.local.flat) if local}

    def conform_grads(mesh):
        \"\"\"conform from a layout cut over a local axis (replicated over
        "data", across processes when it spans them) into one cut over
        "data": {flat position: [moved block, source block's gradient
        after sum_replica_grads]}.\"\"\"
        source = P("model", None) if "model" in mesh.shape else P(
            "data", None)
        leaf = shard_pytree(block(99, (8, 6), 3), mesh, source)
        for tensor in leaf.unique():
            tensor.requires_grad_()
        moved = collectives.conform(leaf, P(None, "data"), mesh,
                                    dict(mesh.shape))
        weighted_loss(moved.shards, mesh).backward()
        collectives.sum_replica_grads(leaf)
        return {index: [moved.shards.flat[index].detach().numpy(),
                        gradient(leaf.shards.flat[index])]
                for index, local in enumerate(mesh.local.flat) if local}

    OTHER_CASES = {"conform": conform_grads, "whole": whole_grads}
""")

COLLECTIVE_WORKER = GRAD_CASES + textwrap.dedent("""
    import json
    import sys
    from aiko_services_tpu_torch.parallel import (
        global_mesh, initialize_distributed, process_index,
        set_default_devices, shutdown_distributed)
    meshes, out = json.loads(sys.argv[1])
    assert initialize_distributed(timeout_seconds=200)
    rank = process_index()
    results = {}
    for axes in meshes:
        set_default_devices(["cpu"] * (int(np.prod(list(axes.values())))
                                       // 2))
        mesh = global_mesh(axes)
        label = "x".join(mesh.axis_names)
        for name in [*COLLECTIVES, *OTHER_CASES]:
            got = (OTHER_CASES[name](mesh) if name in OTHER_CASES
                   else collective_grads(name, mesh))
            for index, (value, grad) in got.items():
                results[f"{label}/{name}/{index}/out"] = value
                results[f"{label}/{name}/{index}/grad"] = grad
    np.savez(f"{out}.{rank}.npz", **results)
    print(f"rank {rank} collectives done", flush=True)
    shutdown_distributed()
""")

CASE_MESHES = [{"data": 2}, {"data": 2, "model": 2}]


def _run_pair(script: str, argument: str, tag: str, timeout: float = 240):
    """Two workers of `script` over gloo; each must exit 0 within its
    time limit and print its rank's `tag`."""
    coordinator = f"127.0.0.1:{_free_port()}"
    workers = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   AIKO_COORDINATOR=coordinator, AIKO_NUM_PROCESSES="2",
                   AIKO_PROCESS_ID=str(rank))
        workers.append(subprocess.Popen(
            [sys.executable, "-c", script, argument],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    try:
        for rank, worker in enumerate(workers):
            output, _ = worker.communicate(timeout=timeout)
            assert worker.returncode == 0, output
            assert f"rank {rank} {tag}" in output, output
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
                worker.wait()


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    """Each rank's outputs and block gradients for every collective and
    the conform case on both meshes, and the one-process meshes'."""
    out = str(tmp_path_factory.mktemp("collectives") / "out")
    _run_pair(COLLECTIVE_WORKER, json.dumps([CASE_MESHES, out]),
              "collectives done")
    cases: dict = {}
    exec(GRAD_CASES, cases)
    from aiko_services_tpu_torch.parallel import create_mesh
    reference, jax_reference = {}, {}
    for axes in CASE_MESHES:
        count = int(np.prod(list(axes.values())))
        mesh = create_mesh(axes, devices=["cpu"] * count)
        label = "x".join(mesh.axis_names)
        for name in [*cases["COLLECTIVES"], *cases["OTHER_CASES"]]:
            reference[(label, name)] = (
                cases["OTHER_CASES"][name](mesh)
                if name in cases["OTHER_CASES"]
                else cases["collective_grads"](name, mesh))
            jax_reference[(label, name)] = _jax_collective(axes, name)
    return ([dict(np.load(f"{out}.{rank}.npz")) for rank in range(2)],
            reference, jax_reference)


def _block(index, shape, seed):
    """GRAD_CASES' block, in numpy."""
    return np.random.default_rng([seed, index]).standard_normal(
        shape).astype(np.float32)


def _jax_collective(axes: dict, name: str) -> dict:
    """{flat position: [output, its block's gradient]} of the same case
    in JAX: the seeded blocks through jax.shard_map's lax collective on
    the CPU devices (conform: the moved blocks sliced out of the whole
    tensor), differentiated by jax.grad of the same weighted loss."""
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as JaxP
    names, shape = tuple(axes), tuple(axes.values())
    count = int(np.prod(shape))
    positions = list(np.ndindex(*shape))
    if name == "conform":
        whole = _block(99, (8, 6), 3)
        source = "model" if "model" in axes else "data"
        rows, columns = 8 // axes[source], 6 // axes["data"]

        def moved(tensor, position):
            column = position[names.index("data")] * columns
            return tensor[:, column:column + columns]
        weights = [_block(index, (8, columns), 2)
                   for index in range(count)]
        grad = jax.grad(lambda tensor: sum(
            jnp.sum(moved(tensor, position) * weight)
            for position, weight in zip(positions, weights)))(whole)
        return {index: [np.asarray(moved(whole, position)), np.asarray(
            grad[position[names.index(source)] * rows:][:rows])]
            for index, position in enumerate(positions)}
    mesh = JaxMesh(np.array(jax.devices()[:count]).reshape(shape), names)
    spec = JaxP(*names)
    over = tuple(axis for axis in ("data", "model") if axis in axes)
    collective = {
        "psum": lambda x: lax.psum(x, over),
        "all_gather": lambda x: lax.all_gather(x, "data", axis=1,
                                               tiled=True),
        "psum_scatter": lambda x: lax.psum_scatter(
            x, "data", scatter_dimension=0, tiled=True),
        "all_to_all": lambda x: lax.all_to_all(x, "data", 0, 1,
                                               tiled=True),
        "ppermute": lambda x: lax.ppermute(x, "data", [(0, 1)]),
        "whole": None,
    }[name]
    blocks = np.stack([_block(index, (4, 6), 1)
                       for index in range(count)]).reshape(*shape, 4, 6)
    lead = (1,) * len(shape)
    if name == "whole":
        weight = _block(77, (4, 6), 4)
        apply = jax.shard_map(
            lambda w, x: (w * x.reshape(4, 6)).reshape(*lead, 4, 6),
            mesh=mesh, in_specs=(JaxP(), spec), out_specs=spec)
        out = apply(weight, blocks)
        weights = np.stack([_block(index, out.shape[len(shape):], 2)
                            for index in range(count)]).reshape(out.shape)
        grad = jax.grad(lambda w: jnp.sum(apply(w, blocks) * weights)
                        + jnp.sum(w ** 2))(weight)
        return {index: [np.asarray(out[position]), np.asarray(grad)]
                for index, position in enumerate(positions)}
    def local(x):
        y = collective(x.reshape(4, 6))
        return y.reshape(*lead, *y.shape)
    apply = jax.shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec)
    out = apply(blocks)
    weights = np.stack([_block(index, out.shape[len(shape):], 2)
                        for index in range(count)]).reshape(out.shape)
    grad = jax.grad(lambda x: jnp.sum(apply(x) * weights))(blocks)
    return {index: [np.asarray(out[position]), np.asarray(grad[position])]
            for index, position in enumerate(positions)}


def _assert_rank_blocks(runs, references, label, name):
    """Every rank's outputs and block gradients against the one-process
    mesh's and JAX's, and the one-process mesh's against JAX's (atol
    1e-6)."""
    reference, jax_reference = references
    want = jax_reference[(label, name)]
    for index, (value, grad) in reference[(label, name)].items():
        np.testing.assert_allclose(value, want[index][0], atol=1e-6,
                                   rtol=0, err_msg=f"{label} {index} out")
        np.testing.assert_allclose(grad, want[index][1], atol=1e-6,
                                   rtol=0, err_msg=f"{label} {index} grad")
    seen = set()
    for rank, results in enumerate(runs):
        prefix = f"{label}/{name}/"
        for key, value in results.items():
            if not key.startswith(prefix):
                continue
            index, what = key[len(prefix):].split("/")
            part = 0 if what == "out" else 1
            for source, expected in (("one process", reference),
                                     ("jax", jax_reference)):
                np.testing.assert_allclose(
                    value, expected[(label, name)][int(index)][part],
                    atol=1e-6, rtol=0,
                    err_msg=f"rank {rank} {key} against {source}")
            seen.add(int(index))
    assert seen == set(reference[(label, name)]), seen


@pytest.mark.parametrize("name", ["psum", "all_gather", "psum_scatter",
                                  "all_to_all", "ppermute"])
def test_two_process_collective_gradients_match_one_process(
        collective_runs, name):
    """A seeded f32 grid through the collective on {"data": 2} and on
    {"data": 2, "model": 2} (two local CPU positions a process), each
    spanning two processes over "data": every position's output and its
    block's gradient equal the one-process mesh's of the same axes and
    jax.shard_map's lax collective's under jax.grad (atol 1e-6) -- the
    cotangents one process computes for another's blocks reach their
    owner, and the shared transpose is JAX's."""
    runs, reference, jax_reference = collective_runs
    for label in ("data", "dataxmodel"):
        _assert_rank_blocks(runs, (reference, jax_reference), label, name)


def test_two_process_conform_carries_the_gradient_back(collective_runs):
    """conform on a global mesh: a leaf cut over a local axis (replicated
    over "data" across the processes on the 2 x 2 mesh) moved into a
    layout cut over "data"; the moved blocks and each source block's
    gradient (after sum_replica_grads) equal the one-process mesh's and
    jax.grad's of the same slices of the whole tensor (atol 1e-6)."""
    runs, reference, jax_reference = collective_runs
    for label in ("data", "dataxmodel"):
        _assert_rank_blocks(runs, (reference, jax_reference), label,
                            "conform")


def test_two_process_whole_tensor_gradient_sums_the_call_share(
        collective_runs):
    """A whole tensor a sharded call uses at every position, plus a
    penalty every process computes alike on it: its gradient on both
    ranks equals the one-process mesh's and jax.shard_map's with the
    tensor replicated (atol 1e-6) -- the call's share summed over the
    processes, the penalty's counted once."""
    runs, reference, jax_reference = collective_runs
    for label in ("data", "dataxmodel"):
        _assert_rank_blocks(runs, (reference, jax_reference), label,
                            "whole")


TRAIN_LR = 1e-3
TRAIN_CASES = {
    "data": ({"data": 2}, 0),
    "fsdp": ({"fsdp": 2}, 0),
    "model": ({"model": 2}, 0),
    "fsdp_model": ({"fsdp": 2, "model": 2}, 0),
    "moe_expert": ({"expert": 2}, 4),
    "moe_data": ({"data": 2}, 4),
}

TRAIN_WORKER = textwrap.dedent("""
    import json
    import sys
    import weakref
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models import load_pytree, optim
    from aiko_services_tpu_torch.models import transformer as lm
    from aiko_services_tpu_torch.parallel import (
        filter_specs, global_mesh, initialize_distributed, process_index,
        set_default_devices, shutdown_distributed, unshard, use_mesh)
    cases, config, weights, lr, out = json.loads(sys.argv[1])
    assert initialize_distributed(timeout_seconds=200)
    rank = process_index()

    def flat(tree, prefix):
        if isinstance(tree, dict):
            out = {}
            for key, value in tree.items():
                out.update(flat(value, f"{prefix}/{key}"))
            return out
        # a copy: a whole leaf is the live tensor the update changes
        return {prefix: unshard(tree).detach().numpy().copy()}

    for name, (axes, experts) in cases.items():
        set_default_devices(["cpu"] * (int(np.prod(list(axes.values())))
                                       // 2))
        mesh = global_mesh(axes)
        assert not mesh.local.all()
        cfg = lm.TransformerConfig(**config, n_experts=experts)
        path = weights[str(experts)]
        specs = filter_specs(lm.param_specs(cfg), mesh)
        tokens = torch.from_numpy(np.load(path + ".tokens.npy"))

        def loss_fn(params, tokens):
            logits, aux = lm.forward(params, cfg, tokens[:, :-1],
                                     activation_specs=True, return_aux=True)
            return (optim.next_token_loss(logits, tokens[:, 1:])
                    + cfg.moe_aux_weight * aux)

        def exchanges():
            return sum(mesh.sequence.values())

        with use_mesh(mesh):
            params = load_pytree(path, mesh=mesh, specs=specs)
            before = exchanges()
            loss, grads = optim.value_and_grad(loss_fn, params, tokens)
            first = exchanges() - before
            results = {"loss": np.asarray(float(loss))}
            results.update(flat(grads, "grad"))
            # an evaluation with gradients on whose loss is held through
            # the next gradient, then one whose loss is dropped
            held = loss_fn(params, tokens)
            before = exchanges()
            _, again = optim.value_and_grad(loss_fn, params, tokens)
            second = exchanges() - before
            results.update(flat(again, "again"))
            dropped = loss_fn(params, tokens)
            del held, dropped
            chain = mesh.chain
            freed = chain is None or (isinstance(chain, weakref.ref)
                                      and chain() is None)
            results["eval/exchanges"] = np.asarray([first, second])
            results["eval/freed"] = np.asarray(freed)
            params = load_pytree(path, mesh=mesh, specs=specs)
            adam = optim.adam(lr)
            steps = iter(range(1 << 30))

            def update(grads, state, params=None):
                # what each step hands the optimizer, and the parameters
                # it updates
                step = next(steps)
                results.update(flat(params, f"step{step}/before"))
                results.update(flat(grads, f"step{step}/grad"))
                return adam.update(grads, state, params)
            optimizer = optim.GradientTransformation(adam.init, update)
            state = optimizer.init(params)
            step = lm.make_train_step(cfg, optimizer, sharded=True)
            for _ in range(2):
                params, state, _ = step(params, state, tokens)
            results.update(flat(params, "param"))
        np.savez(f"{out}.{name}.{rank}.npz", **results)
    print(f"rank {rank} trained", flush=True)
    shutdown_distributed()
""")


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """(each case's per-rank results, the JAX references by expert
    count, the JAX (config, params) by expert count, the tokens): both
    packages on the JAX package's random weights (saved by its
    save_pytree) and one seeded batch."""
    root = tmp_path_factory.mktemp("train")
    weights, models = {}, {}
    tokens = np.random.default_rng(6).integers(0, 128, (4, 17)).astype(
        np.int32)
    for experts in (0, 4):
        config = jax_lm.TransformerConfig(**SMALL, n_experts=experts)
        params = jax_lm.init_params(config, jax.random.PRNGKey(5))
        path = str(root / f"lm{experts}.safetensors")
        jax_save_pytree(path, params)
        np.save(path + ".tokens.npy", tokens)
        weights[str(experts)], models[experts] = path, (config, params)
    out = str(root / "out")
    coordinator = f"127.0.0.1:{_free_port()}"
    argument = json.dumps([TRAIN_CASES, SMALL, weights, TRAIN_LR, out])
    workers = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   AIKO_COORDINATOR=coordinator, AIKO_NUM_PROCESSES="2",
                   AIKO_PROCESS_ID=str(rank))
        workers.append(subprocess.Popen(
            [sys.executable, "-c", TRAIN_WORKER, argument],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    try:
        # the JAX references run while the workers train
        references = {experts: _jax_reference(*models[experts], tokens)
                      for experts in models}
        for rank, worker in enumerate(workers):
            output, _ = worker.communicate(timeout=240)
            assert worker.returncode == 0, output
            assert f"rank {rank} trained" in output, output
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
    runs = {name: [dict(np.load(f"{out}.{name}.{rank}.npz"))
                   for rank in range(2)] for name in TRAIN_CASES}
    return runs, references, models, tokens


def _jax_loss(config):
    """The JAX package's train-step loss (transformer.make_train_step's)
    and its jitted jax.value_and_grad."""
    import jax.numpy as jnp

    def loss_fn(params, tokens):
        logits, aux = jax_lm.forward(params, config, tokens[:, :-1],
                                     return_aux=True)
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return (-jnp.mean(jnp.take_along_axis(
            log_probs, tokens[:, 1:, None], axis=-1)[..., 0])
            + config.moe_aux_weight * aux)
    return loss_fn, jax.jit(jax.value_and_grad(loss_fn))


def _nested(flat_tree: dict, prefix: str) -> dict:
    """{prefix/a/b: leaf} -> {a: {b: leaf}}."""
    tree: dict = {}
    for key, leaf in flat_tree.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def _flat(tree, prefix: str) -> dict:
    return {prefix + "".join(f"/{key.key}" for key in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_reference(config, params, tokens) -> dict:
    """The JAX package's train-step loss and its gradient
    (jax.value_and_grad), and the parameters after two make_train_step
    steps with optax.adam, as flat {"loss", "grad/...", "param/..."}."""
    import jax.numpy as jnp
    import optax
    _, value_and_grad = _jax_loss(config)
    loss, grads = value_and_grad(params, tokens)
    optimizer = optax.adam(TRAIN_LR)
    trained = jax.tree_util.tree_map(jnp.array, params)
    state = optimizer.init(trained)
    step = jax_lm.make_train_step(config, optimizer)
    for _ in range(2):
        trained, state, _ = step(trained, state, jnp.asarray(tokens))
    return {"loss": np.asarray(loss), **_flat(grads, "grad"),
            **_flat(trained, "param")}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_two_process_train_step_matches_jax(train_runs, case):
    """The train step on a global mesh over two processes (the SMALL
    llama, f32; a 4-expert MoE on "expert" and on "data"), on both
    ranks: the loss and every gradient leaf equal jax.value_and_grad of
    the JAX package's train-step loss (atol 1e-6: no cotangent lost,
    none counted twice); in two adam(1e-3) steps, the gradients each
    step hands the optimizer equal jax.value_and_grad at the port's own
    parameters before that step (1e-6), the parameters after them equal
    optax.adam applied to those gradients (test_five_steps_match_optax's
    bound) and the JAX package's make_train_step's (atol 1e-5) wherever
    its first gradient exceeds 1e-6; the ranks' parameters are bit for
    bit equal."""
    import jax.numpy as jnp
    import optax
    runs, references, models, tokens = train_runs
    experts = TRAIN_CASES[case][1]
    reference = references[experts]
    config, initial = models[experts]
    _, value_and_grad = _jax_loss(config)
    ranks = runs[case]
    for rank, results in enumerate(ranks):
        keys = {key for key in results if key.split("/")[0] in (
            "loss", "grad", "param")}
        assert keys == set(reference), keys ^ set(reference)
        for key, want in reference.items():
            if not key.startswith("param/"):
                np.testing.assert_allclose(results[key], want, atol=1e-6,
                                           rtol=0,
                                           err_msg=f"rank {rank} {key}")
        optimizer = optax.adam(TRAIN_LR)
        replayed = jax.tree_util.tree_map(jnp.asarray, initial)
        state = optimizer.init(replayed)
        for step in range(2):
            before = _nested(results, f"step{step}/before")
            for key, leaf in _flat(replayed, "").items():
                np.testing.assert_allclose(
                    _flat(before, "")[key], leaf, atol=1e-7,
                    rtol=2.0 ** -22,
                    err_msg=f"rank {rank} step {step} optax {key}")
            _, want = value_and_grad(before, tokens)
            got = _nested(results, f"step{step}/grad")
            for key, leaf in _flat(want, "").items():
                np.testing.assert_allclose(
                    _flat(got, "")[key], leaf, atol=1e-6, rtol=0,
                    err_msg=f"rank {rank} step {step} gradient {key}")
            updates, state = optimizer.update(
                jax.tree_util.tree_map(jnp.asarray, got), state, replayed)
            replayed = optax.apply_updates(replayed, updates)
        for key, leaf in _flat(replayed, "param").items():
            np.testing.assert_allclose(results[key], leaf, atol=1e-7,
                                       rtol=2.0 ** -22,
                                       err_msg=f"rank {rank} optax {key}")
            steep = np.abs(reference["grad" + key[len("param"):]]) > 1e-6
            np.testing.assert_allclose(
                results[key][steep], reference[key][steep], atol=1e-5,
                rtol=0, err_msg=f"rank {rank} make_train_step {key}")
    for key in ranks[0]:
        if key.startswith("param/"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                          err_msg=key)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_two_process_evaluation_with_gradients_leaves_no_backward_behind(
        train_runs, case):
    """An evaluation forward with gradients on whose loss is never
    backpropagated: the next value_and_grad, run while that loss is
    still held, gives every gradient leaf of jax.value_and_grad (atol
    1e-6) through exactly as many cross-process exchanges as the first
    (none of the evaluation's collectives runs its backward), and once
    an evaluation's loss is dropped the mesh keeps nothing of its
    graph."""
    runs, references, _, _ = train_runs
    reference = references[TRAIN_CASES[case][1]]
    for rank, results in enumerate(runs[case]):
        for key, want in reference.items():
            if key.startswith("grad/"):
                np.testing.assert_allclose(
                    results["again/" + key[len("grad/"):]], want,
                    atol=1e-6, rtol=0, err_msg=f"rank {rank} again {key}")
        first, second = results["eval/exchanges"].tolist()
        assert first == second, (rank, first, second)
        assert results["eval/freed"], rank
