# The mesh over several processes with more than two of them, on the CPU:
# four OS processes join one job over gloo through the AIKO_* contract,
# one mesh position each, the layout a job of one NCCL rank per card has
# on a machine with four cards.  With four processes a collective's
# process group can leave ranks out: on fsdp 2 x model 2 the groups are
# {0, 1} and {2, 3} over "model", {0, 2} and {1, 3} over "fsdp", and every
# process creates every group alike (parallel/collectives.py
# _process_group).  A causal ring of four hops point to point between
# the processes, rank r executing r + 1 hops a layer.
#
# Against the JAX package on the same inputs (its weights saved by its
# save_pytree and read by the port's load_pytree; its ring and Ulysses on
# four CPU devices, the Pallas kernels in interpret mode, in the test
# process while the workers run):
#   - a make_train_step(sharded=True) step on fsdp 2 x model 2: the loss
#     and every gradient leaf it hands the optimizer against
#     jax.value_and_grad of the JAX package's loss, atol 1e-6 (f32,
#     tests/test_torch_sp_processes.py's bound);
#   - ring and Ulysses attention forward and backward on {"seq": 4}: each
#     rank's block of O and of dQ, dK, dV against jax.grad through the
#     JAX package's ring_attention / ulysses_attention (ATTENTION_ATOL);
#   - the collective calls and bytes each rank issues, worked out from
#     the mesh and the shapes in advance.
# Each worker runs with one thread (OMP_NUM_THREADS=1): the tier-1 run
# shares the machine's cores between several test processes.
#
# The same job in the pod layout (one process per host driving its
# cards): two processes with two positions each, data 2 x model 2 and
# fsdp 2 x model 2 with the first axis across the processes, and the
# ring and Ulysses on {"seq": 4} with positions 2r and 2r + 1 on rank r,
# against the same JAX references.  On gloo with CPU entries no exchange
# copies a byte between cards or stages one through host memory.
#
# initialize_distributed on NCCL is held here with torch.cuda and
# torch.distributed patched: the process's card is current (and the
# group's device_id) before any collective, and two ranks that name one
# physical card (one UUID, whatever CUDA index each process sees it as)
# anywhere in their local_device_ids raise on both before any NCCL call,
# while ranks that each see their own card as cuda:0
# (CUDA_VISIBLE_DEVICES) initialize, as do ranks with two cards each.
# The wire rule (parallel/collectives.py _wire) is held under a patched
# torch.distributed.get_backend: an NCCL exchange's payload lies on the
# process's bound card whatever card its entries lie on.
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import save_pytree as jax_save_pytree
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu.parallel import attention as jax_attention
from aiko_services_tpu.parallel import create_mesh as jax_create_mesh
from aiko_services_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 4
SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, max_seq_len=64, dtype="float32")
TRAIN_AXES = {"fsdp": 2, "model": 2}
# the train step's meshes: fsdp x model, and data x fsdp, where the
# processes of the second fsdp position hold no block of the first
# line of the logits' data blocks
TRAIN_MESHES = {"fsdp_model": TRAIN_AXES, "data_fsdp": {"data": 2, "fsdp": 2}}
BATCH, SEQ = 2, 16            # the train step's tokens: (2, 17)
ATTENTION = (1, 4, 64, 8)     # (B, H, L, D): 16 positions a process
MECHANISMS = ("ring", "ulysses")
# the pod layout (one process per host driving its cards): two processes
# with two positions each, the data or fsdp axis across them and model
# within; {"seq": 4} puts positions 2r and 2r + 1 on rank r
POD_PROCESSES, POD_POSITIONS = 2, 2
POD_MESHES = {"data_model": {"data": 2, "model": 2},
              "fsdp_model": {"fsdp": 2, "model": 2}}
# against the JAX package, rtol 0: the ring within 1e-6 (largest read
# 7.153e-7, dV); Ulysses' dK and dV differ by up to 1.192e-6 and 1.431e-6
# at values up to 3.16 and 5.16 (a few f32 ulps: the two sides sum a
# block's products in different orders), so its bound is the largest
# read plus one ulp at that size
ATTENTION_ATOL = {"ring": 1e-6, "ulysses": 2e-6}

WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models import load_pytree, optim
    from aiko_services_tpu_torch.models import transformer as lm
    from aiko_services_tpu_torch.parallel import (
        attention, collectives, filter_specs, global_mesh,
        initialize_distributed, process_index, set_default_devices,
        shutdown_distributed, unshard, use_mesh)
    small, meshes, paths, target, positions = json.loads(sys.argv[1])
    assert initialize_distributed(timeout_seconds=200)
    rank = process_index()
    set_default_devices(["cpu"] * positions)  # positions a process
    results = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            out = {}
            for key, value in tree.items():
                out.update(flat(value, f"{prefix}/{key}"))
            return out
        return {prefix: unshard(tree).detach().numpy().copy()}

    def counted():
        return {axes: [entry["calls"], entry["bytes"]] for axes, entry
                in collectives.collective_counts().items()}

    def copied():
        # (bytes copied between cards to reach the wire, bytes staged
        # through host memory): both 0 for CPU entries on gloo
        return np.asarray([collectives.wire_copy_bytes(),
                           collectives.staged_bytes()])

    # the train step on each mesh
    cfg = lm.TransformerConfig(**small)
    tokens = torch.from_numpy(np.load(paths["tokens"]))
    for name, axes in meshes.items():
        mesh = global_mesh(axes)
        results[f"{name}/processes"] = mesh.processes
        params = load_pytree(paths["lm"], mesh=mesh, specs=filter_specs(
            lm.param_specs(cfg), mesh))
        adam = optim.adam(1e-3)

        def update(grads, state, params=None, name=name):
            results.update(flat(grads, f"{name}/grad"))
            return adam.update(grads, state, params)
        optimizer = optim.GradientTransformation(adam.init, update)
        state = optimizer.init(params)
        step = lm.make_train_step(cfg, optimizer, sharded=True)
        collectives.reset_collective_counts()
        with use_mesh(mesh):
            _, _, loss = step(params, state, tokens)
        results[f"{name}/loss"] = np.asarray(float(loss))
        results[f"{name}/counts"] = np.asarray(json.dumps(counted()))
        results[f"{name}/copied"] = copied()
        results[f"{name}/groups"] = np.asarray(json.dumps(sorted(
            list(ranks) for ranks in mesh.process_groups)))

    # ring and Ulysses forward + backward on {"seq": 4}, this rank's
    # blocks (contiguous: its positions are consecutive along "seq")
    mesh = global_mesh({"seq": 4})
    arrays = [np.load(paths[name]) for name in ("q", "k", "v")]
    block = arrays[0].shape[2] // 4
    mine = [index for index, local in enumerate(mesh.local.flat) if local]
    for mechanism in ("ring", "ulysses"):
        inputs = {index: [torch.from_numpy(
            array[:, :, index * block:(index + 1) * block].copy()
        ).requires_grad_() for array in arrays] for index in mine}
        grids = []
        for which in range(3):
            grid = np.empty(mesh.devices.shape, dtype=object)
            for index in mine:
                grid[index] = inputs[index][which]
            grids.append(grid)
        function = (attention.ring_attention_grid if mechanism == "ring"
                    else attention.ulysses_attention_grid)
        hops = []
        attention._RING_HOP_CALLBACK = hops.append
        collectives.begin_backward()
        collectives.reset_collective_counts()
        try:
            grid = function(*grids, mesh, "seq", causal=True)
            outs = [grid[index] for index in mine]
            forward_hops = len(hops)
            loss = collectives.join_backward(
                sum((out * torch.cos(out)).sum() for out in outs), mesh)
            grads = torch.autograd.grad(loss, [
                tensor for index in mine for tensor in inputs[index]])
        finally:
            attention._RING_HOP_CALLBACK = None
        results[f"{mechanism}/out"] = np.concatenate(
            [out.detach().numpy() for out in outs], axis=2)
        for which, name in enumerate(("dq", "dk", "dv")):
            results[f"{mechanism}/{name}"] = np.concatenate(
                [grad.numpy() for grad in grads[which::3]], axis=2)
        results[f"{mechanism}/hops"] = np.asarray(forward_hops)
        results[f"{mechanism}/counts"] = np.asarray(json.dumps(counted()))
        results[f"{mechanism}/copied"] = copied()
    np.savez(f"{target}.{rank}.npz", **results)
    print(f"rank {rank} done", flush=True)
    shutdown_distributed()
""")


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _flat(tree, prefix: str) -> dict:
    return {prefix + "".join(f"/{key.key}" for key in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _lm_loss(config):
    """make_train_step's loss in the JAX package (the dense FFN)."""
    def loss_fn(params, tokens):
        logits = jax_lm.forward(params, config, tokens[:, :-1])
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            log_probs, tokens[:, 1:, None], axis=-1)[..., 0])
    return loss_fn


def _jax_references(params, data) -> dict:
    """The JAX package on the same weights and inputs: the train step's
    loss and gradients, and the ring's and Ulysses' O and the gradients
    of sum(O cos O) on a {"seq": 4} mesh of four CPU devices."""
    loss, grads = jax.value_and_grad(_lm_loss(jax_lm.TransformerConfig(
        **SMALL)))(params, data["tokens"])
    out = {"loss": np.asarray(loss), **_flat(grads, "grad")}
    mesh = jax_create_mesh({"seq": PROCESSES},
                           devices=jax.devices()[:PROCESSES])
    functions = {"ring": jax_attention.ring_attention,
                 "ulysses": jax_attention.ulysses_attention}
    for mechanism, function in functions.items():
        def attend(q, k, v, function=function):
            return function(q, k, v, mesh, causal=True)

        def loss_of(q, k, v, attend=attend):
            result = attend(q, k, v)
            return jnp.sum(result * jnp.cos(result))
        out[f"{mechanism}/out"] = np.asarray(attend(
            data["q"], data["k"], data["v"]))
        for name, grad in zip(("dq", "dk", "dv"), jax.grad(
                loss_of, argnums=(0, 1, 2))(data["q"], data["k"],
                                            data["v"])):
            out[f"{mechanism}/{name}"] = np.asarray(grad)
    return out


def _start_job(root, paths: dict, meshes: dict, processes: int,
               positions: int) -> tuple:
    """The workers of one job, `positions` mesh positions each: (the
    worker processes, the stem of their result files)."""
    out = str(root / f"out{processes}x{positions}")
    argument = json.dumps([SMALL, meshes, paths, out, positions])
    coordinator = f"127.0.0.1:{_free_port()}"
    workers = []
    for rank in range(processes):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   AIKO_COORDINATOR=coordinator,
                   AIKO_NUM_PROCESSES=str(processes),
                   AIKO_PROCESS_ID=str(rank))
        workers.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, argument],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    return workers, out


def _finish_job(workers: list, out: str) -> list:
    """Each rank's results, once every worker ended well; a worker still
    running when the test gives up is killed."""
    try:
        for rank, worker in enumerate(workers):
            output, _ = worker.communicate(timeout=240)
            assert worker.returncode == 0, output
            assert f"rank {rank} done" in output, output
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
    return [dict(np.load(f"{out}.{rank}.npz"))
            for rank in range(len(workers))]


@pytest.fixture(scope="module")
def job_inputs(tmp_path_factory):
    """(directory, the input files, the JAX package's weights, the
    inputs)."""
    root = tmp_path_factory.mktemp("cards")
    rng = np.random.default_rng(16)
    data = {"tokens": rng.integers(0, SMALL["vocab_size"],
                                   (BATCH, SEQ + 1)).astype(np.int32)}
    for name in ("q", "k", "v"):
        data[name] = rng.standard_normal(ATTENTION, dtype=np.float32)
    paths = {"lm": str(root / "lm.safetensors")}
    for name, value in data.items():
        paths[name] = str(root / f"{name}.npy")
        np.save(paths[name], value)
    params = jax_lm.init_params(jax_lm.TransformerConfig(**SMALL),
                                jax.random.PRNGKey(16))
    jax_save_pytree(paths["lm"], params)
    return root, paths, params, data


@pytest.fixture(scope="module")
def runs(job_inputs):
    """(each rank's results, the JAX references): four processes, one
    position each."""
    root, paths, params, data = job_inputs
    workers, out = _start_job(root, paths, TRAIN_MESHES, PROCESSES, 1)
    try:
        # the JAX references run while the workers compute
        references = _jax_references(params, data)
    finally:
        results = _finish_job(workers, out)
    return results, references


@pytest.fixture(scope="module")
def pod_runs(job_inputs, runs):
    """(each rank's results, the JAX references): the pod layout, two
    processes with two positions each, every mesh's across-process axis
    major and its within-process axis minor."""
    root, paths, _, _ = job_inputs
    workers, out = _start_job(root, paths, POD_MESHES, POD_PROCESSES,
                              POD_POSITIONS)
    return _finish_job(workers, out), runs[1]


def _train_step_counts() -> dict:
    """What one sharded train step on fsdp 2 x model 2, one position a
    process, issues on each rank, worked out from the shapes: over
    "fsdp" the embedding's gather, per layer the q/k/v and gate/up psums
    and the wo and w_down gathers (each the activations' bytes: f32, the
    batch's tokens), and the f32 logits' psum; over "model" per layer the
    wo and w_down psums and the embedding's replica sum; over both (each
    spans the processes) one all_reduce a step of each whole leaf's
    gradient (the three norms: every process uses them), each with its
    local bytes."""
    fsdp, model = TRAIN_AXES["fsdp"], TRAIN_AXES["model"]
    layers, d, d_ff = SMALL["n_layers"], SMALL["d_model"], SMALL["d_ff"]
    heads, kv_heads = SMALL["n_heads"], SMALL["n_kv_heads"]
    head_dim, vocab, width = d // heads, SMALL["vocab_size"], 4
    tokens = BATCH * SEQ
    # param_specs: the embedding is cut by fsdp alone (its replicas
    # across "model" sum their gradients), the layer products by both
    # axes, the norms are whole
    whole = layers * d * 2 + d
    return {
        "fsdp": [2 + 4 * layers, tokens * width * (
            d // fsdp + layers * ((heads + 2 * kv_heads) * head_dim // model
                                  + 2 * d // fsdp + 2 * d_ff // model))
            + tokens * vocab * 4],
        "model": [2 * layers + 1, tokens * width * layers * 2 * d // fsdp
                  + vocab * d // fsdp * width],
        "fsdp+model": [3, whole * width]}


def test_four_process_mesh_groups_leave_ranks_out(runs):
    """The job's four processes hold one position each of fsdp 2 x model
    2; every process created the same process groups, those that leave
    ranks out among them."""
    results, _ = runs
    for rank, result in enumerate(results):
        np.testing.assert_array_equal(result["fsdp_model/processes"],
                                      [[0, 1], [2, 3]])
        groups = json.loads(str(result["fsdp_model/groups"]))
        assert {(0, 1), (2, 3), (0, 2), (1, 3)} <= set(map(tuple, groups)), (
            rank, groups)
        assert groups == json.loads(str(results[0]["fsdp_model/groups"]))


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_four_process_train_step_matches_jax(runs, mesh):
    """make_train_step(sharded=True) on fsdp 2 x model 2 and on data 2 x
    fsdp 2 across four processes: the loss and every gradient leaf the
    optimizer receives, on every rank, equal jax.value_and_grad of the
    JAX package's loss (1e-6).  On data x fsdp the ranks of the second
    fsdp position gather the logits' data blocks from a line of their
    own, and only the first line's copy sends its cotangents back: a
    second would double the gradient of every replicated leaf."""
    results, references = runs
    keys = [key for key in references if key.startswith("grad/")]
    assert keys
    for rank, result in enumerate(results):
        np.testing.assert_allclose(result[f"{mesh}/loss"],
                                   references["loss"], atol=1e-6, rtol=0)
        for key in keys:
            np.testing.assert_allclose(result[f"{mesh}/" + key],
                                       references[key], atol=1e-6, rtol=0,
                                       err_msg=f"rank {rank} {mesh} {key}")


@pytest.mark.parametrize("rank", range(PROCESSES))
def test_four_process_train_step_collectives_as_worked_out(runs, rank):
    """Each rank's collective calls and bytes of one train step equal the
    counts worked out from the mesh and the shapes in advance."""
    results, _ = runs
    assert (json.loads(str(results[rank]["fsdp_model/counts"]))
            == _train_step_counts())


@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_four_process_attention_matches_jax(runs, mechanism):
    """Ring and Ulysses on {"seq": 4}, one block a process: each rank's
    block of O and of the gradients of sum(O cos O) equal the JAX
    package's on four CPU devices (ATTENTION_ATOL)."""
    results, references = runs
    block = ATTENTION[2] // PROCESSES
    for rank, result in enumerate(results):
        own = slice(rank * block, (rank + 1) * block)
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(
                result[f"{mechanism}/{name}"],
                references[f"{mechanism}/{name}"][:, :, own],
                atol=ATTENTION_ATOL[mechanism], rtol=0,
                err_msg=f"rank {rank} {mechanism} {name}")


@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_four_process_attention_hops_and_exchanges(runs, mechanism):
    """Rank r of the causal ring executes r + 1 hops (ring) and each rank
    issues the exchanges worked out from the shapes: the ring's forward
    three hops of its K/V block, its backward three hops of K, V and their
    f32 dK, dV and one returning dK, dV home (seven calls, point to point
    between the processes); Ulysses one all_to_all of q, k, v stacked and
    one of O (its backward's transposes ride the same calls' nodes)."""
    results, _ = runs
    batch, heads, length, dim = ATTENTION
    block = batch * heads * (length // PROCESSES) * dim
    hops = PROCESSES - 1
    for rank, result in enumerate(results):
        counts = json.loads(str(result[f"{mechanism}/counts"]))
        if mechanism == "ring":
            assert int(result["ring/hops"]) == rank + 1
            expected = [2 * hops + 1, 4 * (hops * 2 * block
                                           + hops * 4 * block + 2 * block)]
        else:
            assert int(result["ulysses/hops"]) == 0
            expected = [2, 4 * (3 * block + block)]
        assert counts == {"seq": expected}, (rank, counts)


# -- initialize_distributed on NCCL, torch.cuda and dist patched ----------------

def _claim(index: int, uuid: str, host: str | None = None) -> str:
    """What a rank on card `uuid`, its cuda:`index`, sets in the store."""
    return _claims([(index, uuid)], host)


def _claims(cards, host: str | None = None) -> str:
    """What a rank on `cards` ((its cuda index, uuid) pairs) sets in the
    store."""
    return json.dumps({"host": host or socket.gethostname(),
                       "cards": sorted([uuid, index]
                                       for index, uuid in cards)})


def _store(others: dict):
    """A rendezvous store holding the keys the other ranks set."""
    import torch.distributed as dist
    store = dist.HashStore()
    for key, value in others.items():
        store.set(key, value)
    return store


@pytest.fixture
def nccl(monkeypatch):
    """initialize_distributed's view of torch.cuda and torch.distributed,
    recording the calls in order; yields (calls, install(store), uuids):
    cuda:i of this process is the card uuids[i] (GPU-i unless a test
    says otherwise)."""
    import types

    import torch.distributed as dist
    calls, uuids = [], {}
    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    monkeypatch.setattr(distributed, "_LOCAL_DEVICE_IDS", None)
    monkeypatch.setattr(distributed, "_CARD", None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda device: calls.append(("set_device", device)))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda device: types.SimpleNamespace(uuid=uuids.get(
            torch.device(device).index,
            f"GPU-{torch.device(device).index}")))

    def init_process_group(backend, **options):
        calls.append(("init_process_group", backend, options))

    def all_gather_object(out, value, group=None):
        calls.append(("all_gather_object", value))
        out[:] = [value] * len(out)
    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)

    def install(store):
        def rendezvous(url, rank, world_size, **options):
            calls.append(("rendezvous", url, rank, world_size))
            yield store, rank, world_size
        monkeypatch.setattr(dist, "rendezvous", rendezvous)
    yield calls, install, uuids


@pytest.mark.parametrize("rank", [0, 3])
def test_nccl_makes_the_card_current_before_any_collective(nccl, rank):
    """Rank r with local_device_ids [r] on NCCL: cuda:r is the current
    device and the process group's device_id before the first collective
    (the group's creation, then global_mesh's all_gather_object), and
    the mesh's position is cuda:r."""
    calls, install, _ = nccl
    install(_store({f"aiko_card/{other}": _claim(other, f"GPU-{other}")
                    for other in range(PROCESSES) if other != rank}))
    assert distributed.initialize_distributed(
        "127.0.0.1:1", PROCESSES, rank, local_device_ids=[rank],
        backend="nccl")
    card = torch.device("cuda", rank)
    assert [call[0] for call in calls] == ["rendezvous", "set_device",
                                           "init_process_group"]
    assert calls[1] == ("set_device", card)
    backend, options = calls[2][1:]
    assert backend == "nccl" and options["device_id"] == card
    assert (options["rank"], options["world_size"]) == (rank, PROCESSES)
    assert distributed._local_devices() == [card]


def test_nccl_ranks_on_distinct_cards_seen_as_cuda0_initialize(
        nccl, monkeypatch):
    """One card a rank through CUDA_VISIBLE_DEVICES: every rank sees its
    card as cuda:0 and takes it by default, but the cards' UUIDs differ,
    so the job initializes on cuda:0 of each process."""
    calls, install, uuids = nccl
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    uuids[0] = "GPU-rank1"
    install(_store({f"aiko_card/{other}": _claim(0, f"GPU-rank{other}")
                    for other in range(PROCESSES) if other != 1}))
    assert distributed.initialize_distributed(
        "127.0.0.1:1", PROCESSES, 1, backend="nccl")
    card = torch.device("cuda", 0)
    assert calls[1] == ("set_device", card)
    assert calls[2][2]["device_id"] == card


@pytest.mark.parametrize("indices", [(0, 0), (0, 2)])
def test_two_nccl_ranks_naming_one_card_raise(nccl, indices):
    """Ranks 0 and 1 on one card of this host -- both as cuda:0, or as
    cuda:0 and cuda:2 of processes that see the cards in different
    orders: both raise before any NCCL call (rank 0, whose process holds
    the store, once rank 1 has read the claims), and nothing falls back
    to gloo."""
    calls, install, uuids = nccl
    uuids[indices[0]] = "GPU-shared"
    install(_store({"aiko_card/1": _claim(indices[1], "GPU-shared"),
                    "aiko_card_read/1": "1"}))
    with pytest.raises(ValueError, match=(
            r"ranks \[0, 1\] on card GPU-shared of .* \(as cuda:"
            f"{indices[0]}/{indices[1]}\\)")):
        distributed.initialize_distributed(
            "127.0.0.1:1", 2, 0, local_device_ids=[indices[0]],
            backend="nccl")
    assert [call[0] for call in calls] == ["rendezvous"]
    assert not distributed._INITIALIZED


def test_gloo_keeps_the_init_method_and_sets_no_card(nccl):
    """A gloo job joins through the tcp:// init method as before: no
    rendezvous store of its own, no current card, no device_id."""
    calls, _, _ = nccl
    assert distributed.initialize_distributed(
        "127.0.0.1:1", 2, 1, local_device_ids=[0, 0], backend="gloo")
    assert [call[0] for call in calls] == ["init_process_group"]
    backend, options = calls[0][1:]
    assert backend == "gloo"
    assert options["init_method"] == "tcp://127.0.0.1:1"
    assert "device_id" not in options and "store" not in options


# -- the pod layout: several cards a process on NCCL --------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_nccl_ranks_naming_one_card_among_several_raise(nccl, rank):
    """Rank 0 on [0, 1] and rank 1 on [1, 2]: their first cards differ,
    but both name cuda:1.  Each raises before any NCCL call, the message
    naming the shared card and each rank's index for it (and no card
    only one rank names); nothing falls back to gloo."""
    calls, install, _ = nccl
    cards = {0: [0, 1], 1: [1, 2]}
    other = 1 - rank
    install(_store({
        f"aiko_card/{other}": _claims([(index, f"GPU-{index}")
                                       for index in cards[other]]),
        "aiko_card_read/1": "1"}))
    with pytest.raises(ValueError, match=(
            r"ranks \[0, 1\] on card GPU-1 of .* \(as cuda:1/1\)")) as raised:
        distributed.initialize_distributed(
            "127.0.0.1:1", 2, rank, local_device_ids=cards[rank],
            backend="nccl")
    assert "GPU-0" not in str(raised.value)
    assert "GPU-2" not in str(raised.value)
    assert [call[0] for call in calls] == ["rendezvous"]
    assert not distributed._INITIALIZED
    assert distributed.process_card() is None


@pytest.mark.parametrize("rank", [0, 1])
def test_nccl_two_cards_a_rank_bind_the_first(nccl, rank):
    """The pod layout, rank r on [2r, 2r + 1]: the job initializes,
    cuda:2r is the current card, the group's device_id and
    process_card(), and the process's positions lie on both cards."""
    calls, install, _ = nccl
    other = 1 - rank
    install(_store({f"aiko_card/{other}": _claims(
        [(2 * other, f"GPU-{2 * other}"),
         (2 * other + 1, f"GPU-{2 * other + 1}")])}))
    assert distributed.initialize_distributed(
        "127.0.0.1:1", 2, rank, local_device_ids=[2 * rank, 2 * rank + 1],
        backend="nccl")
    card = torch.device("cuda", 2 * rank)
    assert [call[0] for call in calls] == ["rendezvous", "set_device",
                                           "init_process_group"]
    assert calls[1] == ("set_device", card)
    assert calls[2][2]["device_id"] == card
    assert distributed.process_card() == card
    assert distributed._local_devices() == [
        card, torch.device("cuda", 2 * rank + 1)]


def test_nccl_one_process_may_name_a_card_several_times(nccl):
    """[0, 0, 1, 1]: two positions on each of two cards in one process.
    Its claim names each card once, the job (rank 1 on [2, 3])
    initializes with device_id cuda:0, and equal devices are one
    object."""
    calls, install, _ = nccl
    store = _store({"aiko_card/1": _claims([(2, "GPU-2"), (3, "GPU-3")])})
    install(store)
    assert distributed.initialize_distributed(
        "127.0.0.1:1", 2, 0, local_device_ids=[0, 0, 1, 1], backend="nccl")
    assert calls[2][2]["device_id"] == torch.device("cuda", 0)
    assert json.loads(store.get("aiko_card/0").decode())["cards"] == [
        ["GPU-0", 0], ["GPU-1", 1]]
    devices = distributed._local_devices()
    assert devices == [torch.device("cuda", index) for index in (0, 0, 1, 1)]
    assert devices[0] is devices[1] and devices[2] is devices[3]


@pytest.fixture
def backends(monkeypatch):
    """torch.distributed.get_backend patched: the group "nccl" is an
    NCCL group bound to cuda:2, the group "gloo" a gloo group."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_backend", lambda group=None: group)
    monkeypatch.setattr(distributed, "_CARD", torch.device("cuda", 2))


@pytest.mark.parametrize("entries", ["cuda:2", "cuda:3", "cuda:0"])
def test_wire_is_the_bound_card_on_nccl_whatever_the_entries(backends,
                                                             entries):
    """An NCCL exchange puts its payload on the process's bound card
    whatever card its entries lie on; gloo keeps CPU entries where they
    are and stages CUDA ones through the host."""
    from aiko_services_tpu_torch.parallel import collectives
    assert collectives._wire("nccl", entries) == torch.device("cuda", 2)
    assert collectives._wire("gloo", "cpu") == torch.device("cpu")
    assert collectives._wire("gloo", entries) == torch.device("cpu")


def test_wire_refuses_what_nccl_cannot_carry(backends, monkeypatch):
    """Host entries on an NCCL group, or an NCCL group with no bound
    card (joined without initialize_distributed), raise: nothing falls
    back to gloo or carries on on the CPU."""
    from aiko_services_tpu_torch.parallel import collectives
    with pytest.raises(RuntimeError, match="NCCL"):
        collectives._wire("nccl", "cpu")
    monkeypatch.setattr(distributed, "_CARD", None)
    with pytest.raises(RuntimeError, match="NCCL"):
        collectives._wire("nccl", "cuda:2")


@pytest.mark.parametrize("mesh", list(POD_MESHES))
def test_pod_layout_train_step_matches_jax(pod_runs, mesh):
    """make_train_step(sharded=True) on data 2 x model 2 and fsdp 2 x
    model 2 over two processes with two positions each (the data or
    fsdp axis across them, model within): the loss and every gradient
    leaf the optimizer receives, on both ranks, equal jax.value_and_grad
    of the JAX package's loss (1e-6)."""
    results, references = pod_runs
    keys = [key for key in references if key.startswith("grad/")]
    assert keys
    for rank, result in enumerate(results):
        np.testing.assert_array_equal(result[f"{mesh}/processes"],
                                      [[0, 0], [1, 1]])
        np.testing.assert_allclose(result[f"{mesh}/loss"],
                                   references["loss"], atol=1e-6, rtol=0)
        for key in keys:
            np.testing.assert_allclose(result[f"{mesh}/" + key],
                                       references[key], atol=1e-6, rtol=0,
                                       err_msg=f"rank {rank} {mesh} {key}")


@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_pod_layout_attention_matches_jax(pod_runs, mechanism):
    """Ring and Ulysses on {"seq": 4} with positions 2r and 2r + 1 on
    rank r: each rank's two blocks of O and of the gradients of
    sum(O cos O) equal the JAX package's (ATTENTION_ATOL)."""
    results, references = pod_runs
    span = ATTENTION[2] // POD_PROCESSES
    for rank, result in enumerate(results):
        own = slice(rank * span, (rank + 1) * span)
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(
                result[f"{mechanism}/{name}"],
                references[f"{mechanism}/{name}"][:, :, own],
                atol=ATTENTION_ATOL[mechanism], rtol=0,
                err_msg=f"rank {rank} {mechanism} {name}")


@pytest.mark.parametrize("layout", ["pod", "four"])
def test_gloo_jobs_copy_nothing_between_cards(runs, pod_runs, layout):
    """On gloo with CPU entries every exchange lies where its entries
    are: no byte is copied between cards to reach the wire, none staged
    through host memory, in either layout and any arm."""
    results = (pod_runs if layout == "pod" else runs)[0]
    for rank, result in enumerate(results):
        arms = [key for key in result if key.endswith("/copied")]
        assert len(arms) == 4, arms
        for key in arms:
            assert result[key].tolist() == [0, 0], (rank, key)
