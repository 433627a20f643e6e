# Sequence parallelism across processes on the CPU: two OS processes join
# one job over gloo (tests/test_torch_distributed.py's harness), and a
# global mesh's "seq" axis spans them -- alone, {"seq": 2}, or with a
# model axis of two local positions, {"seq": 2, "model": 2}.  Each process
# then holds only its block of the sequence: it embeds, projects and runs
# the FFN on L/2 positions, and the ring's hops (one point-to-point
# ppermute of the K/V blocks each), Ulysses' all_to_alls and the sp
# decode's pmax and psum cross the process boundary.  One pair of workers
# runs every case on the JAX package's random weights (saved by its
# save_pytree, read by the port's load_pytree as each process's blocks);
# the JAX references run in the test process on its CPU devices, the
# JAX package's Pallas kernels in interpret mode.
#
# Tolerances (f32, the SMALL llama of test_torch_distributed.py):
# logits atol/rtol 1e-5 against the JAX package's SP forward on a
# one-process mesh of the same shape and against its dense forward
# (test_torch_sequence_parallel.py's bound); the loss and every gradient
# leaf atol 1e-6 against jax.value_and_grad of the JAX dense loss
# (test_torch_sequence_parallel.py:175), the switch-MoE LM's (4 experts,
# its loss with moe_aux_weight * aux) included; greedy tokens identical;
# remat gradients atol 1e-6 against the same JAX gradients and from the
# same step without remat; the ASR
# gradients atol 1e-6 against jax.value_and_grad of the JAX package's
# make_asr_train_step loss.
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

from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu.models import save_pytree as jax_save_pytree
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu.parallel import create_mesh as jax_create_mesh
from aiko_services_tpu.parallel import filter_specs as jax_filter_specs
from aiko_services_tpu.parallel import shard_pytree as jax_shard_pytree
from aiko_services_tpu_torch.models import load_pytree, optim
from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.parallel import (
    create_mesh, filter_specs, unshard, use_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, max_seq_len=64, dtype="float32")
ASR = dict(n_mels=16, d_model=32, enc_layers=2, dec_layers=2, n_heads=4,
           vocab_size=64, max_frames=32, max_text_len=16, dtype="float32")
LENGTH = 16                   # forward positions: 8 a process
PROMPT, NEW = 16, 8           # generate: the cache's 24 divide by seq 2
MOE = dict(n_experts=4)        # capacity 5 of 16 positions: tokens drop
REMAT = ("everything_saveable", "nothing_saveable", "dots_saveable",
         "dots_with_no_batch_dims_saveable")

# case name -> (axes, sp_mechanism[, n_experts])
FORWARD = {"ring_seq": ({"seq": 2}, "ring"),
           "ulysses_seq": ({"seq": 2}, "ulysses"),
           "ring_seq_model": ({"seq": 2, "model": 2}, "ring"),
           "ulysses_seq_model": ({"seq": 2, "model": 2}, "ulysses")}
TRAIN = {"ring_seq": ({"seq": 2}, "ring", 0),
         "ulysses_seq": ({"seq": 2}, "ulysses", 0),
         "ring_seq_model": ({"seq": 2, "model": 2}, "ring", 0),
         "moe_ring_seq": ({"seq": 2}, "ring", MOE["n_experts"]),
         "moe_ulysses_seq": ({"seq": 2}, "ulysses", MOE["n_experts"])}
DECODE = {"ring_seq": ({"seq": 2}, "ring"),
          "ulysses_seq_model": ({"seq": 2, "model": 2}, "ulysses")}
REMAT_MESHES = {"fsdp": {"fsdp": 2}, "seq": {"seq": 2}}
ASR_MESHES = {"fsdp": {"fsdp": 2}, "model": {"model": 2}}

WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models import asr as asr_model
    from aiko_services_tpu_torch.models import load_pytree, optim
    from aiko_services_tpu_torch.models import transformer as lm
    from aiko_services_tpu_torch.parallel import (
        attention, collectives, filter_specs, global_mesh,
        initialize_distributed, process_index, set_default_devices,
        shutdown_distributed, unshard, use_mesh)
    plan, small, asr, paths, out = json.loads(sys.argv[1])
    assert initialize_distributed(timeout_seconds=200)
    rank = process_index()
    results = {}
    tokens = torch.from_numpy(np.load(paths["tokens"]))
    train_tokens = torch.from_numpy(np.load(paths["train_tokens"]))
    prompt = torch.from_numpy(np.load(paths["prompt"]))

    def flat(tree, prefix):
        if isinstance(tree, dict):
            out = {}
            for key, value in tree.items():
                out.update(flat(value, f"{prefix}/{key}"))
            return out
        return {prefix: unshard(tree).detach().numpy().copy()}

    def mesh_of(axes):
        set_default_devices(["cpu"] * (int(np.prod(list(axes.values())))
                                       // 2))
        mesh = global_mesh(axes)
        assert not mesh.local.all()
        return mesh

    def config(mechanism=None, experts=0):
        if mechanism is None:
            return lm.TransformerConfig(**small)
        return lm.TransformerConfig(**small, sequence_parallel=True,
                                    sp_mechanism=mechanism,
                                    n_experts=experts)

    def weights(mesh, cfg):
        path = paths["moe" if cfg.n_experts else "lm"]
        return load_pytree(path, mesh=mesh, specs=filter_specs(
            lm.param_specs(cfg), mesh))

    def exchanges(mesh):
        return sum(mesh.sequence.values())

    shapes = []
    layer = lm._sharded_layer

    def recorded(call, layer_params, h, *rest):
        shapes.append(sorted({tuple(x.shape) for x in h.flat
                              if x is not None}))
        return layer(call, layer_params, h, *rest)
    lm._sharded_layer = recorded

    for name, (axes, mechanism) in plan["forward"].items():
        mesh = mesh_of(axes)
        cfg = config(mechanism)
        params = weights(mesh, cfg)
        shapes.clear()
        collectives.reset_collective_counts()
        with use_mesh(mesh), torch.no_grad():
            logits = lm.forward(params, cfg, tokens)
        seq = collectives.collective_counts().get("seq", {})
        results[f"forward/{name}/logits"] = logits.numpy()
        results[f"forward/{name}/shapes"] = np.asarray(shapes)
        results[f"forward/{name}/seq"] = np.asarray(
            [seq.get("calls", 0), seq.get("bytes", 0)])

    def loss_of(cfg, remat=None, activation_specs=False):
        def loss_fn(params, tokens):
            logits, aux = lm.forward(params, cfg, tokens[:, :-1],
                                     activation_specs=activation_specs,
                                     remat_policy=remat, return_aux=True)
            return (optim.next_token_loss(logits, tokens[:, 1:])
                    + cfg.moe_aux_weight * aux)
        return loss_fn

    for name, (axes, mechanism, experts) in plan["train"].items():
        mesh = mesh_of(axes)
        cfg = config(mechanism, experts)
        with use_mesh(mesh):
            params = weights(mesh, cfg)
            loss, grads = optim.value_and_grad(loss_of(cfg), params,
                                               train_tokens)
            results[f"train/{name}/loss"] = np.asarray(float(loss))
            results.update(flat(grads, f"train/{name}/grad"))
            optimizer = optim.adam(1e-3)
            state = optimizer.init(params)
            step = lm.make_train_step(cfg, optimizer, sharded=True)
            for _ in range(2):
                params, state, _ = step(params, state, train_tokens)
            results.update(flat(params, f"train/{name}/param"))

    for name, (axes, mechanism) in plan["decode"].items():
        mesh = mesh_of(axes)
        cfg = config(mechanism)
        with use_mesh(mesh):
            generated, _ = lm.generate(weights(mesh, cfg), cfg, prompt,
                                       plan["new"])
        results[f"decode/{name}/tokens"] = generated.numpy()

    # the products (aten.mm / addmm) each remat layer's forward and its
    # backward's recompute run, and whether the forward's ran with
    # autograd: counters entered beneath the policy's contexts see only
    # what those contexts let through (under nothing_saveable no-op
    # contexts themselves, as the policy's are)
    from contextlib import contextmanager, nullcontext
    from torch.utils._python_dispatch import TorchDispatchMode
    products = {"forward": 0, "recompute": 0}
    forward_grad = set()

    class Products(TorchDispatchMode):
        def __init__(self, phase):
            super().__init__()
            self.phase = phase

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                products[self.phase] += 1
                if self.phase == "forward":
                    forward_grad.add(torch.is_grad_enabled())
            return func(*args, **(kwargs or {}))

    class Counted(nullcontext):
        def __init__(self, phase):
            super().__init__()
            self.mode = Products(phase)

        def __enter__(self):
            self.mode.__enter__()

        def __exit__(self, *exc):
            return self.mode.__exit__(*exc)

    resolve = lm.resolve_remat_policy

    def counted_policy(name):
        context_fn = resolve(name)
        if context_fn is None:
            return None

        @contextmanager
        def beneath(phase, inner):
            with Products(phase), inner:
                yield

        def contexts():
            saving, recompute = context_fn()
            if isinstance(saving, nullcontext):
                return Counted("forward"), Counted("recompute")
            return (beneath("forward", saving),
                    beneath("recompute", recompute))
        return contexts
    lm.resolve_remat_policy = counted_policy

    for name, axes in plan["remat"].items():
        mesh = mesh_of(axes)
        cfg = config("ring" if "seq" in axes else None)
        with use_mesh(mesh):
            params = weights(mesh, cfg)
            for policy in ["none", *plan["policies"]]:
                before = exchanges(mesh)
                products.update(forward=0, recompute=0)
                forward_grad.clear()
                _, grads = optim.value_and_grad(
                    loss_of(cfg, policy, activation_specs=True), params,
                    train_tokens)
                results[f"remat/{name}/{policy}/exchanges"] = np.asarray(
                    exchanges(mesh) - before)
                results[f"remat/{name}/{policy}/products"] = np.asarray(
                    [products["forward"], products["recompute"]])
                results[f"remat/{name}/{policy}/forward_grad"] = np.asarray(
                    sorted(forward_grad))
                results.update(flat(grads, f"remat/{name}/{policy}/grad"))
    lm.resolve_remat_policy = resolve

    asr_config = asr_model.AsrConfig(**asr)
    mel = torch.from_numpy(np.load(paths["mel"]))
    text = torch.from_numpy(np.load(paths["text"]))
    for name, axes in plan["asr"].items():
        mesh = mesh_of(axes)
        params = load_pytree(paths["asr"], mesh=mesh, specs=filter_specs(
            asr_model.asr_param_specs(asr_config), mesh))
        adam = optim.adam(1e-3)

        def update(grads, state, params=None, name=name):
            results.update(flat(grads, f"asr/{name}/grad"))
            return adam.update(grads, state, params)
        optimizer = optim.GradientTransformation(adam.init, update)
        step = asr_model.make_asr_train_step(asr_config, optimizer)
        _, _, loss = step(params, optimizer.init(params), mel, text)
        results[f"asr/{name}/loss"] = np.asarray(float(loss))
    np.savez(f"{out}.{rank}.npz", **results)

    # a ring one hop short on rank 1: its next exchange is the next
    # ring's, and both ranks' headers disagree there
    mesh = mesh_of({"seq": 2})
    cfg = config("ring")
    params = weights(mesh, cfg)
    hop = attention.ppermute
    skipped = []

    def short(grid, *arguments, **keywords):
        if rank == 1 and not skipped:
            skipped.append(True)
            return grid
        return hop(grid, *arguments, **keywords)
    attention.ppermute = short
    try:
        with use_mesh(mesh), torch.no_grad():
            lm.forward(params, cfg, tokens)
        print(f"rank {rank} order: no error", flush=True)
    except RuntimeError as error:
        print(f"rank {rank} order: {error}", flush=True)
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


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict of tensors."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, (*path, key))
    else:
        yield path, tree


def _jax_mesh(axes: dict):
    count = int(np.prod(list(axes.values())))
    return jax_create_mesh(axes, devices=jax.devices()[:count])


def _lm_loss(config):
    """make_train_step's loss in the JAX package: next-token
    cross-entropy plus moe_aux_weight * aux (0 for the dense FFN)."""
    def loss_fn(params, tokens):
        logits, aux = jax_lm.forward(params, config, tokens[:, :-1],
                                     return_aux=True)
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            log_probs, tokens[:, 1:, None], axis=-1)[..., 0]) \
            + config.moe_aux_weight * aux
    return loss_fn


def _asr_loss(config):
    """make_asr_train_step's loss in the JAX package."""
    def loss_fn(params, mel, tokens):
        logits = jax_asr.asr_forward(params, config, mel, tokens[:, :-1])
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        taken = jnp.take_along_axis(log_probs, tokens[:, 1:][..., None],
                                    axis=-1, mode="clip")[..., 0]
        return -jnp.mean(taken)
    return loss_fn


def _jax_references(params, moe_params, asr_params, data) -> dict:
    """The JAX package on the same weights and inputs: SP forwards and
    generates on one-process meshes of the workers' shapes, the dense
    forward, and the dense LM's, the MoE LM's and the ASR model's loss's
    value_and_grad."""
    dense = jax_lm.TransformerConfig(**SMALL)
    out = {"dense": np.asarray(jax_lm.forward(params, dense, data["tokens"]))}

    def placed(config, mesh):
        return jax_shard_pytree(params, mesh, jax_filter_specs(
            jax_lm.param_specs(config), mesh))
    for name, (axes, mechanism) in FORWARD.items():
        config = jax_lm.TransformerConfig(**SMALL, sequence_parallel=True,
                                          sp_mechanism=mechanism)
        mesh = _jax_mesh(axes)
        with jax.set_mesh(mesh):
            out[f"forward/{name}"] = np.asarray(jax_lm.forward(
                placed(config, mesh), config, data["tokens"]))
    for name, (axes, mechanism) in DECODE.items():
        config = jax_lm.TransformerConfig(**SMALL, sequence_parallel=True,
                                          sp_mechanism=mechanism)
        mesh = _jax_mesh(axes)
        with jax.set_mesh(mesh):
            cache = jax_shard_pytree(
                jax_lm.init_cache(config, data["prompt"].shape[0],
                                  max_len=PROMPT + NEW), mesh,
                jax_filter_specs(jax_lm.cache_specs(sequence_parallel=True),
                                 mesh))
            generated, _ = jax_lm.generate(placed(config, mesh), config,
                                           data["prompt"], NEW, cache=cache)
        out[f"decode/{name}"] = np.asarray(generated)
    loss, grads = jax.value_and_grad(_lm_loss(dense))(params,
                                                      data["train_tokens"])
    out["loss"] = np.asarray(loss)
    out.update(_flat(grads, "grad"))
    loss, grads = jax.value_and_grad(_lm_loss(jax_lm.TransformerConfig(
        **SMALL, **MOE)))(moe_params, data["train_tokens"])
    out["moe/loss"] = np.asarray(loss)
    out.update(_flat(grads, "moe/grad"))
    asr_config = jax_asr.AsrConfig(**ASR)
    loss, grads = jax.value_and_grad(_asr_loss(asr_config))(
        asr_params, data["mel"], data["text"])
    out["asr/loss"] = np.asarray(loss)
    out.update(_flat(grads, "asr/grad"))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> dict:
    """The seeded inputs, the JAX package's random weights (the dense LM,
    the MoE LM, the ASR model) and the files both packages read them
    from."""
    root = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(15)
    data = {"tokens": rng.integers(0, 128, (2, LENGTH)),
            "train_tokens": rng.integers(0, 128, (2, LENGTH + 1)),
            "prompt": rng.integers(0, 128, (2, PROMPT)),
            "mel": rng.standard_normal((2, ASR["n_mels"], 24)),
            "text": rng.integers(0, ASR["vocab_size"], (2, 9))}
    data = {name: value.astype(np.float32 if name == "mel" else np.int32)
            for name, value in data.items()}
    paths = {"lm": str(root / "lm.safetensors"),
             "moe": str(root / "moe.safetensors"),
             "asr": str(root / "asr.safetensors")}
    for name, value in data.items():
        paths[name] = str(root / f"{name}.npy")
        np.save(paths[name], value)
    params = jax_lm.init_params(jax_lm.TransformerConfig(**SMALL),
                                jax.random.PRNGKey(15))
    moe_params = jax_lm.init_params(jax_lm.TransformerConfig(**SMALL, **MOE),
                                    jax.random.PRNGKey(17))
    asr_params = jax_asr.init_asr_params(jax_asr.AsrConfig(**ASR),
                                         jax.random.PRNGKey(16))
    jax_save_pytree(paths["lm"], params)
    jax_save_pytree(paths["moe"], moe_params)
    jax_save_pytree(paths["asr"], asr_params)
    return {"root": root, "data": data, "paths": paths, "params": params,
            "moe_params": moe_params, "asr_params": asr_params}


@pytest.fixture(scope="module")
def runs(inputs):
    """(each rank's results, each rank's output, the JAX references)."""
    data, paths = inputs["data"], inputs["paths"]
    out = str(inputs["root"] / "out")
    plan = {"forward": FORWARD, "train": TRAIN, "decode": DECODE,
            "new": NEW, "remat": REMAT_MESHES, "policies": REMAT,
            "asr": ASR_MESHES}
    argument = json.dumps([plan, SMALL, ASR, paths, out])
    coordinator = f"127.0.0.1:{_free_port()}"
    workers = []
    for rank in range(2):
        # two threads a worker: the tier-1 run shares the machine's cores
        # between six test processes
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                   AIKO_COORDINATOR=coordinator, AIKO_NUM_PROCESSES="2",
                   AIKO_PROCESS_ID=str(rank))
        workers.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, argument],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    outputs = []
    try:
        # the JAX references run while the workers compute
        references = _jax_references(inputs["params"], inputs["moe_params"],
                                     inputs["asr_params"], data)
        for rank, worker in enumerate(workers):
            output, _ = worker.communicate(timeout=300)
            assert worker.returncode == 0, output
            assert f"rank {rank} done" in output, output
            outputs.append(output)
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
    return ([dict(np.load(f"{out}.{rank}.npz")) for rank in range(2)],
            outputs, references)


@pytest.mark.parametrize("case", list(FORWARD))
def test_sp_forward_across_processes_matches_jax(runs, case):
    """Ring and Ulysses with "seq" across the two processes: both ranks'
    logits equal the JAX package's SP forward on a one-process mesh of
    the same axes and its dense forward (1e-5); every layer's hidden
    state on each process is its (B, L/2, d) block alone; the ring moves
    the K/V blocks once a hop -- one ppermute over "seq" a layer (n = 2),
    with each process's blocks' bytes -- and Ulysses runs two
    all_to_alls a layer."""
    results, _, references = runs
    axes, mechanism = FORWARD[case]
    layers, batch = SMALL["n_layers"], 2
    heads, head_dim = SMALL["n_heads"], SMALL["d_model"] // SMALL["n_heads"]
    for rank, result in enumerate(results):
        logits = result[f"forward/{case}/logits"]
        np.testing.assert_allclose(logits, references[f"forward/{case}"],
                                   err_msg=f"rank {rank} jax sp", **TOL)
        np.testing.assert_allclose(logits, references["dense"],
                                   err_msg=f"rank {rank} jax dense", **TOL)
        np.testing.assert_array_equal(
            result[f"forward/{case}/shapes"],
            [[[batch, LENGTH // 2, SMALL["d_model"]]]] * layers)
        calls, size = result[f"forward/{case}/seq"].tolist()
        if mechanism == "ring":
            # K and V, every head (expanded), this process's half
            assert (calls, size) == (layers, layers * 2 * batch * heads
                                     * (LENGTH // 2) * head_dim * 4), (
                rank, calls, size)
        else:
            assert calls == 2 * layers, (rank, calls)


@pytest.mark.parametrize("case", list(TRAIN))
def test_sp_train_step_across_processes_matches_jax_gradients(runs, case):
    """The SP loss and every gradient leaf on both ranks equal
    jax.value_and_grad of the JAX package's loss on the whole sequence
    (1e-6): each process's backward carries its block's cotangents, the
    ring's second ring returns dK/dV home across the processes, and the
    whole parameters sum the processes' shares.  The MoE cases' FFN runs
    on the row gathered over "seq" (capacity counted along the whole
    row, tokens dropped past it), their aux loss counted once.  After two
    adam(1e-3) steps the ranks' parameters are bit for bit equal."""
    results, _, references = runs
    reference = "moe/" if TRAIN[case][2] else ""
    keys = [key for key in references if key.startswith(reference + "grad/")]
    assert keys
    for rank, result in enumerate(results):
        np.testing.assert_allclose(result[f"train/{case}/loss"],
                                   references[reference + "loss"], atol=1e-6,
                                   rtol=0)
        for key in keys:
            np.testing.assert_allclose(
                result[f"train/{case}/{key[len(reference):]}"],
                references[key], atol=1e-6, rtol=0,
                err_msg=f"rank {rank} {key}")
    params = [key for key in results[0]
              if key.startswith(f"train/{case}/param/")]
    assert params
    for key in params:
        np.testing.assert_array_equal(results[0][key], results[1][key],
                                      err_msg=key)


@pytest.mark.parametrize("case", list(DECODE))
def test_sp_generate_across_processes_equals_jax(runs, case):
    """SP cached prefill (the ring or Ulysses at pos 0, each process
    writing its cache window) and sp decode (one pmax and one psum over
    "seq" across the processes) give the JAX package's SP generate
    tokens on a one-process mesh of the same axes, on both ranks."""
    results, _, references = runs
    for rank, result in enumerate(results):
        np.testing.assert_array_equal(result[f"decode/{case}/tokens"],
                                      references[f"decode/{case}"],
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("policy", REMAT)
@pytest.mark.parametrize("mesh", list(REMAT_MESHES))
def test_remat_across_processes_gives_the_gradients_of_no_remat(
        runs, mesh, policy):
    """A remat policy on a mesh over the two processes ({"fsdp": 2}, and
    {"seq": 2} through the ring): every gradient leaf, with the policy
    and without remat, equals jax.value_and_grad of the JAX package's
    loss on the same weights and tokens (1e-6), and the policy's equals
    the same loss's without remat (1e-6); both ranks ran the same number
    of exchanges -- more than without remat where a layer is recomputed
    (its forward collectives run again inside the backward), as many
    under everything_saveable, which recomputes nothing.  The recompute
    runs the products the policy does not save: none under the dots
    policies, every one of the forward's under nothing_saveable; the
    forward runs with autograd only where the policy's contexts pair its
    operations with the recompute's (the dots policies), and holds no
    graph under nothing_saveable."""
    results, _, references = runs
    prefix, base = f"remat/{mesh}/{policy}/", f"remat/{mesh}/none/"
    keys = [key for key in references if key.startswith("grad/")]
    assert keys
    for rank, result in enumerate(results):
        for key in keys:
            for run in (base, prefix):
                np.testing.assert_allclose(
                    result[run + key], references[key], atol=1e-6, rtol=0,
                    err_msg=f"rank {rank} {run}{key} vs jax")
            np.testing.assert_allclose(
                result[prefix + key], result[base + key], atol=1e-6,
                rtol=0, err_msg=f"rank {rank} {key}")
        forward, recompute = result[prefix + "products"].tolist()
        if policy == "everything_saveable":
            assert (result[prefix + "exchanges"]
                    == result[base + "exchanges"])
            assert (forward, recompute) == (0, 0), (rank, forward)
            continue
        assert result[prefix + "exchanges"] > result[base + "exchanges"]
        assert forward > 0, (rank, policy)
        assert recompute == (forward if policy == "nothing_saveable"
                             else 0), (rank, policy, forward, recompute)
        assert (result[prefix + "forward_grad"].tolist()
                == [policy != "nothing_saveable"]), (rank, policy)
    assert (results[0][prefix + "exchanges"]
            == results[1][prefix + "exchanges"])


@pytest.mark.parametrize("mechanism", ["ring", "ulysses"])
def test_sp_moe_loss_on_one_process_matches_jax_gradients(inputs, runs,
                                                          mechanism):
    """The MoE LM through the seq-cut sharded path on a one-process
    {"seq": 2} mesh (activation_specs: each position embeds its block;
    the FFN on the row gathered over "seq", each position keeping its
    block's outputs): the loss with moe_aux_weight * aux and every
    gradient leaf equal jax.value_and_grad of the JAX package's loss
    (1e-6), as across the processes."""
    _, _, references = runs
    config = torch_lm.TransformerConfig(**SMALL, **MOE,
                                        sequence_parallel=True,
                                        sp_mechanism=mechanism)
    mesh = create_mesh({"seq": 2}, devices=["cpu"] * 2)
    params = load_pytree(inputs["paths"]["moe"], mesh=mesh,
                         specs=filter_specs(torch_lm.param_specs(config),
                                            mesh))

    def loss_fn(params, tokens):
        logits, aux = torch_lm.forward(params, config, tokens[:, :-1],
                                       activation_specs=True,
                                       return_aux=True)
        return (optim.next_token_loss(logits, tokens[:, 1:])
                + config.moe_aux_weight * aux)
    with use_mesh(mesh):
        loss, grads = optim.value_and_grad(loss_fn, params, torch.from_numpy(
            inputs["data"]["train_tokens"]))
    np.testing.assert_allclose(float(loss), references["moe/loss"],
                               atol=1e-6, rtol=0)
    got = {"moe/grad" + "".join(f"/{key}" for key in path): leaf
           for path, leaf in _leaves(grads)}
    keys = [key for key in references if key.startswith("moe/grad/")]
    assert sorted(got) == sorted(keys)
    for key in keys:
        np.testing.assert_allclose(unshard(got[key]).detach().numpy(),
                                   references[key], atol=1e-6, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("mesh", list(ASR_MESHES))
def test_asr_train_step_across_processes_matches_jax(runs, mesh):
    """make_asr_train_step on whisper-shaped weights placed by
    asr_param_specs over a mesh across the two processes: the loss and
    the gradients it hands its optimizer, every leaf, equal
    jax.value_and_grad of the JAX package's make_asr_train_step loss
    (1e-6), on both ranks."""
    results, _, references = runs
    keys = [key for key in references if key.startswith("asr/grad/")]
    assert keys
    for rank, result in enumerate(results):
        np.testing.assert_allclose(result[f"asr/{mesh}/loss"],
                                   references["asr/loss"], atol=1e-6, rtol=0)
        for key in keys:
            np.testing.assert_allclose(
                result[f"asr/{mesh}/grad/" + key[len("asr/grad/"):]],
                references[key], atol=1e-6, rtol=0,
                err_msg=f"rank {rank} {key}")


def test_a_ring_hop_out_of_step_raises_on_both_ranks(runs):
    """Rank 1's ring skips its first hop: the next exchange of each rank
    belongs to a different call (the ring's call number is in the
    checked tag), so both ranks raise "out of step" at once -- neither
    hangs nor pairs the wrong blocks."""
    _, outputs, _ = runs
    for rank, output in enumerate(outputs):
        assert (f"rank {rank} order: cross-process collectives out of step"
                in output), output
