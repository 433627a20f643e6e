# The port's LM (models/transformer.py) against the JAX package's on the
# CPU, on the same weights: the JAX package's random parameters go through
# numpy into the port (models/bridge.py), the same numpy tokens go into
# both.  f32 throughout, at the JAX package's own test config.
#
# Tolerances: logits atol 1e-5 (two f32 transformer layers summed in
# another order); the loss atol 1e-6 and every gradient leaf atol 1e-6 on
# values of order 1e-2 (f32 rounding of the same sums); parameters after
# three adamw(1e-3) steps atol 5e-5: Adam divides each gradient by its own
# running magnitude, so an f32 rounding difference in a gradient near its
# noise floor moves that entry by up to a fraction of the learning rate.

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu_torch.models import (
    optim, params_from_numpy, params_to_numpy)
from aiko_services_tpu_torch.models import transformer as torch_lm

CONFIG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32")


@pytest.fixture(scope="module")
def lm():
    """(jax config, jax params, port config, numpy params, tokens)."""
    jax_config = jax_lm.TransformerConfig(**CONFIG)
    jax_params = jax_lm.init_params(jax_config, jax.random.PRNGKey(0))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 17)).astype(
        np.int32)
    return (jax_config, jax_params, torch_lm.TransformerConfig(**CONFIG),
            numpy_params, tokens)


def _port_params(numpy_params):
    return params_from_numpy(numpy_params, device="cpu")


def _pairs(jax_tree, torch_tree):
    """(path, jax leaf, port leaf) for every leaf of the JAX tree."""
    torch_numpy = params_to_numpy(torch_tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        node = torch_numpy
        for key in path:
            node = node[key.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), node


def test_forward_logits_match_jax(lm):
    jax_config, jax_params, torch_config, numpy_params, tokens = lm
    expected = np.asarray(jax_lm.forward(jax_params, jax_config, tokens))
    actual = torch_lm.forward(_port_params(numpy_params), torch_config,
                              torch.from_numpy(tokens))
    assert actual.shape == (2, 17, 256) and actual.dtype == torch.float32
    np.testing.assert_allclose(actual.detach().numpy(), expected, atol=1e-5,
                               rtol=0)


def test_loss_and_every_gradient_leaf_match_jax(lm):
    jax_config, jax_params, torch_config, numpy_params, tokens = lm

    def jax_loss(params, tokens):
        logits = jax_lm.forward(params, jax_config, tokens[:, :-1])
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            log_probs, tokens[:, 1:, None], axis=-1)[..., 0])

    def torch_loss(params, tokens):
        logits = torch_lm.forward(params, torch_config, tokens[:, :-1])
        return optim.next_token_loss(logits, tokens[:, 1:])

    expected_loss, expected_grads = jax.value_and_grad(jax_loss)(
        jax_params, tokens)
    loss, grads = optim.value_and_grad(torch_loss,
                                       _port_params(numpy_params),
                                       torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(expected_loss), atol=1e-6,
                               rtol=0)
    leaves = list(_pairs(expected_grads, grads))
    assert len(leaves) == 11
    for name, expected, actual in leaves:
        np.testing.assert_allclose(actual, expected, atol=1e-6, rtol=0,
                                   err_msg=name)


def test_three_adamw_steps_match_optax(lm):
    jax_config, jax_params, torch_config, numpy_params, tokens = lm
    jax_optimizer = optax.adamw(1e-3)
    jax_step = jax_lm.make_train_step(jax_config, jax_optimizer)
    expected, jax_state = jax_params, jax_optimizer.init(jax_params)
    optimizer = optim.adamw(1e-3)
    params = _port_params(numpy_params)
    state = optimizer.init(params)
    step = torch_lm.make_train_step(torch_config, optimizer)
    for _ in range(3):
        expected, jax_state, expected_loss = jax_step(expected, jax_state,
                                                      tokens)
        params, state, loss = step(params, state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(expected_loss),
                                   atol=1e-5, rtol=0)
    for name, want, got in _pairs(expected, params):
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0,
                                   err_msg=name)


def test_train_step_reduces_loss(lm):
    _, _, torch_config, numpy_params, _ = lm
    params = torch_lm.init_params(torch_config,
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    optimizer = optim.adam(1e-2)
    state = optimizer.init(params)
    step = torch_lm.make_train_step(torch_config, optimizer)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 16)).astype(np.int32))
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_remat_policies_give_bit_identical_losses(lm):
    _, _, torch_config, numpy_params, _ = lm
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 17)).astype(np.int32))
    losses = {}
    for policy in torch_lm.REMAT_POLICIES:
        params = _port_params(numpy_params)
        optimizer = optim.adamw(1e-3)
        state = optimizer.init(params)
        step = torch_lm.make_train_step(torch_config, optimizer,
                                        remat_policy=policy)
        trail = []
        for _ in range(3):
            params, state, loss = step(params, state, tokens)
            trail.append(loss.item())
        losses[policy] = trail
    assert len(losses) == 5
    for policy, trail in losses.items():
        assert trail == losses["none"], policy


def test_unknown_remat_policy_fails_fast(lm):
    torch_config = lm[2]
    with pytest.raises(ValueError, match="remat_policy"):
        torch_lm.make_train_step(torch_config, optim.adam(1e-3),
                                 remat_policy="dots_savable")
    assert "nothing_saveable" in torch_lm.REMAT_POLICIES


def test_init_params_tree_matches_jax_and_is_seeded(lm):
    _, jax_params, torch_config, _, _ = lm
    first = torch_lm.init_params(torch_config,
                                 torch.Generator().manual_seed(3),
                                 device="cpu")
    again = torch_lm.init_params(torch_config,
                                 torch.Generator().manual_seed(3),
                                 device="cpu")
    for name, want, got in _pairs(jax_params, first):
        assert got.shape == want.shape and got.dtype == want.dtype, name
    assert torch.equal(first["layers"]["wq"]["w"], again["layers"]["wq"]["w"])
    assert torch_lm.count_params(first) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(jax_params))


def test_constructors_default_to_cuda():
    from aiko_services_tpu_torch.models import (
        asr, layers, load_llama_params, load_pytree, load_whisper_params,
        tts, yolo)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    asset = (pathlib.Path(__file__).parent / "assets"
             / "asr_tones.safetensors")
    constructors = {
        "init_params": lambda: torch_lm.init_params(
            torch_lm.TransformerConfig(**CONFIG), torch.Generator()),
        "init_asr_params": lambda: asr.init_asr_params(
            asr.AsrConfig(d_model=32, n_heads=2, vocab_size=64,
                          dtype="float32"), torch.Generator()),
        "params_from_numpy": lambda: params_from_numpy(
            {"w": np.zeros(3, np.float32)}),
        "load_pytree": lambda: load_pytree(asset),
        "init_yolo_params": lambda: yolo.init_yolo_params(
            yolo.YOLOV8N, torch.Generator()),
        "load_yolov8_params": lambda: yolo.load_yolov8_params(
            asset, yolo.YOLOV8N),
        "init_tts_params": lambda: tts.init_tts_params(
            tts.TTSConfig(d_model=32), torch.Generator()),
        "load_llama_params": lambda: load_llama_params(
            asset, torch_lm.TransformerConfig(**CONFIG)),
        "load_whisper_params": lambda: load_whisper_params(
            asset, asr.AsrConfig(d_model=32, n_heads=2)),
    }
    for name, construct in constructors.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            construct()
    with pytest.raises(TypeError, match="device"):
        layers.init_dense(torch.Generator(), 2, 3)
    with pytest.raises(TypeError, match="device"):
        layers.init_norm(3)


def _sp_mesh(axes: dict):
    from aiko_services_tpu_torch.parallel import create_mesh
    return create_mesh(axes, devices=["cpu"] * int(np.prod(
        list(axes.values()))))


def _moe_trains(tmp_path) -> None:
    """A switch-MoE config trains (aux loss in the step) and generates;
    tests/test_torch_moe.py holds it against the JAX package."""
    config = torch_lm.TransformerConfig(**CONFIG, n_experts=4)
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    assert tuple(params["layers"]["w_gate"]["w"].shape) == (2, 4, 64, 128)
    optimizer = optim.adam(1e-2)
    state = optimizer.init(params)
    step = torch_lm.make_train_step(config, optimizer)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 16)).astype(np.int32))
    losses = []
    for _ in range(4):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    out, _ = torch_lm.generate(params, config, tokens[:, :5], 3)
    assert tuple(out.shape) == (4, 3)


def _ultralytics_detector_runs(tmp_path) -> None:
    """The Detector reads an ultralytics-named checkpoint's architecture
    off its shapes and detects; tests/test_torch_yolo.py holds it against
    the JAX package."""
    import queue
    from aiko_services_tpu_torch.models import yolo
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    from test_torch_yolo import TINY, write_ultralytics_yolo
    path = tmp_path / "yolo.safetensors"
    write_ultralytics_yolo(path, yolo.YoloV8Config(**TINY))
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, {
            "name": "ported",
            "graph": ["(node)"],
            "parameters": {"device": "cpu"},
            "elements": [
                {"name": "node", "input": [{"name": "image"}],
                 "output": [{"name": "detections"}],
                 "parameters": {"weights": str(path), "image_size": 64,
                                "max_detections": 8, "dtype": "float32"},
                 "deploy": {"local": {
                     "module": "aiko_services_tpu_torch.elements",
                     "class_name": "Detector"}}}],
        })
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s", queue_response=responses)
        pipeline.create_frame(stream, {"image": np.zeros(
            (1, 3, 64, 64), np.float32)})
        _, _, outputs = responses.get(timeout=60)
    finally:
        process.terminate()
    assert tuple(outputs["detections"]["boxes"].shape) == (1, 8, 4)


def _sequence_parallel_trains(tmp_path) -> None:
    """A sequence-parallel config trains through the ring on a seq mesh;
    tests/test_torch_sequence_parallel.py holds it against the JAX
    package."""
    from aiko_services_tpu_torch.parallel import use_mesh
    config = torch_lm.TransformerConfig(**CONFIG, sequence_parallel=True)
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    optimizer = optim.adam(1e-2)
    state = optimizer.init(params)
    step = torch_lm.make_train_step(config, optimizer)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 17)).astype(np.int32))
    losses = []
    with use_mesh(_sp_mesh({"seq": 4})):
        for _ in range(3):
            params, state, loss = step(params, state, tokens)
            losses.append(float(loss))
    assert losses[-1] < losses[0]


def _tp_fsdp_params(config):
    """llama-style params and the same cut by param_specs over data 2 x
    fsdp 2 x model 2; tests/test_torch_sharding.py holds the sharded
    paths against the JAX package."""
    from aiko_services_tpu_torch.parallel import (
        filter_specs, shard_pytree)
    mesh = _sp_mesh({"data": 2, "fsdp": 2, "model": 2})
    whole = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                 device="cpu")
    sharded = shard_pytree(torch_lm.init_params(
        config, torch.Generator().manual_seed(0), device="cpu"), mesh,
        filter_specs(torch_lm.param_specs(config), mesh))
    return whole, sharded, mesh


def _activation_specs_run(tmp_path) -> None:
    """forward(activation_specs=True) splits the batch over the ambient
    mesh's data axis and gives the unsharded logits."""
    from aiko_services_tpu_torch.parallel import use_mesh
    config = torch_lm.TransformerConfig(**CONFIG)
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 16)).astype(np.int32))
    whole = torch_lm.forward(params, config, tokens)
    with use_mesh(_sp_mesh({"data": 2, "model": 2})):
        split = torch_lm.forward(params, config, tokens,
                                 activation_specs=True)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), atol=1e-5)


def _sharded_train_step_runs(tmp_path) -> None:
    """make_train_step(sharded=True) trains a tree cut by param_specs
    where it lies, step for step as the unsharded tree trains."""
    config = torch_lm.TransformerConfig(**CONFIG)
    whole, sharded, _ = _tp_fsdp_params(config)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 16)).astype(np.int32))
    optimizer = optim.adam(1e-3)
    losses = {}
    for name, params, sharded_step in (("whole", whole, False),
                                       ("sharded", sharded, True)):
        state = optimizer.init(params)
        step = torch_lm.make_train_step(config, optimizer,
                                        sharded=sharded_step)
        losses[name] = []
        for _ in range(3):
            params, state, loss = step(params, state, tokens)
            losses[name].append(float(loss))
    assert losses["sharded"][-1] < losses["sharded"][0]
    np.testing.assert_allclose(losses["sharded"], losses["whole"],
                               atol=1e-5)


def _sequence_parallel_with_model_axis_runs(tmp_path) -> None:
    """Sequence parallelism composes with tensor parallelism, as
    examples/pipeline_longcontext.json asks: the ring over each model
    shard's heads on seq 2 x model 2 gives the dense logits."""
    from aiko_services_tpu_torch.parallel import (
        filter_specs, shard_pytree, use_mesh)
    config = torch_lm.TransformerConfig(**CONFIG)
    sp_config = torch_lm.TransformerConfig(**CONFIG, sequence_parallel=True)
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 16)).astype(np.int32))
    mesh = _sp_mesh({"seq": 2, "model": 2})
    sharded = shard_pytree(params, mesh, filter_specs(
        torch_lm.param_specs(config), mesh))
    with use_mesh(mesh):
        ringed = torch_lm.forward(sharded, sp_config, tokens)
    np.testing.assert_allclose(
        ringed.numpy(), torch_lm.forward(params, config, tokens).numpy(),
        atol=2e-3, rtol=2e-3)


# options the port once refused and now runs, under the ids of the
# refusal cases they replace
PORTED = {
    "activation_specs": _activation_specs_run,
    "sharded_train_step": _sharded_train_step_runs,
    "sequence_parallel_with_model_axis":
        _sequence_parallel_with_model_axis_runs,
    "n_experts": _moe_trains,
    "sequence_parallel": _sequence_parallel_trains,
    "ultralytics_detector_weights": _ultralytics_detector_runs,
}


@pytest.mark.parametrize("option", sorted(PORTED))
def test_formerly_unported_options_run(option, tmp_path):
    PORTED[option](tmp_path)


def test_dense_reduces_bf16_products_in_f32(monkeypatch):
    """During a bf16 dense (and the cached attention's bf16 P·V) cuBLAS
    may not reduce in bf16: the flag is off inside the product and
    restored after."""
    from aiko_services_tpu_torch.models import layers
    seen = []
    matmul = torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction)
        return matmul(a, b)

    before = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    monkeypatch.setattr(torch, "matmul", spy)
    x = torch.ones((2, 8), dtype=torch.bfloat16)
    w = torch.ones((8, 4), dtype=torch.bfloat16)
    assert torch.equal(layers.dense({"w": w}, x),
                       torch.full((2, 4), 8.0, dtype=torch.bfloat16))
    assert seen == [False]
    assert (torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction == before)
    config = torch_lm.TransformerConfig(**{**CONFIG, "dtype": "bfloat16"})
    q = torch.ones((1, config.n_heads, 1, config.head_dim),
                   dtype=torch.bfloat16)
    kv = torch.ones((1, config.n_kv_heads, 3, config.head_dim),
                    dtype=torch.bfloat16)
    seen.clear()
    torch_lm._masked_attention(config, q, kv, kv, torch.tensor([[2]]),
                               torch.arange(3)[None])
    assert seen == [True, False]    # q·kᵀ in f32, then the bf16 P·V


@pytest.mark.parametrize("guard", ["f32_reduction", "full_f32_convolution"])
def test_precision_guards_hold_across_threads(guard):
    """Two threads' scopes overlap (two engines on one card): the flag
    stays off until the LAST scope closes, then the previous setting
    comes back -- one thread's exit never turns it on under the other's
    product."""
    import threading
    from aiko_services_tpu_torch.models import layers
    from aiko_services_tpu_torch.ops import audio
    scope, read, write = {
        "f32_reduction": (
            layers.f32_reduction,
            lambda: torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction,
            lambda value: setattr(torch.backends.cuda.matmul,
                                  "allow_bf16_reduced_precision_reduction",
                                  value)),
        "full_f32_convolution": (
            audio.full_f32_convolution,
            lambda: torch.backends.cudnn.allow_tf32,
            lambda value: setattr(torch.backends.cudnn, "allow_tf32",
                                  value))}[guard]
    before = read()
    write(True)
    try:
        entered, leave = threading.Event(), threading.Event()

        def other():
            with scope():
                entered.set()
                leave.wait(timeout=30)

        thread = threading.Thread(target=other)
        with scope():
            thread.start()
            assert entered.wait(timeout=30)
        # this thread's scope closed first: the other's is still open
        assert read() is False
        leave.set()
        thread.join(timeout=30)
        assert not thread.is_alive() and read() is True
        # stress: more threads than cores, switching often; inside any
        # scope the flag must read off, whatever the others do
        import sys
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        violations = []

        def churn():
            for _ in range(200):
                with scope():
                    if read() is not False:
                        violations.append(1)

        threads = [threading.Thread(target=churn) for _ in range(16)]
        try:
            for worker in threads:
                worker.start()
            for worker in threads:
                worker.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(worker.is_alive() for worker in threads)
        assert violations == [] and read() is True
    finally:
        write(before)
