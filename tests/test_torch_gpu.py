# The port's CUDA kernels against their plain PyTorch versions, on the
# card.  Every test here needs an NVIDIA GPU and nvcc: it is marked `gpu`
# and skips, with its reason, where there is none.  This file imports no
# JAX, so it also runs where only PyTorch is installed:
#
#   python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
#
# Tolerances: bf16 outputs are compared with atol/rtol 2e-2 (one bf16
# rounding of values of order 1, the forward's rounding of P to bf16
# before P.V, plus f32 sums taken in another order);
# f32 outputs with atol 1e-5; the f32 logsumexp with atol 1e-4 (a log of
# a sum of up to 300 terms, summed in another order).  Gradients: bf16
# per-tensor relative error ||g - g_ref|| / ||g_ref|| <= 2e-2 (the
# tensor-core kernels round P and dS to bf16 before the second product
# and each gradient once more, 2^-9 relative each, and sum up to 1024 f32
# terms in another order); f32 atol 1e-4 (sums of up to 251 f32 products
# of order 1 in another order).

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.ops import kernels
from aiko_services_tpu_torch.parallel.attention import (
    flash_attention, flash_attention_backward,
    flash_attention_backward_plain, flash_attention_forward,
    flash_attention_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _qkv(shape_q, shape_k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q, dtype=np.float32)
    k = rng.standard_normal(shape_k, dtype=np.float32)
    v = rng.standard_normal(shape_k, dtype=np.float32)
    return [torch.from_numpy(x).to(device=device, dtype=dtype)
            for x in (q, k, v)]


CASES = {
    # name: (B, H, Lq, Lk, D, dtype, causal, q_offset)
    "encoder_bf16": (4, 12, 251, 251, 64, torch.bfloat16, False, 0),
    "causal_300": (2, 4, 300, 300, 64, torch.bfloat16, True, 0),
    "causal_decode_offset": (2, 4, 37, 251, 64, torch.bfloat16, True, 0),
    "cross_37x251": (2, 4, 37, 251, 64, torch.bfloat16, False, 0),
    "asr_tones_f32": (4, 4, 12, 12, 16, torch.float32, False, 0),
    "f32_causal_q_offset": (2, 3, 50, 130, 32, torch.float32, True, -7),
    "f32_d128_ragged": (1, 2, 65, 129, 128, torch.float32, False, 0),
    "lm_training_bf16": (1, 4, 1024, 1024, 64, torch.bfloat16, True, 0),
    "d16_causal_bf16": (2, 4, 200, 200, 16, torch.bfloat16, True, 0),
    "d32_causal_bf16": (2, 4, 300, 300, 32, torch.bfloat16, True, 0),
    "d128_causal_bf16": (1, 4, 520, 520, 128, torch.bfloat16, True, 0),
    "ragged_65x129_d128_bf16": (1, 2, 65, 129, 128, torch.bfloat16, False,
                                0),
    "causal_q_offset_bf16": (2, 3, 50, 130, 32, torch.bfloat16, True, -7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    batch, heads, q_len, k_len, dim, dtype, causal, q_offset = CASES[case]
    q, k, v = _qkv((batch, heads, q_len, dim), (batch, heads, k_len, dim),
                   dtype, cuda)
    before = kernels.launch_counts["flash_attention"]
    out, lse = flash_attention_forward(q, k, v, causal=causal,
                                       q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention"] == before + 1
    ref_out, ref_lse = flash_attention_plain(
        q.float(), k.float(), v.float(), causal=causal, q_offset=q_offset)
    assert out.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref_out, atol=2e-2,
                                   rtol=2e-2)
    else:
        torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 8, 48), (1, 2, 8, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_forward(q, k, v)
    q, k, v = _qkv((1, 2, 8, 16), (1, 2, 8, 16), torch.float16, cuda)
    with pytest.raises(TypeError, match="float32 or"):
        flash_attention_forward(q, k, v)
    q, k, v = _qkv((1, 8, 2, 16), (1, 8, 2, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_forward(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2))
    # the bf16 kernel copies 16-byte chunks: a tensor starting 2 bytes in
    # is refused
    q, k, v = _qkv((1, 2, 8, 16), (1, 2, 8, 16), torch.bfloat16, cuda)
    shifted = torch.empty(q.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_forward(shifted, k, v)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_forward(q, k, shifted)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_kernel_is_bitwise_repeatable(cuda, dtype):
    """Each output tile has one owner block and no atomics: two launches
    on the same inputs give the same bits."""
    q, k, v = _qkv((2, 4, 300, 64), (2, 4, 300, 64), dtype, cuda, seed=5)
    first = flash_attention_forward(q, k, v, causal=True)
    second = flash_attention_forward(q, k, v, causal=True)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("out", "lse")):
        assert torch.equal(a, b), name


BACKWARD_CASES = {
    # name: (B, H, Lq, Lk, D, dtype, causal, q_offset)
    "lm_training_bf16": (1, 4, 1024, 1024, 64, torch.bfloat16, True, 0),
    "encoder_bf16": (2, 4, 251, 251, 64, torch.bfloat16, False, 0),
    "cross_16x251_bf16": (2, 4, 16, 251, 64, torch.bfloat16, False, 0),
    "causal_37x251_bf16": (2, 4, 37, 251, 64, torch.bfloat16, True, 0),
    "d16_causal_bf16": (2, 4, 200, 200, 16, torch.bfloat16, True, 0),
    "d32_causal_bf16": (2, 4, 300, 300, 32, torch.bfloat16, True, 0),
    "d128_causal_bf16": (1, 4, 520, 520, 128, torch.bfloat16, True, 0),
    "ragged_65x129_d128_bf16": (1, 2, 65, 129, 128, torch.bfloat16, False,
                                0),
    "causal_q_offset_bf16": (2, 3, 50, 130, 32, torch.bfloat16, True, -7),
    "f32_causal_q_offset": (2, 3, 50, 130, 32, torch.float32, True, -7),
    "f32_d128_ragged": (1, 2, 65, 129, 128, torch.float32, False, 0),
    "asr_tones_f32": (4, 4, 12, 12, 16, torch.float32, False, 0),
}


def _relative_error(actual, expected):
    return ((actual.float() - expected).norm() / expected.norm()).item()


@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_backward_kernels_match_plain(cuda, case):
    batch, heads, q_len, k_len, dim, dtype, causal, q_offset = (
        BACKWARD_CASES[case])
    q, k, v = _qkv((batch, heads, q_len, dim), (batch, heads, k_len, dim),
                   dtype, cuda, seed=1)
    dout = _qkv((batch, heads, q_len, dim), (batch, heads, 1, dim), dtype,
                cuda, seed=2)[0]
    out, lse = flash_attention_forward(q, k, v, causal=causal,
                                       q_offset=q_offset)
    before = dict(kernels.launch_counts)
    grads = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention_dq"] == (
        before["flash_attention_dq"] + 1)
    assert kernels.launch_counts["flash_attention_dkv"] == (
        before["flash_attention_dkv"] + 1)
    expected = flash_attention_backward_plain(
        q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
        causal=causal, q_offset=q_offset)
    for got, want, name in zip(grads, expected, ("dq", "dk", "dv")):
        assert got.dtype == dtype and got.shape == want.shape, name
        if dtype == torch.bfloat16:
            assert _relative_error(got, want) <= 2e-2, name
        else:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0,
                                       msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_are_bitwise_repeatable(cuda, dtype):
    """Each output tile has one owner block and no atomics: two launches
    on the same inputs give the same bits."""
    q, k, v = _qkv((2, 4, 300, 64), (2, 4, 300, 64), dtype, cuda, seed=3)
    dout = _qkv((2, 4, 300, 64), (2, 4, 1, 64), dtype, cuda, seed=4)[0]
    out, lse = flash_attention_forward(q, k, v, causal=True)
    first = flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    second = flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


def test_flash_attention_carries_a_gradient_on_cuda(cuda):
    q, k, v = [tensor.requires_grad_(True) for tensor in _qkv(
        (1, 2, 40, 64), (1, 2, 40, 64), torch.bfloat16, cuda)]
    before = dict(kernels.launch_counts)
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    # the cotangent arrives transposed, as from the model's head merge
    out.transpose(1, 2).sum().backward()
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    assert all(tensor.grad is not None and torch.isfinite(tensor.grad).all()
               for tensor in (q, k, v))


def test_backward_wrappers_reject_what_they_do_not_take(cuda):
    q, k, v = _qkv((1, 2, 8, 16), (1, 2, 8, 16), torch.float32, cuda)
    out, lse = flash_attention_forward(q, k, v)
    dout = torch.ones_like(q)
    with pytest.raises(ValueError, match="dout must be contiguous"):
        flash_attention_backward(q, k, v, out, lse,
                                 dout.transpose(2, 3).contiguous()
                                 .transpose(2, 3))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward(q, k, v, out, lse.double(), dout)
    with pytest.raises(ValueError, match="does not match q"):
        flash_attention_backward(q, k, v, out, lse, dout.bfloat16())
    q48, k48, v48 = _qkv((1, 2, 8, 48), (1, 2, 8, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_backward(q48, k48, v48, q48, lse, q48)
    # the bf16 kernels copy 16-byte chunks: a tensor starting 2 bytes in
    # is refused
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(qb.shape)
    shifted.copy_(qb)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_backward(shifted, kb, vb, out.bfloat16(), lse,
                                 qb)


# -- the config-5 serving path on the card -----------------------------------

def test_generate_on_cuda_equals_the_cpu_at_f32(cuda):
    """Greedy tokens of a small f32 LM on the card (the cached prefill
    and decode in f32 matmuls, TF32 off) equal the CPU's on the same
    weights and prompts."""
    from aiko_services_tpu_torch.models import (
        LM_TOY, generate, init_params)
    from aiko_services_tpu_torch.utils.tree import tree_map
    config = LM_TOY
    params = init_params(config, torch.Generator().manual_seed(0),
                         device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        3, config.vocab_size, (4, 12)).astype(np.int32))
    expected, _ = generate(params, config, prompt, 10)
    on_card = tree_map(lambda leaf: leaf.to(cuda), params)
    actual, cache = generate(on_card, config, prompt.to(cuda), 10)
    assert cache["k"].is_cuda and actual.dtype == torch.int32
    assert torch.equal(actual.cpu(), expected)


def test_detector_on_cuda_finds_the_checkpoints_square(cuda):
    import ast
    import pathlib
    from aiko_services_tpu_torch.models import (
        DetectorConfig, SafetensorsFile, detect, load_pytree)
    asset = (pathlib.Path(__file__).parent / "assets"
             / "detector_shapes.safetensors")
    container = SafetensorsFile(asset)
    metadata = {key: ast.literal_eval(value)
                for key, value in container.metadata.items()}
    container.close()
    config = DetectorConfig(**metadata["config"])
    params = load_pytree(asset, dtype=config.dtype, device=cuda)
    colors = np.asarray(metadata["colors"], np.float32)
    rng = np.random.default_rng(1030)
    image = rng.uniform(0.0, 0.25, (3, 64, 64)).astype(np.float32)
    image[:, 12:28, 30:46] = colors[1][:, None, None] * 0.9
    detections = detect(params, config, torch.from_numpy(image)[None].to(
        cuda))
    valid = detections["valid"][0].cpu().numpy()
    assert valid.sum() == 1
    slot = int(np.argmax(valid))
    assert int(detections["classes"][0, slot]) == 1
    x0, y0, x1, y1 = detections["boxes"][0, slot].cpu().tolist()
    inter = max(0.0, min(x1, 46) - max(x0, 30)) * max(
        0.0, min(y1, 28) - max(y0, 12))
    union = (x1 - x0) * (y1 - y0) + 16 * 16 - inter
    assert inter / union >= 0.5


def test_multimodal_source_on_device_yields_cuda_tensors(cuda):
    import queue
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    definition = {
        "name": "sources",
        "graph": ["(sources)"],
        "parameters": {"device": "cuda"},
        "elements": [
            {"name": "sources",
             "output": [{"name": "audio", "type": "f32[b,8000]"},
                        {"name": "image", "type": "f32[b,3,64,64]"}],
             "parameters": {"data_sources": [[440, 0.5]],
                            "image_shape": [3, 64, 64],
                            "data_batch_size": 4, "on_device": True,
                            "count": 2},
             "deploy": {"local": {
                 "module": "aiko_services_tpu_torch.elements",
                 "class_name": "MultiModalSource"}}}],
    }
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        for _ in range(2):
            _, _, outputs = responses.get(timeout=60)
            assert outputs["audio"].is_cuda and outputs["image"].is_cuda
            assert tuple(outputs["audio"].shape) == (4, 8000)
            assert tuple(outputs["image"].shape) == (4, 3, 64, 64)
            assert outputs["image"].dtype == torch.float32
            assert 0 <= outputs["image"].min() and outputs["image"].max() < 1
    finally:
        process.terminate()


def test_bf16_dense_reduces_in_f32_at_a_split_k_shape(cuda):
    """A bf16 dense at M = 8, K = 8192 (small M and long K invite cuBLAS
    to split K) is its f32 product rounded once to bf16.  The inputs are
    small integers, so every partial sum is exact in f32 whatever the
    order: the only way to differ is to sum in bf16."""
    from aiko_services_tpu_torch.models.layers import dense
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-3, 4, (8, 8192)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.integers(-3, 4, (8192, 2048)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    expected = torch.matmul(x.float(), w.float()).to(torch.bfloat16)
    assert torch.equal(dense({"w": w}, x), expected)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_decode_step_replays_the_eager_step(cuda, dtype):
    """The engine's captured paged_decode_step (and the speculative
    verify windows) against the same engine run eagerly on the card:
    identical tokens and a bit-identical pool after a storm with
    admissions, evictions and a block crossing."""
    from dataclasses import replace
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.models import TransformerConfig, init_params
    config = TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=128,
                               max_seq_len=128, dtype=dtype)
    draft_config = replace(config, n_layers=1)
    params = init_params(config, torch.Generator().manual_seed(0),
                         device=cuda)
    draft = init_params(draft_config, torch.Generator().manual_seed(1),
                        device=cuda)
    rng = np.random.default_rng(4)
    requests = [(rng.integers(1, 256, size=int(rng.integers(3, 30)))
                 .astype(np.int32), int(rng.integers(2, 20)))
                for _ in range(10)]
    runs = {}
    for graphs in (True, False):
        for speculative in (False, True):
            options = ({"draft_params": draft, "draft_config": draft_config,
                        "spec_k": 3} if speculative else {})
            engine = DecodeEngine(params, config, decode_slots=3,
                                  kv_block_size=8, **options)
            engine._graphs = graphs
            for index, (prompt, max_new) in enumerate(requests):
                engine.submit(index, prompt, max_new)
            done = {}
            while engine.has_work():
                for completion in engine.step().completions:
                    done[completion.request_id] = completion.tokens
            assert bool(engine._captured) == graphs
            runs[graphs, speculative] = (done, {
                name: leaf.clone() for name, leaf in engine.pool.items()})
    for speculative in (False, True):
        graph_done, graph_pool = runs[True, speculative]
        eager_done, eager_pool = runs[False, speculative]
        for index in range(len(requests)):
            np.testing.assert_array_equal(graph_done[index],
                                          eager_done[index])
        for name in graph_pool:
            # block 0 is the trash block: which duplicate write wins
            # there is unspecified
            assert torch.equal(graph_pool[name][:, 1:],
                               eager_pool[name][:, 1:])


def _lm(cuda, dtype="bfloat16"):
    from aiko_services_tpu_torch.models import TransformerConfig, init_params
    config = TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=128,
                               max_seq_len=128, dtype=dtype)
    return init_params(config, torch.Generator().manual_seed(0),
                       device=cuda), config


def _drain(engine, done):
    while engine.has_work():
        for completion in engine.step().completions:
            done[completion.request_id] = completion.tokens
    return done


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adopt_into_a_captured_pool_equals_a_local_prefill(cuda, dtype):
    """Blocks adopted into a pool whose decode graph was captured BEFORE
    the adopt: the replayed graph reads the adopted KV (the scatter
    writes the pool's own storage) and decodes the local prefill's
    tokens, bit for bit."""
    from aiko_services_tpu_torch.decode import DecodeEngine, PrefillEngine
    params, config = _lm(cuda, dtype)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32)
               for n in (9, 21, 30)]
    local = DecodeEngine(params, config, decode_slots=3, kv_block_size=8)
    for index, prompt in enumerate(prompts):
        local.submit(index, prompt, 12)
    expected = _drain(local, {})
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8)
    engine.submit("warm", prompts[0], 3)     # captures the decode step
    _drain(engine, {})
    assert engine._captured
    pointers = {name: leaf.data_ptr() for name, leaf in engine.pool.items()}
    prefill = PrefillEngine(params, config, kv_block_size=8, device=cuda)
    done = {}
    for index, prompt in enumerate(prompts):
        prefill.submit(index, prompt, 12)
    while prefill.has_work():
        for handoff in prefill.step():
            report = engine.adopt_request(handoff["request_id"], handoff,
                                          timeout=30)
            for completion in report.completions:
                done[completion.request_id] = completion.tokens
    _drain(engine, done)
    assert engine.counters["adopted"] == 3
    assert engine.counters["adopt_fallbacks"] == 0
    assert {name: leaf.data_ptr()
            for name, leaf in engine.pool.items()} == pointers
    for index in range(len(prompts)):
        np.testing.assert_array_equal(done[index], expected[index])


def test_two_engines_capture_from_two_threads(cuda):
    """Two decode engines on one card, each stepped by its own thread:
    each engine's capture runs while the other thread launches work, and
    both decode the tokens they decode alone."""
    import threading
    from aiko_services_tpu_torch.decode import DecodeEngine
    params, config = _lm(cuda)
    rng = np.random.default_rng(9)
    workloads = [[(rng.integers(1, 256, size=int(rng.integers(4, 40)))
                   .astype(np.int32), int(rng.integers(8, 40)))
                  for _ in range(8)] for _ in range(2)]

    def serve(workload, slots):
        engine = DecodeEngine(params, config, decode_slots=slots,
                              kv_block_size=8)
        for index, (prompt, max_new) in enumerate(workload):
            engine.submit(index, prompt, max_new)
        return _drain(engine, {})

    alone = [serve(workload, slots)
             for workload, slots in zip(workloads, (3, 4))]
    results, errors = [None, None], []
    start = threading.Barrier(2)

    def run(position, slots):
        try:
            start.wait()
            results[position] = serve(workloads[position], slots)
        except Exception as error:        # surfaced by the assert below
            errors.append(error)

    threads = [threading.Thread(target=run, args=(position, slots))
               for position, slots in ((0, 3), (1, 4))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=600)
    assert errors == []
    for together, solo in zip(results, alone):
        for index in solo:
            np.testing.assert_array_equal(together[index], solo[index])


# -- the model families of the MoE / YOLOv8 / TTS slice ----------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_captured_decode_and_verify_steps_replay_the_eager_steps(
        cuda, dtype):
    """A switch-MoE model (4 experts, capacity factor 1.25) in the
    engine: the captured decode step (the weight gather, 1 < E) and the
    speculative verify windows (4 = E: capacity dispatch) against the same
    engine run eagerly, identical tokens and a bit-identical pool.  No
    MoE path syncs with the host inside a capture."""
    from dataclasses import replace
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.models import TransformerConfig, init_params
    config = TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=128,
                               max_seq_len=128, dtype=dtype, n_experts=4)
    draft_config = replace(config, n_layers=1)
    params = init_params(config, torch.Generator().manual_seed(0),
                         device=cuda)
    draft = init_params(draft_config, torch.Generator().manual_seed(1),
                        device=cuda)
    rng = np.random.default_rng(4)
    requests = [(rng.integers(1, 256, size=int(rng.integers(3, 30)))
                 .astype(np.int32), int(rng.integers(2, 20)))
                for _ in range(10)]
    runs = {}
    for graphs in (True, False):
        for speculative in (False, True):
            options = ({"draft_params": draft, "draft_config": draft_config,
                        "spec_k": 3} if speculative else {})
            engine = DecodeEngine(params, config, decode_slots=3,
                                  kv_block_size=8, **options)
            engine._graphs = graphs
            for index, (prompt, max_new) in enumerate(requests):
                engine.submit(index, prompt, max_new)
            done = _drain(engine, {})
            assert bool(engine._captured) == graphs
            runs[graphs, speculative] = (done, {
                name: leaf.clone() for name, leaf in engine.pool.items()})
    for speculative in (False, True):
        graph_done, graph_pool = runs[True, speculative]
        eager_done, eager_pool = runs[False, speculative]
        for index in range(len(requests)):
            np.testing.assert_array_equal(graph_done[index],
                                          eager_done[index])
        for name in graph_pool:
            assert torch.equal(graph_pool[name][:, 1:],
                               eager_pool[name][:, 1:])


def test_moe_bf16_train_step_launches_the_kernels(cuda):
    """The switch-MoE train step in bf16: K1 once a layer in the forward,
    K2 and K3 once a layer in the backward (no remat), a finite loss with
    the aux term, and the loss falls on a fixed batch."""
    from aiko_services_tpu_torch.models import (
        TransformerConfig, adamw, init_params, make_train_step)
    config = TransformerConfig(vocab_size=512, d_model=256, n_layers=3,
                               n_heads=4, n_kv_heads=2, d_ff=512,
                               max_seq_len=256, dtype="bfloat16",
                               n_experts=4)
    params = init_params(config, torch.Generator().manual_seed(0),
                         device=cuda)
    optimizer = adamw(1e-3)
    state = optimizer.init(params)
    step = make_train_step(config, optimizer)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 129))).to(cuda)
    kernels.reset_launch_counts()
    params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    assert {name: kernels.launch_counts[name] for name in kernels.KERNELS} \
        == {name: config.n_layers for name in kernels.KERNELS}
    losses = [float(loss)]
    for _ in range(4):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_yolov8n_sppf_pool_in_bf16_is_reduce_window(cuda):
    """The SPPF's pool at yolov8n's P5 shape (640 px: 20 x 20 x 128) in
    bf16 on the card: reduce_window(max, 5x5, stride 1, "SAME", -inf),
    computed here as a max over the 25 shifted views of the input padded
    with -inf; a max selects, so the two agree exactly."""
    from aiko_services_tpu_torch.models.yolo import _max_pool5
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 20, 20, 128)).astype(np.float32) - 1.0).to(cuda, torch.bfloat16)
    padded = torch.nn.functional.pad(x.float().cpu(), (0, 0, 2, 2, 2, 2),
                                     value=float("-inf"))
    expected = torch.stack([padded[:, i:i + 20, j:j + 20]
                            for i in range(5) for j in range(5)]).amax(0)
    actual = _max_pool5(x)
    assert actual.dtype == torch.bfloat16 and actual.is_cuda
    assert torch.equal(actual.float().cpu(), expected)


# -- sequence parallelism on the card ----------------------------------------
#
# A {"seq": 4} mesh over cuda:0 four times: every hop launches the kernels
# at the shard's shape on the one card.  bf16 against the plain attention
# of the whole sequence in f32: outputs atol/rtol 2e-2 as above (each hop
# rounds P to bf16; the partials merge in f32); gradients per-tensor
# relative error <= 5e-2, the limit phase 6 of chip_smoke.py holds
# gradients through chained kernels to (each executed hop adds its bf16
# dQ/dK/dV roundings to the f32 accumulators).

def _seq_mesh(cuda, size=4):
    from aiko_services_tpu_torch.parallel import create_mesh
    return create_mesh({"seq": size}, devices=[cuda] * size)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_cuda_matches_plain(cuda, causal):
    from aiko_services_tpu_torch.parallel import (
        attention_reference, ring_attention)
    q, k, v = _qkv((1, 4, 512, 64), (1, 4, 512, 64), torch.bfloat16, cuda,
                   seed=3)
    inputs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kernels.reset_launch_counts()
    out = ring_attention(*inputs, _seq_mesh(cuda), causal=causal)
    hops = 10 if causal else 16
    assert kernels.launch_counts["flash_attention"] == hops
    assert out.grad_fn is not None and out.is_cuda
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, inputs, dout)
    assert kernels.launch_counts["flash_attention_dq"] == hops
    assert kernels.launch_counts["flash_attention_dkv"] == hops
    plain = [x.float().requires_grad_(True) for x in (q, k, v)]
    expected = attention_reference(*plain, causal=causal)
    expected_grads = torch.autograd.grad(expected, plain, dout.float())
    torch.testing.assert_close(out.float(), expected, atol=2e-2, rtol=2e-2)
    for actual, wanted in zip(grads, expected_grads):
        assert _relative_error(actual, wanted) <= 5e-2


def test_ring_hop_count_on_cuda(cuda):
    from aiko_services_tpu_torch.parallel import attention
    q, k, v = _qkv((1, 2, 256, 64), (1, 2, 256, 64), torch.bfloat16, cuda)
    hops = []
    attention._RING_HOP_CALLBACK = hops.append
    try:
        attention.ring_attention(q, k, v, _seq_mesh(cuda, 8), causal=True)
    finally:
        attention._RING_HOP_CALLBACK = None
    assert len(hops) == 36


def test_ulysses_attention_on_cuda_matches_plain(cuda):
    from aiko_services_tpu_torch.parallel import (
        attention_reference, ulysses_attention)
    q, k, v = _qkv((1, 8, 512, 64), (1, 8, 512, 64), torch.bfloat16, cuda,
                   seed=4)
    kernels.reset_launch_counts()
    out = ulysses_attention(q, k, v, _seq_mesh(cuda), causal=True)
    assert kernels.launch_counts["flash_attention"] == 4
    expected = attention_reference(q.float(), k.float(), v.float(),
                                   causal=True)
    torch.testing.assert_close(out.float(), expected, atol=2e-2, rtol=2e-2)


def test_ring_and_ulysses_across_cards_equal_one_card(cuda):
    """A mesh over distinct cards (cuda:0..n-1, n <= 4) moves the shards
    between cards and gives, bit for bit, what the same mesh over cuda:0
    n times gives: the same kernels on the same shards.  Needs two cards
    or more (run it on a machine with several)."""
    from aiko_services_tpu_torch.parallel import (
        create_mesh, ring_attention, sp_decode_attention, ulysses_attention)
    count = min(torch.cuda.device_count(), 4)
    if count < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    meshes = [create_mesh({"seq": count}, devices=devices) for devices in (
        [f"cuda:{index}" for index in range(count)], ["cuda:0"] * count)]
    q, k, v = _qkv((1, 8, 256 * count, 64), (1, 8, 256 * count, 64),
                   torch.bfloat16, cuda, seed=5)
    dout = torch.randn_like(q)
    cache = torch.randn((1, 2, 64 * count, 64), device=cuda)
    results = []
    for mesh in meshes:
        inputs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = ring_attention(*inputs, mesh, causal=True)
        grads = torch.autograd.grad(out, inputs, dout)
        decode = sp_decode_attention(q[:, :, :1].float(), cache, cache, 99,
                                     mesh=mesh)
        results.append((out, *grads,
                        ulysses_attention(q, k, v, mesh, causal=True),
                        decode))
    for across, one in zip(*results):
        assert across.device == one.device == torch.device("cuda", 0)
        assert torch.equal(across, one)


# -- several cards -------------------------------------------------------------

@pytest.fixture
def cards(cuda):
    """cuda:0 ... cuda:N-1 (N <= 4); skips below two cards."""
    count = min(torch.cuda.device_count(), 4)
    if count < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    return [torch.device("cuda", index) for index in range(count)]


@pytest.mark.parametrize("case", ["encoder_bf16", "lm_training_bf16",
                                  "f32_causal_q_offset",
                                  "d128_causal_bf16"])
def test_kernels_on_every_card_match_plain(cards, case):
    """K1, K2 and K3 launched on each card (the launch guard makes it
    the current device) against their plain versions on that card, the
    results on the card of the inputs."""
    batch, heads, q_len, k_len, dim, dtype, causal, q_offset = CASES[case]
    for card in cards:
        q, k, v = _qkv((batch, heads, q_len, dim), (batch, heads, k_len, dim),
                       dtype, card, seed=card.index)
        dout = _qkv((batch, heads, q_len, dim), (batch, heads, 1, dim),
                    dtype, card, seed=card.index + 10)[0]
        before = dict(kernels.launch_counts)
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           q_offset=q_offset)
        grads = flash_attention_backward(q, k, v, out, lse, dout,
                                         causal=causal, q_offset=q_offset)
        torch.cuda.synchronize(card)
        for name in ("flash_attention", "flash_attention_dq",
                     "flash_attention_dkv"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        ref_out, ref_lse = flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal,
            q_offset=q_offset)
        expected = flash_attention_backward_plain(
            q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
            causal=causal, q_offset=q_offset)
        assert out.device == lse.device == card
        tolerance = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
                     else dict(atol=1e-5, rtol=0))
        torch.testing.assert_close(out.float(), ref_out, **tolerance)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        for got, want, name in zip(grads, expected, ("dq", "dk", "dv")):
            assert got.device == card, name
            if dtype == torch.bfloat16:
                assert _relative_error(got, want) <= 2e-2, (card, name)
            else:
                torch.testing.assert_close(got, want, atol=1e-4, rtol=0,
                                           msg=f"{card} {name}")


@pytest.mark.parametrize("collective", ["psum", "all_gather",
                                        "psum_scatter", "all_to_all",
                                        "ppermute"])
def test_collectives_across_cards_equal_one_card(cards, collective):
    """Each collective over a {"seq": N} mesh of cuda:0 ... N-1 puts every
    position's result on its own card, bit for bit what the same mesh
    over cuda:0 N times gives (the same f32 sums, in the same order)."""
    from aiko_services_tpu_torch.parallel import collectives, create_mesh
    count = len(cards)
    generator = torch.Generator().manual_seed(7)
    blocks = [torch.randn((2, 3, 4 * count, 8), generator=generator).to(
        torch.bfloat16) for _ in range(count)]
    calls = {
        "psum": lambda grid, mesh: collectives.psum(grid, mesh, "seq"),
        "all_gather": lambda grid, mesh: collectives.all_gather(
            grid, mesh, "seq", dim=2),
        "psum_scatter": lambda grid, mesh: collectives.psum_scatter(
            grid, mesh, "seq", dim=2),
        "all_to_all": lambda grid, mesh: collectives.all_to_all(
            grid, mesh, "seq", split_dim=2, concat_dim=1),
        "ppermute": lambda grid, mesh: collectives.ppermute(
            grid, mesh, "seq", [(i, (i + 1) % count)
                                for i in range(count)])}
    results = []
    for devices in (cards, [cards[0]] * count):
        mesh = create_mesh({"seq": count}, devices=devices)
        grid = np.empty(count, dtype=object)
        for index, device in enumerate(mesh.devices.flat):
            grid[index] = blocks[index].to(device)
        results.append(calls[collective](grid, mesh))
    for index, (across, one) in enumerate(zip(*(result.flat
                                                for result in results))):
        assert across.device == cards[index], (index, across.device)
        assert one.device == cards[0]
        assert torch.equal(across.to(cards[0]), one), index
