# The paged decode attention: K4 (csrc/paged_attention.cu), its plain
# version models/transformer.py::paged_gather_attention (the gather path)
# and the route that picks between them in the paged steps.  The CPU tests
# hold the plain version to the gather path and to a per-row reference
# written out position by position, check the route and the counting of
# launches a captured graph replays.  The tests marked `gpu` hold K4 to
# its plain version on the card and run the decode engine through it;
# they skip, with their reason, where there is no card.  This file
# imports no JAX, so on the card it runs without the conftest:
#
#   python -m pytest --noconftest -p no:cacheprovider -m gpu \
#       tests/test_torch_paged_attention.py
#
# Tolerances.  On the CPU the plain version rounds its softmax weights to
# bf16 before P.V and its output once to bf16: against the f64 per-row
# reference, atol 2e-2 on values of order 1 (2^-9 relative per weight and
# once on the output); in f32 only the summation order differs, atol
# 1e-5.  On the card K4 keeps P in f32 and rounds its output once to bf16
# from f32 sums taken in another order than the plain version's: against
# the plain version computed in f32 on the same bf16 inputs, rtol 1e-2
# covers the one bf16 rounding (at most 2^-8 relative) of rows that see a
# few keys, whose outputs are of order 1 to 4, and atol 2e-3 that of rows
# averaging hundreds of random V rows, whose outputs are of order 0.05.

import threading
import types
from dataclasses import replace

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.ops import kernels
from aiko_services_tpu_torch.parallel import attention


def _config(group: int, dtype: str = "bfloat16", head_dim: int = 16,
            kv_heads: int = 2):
    heads = group * kv_heads
    return torch_lm.TransformerConfig(
        vocab_size=64, d_model=heads * head_dim, n_layers=2, n_heads=heads,
        n_kv_heads=kv_heads, d_ff=64, max_seq_len=512, dtype=dtype)


def _paged_inputs(config, block_size: int, window: int, lengths,
                  max_blocks: int, seed: int = 0, device="cpu"):
    """Random pools, shuffled block tables and positions: slot s's first
    window row sees lengths[s] keys; one more slot is inactive (its
    table all on the trash block 0, position 0)."""
    rng = np.random.default_rng(seed)
    slots = len(lengths) + 1
    num_blocks = 1 + len(lengths) * max_blocks
    dtype = config.torch_dtype

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=device, dtype=dtype)

    k_pool = normal(num_blocks, config.n_kv_heads, block_size,
                    config.head_dim)
    v_pool = normal(num_blocks, config.n_kv_heads, block_size,
                    config.head_dim)
    q = normal(slots, config.n_heads, window, config.head_dim)
    blocks = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    tables = np.zeros((slots, max_blocks), np.int32)
    tables[:len(lengths)] = blocks.reshape(len(lengths), max_blocks)
    positions = np.array([length - 1 for length in lengths] + [0],
                         np.int32)
    return (q, k_pool, v_pool, torch.from_numpy(tables).to(device),
            torch.from_numpy(positions).to(device))


def _per_row_reference(config, q, k_pool, v_pool, tables, positions):
    """Row w of slot s over its keys 0 .. positions[s] + w (at most the
    table's capacity), each looked up through the table, in f64."""
    block_size = k_pool.shape[2]
    capacity = tables.shape[1] * block_size
    group = config.n_heads // config.n_kv_heads
    q, k_pool, v_pool = (x.double().numpy() for x in (q, k_pool, v_pool))
    tables, positions = tables.numpy(), positions.numpy()
    out = np.zeros(q.shape)
    scale = 1.0 / np.sqrt(config.head_dim)
    for slot in range(q.shape[0]):
        for w in range(q.shape[2]):
            keys = min(int(positions[slot]) + w + 1, capacity)
            at = np.arange(keys)
            blocks = tables[slot, at // block_size]
            for head in range(q.shape[1]):
                kv_head = head // group
                k = k_pool[blocks, kv_head, at % block_size]
                v = v_pool[blocks, kv_head, at % block_size]
                logits = k @ q[slot, head, w] * scale
                weights = np.exp(logits - logits.max())
                out[slot, head, w] = weights @ v / weights.sum()
    return out


# GQA 4:1 and 1:1, blocks of 16 and 32, windows of 1 and 4; lengths 1,
# bs - 1, bs, bs + 1 and the whole table
PLAIN_CASES = [(group, block_size, window)
               for group in (4, 1) for block_size in (16, 32)
               for window in (1, 4)]


def _lengths(block_size: int, max_blocks: int) -> list:
    return [1, block_size - 1, block_size, block_size + 1,
            max_blocks * block_size]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("group,block_size,window", PLAIN_CASES)
def test_plain_version_is_the_gather_path(group, block_size, window, dtype):
    config = _config(group, dtype)
    max_blocks = 3
    q, k_pool, v_pool, tables, positions = _paged_inputs(
        config, block_size, window, _lengths(block_size, max_blocks),
        max_blocks)
    out = torch_lm.paged_gather_attention(config, q, k_pool, v_pool,
                                          tables, positions)
    q_pos = positions.long()[:, None] + torch.arange(window)[None, :]
    gathered = torch_lm._masked_attention(
        config, q, torch_lm._paged_gather(k_pool, tables.long()),
        torch_lm._paged_gather(v_pool, tables.long()),
        q_pos[:, None, :, None], torch.arange(max_blocks * block_size))
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.equal(out, gathered)
    expected = _per_row_reference(config, q, k_pool, v_pool, tables,
                                  positions)
    np.testing.assert_allclose(out.double().numpy(), expected,
                               atol=2e-2 if dtype == "bfloat16" else 1e-5)


def _pool(device: str, dtype):
    """A stand-in for a pool: the route reads only the K pool's device
    and dtype."""
    return {"k": types.SimpleNamespace(device=torch.device(device),
                                       dtype=dtype)}


ROUTES = {
    # name: (device, pool dtype, window, takes K4)
    "card_decode": ("cuda", torch.bfloat16, 1, True),
    "card_verify_16": ("cuda", torch.bfloat16, 16, True),
    "card_window_17": ("cuda", torch.bfloat16, 17, False),
    "card_int8_pool": ("cuda", torch.int8, 1, False),
    "card_f32_pool": ("cuda", torch.float32, 1, False),
    "cpu_bf16_pool": ("cpu", torch.bfloat16, 1, False),
    "cpu_f32_pool": ("cpu", torch.float32, 1, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_follows_device_pool_dtype_window_and_head_size(case):
    """The route reads the device, the pool's dtype and the window; the
    head size does not choose it (on the route, K4 takes it or the step
    raises: the next test)."""
    device, dtype, window, takes = ROUTES[case]
    assert torch_lm._takes_paged_kernel(_pool(device, dtype),
                                        window) is takes


@pytest.mark.parametrize("head_dim", [8, 48])
def test_paged_step_on_k4_route_raises_on_a_head_size_it_does_not_take(
        monkeypatch, head_dim):
    """A step on K4's route at a head size K4 does not take raises before
    it writes the pool, rather than running the gather (the route forced
    here, on the CPU)."""
    def refuse(*_, **__):
        raise AssertionError("K4 launched")

    monkeypatch.setattr(torch_lm, "_takes_paged_kernel", lambda *_: True)
    monkeypatch.setattr(torch_lm, "paged_decode_attention", refuse)
    monkeypatch.setattr(torch_lm, "paged_gather_attention", refuse)
    config = _config(4, head_dim=head_dim)
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    pool = torch_lm.init_paged_pool(config, num_blocks=3, block_size=16,
                                    device="cpu")
    pool["k"].normal_()
    before = {name: buffer.clone() for name, buffer in pool.items()}
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    one = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        torch_lm.paged_decode_step(params, config, pool, tables, one,
                                   one[:, None], one, one)
    for name, buffer in pool.items():
        assert torch.equal(buffer, before[name])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("window", [1, 17])
def test_paged_steps_on_the_cpu_take_the_gather_path(monkeypatch, window,
                                                     kv_dtype):
    """The CPU (and an int8 pool, and a window past 16) never reach K4:
    a step with K4's launcher made to fail runs, and counts nothing."""
    def refuse(*_, **__):
        raise AssertionError("K4 launched on the CPU")

    monkeypatch.setattr(torch_lm, "paged_decode_attention", refuse)
    config = _config(4, head_dim=16)
    if kv_dtype:
        config = replace(config, kv_dtype=kv_dtype)
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    pool = torch_lm.init_paged_pool(config, num_blocks=5, block_size=16,
                                    device="cpu")
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    positions = torch.tensor([3, 20], dtype=torch.int32)
    tokens = torch.ones((2, window), dtype=torch.int32)
    at = positions[:, None] + torch.arange(window)[None, :]
    blocks = torch.gather(tables, 1, (at // 16).clamp(max=1))
    before = dict(kernels.launch_counts)
    _, greedy = torch_lm.paged_verify_step(params, config, pool, tables,
                                           positions, tokens, blocks,
                                           at % 16)
    assert greedy.shape == (2, window)
    assert kernels.launch_counts == before


def test_kernel_launcher_refuses_cpu_tensors():
    config = _config(4, head_dim=64)
    q, k_pool, v_pool, tables, positions = _paged_inputs(
        config, 16, 1, [5], 2)
    with pytest.raises(ValueError, match="not q's CUDA device"):
        attention.paged_decode_attention(q, k_pool, v_pool, tables,
                                         positions, 0.125)


def test_captured_launches_count_at_each_replay():
    """Launches recorded into a graph count once a replay, never at the
    capture; another thread's launches meanwhile count as they run."""
    name = "paged_decode_attention"
    start = kernels.launch_counts[name]
    other = threading.Thread(target=kernels.count_launch, args=(name,))
    with kernels.captured_launches() as captured:
        kernels.count_launch(name)
        kernels.count_launch(name)
        other.start()
        other.join()
    assert captured[name] == 2
    assert kernels.launch_counts[name] == start + 1
    for _ in range(3):
        kernels.count_replay(captured)
    assert kernels.launch_counts[name] == start + 7
    kernels.count_launch(name)
    assert kernels.launch_counts[name] == start + 8


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# (slots, H, H_kv, d, bs, max_blocks, W): the mistral_7b.serve_chat step
# (64 slots, 144 blocks of 32, H 32, H_kv 8, d 128) and its verify window;
# CTAs of 4, 8, 16 and 32 query rows and a KV head whose 40 rows take two
# CTAs; d 64, 32 and 16; a block size that is no power of two
CARD_CASES = {
    "serve_chat_decode": (64, 32, 8, 128, 32, 144, 1),
    "serve_chat_verify_4": (64, 32, 8, 128, 32, 144, 4),
    "gqa_4_w2_d64": (9, 8, 2, 64, 32, 20, 2),
    "mha_d64_w16": (6, 4, 4, 64, 16, 40, 16),
    "gqa_8_bs48": (7, 16, 2, 128, 48, 12, 3),
    "gqa_8_w5_two_ctas": (7, 16, 2, 128, 16, 30, 5),
    "gqa_2_w4_d32": (8, 8, 4, 32, 16, 70, 4),
    "gqa_2_w1_d16": (8, 4, 2, 16, 8, 90, 1),
    "mha_d16_w16": (7, 2, 2, 16, 32, 20, 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_k4_matches_its_plain_version(cuda, case):
    slots, heads, kv_heads, dim, block_size, max_blocks, window = \
        CARD_CASES[case]
    config = torch_lm.TransformerConfig(
        vocab_size=64, d_model=heads * dim, n_layers=1, n_heads=heads,
        n_kv_heads=kv_heads, d_ff=64, dtype="bfloat16")
    capacity = max_blocks * block_size
    rng = np.random.default_rng(21)
    lengths = [1, capacity, block_size - 1, block_size, block_size + 1,
               *rng.integers(1, capacity + 1, size=slots - 6)]
    q, k_pool, v_pool, tables, positions = _paged_inputs(
        config, block_size, window, lengths, max_blocks, seed=5,
        device=cuda)
    scale = torch_lm._attention_scale(dim)
    kernels.reset_launch_counts()
    out = attention.paged_decode_attention(q, k_pool, v_pool, tables,
                                           positions, scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts["paged_decode_attention"] == 2
    again = attention.paged_decode_attention(q, k_pool, v_pool, tables,
                                             positions, scale)
    assert torch.equal(out, again)
    # the plain version in f32 on the same bf16 inputs, a slot at a time
    # (its gather of a whole table, expanded to H heads in f32)
    f32 = replace(config, dtype="float32")
    k32, v32 = k_pool.float(), v_pool.float()
    expected = torch.cat([
        torch_lm.paged_gather_attention(
            f32, q[slot:slot + 1].float(), k32, v32,
            tables[slot:slot + 1], positions[slot:slot + 1])
        for slot in range(q.shape[0])])
    torch.testing.assert_close(out.float(), expected, atol=2e-3, rtol=1e-2)
    # a row's result does not depend on the window: row 0 alone
    first = attention.paged_decode_attention(
        q[:, :, :1].contiguous(), k_pool, v_pool, tables, positions, scale)
    assert torch.equal(first, out[:, :, :1])


@pytest.mark.gpu
def test_k4_rejects_what_it_does_not_take(cuda):
    config = _config(4, head_dim=64)
    q, k_pool, v_pool, tables, positions = _paged_inputs(
        config, 16, 2, [5, 40], 4, device=cuda)
    launch = attention.paged_decode_attention
    with pytest.raises(TypeError, match="bfloat16"):
        launch(q.float(), k_pool, v_pool, tables, positions, 0.125)
    with pytest.raises(TypeError, match="int32"):
        launch(q, k_pool, v_pool, tables.long(), positions, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        launch(q[..., :48].contiguous(), k_pool[..., :48].contiguous(),
               v_pool[..., :48].contiguous(), tables, positions, 0.125)
    with pytest.raises(ValueError, match="window"):
        launch(q.repeat(1, 1, 9, 1), k_pool, v_pool, tables, positions,
               0.125)
    with pytest.raises(ValueError, match="contiguous"):
        launch(q.transpose(1, 2), k_pool, v_pool, tables, positions, 0.125)
    with pytest.raises(ValueError, match="slots"):
        launch(q, k_pool, v_pool, tables[:2], positions, 0.125)


def _engine_model(cuda):
    from aiko_services_tpu_torch.models import init_params
    config = torch_lm.TransformerConfig(
        vocab_size=256, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=512, max_seq_len=256, dtype="bfloat16")
    draft_config = replace(config, n_layers=1)
    return (init_params(config, torch.Generator().manual_seed(0),
                        device=cuda), config,
            init_params(draft_config, torch.Generator().manual_seed(1),
                        device=cuda), draft_config)


@pytest.mark.gpu
def test_engine_on_k4_speculative_equals_plain_greedy(cuda):
    """A bf16 engine (head size 64: K4's route) decodes the same tokens
    with spec_k 0 and 3: the verify window's rows equal the decode
    step's."""
    from aiko_services_tpu_torch.decode import DecodeEngine
    params, config, draft, draft_config = _engine_model(cuda)
    rng = np.random.default_rng(8)
    requests = [(rng.integers(1, 256, size=int(rng.integers(3, 90)))
                 .astype(np.int32), int(rng.integers(4, 40)))
                for _ in range(8)]
    runs = []
    for options in ({}, {"draft_params": draft,
                         "draft_config": draft_config, "spec_k": 3}):
        kernels.reset_launch_counts()
        engine = DecodeEngine(params, config, decode_slots=4,
                              kv_block_size=16, **options)
        for index, (prompt, max_new) in enumerate(requests):
            engine.submit(index, prompt, max_new)
        done = {}
        while engine.has_work():
            for completion in engine.step().completions:
                done[completion.request_id] = completion.tokens
        torch.cuda.synchronize()
        assert kernels.launch_counts["paged_decode_attention"] > 0
        runs.append(done)
    for index in range(len(requests)):
        np.testing.assert_array_equal(runs[0][index], runs[1][index])


@pytest.mark.gpu
def test_k4_launches_count_each_replay(cuda, monkeypatch):
    """Once the decode step is captured, K4's count is 2 launches a layer
    for every replay of the step: the capture's launches counted again at
    each replay."""
    from aiko_services_tpu_torch.decode import DecodeEngine, engine as \
        engine_module
    params, config, _, _ = _engine_model(cuda)
    engine = DecodeEngine(params, config, decode_slots=4, kv_block_size=16)
    engine.submit("warm", np.arange(1, 20, dtype=np.int32), 3)
    while engine.has_work():
        engine.step()
    assert engine._captured
    replays = [0]
    replay = engine_module._CapturedStep.replay

    def counted(self, arrays):
        replays[0] += 1
        return replay(self, arrays)

    monkeypatch.setattr(engine_module._CapturedStep, "replay", counted)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    for index in range(6):
        engine.submit(index, rng.integers(1, 256, size=30 + 7 * index)
                      .astype(np.int32), 25)
    while engine.has_work():
        engine.step()
    torch.cuda.synchronize()
    assert replays[0] > 0
    assert kernels.launch_counts["paged_decode_attention"] == (
        2 * config.n_layers * replays[0])
