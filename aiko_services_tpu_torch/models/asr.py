# Whisper-style encoder-decoder speech recognizer.
#
# Counterpart of aiko_services_tpu/models/asr.py.  Same model, same
# parameter tree (nested dicts, decoder and encoder layers stacked on a
# leading (L, ...) axis), same casts; PyTorch run eagerly on the device
# its tensors lie on.  jax.lax.scan over the stacked layers is a Python
# loop over layer slices, the scanned decode loop a Python loop over
# steps, and every encoder and teacher-forced decoder attention goes
# through flash_attention (the hand-written Hopper kernel on CUDA).
#
# Decode-step attention over the KV caches stays plain PyTorch, as it is
# plain XLA in the JAX package.  make_asr_train_step trains through the
# same flash_attention, whose backward runs the hand-written dQ and dK/dV
# kernels on CUDA; its update is written into the parameters in place.
#
# asr_param_specs lays the tree out megatron-style (q/k/v and the first
# MLP weight column-parallel over "model" and row-cut over "fsdp", the
# output projections and the second MLP weight the other way round, the
# token table's model dimension over "fsdp").  With Sharded leaves
# (parallel.shard_pytree) encode_audio, decode_tokens, asr_forward and
# transcribe run on the shards: each model shard attends over its heads
# (the encoder and the teacher-forced decoder through flash_attention, so
# the forward kernel runs once per model shard), the dense layers are
# column- and row-parallel (models/layers.py), the batch splits over
# "data", and the results come back whole on the mesh's home device.

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.audio import full_f32_convolution, log_mel_spectrogram
from ..ops.device import resolve_device
from ..parallel.attention import flash_attention
from ..parallel.collectives import map_shards
from ..parallel.mesh import PartitionSpec as P
from ..parallel.mesh import check_layout, leaf_layout, sharded_leaves
from .layers import (
    ShardedCall, column_parallel, dense, f32_reduction, init_dense,
    init_norm, layer_norm, row_parallel)
from .optim import apply_updates, next_token_loss, value_and_grad

__all__ = ["AsrConfig", "init_asr_params", "asr_param_specs",
           "transcribe_audio",
           "transcribe_rescore", "encode_audio", "decode_tokens",
           "asr_forward", "make_asr_train_step", "transcribe",
           "count_params"]

_NEG_INF = -1e30


@dataclass(frozen=True)
class AsrConfig:
    n_mels: int = 80
    d_model: int = 384
    enc_layers: int = 4
    dec_layers: int = 4
    n_heads: int = 6
    vocab_size: int = 1024
    max_frames: int = 1500        # mel frames after conv (30 s @ 10 ms hop)
    max_text_len: int = 128
    sot_token: int = 1            # start-of-transcript
    eot_token: int = 2            # end-of-transcript
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal positions (length, channels)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def _stack(layer_list: list) -> dict:
    first = layer_list[0]
    if isinstance(first, dict):
        return {key: _stack([layer[key] for layer in layer_list])
                for key in first}
    return torch.stack(layer_list)


def _layer(stacked: dict, index: int) -> dict:
    """Layer `index` of a stacked (L, ...) layer tree (views, no copy)."""
    if isinstance(stacked, dict):
        return {key: _layer(value, index) for key, value in stacked.items()}
    return stacked[index]


def _layer_count(stacked: dict) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def count_params(params) -> int:
    """The global element count (a Sharded leaf counts its whole
    shape, not its blocks)."""
    if isinstance(params, dict):
        return sum(count_params(value) for value in params.values())
    if isinstance(params, list):
        return sum(count_params(value) for value in params)
    return int(params.numel())


def init_asr_params(config: AsrConfig, generator: torch.Generator,
                    device="cuda") -> dict:
    """Random parameters drawn on the CPU from `generator` (seeded by the
    caller), cast to config.dtype and placed on `device`.  The draws
    follow the JAX package's distributions, not its numbers."""
    device = resolve_device(device)
    d, dtype = config.d_model, config.torch_dtype

    def normal(shape, scale):
        values = torch.randn(shape, generator=generator,
                             dtype=torch.float32) * scale
        return values.to(device=device, dtype=dtype)

    def attention():
        return {name: init_dense(generator, d, d, dtype, device=device)
                for name in ("wq", "wk", "wv", "wo")}

    def mlp():
        return {"w1": init_dense(generator, d, d * 4, dtype, device=device),
                "w2": init_dense(generator, d * 4, d, dtype, device=device)}

    def norm():
        return init_norm(d, dtype, device=device)

    conv1 = {"w": normal((d, config.n_mels, 3),
                         1.0 / np.sqrt(config.n_mels * 3)),
             "b": torch.zeros((d,), dtype=dtype, device=device)}
    conv2 = {"w": normal((d, d, 3), 1.0 / np.sqrt(d * 3)),
             "b": torch.zeros((d,), dtype=dtype, device=device)}
    enc = [{"attn_norm": norm(), "attn": attention(),
            "mlp_norm": norm(), "mlp": mlp()}
           for _ in range(config.enc_layers)]
    dec = [{"self_norm": norm(), "self": attention(),
            "cross_norm": norm(), "cross": attention(),
            "mlp_norm": norm(), "mlp": mlp()}
           for _ in range(config.dec_layers)]
    return {
        "conv1": conv1,
        "conv2": conv2,
        "enc_positions": torch.from_numpy(
            _sinusoids(config.max_frames, d)).to(device=device, dtype=dtype),
        "enc_layers": _stack(enc),
        "enc_norm": norm(),
        "token_embed": {"w": normal((config.vocab_size, d), 0.02)},
        "dec_positions": normal((config.max_text_len, d), 0.01),
        "dec_layers": _stack(dec),
        "dec_norm": norm(),
    }


def asr_param_specs(config: AsrConfig) -> dict:
    """Megatron TP on "model" + FSDP on "fsdp" for the whisper tree
    (stacked layers carry a leading None); norms, convolutions and
    positions replicate."""
    attention = {"wq": {"w": P(None, "fsdp", "model")},
                 "wk": {"w": P(None, "fsdp", "model")},
                 "wv": {"w": P(None, "fsdp", "model")},
                 "wo": {"w": P(None, "model", "fsdp")}}
    mlp = {"w1": {"w": P(None, "fsdp", "model")},
           "w2": {"w": P(None, "model", "fsdp")}}
    norm = {"scale": P(None, None)}
    return {
        "conv1": {"w": P(None, None, None), "b": P(None)},
        "conv2": {"w": P(None, None, None), "b": P(None)},
        "enc_positions": P(None, None),
        "enc_layers": {"attn_norm": norm, "attn": attention,
                       "mlp_norm": norm, "mlp": mlp},
        "enc_norm": {"scale": P(None)},
        "token_embed": {"w": P(None, "fsdp")},
        "dec_positions": P(None, None),
        "dec_layers": {"self_norm": norm, "self": attention,
                       "cross_norm": norm, "cross": attention,
                       "mlp_norm": norm, "mlp": mlp},
        "dec_norm": {"scale": P(None)},
    }


# -- model ------------------------------------------------------------------

def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _split_heads(x, n_heads: int):
    """(B, L, d) -> contiguous (B, H, L, d/H): the attention kernel takes
    contiguous tensors only."""
    batch, length, _ = x.shape
    return x.reshape(batch, length, n_heads, -1).transpose(1, 2).contiguous()


def _merge_heads(x):
    batch, heads, length, dim = x.shape
    return x.transpose(1, 2).reshape(batch, length, heads * dim)


def _attend(attention, x, memory, n_heads: int, causal: bool):
    q = _split_heads(dense(attention["wq"], x), n_heads)
    k = _split_heads(dense(attention["wk"], memory), n_heads)
    v = _split_heads(dense(attention["wv"], memory), n_heads)
    out = flash_attention(q, k, v, causal=causal)
    return dense(attention["wo"], _merge_heads(out))


def _conv1d(params, x, stride: int):
    """x (B, T, C_in), w (C_out, C_in, K) -> (B, ceil(T/stride), C_out).

    XLA's "SAME" padding, written out (PyTorch has no "same" for a stride
    above 1): total = max((ceil(T/s) - 1) * s + K - T, 0), the lower half
    (rounded down) before, the rest after.  The bias is added in f32 and
    the sum cast once, as the JAX package does; in bf16 the convolution
    itself rounds its f32 sums to bf16 first."""
    weight = params["w"].to(x.dtype)
    length, kernel = x.shape[1], weight.shape[-1]
    total = max((math.ceil(length / stride) - 1) * stride + kernel - length,
                0)
    low = total // 2
    padded = F.pad(x.transpose(1, 2), (low, total - low))
    if x.dtype == torch.float32:
        with full_f32_convolution():
            out = F.conv1d(padded, weight, stride=stride)
    else:
        out = F.conv1d(padded, weight, stride=stride)
    out = out.float() + params["b"].float()[:, None]
    return out.to(x.dtype).transpose(1, 2)


def _encoder_input(conv1, conv2, positions, config: AsrConfig, mel):
    """The convolution stem and positions: mel (B, n_mels, frames) ->
    (B, frames//2, d)."""
    x = mel.to(config.torch_dtype).transpose(1, 2)     # (B, T, mels)
    x = _gelu(_conv1d(conv1, x, stride=1))
    x = _gelu(_conv1d(conv2, x, stride=2))
    # whisper-style fixed context window: audio beyond max_frames post-conv
    # positions is truncated (callers chunk longer audio -- AudioFraming)
    x = x[:, :config.max_frames]
    return x + positions[:x.shape[1]]


def encode_audio(params: dict, config: AsrConfig, mel):
    """mel (B, n_mels, frames) -> encoder memory (B, frames//2, d)."""
    call = _asr_call(params, config)
    if call is not None:
        return call.gather_home(_sharded_encode(call, params, mel))
    x = _encoder_input(params["conv1"], params["conv2"],
                       params["enc_positions"], config, mel)
    layers = params["enc_layers"]
    for index in range(_layer_count(layers)):
        layer = _layer(layers, index)
        normed = layer_norm(layer["attn_norm"], x)
        x = x + _attend(layer["attn"], normed, normed, config.n_heads,
                        causal=False)
        normed = layer_norm(layer["mlp_norm"], x)
        x = x + dense(layer["mlp"]["w2"],
                      _gelu(dense(layer["mlp"]["w1"], normed)))
    return layer_norm(params["enc_norm"], x)


def _embed(params: dict, tokens):
    """Token embeddings; out-of-range ids clamp (jnp.take mode="clip")."""
    table = params["token_embed"]["w"]
    return table[tokens.clamp(0, table.shape[0] - 1)]


def _logits(params: dict, h):
    return torch.einsum("btd,vd->btv", h.float(),
                        params["token_embed"]["w"].float())


def decode_tokens(params: dict, config: AsrConfig, tokens, memory):
    """tokens (B, T) + encoder memory -> logits (B, T, vocab) f32."""
    call = _asr_call(params, config)
    if call is not None:
        memory_grid = call.split_batch(memory)
        return call.gather_home(_sharded_decode(
            call, params, call.split_batch(tokens), memory_grid))
    h = _embed(params, tokens)
    h = h + params["dec_positions"][:tokens.shape[1]]
    layers = params["dec_layers"]
    for index in range(_layer_count(layers)):
        layer = _layer(layers, index)
        normed = layer_norm(layer["self_norm"], h)
        h = h + _attend(layer["self"], normed, normed, config.n_heads,
                        causal=True)
        h = h + _attend(layer["cross"],
                        layer_norm(layer["cross_norm"], h), memory,
                        config.n_heads, causal=False)
        normed = layer_norm(layer["mlp_norm"], h)
        h = h + dense(layer["mlp"]["w2"],
                      _gelu(dense(layer["mlp"]["w1"], normed)))
    return _logits(params, layer_norm(params["dec_norm"], h))


def asr_forward(params: dict, config: AsrConfig, mel, tokens):
    """Teacher-forced forward (scoring): logits (B, T, vocab)."""
    return decode_tokens(params, config, tokens,
                         encode_audio(params, config, mel))


def make_asr_train_step(config: AsrConfig, optimizer):
    """Returns train_step(params, opt_state, mel, tokens) -> (params,
    opt_state, loss): teacher-forced next-token cross-entropy in f32 over
    asr_forward(mel, tokens[:, :-1]) -> tokens[:, 1:] (targets clamp into
    the vocabulary).  The update is written into params and opt_state in
    place (the JAX step donates both)."""

    def loss_fn(params, mel, tokens):
        logits = asr_forward(params, config, mel, tokens[:, :-1])
        return next_token_loss(logits, tokens[:, 1:])

    def train_step(params, opt_state, mel, tokens):
        loss, grads = value_and_grad(loss_fn, params, mel, tokens)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def _cross_kv(params: dict, config: AsrConfig, memory):
    """Cross-attention K/V for every decoder layer, computed ONCE per
    transcription.  Returns (L, B, H, M, hd) stacked pairs."""
    layers = params["dec_layers"]
    ks, vs = [], []
    for index in range(_layer_count(layers)):
        cross = _layer(layers, index)["cross"]
        ks.append(_split_heads(dense(cross["wk"], memory), config.n_heads))
        vs.append(_split_heads(dense(cross["wv"], memory), config.n_heads))
    return torch.stack(ks), torch.stack(vs)


def _attend_cached(q, k, v):
    """(B, H, 1, hd) query over cached keys/values, f32 softmax."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    att = torch.softmax(scores, dim=-1).to(v.dtype)
    with f32_reduction():
        return torch.einsum("bhqk,bhkd->bhqd", att, v)


def _decode_step(params: dict, config: AsrConfig, token, index: int,
                 self_k, self_v, cross_k, cross_v):
    """One incremental decode step: token (B, 1) consumed at buffer
    position `index`.  The self K/V caches (L, B, H, T, hd) are written
    IN PLACE at `index` (the JAX package's dynamic_update_slice returns
    updated copies); attention masks positions > index.  Returns
    (next-position logits (B, vocab) f32, self_k, self_v)."""
    h = _embed(params, token)
    positions = params["dec_positions"]
    # dynamic_slice clamps its start so the slice stays in bounds
    h = h + positions[min(index, positions.shape[0] - 1)][None, None]
    max_tokens = self_k.shape[3]
    mask = (torch.arange(max_tokens, device=token.device)
            > index)[None, None, None, :]
    scale = 1.0 / np.sqrt(config.head_dim)
    layers = params["dec_layers"]
    for layer_index in range(_layer_count(layers)):
        layer = _layer(layers, layer_index)
        x = layer_norm(layer["self_norm"], h)
        q = _split_heads(dense(layer["self"]["wq"], x), config.n_heads)
        k_new = _split_heads(dense(layer["self"]["wk"], x), config.n_heads)
        v_new = _split_heads(dense(layer["self"]["wv"], x), config.n_heads)
        self_k[layer_index, :, :, index] = k_new[:, :, 0]
        self_v[layer_index, :, :, index] = v_new[:, :, 0]
        sk, sv = self_k[layer_index], self_v[layer_index]
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                              sk.float()) * scale
        scores = scores.masked_fill(mask, _NEG_INF)
        att = torch.softmax(scores, dim=-1).to(sv.dtype)
        with f32_reduction():
            self_out = torch.einsum("bhqk,bhkd->bhqd", att, sv)
        h = h + dense(layer["self"]["wo"], _merge_heads(self_out))
        xc = layer_norm(layer["cross_norm"], h)
        qc = _split_heads(dense(layer["cross"]["wq"], xc), config.n_heads)
        h = h + dense(layer["cross"]["wo"], _merge_heads(
            _attend_cached(qc, cross_k[layer_index], cross_v[layer_index])))
        normed = layer_norm(layer["mlp_norm"], h)
        h = h + dense(layer["mlp"]["w2"],
                      _gelu(dense(layer["mlp"]["w1"], normed)))
    logits = _logits(params, layer_norm(params["dec_norm"], h))
    return logits[:, 0], self_k, self_v


def _start_tokens(config: AsrConfig, batch: int, max_tokens: int, device):
    tokens = torch.full((batch, max_tokens + 1), config.eot_token,
                        dtype=torch.int32, device=device)
    tokens[:, 0] = config.sot_token
    return tokens


def _greedy_next(config: AsrConfig, logits, finished):
    """argmax (first maximum on ties, as jnp.argmax); finished rows keep
    emitting eot."""
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(finished, config.eot_token, next_token)


def transcribe_rescore(params: dict, config: AsrConfig, mel,
                       max_tokens: int = 32):
    """Greedy transcription by FULL re-score per step (no KV cache): the
    simple quadratic loop, kept as the numerics oracle for the
    incremental path.  Every step runs the decoder's causal self- and
    cross-attention through flash_attention."""
    memory = encode_audio(params, config, mel)
    tokens = _start_tokens(config, mel.shape[0], max_tokens, mel.device)
    finished = torch.zeros((mel.shape[0],), dtype=torch.bool,
                           device=mel.device)
    for index in range(max_tokens):
        logits = decode_tokens(params, config, tokens[:, :-1], memory)
        next_token = _greedy_next(config, logits[:, index], finished)
        tokens[:, index + 1] = next_token
        finished = finished | (next_token == config.eot_token)
    return tokens[:, 1:]


def transcribe(params: dict, config: AsrConfig, mel, max_tokens: int = 32):
    """Greedy transcription: mel (B, n_mels, frames) -> (B, max_tokens)
    int32 token ids (eot-padded).  Encoder once, cross K/V once, then an
    incremental KV-cached decode loop of max_tokens steps (no early exit,
    as the JAX package's scan: stopping would cost a host sync per
    step)."""
    call = _asr_call(params, config)
    if call is not None:
        return _sharded_transcribe(call, params, mel, max_tokens)
    memory = encode_audio(params, config, mel)
    cross_k, cross_v = _cross_kv(params, config, memory)
    batch = mel.shape[0]
    shape = (_layer_count(params["dec_layers"]), batch, config.n_heads,
             max_tokens, config.head_dim)
    self_k = torch.zeros(shape, dtype=config.torch_dtype, device=mel.device)
    self_v = torch.zeros(shape, dtype=config.torch_dtype, device=mel.device)
    tokens = _start_tokens(config, batch, max_tokens, mel.device)
    finished = torch.zeros((batch,), dtype=torch.bool, device=mel.device)
    for index in range(max_tokens):
        token = tokens[:, index:index + 1]
        logits, self_k, self_v = _decode_step(
            params, config, token, index, self_k, self_v, cross_k, cross_v)
        next_token = _greedy_next(config, logits, finished)
        tokens[:, index + 1] = next_token
        finished = finished | (next_token == config.eot_token)
    return tokens[:, 1:]


def transcribe_audio(params: dict, config: AsrConfig, audio,
                     max_tokens: int = 32):
    """audio (B, samples) 16 kHz f32 -> (B, max_tokens) token ids: the
    log-mel frontend, then transcribe(), on audio's device."""
    mel = log_mel_spectrogram(audio, n_mels=config.n_mels)
    return transcribe(params, config, mel, max_tokens=max_tokens)


# -- the sharded path ---------------------------------------------------------
#
# The per-position counterparts of encode_audio, decode_tokens and
# transcribe on a tree laid out by asr_param_specs: the same functions
# of the same weights.  Per layer, one psum over fsdp for the fused
# q/k/v (and w1) partials, one psum over model plus one all_gather over
# fsdp after each output projection and after w2; the logits take one
# psum over fsdp.


def _asr_call(params: dict, config: AsrConfig) -> ShardedCall | None:
    """The call's view of the mesh of the tree's Sharded leaves, or None
    for a whole tree.  Every leaf must have asr_param_specs' layout."""
    leaf = next(sharded_leaves(params), None)
    if leaf is None:
        return None
    call = ShardedCall(leaf.mesh)
    wq = leaf_layout(params["enc_layers"]["attn"]["wq"]["w"], leaf.mesh)
    call.cut = {"model": call.size["model"] if "model" in wq[2] else 1,
                "fsdp": call.size["fsdp"] if "fsdp" in wq[1] else 1,
                "expert": 1}
    check_layout(params, asr_param_specs(config), leaf.mesh, call.cut,
                 "sharded whisper: params")
    if config.n_heads % call.cut["model"]:
        raise ValueError(f"n_heads ({config.n_heads}) must divide by the "
                         f"model axis ({call.cut['model']}): each model "
                         f"shard takes whole heads")
    call.heads = config.n_heads // call.cut["model"]
    call.config = config
    return call


def _norm(params, x):
    return map_shards(layer_norm, params, x)


def _add(a, b):
    return map_shards(torch.add, a, b)


def _mlp(call: ShardedCall, mlp, x):
    hidden, = column_parallel(call, [mlp["w1"]], x)
    return row_parallel(call, mlp["w2"], map_shards(_gelu, hidden))


def _sharded_attend(call: ShardedCall, attention, x, memory, causal: bool):
    """_attend on each model shard's heads."""
    if x is memory:
        q, k, v = column_parallel(
            call, [attention["wq"], attention["wk"], attention["wv"]], x)
    else:
        q, = column_parallel(call, [attention["wq"]], x)
        k, v = column_parallel(call, [attention["wk"], attention["wv"]],
                               memory)
    heads = call.heads
    out = map_shards(lambda q, k, v: _merge_heads(flash_attention(
        _split_heads(q, heads), _split_heads(k, heads),
        _split_heads(v, heads), causal=causal)), q, k, v)
    return row_parallel(call, attention["wo"], out)


def _sharded_embed(call: ShardedCall, grids, tokens):
    return call.all_gather(map_shards(
        lambda table, t: _embed({"token_embed": table}, t),
        grids["token_embed"], tokens), "fsdp")


def _sharded_logits(call: ShardedCall, grids, h):
    normed = call.slice_axis(_norm(grids["dec_norm"], h), "fsdp")
    return call.psum(map_shards(
        lambda table, x: _logits({"token_embed": table}, x),
        grids["token_embed"], normed), "fsdp")


def _sharded_encode(call: ShardedCall, params: dict, mel):
    config = call.config
    grids = call.dicts(params)
    x = map_shards(lambda c1, c2, positions, m: _encoder_input(
        c1, c2, positions, config, m), grids["conv1"], grids["conv2"],
        grids["enc_positions"], call.split_batch(mel))
    for index in range(_layer_count(params["enc_layers"])):
        layer = call.layer(grids["enc_layers"], index)
        normed = _norm(layer["attn_norm"], x)
        x = _add(x, _sharded_attend(call, layer["attn"], normed, normed,
                                    causal=False))
        x = _add(x, _mlp(call, layer["mlp"],
                         _norm(layer["mlp_norm"], x)))
    return _norm(grids["enc_norm"], x)


def _sharded_decode(call: ShardedCall, params: dict, tokens, memory):
    grids = call.dicts(params)
    length = next(t for t in tokens.flat if t is not None).shape[1]
    h = map_shards(lambda h, positions: h + positions[:length],
                   _sharded_embed(call, grids, tokens),
                   grids["dec_positions"])
    for index in range(_layer_count(params["dec_layers"])):
        layer = call.layer(grids["dec_layers"], index)
        normed = _norm(layer["self_norm"], h)
        h = _add(h, _sharded_attend(call, layer["self"], normed, normed,
                                    causal=True))
        h = _add(h, _sharded_attend(call, layer["cross"],
                                    _norm(layer["cross_norm"], h), memory,
                                    causal=False))
        h = _add(h, _mlp(call, layer["mlp"], _norm(layer["mlp_norm"], h)))
    return _sharded_logits(call, grids, h)


@torch.no_grad()
def _sharded_transcribe(call: ShardedCall, params: dict, mel,
                        max_tokens: int):
    """transcribe() on the shards: the encoder once, each layer's cross
    K/V once per model shard, then max_tokens cached decode steps whose
    self K/V caches hold each shard's heads."""
    config, heads = call.config, call.heads
    grids = call.dicts(params)
    memory = _sharded_encode(call, params, mel)
    layers = _layer_count(params["dec_layers"])
    dec = [call.layer(grids["dec_layers"], index) for index in range(layers)]
    cross = []
    for layer in dec:
        k, v = column_parallel(call, [layer["cross"]["wk"],
                                      layer["cross"]["wv"]], memory)
        cross.append(map_shards(lambda k, v: (_split_heads(k, heads),
                                              _split_heads(v, heads)), k, v))
    caches = map_shards(lambda kv: (
        torch.zeros((layers,) + kv[0].shape[:2] + (max_tokens,)
                    + kv[0].shape[3:], dtype=config.torch_dtype,
                    device=kv[0].device),
        torch.zeros((layers,) + kv[0].shape[:2] + (max_tokens,)
                    + kv[0].shape[3:], dtype=config.torch_dtype,
                    device=kv[0].device)), cross[0])
    batch = mel.shape[0]
    tokens = _start_tokens(config, batch, max_tokens, call.home)
    finished = torch.zeros((batch,), dtype=torch.bool, device=call.home)
    mask = (torch.arange(max_tokens, device=call.home)[None, None, None, :])
    scale = 1.0 / np.sqrt(config.head_dim)
    for index in range(max_tokens):
        token = call.split_batch(tokens[:, index:index + 1])
        h = map_shards(lambda h, positions: h + positions[
            min(index, positions.shape[0] - 1)][None, None],
            _sharded_embed(call, grids, token), grids["dec_positions"])
        for layer_index, layer in enumerate(dec):
            x = _norm(layer["self_norm"], h)
            q, k, v = column_parallel(call, [layer["self"]["wq"],
                                             layer["self"]["wk"],
                                             layer["self"]["wv"]], x)

            def self_attend(q, k, v, cache, layer_index=layer_index):
                self_k, self_v = cache[0][layer_index], cache[1][layer_index]
                self_k[:, :, index] = _split_heads(k, heads)[:, :, 0]
                self_v[:, :, index] = _split_heads(v, heads)[:, :, 0]
                scores = torch.einsum(
                    "bhqd,bhkd->bhqk", _split_heads(q, heads).float(),
                    self_k.float()) * scale
                scores = scores.masked_fill(mask.to(q.device) > index,
                                            _NEG_INF)
                att = torch.softmax(scores, dim=-1).to(self_v.dtype)
                with f32_reduction():
                    return _merge_heads(torch.einsum("bhqk,bhkd->bhqd",
                                                     att, self_v))
            h = _add(h, row_parallel(call, layer["self"]["wo"], map_shards(
                self_attend, q, k, v, caches)))
            qc, = column_parallel(call, [layer["cross"]["wq"]],
                                  _norm(layer["cross_norm"], h))
            h = _add(h, row_parallel(call, layer["cross"]["wo"], map_shards(
                lambda q, kv: _merge_heads(_attend_cached(
                    _split_heads(q, heads), kv[0], kv[1])),
                qc, cross[layer_index])))
            h = _add(h, _mlp(call, layer["mlp"],
                             _norm(layer["mlp_norm"], h)))
        logits = call.gather_home(_sharded_logits(call, grids, h))
        next_token = _greedy_next(config, logits[:, 0], finished)
        tokens[:, index + 1] = next_token
        finished = finished | (next_token == config.eot_token)
    return tokens[:, 1:]
