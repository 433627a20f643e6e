# ML pipeline elements backed by the port's model families.
#
# Counterpart of aiko_services_tpu/elements/ml.py: SpeechToText (the
# reference's PE_WhisperX seat, reference speech_elements.py:229-262),
# LMForward, LMGenerate (the reference's PE_LLM seat,
# elements_llm.py:137-210: chat template, detections context, streamed
# tokens) with its closed-batch path and its continuous decode engine
# (`continuous: true`, decode/engine.py: continuous batching, chunked
# prefill, speculative decode, the local prefix cache), Detector (the
# YoloDetector seat, yolo.py:51-87), DetectionsPublish, TokensToText and
# TextToTokens.  Everything runs on the element's device (`device`, CUDA
# unless the definition asks for the CPU).
#
# LMGenerate also serves the split fleet of the serving tier: `role:
# prefill` (decode/disagg.py PrefillEngine: frames return KV handoffs),
# the `handoff` input (the decode engine adopts the migrated KV), warm KV
# failover (`checkpoint`: decode/checkpoint.py snapshots, and the
# `restore` input a failing-over gateway attaches) and the cross-replica
# prefix store (`prefix_keeper`).
#
# TextToSpeech (the reference's Coqui seat) synthesizes through
# models/tts.py; the Detector loads ultralytics YOLOv8 checkpoints
# (models/yolo.py) as well as the native detector's.
#
# LMForward, the closed-batch LMGenerate and SpeechToText run on the
# element's mesh (the `sharding` block): their state spec defaults to the
# family's megatron tree filtered to the mesh (param_specs with the
# untied head's entry, quantized_param_specs under `weight_dtype: int8`,
# asr_param_specs), an explicit `state` spec winning, so the model runs
# its sharded path.  `sequence_parallel: true` with a "seq" axis runs the
# ring (or Ulysses) prefill and the sequence-parallel decode, the KV
# cache's length padded to divide the seq axis and the prompt
# left-padded to a multiple of it.  The decode and prefill engines
# (`continuous: true`, `role: prefill`) stay on one device and refuse a
# mesh, as the JAX package's do.
#
# A `weights` checkpoint in HuggingFace naming loads through the name maps
# of models/weights.py: Llama-family (model.embed_tokens.weight) for the
# LM elements, read straight into the element's shards on a mesh, and
# openai/whisper-* (model.encoder.conv1.weight) for SpeechToText, which
# then decodes between whisper's own special tokens.

from __future__ import annotations

import contextlib
import time
from dataclasses import replace

import numpy as np
import torch

from ..models import (
    YOLO_VARIANTS, AsrConfig, BPETokenizer, DetectorConfig, TTSConfig,
    TransformerConfig, count_params, detect, encode_chars, forward,
    generate, generate_stream, infer_yolov8_config, init_asr_params,
    init_detector_params, init_params, init_tts_params, load_llama_params,
    load_pytree, load_whisper_params, load_yolov8_params, quantize_weights_int8, synthesize, yolo_detect)
from ..models import configs as model_configs
from ..ops.device import as_device_array
from ..parallel.mesh import filter_specs, sharded_leaves, unshard, use_mesh
from ..pipeline import (
    AsyncHostElement, ComputeElement, PipelineElement, StreamEvent)
from ..utils import get_logger, truthy
from ..utils.padding import bucket_length, pad_axis_to

__all__ = ["LMForward", "LMGenerate", "SpeechToText", "TextToSpeech",
           "Detector", "DetectionsPublish", "TokensToText", "TextToTokens"]

_LOGGER = get_logger("ml_elements")

# "preset" parameter values -> reference-scale configs (configs.py)
_LM_PRESETS = {
    "llama3_8b": model_configs.LLAMA3_8B,
    "llama32_1b": model_configs.LLAMA32_1B,
    "toy": model_configs.LM_TOY,
}
_ASR_PRESETS = {
    "whisper_tiny": model_configs.WHISPER_TINY,
    "whisper_small": model_configs.WHISPER_SMALL,
}
_DETECTOR_PRESETS = {
    "yolov8n": model_configs.YOLOV8N_SHAPE,
    "toy": model_configs.DETECTOR_TOY,
}

# byte-level toy vocabulary shared by SpeechToText and TokensToText:
# 0=pad 1=sot 2=eot, 3..258 = bytes
_BYTE_OFFSET = 3


def _weights_named(weights, names) -> bool:
    """True when the checkpoint holds any of `names` (a naming
    convention: ultralytics selects the Detector's YOLOv8, HuggingFace
    names the Llama and whisper name maps).  Probes the FIRST shard when weights is a list
    (shards share one naming convention)."""
    if not weights:
        return False
    from ..models import SafetensorsFile
    probe = SafetensorsFile(weights[0] if isinstance(weights, list)
                            else weights)
    try:
        return any(name in probe for name in names)
    finally:
        probe.close()


def _host(value) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
    return np.asarray(value)


def _transformer_config(element) -> TransformerConfig:
    # sequence_parallel: long-context attention over the element mesh's
    # "seq" axis (ring prefill + sp decode); requires the element's
    # sharding block to name a seq axis
    sequence_parallel = truthy(
        element.get_parameter("sequence_parallel", False))
    # "int8" halves KV-cache memory and read bandwidth
    kv_dtype = str(element.get_parameter("kv_dtype", "") or "")
    preset = element.get_parameter("preset")
    if preset:
        config = _LM_PRESETS[str(preset)]
        dtype = element.get_parameter("dtype")
        if dtype:
            config = replace(config, dtype=str(dtype))
        if sequence_parallel:
            config = replace(config, sequence_parallel=True)
        if kv_dtype:
            config = replace(config, kv_dtype=kv_dtype)
        return config
    return TransformerConfig(
        vocab_size=int(element.get_parameter("vocab_size", 8192)),
        d_model=int(element.get_parameter("d_model", 512)),
        n_layers=int(element.get_parameter("n_layers", 8)),
        n_heads=int(element.get_parameter("n_heads", 8)),
        n_kv_heads=int(element.get_parameter("n_kv_heads", 4)),
        d_ff=int(element.get_parameter("d_ff", 1536)),
        max_seq_len=int(element.get_parameter("max_seq_len", 2048)),
        dtype=str(element.get_parameter("dtype", "bfloat16")),
        sequence_parallel=sequence_parallel,
        kv_dtype=kv_dtype,
    )


def _default_state_spec(element, spec_factory) -> None:
    """A meshed model element's state spec defaults to the family's
    megatron spec tree filtered to the element's mesh, not full
    replication (an 8B replicated on every position would not fit); an
    explicit sharding.state in the definition wins."""
    if element.mesh is not None and element._state_spec is None:
        element._state_spec = filter_specs(spec_factory(), element.mesh)


def _default_lm_state_spec(element, config) -> None:
    from ..models import param_specs, quantized_param_specs
    if str(element.get_parameter("weight_dtype", "") or "") == "int8":
        # the quantized tree carries w_scale planes the plain specs
        # don't know about
        _default_state_spec(
            element, lambda: quantized_param_specs(config, lm_head=True))
    else:
        _default_state_spec(
            element, lambda: param_specs(config, lm_head=True))


def _load_transformer_params(element, config: TransformerConfig):
    """weights parameter: path (or list of shard paths) to a safetensors
    checkpoint -- HuggingFace Llama naming (probed on the first shard) or
    the framework's save_pytree layout; absent -> seeded random init.
    weight_dtype "int8": weight-only serving quantization."""
    weights = element.get_parameter("weights")
    weight_dtype = str(element.get_parameter("weight_dtype", "") or "")
    if weights:
        paths = weights if isinstance(weights, list) else [weights]
        # a meshed element reads each tensor straight into its shards
        # (int8 quantizes whole tensors first)
        placed = element.mesh is not None and not weight_dtype
        mesh = element.mesh if placed else None
        specs = element._state_spec if placed else None
        if _weights_named(paths, ("model.embed_tokens.weight",)):
            params = load_llama_params(paths, config, mesh=mesh,
                                       specs=specs, device=element.device)
        else:
            params = load_pytree(paths[0], dtype=config.dtype,
                                 device=element.device, mesh=mesh,
                                 specs=specs)
    else:
        params = init_params(
            config,
            torch.Generator().manual_seed(
                int(element.get_parameter("seed", 0))),
            device=element.device)
    if weight_dtype == "int8":
        params = quantize_weights_int8(params, config)
    elif weight_dtype:
        raise ValueError(
            f"weight_dtype must be '' or 'int8', got {weight_dtype!r}")
    return params


def _tokenizer_for(element) -> BPETokenizer | None:
    """tokenizer parameter: "default" (the committed BPE asset), a path to
    a tokenizer json (ours or HuggingFace tokenizer.json), or unset ->
    None (byte-level toy vocabulary).  Loaded once per source and
    element."""
    source = element.get_parameter("tokenizer")
    if not source:
        return None
    cache = element.__dict__.setdefault("_tokenizers", {})
    tokenizer = cache.get(source)
    if tokenizer is None:
        tokenizer = cache[source] = (
            BPETokenizer.default() if source == "default"
            else BPETokenizer.from_file(source))
    return tokenizer


class LMForward(ComputeElement):
    """tokens (B, L) -> logits (B, L, V) + per-sequence mean NLL.

    The scoring workhorse: one full causal forward (every attention the
    flash-attention kernel on CUDA)."""

    def __init__(self, process, pipeline, definition):
        super().__init__(process, pipeline, definition)

    def configure(self):
        if not hasattr(self, "config"):
            self.config = _transformer_config(self)
            _default_lm_state_spec(self, self.config)

    def setup(self):
        params = _load_transformer_params(self, self.config)
        _LOGGER.info("%s: transformer %.1fM params",
                     self.definition.name, count_params(params) / 1e6)
        return params

    def compute(self, state, tokens):
        with torch.no_grad():
            logits = forward(state, self.config, tokens)
            tokens = unshard(tokens)
            log_probs = torch.log_softmax(logits[:, :-1], dim=-1)
            # jnp.take_along_axis(mode="clip"): out-of-vocab ids clamp
            targets = tokens[:, 1:].long().clamp(0, logits.shape[-1] - 1)
            taken = torch.gather(log_probs, -1, targets[..., None])[..., 0]
        return {"logits": logits, "nll": -torch.mean(taken, dim=-1)}


class LMGenerate(ComputeElement):
    """tokens (B, L) prompt -> generated (B, max_new_tokens) greedy
    tokens (int32).

    Closed batch (the default): owns its KV cache; a frame's generation
    is a prefill and one cached step per token, so the pipeline only sees
    whole completions.  `continuous: true`: each frame's rows are
    submitted to the slot-based DecodeEngine and the frame parks until
    they complete (decode_slots, kv_block_size, kv_blocks, max_context,
    eos_id, prefill_chunk_size, speculative, prefix_policy, checkpoint,
    prefix_keeper, adopt_timeout; the `handoff` and `restore` inputs).
    `role: prefill`: frames run the PrefillEngine and return KV handoffs.

    Chat semantics (reference elements_llm.py:137-210): a "system_prompt"
    parameter and optional "chat_template" ({system}/{context}/{user}
    fields) format text prompts; with "detections_subscribe" the element
    watches the "{namespace}/detections" side-channel (or an explicit
    "detections_topic") and injects objects seen within
    "detections_window" seconds (default 1.0, the reference's freshness
    rule, elements_llm.py:196-210) into {context}.
    """

    def __init__(self, process, pipeline, definition):
        super().__init__(process, pipeline, definition)
        # continuous-mode engine state: present (None/empty) from
        # construction so observers can poll without racing the first
        # frame's lazy _ensure_engine()
        self._engine = None
        self._engine_frames = {}
        # subscribe at CONSTRUCTION (not lazy setup): detections published
        # before the first frame must still be visible to that frame's
        # prompt, like the reference's init-time subscription
        # (elements_llm.py:196-210)
        self._detections = None  # (names, seen_at)
        from ..utils import parse
        topic = self.get_parameter("detections_topic")
        if topic or truthy(self.get_parameter("detections_subscribe",
                                              False)):
            topic = str(topic or f"{self.process.namespace}/detections")

            def handler(_topic, payload):
                try:
                    command, parameters = parse(payload)
                except ValueError:
                    return
                if command != "detections":
                    return
                names = (parameters[0] if parameters
                         and isinstance(parameters[0], list)
                         else parameters)
                self._detections = ([str(name) for name in names],
                                    time.time())

            self._detections_handler = (handler, topic)
            self.process.add_message_handler(handler, topic)

    def engine_managed(self, stream):
        return truthy(self.get_parameter("continuous", False, stream))

    def disagg_role(self, stream=None) -> str:
        """Disaggregated-fleet role: "" (co-located, the default),
        "prefill" (prompt prefills only -- frames return a KV handoff
        instead of tokens), or "decode" (the continuous engine, which
        ADOPTS incoming handoffs instead of re-prefilling)."""
        return str(self.get_parameter("role", "", stream) or "")

    def configure(self):
        if not hasattr(self, "config"):
            self.config = _transformer_config(self)
            self.tokenizer = _tokenizer_for(self)
            _default_lm_state_spec(self, self.config)

    def setup(self):
        return _load_transformer_params(self, self.config)

    def _format_prompt(self, stream, text: str) -> str:
        """Chat formatting: system prompt + fresh vision context + user
        turn.  Plain passthrough when neither is configured."""
        system = self.get_parameter("system_prompt", None, stream)
        template = self.get_parameter("chat_template", None, stream)
        context = ""
        if self._detections is not None:
            names, seen_at = self._detections
            window = float(self.get_parameter(
                "detections_window", 1.0, stream))
            if names and time.time() - seen_at <= window:
                context = ("Visible objects: "
                           + ", ".join(names) + ".\n")
        if not (system or template or context):
            return text
        template = template or "{system}\n{context}{user}"
        # plain substitution, NOT str.format: templates legitimately
        # contain literal braces (JSON / S-expression reply formats)
        return (template.replace("{system}", system or "")
                .replace("{context}", context)
                .replace("{user}", text))

    def stop(self) -> None:
        handler = getattr(self, "_detections_handler", None)
        if handler is not None:
            self.process.remove_message_handler(*handler)
            self._detections_handler = None
        super().stop()

    def _sp_cache(self, batch: int, max_len: int):
        """KV cache laid out for sequence-parallel decode: length sharded
        over the element mesh's seq axis (padded to divide it)."""
        from ..models import init_sp_cache
        if self.mesh is None or "seq" not in self.mesh.axis_names:
            raise ValueError(
                f"{self.definition.name}: sequence_parallel needs a "
                "sharding block whose axes include 'seq'")
        return init_sp_cache(self.config, batch, max_len, self.mesh,
                             device=self.device)

    def _encode_prompts(self, stream, text):
        """Text prompts -> left-padded (B, W) int32 token matrix plus the
        post-template prompt strings."""
        prompts = [text] if isinstance(text, str) else list(text)
        if self.tokenizer is None:
            raise ValueError("text input needs a tokenizer parameter")
        prompts = [self._format_prompt(stream, prompt)
                   for prompt in prompts]
        encoded = [self.tokenizer.encode(p, bos=True) for p in prompts]
        width = max(len(ids) for ids in encoded)
        pad = self.tokenizer.pad_id or 0
        tokens = np.full((len(encoded), width), pad, np.int32)
        for row, ids in enumerate(encoded):
            tokens[row, width - len(ids):] = ids  # left-pad
        return tokens, prompts

    def process_frame(self, stream, tokens=None, text=None,
                      handoff=None, restore=None):
        if self.disagg_role(stream) == "prefill":
            return self._process_frame_prefill(stream, tokens, text)
        if self.engine_managed(stream):
            return self._process_frame_continuous(stream, tokens, text,
                                                  handoff, restore)
        self._ensure_ready()
        max_new = int(self.get_parameter("max_new_tokens", 32, stream))
        formatted = None
        if tokens is None:
            if text is None:
                raise ValueError("LMGenerate needs tokens or text input")
            tokens, formatted = self._encode_prompts(stream, text)
        tokens = as_device_array(tokens, torch.int32, self.device)
        pad = ((self.tokenizer.pad_id or 0)
               if self.tokenizer is not None else 0)
        batch = tokens.shape[0]
        if self.config.sequence_parallel:
            tokens = self._sp_tokens(tokens, pad)
        # sequence_parallel: ring prefill + sp decode run on the AMBIENT
        # mesh, and the cache must be seq-sharded
        mesh_scope = (use_mesh(self.mesh) if self.mesh is not None
                      else contextlib.nullcontext())
        with mesh_scope:
            # sharded parameters: generate lays its cache out over their
            # mesh by cache_specs (padded to the seq axis)
            sharded = next(sharded_leaves(self.state), None) is not None
            cache = (self._sp_cache(tokens.shape[0],
                                    tokens.shape[1] + max_new)
                     if self.config.sequence_parallel and not sharded
                     else None)
            if truthy(self.get_parameter("stream_tokens", False, stream)):
                # streamed serving path: publish token chunks to /out as
                # they decode (reference capability: Ollama streaming)
                chunk = int(self.get_parameter("stream_chunk", 8, stream))
                blocks = []
                for offset, block in generate_stream(
                        self.state, self.config, tokens, max_new,
                        cache=cache, chunk=chunk):
                    block = block[:batch]  # drop batch-padding rows
                    blocks.append(block)
                    payload = block.tolist()
                    if self.tokenizer is not None:
                        payload = [self.tokenizer.decode(row)
                                   for row in block]
                    self.publish_out("tokens",
                                     [stream.stream_id, offset, payload])
                out = np.concatenate(blocks, axis=1)
            else:
                out, _ = generate(self.state, self.config, tokens, max_new,
                                  cache=cache)
                out = out[:batch]
        result = {"generated": out}
        if formatted is not None:
            result["prompt"] = formatted  # post-template (observability)
        if self.tokenizer is not None:
            result["text"] = [self.tokenizer.decode(row)
                              for row in _host(out)]
        return StreamEvent.OKAY, result

    def _sp_tokens(self, tokens, pad: int):
        """The prompt as the sequence-parallel path takes it.  The ring
        prefill shards the prompt over the seq axis: LEFT-pad it up to a
        seq multiple with the SAME pad id as the batch left-padding (pad
        tokens are causally attended, so a divergent id would change
        generation for widths not divisible by the seq axis).  The
        seq-sharded cache also shards BATCH over the data axis: ragged
        batches gain dummy rows, sliced off the output."""
        seq_size = (self.mesh.shape.get("seq", 1)
                    if self.mesh is not None else 1)
        width = tokens.shape[1]
        target = ((width + seq_size - 1) // seq_size) * seq_size
        if target != width:
            pad_block = torch.full((tokens.shape[0], target - width), pad,
                                   dtype=torch.int32, device=tokens.device)
            tokens = torch.cat([pad_block, tokens], dim=1)
        data_size = (self.mesh.shape.get("data", 1)
                     if self.mesh is not None else 1)
        extra = (-tokens.shape[0]) % data_size
        if extra:
            tokens = pad_axis_to(tokens, 0, tokens.shape[0] + extra,
                                 pad_value=pad)
        return tokens

    # -- continuous batching (decode/ engine) ------------------------------
    #
    # `continuous: true` swaps the closed batch for the slot-based
    # DecodeEngine: each frame's rows are SUBMITTED as requests and the
    # frame parks (StreamEvent.PENDING) while the engine interleaves its
    # decode steps with every other in-flight frame's.  The pump rides the
    # element's own mailbox -- one engine step per message -- so frames
    # arriving on the pipeline mailbox are admitted into the RUNNING
    # decode loop at prefill boundaries instead of convoying behind a
    # closed batch.  Completions resume their frame through the ordinary
    # process_frame_response path, with the closed batch's tokens.

    def _ensure_engine(self):
        engine = getattr(self, "_engine", None)
        if engine is not None:
            return engine
        self._ensure_ready()
        if self.mesh is not None or self.config.sequence_parallel:
            raise ValueError(
                f"{self.definition.name}: continuous mode runs the paged "
                f"decode engine single-device; drop the sharding mesh / "
                f"sequence_parallel or use the closed-batch path")
        from ..decode import DecodeEngine
        telemetry = getattr(self.pipeline, "telemetry", None)
        registry = (telemetry.registry if telemetry is not None
                    and telemetry.enabled else None)
        kv_blocks = self.get_parameter("kv_blocks")
        max_context = self.get_parameter("max_context")
        eos_id = self.get_parameter("eos_id")
        prefill_chunk = self.get_parameter("prefill_chunk_size")
        draft_params, draft_config, spec_k = self._speculative_setup()
        prefix_spec = self.get_parameter("prefix_policy")
        prefix_policy = None
        if prefix_spec:
            # the spec parses through the AIKO411 grammar AS-IS (string
            # or dict, the value lint checked): a bad value fails here
            # with the message `aiko lint` reports
            from ..decode.prefix import PrefixPolicy
            prefix_policy = PrefixPolicy.parse(prefix_spec)
            prefix_policy.validate_engine()
        self._engine = DecodeEngine(
            self.state, self.config,
            decode_slots=int(self.get_parameter("decode_slots", 4)),
            kv_block_size=int(self.get_parameter("kv_block_size", 16)),
            kv_blocks=int(kv_blocks) if kv_blocks else None,
            max_context=int(max_context) if max_context else None,
            eos_id=int(eos_id) if eos_id is not None else None,
            prefill_chunk_size=(int(prefill_chunk) if prefill_chunk
                                else None),
            draft_params=draft_params, draft_config=draft_config,
            spec_k=spec_k,
            prefix_policy=prefix_policy,
            registry=registry)
        self._prefix_heads_shared = ""
        self._engine_frames = {}
        self._pump_posted = False
        self._checkpointer = None
        spec = self.get_parameter("checkpoint")
        if spec:
            # warm KV failover (decode/checkpoint.py): ship incremental
            # decode-state snapshots to the named keeper so a crash
            # restores on a survivor instead of re-prefilling.  The spec
            # parses through the AIKO409 grammar AS-IS (string or dict,
            # the value lint checked): a bad value fails here with the
            # message `aiko lint` reports
            from ..decode.checkpoint import (
                CheckpointPolicy, DecodeCheckpointer)
            policy = CheckpointPolicy.parse(spec)
            policy.validate_engine()
            on_checkpoint = (telemetry.record_checkpoint
                             if telemetry is not None
                             and telemetry.enabled else None)
            self._checkpointer = DecodeCheckpointer(
                self._engine, policy, registry=registry,
                node=self.definition.name, on_checkpoint=on_checkpoint)
        return self._engine

    def _speculative_setup(self):
        """`speculative` parameter -> (draft_params, draft_config, k).
        `draft=self` shrinks the TARGET's config family (layers/d_ff
        overrides); `draft=<preset>` instantiates an _LM_PRESETS entry,
        which must share the target's vocabulary.  The draft's weights are
        random from a torch.Generator seeded by `seed` (jax.random's
        cannot be reproduced); greedy-exact acceptance makes the tokens
        independent of the draft -- a weak one only costs acceptance
        length."""
        spec = self.get_parameter("speculative")
        if not spec:
            return None, None, 0
        from ..analyze.policies import parse_speculative_spec
        parsed = parse_speculative_spec(str(spec))
        draft = parsed["draft"]
        if draft == "self":
            draft_config = self.config
        elif draft in _LM_PRESETS:
            draft_config = _LM_PRESETS[draft]
            if draft_config.dtype != self.config.dtype:
                draft_config = replace(draft_config,
                                       dtype=self.config.dtype)
        else:
            raise ValueError(
                f"{self.definition.name}: speculative draft={draft!r} "
                f"is neither 'self' nor a preset "
                f"{sorted(_LM_PRESETS)}")
        overrides = {}
        if "layers" in parsed:
            overrides["n_layers"] = parsed["layers"]
        if "d_ff" in parsed:
            overrides["d_ff"] = parsed["d_ff"]
        if overrides:
            draft_config = replace(draft_config, **overrides)
        draft_params = init_params(
            draft_config,
            torch.Generator().manual_seed(int(parsed.get("seed", 0))),
            device=self.device)
        return draft_params, draft_config, parsed["k"]

    # -- disaggregated prefill (decode/disagg.py PrefillEngine) ------------
    #
    # `role: prefill` turns the element into the prompt half of a
    # split fleet: frames run paged_prefill / paged_prefill_chunk into
    # a private paged pool and the response carries a KV HANDOFF (one
    # JSON-safe record per row: prompt + first token + `__tensorref__`
    # descriptors for the prompt's KV blocks) instead of tokens.  A
    # decode-role replica adopts the handoff into a free slot and
    # continues greedy decode bit-identically -- no re-prefill.

    def _ensure_prefill_engine(self):
        engine = getattr(self, "_prefill_engine", None)
        if engine is not None:
            return engine
        self._ensure_ready()
        if self.mesh is not None or self.config.sequence_parallel:
            raise ValueError(
                f"{self.definition.name}: role=prefill runs the paged "
                f"prefill engine single-device; drop the sharding mesh "
                f"/ sequence_parallel")
        from ..decode import PrefillEngine
        telemetry = getattr(self.pipeline, "telemetry", None)
        registry = (telemetry.registry if telemetry is not None
                    and telemetry.enabled else None)
        max_context = self.get_parameter("max_context")
        prefill_chunk = self.get_parameter("prefill_chunk_size")
        self._prefill_engine = PrefillEngine(
            self.state, self.config,
            kv_block_size=int(self.get_parameter("kv_block_size", 16)),
            max_context=int(max_context) if max_context else None,
            prefill_chunk_size=(int(prefill_chunk) if prefill_chunk
                                else None),
            registry=registry, device=self.device)
        self._prefill_frames = {}
        self._prefill_pump_posted = False
        return self._prefill_engine

    def _process_frame_prefill(self, stream, tokens, text):
        engine = self._ensure_prefill_engine()
        if tokens is None:
            if text is None:
                raise ValueError("LMGenerate needs tokens or text input")
            tokens, _ = self._encode_prompts(stream, text)
        tokens = _host(tokens).astype(np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        max_new = int(self.get_parameter("max_new_tokens", 32, stream))
        key = (stream.stream_id, stream.current_frame_id)
        # fleet tracing: the prefill frame's (possibly gateway-minted)
        # trace context is frozen here so the finished KV handoff can
        # carry it -- the adopting decode replica parents its adopt
        # span under THIS prefill hop, not just the gateway root
        frame = stream.frames.get(stream.current_frame_id)
        trace = getattr(frame, "trace", None) if frame is not None \
            else None
        context = None
        if trace is not None:
            from ..observe.trace import make_trace_context
            context = make_trace_context(trace)
        self._prefill_frames[key] = {
            "rows": tokens.shape[0], "done": {},
            "submitted_at": time.perf_counter(),
            "trace_context": context,
        }
        try:
            for row in range(tokens.shape[0]):
                engine.submit(key + (row,), tokens[row], max_new)
        except ValueError:
            self._prefill_frames.pop(key, None)
            engine.cancel(lambda rid: rid[:2] == key)
            raise
        self._schedule_prefill_pump()
        return StreamEvent.PENDING, None

    def _schedule_prefill_pump(self):
        if not getattr(self, "_prefill_pump_posted", False):
            self._prefill_pump_posted = True
            self.post_message("_prefill_pump", [])

    def _prefill_pump(self):
        self._prefill_pump_posted = False
        engine = getattr(self, "_prefill_engine", None)
        if engine is None:
            return
        try:
            for handoff in engine.step():
                self._finish_prefill_handoff(handoff)
        except Exception as error:
            self._fail_prefill_frames(error)
            return
        if engine.has_work():
            self._schedule_prefill_pump()

    def _finish_prefill_handoff(self, handoff):
        stream_id, frame_id, row = handoff["request_id"]
        key = (stream_id, frame_id)
        entry = self._prefill_frames.get(key)
        if entry is None:
            return  # stream destroyed mid-prefill
        record = dict(handoff)
        record["request_id"] = row  # peer-local identity, JSON-safe
        if entry.get("trace_context"):
            # the handoff DESCRIPTOR carries the trace context: even a
            # handoff forwarded through a telemetry-disabled gateway
            # still links decode's adopt span to this prefill hop
            record["trace_context"] = entry["trace_context"]
        entry["done"][row] = record
        if len(entry["done"]) < entry["rows"]:
            return
        outputs = {"handoff": [entry["done"][r]
                               for r in range(entry["rows"])]}
        self.pipeline.post_message("process_frame_response", [
            {"stream_id": stream_id, "frame_id": frame_id,
             "node": self.definition.name,
             "time": time.perf_counter() - entry["submitted_at"]},
            outputs])
        del self._prefill_frames[key]

    def _fail_prefill_frames(self, error):
        """Prefill engine failure: release every PENDING frame with an
        error response (the stream applies its on_error policy; a
        disagg gateway degrades the frame to a local decode-side
        prefill) and rebuild the engine lazily."""
        _LOGGER.error("%s: prefill engine failed, releasing %d frames: "
                      "%s", self.definition.name,
                      len(getattr(self, "_prefill_frames", {})), error)
        frames = getattr(self, "_prefill_frames", {})
        self._prefill_frames = {}
        self._prefill_engine = None
        for stream_id, frame_id in frames:
            self.pipeline.post_message("process_frame_response", [
                {"stream_id": stream_id, "frame_id": frame_id,
                 "node": self.definition.name, "event": "error"}, {}])

    def prefill_stats(self) -> dict | None:
        """Live prefill-engine occupancy; None before the first
        prefill frame."""
        engine = getattr(self, "_prefill_engine", None)
        return None if engine is None else engine.stats()

    def _process_frame_continuous(self, stream, tokens, text,
                                  handoff=None, restore=None):
        engine = self._ensure_engine()
        formatted = None
        handoffs = None
        if handoff:
            # disaggregated hop 2: adopt the prefill pool's KV blocks
            # instead of re-prefilling the prompt locally
            handoffs = handoff if isinstance(handoff, list) else [handoff]
            rows = len(handoffs)
        else:
            if tokens is None:
                if text is None:
                    raise ValueError(
                        "LMGenerate needs tokens, text, or handoff "
                        "input")
                tokens, formatted = self._encode_prompts(stream, text)
            tokens = _host(tokens).astype(np.int32)
            if tokens.ndim == 1:
                tokens = tokens[None]
            rows = tokens.shape[0]
        max_new = int(self.get_parameter("max_new_tokens", 32, stream))
        key = (stream.stream_id, stream.current_frame_id)
        self._engine_frames[key] = {
            "rows": rows, "done": {},
            "formatted": formatted, "max_new": max_new,
            "submitted_at": time.perf_counter(),
            "stream_tokens": truthy(self.get_parameter(
                "stream_tokens", False, stream)),
            "chunk": max(1, int(self.get_parameter(
                "stream_chunk", 8, stream))),
            "buffers": {},
            # cross-replica prefix store (decode/prefix.py): the
            # gateway injects `prefix_keeper` when it runs both a
            # checkpoint keeper and a prefix policy; prompts are kept
            # so finished requests can export their cached prefix
            "prefix_keeper": str(self.get_parameter(
                "prefix_keeper", "", stream) or ""),
            "prompts": None,
        }
        # submission order == row order; the engine's FIFO admission
        # keeps caller-observed ordering deterministic.  A rejected row
        # (e.g. prompt + max_new over max_context) must not leak the
        # frame entry or strand already-queued sibling rows
        try:
            if handoffs is not None:
                timeout = self.get_parameter("adopt_timeout", None,
                                             stream)
                adopt_s = time.perf_counter()
                upstream = None
                for row, record in enumerate(handoffs):
                    if isinstance(record, dict) \
                            and "trace_context" in record:
                        # the prefill hop's trace identity rides the
                        # handoff descriptor: strip it before the
                        # engine sees the record, keep it as the adopt
                        # span's parent link
                        record = dict(record)
                        upstream = record.pop("trace_context") or \
                            upstream
                    report = engine.adopt_request(
                        key + (row,), record,
                        timeout=(float(timeout) if timeout else None))
                    for rid, _offset, token in report.emitted:
                        self._buffer_streamed_token(rid, token)
                    for completion in report.completions:
                        self._finish_request(completion)
                self._note_adopt_span(stream, key,
                                      time.perf_counter() - adopt_s,
                                      parent=upstream)
            elif restore:
                self._restore_rows(stream, key, tokens, max_new,
                                   restore)
            else:
                if engine.prefix is not None:
                    self._engine_frames[key]["prompts"] = tokens
                    self._prewarm_prefix(stream, tokens)
                for row in range(rows):
                    engine.submit(key + (row,), tokens[row], max_new)
        except ValueError:
            self._engine_frames.pop(key, None)
            engine.cancel(lambda rid: rid[:2] == key)
            raise
        self._schedule_pump()
        return StreamEvent.PENDING, None

    def _restore_rows(self, stream, key, tokens, max_new,
                      restore) -> None:
        """Warm failover (decode/checkpoint.py): a gateway replaying a
        dead decode replica's frames attached a RESTORE hint naming
        the checkpoint keeper.  Each row asks the keeper for its
        snapshot (keyed by (stream_id, frame_id, row) -- stable across
        replicas) and resumes via engine.restore_request; a missing/
        stale/unfetchable snapshot degrades to the ordinary re-prefill
        inside restore_request, so the frame is never lost.  The
        optional `resume_from` map (row -> highest token offset the
        client already holds) makes re-emission resume gaplessly."""
        from ..decode.checkpoint import get_keeper
        engine = self._engine
        hint = restore if isinstance(restore, dict) else {}
        keeper = get_keeper(str(hint.get("keeper") or ""))
        resume_map = hint.get("resume_from") or {}
        timeout = self.get_parameter("adopt_timeout", None, stream)
        restore_s = time.perf_counter()
        entry = self._engine_frames[key]
        for row in range(tokens.shape[0]):
            request_key = key + (row,)
            record = None
            if keeper is not None:
                try:
                    record = keeper.restore(request_key)
                except (KeyError, ValueError) as error:
                    _LOGGER.info("%s: keeper has no snapshot for %r "
                                 "(%s); re-prefilling",
                                 self.definition.name, request_key,
                                 error)
            resume = int(resume_map.get(row,
                                        resume_map.get(str(row), 0))
                         or 0)
            restores_before = engine.counters["restores"]
            report = engine.restore_request(
                request_key, record, prompt_tokens=tokens[row],
                max_new_tokens=max_new,
                timeout=(float(timeout) if timeout else None),
                resume_from=resume)
            if (resume and entry["stream_tokens"]
                    and engine.counters["restores"] > restores_before):
                # a RESTORED row resumes emission at the client's
                # floor: the chunk buffer must publish offsets from
                # there, not from 0 -- an offset-keyed consumer would
                # otherwise overwrite its held prefix with later
                # tokens.  A FALLBACK row re-prefills and re-emits
                # from offset 0, so its buffer keeps the default start
                entry["buffers"][row] = [min(resume, max_new), []]
            for rid, _offset, token in report.emitted:
                self._buffer_streamed_token(rid, token)
            for completion in report.completions:
                self._finish_request(completion)
        # restores ride the adopt span category: both are KV
        # migrations, and tune's migration-bound classifier should see
        # failover restores exactly as it sees prefill-pool adoptions;
        # the hint's trace context (frozen at failover) parents the
        # span under the gateway's replayed-frame root
        hint_context = hint.get("trace_context")
        self._note_adopt_span(
            stream, key, time.perf_counter() - restore_s,
            parent=(hint_context
                    if isinstance(hint_context, dict) else None))

    def _note_adopt_span(self, stream, key, elapsed_s: float,
                         parent: dict | None = None) -> None:
        """Record the adopt (KV-migration) span on the frame trace so
        `aiko tune` can attribute migration-bound waits distinctly from
        slot-queue waits.  `parent` is the upstream (prefill-hop) trace
        context the handoff descriptor carried, linking the adopt span
        across processes in a merged fleet artifact."""
        telemetry = getattr(self.pipeline, "telemetry", None)
        if telemetry is None or not telemetry.enabled:
            return
        telemetry.record_adopt(
            self.pipeline.streams.get(key[0]), key[1],
            self.definition.name, elapsed_s, parent=parent)

    def _prewarm_prefix(self, stream, tokens) -> None:
        """Second-chance CROSS-REPLICA prefix pre-warm: when this
        prompt's hash chain has no local cache hit, ask the stream's
        `prefix_keeper` (injected by the gateway when it runs both a
        checkpoint keeper and a prefix policy) for a snapshot keyed by
        the chain head and adopt it into the local cached tier over
        the transfer plane -- so a follow-up turn landing on a COLD
        replica still skips the shared-prefix prefill.  Best-effort
        end to end: any miss/failure just means a normal cold
        prefill."""
        engine = self._engine
        keeper_name = str(self.get_parameter(
            "prefix_keeper", "", stream) or "")
        if not keeper_name:
            return
        from ..decode.checkpoint import get_keeper
        from ..decode.prefix import chain_hashes
        keeper = get_keeper(keeper_name)
        if keeper is None:
            return
        timeout = self.get_parameter("adopt_timeout", None, stream)
        for row in range(tokens.shape[0]):
            hashes = chain_hashes(tokens[row],
                                  engine.blocks.block_size)
            if not hashes or engine.prefix.lookup(hashes):
                continue      # local hit (or sub-block prompt)
            try:
                record = keeper.restore(("prefix", hashes[0]))
            except (KeyError, ValueError):
                continue
            engine.adopt_prefix(
                record, timeout=(float(timeout) if timeout else None))

    def _export_prefix(self, entry: dict, row: int) -> None:
        """Offer a finished request's cached prefix blocks to the
        stream's prefix keeper (once per chain: skipped when the
        keeper already holds it).  The keeper ingests asynchronously,
        so this never blocks the engine pump."""
        engine = getattr(self, "_engine", None)
        if engine is None or engine.prefix is None:
            return
        prompts = entry.get("prompts")
        if prompts is None:
            return
        from ..decode.checkpoint import get_keeper
        keeper = get_keeper(entry["prefix_keeper"])
        if keeper is None:
            return
        snapshot = engine.export_prefix_snapshot(prompts[row])
        if snapshot is None:
            return
        if keeper.kept_blocks(tuple(snapshot["request_id"])) \
                >= snapshot["blocks_total"]:
            return
        keeper.store(snapshot)

    def _publish_prefix_heads(self, engine) -> None:
        """Mirror the cache's resident chain-head digests into the
        pipeline share (comma-joined, on change only) -- the compact
        summary gateway prefix-affinity routing scores against."""
        heads = ",".join(engine.prefix_heads())
        if heads != getattr(self, "_prefix_heads_shared", ""):
            self._prefix_heads_shared = heads
            self.pipeline.set_parameter("prefix_heads", heads)

    def _schedule_pump(self):
        """At most ONE pump message in flight: each tick runs one engine
        step and re-posts itself while the engine has work, so the
        mailbox interleaves admissions with decode progress."""
        if not getattr(self, "_pump_posted", False):
            self._pump_posted = True
            self.post_message("_engine_pump", [])

    def _engine_pump(self):
        self._pump_posted = False
        engine = getattr(self, "_engine", None)
        if engine is None:
            return
        try:
            report = engine.step()
            for request_id, _offset, token in report.emitted:
                self._buffer_streamed_token(request_id, token)
            for completion in report.completions:
                self._finish_request(completion)
            if getattr(self, "_checkpointer", None) is not None:
                # live cadence override: a gateway's
                # set_replica_parameter retunes `checkpoint_every`, so
                # the policy is re-read each step (wire values arrive as
                # strings) and takes effect on the NEXT cadence tick --
                # never a checkpointer rebuild, never a restart
                cadence = self.get_parameter("checkpoint_every")
                if cadence is not None:
                    try:
                        cadence = int(cadence)
                    except (TypeError, ValueError):
                        cadence = None
                if cadence is not None and cadence > 0 and cadence \
                        != self._checkpointer.policy.checkpoint_every:
                    self._checkpointer.policy.checkpoint_every = cadence
                # one cadence tick per engine step: a failed offer keeps
                # the keeper's previous snapshot, a device fault in the
                # gather fails the engine's frames like a step's would
                self._checkpointer.tick()
            if engine.prefix is not None:
                self._publish_prefix_heads(engine)
        except Exception as error:
            # the mailbox swallows exceptions, so an unguarded failure
            # here (device error, tokenizer crash) would strand every
            # PENDING frame with the pump never re-posted
            self._fail_engine_frames(error)
            return
        if engine.has_work():
            self._schedule_pump()

    def _fail_engine_frames(self, error):
        """Engine failure: every in-flight frame gets an error response
        (the AsyncHostElement contract, element.py) so streams apply
        their on_error policy instead of hanging; the engine is dropped
        and lazily rebuilt by the next continuous frame."""
        _LOGGER.error("%s: decode engine failed, releasing %d in-flight "
                      "frame(s): %s", self.definition.name,
                      len(self._engine_frames), error)
        frames, self._engine_frames = self._engine_frames, {}
        self._engine = None
        self._checkpointer = None  # rebuilt with the engine
        for stream_id, frame_id in frames:
            self.pipeline.post_message("process_frame_response", [
                {"stream_id": stream_id, "frame_id": frame_id,
                 "node": self.definition.name, "event": "error"}, {}])

    def _buffer_streamed_token(self, request_id, token):
        entry = self._engine_frames.get(request_id[:2])
        if entry is None or not entry["stream_tokens"]:
            return
        row = request_id[2]
        buffer = entry["buffers"].setdefault(row, [0, []])
        buffer[1].append(int(token))
        if len(buffer[1]) >= entry["chunk"]:
            self._flush_stream_buffer(request_id[:2], entry, row)

    def _flush_stream_buffer(self, key, entry, row):
        """Publish one token chunk for one request row:
        `(token_chunk stream_id frame_id row offset payload)` -- offset
        is the row's completion-token offset of the chunk's first token
        (a preempted request's regenerated tokens are never re-emitted,
        so offsets stay gapless).  Not the closed batch's `(tokens
        stream_id offset payload)` command: one command name, one
        schema."""
        start, chunk = entry["buffers"].pop(row, (0, []))
        if not chunk:
            return
        payload = ([self.tokenizer.decode(np.asarray(chunk, np.int32))]
                   if self.tokenizer is not None else [chunk])
        self.publish_out("token_chunk",
                         [key[0], key[1], row, start, payload])
        entry["buffers"][row] = [start + len(chunk), []]

    def _finish_request(self, completion):
        checkpointer = getattr(self, "_checkpointer", None)
        if checkpointer is not None:
            # a cleanly finished request's snapshots are dead weight on
            # the keeper; FENCED streams (failover) deliberately skip
            # this -- their snapshots are what the survivor restores
            checkpointer.forget(completion.request_id)
        stream_id, frame_id, row = completion.request_id
        key = (stream_id, frame_id)
        entry = self._engine_frames.get(key)
        if entry is None:
            return  # stream destroyed mid-decode; engine.cancel raced
        if entry["stream_tokens"]:
            self._flush_stream_buffer(key, entry, row)
            entry["buffers"].pop(row, None)
        if entry.get("prefix_keeper"):
            self._export_prefix(entry, row)
        entry["done"][row] = completion
        if len(entry["done"]) < entry["rows"]:
            return
        # the entry stays registered until the response is POSTED: a
        # crash in decode/telemetry below must leave the key visible to
        # _fail_engine_frames or the frame would park forever
        out = np.stack([entry["done"][r].tokens
                        for r in range(entry["rows"])])
        outputs = {"generated": out}
        if entry["formatted"] is not None:
            outputs["prompt"] = entry["formatted"]
        if self.tokenizer is not None:
            outputs["text"] = [self.tokenizer.decode(r) for r in out]
        stats = [entry["done"][r].stats for r in range(entry["rows"])]
        pipeline = self.pipeline
        telemetry = getattr(pipeline, "telemetry", None)
        if telemetry is not None:
            stream = pipeline.streams.get(stream_id)
            frame = (stream.frames.get(frame_id)
                     if stream is not None else None)
            if frame is not None:
                telemetry.record_engine_frame(
                    frame, self.definition.name, stats)
        # "time" is the element-compute share only: the engine's slot
        # wait is reported as time_queue_{node} by record_engine_frame
        queue_wait = max((float(s.get("queue_wait_s", 0.0))
                          for s in stats), default=0.0)
        total = time.perf_counter() - entry["submitted_at"]
        pipeline.post_message("process_frame_response", [
            {"stream_id": stream_id, "frame_id": frame_id,
             "node": self.definition.name,
             "time": max(total - queue_wait, 0.0)},
            outputs])
        del self._engine_frames[key]

    def stop_stream(self, stream, stream_id):
        engine = getattr(self, "_engine", None)
        if engine is not None:
            for key in [key for key in list(self._engine_frames)
                        if key[0] == stream_id]:
                self._engine_frames.pop(key, None)
            engine.cancel(lambda rid: rid[0] == stream_id)
        prefill = getattr(self, "_prefill_engine", None)
        if prefill is not None:
            for key in [key for key in list(self._prefill_frames)
                        if key[0] == stream_id]:
                self._prefill_frames.pop(key, None)
            prefill.cancel(lambda rid: rid[0] == stream_id)
        return super().stop_stream(stream, stream_id)

    def engine_stats(self) -> dict | None:
        """Live engine occupancy (dashboard / tests); None before the
        first continuous frame."""
        engine = getattr(self, "_engine", None)
        return None if engine is None else engine.stats()

    def checkpoint_stats(self) -> dict | None:
        """Live decode-checkpointer counters; None when the element
        runs without a `checkpoint` spec (or before the engine)."""
        checkpointer = getattr(self, "_checkpointer", None)
        return None if checkpointer is None else checkpointer.stats()

    def group_kernel(self, stream):
        """Fused micro-batch hook for the decode stage: greedy generation
        over the whole coalesced group.  The chained path runs instead
        whenever process_frame does per-frame host work the kernel cannot
        reproduce: text prompts / tokenizer decode, token streaming,
        sequence-parallel padding, meshed placement."""
        if type(self).process_frame is not LMGenerate.process_frame:
            # a subclass overriding process_frame must not have its
            # override silently bypassed by the inherited fused kernel
            return None
        self._ensure_ready()  # configure(): config + tokenizer exist
        if (self.mesh is not None or self.config.sequence_parallel
                or self.tokenizer is not None
                or truthy(self.get_parameter(
                    "stream_tokens", False, stream))
                or self.engine_managed(stream)
                or self.disagg_role(stream)):
            return None
        max_new = int(self.get_parameter("max_new_tokens", 32, stream))

        def build():
            config, device = self.config, self.device

            def kernel(state, tokens):
                out, _ = generate(
                    state, config,
                    as_device_array(tokens, torch.int32, device), max_new)
                return {"generated": out}

            return kernel

        return self._cached_group_kernel(max_new, build), self.state

    def eval_kernel(self):
        """Static-analyzer hook (PipelineElement.eval_kernel): greedy
        generation as a pure kernel over a `tokens` input, with setup()
        as the state builder -- the analyzer proves the `generated`
        shape on the meta device without building the transformer."""
        if type(self).process_frame is not LMGenerate.process_frame:
            return None
        self.configure()
        if self.config.sequence_parallel:
            return None  # sp decode needs an ambient mesh to trace
        if self.disagg_role():
            # a disagg element's output contract is a handoff record /
            # adopted completion, not the pure generate() shape
            return None
        max_new = int(self.get_parameter("max_new_tokens", 32))
        config = self.config

        def kernel(state, tokens):
            out, _ = generate(state, config, tokens.to(torch.int32),
                              max_new)
            return {"generated": out}

        return kernel, self.setup


class SpeechToText(ComputeElement):
    """audio (B, samples) 16 kHz f32 -> token ids (B, max_tokens) int32.

    The log-mel frontend and the encoder-decoder transformer run on the
    element's device (`device`, CUDA unless the definition asks for the
    CPU); every encoder attention is the hand-written flash-attention
    kernel on CUDA.
    """

    def configure(self):
        if hasattr(self, "config"):
            return
        preset = self.get_parameter("preset")
        if preset:
            self.config = _ASR_PRESETS[str(preset)]
            dtype = self.get_parameter("dtype")
            if dtype:
                self.config = replace(self.config, dtype=str(dtype))
            # serving window override: chunked serving (5 s chunks, the
            # reference cadence) need not pay the full 30 s whisper
            # window -- encoder cost scales with max_frames
            max_frames = self.get_parameter("max_frames")
            if max_frames:
                self.config = replace(self.config,
                                      max_frames=int(max_frames))
        else:
            self.config = AsrConfig(
                n_mels=int(self.get_parameter("n_mels", 80)),
                d_model=int(self.get_parameter("d_model", 384)),
                enc_layers=int(self.get_parameter("enc_layers", 4)),
                dec_layers=int(self.get_parameter("dec_layers", 4)),
                n_heads=int(self.get_parameter("n_heads", 6)),
                vocab_size=int(self.get_parameter("vocab_size", 1024)),
                max_frames=int(self.get_parameter("max_frames", 1500)),
                dtype=str(self.get_parameter("dtype", "bfloat16")),
            )
        # HF whisper checkpoints decode between the real special tokens
        # (<|startoftranscript|> 50258, <|endoftext|> 50257); resolved
        # HERE (not in setup) so the checkpoint-restore path -- which
        # skips setup -- still decodes with the right ids
        self._hf_weights = _weights_named(self.get_parameter("weights"),
                                          ("model.encoder.conv1.weight",))
        if self._hf_weights:
            self.config = replace(
                self.config,
                sot_token=int(self.get_parameter("sot_token", 50258)),
                eot_token=int(self.get_parameter("eot_token", 50257)))
        from ..models import asr_param_specs
        _default_state_spec(self, lambda: asr_param_specs(self.config))

    def setup(self):
        weights = self.get_parameter("weights")
        if weights:
            # the container's naming was decided in configure()
            # (restore-safe): HF openai/whisper-* through the whisper name
            # map, else the framework's save_pytree layout
            if self._hf_weights:
                params = load_whisper_params(weights, self.config,
                                             device=self.device)
            else:
                params = load_pytree(weights, dtype=self.config.dtype,
                                     device=self.device)
        else:
            generator = torch.Generator().manual_seed(
                int(self.get_parameter("seed", 0)))
            params = init_asr_params(self.config, generator,
                                     device=self.device)
        _LOGGER.info("%s: ASR %.1fM params on %s", self.definition.name,
                     count_params(params) / 1e6, self.device)
        return params

    def _transcribe(self, state, audio, max_tokens: int):
        from ..models.asr import transcribe_audio
        audio = as_device_array(audio, torch.float32, self.device)
        if audio.ndim == 1:
            audio = audio[None]
        return transcribe_audio(state, self.config, audio,
                                max_tokens=max_tokens)

    def process_frame(self, stream, audio):
        self._ensure_ready()
        max_tokens = int(self.get_parameter("max_tokens", 32, stream))
        return StreamEvent.OKAY, {
            "tokens": self._transcribe(self.state, audio, max_tokens)}

    def group_kernel(self, stream):
        """Fused micro-batch hook: log-mel frontend + transcription as a
        batch kernel inside the scheduler's fused group call.  Kernels
        are cached per max_tokens (a stable identity keeps the
        scheduler's program cache entry)."""
        if type(self).process_frame is not SpeechToText.process_frame:
            return None  # subclass override must run, not be bypassed
        if self.mesh is not None:
            return None  # meshed inputs need host-side placement
        self._ensure_ready()
        max_tokens = int(self.get_parameter("max_tokens", 32, stream))

        def build():
            def kernel(state, audio):
                return {"tokens": self._transcribe(state, audio,
                                                   max_tokens)}

            return kernel

        return self._cached_group_kernel(max_tokens, build), self.state

    def eval_kernel(self):
        """Static-analyzer hook (PipelineElement.eval_kernel): log-mel
        frontend + transcription as a pure kernel, setup() as the state
        builder; the meta trace proves the `tokens` contract without
        building the ASR params (every encoder attention takes K1's
        meta branch)."""
        if type(self).process_frame is not SpeechToText.process_frame:
            return None
        self.configure()
        max_tokens = int(self.get_parameter("max_tokens", 32))

        def kernel(state, audio):
            return {"tokens": self._transcribe(state, audio, max_tokens)}

        return kernel, self.setup


class TextToSpeech(ComputeElement):
    """text (str | list[str]) -> waveform (B, samples) f32 on the
    element's device + sample_rate: the reference's Coqui TTS seat
    (reference speech_elements.py:109-146).  Characters -> mel ->
    Griffin-Lim (models/tts.py).  Prompt lengths pad to power-of-two
    buckets of at least 16 characters; "max_chars" (default 512) caps
    them, with a warning on truncation."""

    def configure(self):
        if hasattr(self, "config"):
            return
        self.config = TTSConfig(
            d_model=int(self.get_parameter("d_model", 256)),
            n_conv_layers=int(self.get_parameter("n_conv_layers", 4)),
            sample_rate=int(self.get_parameter("sample_rate", 16000)),
            frames_per_char=int(self.get_parameter("frames_per_char", 6)),
            griffin_lim_iters=int(
                self.get_parameter("griffin_lim_iters", 30)),
        )

    def setup(self):
        weights = self.get_parameter("weights")
        if weights:
            params = load_pytree(weights, dtype=self.config.dtype,
                                 device=self.device)
        else:
            params = init_tts_params(
                self.config,
                torch.Generator().manual_seed(
                    int(self.get_parameter("seed", 0))),
                device=self.device)
        _LOGGER.info("%s: TTS %.1fM params", self.definition.name,
                     count_params(params) / 1e6)
        return params

    def process_frame(self, stream, text):
        self._ensure_ready()
        prompts = [text] if isinstance(text, str) else list(text)
        max_chars = int(self.get_parameter("max_chars", 512, stream))
        longest = max((len(prompt.encode("utf-8", "replace"))
                       for prompt in prompts), default=1)
        if longest > max_chars:
            _LOGGER.warning(
                "%s: prompt of %d chars truncated to max_chars=%d",
                self.definition.name, longest, max_chars)
        width = bucket_length(min(longest, max_chars), minimum=16)
        chars = np.concatenate([encode_chars(prompt, max_len=width)
                                for prompt in prompts])
        waveform = synthesize(self.state, self.config,
                              torch.from_numpy(chars).to(self.device))
        return StreamEvent.OKAY, {
            "audio": waveform, "sample_rate": self.config.sample_rate}


class DetectionsPublish(AsyncHostElement):
    """detections (the Detector contract) -> "(detections (names...))" on
    the "{namespace}/detections" side-channel, closing the vision->LLM
    loop (reference: the YOLO element publishes and the LLM element
    injects, elements_llm.py:196-210).  Class ids map through the
    "class_names" parameter when given.  Runs as an async host element:
    the device->host readback of the valid mask happens off the event
    loop.  Detections pass through unchanged for downstream stages."""

    def process_async(self, stream, detections):
        from ..utils import generate as generate_sexpr
        classes = _host(detections["classes"])
        valid = _host(detections["valid"])
        class_names = self.get_parameter("class_names", None, stream)
        names = []
        for row_classes, row_valid in zip(classes, valid):
            for class_id, ok in zip(row_classes, row_valid):
                if not ok:
                    continue
                names.append(str(class_names[int(class_id)])
                             if class_names
                             and int(class_id) < len(class_names)
                             else str(int(class_id)))
        topic = str(self.get_parameter(
            "topic", f"{self.process.namespace}/detections", stream))
        # dedupe, keep first-seen order (reference publishes object names)
        unique = list(dict.fromkeys(names))
        self.process.publish(topic, generate_sexpr("detections", [unique]))
        return {"detections": detections}


class TokensToText(AsyncHostElement):
    """tokens (B, T) -> text list[str] (explicit host boundary: this is
    where token ids leave the device).  With a "tokenizer" parameter
    ("default" or a path) decoding uses the real BPE vocabulary; without
    one, the byte-level toy vocabulary.  Runs as an ASYNC host element:
    the device->host readback happens on a worker thread with the frame
    parked."""

    def process_async(self, stream, tokens):
        token_array = _host(tokens)
        tokenizer = _tokenizer_for(self)
        texts = []
        for row in token_array:
            if tokenizer is not None:
                texts.append(tokenizer.decode(row))
            else:
                data = bytes(int(t) - _BYTE_OFFSET for t in row
                             if _BYTE_OFFSET <= t < _BYTE_OFFSET + 256)
                texts.append(data.decode("utf-8", errors="replace"))
        return {"text": texts}


class TextToTokens(PipelineElement):
    """text (str | list[str]) -> token ids (B, T) int32, left-padded.

    The host->device tokenization boundary feeding LMForward/LMGenerate;
    "tokenizer" parameter as in TokensToText (defaults to the committed
    BPE asset)."""

    def process_frame(self, stream, text):
        tokenizer = _tokenizer_for(self) or BPETokenizer.default()
        prompts = [text] if isinstance(text, str) else list(text)
        bos = bool(self.get_parameter("bos", True, stream))
        encoded = [tokenizer.encode(p, bos=bos) for p in prompts]
        max_len = self.get_parameter("max_len", None, stream)
        width = max(len(ids) for ids in encoded) if encoded else 1
        if max_len:
            width = int(max_len)
            encoded = [ids[-width:] for ids in encoded]
        pad = tokenizer.pad_id or 0
        tokens = np.full((len(encoded), max(width, 1)), pad, np.int32)
        for row, ids in enumerate(encoded):
            tokens[row, tokens.shape[1] - len(ids):] = ids
        return StreamEvent.OKAY, {"tokens": tokens}


class Detector(ComputeElement):
    """image (B, 3, H, W) [0,1] -> fixed-size detections {boxes, scores,
    classes, valid} (the reference overlay contract, yolo.py:56-87, is
    produced from them downstream); detections stay on the device."""

    def configure(self) -> None:
        """Probes the weights: ultralytics YOLOv8 naming selects the real
        v8 architecture (models/yolo.py, BatchNorm folded), its layout
        read off the checkpoint's shapes (yolo_variant "auto") or named
        (one of YOLO_VARIANTS)."""
        if hasattr(self, "config"):
            return
        weights = self.get_parameter("weights")
        self._yolo = _weights_named(weights, ("model.0.conv.weight",
                                              "model.model.0.conv.weight"))
        if self._yolo:
            overrides = dict(
                image_size=int(self.get_parameter("image_size", 640)),
                max_detections=int(
                    self.get_parameter("max_detections", 300)),
                score_threshold=float(
                    self.get_parameter("score_threshold", 0.25)),
                dtype=str(self.get_parameter("dtype", "bfloat16")))
            variant = str(self.get_parameter("yolo_variant", "auto"))
            if variant == "auto":
                self.config = infer_yolov8_config(weights, **overrides)
            elif variant in YOLO_VARIANTS:
                self.config = replace(
                    YOLO_VARIANTS[variant],
                    n_classes=int(self.get_parameter("n_classes", 80)),
                    **overrides)
            else:
                raise ValueError(
                    f"unknown yolo_variant {variant!r}; "
                    f"'auto' or one of {sorted(YOLO_VARIANTS)}")
            return
        preset = self.get_parameter("preset")
        if preset:
            self.config = _DETECTOR_PRESETS[str(preset)]
            dtype = self.get_parameter("dtype")
            if dtype:
                self.config = replace(self.config, dtype=str(dtype))
        else:
            self.config = DetectorConfig(
                n_classes=int(self.get_parameter("n_classes", 16)),
                base_channels=int(self.get_parameter("base_channels", 32)),
                image_size=int(self.get_parameter("image_size", 256)),
                max_detections=int(
                    self.get_parameter("max_detections", 32)),
                score_threshold=float(
                    self.get_parameter("score_threshold", 0.25)),
                dtype=str(self.get_parameter("dtype", "bfloat16")),
            )

    def setup(self):
        weights = self.get_parameter("weights")
        if self._yolo:
            params = load_yolov8_params(weights, self.config,
                                        device=self.device)
            _LOGGER.info("%s: yolov8 %.1fM params (BN folded)",
                         self.definition.name, count_params(params) / 1e6)
            return params
        if weights:
            params = load_pytree(weights, dtype=self.config.dtype,
                                 device=self.device)
        else:
            params = init_detector_params(
                self.config,
                torch.Generator().manual_seed(
                    int(self.get_parameter("seed", 0))),
                device=self.device)
        _LOGGER.info("%s: detector %.1fM params", self.definition.name,
                     count_params(params) / 1e6)
        return params

    def _detect(self, state, image):
        image = as_device_array(image, torch.float32, self.device)
        if image.ndim == 3:
            image = image[None]
        detect_fn = yolo_detect if self._yolo else detect
        return detect_fn(state, self.config, image)

    def process_frame(self, stream, image):
        self._ensure_ready()  # configure() runs inside
        return StreamEvent.OKAY, {"detections": self._detect(self.state,
                                                             image)}

    def group_kernel(self, stream):
        """Fused micro-batch hook: detection over the whole coalesced
        group in one call."""
        if type(self).process_frame is not Detector.process_frame:
            return None  # subclass override must run, not be bypassed
        self._ensure_ready()
        if self._group_kernel_fn is None:
            def kernel(state, image):
                return {"detections": self._detect(state, image)}

            self._group_kernel_fn = kernel
        return self._group_kernel_fn, self.state

    def eval_kernel(self):
        """Static-analyzer hook (PipelineElement.eval_kernel): the
        detection kernel with setup() as the state builder, so the meta
        trace proves the detections contract without building the
        detector's params."""
        if type(self).process_frame is not Detector.process_frame:
            return None
        self.configure()

        def kernel(state, image):
            return {"detections": self._detect(state, image)}

        return kernel, self.setup
