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
# Not ported yet, and raising NotImplementedError naming it: prefill/
# decode disaggregation (`role`, handoff / restore inputs), warm KV
# failover (`checkpoint`) and the cross-replica prefix store
# (`prefix_keeper`), all ROADMAP Queue A item 2; HuggingFace Llama and
# whisper checkpoints; ultralytics YOLOv8 checkpoints for the Detector;
# TextToSpeech.  Lint also refuses `checkpoint` as a DefinitionError
# (analyze/policies.py); `sequence_parallel` and a `sharding` block raise
# at construction.

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from ..models import (
    AsrConfig, BPETokenizer, DetectorConfig, TransformerConfig,
    count_params, detect, forward, generate, generate_stream,
    init_asr_params, init_detector_params, init_params, load_pytree,
    quantize_weights_int8)
from ..models import configs as model_configs
from ..ops.device import as_device_array
from ..pipeline import (
    AsyncHostElement, ComputeElement, PipelineElement, StreamEvent)
from ..utils import get_logger, truthy

__all__ = ["LMForward", "LMGenerate", "SpeechToText", "Detector",
           "DetectionsPublish", "TokensToText", "TextToTokens"]

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


def _not_ported(element, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{element.definition.name}: {what} is not yet ported to the torch "
        f"port")


def _weights_named(weights, names) -> bool:
    """True when the checkpoint holds any of `names` (a foreign naming
    convention the port does not map yet).  Probes the FIRST shard when
    weights is a list (shards share one naming convention)."""
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
    if truthy(element.get_parameter("sequence_parallel", False)):
        raise _not_ported(element, "sequence-parallel attention "
                                   "(`sequence_parallel`)")
    # "int8" halves KV-cache memory and read bandwidth
    kv_dtype = str(element.get_parameter("kv_dtype", "") or "")
    preset = element.get_parameter("preset")
    if preset:
        config = _LM_PRESETS[str(preset)]
        dtype = element.get_parameter("dtype")
        if dtype:
            config = replace(config, dtype=str(dtype))
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
        kv_dtype=kv_dtype,
    )


def _refuse_llama_weights(element) -> None:
    if _weights_named(element.get_parameter("weights"),
                      ("model.embed_tokens.weight",)):
        raise _not_ported(element, "loading HuggingFace Llama checkpoints "
                                   "(load_llama_params)")


def _load_transformer_params(element, config: TransformerConfig):
    """weights parameter: path to a safetensors checkpoint in the
    framework's save_pytree layout; absent -> seeded random init.
    weight_dtype "int8": weight-only serving quantization."""
    weights = element.get_parameter("weights")
    if weights:
        paths = weights if isinstance(weights, list) else [weights]
        params = load_pytree(paths[0], dtype=config.dtype,
                             device=element.device)
    else:
        params = init_params(
            config,
            torch.Generator().manual_seed(
                int(element.get_parameter("seed", 0))),
            device=element.device)
    weight_dtype = str(element.get_parameter("weight_dtype", "") or "")
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
        _refuse_llama_weights(self)

    def configure(self):
        if not hasattr(self, "config"):
            self.config = _transformer_config(self)

    def setup(self):
        params = _load_transformer_params(self, self.config)
        _LOGGER.info("%s: transformer %.1fM params",
                     self.definition.name, count_params(params) / 1e6)
        return params

    def compute(self, state, tokens):
        with torch.no_grad():
            logits = forward(state, self.config, tokens)
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
    eos_id, prefill_chunk_size, speculative, prefix_policy).

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
        self._refuse_unported()
        _refuse_llama_weights(self)
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

    def _refuse_unported(self, stream=None) -> None:
        """Disaggregation, warm KV failover and the cross-replica prefix
        store raise: the engine would silently ignore them."""
        if self.disagg_role(stream):
            raise _not_ported(self, "prefill/decode disaggregation "
                                    "(`role`)")
        if self.get_parameter("checkpoint", None, stream):
            raise _not_ported(self, "warm KV failover (`checkpoint`)")
        if self.get_parameter("prefix_keeper", "", stream):
            raise _not_ported(self, "the cross-replica prefix store "
                                    "(`prefix_keeper`)")

    def engine_managed(self, stream):
        return truthy(self.get_parameter("continuous", False, stream))

    def disagg_role(self, stream=None) -> str:
        return str(self.get_parameter("role", "", stream) or "")

    def configure(self):
        if not hasattr(self, "config"):
            self.config = _transformer_config(self)
            self.tokenizer = _tokenizer_for(self)

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
        self._refuse_unported(stream)
        if handoff is not None or restore is not None:
            raise _not_ported(self, "KV handoff / restore inputs "
                                    "(disaggregation, warm KV failover)")
        if self.engine_managed(stream):
            return self._process_frame_continuous(stream, tokens, text)
        self._ensure_ready()
        max_new = int(self.get_parameter("max_new_tokens", 32, stream))
        formatted = None
        if tokens is None:
            if text is None:
                raise ValueError("LMGenerate needs tokens or text input")
            tokens, formatted = self._encode_prompts(stream, text)
        tokens = as_device_array(tokens, torch.int32, self.device)
        if truthy(self.get_parameter("stream_tokens", False, stream)):
            # streamed serving path: publish token chunks to /out as
            # they decode (reference capability: Ollama streaming)
            chunk = int(self.get_parameter("stream_chunk", 8, stream))
            blocks = []
            for offset, block in generate_stream(
                    self.state, self.config, tokens, max_new, chunk=chunk):
                blocks.append(block)
                payload = block.tolist()
                if self.tokenizer is not None:
                    payload = [self.tokenizer.decode(row)
                               for row in block]
                self.publish_out("tokens",
                                 [stream.stream_id, offset, payload])
            out = np.concatenate(blocks, axis=1)
        else:
            out, _ = generate(self.state, self.config, tokens, max_new)
        result = {"generated": out}
        if formatted is not None:
            result["prompt"] = formatted  # post-template (observability)
        if self.tokenizer is not None:
            result["text"] = [self.tokenizer.decode(row)
                              for row in _host(out)]
        return StreamEvent.OKAY, result

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
        self._engine_frames = {}
        self._pump_posted = False
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

    def _process_frame_continuous(self, stream, tokens, text):
        engine = self._ensure_engine()
        formatted = None
        if tokens is None:
            if text is None:
                raise ValueError("LMGenerate needs tokens or text input")
            tokens, formatted = self._encode_prompts(stream, text)
        tokens = _host(tokens).astype(np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        rows = tokens.shape[0]
        max_new = int(self.get_parameter("max_new_tokens", 32, stream))
        key = (stream.stream_id, stream.current_frame_id)
        self._engine_frames[key] = {
            "rows": rows, "done": {}, "formatted": formatted,
            "submitted_at": time.perf_counter(),
            "stream_tokens": truthy(self.get_parameter(
                "stream_tokens", False, stream)),
            "chunk": max(1, int(self.get_parameter(
                "stream_chunk", 8, stream))),
            "buffers": {},
        }
        # submission order == row order; the engine's FIFO admission
        # keeps caller-observed ordering deterministic.  A rejected row
        # (e.g. prompt + max_new over max_context) must not leak the
        # frame entry or strand already-queued sibling rows
        try:
            for row in range(rows):
                engine.submit(key + (row,), tokens[row], max_new)
        except ValueError:
            self._engine_frames.pop(key, None)
            engine.cancel(lambda rid: rid[:2] == key)
            raise
        self._schedule_pump()
        return StreamEvent.PENDING, None

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
        stream_id, frame_id, row = completion.request_id
        key = (stream_id, frame_id)
        entry = self._engine_frames.get(key)
        if entry is None:
            return  # stream destroyed mid-decode; engine.cancel raced
        if entry["stream_tokens"]:
            self._flush_stream_buffer(key, entry, row)
            entry["buffers"].pop(row, None)
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
        return super().stop_stream(stream, stream_id)

    def engine_stats(self) -> dict | None:
        """Live engine occupancy (dashboard / tests); None before the
        first continuous frame."""
        engine = getattr(self, "_engine", None)
        return None if engine is None else engine.stats()

    def group_kernel(self, stream):
        """Fused micro-batch hook for the decode stage: greedy generation
        over the whole coalesced group.  The chained path runs instead
        whenever process_frame does per-frame host work the kernel cannot
        reproduce: text prompts / tokenizer decode, token streaming."""
        if type(self).process_frame is not LMGenerate.process_frame:
            # a subclass overriding process_frame must not have its
            # override silently bypassed by the inherited fused kernel
            return None
        self._refuse_unported(stream)
        self._ensure_ready()  # configure(): config + tokenizer exist
        if (self.tokenizer is not None
                or truthy(self.get_parameter(
                    "stream_tokens", False, stream))
                or self.engine_managed(stream)):
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
        # HF whisper checkpoints (openai/whisper-* naming) need the
        # whisper name map, which is not ported yet
        if _weights_named(self.get_parameter("weights"),
                          ("model.encoder.conv1.weight",)):
            raise _not_ported(self, "HuggingFace whisper checkpoints")

    def setup(self):
        weights = self.get_parameter("weights")
        if weights:
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
        self._ensure_ready()
        max_tokens = int(self.get_parameter("max_tokens", 32, stream))

        def build():
            def kernel(state, audio):
                return {"tokens": self._transcribe(state, audio,
                                                   max_tokens)}

            return kernel

        return self._cached_group_kernel(max_tokens, build), self.state

    def eval_kernel(self):
        """Static-analyzer hook: None until the `eval` pass is ported."""
        return None


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

    def __init__(self, process, pipeline, definition):
        super().__init__(process, pipeline, definition)
        if _weights_named(self.get_parameter("weights"),
                          ("model.0.conv.weight",
                           "model.model.0.conv.weight")):
            raise _not_ported(self, "ultralytics YOLOv8 checkpoints "
                                    "(models/yolo.py)")

    def configure(self) -> None:
        if hasattr(self, "config"):
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
        return detect(state, self.config, image)

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
