# ML pipeline elements backed by the port's model families.
#
# Counterpart of aiko_services_tpu/elements/ml.py, for the speech branch:
# SpeechToText (the reference's PE_WhisperX seat, reference
# speech_elements.py:229-262) and TokensToText.  The LM, detector and TTS
# elements come with their models.

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..models import (
    AsrConfig, count_params, init_asr_params, load_pytree)
from ..models import configs as model_configs
from ..ops.device import as_device_array
from ..pipeline import AsyncHostElement, ComputeElement, StreamEvent
from ..utils import get_logger

__all__ = ["SpeechToText", "TokensToText"]

_LOGGER = get_logger("ml_elements")

# "preset" parameter values -> reference-scale configs (configs.py)
_ASR_PRESETS = {
    "whisper_tiny": model_configs.WHISPER_TINY,
    "whisper_small": model_configs.WHISPER_SMALL,
}

# byte-level toy vocabulary shared by SpeechToText and TokensToText:
# 0=pad 1=sot 2=eot, 3..258 = bytes
_BYTE_OFFSET = 3


def _probe_weight_names(weights) -> "SafetensorsFile":
    """Container probe for format detection: opens the FIRST shard when
    weights is a list (shards share one naming convention).  Caller
    closes."""
    from ..models import SafetensorsFile
    paths = weights if isinstance(weights, list) else [weights]
    return SafetensorsFile(paths[0])


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
        weights = self.get_parameter("weights")
        if weights:
            probe = _probe_weight_names(weights)
            hf_weights = "model.encoder.conv1.weight" in probe
            probe.close()
            if hf_weights:
                raise NotImplementedError(
                    f"{self.definition.name}: HuggingFace whisper "
                    f"checkpoints are not yet ported to the torch port")

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


class TokensToText(AsyncHostElement):
    """tokens (B, T) -> text list[str] (explicit host boundary: this is
    where token ids leave the device), decoded with the byte-level toy
    vocabulary.  Runs as an ASYNC host element: the device->host readback
    happens on a worker thread with the frame parked.  The BPE
    `tokenizer` parameter is not ported yet."""

    def process_async(self, stream, tokens):
        if self.get_parameter("tokenizer"):
            raise NotImplementedError(
                f"{self.definition.name}: the `tokenizer` parameter (BPE "
                f"vocabulary) is not yet ported to the torch port")
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu()
        token_array = np.asarray(tokens)
        texts = []
        for row in token_array:
            data = bytes(int(t) - _BYTE_OFFSET for t in row
                         if _BYTE_OFFSET <= t < _BYTE_OFFSET + 256)
            texts.append(data.decode("utf-8", errors="replace"))
        return {"text": texts}
