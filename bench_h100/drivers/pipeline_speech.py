"""A speech pipeline under closed-loop audio: the port's
`create_pipeline` on a loopback `runtime.Process` with the graph
(asr (text)), SpeechToText then TokensToText; `streams` streams, each
with one frame of `rows` windows in flight.  Frames coalesce across
streams into groups of `micro_batch` (models/asr.py's encoder, cross
K/V and greedy decode on the card).

The window opens once one group of frames has come back, so every shape
is warm; frames are posted while the window
is open and the window closes when the last of them has come back, so
its rate counts all the work and all the time.  `correct` compares the
tokens of rows drawn from the seed against the plain reference's logits
(bench_h100/reference/whisper.py)."""

from __future__ import annotations

import queue
import time

import numpy as np

from .. import roofline, traffic
from ..harness import Outcome
from ..reference import full_f32, gaps
from ..reference import whisper as reference
from ..weights import draw, whisper_scale
from .common import peak_bytes, release, sample_indices

MODULE = "aiko_services_tpu_torch.elements"


def asr_config(config: dict):
    """The program's AsrConfig for a Hugging Face Whisper config."""
    from aiko_services_tpu_torch.models.asr import AsrConfig
    if config["encoder_attention_heads"] != config["decoder_attention_heads"]:
        raise SystemExit("the port's ASR model has one head count")
    if config["encoder_ffn_dim"] != 4 * config["d_model"] or \
            config["decoder_ffn_dim"] != 4 * config["d_model"]:
        raise SystemExit("the port's ASR model has an MLP of 4 x d_model")
    return AsrConfig(
        n_mels=config["num_mel_bins"], d_model=config["d_model"],
        enc_layers=config["encoder_layers"],
        dec_layers=config["decoder_layers"],
        n_heads=config["encoder_attention_heads"],
        vocab_size=config["vocab_size"],
        max_frames=config["max_source_positions"],
        max_text_len=config["max_target_positions"],
        sot_token=config["assumed"]["sot_token"],
        eot_token=config["assumed"]["eot_token"],
        dtype=config["torch_dtype"])


def definition(config: dict, spec: dict, device: str) -> dict:
    parameters = {
        "n_mels": config["num_mel_bins"], "d_model": config["d_model"],
        "enc_layers": config["encoder_layers"],
        "dec_layers": config["decoder_layers"],
        "n_heads": config["encoder_attention_heads"],
        "vocab_size": config["vocab_size"],
        "max_frames": config["max_source_positions"],
        "dtype": config["torch_dtype"],
        "max_tokens": spec["max_tokens"],
        "micro_batch": spec["micro_batch"],
        "micro_batch_wait_ms": spec["micro_batch_wait_ms"]}
    return {
        "name": "speech", "graph": ["(asr (text))"],
        "parameters": {"device": device},
        "elements": [
            {"name": "asr", "input": [{"name": "audio"}],
             "output": [{"name": "tokens"}], "parameters": parameters,
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "SpeechToText"}}},
            {"name": "text", "input": [{"name": "tokens"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "TokensToText"}}}]}


def weights(config: dict, seed: int, device: str) -> dict:
    import torch
    from aiko_services_tpu_torch.models.asr import init_asr_params
    program_config = asr_config(config)
    with torch.device("meta"):
        shapes = init_asr_params(program_config, torch.Generator(),
                                 device="meta")
    return draw(shapes, whisper_scale, seed, device,
                program_config.torch_dtype)


class Loop:
    """Closed-loop streams on one pipeline: each stream posts its next
    frame when its last one comes back."""

    def __init__(self, pipeline, streams: int, pool: np.ndarray):
        self.pipeline = pipeline
        self.pool = pool
        self.responses = queue.Queue()
        self.streams = [pipeline.create_stream(
            f"bench{index}", queue_response=self.responses,
            grace_time=3600.0) for index in range(streams)]
        self.sent = 0
        self.pending = {}         # stream id -> (post time, pool index)

    def post(self, stream) -> None:
        index = self.sent % len(self.pool)
        self.sent += 1
        self.pending[stream.stream_id] = (time.perf_counter(), index)
        self.pipeline.create_frame(stream, {"audio": self.pool[index]})

    def receive(self):
        """(stream, pool index, outputs, latency seconds, arrival)."""
        stream, _, outputs = self.responses.get(timeout=900)
        arrival = time.perf_counter()
        posted, index = self.pending.pop(stream.stream_id)
        return stream, index, outputs, arrival - posted, arrival

    def warm(self, group: int) -> None:
        """One group through the pipeline: every shape the window uses."""
        for stream in self.streams[:group]:
            self.post(stream)
        for _ in range(group):
            self.receive()


def run(context) -> Outcome:
    import torch
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process

    config, spec, mix = context.config, context.spec, context.traffic
    device = context.device
    context.note("program imported")
    params = weights(config, context.seed, device)
    context.note("weights drawn")
    pool = traffic.tones(mix, context.seed, device)
    context.note("audio made")
    process = Process(transport_kind="loopback")
    pipeline = create_pipeline(process, definition(config, spec, device))
    process.run(in_thread=True)
    try:
        pipeline.elements["asr"].restore_state(params)
        loop = Loop(pipeline, int(mix["streams"]), pool)
        context.note("pipeline up")
        loop.warm(int(spec["micro_batch"]))   # the group's shapes
        if device != "cpu":
            torch.cuda.synchronize()
        context.setup_done()
        kernels.reset_launch_counts()
        latencies, kept = [], []
        with context.traced():
            start = time.perf_counter()
            for stream in loop.streams:
                loop.post(stream)
            posted = len(loop.streams)
            while loop.pending:
                stream, index, outputs, latency, arrival = loop.receive()
                latencies.append(latency)
                kept.append((index, outputs["tokens"]))
                # after the close, only fill the group already begun
                if (arrival - start < context.seconds
                        or posted % int(spec["micro_batch"])):
                    loop.post(stream)
                    posted += 1
            end = time.perf_counter()
        launches = kernels.launch_counts["flash_attention"]
        peak = peak_bytes(device)
    finally:
        process.terminate()
    del pipeline, process, loop
    release(device)

    rows = int(mix["rows"])
    window_s = end - start
    frames = len(kept)
    audio_s = frames * rows * float(mix["seconds_audio"])
    samples = int(mix["seconds_audio"] * mix["sample_rate"])
    group_rows = rows * int(spec["micro_batch"])
    record = {
        "frame_latency_s": latencies,
        "host_window_s": window_s,
        "model_flops": frames * roofline.whisper_transcribe_flops(
            config, rows, config["max_source_positions"], samples,
            int(spec["max_tokens"])),
        "k1_cases": [{"heads": group_rows * config["encoder_attention_heads"],
                      "q_len": config["max_source_positions"],
                      "k_len": config["max_source_positions"],
                      "dim": config["d_model"]
                      // config["encoder_attention_heads"],
                      "causal": False, "launches": launches}],
    }
    gap, control_gap = judge(context, params, pool, kept)
    checks = [("max_logit_gap", gap, float(spec["max_logit_gap"]))]
    if control_gap is not None:
        checks.append(("control_max_logit_gap", control_gap,
                       float(spec["max_logit_gap"])))
    return Outcome(e2e={"audio_s_per_s": audio_s / window_s},
                   record=record, attempted=frames,
                   failed=sum(1 for _, tokens in kept
                              if tuple(tokens.shape) !=
                              (rows, int(spec["max_tokens"]))),
                   checks=checks, memory_peak_bytes=peak)


def judge(context, params: dict, pool: np.ndarray, kept: list) -> tuple:
    """The widest gap between a served token's reference logit and the
    reference's best, over `check_rows` rows drawn from the seed among
    the window's frames (up to and including each row's first eot);
    with the control, the same for the token the fp8 reference puts
    first."""
    import torch
    config, spec = context.config, context.spec
    eot = int(config["assumed"]["eot_token"])
    sot = int(config["assumed"]["sot_token"])
    rows = int(context.traffic["rows"])
    rng = np.random.default_rng(int(context.seed) + 1)
    picks = sample_indices(rng, len(kept) * rows, [],
                           int(spec["check_rows"]))
    audio = np.stack([pool[kept[pick // rows][0]][pick % rows]
                      for pick in picks])
    served = torch.stack([kept[pick // rows][1][pick % rows]
                          for pick in picks]).to(context.device).long()
    worst = control_worst = 0.0
    block = int(spec["check_block"])
    with full_f32(), torch.no_grad():
        for first in range(0, len(picks), block):
            wave = torch.from_numpy(audio[first:first + block]).to(
                context.device)
            tokens = served[first:first + block]
            mel = reference.log_mel(wave, config["num_mel_bins"])
            inputs = torch.cat([torch.full_like(tokens[:, :1], sot),
                                tokens[:, :-1]], dim=1)
            memory = reference.encode(params, config, mel)
            logits = reference.decoder_logits(params, config, inputs, memory)
            control = None
            if context.control == "reference_fp8":
                memory = reference.encode(params, config, mel, "fp8")
                control = reference.decoder_logits(params, config, inputs,
                                                   memory, "fp8")
            for row in range(tokens.shape[0]):
                length = _through_first(tokens[row], eot)
                worst = max(worst, float(gaps(
                    logits[row, :length], tokens[row, :length]).max()))
                if control is not None:
                    chosen = control[row, :length].argmax(dim=-1)
                    control_worst = max(control_worst, float(gaps(
                        logits[row, :length], chosen).max()))
    return worst, (control_worst if context.control else None)


def _through_first(tokens, eot: int) -> int:
    """Positions up to and including the first eot (all, without one)."""
    hits = (tokens == eot).nonzero()
    return int(hits[0, 0]) + 1 if hits.numel() else int(tokens.shape[0])
