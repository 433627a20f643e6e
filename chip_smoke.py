"""Drive the PyTorch/CUDA port's speech-serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero and prints no
result:

  0. the card: nvidia-smi's name and power limit, torch's device name and
     count (no CUDA device: fail)
  1. build every kernel of the path from csrc/ with nvcc (sm_90a)
  2. hold each kernel against its plain PyTorch version on the card
  3. time the flash-attention kernel at the serving shape with CUDA
     events, beside its bound, its plain version and PyTorch's
     scaled_dot_product_attention (timed only, never used by the port)
  4. asr_tones (the committed trained checkpoint) through the port's
     Process / create_pipeline on CUDA: exact transcripts
  5. whisper_small at full width (random weights from a seed) through the
     same entry points: encoder against the plain attention path, then
     serving: frames/s, p50 frame latency, real-time factor, kernel
     launches, peak device memory

The line before the last is one JSON object describing every kernel of
the path; the last line is {"ok": true, "device": {...}}.  Imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import ast
import json
import pathlib
import queue
import statistics
import subprocess
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
ASSET = ROOT / "tests" / "assets" / "asr_tones.safetensors"
MODULE = "aiko_services_tpu_torch.elements"
SAMPLE_RATE = 16000

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 tensor
# FLOP/s, float32 (non-tensor) FLOP/s, matched on the name nvidia-smi
# reports.  The rates assume the card's full power limit.
PEAKS = (
    ("H200", {"bytes": 4.8e12, "bfloat16": 989e12, "float32": 67e12}),
    ("H100 NVL", {"bytes": 3.9e12, "bfloat16": 835e12, "float32": 60e12}),
    ("H100 PCIe", {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12}),
    ("H100", {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12}),
)

# Tolerances of the kernel-vs-plain checks (the plain version runs in f32
# on the same inputs): bf16 O may differ by one bf16 rounding of values of
# order 1 plus f32 sums taken in another order -> atol/rtol 2e-2; f32 O
# differs only by summation order -> atol 1e-5; the f32 logsumexp of up
# to 300 terms -> atol 1e-4.
BF16_TOL = 2e-2
F32_ATOL = 1e-5
LSE_ATOL = 1e-4
# encoder memory of whisper_small (12 bf16 layers, layer-normed output):
# the kernel and the plain path round each layer's attention output to
# bf16 from differently ordered f32 sums, and 12 residual layers carry
# those one-ulp differences forward -> atol/rtol 5e-2 on values of order 1
ENCODER_TOL = 5e-2


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{key}={value}"
                                   for key, value in fields.items()),
          flush=True)


def card() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return result.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> tuple:
    for key, peaks in PEAKS:
        if key in name:
            return key, peaks
    raise SystemExit(f"no published peaks for card {name!r}")


def cuda_ms(function, warmup: int = 3, runs: int = 25) -> float:
    """Median milliseconds of `function` over `runs` launches, each timed
    with CUDA events after `warmup` untimed ones."""
    for _ in range(warmup):
        function()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        function()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_qkv(batch, heads, q_len, k_len, dim, dtype, seed):
    generator = torch.Generator().manual_seed(seed)
    shapes = [(batch, heads, q_len, dim), (batch, heads, k_len, dim),
              (batch, heads, k_len, dim)]
    return [torch.randn(shape, generator=generator).to("cuda", dtype)
            for shape in shapes]


# -- phases --------------------------------------------------------------

def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = card()
    say("0 card", nvidia_smi=repr(smi),
        torch_device=repr(torch.cuda.get_device_name(0)),
        device_count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    for name in kernels.KERNEL_SOURCES:
        kernels.build_kernel(name)
        kernels.load_kernel(name)
    registers = sorted({line.split("Used ")[1].split(" registers")[0]
                        for line in kernels.build_logs.get(
                            "flash_attention", "").splitlines()
                        if "registers" in line})
    say("1 build", kernels=",".join(kernels.KERNEL_SOURCES),
        seconds=f"{time.perf_counter() - start:.2f}",
        nvcc_seconds=json.dumps(kernels.build_seconds),
        registers_per_thread=",".join(registers))


# (B, H, Lq, Lk, D, dtype, causal, q_offset)
KERNEL_CASES = {
    "serving_encoder_bf16": (128, 12, 251, 251, 64, torch.bfloat16, False,
                             0),
    "causal_300": (8, 12, 300, 300, 64, torch.bfloat16, True, 0),
    "causal_37x251": (8, 12, 37, 251, 64, torch.bfloat16, True, 0),
    "cross_37x251": (8, 12, 37, 251, 64, torch.bfloat16, False, 0),
    "asr_tones_d16_f32": (4, 4, 12, 12, 16, torch.float32, False, 0),
}


def phase_kernel_checks() -> float:
    """Every case against the plain f32 version; returns the O max abs
    error at the serving shape."""
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_forward, flash_attention_plain)
    serving_error = None
    for index, (case, spec) in enumerate(KERNEL_CASES.items()):
        batch, heads, q_len, k_len, dim, dtype, causal, q_offset = spec
        q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype,
                             seed=index)
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           q_offset=q_offset)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal,
            q_offset=q_offset)
        out_error = (out.float() - ref_out).abs().max().item()
        lse_error = (lse - ref_lse).abs().max().item()
        if dtype == torch.bfloat16:
            torch.testing.assert_close(out.float(), ref_out, atol=BF16_TOL,
                                       rtol=BF16_TOL)
        else:
            torch.testing.assert_close(out, ref_out, atol=F32_ATOL, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
        say("2 kernel_vs_plain", case=case,
            shape=f"{batch}x{heads}x{q_len}x{k_len}x{dim}",
            dtype=str(dtype).replace("torch.", ""), causal=causal,
            o_max_abs_err=f"{out_error:.3e}",
            lse_max_abs_err=f"{lse_error:.3e}", ok=True)
        if case == "serving_encoder_bf16":
            serving_error = out_error
    return serving_error


def phase_timing(smi: str) -> dict:
    import torch.nn.functional as F

    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_forward, flash_attention_plain)
    batch, heads, q_len, k_len, dim, dtype, _, _ = KERNEL_CASES[
        "serving_encoder_bf16"]
    q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype, seed=99)
    kernel_ms = cuda_ms(lambda: flash_attention_forward(q, k, v))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    # least time for the same work: each input read once, each output
    # written once; operations at the peak for the inputs' type
    element = q.element_size()
    moved = (q.numel() + k.numel() + v.numel() + q.numel()) * element \
        + batch * heads * q_len * 4
    operations = 4 * batch * heads * q_len * k_len * dim
    peaks_name, peaks = peaks_for(smi)
    bytes_ms = moved / peaks["bytes"] * 1e3
    operations_ms = operations / peaks["bfloat16"] * 1e3
    bound_ms = max(bytes_ms, operations_ms)
    bound_by = "bytes" if bytes_ms >= operations_ms else "operations"
    say("3 timing", shape=f"{batch}x{heads}x{q_len}x{k_len}x{dim}",
        dtype="bfloat16", kernel_ms=f"{kernel_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
        bytes=moved, operations=operations,
        peaks=f"{peaks_name}:{peaks['bytes']:.3g}B/s,"
              f"{peaks['bfloat16']:.3g}FLOP/s(bf16)", card=repr(smi))
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _definition(asr_parameters: dict) -> dict:
    return {
        "name": "speech",
        "graph": ["(asr (text))"],
        "parameters": {"device": "cuda"},
        "elements": [
            {"name": "asr", "input": [{"name": "audio"}],
             "output": [{"name": "tokens"}],
             "parameters": asr_parameters,
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "SpeechToText"}}},
            {"name": "text", "input": [{"name": "tokens"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "TokensToText"}}},
        ],
    }


class Server:
    """A Process on the loopback broker serving one pipeline definition;
    serve() posts frames on one stream and returns their outputs with
    each frame's latency."""

    def __init__(self, definition: dict):
        from aiko_services_tpu_torch.pipeline import create_pipeline
        from aiko_services_tpu_torch.runtime import Process
        self.process = Process(transport_kind="loopback")
        self.pipeline = create_pipeline(self.process, definition)
        self.process.run(in_thread=True)
        self.responses = queue.Queue()
        self.stream = self.pipeline.create_stream(
            "s1", queue_response=self.responses)
        self.frames = 0

    def serve(self, audio_frames: list) -> list:
        """[(outputs, latency seconds)] in frame order."""
        posted = {}
        for audio in audio_frames:
            posted[self.frames] = time.perf_counter()
            self.frames += 1
            self.pipeline.create_frame(self.stream, {"audio": audio})
        results = {}
        for _ in audio_frames:
            _, frame, outputs = self.responses.get(timeout=600)
            results[frame.frame_id] = (
                outputs, time.perf_counter() - posted[frame.frame_id])
        return [results[frame_id] for frame_id in sorted(results)]

    def close(self) -> None:
        self.process.terminate()


def phase_asr_tones() -> None:
    from aiko_services_tpu_torch.models import SafetensorsFile
    from aiko_services_tpu_torch.ops import kernels
    container = SafetensorsFile(ASSET)
    metadata = {key: ast.literal_eval(value)
                for key, value in container.metadata.items()}
    container.close()
    labels = {float(freq): label
              for freq, label in metadata["labels"].items()}
    parameters = {**{key: value for key, value in metadata["config"].items()
                     if key != "max_text_len"},
                  "max_tokens": 9, "weights": str(ASSET)}
    t = np.arange(int(float(metadata["seconds"]) * SAMPLE_RATE)) \
        / SAMPLE_RATE
    audio = [np.sin(2 * np.pi * freq * t).astype(np.float32)[None]
             for freq in labels]
    server = Server(_definition(parameters))
    try:
        kernels.reset_launch_counts()
        results = server.serve(audio)
        launches = kernels.launch_counts["flash_attention"]
    finally:
        server.close()
    transcripts = [outputs["text"][0] for outputs, _ in results]
    if transcripts != list(labels.values()):
        raise SystemExit(f"asr_tones transcribed {transcripts}, expected "
                         f"{list(labels.values())}")
    if launches == 0:
        raise SystemExit("asr_tones ran without launching the flash "
                         "attention kernel")
    say("4 asr_tones", transcripts=json.dumps(transcripts), exact=True,
        flash_attention_launches=launches)


def tones_batch(rows: int, seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    frequencies = rng.uniform(200.0, 2000.0, rows)
    return np.stack([np.sin(2 * np.pi * freq * t) for freq in frequencies]
                    ).astype(np.float32)


WHISPER = {"preset": "whisper_small", "max_frames": 512,
           "dtype": "bfloat16", "max_tokens": 16, "micro_batch": 8,
           "micro_batch_wait_ms": 5000, "seed": 0}
ROWS, SECONDS, GROUPS = 16, 5.0, 4


def phase_whisper_small(smi: str) -> int:
    """Returns the kernel launches of the measured serving run."""
    from aiko_services_tpu_torch.models import asr
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_plain)

    micro = WHISPER["micro_batch"]
    server = Server(_definition(WHISPER))
    try:
        element = server.pipeline.elements["asr"]
        element._ensure_ready()
        config, params = element.config, element.state

        # the encoder on one 16-row batch: kernel path vs plain path
        mel = log_mel_spectrogram(torch.from_numpy(
            tones_batch(ROWS, SECONDS, seed=1)).cuda(), n_mels=config.n_mels)
        memory = asr.encode_audio(params, config, mel)
        kernel_attention = asr.flash_attention
        asr.flash_attention = (
            lambda q, k, v, causal=False, **_: flash_attention_plain(
                q, k, v, causal=causal)[0])
        try:
            reference = asr.encode_audio(params, config, mel)
        finally:
            asr.flash_attention = kernel_attention
        torch.cuda.synchronize()
        if not torch.isfinite(memory).all():
            raise SystemExit("whisper_small encoder memory is not finite")
        error = (memory.float() - reference.float()).abs()
        torch.testing.assert_close(memory.float(), reference.float(),
                                   atol=ENCODER_TOL, rtol=ENCODER_TOL)
        say("5 encoder_vs_plain", shape=tuple(memory.shape),
            max_abs_err=f"{error.max().item():.3e}",
            mean_abs_err=f"{error.mean().item():.3e}", ok=True)

        frames = [tones_batch(ROWS, SECONDS, seed=10 + index)
                  for index in range(micro * (GROUPS + 1))]
        server.serve(frames[:micro])                      # warm-up group
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        results = []
        for group in range(GROUPS):
            results += server.serve(
                frames[micro * (group + 1):micro * (group + 2)])
        elapsed = time.perf_counter() - start
        launches = kernels.launch_counts["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        groups = server.pipeline.telemetry.summary()
    finally:
        server.close()

    for outputs, _ in results:
        tokens = outputs["tokens"].cpu().numpy()
        if tokens.shape != (ROWS, WHISPER["max_tokens"]) or not (
                (0 <= tokens).all() and (tokens < config.vocab_size).all()):
            raise SystemExit(f"bad tokens {tokens.shape}")
        if len(outputs["text"]) != ROWS:
            raise SystemExit("a frame lost rows")
    if launches < config.enc_layers * GROUPS:
        raise SystemExit(f"{launches} kernel launches in {GROUPS} groups, "
                         f"expected at least {config.enc_layers} per group")
    latencies = sorted(latency for _, latency in results)
    audio_seconds = len(results) * ROWS * SECONDS
    say("5 whisper_small_serving", groups=GROUPS, frames=len(results),
        rows_per_frame=ROWS, frames_per_s=f"{len(results) / elapsed:.3f}",
        p50_frame_latency_ms=f"{statistics.median(latencies) * 1e3:.1f}",
        real_time_factor=f"{elapsed / audio_seconds:.5f}",
        audio_seconds_per_s=f"{audio_seconds / elapsed:.1f}",
        flash_attention_launches=launches,
        launches_per_group=f"{launches / GROUPS:g}",
        fused_groups=groups["fused_groups"],
        max_memory_allocated_gib=f"{peak / 2**30:.2f}", card=repr(smi))
    return launches


def main() -> None:
    smi = phase_card()
    phase_build()
    serving_error = phase_kernel_checks()
    timing = phase_timing(smi)
    phase_asr_tones()
    launches = phase_whisper_small(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "aiko_services_tpu_torch/csrc/flash_attention.cu",
        "replaces": "aiko_services_tpu/parallel/attention.py:75",
        "launches": launches,
        "max_abs_err": serving_error,
        **timing,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
