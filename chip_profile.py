"""Where the speech-serving path spends its time on one NVIDIA GPU.

    python3 chip_profile.py

Serves whisper_small (the configuration chip_smoke.py drives: preset
whisper_small, max_frames 512, bf16, max_tokens 16, micro_batch 8, 16 rows
of 5 s audio per frame, random weights from a seed) through the port's
pipeline and prints:

  - the stages of one 128-row group timed alone with CUDA events: log-mel
    frontend, encoder, cross K/V, the 16-step decode loop;
  - one served group under torch.profiler: the device's busy and idle
    share of the group's wall time and the kernels that took the most
    device time, with the flash-attention kernel's share.

The Chrome trace goes to chiprun_out/profile_speech.json.  Needs one GPU;
imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import statistics
import time

import torch

import chip_smoke

OUT = pathlib.Path(__file__).resolve().parent / "chiprun_out"


def stage_ms(function, runs: int = 3) -> float:
    """Median milliseconds of function() over `runs` calls (after one
    warm-up), bracketed by CUDA events."""
    function()
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


def main() -> None:
    smi = chip_smoke.phase_card()
    from aiko_services_tpu_torch.models import asr
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram

    micro, rows = chip_smoke.WHISPER["micro_batch"], chip_smoke.ROWS
    server = chip_smoke.Server(chip_smoke._definition(chip_smoke.WHISPER))
    try:
        element = server.pipeline.elements["asr"]
        element._ensure_ready()
        config, params = element.config, element.state
        audio = torch.from_numpy(chip_smoke.tones_batch(
            micro * rows, chip_smoke.SECONDS, seed=3)).cuda()
        mel = log_mel_spectrogram(audio, n_mels=config.n_mels)
        memory = asr.encode_audio(params, config, mel)
        max_tokens = chip_smoke.WHISPER["max_tokens"]
        stages = {
            "log_mel": lambda: log_mel_spectrogram(
                audio, n_mels=config.n_mels),
            "encoder": lambda: asr.encode_audio(params, config, mel),
            "cross_kv": lambda: asr._cross_kv(params, config, memory),
            "transcribe": lambda: asr.transcribe(
                params, config, mel, max_tokens=max_tokens),
        }
        times = {name: stage_ms(function)
                 for name, function in stages.items()}
        times["decode_loop"] = (times["transcribe"] - times["encoder"]
                                - times["cross_kv"])
        chip_smoke.say("stages", rows=micro * rows, **{
            f"{name}_ms": f"{value:.2f}" for name, value in times.items()},
            card=repr(smi))

        frames = [chip_smoke.tones_batch(rows, chip_smoke.SECONDS,
                                         seed=20 + index)
                  for index in range(2 * micro)]
        server.serve(frames[:micro])                       # warm-up group
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as profile:
            start = time.perf_counter()
            server.serve(frames[micro:])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
    finally:
        server.close()

    kernels = [event for event in profile.events()
               if event.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(event.time_range.elapsed_us() for event in kernels) / 1e3
    if not kernels or device_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    by_name: dict = {}
    for event in kernels:
        count, total = by_name.get(event.name, (0, 0.0))
        by_name[event.name] = (
            count + 1, total + event.time_range.elapsed_us() / 1e3)
    flash_ms = sum(total for name, (_, total) in by_name.items()
                   if "flash_forward_kernel" in name)
    chip_smoke.say("group", wall_ms=f"{wall_ms:.1f}",
                   device_busy_ms=f"{device_ms:.1f}",
                   device_busy_share=f"{device_ms / wall_ms:.3f}",
                   idle_share=f"{1 - device_ms / wall_ms:.3f}",
                   kernel_launches=len(kernels),
                   flash_attention_ms=f"{flash_ms:.2f}",
                   flash_attention_share_of_busy=f"{flash_ms / device_ms:.3f}",
                   card=repr(smi))
    for name, (count, total) in sorted(by_name.items(),
                                       key=lambda item: -item[1][1])[:12]:
        chip_smoke.say("top_kernel", ms=f"{total:.2f}", launches=count,
                       name=repr(name[:90]))
    OUT.mkdir(exist_ok=True)
    profile.export_chrome_trace(str(OUT / "profile_speech.json"))


if __name__ == "__main__":
    main()
