"""Where the serving paths spend their time on one NVIDIA GPU.

    python3 chip_profile.py            # the speech branch
    python3 chip_profile.py config5    # the config-5 graph

Speech: serves whisper_small (the configuration chip_smoke.py phase 5
drives: preset whisper_small, max_frames 512, bf16, max_tokens 16,
micro_batch 8, 16 rows of 5 s audio per frame, random weights from a seed)
through the port's pipeline.  config5: serves chip_smoke.py phase 8's
graph, (sources (asr (text) (lm (reply))) (detector)) with whisper_small,
llama32_1b (32 new tokens) and the yolov8n-shape detector at 640 px.
Each prints:

  - the stages of one 128-row group timed alone with CUDA events (speech:
    log-mel frontend, encoder, cross K/V, the 16-step decode loop;
    config5: transcription, the LM's prefill and whole generation, the
    detector's backbone and its decode + NMS);
  - the device's busy and idle share of one served group's wall time and
    the kernels that took the most device time, with the flash-attention
    kernel's share (speech: the served group under torch.profiler;
    config5: each model's group work under torch.profiler on the main
    thread, summed, over a served group's wall time).

The speech group's Chrome trace goes to chiprun_out/profile_speech.json
(config5 keeps none: its LM stage alone records ~35,000 kernels, too
large to bring back).  Needs one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import queue
import statistics
import sys
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


def device_time(profile) -> tuple:
    """(device busy ms, kernel launches, {kernel name: (launches, ms)})
    of what `profile` recorded on the card."""
    kernels = [event for event in profile.events()
               if event.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for event in kernels:
        count, total = by_name.get(event.name, (0, 0.0))
        by_name[event.name] = (
            count + 1, total + event.time_range.elapsed_us() / 1e3)
    busy_ms = sum(total for _, total in by_name.values())
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    return busy_ms, len(kernels), by_name


def say_top_kernels(by_name: dict, count: int = 12) -> None:
    for name, (launches, total) in sorted(
            by_name.items(), key=lambda item: -item[1][1])[:count]:
        chip_smoke.say("top_kernel", ms=f"{total:.2f}", launches=launches,
                       name=repr(name[:90]))


def flash_ms(by_name: dict) -> float:
    return sum(total for name, (_, total) in by_name.items()
               if "flash_forward_kernel" in name)


def profile_speech(smi: str) -> None:
    """Stage times of the speech branch, then one served group under
    torch.profiler: its device busy and idle share and the largest device
    costs."""
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
        with torch.profiler.profile(activities=ACTIVITIES) as profile:
            start = time.perf_counter()
            server.serve(frames[micro:])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
    finally:
        server.close()
    busy_ms, launches, by_name = device_time(profile)
    chip_smoke.say("group", mode="speech", wall_ms=f"{wall_ms:.1f}",
                   device_busy_ms=f"{busy_ms:.1f}",
                   device_busy_share=f"{busy_ms / wall_ms:.3f}",
                   idle_share=f"{1 - busy_ms / wall_ms:.3f}",
                   kernel_launches=launches,
                   flash_attention_ms=f"{flash_ms(by_name):.2f}",
                   flash_attention_share_of_busy=(
                       f"{flash_ms(by_name) / busy_ms:.3f}"),
                   card=repr(smi))
    say_top_kernels(by_name)
    OUT.mkdir(exist_ok=True)
    profile.export_chrome_trace(str(OUT / "profile_speech.json"))


def profile_config5(smi: str) -> None:
    """The config-5 graph's three models on one 128-row group: each stage
    timed alone with CUDA events and once under torch.profiler on this
    thread (device busy, launches, the largest device costs), then one
    served group's wall time through the pipeline.  The served group's
    device time is the sum of its stages' (the group kernels run the same
    functions on the same shapes), so its idle share is 1 - that sum over
    the group's wall time."""
    from aiko_services_tpu_torch.models import (
        decode_boxes, detect, detector_forward, forward, generate,
        init_cache)
    from aiko_services_tpu_torch.models.asr import transcribe_audio
    from aiko_services_tpu_torch.models.detector import _nms
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process

    micro, rows = chip_smoke.C5_MICRO, chip_smoke.C5_ROWS
    definition = chip_smoke.config5_definition()
    definition["elements"][0]["parameters"]["count"] = 2 * micro
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        asr, lm, detector = (pipeline.elements[name]
                             for name in ("asr", "lm", "detector"))
        for element in (asr, lm, detector):
            element._ensure_ready()
        group = micro * rows
        audio = torch.from_numpy(chip_smoke.tones_batch(
            group, chip_smoke.C5_SECONDS, seed=3)).cuda()
        size = chip_smoke.C5_IMAGE
        generator = torch.Generator(device="cuda").manual_seed(3)
        images = torch.rand((group, 3, size, size), device="cuda",
                            generator=generator)
        prompt = torch.randint(0, asr.config.vocab_size,
                               (group, chip_smoke.C5_MAX_TOKENS),
                               dtype=torch.int32, device="cuda")
        max_new = chip_smoke.C5_MAX_NEW

        def prefill():
            with torch.no_grad():
                cache = init_cache(lm.config, group,
                                   max_len=prompt.shape[1] + max_new)
                return forward(lm.state, lm.config, prompt, cache=cache)

        raw = detector_forward(detector.state, detector.config, images)
        stages = {
            "asr_transcribe": lambda: transcribe_audio(
                asr.state, asr.config, audio,
                max_tokens=chip_smoke.C5_MAX_TOKENS),
            "lm_prefill": prefill,
            "lm_generate": lambda: generate(lm.state, lm.config, prompt,
                                            max_new),
            "detector_backbone": lambda: detector_forward(
                detector.state, detector.config, images),
            "detector_decode_nms": lambda: _nms(
                *decode_boxes(raw, detector.config), detector.config),
        }
        times = {name: stage_ms(function)
                 for name, function in stages.items()}
        times["lm_decode_loop"] = times["lm_generate"] - times["lm_prefill"]
        chip_smoke.say("stages", rows=group, new_tokens=max_new, **{
            f"{name}_ms": f"{value:.2f}" for name, value in times.items()},
            card=repr(smi))

        # the group kernels' work, one stage at a time under the profiler
        served_stages = {
            "asr": stages["asr_transcribe"],
            "lm": stages["lm_generate"],
            "detector": lambda: detect(detector.state, detector.config,
                                       images)}
        busy_total, merged = 0.0, {}
        for name, function in served_stages.items():
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=ACTIVITIES) as profile:
                start = time.perf_counter()
                function()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - start) * 1e3
            busy_ms, launches, by_name = device_time(profile)
            busy_total += busy_ms
            for kernel, (count, total) in by_name.items():
                before = merged.get(kernel, (0, 0.0))
                merged[kernel] = (before[0] + count, before[1] + total)
            chip_smoke.say("stage_profile", stage=name,
                           wall_ms=f"{wall_ms:.1f}",
                           device_busy_ms=f"{busy_ms:.1f}",
                           idle_share=f"{1 - busy_ms / wall_ms:.3f}",
                           kernel_launches=launches,
                           flash_attention_ms=f"{flash_ms(by_name):.2f}")
        del audio, images, prompt, raw

        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses,
                               parameters={"frame_window": micro})
        for _ in range(micro):                             # warm-up group
            responses.get(timeout=900)
        start = time.perf_counter()
        served = [responses.get(timeout=900) for _ in range(micro)]
        group_ms = (time.perf_counter() - start) * 1e3
    finally:
        process.terminate()
    element_ms = {
        node: round(statistics.median(
            frame.metrics.get(f"time_{node}", 0.0)
            for _, frame, _ in served) * 1e3, 2)
        for node in ("asr", "text", "lm", "reply", "detector")}
    chip_smoke.say("group", mode="config5", wall_ms=f"{group_ms:.1f}",
                   device_busy_ms=f"{busy_total:.1f}",
                   device_busy_share=f"{busy_total / group_ms:.3f}",
                   idle_share=f"{1 - busy_total / group_ms:.3f}",
                   kernel_launches=sum(count for count, _ in
                                       merged.values()),
                   flash_attention_ms=f"{flash_ms(merged):.2f}",
                   element_ms_median_per_frame=json.dumps(element_ms),
                   card=repr(smi))
    say_top_kernels(merged)


ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]
MODES = {"speech": profile_speech, "config5": profile_config5}


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) > 1 else "speech"
    if mode not in MODES:
        raise SystemExit(f"usage: chip_profile.py [{'|'.join(MODES)}]")
    MODES[mode](chip_smoke.phase_card())


if __name__ == "__main__":
    main()
