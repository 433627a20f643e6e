"""Drive the PyTorch/CUDA port's speech-serving, training, LM-serving
and serving-tier paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero and prints no
result:

  0. the card: nvidia-smi's name and power limit, torch's device name and
     count (no CUDA device: fail)
  1. build every kernel library from csrc/ with nvcc (sm_90a), one nvcc
     per source, all started together; print each kernel's registers and
     spill bytes as ptxas reports them (kernel<dtype,D>), and fail on any
     spill
  2. hold the flash-attention forward kernel (K1) against its plain
     PyTorch version on the card, at the serving and training shapes and
     at the edges the kernels meet (bf16 at D = 16, 32, 64, 128, ragged,
     causal with a negative q_offset; f32), and a second launch bitwise
     equal to the first
  2b. hold the backward kernels (K2 dQ, K3 dK/dV) against their plain
     version on the card, on the same inputs and the same dO (bf16 at
     D = 16, 32, 64, 128, ragged, causal with a negative q_offset; f32),
     and a second launch bitwise equal to the first
  3. time K1 at the serving shape and K1, K2, K3 at the llama32_1b
     training shape with CUDA events, beside their bounds (and the
     achieved TFLOP/s and kernel/bound ratio), their plain versions and
     PyTorch's scaled_dot_product_attention forward and backward (timed
     only, never used by the port)
  4. asr_tones (the committed trained checkpoint) through the port's
     Process / create_pipeline on CUDA: exact transcripts
  5. whisper_small at full width (random weights from a seed) through the
     same entry points: encoder against the plain attention path, then
     serving: frames/s, p50 frame latency, real-time factor, kernel
     launches, peak device memory
  6. llama32_1b training at full width (16 layers, batch 4 x 1024, random
     weights from a seed) through make_train_step: one step's loss and
     attention-weight gradients against the plain attention path, the
     loss falling on a fixed batch, then tokens/s, step time, train MFU,
     peak device memory and K1/K2/K3 launches per step, and one more step
     under torch.profiler: device idle share and where the time goes
  7. asr_tones trained from a seeded init on the card through
     make_asr_train_step until held-out tones transcribe exactly
  8. the config-5 serving graph, (sources (asr (text) (lm (reply)))
     (detector)), at full width (whisper_small, llama32_1b, the
     yolov8n-shape detector at 640 px, bf16, random weights from seeds):
     8a the LM's cached prefill (masked einsum) against the cacheless
        forward (K1 causal) at llama32_1b width on 16-token prompts;
     8b greedy generation of a small f32 LM on the card token for token
        equal to the CPU's;
     8c the committed detector checkpoint on the card: the right class
        and IoU >= 0.5 with the true box;
     8d serving through Process / create_pipeline: one warm-up group and
        4 measured groups of 8 frames x 16 rows, every output checked,
        then frames/s, p50 frame latency, per-element times, LM tokens/s,
        K1 launches and peak device memory
  9. the continuous decode engine (decode/engine.py, paged KV steps
     replayed as captured CUDA graphs) at llama32_1b's full width, bf16,
     on bench.py's config-6b workload (8 slots, 32-position blocks, 96
     seeded requests, prompts of 32-128 tokens, 16-96 new tokens):
     9a warm-up, capacity with every slot busy, then open-loop arrivals
        at twice that: goodput tokens/s, TTFT p50/p99, ms per engine
        step, slot occupancy, step signatures added in the window (must
        be 0), peak memory; 20 steps under torch.profiler (idle share)
        and one graph replay's device time; the same requests submitted
        all at once and through a pool cut until preemption fires, each
        request's tokens identical to the open-loop run's;
     9b 16 steps of one slot state replayed from the graph and run
        eagerly: identical tokens;
     9c the same weights in f32 (TF32 off): 12 requests through the
        engine, closed-batch generate one at a time, the engine with
        prefill_chunk_size 64 and with a 2-layer draft (k = 4): identical
        tokens (any difference fails, printed with its top-2 logit gap);
     9d 4 frames of 8 text rows (the BPE tokenizer) through LMGenerate
        `continuous: true` in a pipeline: every frame completes with the
        engine's tokens for the same rows
 10. the serving tier (serve/, decode/disagg.py, decode/checkpoint.py) at
     llama32_1b's full width, bf16, one set of seeded weights shared by
     every engine and replica:
     10a bench.py's config 6f: 64 decode requests open-loop at 0.4x the
         capacity and 8 long 256-token prompts mid-run, colocated (long
         prompts prefill on the decode engine) and disaggregated (a
         PrefillEngine on its own thread, its handoffs adopted into free
         slots): identical tokens, 8 adopted, 0 fallbacks, 0 signatures;
         KV MiB per long prompt, adopt ms and decode TTFT p50/p99 per
         arm; then text frames through a `disagg: role=prefill` pipeline
         and a decode pipeline behind Gateway(disagg=...), equal to a
         colocated engine's tokens;
     10b warm failover (bench.py's _chaos_decode_replica_kill): 12
         checkpointed streams on one replica of two, killed mid-decode by
         the seeded plan's replica_kill: the same tokens as the uncrashed
         arm, 0 frames lost, 12 restores, 0 restore fallbacks, 0 survivor
         signatures; recovery TTFT, checkpoint MiB and ms per tick and the
         checkpointer's share of a step;
     10c prefix affinity and the keeper store in f32: a hinted stream
         routes to the replica holding its prefix, the other replica
         pre-warms it from the keeper, warm tokens equal cold ones;
     10d admission under 2x overload (bench.py --router 2): two Detector
         replicas (yolov8n shape, 640 px, micro_batch 16), 16 streams x
         30 frames; goodput, shed rate, admitted p50/p99, 0 frames lost,
         every admitted frame's detections bit-equal to the direct
         replica's

The last three lines are the card's nvidia-smi name and power limit, one
JSON object describing every kernel of the paths, and {"ok": true,
"device": {...}}.  Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import ast
import json
import pathlib
import queue
import re
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

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
# order 1, the tensor-core kernel's rounding of P to bf16 before P.V
# (2^-9 relative per entry, averaged over the keys), and f32 sums taken in
# another order -> atol/rtol 2e-2; f32 O
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
# backward kernels against the plain f32 version on the same inputs: the
# bf16 kernels round P and dS to bf16 before the second product and each
# gradient once more (2^-9 relative each), from f32 sums of up to 1024
# terms taken in another order -> per-tensor relative error
# ||g - g_ref|| / ||g_ref|| <= 2e-2; an f32 gradient differs only by
# summation order over up to 251 products of order 1 -> atol 1e-4
GRAD_REL_TOL = 2e-2
GRAD_F32_ATOL = 1e-4
# one llama32_1b training step, kernel path against the plain attention
# path on the same weights and tokens: every activation is bf16, and each
# of the 16 layers rounds its attention output (and, in the backward, its
# dQ/dK/dV) to bf16 from differently ordered f32 sums; those one-ulp
# differences (2^-9 relative) pass through 16 residual layers forward and
# back, so the loss (~11.9) may move by 1e-2 and the gradient of each
# stacked wq/wk/wv/wo leaf by 5e-2 relative
TRAIN_LOSS_ATOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2


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
    """Median milliseconds per call of `function` over `runs` samples,
    each a run of 10 back-to-back calls between two CUDA events, after
    `warmup` untimed calls.  Within a run the host enqueues the next call
    while the device computes this one, so the host time a wrapper spends
    before its launch is not counted as device time (with one call per
    sample it would be, once the kernel is as short as the wrapper)."""
    for _ in range(warmup):
        function()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            function()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return statistics.median(times)


def device_ms(function, runs: int = 10) -> float:
    """Mean device milliseconds of `function`: the time of the kernels it
    launches, summed by torch.profiler over `runs` calls after a warm-up.
    Unlike CUDA events around the call, this leaves out the gaps where
    the device waits for a host that enqueues slower than it computes."""
    function()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as profile:
        for _ in range(runs):
            function()
        torch.cuda.synchronize()
    total_us = sum(event.time_range.elapsed_us()
                   for event in profile.events()
                   if event.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / runs / 1e3


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


def ptxas_stats(log: str) -> dict:
    """kernel<template arguments> -> {"registers", "spill_bytes"} from
    what `nvcc -Xptxas -v` printed (spill stores plus spill loads)."""
    stats, label = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            name = re.search(r"(flash_[a-z]+(?:_[a-z]+)*)I", mangled)
            # the element type of the tensors the kernel takes: a
            # template argument or the type of its first pointer
            dtype = ("bf16," if "13__nv_bfloat16" in mangled else
                     "f32," if "IfLi" in mangled or "EEvPKf" in mangled
                     else "")
            dim = re.search(r"Li(\d+)E", mangled)
            label = (f"{name.group(1) if name else mangled}"
                     f"<{dtype}{dim.group(1) if dim else ''}>")
            stats[label] = {}
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and label:
            stats[label]["spill_bytes"] = int(spill.group(1)) + int(
                spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and label:
            stats[label]["registers"] = int(used.group(1))
    return stats


# every kernel the libraries build, as ptxas_stats labels them: each C
# entry point runs the tensor-core kernel for bf16 and the CUDA-core one
# for f32, at every head size
BUILT_KERNELS = tuple(
    f"{kernel}<{dtype},{dim}>"
    for kernel, dtype in (
        ("flash_forward_kernel_tc", "bf16"), ("flash_forward_kernel", "f32"),
        ("flash_dq_kernel_tc", "bf16"), ("flash_dq_kernel", "f32"),
        ("flash_dkv_kernel_tc", "bf16"), ("flash_dkv_kernel", "f32"))
    for dim in (16, 32, 64, 128))


def phase_build() -> None:
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    kernels.build_all()
    for name in kernels.KERNEL_SOURCES:
        kernels.load_kernel(name)
    stats = {}
    for name in kernels.KERNEL_SOURCES:
        stats.update(ptxas_stats(kernels.build_logs.get(name, "")))
    spilled = {label: stat for label, stat in stats.items()
               if stat.get("spill_bytes", 0)}
    say("1 build", libraries=",".join(kernels.KERNEL_SOURCES),
        kernels=",".join(kernels.KERNELS),
        seconds=f"{time.perf_counter() - start:.2f}",
        nvcc_seconds=json.dumps(kernels.build_seconds),
        registers_and_spill_bytes=json.dumps(
            {label: f"{stat.get('registers')}/{stat.get('spill_bytes')}"
             for label, stat in stats.items()}))
    missing = [label for label in BUILT_KERNELS if label not in stats]
    if missing:
        raise SystemExit(f"nvcc printed no ptxas statistics for {missing}")
    if spilled:
        raise SystemExit(f"kernels spill to local memory: {spilled}")


# (B, H, Lq, Lk, D, dtype, causal, q_offset)
KERNEL_CASES = {
    "serving_encoder_bf16": (128, 12, 251, 251, 64, torch.bfloat16, False,
                             0),
    "causal_300": (8, 12, 300, 300, 64, torch.bfloat16, True, 0),
    "causal_37x251": (8, 12, 37, 251, 64, torch.bfloat16, True, 0),
    "cross_37x251": (8, 12, 37, 251, 64, torch.bfloat16, False, 0),
    "asr_tones_d16_f32": (4, 4, 12, 12, 16, torch.float32, False, 0),
    "lm_training_bf16": (4, 32, 1024, 1024, 64, torch.bfloat16, True, 0),
    "d16_causal_bf16": (8, 8, 200, 200, 16, torch.bfloat16, True, 0),
    "d32_causal_bf16": (8, 8, 300, 300, 32, torch.bfloat16, True, 0),
    "d128_causal_bf16": (4, 8, 520, 520, 128, torch.bfloat16, True, 0),
    "ragged_65x129_d128_bf16": (2, 4, 65, 129, 128, torch.bfloat16, False,
                                0),
    "causal_q_offset_bf16": (4, 8, 50, 130, 32, torch.bfloat16, True, -7),
    "f32_causal_q_offset": (4, 8, 50, 130, 32, torch.float32, True, -7),
    "f32_d128_ragged": (2, 4, 65, 129, 128, torch.float32, False, 0),
}


def phase_kernel_checks() -> float:
    """Every case against the plain f32 version, and a second launch on
    the same inputs bitwise equal to the first (one owner block per
    output tile, no atomics); returns the O max abs error at the serving
    shape."""
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_forward, flash_attention_plain)
    serving_error = None
    for index, (case, spec) in enumerate(KERNEL_CASES.items()):
        batch, heads, q_len, k_len, dim, dtype, causal, q_offset = spec
        q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype,
                             seed=index)
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           q_offset=q_offset)
        repeat = flash_attention_forward(q, k, v, causal=causal,
                                         q_offset=q_offset)
        torch.cuda.synchronize()
        if not (torch.equal(out, repeat[0]) and torch.equal(lse, repeat[1])):
            raise SystemExit(f"{case}: two launches on the same inputs "
                             f"differ")
        del repeat
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
            q_offset=q_offset, o_max_abs_err=f"{out_error:.3e}",
            lse_max_abs_err=f"{lse_error:.3e}", bitwise_repeat=True,
            ok=True)
        if case == "serving_encoder_bf16":
            serving_error = out_error
    return serving_error


# (B, H, Lq, Lk, D, dtype, causal, q_offset)
BACKWARD_CASES = {
    "lm_training_bf16": (4, 32, 1024, 1024, 64, torch.bfloat16, True, 0),
    "whisper_encoder_bf16": (16, 12, 251, 251, 64, torch.bfloat16, False,
                             0),
    "cross_16x251_bf16": (16, 12, 16, 251, 64, torch.bfloat16, False, 0),
    "causal_37x251_bf16": (8, 12, 37, 251, 64, torch.bfloat16, True, 0),
    "d16_causal_bf16": (8, 8, 200, 200, 16, torch.bfloat16, True, 0),
    "d32_causal_bf16": (8, 8, 300, 300, 32, torch.bfloat16, True, 0),
    "d128_causal_bf16": (4, 8, 520, 520, 128, torch.bfloat16, True, 0),
    "ragged_65x129_d128_bf16": (2, 4, 65, 129, 128, torch.bfloat16, False,
                                0),
    "causal_q_offset_bf16": (4, 8, 50, 130, 32, torch.bfloat16, True, -7),
    "f32_causal_q_offset": (4, 8, 50, 130, 32, torch.float32, True, -7),
    "f32_d128_ragged": (2, 4, 65, 129, 128, torch.float32, False, 0),
    "asr_tones_d16_f32": (32, 4, 21, 21, 16, torch.float32, False, 0),
}


def relative_error(actual, expected) -> float:
    return ((actual.float() - expected.float()).norm()
            / expected.float().norm()).item()


def phase_backward_checks() -> dict:
    """K2 and K3 against the plain f32 backward on the same inputs and
    the same dO, and a second launch on the same inputs bitwise equal to
    the first (one owner block per output tile, no atomics); returns the
    max abs errors at the training shape."""
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_forward)
    errors = None
    for index, (case, spec) in enumerate(BACKWARD_CASES.items()):
        batch, heads, q_len, k_len, dim, dtype, causal, q_offset = spec
        q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype,
                             seed=100 + index)
        dout = random_qkv(batch, heads, q_len, 1, dim, dtype,
                          seed=200 + index)[0]
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           q_offset=q_offset)
        grads = flash_attention_backward(q, k, v, out, lse, dout,
                                         causal=causal, q_offset=q_offset)
        repeat = flash_attention_backward(q, k, v, out, lse, dout,
                                          causal=causal, q_offset=q_offset)
        torch.cuda.synchronize()
        if not all(torch.equal(first, second)
                   for first, second in zip(grads, repeat)):
            raise SystemExit(f"{case}: two launches on the same inputs "
                             f"differ")
        del repeat
        expected = flash_attention_backward_plain(
            q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
            causal=causal, q_offset=q_offset)
        fields = {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, expected):
            if got.dtype != dtype or got.shape != want.shape:
                raise SystemExit(f"{case}: {name} is {got.dtype} "
                                 f"{tuple(got.shape)}")
            error = relative_error(got, want)
            fields[f"{name}_max_abs_err"] = (got.float() - want).abs().max(
                ).item()
            fields[f"{name}_rel_err"] = error
            if dtype == torch.bfloat16 and error > GRAD_REL_TOL:
                raise SystemExit(f"{case}: {name} relative error "
                                 f"{error:.3e} > {GRAD_REL_TOL}")
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=GRAD_F32_ATOL,
                                           rtol=0)
        say("2b backward_vs_plain", case=case,
            shape=f"{batch}x{heads}x{q_len}x{k_len}x{dim}",
            dtype=str(dtype).replace("torch.", ""), causal=causal,
            q_offset=q_offset,
            **{key: f"{value:.3e}" for key, value in fields.items()},
            bitwise_repeat=True, ok=True)
        if case == "lm_training_bf16":
            errors = {"flash_attention_dq": fields["dq_max_abs_err"],
                      "flash_attention_dkv": max(fields["dk_max_abs_err"],
                                                 fields["dv_max_abs_err"])}
    return errors


def visible_pairs(q_len: int, k_len: int, causal: bool,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps: the work a causal kernel must
    do for these inputs."""
    if not causal:
        return q_len * k_len
    diagonal = q_offset + k_len - q_len
    return int(sum(min(k_len, max(0, row + diagonal + 1))
                   for row in range(q_len)))


def bound(moved: int, operations: int, peaks: dict) -> tuple:
    """(least ms, what bounds it): each input read once and each output
    written once at the memory rate, the operations at the bf16 peak."""
    bytes_ms = moved / peaks["bytes"] * 1e3
    operations_ms = operations / peaks["bfloat16"] * 1e3
    if bytes_ms >= operations_ms:
        return bytes_ms, "bytes"
    return operations_ms, "operations"


def tflops(operations: int, ms: float) -> float:
    """Achieved rate: the operations the inputs need over the time."""
    return operations / (ms * 1e-3) / 1e12


def phase_timing(smi: str) -> dict:
    """Kernel, plain and library times; returns the JSON fields of each
    kernel (K1 at the serving shape, K2/K3 at the training shape)."""
    from aiko_services_tpu_torch.parallel import attention
    peaks_name, peaks = peaks_for(smi)
    peaks_text = (f"{peaks_name}:{peaks['bytes']:.3g}B/s,"
                  f"{peaks['bfloat16']:.3g}FLOP/s(bf16)")
    timings = {}
    for case in ("serving_encoder_bf16", "lm_training_bf16"):
        batch, heads, q_len, k_len, dim, dtype, causal, _ = KERNEL_CASES[
            case]
        q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype,
                             seed=99)
        kernel_ms = cuda_ms(lambda: attention.flash_attention_forward(
            q, k, v, causal=causal))
        plain_ms = cuda_ms(lambda: attention.flash_attention_plain(
            q, k, v, causal=causal))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + batch * heads * q_len * 4
        operations = 4 * dim * batch * heads * visible_pairs(
            q_len, k_len, causal)
        bound_ms, bound_by = bound(moved, operations, peaks)
        say("3 timing", kernel="flash_attention", case=case,
            shape=f"{batch}x{heads}x{q_len}x{k_len}x{dim}", causal=causal,
            dtype="bfloat16", kernel_ms=f"{kernel_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            kernel_over_bound=f"{kernel_ms / bound_ms:.2f}",
            tflops=f"{tflops(operations, kernel_ms):.1f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bytes=moved, operations=operations, peaks=peaks_text,
            card=repr(smi))
        if case == "serving_encoder_bf16":
            timings["flash_attention"] = {
                "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    # the backward at the llama32_1b training shape
    batch, heads, q_len, k_len, dim, dtype, causal, _ = KERNEL_CASES[
        "lm_training_bf16"]
    q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype, seed=98)
    dout = random_qkv(batch, heads, q_len, 1, dim, dtype, seed=97)[0]
    scale = 1.0 / dim ** 0.5
    out, lse = attention.flash_attention_forward(q, k, v, causal=causal)
    delta = torch.sum(dout.float() * out.float(), dim=-1)
    arguments = (q, k, v, dout, lse, delta, causal, scale, 0)
    # SDPA's backward alone: the device time of forward + backward less
    # that of the forward (its autograd call enqueues slower than the
    # device runs it, so CUDA events around it would time the host)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))

    def sdpa_forward():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_forward_backward():
        torch.autograd.grad(sdpa_forward(), (qg, kg, vg), dout)

    library_ms = device_ms(sdpa_forward_backward) - device_ms(sdpa_forward)
    pairs = visible_pairs(q_len, k_len, causal)
    tensor_bytes = q.numel() * q.element_size()
    stats_bytes = 2 * batch * heads * q_len * 4       # lse and delta
    for kernel, launch, plain, outputs, flop_per_pair in (
            ("flash_attention_dq", attention._flash_kernel_dq,
             attention.flash_attention_dq_plain, 1, 6),
            ("flash_attention_dkv", attention._flash_kernel_dkv,
             attention.flash_attention_dkv_plain, 2, 8)):
        kernel_ms = cuda_ms(lambda: launch(*arguments))
        plain_ms = cuda_ms(lambda: plain(*arguments))
        moved = (4 + outputs) * tensor_bytes + stats_bytes
        operations = flop_per_pair * dim * batch * heads * pairs
        bound_ms, bound_by = bound(moved, operations, peaks)
        say("3 timing", kernel=kernel, case="lm_training_bf16",
            shape=f"{batch}x{heads}x{q_len}x{k_len}x{dim}", causal=causal,
            dtype="bfloat16", kernel_ms=f"{kernel_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            kernel_over_bound=f"{kernel_ms / bound_ms:.2f}",
            tflops=f"{tflops(operations, kernel_ms):.1f}",
            plain_ms=f"{plain_ms:.4f}",
            library_ms_sdpa_backward_pair=f"{library_ms:.4f}", bytes=moved,
            operations=operations, peaks=peaks_text, card=repr(smi))
        timings[kernel] = {"ms": kernel_ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": library_ms}
    return timings


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


# -- training ------------------------------------------------------------------

# the bench.py config-4c shape at the architecture's full 16 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6


class PlainAttention(torch.autograd.Function):
    """The plain attention path: the kernels' plain versions, forward and
    backward, on the card.  A reference for phase 6 only; the port's
    flash_attention never takes them for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from aiko_services_tpu_torch.parallel.attention import (
            flash_attention_plain)
        out, lse = flash_attention_plain(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        from aiko_services_tpu_torch.parallel.attention import (
            flash_attention_backward_plain)
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward_plain(q, k, v, out, lse, dout,
                                                causal=ctx.causal), None)


def plain_attention(q, k, v, causal=False, **_):
    return PlainAttention.apply(q, k, v, causal)


def phase_llama_training(smi: str) -> dict:
    """Returns the kernel launches of the measured training steps."""
    from aiko_services_tpu_torch.models import (
        LLAMA32_1B, adamw, count_params, init_params, make_train_step)
    from aiko_services_tpu_torch.models import transformer
    from aiko_services_tpu_torch.models.optim import (
        next_token_loss, value_and_grad)
    from aiko_services_tpu_torch.ops import kernels

    config = LLAMA32_1B
    start = time.perf_counter()
    params = init_params(config, torch.Generator().manual_seed(0),
                         device="cuda")
    n_params = count_params(params)
    rng = np.random.default_rng(0)

    def random_tokens():
        return torch.from_numpy(rng.integers(
            0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()

    tokens = random_tokens()
    torch.cuda.synchronize()
    say("6 llama32_1b_setup", layers=config.n_layers,
        d_model=config.d_model, heads=f"{config.n_heads}/{config.n_kv_heads}",
        d_ff=config.d_ff, vocab=config.vocab_size, dtype=config.dtype,
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        init_seconds=f"{time.perf_counter() - start:.1f}")

    # (a) one step's loss and attention gradients: kernels vs plain path
    def loss_fn(params, tokens):
        logits = transformer.forward(params, config, tokens[:, :-1])
        return next_token_loss(logits, tokens[:, 1:])

    def attention_grads():
        loss, grads = value_and_grad(loss_fn, params, tokens)
        return loss.item(), {name: grads["layers"][name]["w"]
                             for name in ("wq", "wk", "wv", "wo")}

    kernel_loss, kernel_grads = attention_grads()
    kernel_attention = transformer.flash_attention
    transformer.flash_attention = plain_attention
    try:
        plain_loss, plain_grads = attention_grads()
    finally:
        transformer.flash_attention = kernel_attention
    errors = {name: relative_error(kernel_grads[name], plain_grads[name])
              for name in kernel_grads}
    worst_layer = {name: max(relative_error(kernel_grads[name][layer],
                                            plain_grads[name][layer])
                             for layer in range(config.n_layers))
                   for name in kernel_grads}
    del kernel_grads, plain_grads
    if not (np.isfinite(kernel_loss) and abs(kernel_loss - plain_loss)
            <= TRAIN_LOSS_ATOL):
        raise SystemExit(f"llama32_1b loss {kernel_loss} (kernels) vs "
                         f"{plain_loss} (plain)")
    if max(errors.values()) > TRAIN_GRAD_REL_TOL:
        raise SystemExit(f"llama32_1b attention gradients differ from the "
                         f"plain path: {errors}")
    say("6a llama32_1b_kernel_vs_plain", loss_kernel=f"{kernel_loss:.6f}",
        loss_plain=f"{plain_loss:.6f}",
        grad_rel_err=json.dumps({key: float(f"{value:.3e}")
                                 for key, value in errors.items()}),
        worst_layer_rel_err=json.dumps({key: float(f"{value:.3e}")
                                        for key, value in
                                        worst_layer.items()}), ok=True)

    # (b) the loss falls on a fixed batch
    optimizer = adamw(1e-3)
    opt_state = optimizer.init(params)
    train_step = make_train_step(config, optimizer)
    losses = []
    for _ in range(5):
        params, opt_state, loss = train_step(params, opt_state, tokens)
        losses.append(loss.item())
    if not (np.isfinite(losses).all() and min(losses[1:]) < losses[0]):
        raise SystemExit(f"llama32_1b loss did not fall: {losses}")
    say("6b llama32_1b_loss_falls", optimizer="adamw(1e-3)",
        losses=json.dumps([round(value, 4) for value in losses]), ok=True)
    del opt_state, train_step

    # (c) throughput: 1 warm-up step, then TRAIN_STEPS measured steps
    optimizer = adamw(1e-4)
    opt_state = optimizer.init(params)
    train_step = make_train_step(config, optimizer)
    batches = [random_tokens() for _ in range(TRAIN_STEPS + 1)]
    params, opt_state, loss = train_step(params, opt_state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    losses = []
    for batch in batches[1:]:
        params, opt_state, loss = train_step(params, opt_state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {name: kernels.launch_counts[name]
                for name in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = [value.item() for value in losses]
    if not np.isfinite(losses).all():
        raise SystemExit(f"llama32_1b losses not finite: {losses}")
    for name, count in launches.items():
        if count != config.n_layers * TRAIN_STEPS:
            raise SystemExit(f"{name}: {count} launches in {TRAIN_STEPS} "
                             f"steps, expected {config.n_layers} per step")
    tokens_per_s = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / elapsed
    # fwd + bwd ~ 6 * params FLOPs per token, attention terms omitted
    # (bench.py's conservative definition)
    mfu = 6 * n_params * tokens_per_s / peaks_for(smi)[1]["bfloat16"]
    say("6c llama32_1b_training", optimizer="adamw(1e-4)",
        steps=TRAIN_STEPS, tokens_per_s=f"{tokens_per_s:.1f}",
        step_ms=f"{elapsed / TRAIN_STEPS * 1e3:.1f}",
        train_mfu=f"{mfu:.4f}",
        max_memory_allocated_gib=f"{peak / 2**30:.2f}",
        launches_per_step=json.dumps({name: count / TRAIN_STEPS
                                      for name, count in launches.items()}),
        losses=json.dumps([round(value, 4) for value in losses]),
        card=repr(smi))
    profile_train_step(train_step, params, opt_state, random_tokens(), smi)
    del params, opt_state, train_step, batches
    torch.cuda.empty_cache()
    return launches


# kernel-name fragments -> the part of a train step's device time they
# are, matched in this order (the f32 LM-head GEMMs run on the CUDA cores)
STEP_PARTS = (
    ("flash_attention_ms", ("flash_forward_kernel",)),
    ("flash_attention_dq_ms", ("flash_dq_kernel",)),
    ("flash_attention_dkv_ms", ("flash_dkv_kernel",)),
    ("f32_gemm_ms", ("f32f32", "sgemm")),
    ("bf16_gemm_ms", ("gemm", "nvjet", "cutlass")),
)


def profile_train_step(train_step, params, opt_state, tokens,
                       smi: str) -> None:
    """One more train step under torch.profiler: the device's busy and
    idle share of its wall time, and where the device time goes."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as profile:
        start = time.perf_counter()
        train_step(params, opt_state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    parts = {name: 0.0 for name, _ in STEP_PARTS}
    parts["other_ms"] = 0.0
    busy_ms, launches = 0.0, 0
    for event in profile.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = event.time_range.elapsed_us() / 1e3
        busy_ms += ms
        launches += 1
        part = next((name for name, fragments in STEP_PARTS
                     if any(fragment in event.name
                            for fragment in fragments)), "other_ms")
        parts[part] += ms
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    say("6d llama32_1b_step_profile", wall_ms=f"{wall_ms:.1f}",
        device_busy_ms=f"{busy_ms:.1f}",
        idle_share=f"{1 - busy_ms / wall_ms:.3f}",
        device_launches=launches,
        **{name: f"{value:.2f}" for name, value in parts.items()},
        card=repr(smi))


# The training recipe of examples/train_asr_tones.py (kept here as a copy:
# this script imports nothing of the examples): four tone classes, each
# labelled with a word in the byte-level toy vocabulary (0 pad, 1 sot,
# 2 eot, 3..258 bytes), jittered tones to train on, held-out tones plus
# the four clean tones to transcribe exactly.
TONE_SECONDS = 0.4
BYTE_OFFSET = 3
TONE_LABELS = {440.0: "alpha", 523.25: "bravo", 659.25: "charlie",
               783.99: "delta"}
TOKEN_WIDTH = 10  # sot + longest word (7) + eot, eot-padded
TONE_STEPS = 2000


def encode_label(text: str) -> list:
    tokens = [1] + [BYTE_OFFSET + byte for byte in text.encode()] + [2]
    return tokens + [2] * (TOKEN_WIDTH - len(tokens))


def tone_batch(rng, per_class: int) -> tuple:
    """Jittered training tones: random phase, amplitude, mild noise,
    +-0.5% frequency wobble."""
    samples = int(TONE_SECONDS * SAMPLE_RATE)
    t = np.arange(samples) / SAMPLE_RATE
    audio, tokens = [], []
    for frequency, label in TONE_LABELS.items():
        for _ in range(per_class):
            freq = frequency * (1.0 + rng.uniform(-0.005, 0.005))
            phase = rng.uniform(0, 2 * np.pi)
            amplitude = rng.uniform(0.4, 1.1)
            wave = amplitude * np.sin(2 * np.pi * freq * t + phase)
            wave += rng.normal(0, rng.uniform(0.0, 0.02), samples)
            audio.append(wave.astype(np.float32))
            tokens.append(encode_label(label))
    return np.stack(audio), np.asarray(tokens, np.int32)


def phase_asr_tones_training() -> dict:
    """Returns the kernel launches of the training run."""
    from aiko_services_tpu_torch.models import (
        AsrConfig, adamw, init_asr_params, make_asr_train_step,
        transcribe_audio)
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram

    config = AsrConfig(
        n_mels=80, d_model=64, enc_layers=2, dec_layers=2, n_heads=4,
        vocab_size=259, max_frames=24, max_text_len=16, dtype="float32")
    params = init_asr_params(config, torch.Generator().manual_seed(0),
                             device="cuda")
    optimizer = adamw(3e-4)
    opt_state = optimizer.init(params)
    train_step = make_asr_train_step(config, optimizer)

    rng = np.random.default_rng(7)
    heldout_audio, heldout_tokens = tone_batch(np.random.default_rng(1234),
                                               per_class=4)
    t = np.arange(int(TONE_SECONDS * SAMPLE_RATE)) / SAMPLE_RATE
    clean = np.stack([np.sin(2 * np.pi * freq * t).astype(np.float32)
                      for freq in TONE_LABELS])
    clean_tokens = np.asarray([encode_label(label)
                               for label in TONE_LABELS.values()], np.int32)
    heldout_audio = torch.from_numpy(
        np.concatenate([heldout_audio, clean])).cuda()
    heldout_tokens = np.concatenate([heldout_tokens, clean_tokens])

    def heldout_exact() -> bool:
        with torch.no_grad():
            out = transcribe_audio(params, config, heldout_audio,
                                   max_tokens=TOKEN_WIDTH - 1)
        return bool(np.array_equal(out.cpu().numpy(),
                                   heldout_tokens[:, 1:]))

    kernels.reset_launch_counts()
    start = time.perf_counter()
    loss, exact = float("nan"), False
    for step in range(1, TONE_STEPS + 1):
        audio, tokens = tone_batch(rng, per_class=8)
        mel = log_mel_spectrogram(torch.from_numpy(audio).cuda(),
                                  n_mels=config.n_mels)
        params, opt_state, loss = train_step(params, opt_state, mel,
                                             torch.from_numpy(tokens).cuda())
        if step % 50 == 0:
            loss = loss.item()
            exact = heldout_exact()
            if exact and loss < 0.01:
                break
    elapsed = time.perf_counter() - start
    launches = {name: kernels.launch_counts[name]
                for name in kernels.KERNELS}
    if not (exact and loss < 0.01):
        raise SystemExit(f"asr_tones did not converge in {TONE_STEPS} "
                         f"steps: loss {loss}, held-out exact {exact}")
    if min(launches.values()) == 0:
        raise SystemExit(f"asr_tones trained without a kernel: {launches}")
    say("7 asr_tones_training", steps=step, final_loss=f"{loss:.5f}",
        heldout_exact=exact, heldout_rows=len(heldout_tokens),
        seconds=f"{elapsed:.1f}", launches=json.dumps(launches))
    return launches


# -- the config-5 serving graph --------------------------------------------

# bench.py::_multimodal_setup at its throughput operating point: 16 rows
# of 5 s audio and 640 px images per frame, micro_batch 8 on the three
# model stages (128 rows per fused group), one group in flight
C5_ROWS, C5_SECONDS, C5_MICRO, C5_GROUPS = 16, 5.0, 8, 4
C5_MAX_TOKENS, C5_MAX_NEW, C5_IMAGE = 16, 32, 640
# 8a: llama32_1b's last-position logits (values of order 1) from the
# cached prefill (f32 q.k^T, softmax in f32, bf16 P.V) against the
# cacheless forward (K1: bf16 P, another summation order): each of the
# 16 layers rounds its attention output to bf16 from differently
# ordered sums, and those one-ulp differences (2^-8 relative) pass
# through 16 residual layers -> atol 1e-1
LM_CACHE_TOL = 1e-1


def config5_definition() -> dict:
    samples = int(C5_SECONDS * SAMPLE_RATE)
    audio_t = f"f32[b,{samples}]"
    image_t = f"f32[b,3,{C5_IMAGE},{C5_IMAGE}]"
    tokens_t = f"i32[b,{C5_MAX_TOKENS}]"
    generated_t = f"i32[b,{C5_MAX_NEW}]"
    # micro_batch_wait_ms: the flush waits for the full group of 8
    batching = {"micro_batch": C5_MICRO, "micro_batch_wait_ms": 5000}

    def local(class_name):
        return {"local": {"module": MODULE, "class_name": class_name}}

    return {
        "name": "config5",
        "graph": ["(sources (asr (text) (lm (reply))) (detector))"],
        "parameters": {"device": "cuda"},
        "elements": [
            {"name": "sources",
             "output": [{"name": "audio", "type": audio_t},
                        {"name": "image", "type": image_t},
                        {"name": "t0", "type": "float"}],
             "parameters": {"data_sources": [[440, C5_SECONDS]],
                            "image_shape": [3, C5_IMAGE, C5_IMAGE],
                            "data_batch_size": C5_ROWS, "timestamps": True,
                            "on_device": True,
                            "count": C5_MICRO * (C5_GROUPS + 1)},
             "deploy": local("MultiModalSource")},
            {"name": "asr",
             "input": [{"name": "audio", "type": audio_t}],
             "output": [{"name": "tokens", "type": tokens_t}],
             "parameters": {"preset": "whisper_small", "max_frames": 512,
                            "max_tokens": C5_MAX_TOKENS,
                            "dtype": "bfloat16", **batching},
             "deploy": local("SpeechToText")},
            {"name": "text",
             "input": [{"name": "tokens", "type": tokens_t}],
             "output": [{"name": "text", "type": "str"}],
             "parameters": {"workers": 32},
             "deploy": local("TokensToText")},
            {"name": "lm",
             "input": [{"name": "tokens", "type": tokens_t}],
             "output": [{"name": "generated", "type": generated_t}],
             "parameters": {"preset": "llama32_1b", "dtype": "bfloat16",
                            "max_new_tokens": C5_MAX_NEW, **batching},
             "deploy": local("LMGenerate")},
            {"name": "reply",
             "input": [{"name": "tokens", "type": generated_t}],
             "output": [{"name": "text", "type": "str"}],
             "map_in": {"tokens": "generated"},
             "map_out": {"text": "reply"},
             "parameters": {"workers": 32},
             "deploy": local("TokensToText")},
            {"name": "detector",
             "input": [{"name": "image", "type": image_t}],
             "output": [{"name": "detections", "type": "dict"}],
             "parameters": {"preset": "yolov8n", "dtype": "bfloat16",
                            **batching},
             "deploy": local("Detector")},
        ],
    }


def phase_lm_cache_vs_kernel(params, config) -> None:
    """8a: the cached prefill's last-position logits against the
    cacheless forward's (K1 causal) on the same 16-token prompts."""
    from aiko_services_tpu_torch.models import forward, init_cache
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, config.vocab_size, (C5_ROWS, C5_MAX_TOKENS)).astype(
            np.int32)).cuda()
    with torch.no_grad():
        cache = init_cache(config, C5_ROWS,
                           max_len=C5_MAX_TOKENS + C5_MAX_NEW,
                           device=tokens.device)
        cached, _ = forward(params, config, tokens, cache=cache, pos=0)
        cached = cached[:, -1]
        kernel = forward(params, config, tokens)[:, -1]
    torch.cuda.synchronize()
    if not (torch.isfinite(cached).all() and torch.isfinite(kernel).all()):
        raise SystemExit("8a: llama32_1b logits are not finite")
    error = (cached - kernel).abs()
    same_argmax = (cached.argmax(-1) == kernel.argmax(-1)).float().mean()
    say("8a lm_cache_vs_k1", rows=C5_ROWS, prompt=C5_MAX_TOKENS,
        vocab=config.vocab_size, max_abs_err=f"{error.max().item():.3e}",
        mean_abs_err=f"{error.mean().item():.3e}", tolerance=LM_CACHE_TOL,
        logit_abs_max=f"{kernel.abs().max().item():.3f}",
        same_argmax_share=f"{same_argmax.item():.3f}")
    if error.max().item() > LM_CACHE_TOL:
        raise SystemExit(f"8a: cached prefill differs from the K1 forward "
                         f"by {error.max().item():.3e} > {LM_CACHE_TOL}")


def phase_generate_f32_vs_cpu() -> None:
    """8b: greedy tokens of LM_TOY at f32 on the card equal the CPU's."""
    from aiko_services_tpu_torch.models import LM_TOY, generate, init_params
    from aiko_services_tpu_torch.utils.tree import tree_map
    params = init_params(LM_TOY, torch.Generator().manual_seed(3),
                         device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        3, LM_TOY.vocab_size, (8, 12)).astype(np.int32))
    expected, _ = generate(params, LM_TOY, prompt, 24)
    actual, cache = generate(tree_map(lambda leaf: leaf.cuda(), params),
                             LM_TOY, prompt.cuda(), 24)
    if not cache["k"].is_cuda:
        raise SystemExit("8b: the cache is not on the card")
    same = torch.equal(actual.cpu(), expected)
    say("8b generate_f32_card_vs_cpu", rows=8, prompt=12, new_tokens=24,
        identical=same)
    if not same:
        raise SystemExit(f"8b: tokens on the card {actual.cpu().tolist()} "
                         f"differ from the CPU's {expected.tolist()}")


def phase_detector_checkpoint() -> None:
    """8c: the committed detector checkpoint on the card finds squares:
    the right class, IoU >= 0.5."""
    from aiko_services_tpu_torch.models import (
        DetectorConfig, SafetensorsFile, detect, load_pytree)
    asset = ROOT / "tests" / "assets" / "detector_shapes.safetensors"
    container = SafetensorsFile(asset)
    metadata = {key: ast.literal_eval(value)
                for key, value in container.metadata.items()}
    container.close()
    config = DetectorConfig(**metadata["config"])
    params = load_pytree(asset, dtype=config.dtype, device="cuda")
    colors = np.asarray(metadata["colors"], np.float32)
    size = config.image_size
    cases = [(0, 6, 8, 20), (1, 30, 12, 16), (2, 14, 34, 22),
             (3, 36, 36, 18)]
    images, boxes = [], []
    for class_id, x0, y0, side in cases:
        rng = np.random.default_rng(class_id * 1000 + x0 + y0)
        image = rng.uniform(0.0, 0.25, (3, size, size)).astype(np.float32)
        image[:, y0:y0 + side, x0:x0 + side] = (
            colors[class_id][:, None, None] * 0.9)
        images.append(image)
        boxes.append((x0, y0, x0 + side, y0 + side))
    found = detect(params, config, torch.from_numpy(np.stack(images)).cuda())
    ious = []
    for index, (class_id, *_) in enumerate(cases):
        valid = found["valid"][index].cpu().numpy()
        if valid.sum() != 1:
            raise SystemExit(f"8c: case {index}: {int(valid.sum())} "
                             f"detections, expected 1")
        slot = int(np.argmax(valid))
        if int(found["classes"][index, slot]) != class_id:
            raise SystemExit(f"8c: case {index}: class "
                             f"{int(found['classes'][index, slot])}, "
                             f"expected {class_id}")
        ious.append(box_iou(found["boxes"][index, slot].cpu().tolist(),
                            boxes[index]))
    if min(ious) < 0.5:
        raise SystemExit(f"8c: IoU {ious} below 0.5")
    say("8c detector_checkpoint", cases=len(cases),
        ious=json.dumps([round(value, 3) for value in ious]), ok=True)


def box_iou(a, b) -> float:
    inter = (max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
             * max(0.0, min(a[3], b[3]) - max(a[1], b[1])))
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1e-9)


def check_config5_outputs(outputs: dict, limits: dict) -> None:
    """Shapes, dtypes, devices and ranges of one served frame; `limits`
    holds the vocabularies, the detection slots and the class count."""
    def fail(what):
        raise SystemExit(f"8d: {what}")

    def check(name, value, shape, dtype):
        if not (value.is_cuda and value.dtype == dtype
                and tuple(value.shape) == shape):
            fail(f"{name} is {value.dtype} {tuple(value.shape)} on "
                 f"{value.device}")

    for name, width, vocab in (
            ("tokens", C5_MAX_TOKENS, limits["asr_vocab"]),
            ("generated", C5_MAX_NEW, limits["lm_vocab"])):
        check(name, outputs[name], (C5_ROWS, width), torch.int32)
        if not ((0 <= outputs[name]).all() and (outputs[name] < vocab).all()):
            fail(f"{name} outside [0, {vocab})")
    for name in ("text", "reply"):
        if not (isinstance(outputs[name], list)
                and len(outputs[name]) == C5_ROWS
                and all(isinstance(text, str) for text in outputs[name])):
            fail(f"{name} is not {C5_ROWS} strings")
    detections, slots = outputs["detections"], limits["detections"]
    check("boxes", detections["boxes"], (C5_ROWS, slots, 4), torch.float32)
    check("scores", detections["scores"], (C5_ROWS, slots), torch.float32)
    check("classes", detections["classes"], (C5_ROWS, slots), torch.int32)
    check("valid", detections["valid"], (C5_ROWS, slots), torch.bool)
    scores, classes = detections["scores"], detections["classes"]
    if not (torch.isfinite(detections["boxes"]).all()
            and (0 <= scores).all() and (scores <= 1).all()
            and (0 <= classes).all()
            and (classes < limits["classes"]).all()):
        fail("detections outside their ranges")
    if not isinstance(outputs.get("t0"), float):
        fail("no t0 timestamp")


def phase_config5(smi: str) -> dict:
    """Returns the kernel launches of the measured serving run."""
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    from aiko_services_tpu_torch.utils.tree import tree_leaves

    torch.cuda.empty_cache()
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, config5_definition())
        start = time.perf_counter()
        for name in ("asr", "lm", "detector"):
            pipeline.elements[name]._ensure_ready()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - start
        lm = pipeline.elements["lm"]
        phase_lm_cache_vs_kernel(lm.state, lm.config)
        phase_generate_f32_vs_cpu()
        phase_detector_checkpoint()
        detector = pipeline.elements["detector"].config
        limits = {"asr_vocab": pipeline.elements["asr"].config.vocab_size,
                  "lm_vocab": lm.config.vocab_size,
                  "detections": detector.max_detections,
                  "classes": detector.n_classes}
        lm_weight_bytes = sum(leaf.numel() * leaf.element_size()
                              for leaf in tree_leaves(lm.state))

        process.run(in_thread=True)
        responses = queue.Queue()
        torch.cuda.synchronize()
        pipeline.create_stream("s1", queue_response=responses,
                               parameters={"frame_window": C5_MICRO})
        warmup = [responses.get(timeout=900) for _ in range(C5_MICRO)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        measured = []   # (arrival time.time(), frame, outputs)
        for _ in range(C5_MICRO * C5_GROUPS):
            _, frame, outputs = responses.get(timeout=900)
            measured.append((time.time(), frame, outputs))
        elapsed = time.perf_counter() - start
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        summary = pipeline.telemetry.summary()
    finally:
        process.terminate()

    for *_, outputs in warmup + measured:
        check_config5_outputs(outputs, limits)
    groups = C5_GROUPS + 1
    if (summary["fused_groups"] != 3 * groups
            or summary["chained_groups"] or summary["errors"]):
        raise SystemExit(f"8d: expected {3 * groups} fused groups and no "
                         f"chained group or error: {summary}")
    encoder_layers = 12
    if launches["flash_attention"] < encoder_layers * C5_GROUPS:
        raise SystemExit(f"8d: {launches['flash_attention']} K1 launches "
                         f"in {C5_GROUPS} groups, expected at least "
                         f"{encoder_layers} per group")
    # frame latency: synthesis (t0) -> the response's arrival
    latencies = sorted(arrival - outputs["t0"]
                       for arrival, _, outputs in measured)
    stage_ms = {}
    for node in ("asr", "text", "lm", "reply", "detector"):
        values = [frame.metrics.get(f"time_{node}")
                  for _, frame, _ in measured]
        values = [value for value in values if value is not None]
        if values:
            stage_ms[node] = round(statistics.median(values) * 1e3, 2)
    frames = len(measured)
    tokens = frames * C5_ROWS * C5_MAX_NEW
    say("8d config5_serving", groups=C5_GROUPS, frames=frames,
        rows_per_frame=C5_ROWS, rows_per_group=C5_ROWS * C5_MICRO,
        frames_per_s=f"{frames / elapsed:.3f}",
        p50_frame_latency_ms=f"{statistics.median(latencies) * 1e3:.1f}",
        lm_generated_tokens_per_s=f"{tokens / elapsed:.1f}",
        element_ms_median_per_frame=json.dumps(stage_ms),
        flash_attention_launches=launches["flash_attention"],
        fused_groups=summary["fused_groups"],
        lm_weight_gib=f"{lm_weight_bytes / 2**30:.2f}",
        max_memory_allocated_gib=f"{peak / 2**30:.2f}",
        setup_seconds=f"{setup_s:.1f}", card=repr(smi))
    return launches


# -- the continuous decode engine --------------------------------------------

# bench.py's config 6b (bench_continuous) at its full size: LLAMA32_1B at
# its published widths and full depth, bf16, random weights from seed 0;
# 8 decode slots, 32-position KV blocks; 96 requests from
# default_rng(11), prompts of 32-128 tokens, 16-96 new tokens; the
# context rounded up from bucket(128) + 96
E_SLOTS, E_BLOCK, E_REQUESTS = 8, 32, 96
E_PROMPT, E_NEW = (32, 128), (16, 96)
E_PROFILE_STEPS, E_GRAPH_STEPS = 20, 16
# 9c: 12 of the requests through four paths in f32 (TF32 off): the
# engine, closed-batch generate one request at a time, the engine with
# prefill_chunk_size 64 and with speculative draft=self;layers=2;k=4
E_F32_REQUESTS, E_CHUNK, E_DRAFT_LAYERS, E_SPEC_K = 12, 64, 2, 4
# 9d: frames of text rows through LMGenerate `continuous: true`
E_FRAMES, E_ROWS, E_FRAME_NEW = 4, 8, 32


def engine_workload(vocab: int) -> tuple:
    """bench_continuous's workload: (requests [(prompt, max_new)], the
    rng, positioned for the arrival draws, max_context)."""
    from aiko_services_tpu_torch.utils.padding import bucket_length
    rng = np.random.default_rng(11)
    workload = [
        (rng.integers(1, vocab, size=int(rng.integers(
            E_PROMPT[0], E_PROMPT[1] + 1))).astype(np.int32),
         int(rng.integers(E_NEW[0], E_NEW[1] + 1)))
        for _ in range(E_REQUESTS)]
    bucket = bucket_length(E_PROMPT[1], minimum=E_BLOCK)
    max_context = -(-(bucket + E_NEW[1]) // E_BLOCK) * E_BLOCK
    return workload, rng, max_context


def drain_engine(engine, limit: int = 100000) -> tuple:
    """Step the engine until idle: ({request: Completion}, steps)."""
    done, steps = {}, 0
    while engine.has_work():
        for completion in engine.step().completions:
            done[completion.request_id] = completion
        steps += 1
        if steps > limit:
            raise SystemExit("9: the engine did not drain")
    return done, steps


def same_tokens(what: str, done: dict, reference: dict) -> None:
    differ = [key for key in reference
              if not np.array_equal(done[key].tokens, reference[key])]
    if len(done) != len(reference) or differ:
        raise SystemExit(f"{what}: {len(differ)} of {len(reference)} "
                         f"requests differ from the open-loop run "
                         f"(first: {differ[:4]})")


def phase_engine_storm(params, config, workload, rng, max_context,
                       smi: str) -> tuple:
    """9a.  Returns (the open-loop tokens {request: tokens}, the engine)."""
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.ops import kernels
    engine = DecodeEngine(params, config, decode_slots=E_SLOTS,
                          kv_block_size=E_BLOCK, max_context=max_context)
    length, index = E_BLOCK, 0
    while length <= max_context - E_NEW[1]:   # one prompt per bucket
        engine.submit(("warm", index), np.ones((length,), np.int32), 2)
        length, index = length * 2, index + 1
    drain_engine(engine)
    # capacity with all slots busy: decoded tokens/s
    probe_steps = 32
    for index in range(E_SLOTS):
        engine.submit(("probe", index), np.ones((E_PROMPT[0],), np.int32),
                      probe_steps + 2)
    engine.step()
    torch.cuda.synchronize()
    start, decoded = time.perf_counter(), 0
    while engine.has_work():
        decoded += engine.step().active
    capacity = decoded / (time.perf_counter() - start)
    mean_new = float(np.mean([new for _, new in workload]))
    arrivals = np.cumsum(rng.exponential(mean_new / (2.0 * capacity),
                                         size=E_REQUESTS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    signatures = engine.compile_count
    ttft, occupancy, step_ms, tokens_done, done = {}, [], [], 0, {}
    next_index = 0
    start = time.perf_counter()
    while next_index < E_REQUESTS or engine.has_work():
        now = time.perf_counter() - start
        while next_index < E_REQUESTS and arrivals[next_index] <= now:
            prompt, max_new = workload[next_index]
            engine.submit(next_index, prompt, max_new)
            next_index += 1
        if not engine.has_work():
            time.sleep(min(arrivals[next_index] - now, 0.01))
            continue
        step_start = time.perf_counter()
        report = engine.step()
        step_ms.append((time.perf_counter() - step_start) * 1e3)
        occupancy.append(report.active / E_SLOTS)
        for request_id, offset, _ in report.emitted:
            if offset == 0:
                ttft[request_id] = (time.perf_counter() - start
                                    - arrivals[request_id])
        for completion in report.completions:
            tokens_done += completion.stats["tokens"]
            done[completion.request_id] = completion
    elapsed = time.perf_counter() - start
    added = engine.compile_count - signatures
    peak = torch.cuda.max_memory_allocated()
    # the engine's path runs no Pallas counterpart: the JAX package's
    # paged steps are masked einsums too
    flash_launches = sum(kernels.launch_counts.values())
    open_loop = {key: done[key].tokens for key in range(E_REQUESTS)}
    for key, tokens in open_loop.items():
        if not (tokens.shape == (workload[key][1],)
                and (0 <= tokens).all() and (tokens < config.vocab_size)
                .all()):
            raise SystemExit(f"9a: request {key}: tokens {tokens}")
    ttft_ms = np.asarray(list(ttft.values())) * 1e3
    say("9a engine_open_loop", requests=E_REQUESTS, slots=E_SLOTS,
        block=E_BLOCK, max_context=max_context,
        capacity_tokens_per_s=f"{capacity:.1f}",
        offered_requests_per_s=f"{2.0 * capacity / mean_new:.3f}",
        goodput_tokens_per_s=f"{tokens_done / elapsed:.1f}",
        ttft_p50_ms=f"{np.percentile(ttft_ms, 50):.1f}",
        ttft_p99_ms=f"{np.percentile(ttft_ms, 99):.1f}",
        engine_step_ms_mean=f"{np.mean(step_ms):.3f}",
        engine_step_ms_p50=f"{np.median(step_ms):.3f}",
        engine_steps=len(step_ms),
        slot_occupancy_mean=f"{np.mean(occupancy):.3f}",
        signatures_in_window=added,
        flash_attention_launches=flash_launches,
        preempted=engine.counters["preempted"],
        max_memory_allocated_gib=f"{peak / 2**30:.2f}",
        wall_s=f"{elapsed:.2f}", card=repr(smi))
    if added or flash_launches:
        raise SystemExit(f"9a: {added} step signatures added and "
                         f"{flash_launches} flash-attention launches "
                         f"inside the measured window")
    profile_engine_steps(engine, workload, smi)
    # the same requests submitted all at once, then with the pool cut so
    # that preemption fires: each request's tokens are those of the
    # open-loop run (a row's result through a fixed-shape step depends
    # on that row only)
    for index, (prompt, max_new) in enumerate(workload):
        engine.submit(index, prompt, max_new)
    same_tokens("9a all-at-once", drain_engine(engine)[0], open_loop)
    cut = DecodeEngine(params, config, decode_slots=E_SLOTS,
                       kv_block_size=E_BLOCK, max_context=max_context,
                       kv_blocks=3 * E_SLOTS + 1)
    for index, (prompt, max_new) in enumerate(workload):
        cut.submit(index, prompt, max_new)
    same_tokens("9a preempted", drain_engine(cut)[0], open_loop)
    if not cut.counters["preempted"]:
        raise SystemExit("9a: the cut pool preempted nothing")
    say("9a engine_replays", all_at_once_identical=True,
        cut_pool_blocks=cut.blocks.capacity,
        preempted=cut.counters["preempted"],
        deferred_admissions=cut.counters["deferred_admissions"],
        cut_pool_identical=True)
    return open_loop, engine


def decode_step_bound(engine, smi: str) -> tuple:
    """The least time one decode step over every slot could take on this
    card: the bytes it must move (every layer's weights, the f32 head, the
    embedding rows, the pool blocks the tables name, the K/V it writes)
    over the memory rate, against its operations (2 per weight and token:
    bf16 layers on the tensor cores, the f32 head on the CUDA cores).
    Returns (bound_ms, bound_by, bytes)."""
    from aiko_services_tpu_torch.decode import TRASH_BLOCK
    from aiko_services_tpu_torch.utils.tree import tree_leaves
    _, peaks = peaks_for(smi)
    params, config, slots = engine.params, engine.config, engine.slots_n
    head = params.get("lm_head", params["embed"])["w"]
    layer_bytes = sum(leaf.numel() * leaf.element_size()
                      for leaf in tree_leaves(params["layers"]))
    layer_weights = sum(leaf.numel() for leaf in tree_leaves(
        params["layers"]) if leaf.dim() == 3)
    pool_block = sum(leaf[:, 0].numel() * leaf.element_size()
                     for leaf in engine.pool.values())
    blocks = len(set(engine.tables.ravel().tolist()) - {TRASH_BLOCK})
    moved = (layer_bytes + head.numel() * head.element_size()
             + slots * config.d_model * params["embed"]["w"].element_size()
             + blocks * pool_block
             + slots * pool_block // engine.blocks.block_size)
    seconds = {"bytes": moved / peaks["bytes"],
               "operations": 2 * slots * layer_weights / peaks["bfloat16"]
               + 2 * slots * head.numel() / peaks["float32"]}
    bound_by = max(seconds, key=seconds.get)
    return seconds[bound_by] * 1e3, bound_by, moved


def profile_engine_steps(engine, workload, smi: str) -> None:
    """The device's busy and idle share of E_PROFILE_STEPS decode steps
    with every slot busy, under torch.profiler, and the device time of
    one replay of the captured decode step (back-to-back replays between
    CUDA events, static inputs pointed at the trash block)."""
    from aiko_services_tpu_torch.decode import TRASH_BLOCK
    for index in range(E_SLOTS):
        engine.submit(("profile", index), workload[index][0],
                      E_PROFILE_STEPS + 4)
    while any(slot is None or slot.prefilling for slot in engine.slots):
        engine.step()
    bound_ms, bound_by, moved = decode_step_bound(engine, smi)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as profile:
        start = time.perf_counter()
        for _ in range(E_PROFILE_STEPS):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    device_events = [event for event in profile.events()
                     if event.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(event.time_range.elapsed_us()
                  for event in device_events) / 1e3
    drain_engine(engine)
    captured = engine._captured[("target", "paged_decode_step", 1)]
    for static in captured.inputs:
        static.fill_(TRASH_BLOCK)
    replay_ms = cuda_ms(captured.graph.replay, warmup=2, runs=10)
    say("9a engine_step_profile", steps=E_PROFILE_STEPS,
        wall_ms=f"{wall_ms:.1f}",
        step_ms=f"{wall_ms / E_PROFILE_STEPS:.3f}",
        device_busy_ms=f"{busy_ms:.1f}",
        device_launches_per_step=len(device_events) / E_PROFILE_STEPS,
        idle_share=(f"{1 - busy_ms / wall_ms:.3f}" if busy_ms > 0
                    else "not measured (the profiler saw no device time)"),
        graph_replay_device_ms=f"{replay_ms:.3f}",
        step_bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
        step_bytes=moved,
        idle_share_from_replay=(
            f"{1 - replay_ms * E_PROFILE_STEPS / wall_ms:.3f}"),
        card=repr(smi))


def phase_engine_graph_vs_eager(params, config, workload, max_context,
                                smi: str) -> None:
    """9b: the first E_GRAPH_STEPS steps of one slot state, replayed from
    the captured graph and run eagerly, give identical tokens."""
    from aiko_services_tpu_torch.decode import DecodeEngine
    emitted, step_ms = {}, {}
    for mode in ("graph", "eager"):
        engine = DecodeEngine(params, config, decode_slots=E_SLOTS,
                              kv_block_size=E_BLOCK,
                              max_context=max_context)
        engine._graphs = mode == "graph"
        for index in range(E_SLOTS):
            engine.submit(index, workload[index][0], E_GRAPH_STEPS + 1)
        tokens, times = [], []
        for _ in range(E_GRAPH_STEPS + 1):
            start = time.perf_counter()
            tokens.extend(engine.step().emitted)
            times.append((time.perf_counter() - start) * 1e3)
        emitted[mode] = tokens
        step_ms[mode] = float(np.median(times[2:]))
        del engine
    same = emitted["graph"] == emitted["eager"]
    say("9b engine_graph_vs_eager", steps=E_GRAPH_STEPS,
        tokens=len(emitted["graph"]), identical=same,
        graph_step_ms=f"{step_ms['graph']:.3f}",
        eager_step_ms=f"{step_ms['eager']:.3f}", card=repr(smi))
    if not same or len(emitted["graph"]) != E_SLOTS * (E_GRAPH_STEPS + 1):
        raise SystemExit("9b: graph replay and the eager step differ")


def top2_gap(params, config, prompt, generated, position) -> float:
    """The gap between the two largest logits after the prompt and the
    first `position` generated tokens (the logits that chose token
    `position`)."""
    from aiko_services_tpu_torch.models import forward
    tokens = np.concatenate([prompt, generated[:position]]).astype(np.int32)
    with torch.no_grad():
        logits = forward(params, config, torch.from_numpy(tokens)[None]
                         .cuda())[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def phase_engine_f32(params, config, workload, max_context,
                     smi: str) -> None:
    """9c: the same weights in f32, TF32 off: 12 requests through the
    engine, closed-batch generate one at a time, the chunked engine and
    the speculative engine give identical tokens.  In bf16 the rounding
    noise is of the order of the top-2 logit gaps, so tokens can only be
    expected to agree across different shapes in f32."""
    from dataclasses import replace
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.models import generate, init_params
    from aiko_services_tpu_torch.utils.tree import tree_map
    config32 = replace(config, dtype="float32")
    params32 = tree_map(lambda leaf: leaf.float(), params)
    requests = workload[:E_F32_REQUESTS]
    previous = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tokens, stats = {}, {}
        draft_config = replace(config32, n_layers=E_DRAFT_LAYERS)
        draft = init_params(draft_config, torch.Generator().manual_seed(0),
                            device="cuda")
        for path, options in (
                ("engine", {}),
                ("chunked", {"prefill_chunk_size": E_CHUNK}),
                ("speculative", {"draft_params": draft,
                                 "draft_config": draft_config,
                                 "spec_k": E_SPEC_K})):
            engine = DecodeEngine(params32, config32, decode_slots=E_SLOTS,
                                  kv_block_size=E_BLOCK,
                                  max_context=max_context, **options)
            for index, (prompt, max_new) in enumerate(requests):
                engine.submit(index, prompt, max_new)
            start = time.perf_counter()
            done, steps = drain_engine(engine)
            stats[path] = (engine.stats(),
                           (time.perf_counter() - start) * 1e3 / steps)
            tokens[path] = [done[index].tokens
                            for index in range(len(requests))]
            del engine
        tokens["generate"] = []
        for prompt, max_new in requests:
            out, _ = generate(params32, config32,
                              torch.from_numpy(prompt)[None].cuda(),
                              max_new)
            tokens["generate"].append(out[0].cpu().numpy())
        differences = []
        for index, (prompt, _) in enumerate(requests):
            for path in ("generate", "chunked", "speculative"):
                other, mine = tokens[path][index], tokens["engine"][index]
                if not np.array_equal(other, mine):
                    position = int(np.argmax(other != mine))
                    differences.append((index, path, position,
                                        int(mine[position]),
                                        int(other[position])))
        spec = stats["speculative"][0]
        say("9c engine_f32_paths", requests=len(requests),
            tokens=int(sum(out.size for out in tokens["engine"])),
            identical=not differences,
            prefill_chunks=stats["chunked"][0]["prefill_chunks"],
            spec_windows=spec["spec_windows"],
            accepted_len_mean=spec["accepted_len_mean"],
            engine_step_ms=f"{stats['engine'][1]:.3f}",
            speculative_step_ms=f"{stats['speculative'][1]:.3f}",
            card=repr(smi))
        for index, path, position, mine, other in differences:
            # the f32 cacheless forward's top-2 gap where they part: a
            # near tie says summation order, a wide gap a fault
            gap = top2_gap(params32, config32, requests[index][0],
                           tokens["engine"][index], position)
            say("9c difference", request=index, path=path,
                position=position, engine_token=mine, path_token=other,
                top2_gap=f"{gap:.6g}")
        if differences:
            raise SystemExit(f"9c: {len(differences)} path(s) differ from "
                             f"the engine in f32")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = previous
        del params32
        torch.cuda.empty_cache()


E_WORDS = ("the", "engine", "admits", "requests", "into", "free", "slots",
           "while", "every", "decode", "step", "runs", "over", "a", "paged",
           "pool", "of", "blocks", "and", "tokens", "stream", "back", "to",
           "each", "frame", "in", "order", "card", "graph", "replay")


def engine_text_frames() -> list:
    """E_FRAMES frames of E_ROWS seeded sentences (8-40 words)."""
    rng = np.random.default_rng(9)
    return [[" ".join(rng.choice(E_WORDS, size=int(rng.integers(8, 41))))
             for _ in range(E_ROWS)] for _ in range(E_FRAMES)]


def phase_engine_pipeline(max_context: int, smi: str) -> None:
    """9d: text frames through LMGenerate `continuous: true` (the BPE
    tokenizer, bf16 llama32_1b) in a pipeline; every frame completes and
    its rows equal a DecodeEngine's tokens for the same token rows."""
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    engine_parameters = {"decode_slots": E_SLOTS, "kv_block_size": E_BLOCK,
                         "max_context": max_context}
    definition = {
        "name": "continuous",
        "graph": ["(lm)"],
        "parameters": {"device": "cuda"},
        "elements": [
            {"name": "lm", "input": [{"name": "text"}],
             "output": [{"name": "generated"}, {"name": "text"}],
             "parameters": {"preset": "llama32_1b", "dtype": "bfloat16",
                            "tokenizer": "default", "continuous": True,
                            "max_new_tokens": E_FRAME_NEW,
                            **engine_parameters},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "LMGenerate"}}}],
    }
    frames = engine_text_frames()
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        lm = pipeline.elements["lm"]
        lm._ensure_ready()
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s1", queue_response=responses)
        start = time.perf_counter()
        for texts in frames:
            pipeline.create_frame(stream, {"text": texts})
        served = {}
        for _ in frames:
            _, frame, outputs = responses.get(timeout=600)
            served[frame.frame_id] = outputs
        elapsed = time.perf_counter() - start
        stats = lm.engine_stats()
        rows = [lm._encode_prompts(None, texts)[0] for texts in frames]
        params, config = lm.state, lm.config
    finally:
        process.terminate()
    engine = DecodeEngine(params, config, **engine_parameters)
    for frame_id, tokens in enumerate(rows):
        for row in range(tokens.shape[0]):
            engine.submit((frame_id, row), tokens[row], E_FRAME_NEW)
    done, _ = drain_engine(engine)
    for frame_id in range(len(frames)):
        outputs = served.get(frame_id)
        if outputs is None:
            raise SystemExit(f"9d: frame {frame_id} did not complete")
        generated = np.asarray(outputs["generated"])
        expected = np.stack([done[(frame_id, row)].tokens
                             for row in range(E_ROWS)])
        if not (generated.shape == (E_ROWS, E_FRAME_NEW)
                and np.array_equal(generated, expected)
                and len(outputs["text"]) == E_ROWS):
            raise SystemExit(f"9d: frame {frame_id}'s rows differ from "
                             f"the engine's tokens")
    say("9d engine_pipeline", frames=len(frames), rows_per_frame=E_ROWS,
        prompt_widths=json.dumps([int(tokens.shape[1]) for tokens in rows]),
        new_tokens=E_FRAME_NEW, identical=True,
        admitted=stats["admitted"], completed=stats["completed"],
        wall_s=f"{elapsed:.2f}",
        tokens_per_s=f"{len(frames) * E_ROWS * E_FRAME_NEW / elapsed:.1f}",
        card=repr(smi))


def phase_engine(smi: str) -> None:
    """Phase 9: the continuous decode engine at llama32_1b's full width."""
    from aiko_services_tpu_torch.models import LLAMA32_1B, init_params
    from aiko_services_tpu_torch.utils.tree import tree_leaves
    torch.cuda.empty_cache()
    start = time.perf_counter()
    params = init_params(LLAMA32_1B, torch.Generator().manual_seed(0),
                         device="cuda")
    workload, rng, max_context = engine_workload(LLAMA32_1B.vocab_size)
    weight_bytes = sum(leaf.numel() * leaf.element_size()
                       for leaf in tree_leaves(params))
    say("9 engine_setup", weights_gib=f"{weight_bytes / 2**30:.2f}",
        setup_s=f"{time.perf_counter() - start:.1f}")
    _, engine = phase_engine_storm(params, LLAMA32_1B, workload, rng,
                                   max_context, smi)
    del engine
    phase_engine_graph_vs_eager(params, LLAMA32_1B, workload, max_context,
                                smi)
    phase_engine_f32(params, LLAMA32_1B, workload, max_context, smi)
    del params
    torch.cuda.empty_cache()
    phase_engine_pipeline(max_context, smi)


# -- the serving tier ----------------------------------------------------------

# Phase 10 serves LLAMA32_1B at its published widths and full depth, bf16,
# random weights from seed 0 (shared by every engine and replica through
# restore_state), 32-position KV blocks and 8 slots unless stated.
S_SLOTS, S_BLOCK = 8, 32
# 10a: bench.py config 6f (bench_disagg): 64 decode requests from
# default_rng(17) (prompts 16-48 tokens, 32-96 new), 8 long prompts of
# 4 x bucket(48) = 256 tokens landing mid-run, open-loop arrivals at 0.4x
# the capacity measured with every slot busy; then text frames through a
# prefill pipeline and a decode pipeline behind Gateway(disagg=...)
A_DECODE, A_PROMPT, A_NEW, A_LONGS, A_LOAD = 64, (16, 48), (32, 96), 8, 0.4
A_FRAMES, A_ROWS, A_FRAME_NEW, A_FRAME_CONTEXT = 2, 4, 16, 128
# 10b: _chaos_decode_replica_kill (bench.py:2072): 12 streams of 6-token
# prompts from default_rng(13), 48 new tokens each, two checkpointed
# `continuous: true` replicas (one slot a stream), a seeded replica_kill
B_STREAMS, B_PROMPT, B_NEW, B_SEED, B_CONTEXT = 12, 6, 48, 13, 64
B_KEEPER = "smoke_ckpt_keeper"
# 10c: three prompts sharing a 4-block preamble, two prefix-cached
# replicas behind a prefix-affinity gateway, f32 (TF32 off): warm tokens
# must equal cold ones, and across prefill shapes only f32 can
C_PREFIX_BLOCKS, C_PROMPTS, C_NEW, C_CONTEXT = 4, 3, 16, 256
C_KEEPER = "smoke_prefix_store"
# 10d: bench.py --router 2 (bench_router, bench.py:1212): two Detector
# replicas (YOLOV8N_SHAPE, 640 px, micro_batch 16), 16 streams x 30
# frames offered open-loop at twice the measured aggregate capacity
D_STREAMS, D_FRAMES, D_MICRO, D_IMAGES = 16, 30, 16, 32
D_POLICY = "max_inflight=64;queue=128"


def percentile_ms(seconds, q: float) -> str:
    return (f"{np.percentile(np.asarray(seconds) * 1e3, q):.1f}"
            if len(seconds) else "none")


def lm_pipeline(name: str, parameters: dict, params, inputs=("tokens",),
                optional=(), output="generated",
                pipeline_parameters=None) -> tuple:
    """(process, pipeline): one LMGenerate element on the card whose
    weights are `params` (installed through restore_state, so replicas
    share one copy on the card)."""
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    definition = {
        "name": name,
        "graph": ["(lm)"],
        "parameters": {"device": "cuda", **(pipeline_parameters or {})},
        "elements": [
            {"name": "lm",
             "input": [{"name": port} for port in inputs]
             + [{"name": port, "optional": True} for port in optional],
             "output": [{"name": output}],
             "parameters": {"preset": "llama32_1b", **parameters},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "LMGenerate"}}}],
    }
    process = Process(transport_kind="loopback")
    pipeline = create_pipeline(process, definition)
    pipeline.elements["lm"].restore_state(params)
    return process, pipeline


def stop_processes(processes) -> None:
    for process in processes:
        try:
            process.terminate()
        except Exception as error:    # a crashed replica's teardown
            say("10 teardown", process=process.topic_path_process,
                error=repr(error))


def disagg_workload(vocab: int) -> tuple:
    """bench_disagg's workload: (decode requests [(prompt, max_new)],
    long prompts, mean new tokens, max_context)."""
    from aiko_services_tpu_torch.utils.padding import bucket_length
    rng = np.random.default_rng(17)
    work = [(rng.integers(1, vocab, size=int(rng.integers(
                A_PROMPT[0], A_PROMPT[1] + 1))).astype(np.int32),
             int(rng.integers(A_NEW[0], A_NEW[1] + 1)))
            for _ in range(2 * A_DECODE)]      # bench draws the 2x arm too
    long_len = 4 * bucket_length(A_PROMPT[1], minimum=S_BLOCK)
    longs = [rng.integers(1, vocab, size=long_len).astype(np.int32)
             for _ in range(A_LONGS)]
    mean_new = float(np.mean([new for _, new in work]))
    max_context = -(-(long_len + A_NEW[1]) // S_BLOCK) * S_BLOCK
    return work[:A_DECODE], longs, mean_new, max_context


def disagg_arm(params, config, work, longs, offered_req_s,
               max_context: int, disagg: bool) -> dict:
    """One arm of 10a: decode requests open-loop, long prompts landing
    at evenly spaced points of the arrival span -- prefilled on the
    decode engine (colocated) or on a PrefillEngine on its own thread
    whose handoffs the decode engine adopts into free slots."""
    import threading
    from aiko_services_tpu_torch.decode import DecodeEngine, PrefillEngine
    from aiko_services_tpu_torch.utils.padding import bucket_length
    engine = DecodeEngine(params, config, decode_slots=S_SLOTS,
                          kv_block_size=S_BLOCK, max_context=max_context)
    length, index = S_BLOCK, 0
    while length <= bucket_length(len(longs[0]), minimum=S_BLOCK):
        engine.submit(("warm", index), np.ones((length,), np.int32), 2)
        length, index = length * 2, index + 1
    drain_engine(engine)
    jobs, handoffs, worker, prefill = queue.Queue(), queue.Queue(), None, None
    if disagg:
        prefill = PrefillEngine(params, config, kv_block_size=S_BLOCK,
                                max_context=max_context, device="cuda")
        # both halves of the migration once outside the window
        prefill.submit(("warm", "prefill"), longs[0], 2)
        for handoff in prefill.step():
            engine.adopt_request(("warm", "adopt"), handoff, timeout=30)
        drain_engine(engine)

        def pump():
            # the prefill replica: its own thread, pool and CUDA stream
            while (job := jobs.get()) is not None:
                prefill.submit(*job)
                while prefill.has_work():
                    for handoff in prefill.step():
                        handoffs.put(handoff)

        worker = threading.Thread(target=pump, daemon=True)
        worker.start()
    counters = dict(engine.counters)
    signatures = engine.compile_count
    arrivals = np.cumsum(np.random.default_rng(29).exponential(
        1.0 / offered_req_s, size=len(work)))
    long_arrivals = [arrivals[-1] * (index + 1) / (len(longs) + 1)
                     for index in range(len(longs))]
    ttft, outputs, adopt_s = {}, {}, []
    next_decode = next_long = adopted = 0
    start = time.perf_counter()
    try:
        while (next_decode < len(work) or next_long < len(longs)
               or adopted < (next_long if disagg else 0)
               or engine.has_work()):
            now = time.perf_counter() - start
            while next_decode < len(work) and arrivals[next_decode] <= now:
                engine.submit(("d", next_decode), *work[next_decode])
                next_decode += 1
            while (next_long < len(longs)
                   and long_arrivals[next_long] <= now):
                request = (("long", next_long), longs[next_long],
                           A_NEW[0])
                if disagg:
                    jobs.put(request)
                else:
                    engine.submit(*request)
                next_long += 1
            # adopt only INTO free slots: a busy engine leaves the
            # handoff on the transfer plane instead of falling back
            while disagg and any(slot is None for slot in engine.slots):
                try:
                    handoff = handoffs.get_nowait()
                except queue.Empty:
                    break
                adopt_start = time.perf_counter()
                report = engine.adopt_request(handoff["request_id"],
                                              handoff, timeout=30)
                adopt_s.append(time.perf_counter() - adopt_start)
                adopted += 1
                for completion in report.completions:
                    outputs[completion.request_id] = completion.tokens
            if not engine.has_work():
                time.sleep(0.001)       # open loop: the next arrival
                continue
            report = engine.step()
            now = time.perf_counter() - start
            for request_id, offset, _ in report.emitted:
                if offset == 0 and request_id[0] == "d":
                    ttft[request_id] = now - arrivals[request_id[1]]
            for completion in report.completions:
                outputs[completion.request_id] = completion.tokens
        elapsed = time.perf_counter() - start
    finally:
        jobs.put(None)
        if worker is not None:
            worker.join(timeout=60)
    delta = {name: engine.counters[name] - counters[name]
             for name in ("adopted", "adopt_fallbacks",
                          "kv_migrated_bytes")}
    result = {"outputs": outputs, "ttft": list(ttft.values()),
              "adopt_s": adopt_s, "elapsed": elapsed,
              "signatures": engine.compile_count - signatures, **delta}
    del engine, prefill
    torch.cuda.empty_cache()
    return result


def phase_disagg(params, config, smi: str) -> None:
    """10a: the colocated and the disaggregated arm on one workload:
    identical tokens, every long prompt adopted (0 fallbacks), 0 step
    signatures added in either window."""
    from aiko_services_tpu_torch.decode import DecodeEngine
    work, longs, mean_new, max_context = disagg_workload(config.vocab_size)
    probe = DecodeEngine(params, config, decode_slots=S_SLOTS,
                         kv_block_size=S_BLOCK, max_context=max_context)
    for index in range(S_SLOTS):
        probe.submit(("probe", index), np.ones((A_PROMPT[0],), np.int32),
                     34)
    probe.step()
    torch.cuda.synchronize()
    start, decoded = time.perf_counter(), 0
    while probe.has_work():
        decoded += probe.step().active
    capacity = decoded / (time.perf_counter() - start)
    del probe
    offered = A_LOAD * capacity / mean_new
    arms = {name: disagg_arm(params, config, work, longs, offered,
                             max_context, disagg=name == "disagg")
            for name in ("colocated", "disagg")}
    colocated, split = arms["colocated"], arms["disagg"]
    for name, arm in arms.items():
        say(f"10a disagg_{name}", requests=len(work), longs=len(longs),
            long_prompt=len(longs[0]),
            offered_requests_per_s=f"{offered:.3f}",
            completed=len(arm["outputs"]),
            decode_ttft_p50_ms=percentile_ms(arm["ttft"], 50),
            decode_ttft_p99_ms=percentile_ms(arm["ttft"], 99),
            adopted=arm["adopted"], adopt_fallbacks=arm["adopt_fallbacks"],
            kv_migrated_mib_per_long=(
                f"{arm['kv_migrated_bytes'] / max(arm['adopted'], 1) / 2**20:.3f}"),
            adopt_ms_p50=percentile_ms(arm["adopt_s"], 50),
            adopt_ms_p99=percentile_ms(arm["adopt_s"], 99),
            signatures_in_window=arm["signatures"],
            wall_s=f"{arm['elapsed']:.2f}", card=repr(smi))
    expected = len(work) + len(longs)
    differ = [key for key, tokens in colocated["outputs"].items()
              if not np.array_equal(split["outputs"].get(key), tokens)]
    if (len(colocated["outputs"]) != expected
            or len(split["outputs"]) != expected or differ):
        raise SystemExit(f"10a: {len(differ)} requests differ between "
                         f"the arms (first: {differ[:4]}); completed "
                         f"{len(colocated['outputs'])} / "
                         f"{len(split['outputs'])} of {expected}")
    if (split["adopted"] != len(longs) or split["adopt_fallbacks"]
            or colocated["signatures"] or split["signatures"]):
        raise SystemExit(f"10a: adopted {split['adopted']} of "
                         f"{len(longs)}, {split['adopt_fallbacks']} "
                         f"fallbacks, signatures added "
                         f"{colocated['signatures']} / "
                         f"{split['signatures']}")
    phase_disagg_gateway(params, config, smi)


def phase_disagg_gateway(params, config, smi: str) -> None:
    """10a: text frames through a `disagg: role=prefill` pipeline and a
    `role: decode` pipeline behind Gateway(disagg=...): every frame's
    rows equal a colocated DecodeEngine's tokens for the same rows."""
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.runtime import Process
    from aiko_services_tpu_torch.serve import Gateway
    common = {"dtype": "bfloat16", "tokenizer": "default",
              "kv_block_size": S_BLOCK, "max_context": A_FRAME_CONTEXT,
              "max_new_tokens": A_FRAME_NEW}
    prefill_process, prefill = lm_pipeline(
        "smoke_prefill", {**common, "role": "prefill"}, params,
        inputs=("text",), output="handoff",
        pipeline_parameters={"disagg": "role=prefill"})
    decode_process, decode = lm_pipeline(
        "smoke_decode", {**common, "role": "decode", "continuous": True,
                         "decode_slots": S_SLOTS}, params,
        inputs=("text",), optional=("handoff",))
    gateway_process = Process(transport_kind="loopback")
    processes = [prefill_process, decode_process, gateway_process]
    rng = np.random.default_rng(5)
    frames = [[" ".join(rng.choice(E_WORDS, size=int(rng.integers(6, 30))))
               for _ in range(A_ROWS)] for _ in range(A_FRAMES)]
    try:
        gateway = Gateway(gateway_process, policy="max_inflight=8;queue=32",
                          disagg="adopt_timeout=30")
        gateway.attach_replica(prefill)
        gateway.attach_replica(decode)
        for process in processes:
            process.run(in_thread=True)
        replies = queue.Queue()
        gateway.submit_stream("text", {}, queue_response=replies)
        for frame_id, texts in enumerate(frames):
            gateway.submit_frame("text", {"text": texts}, frame_id=frame_id)
        served = {}
        for _ in frames:
            _, frame_id, outputs, status = replies.get(timeout=600)
            if status != "ok":
                raise SystemExit(f"10a: gateway frame {frame_id}: {status}")
            served[frame_id] = np.asarray(outputs["generated"])
        lm = decode.elements["lm"]
        stats = lm.engine_stats()
        rows = [lm._encode_prompts(None, texts)[0] for texts in frames]
        migrations = gateway.telemetry.kv_migrations.value
    finally:
        stop_processes(processes)
    engine = DecodeEngine(params, config, decode_slots=S_SLOTS,
                          kv_block_size=S_BLOCK,
                          max_context=A_FRAME_CONTEXT)
    for frame_id, tokens in enumerate(rows):
        for row in range(tokens.shape[0]):
            engine.submit((frame_id, row), tokens[row], A_FRAME_NEW)
    done, _ = drain_engine(engine)
    del engine
    for frame_id in range(len(frames)):
        expected = np.stack([done[(frame_id, row)].tokens
                             for row in range(A_ROWS)])
        if not np.array_equal(served[frame_id], expected):
            raise SystemExit(f"10a: gateway frame {frame_id}'s rows "
                             f"differ from the colocated engine's")
    if (migrations != len(frames) or stats["adopted"] != len(frames) * A_ROWS
            or stats["adopt_fallbacks"]):
        raise SystemExit(f"10a: {migrations} migrations, adopted "
                         f"{stats['adopted']}, {stats['adopt_fallbacks']} "
                         f"fallbacks")
    say("10a disagg_gateway", frames=len(frames), rows_per_frame=A_ROWS,
        kv_migrations=migrations, adopted=stats["adopted"],
        adopt_fallbacks=stats["adopt_fallbacks"], identical=True,
        card=repr(smi))


def failover_arm(params, frames: list, kill: bool) -> dict:
    """One arm of 10b: every stream pinned to replica ck_dec0; the kill
    arm pauses its engine once every stream has a checkpoint and none
    has finished, consults the seeded plan's replica_kill point, crashes
    the replica and fails its streams over to ck_dec1."""
    import threading
    from aiko_services_tpu_torch.decode import (
        CheckpointKeeper, reset_keepers)
    from aiko_services_tpu_torch.faults import create_injector
    from aiko_services_tpu_torch.runtime import Process
    from aiko_services_tpu_torch.serve import Gateway
    from aiko_services_tpu_torch.utils import parse
    reset_keepers()
    keeper = CheckpointKeeper(B_KEEPER)
    parameters = {
        "dtype": "bfloat16", "continuous": True, "decode_slots": B_STREAMS,
        "kv_block_size": S_BLOCK, "max_context": B_CONTEXT,
        "max_new_tokens": B_NEW, "stream_tokens": True, "stream_chunk": 1,
        "checkpoint": (f"checkpoint_every=1;max_checkpoint_lag=4;"
                       f"keeper={B_KEEPER}")}
    victim_process, victim = lm_pipeline("ck_dec0", parameters, params,
                                         optional=("restore",))
    survivor_process, survivor = lm_pipeline("ck_dec1", parameters, params,
                                             optional=("restore",))
    gateway_process = Process(transport_kind="loopback")
    processes = [victim_process, survivor_process, gateway_process]
    lock, token_times = threading.Lock(), {}
    paused, resume = threading.Event(), threading.Event()

    def on_out(topic, payload):
        try:
            command, fields = parse(payload)
        except ValueError:
            return
        if command == "token_chunk" and len(fields) >= 5:
            now = time.perf_counter()
            with lock:
                for index in range(len(fields[4][0])):
                    token_times.setdefault(
                        (str(fields[0]), int(fields[3]) + index), now)

    try:
        gateway = Gateway(gateway_process, policy="max_inflight=32;queue=128",
                          router_seed=B_SEED, metrics_interval=60.0,
                          checkpoint=f"recovery_rate=4;keeper={B_KEEPER}")
        gateway.attach_replica(victim)
        for pipe in (victim, survivor):
            pipe.process.add_message_handler(
                on_out, f"{pipe.elements['lm'].topic_path}/out")
        for process in processes:
            process.run(in_thread=True)
        # warm both engines (the prompt bucket and the captured decode
        # step) outside the window
        warm = queue.Queue()
        for pipe in (victim, survivor):
            stream = pipe.create_stream("warm", queue_response=warm,
                                        grace_time=300)
            pipe.create_frame(stream, {"tokens": frames[0]})
            warm.get(timeout=600)
            pipe.destroy_stream("warm")
        engines = {name: pipe.elements["lm"]._engine
                   for name, pipe in (("victim", victim),
                                      ("survivor", survivor))}
        signatures = {name: engine.compile_count
                      for name, engine in engines.items()}
        before = dict(victim.elements["lm"].checkpoint_stats())
        step_s = [0.0]
        step = engines["victim"].step

        def timed_step():
            if (kill and not paused.is_set() and keeper.flush(timeout=5)
                    and keeper.kept_count() >= B_STREAMS):
                paused.set()              # every stream checkpointed
                resume.wait(timeout=600)
            step_start = time.perf_counter()
            report = step()
            step_s[0] += time.perf_counter() - step_start
            return report

        engines["victim"].step = timed_step
        replies = queue.Queue()
        for index, frame in enumerate(frames):
            gateway.submit_stream(f"s{index}", {}, queue_response=replies)
            gateway.submit_frame(f"s{index}", {"tokens": frame}, frame_id=0)
        kill_at, migrated = None, []
        if kill:
            if not paused.wait(timeout=600):
                raise SystemExit("10b: the streams never all checkpointed")
            gateway.attach_replica(survivor)
            injector = create_injector(
                f"seed={B_SEED};replica_kill:node={victim.name}:frame=0")
            if not injector.replica_kill(victim.name):
                raise SystemExit("10b: the seeded replica_kill did not fire")
            migrated = sorted(gateway.replicas[victim.topic_path].streams)
            kill_at = time.perf_counter()
            victim.process.crash()
            gateway.post_message("_replica_lost", [
                victim.topic_path, "injected replica_kill"])
        outputs, deadline = {}, time.monotonic() + 600
        while len(outputs) < len(frames) and time.monotonic() < deadline:
            try:
                stream_id, _, out, status = replies.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                break
            if status == "ok":
                outputs[stream_id] = np.asarray(out["generated"])
        recovery_ttft = []
        with lock:
            for stream_id in migrated:
                after = [at for (sid, _), at in token_times.items()
                         if sid == stream_id and at > kill_at]
                if after:
                    recovery_ttft.append(min(after) - kill_at)
        victim_stats = victim.elements["lm"].checkpoint_stats()
        survivor_stats = survivor.elements["lm"].checkpoint_stats()
        result = {
            "outputs": outputs, "frames_lost": len(frames) - len(outputs),
            "migrated": len(migrated), "recovery_ttft": recovery_ttft,
            "survivor": survivor.elements["lm"].engine_stats(),
            "survivor_signatures": (engines["survivor"].compile_count
                                    - signatures["survivor"]),
            "paced": gateway.telemetry.recovery_paced.value,
            "step_s": step_s[0],
            "checkpoint_errors": (victim_stats["checkpoint_errors"]
                                  + survivor_stats["checkpoint_errors"]),
            "store_errors": keeper.stats()["store_errors"],
            **{name: victim_stats[name] - before[name]
               for name in ("ticks", "checkpoints", "checkpoint_bytes",
                            "checkpoint_s")}}
    finally:
        resume.set()
        stop_processes(processes)
        reset_keepers()
    del victim, survivor, engines
    torch.cuda.empty_cache()
    return result


def phase_warm_failover(params, config, smi: str) -> None:
    """10b: the kill arm equals the uncrashed arm, frames_lost == 0,
    every migrated stream resumes from its checkpoint (0 restore
    fallbacks, 0 replayed tokens: the kill comes after a tick shipped
    every stream), no snapshot failed to ship or to ingest (0
    checkpoint errors, 0 keeper store errors) and the survivor adds 0
    step signatures."""
    rng = np.random.default_rng(B_SEED)
    frames = [rng.integers(1, config.vocab_size, size=(1, B_PROMPT))
              .astype(np.int32) for _ in range(B_STREAMS)]
    uncrashed = failover_arm(params, frames, kill=False)
    killed = failover_arm(params, frames, kill=True)
    survivor = killed["survivor"]
    restores, fallbacks = survivor["restores"], survivor["restore_fallbacks"]
    ticks = max(uncrashed["ticks"], 1)
    share = uncrashed["checkpoint_s"] / max(
        uncrashed["checkpoint_s"] + uncrashed["step_s"], 1e-9)
    identical = (sorted(killed["outputs"]) == sorted(uncrashed["outputs"])
                 and all(np.array_equal(killed["outputs"][key], tokens)
                         for key, tokens in uncrashed["outputs"].items()))
    say("10b warm_failover", streams=B_STREAMS, new_tokens=B_NEW,
        frames_lost=killed["frames_lost"],
        frames_lost_uncrashed=uncrashed["frames_lost"],
        identical=identical, migrated_streams=killed["migrated"],
        restores=restores, restore_fallbacks=fallbacks,
        restore_replayed_tokens=survivor["restore_replayed_tokens"],
        checkpoint_errors=(killed["checkpoint_errors"]
                           + uncrashed["checkpoint_errors"]),
        keeper_store_errors=(killed["store_errors"]
                             + uncrashed["store_errors"]),
        reprefill_avoided=f"{restores / max(restores + fallbacks, 1):.3f}",
        recovery_paced=killed["paced"],
        recovery_ttft_p50_ms=percentile_ms(killed["recovery_ttft"], 50),
        recovery_ttft_p99_ms=percentile_ms(killed["recovery_ttft"], 99),
        survivor_signatures_in_window=killed["survivor_signatures"],
        checkpoints=uncrashed["checkpoints"],
        checkpoint_mib_per_tick=(
            f"{uncrashed['checkpoint_bytes'] / ticks / 2**20:.3f}"),
        checkpoint_ms_per_tick=f"{uncrashed['checkpoint_s'] / ticks * 1e3:.3f}",
        step_ms_per_tick=f"{uncrashed['step_s'] / ticks * 1e3:.3f}",
        checkpointer_share_of_step=f"{share:.3f}", card=repr(smi))
    if not (identical and killed["frames_lost"] == 0
            and uncrashed["frames_lost"] == 0 and fallbacks == 0
            and restores == killed["migrated"] == B_STREAMS
            and survivor["restore_replayed_tokens"] == 0
            and killed["checkpoint_errors"] == uncrashed["checkpoint_errors"]
            == killed["store_errors"] == uncrashed["store_errors"] == 0
            and killed["survivor_signatures"] == 0):
        raise SystemExit("10b: the kill arm failed its checks")


def phase_prefix(params, config, smi: str) -> None:
    """10c: prefix affinity and the keeper store in f32 (TF32 off): a
    request hinting a cached head routes to its holder, the other
    replica pre-warms the prefix from the keeper (adopt_prefix), and
    warm tokens equal a cold replica's."""
    from dataclasses import replace
    from aiko_services_tpu_torch.decode import (
        CheckpointKeeper, prefix_head, reset_keepers)
    from aiko_services_tpu_torch.runtime import Process
    from aiko_services_tpu_torch.serve import Gateway
    from aiko_services_tpu_torch.utils.tree import tree_map
    params32 = tree_map(lambda leaf: leaf.float(), params)
    config32 = replace(config, dtype="float32")
    rng = np.random.default_rng(21)
    preamble = rng.integers(1, config.vocab_size,
                            size=C_PREFIX_BLOCKS * S_BLOCK).astype(np.int32)
    prompts = [np.concatenate([preamble, rng.integers(
        1, config.vocab_size, size=int(rng.integers(5, 21)))])
        .astype(np.int32)[None] for _ in range(C_PROMPTS)]
    head = prefix_head(prompts[0][0], S_BLOCK)
    previous = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_keepers()
    keeper = CheckpointKeeper(C_KEEPER)
    parameters = {"dtype": "float32", "continuous": True,
                  "decode_slots": S_SLOTS, "kv_block_size": S_BLOCK,
                  "max_context": C_CONTEXT, "max_new_tokens": C_NEW}
    warm_parameters = {**parameters,
                       "prefix_policy": "prefix_cache=on;min_prefix_blocks=1"}
    built = [lm_pipeline(f"px{index}", warm_parameters, params32)
             for index in range(2)]
    built.append(lm_pipeline("px_cold", parameters, params32))
    processes = [process for process, _ in built]
    replicas, cold = [pipe for _, pipe in built[:2]], built[2][1]
    processes.append(Process(transport_kind="loopback"))
    try:
        gateway = Gateway(processes[-1], policy="max_inflight=8;queue=32",
                          router_seed=2,
                          prefix="prefix_cache=on;affinity_weight=4",
                          checkpoint=f"keeper={C_KEEPER}")
        for replica in replicas:
            gateway.attach_replica(replica)
        for process in processes:
            process.run(in_thread=True)

        def direct(pipe, stream_id, tokens, stream_parameters=None):
            replies = queue.Queue()
            stream = pipe.create_stream(stream_id, queue_response=replies,
                                        grace_time=300,
                                        parameters=stream_parameters or {})
            pipe.create_frame(stream, {"tokens": tokens})
            return np.asarray(replies.get(timeout=600)[2]["generated"])

        warm, placed = [], []
        for index in range(2):
            replies = queue.Queue()
            gateway.submit_stream(f"p{index}", {"prefix_hint": head},
                                  queue_response=replies, grace_time=300)
            gateway.submit_frame(f"p{index}", {"tokens": prompts[index]},
                                 frame_id=0)
            _, _, outputs, status = replies.get(timeout=600)
            if status != "ok":
                raise SystemExit(f"10c: gateway stream p{index}: {status}")
            warm.append(np.asarray(outputs["generated"]))
            placed.append(gateway.streams[f"p{index}"].replica.name)
        holder = next(pipe for pipe in replicas if pipe.name == placed[0])
        other = next(pipe for pipe in replicas if pipe.name != placed[0])
        holder_stats = holder.elements["lm"].engine_stats()
        keeper.flush(timeout=30)
        warm.append(direct(other, "prewarm", prompts[2],
                           {"prefix_keeper": C_KEEPER}))
        other_stats = other.elements["lm"].engine_stats()
        cold_tokens = [direct(cold, f"cold{index}", prompt)
                       for index, prompt in enumerate(prompts)]
        hits = gateway.telemetry.affinity_hits.value
    finally:
        stop_processes(processes)
        reset_keepers()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = previous
        del params32
        torch.cuda.empty_cache()
    identical = all(np.array_equal(got, want)
                    for got, want in zip(warm, cold_tokens))
    say("10c prefix_store", prompts=len(prompts),
        preamble_blocks=C_PREFIX_BLOCKS, placements=json.dumps(placed),
        affinity_hits=hits, holder_prefix_hits=holder_stats["prefix_hits"],
        prewarmed_prefix_hits=other_stats["prefix_hits"],
        prewarmed_blocks_shared=other_stats["prefix_blocks_shared"],
        warm_equals_cold=identical, card=repr(smi))
    if not (identical and placed[1] == placed[0]
            and holder_stats["prefix_hits"] >= 1
            and other_stats["prefix_hits"] == 1
            and other_stats["prefix_blocks_shared"] == C_PREFIX_BLOCKS):
        raise SystemExit("10c: prefix affinity or the keeper store failed "
                         "its checks")


def detector_pipeline(name: str) -> tuple:
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    process = Process(transport_kind="loopback")
    return process, create_pipeline(process, {
        "name": name,
        "parameters": {"device": "cuda", "metrics_interval": 60.0},
        "graph": ["(detector)"],
        "elements": [
            {"name": "detector", "input": [{"name": "image"}],
             "output": [{"name": "detections", "type": "dict"}],
             "parameters": {"preset": "yolov8n", "dtype": "bfloat16",
                            "micro_batch": D_MICRO},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "Detector"}}}]})


def served_detections(pipe, stream_ids: list, frames_per_stream: int,
                      image_for) -> tuple:
    """Serve every (stream, frame) straight through one replica:
    ({(stream index, frame id): detections}, seconds)."""
    replies = queue.Queue()
    streams = [pipe.create_stream(stream_id, queue_response=replies,
                                  grace_time=600)
               for stream_id in stream_ids]
    start = time.perf_counter()
    for frame_id in range(frames_per_stream):
        for index, stream in enumerate(streams):
            pipe.create_frame(stream, {"image": image_for(index, frame_id)})
    out = {}
    for _ in range(len(streams) * frames_per_stream):
        stream, frame, outputs = replies.get(timeout=600)
        detections = {name: value.cpu()
                      for name, value in outputs["detections"].items()}
        out[stream_ids.index(stream.stream_id), frame.frame_id] = detections
    elapsed = time.perf_counter() - start
    for stream_id in stream_ids:
        pipe.destroy_stream(stream_id)
    return out, elapsed


def phase_admission(smi: str) -> None:
    """10d: two Detector replicas behind a gateway under 2x overload:
    every frame answered or shed (none lost), every admitted frame's
    detections bit-equal to the same frame served straight through one
    replica (the engine pads every micro-batch to micro_batch rows, so
    each group runs at one shape)."""
    import threading
    from aiko_services_tpu_torch.runtime import Process
    from aiko_services_tpu_torch.serve import Gateway
    from aiko_services_tpu_torch.models import YOLOV8N_SHAPE
    generator = torch.Generator(device="cuda").manual_seed(3)
    size = YOLOV8N_SHAPE.image_size
    images = [torch.rand((1, 3, size, size), generator=generator,
                         device="cuda") for _ in range(D_IMAGES)]

    def image_for(stream_index, frame_id):
        return images[(stream_index * (D_FRAMES + 1) + frame_id)
                      % D_IMAGES]

    built = [detector_pipeline(f"det{index}") for index in range(2)]
    processes = [process for process, _ in built]
    replicas = [pipe for _, pipe in built]
    processes.append(Process(transport_kind="loopback"))
    try:
        for process in processes[:2]:
            process.run(in_thread=True)
        # capacity: one replica driven closed-loop with every stream busy
        probe_ids = [f"probe{index}" for index in range(D_STREAMS)]
        served_detections(replicas[0], probe_ids, 1, image_for)   # warm
        _, probe_s = served_detections(replicas[0], probe_ids, 4,
                                       image_for)
        capacity = 4 * D_STREAMS / probe_s
        gateway = Gateway(processes[2], policy=D_POLICY, router_seed=7,
                          metrics_interval=60.0)
        for replica in replicas:
            gateway.attach_replica(replica)
        processes[2].run(in_thread=True)
        replies = queue.Queue()
        for index in range(D_STREAMS):
            gateway.submit_stream(f"g{index}", {}, queue_response=replies,
                                  grace_time=600)
            gateway.submit_frame(f"g{index}", {"image": image_for(index, 0)},
                                 frame_id=0)
        for _ in range(D_STREAMS):            # frame 0 warms both replicas
            if replies.get(timeout=600)[3] != "ok":
                raise SystemExit("10d: a warm-up frame was not answered")
        offered_rate = 2.0 * 2 * capacity
        offered = D_STREAMS * D_FRAMES
        submitted, answered, statuses = {}, {}, {"ok": 0, "shed": 0}
        done = threading.Event()

        def drain():
            for _ in range(offered):
                stream_id, frame_id, outputs, status = replies.get(
                    timeout=600)
                key = (int(stream_id[1:]), int(frame_id))
                if status == "ok":
                    detections = {name: value.cpu() for name, value
                                  in outputs["detections"].items()}
                    answered[key] = (detections,
                                     time.perf_counter() - submitted[key])
                statuses[status] = statuses.get(status, 0) + 1
            done.set()

        drainer = threading.Thread(target=drain, daemon=True)
        drainer.start()
        start = time.perf_counter()
        for index in range(offered):
            stream_index, frame_id = index % D_STREAMS, 1 + index // D_STREAMS
            submitted[stream_index, frame_id] = time.perf_counter()
            gateway.submit_frame(f"g{stream_index}",
                                 {"image": image_for(stream_index, frame_id)},
                                 frame_id=frame_id)
            ahead = start + (index + 1) / offered_rate - time.perf_counter()
            if ahead > 0:
                time.sleep(ahead)             # open loop: the arrival clock
        if not done.wait(timeout=600):
            raise SystemExit("10d: frames were neither answered nor shed")
        elapsed = time.perf_counter() - start
        summary = gateway.telemetry.summary()
        reference, _ = served_detections(
            replicas[0], [f"ref{index}" for index in range(D_STREAMS)],
            D_FRAMES + 1, image_for)
    finally:
        stop_processes(processes)
    lost = offered - statuses["ok"] - statuses["shed"]
    mismatched = [key for key, (detections, _) in answered.items()
                  if not all(torch.equal(detections[name],
                                         reference[key][name])
                             for name in detections)]
    latencies = [latency for _, latency in answered.values()]
    say("10d admission", replicas=2, streams=D_STREAMS, policy=D_POLICY,
        micro_batch=D_MICRO, capacity_single_fps=f"{capacity:.1f}",
        offered_fps=f"{offered_rate:.1f}", offered_frames=offered,
        admitted=statuses["ok"], shed=statuses["shed"], lost=lost,
        goodput_fps=f"{statuses['ok'] / elapsed:.1f}",
        shed_rate=f"{statuses['shed'] / offered:.3f}",
        admitted_p50_ms=percentile_ms(latencies, 50),
        admitted_p99_ms=percentile_ms(latencies, 99),
        throttled=summary.get("throttled", 0),
        bit_equal_to_direct=not mismatched, card=repr(smi))
    if lost or mismatched or set(statuses) - {"ok", "shed"}:
        raise SystemExit(f"10d: {lost} frames lost, statuses {statuses}, "
                         f"{len(mismatched)} admitted frames differ from "
                         f"the direct replica (first: {mismatched[:4]})")


def phase_serving_tier(smi: str) -> None:
    """Phase 10: the serving tier at llama32_1b's full width."""
    from aiko_services_tpu_torch.models import LLAMA32_1B, init_params
    from aiko_services_tpu_torch.ops import kernels
    torch.cuda.empty_cache()
    start = time.perf_counter()
    kernels.reset_launch_counts()
    params = init_params(LLAMA32_1B, torch.Generator().manual_seed(0),
                         device="cuda")
    say("10 serving_setup", setup_s=f"{time.perf_counter() - start:.1f}")
    phase_disagg(params, LLAMA32_1B, smi)
    phase_warm_failover(params, LLAMA32_1B, smi)
    phase_prefix(params, LLAMA32_1B, smi)
    del params
    torch.cuda.empty_cache()
    phase_admission(smi)
    flash_launches = sum(kernels.launch_counts.values())
    say("10 serving_tier", flash_attention_launches=flash_launches,
        wall_s=f"{time.perf_counter() - start:.1f}", card=repr(smi))
    if flash_launches:
        raise SystemExit(f"10: {flash_launches} flash-attention launches "
                         f"on the serving tier's path")


def main() -> None:
    from aiko_services_tpu_torch.ops import kernels
    smi = phase_card()
    phase_build()
    max_abs_err = {"flash_attention": phase_kernel_checks()}
    max_abs_err.update(phase_backward_checks())
    timing = phase_timing(smi)
    phase_asr_tones()
    launches = {name: 0 for name in kernels.KERNELS}
    launches["flash_attention"] += phase_whisper_small(smi)
    for path_launches in (phase_llama_training(smi),
                          phase_asr_tones_training(), phase_config5(smi)):
        for name, count in path_launches.items():
            launches[name] += count
    phase_engine(smi)
    phase_serving_tier(smi)
    sources = {"flash_attention": ("flash_attention.cu", 75),
               "flash_attention_dq": ("flash_attention_backward.cu", 264),
               "flash_attention_dkv": ("flash_attention_backward.cu", 314)}
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"aiko_services_tpu_torch/csrc/{sources[name][0]}",
        "replaces": f"aiko_services_tpu/parallel/attention.py:"
                    f"{sources[name][1]}",
        "launches": launches[name],
        "max_abs_err": max_abs_err[name],
        **timing[name],
    } for name in kernels.KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
