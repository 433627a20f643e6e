"""Drive the PyTorch/CUDA port's speech-serving and training paths on one
NVIDIA GPU.

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

The line before the last is one JSON object describing every kernel of
the paths; the last line is {"ok": true, "device": {...}}.  Imports
nothing of JAX and nothing of the JAX package.
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
                          phase_asr_tones_training()):
        for name, count in path_launches.items():
            launches[name] += count
    sources = {"flash_attention": ("flash_attention.cu", 75),
               "flash_attention_dq": ("flash_attention_backward.cu", 264),
               "flash_attention_dkv": ("flash_attention_backward.cu", 314)}
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
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
