"""Hold versions of the flash-attention backward kernels (K2 dQ, K3 dK/dV)
against each other on one NVIDIA GPU.

    python3 chip_backward_ab.py A.cu B.cu [C.cu ...]

Each argument is a version of
aiko_services_tpu_torch/csrc/flash_attention_backward.cu, for example a
parent commit's:

    source=aiko_services_tpu_torch/csrc/flash_attention_backward.cu
    git show <commit>:$source > build/parent.cu

Every version is built with the port's nvcc flags into build/kernels/ and
loaded through the same C interface.  At the llama32_1b training shape
(4 x 32 x 1024 x 1024 x 64, bf16, causal) each is checked against the
plain f32 backward (per-tensor relative error <= 2e-2, the tolerance of
chip_smoke.py), and then all are timed in turns A, B, ..., B, A: the
median over 25 samples of a run of 10 back-to-back launches between CUDA
events, one sample set per turn.  Prints each version's registers and
spill bytes, its errors, one line per version and turn, and the card's
name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

from chip_smoke import (GRAD_REL_TOL, card, cuda_ms, ptxas_stats,
                        relative_error)

SHAPE = (4, 32, 1024, 64)   # B, H, L (= Lq = Lk), D


def build(source: pathlib.Path, index: int) -> ctypes.CDLL:
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel.attention import _SIGNATURES
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = kernels.BUILD_DIR / f"libbackward_ab{index}.so"
    result = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(target),
         str(source)], capture_output=True, text=True)
    if result.returncode:
        raise SystemExit(f"nvcc failed on {source}:\n{result.stderr}")
    stats = ptxas_stats(result.stdout + result.stderr)
    print(f"[build] {source} " + " ".join(
        f"{label}={stat.get('registers')}/{stat.get('spill_bytes')}"
        for label, stat in stats.items() if "_tc" in label), flush=True)
    library = ctypes.CDLL(str(target))
    for symbol in ("aiko_flash_attention_dq", "aiko_flash_attention_dkv"):
        function = getattr(library, symbol)
        function.argtypes = _SIGNATURES[symbol][1]
        function.restype = ctypes.c_int
    return library


def main() -> None:
    from aiko_services_tpu_torch.parallel.attention import (
        _delta, flash_attention_backward_plain, flash_attention_forward)
    if not torch.cuda.is_available() or len(sys.argv) < 3:
        raise SystemExit(__doc__)
    sources = [pathlib.Path(argument) for argument in sys.argv[1:]]
    libraries = [build(source, index) for index, source in
                 enumerate(sources)]
    batch, heads, length, dim = SHAPE
    generator = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn((batch, heads, length, dim),
                                 generator=generator).to("cuda",
                                                         torch.bfloat16)
                     for _ in range(4))
    out, lse = flash_attention_forward(q, k, v, causal=True)
    delta = _delta(out, dout)
    scale = 1.0 / dim ** 0.5
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream().cuda_stream
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    sizes = (batch * heads, length, length, dim, 1, 1, scale, 0, stream)

    def launch_dq(library):
        error = library.aiko_flash_attention_dq(*common, dq.data_ptr(),
                                                *sizes)
        if error:
            raise SystemExit(f"dQ launch failed: CUDA error {error}")

    def launch_dkv(library):
        error = library.aiko_flash_attention_dkv(
            *common, dk.data_ptr(), dv.data_ptr(), *sizes)
        if error:
            raise SystemExit(f"dK/dV launch failed: CUDA error {error}")

    expected = flash_attention_backward_plain(
        q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
        causal=True)
    for source, library in zip(sources, libraries):
        launch_dq(library)
        launch_dkv(library)
        torch.cuda.synchronize()
        errors = [relative_error(got, want)
                  for got, want in zip((dq, dk, dv), expected)]
        print(f"[check] {source} rel_err dq/dk/dv="
              f"{'/'.join(f'{e:.3e}' for e in errors)}", flush=True)
        if max(errors) > GRAD_REL_TOL:
            raise SystemExit(f"{source}: relative error above "
                             f"{GRAD_REL_TOL}")
    order = list(range(len(sources)))
    for turn, index in enumerate(order + order[::-1]):
        library = libraries[index]
        dq_ms = cuda_ms(lambda: launch_dq(library))
        dkv_ms = cuda_ms(lambda: launch_dkv(library))
        print(f"[time] turn={turn} source={sources[index]} "
              f"dq_ms={dq_ms:.4f} dkv_ms={dkv_ms:.4f} "
              f"pair_ms={dq_ms + dkv_ms:.4f}", flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
