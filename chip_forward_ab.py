"""Hold versions of the flash-attention forward kernel (K1) against each
other on one NVIDIA GPU.

    python3 chip_forward_ab.py A.cu B.cu [C.cu ...]

Each argument is a version of aiko_services_tpu_torch/csrc/flash_attention.cu,
for example a parent commit's:

    source=aiko_services_tpu_torch/csrc/flash_attention.cu
    git show <commit>:$source > build/parent.cu

Every version is built as chip_backward_ab.py builds them and loaded
through the same C interface.  At the whisper_small serving shape (128 x 12
x 251 x 251 x 64, bf16) and the llama32_1b training shape (4 x 32 x 1024 x
1024 x 64, bf16, causal) each is checked against the plain f32 forward (O
within atol/rtol 2e-2, LSE within atol 1e-4: the tolerances of
chip_smoke.py), and then all are timed in turns A, B, ..., B, A: the median
over 25 samples of a run of 10 back-to-back launches between CUDA events,
one sample set per turn and shape.  Prints each version's registers and
spill bytes, its errors, one line per version, turn and shape, and the
card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys

import torch

from chip_backward_ab import build
from chip_smoke import (BF16_TOL, KERNEL_CASES, LSE_ATOL, card, cuda_ms,
                        random_qkv)

CASES = ("serving_encoder_bf16", "lm_training_bf16")


def main() -> None:
    from aiko_services_tpu_torch.parallel.attention import (
        _diagonal, flash_attention_plain)
    if not torch.cuda.is_available() or len(sys.argv) < 3:
        raise SystemExit(__doc__)
    sources = [pathlib.Path(argument) for argument in sys.argv[1:]]
    libraries = [build(source, index, ("aiko_flash_attention_forward",),
                       "forward") for index, source in enumerate(sources)]
    launches, tensors = {}, {}
    for case in CASES:
        batch, heads, q_len, k_len, dim, dtype, causal, _ = KERNEL_CASES[
            case]
        q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype, seed=7)
        out = torch.empty_like(q)
        lse = torch.empty((batch, heads, q_len), dtype=torch.float32,
                          device=q.device)
        # the launches below get raw pointers: keep the tensors alive
        tensors[case] = (q, k, v, out, lse)
        arguments = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), batch * heads, q_len,
                     k_len, dim, 1, int(causal), dim ** -0.5,
                     _diagonal(causal, 0, q_len, k_len),
                     torch.cuda.current_stream().cuda_stream)

        def launch(library, arguments=arguments):
            error = library.aiko_flash_attention_forward(*arguments)
            if error:
                raise SystemExit(f"forward launch failed: CUDA error "
                                 f"{error}")

        launches[case] = launch
        want_out, want_lse = flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal)
        for source, library in zip(sources, libraries):
            out.zero_()
            launch(library)
            torch.cuda.synchronize()
            print(f"[check] {source} case={case} o_max_abs_err="
                  f"{(out.float() - want_out).abs().max().item():.3e} "
                  f"lse_max_abs_err="
                  f"{(lse - want_lse).abs().max().item():.3e}", flush=True)
            torch.testing.assert_close(out.float(), want_out, atol=BF16_TOL,
                                       rtol=BF16_TOL)
            torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL, rtol=0)
    order = list(range(len(sources)))
    for turn, index in enumerate(order + order[::-1]):
        library = libraries[index]
        times = {case: cuda_ms(lambda: launches[case](library))
                 for case in CASES}
        print(f"[time] turn={turn} source={sources[index]} " + " ".join(
            f"{case}_ms={ms:.4f}" for case, ms in times.items()), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
