"""Time the port's bf16 `dense` with its products reduced in f32 (the
default since models/layers.py's f32_reduction) against the same product
with cuBLAS allowed to reduce in bf16, on one NVIDIA GPU.

    python3 chip_dense_ab.py

At llama32_1b's dense shapes (d_model 2048, 8 query heads x 64 of KV,
d_ff 8192) and at 8 rows (the decode engine's slots) and 128 rows (the
config-5 decode batch), each product is timed in turns f32, bf16, bf16,
f32: the median over 25 samples of a run of 10 back-to-back calls between
CUDA events.  Prints, per shape, each turn's time, and how many of the
outputs the two reductions round differently (random N(0, 1) inputs);
then the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import statistics

import torch

from chip_smoke import card, cuda_ms, say

# (rows, in, out): wq/wo, wk/wv, w_gate/w_up, w_down
SHAPES = [(rows, k, n) for rows in (8, 128)
          for k, n in ((2048, 2048), (2048, 512), (2048, 8192),
                       (8192, 2048))]


def main() -> None:
    from aiko_services_tpu_torch.models.layers import dense
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = card()
    matmul = torch.backends.cuda.matmul
    generator = torch.Generator().manual_seed(0)
    for rows, k, n in SHAPES:
        x = torch.randn((rows, k), generator=generator).to("cuda",
                                                           torch.bfloat16)
        w = (torch.randn((k, n), generator=generator) / k ** 0.5).to(
            "cuda", torch.bfloat16)
        params = {"w": w}

        def f32_reduced():
            return dense(params, x)

        def bf16_reduced():
            return torch.matmul(x, w)

        previous = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = True
        try:
            differ = int((f32_reduced() != bf16_reduced()).sum())
            times = {"f32": [], "bf16": []}
            for name in ("f32", "bf16", "bf16", "f32"):
                times[name].append(cuda_ms(
                    f32_reduced if name == "f32" else bf16_reduced))
        finally:
            matmul.allow_bf16_reduced_precision_reduction = previous
        ratio = (statistics.median(times["f32"])
                 / statistics.median(times["bf16"]))
        say("dense_reduction", rows=rows, k=k, n=n,
            f32_reduction_ms=[round(t, 4) for t in times["f32"]],
            bf16_reduction_ms=[round(t, 4) for t in times["bf16"]],
            median_ratio=f"{ratio:.3f}",
            outputs_rounded_differently=differ, outputs=rows * n,
            card=repr(smi))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
