"""Time the one-process sequence-parallel paths of one source tree on one
NVIDIA GPU, so that two trees can be held against each other in turns.

    python3 chip_sp_ab.py TREE LABEL

TREE is a checkout of this repository (`.` for this one; another, such as
a parent commit's, unpacked with `git archive <commit> | tar -x -C
build/parent`).  Run one process per turn, in the order A, B, B, A, in
one call on one card.  The tree's own chip_smoke.py and port are
imported; its kernels are built (or loaded from its build cache).
Measured, on a {"seq": 4} mesh over cuda:0 as chip_smoke.py's phase 12
does:

  - 12a's ring at (1, 32, 8192, 64) bf16, causal, forward and backward:
    the median over 10 runs between CUDA events, three times, and one
    K1 + K2 + K3 call on the whole sequence;
  - 12b's sequence-parallel prefill of llama32_1b (weights drawn on the
    card from seed 12) on one 1 x 8192 prompt, ring and Ulysses: five
    timed forwards after one warm-up, and their median.

Prints the card's name and power limit, then one line `AB12 {...}`.
Imports nothing of JAX.
"""

import json
import statistics
import sys
import time
from dataclasses import replace

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

smi = cs.phase_card()
from aiko_services_tpu_torch.ops import kernels  # noqa: E402

kernels.build_all()      # phase_build wants nvcc's log: a cached build has none
for name in kernels.KERNEL_SOURCES:
    kernels.load_kernel(name)
from aiko_services_tpu_torch.models import LLAMA32_1B, forward  # noqa: E402
from aiko_services_tpu_torch.parallel import use_mesh  # noqa: E402
from aiko_services_tpu_torch.parallel.attention import (  # noqa: E402
    flash_attention_backward, flash_attention_forward, ring_attention)

q, k, v = cs.random_qkv(1, 32, cs.SP_SEQ, cs.SP_SEQ, 64, torch.bfloat16,
                        seed=1200)
dout = cs.random_qkv(1, 32, cs.SP_SEQ, 1, 64, torch.bfloat16, seed=1201)[0]
mesh = cs.seq_mesh()
inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]


def ring_step():
    out = ring_attention(*inputs, mesh, causal=True)
    torch.autograd.grad(out, inputs, dout)


def one_call_step():
    out, lse = flash_attention_forward(q, k, v, causal=True)
    flash_attention_backward(q, k, v, out, lse, dout, causal=True)


result = {"label": label, "root": root}
result["ring_fwd_bwd_ms"] = [cs.cuda_ms(ring_step, warmup=2, runs=10)
                             for _ in range(3)]
result["one_k1_k2_k3_ms"] = cs.cuda_ms(one_call_step, warmup=2, runs=10)
del q, k, v, dout, inputs
torch.cuda.empty_cache()
params = cs.draw_on_card(LLAMA32_1B, 12)
tokens = torch.randint(0, LLAMA32_1B.vocab_size, (1, cs.SP_SEQ),
                       generator=torch.Generator().manual_seed(1202)).cuda()
for mechanism in ("ring", "ulysses"):
    config = replace(LLAMA32_1B, sequence_parallel=True,
                     sp_mechanism=mechanism)
    seconds = []
    with use_mesh(mesh), torch.no_grad():
        forward(params, config, tokens)
        torch.cuda.synchronize()
        for _ in range(5):
            start = time.perf_counter()
            forward(params, config, tokens)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
    result[f"12b_{mechanism}_ms"] = [round(s * 1e3, 2) for s in seconds]
    result[f"12b_{mechanism}_median_ms"] = statistics.median(seconds) * 1e3
print(smi, flush=True)
print("AB12 " + json.dumps(result), flush=True)
