"""Drive the PyTorch/CUDA port's speech-serving, training, LM-serving
and serving-tier paths, its remaining model families (switch MoE,
YOLOv8, TTS), its long-context (sequence-parallel) path, its
parameter-sharding axes (tensor, FSDP, data and expert parallelism),
HuggingFace checkpoints, the shipped examples, the analyzer's eval
pass, the elastic fleet, the media and vision elements, the
Checkpointer, the native codec and sharded training across processes
on one NVIDIA GPU; with `cards`, the mesh on several cards (phases 19
and 20, below).

    python3 chip_smoke.py
    python3 chip_smoke.py cards    # a machine with four cards

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
 11. the remaining model families:
     11a a switch-MoE llama32_1b (the published widths, 8 experts,
         capacity factor 1.25, depth cut to 8 layers, bf16, random
         weights from a seed) trained through make_train_step at batch
         4 x 1024: one step's loss against the plain attention path in
         bf16 (with the share of routes that flip) and loss and
         attention gradients in f32, then tokens/s, step time, the
         active-parameter MFU, peak memory, the aux loss and K1/K2/K3
         launches per step, and one step under torch.profiler;
     11b on the same weights: closed-batch generate, the decode engine
         on 32 seeded requests under captured graphs (captured == eager,
         0 signatures added, the full-slot step against its byte bound
         with each slot's gathered expert counted), and a small f32 MoE
         model card == CPU through generate and the engine at capacity
         factors 1.25, 4 and 0, the gather, capacity and oracle routes
         each taken;
     11c yolov8n from an ultralytics-named checkpoint written from a
         seeded rng: f32 candidates card against CPU and NMS equal, bf16
         heads within bf16 roundings, then a Detector at 640 px,
         micro_batch 16, 1 + 4 groups: frames/s, p50, peak memory;
     11d TextToSpeech card against CPU and seconds of audio a second,
         make_tts_train_step's loss falling, make_detector_train_step at
         the yolov8n shape (640 px, bf16, batch 16) and one f32 step of
         the toy detector card against CPU
 12. long context: sequence parallelism over a {"seq": 4} mesh that
     names cuda:0 four times (a ring hop between two shards on one card
     moves no bytes), llama32_1b at its published widths, bf16, seeded:
     12a the ring at (1, 32, 8192, 64), causal at n = 4 and 8 and dense
         at n = 4: O against one K1 call and the plain version, dQ/dK/dV
         (K2/K3 per hop) against the plain gradients, executed hops and
         launches = n(n+1)/2 (n^2 dense); the ring forward + backward
         timed against one K1 + K2 + K3 call;
     12b forward with sequence_parallel on a 1 x 8192 prompt, ring and
         Ulysses, against the non-SP forward: logits, equal argmaxes, ms
         and tokens/s;
     12d generate with the SP cache (ring cached prefill, sp decode) on
         a 4,096-token prompt, 32 new tokens: tokens/s, agreement with
         non-SP generate; a small f32 LM's SP tokens card == CPU;
     12c make_train_step with sequence_parallel, adamw, 1 x 8192, 1 + 3
         steps: loss against the non-SP step, step ms, tokens/s, MFU,
         peak memory, K1/K2/K3 launches a step;
     12e (tokens (lm)) after examples/pipeline_longcontext.json:
         TokenSource -> LMForward sequence_parallel on a data 1 x seq 4
         sharding block, 4 frames of 1 x 8192 held against a direct
         forward; an LMGenerate frame whose 1,021-token prompt is
         left-padded to the seq axis, against a direct generate
 13. the parameter-sharding axes, on meshes that name cuda:0 several
     times (a collective between two shards on one card moves no bytes,
     so every time is one card's):
     13a examples/pipeline_llm_8b.json as shipped: llama3_8b at full
         width (bf16, weights drawn on the card from a seed and installed
         through the element's restore_state) on its fsdp 2 x model 4 mesh,
         the TextSource prompt, 64 new tokens (it ships 128) through
         the pipeline:
         tokens/s, decode-step ms, collective calls and KiB a step, peak
         memory; the last prompt position's logits and the greedy tokens
         against the unsharded 8B on the same weights, and where the
         tokens part, the unsharded top-2 gap there; then the same
         weights as int8 weights and int8 KV on fsdp 2 x model 2;
     13b f32 at the 8B widths, 2 layers: sharded and unsharded generate
         give identical tokens on fsdp 2 x model 4, and with int8
         weights and int8 KV on fsdp 2 x model 2;
     13c llama32_1b at full width, depth cut to 8 layers, data 2 x
         fsdp 2 x model 2, batch 4 x 1024, adamw, 2 steps of
         make_train_step(sharded=True): losses and each parameter's
         change against the unsharded steps, step ms, tokens/s, MFU,
         K1/K2/K3 launches a step (8 layers x 2 data x 2 model shards);
         then in f32 at 2 layers, where each step's
         gradients are held leaf by leaf against the unsharded step's;
     13d phase 11a's MoE (its depth cut to 4 layers) on data 2 x expert
         2 x model 2: 2 train steps against the unsharded ones, in bf16
         and in f32 at 2 layers (gradients too), then f32 generate (2
         layers) token for token equal to it;
     13e examples/pipeline_longcontext.json as shipped (data 1 x seq 4 x
         model 2): each frame against an unsharded forward, K1 launches a
         frame (the ring's 10 hops per model shard and layer);
     13f SpeechToText whisper_small, f32, on {"model": 2} with its default
         asr_param_specs: tokens identical to the element without a mesh;
     13g K1, and K2 with K3, at every case 13a-13f launched them with
         that phase 2 did not check (the per-shard shapes), against the
         plain versions at phase 2's limits
 14. HuggingFace checkpoints, the shipped examples and the eval pass,
     on phase 8's seeded config-5 weights (nothing is drawn again):
     14a whisper_small written as an HF openai/whisper-* file (the name
         map inverted; the biases the seeded init leaves out as zeros)
         and served as config 5's asr (max_frames 512, 2 groups of 8 x
         16 rows): tokens identical to the same element loaded through
         save_pytree with whisper's sot/eot ids; load seconds, peak
         memory, K1 launches;
     14b llama32_1b (tied) written as an HF Llama file and served as
         config 5's lm: tokens identical to the native-layout load;
     14c the same file read straight into an LMGenerate on fsdp 2 x
         model 2: the load's peak below one whole copy plus the largest
         tensor, logits and tokens held as 13a holds sharded bf16
         decode; a 2-layer f32 file placed on the mesh: tokens
         identical to its unsharded load;
     14d the repaired departures: whisper_small in f32 on model 8 (12
         heads over 8 shards: whole-head spans) with tokens identical
         to the unsharded element, K1 launches a shard and the heads
         computed twice; a llama32_1b forward on weights cut by a
         non-default spec: logits equal to the default layout's, the
         reshard's calls and bytes from the collective counter;
     14e examples/pipeline_multimodal.json (K1 in its ASR),
         pipeline_compute.json and pipeline_robot_loop.json as shipped
         with runtime "torch", outputs checked as their JAX tests check
         them (no cv2 or PIL on the card's machine: the video examples
         and image file I/O are the CPU tests');
     14f the analyzer's eval pass over config 5's definition on the
         meta device: asr, lm and detector traced, no AIKO207/AIKO208,
         memory_allocated unchanged, element_cost_estimates printed;
     14g K1 at every case 14a-14e launched it with that phase 2 did not
         check, against the plain version
 15. the elastic fleet (serve/autoscale.py, runtime/compile_cache.py,
     serve/autopilot.py, the CLI): replicas of the config-5 graph at
     full width on phase 8's weights, fed by a gateway (2-row frames,
     no micro-batching, so each frame is computed alone):
     15a a cold replica through InProcessReplicaFactory against a fresh
         kernel build cache under build/fleet/ (nvcc builds K1's
         library: a miss) and a warm one from it (0 misses, a hit on
         its own threads, asr/lm/detector imported, K1 launched):
         time-to-healthy of each, captures, nvcc seconds;
     15b a burst above the high watermark spawns exactly one warm
         replica, two trickle streams on it are drained mid-way by the
         low watermark back to one replica: 0 frames lost, every
         output (ASR and LM tokens, detector boxes) equal to the
         unscaled run's;
     15c one OS-process replica (`python -m aiko_services_tpu_torch
         pipeline`) through ProcessReplicaFactory and ProcessManager,
         warm from the cold replica and the cache, attached by
         registrar discovery over a local MQTT broker: its frame equal
         to the reference, its published counters 1+ hit and 0 misses,
         the cache unchanged, retired; its time-to-healthy;
     15d the gateway's autopilot ticked once over the live traces: its
         recommendations, what it applied or declined and why, the
         journal holding exactly the applied deltas; the port's `tune`
         on the same traces in a subprocess exits 0

 16. the last modules: the media and vision elements, the Checkpointer
     and the native S-expression codec, on phase 8's seeded weights:
     16a two media graphs at full width through Process /
         create_pipeline: ToneSource (on_device, 7.5 s tones read as 24
         kHz audio) -> AudioResample (24 -> 16 kHz) -> AudioFraming (a
         window of 2 chunks: 5 s, then 10 s) -> SpeechToText
         (whisper_small, max_frames 512, bf16) -> TokensToText, with
         AudioFFT on a side branch; ImageSource (on_device, 3 x 480 x
         640) -> ImageResize (640 x 640) -> Detector (yolov8n shape) and
         FaceDetect, ImageOutput.  The card's resampled, framed and
         resized tensors and its spectrum against the same elements on
         the CPU (the tests' tolerances), the ASR tokens against the
         card's SpeechToText on the CPU-framed audio (identical),
         FaceDetect's detections against a CPU run on the same image
         (equal), K1 launches counted;
     16b config 5's graph at full width (phase 15's replica definition,
         2-row frames) serving 4 frames, Pipeline.checkpoint into a
         Checkpointer under build/, a fresh pipeline restored from it:
         the stream cursor restored, the same frames' outputs identical
         to the pipeline's before the checkpoint, K1 launched after the
         restore; bytes written, save and restore seconds, peak memory;
     16c native.build.build() with g++, then utils.sexpr.parse on the
         native path: tests/test_native.py's corpus equal to the Python
         parser's (errors too), and both parsers' microseconds a message;
     16d K1 at every case 16a/16b launched it with that phase 2 did not
         check, against the plain version
 17. sharded training across two processes on the one card: two worker
     processes join a gloo job through the AIKO_* contract on localhost,
     each with local_device_ids [0, 0] (two positions on cuda:0), and a
     global mesh spans both; every cross-process exchange of a CUDA
     block goes through host memory (counted).  The parent first runs
     the unsharded steps on the same weights (drawn on the card from one
     seed in every process) and batches, writes the parameters after
     them (and the f32 gradients) under build/, and frees the card:
     17a llama32_1b at full width, depth cut to 8 layers, bf16, batch
         4 x 1024,
         adamw, 1 + 2 steps of make_train_step(sharded=True) on fsdp 2 x
         model 2, fsdp across the processes: each rank's losses and its
         blocks' change against the unsharded steps (13c's gates), step
         ms, tokens/s, peak memory, collective calls and bytes a step
         (worked out from the mesh in advance; a mismatch fails), bytes
         staged through the host, K1/K2/K3 launches a step against
         layers x the shards the rank computes, 0 kernel builds in the
         workers;
     17b the same step in f32 at 2 layers on fsdp 2 x model 2 and on
         data 2 x fsdp 2 (the replica sum across the processes): each
         step's gradients leaf by leaf and the losses against the
         unsharded step's;
     17c every K1 and K2/K3 case 17a/17b launched that phase 2 did not
         check, against the plain versions, on each rank; and the ranks'
         replicas (whole leaves, blocks both hold) bit for bit equal
 18. sequence parallelism across two processes on the one card: two
     gloo workers (phase 17's harness), each one "seq" position on
     cuda:0 (local_device_ids [0]) of a global {"seq": 2} mesh; each
     embeds, projects and runs the FFN on its half of the sequence, and
     the ring's hops, Ulysses' all_to_alls, the cached prefill's K/V
     gather and the sp decode's pmax/psum cross the processes through
     host memory.  Per arm and rank: ms and tokens/s, K1/K2/K3 launches
     (a causal ring of 2: rank 0 one hop a layer, rank 1 two) and
     collective calls and bytes, each held to the count worked out from
     the shapes in advance, bytes staged through the host, peak memory:
     18a llama32_1b at full width and depth, bf16, a 1 x 8192 prompt,
         ring and Ulysses forwards, against 12b's path (the one-process
         {"seq": 4} forward) at 12b's gates;
     18b depth cut to 4 layers, bf16, 1 x 8192, 1 + 2 adamw steps
         through the ring, losses against the same steps on a
         one-process {"seq": 2} mesh, the first against the non-SP
         step's;
     18c full depth, a 4,096-token prompt and 32 new tokens (the ring's
         cached prefill, then the sp decode), tokens identical to the
         one-process SP generate on {"seq": 2} with the same layout; the
         cached prefill's and one decode step's logits and the first
         token against the non-SP path's at 12b's gates;
     18d f32 at 2 layers, 1 x 2048, one step through the ring under
         nothing_saveable and under dots_saveable (each layer recomputed
         inside its backward node, the products kept under the second),
         gradients leaf by leaf against the unsharded step's; for each
         policy the peak over the layers' forward and what the layers
         leave held for the backward (read before the f32 head, whose
         transient sets the step's own peak);
     18e every K1 and K2/K3 case 18a-18d launched that phase 2 did not
         check, against the plain versions, on each rank

`python3 chip_smoke.py cards` runs phases 0, 1, 19 and 20 and phase 3's
timing on cuda:0; it exits non-zero with fewer than four CUDA devices:
 19. one process over several cards:
     19a nvidia-smi topo -m, a 1 GiB bf16 copy cuda:0 -> cuda:k timed
         on each card, then phase 2's K1 and K2/K3 cases on every card
         but cuda:0, each against its plain version there, each
         launched twice and bitwise equal;
     19b examples/pipeline_llm_8b.json (llama3_8b, bf16, drawn on the
         card) through create_pipeline with its eight fsdp 2 x model 4
         positions spread over the cards (two a card on four): its 64
         tokens identical to the same definition over cuda:0 eight
         times; decode-step ms, collective calls and KiB a step, each
         card's peak;
     19c llama32_1b at full width and depth, bf16, 4 x 1024, adamw, 1 +
         2 sharded steps on fsdp 2 x model 2 over four cards, losses and
         parameters against the same mesh over cuda:0 four times (13c's
         gates, and whether bit-equal): step ms, tokens/s, MFU over the
         four cards' peak, each card's peak, K1/K2/K3 launches a step a
         card;
     19d 12a's ring forward + backward at (1, 32, 8192, 64) bf16 on
         {"seq": 4} over four cards, bit-equal to the cuda:0 x 4 mesh,
         timed against one K1 + K2 + K3 call; 12b's SP prefill, ring and
         Ulysses, on the four cards against the non-SP forward;
 20. four NCCL worker processes (phase 17's harness), each one card
     (local_device_ids [rank]), nothing staged through host memory:
     20a 17a's step at full depth on fsdp 2 x model 2, one position a
         process, against the unsharded steps, the counts worked out in
         advance, and the step again with every exchange's checked
         header skipped (what the headers cost);
     20b 17b's f32 arms at 2 layers on fsdp 2 x model 2 and data 2 x
         fsdp 2, each gradient leaf against the unsharded step's;
     20c 18a on {"seq": 4} across the four processes: ring and Ulysses
         forwards against 12b's path on each rank's card, rank r's
         hops r + 1 a layer;
     20d every K1 and K2/K3 case 20a-20c launched that phase 2 did not
         check, against the plain versions on each rank's card

The last three lines are the card's nvidia-smi name and power limit, one
JSON object describing every kernel of the paths, and {"ok": true,
"device": {...}}.  Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import ast
import contextlib
import gc
import json
import math
import pathlib
import queue
import re
import statistics
import subprocess
import sys
import threading
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


def random_qkv(batch, heads, q_len, k_len, dim, dtype, seed,
               device="cuda"):
    generator = torch.Generator().manual_seed(seed)
    shapes = [(batch, heads, q_len, dim), (batch, heads, k_len, dim),
              (batch, heads, k_len, dim)]
    return [torch.randn(shape, generator=generator).to(device, dtype)
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


def plain_by_heads(function, batch: int, q_len: int, k_len: int, heads: int,
                   *tensors) -> list:
    """function(*tensors) of a plain f32 version, taken over as many heads
    at a time as keep its f32 scores within 1 GiB (heads are independent,
    so the result is the whole call's); returns its outputs, each
    concatenated over the heads."""
    chunk = max(1, 2 ** 30 // (4 * batch * q_len * k_len))
    parts = []
    for start in range(0, heads, chunk):
        picked = [tensor[:, start:start + chunk].contiguous()
                  for tensor in tensors]
        result = function(*picked)
        parts.append(result if isinstance(result, tuple) else (result,))
    return [torch.cat(column, dim=1) for column in zip(*parts)]


def check_forward_case(case: str, spec: tuple, seed: int,
                       phase: str, device="cuda") -> float:
    """One K1 case (B, H, Lq, Lk, D, dtype, causal, q_offset[, sm_scale])
    on `device` (the current card by default) against the plain f32
    version there, and a second launch on the same inputs bitwise equal
    to the first (one owner block per output tile, no atomics); returns
    O's max abs error."""
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_forward, flash_attention_plain)
    batch, heads, q_len, k_len, dim, dtype, causal, q_offset, *scale = spec
    sm_scale = scale[0] if scale else None
    q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype, seed=seed,
                         device=device)
    out, lse = flash_attention_forward(q, k, v, causal=causal,
                                       sm_scale=sm_scale, q_offset=q_offset)
    repeat = flash_attention_forward(q, k, v, causal=causal,
                                     sm_scale=sm_scale, q_offset=q_offset)
    torch.cuda.synchronize(q.device)
    if not (torch.equal(out, repeat[0]) and torch.equal(lse, repeat[1])):
        raise SystemExit(f"{case}: two launches on the same inputs differ")
    del repeat
    ref_out, ref_lse = plain_by_heads(
        lambda q, k, v: flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal,
            sm_scale=sm_scale, q_offset=q_offset),
        batch, q_len, k_len, heads, q, k, v)
    out_error = (out.float() - ref_out).abs().max().item()
    lse_error = (lse - ref_lse).abs().max().item()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref_out, atol=BF16_TOL,
                                   rtol=BF16_TOL)
    else:
        torch.testing.assert_close(out, ref_out, atol=F32_ATOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    say(phase, case=case, shape=f"{batch}x{heads}x{q_len}x{k_len}x{dim}",
        dtype=str(dtype).replace("torch.", ""), causal=causal,
        q_offset=q_offset, o_max_abs_err=f"{out_error:.3e}",
        lse_max_abs_err=f"{lse_error:.3e}", bitwise_repeat=True,
        **({} if device == "cuda" else {"device": str(out.device)}),
        ok=True)
    return out_error


def phase_kernel_checks(phase: str = "2 kernel_vs_plain",
                        device="cuda") -> float:
    """Every case of KERNEL_CASES (check_forward_case) on `device`;
    returns the O max abs error at the serving shape."""
    serving_error = None
    for index, (case, spec) in enumerate(KERNEL_CASES.items()):
        error = check_forward_case(case, spec, index, phase, device)
        if case == "serving_encoder_bf16":
            serving_error = error
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


def check_backward_case(case: str, spec: tuple, seed: int,
                        phase: str, device="cuda") -> dict:
    """K2 and K3 at one case (B, H, Lq, Lk, D, dtype, causal, q_offset[,
    sm_scale]) on `device` (the current card by default) against the
    plain f32 backward on the same inputs and the same dO there, and a
    second launch on the same inputs bitwise equal to the first; returns
    each gradient's max abs and relative error."""
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_forward)
    batch, heads, q_len, k_len, dim, dtype, causal, q_offset, *scale = spec
    options = dict(causal=causal, q_offset=q_offset,
                   sm_scale=scale[0] if scale else None)
    q, k, v = random_qkv(batch, heads, q_len, k_len, dim, dtype, seed=seed,
                         device=device)
    dout = random_qkv(batch, heads, q_len, 1, dim, dtype,
                      seed=seed + 100, device=device)[0]
    out, lse = flash_attention_forward(q, k, v, **options)
    grads = flash_attention_backward(q, k, v, out, lse, dout, **options)
    repeat = flash_attention_backward(q, k, v, out, lse, dout, **options)
    torch.cuda.synchronize(q.device)
    if not all(torch.equal(first, second)
               for first, second in zip(grads, repeat)):
        raise SystemExit(f"{case}: two launches on the same inputs differ")
    del repeat
    expected = plain_by_heads(
        lambda q, k, v, out, lse, dout: flash_attention_backward_plain(
            q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
            **options),
        batch, q_len, k_len, heads, q, k, v, out, lse, dout)
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
    say(phase, case=case, shape=f"{batch}x{heads}x{q_len}x{k_len}x{dim}",
        dtype=str(dtype).replace("torch.", ""), causal=causal,
        q_offset=q_offset,
        **{key: f"{value:.3e}" for key, value in fields.items()},
        bitwise_repeat=True,
        **({} if device == "cuda" else {"device": str(q.device)}),
        ok=True)
    return fields


def phase_backward_checks(phase: str = "2b backward_vs_plain",
                          device="cuda") -> dict:
    """Every case of BACKWARD_CASES (check_backward_case) on `device`;
    returns the max abs errors at the training shape."""
    errors = None
    for index, (case, spec) in enumerate(BACKWARD_CASES.items()):
        fields = check_backward_case(case, spec, 100 + index, phase,
                                     device)
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


def profile_train_step(train_step, params, opt_state, tokens, smi: str,
                       label: str = "6d llama32_1b_step_profile") -> None:
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
    say(label, wall_ms=f"{wall_ms:.1f}",
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
# {"asr" | "lm" | "detector": (config, parameters on the host)}: phase
# 8's seeded whisper_small, llama32_1b and detector; phase 14 writes the
# first two as HF-named files, phase 15's replicas serve all three
C5_WEIGHTS: dict = {}


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
    from aiko_services_tpu_torch.utils.tree import tree_leaves, tree_map

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
        # phase 14 writes HF-named checkpoints of these same weights
        C5_WEIGHTS.update({name: (element.config, tree_map(
            lambda leaf: leaf.detach().cpu(), element.state))
            for name, element in (("asr", pipeline.elements["asr"]),
                                  ("lm", lm), ("detector",
                                               pipeline.elements[
                                                   "detector"]))})
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
    bf16 layers on the tensor cores, the f32 head on the CUDA cores).  A
    switch-MoE layer's experts count as each slot's own expert read once
    for that slot: the decode step gathers every token's expert weights.
    Returns (bound_ms, bound_by, bytes)."""
    from aiko_services_tpu_torch.decode import TRASH_BLOCK
    from aiko_services_tpu_torch.utils.tree import tree_leaves
    _, peaks = peaks_for(smi)
    params, config, slots = engine.params, engine.config, engine.slots_n
    head = params.get("lm_head", params["embed"])["w"]
    shared, per_slot = [], []
    for name, entry in params["layers"].items():
        for leaf in tree_leaves(entry):
            if config.n_experts and name in ("w_gate", "w_up", "w_down"):
                per_slot.append(leaf[:, 0])      # one expert, every layer
            else:
                shared.append(leaf)

    def size(leaves, dim=None):
        return sum(leaf.numel() * (leaf.element_size() if dim is None
                                   else 1)
                   for leaf in leaves if dim is None or leaf.dim() == dim)

    pool_block = sum(leaf[:, 0].numel() * leaf.element_size()
                     for leaf in engine.pool.values())
    blocks = len(set(engine.tables.ravel().tolist()) - {TRASH_BLOCK})
    moved = (size(shared) + slots * size(per_slot)
             + head.numel() * head.element_size()
             + slots * config.d_model * params["embed"]["w"].element_size()
             + blocks * pool_block
             + slots * pool_block // engine.blocks.block_size)
    weights = size(shared, 3) + size(per_slot, 3)
    seconds = {"bytes": moved / peaks["bytes"],
               "operations": 2 * slots * weights / peaks["bfloat16"]
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


# -- the remaining model families ------------------------------------------------

# 11a: a switch-MoE llama32_1b: the published widths with 8 experts at
# the JAX default capacity factor 1.25, depth cut from 16 layers to 8
# (3.57 G parameters, 7.1 GB in bf16; parameters, gradients and two bf16
# moments 28.5 GB, the f32 operand copies the expert products keep for
# the backward 12.9 GB, the f32 head ~6 GB: 16 layers would not fit beside
# the optimizer state), bf16, batch 4 x 1024 as phase 6, adamw(1e-4), 1 +
# 5 steps
M_LAYERS, M_EXPERTS, M_STEPS = 8, 8, 5
# 11b, on 11a's weights: closed-batch generate of 8 prompts of 32 tokens,
# 32 new; the engine: 32 requests from default_rng(21), prompts of 16-64
# tokens, 16-48 new, 8 slots of 32-position blocks, captured graphs
M_GEN_ROWS, M_GEN_PROMPT, M_GEN_NEW = 8, 32, 32
M_REQUESTS, M_PROMPT, M_NEW = 32, (16, 64), (16, 48)
# and in f32 (TF32 off) a small MoE model, card against the CPU, at three
# capacity factors: 1.25 (tokens drop), n_experts (none drop), 0 (the
# dense oracle)
M_SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=256, max_seq_len=128, dtype="float32",
               n_experts=4)
M_FACTORS = (("drops", 1.25), ("no_drops", 4.0), ("oracle", 0.0))
# 11c: yolov8n (ultralytics layout, weights from default_rng(0)) at 640
# px: a Detector with micro_batch 16 over 16 streams, 1 + 4 groups
Y_MICRO, Y_GROUPS = 16, 4
# the raw heads and pre-NMS boxes of a bf16 run, card against the CPU:
# each of ~25 convolution layers rounds its f32 sums to bf16 (2^-9
# relative) in its own summation order, and those one-ulp differences
# compound through the network -> relative norm error <= 5e-2
YOLO_BF16_TOL = 5e-2
# f32 (TF32 off) pre-NMS candidates, card against the CPU: the same
# products summed in another order through ~25 layers -> boxes atol 1e-3
# px, scores atol 1e-5; NMS on the same candidates identical
# 11d: TextToSpeech (the default TTSConfig: d_model 256, 4 convs, 30
# Griffin-Lim iterations) on four prompts, f32: waveforms within the CPU
# test's atol 1e-4 of the CPU's
T_PROMPTS = ("hello from the card", "text to speech on an h100",
             "griffin lim recovers the phase", "four prompts, one element")
T_TRAIN_STEPS = 20
# make_detector_train_step at YOLOV8N_SHAPE, 640 px, bf16, batch 16
DT_BATCH, DT_STEPS = 16, 5


def moe_active_params(config) -> int:
    """Parameters a token reaches in a forward: each layer's attention,
    router and ONE expert's FFN, and the tied head."""
    d, hd = config.d_model, config.head_dim
    attention = (d * (config.n_heads + 2 * config.n_kv_heads) * hd
                 + config.n_heads * hd * d)
    expert = 3 * d * config.d_ff
    return (config.n_layers * (attention + d * config.n_experts + expert)
            + config.vocab_size * d)


def phase_moe_training(smi: str) -> tuple:
    """11a.  Returns (the trained params, the config, the kernel launches
    of the measured steps)."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        LLAMA32_1B, adamw, count_params, make_train_step)
    from aiko_services_tpu_torch.models import transformer
    from aiko_services_tpu_torch.models.optim import (
        next_token_loss, value_and_grad)
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.utils.tree import tree_map

    torch.cuda.empty_cache()
    config = replace(LLAMA32_1B, n_layers=M_LAYERS, n_experts=M_EXPERTS)
    start = time.perf_counter()
    params = draw_on_card(config, 0)
    n_params = count_params(params)
    active = moe_active_params(config)
    rng = np.random.default_rng(0)

    def random_tokens():
        return torch.from_numpy(rng.integers(
            0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()

    tokens = random_tokens()
    torch.cuda.synchronize()
    say("11a moe_setup", layers=config.n_layers, experts=config.n_experts,
        capacity_factor=config.moe_capacity_factor,
        d_model=config.d_model, d_ff=config.d_ff, params=n_params,
        active_params=active, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        init_seconds=f"{time.perf_counter() - start:.1f}")

    # one step's loss (with the aux term) and attention gradients: the
    # kernels against the plain attention path, in bf16 and in f32
    def loss_fn(params, tokens):
        logits, aux = transformer.forward(params, config, tokens[:, :-1],
                                          return_aux=True)
        return (next_token_loss(logits, tokens[:, 1:])
                + config.moe_aux_weight * aux)

    def attention_grads(tree, routes):
        """(loss, the attention weights' gradients), each layer's chosen
        experts appended to `routes`."""
        router = transformer._router

        def recording(*args):
            chosen = router(*args)
            routes.append(chosen[0])
            return chosen

        transformer._router = recording
        try:
            loss, grads = value_and_grad(loss_fn, tree, tokens)
        finally:
            transformer._router = router
        return loss.item(), {name: grads["layers"][name]["w"]
                             for name in ("wq", "wk", "wv", "wo")}

    def kernel_vs_plain(tree):
        kernel_routes, plain_routes = [], []
        kernel_loss, kernel_grads = attention_grads(tree, kernel_routes)
        kernel_attention = transformer.flash_attention
        transformer.flash_attention = plain_attention
        try:
            plain_loss, plain_grads = attention_grads(tree, plain_routes)
        finally:
            transformer.flash_attention = kernel_attention
        errors = {name: relative_error(kernel_grads[name],
                                       plain_grads[name])
                  for name in kernel_grads}
        flipped = float(np.mean([
            (a != b).float().mean().item()
            for a, b in zip(kernel_routes, plain_routes)]))
        return kernel_loss, plain_loss, errors, flipped

    def summary(errors):
        return json.dumps({key: float(f"{value:.3e}")
                           for key, value in errors.items()})

    # bf16: the two paths round each layer's attention output to bf16
    # from differently ordered sums; near-tie routes flip on those ulps,
    # and a flipped token moves every later token of both experts' queues
    # against the capacity, so the gradients part by more than the dense
    # model's (phase 6): the loss (a mean over 4,096 tokens) is held to
    # phase 6's limit, the gradients and the share of flipped routes are
    # reported
    loss_k, loss_p, errors16, flipped16 = kernel_vs_plain(params)
    if not (np.isfinite(loss_k) and abs(loss_k - loss_p)
            <= TRAIN_LOSS_ATOL):
        raise SystemExit(f"11a: bf16 loss {loss_k} (kernels) vs {loss_p} "
                         f"(plain)")
    say("11a moe_kernel_vs_plain_bf16", loss_kernel=f"{loss_k:.6f}",
        loss_plain=f"{loss_p:.6f}", grad_rel_err=summary(errors16),
        routes_flipped=f"{flipped16:.5f}", ok=True)
    # f32 (TF32 off): the kernels' f32 versions on the same path and
    # shapes, where the two paths differ by f32 summation order only and
    # no route flips: the loss and the gradients within phase 6's limits
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # the cacheless forward computes in its parameters' dtype
        params32 = tree_map(lambda leaf: leaf.detach().float(), params)
        loss_k, loss_p, errors32, flipped32 = kernel_vs_plain(params32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
        del params32
        torch.cuda.empty_cache()
    if not (np.isfinite(loss_k) and abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL
            and max(errors32.values()) <= TRAIN_GRAD_REL_TOL):
        raise SystemExit(f"11a: f32 loss {loss_k} (kernels) vs {loss_p} "
                         f"(plain), gradients {errors32}")
    say("11a moe_kernel_vs_plain_f32", loss_kernel=f"{loss_k:.6f}",
        loss_plain=f"{loss_p:.6f}", grad_rel_err=summary(errors32),
        routes_flipped=f"{flipped32:.5f}", ok=True)

    # throughput: 1 warm-up step, then M_STEPS measured steps
    optimizer = adamw(1e-4)
    opt_state = optimizer.init(params)
    train_step = make_train_step(config, optimizer)
    batches = [random_tokens() for _ in range(M_STEPS + 1)]
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
        raise SystemExit(f"11a: losses not finite: {losses}")
    for name, count in launches.items():
        if count != config.n_layers * M_STEPS:
            raise SystemExit(f"11a: {name}: {count} launches in {M_STEPS} "
                             f"steps, expected {config.n_layers} per step")
    with torch.no_grad():
        _, aux = transformer.forward(params, config, batches[-1][:, :-1],
                                     return_aux=True)
    tokens_per_s = M_STEPS * TRAIN_BATCH * TRAIN_SEQ / elapsed
    mfu = 6 * active * tokens_per_s / peaks_for(smi)[1]["bfloat16"]
    say("11a moe_training", optimizer="adamw(1e-4)", steps=M_STEPS,
        tokens_per_s=f"{tokens_per_s:.1f}",
        step_ms=f"{elapsed / M_STEPS * 1e3:.1f}",
        active_param_mfu=f"{mfu:.4f}",
        max_memory_allocated_gib=f"{peak / 2**30:.2f}",
        aux_loss=f"{aux.item():.6f}",
        launches_per_step=json.dumps({name: count / M_STEPS
                                      for name, count in launches.items()}),
        losses=json.dumps([round(value, 4) for value in losses]),
        card=repr(smi))
    profile_train_step(train_step, params, opt_state, random_tokens(), smi,
                       label="11a moe_step_profile")
    del opt_state, train_step, batches
    torch.cuda.empty_cache()
    return params, config, launches


def moe_workload(vocab: int) -> tuple:
    from aiko_services_tpu_torch.utils.padding import bucket_length
    rng = np.random.default_rng(21)
    workload = [
        (rng.integers(1, vocab, size=int(rng.integers(
            M_PROMPT[0], M_PROMPT[1] + 1))).astype(np.int32),
         int(rng.integers(M_NEW[0], M_NEW[1] + 1)))
        for _ in range(M_REQUESTS)]
    bucket = bucket_length(M_PROMPT[1], minimum=E_BLOCK)
    return workload, -(-(bucket + M_NEW[1]) // E_BLOCK) * E_BLOCK


def full_slots_step_ms(engine, steps: int = 16) -> float:
    """Median wall milliseconds of an engine step with every slot
    decoding: E_SLOTS requests admitted (one prefill a tick), then
    `steps` timed steps (each ends in the host's token readback)."""
    for index in range(E_SLOTS):
        engine.submit(("full", index), np.ones((M_PROMPT[0],), np.int32),
                      E_SLOTS + steps + 2)
    while engine.step().active < E_SLOTS:
        pass
    times = []
    for _ in range(steps):
        start = time.perf_counter()
        engine.step()
        times.append((time.perf_counter() - start) * 1e3)
    drain_engine(engine)
    return statistics.median(times)


def phase_moe_serving(params, config, smi: str) -> None:
    """11b: closed-batch generate and the decode engine on 11a's
    weights."""
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.models import generate
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(
        1, config.vocab_size, (M_GEN_ROWS, M_GEN_PROMPT)).astype(
            np.int32)).cuda()
    generate(params, config, prompt[:, :8], 2)             # warm-up
    torch.cuda.synchronize()
    start = time.perf_counter()
    out, _ = generate(params, config, prompt, M_GEN_NEW)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    if not (tuple(out.shape) == (M_GEN_ROWS, M_GEN_NEW)
            and (0 <= out).all() and (out < config.vocab_size).all()):
        raise SystemExit(f"11b: generate gave {out.shape} {out.dtype}")
    say("11b moe_generate", rows=M_GEN_ROWS, prompt=M_GEN_PROMPT,
        new_tokens=M_GEN_NEW,
        tokens_per_s=f"{M_GEN_ROWS * M_GEN_NEW / elapsed:.1f}",
        ms_per_token_step=f"{elapsed / M_GEN_NEW * 1e3:.2f}",
        card=repr(smi))
    del out

    workload, max_context = moe_workload(config.vocab_size)
    runs = {}
    for mode in ("graph", "eager"):
        engine = DecodeEngine(params, config, decode_slots=E_SLOTS,
                              kv_block_size=E_BLOCK, max_context=max_context)
        engine._graphs = mode == "graph"
        length, index = E_BLOCK, 0
        while length <= max_context - M_NEW[1]:   # one prompt per bucket
            engine.submit(("warm", index), np.ones((length,), np.int32), 2)
            length, index = length * 2, index + 1
        drain_engine(engine)
        signatures = engine.compile_count
        for index, (prompt_row, max_new) in enumerate(workload):
            engine.submit(index, prompt_row, max_new)
        torch.cuda.synchronize()
        tokens, steps = 0, 0
        start = time.perf_counter()
        done = {}
        while engine.has_work():
            for completion in engine.step().completions:
                done[completion.request_id] = completion.tokens
                tokens += completion.stats["tokens"]
            steps += 1
        elapsed = time.perf_counter() - start
        runs[mode] = {"done": done, "tokens": tokens, "elapsed": elapsed,
                      "steps": steps, "added": engine.compile_count
                      - signatures, "full_ms": full_slots_step_ms(engine),
                      "captured": bool(engine._captured)}
        if mode == "graph":
            bound_ms, bound_by, moved = decode_step_bound(engine, smi)
        del engine
    graph, eager = runs["graph"], runs["eager"]
    same = (sorted(graph["done"]) == sorted(eager["done"])
            == list(range(M_REQUESTS))
            and all(np.array_equal(graph["done"][key], eager["done"][key])
                    for key in graph["done"]))
    for key, (_, max_new) in enumerate(workload):
        tokens = graph["done"][key]
        if not (tokens.shape == (max_new,) and (0 <= tokens).all()
                and (tokens < config.vocab_size).all()):
            raise SystemExit(f"11b: request {key}: tokens {tokens}")
    full_step_ms = graph["full_ms"]
    say("11b moe_engine", requests=M_REQUESTS, slots=E_SLOTS,
        block=E_BLOCK, max_context=max_context,
        tokens_per_s=f"{graph['tokens'] / graph['elapsed']:.1f}",
        engine_steps=graph["steps"],
        full_step_ms_p50=f"{full_step_ms:.3f}",
        eager_full_step_ms_p50=f"{eager['full_ms']:.3f}",
        step_bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        step_bound_gib=f"{moved / 2**30:.3f}",
        captured=graph["captured"], captured_equals_eager=same,
        signatures_in_window=graph["added"], card=repr(smi))
    if not same or graph["added"] or not graph["captured"]:
        raise SystemExit(f"11b: captured == eager {same}, "
                         f"{graph['added']} signatures added, captured "
                         f"{graph['captured']}")


def phase_moe_f32_card_vs_cpu(smi: str) -> None:
    """11b, f32 (TF32 off), a small MoE model at three capacity factors:
    generate and the engine (captured on the card, eager on the CPU)
    token for token equal, with the gather, capacity and dense-oracle
    routes each taken."""
    from collections import Counter
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.models import (
        TransformerConfig, generate, init_params)
    from aiko_services_tpu_torch.models import transformer
    from aiko_services_tpu_torch.utils.tree import tree_map
    routes = Counter()
    original = {name: getattr(transformer, name)
                for name in ("_switch_moe", "_switch_moe_gather",
                             "_switch_moe_dense")}

    def counting(name):
        def wrapped(*args, **kwargs):
            routes[name] += 1
            return original[name](*args, **kwargs)
        return wrapped

    rng = np.random.default_rng(8)
    prompts = rng.integers(1, M_SMALL["vocab_size"], (4, 24)).astype(
        np.int32)
    requests = [(rng.integers(1, M_SMALL["vocab_size"], size=int(
        rng.integers(3, 40))).astype(np.int32), int(rng.integers(4, 16)))
        for _ in range(8)]
    previous = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in original:
        setattr(transformer, name, counting(name))
    results = {}
    try:
        for label, factor in M_FACTORS:
            config = TransformerConfig(**M_SMALL,
                                       moe_capacity_factor=factor)
            cpu = init_params(config, torch.Generator().manual_seed(5),
                              device="cpu")
            card = tree_map(lambda leaf: leaf.cuda(), cpu)
            outputs = {}
            for device, params in (("cpu", cpu), ("cuda", card)):
                tokens, _ = generate(params, config,
                                     torch.from_numpy(prompts).to(device),
                                     12)
                engine = DecodeEngine(params, config, decode_slots=3,
                                      kv_block_size=8)
                for index, (prompt, max_new) in enumerate(requests):
                    engine.submit(index, prompt, max_new)
                done, _ = drain_engine(engine)
                outputs[device] = (tokens.cpu().numpy(),
                                   [done[index].tokens
                                    for index in range(len(requests))],
                                   bool(engine._captured))
            same_generate = np.array_equal(outputs["cpu"][0],
                                           outputs["cuda"][0])
            same_engine = all(np.array_equal(a, b) for a, b in zip(
                outputs["cpu"][1], outputs["cuda"][1]))
            results[label] = (same_generate, same_engine,
                              outputs["cuda"][2])
    finally:
        for name, function in original.items():
            setattr(transformer, name, function)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = previous
    capacity = (routes["_switch_moe"] - routes["_switch_moe_gather"]
                - routes["_switch_moe_dense"])
    say("11b moe_f32_card_vs_cpu",
        identical=json.dumps({label: value[:2]
                              for label, value in results.items()}),
        captured=all(value[2] for value in results.values()),
        route_calls=json.dumps({"gather": routes["_switch_moe_gather"],
                                "capacity": capacity,
                                "oracle": routes["_switch_moe_dense"]}),
        card=repr(smi))
    if not all(all(value) for value in results.values()):
        raise SystemExit(f"11b: f32 card != CPU: {results}")
    if not (routes["_switch_moe_gather"] and capacity
            and routes["_switch_moe_dense"]):
        raise SystemExit(f"11b: a route was not taken: {routes}")


def write_yolov8n(path, seed: int = 0) -> None:
    """An ultralytics-named yolov8n state_dict from a seeded rng (torch
    (O, I, kh, kw) convolutions with separate BatchNorm tensors, the
    head's last 1x1 convolutions plain with a bias), as the tests write
    their tiny one."""
    from aiko_services_tpu_torch.models import YOLOV8N, write_safetensors
    config = YOLOV8N
    rng = np.random.default_rng(seed)
    tensors = {}

    def conv_bn(stem, c_in, c_out, k):
        tensors[f"{stem}.conv.weight"] = (rng.standard_normal(
            (c_out, c_in, k, k)).astype(np.float32)
            / np.sqrt(c_in * k * k))
        tensors[f"{stem}.bn.weight"] = rng.uniform(
            0.5, 1.5, c_out).astype(np.float32)
        tensors[f"{stem}.bn.bias"] = (
            rng.standard_normal(c_out).astype(np.float32) * 0.1)
        tensors[f"{stem}.bn.running_mean"] = (
            rng.standard_normal(c_out).astype(np.float32) * 0.1)
        tensors[f"{stem}.bn.running_var"] = rng.uniform(
            0.5, 2.0, c_out).astype(np.float32)

    def plain(stem, c_in, c_out):
        tensors[f"{stem}.weight"] = (rng.standard_normal(
            (c_out, c_in, 1, 1)).astype(np.float32) / np.sqrt(c_in))
        tensors[f"{stem}.bias"] = (
            rng.standard_normal(c_out).astype(np.float32) * 0.1)

    def c2f(module, c_in, c_out, n):
        half = c_out // 2
        conv_bn(f"model.{module}.cv1", c_in, c_out, 1)
        conv_bn(f"model.{module}.cv2", (2 + n) * half, c_out, 1)
        for i in range(n):
            conv_bn(f"model.{module}.m.{i}.cv1", half, half, 3)
            conv_bn(f"model.{module}.m.{i}.cv2", half, half, 3)

    w, r = config.width, config.repeats
    conv_bn("model.0", 3, w[0], 3)
    conv_bn("model.1", w[0], w[1], 3)
    c2f(2, w[1], w[1], r[0])
    conv_bn("model.3", w[1], w[2], 3)
    c2f(4, w[2], w[2], r[1])
    conv_bn("model.5", w[2], w[3], 3)
    c2f(6, w[3], w[3], r[2])
    conv_bn("model.7", w[3], w[4], 3)
    c2f(8, w[4], w[4], r[3])
    conv_bn("model.9.cv1", w[4], w[4] // 2, 1)
    conv_bn("model.9.cv2", w[4] * 2, w[4], 1)
    c2f(12, w[4] + w[3], w[3], 1)
    c2f(15, w[3] + w[2], w[2], 1)
    conv_bn("model.16", w[2], w[2], 3)
    c2f(18, w[3] + w[2], w[3], 1)
    conv_bn("model.19", w[3], w[3], 3)
    c2f(21, w[4] + w[3], w[4], 1)
    box_c, cls_c = config.head_box_hidden, config.head_cls_hidden
    for scale, c_in in enumerate((w[2], w[3], w[4])):
        conv_bn(f"model.22.cv2.{scale}.0", c_in, box_c, 3)
        conv_bn(f"model.22.cv2.{scale}.1", box_c, box_c, 3)
        plain(f"model.22.cv2.{scale}.2", box_c, 4 * config.reg_max)
        conv_bn(f"model.22.cv3.{scale}.0", c_in, cls_c, 3)
        conv_bn(f"model.22.cv3.{scale}.1", cls_c, cls_c, 3)
        plain(f"model.22.cv3.{scale}.2", cls_c, config.n_classes)
    write_safetensors(path, tensors)


def yolo_candidates(params, config, images) -> tuple:
    """The raw heads and the pre-NMS candidates (boxes, scores, classes)
    of yolo_detect."""
    from aiko_services_tpu_torch.models import yolo
    with torch.no_grad():
        heads = yolo.yolo_forward(params, config, images)
        decoded = [yolo._decode_scale(raw, float(stride), config)
                   for raw, stride in zip(heads, config.strides)]
    return heads, [torch.cat(parts, dim=1) for parts in zip(*decoded)]


def phase_yolo_card_vs_cpu(path, smi: str) -> None:
    """11c: the checkpoint loaded by both devices; two 640 px images."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        infer_yolov8_config, load_yolov8_params)
    from aiko_services_tpu_torch.models.detector import _nms
    images = torch.from_numpy(np.random.default_rng(4).random(
        (2, 3, 640, 640), np.float32))
    config32 = infer_yolov8_config(path, dtype="float32")
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        results = {}
        for device in ("cpu", "cuda"):
            params = load_yolov8_params(path, config32, device=device)
            results[device] = yolo_candidates(params, config32,
                                              images.to(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    (_, (cpu_boxes, cpu_scores, cpu_classes)) = results["cpu"]
    (_, (boxes, scores, classes)) = results["cuda"]
    box_err = float((boxes.cpu() - cpu_boxes).abs().max())
    score_err = float((scores.cpu() - cpu_scores).abs().max())
    class_agree = float((classes.cpu() == cpu_classes).float().mean())
    # NMS on the card's candidates, on the card and on the CPU
    kept = _nms(boxes, scores, classes, config32)
    kept_cpu = _nms(boxes.cpu(), scores.cpu(), classes.cpu(), config32)
    same_nms = all(torch.equal(a.cpu(), b) for a, b in zip(kept, kept_cpu))
    valid = int(kept[3].sum())
    # bf16: the raw heads and candidate boxes within bf16 roundings
    config16 = replace(config32, dtype="bfloat16")
    bf16 = {device: yolo_candidates(
        load_yolov8_params(path, config16, device=device), config16,
        images.to(device)) for device in ("cpu", "cuda")}
    head_err = max(relative_error(card.float(), cpu.float().cuda())
                   for card, cpu in zip(bf16["cuda"][0], bf16["cpu"][0]))
    bf16_box_err = relative_error(bf16["cuda"][1][0],
                                  bf16["cpu"][1][0].cuda())
    say("11c yolov8n_card_vs_cpu", images=2, candidates=boxes.shape[1],
        f32_box_max_err_px=f"{box_err:.3e}",
        f32_score_max_err=f"{score_err:.3e}",
        f32_class_agreement=f"{class_agree:.5f}",
        nms_card_equals_cpu=same_nms, valid=valid,
        bf16_head_rel_err=f"{head_err:.3e}",
        bf16_box_rel_err=f"{bf16_box_err:.3e}", card=repr(smi))
    if not (box_err <= 1e-3 and score_err <= 1e-5 and same_nms and valid
            and head_err <= YOLO_BF16_TOL
            and bf16_box_err <= YOLO_BF16_TOL):
        raise SystemExit("11c: yolov8n on the card differs from the CPU")


def phase_yolo_serving(path, smi: str) -> None:
    """11c: a Detector on the ultralytics checkpoint (the architecture
    read off its shapes), bf16, micro_batch 16 over 16 streams: one
    warm-up group, then Y_GROUPS measured groups."""
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    generator = torch.Generator(device="cuda").manual_seed(6)
    images = [torch.rand((1, 3, 640, 640), generator=generator,
                         device="cuda") for _ in range(Y_MICRO)]
    process = Process(transport_kind="loopback")
    try:
        pipe = create_pipeline(process, {
            "name": "yolo",
            "parameters": {"device": "cuda", "metrics_interval": 60.0},
            "graph": ["(detector)"],
            "elements": [
                {"name": "detector", "input": [{"name": "image"}],
                 "output": [{"name": "detections", "type": "dict"}],
                 "parameters": {"weights": str(path), "dtype": "bfloat16",
                                "micro_batch": Y_MICRO},
                 "deploy": {"local": {"module": MODULE,
                                      "class_name": "Detector"}}}]})
        process.run(in_thread=True)
        replies = queue.Queue()
        streams = [pipe.create_stream(f"y{index}", queue_response=replies,
                                      grace_time=600)
                   for index in range(Y_MICRO)]
        sent, latency, outputs = {}, [], []
        torch.cuda.synchronize()
        for group in range(Y_GROUPS + 1):
            if group == 1:
                torch.cuda.reset_peak_memory_stats()
                start = time.perf_counter()
            for index, stream in enumerate(streams):
                sent[stream.stream_id, group] = time.perf_counter()
                pipe.create_frame(stream, {"image": images[index]})
            for _ in streams:
                stream, frame, output = replies.get(timeout=600)
                arrived = time.perf_counter()
                if group:
                    latency.append(arrived
                                   - sent[stream.stream_id, frame.frame_id])
                outputs.append(output["detections"])
        elapsed = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated()
        config = pipe.elements["detector"].config
        summary = pipe.telemetry.summary()
    finally:
        process.terminate()
    for detections in outputs:
        if not (tuple(detections["boxes"].shape)
                == (1, config.max_detections, 4)
                and detections["boxes"].is_cuda
                and torch.isfinite(detections["boxes"]).all()
                and detections["classes"].dtype == torch.int32):
            raise SystemExit("11c: a served frame's detections are wrong")
    frames = Y_MICRO * Y_GROUPS
    say("11c yolov8n_serving", width=json.dumps(config.width),
        image=640, micro_batch=Y_MICRO, groups=Y_GROUPS, frames=frames,
        frames_per_s=f"{frames / elapsed:.1f}",
        p50_frame_latency_ms=f"{statistics.median(latency) * 1e3:.1f}",
        fused_groups=summary["fused_groups"],
        max_memory_allocated_gib=f"{peak / 2**30:.3f}", card=repr(smi))
    if summary["errors"]:
        raise SystemExit(f"11c: serving errors: {summary}")


def phase_tts(smi: str) -> None:
    """11d: TextToSpeech on the card against the CPU, seconds of audio a
    second, and make_tts_train_step's loss falling."""
    from aiko_services_tpu_torch.models import (
        TTSConfig, adam, encode_chars, init_tts_params, make_tts_train_step,
        save_pytree, synthesize)
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    from aiko_services_tpu_torch.utils.padding import bucket_length
    config = TTSConfig()
    cpu = init_tts_params(config, torch.Generator().manual_seed(0),
                          device="cpu")
    path = ROOT / "build" / "tts_smoke.safetensors"
    save_pytree(path, cpu)
    process = Process(transport_kind="loopback")
    try:
        pipe = create_pipeline(process, {
            "name": "tts",
            "parameters": {"device": "cuda", "metrics_interval": 60.0},
            "graph": ["(speak)"],
            "elements": [
                {"name": "speak", "input": [{"name": "text"}],
                 "output": [{"name": "audio"}, {"name": "sample_rate"}],
                 "parameters": {"weights": str(path)},
                 "deploy": {"local": {"module": MODULE,
                                      "class_name": "TextToSpeech"}}}]})
        process.run(in_thread=True)
        replies = queue.Queue()
        stream = pipe.create_stream("t", queue_response=replies,
                                    grace_time=600)
        audio = {}
        for rounds in range(2):                      # warm-up, measured
            torch.cuda.synchronize()
            start = time.perf_counter()
            for text in T_PROMPTS:
                pipe.create_frame(stream, {"text": text})
            for _ in T_PROMPTS:
                _, frame, outputs = replies.get(timeout=600)
                audio[frame.frame_id % len(T_PROMPTS)] = outputs["audio"]
            elapsed = time.perf_counter() - start
    finally:
        process.terminate()
    errors = []
    seconds = 0.0
    for index, text in enumerate(T_PROMPTS):
        width = bucket_length(len(text.encode()), minimum=16)
        expected = synthesize(cpu, config, torch.from_numpy(
            encode_chars(text, max_len=width)))
        waveform = audio[index]
        if not (waveform.is_cuda and waveform.shape == expected.shape):
            raise SystemExit(f"11d: waveform {waveform.shape} on "
                             f"{waveform.device}")
        errors.append(float((waveform.cpu() - expected).abs().max()))
        seconds += waveform.shape[1] / config.sample_rate
    # the train step: phoneme templates, 'a' low bands, 's' high bands
    params = init_tts_params(config, torch.Generator().manual_seed(1),
                             device="cuda")
    chars = np.concatenate([encode_chars("aaaaaaaa"),
                            encode_chars("ssssssss")])
    target = np.full((2, config.n_mels, chars.shape[1]
                      * config.frames_per_char), -6.0, np.float32)
    target[0, 4:16] = 1.5
    target[1, 60:76] = 1.5
    optimizer = adam(3e-3)
    state = optimizer.init(params)
    step = make_tts_train_step(config, optimizer)
    chars_t, target_t = (torch.from_numpy(chars).cuda(),
                         torch.from_numpy(target).cuda())
    losses = []
    torch.cuda.synchronize()
    start_train = time.perf_counter()
    for _ in range(T_TRAIN_STEPS):
        params, state, loss = step(params, state, chars_t, target_t)
        losses.append(loss.item())
    train_ms = (time.perf_counter() - start_train) / T_TRAIN_STEPS * 1e3
    say("11d tts", prompts=len(T_PROMPTS),
        max_abs_err_vs_cpu=f"{max(errors):.3e}",
        audio_seconds_per_second=f"{seconds / elapsed:.2f}",
        wall_ms_per_prompt=f"{elapsed / len(T_PROMPTS) * 1e3:.1f}",
        train_steps=T_TRAIN_STEPS, train_step_ms=f"{train_ms:.2f}",
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
        card=repr(smi))
    if max(errors) > 1e-4:
        raise SystemExit(f"11d: TTS waveforms differ from the CPU's by "
                         f"{max(errors)}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"11d: the TTS loss did not fall: {losses}")


def detector_targets(rng, batch: int, size: int, classes: int) -> tuple:
    corner = rng.uniform(0, size * 0.75, (batch, 2))
    extent = rng.uniform(size * 0.05, size * 0.25, (batch, 2))
    boxes = np.concatenate([corner, corner + extent], axis=1)
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(rng.integers(0, classes, batch).astype(
                np.int32)))


def phase_detector_training(smi: str) -> None:
    """11d: make_detector_train_step at YOLOV8N_SHAPE (640 px, bf16,
    batch 16), and one f32 step at DETECTOR_TOY, card against the CPU:
    the loss atol 1e-5 and every gradient leaf within 1e-4 of its
    largest entry (the CPU test's limits: the same products through
    eight f32 convolutions, summed in another order)."""
    from aiko_services_tpu_torch.models import (
        DETECTOR_TOY, YOLOV8N_SHAPE, adamw, init_detector_params,
        make_detector_train_step)
    from aiko_services_tpu_torch.models.optim import GradientTransformation
    from aiko_services_tpu_torch.utils.tree import tree_leaves, tree_map
    rng = np.random.default_rng(12)
    config = YOLOV8N_SHAPE
    params = init_detector_params(config, torch.Generator().manual_seed(0),
                                  device="cuda")
    optimizer = adamw(1e-3)
    state = optimizer.init(params)
    step = make_detector_train_step(config, optimizer)
    generator = torch.Generator(device="cuda").manual_seed(2)
    images = torch.rand((DT_BATCH, 3, config.image_size, config.image_size),
                        generator=generator, device="cuda")
    boxes, classes = detector_targets(rng, DT_BATCH, config.image_size,
                                      config.n_classes)
    targets = {"box": boxes.cuda(), "class": classes.cuda()}
    params, state, loss = step(params, state, images, targets)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [loss.item()]
    start = time.perf_counter()
    for _ in range(DT_STEPS):
        params, state, loss = step(params, state, images, targets)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) / DT_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = [float(value) for value in losses]
    # f32 at DETECTOR_TOY: one step's loss and gradients on both devices
    # (an optimizer whose state after the step is the gradient tree)
    toy = DETECTOR_TOY
    cpu = init_detector_params(toy, torch.Generator().manual_seed(1),
                               device="cpu")
    card = tree_map(lambda leaf: leaf.cuda(), cpu)
    toy_images = torch.from_numpy(np.random.default_rng(3).random(
        (4, 3, toy.image_size, toy.image_size), np.float32))
    toy_boxes, toy_classes = detector_targets(rng, 4, toy.image_size,
                                              toy.n_classes)
    capture = GradientTransformation(
        lambda tree: None,
        lambda grads, state, tree=None: (
            tree_map(torch.zeros_like, grads), grads))
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        toy_runs = {}
        for device, tree in (("cpu", cpu), ("cuda", card)):
            toy_step = make_detector_train_step(toy, capture)
            _, grads, toy_loss = toy_step(
                tree, None, toy_images.to(device),
                {"box": toy_boxes.to(device),
                 "class": toy_classes.to(device)})
            toy_runs[device] = (toy_loss.item(), tree_leaves(grads))
    finally:
        torch.backends.cudnn.allow_tf32 = previous
    loss_err = abs(toy_runs["cuda"][0] - toy_runs["cpu"][0])
    # each gradient leaf's largest difference over its largest entry
    grad_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                   for a, b in zip(toy_runs["cuda"][1], toy_runs["cpu"][1]))
    say("11d detector_training", image=config.image_size, batch=DT_BATCH,
        dtype=config.dtype, steps=DT_STEPS, step_ms=f"{step_ms:.1f}",
        images_per_s=f"{DT_BATCH / step_ms * 1e3:.1f}",
        max_memory_allocated_gib=f"{peak / 2**30:.3f}",
        losses=json.dumps([round(value, 4) for value in losses]),
        toy_f32_loss_err=f"{loss_err:.3e}",
        toy_f32_grad_rel_err=f"{grad_err:.3e}", card=repr(smi))
    if not np.isfinite(losses).all():
        raise SystemExit(f"11d: detector losses not finite: {losses}")
    if loss_err > 1e-5 or grad_err > 1e-4:
        raise SystemExit(f"11d: the f32 detector step on the card differs "
                         f"from the CPU's: loss {loss_err}, gradients "
                         f"{grad_err}")


def phase_model_families(smi: str) -> dict:
    """Phase 11.  Returns the kernel launches of 11a's measured steps."""
    start = time.perf_counter()
    params, config, launches = phase_moe_training(smi)
    phase_moe_serving(params, config, smi)
    del params
    torch.cuda.empty_cache()
    phase_moe_f32_card_vs_cpu(smi)
    path = ROOT / "build" / "yolov8n_smoke.safetensors"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_yolov8n(path)
    phase_yolo_card_vs_cpu(path, smi)
    phase_yolo_serving(path, smi)
    phase_tts(smi)
    phase_detector_training(smi)
    say("11 model_families", wall_s=f"{time.perf_counter() - start:.1f}",
        card=repr(smi))
    return launches


# -- phase 12: long context on the card ---------------------------------
#
# Sequence parallelism over a {"seq": 4} mesh that names cuda:0 four
# times (also {"seq": 8} in 12a): every hop launches the kernels at the
# shard's shape on the one card, and a ring "ppermute" between two shards
# on one device moves no bytes -- times here cover the kernels and the
# merges, not an interconnect.  llama32_1b at its published widths and
# full depth, bf16, seeded weights and tokens.

SP_SIZE = 4
SP_SEQ = 8192                 # 12a, 12b and 12c
SP_HEAD_CHUNK = 8             # heads per plain-reference chunk: 2 GiB of
                              # f32 scores at L 8192
SP_PROMPT, SP_NEW = 4096, 32  # 12d
SP_TRAIN_STEPS = 3            # 12c: 1 + 3 steps
# 12a holds the ring's O against the plain version and against one K1
# call by its relative error over the whole tensor: at L 8192 a typical
# |O| is about sqrt(e / L) ~ 2e-2, as large as BF16_TOL's atol, so the
# elementwise check alone would pass a hop merged with wrong weights.
# The ring rounds P and O to bf16 (2^-9 relative each) from f32 sums
# merged in another order -> the limit the gradients of one call take
RING_O_REL_TOL = GRAD_REL_TOL
# 12b holds the SP logits against the non-SP forward's only against
# gross faults (a ring hop over the wrong keys moves logits by whole
# units and the argmax of most positions): each layer rounds its
# attention output to bf16 from differently ordered f32 sums, as 8a's
# cached path does (7.35e-2 there on 16 tokens), through 16 layers
SP_LOGITS_GROSS_TOL = 1.0
SP_ARGMAX_FLOOR = 0.9
# 12e: the element and a direct forward run the same kernels on the same
# inputs, and every launch is bitwise repeatable (phase 2)
SP_ELEMENT_TOL = 1e-3
# 12d's small f32 LM, card == CPU
SP_F32 = dict(vocab_size=1024, d_model=256, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=512, max_seq_len=1024, dtype="float32")
SP_F32_PROMPT, SP_F32_NEW = 256, 16
# examples/pipeline_longcontext.json's lm widths on a data 1 x seq 4
# mesh (phase 13e runs the example's own seq x model mesh)
LONGCONTEXT = dict(vocab_size=8192, d_model=512, n_layers=8, n_heads=8,
                   n_kv_heads=4, d_ff=1536, max_seq_len=16384)
LONGCONTEXT_FRAMES, LONGCONTEXT_SEQ = 4, 8192
LEFT_PAD_PROMPT, LEFT_PAD_NEW = 1021, 16


def seq_mesh(size: int = SP_SIZE, device="cuda:0"):
    from aiko_services_tpu_torch.parallel import create_mesh
    return create_mesh({"seq": size}, devices=[device] * size)


def launch_counts() -> dict:
    from aiko_services_tpu_torch.ops import kernels
    return {name: kernels.launch_counts[name] for name in kernels.KERNELS}


def add_launches(total: dict, more: dict) -> None:
    for name, count in more.items():
        total[name] += count


def plain_attention_chunks(q, k, v, dout, causal: bool) -> list:
    """[O, dQ, dK, dV] of the plain f32 version on the whole sequence,
    SP_HEAD_CHUNK heads at a time (heads are independent)."""
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_backward_plain, flash_attention_plain)
    parts = []
    for start in range(0, q.shape[1], SP_HEAD_CHUNK):
        heads = slice(start, start + SP_HEAD_CHUNK)
        qs, ks, vs, ds = (x[:, heads].float().contiguous()
                          for x in (q, k, v, dout))
        out, lse = flash_attention_plain(qs, ks, vs, causal=causal)
        parts.append((out, *flash_attention_backward_plain(
            qs, ks, vs, out, lse, ds, causal=causal)))
    return [torch.cat(column, dim=1) for column in zip(*parts)]


def ring_pass(q, k, v, dout, size: int, causal: bool, mesh=None) -> tuple:
    """(O, [dQ, dK, dV], executed hops, launches) of ring_attention
    forward and backward on `mesh`, by default a {"seq": size} mesh over
    cuda:0."""
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import attention
    inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    hops = []
    kernels.reset_launch_counts()
    attention._RING_HOP_CALLBACK = hops.append
    try:
        out = attention.ring_attention(
            *inputs, seq_mesh(size) if mesh is None else mesh,
            causal=causal)
    finally:
        attention._RING_HOP_CALLBACK = None
    grads = torch.autograd.grad(out, inputs, dout)
    synchronize_cards([torch.cuda.current_device()] if mesh is None
                      else list(mesh.devices.flat))
    return out.detach(), grads, len(hops), launch_counts()


def phase_ring_kernels(smi: str) -> None:
    """12a: the ring at kernel level, (1, 32, 8192, 64) bf16: O against
    one K1 call on the whole sequence and against the plain version,
    dQ/dK/dV (K2/K3 per hop) against the plain gradients, executed hops
    and launches, at n = 4 (causal and not) and n = 8 (causal); then the
    ring forward + backward timed against one K1 + K2 + K3 call."""
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_backward, flash_attention_forward, ring_attention)
    q, k, v = random_qkv(1, 32, SP_SEQ, SP_SEQ, 64, torch.bfloat16,
                         seed=1200)
    dout = random_qkv(1, 32, SP_SEQ, 1, 64, torch.bfloat16, seed=1201)[0]
    for causal in (True, False):
        plain_out, *plain_grads = plain_attention_chunks(q, k, v, dout,
                                                         causal)
        single_out, single_lse = flash_attention_forward(q, k, v,
                                                         causal=causal)
        single_grads = flash_attention_backward(
            q, k, v, single_out, single_lse, dout, causal=causal)
        single_rel = {name: relative_error(got, want) for name, got, want
                      in zip(("dq", "dk", "dv"), single_grads, plain_grads)}
        del single_grads, single_lse
        for size in ((SP_SIZE, 8) if causal else (SP_SIZE,)):
            out, grads, hops, launches = ring_pass(q, k, v, dout, size,
                                                   causal)
            expected_hops = size * (size + 1) // 2 if causal else size ** 2
            if hops != expected_hops or set(launches.values()) != {
                    expected_hops}:
                raise SystemExit(f"12a: ring n={size} causal={causal} ran "
                                 f"{hops} hops, launches {launches}; "
                                 f"expected {expected_hops} each")
            rel = {name: relative_error(got, want) for name, got, want
                   in zip(("dq", "dk", "dv"), grads, plain_grads)}
            o_plain = (out.float() - plain_out).abs().max().item()
            o_k1 = (out.float() - single_out.float()).abs().max().item()
            o_rel = {"plain": relative_error(out, plain_out),
                     "one_k1": relative_error(out, single_out)}
            say("12a ring_vs_plain", shape=f"1x32x{SP_SEQ}x64",
                dtype="bfloat16", causal=causal, seq_axis=size,
                executed_hops=hops, launches=json.dumps(launches),
                o_max_abs_err_vs_plain=f"{o_plain:.3e}",
                o_rel_err_vs_plain=f"{o_rel['plain']:.3e}",
                o_max_abs_err_vs_one_k1=f"{o_k1:.3e}",
                o_rel_err_vs_one_k1=f"{o_rel['one_k1']:.3e}",
                o_rel_limit=RING_O_REL_TOL,
                grad_rel_err=json.dumps({key: float(f"{value:.3e}")
                                         for key, value in rel.items()}),
                grad_max_abs_err=json.dumps({
                    name: float(f"{(got.float() - want).abs().max():.3e}")
                    for name, got, want in zip(("dq", "dk", "dv"), grads,
                                               plain_grads)}),
                one_call_grad_rel_err=json.dumps({
                    key: float(f"{value:.3e}")
                    for key, value in single_rel.items()}),
                grad_limit=TRAIN_GRAD_REL_TOL, card=repr(smi))
            torch.testing.assert_close(out.float(), plain_out,
                                       atol=BF16_TOL, rtol=BF16_TOL)
            torch.testing.assert_close(out.float(), single_out.float(),
                                       atol=BF16_TOL, rtol=BF16_TOL)
            if max(o_rel.values()) > RING_O_REL_TOL:
                raise SystemExit(f"12a: ring n={size} causal={causal} O "
                                 f"relative errors {o_rel} exceed "
                                 f"{RING_O_REL_TOL}")
            if max(rel.values()) > TRAIN_GRAD_REL_TOL:
                raise SystemExit(f"12a: ring n={size} causal={causal} "
                                 f"gradients {rel} exceed "
                                 f"{TRAIN_GRAD_REL_TOL}")
            del out, grads
        del plain_out, plain_grads, single_out
        torch.cuda.empty_cache()

    mesh = seq_mesh()
    inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def ring_step():
        out = ring_attention(*inputs, mesh, causal=True)
        torch.autograd.grad(out, inputs, dout)

    def one_call_step():
        out, lse = flash_attention_forward(q, k, v, causal=True)
        flash_attention_backward(q, k, v, out, lse, dout, causal=True)

    ring_ms = cuda_ms(ring_step, warmup=2, runs=10)
    one_call_ms = cuda_ms(one_call_step, warmup=2, runs=10)
    say("12a ring_timing", shape=f"1x32x{SP_SEQ}x64", causal=True,
        seq_axis=SP_SIZE, ring_fwd_bwd_ms=f"{ring_ms:.4f}",
        one_k1_k2_k3_ms=f"{one_call_ms:.4f}",
        ring_over_one_call=f"{ring_ms / one_call_ms:.3f}",
        note="shards_share_one_card_no_interconnect", card=repr(smi))


def phase_sp_prefill(params, config, smi: str) -> dict:
    """12b: forward with sequence_parallel on a 1 x 8192 prompt, ring and
    then Ulysses (32 heads / 4), against the non-SP forward: logits max
    abs difference, equal-argmax share, ms and tokens/s of each."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import forward
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import use_mesh
    tokens = torch.from_numpy(np.random.default_rng(1202).integers(
        0, config.vocab_size, (1, SP_SEQ)).astype(np.int32)).cuda()
    mesh = seq_mesh()

    def timed(run_config) -> tuple:
        with use_mesh(mesh), torch.no_grad():
            logits = forward(params, run_config, tokens)
            torch.cuda.synchronize()
            seconds = []
            for _ in range(2):
                start = time.perf_counter()
                forward(params, run_config, tokens)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - start)
        return logits, statistics.median(seconds) * 1e3

    dense, dense_ms = timed(config)
    dense_argmax = dense.argmax(-1)
    say("12b prefill_non_sp", tokens=SP_SEQ, ms=f"{dense_ms:.1f}",
        tokens_per_s=f"{SP_SEQ / dense_ms * 1e3:.1f}", card=repr(smi))
    launches = {name: 0 for name in kernels.KERNELS}
    for mechanism, per_layer in (("ring", SP_SIZE * (SP_SIZE + 1) // 2),
                                 ("ulysses", SP_SIZE)):
        sp_config = replace(config, sequence_parallel=True,
                            sp_mechanism=mechanism)
        kernels.reset_launch_counts()
        logits, ms = timed(sp_config)
        counted = launch_counts()
        add_launches(launches, counted)
        if counted["flash_attention"] != 3 * config.n_layers * per_layer:
            raise SystemExit(f"12b: {mechanism} launched {counted}, "
                             f"expected {per_layer} K1 a layer a forward")
        if not (logits.shape == dense.shape
                and torch.isfinite(logits).all()):
            raise SystemExit(f"12b: {mechanism} logits "
                             f"{tuple(logits.shape)} not finite")
        error = (logits - dense).abs().max().item()
        same = (logits.argmax(-1) == dense_argmax).float().mean().item()
        say("12b prefill_sp", mechanism=mechanism, seq_axis=SP_SIZE,
            tokens=SP_SEQ, ms=f"{ms:.1f}",
            tokens_per_s=f"{SP_SEQ / ms * 1e3:.1f}",
            logits_max_abs_diff_vs_non_sp=f"{error:.3e}",
            same_argmax_share=f"{same:.4f}",
            k1_launches_per_forward=counted["flash_attention"] // 3,
            note="shards_share_one_card_no_interconnect", card=repr(smi))
        if error > SP_LOGITS_GROSS_TOL or same < SP_ARGMAX_FLOOR:
            raise SystemExit(f"12b: {mechanism} logits differ from the "
                             f"non-SP forward by {error:.3e} (argmax "
                             f"share {same:.4f})")
        del logits
    del dense
    torch.cuda.empty_cache()
    return launches


def phase_sp_generate(params, config, smi: str) -> dict:
    """12d: generate with the SP cache (ring cached prefill at pos 0,
    then sp_decode_attention over the seq-sharded cache) on a 4,096-token
    prompt, 32 new tokens, against non-SP generate; then a small f32 LM
    whose SP tokens on the card equal the CPU's."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        TransformerConfig, generate, init_params, init_sp_cache)
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import create_mesh, use_mesh
    from aiko_services_tpu_torch.utils.tree import tree_map
    prompt = torch.from_numpy(np.random.default_rng(1203).integers(
        0, config.vocab_size, (1, SP_PROMPT)).astype(np.int32)).cuda()
    sp_config = replace(config, sequence_parallel=True)
    mesh = seq_mesh()
    dense, _ = generate(params, config, prompt, SP_NEW)
    with use_mesh(mesh):
        generate(params, sp_config, prompt, 2, cache=init_sp_cache(
            sp_config, 1, SP_PROMPT + SP_SIZE, mesh, "cuda"))   # warm-up
        cache = init_sp_cache(sp_config, 1, SP_PROMPT + SP_NEW, mesh,
                              "cuda")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        tokens, cache = generate(params, sp_config, prompt, SP_NEW,
                                 cache=cache)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
    launches = launch_counts()
    if not (tokens.shape == (1, SP_NEW) and tokens.dtype == torch.int32
            and int(tokens.min()) >= 0
            and int(tokens.max()) < config.vocab_size):
        raise SystemExit(f"12d: SP tokens {tokens.tolist()}")
    if launches["flash_attention"] != config.n_layers * SP_SIZE * (
            SP_SIZE + 1) // 2:
        raise SystemExit(f"12d: the SP prefill launched {launches}")
    agree = (tokens == dense).float().mean().item()
    first_diff = next((index for index in range(SP_NEW)
                       if tokens[0, index] != dense[0, index]), None)
    # greedy decoding diverges for good after its first flip: the gap
    # between the two best logits there says whether it was a near-tie
    gap = None
    if first_diff is not None:
        gap = round(top2_gap(params, config, prompt[0].cpu().numpy(),
                             dense[0].cpu().numpy(), first_diff), 4)
    say("12d generate_sp", prompt=SP_PROMPT, new_tokens=SP_NEW,
        seq_axis=SP_SIZE, cache_len=SP_PROMPT + SP_NEW,
        tokens_per_s=f"{SP_NEW / elapsed:.1f}",
        seconds=f"{elapsed:.3f}", prefill_k1_launches=launches[
            "flash_attention"],
        token_agreement_with_non_sp=f"{agree:.4f}",
        first_differing_position=first_diff,
        non_sp_top2_logit_gap_there=gap,
        note="shards_share_one_card_no_interconnect", card=repr(smi))

    small = TransformerConfig(**SP_F32, sequence_parallel=True)
    cpu_params = init_params(small, torch.Generator().manual_seed(12),
                             device="cpu")
    small_prompt = torch.from_numpy(np.random.default_rng(1204).integers(
        0, small.vocab_size, (2, SP_F32_PROMPT)).astype(np.int32))
    cache_len = SP_F32_PROMPT + SP_F32_NEW
    cpu_mesh = create_mesh({"seq": SP_SIZE}, devices=["cpu"] * SP_SIZE)
    with use_mesh(cpu_mesh):
        expected, _ = generate(cpu_params, small, small_prompt, SP_F32_NEW,
                               cache=init_sp_cache(small, 2, cache_len,
                                                   cpu_mesh, "cpu"))
    with use_mesh(mesh):
        actual, card_cache = generate(
            tree_map(lambda leaf: leaf.cuda(), cpu_params), small,
            small_prompt.cuda(), SP_F32_NEW,
            cache=init_sp_cache(small, 2, cache_len, mesh, "cuda"))
    same = torch.equal(actual.cpu(), expected)
    say("12d generate_sp_f32_card_vs_cpu", rows=2, prompt=SP_F32_PROMPT,
        new_tokens=SP_F32_NEW, seq_axis=SP_SIZE, d_model=small.d_model,
        layers=small.n_layers, identical=same,
        cache_on_card=card_cache["k"].is_cuda)
    if not (same and card_cache["k"].is_cuda):
        raise SystemExit(f"12d: f32 SP tokens on the card "
                         f"{actual.cpu().tolist()} differ from the CPU's "
                         f"{expected.tolist()}")
    return launches


def phase_sp_training(params, config, smi: str) -> dict:
    """12c: make_train_step with sequence_parallel (the ring's backward:
    K2/K3 per hop), adamw, batch 1 x 8192, 1 + 3 steps; the first step's
    loss against the non-SP step's on the same weights and tokens."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        adamw, count_params, make_train_step)
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import use_mesh
    from aiko_services_tpu_torch.utils.tree import tree_map
    rng = np.random.default_rng(1205)
    batches = [torch.from_numpy(rng.integers(
        0, config.vocab_size, (1, SP_SEQ + 1))).cuda()
        for _ in range(SP_TRAIN_STEPS + 1)]
    n_params = count_params(params)
    dense_params = tree_map(torch.clone, params)
    optimizer = adamw(1e-4)
    dense_state = optimizer.init(dense_params)
    _, _, dense_loss = make_train_step(config, optimizer)(
        dense_params, dense_state, batches[0])
    dense_loss = dense_loss.item()
    del dense_params, dense_state
    torch.cuda.empty_cache()
    sp_config = replace(config, sequence_parallel=True)
    state = optimizer.init(params)
    train_step = make_train_step(sp_config, optimizer)
    with use_mesh(seq_mesh()):
        params, state, loss = train_step(params, state, batches[0])
        first_loss = loss.item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        losses = []
        for batch in batches[1:]:
            params, state, loss = train_step(params, state, batch)
            losses.append(loss)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        profile_train_step(train_step, params, state, batches[0], smi,
                           label="12c sp_step_profile")
    losses = [value.item() for value in losses]
    hops = SP_SIZE * (SP_SIZE + 1) // 2
    if set(launches.values()) != {config.n_layers * hops * SP_TRAIN_STEPS}:
        raise SystemExit(f"12c: {launches} in {SP_TRAIN_STEPS} steps, "
                         f"expected {hops} hops x {config.n_layers} layers "
                         f"a step for each kernel")
    tokens_per_s = SP_TRAIN_STEPS * SP_SEQ / elapsed
    mfu = 6 * n_params * tokens_per_s / peaks_for(smi)[1]["bfloat16"]
    say("12c train_sp", optimizer="adamw(1e-4)", batch=f"1x{SP_SEQ}",
        seq_axis=SP_SIZE, loss_sp=f"{first_loss:.6f}",
        loss_non_sp=f"{dense_loss:.6f}",
        loss_abs_diff=f"{abs(first_loss - dense_loss):.3e}",
        loss_limit=TRAIN_LOSS_ATOL, steps=SP_TRAIN_STEPS,
        step_ms=f"{elapsed / SP_TRAIN_STEPS * 1e3:.1f}",
        tokens_per_s=f"{tokens_per_s:.1f}", train_mfu=f"{mfu:.4f}",
        max_memory_allocated_gib=f"{peak / 2**30:.2f}",
        launches_per_step=json.dumps({name: count / SP_TRAIN_STEPS
                                      for name, count in launches.items()}),
        losses=json.dumps([round(value, 4) for value in losses]),
        note="shards_share_one_card_no_interconnect", card=repr(smi))
    if not (np.isfinite([first_loss, *losses]).all()
            and abs(first_loss - dense_loss) <= TRAIN_LOSS_ATOL):
        raise SystemExit(f"12c: SP loss {first_loss} vs non-SP "
                         f"{dense_loss}")
    del state, train_step
    torch.cuda.empty_cache()
    return launches


def longcontext_definition() -> dict:
    """(tokens (lm)) after examples/pipeline_longcontext.json, on the
    card: TokenSource -> LMForward with sequence_parallel on a data 1 x
    seq 4 mesh, the example's bucket_axes and input spec."""
    return {
        "name": "pipeline_longcontext",
        "graph": ["(tokens (lm))"],
        "parameters": {"device": "cuda"},
        "elements": [
            {"name": "tokens",
             "output": [{"name": "tokens",
                         "type": f"i32[1,{LONGCONTEXT_SEQ}]"}],
             "parameters": {"data_sources": [[1, LONGCONTEXT_SEQ]],
                            "count": LONGCONTEXT_FRAMES,
                            "vocab_size": LONGCONTEXT["vocab_size"]},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "TokenSource"}}},
            {"name": "lm",
             "input": [{"name": "tokens",
                        "type": f"i32[1,{LONGCONTEXT_SEQ}]"}],
             "output": [{"name": "logits"}, {"name": "nll"}],
             "parameters": {**LONGCONTEXT, "sequence_parallel": True,
                            "bucket_axes": {"tokens": 1},
                            "bucket_min": 32, "seed": 12},
             "sharding": {"axes": {"data": 1, "seq": SP_SIZE},
                          "inputs": {"tokens": ["data", None]}},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "LMForward"}}},
        ],
    }


def phase_sp_element(smi: str) -> dict:
    """12e: the long-context graph's 4 frames, each frame's logits and
    NLL against a direct forward on the element's weights and mesh; then
    an LMGenerate frame whose 1,021-token prompt is left-padded to a
    multiple of the seq axis, against a direct generate."""
    from aiko_services_tpu_torch.models import (
        forward, generate, init_sp_cache)
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        set_default_devices, use_mesh)
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    set_default_devices(["cuda:0"] * SP_SIZE)
    launches = {name: 0 for name in kernels.KERNELS}
    processes = []
    try:
        process = Process(transport_kind="loopback")
        processes.append(process)
        pipeline = create_pipeline(process, longcontext_definition())
        element = pipeline.elements["lm"]
        process.run(in_thread=True)
        element._ensure_ready()
        responses = queue.Queue()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        pipeline.create_stream("s1", queue_response=responses)
        frames = {}
        for _ in range(LONGCONTEXT_FRAMES):
            _, frame, outputs = responses.get(timeout=300)
            frames[frame.frame_id] = outputs
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        add_launches(launches, launch_counts())
        # the source seeds emission i with default_rng(i); each frame is
        # held against the direct forward of every emission and must
        # match one of them
        direct = []
        for index in range(LONGCONTEXT_FRAMES):
            tokens = torch.from_numpy(np.random.default_rng(index).integers(
                0, LONGCONTEXT["vocab_size"], (1, LONGCONTEXT_SEQ),
                dtype=np.int32)).cuda()
            with use_mesh(element.mesh), torch.no_grad():
                logits = forward(element.state, element.config, tokens)
                log_probs = torch.log_softmax(logits[:, :-1], dim=-1)
                nll = -torch.gather(log_probs, -1, tokens[:, 1:].long()[
                    ..., None])[..., 0].mean(-1)
            direct.append((logits, nll))
            del log_probs
        worst = 0.0
        for frame_id, outputs in sorted(frames.items()):
            got = outputs["logits"]
            if not (got.is_cuda and got.shape == direct[0][0].shape
                    and torch.isfinite(got).all()):
                raise SystemExit(f"12e: frame {frame_id} logits "
                                 f"{tuple(got.shape)} on {got.device}")
            worst = max(worst, min(
                max((got - logits).abs().max().item(),
                    (outputs["nll"] - nll).abs().max().item())
                for logits, nll in direct))
        del direct
        per_frame = launches["flash_attention"] / LONGCONTEXT_FRAMES
        say("12e longcontext_element", frames=LONGCONTEXT_FRAMES,
            tokens=LONGCONTEXT_SEQ, mesh=json.dumps(dict(
                element.mesh.shape)), d_model=LONGCONTEXT["d_model"],
            layers=LONGCONTEXT["n_layers"],
            frames_per_s=f"{LONGCONTEXT_FRAMES / elapsed:.2f}",
            tokens_per_s=f"{LONGCONTEXT_FRAMES * LONGCONTEXT_SEQ
                            / elapsed:.1f}",
            max_abs_diff_vs_direct_forward=f"{worst:.3e}",
            k1_launches_per_frame=per_frame, card=repr(smi))
        if worst > SP_ELEMENT_TOL or per_frame != LONGCONTEXT[
                "n_layers"] * SP_SIZE * (SP_SIZE + 1) // 2:
            raise SystemExit(f"12e: element vs direct forward {worst:.3e}, "
                             f"{per_frame} K1 a frame")

        process = Process(transport_kind="loopback")
        processes.append(process)
        pipeline = create_pipeline(process, {
            "name": "longcontext_generate", "graph": ["(lm)"],
            "parameters": {"device": "cuda"},
            "elements": [{
                "name": "lm", "input": [{"name": "tokens"}],
                "output": [{"name": "generated"}],
                "parameters": {**LONGCONTEXT, "sequence_parallel": True,
                               "max_new_tokens": LEFT_PAD_NEW,
                               "seed": 12},
                "sharding": {"axes": {"data": 1, "seq": SP_SIZE},
                             "inputs": {"tokens": ["data", None]}},
                "deploy": {"local": {"module": MODULE,
                                     "class_name": "LMGenerate"}}}]})
        generator = pipeline.elements["lm"]
        process.run(in_thread=True)
        prompt = np.random.default_rng(1206).integers(
            1, LONGCONTEXT["vocab_size"], (1, LEFT_PAD_PROMPT),
            dtype=np.int32)
        responses = queue.Queue()
        stream = pipeline.create_stream("s1", queue_response=responses)
        kernels.reset_launch_counts()
        pipeline.create_frame(stream, {"tokens": prompt})
        _, _, outputs = responses.get(timeout=300)
        add_launches(launches, launch_counts())
        width = -(-LEFT_PAD_PROMPT // SP_SIZE) * SP_SIZE
        padded = torch.zeros((1, width), dtype=torch.int32, device="cuda")
        padded[:, width - LEFT_PAD_PROMPT:] = torch.from_numpy(prompt)
        config = generator.config
        with use_mesh(generator.mesh):
            expected, _ = generate(generator.state, config, padded,
                                   LEFT_PAD_NEW, cache=init_sp_cache(
                                       config, 1, width + LEFT_PAD_NEW,
                                       generator.mesh, "cuda"))
        got = torch.as_tensor(outputs["generated"]).cpu()
        same = torch.equal(got, expected.cpu())
        say("12e longcontext_generate_left_pad", prompt=LEFT_PAD_PROMPT,
            padded_to=width, new_tokens=LEFT_PAD_NEW, identical=same)
        if not same:
            raise SystemExit(f"12e: LMGenerate {got.tolist()} differs "
                             f"from the direct generate on the left-padded "
                             f"prompt {expected.tolist()}")
    finally:
        set_default_devices(None)
        stop_processes(processes)
    return launches


def phase_long_context(smi: str) -> dict:
    """Phase 12.  Returns the kernel launches of its main-path runs
    (12b's SP forwards, 12c's measured steps, 12d's SP generate, 12e's
    frames); 12a's ring checks are reported on their own lines."""
    from aiko_services_tpu_torch.models import LLAMA32_1B, init_params
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    phase_ring_kernels(smi)
    params = init_params(LLAMA32_1B, torch.Generator().manual_seed(12),
                         device="cuda")
    launches = {name: 0 for name in kernels.KERNELS}
    add_launches(launches, phase_sp_prefill(params, LLAMA32_1B, smi))
    add_launches(launches, phase_sp_generate(params, LLAMA32_1B, smi))
    add_launches(launches, phase_sp_training(params, LLAMA32_1B, smi))
    del params
    torch.cuda.empty_cache()
    add_launches(launches, phase_sp_element(smi))
    if min(launches.values()) == 0:
        raise SystemExit(f"12: a kernel never launched on the long-context "
                         f"paths: {launches}")
    say("12 long_context", wall_s=f"{time.perf_counter() - start:.1f}",
        launches=json.dumps(launches), card=repr(smi))
    return launches


# -- phase 13: the parameter-sharding axes on the card ----------------------
#
# Tensor parallelism on "model", FSDP on "fsdp", data and expert
# parallelism: every mesh names cuda:0 several times (set_default_devices,
# as phase 12 does), so a collective between two shards moves no bytes
# across an interconnect and every time here is one card's.  The
# collective counter (parallel.collectives) counts what each step issues.

PIPELINE_8B = ROOT / "examples" / "pipeline_llm_8b.json"
LONGCONTEXT_JSON = ROOT / "examples" / "pipeline_longcontext.json"
SHARD_DECODE_STEPS = 16       # 13a: decode steps timed on the element
SHARD_8B_NEW_TOKENS = 64      # 13a: the example ships 128; cut to keep the
                              # run well inside its time limit
SHARD_F32_LAYERS = 2          # 13b, 13d's f32 generate: depth cut
SHARD_F32_PROMPT, SHARD_F32_NEW = 16, 16
SHARD_TRAIN_STEPS = 2         # 13c, 13d
SHARD_BF16_LAYERS = 8         # 13c's bf16 arm: depth cut to make room
                              # for phase 18 in the run's time limit
SHARD_LR = 1e-4
SHARD_MOE_PROMPT, SHARD_MOE_NEW = 16, 8
# 13d trains phase 11a's MoE at half its depth: at 8 layers the sharded
# step beside the unsharded result peaked at 75.69 of 79.18 GiB (each
# data block's dispatch buffers and f32 expert products)
SHARD_MOE_LAYERS = M_LAYERS // 2
# 13a: the sharded 8B against the unsharded one in bf16 -- each layer's
# row-parallel partial sums are rounded to bf16 before the psum (the
# unsharded product rounds once), through 32 layers; held only against
# gross faults (a missing psum or a shard of the wrong block moves the
# logits by their whole span).  Where the greedy tokens part, the
# unsharded top-2 gap there is printed beside the sharded logits'
# distance (both runs fed the unsharded tokens); the exact token check
# of each arm's weights and KV format is 13b's, in f32.
SHARD_LOGITS_GROSS_FRACTION = 0.25
# 13c/13d, bf16 at full width: the loss within phase 6a's TRAIN_LOSS_ATOL
# (16 layers of bf16 roundings taken in another order).  Each parameter's
# change over the steps, sharded against unsharded, is printed as
# ||d_sharded - d_whole|| / ||d_whole|| (its worst leaf): adamw's first
# steps move each entry by about lr times the sign of its gradient, so a
# bf16 gradient near its noise floor flips its entry's move, and the
# gate is SHARD_BF16_UPDATE_REL_TOL, below a step that skips the update
# (1) or negates it (2).
SHARD_LOSS_ATOL = TRAIN_LOSS_ATOL
SHARD_BF16_UPDATE_REL_TOL = 0.5
# 13c/13d, f32 at SHARD_F32_LAYERS layers (full width): the gradients
# each step hands the optimizer, leaf by leaf, relative to the unsharded
# step's (the same products, their partial sums added in another order:
# ~1e-6 relative, where a missing psum or a gradient off by a factor
# gives O(1)), and each parameter's change over the steps (a sign flip
# only where a gradient is within its f32 noise of zero); the loss atol
# 1e-5 (f32 sums of ~12 over 2 layers)
SHARD_F32_GRAD_REL_TOL = 1e-4
SHARD_F32_UPDATE_REL_TOL = 1e-2
SHARD_F32_LOSS_ATOL = 1e-5


def shard_mesh(axes: dict):
    from aiko_services_tpu_torch.parallel import create_mesh
    count = int(np.prod(list(axes.values())))
    return create_mesh(axes, devices=["cuda:0"] * count)


def port_definition(path: pathlib.Path) -> dict:
    """An example as shipped, with the port's runtime and element
    modules."""
    definition = json.loads(path.read_text())
    definition["runtime"] = "torch"
    for element in definition["elements"]:
        element["deploy"]["local"]["module"] = MODULE
    return definition


def unsharded(tree):
    from aiko_services_tpu_torch.parallel import unshard
    if isinstance(tree, dict):
        return {key: unsharded(value) for key, value in tree.items()}
    return unshard(tree)


def first_difference(a, b) -> int:
    """The first column where two token matrices differ, -1 if none."""
    differ = (torch.as_tensor(a).cpu() != torch.as_tensor(b).cpu()).any(0)
    return int(differ.nonzero()[0, 0]) if differ.any() else -1


def forced_step_logits(params, config, prompt, forced, steps: int) -> list:
    """The f32 logits of the first `steps` generated positions, each
    decode step fed the token `forced` holds there (so two runs see the
    same inputs): the prefill's last position, then one cached step
    each."""
    from aiko_services_tpu_torch.models import forward
    from aiko_services_tpu_torch.models import transformer
    cache = transformer._prompt_cache(params, config, prompt, steps, None)
    with torch.no_grad():
        logits, cache = forward(params, config, prompt, cache=cache)
        out = [logits[0, -1].float()]
        for step in range(1, steps):
            logits, cache = forward(params, config,
                                    forced[:, step - 1:step], cache=cache,
                                    pos=prompt.shape[1] + step - 1)
            out.append(logits[0, -1].float())
    return out


def draw_on_card(config, seed: int) -> dict:
    """init_params' tree and distributions drawn on the card from a CUDA
    generator seeded with `seed`: the embedding N(0, 0.02^2), each dense
    weight N(0, 1/in_features) a layer at a time in f32 and cast, the
    norm scales 1.  Not init_params' numbers (it draws on the host, which
    took about 82 s for the 8B); 13a holds the sharded run against the
    unsharded one on this same draw."""
    from aiko_services_tpu_torch.models import init_params
    generator = torch.Generator(device="cuda").manual_seed(seed)

    def draw(node, path):
        if isinstance(node, dict):
            return {key: draw(value, path + (key,))
                    for key, value in node.items()}
        out = torch.empty(node.shape, dtype=node.dtype, device="cuda")
        if path[-1] == "scale":
            return out.fill_(1.0)
        scale = 0.02 if path[0] == "embed" else 1.0 / math.sqrt(
            node.shape[-2])
        for block in out.view(-1, *node.shape[-2:]):
            block.copy_(torch.randn(block.shape, generator=generator,
                                    device="cuda") * scale)
        return out

    with torch.device("meta"):  # init_dense draws on the host otherwise
        shapes = init_params(config, torch.Generator(), device="meta")
    return draw(shapes, ())


def phase_8b_arm(smi: str, axes: dict, whole=None) -> tuple:
    """One arm of 13a: the 8B example's pipeline on `axes`, then its
    element's decode steps timed and counted, and the sharded logits and
    greedy tokens against the unsharded 8B.  The first arm's weights are
    drawn on the card (draw_on_card, seed 0) and installed through the
    element's restore_state; with `whole` (the first arm's weights,
    unsharded), the arm serves them as int8 weights and KV instead.
    Returns (the pipeline run's kernel launches, the weights unsharded)."""
    quantized = whole is not None
    from aiko_services_tpu_torch.models import (
        forward, generate, quantize_weights_int8)
    from aiko_services_tpu_torch.models import transformer
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        collective_totals, reset_collective_counts, set_default_devices)
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    label = "13a llama3_8b_int8" if quantized else "13a llama3_8b"
    definition = port_definition(PIPELINE_8B)
    lm = next(element for element in definition["elements"]
              if element["name"] == "lm")
    count = int(np.prod(list(axes.values())))
    lm["sharding"]["axes"] = axes
    lm["sharding"]["devices"] = [0, count]
    if quantized:
        lm["parameters"].update(weight_dtype="int8", kv_dtype="int8")
    prompt_text = definition["elements"][0]["parameters"][
        "data_sources"][0]
    lm["parameters"]["max_new_tokens"] = max_new = SHARD_8B_NEW_TOKENS
    set_default_devices(["cuda:0"] * count)
    process = Process(transport_kind="loopback")
    try:
        start = time.perf_counter()
        pipeline = create_pipeline(process, definition)
        element = pipeline.elements["lm"]
        element.configure()
        if quantized:
            element.restore_state(quantize_weights_int8(whole,
                                                        element.config))
            del whole
        else:
            element.restore_state(draw_on_card(
                element.config, int(lm["parameters"].get("seed", 0))))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - start
        process.run(in_thread=True)
        torch.cuda.reset_peak_memory_stats()
        responses = queue.Queue()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        pipeline.create_stream("s1", queue_response=responses)
        _, _, outputs = responses.get(timeout=600)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        generated = torch.as_tensor(outputs["generated"]).cpu()
        if generated.shape != (1, max_new) or not outputs["text"]:
            raise SystemExit(f"{label}: generated {tuple(generated.shape)}"
                             f", text {outputs['text']!r}")
        config, state = element.config, element.state
        tokens = torch.from_numpy(element._encode_prompts(
            None, prompt_text)[0]).cuda()
        # decode steps on the element's sharded state: ms and collectives
        cache = transformer._prompt_cache(state, config, tokens,
                                          SHARD_DECODE_STEPS + 1, None)
        with torch.no_grad():
            logits, cache = forward(state, config, tokens, cache=cache)
        token = logits[:, -1:].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        reset_collective_counts()
        start = time.perf_counter()
        for step in range(SHARD_DECODE_STEPS):
            token, _, cache = transformer.decode_step(
                state, config, cache, token, tokens.shape[1] + step)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - start) / SHARD_DECODE_STEPS * 1e3
        calls, size = collective_totals()
        del cache
        # the unsharded 8B on the same weights
        whole = unsharded(state)
        with torch.no_grad():
            sharded_last = forward(state, config, tokens)[0, -1]
            whole_last = forward(whole, config, tokens)[0, -1]
        reference, _ = generate(whole, config, tokens, max_new)
        parting = first_difference(generated, reference)
        parting_fields = {}
        if parting >= 0:
            ours = forced_step_logits(state, config, tokens, reference,
                                      parting + 1)
            theirs = forced_step_logits(whole, config, tokens, reference,
                                        parting + 1)
            top = torch.topk(theirs[parting], 2).values
            distance = (ours[parting] - theirs[parting]).abs().max()
            parting_fields = dict(
                parting_logits_max_abs_diff=f"{distance.item():.3e}",
                parting_unsharded_top2_gap=f"{(top[0] - top[1]).item():.3e}")
        torch.cuda.empty_cache()
    finally:
        process.terminate()
        set_default_devices(None)
    diff = (sharded_last - whole_last).abs().max().item()
    span = whole_last.abs().max().item()
    fields = dict(
        mesh=json.dumps(axes), weights="int8" if quantized else config.dtype,
        kv=config.kv_dtype or config.dtype, layers=config.n_layers,
        d_model=config.d_model,
        heads=f"{config.n_heads}/{config.n_kv_heads}",
        vocab=config.vocab_size, prompt_tokens=tokens.shape[1],
        new_tokens=max_new, setup_s=f"{setup_s:.1f}",
        tokens_per_s=f"{max_new / elapsed:.2f}",
        decode_step_ms=f"{step_ms:.2f}",
        collective_calls_per_step=calls / SHARD_DECODE_STEPS,
        collective_kib_per_step=f"{size / SHARD_DECODE_STEPS / 1024:.1f}",
        max_memory_allocated_gib=f"{peak / 2**30:.2f}",
        last_logits_max_abs_diff_vs_unsharded=f"{diff:.3e}",
        logits_span=f"{span:.3e}",
        greedy_first_difference=parting, **parting_fields,
        card=repr(smi))
    say(label, **fields)
    if not np.isfinite(diff) or diff > SHARD_LOGITS_GROSS_FRACTION * span:
        raise SystemExit(f"{label}: sharded logits differ from the "
                         f"unsharded 8B by {diff} (span {span})")
    return launches, whole


def phase_8b_f32(smi: str) -> None:
    """13b: f32 at the 8B widths, 2 layers: the sharded and unsharded
    generate give identical tokens, with f32 weights and KV on fsdp 2 x
    model 4 (13a's first arm) and with int8 weights and int8 KV on fsdp 2
    x model 2 (its second)."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        LLAMA3_8B, generate, init_params, param_specs,
        quantize_weights_int8, quantized_param_specs)
    from aiko_services_tpu_torch.parallel import (
        collective_totals, filter_specs, reset_collective_counts,
        shard_pytree)
    for quantized, axes in ((False, {"fsdp": 2, "model": 4}),
                            (True, {"fsdp": 2, "model": 2})):
        config = replace(LLAMA3_8B, n_layers=SHARD_F32_LAYERS,
                         dtype="float32", kv_dtype="int8" if quantized
                         else "")
        params = init_params(config, torch.Generator().manual_seed(13),
                             device="cuda")
        specs = param_specs
        if quantized:
            params = quantize_weights_int8(params, config)
            specs = quantized_param_specs
        mesh = shard_mesh(axes)
        sharded = shard_pytree(params, mesh, filter_specs(
            specs(config, lm_head="lm_head" in params), mesh))
        prompt = torch.from_numpy(np.random.default_rng(13).integers(
            1, config.vocab_size, (2, SHARD_F32_PROMPT),
            dtype=np.int32)).cuda()
        expected, _ = generate(params, config, prompt, SHARD_F32_NEW)
        reset_collective_counts()
        got, _ = generate(sharded, config, prompt, SHARD_F32_NEW)
        calls, size = collective_totals()
        del params, sharded
        torch.cuda.empty_cache()
        same = torch.equal(got.cpu(), expected.cpu())
        label = ("13b llama3_8b_widths_f32_int8" if quantized
                 else "13b llama3_8b_widths_f32")
        say(label, layers=config.n_layers, mesh=json.dumps(axes),
            weights="int8" if quantized else "float32",
            kv=config.kv_dtype or "float32", prompt=SHARD_F32_PROMPT,
            new_tokens=SHARD_F32_NEW, identical=same,
            collective_calls=calls, collective_mib=f"{size / 2**20:.2f}",
            card=repr(smi))
        if not same:
            raise SystemExit(f"{label}: sharded f32 tokens {got.tolist()} "
                             f"differ from the unsharded "
                             f"{expected.tolist()}")


def leaf_items(tree, prefix: str = ""):
    """(path, leaf) of a nested dict, in order."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from leaf_items(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def worst_relative(got_tree, want_tree, base_tree=None) -> tuple:
    """(the worst leaf, its ||got - want|| / ||want||) over the leaves of
    two trees (Sharded leaves unsharded); with `base_tree`, of the changes
    got - base against want - base."""
    from aiko_services_tpu_torch.parallel import unshard
    worst = ("", 0.0)
    wants = dict(leaf_items(want_tree))
    bases = dict(leaf_items(base_tree)) if base_tree is not None else {}
    for name, leaf in leaf_items(got_tree):
        got = unshard(leaf).float()
        want = wants[name].to(got.device).float()
        if name in bases:
            base = bases[name].to(got.device).float()
            got, want = got - base, want - base
        scale = want.norm().item()
        error = ((got - want).norm().item() / scale if scale
                 else 0.0 if not got.any() else float("inf"))
        if not error <= worst[1]:
            worst = (name, error)
    return worst


def recording(optimizer, record):
    """`optimizer`, calling record(step, grads) with the gradients each
    train step hands it, before it updates."""
    from aiko_services_tpu_torch.models.optim import GradientTransformation
    steps = iter(range(1 << 30))

    def update(grads, state, params=None):
        record(next(steps), grads)
        return optimizer.update(grads, state, params)
    return GradientTransformation(optimizer.init, update)


def sharded_vs_whole_training(smi: str, label: str, config, axes: dict,
                              steps: int, seed: int) -> dict:
    """A sharded train step on `axes` against the unsharded one on the
    same weights and batches: losses, each parameter's change over the
    steps, step ms, tokens/s, MFU and K1/K2/K3 launches a step.  An f32
    config also holds each step's gradients, leaf by leaf, against the
    unsharded step's."""
    from aiko_services_tpu_torch.models import (
        adamw, count_params, make_train_step, param_specs)
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        collective_totals, filter_specs, reset_collective_counts,
        shard_pytree, sharded_leaves)
    f32 = config.dtype == "float32"
    rng = np.random.default_rng(seed)
    batches = [torch.from_numpy(rng.integers(
        0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
        for _ in range(steps)]
    params = draw_on_card(config, seed)
    n_params = count_params(params)
    mesh = shard_mesh(axes)
    sharded = copy_replicated(shard_pytree(
        params, mesh, filter_specs(param_specs(config), mesh)))
    before = tree_to(params, "cpu")
    whole_grads = []
    optimizer = recording(adamw(SHARD_LR), lambda step, grads: (
        whole_grads.append(tree_to(grads, "cpu")) if f32 else None))
    state = optimizer.init(params)
    step = make_train_step(config, optimizer)
    whole_losses = []
    for batch in batches:
        params, state, loss = step(params, state, batch)
        whole_losses.append(loss.item())
    # the unsharded result waits on the host while the sharded tree trains
    del state, step
    params = tree_to(params, "cpu")
    torch.cuda.empty_cache()
    grad_errors = []
    optimizer = recording(adamw(SHARD_LR), lambda step, grads: (
        grad_errors.append(worst_relative(grads, whole_grads[step]))
        if f32 else None))
    state = optimizer.init(sharded)
    step = make_train_step(config, optimizer, sharded=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    reset_collective_counts()
    losses, times = [], []
    for batch in batches:
        start = time.perf_counter()
        sharded, state, loss = step(sharded, state, batch)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    launches = launch_counts()
    calls, size = collective_totals()
    peak = torch.cuda.max_memory_allocated()
    update_leaf, update_error = worst_relative(sharded, params, before)
    # on one card the data replicas of a block are one tensor (they share
    # a device), so this holds by construction; the sum of the data
    # blocks' gradients is held by the f32 gradient check
    replicas_one_tensor = all(
        len({leaf.block(position) for position in np.ndindex(
            leaf.shards.shape)}) == len(leaf.unique())
        for leaf in sharded_leaves(sharded))
    del sharded, state, step, params, before, whole_grads
    torch.cuda.empty_cache()
    loss_diff = max(abs(a - b) for a, b in zip(losses, whole_losses))
    step_s = statistics.median(times)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    mfu = 6 * n_params * tokens_per_s / peaks_for(smi)[1][config.dtype]
    grad_leaf, grad_error = max(grad_errors, key=lambda item: item[1],
                                default=("", 0.0))
    say(label, mesh=json.dumps(axes), dtype=config.dtype,
        layers=config.n_layers, experts=config.n_experts, steps=steps,
        losses=json.dumps([round(value, 6) for value in losses]),
        unsharded_losses=json.dumps([round(value, 6)
                                     for value in whole_losses]),
        loss_max_abs_diff=f"{loss_diff:.3e}",
        update_rel_err=f"{update_error:.3e}", update_worst_leaf=update_leaf,
        data_replicas_one_tensor=replicas_one_tensor,
        **(dict(grad_rel_err=f"{grad_error:.3e}", grad_worst_leaf=grad_leaf)
           if f32 else {}),
        step_ms=f"{step_s * 1e3:.1f}", tokens_per_s=f"{tokens_per_s:.1f}",
        train_mfu=f"{mfu:.4f}",
        launches_per_step=json.dumps({name: count / steps for name, count
                                      in launches.items()}),
        collective_calls_per_step=calls / steps,
        collective_mib_per_step=f"{size / steps / 2**20:.1f}",
        max_memory_allocated_gib=f"{peak / 2**30:.2f}", card=repr(smi))
    limits = ((SHARD_F32_LOSS_ATOL, SHARD_F32_UPDATE_REL_TOL) if f32
              else (SHARD_LOSS_ATOL, SHARD_BF16_UPDATE_REL_TOL))
    if not (np.isfinite(losses).all() and loss_diff <= limits[0]
            and update_error <= limits[1]
            and grad_error <= SHARD_F32_GRAD_REL_TOL):
        raise SystemExit(f"{label}: losses {losses} vs unsharded "
                         f"{whole_losses} (limit {limits[0]}); parameter "
                         f"change {update_error:.3e} relative at "
                         f"{update_leaf} (limit {limits[1]}); gradient "
                         f"{grad_error:.3e} relative at {grad_leaf} (limit "
                         f"{SHARD_F32_GRAD_REL_TOL})")
    return launches


def tree_to(tree, device):
    """A copy of a tree of tensors on `device`."""
    if isinstance(tree, dict):
        return {key: tree_to(value, device) for key, value in tree.items()}
    return tree.detach().to(device, copy=True)


def copy_replicated(tree):
    """The tree with every whole (replicated) leaf cloned: shard_pytree
    hands back a replicated leaf that already lies on the mesh's home
    device as the very tensor it was given."""
    from aiko_services_tpu_torch.parallel import Sharded
    if isinstance(tree, dict):
        return {key: copy_replicated(value) for key, value in tree.items()}
    return tree if isinstance(tree, Sharded) else tree.clone()


def phase_sharded_training(smi: str) -> dict:
    """13c: llama32_1b at full width on data 2 x fsdp 2 x model 2, in
    bf16 (depth cut to SHARD_BF16_LAYERS) and in f32 (depth cut to
    SHARD_F32_LAYERS)."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import LLAMA32_1B
    axes = {"data": 2, "fsdp": 2, "model": 2}
    launches = {}
    for config in (replace(LLAMA32_1B, n_layers=SHARD_BF16_LAYERS),
                   replace(LLAMA32_1B, n_layers=SHARD_F32_LAYERS,
                           dtype="float32")):
        arm = sharded_vs_whole_training(
            smi, f"13c llama32_1b_sharded_train_step_{config.dtype}",
            config, axes, SHARD_TRAIN_STEPS, 13)
        expected = config.n_layers * 2 * 2 * SHARD_TRAIN_STEPS
        if any(count != expected for count in arm.values()):
            raise SystemExit(f"13c: launches {arm} in {SHARD_TRAIN_STEPS} "
                             f"steps, expected {expected} of each (layers "
                             f"x data x model)")
        for name, count in arm.items():
            launches[name] = launches.get(name, 0) + count
    return launches


def phase_expert_parallel(smi: str) -> dict:
    """13d: phase 11a's MoE on data 2 x expert 2 x model 2: train steps
    against the unsharded steps in bf16 and (depth cut to
    SHARD_F32_LAYERS) in f32, then f32 generate token for token equal to
    the unsharded one."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        LLAMA32_1B, generate, init_params, param_specs)
    from aiko_services_tpu_torch.parallel import filter_specs, shard_pytree
    axes = {"data": 2, "expert": 2, "model": 2}
    config = replace(LLAMA32_1B, n_layers=SHARD_MOE_LAYERS,
                     n_experts=M_EXPERTS)
    f32 = replace(config, n_layers=SHARD_F32_LAYERS, dtype="float32")
    launches = {}
    for arm in (config, f32):
        for name, count in sharded_vs_whole_training(
                smi, f"13d moe_expert_parallel_train_step_{arm.dtype}",
                arm, axes, SHARD_TRAIN_STEPS, 14).items():
            launches[name] = launches.get(name, 0) + count
    params = init_params(f32, torch.Generator().manual_seed(15),
                         device="cuda")
    mesh = shard_mesh(axes)
    sharded = shard_pytree(params, mesh, filter_specs(param_specs(f32),
                                                      mesh))
    prompt = torch.from_numpy(np.random.default_rng(15).integers(
        1, f32.vocab_size, (4, SHARD_MOE_PROMPT), dtype=np.int32)).cuda()
    expected, _ = generate(params, f32, prompt, SHARD_MOE_NEW)
    got, _ = generate(sharded, f32, prompt, SHARD_MOE_NEW)
    del params, sharded
    torch.cuda.empty_cache()
    same = torch.equal(got.cpu(), expected.cpu())
    say("13d moe_expert_parallel_generate_f32", mesh=json.dumps(axes),
        layers=f32.n_layers, experts=f32.n_experts,
        new_tokens=SHARD_MOE_NEW, identical=same, card=repr(smi))
    if not same:
        raise SystemExit(f"13d: sharded MoE tokens {got.tolist()} differ "
                         f"from the unsharded {expected.tolist()}")
    return launches


def phase_longcontext_as_shipped(smi: str) -> dict:
    """13e: examples/pipeline_longcontext.json as shipped, data 1 x seq 4
    x model 2: each frame's logits and NLL against a direct unsharded
    forward on the element's weights."""
    from aiko_services_tpu_torch.models import forward
    from aiko_services_tpu_torch.parallel import (
        reset_collective_counts, collective_counts, set_default_devices)
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    definition = port_definition(LONGCONTEXT_JSON)
    source, lm = definition["elements"]
    axes = lm["sharding"]["axes"]
    count = int(np.prod(list(axes.values())))
    frames_wanted = int(source["parameters"]["count"])
    length = int(source["parameters"]["data_sources"][0][1])
    # TokenSource draws emission i from default_rng(seed + i) over its
    # vocab_size (8192 unless the definition sets one)
    vocab = int(source["parameters"].get("vocab_size", 8192))
    set_default_devices(["cuda:0"] * count)
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        element = pipeline.elements["lm"]
        process.run(in_thread=True)
        element._ensure_ready()
        responses = queue.Queue()
        torch.cuda.synchronize()
        from aiko_services_tpu_torch.ops import kernels
        kernels.reset_launch_counts()
        reset_collective_counts()
        start = time.perf_counter()
        pipeline.create_stream("s1", queue_response=responses)
        frames = {}
        for _ in range(frames_wanted):
            _, frame, outputs = responses.get(timeout=600)
            frames[frame.frame_id] = outputs
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = launch_counts()
        collectives = collective_counts()
        whole = unsharded(element.state)
        config = element.config
        from dataclasses import replace
        dense = replace(config, sequence_parallel=False)
        worst = 0.0
        for index in range(frames_wanted):
            tokens = torch.from_numpy(np.random.default_rng(index).integers(
                0, vocab, (1, length), dtype=np.int32)).cuda()
            with torch.no_grad():
                logits = forward(whole, dense, tokens)
                log_probs = torch.log_softmax(logits[:, :-1], dim=-1)
                nll = -torch.gather(log_probs, -1, tokens[:, 1:].long()[
                    ..., None])[..., 0].mean(-1)
            worst_frame = min(
                max((outputs["logits"] - logits).abs().max().item(),
                    (outputs["nll"] - nll).abs().max().item())
                for outputs in frames.values())
            worst = max(worst, worst_frame)
            del logits, log_probs
        del whole
        torch.cuda.empty_cache()
    finally:
        process.terminate()
        set_default_devices(None)
    per_frame = launches["flash_attention"] / frames_wanted
    expected_k1 = (config.n_layers * axes["model"]
                   * axes["seq"] * (axes["seq"] + 1) // 2)
    say("13e longcontext_as_shipped", mesh=json.dumps(axes),
        frames=frames_wanted, tokens=length,
        frames_per_s=f"{frames_wanted / elapsed:.2f}",
        max_abs_diff_vs_unsharded_forward=f"{worst:.3e}",
        k1_launches_per_frame=per_frame,
        collectives=json.dumps(collectives), card=repr(smi))
    if worst > SHARD_LONGCONTEXT_TOL or per_frame != expected_k1:
        raise SystemExit(f"13e: element vs unsharded forward {worst:.3e}, "
                         f"{per_frame} K1 a frame (expected "
                         f"{expected_k1})")
    return launches


# 13e: the ring over each model shard's heads against the unsharded
# dense forward in bf16: different kernels on the same inputs (the ring's
# merged partials against one K1 call) and the row-parallel partial sums
# rounded to bf16 before the psum, through 8 layers -- phase 12b's gross
# bound on the logits
SHARD_LONGCONTEXT_TOL = SP_LOGITS_GROSS_TOL


def sharded_speech(smi: str, label: str, axes: dict,
                   max_tokens: int = 16) -> tuple:
    """SpeechToText whisper_small (f32, so the tokens are exact) on
    `axes` with its default asr_param_specs, against the element without
    a mesh on the same 2 frames.  Returns (the sharded run's K1
    launches, the sharded element)."""
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import set_default_devices
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process

    def serve(sharding):
        element = {"name": "asr", "input": [{"name": "audio"}],
                   "output": [{"name": "tokens"}],
                   "parameters": {"preset": "whisper_small",
                                  "dtype": "float32", "max_frames": 500,
                                  "max_tokens": max_tokens, "seed": 16},
                   "deploy": {"local": {"module": MODULE,
                                        "class_name": "SpeechToText"}}}
        if sharding:
            element["sharding"] = sharding
        process = Process(transport_kind="loopback")
        try:
            pipeline = create_pipeline(process, {
                "name": "asr13", "graph": ["(asr)"],
                "parameters": {"device": "cuda"}, "elements": [element]})
            process.run(in_thread=True)
            pipeline.elements["asr"]._ensure_ready()
            responses = queue.Queue()
            stream = pipeline.create_stream("s1", queue_response=responses)
            kernels.reset_launch_counts()
            rng = np.random.default_rng(16)
            for _ in range(2):
                pipeline.create_frame(stream, {"audio": rng.standard_normal(
                    (2, SAMPLE_RATE * 5)).astype(np.float32) * 0.1})
            out = {}
            for _ in range(2):
                _, frame, outputs = responses.get(timeout=300)
                out[frame.frame_id] = outputs["tokens"].cpu()
            torch.cuda.synchronize()
            return out, launch_counts(), pipeline.elements["asr"]
        finally:
            process.terminate()

    count = int(np.prod(list(axes.values())))
    set_default_devices(["cuda:0"] * count)
    try:
        sharded, launches, element = serve({"axes": axes})
        cut = type(element.state["enc_layers"]["attn"]["wq"]["w"]).__name__
    finally:
        set_default_devices(None)
    whole, _, _ = serve(None)
    torch.cuda.empty_cache()
    same = all(torch.equal(sharded[key], whole[key]) for key in whole)
    say(label, mesh=json.dumps(axes), dtype="float32", frames=2,
        max_tokens=max_tokens, wq=cut, identical=same,
        k1_launches=launches["flash_attention"], card=repr(smi))
    if not same or cut != "Sharded":
        raise SystemExit(f"{label}: sharded tokens {sharded} differ from "
                         f"the unsharded element's {whole} (wq {cut})")
    return launches["flash_attention"], element


def phase_sharded_speech(smi: str) -> int:
    """13f: whisper_small on {"model": 2}.  Returns the sharded run's K1
    launches."""
    launches, _ = sharded_speech(smi, "13f whisper_small_model_parallel",
                                 {"model": 2})
    return launches


@contextlib.contextmanager
def recorded_kernel_cases(forward: set, backward: set,
                          threads: dict | None = None):
    """Within the block, every K1 launch adds its case (B, H, Lq, Lk, D,
    dtype, causal, q_offset, sm_scale) to `forward`, and every K2/K3 pair
    its case to `backward`; with `threads`, every K1 launch also adds one
    to the count of the thread it launched on (by thread name).  The
    record is taken at the module names every path reaches the kernels
    through, and the wrappers (and their launch counts) stay as they
    are."""
    from aiko_services_tpu_torch.parallel import attention
    forward_kernel = attention.flash_attention_forward
    backward_kernel = attention.flash_attention_backward

    def case(q, k, causal, sm_scale, q_offset):
        if sm_scale is None:
            sm_scale = 1.0 / math.sqrt(q.shape[-1])
        return (*q.shape[:3], k.shape[2], q.shape[3], q.dtype, bool(causal),
                int(q_offset), float(sm_scale))

    def forward_recorded(q, k, v, causal=False, sm_scale=None, q_offset=0):
        if q.device.type == "cuda":
            forward.add(case(q, k, causal, sm_scale, q_offset))
            if threads is not None:
                name = threading.current_thread().name
                threads[name] = threads.get(name, 0) + 1
        return forward_kernel(q, k, v, causal=causal, sm_scale=sm_scale,
                              q_offset=q_offset)

    def backward_recorded(q, k, v, out, lse, dout, causal=False,
                          sm_scale=None, q_offset=0):
        if q.device.type == "cuda":
            backward.add(case(q, k, causal, sm_scale, q_offset))
        return backward_kernel(q, k, v, out, lse, dout, causal=causal,
                               sm_scale=sm_scale, q_offset=q_offset)

    attention.flash_attention_forward = forward_recorded
    attention.flash_attention_backward = backward_recorded
    try:
        yield
    finally:
        attention.flash_attention_forward = forward_kernel
        attention.flash_attention_backward = backward_kernel


def phase_shard_kernel_checks(forward: set, backward: set) -> None:
    """13g: K1, and K2 with K3, at every case phase 13 launched them with
    (the per-shard shapes, in f32 and bf16) that phase 2 did not check,
    against the plain versions at phase 2's limits."""
    def checked(cases):
        return {(*spec, 1.0 / math.sqrt(spec[4])) for spec in cases}
    new_forward = sorted(forward - checked(KERNEL_CASES.values()), key=str)
    new_backward = sorted(backward - checked(BACKWARD_CASES.values()),
                          key=str)
    if not new_forward or not new_backward:
        raise SystemExit(f"13g: phase 13 launched no new K1 ({forward}) "
                         f"or K2/K3 ({backward}) case")
    for index, spec in enumerate(new_forward):
        check_forward_case(f"13_{index}", spec, 1300 + index,
                           "13g kernel_vs_plain")
    for index, spec in enumerate(new_backward):
        check_backward_case(f"13_{index}", spec, 1400 + index,
                            "13g backward_vs_plain")
    say("13g shard_kernel_checks", k1_cases=len(new_forward),
        k2_k3_cases=len(new_backward), ok=True)


def phase_parameter_sharding(smi: str) -> dict:
    """Phase 13.  Returns the kernel launches of its main-path runs."""
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    launches = {name: 0 for name in kernels.KERNELS}
    forward, backward = set(), set()
    with recorded_kernel_cases(forward, backward):
        served, whole = phase_8b_arm(smi, {"data": 1, "fsdp": 2, "seq": 1,
                                           "model": 4})
        add_launches(launches, served)
        served, whole = phase_8b_arm(smi, {"data": 1, "fsdp": 2, "seq": 1,
                                           "model": 2}, whole)
        add_launches(launches, served)
        del whole
        torch.cuda.empty_cache()
        phase_8b_f32(smi)
        add_launches(launches, phase_sharded_training(smi))
        add_launches(launches, phase_expert_parallel(smi))
        add_launches(launches, phase_longcontext_as_shipped(smi))
        launches["flash_attention"] += phase_sharded_speech(smi)
    if min(launches.values()) == 0:
        raise SystemExit(f"13: a kernel never launched on the sharded "
                         f"paths: {launches}")
    phase_shard_kernel_checks(forward, backward)
    say("13 parameter_sharding", wall_s=f"{time.perf_counter() - start:.1f}",
        launches=json.dumps(launches), card=repr(smi))
    return launches


# -- phase 14: HF checkpoints, the shipped examples, the eval pass ------------
#
# Phase 8's config-5 weights (whisper_small and llama32_1b, bf16, seeded)
# are written as HuggingFace-named safetensors files (the name maps of
# models/weights.py inverted: a helper here, not a feature of the
# package) and served from them; the repaired sharding departures run on
# meshes that name cuda:0 several times; three shipped examples run as
# shipped with runtime "torch"; the analyzer's eval pass traces config 5
# on the meta device.

HF_DIR = ROOT / "build" / "hf"
HF_PROMPT = 16                # 14b/14c: config 5's asr tokens per row
HF_F32_LAYERS, HF_F32_NEW = 2, 16
STRADDLE_AXES = {"model": 8}  # 14d: whisper_small's 12 heads over 8
RESHARD_AXES = {"fsdp": 2, "model": 2}
EXAMPLE_FRAMES = 2


def leaf_at(tree: dict, parts) -> torch.Tensor:
    for part in parts:
        tree = tree[part]
    return tree


def write_hf(path, tensors: dict, layer_maps: list) -> None:
    """`tensors` (HF name -> host tensor) plus every layer of
    `layer_maps` ([(stacked tree, [{HF name: (path, transpose?)}] per
    layer)]), each (in, out) weight transposed back to HF's (out, in)."""
    from aiko_services_tpu_torch.models import write_safetensors
    tensors = dict(tensors)
    for stacked, maps in layer_maps:
        for layer, mapping in enumerate(maps):
            for name, (parts, transpose) in mapping.items():
                tensor = leaf_at(stacked, parts)[layer]
                tensors[name] = (tensor.T if transpose else tensor
                                 ).contiguous()
    write_safetensors(path, tensors)


def hf_whisper_tree(config, params) -> dict:
    """`params` with every leaf the HF whisper naming holds: a layer
    norm's bias, and the q/v/out and fc biases, which this framework's
    seeded init leaves out, as zeros (the same function)."""
    from aiko_services_tpu_torch.models import whisper_layer_map
    from aiko_services_tpu_torch.utils.tree import tree_map
    tree = tree_map(lambda leaf: leaf, params)
    for norm in ("enc_norm", "dec_norm"):
        tree[norm].setdefault("bias", torch.zeros_like(tree[norm]["scale"]))
    for key, count, decoder in (("enc_layers", config.enc_layers, False),
                                ("dec_layers", config.dec_layers, True)):
        for parts, _ in whisper_layer_map(0, decoder).values():
            owner = leaf_at(tree[key], parts[:-1])
            if parts[-1] in owner:
                continue
            weight = owner["w"] if "w" in owner else owner["scale"]
            owner[parts[-1]] = torch.zeros(
                (count, weight.shape[-1]), dtype=weight.dtype)
    return tree


def write_hf_whisper(path, config, params) -> None:
    from aiko_services_tpu_torch.models import whisper_layer_map
    write_hf(path, {
        "model.encoder.conv1.weight": params["conv1"]["w"],
        "model.encoder.conv1.bias": params["conv1"]["b"],
        "model.encoder.conv2.weight": params["conv2"]["w"],
        "model.encoder.conv2.bias": params["conv2"]["b"],
        "model.encoder.embed_positions.weight": params["enc_positions"],
        "model.encoder.layer_norm.weight": params["enc_norm"]["scale"],
        "model.encoder.layer_norm.bias": params["enc_norm"]["bias"],
        "model.decoder.embed_tokens.weight": params["token_embed"]["w"],
        "model.decoder.embed_positions.weight": params["dec_positions"],
        "model.decoder.layer_norm.weight": params["dec_norm"]["scale"],
        "model.decoder.layer_norm.bias": params["dec_norm"]["bias"],
    }, [(params["enc_layers"], [whisper_layer_map(layer, False)
                                for layer in range(config.enc_layers)]),
        (params["dec_layers"], [whisper_layer_map(layer, True)
                                for layer in range(config.dec_layers)])])


def write_hf_llama(path, config, params) -> None:
    from aiko_services_tpu_torch.models import llama_name_map
    tensors = {"model.embed_tokens.weight": params["embed"]["w"],
               "model.norm.weight": params["norm_out"]["scale"]}
    if "lm_head" in params:
        tensors["lm_head.weight"] = params["lm_head"]["w"]
    write_hf(path, tensors, [(params["layers"], [
        llama_name_map(layer) for layer in range(config.n_layers)])])


def tree_bytes(tree) -> tuple:
    """(total bytes, largest leaf's bytes) of a tree of tensors."""
    from aiko_services_tpu_torch.utils.tree import tree_leaves
    sizes = [leaf.numel() * leaf.element_size()
             for leaf in tree_leaves(tree)]
    return sum(sizes), max(sizes)


def served_asr(weights: str, sot_eot: tuple) -> tuple:
    """14a: config 5's asr (phase 5's whisper_small serving parameters,
    max_frames 512) on `weights`, 2 groups of ROWS x SECONDS frames ->
    ({frame: tokens}, load s, peak GiB, K1 launches)."""
    from dataclasses import replace
    from aiko_services_tpu_torch.ops import kernels
    parameters = {key: value for key, value in WHISPER.items()
                  if key != "seed"}
    server = Server(_definition({**parameters, "weights": weights}))
    try:
        element = server.pipeline.elements["asr"]
        element.configure()
        element.config = replace(element.config, sot_token=sot_eot[0],
                                 eot_token=sot_eot[1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        element._ensure_ready()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        kernels.reset_launch_counts()
        frames = [tones_batch(ROWS, SECONDS, seed=140 + index)
                  for index in range(2 * WHISPER["micro_batch"])]
        results = server.serve(frames)
        torch.cuda.synchronize()
        launches = kernels.launch_counts["flash_attention"]
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        server.close()
    tokens = {index: outputs["tokens"].cpu()
              for index, (outputs, _) in enumerate(results)}
    return tokens, load_s, peak, launches


def lm_definition(weights: str, vocab: int, sharding: dict | None = None,
                  frames: int = 2) -> dict:
    """(tokens (lm)): config 5's lm (llama32_1b, bf16, C5_MAX_NEW new
    tokens) on `weights`, fed `frames` seeded C5_ROWS x HF_PROMPT
    prompts of ids below `vocab`."""
    lm = {"name": "lm", "input": [{"name": "tokens"}],
          "output": [{"name": "generated"}],
          "parameters": {"preset": "llama32_1b", "dtype": "bfloat16",
                         "max_new_tokens": C5_MAX_NEW, "weights": weights},
          "deploy": {"local": {"module": MODULE,
                               "class_name": "LMGenerate"}}}
    if sharding:
        lm["sharding"] = sharding
    return {
        "name": "lm14", "graph": ["(tokens (lm))"],
        "parameters": {"device": "cuda"},
        "elements": [
            {"name": "tokens", "output": [{"name": "tokens"}],
             "parameters": {"data_sources": [[C5_ROWS, HF_PROMPT]],
                            "count": frames, "seed": 14,
                            "vocab_size": vocab},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "TokenSource"}}},
            lm]}


def served_lm(definition: dict, frames: int) -> tuple:
    """({frame: (prompt, generated)}, load s, load peak bytes above the
    start, the element)."""
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        element = pipeline.elements["lm"]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        element._ensure_ready()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        load_peak = torch.cuda.max_memory_allocated() - base
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        out = {}
        for _ in range(frames):
            _, frame, outputs = responses.get(timeout=600)
            out[frame.frame_id] = (
                torch.as_tensor(outputs["tokens"]).cpu(),
                torch.as_tensor(outputs["generated"]).cpu())
        return out, load_s, load_peak, element
    finally:
        process.terminate()


def phase_hf_whisper(smi: str) -> int:
    """14a.  Returns the HF arm's K1 launches."""
    config, params = C5_WEIGHTS["asr"]
    params = hf_whisper_tree(config, params)
    hf, native = HF_DIR / "whisper_small.safetensors", \
        HF_DIR / "whisper_small_native.safetensors"
    from aiko_services_tpu_torch.models import save_pytree
    start = time.perf_counter()
    write_hf_whisper(hf, config, params)
    save_pytree(native, params)
    write_s = time.perf_counter() - start
    whisper_ids = (50258, 50257)
    hf_tokens, hf_load, hf_peak, launches = served_asr(str(hf), whisper_ids)
    native_tokens, native_load, _, _ = served_asr(str(native), whisper_ids)
    same = all(torch.equal(hf_tokens[key], native_tokens[key])
               for key in native_tokens)
    say("14a whisper_small_hf", frames=len(hf_tokens), rows=ROWS,
        groups=2, max_frames=WHISPER["max_frames"],
        sot_eot=json.dumps(whisper_ids), identical=same,
        write_s=f"{write_s:.1f}", hf_load_s=f"{hf_load:.2f}",
        native_load_s=f"{native_load:.2f}",
        max_memory_allocated_gib=f"{hf_peak:.2f}",
        k1_launches=launches, card=repr(smi))
    if not same:
        raise SystemExit("14a: tokens from the HF file differ from the "
                         "native-layout load's")
    if launches < config.enc_layers * 2:
        raise SystemExit(f"14a: {launches} K1 launches in 2 groups")
    return launches


def phase_hf_llama(smi: str) -> dict:
    """14b, 14c.  Returns {frame: generated} of the unsharded HF load."""
    from aiko_services_tpu_torch.models import (
        forward, generate, load_llama_params, param_specs, save_pytree)
    from aiko_services_tpu_torch.parallel import (
        filter_specs, set_default_devices)
    config, params = C5_WEIGHTS["lm"]
    hf, native = HF_DIR / "llama32_1b.safetensors", \
        HF_DIR / "llama32_1b_native.safetensors"
    start = time.perf_counter()
    write_hf_llama(hf, config, params)
    save_pytree(native, params)
    write_s = time.perf_counter() - start
    vocab = config.vocab_size
    hf_out, hf_load, _, _ = served_lm(lm_definition(str(hf), vocab), 2)
    native_out, native_load, _, _ = served_lm(
        lm_definition(str(native), vocab), 2)
    same = all(torch.equal(hf_out[key][1], native_out[key][1])
               for key in native_out)
    say("14b llama32_1b_hf", tied="lm_head" not in params,
        frames=len(hf_out), rows=C5_ROWS, new_tokens=C5_MAX_NEW,
        identical=same, write_s=f"{write_s:.1f}",
        hf_load_s=f"{hf_load:.2f}", native_load_s=f"{native_load:.2f}",
        card=repr(smi))
    if not same:
        raise SystemExit("14b: tokens from the HF file differ from the "
                         "native-layout load's")
    torch.cuda.empty_cache()

    # 14c: the same file read straight into fsdp 2 x model 2 shards
    whole_bytes, largest = tree_bytes(params)
    axes = {"fsdp": 2, "model": 2}
    set_default_devices(["cuda:0"] * 4)
    try:
        sharded_out, sharded_load, load_peak, element = served_lm(
            lm_definition(str(hf), vocab, {"axes": axes}, frames=1), 1)
        wq = type(element.state["layers"]["wq"]["w"]).__name__
        prompt, generated = sharded_out[0]
        reference = hf_out[0][1]
        parting = first_difference(generated, reference)
        whole = unsharded(element.state)
        prompt = prompt.cuda()
        with torch.no_grad():
            sharded_last = forward(element.state, config, prompt)[:, -1]
            whole_last = forward(whole, config, prompt)[:, -1]
        parting_fields = {}
        if parting >= 0:
            # the first row that parts there, both runs fed the
            # unsharded tokens (phase 13a's near-tie check)
            row = int((generated[:, parting] != reference[:, parting])
                      .nonzero()[0, 0])
            forced = reference[row:row + 1].cuda()
            ours = forced_step_logits(element.state, config,
                                      prompt[row:row + 1], forced,
                                      parting + 1)[parting]
            theirs = forced_step_logits(whole, config, prompt[row:row + 1],
                                        forced, parting + 1)[parting]
            top = torch.topk(theirs, 2).values
            parting_fields = dict(
                parting_row=row,
                parting_logits_max_abs_diff=(
                    f"{(ours - theirs).abs().max().item():.3e}"),
                parting_unsharded_top2_gap=f"{(top[0] - top[1]).item():.3e}")
        del whole, element
    finally:
        set_default_devices(None)
    torch.cuda.empty_cache()
    diff = (sharded_last - whole_last).abs().max().item()
    span = whole_last.abs().max().item()
    agree = float((generated == reference).float().mean())
    say("14c llama32_1b_hf_on_mesh", mesh=json.dumps(axes), wq=wq,
        load_s=f"{sharded_load:.2f}",
        load_peak_gib=f"{load_peak / 2**30:.3f}",
        whole_copy_gib=f"{whole_bytes / 2**30:.3f}",
        largest_tensor_gib=f"{largest / 2**30:.3f}",
        last_logits_max_abs_diff_vs_unsharded=f"{diff:.3e}",
        logits_span=f"{span:.3e}", greedy_first_difference=parting,
        **parting_fields, tokens_agreeing=f"{agree:.4f}", card=repr(smi))
    if load_peak >= whole_bytes + largest or wq != "Sharded":
        raise SystemExit(f"14c: the placed load peaked at {load_peak} B, "
                         f"not below one copy {whole_bytes} + the largest "
                         f"tensor {largest} (wq {wq})")
    if not np.isfinite(diff) or diff > SHARD_LOGITS_GROSS_FRACTION * span:
        raise SystemExit(f"14c: sharded logits differ from the unsharded "
                         f"load by {diff} (span {span})")

    # 14c f32 at HF_F32_LAYERS layers: tokens identical to the unsharded
    # load of the same file
    from dataclasses import replace
    small = replace(config, n_layers=HF_F32_LAYERS, dtype="float32")
    cut = {"embed": {"w": params["embed"]["w"].float()},
           "norm_out": {"scale": params["norm_out"]["scale"].float()},
           "layers": {name: {key: leaf[:HF_F32_LAYERS].float()
                             for key, leaf in layer.items()}
                      for name, layer in params["layers"].items()}}
    small_path = HF_DIR / "llama32_1b_f32_2layers.safetensors"
    write_hf_llama(small_path, small, cut)
    prompt = hf_out[0][0][:4].cuda()
    whole = load_llama_params(small_path, small, device="cuda")
    want, _ = generate(whole, small, prompt, HF_F32_NEW)
    del whole
    set_default_devices(["cuda:0"] * 4)
    try:
        from aiko_services_tpu_torch.parallel import create_mesh
        mesh = create_mesh(axes)
        placed = load_llama_params(
            small_path, small, mesh=mesh,
            specs=filter_specs(param_specs(small), mesh))
        got, _ = generate(placed, small, prompt, HF_F32_NEW)
        del placed
    finally:
        set_default_devices(None)
    same = torch.equal(got.cpu(), want.cpu())
    say("14c llama32_1b_hf_f32_on_mesh", mesh=json.dumps(axes),
        layers=HF_F32_LAYERS, rows=prompt.shape[0], new_tokens=HF_F32_NEW,
        identical=same, card=repr(smi))
    if not same:
        raise SystemExit("14c: f32 tokens of the placed load differ from "
                         "the unsharded load's")
    torch.cuda.empty_cache()
    return {key: value[1] for key, value in hf_out.items()}


def phase_repaired_departures(smi: str) -> int:
    """14d.  Returns the straddling whisper run's K1 launches."""
    from aiko_services_tpu_torch.models import forward, param_specs
    from aiko_services_tpu_torch.models.asr import _asr_call
    from aiko_services_tpu_torch.parallel import (
        PartitionSpec, collective_counts, create_mesh, filter_specs,
        reset_collective_counts, set_default_devices, shard_pytree)
    launches, element = sharded_speech(smi, "14d whisper_small_straddle",
                                       STRADDLE_AXES, max_tokens=8)
    call, _ = _asr_call(element.state, element.config)
    spans = [h1 - h0 for h0, h1 in call.spans]
    say("14d straddle_heads", heads=element.config.n_heads,
        model=STRADDLE_AXES["model"], heads_per_shard=json.dumps(spans),
        duplicated_heads_per_layer=sum(spans) - element.config.n_heads,
        k1_launches_per_shard=launches / STRADDLE_AXES["model"],
        card=repr(smi))
    del element

    config, params = C5_WEIGHTS["lm"]
    count = int(np.prod(list(RESHARD_AXES.values())))
    set_default_devices(["cuda:0"] * count)
    try:
        mesh = create_mesh(RESHARD_AXES)
        specs = filter_specs(param_specs(config), mesh)
        default = shard_pytree(params, mesh, specs)
        layers = dict(specs["layers"])
        for name in ("wq", "wk", "wv"):
            layers[name] = {"w": PartitionSpec(None, "model", "fsdp")}
        swapped = shard_pytree(params, mesh, dict(
            specs, layers=layers, embed={"w": PartitionSpec("fsdp", None)}))
        prompt = torch.from_numpy(np.random.default_rng(14).integers(
            0, config.vocab_size, (2, HF_PROMPT)).astype(np.int32)).cuda()
        with torch.no_grad():
            reset_collective_counts()
            want = forward(default, config, prompt)
            plain = collective_counts()
            reset_collective_counts()
            got = forward(swapped, config, prompt)
            counted = collective_counts()
        del default, swapped
    finally:
        set_default_devices(None)
    torch.cuda.empty_cache()
    moved = {axes: {"calls": entry["calls"] - plain.get(axes, {}).get(
        "calls", 0), "bytes": entry["bytes"] - plain.get(axes, {}).get(
        "bytes", 0)} for axes, entry in counted.items()}
    moved = {axes: entry for axes, entry in moved.items() if entry["calls"]}
    same = torch.equal(got, want)
    say("14d llama32_1b_reshard", mesh=json.dumps(RESHARD_AXES),
        resharded=json.dumps(moved),
        reshard_mib=f"{sum(e['bytes'] for e in moved.values()) / 2**20:.1f}",
        logits_identical=same, card=repr(smi))
    if not same or sum(entry["calls"] for entry in moved.values()) != 4:
        raise SystemExit(f"14d: resharded logits differ ({same}) or the "
                         f"reshard was not counted once a leaf: {moved}")
    return launches


def phase_shipped_examples(smi: str) -> int:
    """14e.  Returns the multimodal example's K1 launches."""
    import threading
    from aiko_services_tpu_torch.elements import RobotActor
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import set_default_devices
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process, Registrar

    def frames_of(definition, count):
        process = Process(transport_kind="loopback")
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        try:
            responses = queue.Queue()
            pipeline.create_stream("s1", queue_response=responses)
            return [responses.get(timeout=300)[2] for _ in range(count)]
        finally:
            process.terminate()

    start = time.perf_counter()
    kernels.reset_launch_counts()
    outputs = frames_of(port_definition(
        ROOT / "examples" / "pipeline_multimodal.json"), EXAMPLE_FRAMES)
    torch.cuda.synchronize()
    launches = kernels.launch_counts["flash_attention"]
    for out in outputs:
        logits = out["logits"]
        if not (tuple(out["tokens"].shape) == (1, 32) and out["tokens"].is_cuda
                and tuple(logits.shape) == (1, 32, 1024)
                and torch.isfinite(logits).all()
                and tuple(out["nll"].shape) == (1,)
                and out["image"].shape == (256, 256, 3)
                and out["image"].dtype == np.uint8
                and len(out["overlay"]["objects"])
                == len(out["overlay"]["rectangles"])
                and isinstance(out["text"], list)):
            raise SystemExit(f"14e multimodal: bad outputs {out.keys()}")
    multimodal_s = time.perf_counter() - start
    if launches < 4 * EXAMPLE_FRAMES:
        raise SystemExit(f"14e multimodal: {launches} K1 launches")

    start = time.perf_counter()
    # the example's {"data": -1} mesh resolves over the default device
    # list: pinned to cuda:0, as on a machine with one card
    set_default_devices(["cuda:0"])
    try:
        outputs = frames_of(port_definition(
            ROOT / "examples" / "pipeline_compute.json"), 3)
    finally:
        set_default_devices(None)
    for out in outputs:
        tensor = np.asarray(out["tensor"])
        if tensor.shape != (8, 16) or not np.isfinite(tensor).all():
            raise SystemExit(f"14e compute: {tensor.shape}")
    compute_s = time.perf_counter() - start

    start = time.perf_counter()
    process = Process(transport_kind="loopback")
    Registrar(process, search_timeout=0.05)
    robot = RobotActor(process, name="dog")
    pipeline = create_pipeline(process, port_definition(
        ROOT / "examples" / "pipeline_robot_loop.json"))
    process.run(in_thread=True)
    try:
        published = threading.Event()
        process.add_message_handler(lambda _topic, _payload: published.set(),
                                    f"{process.namespace}/detections")
        pipeline.create_stream("vision", queue_response=queue.Queue(),
                               graph_path="camera", grace_time=300)
        robot.start_camera(period=0.1, height=64, width=64)
        if not published.wait(timeout=120):
            raise SystemExit("14e robot: the vision leg never published")
        responses = queue.Queue()
        pipeline.create_stream(
            "chat", queue_response=responses, graph_path="ask",
            parameters={"control.robot_topic": robot.topic_path,
                        "detections_window": 300.0})
        context = False
        for _ in range(8):
            outputs = responses.get(timeout=120)[2]
            if "prompt" in outputs:
                context = "Visible objects:" in outputs["prompt"][0]
            if context:
                break
        robot.stop_camera()
        before = float(robot.share["odometer"])
        pipeline.create_stream(
            "drive", queue_response=queue.Queue(), graph_path="control",
            parameters={"control.robot_topic": robot.topic_path})
        pipeline.create_frame(pipeline.streams["drive"], {
            "text": ["(action move 0.5) (action speak hello)"]})
        deadline = time.monotonic() + 30
        while (float(robot.share["odometer"]) <= before
               and time.monotonic() < deadline):
            time.sleep(0.05)
        moved = float(robot.share["odometer"]) - before
    finally:
        process.terminate()
    if not context or abs(moved - 0.5) > 1e-6 or robot.share[
            "utterances"] < 1:
        raise SystemExit(f"14e robot: context {context}, moved {moved}")
    robot_s = time.perf_counter() - start
    say("14e shipped_examples", multimodal_frames=EXAMPLE_FRAMES,
        multimodal_k1_launches=launches, multimodal_s=f"{multimodal_s:.1f}",
        compute_frames=3, compute_s=f"{compute_s:.1f}",
        robot_context=context, robot_moved_m=f"{moved:.3f}",
        robot_s=f"{robot_s:.1f}", card=repr(smi))
    return launches


def phase_eval_pass(smi: str) -> None:
    """14f: the analyzer's eval pass over config 5's definition on the
    meta device: asr, lm and detector traced, no AIKO207/AIKO208, and
    no byte allocated on the card."""
    from aiko_services_tpu_torch.analyze import (
        ALL_PASSES, analyze_definition)
    from aiko_services_tpu_torch.analyze.shape_eval import (
        element_cost_estimates)
    from aiko_services_tpu_torch.pipeline.definition import (
        parse_pipeline_definition)
    import gc

    def allocated() -> int:
        # what earlier phases left unreachable is collected first, so
        # the two readings differ only by what the pass holds
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    before = allocated()
    start = time.perf_counter()
    report = analyze_definition(config5_definition(), passes=ALL_PASSES)
    estimates = element_cost_estimates(parse_pipeline_definition(
        config5_definition(), validate=False))
    after = allocated()
    traced = sorted(getattr(report, "traced_elements", ()))
    bad = [d.code for d in report.findings
           if d.code in ("AIKO207", "AIKO208")]
    say("14f eval_pass", traced=json.dumps(traced), aiko207_208=len(bad),
        memory_allocated_before=before, memory_allocated_after=after,
        seconds=f"{time.perf_counter() - start:.1f}",
        element_cost_estimates=json.dumps(estimates), card=repr(smi))
    if not {"asr", "lm", "detector"} <= set(traced) or bad \
            or after != before:
        raise SystemExit(f"14f: traced {traced}, findings "
                         f"{report.render()}, memory {before} -> {after}")


def phase_hf_and_examples(smi: str) -> dict:
    """Phase 14.  Returns the kernel launches of its main-path runs."""
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    HF_DIR.mkdir(parents=True, exist_ok=True)
    launches = {name: 0 for name in kernels.KERNELS}
    forward, backward = set(), set()
    with recorded_kernel_cases(forward, backward):
        launches["flash_attention"] += phase_hf_whisper(smi)
        phase_hf_llama(smi)
        launches["flash_attention"] += phase_repaired_departures(smi)
        launches["flash_attention"] += phase_shipped_examples(smi)
    phase_eval_pass(smi)
    checked = {(*spec, 1.0 / math.sqrt(spec[4]))
               for spec in KERNEL_CASES.values()}
    new = sorted(forward - checked, key=str)
    for index, spec in enumerate(new):
        check_forward_case(f"14_{index}", spec, 1500 + index,
                           "14g kernel_vs_plain")
    say("14 hf_examples_eval", wall_s=f"{time.perf_counter() - start:.1f}",
        launches=json.dumps(launches), new_k1_cases=len(new),
        card=repr(smi))
    return launches


# -- the elastic fleet (phase 15) --------------------------------------------

# replicas of the config-5 graph at full width on phase 8's weights
# (nothing is drawn again), fed by the gateway: (inputs (asr (text) (lm
# (reply))) (detector)), `inputs` passing each frame's audio and image
# on.  Cut to F_ROWS rows a frame (config 5's frames carry 16; a batch,
# not a width) and no micro-batching, so every replica computes each
# frame alone and the unscaled run is the reference, token for token.
FLEET_DIR = ROOT / "build" / "fleet"
F_ROWS = 2
F_FRAMES = 4                  # distinct frames, each served as reference
# the burst: F_BURST_FRAMES frames in flight per stream until the
# spawned replica joins
F_BURST_STREAMS, F_BURST_FRAMES = 4, 2
# per trickle stream, one frame in flight: at least F_TRICKLE_FRAMES,
# and on until F_TRICKLE_AFTER_DRAIN frames went to the cold replica
# after the drain (at most F_TRICKLE_FRAMES_MAX)
F_TRICKLE_FRAMES, F_TRICKLE_AFTER_DRAIN, F_TRICKLE_FRAMES_MAX = 3, 2, 40
F_ADMISSION = "max_inflight=4;queue=64"
# high water: the burst (8 frames on one replica of 4 slots: 2.0)
# spawns one replica; the two trickle streams alone (2 of 8 slots:
# 0.25, under the low water) let the spawned replica drain after the
# cooldown, and on the one replica left (2 of 4: 0.5, under the high
# water) spawn nothing more
F_AUTOSCALE = ("min_replicas=1;max_replicas=2;high_water=0.75;"
               "low_water=0.3;cooldown=2;interval=0.05;drain_timeout=0")
F_AUTOPILOT = "interval=0;apply=on;max_delta_frac=0.5;margin=0.15"
F_JOURNAL = "backend=retained;interval=0.02;search_timeout=0.5"
F_TIMEOUT = 600


def fleet_definition(name: str, metrics_interval: float = 60.0) -> dict:
    audio_t = f"f32[b,{int(C5_SECONDS * SAMPLE_RATE)}]"
    image_t = f"f32[b,3,{C5_IMAGE},{C5_IMAGE}]"
    fleet = dict(config5_definition(), name=name)
    fleet["graph"] = ["(inputs (asr (text) (lm (reply))) (detector))"]
    fleet["parameters"] = {"device": "cuda", "telemetry": True,
                           "metrics_interval": metrics_interval}
    elements = []
    for element in fleet["elements"]:
        element = json.loads(json.dumps(element))
        if element["name"] == "sources":
            element = {"name": "inputs",
                       "input": [{"name": "audio", "type": audio_t},
                                 {"name": "image", "type": image_t}],
                       "output": [{"name": "audio", "type": audio_t},
                                  {"name": "image", "type": image_t}],
                       "deploy": {"local": {"module": MODULE,
                                            "class_name": "Sample"}}}
        for key in ("micro_batch", "micro_batch_wait_ms"):
            element.get("parameters", {}).pop(key, None)
        elements.append(element)
    fleet["elements"] = elements
    return fleet


def fleet_frames() -> list:
    """F_FRAMES distinct host frames of F_ROWS rows: tones and seeded
    images at config 5's sizes."""
    from aiko_services_tpu_torch.elements.audio_io import synthesize_tone
    from aiko_services_tpu_torch.elements.image_io import synthesize_image
    frames = []
    for index in range(F_FRAMES):
        rows = range(index * F_ROWS, (index + 1) * F_ROWS)
        frames.append({
            "audio": np.stack([synthesize_tone(330.0 + 55.0 * row,
                                               C5_SECONDS)
                               for row in rows]),
            "image": np.stack([synthesize_image((3, C5_IMAGE, C5_IMAGE),
                                                150 + row)
                               for row in rows])})
    return frames


def fleet_outputs(outputs: dict) -> dict:
    """What a served frame must reproduce exactly, on the host: the
    ASR's and the LM's token streams and the detector's output."""
    detections = outputs["detections"]
    return {name: torch.as_tensor(np.asarray(value.cpu()
                                             if torch.is_tensor(value)
                                             else value))
            for name, value in (
                ("tokens", outputs["tokens"]),
                ("generated", outputs["generated"]),
                *((f"detections.{key}", detections[key])
                  for key in ("boxes", "scores", "classes", "valid")))}


def same_outputs(what: str, got: dict, want: dict) -> None:
    for name, value in want.items():
        if not torch.equal(got[name], value):
            raise SystemExit(f"{what}: {name} differs from the unscaled "
                             f"run: {got[name].tolist()} != "
                             f"{value.tolist()}")


def host_exports() -> dict:
    """Phase 8's host weights offered over the transfer plane, in
    export_weights' shape: the cold replica imports them as a warm one
    imports a sibling's."""
    from aiko_services_tpu_torch.pipeline.transfer import (
        TENSOR_REF_KEY, get_transfer_server)
    from aiko_services_tpu_torch.utils.tree import tree_map
    server = get_transfer_server()
    return {name: tree_map(lambda leaf: {TENSOR_REF_KEY:
                                         server.offer(leaf)}, state)
            for name, (_, state) in C5_WEIGHTS.items()}


def spawn_replica(factory, name: str, warm_source) -> tuple:
    """(handle, spawn info, seconds to healthy: spawn -> warm-up frame
    served); raises on a failed bring-up."""
    ready = queue.Queue()
    start = time.perf_counter()
    factory.spawn(name, warm_source=warm_source,
                  ready=lambda handle, info: ready.put((handle, info)))
    handle, info = ready.get(timeout=F_TIMEOUT)
    seconds = time.perf_counter() - start
    if handle is None:
        raise SystemExit(f"15a: replica {name} failed: {info}")
    return handle, info, seconds


def serve_direct(pipeline, frames: list) -> list:
    """The unscaled run: every frame through one replica's own stream."""
    responses = queue.Queue()
    stream = pipeline.create_stream("reference", queue_response=responses,
                                    grace_time=F_TIMEOUT)
    for frame in frames:
        pipeline.create_frame(stream, dict(frame))
    results = {}
    for _ in frames:
        _, frame, outputs = responses.get(timeout=F_TIMEOUT)
        results[frame.frame_id] = fleet_outputs(outputs)
    pipeline.destroy_stream("reference")
    return [results[frame_id] for frame_id in sorted(results)]


def loop_thread(pipeline) -> str:
    """The name of the thread a replica's elements run on: its Process's
    event loop (runtime/event.py loop_in_thread)."""
    return f"{pipeline.process.event.name}-loop"


def phase_fleet_bring_up(factory, threads: dict, smi: str) -> tuple:
    """15a: a cold replica (the fresh build cache: nvcc builds K1's
    library, a miss) and a warm one from it (0 misses, a hit, all three
    models imported, K1 launched on its own thread: `threads` counts the
    K1 launches per thread).  Returns (cold handle, launches)."""
    from aiko_services_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    cold, cold_info, cold_s = spawn_replica(factory, "fleet-cold",
                                            host_exports())
    nvcc_s = kernels.build_seconds.get("flash_attention")
    warm, warm_info, warm_s = spawn_replica(factory, "fleet-warm",
                                            cold.pipeline)
    cold_k1 = threads.get(loop_thread(cold.pipeline), 0)
    warm_k1 = threads.get(loop_thread(warm.pipeline), 0)
    launches = dict(kernels.launch_counts)
    say("15a fleet_bring_up", cold_time_to_healthy_s=f"{cold_s:.2f}",
        warm_time_to_healthy_s=f"{warm_s:.2f}",
        nvcc_build_s=f"{nvcc_s:.2f}" if nvcc_s is not None else None,
        cold=json.dumps({key: cold_info[key] for key in (
            "cache_hits", "cache_misses", "cache_captures")}),
        warm=json.dumps({key: warm_info[key] for key in (
            "cache_hits", "cache_misses", "cache_captures")}),
        warm_imported=",".join(warm_info["imported_elements"]),
        k1_launches_cold=cold_k1, k1_launches_warm=warm_k1,
        card=repr(smi))
    warm.process.terminate()
    if cold_info["cache_misses"] < 1 or nvcc_s is None:
        raise SystemExit(f"15a: the cold replica built nothing: "
                         f"{cold_info}")
    if warm_info["cache_misses"] != 0 or warm_info["cache_hits"] < 1:
        raise SystemExit(f"15a: the warm replica is not warm: {warm_info}")
    if sorted(warm_info["imported_elements"]) != ["asr", "detector", "lm"]:
        raise SystemExit(f"15a: the warm replica imported "
                         f"{warm_info['imported_elements']}")
    layers = C5_WEIGHTS["asr"][0].enc_layers
    if cold_k1 < layers or warm_k1 < layers:
        raise SystemExit(f"15a: K1 launches {cold_k1} cold, {warm_k1} warm: "
                         f"expected the encoder's {layers} layers each")
    return cold, launches


def phase_fleet_scaling(gateway, cold, frames: list, reference: list,
                        threads: dict, smi: str) -> dict:
    """15b: a burst on the cold replica spawns exactly one warm replica;
    the burst streams keep F_BURST_FRAMES frames each in flight until it
    has joined, so two trickle streams (one frame in flight each) start
    on it while the burst holds the cold one; once the burst is served
    the low watermark drains the spawned replica with both trickle
    streams mid-way.  Every frame equals the unscaled run.  Returns the
    launches."""
    from aiko_services_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    cold_thread = loop_thread(cold.pipeline)
    cold_before = threads.get(cold_thread, 0)
    responses = queue.Queue()
    expected = {}                 # (stream, frame_id) -> frame index
    received, lost = {}, []
    cursors = {}

    def submit(stream_id, offset):
        cursor = cursors.get(stream_id, 0)
        expected[(stream_id, cursor)] = (offset + cursor) % F_FRAMES
        gateway.submit_frame(stream_id, frames[expected[(stream_id,
                                                         cursor)]],
                             frame_id=cursor)
        cursors[stream_id] = cursor + 1

    def receive(timeout):
        stream_id, frame_id, outputs, status = responses.get(
            timeout=timeout)
        if status != "ok":
            lost.append((stream_id, frame_id, status))
        else:
            received[(stream_id, int(frame_id))] = fleet_outputs(outputs)
        return stream_id

    start = time.perf_counter()
    burst = [f"b{index}" for index in range(F_BURST_STREAMS)]
    for stream_id in burst:
        gateway.submit_stream(stream_id, queue_response=responses)
    for _ in range(F_BURST_FRAMES):
        for offset, stream_id in enumerate(burst):
            submit(stream_id, offset)
    deadline = time.monotonic() + F_TIMEOUT
    while len(gateway.replicas) < 2 and time.monotonic() < deadline:
        try:
            stream_id = receive(0.02)
        except queue.Empty:
            continue
        if len(gateway.replicas) < 2:
            submit(stream_id, burst.index(stream_id))
    grown_s = time.perf_counter() - start
    grown = [replica for replica in list(gateway.replicas.values())
             if replica.name != cold.name]
    if not grown:
        raise SystemExit("15b: the burst spawned no replica")
    grown_thread = loop_thread(grown[0].pipeline)
    grown = [replica.name for replica in grown]
    # the cold replica is saturated by the burst: both trickle streams
    # place on the spawned one
    trickle = ("t0", "t1")
    placements = {stream_id: [] for stream_id in trickle}

    def submit_trickle(stream_id):
        """One trickle frame, and the replica its stream is pinned to."""
        submit(stream_id, trickle.index(stream_id))
        deadline = time.monotonic() + 30
        while (gateway.streams.get(stream_id) is None
               and time.monotonic() < deadline):
            time.sleep(0.005)
        stream = gateway.streams.get(stream_id)
        placements[stream_id].append(
            stream.replica.name if stream is not None
            and stream.replica is not None else None)

    for stream_id in trickle:
        gateway.submit_stream(stream_id, queue_response=responses)
        submit_trickle(stream_id)
    while len(received) + len(lost) < len(expected):
        stream_id = receive(F_TIMEOUT)
        names = placements.get(stream_id)
        if names is not None and len(names) < F_TRICKLE_FRAMES_MAX and (
                len(names) < F_TRICKLE_FRAMES
                or len(gateway.replicas) > 1
                or names.count(cold.name) < F_TRICKLE_AFTER_DRAIN):
            submit_trickle(stream_id)
    elapsed = time.perf_counter() - start
    deadline = time.monotonic() + 30
    while len(gateway.replicas) > 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    launches = dict(kernels.launch_counts)
    replica_k1 = {cold.name: threads.get(cold_thread, 0) - cold_before,
                  grown[0]: threads.get(grown_thread, 0)}
    spawns = list(gateway.autoscaler.spawns)
    for key, index in expected.items():
        if key in received:
            same_outputs(f"15b {key}", received[key], reference[index])
    drained_mid_way = [stream_id for stream_id, names in placements.items()
                       if names[0] == grown[0] and names[-1] == cold.name]
    telemetry = gateway.telemetry
    say("15b fleet_scaling", frames=len(expected),
        frames_ok=len(received), frames_lost=len(lost),
        seconds=f"{elapsed:.2f}", spawned_after_s=f"{grown_s:.2f}",
        scale_ups=telemetry.scale_ups.value,
        scale_downs=telemetry.scale_downs.value,
        spawned=json.dumps(spawns), pool_after=len(gateway.replicas),
        trickle_placements=json.dumps(placements),
        drained_mid_way=",".join(drained_mid_way),
        k1_launches=launches["flash_attention"],
        k1_launches_by_replica=json.dumps(replica_k1), card=repr(smi))
    if lost or len(received) != len(expected):
        raise SystemExit(f"15b: frames lost: {lost}")
    layers = C5_WEIGHTS["asr"][0].enc_layers
    if min(replica_k1.values()) < layers:
        raise SystemExit(f"15b: K1 launches by replica {replica_k1}: "
                         f"expected the encoder's {layers} layers each")
    if (len(spawns) != 1 or telemetry.scale_ups.value != 1
            or not spawns[0]["warm"] or spawns[0]["cache_misses"] != 0
            or spawns[0]["cache_hits"] < 1
            or sorted(spawns[0]["imported_elements"])
            != ["asr", "detector", "lm"]):
        raise SystemExit(f"15b: expected exactly one warm spawn with no "
                         f"build: {spawns}")
    if telemetry.scale_downs.value != 1 or len(gateway.replicas) != 1:
        raise SystemExit(f"15b: the low watermark did not drain the pool "
                         f"back to 1: {len(gateway.replicas)} replicas")
    if not drained_mid_way:
        raise SystemExit(f"15b: no trickle stream was drained mid-way: "
                         f"{placements}")
    return launches


def phase_fleet_process(cold, cache, reference: list, frames: list,
                        smi: str) -> dict:
    """15c: one OS-process replica through ProcessReplicaFactory over
    the port's ProcessManager, attached by registrar discovery over a
    local MQTT broker; its counters come from the process snapshot it
    publishes.  Returns the counters and seconds."""
    import os
    from aiko_services_tpu_torch.runtime import (
        Process, ProcessManager, Recorder, Registrar)
    from aiko_services_tpu_torch.serve import Gateway, ProcessReplicaFactory
    from aiko_services_tpu_torch.transport.minimqtt import MiniMqttBroker
    broker = MiniMqttBroker()
    saved = {key: os.environ.get(key)
             for key in ("AIKO_MQTT_HOST", "AIKO_MQTT_PORT")}
    os.environ["AIKO_MQTT_HOST"] = "127.0.0.1"
    os.environ["AIKO_MQTT_PORT"] = str(broker.port)
    definition = FLEET_DIR / "replica.json"
    definition.write_text(json.dumps(fleet_definition(
        "template", metrics_interval=0.5)))
    libraries = sorted(path.name for path in cache.iterdir())
    process = Process(transport_kind="mqtt")
    manager = ProcessManager()
    logs = FLEET_DIR / "logs"
    try:
        Registrar(process, search_timeout=0.05)
        recorder = Recorder(process)
        gateway = Gateway(process, name="fleet_os_gw", policy=F_ADMISSION)
        process.run(in_thread=True)
        gateway.discover(name="fleet-os*")
        factory = ProcessReplicaFactory(
            manager, str(definition), transport="mqtt",
            compile_cache=str(cache), log_dir=str(logs))
        start = time.perf_counter()
        factory.spawn("fleet-os1", warm_source=cold.pipeline).join(
            timeout=F_TIMEOUT)
        deadline = time.monotonic() + F_TIMEOUT
        replica = None
        while time.monotonic() < deadline:
            replica = next((replica for replica in gateway.replicas.values()
                            if replica.name == "fleet-os1"), None)
            if replica is not None and replica.fresh(
                    time.monotonic(), gateway.policy.stale_after_s):
                break
            if "fleet-os1" not in manager:
                break
            time.sleep(0.05)
        attached_s = time.perf_counter() - start
        if replica is None:
            raise SystemExit(f"15c: the child never attached (log: "
                             f"{(logs / 'fleet-os1.log').read_text()[-2000:]})")
        responses = queue.Queue()
        gateway.submit_stream("c0", queue_response=responses)
        gateway.submit_frame("c0", frames[0])
        _, _, outputs, status = responses.get(timeout=F_TIMEOUT)
        healthy_s = time.perf_counter() - start
        if status != "ok":
            raise SystemExit(f"15c: the child's frame: {status} {outputs}")
        same_outputs("15c", fleet_outputs(outputs), reference[0])
        # the child's process snapshot once it counts the frame's K1
        # launches beside its build cache's counters
        counters = None
        deadline = time.monotonic() + 60
        while counters is None and time.monotonic() < deadline:
            for source in recorder.metrics_sources():
                snapshot = (recorder.metrics_for(source) or {}).get(
                    "counters", {})
                if (source.endswith("/process")
                        and f"/{os.getpid()}/" not in source
                        and "compile_cache.hits" in snapshot
                        and "kernel_launches.flash_attention" in snapshot):
                    counters = snapshot
            time.sleep(0.1)
        factory.retire("fleet-os1")
        deadline = time.monotonic() + 60
        while "fleet-os1" in manager and time.monotonic() < deadline:
            time.sleep(0.05)
        retired = "fleet-os1" not in manager
    finally:
        process.terminate()
        manager.terminate()
        broker.stop()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    after = sorted(path.name for path in cache.iterdir())
    child = {key: (counters or {}).get(f"compile_cache.{key}", 0)
             for key in ("hits", "misses", "captures")}
    child["k1_launches"] = (counters or {}).get(
        "kernel_launches.flash_attention", 0)
    say("15c fleet_os_process", attached_s=f"{attached_s:.2f}",
        time_to_healthy_s=f"{healthy_s:.2f}", child=json.dumps(child),
        libraries_before=len(libraries), libraries_after=len(after),
        retired=retired, card=repr(smi))
    if counters is None:
        raise SystemExit("15c: no process snapshot from the child")
    if child["misses"] != 0 or child["hits"] < 1:
        raise SystemExit(f"15c: the child is not warm: {child}")
    layers = C5_WEIGHTS["asr"][0].enc_layers
    if child["k1_launches"] < layers:
        raise SystemExit(f"15c: the child launched K1 "
                         f"{child['k1_launches']} times: expected the "
                         f"encoder's {layers} layers")
    if after != libraries:
        raise SystemExit(f"15c: the cache changed: {libraries} -> {after}")
    if not retired:
        raise SystemExit("15c: the child outlived its retirement")
    return child


def phase_fleet_autopilot(gateway, smi: str) -> None:
    """15d: one autopilot tick over what the live replicas and the
    gateway recorded, its journal, then `tune` on the same traces."""
    from aiko_services_tpu_torch.observe import merge_trace_documents
    from aiko_services_tpu_torch.observe.trace import chrome_trace_document
    # the fleet's scaling is done: an applied floor must not spawn a
    # replica after the phase
    gateway.autoscaler.stop()
    pilot = gateway.autopilot
    start = time.perf_counter()
    report = pilot.tick_now()
    tick_s = time.perf_counter() - start
    if report is None:
        raise SystemExit("15d: the autopilot harvested nothing to tune")
    tick = pilot.ledger[-1]
    planned = [f"{record['target']}.{record['knob']} "
               f"{record['current']!r}->{record['proposed']!r} "
               f"({record['reason']})"
               for record in report["recommendations"]]
    applied = [{key: record[key] for key in ("seq", "target", "knob",
                                             "value", "clamped")}
               for record in tick["applied"]]
    journal = [{key: record[key] for key in ("seq", "target", "knob",
                                             "value", "clamped")}
               for record in gateway.journal.replay_deltas()]
    if applied:
        decision = "applied"
    elif tick["gated"]:
        decision = "declined: the SLO burn is under the threshold"
    elif tick["skipped"]:
        decision = ("declined: the planned knobs change shapes (skipped, "
                    "never applied live)")
    else:
        decision = ("declined: nothing to move (converged)"
                    if tick["converged"] else "declined")
    documents = [(gateway.topic_path, chrome_trace_document(
        gateway.telemetry.chrome_events(),
        metadata=gateway.telemetry.trace_metadata()))]
    for replica in gateway.replicas.values():
        telemetry = replica.pipeline.telemetry
        documents.append((replica.topic_path, chrome_trace_document(
            telemetry.chrome_events(), metadata=telemetry.trace_metadata())))
    trace = FLEET_DIR / "fleet_trace.json"
    trace.write_text(json.dumps(merge_trace_documents(sorted(documents))))
    result = subprocess.run(
        [sys.executable, "-m", "aiko_services_tpu_torch", "tune",
         str(trace), "--json", "--no-flops"], capture_output=True,
        text=True, timeout=F_TIMEOUT, cwd=ROOT)
    say("15d fleet_autopilot", tick_s=f"{tick_s:.2f}",
        floors=json.dumps({name: record["floor"] for name, record
                           in report["elements"].items()}),
        planned=json.dumps(planned), decision=repr(decision),
        applied=json.dumps(applied), journal=json.dumps(journal),
        convergence=tick["convergence"], tune_cli_rc=result.returncode,
        card=repr(smi))
    if journal != applied:
        raise SystemExit(f"15d: the journal {journal} is not the applied "
                         f"deltas {applied}")
    if result.returncode != 0:
        raise SystemExit(f"15d: tune exited {result.returncode}: "
                         f"{result.stderr[-2000:]}")
    cli = json.loads(result.stdout)
    if set(cli["elements"]) != set(report["elements"]):
        raise SystemExit(f"15d: tune's elements {sorted(cli['elements'])} "
                         f"are not the autopilot's "
                         f"{sorted(report['elements'])}")


def phase_fleet_kernel_checks(forward: set) -> None:
    """15e: K1 at every case the fleet's replicas launched it with (F_ROWS
    rows a frame) that phase 2 did not check, against the plain version
    at phase 2's limits."""
    checked = {(*spec, 1.0 / math.sqrt(spec[4]))
               for spec in KERNEL_CASES.values()}
    new = sorted(forward - checked, key=str)
    if not new:
        raise SystemExit(f"15e: the fleet launched no K1 case phase 2 did "
                         f"not check: {forward}")
    for index, spec in enumerate(new):
        check_forward_case(f"15_{index}", spec, 1700 + index,
                           "15e kernel_vs_plain")
    say("15e fleet_kernel_checks", k1_cases=len(new), ok=True)


def phase_fleet(smi: str) -> dict:
    """Phase 15.  Returns the kernel launches of its main-path runs."""
    import shutil
    from aiko_services_tpu_torch.runtime import (
        Process, disable_compile_cache, enable_compile_cache)
    from aiko_services_tpu_torch.serve import Gateway, InProcessReplicaFactory
    start = time.perf_counter()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    cache = FLEET_DIR / "cache"
    enable_compile_cache(str(cache))
    frames = fleet_frames()
    factory = InProcessReplicaFactory(
        fleet_definition, warmup=frames[0], compile_cache=str(cache),
        probe_timeout=F_TIMEOUT)
    launches = {}
    forward, threads = set(), {}
    gateway_process = Process(transport_kind="loopback")
    cold, running = None, False
    try:
        with recorded_kernel_cases(forward, set(), threads):
            cold, launches = phase_fleet_bring_up(factory, threads, smi)
            reference = serve_direct(cold.pipeline, frames)
            gateway = Gateway(gateway_process, name="fleet_gw",
                              policy=F_ADMISSION, router_seed=7,
                              telemetry=True, metrics_interval=60.0,
                              journal=F_JOURNAL, autopilot=F_AUTOPILOT)
            gateway.attach_replica(cold.pipeline)
            gateway.enable_autoscale(F_AUTOSCALE, factory)
            gateway_process.run(in_thread=True)
            running = True
            for name, count in phase_fleet_scaling(
                    gateway, cold, frames, reference, threads,
                    smi).items():
                launches[name] = launches.get(name, 0) + count
        phase_fleet_process(cold, cache, reference, frames, smi)
        phase_fleet_autopilot(gateway, smi)
        phase_fleet_kernel_checks(forward)
    finally:
        if running:       # a Process never run cannot be terminated
            gateway_process.terminate()
        if cold is not None:
            cold.process.terminate()
        disable_compile_cache()
    say("15 fleet", wall_s=f"{time.perf_counter() - start:.1f}",
        launches=json.dumps(launches), card=repr(smi))
    return launches


# -- phase 16: the media and vision elements, the Checkpointer, the codec ----
#
# The last modules of the port on the card, on phase 8's seeded config-5
# weights (C5_WEIGHTS: nothing is drawn again).  The media elements run
# where the JAX package's do: the resampler, the FFT and the resize on
# the card, framing and face detection on the host; each card output is
# held against the same element on the CPU.

CHECKPOINT_DIR = ROOT / "build" / "c5_checkpoint"
M_TONES = ((440.0, 7.5), (523.25, 7.5), (659.25, 7.5))
M_RATE_IN = 24000             # the 7.5 s tones' samples read as 24 kHz
M_WINDOW = 2                  # AudioFraming: chunks of 5 s, then 10 s
M_MAX_TOKENS = 16
M_IMAGES = 2
M_IMAGE_SHAPE = (3, 480, 640)
M_RESAMPLE_ATOL = 1e-6        # tests/test_torch_media.py's bounds
M_RESIZE_ATOL = 1e-6
M_SPECTRUM_REL = 1e-5         # of the spectrum's peak
K_FRAMES = 4                  # 16b: frames served before the checkpoint
# tests/test_native.py's corpus and its malformed payloads
SEXPR_CORPUS = [
    "",
    "(test)",
    "(add topic name protocol transport owner (a=b c=d))",
    "(process_frame (stream_id: 1 frame_id: 0) (a: 0))",
    '(say "hello world" "quo\\"ted")',
    "(share response/topic 300 *)",
    "(nested (a (b (c))) ())",
    "(mixed (a: 1) plain (b: 2))",
    "atom_only",
    "(numbers 1 2.5 -3 1e-6)",
    "(canon 5:ab cd x)",
    "(canon 3:\x00\x01\xff end)",
    "  ( spaced   out )  ",
    "(empty ())",
    "(keyword_odd a: 1 b:)",
    "(blob 256:" + bytes(range(256)).decode("latin-1") + ")",
]
SEXPR_MALFORMED = ["((((", "(unterminated", '("unclosed)', "(a) trailing",
                   "(overrun 99:x)"]


def media_definitions() -> tuple:
    """(the speech graph, the image graph), on the card."""
    def local(class_name):
        return {"local": {"module": MODULE, "class_name": class_name}}

    speech = {
        "name": "media_speech",
        "graph": ["(tone (resample (framing (asr (text))) (fft)))"],
        "parameters": {"device": "cuda"},
        "elements": [
            {"name": "tone", "output": [{"name": "audio"}],
             "parameters": {"data_sources": [list(t) for t in M_TONES],
                            "on_device": True},
             "deploy": local("ToneSource")},
            {"name": "resample", "input": [{"name": "audio"}],
             "output": [{"name": "audio"}, {"name": "sample_rate"}],
             "map_out": {"audio": "resampled"},
             "parameters": {"rate_in": M_RATE_IN,
                            "rate_out": SAMPLE_RATE},
             "deploy": local("AudioResample")},
            {"name": "framing", "input": [{"name": "audio"}],
             "output": [{"name": "audio"}],
             "map_in": {"audio": "resampled"},
             "map_out": {"audio": "framed"},
             "parameters": {"window_count": M_WINDOW},
             "deploy": local("AudioFraming")},
            {"name": "asr", "input": [{"name": "audio"}],
             "output": [{"name": "tokens"}],
             "map_in": {"audio": "framed"},
             "parameters": {"preset": "whisper_small", "max_frames": 512,
                            "max_tokens": M_MAX_TOKENS,
                            "dtype": "bfloat16"},
             "deploy": local("SpeechToText")},
            {"name": "text", "input": [{"name": "tokens"}],
             "output": [{"name": "text"}],
             "deploy": local("TokensToText")},
            {"name": "fft", "input": [{"name": "audio"}],
             "output": [{"name": "spectrum"}, {"name": "frequencies"}],
             "map_in": {"audio": "resampled"},
             "deploy": local("AudioFFT")},
        ]}
    image = {
        "name": "media_image",
        "graph": ["(camera (resize (detector) (face) (show)))"],
        "parameters": {"device": "cuda"},
        "elements": [
            {"name": "camera", "output": [{"name": "image"}],
             "parameters": {"data_sources": [list(M_IMAGE_SHAPE)]
                            * M_IMAGES, "on_device": True, "seed": 160},
             "deploy": local("ImageSource")},
            {"name": "resize", "input": [{"name": "image"}],
             "output": [{"name": "image"}], "map_out": {"image": "resized"},
             "parameters": {"resize_height": C5_IMAGE,
                            "resize_width": C5_IMAGE},
             "deploy": local("ImageResize")},
            {"name": "detector", "input": [{"name": "image"}],
             "output": [{"name": "detections"}],
             "map_in": {"image": "resized"},
             "parameters": {"preset": "yolov8n", "dtype": "bfloat16"},
             "deploy": local("Detector")},
            {"name": "face", "input": [{"name": "image"}],
             "output": [{"name": "detections"}, {"name": "overlay"}],
             "map_in": {"image": "resized"},
             "map_out": {"detections": "faces"},
             "deploy": local("FaceDetect")},
            {"name": "show", "input": [{"name": "image"}],
             "output": [{"name": "image"}], "map_in": {"image": "resized"},
             "map_out": {"image": "shown"},
             "deploy": local("ImageOutput")},
        ]}
    return speech, image


def serve_frames(definition: dict, count: int, weights: dict) -> tuple:
    """(the outputs of `count` frames of one stream in frame order, the
    pipeline's K1 launches, its ASR element): each element named in
    `weights` gets phase 8's state through restore_state first."""
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        for name, state in weights.items():
            pipeline.elements[name].restore_state(state)
        responses = queue.Queue()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        pipeline.create_stream("s1", queue_response=responses,
                               grace_time=600)
        results = {}
        for _ in range(count):
            _, frame, outputs = responses.get(timeout=600)
            results[frame.frame_id] = outputs
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
    finally:
        process.terminate()
    return ([results[key] for key in sorted(results)], launches,
            pipeline.elements.get("asr"))


def cpu_element(cls, **parameters):
    """A port element on the CPU, outside any pipeline (its parameters
    as given, a fresh stream state)."""
    import types
    element = cls.__new__(cls)
    parameters["device"] = "cpu"
    element.get_parameter = (lambda name, default=None, stream=None:
                             parameters.get(name, default))
    element.definition = types.SimpleNamespace(name=cls.__name__)
    return element


def phase_media_speech(smi: str) -> dict:
    """16a, the speech graph.  Returns its kernel launches."""
    import types
    from aiko_services_tpu_torch.elements import (
        AudioFFT, AudioFraming, AudioResample)
    speech, _ = media_definitions()
    start = time.perf_counter()
    outputs, launches, asr = serve_frames(
        speech, len(M_TONES), {"asr": C5_WEIGHTS["asr"][1]})
    seconds = time.perf_counter() - start
    resample = cpu_element(AudioResample, rate_in=M_RATE_IN,
                           rate_out=SAMPLE_RATE)
    framing = cpu_element(AudioFraming, window_count=M_WINDOW)
    fft = cpu_element(AudioFFT)
    window = types.SimpleNamespace(variables={})
    worst = {"resampled": 0.0, "framed": 0.0, "spectrum": 0.0}
    lengths = []
    for index, frame in enumerate(outputs):
        tone = frame["audio"]
        if not (tone.is_cuda and frame["resampled"].is_cuda
                and frame["spectrum"].is_cuda):
            raise SystemExit("16a: the tone, the resampled audio or the "
                             "spectrum left the card")
        _, resampled = AudioResample.process_frame(resample, None,
                                                   tone.cpu())
        _, framed = AudioFraming.process_frame(framing, window,
                                               resampled["audio"])
        _, spectrum = AudioFFT.process_frame(fft, None, resampled["audio"])
        errors = {
            "resampled": (frame["resampled"].cpu()
                          - resampled["audio"]).abs().max().item(),
            "framed": float(np.abs(frame["framed"]
                                   - framed["audio"]).max()),
            "spectrum": (frame["spectrum"].cpu() - spectrum["spectrum"]
                         ).abs().max().item()
            / spectrum["spectrum"].abs().max().item()}
        for name, error in errors.items():
            worst[name] = max(worst[name], error)
        if (errors["resampled"] > M_RESAMPLE_ATOL
                or errors["framed"] > M_RESAMPLE_ATOL
                or errors["spectrum"] > M_SPECTRUM_REL):
            raise SystemExit(f"16a: frame {index} differs from the CPU "
                             f"elements: {errors}")
        peak_hz = spectrum["frequencies"][
            int(frame["spectrum"].argmax().item())]
        want_hz = M_TONES[index][0] * M_RATE_IN / SAMPLE_RATE
        if abs(peak_hz - want_hz) > 1.0:
            raise SystemExit(f"16a: spectrum peak {peak_hz} Hz, the tone "
                             f"is at {want_hz} Hz")
        reference = asr._transcribe(asr.state, framed["audio"],
                                    M_MAX_TOKENS)
        tokens = frame["tokens"]
        if not torch.equal(tokens.cpu(), reference.cpu()):
            raise SystemExit(f"16a: frame {index}: the served tokens "
                             f"{tokens.tolist()} differ from the card's "
                             f"ASR on the CPU-framed audio "
                             f"{reference.tolist()}")
        if not (isinstance(frame["text"], list) and len(frame["text"]) == 1):
            raise SystemExit(f"16a: text {frame['text']!r}")
        lengths.append(int(frame["framed"].shape[-1]))
    if launches["flash_attention"] < 12 * len(M_TONES):
        raise SystemExit(f"16a: {launches['flash_attention']} K1 launches "
                         f"for {len(M_TONES)} frames of 12 encoder layers")
    say("16a media_speech", frames=len(outputs),
        framed_samples=json.dumps(lengths),
        resampled_max_abs_err=f"{worst['resampled']:.3e}",
        framed_max_abs_err=f"{worst['framed']:.3e}",
        spectrum_max_rel_err=f"{worst['spectrum']:.3e}",
        tokens_equal_cpu_framed=True,
        flash_attention_launches=launches["flash_attention"],
        wall_s=f"{seconds:.1f}", card=repr(smi), ok=True)
    return launches


def phase_media_image(smi: str) -> None:
    """16a, the image graph (no kernel of the port runs on it)."""
    from aiko_services_tpu_torch.elements import FaceDetect, ImageResize
    _, image = media_definitions()
    start = time.perf_counter()
    outputs, _, _ = serve_frames(image, M_IMAGES,
                                 {"detector": C5_WEIGHTS["detector"][1]})
    seconds = time.perf_counter() - start
    config = C5_WEIGHTS["detector"][0]
    resize = cpu_element(ImageResize, resize_height=C5_IMAGE,
                         resize_width=C5_IMAGE)
    face = cpu_element(FaceDetect)
    worst, faces = 0.0, 0
    for index, frame in enumerate(outputs):
        if not (frame["image"].is_cuda and frame["resized"].is_cuda
                and tuple(frame["resized"].shape)
                == (3, C5_IMAGE, C5_IMAGE)
                and torch.equal(frame["shown"], frame["resized"])):
            raise SystemExit(f"16a: frame {index}: image "
                             f"{tuple(frame['image'].shape)} resized "
                             f"{tuple(frame['resized'].shape)}")
        _, resized = ImageResize.process_frame(resize, None,
                                               frame["image"].cpu())
        error = (frame["resized"].cpu() - resized["image"]).abs().max()
        worst = max(worst, error.item())
        if error > M_RESIZE_ATOL:
            raise SystemExit(f"16a: frame {index}: the resize differs "
                             f"from the CPU's by {error.item()}")
        _, expected = FaceDetect.process_frame(face, None,
                                               frame["resized"].cpu())
        for key in ("boxes", "scores", "classes", "valid"):
            if not np.array_equal(frame["faces"][key],
                                  expected["detections"][key]):
                raise SystemExit(f"16a: frame {index}: FaceDetect's {key} "
                                 f"differ from the CPU run's")
        if frame["overlay"] != expected["overlay"]:
            raise SystemExit(f"16a: frame {index}: the face overlay "
                             f"differs from the CPU run's")
        faces += int(np.asarray(frame["faces"]["valid"]).sum())
        detections = frame["detections"]
        boxes, scores = detections["boxes"], detections["scores"]
        classes = detections["classes"]
        if not (boxes.is_cuda and tuple(boxes.shape)
                == (1, config.max_detections, 4)
                and torch.isfinite(boxes).all()
                and ((0 <= scores) & (scores <= 1)).all()
                and ((0 <= classes) & (classes < config.n_classes)).all()):
            raise SystemExit(f"16a: frame {index}: detections "
                             f"{tuple(boxes.shape)} outside their ranges")
    say("16a media_image", frames=len(outputs),
        image=json.dumps(list(M_IMAGE_SHAPE)),
        resized=json.dumps([3, C5_IMAGE, C5_IMAGE]),
        resize_max_abs_err=f"{worst:.3e}", faces_found=faces,
        face_detections_equal_cpu=True, wall_s=f"{seconds:.1f}",
        card=repr(smi), ok=True)


def serve_stream(pipeline, stream_id: str, frames: list) -> list:
    """fleet_outputs of `frames` through a stream of `pipeline` that stays
    open, in frame order."""
    responses = queue.Queue()
    stream = pipeline.create_stream(stream_id, queue_response=responses,
                                    grace_time=F_TIMEOUT)
    for frame in frames:
        pipeline.create_frame(stream, dict(frame))
    results = {}
    for _ in frames:
        _, frame, outputs = responses.get(timeout=F_TIMEOUT)
        results[frame.frame_id] = fleet_outputs(outputs)
    return [results[key] for key in sorted(results)]


def phase_checkpoint(smi: str) -> dict:
    """16b.  Returns the kernel launches of the restored pipeline's run."""
    import shutil
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    from aiko_services_tpu_torch.utils.checkpoint import Checkpointer
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    frames = fleet_frames()[:K_FRAMES]
    checkpointer = Checkpointer(CHECKPOINT_DIR, max_to_keep=1,
                                device="cuda")
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, fleet_definition("c5_ckpt"))
        process.run(in_thread=True)
        for name, (_, state) in C5_WEIGHTS.items():
            pipeline.elements[name].restore_state(state)
        before = serve_stream(pipeline, "s16", frames)
        cursor = pipeline.streams["s16"].frame_id
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        target = pipeline.checkpoint(checkpointer, step=K_FRAMES)
        save_s = time.perf_counter() - start
        save_peak = torch.cuda.max_memory_allocated()
    finally:
        process.terminate()
    del pipeline
    torch.cuda.empty_cache()
    written = sum(path.stat().st_size for path in target.rglob("*")
                  if path.is_file())
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, fleet_definition("c5_ckpt"))
        process.run(in_thread=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        metadata = pipeline.restore_checkpoint(checkpointer)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - start
        restore_peak = torch.cuda.max_memory_allocated()
        restored_cursor = pipeline.streams["s16"].frame_id
        kernels.reset_launch_counts()
        after = serve_stream(pipeline, "s16_restored", frames)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
    finally:
        process.terminate()
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    if metadata.get("pipeline") != "c5_ckpt" or restored_cursor != cursor:
        raise SystemExit(f"16b: cursor {restored_cursor} restored, "
                         f"{cursor} saved ({metadata.get('pipeline')})")
    for index, (got, want) in enumerate(zip(after, before)):
        same_outputs(f"16b frame {index} after the restore", got, want)
    if launches["flash_attention"] < 12 * K_FRAMES:
        raise SystemExit(f"16b: {launches['flash_attention']} K1 launches "
                         f"after the restore for {K_FRAMES} frames")
    say("16b checkpoint", frames=K_FRAMES, rows_per_frame=F_ROWS,
        stream_cursor=restored_cursor, bytes_written=written,
        gib_written=f"{written / 2**30:.3f}", save_s=f"{save_s:.2f}",
        restore_s=f"{restore_s:.2f}",
        save_max_memory_allocated_gib=f"{save_peak / 2**30:.2f}",
        restore_max_memory_allocated_gib=f"{restore_peak / 2**30:.2f}",
        outputs_identical=True,
        flash_attention_launches=launches["flash_attention"],
        card=repr(smi), ok=True)
    return launches


def phase_native_codec(smi: str) -> None:
    """16c."""
    from aiko_services_tpu_torch import native
    from aiko_services_tpu_torch.native.build import build
    from aiko_services_tpu_torch.utils import sexpr
    start = time.perf_counter()
    if build() is None or native.sexpr_parse_native is None:
        raise SystemExit("16c: the native codec did not build or load")
    build_s = time.perf_counter() - start
    for payload in SEXPR_CORPUS:
        if sexpr.parse(payload) != sexpr._parse_python(payload):
            raise SystemExit(f"16c: the native parser differs on "
                             f"{payload!r}")
    for payload in SEXPR_MALFORMED:
        for parser in (sexpr.parse, sexpr._parse_python):
            try:
                parser(payload)
            except sexpr.ParseError:
                continue
            raise SystemExit(f"16c: {payload!r} parsed without a "
                             f"ParseError")
    message = sexpr.generate(
        "add", ["namespace/host/1234/5", "pipeline_worker",
                "github.com/x/protocol/pipeline:0", "mqtt", "owner",
                ["ec=true", "stage=3"]])
    timed = {}
    for name, parser in (("native", sexpr.parse),
                         ("python", sexpr._parse_python)):
        start = time.perf_counter()
        for _ in range(20000):
            parser(message)
        timed[name] = (time.perf_counter() - start) / 20000 * 1e6
    say("16c native_codec", build_s=f"{build_s:.2f}",
        corpus=len(SEXPR_CORPUS), malformed=len(SEXPR_MALFORMED),
        native_us_per_message=f"{timed['native']:.3f}",
        python_us_per_message=f"{timed['python']:.3f}",
        message_bytes=len(message), equal_to_python=True, ok=True)


def phase_media_kernel_checks(forward: set) -> None:
    """16d: K1 at every case 16a/16b launched it with that phase 2 did
    not check, against the plain version."""
    checked = {(*spec, 1.0 / math.sqrt(spec[4]))
               for spec in KERNEL_CASES.values()}
    new = sorted(forward - checked, key=str)
    for index, spec in enumerate(new):
        check_forward_case(f"16_{index}", spec, 1600 + index,
                           "16d kernel_vs_plain")
    say("16d media_kernel_checks", k1_cases=len(new), ok=True)


def phase_last_modules(smi: str) -> dict:
    """Phase 16.  Returns the kernel launches of its main-path runs."""
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    launches = {name: 0 for name in kernels.KERNELS}
    forward = set()
    with recorded_kernel_cases(forward, set()):
        add_launches(launches, phase_media_speech(smi))
        phase_media_image(smi)
        add_launches(launches, phase_checkpoint(smi))
    phase_native_codec(smi)
    phase_media_kernel_checks(forward)
    say("16 last_modules", wall_s=f"{time.perf_counter() - start:.1f}",
        launches=json.dumps(launches), card=repr(smi))
    return launches


# -- phase 17: training across processes --------------------------------------
#
# Two worker processes (process_worker, each its own python) join one job
# through the AIKO_* contract on localhost with backend "gloo" (one card
# cannot hold two NCCL ranks) and local_device_ids [0, 0]: each drives
# two positions on cuda:0, and global_mesh spans both.  Every
# cross-process exchange of a CUDA block goes through host memory
# (gloo), counted.  The parent runs the unsharded steps first on the same
# weights (draw_on_card, drawn alike in every process) and batches,
# writes what the workers hold their steps against under PROCESS_DIR, and
# frees the card before the workers start.

PROCESS_DIR = ROOT / "build" / "processes"
PROCESS_TIMEOUT = 900         # seconds, for both workers together
PROCESS_SEED = 17
PROCESS_BF16_LAYERS = 8       # 17a: depth cut (16 before; 20a runs all
                              # 16 on NCCL), widths kept
PROCESS_ARMS = (              # (label, dtype, layers: None for all, axes)
    ("17a", "bfloat16", PROCESS_BF16_LAYERS, {"fsdp": 2, "model": 2}),
    ("17b", "float32", SHARD_F32_LAYERS, {"fsdp": 2, "model": 2}),
    ("17b", "float32", SHARD_F32_LAYERS, {"data": 2, "fsdp": 2}),
)


def process_config(dtype: str, layers):
    from dataclasses import replace
    from aiko_services_tpu_torch.models import LLAMA32_1B
    return replace(LLAMA32_1B, dtype=dtype,
                   n_layers=layers or LLAMA32_1B.n_layers)


def process_batches(config) -> list:
    """The 1 + SHARD_TRAIN_STEPS batches, the same in every process."""
    rng = np.random.default_rng(PROCESS_SEED)
    return [torch.from_numpy(rng.integers(
        0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
        for _ in range(1 + SHARD_TRAIN_STEPS)]


def process_reference(config) -> list:
    """The unsharded steps on PROCESS_SEED's weights and batches: writes
    the parameters after them (and in f32 each step's gradients) under
    PROCESS_DIR and frees the card; returns the losses."""
    from aiko_services_tpu_torch.models import (
        adamw, make_train_step, save_pytree)
    f32 = config.dtype == "float32"
    grads = []
    optimizer = recording(adamw(SHARD_LR), lambda step, tree: (
        grads.append(tree_to(tree, "cpu")) if f32 else None))
    params = draw_on_card(config, PROCESS_SEED)
    state = optimizer.init(params)
    step = make_train_step(config, optimizer)
    losses = []
    for batch in process_batches(config):
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())
    save_pytree(PROCESS_DIR / f"{config.dtype}_after.safetensors", params)
    for index, tree in enumerate(grads):
        save_pytree(PROCESS_DIR / f"{config.dtype}_grads{index}.safetensors",
                    tree)
    del params, state, step, grads
    torch.cuda.empty_cache()
    return losses


def process_references(arms) -> dict:
    """process_reference of each dtype `arms` train in, under a fresh
    PROCESS_DIR: {dtype: the unsharded losses}."""
    import shutil
    shutil.rmtree(PROCESS_DIR, ignore_errors=True)
    PROCESS_DIR.mkdir(parents=True)
    reference = {}
    for _, dtype, layers, _ in arms:
        if dtype not in reference:
            reference[dtype] = process_reference(process_config(dtype,
                                                                layers))
    return reference


def equal_replicas(results: list, phase: str) -> int:
    """Every block two ranks both hold (replica_digests), bit for bit
    equal: rank 0's arms against each other rank's.  Returns how many
    blocks were compared."""
    replicas = 0
    for other in results[1:]:
        for first, second in zip(results[0]["arms"], other["arms"]):
            shared = set(first["digests"]) & set(second["digests"])
            differ = [key for key in shared
                      if first["digests"][key] != second["digests"][key]]
            if not shared or differ:
                raise SystemExit(f"{phase} {first['label']} "
                                 f"{first['axes']}: the ranks' replicas "
                                 f"differ at {differ} (of {len(shared)} "
                                 f"shared blocks)")
            replicas += len(shared)
    return replicas


def local_blocks(leaf) -> list:
    """(tensor, index into the whole tensor) of each distinct block this
    process holds of a placed leaf; a whole tensor is one, at ()."""
    from aiko_services_tpu_torch.parallel import Sharded
    if not isinstance(leaf, Sharded):
        return [(leaf, ())]
    shape = leaf.sharding.shard_shape(tuple(leaf.shape))
    seen, out = set(), []
    for position, tensor in np.ndenumerate(leaf.shards):
        if tensor is None or id(tensor) in seen:
            continue
        seen.add(id(tensor))
        out.append((tensor, tuple(
            slice(start * size, (start + 1) * size)
            for start, size in zip(leaf.block(position), shape))))
    return out


def local_relative(got_tree, want_tree, base_tree=None) -> tuple:
    """worst_relative over the blocks this process holds: per leaf,
    ||got - want|| / ||want|| over its distinct local blocks against the
    same slices of the whole `want_tree` (with `base_tree`, a tree placed
    as `got_tree`, of the changes from it)."""
    worst = ("", 0.0)
    wants = dict(leaf_items(want_tree))
    bases = dict(leaf_items(base_tree)) if base_tree is not None else {}
    for name, leaf in leaf_items(got_tree):
        error2 = scale2 = 0.0
        base = (local_blocks(bases[name]) if name in bases
                else [(None, None)] * len(local_blocks(leaf)))
        for (tensor, index), (start, _) in zip(local_blocks(leaf), base):
            got = tensor.detach().float()
            want = wants[name][index].to(got.device).float()
            if start is not None:
                got, want = got - start.float(), want - start.float()
            error2 += (got - want).norm().item() ** 2
            scale2 += want.norm().item() ** 2
        error = (math.sqrt(error2 / scale2) if scale2
                 else 0.0 if not error2 else float("inf"))
        if not error <= worst[1]:
            worst = (name, error)
    return worst


def replica_digests(tree, mesh) -> dict:
    """sha256 of every local block that another process holds too, and
    of every whole leaf: {name@block: digest}."""
    import hashlib
    from aiko_services_tpu_torch.parallel import Sharded
    out = {}
    for name, leaf in leaf_items(tree):
        held = {}
        if isinstance(leaf, Sharded):
            for position in np.ndindex(leaf.shards.shape):
                held.setdefault(leaf.block(position), set()).add(
                    int(mesh.processes[position]))
        for tensor, index in local_blocks(leaf):
            block = (() if not index else tuple(
                part.start // (part.stop - part.start) for part in index))
            if index and len(held[block]) < 2:
                continue
            data = tensor.detach().contiguous().view(torch.uint8).cpu()
            out[f"{name}@{block}"] = hashlib.sha256(
                data.numpy().tobytes()).hexdigest()
    return out


def process_expected(config, mesh) -> dict:
    """What one sharded train step issues on this process, worked out
    from the mesh: its K1 (and K2, K3) launches -- one per layer and per
    (data block, model shard) its positions compute -- and its
    collective calls and bytes: per position, the embedding's gather and
    per layer the q/k/v and gate/up psums and the wo and w_down gathers
    over fsdp, the wo and w_down psums over model (each the activations'
    bytes), the f32 logits' psum over fsdp; per step, each whole leaf's
    gradient summed across the processes and each Sharded leaf whose
    blocks another process holds too summed with it (sum_replica_grads),
    each with its local blocks' bytes."""
    from aiko_services_tpu_torch.models import init_params, param_specs
    from aiko_services_tpu_torch.parallel import filter_specs
    from aiko_services_tpu_torch.parallel.mesh import spec_layout
    size = {name: mesh.size(name) for name in ("data", "fsdp", "model")}
    data, fsdp, model = size["data"], size["fsdp"], size["model"]
    rows = TRAIN_BATCH // data if TRAIN_BATCH % data == 0 else TRAIN_BATCH
    tokens = rows * TRAIN_SEQ
    width = torch.empty((), dtype=config.torch_dtype).element_size()
    positions = [position for position in np.ndindex(mesh.devices.shape)
                 if mesh.local[position]]
    index = {name: mesh.axis_names.index(name) if name in mesh.axis_names
             else None for name in size}
    shards = {tuple(position[index[name]] if index[name] is not None
                    else 0 for name in ("data", "model"))
              for position in positions}
    calls = per_position = 0
    d, hd = config.d_model, config.head_dim
    if fsdp > 1:
        calls += 2 + 4 * config.n_layers
        per_position += tokens * width * (
            d // fsdp + config.n_layers * (
                (config.n_heads + 2 * config.n_kv_heads) * hd // model
                + 2 * d // fsdp + 2 * config.d_ff // model))
        per_position += tokens * config.vocab_size * 4
    if model > 1:
        calls += 2 * config.n_layers
        per_position += tokens * width * config.n_layers * 2 * d // fsdp
    total = per_position * len(positions)
    with torch.device("meta"):
        shapes = init_params(config, torch.Generator(), device="meta")
    specs = dict(leaf_items(filter_specs(param_specs(config), mesh)))
    spanning = set(mesh.process_axes)
    for name, leaf in leaf_items(shapes):
        layout = spec_layout(specs[name], mesh, leaf.ndim)
        cut_by = {axis for names in layout for axis in names}
        leaf_bytes = leaf.numel() * width
        if not cut_by:
            calls += 1
            total += leaf_bytes
        elif spanning - cut_by:
            cut = int(np.prod([mesh.shape[axis] for axis in cut_by]))
            calls += 1
            total += leaf_bytes // cut * len(positions)
    return {"launches": config.n_layers * len(shards),
            "collective_calls": calls, "collective_bytes": total}


def process_arm(rank: int, label: str, config, axes: dict, smi: str,
                reference: list, header_cost: bool = False) -> dict:
    """One arm of phase 17 (20a, 20b) on this rank: 1 + SHARD_TRAIN_STEPS
    sharded steps on the global mesh, held against the parent's
    unsharded steps (losses; each parameter's change over this rank's
    blocks; in f32 each step's gradients leaf by leaf) and the counts
    worked out in advance; on an NCCL job no byte may be staged through
    host memory.  With `header_cost`, SHARD_TRAIN_STEPS more steps run
    with every exchange's checked header skipped on all ranks alike (the
    sequence still counted): the difference of the two medians is what
    the headers cost a step.  Returns what the parent checks across the
    ranks."""
    from aiko_services_tpu_torch.models import (
        adamw, count_params, load_pytree, make_train_step, param_specs)
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        collective_totals, filter_specs, global_mesh, process_count,
        reset_collective_counts, shard_pytree, staged_bytes, use_mesh)
    from aiko_services_tpu_torch.utils.tree import tree_map
    f32 = config.dtype == "float32"
    mesh = global_mesh(axes)
    params = draw_on_card(config, PROCESS_SEED)
    n_params = count_params(params)
    sharded = copy_replicated(shard_pytree(
        params, mesh, filter_specs(param_specs(config), mesh)))
    del params
    torch.cuda.empty_cache()
    before = tree_map(lambda tensor: tensor.detach().clone(), sharded)
    grad_errors = []

    def record(step, grads):
        if f32:
            want = load_pytree(PROCESS_DIR / f"float32_grads{step}"
                               f".safetensors", device="cpu")
            grad_errors.append(local_relative(grads, want))
    optimizer = recording(adamw(SHARD_LR), record)
    state = optimizer.init(sharded)
    step = make_train_step(config, optimizer, sharded=True)
    losses, times = [], []
    with use_mesh(mesh):
        for index, batch in enumerate(process_batches(config)):
            if index == 1:  # the warm-up step is not counted
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                reset_collective_counts()
                exchanges = sum(mesh.sequence.values())
            start = time.perf_counter()
            sharded, state, loss = step(sharded, state, batch)
            losses.append(loss.item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
    launches = launch_counts()
    calls, size = collective_totals()
    staged = staged_bytes()
    exchanges = sum(mesh.sequence.values()) - exchanges
    peak = torch.cuda.max_memory_allocated()
    after = load_pytree(PROCESS_DIR / f"{config.dtype}_after.safetensors",
                        device="cpu")
    update_leaf, update_error = local_relative(sharded, after, before)
    digests = replica_digests(sharded, mesh)
    expected = process_expected(config, mesh)
    unchecked = []
    if header_cost:
        from aiko_services_tpu_torch.parallel import collectives
        checked_step = collectives._check_step

        def sequence_only(mesh, ranks, *_):
            mesh.sequence[ranks] = mesh.sequence.get(ranks, 0) + 1
        collectives._check_step = sequence_only
        try:
            with use_mesh(mesh):
                for batch in process_batches(config)[1:]:
                    start = time.perf_counter()
                    sharded, state, loss = step(sharded, state, batch)
                    loss.item()
                    torch.cuda.synchronize()
                    unchecked.append(time.perf_counter() - start)
        finally:
            collectives._check_step = checked_step
    del sharded, state, step, before, after
    torch.cuda.empty_cache()
    steps = SHARD_TRAIN_STEPS
    loss_diff = max(abs(a - b) for a, b in zip(losses, reference))
    step_s = statistics.median(times[1:])
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    # over the peak of the cards the job runs on: one on gloo (every
    # rank on cuda:0), one a rank on NCCL
    cards = process_count() if nccl_job() else 1
    mfu = (6 * n_params * tokens_per_s
           / (cards * peaks_for(smi)[1][config.dtype]))
    grad_leaf, grad_error = max(grad_errors, key=lambda item: item[1],
                                default=("", 0.0))
    per_step = {"launches": {name: count / steps
                             for name, count in launches.items()},
                "collective_calls": calls / steps,
                "collective_bytes": size / steps}
    say(f"{label} rank{rank} train_across_processes", mesh=json.dumps(axes),
        dtype=config.dtype, layers=config.n_layers,
        batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}", steps=f"1+{steps}",
        losses=json.dumps([round(value, 6) for value in losses]),
        unsharded_losses=json.dumps([round(value, 6)
                                     for value in reference]),
        loss_max_abs_diff=f"{loss_diff:.3e}",
        update_rel_err=f"{update_error:.3e}", update_worst_leaf=update_leaf,
        **(dict(grad_rel_err=f"{grad_error:.3e}", grad_worst_leaf=grad_leaf)
           if f32 else {}),
        step_ms=f"{step_s * 1e3:.1f}", tokens_per_s=f"{tokens_per_s:.1f}",
        train_mfu=f"{mfu:.4f}",
        launches_per_step=json.dumps(per_step["launches"]),
        expected_launches_per_step=expected["launches"],
        collective_calls_per_step=per_step["collective_calls"],
        expected_collective_calls=expected["collective_calls"],
        collective_mib_per_step=f"{size / steps / 2**20:.3f}",
        expected_collective_mib=f"{expected['collective_bytes'] / 2**20:.3f}",
        host_staged_mib_per_step=f"{staged / steps / 2**20:.1f}",
        **(dict(step_ms_headers_skipped=f"{statistics.median(unchecked) * 1e3:.1f}",
                headers_ms_per_step=f"{(step_s - statistics.median(unchecked)) * 1e3:.1f}",
                checked_exchanges_per_step=exchanges / steps)
           if unchecked else {}),
        max_memory_allocated_gib=f"{peak / 2**30:.2f}",
        device=f"cuda:{torch.cuda.current_device()}", card=repr(smi))
    limits = ((SHARD_F32_LOSS_ATOL, SHARD_F32_UPDATE_REL_TOL) if f32
              else (SHARD_LOSS_ATOL, SHARD_BF16_UPDATE_REL_TOL))
    if nccl_job() and staged:
        raise SystemExit(f"{label} rank {rank}: {staged} bytes staged "
                         f"through host memory on NCCL")
    if not (np.isfinite(losses).all() and loss_diff <= limits[0]
            and update_error <= limits[1]
            and grad_error <= SHARD_F32_GRAD_REL_TOL):
        raise SystemExit(f"{label} rank {rank}: losses {losses} vs "
                         f"unsharded {reference} (limit {limits[0]}); "
                         f"parameter change {update_error:.3e} relative at "
                         f"{update_leaf} (limit {limits[1]}); gradient "
                         f"{grad_error:.3e} relative at {grad_leaf} (limit "
                         f"{SHARD_F32_GRAD_REL_TOL})")
    if (any(count != expected["launches"]
            for count in per_step["launches"].values())
            or per_step["collective_calls"] != expected["collective_calls"]
            or per_step["collective_bytes"] != expected["collective_bytes"]):
        raise SystemExit(f"{label} rank {rank}: a step issued {per_step}, "
                         f"worked out from the mesh: {expected}")
    return {"label": label, "axes": axes, "launches": launches,
            "digests": digests}


def check_new_cases(forward: set, backward: set, prefix: str,
                    phase: str, seed: int) -> tuple:
    """Each K1 case of `forward` and K2/K3 case of `backward` that phase
    2 did not check, against the plain versions at phase 2's limits;
    returns how many of each were checked."""
    def checked(cases):
        return {(*spec, 1.0 / math.sqrt(spec[4])) for spec in cases}
    new_forward = sorted(forward - checked(KERNEL_CASES.values()), key=str)
    new_backward = sorted(backward - checked(BACKWARD_CASES.values()),
                          key=str)
    for index, spec in enumerate(new_forward):
        check_forward_case(f"{prefix}_{index}", spec, seed + index,
                           f"{phase} kernel_vs_plain")
    for index, spec in enumerate(new_backward):
        check_backward_case(f"{prefix}_{index}", spec, seed + 100 + index,
                            f"{phase} backward_vs_plain")
    return len(new_forward), len(new_backward)


def process_worker(argument: str) -> None:
    """One rank of phase 17, in its own process: joins the job, loads the
    kernels phase 1 built (no build here), runs every arm of
    PROCESS_ARMS, holds each new K1/K2/K3 case against its plain version,
    and writes its results under PROCESS_DIR."""
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        initialize_distributed, process_index, shutdown_distributed)
    smi, reference = json.loads(argument)
    if not torch.cuda.is_available():
        raise SystemExit("phase 17 worker: no CUDA device")
    if not initialize_distributed(backend="gloo", local_device_ids=[0, 0],
                                  timeout_seconds=PROCESS_TIMEOUT):
        raise SystemExit("phase 17 worker: no AIKO_* job to join")
    rank = process_index()
    for name in kernels.KERNEL_SOURCES:
        kernels.load_kernel(name)
    forward, backward = set(), set()
    arms = []
    with recorded_kernel_cases(forward, backward):
        for label, dtype, layers, axes in PROCESS_ARMS:
            config = process_config(dtype, layers)
            arms.append(process_arm(rank, label, config, axes, smi,
                                    reference[dtype]))

    new_forward, new_backward = check_new_cases(
        forward, backward, "17", f"17c rank{rank}", 1700)
    builds = sorted(kernels.build_seconds)
    (PROCESS_DIR / f"rank{rank}.json").write_text(json.dumps({
        "arms": arms, "k1_cases": new_forward,
        "k2_k3_cases": new_backward, "builds": builds}))
    shutdown_distributed()
    if builds:
        raise SystemExit(f"phase 17 worker {rank} built {builds}: it must "
                         f"load what phase 1 built")
    print(f"rank {rank} done", flush=True)


def run_workers(phase: str, directory: pathlib.Path, entry: str,
                argument: str, count: int = 2,
                timeout: float = PROCESS_TIMEOUT) -> None:
    """`count` worker processes, each `chip_smoke.<entry>(argument)` in
    its own python (cwd the repo root), joined through the AIKO_*
    contract on localhost; their logs go under `directory` and their
    `[<phase>` lines are relayed.  Exits unless all end with code 0 and
    print "rank <r> done" within `timeout` seconds; a worker still
    running then is killed."""
    import os
    import socket
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    workers, logs = [], []
    try:
        for rank in range(count):
            env = {key: value for key, value in os.environ.items()
                   if not key.startswith("AIKO_")}
            env.update(PYTHONPATH=str(ROOT),
                       AIKO_COORDINATOR=f"127.0.0.1:{port}",
                       AIKO_NUM_PROCESSES=str(count),
                       AIKO_PROCESS_ID=str(rank))
            logs.append(open(directory / f"rank{rank}.log", "w"))
            workers.append(subprocess.Popen(
                [sys.executable, "-c", f"import sys, chip_smoke; "
                 f"chip_smoke.{entry}(sys.argv[1])", argument],
                cwd=ROOT, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(worker.poll() is None for worker in workers):
            failed = [worker for worker in workers
                      if worker.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
            worker.wait()
        for log in logs:
            log.close()
    texts = [(directory / f"rank{rank}.log").read_text()
             for rank in range(count)]
    for text in texts:
        for line in text.splitlines():
            if line.startswith(f"[{phase}"):
                print(line, flush=True)
    codes = [worker.returncode for worker in workers]
    if codes != [0] * count or any(f"rank {rank} done" not in text
                                   for rank, text in enumerate(texts)):
        raise SystemExit(f"{phase}: workers exited {codes}; their logs "
                         f"end:\n" + "\n".join(text[-3000:]
                                                for text in texts))


def phase_processes(smi: str) -> dict:
    """Phase 17: sharded training across two processes on the card.
    Returns the kernel launches of both workers' main-path steps."""
    import shutil
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    reference = process_references(PROCESS_ARMS)
    reference_s = time.perf_counter() - start
    run_workers("17", PROCESS_DIR, "process_worker",
                json.dumps([smi, reference]))
    results = [json.loads((PROCESS_DIR / f"rank{rank}.json").read_text())
               for rank in range(2)]
    launches = {name: 0 for name in kernels.KERNELS}
    for result in results:
        for arm in result["arms"]:
            add_launches(launches, arm["launches"])
    replicas = equal_replicas(results, "17")
    if min(launches.values()) == 0:
        raise SystemExit(f"17: a kernel never launched: {launches}")
    shutil.rmtree(PROCESS_DIR, ignore_errors=True)
    say("17 processes", workers=2, backend="gloo", devices="cuda:0 x 2 each",
        reference_s=f"{reference_s:.1f}", replicas_equal=replicas,
        k1_cases=[result["k1_cases"] for result in results],
        k2_k3_cases=[result["k2_k3_cases"] for result in results],
        kernel_builds_in_workers=0,
        wall_s=f"{time.perf_counter() - start:.1f}",
        launches=json.dumps(launches), card=repr(smi))
    return launches


# -- phase 18: sequence parallelism across processes --------------------------
#
# Phase 17's harness (run_workers): two gloo worker processes on the one
# card, each owning one "seq" position on cuda:0 (local_device_ids [0]),
# a global {"seq": 2} mesh over both, the weights drawn on the card from
# one seed in each process (draw_on_card).  Each process embeds,
# projects and runs the FFN on its half of the sequence; a ring hop,
# Ulysses' all_to_alls, the cached prefill's K/V gather and the sp
# decode's pmax and psum cross the process boundary through host memory
# (gloo).  Each worker runs an arm's reference on a one-process mesh of
# the card first (phase 12's paths), then the arm across the processes;
# only the latter's launches, collectives and staged bytes are counted,
# and they are held to the counts worked out from the shapes in advance
# (seq_expected).

SEQ_DIR = ROOT / "build" / "seq_processes"
SEQ_SEED = 18
SEQ_TRAIN_LAYERS = 4          # 18b: depth cut, widths kept
SEQ_TRAIN_STEPS = 2           # 18b: 1 + 2 steps, the first not counted
SEQ_REMAT_LAYERS = 2          # 18d: f32, depth cut
SEQ_REMAT_LEN = 2048          # 18d: the step's positions
SEQ_REMAT_POLICIES = ("nothing_saveable", "dots_saveable")
# 18b: the same steps on a one-process {"seq": 2} mesh run the same code,
# so their losses may differ only by the order in which the processes'
# gradient shares are summed (bf16 parameters after each adamw update):
# on an H100 they read 4.482e-5.  The first step's loss is also
# held against the unsharded non-SP step's, at 12c's TRAIN_LOSS_ATOL.
SEQ_SAME_PATH_LOSS_ATOL = 1e-3


def nccl_job() -> bool:
    """Whether this process joined a job over NCCL (cards mode's phase
    20), where no exchange stages through host memory."""
    import torch.distributed as dist
    return dist.is_initialized() and dist.get_backend() == "nccl"


def seq_measured(run) -> tuple:
    """(run()'s result, what it cost on this process: seconds, K1/K2/K3
    launches, collective calls and bytes, bytes staged through host
    memory, peak bytes allocated on the card)."""
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        collective_totals, reset_collective_counts, staged_bytes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    reset_collective_counts()
    start = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    calls, size = collective_totals()
    return result, {"seconds": seconds, "launches": launch_counts(),
                    "calls": calls, "bytes": size, "staged": staged_bytes(),
                    "peak": torch.cuda.max_memory_allocated()}


def seq_expected(config, kind: str, length: int, rank: int,
                 whole: tuple = (0, 0), new_tokens: int = 0,
                 size: int = 2) -> dict:
    """What one arm issues on this rank of a causal {"seq": size} ring
    (or Ulysses) across `size` processes, worked out from the shapes: K1
    (and K2, K3) launches -- rank r runs r + 1 hops a layer, each one
    launch -- and its collective calls and bytes, each call counting this
    process's block (B 1, H heads after the K/V expansion, L/size
    positions); the ring moves its blocks size - 1 hops a layer:
      - a forward hop: one ppermute of K and V;
      - a backward hop: one of K, V and their f32 dK, dV; one more
        returns dK, dV home;
      - Ulysses: one all_to_all of q, k, v stacked and one of O;
      - the cached prefill: one all_gather of the un-expanded K/V block;
      - a decode step: per layer one pmax of the (B, Hkv, G, 1) maxima
        and one psum of [num, den], f32;
      - a train step: one all_reduce of each whole parameter's gradient
        (`whole`: the count of such leaves and their bytes)."""
    layers, heads, hd = config.n_layers, config.n_heads, config.head_dim
    width = torch.empty((), dtype=config.torch_dtype).element_size()
    block = length // size
    qkv = heads * block * hd               # elements of one expanded block
    hop = 2 * qkv * width
    hops = rank + 1
    if kind == "ring":
        return {"launches": {"flash_attention": layers * hops,
                             "flash_attention_dq": 0,
                             "flash_attention_dkv": 0},
                "calls": layers * (size - 1),
                "bytes": layers * (size - 1) * hop}
    if kind == "ulysses":
        return {"launches": {"flash_attention": layers,
                             "flash_attention_dq": 0,
                             "flash_attention_dkv": 0},
                "calls": 2 * layers,
                "bytes": layers * (3 * qkv + qkv) * width}
    if kind == "generate":
        groups = heads // config.n_kv_heads
        prefill = hop + 2 * config.n_kv_heads * block * hd * width
        step = config.n_kv_heads * groups * 4 * (1 + hd + 1)
        return {"launches": {"flash_attention": layers * hops,
                             "flash_attention_dq": 0,
                             "flash_attention_dkv": 0},
                "calls": 2 * layers * new_tokens,
                "bytes": layers * (prefill + (new_tokens - 1) * step)}
    forwards = 2 if kind == "remat" else 1
    backward = qkv * (2 * 4 + 2 * width) + qkv * 2 * 4
    return {"launches": {"flash_attention": forwards * layers * hops,
                         "flash_attention_dq": layers * hops,
                         "flash_attention_dkv": layers * hops},
            "calls": (forwards + 2) * layers + whole[0],
            "bytes": layers * (forwards * hop + backward) + whole[1]}


def seq_report(label: str, rank: int, smi: str, cost: dict,
               expected: dict, tokens: int, **fields) -> None:
    """One arm's line, then its launches and collectives held to the
    counts worked out in advance."""
    say(f"{label} rank{rank}", ms=f"{cost['seconds'] * 1e3:.1f}",
        tokens_per_s=f"{tokens / cost['seconds']:.1f}", **fields,
        launches=json.dumps(cost["launches"]),
        expected_launches=json.dumps(expected["launches"]),
        collective_calls=cost["calls"],
        expected_collective_calls=expected["calls"],
        collective_mib=f"{cost['bytes'] / 2**20:.3f}",
        expected_collective_mib=f"{expected['bytes'] / 2**20:.3f}",
        host_staged_mib=f"{cost['staged'] / 2**20:.1f}",
        max_memory_allocated_gib=f"{cost['peak'] / 2**30:.2f}",
        card=repr(smi))
    if (cost["launches"] != expected["launches"]
            or cost["calls"] != expected["calls"]
            or cost["bytes"] != expected["bytes"]):
        raise SystemExit(f"{label} rank {rank}: issued {cost}, worked out "
                         f"from the shapes: {expected}")


def warm_exchanges(mesh, axis_name: str) -> None:
    """One ring hop and one all_to_all of a few bytes over `axis_name`,
    untimed: the process group and its transport's connections (NCCL
    makes both at first use) are made here, not inside the first
    measured call."""
    from aiko_services_tpu_torch.parallel import collectives
    size = mesh.size(axis_name)
    grid = np.empty(mesh.devices.shape, dtype=object)
    for position in np.ndindex(mesh.devices.shape):
        if mesh.local[position]:
            grid[position] = torch.zeros(size, device=mesh.devices[position])
    with torch.no_grad():
        collectives.ppermute(grid, mesh, axis_name,
                             [(i, (i + 1) % size) for i in range(size)])
        collectives.all_to_all(grid, mesh, axis_name, split_dim=0,
                               concat_dim=0)
    synchronize_cards(list(mesh.devices[mesh.local]))


def seq_tokens(config, shape, seed: int):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, config.vocab_size, shape)).cuda()


def seq_prefill(rank: int, mesh, smi: str, label: str = "18a") -> dict:
    """18a (20c): llama32_1b at full width and depth, bf16, one 1 x
    SP_SEQ prompt through the ring and through Ulysses across the
    processes of `mesh`'s "seq" axis, against 12b's path (the one-process
    {"seq": SP_SIZE} forward on the same weights, on this process's
    card).  On an NCCL job nothing is staged through host memory."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import LLAMA32_1B, forward
    from aiko_services_tpu_torch.parallel import use_mesh
    params = draw_on_card(LLAMA32_1B, SEQ_SEED)
    tokens = seq_tokens(LLAMA32_1B, (1, SP_SEQ), 1801)
    launches = {name: 0 for name in launch_counts()}
    size = mesh.size("seq")
    card = f"cuda:{torch.cuda.current_device()}"
    warm_exchanges(mesh, "seq")
    for mechanism in ("ring", "ulysses"):
        config = replace(LLAMA32_1B, sequence_parallel=True,
                         sp_mechanism=mechanism)
        with use_mesh(seq_mesh(device=card)), torch.no_grad():
            reference = forward(params, config, tokens)
        with use_mesh(mesh), torch.no_grad():
            logits, cost = seq_measured(
                lambda: forward(params, config, tokens))
        if not (logits.shape == reference.shape
                and torch.isfinite(logits).all()):
            raise SystemExit(f"{label} rank {rank}: {mechanism} logits "
                             f"{tuple(logits.shape)} not finite")
        error = (logits - reference).abs().max().item()
        same = (logits.argmax(-1) == reference.argmax(-1)).float().mean(
            ).item()
        del logits, reference
        torch.cuda.empty_cache()
        seq_report(f"{label} prefill_across_processes", rank, smi, cost,
                   seq_expected(config, mechanism, SP_SEQ, rank, size=size),
                   SP_SEQ, mechanism=mechanism, seq_axis=size,
                   logits_max_abs_diff_vs_12b=f"{error:.3e}",
                   same_argmax_share=f"{same:.4f}")
        if error > SP_LOGITS_GROSS_TOL or same < SP_ARGMAX_FLOOR:
            raise SystemExit(f"{label} rank {rank}: {mechanism} logits "
                             f"differ from 12b's by {error:.3e} (argmax "
                             f"share {same:.4f})")
        if nccl_job() and cost["staged"]:
            raise SystemExit(f"{label} rank {rank}: {mechanism} staged "
                             f"{cost['staged']} bytes through host memory "
                             f"on NCCL")
        add_launches(launches, cost["launches"])
    del params
    torch.cuda.empty_cache()
    return launches


def whole_leaves(params) -> tuple:
    """(leaves, bytes) of a tree whose every leaf is whole: on {"seq": 2}
    each one's gradient is summed across the processes."""
    leaves = [leaf for _, leaf in leaf_items(params)]
    return len(leaves), sum(leaf.numel() * leaf.element_size()
                            for leaf in leaves)


def seq_train(rank: int, mesh, smi: str) -> dict:
    """18b: llama32_1b at full width, depth cut to SEQ_TRAIN_LAYERS,
    bf16, 1 x SP_SEQ, 1 + SEQ_TRAIN_STEPS adamw steps through the ring
    across the processes, against the same steps through the ring on a
    one-process {"seq": 2} mesh (losses, SEQ_SAME_PATH_LOSS_ATOL), and
    the first step's loss against the unsharded non-SP step's on the
    same weights and tokens (12c's TRAIN_LOSS_ATOL)."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        LLAMA32_1B, adamw, make_train_step)
    from aiko_services_tpu_torch.parallel import create_mesh, use_mesh
    config = replace(LLAMA32_1B, n_layers=SEQ_TRAIN_LAYERS,
                     sequence_parallel=True)
    batches = [seq_tokens(config, (1, SP_SEQ + 1), 1810 + index)
               for index in range(1 + SEQ_TRAIN_STEPS)]

    def steps(run_mesh) -> tuple:
        params = draw_on_card(config, SEQ_SEED)
        size = whole_leaves(params)
        optimizer = adamw(SHARD_LR)
        state = optimizer.init(params)
        step = make_train_step(config, optimizer, sharded=True)
        losses, costs = [], []
        with use_mesh(run_mesh):
            for index, batch in enumerate(batches):
                (params, state, loss), cost = seq_measured(
                    lambda: step(params, state, batch))
                losses.append(loss.item())
                costs.append(cost)
        del params, state, step
        torch.cuda.empty_cache()
        return losses, costs[1:], size

    params = draw_on_card(config, SEQ_SEED)
    optimizer = adamw(SHARD_LR)
    dense = make_train_step(replace(config, sequence_parallel=False),
                            optimizer)(params, optimizer.init(params),
                                       batches[0])[2].item()
    del params, optimizer
    torch.cuda.empty_cache()
    reference, _, _ = steps(create_mesh({"seq": 2},
                                        devices=["cuda:0"] * 2))
    losses, costs, size = steps(mesh)
    loss_diff = max(abs(a - b) for a, b in zip(losses, reference))
    dense_diff = abs(losses[0] - dense)
    cost = {"seconds": statistics.median(c["seconds"] for c in costs),
            "launches": costs[-1]["launches"], "calls": costs[-1]["calls"],
            "bytes": costs[-1]["bytes"], "staged": costs[-1]["staged"],
            "peak": max(c["peak"] for c in costs)}
    if any((c["launches"], c["calls"], c["bytes"])
           != (cost["launches"], cost["calls"], cost["bytes"])
           for c in costs):
        raise SystemExit(f"18b rank {rank}: the steps issued {costs}")
    seq_report("18b train_across_processes", rank, smi, cost,
               seq_expected(config, "train", SP_SEQ, rank, size), SP_SEQ,
               layers=config.n_layers, batch=f"1x{SP_SEQ}",
               steps=f"1+{SEQ_TRAIN_STEPS}",
               losses=json.dumps([round(value, 6) for value in losses]),
               one_process_losses=json.dumps([round(value, 6)
                                              for value in reference]),
               loss_max_abs_diff=f"{loss_diff:.3e}",
               loss_limit=SEQ_SAME_PATH_LOSS_ATOL,
               non_sp_first_loss=f"{dense:.6f}",
               first_loss_abs_diff_vs_non_sp=f"{dense_diff:.3e}",
               non_sp_limit=TRAIN_LOSS_ATOL)
    if not (np.isfinite(losses).all()
            and loss_diff <= SEQ_SAME_PATH_LOSS_ATOL
            and dense_diff <= TRAIN_LOSS_ATOL):
        raise SystemExit(f"18b rank {rank}: losses {losses} vs the "
                         f"one-process ring's {reference}, the first vs "
                         f"the non-SP step's {dense}")
    return {name: count * len(costs)
            for name, count in cost["launches"].items()}


def seq_generate(rank: int, mesh, smi: str) -> dict:
    """18c: llama32_1b at full depth, a 1 x SP_PROMPT prompt and SP_NEW
    new tokens -- the ring's cached prefill, then the sp decode over the
    cache's windows -- across the processes, against 12d's SP generate
    on a one-process {"seq": 2} mesh with the same layout (tokens
    identical).  That reference runs the same seq-cut code, so the
    cached prefill's logits and one decode step's (the first generated
    token forced on both sides) are also held against the non-SP path's
    on the same weights, at 12b's SP_LOGITS_GROSS_TOL / SP_ARGMAX_FLOOR;
    the first token equals the non-SP one unless the non-SP logits
    there are a near-tie (top-2 gap within SP_LOGITS_GROSS_TOL)."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        LLAMA32_1B, cache_specs, forward, generate, init_cache,
        init_sp_cache)
    from aiko_services_tpu_torch.parallel import (
        create_mesh, filter_specs, shard_pytree, use_mesh)
    config = replace(LLAMA32_1B, sequence_parallel=True)
    params = draw_on_card(config, SEQ_SEED)
    prompt = seq_tokens(config, (1, SP_PROMPT), 1820).to(torch.int32)

    def sp_cache(run_mesh):
        return shard_pytree(
            init_sp_cache(config, 1, SP_PROMPT + SP_NEW, run_mesh, "cuda"),
            run_mesh, filter_specs(cache_specs(sequence_parallel=True),
                                   run_mesh))

    def run(run_mesh):
        with use_mesh(run_mesh):
            return generate(params, config, prompt, SP_NEW,
                            cache=sp_cache(run_mesh))[0]

    reference = run(create_mesh({"seq": 2}, devices=["cuda:0"] * 2))
    tokens, cost = seq_measured(lambda: run(mesh))
    same = torch.equal(tokens, reference)
    # the witness from another path: the non-SP cached prefill and step
    dense = replace(config, sequence_parallel=False)
    first = tokens[:, :1]
    with torch.no_grad():
        want, dense_cache = forward(params, dense, prompt, cache=init_cache(
            dense, 1, SP_PROMPT + SP_NEW, device="cuda"), pos=0)
        want_step = forward(params, dense, first, cache=dense_cache,
                            pos=SP_PROMPT)[0]
        del dense_cache
        with use_mesh(mesh):
            got, cache = forward(params, config, prompt,
                                 cache=sp_cache(mesh), pos=0)
            got_step = forward(params, config, first, cache=cache,
                               pos=SP_PROMPT)[0]
        del cache
    error = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    step_error = (got_step - want_step).abs().max().item()
    top = torch.topk(want[0, -1].float(), 2).values
    gap = (top[0] - want[0, -1, int(first)].float()).item()
    del got, want, got_step, want_step
    torch.cuda.empty_cache()
    seq_report("18c generate_across_processes", rank, smi, cost,
               seq_expected(config, "generate", SP_PROMPT, rank,
                            new_tokens=SP_NEW), SP_NEW,
               prompt=SP_PROMPT, new_tokens=SP_NEW,
               identical_to_one_process=same,
               prefill_logits_max_abs_diff_vs_non_sp=f"{error:.3e}",
               prefill_same_argmax_share=f"{agree:.4f}",
               step_logits_max_abs_diff_vs_non_sp=f"{step_error:.3e}",
               first_token_non_sp_logit_gap=f"{gap:.4f}",
               non_sp_top2_gap=f"{(top[0] - top[1]).item():.4f}")
    if not same:
        raise SystemExit(f"18c rank {rank}: tokens {tokens.tolist()} vs "
                         f"the one-process SP generate's "
                         f"{reference.tolist()}")
    if (error > SP_LOGITS_GROSS_TOL or agree < SP_ARGMAX_FLOOR
            or step_error > SP_LOGITS_GROSS_TOL
            or gap > SP_LOGITS_GROSS_TOL):
        raise SystemExit(f"18c rank {rank}: against the non-SP path the "
                         f"prefill logits differ by {error:.3e} (argmax "
                         f"share {agree:.4f}), the step's by "
                         f"{step_error:.3e}; the first token's logit is "
                         f"{gap:.4f} below the non-SP maximum")
    del params
    torch.cuda.empty_cache()
    return cost["launches"]


def seq_remat(rank: int, mesh, smi: str) -> dict:
    """18d: llama32_1b widths in f32 at SEQ_REMAT_LAYERS layers, one
    train step through the ring across the processes under each of
    SEQ_REMAT_POLICIES (nothing_saveable keeps each layer's inputs,
    dots_saveable its products too), against the unsharded step's
    gradients (like 17b).  The step's own peak is the f32 head's
    transient, alike under both; so each layer's end also reads the
    card's allocator: the peak over the layers' forward and what the
    layers leave held for the backward, each above what the card held as
    the step began."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import (
        LLAMA32_1B, adamw, make_train_step)
    from aiko_services_tpu_torch.models import transformer as lm_module
    from aiko_services_tpu_torch.parallel import use_mesh
    config = replace(LLAMA32_1B, n_layers=SEQ_REMAT_LAYERS, dtype="float32")
    batch = seq_tokens(config, (1, SEQ_REMAT_LEN + 1), 1830)
    grads = {}

    def prepared(run_config, name, **options):
        """(the step on fresh weights, the weights' (leaves, bytes))."""
        params = draw_on_card(run_config, SEQ_SEED)
        optimizer = recording(adamw(SHARD_LR), lambda _, tree: grads.update(
            {name: tree_to(tree, "cuda")}))
        train_step = make_train_step(run_config, optimizer, **options)
        state = optimizer.init(params)
        return (lambda: train_step(params, state, batch)[2].item(),
                whole_leaves(params))

    whole_loss = prepared(config, "whole")[0]()
    torch.cuda.empty_cache()
    sp_config = replace(config, sequence_parallel=True)
    launches = {name: 0 for name in launch_counts()}
    remat_across, reads = lm_module._remat_across, []

    def read_after(*args):
        """The layer, then (peak, allocated) on this card (the
        allocator's counters are kept on the host: no synchronization)."""
        out = remat_across(*args)
        reads.append((torch.cuda.max_memory_allocated(),
                      torch.cuda.memory_allocated()))
        return out
    for policy in SEQ_REMAT_POLICIES:
        step, size = prepared(sp_config, policy, sharded=True,
                              remat_policy=policy)
        reads.clear()

        def run(step=step):
            reads.append((0, torch.cuda.memory_allocated()))
            return step()
        lm_module._remat_across = read_after
        try:
            with use_mesh(mesh):
                loss, cost = seq_measured(run)
        finally:
            lm_module._remat_across = remat_across
        del run, step
        if len(reads) != 1 + config.n_layers:
            raise SystemExit(f"18d rank {rank} {policy}: {len(reads) - 1} "
                             f"layers went through the remat node, not "
                             f"{config.n_layers}")
        base = reads[0][1]
        grad_leaf, grad_error = local_relative(grads.pop(policy),
                                               grads["whole"])
        seq_report("18d remat_across_processes", rank, smi, cost,
                   seq_expected(sp_config, "remat", SEQ_REMAT_LEN, rank,
                                size),
                   SEQ_REMAT_LEN, policy=policy, layers=config.n_layers,
                   dtype=config.dtype,
                   layers_peak_gib=f"{(reads[-1][0] - base) / 2**30:.3f}",
                   held_after_layers_gib=(
                       f"{(reads[-1][1] - base) / 2**30:.3f}"),
                   loss_abs_diff=f"{abs(loss - whole_loss):.3e}",
                   grad_rel_err=f"{grad_error:.3e}",
                   grad_worst_leaf=grad_leaf)
        if not (abs(loss - whole_loss) <= SHARD_F32_LOSS_ATOL
                and grad_error <= SHARD_F32_GRAD_REL_TOL):
            raise SystemExit(f"18d rank {rank} {policy}: loss {loss} vs "
                             f"unsharded {whole_loss}; gradient "
                             f"{grad_error:.3e} relative at {grad_leaf} "
                             f"(limit {SHARD_F32_GRAD_REL_TOL})")
        add_launches(launches, cost["launches"])
        torch.cuda.empty_cache()
    return launches


def seq_worker(argument: str) -> None:
    """One rank of phase 18, in its own process: joins the job with one
    position on cuda:0, loads the kernels phase 1 built (no build here),
    runs 18a-18d, holds each new K1/K2/K3 case against its plain version
    (18e) and writes its launches under SEQ_DIR."""
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        global_mesh, initialize_distributed, process_index,
        shutdown_distributed)
    smi = json.loads(argument)
    if not torch.cuda.is_available():
        raise SystemExit("phase 18 worker: no CUDA device")
    if not initialize_distributed(backend="gloo", local_device_ids=[0],
                                  timeout_seconds=PROCESS_TIMEOUT):
        raise SystemExit("phase 18 worker: no AIKO_* job to join")
    rank = process_index()
    for name in kernels.KERNEL_SOURCES:
        kernels.load_kernel(name)
    mesh = global_mesh({"seq": 2})
    if mesh.process_axes != ("seq",):
        raise SystemExit(f"phase 18 worker: {mesh} does not span the "
                         f"processes on 'seq'")
    forward, backward = set(), set()
    launches = {name: 0 for name in kernels.KERNELS}
    with recorded_kernel_cases(forward, backward):
        for arm in (seq_prefill, seq_train, seq_generate, seq_remat):
            add_launches(launches, arm(rank, mesh, smi))
    cases = check_new_cases(forward, backward, "18", f"18e rank{rank}",
                            1900)
    builds = sorted(kernels.build_seconds)
    (SEQ_DIR / f"rank{rank}.json").write_text(json.dumps({
        "launches": launches, "cases": cases, "builds": builds}))
    shutdown_distributed()
    if builds:
        raise SystemExit(f"phase 18 worker {rank} built {builds}: it must "
                         f"load what phase 1 built")
    print(f"rank {rank} done", flush=True)


def phase_seq_processes(smi: str) -> dict:
    """Phase 18: sequence parallelism across two processes on the card.
    Returns the kernel launches of both workers' main-path runs."""
    import shutil
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    shutil.rmtree(SEQ_DIR, ignore_errors=True)
    SEQ_DIR.mkdir(parents=True)
    run_workers("18", SEQ_DIR, "seq_worker", json.dumps(smi))
    results = [json.loads((SEQ_DIR / f"rank{rank}.json").read_text())
               for rank in range(2)]
    launches = {name: 0 for name in kernels.KERNELS}
    for result in results:
        add_launches(launches, result["launches"])
    if min(launches.values()) == 0:
        raise SystemExit(f"18: a kernel never launched: {launches}")
    shutil.rmtree(SEQ_DIR, ignore_errors=True)
    say("18 seq_processes", workers=2, backend="gloo",
        devices="cuda:0 x 1 each", mesh=json.dumps({"seq": 2}),
        new_cases=[result["cases"] for result in results],
        kernel_builds_in_workers=0,
        wall_s=f"{time.perf_counter() - start:.1f}",
        launches=json.dumps(launches), card=repr(smi))
    return launches


# -- cards mode: the mesh on several cards --------------------------------------
#
# `python3 chip_smoke.py cards`, on a machine with four cards or more (the
# first four take part where a phase names four): one process drives
# meshes whose positions lie on distinct cards (19b-19d), then four
# worker processes each own one card as one NCCL rank (20).  Every phase
# holds the cards against the same work on cuda:0 alone or against the
# unsharded steps; each card's peak is read with card_peaks.  The cards
# phases build the kernels as phase 1 does and end with the same three
# lines as the plain mode.

CARDS = 4                     # 19c, 19d and 20: four cards, four ranks
CARDS_8B_AXES = {"fsdp": 2, "model": 4}    # 19b: 13a's eight positions
CARDS_TRAIN_AXES = {"fsdp": 2, "model": 2}  # 19c and 20a
CARDS_TRAIN_STEPS = 2         # 19c: 1 + 2 steps, the first not counted
CARDS_8B_NEW_TOKENS = 64      # 19b: the example ships 128
CARDS_COPY_BYTES = 2 ** 30    # 19a: the peer-copy yardstick's block
CARDS_TIMEOUT = 600           # phase 20's workers together, seconds
CARDS_PROCESS_ARMS = (        # (label, dtype, layers: None for all, axes)
    ("20a", "bfloat16", None, CARDS_TRAIN_AXES),
    ("20b", "float32", SHARD_F32_LAYERS, {"fsdp": 2, "model": 2}),
    ("20b", "float32", SHARD_F32_LAYERS, {"data": 2, "fsdp": 2}),
)


def card_list() -> list:
    return [torch.device("cuda", index)
            for index in range(torch.cuda.device_count())]


def spread(positions: int, cards: list) -> list:
    """`positions` devices over `cards`, in order, as evenly as they
    go: eight positions over four cards sit two a card."""
    return [cards[index * len(cards) // positions]
            for index in range(positions)]


def distinct_cards(devices) -> list:
    return sorted({torch.device(device).index for device in devices})


def reset_peaks(devices) -> None:
    """Reset the peak of every card `devices` names."""
    for index in distinct_cards(devices):
        torch.cuda.reset_peak_memory_stats(index)


def card_peaks(devices) -> dict:
    """{cuda:i: GiB} -- max_memory_allocated of every card `devices`
    names, since its last reset_peaks."""
    return {f"cuda:{index}": round(torch.cuda.max_memory_allocated(index)
                                   / 2 ** 30, 2)
            for index in distinct_cards(devices)}


def synchronize_cards(devices) -> None:
    for index in distinct_cards(devices):
        torch.cuda.synchronize(index)


def free_cards(devices) -> None:
    """Return the caching allocator's free blocks on every card."""
    gc.collect()
    for index in distinct_cards(devices):
        with torch.cuda.device(index):
            torch.cuda.empty_cache()


def host_ms(function, devices, warmup: int = 1, runs: int = 5) -> float:
    """Median milliseconds of `function` on the host clock, each call
    ending when every card of `devices` is done (CUDA events time one
    card's stream; this work spans several)."""
    for _ in range(warmup):
        function()
    synchronize_cards(devices)
    times = []
    for _ in range(runs):
        start = time.perf_counter()
        function()
        synchronize_cards(devices)
        times.append(time.perf_counter() - start)
    return statistics.median(times) * 1e3


@contextlib.contextmanager
def launches_by_card(counts: dict):
    """Within the block, every K1/K2/K3 launch adds one to
    counts[cuda:i][kernel] of the card it ran on (the wrappers and their
    own counts stay as they are)."""
    from aiko_services_tpu_torch.parallel import attention
    launch = attention._launch

    def counted(kernel, symbol, device, *arguments):
        launch(kernel, symbol, device, *arguments)
        card = counts.setdefault(str(torch.device(device)), {})
        card[kernel] = card.get(kernel, 0) + 1
    attention._launch = counted
    try:
        yield counts
    finally:
        attention._launch = launch


def tree_equal(a, b) -> bool:
    """Every leaf of two trees (Sharded leaves unsharded) bit for bit
    equal."""
    from aiko_services_tpu_torch.parallel import unshard
    wants = dict(leaf_items(b))
    for name, leaf in leaf_items(a):
        got = unshard(leaf)
        if not torch.equal(got, unshard(wants[name]).to(got.device)):
            return False
    return True


def phase_cards_topology(smi: str, cards: list) -> dict:
    """19a: the cards and their links (nvidia-smi topo -m), a 1 GiB bf16
    copy cuda:0 -> cuda:k timed on each card, then phase 2's K1 and
    K2/K3 cases on every card but cuda:0 (which phase 2's own run
    covers), each against its plain version there, each launched twice
    and bitwise equal.  Returns the O and gradient max abs errors at the
    serving and training shapes, the worst over the cards."""
    # a machine may refuse the topology query: then its message stands
    # in, and torch's peer-access matrix says which cards reach which
    topology = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True, timeout=60)
    lines = (topology.stdout.rstrip().splitlines()
             if topology.returncode == 0 else
             [f"nvidia-smi topo -m exited {topology.returncode}: "
              f"{(topology.stdout + topology.stderr).strip()[:300]!r}"])
    for line in lines:
        print(f"[19a topology] {line.rstrip()}", flush=True)
    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    peers = {str(card): [str(other) for other in cards if other != card
                         and torch.cuda.can_device_access_peer(
                             card.index, other.index)]
             for card in cards}
    say("19a cards", count=len(cards), cards=json.dumps(names),
        peer_access=json.dumps(peers), card=repr(smi))
    source = torch.randn(CARDS_COPY_BYTES // 2, device=cards[0]).to(
        torch.bfloat16)
    for target_card in cards[1:]:
        target = torch.empty_like(source, device=target_card)
        pair = [cards[0], target_card]
        ms = host_ms(lambda: target.copy_(source), pair, warmup=2, runs=10)
        if not torch.equal(target[:: 1 << 16].to(cards[0]),
                           source[:: 1 << 16]):
            raise SystemExit(f"19a: the copy to {target_card} differs")
        say("19a peer_copy", source=str(cards[0]), target=str(target_card),
            mib=CARDS_COPY_BYTES // 2 ** 20, dtype="bfloat16",
            peer_access=torch.cuda.can_device_access_peer(
                0, target_card.index),
            ms=f"{ms:.3f}", gb_per_s=f"{CARDS_COPY_BYTES / ms / 1e6:.1f}",
            card=repr(smi))
        del target
    del source
    errors = {"flash_attention": 0.0, "flash_attention_dq": 0.0,
              "flash_attention_dkv": 0.0}
    for target_card in cards[1:]:
        serving = phase_kernel_checks("19a kernel_vs_plain", target_card)
        training = phase_backward_checks("19a backward_vs_plain",
                                         target_card)
        errors["flash_attention"] = max(errors["flash_attention"], serving)
        for name, error in training.items():
            errors[name] = max(errors[name], error)
        torch.cuda.empty_cache()
    return errors


def cards_8b_arm(smi: str, devices: list, weights: dict | None) -> tuple:
    """One arm of 19b: examples/pipeline_llm_8b.json (only `runtime` and
    the element module changed, 13a's token cut) with its lm's positions
    on `devices`, serving `weights` (None: 13a's, drawn on the first
    card from the element's config with draw_on_card, seed 0) installed
    through restore_state; then SHARD_DECODE_STEPS decode steps on the
    element's sharded state, timed and counted.  Returns (generated
    tokens, K1/K2/K3 launches, the line's fields, the weights)."""
    from aiko_services_tpu_torch.models import forward
    from aiko_services_tpu_torch.models import transformer
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        Sharded, collective_totals, reset_collective_counts,
        set_default_devices, sharded_leaves)
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import Process
    definition = port_definition(PIPELINE_8B)
    lm = next(element for element in definition["elements"]
              if element["name"] == "lm")
    lm["sharding"]["axes"] = CARDS_8B_AXES
    lm["sharding"]["devices"] = [0, len(devices)]
    lm["parameters"]["max_new_tokens"] = max_new = CARDS_8B_NEW_TOKENS
    prompt_text = definition["elements"][0]["parameters"][
        "data_sources"][0]
    set_default_devices(devices)
    process = Process(transport_kind="loopback")
    try:
        start = time.perf_counter()
        pipeline = create_pipeline(process, definition)
        element = pipeline.elements["lm"]
        element.configure()
        if weights is None:
            weights = draw_on_card(element.config, int(
                lm["parameters"].get("seed", 0)))
        element.restore_state(weights)
        synchronize_cards(devices)
        setup_s = time.perf_counter() - start
        misplaced = [
            position for leaf in sharded_leaves(element.state)
            for position, tensor in np.ndenumerate(leaf.shards)
            if tensor.device != leaf.mesh.devices[position]]
        if misplaced or not isinstance(element.state["layers"]["wq"]["w"],
                                       Sharded):
            raise SystemExit(f"19b: blocks off their positions' cards at "
                             f"{misplaced[:4]}")
        process.run(in_thread=True)
        reset_peaks(devices)
        responses = queue.Queue()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        pipeline.create_stream("s1", queue_response=responses)
        _, _, outputs = responses.get(timeout=600)
        synchronize_cards(devices)
        elapsed = time.perf_counter() - start
        launches = launch_counts()
        generated = torch.as_tensor(outputs["generated"]).cpu()
        if generated.shape != (1, max_new) or not outputs["text"]:
            raise SystemExit(f"19b: generated {tuple(generated.shape)}, "
                             f"text {outputs['text']!r}")
        config, state = element.config, element.state
        tokens = torch.from_numpy(element._encode_prompts(
            None, prompt_text)[0]).to(devices[0])
        cache = transformer._prompt_cache(state, config, tokens,
                                          SHARD_DECODE_STEPS + 1, None)
        with torch.no_grad():
            logits, cache = forward(state, config, tokens, cache=cache)
        token = logits[:, -1:].argmax(-1).to(torch.int32)
        synchronize_cards(devices)
        reset_collective_counts()
        start = time.perf_counter()
        for step in range(SHARD_DECODE_STEPS):
            token, _, cache = transformer.decode_step(
                state, config, cache, token, tokens.shape[1] + step)
        synchronize_cards(devices)
        step_ms = (time.perf_counter() - start) / SHARD_DECODE_STEPS * 1e3
        calls, size = collective_totals()
        peaks = card_peaks(devices)
        del cache, logits, token
    finally:
        process.terminate()
        set_default_devices(None)
    fields = dict(
        mesh=json.dumps(CARDS_8B_AXES),
        devices=",".join(str(device) for device in devices),
        layers=config.n_layers, d_model=config.d_model,
        prompt_tokens=tokens.shape[1], new_tokens=max_new,
        setup_s=f"{setup_s:.1f}", tokens_per_s=f"{max_new / elapsed:.2f}",
        decode_step_ms=f"{step_ms:.2f}",
        collective_calls_per_step=calls / SHARD_DECODE_STEPS,
        collective_kib_per_step=f"{size / SHARD_DECODE_STEPS / 1024:.1f}",
        peak_gib_by_card=json.dumps(peaks))
    return generated, launches, fields, weights


def phase_cards_serving(smi: str, cards: list) -> dict:
    """19b: the 8B example on fsdp 2 x model 4 with its eight positions
    spread over the cards (two a card on four), against the same
    definition over cuda:0 eight times in the same run, on one draw of
    the weights (13a's: draw_on_card, seed 0): the 64 greedy tokens
    identical, decode-step ms, collective calls and KiB a step, each
    card's peak."""
    positions = int(np.prod(list(CARDS_8B_AXES.values())))
    launches = {name: 0 for name in launch_counts()}
    tokens, weights = {}, None
    for label, devices in (("cards", spread(positions, cards)),
                           ("one_card", [cards[0]] * positions)):
        generated, counted, fields, weights = cards_8b_arm(smi, devices,
                                                           weights)
        tokens[label] = generated
        add_launches(launches, counted)
        say(f"19b llama3_8b_{label}", **fields, card=repr(smi))
        free_cards(cards)
    del weights
    free_cards(cards)
    parting = first_difference(tokens["cards"], tokens["one_card"])
    say("19b llama3_8b_tokens", identical=parting < 0,
        first_difference=parting, card=repr(smi))
    if parting >= 0:
        raise SystemExit(f"19b: the 8B over the cards parts from cuda:0 x "
                         f"{positions} at token {parting}")
    return launches


def cards_train_arm(smi: str, config, devices: list, params: dict,
                    batches: list) -> dict:
    """One arm of 19c: 1 + CARDS_TRAIN_STEPS steps of
    make_train_step(sharded=True) on CARDS_TRAIN_AXES with its positions
    on `devices`, from `params` (copied); the first step not counted.
    Returns the losses, the parameters after (whole, on the first
    card), step ms, K1/K2/K3 launches a step by card and each card's
    peak."""
    from aiko_services_tpu_torch.models import (
        adamw, make_train_step, param_specs)
    from aiko_services_tpu_torch.parallel import (
        collective_totals, create_mesh, filter_specs,
        reset_collective_counts, shard_pytree)
    mesh = create_mesh(CARDS_TRAIN_AXES, devices=devices)
    sharded = copy_replicated(shard_pytree(
        params, mesh, filter_specs(param_specs(config), mesh)))
    optimizer = adamw(SHARD_LR)
    state = optimizer.init(sharded)
    step = make_train_step(config, optimizer, sharded=True)
    losses, times, by_card = [], [], {}
    with launches_by_card(by_card):
        for index, batch in enumerate(batches):
            if index == 1:  # the warm-up step is not counted
                synchronize_cards(devices)
                reset_peaks(devices)
                reset_collective_counts()
                by_card.clear()
            start = time.perf_counter()
            sharded, state, loss = step(sharded, state, batch)
            losses.append(loss.item())
            synchronize_cards(devices)
            times.append(time.perf_counter() - start)
    calls, size = collective_totals()
    steps = len(batches) - 1
    result = {"losses": losses,
              "after": tree_to(unsharded(sharded), devices[0]),
              "step_ms": statistics.median(times[1:]) * 1e3,
              "launches": {card: {name: count / steps
                                  for name, count in kernels_.items()}
                           for card, kernels_ in sorted(by_card.items())},
              "calls": calls / steps, "mib": size / steps / 2 ** 20,
              "peaks": card_peaks(devices)}
    del sharded, state, step
    free_cards(devices)
    return result


def phase_cards_training(smi: str, cards: list) -> dict:
    """19c: llama32_1b at full width and depth, bf16, 4 x 1024, adamw,
    1 + CARDS_TRAIN_STEPS sharded steps on fsdp 2 x model 2 with its four
    positions on four cards, against the same mesh over cuda:0 four
    times (13c's gates; whether they are bit-equal too): step ms,
    tokens/s, MFU over the cards' peak, each card's peak and K1/K2/K3
    launches a step a card.  Returns the launches of both arms."""
    from aiko_services_tpu_torch.models import LLAMA32_1B, count_params
    config = LLAMA32_1B
    rng = np.random.default_rng(19)
    batches = [torch.from_numpy(rng.integers(
        0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(cards[0])
        for _ in range(1 + CARDS_TRAIN_STEPS)]
    params = draw_on_card(config, 19)
    n_params = count_params(params)
    before = tree_to(params, cards[0])
    positions = int(np.prod(list(CARDS_TRAIN_AXES.values())))
    arms = {}
    launches = {name: 0 for name in launch_counts()}
    for label, devices in (("cards", spread(positions, cards[:CARDS])),
                           ("one_card", [cards[0]] * positions)):
        arms[label] = arm = cards_train_arm(smi, config, devices, params,
                                            batches)
        for per_card in arm["launches"].values():
            add_launches(launches, {name: int(count * CARDS_TRAIN_STEPS)
                                    for name, count in per_card.items()})
        tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / arm["step_ms"] * 1e3
        count = len(distinct_cards(devices))
        mfu = (6 * n_params * tokens_per_s
               / (count * peaks_for(smi)[1]["bfloat16"]))
        say(f"19c llama32_1b_train_{label}",
            mesh=json.dumps(CARDS_TRAIN_AXES),
            devices=",".join(str(device) for device in devices),
            layers=config.n_layers, batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}",
            steps=f"1+{CARDS_TRAIN_STEPS}",
            losses=json.dumps([round(value, 6) for value in arm["losses"]]),
            step_ms=f"{arm['step_ms']:.1f}",
            tokens_per_s=f"{tokens_per_s:.1f}", cards_counted=count,
            train_mfu=f"{mfu:.4f}",
            launches_per_step_by_card=json.dumps(arm["launches"]),
            collective_calls_per_step=arm["calls"],
            collective_mib_per_step=f"{arm['mib']:.1f}",
            peak_gib_by_card=json.dumps(arm["peaks"]), card=repr(smi))
    del params
    torch.cuda.empty_cache()
    cards_arm, one = arms["cards"], arms["one_card"]
    loss_diff = max(abs(a - b) for a, b in zip(cards_arm["losses"],
                                               one["losses"]))
    update_leaf, update_error = worst_relative(cards_arm["after"],
                                               one["after"], before)
    bit_equal = (cards_arm["losses"] == one["losses"]
                 and tree_equal(cards_arm["after"], one["after"]))
    per_card = {name: config.n_layers for name in launch_counts()}
    launches_ok = (len(cards_arm["launches"]) == positions and all(
        counts == per_card for counts in cards_arm["launches"].values()))
    say("19c cards_vs_one_card", loss_max_abs_diff=f"{loss_diff:.3e}",
        loss_limit=SHARD_LOSS_ATOL, update_rel_err=f"{update_error:.3e}",
        update_worst_leaf=update_leaf,
        update_limit=SHARD_BF16_UPDATE_REL_TOL, bit_equal=bit_equal,
        launches_per_card_as_layers=launches_ok, card=repr(smi))
    if not (np.isfinite(cards_arm["losses"]).all()
            and loss_diff <= SHARD_LOSS_ATOL
            and update_error <= SHARD_BF16_UPDATE_REL_TOL and launches_ok):
        raise SystemExit(f"19c: over the cards losses {cards_arm['losses']}"
                         f" vs {one['losses']}, parameter change "
                         f"{update_error:.3e} relative at {update_leaf}, "
                         f"launches a step by card {cards_arm['launches']}")
    return launches


def phase_cards_long_context(smi: str, cards: list) -> dict:
    """19d: 12a's ring forward + backward at (1, 32, 8192, 64) bf16 on
    {"seq": 4} with its positions on four cards, bit for bit the same
    mesh over cuda:0 four times, timed against one K1 + K2 + K3 call;
    then 12b's SP prefill (llama32_1b, 1 x 8192, ring and Ulysses) on the
    four cards against the non-SP forward at 12b's gates.  Returns the
    launches."""
    from dataclasses import replace
    from aiko_services_tpu_torch.models import LLAMA32_1B, forward
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        create_mesh, ring_attention, use_mesh)
    from aiko_services_tpu_torch.parallel.attention import (
        flash_attention_backward, flash_attention_forward)
    devices = cards[:CARDS]
    meshes = {"cards": create_mesh({"seq": CARDS}, devices=devices),
              "one_card": seq_mesh(CARDS, cards[0])}
    q, k, v = random_qkv(1, 32, SP_SEQ, SP_SEQ, 64, torch.bfloat16,
                         seed=1200, device=cards[0])
    dout = random_qkv(1, 32, SP_SEQ, 1, 64, torch.bfloat16, seed=1201,
                      device=cards[0])[0]
    launches = {name: 0 for name in launch_counts()}
    results, by_card = {}, {}
    for label, mesh in meshes.items():
        kernels.reset_launch_counts()
        with launches_by_card(by_card.setdefault(label, {})):
            out, grads, hops, counted = ring_pass(q, k, v, dout, CARDS,
                                                  True, mesh)
        add_launches(launches, counted)
        results[label] = (out, *grads)
        expected = CARDS * (CARDS + 1) // 2
        if hops != expected or set(counted.values()) != {expected}:
            raise SystemExit(f"19d: ring on {label} ran {hops} hops, "
                             f"launches {counted}; expected {expected}")
    bit_equal = all(torch.equal(a.to(cards[0]), b) for a, b in zip(
        results["cards"], results["one_card"]))
    placed = {str(out.device) for out in results["cards"]}
    del results
    inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    times = {}
    for label, mesh in meshes.items():
        def ring_step(mesh=mesh):
            out = ring_attention(*inputs, mesh, causal=True)
            torch.autograd.grad(out, inputs, dout)
        reset_peaks(devices)
        times[label] = host_ms(ring_step, devices, warmup=2, runs=10)
        times[f"{label}_peaks"] = card_peaks(devices)

    def one_call_step():
        out, lse = flash_attention_forward(q, k, v, causal=True)
        flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    one_call_ms = cuda_ms(one_call_step, warmup=2, runs=10)
    block = 32 * SP_SEQ // CARDS * 64
    say("19d ring_across_cards", shape=f"1x32x{SP_SEQ}x64", causal=True,
        seq_axis=CARDS, devices=",".join(str(device) for device in devices),
        bit_equal_to_one_card=bit_equal, results_on=sorted(placed),
        launches_by_card=json.dumps(by_card["cards"]),
        ring_fwd_bwd_ms=f"{times['cards']:.4f}",
        one_card_ring_fwd_bwd_ms=f"{times['one_card']:.4f}",
        one_k1_k2_k3_ms=f"{one_call_ms:.4f}",
        hop_mib_forward=f"{2 * block * 2 / 2 ** 20:.1f}",
        hop_mib_backward=f"{block * (2 * 2 + 2 * 4) / 2 ** 20:.1f}",
        peak_gib_by_card=json.dumps(times["cards_peaks"]), card=repr(smi))
    if not bit_equal:
        raise SystemExit("19d: the ring over the cards differs from the "
                         "same mesh over cuda:0")
    del q, k, v, dout, inputs
    torch.cuda.empty_cache()

    params = draw_on_card(LLAMA32_1B, 1202)
    tokens = torch.from_numpy(np.random.default_rng(1202).integers(
        0, LLAMA32_1B.vocab_size, (1, SP_SEQ)).astype(np.int32)).to(cards[0])
    with torch.no_grad():
        dense = forward(params, LLAMA32_1B, tokens)
    for mechanism, per_layer in (("ring", CARDS * (CARDS + 1) // 2),
                                 ("ulysses", CARDS)):
        config = replace(LLAMA32_1B, sequence_parallel=True,
                         sp_mechanism=mechanism)
        outputs = {}
        for label, mesh in meshes.items():
            def prefill(mesh=mesh):
                with use_mesh(mesh), torch.no_grad():
                    outputs[label] = forward(params, config, tokens)
            reset_peaks(devices)
            kernels.reset_launch_counts()
            ms = host_ms(prefill, devices, warmup=1, runs=2)
            counted = launch_counts()
            add_launches(launches, counted)
            if counted["flash_attention"] != 3 * config.n_layers * per_layer:
                raise SystemExit(f"19d: {mechanism} on {label} launched "
                                 f"{counted}")
            times[label] = ms
            times[f"{label}_peaks"] = card_peaks(devices)
        logits = outputs["cards"]
        if not (logits.shape == dense.shape
                and torch.isfinite(logits).all()):
            raise SystemExit(f"19d: {mechanism} logits "
                             f"{tuple(logits.shape)} not finite")
        error = (logits - dense).abs().max().item()
        same = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
        say("19d prefill_sp_across_cards", mechanism=mechanism,
            seq_axis=CARDS, tokens=SP_SEQ, ms=f"{times['cards']:.1f}",
            tokens_per_s=f"{SP_SEQ / times['cards'] * 1e3:.1f}",
            one_card_ms=f"{times['one_card']:.1f}",
            bit_equal_to_one_card=torch.equal(
                logits, outputs["one_card"].to(logits.device)),
            logits_max_abs_diff_vs_non_sp=f"{error:.3e}",
            same_argmax_share=f"{same:.4f}",
            peak_gib_by_card=json.dumps(times["cards_peaks"]),
            card=repr(smi))
        if error > SP_LOGITS_GROSS_TOL or same < SP_ARGMAX_FLOOR:
            raise SystemExit(f"19d: {mechanism} logits differ from the "
                             f"non-SP forward by {error:.3e} (argmax share "
                             f"{same:.4f})")
        del outputs, logits
    del params, dense
    torch.cuda.empty_cache()
    return launches


def cards_worker(argument: str) -> None:
    """One rank of phase 20, in its own process: joins the NCCL job with
    its card (AIKO_PROCESS_ID) as the only position, loads the kernels
    phase 1 built, runs 20a-20c, holds each new K1/K2/K3 case against its
    plain version on its card (20d) and writes its results under
    PROCESS_DIR."""
    import os
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.parallel import (
        global_mesh, initialize_distributed, process_count,
        shutdown_distributed)
    smi, reference = json.loads(argument)
    if torch.cuda.device_count() < CARDS:
        raise SystemExit("phase 20 worker: fewer than four cards")
    rank = int(os.environ["AIKO_PROCESS_ID"])
    if not initialize_distributed(backend="nccl", local_device_ids=[rank],
                                  timeout_seconds=CARDS_TIMEOUT):
        raise SystemExit("phase 20 worker: no AIKO_* job to join")
    if torch.cuda.current_device() != rank:
        raise SystemExit(f"phase 20 worker {rank}: current card "
                         f"{torch.cuda.current_device()}")
    for name in kernels.KERNEL_SOURCES:
        kernels.load_kernel(name)
    forward, backward = set(), set()
    arms = []
    launches = {name: 0 for name in kernels.KERNELS}
    with recorded_kernel_cases(forward, backward):
        for label, dtype, layers, axes in CARDS_PROCESS_ARMS:
            config = process_config(dtype, layers)
            arms.append(process_arm(rank, label, config, axes, smi,
                                    reference[dtype],
                                    header_cost=label == "20a"))
            add_launches(launches, arms[-1]["launches"])
        mesh = global_mesh({"seq": process_count()})
        if mesh.process_axes != ("seq",):
            raise SystemExit(f"phase 20 worker: {mesh} does not span the "
                             f"processes on 'seq'")
        add_launches(launches, seq_prefill(rank, mesh, smi, "20c"))
    cases = check_new_cases(forward, backward, "20", f"20d rank{rank}",
                            2000)
    builds = sorted(kernels.build_seconds)
    (PROCESS_DIR / f"rank{rank}.json").write_text(json.dumps({
        "arms": arms, "launches": launches, "cases": cases,
        "builds": builds}))
    shutdown_distributed()
    if builds:
        raise SystemExit(f"phase 20 worker {rank} built {builds}: it must "
                         f"load what phase 1 built")
    print(f"rank {rank} done", flush=True)


def phase_cards_processes(smi: str, cards: list) -> dict:
    """Phase 20: four NCCL worker processes, one card each.  The parent
    runs the unsharded steps first (phase 17's process_reference, 20a at
    full depth) and frees the card.  Returns the workers' launches."""
    import shutil
    from aiko_services_tpu_torch.ops import kernels
    start = time.perf_counter()
    reference = process_references(CARDS_PROCESS_ARMS)
    reference_s = time.perf_counter() - start
    run_workers("20", PROCESS_DIR, "cards_worker",
                json.dumps([smi, reference]), count=CARDS,
                timeout=CARDS_TIMEOUT)
    results = [json.loads((PROCESS_DIR / f"rank{rank}.json").read_text())
               for rank in range(CARDS)]
    launches = {name: 0 for name in kernels.KERNELS}
    for result in results:
        add_launches(launches, result["launches"])
    replicas = equal_replicas(results, "20")
    if min(launches.values()) == 0:
        raise SystemExit(f"20: {replicas} replicas compared, launches "
                         f"{launches}")
    shutil.rmtree(PROCESS_DIR, ignore_errors=True)
    say("20 cards_processes", workers=CARDS, backend="nccl",
        devices="cuda:r for rank r", reference_s=f"{reference_s:.1f}",
        replicas_equal=replicas,
        new_cases=[result["cases"] for result in results],
        kernel_builds_in_workers=0,
        wall_s=f"{time.perf_counter() - start:.1f}",
        launches=json.dumps(launches), card=repr(smi))
    return launches


def contract_lines(smi: str, launches: dict, max_abs_err: dict,
                   timing: dict) -> None:
    """The last three lines: the card, the kernels JSON, the result."""
    from aiko_services_tpu_torch.ops import kernels
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


def main_cards() -> None:
    """`python3 chip_smoke.py cards`: phases 0, 1, 19a-19d, 20, phase 3's
    timing on cuda:0, and the contract lines."""
    from aiko_services_tpu_torch.ops import kernels
    run_start = time.perf_counter()
    smi = phase_card()
    cards = card_list()
    if len(cards) < CARDS:
        raise SystemExit(f"chip_smoke cards: needs {CARDS} CUDA devices "
                         f"(one NCCL rank per card in phase 20), found "
                         f"{len(cards)}")
    phase_build()
    max_abs_err = phase_cards_topology(smi, cards)
    launches = {name: 0 for name in kernels.KERNELS}
    # a phase that fails is reported and the later ones still run (one
    # four-card run shows every fault it can); the mode then exits
    # non-zero with no result
    failed = []
    for phase in (phase_cards_serving, phase_cards_training,
                  phase_cards_long_context,
                  phase_cards_processes):
        try:
            add_launches(launches, phase(smi, cards))
        except (Exception, SystemExit) as error:
            import traceback
            traceback.print_exc()
            failed.append(f"{getattr(phase, '__name__', phase)}: {error}")
            free_cards(cards)
    if failed:
        raise SystemExit("chip_smoke cards: " + "; ".join(failed))
    timing = phase_timing(smi)
    say("run", mode="cards", seconds=f"{time.perf_counter() - run_start:.1f}",
        card=repr(smi))
    contract_lines(smi, launches, max_abs_err, timing)


def timed_phase(phase, *args):
    """phase(*args), then a line with the seconds it took on the host
    (each phase's share of the run's time limit)."""
    start = time.perf_counter()
    result = phase(*args)
    say("seconds", name=phase.__name__,
        seconds=f"{time.perf_counter() - start:.1f}")
    return result


def main() -> None:
    from aiko_services_tpu_torch.ops import kernels
    run_start = time.perf_counter()
    smi = phase_card()
    timed_phase(phase_build)
    max_abs_err = {"flash_attention": timed_phase(phase_kernel_checks)}
    max_abs_err.update(timed_phase(phase_backward_checks))
    timing = timed_phase(phase_timing, smi)
    timed_phase(phase_asr_tones)
    launches = {name: 0 for name in kernels.KERNELS}
    launches["flash_attention"] += timed_phase(phase_whisper_small, smi)
    for path_launches in (timed_phase(phase_llama_training, smi),
                          timed_phase(phase_asr_tones_training),
                          timed_phase(phase_config5, smi)):
        add_launches(launches, path_launches)
    timed_phase(phase_engine, smi)
    timed_phase(phase_serving_tier, smi)
    for phase in (phase_model_families, phase_long_context,
                  phase_parameter_sharding, phase_hf_and_examples,
                  phase_fleet, phase_last_modules):
        add_launches(launches, timed_phase(phase, smi))
    C5_WEIGHTS.clear()
    torch.cuda.empty_cache()
    for phase in (phase_processes, phase_seq_processes):
        add_launches(launches, timed_phase(phase, smi))
    say("run", seconds=f"{time.perf_counter() - run_start:.1f}",
        card=repr(smi))
    contract_lines(smi, launches, max_abs_err, timing)

if __name__ == "__main__":
    if sys.argv[1:] == ["cards"]:
        main_cards()
    elif sys.argv[1:]:
        raise SystemExit(f"usage: python3 chip_smoke.py [cards], not "
                         f"{sys.argv[1:]}")
    else:
        main()
