"""The decode engine under open-loop requests: `decode/engine.py`
DecodeEngine.submit and step on a decoder-only model drawn from the
seed.  Requests are submitted when they are due (between engine steps,
the engine's own API being synchronous), and each is timed from when it
was due.

Set-up draws the weights on the card, builds the engine, warms every
prefill bucket this cell's traffic uses and the captured decode step,
and admits the cell's `resident_requests` (the population the engine
holds in the steady state at this rate, each prefilled and decoding).
The window offers the mix's requests due before it closes; the load
goes on after the close until each of them has its first token, so
every one counts.  `correct` compares the served tokens of requests
drawn from the seed, the one with the most tokens among them, against
the plain reference's full forward over prompt plus served tokens
(bench_h100/reference/transformer.py); its control is the program's own
weight-only int8 path (control.py --control program_int8)."""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import traffic
from ..harness import Outcome
from ..reference import full_f32, gaps
from ..reference import transformer as reference
from ..weights import draw, transformer_scale
from .common import peak_bytes, percentile, release, sample_indices

# a window's requests that still lack a first token this long after the
# close count as failed
FIRST_TOKEN_GRACE_S = 120.0


def transformer_config(config: dict):
    """The program's TransformerConfig for a Hugging Face config."""
    from aiko_services_tpu_torch.models import TransformerConfig
    d, heads = config["hidden_size"], config["num_attention_heads"]
    if config.get("head_dim", d // heads) != d // heads:
        raise SystemExit("the port's decoder has head_dim = d / heads")
    if config.get("sliding_window") is not None:
        raise SystemExit("the port's decoder has no sliding window")
    return TransformerConfig(
        vocab_size=config["vocab_size"], d_model=d,
        n_layers=config["num_hidden_layers"], n_heads=heads,
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"],
        max_seq_len=config["max_position_embeddings"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        dtype=config["torch_dtype"])


def weights(config: dict, seed: int, device: str) -> dict:
    """The program's tree for the config, with the untied lm_head
    (vocab, d) that models/transformer.py's head reads."""
    import torch
    from aiko_services_tpu_torch.models import init_params
    program_config = transformer_config(config)
    with torch.device("meta"):
        shapes = init_params(program_config, torch.Generator(),
                             device="meta")
        if not config.get("tie_word_embeddings", False):
            shapes["lm_head"] = {"w": torch.empty(
                (config["vocab_size"], config["hidden_size"]),
                dtype=program_config.torch_dtype)}
    return draw(shapes, transformer_scale, seed, device,
                program_config.torch_dtype)


def buckets(engine, requests: list) -> list:
    return sorted({engine._bucket(int(request.prompt.size))
                   for request in requests})


def warm(engine, vocab: int, sizes: list) -> None:
    """One request per prefill bucket, each run to its second token, so
    every prefill shape and the captured decode step are built."""
    rng = np.random.default_rng(0)
    for index, size in enumerate(sizes):
        engine.submit(f"warm{index}", rng.integers(0, vocab, size,
                                                   dtype=np.int32), 2)
    while engine.has_work():
        engine.step()


def admit(engine, population: list) -> None:
    """The steady state's population admitted before the window opens:
    each request prefilled and holding its slot, its tokens kept."""
    for request in population:
        engine.submit(request.index, request.prompt, request.max_new)
    while engine.waiting:
        for request_id, _, token in engine.step().emitted:
            population[request_id - population[0].index].tokens.append(
                int(token))


def run(context) -> Outcome:
    import torch
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.models import quantize_weights_int8
    from aiko_services_tpu_torch.utils.tree import tree_map

    config, spec = context.config, context.spec
    device = context.device
    vocab = int(config["vocab_size"])
    program_config = transformer_config(config)
    context.note("program imported")
    params = weights(config, context.seed, device)
    context.note("weights drawn")
    served_params = params
    if context.control == "program_int8":
        # the bf16 tree is dropped while the int8 one serves (both and
        # the pool do not fit) and drawn again for the reference
        served_params = tree_map(
            lambda leaf: leaf.clone() if leaf.dtype == params["embed"][
                "w"].dtype else leaf,
            quantize_weights_int8(params, program_config))
        params = None
        release(device)
    requests = traffic.open_loop(context.traffic, context.seed,
                                 context.seconds, vocab)
    engine = DecodeEngine(
        served_params, program_config,
        decode_slots=int(spec["decode_slots"]),
        kv_block_size=int(spec["kv_block_size"]),
        max_context=int(spec["max_context"]), eos_id=None)
    context.note("engine built")
    population = traffic.residents(context.traffic, context.seed,
                                   int(spec["resident_requests"]), vocab,
                                   len(requests))
    warm(engine, vocab, buckets(engine, requests + population))
    context.note("shapes warm")
    admit(engine, population)
    if device != "cpu":
        torch.cuda.synchronize()
    context.setup_done()
    window = [request for request in requests if request.in_window]
    requests = requests + population
    steps = []                    # (start, end) seconds after the open
    with context.traced():
        start = time.perf_counter()
        cursor = 0
        while True:
            now = time.perf_counter() - start
            while cursor < len(requests) and requests[cursor].due_s <= now:
                request = requests[cursor]
                engine.submit(request.index, request.prompt,
                              request.max_new)
                cursor += 1
            if now >= context.seconds and (
                    all(r.first_token_s is not None for r in window)
                    or now >= context.seconds + FIRST_TOKEN_GRACE_S):
                break
            if not engine.has_work():
                if cursor < len(requests):
                    time.sleep(max(0.0, requests[cursor].due_s - now))
                continue
            report = engine.step()
            done = time.perf_counter() - start
            steps.append((now, done))
            for request_id, _, token in report.emitted:
                request = requests[request_id]
                if request.first_token_s is None:
                    request.first_token_s = done
                    request.admitted_step_s = now
                request.token_times.append(done)
                request.tokens.append(int(token))
    peak = peak_bytes(device)
    del engine, served_params
    release(device)
    if params is None:
        params = weights(config, context.seed, device)

    close = context.seconds
    # a request with no first token by the cut-off counts as waiting
    # until the cut-off
    cutoff = steps[-1][1] if steps else close
    ttft = [(request.first_token_s if request.first_token_s is not None
             else cutoff) - request.due_s for request in window]
    failed = sum(1 for request in window if request.first_token_s is None)
    itl = [later - earlier for request in requests
           for earlier, later in zip(request.token_times,
                                     request.token_times[1:])
           if later <= close]
    queue_wait = [request.admitted_step_s - request.due_s
                  for request in window
                  if request.first_token_s is not None]
    record = {
        "step_s": [end - begin for begin, end in steps if end <= close],
        "queue_wait_s": queue_wait,
    }
    print(f"[{context.cell}] ttft_ms={sorted(round(v * 1e3) for v in ttft)}"
          f" itl_ms_p50/90/95/99="
          f"{[round(percentile(itl, q) * 1e3) for q in (50, 90, 95, 99)]}"
          f" gaps={len(itl)} steps={len(record['step_s'])}",
          file=sys.stderr, flush=True)
    checks = [("mean_logit_gap", judge(context, params, window),
               float(spec["mean_logit_gap"]))]
    e2e = {"ttft_p95_ms": percentile(ttft, 95) * 1e3,
           "itl_p90_ms": percentile(itl, 90) * 1e3}
    return Outcome(e2e=e2e, record=record, attempted=len(window),
                   failed=failed, checks=checks, memory_peak_bytes=peak)


def judge(context, params: dict, window: list) -> float:
    """The mean gap between a served token's reference logit and the
    reference's best, over requests drawn from the seed among the
    window's (the one with the most served tokens always among them)
    until `check_tokens` served tokens are held.  (The widest gap does
    not part the program from its int8 control by three times: PERF.md
    section 6.)"""
    import torch
    spec, config = context.spec, context.config
    served = [request for request in window if request.tokens]
    if not served:
        return float("inf")
    longest = max(range(len(served)), key=lambda i: len(served[i].tokens))
    rng = np.random.default_rng(int(context.seed) + 1)
    found = []
    held = 0
    with full_f32(), torch.no_grad():
        for index in sample_indices(rng, len(served), [longest],
                                    len(served)):
            if held >= int(spec["check_tokens"]):
                break
            request = served[index]
            tokens = torch.from_numpy(np.concatenate(
                [request.prompt, np.asarray(request.tokens[:-1],
                                            np.int32)])).to(context.device)
            logits = reference.logits(params, config, tokens,
                                      request.prompt.size - 1)
            found.append(gaps(logits, torch.tensor(
                request.tokens, device=context.device)).cpu())
            held += len(request.tokens)
    found = torch.cat(found)
    print(f"[{context.cell}] gaps: tokens={found.numel()} "
          f"max={float(found.max())!r} mean={float(found.mean())!r} "
          f"parted={float((found > 0).float().mean())!r}",
          file=sys.stderr, flush=True)
    return float(found.mean())
