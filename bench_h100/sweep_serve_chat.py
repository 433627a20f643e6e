"""The rate sweep that found the knee of mistral_7b.serve_chat: one
engine, set up as the cell sets it up, offered the cell's chat mix at
each rate in turn for --seconds, from an empty engine.

    python3 bench_h100/sweep_serve_chat.py --rates 0.2 0.3 0.4 \\
        --seconds 240 --seed 7

A rate is sustained when no request waits for a slot (the admission
queue is empty at the run's half and at its end) and the slots in use
at the end stay below the engine's: above the knee every slot fills and
the queue grows through the run.  Each rate prints one JSON line:
offered, admitted and completed requests, slots in use and queue at
the half and the end, TTFT and ITL percentiles, tokens/s.  The knee and
these lines are written beside the cell's `why` in README.md."""

import argparse
import json
import sys
import time
from pathlib import Path


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench_h100 import harness, traffic
    from bench_h100.drivers import engine_open_loop as driver
    from bench_h100.drivers.common import percentile
    parser = argparse.ArgumentParser(prog="bench_h100/sweep_serve_chat.py")
    parser.add_argument("--workload", default="mistral_7b.serve_chat")
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=240.0)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    kernel_cache = harness.set_cache_dirs(harness.ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("the sweep runs on the card")
    from aiko_services_tpu_torch.decode import DecodeEngine
    from aiko_services_tpu_torch.ops import kernels
    kernels.set_cache_dir(str(kernel_cache))
    benchmark = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = harness.cell_entry(benchmark, args.workload)
    spec = harness.load_json(harness.HERE / "workloads"
                             / f"{args.workload}.json")
    config = harness.load_json(harness.HERE / "configs"
                               / f"{entry['config']}.json")
    mix = traffic.load(entry["traffic"])
    vocab = int(config["vocab_size"])
    print(f"card: {harness.card_line()}", flush=True)
    params = driver.weights(config, args.seed, "cuda")
    engine = DecodeEngine(
        params, driver.transformer_config(config),
        decode_slots=int(spec["decode_slots"]),
        kv_block_size=int(spec["kv_block_size"]),
        max_context=int(spec["max_context"]), eos_id=None)
    every = traffic.open_loop(dict(mix, rate_per_s=1.0), args.seed, 60.0,
                              vocab, cycles=1)
    driver.warm(engine, vocab, driver.buckets(engine, every))
    for rate in args.rates:
        requests = traffic.open_loop(dict(mix, rate_per_s=rate), args.seed,
                                     args.seconds, vocab, cycles=1)
        start = time.perf_counter()
        cursor, completed, tokens, half = 0, 0, 0, None
        while True:
            now = time.perf_counter() - start
            while cursor < len(requests) and requests[cursor].due_s <= now:
                request = requests[cursor]
                engine.submit(request.index, request.prompt,
                              request.max_new)
                cursor += 1
            if half is None and now >= args.seconds / 2:
                half = engine.stats()
            if now >= args.seconds:
                break
            if not engine.has_work():
                time.sleep(max(0.0, requests[cursor].due_s - now)
                           if cursor < len(requests) else 0.01)
                continue
            report = engine.step()
            done = time.perf_counter() - start
            completed += len(report.completions)
            tokens += len(report.emitted)
            for request_id, _, _ in report.emitted:
                request = requests[request_id]
                if request.first_token_s is None:
                    request.first_token_s = done
                request.token_times.append(done)
        end = engine.stats()
        ttft = [r.first_token_s - r.due_s for r in requests
                if r.first_token_s is not None]
        itl = [b - a for r in requests
               for a, b in zip(r.token_times, r.token_times[1:])]
        print(json.dumps({
            "rate_per_s": rate, "seconds": args.seconds,
            "offered": cursor, "admitted": len(ttft),
            "completed": completed,
            "slots_in_use_half": half["active_slots"],
            "queue_half": half["waiting"],
            "slots_in_use_end": end["active_slots"],
            "queue_end": end["waiting"],
            "ttft_p50_ms": percentile(ttft, 50) * 1e3,
            "ttft_p95_ms": percentile(ttft, 95) * 1e3,
            "itl_p50_ms": percentile(itl, 50) * 1e3,
            "itl_p95_ms": percentile(itl, 95) * 1e3,
            "tokens_per_s": tokens / args.seconds,
            "sustained": (half["waiting"] == 0 and end["waiting"] == 0
                          and end["active_slots"] < end["slots"])}),
            flush=True)
        engine.cancel(lambda request_id: True)
        while engine.has_work():
            engine.step()
