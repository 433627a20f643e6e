"""The controls of `correct`: runs of a cell whose compared number must
come out above its limit.

    python3 bench_h100/control.py --workload <cell> \\
        --control reference_fp8|program_int8 --seeds 11 12 13 \\
        [--seconds 10]

reference_fp8: the plain reference computed with float8 (e4m3) weights
and activations, one step below the configurations' bfloat16, read at
each position of the served prompts and tokens (the token it puts
first).  program_int8: the program's own weight-only int8 path switched
on, served as the cell serves (decoder-only cells).  Each seed prints
one JSON line with the program's and the control's widest gaps.  The
benchmark's own runs never run this."""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench_h100 import harness
    parser = argparse.ArgumentParser(prog="bench_h100/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--control", required=True,
                        choices=("reference_fp8", "program_int8"))
    parser.add_argument("--seeds", required=True, type=int, nargs="+")
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args()
    kernel_cache = harness.set_cache_dirs(harness.ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("the controls run on the card")
    from aiko_services_tpu_torch.ops import kernels
    kernels.set_cache_dir(str(kernel_cache))
    benchmark = harness.load_json(harness.ROOT / "BENCHMARK.json")
    print(f"card: {harness.card_line()}", flush=True)
    for seed in args.seeds:
        started = time.perf_counter()
        result = harness.execute(benchmark, args.workload, seed,
                                 args.seconds, False, "cuda", started,
                                 control=args.control)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "metrics": result["metrics"],
                          "seconds": time.perf_counter() - started}),
              flush=True)
