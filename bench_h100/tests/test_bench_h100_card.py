"""The controls at the cells' own sizes, on the card: the whisper cell's
fp8 reference and the serving cell's int8 program must each come out
above the cell's limit.  Run on a machine with an H100:

    python -m pytest -p no:cacheprovider -m gpu bench_h100/tests
"""

import time

import pytest

from bench_h100 import harness

SEED = 2**31 + 77


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aiko_services_tpu_torch.ops import kernels
    kernels.set_cache_dir(str(harness.set_cache_dirs(harness.ROOT)))
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.gpu
@pytest.mark.parametrize("cell,control,name", [
    ("whisper_small.transcribe_30s", "reference_fp8",
     "control_max_logit_gap"),
    ("mistral_7b.serve_chat", "program_int8", "mean_logit_gap")])
def test_control_at_the_cell_size_is_not_correct(card, cell, control,
                                                 name):
    result = harness.execute(card, cell, SEED, 10.0, False, "cuda",
                             time.perf_counter(), control=control)
    check = result["checks"][name]
    assert check["value"] > check["limit"]
    assert result["correct"] is False
