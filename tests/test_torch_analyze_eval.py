# The `eval` lint pass on the meta device (analyze/shape_eval.py) against
# the JAX package's jax.eval_shape pass: tests/test_analyze.py's
# config-5 acceptance (test_config5_graph_verified_by_eval_shape) and its
# strict-clean sweep of the shipped examples with `eval` included, an
# AIKO207 from a wrong declared spec in both packages, the cost
# estimates' bytes equal to JAX's, and flash attention's meta branch
# against the CPU plain version's output contract.
#
# FLOP tolerance.  The JAX package's FLOPs are XLA's cost_analysis of the
# lowered program, which counts elementwise work (norms, softmax, GELU,
# masks) besides the products and counts the body of a loop ONCE (the
# decode loops, and the scans over the layer stacks); the port counts
# every product and convolution of the meta run (FlopCounterMode) plus
# K1's 4 B H D per visible pair, on every iteration.  So for a program
# without a loop the two agree within the elementwise share: 0.85-1.15
# of JAX's.  For a program with a loop the port's count lies between
# 0.85 of JAX's and JAX's times the loop's trip count (every iteration
# XLA did not count).

import copy
import json
import os
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from aiko_services_tpu.analyze import analyze_definition as jax_analyze
from aiko_services_tpu.analyze.shape_eval import (
    element_cost_estimates as jax_estimates)
from aiko_services_tpu.pipeline.definition import (
    parse_pipeline_definition as jax_parse)
from aiko_services_tpu_torch.analyze import ALL_PASSES, analyze_definition
from aiko_services_tpu_torch.analyze.shape_eval import (
    element_cost_estimates)
from aiko_services_tpu_torch.parallel import mesh as torch_mesh
from aiko_services_tpu_torch.parallel.attention import (
    count_meta_flops, flash_attention, flash_attention_forward)
from aiko_services_tpu_torch.pipeline.definition import (
    parse_pipeline_definition)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PORT_MODULE = "aiko_services_tpu_torch.elements"


@pytest.fixture(autouse=True)
def eight_cpus():
    torch_mesh.set_default_devices(["cpu"] * 8)
    try:
        yield
    finally:
        torch_mesh.set_default_devices(None)


def _on_port(definition: dict) -> dict:
    definition = copy.deepcopy(definition)
    definition["runtime"] = "torch"
    definition.setdefault("parameters", {})["device"] = "cpu"
    for element in definition["elements"]:
        local = element["deploy"].get("local")
        if local and local["module"] == "aiko_services_tpu.elements":
            local["module"] = PORT_MODULE
    return definition


@pytest.fixture(scope="module")
def config5():
    """bench.py's config-5 definition at its smoke sizes (JAX's)."""
    os.environ["AIKO_BENCH_SMOKE"] = "1"
    try:
        bench = runpy.run_path(str(ROOT / "bench.py"))
        return bench["collect_definitions"]()["multimodal"]
    finally:
        del os.environ["AIKO_BENCH_SMOKE"]


def test_config5_graph_verified_on_meta(config5):
    """test_config5_graph_verified_by_eval_shape on the port: asr, lm
    and detector trace on meta (not merely skip), with no AIKO207 or
    AIKO208 -- the same elements JAX's pass traces."""
    report = analyze_definition(_on_port(config5), passes=ALL_PASSES)
    traced = set(getattr(report, "traced_elements", ()))
    assert {"asr", "lm", "detector"} <= traced, report.render()
    assert not [d for d in report.findings
                if d.code in ("AIKO207", "AIKO208")], report.render()
    theirs = jax_analyze(config5, passes=ALL_PASSES)
    assert traced == set(theirs.traced_elements)
    assert ALL_PASSES == ("graph", "policy", "actor", "eval")


@pytest.mark.parametrize(
    "path", sorted(EXAMPLES.glob("pipeline_*.json")),
    ids=[p.stem for p in sorted(EXAMPLES.glob("pipeline_*.json"))])
def test_examples_zero_findings_strict_with_eval(path):
    """TestShippedDefinitionsClean.test_examples_zero_findings_strict on
    the port, `eval` included: no error or warning, and the elements
    JAX's pass traces trace here too."""
    definition = json.loads(path.read_text())
    report = analyze_definition(_on_port(definition), passes=ALL_PASSES,
                                source_path=str(path))
    assert report.failures(strict=True) == [], report.render()
    theirs = jax_analyze(definition, passes=ALL_PASSES)
    assert set(getattr(report, "traced_elements", ())) >= set(
        getattr(theirs, "traced_elements", ())), report.render()


def test_wrong_declared_output_spec_is_aiko207_in_both():
    """A JaxScale whose declared output width disagrees with what it
    computes: AIKO207 from both packages' eval pass, on the same port."""
    definition = json.loads((EXAMPLES / "pipeline_compute.json").read_text())
    scale = definition["elements"][1]
    scale["output"] = [{"name": "tensor", "type": "f32[8,15]"}]
    definition["elements"][2]["input"] = [{"name": "tensor",
                                           "type": "f32[8,15]"}]
    for report in (jax_analyze(definition, passes=ALL_PASSES),
                   analyze_definition(_on_port(definition),
                                      passes=ALL_PASSES)):
        found = [d for d in report.findings if d.code == "AIKO207"]
        assert [(d.element, d.port) for d in found] == [("scale",
                                                         "tensor")]


# bounds of the trip counts XLA does not count in config 5's programs
# (the smoke sizes): transcribe's and generate's decode steps (their
# layer stacks of one and two layers inside); the detector's NMS loop
# runs until stable, at most its candidate count
LOOPS = {"asr": 8, "lm": 8, "detector": 128}


def test_cost_estimates_match_jax(config5):
    """element_cost_estimates over config 5: rows and bytes in, out and
    of the parameters equal JAX's; FLOPs within the bounds stated at the
    top of this file."""
    ours = element_cost_estimates(parse_pipeline_definition(
        _on_port(config5), validate=False))
    theirs = jax_estimates(jax_parse(config5, validate=False))
    assert set(ours) == set(theirs) == {"asr", "lm", "detector"}
    for name, want in theirs.items():
        got = ours[name]
        for key in ("rows", "bytes_in", "bytes_out", "param_bytes"):
            assert got[key] == want[key], (name, key, got, want)
        assert want["flops"] is not None
        assert 0.85 * want["flops"] <= got["flops"] <= (
            LOOPS[name] * want["flops"]), (name, got, want)


def test_cost_estimates_count_every_product():
    """JaxMLP (no loop): within 0.85-1.15 of XLA's count.  The
    multimodal example's LMForward: exactly its products -- the
    projections, the FFN and the head, 2 * weights per token, and K1's
    causal pairs -- which XLA counts for one layer of its scan over
    eight, so JAX's count lies below it by at most that trip count."""
    definition = json.loads((EXAMPLES / "pipeline_compute.json").read_text())
    ours = element_cost_estimates(parse_pipeline_definition(
        _on_port(definition), validate=False))["mlp"]
    theirs = jax_estimates(jax_parse(definition, validate=False))["mlp"]
    for key in ("rows", "bytes_in", "bytes_out", "param_bytes"):
        assert ours[key] == theirs[key], key
    assert 0.85 <= ours["flops"] / theirs["flops"] <= 1.15

    definition = json.loads(
        (EXAMPLES / "pipeline_multimodal.json").read_text())
    ours = element_cost_estimates(parse_pipeline_definition(
        _on_port(definition), validate=False))["lm"]
    theirs = jax_estimates(jax_parse(definition, validate=False))["lm"]
    for key in ("rows", "bytes_in", "bytes_out", "param_bytes"):
        assert ours[key] == theirs[key], key
    lm = next(element["parameters"] for element in definition["elements"]
              if element["name"] == "lm")
    rows, length = ours["rows"], 32
    d, hd = lm["d_model"], lm["d_model"] // lm["n_heads"]
    weights = (d * hd * (2 * lm["n_heads"] + 2 * lm["n_kv_heads"])
               + 3 * d * lm["d_ff"])
    pairs = length * (length + 1) // 2
    expected = (rows * length * (lm["n_layers"] * 2 * weights
                                 + 2 * d * lm["vocab_size"])
                + lm["n_layers"] * 4 * rows * lm["n_heads"] * hd * pairs)
    assert ours["flops"] == expected
    assert theirs["flops"] <= ours["flops"] <= (
        lm["n_layers"] * theirs["flops"])


@pytest.mark.parametrize("dtype, causal, q_len, k_len, q_offset", [
    (torch.bfloat16, False, 8, 8, 0), (torch.bfloat16, True, 8, 12, 0),
    (torch.float32, True, 16, 16, 0), (torch.float32, True, 4, 10, -3)])
def test_flash_attention_meta_branch_is_the_output_contract(
        dtype, causal, q_len, k_len, q_offset):
    """K1 on meta tensors returns O (q's dtype and shape) and LSE (f32,
    (B, H, Lq)) as the CPU plain version does, computes nothing, and
    counts 4 B H D per visible (query, key) pair."""
    batch, heads, dim = 2, 3, 16
    rng = np.random.default_rng(0)
    cpu = [torch.from_numpy(rng.standard_normal(
        (batch, heads, length, dim)).astype(np.float32)).to(dtype)
        for length in (q_len, k_len, k_len)]
    plain_out, plain_lse = flash_attention_forward(
        *cpu, causal=causal, q_offset=q_offset)
    meta = [tensor.to("meta") for tensor in cpu]
    with count_meta_flops() as flops:
        out, lse = flash_attention_forward(*meta, causal=causal,
                                           q_offset=q_offset)
        wrapped = flash_attention(*meta, causal=causal, q_offset=q_offset)
    for got, want in ((out, plain_out), (lse, plain_lse),
                      (wrapped, plain_out)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    rows = np.arange(q_len)[:, None]
    keys = np.arange(k_len)[None, :]
    visible = (keys <= rows + q_offset + (k_len - q_len)) if causal \
        else np.ones((q_len, k_len), bool)
    assert flops[0] == 2 * 4 * batch * heads * dim * int(visible.sum())
