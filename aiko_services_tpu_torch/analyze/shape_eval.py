# Pass 2 -- abstract interpretation of element compute on the meta
# device (AIKO207/AIKO208).
#
# Counterpart of aiko_services_tpu/analyze/shape_eval.py, where the pass
# runs under jax.eval_shape.  Here it runs on PyTorch's meta device: for
# local elements exposing a pure device program (the
# PipelineElement.eval_kernel contract), the pass synthesizes meta
# tensors from the DECLARED input specs, builds the element's state on
# meta (its setup() with the element's device set to meta, inside a
# torch.device("meta") scope) and runs the kernel there: the declared
# output specs are PROVEN against the traced outputs without allocating a
# parameter, launching a kernel or touching a device.  The hand-written
# kernels give their output contract on meta tensors
# (parallel/attention.py).
#
# Elements with no pure program (sources, async host elements, custom
# host-side process_frame without an eval_kernel override) are skipped;
# elements whose trace fails report AIKO208 (info -- an analysis limit,
# not a defect).
#
# element_cost_estimates feeds the tune/ cost model: bytes in, out and
# of the parameters from the meta tensors (equal to the JAX package's),
# and FLOPs from torch.utils.flop_counter.FlopCounterMode over the meta
# run plus the flash-attention forward's own count (count_meta_flops; it
# is no aten op).  The JAX package takes FLOPs from XLA's cost_analysis,
# which also counts elementwise work and counts a loop body once: the
# two agree on the products that dominate a model and differ elsewhere.

from __future__ import annotations

from dataclasses import replace

import torch

from ..parallel.attention import count_meta_flops
from .diagnostics import AnalysisReport, Diagnostic
from .specs import resolve_dims

__all__ = ["run_eval_pass", "element_cost_estimates"]

_META = torch.device("meta")


def _synthesize(spec, bindings: dict, default_size: int):
    """Concrete shape for one input spec, or None when it cannot be
    synthesized faithfully.  The LEADING axis may default (it is the
    batch contract -- any size traces the same program); an UNBOUND
    symbol or wildcard on an inner axis means the definition does not
    pin the sizes the kernel's architecture depends on, so the element
    is skipped rather than traced at a made-up size."""
    if not spec.is_tensor:
        return None
    shape = []
    for axis, dim in enumerate(spec.dims):
        if isinstance(dim, int):
            shape.append(dim)
            continue
        bound = bindings.get(dim) if dim != "*" else None
        if bound is not None:
            shape.append(bound[0])
            continue
        if axis > 0:
            return None
        if dim != "*":
            bindings[dim] = (default_size, "synthesized")
        shape.append(default_size)
    return tuple(shape)


def _dtype_name(dtype) -> str:
    """torch.float32 -> "float32", the specs' canonical names."""
    return str(dtype).removeprefix("torch.")


def _compare(report, definition_name, element_name, port_name,
             declared, traced, bindings) -> None:
    """AIKO207 when a traced leaf disagrees with its declared spec."""
    expected_shape = resolve_dims(declared, bindings)
    traced_shape = tuple(getattr(traced, "shape", ()))
    traced_dtype = _dtype_name(getattr(traced, "dtype", ""))
    problems = []
    if declared.dtype is not None and traced_dtype != declared.dtype:
        problems.append(f"dtype {traced_dtype} != declared "
                        f"{declared.dtype}")
    if expected_shape is not None:
        if len(traced_shape) != len(declared.dims):
            problems.append(
                f"rank {len(traced_shape)} != declared rank "
                f"{len(declared.dims)}")
        else:
            for axis, (dim, traced_size) in enumerate(
                    zip(declared.dims, traced_shape)):
                if dim == "*":
                    continue
                if isinstance(dim, int):
                    if traced_size != dim:
                        problems.append(
                            f"axis {axis}: traced {traced_size} != "
                            f"declared {dim}")
                else:
                    bound = bindings.get(dim)
                    if bound is None:
                        bindings[dim] = (traced_size, "traced output")
                    elif bound[0] != traced_size:
                        problems.append(
                            f"axis {axis}: traced {traced_size} != "
                            f"symbol {dim!r} bound to {bound[0]}")
    if problems:
        report.add(Diagnostic(
            "AIKO207",
            f"declared {declared.raw!r} but the meta trace gave "
            f"{traced_dtype}{list(traced_shape)}: "
            + "; ".join(problems),
            definition=definition_name, element=element_name,
            port=str(port_name)))


def _instantiate_element(element_def, process):
    """Instantiate a LOCAL element for shape tracing, on the meta device
    and without a mesh (the trace runs the element's whole program: a
    sharded call computes what the whole one computes); None when the
    deploy target is not a PipelineElement (AIKO304 is the actor pass's
    finding).  Shared by the eval pass and the cost estimates so the two
    can never drift."""
    from ..pipeline.element import PipelineElement
    from ..utils import load_module

    module = load_module(element_def.deploy_local["module"])
    cls = getattr(module, element_def.deploy_local["class_name"])
    if not (isinstance(cls, type)
            and issubclass(cls, PipelineElement)):
        return None
    return cls(process, None, replace(
        element_def, parameters={**element_def.parameters,
                                 "device": str(_META)}, sharding={}))


def _kernel_tensors(element, input_specs, bindings, default_size):
    """(kernel, state on meta, input meta tensors) from the element's
    eval_kernel contract and its declared input specs -- or None when
    the element has no pure program, or an input is opaque (str
    prompts, "any") / un-pinned on an inner axis and cannot be
    synthesized faithfully (skipped, not a finding: declare concrete
    tensor specs to opt the element in)."""
    kernel_spec = element.eval_kernel()
    if kernel_spec is None:
        return None
    kernel, state_fn = kernel_spec
    inputs = {}
    for port_name, spec in input_specs.items():
        shape = _synthesize(spec, bindings, default_size)
        if shape is None:
            return None
        inputs[port_name] = torch.empty(
            shape, dtype=getattr(torch, spec.dtype), device=_META)
    # the element's device is meta: setup() builds its state there, and
    # every tensor the kernel makes lands there too
    with torch.device(_META), torch.no_grad():
        state = state_fn() if state_fn is not None else None
    return kernel, state, inputs


def _run_kernel(kernel, state, inputs):
    with torch.device(_META), torch.no_grad():
        return kernel(state, **inputs)


def _trace_element(report, definition, element_def, element, input_specs,
                   output_specs, bindings, default_size) -> None:
    resolved = _kernel_tensors(element, input_specs, bindings,
                               default_size)
    if resolved is None:
        return
    traced = _run_kernel(*resolved)
    if not isinstance(traced, dict):
        report.add(Diagnostic(
            "AIKO208",
            f"eval kernel returned {type(traced).__name__}, not a "
            f"dict of outputs", definition=definition.name,
            element=element_def.name))
        return
    for port_name, declared in output_specs.items():
        if not declared.is_tensor:
            continue  # opaque declared types prove nothing
        leaf = traced.get(port_name)
        if leaf is None or not hasattr(leaf, "shape"):
            # host-produced output (text decode, overlay dicts): the
            # kernel covers the device subset only
            continue
        _compare(report, definition.name, element_def.name, port_name,
                 declared, leaf, bindings)
    report.traced_elements.append(element_def.name)


def _tensor_bytes(tree) -> int:
    """Total bytes of every tensor leaf of a tree of dicts, lists and
    tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(value) for value in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(value) for value in tree)
    return 0


def element_cost_estimates(definition, include_flops: bool = True,
                           default_symbol_size: int = 2) -> dict:
    """Static FLOP/byte estimates per element, the analyze/ half of the
    tune/ cost model: for every local element with a pure device
    program (the eval_kernel contract), meta tensors from the declared
    port specs give bytes in/out/parameters and, when `include_flops`,
    the operations of one run on meta (FlopCounterMode's products and
    convolutions plus the flash-attention forward's count).

    Returns {element_name: {"rows", "bytes_in", "bytes_out",
    "param_bytes", "flops"}}; elements that cannot be traced are
    absent (the tune report marks them estimate-free rather than
    guessing)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..runtime import Process
    from .graph_flow import run_graph_pass

    graph_report = run_graph_pass(definition)
    input_specs = getattr(graph_report, "input_specs", {}) or {}
    bindings = dict(getattr(graph_report, "symbol_bindings", {}) or {})
    estimates: dict = {}
    process = Process(transport_kind="null")
    try:
        for element_def in definition.elements:
            if not element_def.is_local:
                continue
            try:
                element = _instantiate_element(element_def, process)
                if element is None:
                    continue
                resolved = _kernel_tensors(
                    element, input_specs.get(element_def.name, {}),
                    bindings, default_symbol_size)
                if resolved is None or not resolved[2]:
                    continue
                kernel, state, inputs = resolved
                rows = None
                for tensor in inputs.values():
                    if tensor.shape:
                        rows = int(tensor.shape[0])
                        break
                counter = FlopCounterMode(display=False)
                with counter, count_meta_flops() as kernel_flops:
                    traced = _run_kernel(kernel, state, inputs)
                estimates[element_def.name] = {
                    "rows": rows or 1,
                    "bytes_in": _tensor_bytes(inputs),
                    "bytes_out": _tensor_bytes(traced),
                    "param_bytes": _tensor_bytes(state),
                    "flops": (float(counter.get_total_flops()
                                    + kernel_flops[0])
                              if include_flops else None),
                }
            except Exception:
                continue  # uninstantiable element: no estimate
    finally:
        try:
            process.terminate()
        except Exception:
            pass
    return estimates


def run_eval_pass(definition, input_specs, output_specs,
                  symbol_bindings=None,
                  default_symbol_size: int = 2) -> AnalysisReport:
    """Dry-run every local element's pure device program on the meta
    device against the declared port specs.

    `input_specs`/`output_specs` are the per-element {port: PortSpec}
    maps the graph pass resolved; `symbol_bindings` its symbol table
    (shared so the whole graph traces under ONE binding)."""
    from ..runtime import Process

    report = AnalysisReport(passes_run=["eval"])
    report.traced_elements = []
    bindings = dict(symbol_bindings or {})
    process = Process(transport_kind="null")
    try:
        for element_def in definition.elements:
            if not element_def.is_local:
                continue
            try:
                element = _instantiate_element(element_def, process)
                if element is None:
                    continue  # AIKO304 is the actor pass's finding
            except Exception as error:
                report.add(Diagnostic(
                    "AIKO208",
                    f"cannot instantiate for shape tracing: {error}",
                    definition=definition.name,
                    element=element_def.name))
                continue
            try:
                _trace_element(
                    report, definition, element_def, element,
                    input_specs.get(element_def.name, {}),
                    output_specs.get(element_def.name, {}),
                    bindings, default_symbol_size)
            except Exception as error:
                report.add(Diagnostic(
                    "AIKO208",
                    f"shape trace failed: {type(error).__name__}: "
                    f"{error}", definition=definition.name,
                    element=element_def.name))
    finally:
        try:
            process.terminate()
        except Exception:
            pass
    report.symbol_bindings = bindings
    return report
