# Definition-time static analysis: prove a pipeline definition
# well-typed before any frame moves.
#
# Four passes, each with a stable rule-code band (diagnostics.py):
#
#   graph   AIKO1xx  graph/port dataflow: unbound inputs, dead outputs,
#                    map renames, duplicate names/ports
#           AIKO2xx  tensor-spec flow: dtype/rank/dim clashes and
#                    symbolic-dim conflicts propagated
#                    producer->consumer, sharding axes vs the mesh
#   eval    AIKO207+ abstract interpretation: element device programs
#                    dry-run on the meta device against declared specs
#                    (no allocation, no kernel launch, no device;
#                    jax.eval_shape in the JAX package)
#   actor   AIKO3xx  AST safety lint over deployed element modules:
#                    blocking calls on the event loop, shared-state
#                    mutation, group_kernel on async elements
#   policy  AIKO4xx  operator grammars (fault-tolerance parameters,
#                    fault-injection specs, gateway admission policy)
#                    verified through the shared directive-grammar core
#   code    AIKO6xx  whole-package static concurrency lint over Python
#                    SOURCE (not definitions): thread-role inference
#                    over the actor fleet, unsynchronized container
#                    iteration, cross-role check-then-act, blocking
#                    under lock, lock-order inversion, mutable
#                    class-level defaults (aiko lint --code)
#
# `Pipeline.__init__` runs the cheap passes (graph + policy) at
# construction unless the pipeline parameter `validate` is false;
# `aiko lint` runs all four over definition files and CI artifacts;
# `aiko lint --code` runs the AIKO6xx pass over source trees against
# a committed baseline file.

from __future__ import annotations

import contextlib
import os
import sys

from .concurrency import (                                     # noqa: F401
    apply_baseline, finding_fingerprint, load_baseline, role_map,
    run_code_pass, write_baseline)
from .diagnostics import (                                     # noqa: F401
    AnalysisReport, Diagnostic, RULES, severity_of)
from .grammar import (                                         # noqa: F401
    DirectiveGrammar, Field, GrammarError)
from .specs import (                                           # noqa: F401
    PortSpec, SpecError, parse_port_type)

__all__ = [
    "AnalysisReport", "Diagnostic", "RULES", "severity_of",
    "DirectiveGrammar", "Field", "GrammarError",
    "PortSpec", "SpecError", "parse_port_type",
    "CHEAP_PASSES", "ALL_PASSES", "analyze_definition",
    "run_code_pass", "role_map", "finding_fingerprint",
    "load_baseline", "apply_baseline", "write_baseline",
]

CHEAP_PASSES = ("graph", "policy")
ALL_PASSES = ("graph", "policy", "actor", "eval")


def _lint_ignores(definition) -> dict:
    """Suppression sets: "" -> pipeline-wide codes, element name ->
    element-scoped codes (the `lint_ignore` parameter)."""
    ignores = {}

    def codes_of(parameters):
        value = (parameters or {}).get("lint_ignore")
        if not value:
            return frozenset()
        if isinstance(value, str):
            value = [value]
        return frozenset(str(code).upper() for code in value)

    ignores[""] = codes_of(definition.parameters)
    for element in definition.elements:
        ignores[element.name] = codes_of(element.parameters)
    return ignores


@contextlib.contextmanager
def _definition_dir_importable(source):
    """Make a definition file's own directory importable while its
    passes run, so `deploy` modules that live next to the definition
    (fixture elements, project-local elements) resolve under offline
    lint exactly as they do for a process launched from that
    directory."""
    directory = None
    with contextlib.suppress(TypeError, ValueError, OSError):
        path = os.fspath(source)
        if isinstance(path, str) and os.path.isfile(path):
            directory = os.path.dirname(os.path.abspath(path))
    if directory is None or directory in sys.path:
        yield
        return
    sys.path.insert(0, directory)
    already_loaded = frozenset(sys.modules)
    try:
        yield
    finally:
        with contextlib.suppress(ValueError):
            sys.path.remove(directory)
        # evict modules this analysis imported FROM the directory, so a
        # later definition in another directory whose deploy module
        # shares the name is not linted against this directory's file
        from ..utils.importer import unload_module
        for name, module in list(sys.modules.items()):
            if name in already_loaded:
                continue
            origin = getattr(module, "__file__", None)
            if (origin
                    and os.path.dirname(os.path.abspath(origin))
                    == directory):
                unload_module(name)


def analyze_definition(source, passes=ALL_PASSES,
                       source_path: str = "") -> AnalysisReport:
    """Run the selected passes over one definition (dict, JSON text,
    path, or an already-parsed PipelineDefinition).

    Never raises on a broken definition: schema errors surface as
    AIKO100 findings so a corpus of deliberately-defective definitions
    (tests/assets/lint_golden) can be linted in one sweep."""
    from ..pipeline.definition import (
        DefinitionError, PipelineDefinition, parse_pipeline_definition)

    report = AnalysisReport()
    if isinstance(source, PipelineDefinition):
        definition = source
    else:
        try:
            definition = parse_pipeline_definition(source,
                                                   validate=False)
        except DefinitionError as error:
            report.add(Diagnostic("AIKO100", str(error),
                                  source=source_path))
            return report
        except Exception as error:  # unreadable file, bad JSON type
            report.add(Diagnostic(
                "AIKO100", f"{type(error).__name__}: {error}",
                source=source_path))
            return report

    with _definition_dir_importable(source):
        graph_report = None
        if "graph" in passes:
            from .graph_flow import run_graph_pass
            graph_report = run_graph_pass(definition)
            report.extend(graph_report)
        if "policy" in passes:
            from .policies import run_policy_pass
            report.extend(run_policy_pass(definition))
        if "actor" in passes:
            from .actor_lint import run_actor_pass
            report.extend(run_actor_pass(definition))
        if "eval" in passes:
            if graph_report is None:
                from .graph_flow import run_graph_pass
                graph_report = run_graph_pass(definition)
            from .shape_eval import run_eval_pass
            report.extend(run_eval_pass(
                definition, graph_report.input_specs,
                graph_report.output_specs,
                graph_report.symbol_bindings))

    ignores = _lint_ignores(definition)
    pipeline_wide = ignores.get("", frozenset())
    kept = []
    for diagnostic in report.findings:
        suppress = (pipeline_wide
                    | ignores.get(diagnostic.element, frozenset()))
        if diagnostic.code in suppress:
            continue
        if source_path and not diagnostic.source:
            diagnostic.source = source_path
        kept.append(diagnostic)
    report.findings = kept
    return report
