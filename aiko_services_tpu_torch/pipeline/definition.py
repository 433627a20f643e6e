# Pipeline definitions: the JSON document describing a pipeline graph.
#
# Capability parity with the reference definition layer (reference:
# src/aiko_services/main/pipeline.py:142-178 dataclasses and the embedded
# Avro schema :1323-1440): a pipeline has a name, a graph (S-expression path
# list), pipeline-level parameters, and element definitions with typed
# input/output ports and a deploy block that is either local
# {module, class_name} or remote {service_filter}.  Validation is hand-rolled
# schema checking (explicit error messages instead of Avro), plus the graph /
# port cross-checks the reference does in PipelineGraph.validate
# (reference pipeline.py:254-286) including map_in/map_out renames.
#
# TPU-first addition: element definitions may carry a "sharding" block
# naming mesh axes for the element's compute (data/model/sequence), consumed
# by parallel/mesh.py -- the reference has no counterpart (SURVEY.md 2.4).

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from ..utils import Graph

__all__ = [
    "PipelineDefinition", "ElementDefinition", "DefinitionError",
    "definition_to_document", "parse_pipeline_definition",
    "validate_pipeline_definition",
]


class DefinitionError(ValueError):
    pass


@dataclass
class ElementDefinition:
    name: str
    input: list = field(default_factory=list)    # [{"name":..,"type":..}]
    output: list = field(default_factory=list)
    parameters: dict = field(default_factory=dict)
    deploy_local: dict | None = None     # {"module":.., "class_name":..}
    deploy_remote: dict | None = None    # {"service_filter": {...}}
    map_in: dict = field(default_factory=dict)   # input_name -> swag_key
    map_out: dict = field(default_factory=dict)  # output_name -> swag_key
    sharding: dict = field(default_factory=dict)  # TPU mesh axes block

    @property
    def is_local(self) -> bool:
        return self.deploy_local is not None

    def input_names(self) -> list[str]:
        return [port["name"] for port in self.input]

    def output_names(self) -> list[str]:
        return [port["name"] for port in self.output]


@dataclass
class PipelineDefinition:
    name: str
    version: int = 0
    runtime: str = "jax"
    graph: list = field(default_factory=list)
    parameters: dict = field(default_factory=dict)
    elements: list = field(default_factory=list)

    def element(self, name: str) -> ElementDefinition | None:
        for definition in self.elements:
            if definition.name == name:
                return definition
        return None


def definition_to_document(definition: PipelineDefinition) -> dict:
    """The inverse of parse_pipeline_definition: a JSON-able document
    that re-parses to an equivalent definition.  Used by the trace
    exporter (a Perfetto artifact embeds the definition it was recorded
    under, so `aiko tune` can replay it without side-channel files) and
    by `aiko tune --apply` (recommendations are written back as a
    definition document and re-linted)."""
    elements = []
    for element in definition.elements:
        record: dict = {"name": element.name}
        if element.input:
            record["input"] = [dict(port) for port in element.input]
        if element.output:
            record["output"] = [dict(port) for port in element.output]
        if element.parameters:
            record["parameters"] = dict(element.parameters)
        if element.map_in:
            record["map_in"] = dict(element.map_in)
        if element.map_out:
            record["map_out"] = dict(element.map_out)
        if element.sharding:
            record["sharding"] = dict(element.sharding)
        record["deploy"] = (
            {"local": dict(element.deploy_local)}
            if element.deploy_local is not None
            else {"remote": dict(element.deploy_remote or {})})
        elements.append(record)
    document = {
        "name": definition.name,
        "graph": list(definition.graph),
        "elements": elements,
    }
    if definition.version:
        document["version"] = definition.version
    if definition.runtime != "jax":
        document["runtime"] = definition.runtime
    if definition.parameters:
        document["parameters"] = dict(definition.parameters)
    return document


def _require(condition, message):
    if not condition:
        raise DefinitionError(message)


def _parse_ports(ports, element_name, direction) -> list:
    _require(isinstance(ports, list),
             f"{element_name}: '{direction}' must be a list")
    parsed = []
    for port in ports:
        _require(isinstance(port, dict) and "name" in port,
                 f"{element_name}: each {direction} port needs a 'name'")
        record = {"name": port["name"],
                  "type": port.get("type", "any"),
                  # micro-batch contract: batched outputs are split
                  # per frame by leading-row range; "batched": false
                  # marks an output as shared by every coalesced
                  # frame even when its leading dim happens to match
                  # the batch size (e.g. an NxN affinity matrix)
                  "batched": bool(port.get("batched", True))}
        # "optional": true inputs bind to None when the frame carries
        # no such key instead of erroring the frame (the disagg decode
        # element's `handoff` port: present on migrated frames, absent
        # on direct ones).  Only recorded when set, so existing
        # definitions round-trip byte-identically
        if port.get("optional"):
            record["optional"] = True
        parsed.append(record)
    return parsed


def _looks_like_path(source) -> bool:
    """Filesystem-path sniffing: an existing file is ALWAYS a path
    (whatever its suffix -- definitions ship as .json, .pipeline, or
    extensionless), and a .json suffix is a path even when the file is
    missing, so the error names the file instead of a JSONDecodeError
    over the path string."""
    if isinstance(source, Path):
        return True
    text = str(source)
    if text.endswith(".json"):
        return True
    if "\n" in text or text.lstrip()[:1] in ("{", "["):
        return False  # JSON text, never a legal path probe
    try:
        return Path(text).exists()
    except OSError:
        return False  # e.g. a name longer than the filesystem allows


def parse_pipeline_definition(source,
                              validate: bool = True) -> PipelineDefinition:
    """source: dict, JSON text, or a path to a JSON file.

    `validate=False` parses the schema only (the static analyzer lints
    unvalidated definitions so EVERY problem is reported, not just the
    first)."""
    if isinstance(source, (str, Path)) and _looks_like_path(source):
        path = Path(str(source))
        try:
            with open(path) as handle:
                document = json.load(handle)
        except OSError as error:
            raise DefinitionError(
                f"cannot read definition file {path}: {error}") from None
        except json.JSONDecodeError as error:
            raise DefinitionError(
                f"definition file {path} is not valid JSON: "
                f"{error}") from None
    elif isinstance(source, str):
        try:
            document = json.loads(source)
        except json.JSONDecodeError as error:
            raise DefinitionError(
                f"definition is neither an existing file nor valid "
                f"JSON text: {error}") from None
    else:
        document = source
    _require(isinstance(document, dict), "Definition must be a JSON object")
    _require("name" in document, "Definition needs a 'name'")
    _require("graph" in document and isinstance(document["graph"], list)
             and document["graph"],
             "Definition needs a non-empty 'graph' list")
    _require("elements" in document and isinstance(document["elements"], list),
             "Definition needs an 'elements' list")

    elements = []
    for record in document["elements"]:
        _require(isinstance(record, dict) and "name" in record,
                 "Each element needs a 'name'")
        name = record["name"]
        deploy = record.get("deploy", {})
        local = deploy.get("local")
        remote = deploy.get("remote")
        _require((local is None) != (remote is None),
                 f"{name}: deploy must be exactly one of local|remote")
        if local is not None:
            _require("module" in local and "class_name" in local,
                     f"{name}: deploy.local needs module and class_name")
        else:
            _require("service_filter" in remote,
                     f"{name}: deploy.remote needs service_filter")
        elements.append(ElementDefinition(
            name=name,
            input=_parse_ports(record.get("input", []), name, "input"),
            output=_parse_ports(record.get("output", []), name, "output"),
            parameters=record.get("parameters", {}),
            deploy_local=local,
            deploy_remote=remote,
            map_in=record.get("map_in", {}),
            map_out=record.get("map_out", {}),
            sharding=record.get("sharding", {}),
        ))

    definition = PipelineDefinition(
        name=document["name"],
        version=int(document.get("version", 0)),
        runtime=document.get("runtime", "jax"),
        graph=list(document["graph"]),
        parameters=document.get("parameters", {}),
        elements=elements,
    )
    if validate:
        validate_pipeline_definition(definition)
    return definition


# the graph-pass rules that mirror the reference PipelineGraph.validate
# (pipeline.py:254-286): structural wiring errors every caller of
# parse(validate=True) has always been rejected on.  AIKO2xx spec-flow
# errors are deliberately NOT in this set -- typed-port checking is the
# construction-lint/`aiko lint` surface, and legacy callers parse
# untyped definitions.
_STRUCTURAL_CODES = frozenset(
    ["AIKO101", "AIKO102", "AIKO103", "AIKO105", "AIKO106", "AIKO107"])


def validate_pipeline_definition(definition: PipelineDefinition) -> Graph:
    """Cross-check the graph against element definitions and port
    linking: every input of a non-head element must be produced by some
    ancestor's output (after map_in/map_out renames) or supplied as
    initial frame data for head elements.

    The structural rules are the analyzer's graph pass
    (analyze/graph_flow.py AIKO1xx) filtered to _STRUCTURAL_CODES, so
    this error and `aiko lint` can never drift; the on_error grammar
    rides the shared directive-grammar core the same way (AIKO401)."""
    # fault-tolerance grammar: a mistyped on_error would silently fall
    # back to stop_stream at runtime -- reject it at definition time,
    # wherever it is declared (pipeline-wide or per element)
    from ..analyze.grammar import Field, GrammarError
    from .element import ERROR_POLICIES
    on_error_field = Field("str", choices=ERROR_POLICIES)
    for scope_name, parameters in (
            [(definition.name, definition.parameters)]
            + [(element.name, element.parameters)
               for element in definition.elements]):
        on_error = (parameters or {}).get("on_error")
        if on_error is not None:
            try:
                on_error_field.coerce(definition.name, "on_error",
                                      str(on_error).lower())
            except GrammarError as error:
                raise DefinitionError(f"{scope_name}: {error}") from None
    graph = Graph.traverse(definition.graph)
    from ..analyze.graph_flow import run_graph_pass
    report = run_graph_pass(definition, graph=graph)
    problems = [diagnostic for diagnostic in report.findings
                if diagnostic.code in _STRUCTURAL_CODES]
    if problems:
        raise DefinitionError(
            f"{definition.name}: "
            + "\n".join(diagnostic.render() for diagnostic in problems))
    return graph
