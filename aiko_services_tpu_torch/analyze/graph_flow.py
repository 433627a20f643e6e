# Pass 1 -- graph dataflow verification (AIKO1xx) and static
# shape/dtype flow (AIKO2xx).
#
# The MLIR-verifier move: prove the WHOLE graph well-typed from the
# definition alone, before any element is constructed or any frame
# moves.  Port specs (specs.py grammar) propagate producer->consumer
# through the graph S-expression, the map_in/map_out renames, and a
# graph-wide symbolic-dimension table; the sharding block is checked
# against its own mesh axes.  Runs in microseconds, so Pipeline
# construction runs it by default (opt-out `validate: false`).

from __future__ import annotations

from .diagnostics import AnalysisReport, Diagnostic
from .specs import SpecError, check_flow, parse_port_type

__all__ = ["run_graph_pass", "collect_sharding_axes"]


def _parse_ports(report, definition_name, element, direction):
    """Parse every port type of one direction; AIKO201/AIKO107 on the
    way.  Returns {port_name: PortSpec} (unparseable types become
    "any" so later checks still run)."""
    specs = {}
    ports = element.input if direction == "input" else element.output
    for port in ports:
        name = port.get("name")
        if name in specs:
            report.add(Diagnostic(
                "AIKO107",
                f"{direction} port {name!r} declared more than once",
                definition=definition_name, element=element.name,
                port=str(name)))
            continue
        try:
            specs[name] = parse_port_type(port.get("type"))
        except SpecError as error:
            report.add(Diagnostic(
                "AIKO201", str(error), definition=definition_name,
                element=element.name, port=str(name)))
            specs[name] = parse_port_type(None)
    return specs


def collect_sharding_axes(sharding: dict) -> set:
    """Every mesh-axis name a sharding block's input/state specs
    reference (nested pytrees of axis lists, reference
    parallel/mesh.py partition_spec shapes)."""
    names: set = set()

    def walk(node):
        if node is None:
            return
        if isinstance(node, str):
            names.add(node)
        elif isinstance(node, dict):
            for value in node.values():
                walk(value)
        elif isinstance(node, (list, tuple)):
            for entry in node:
                walk(entry)

    walk(sharding.get("inputs"))
    walk(sharding.get("state"))
    return names


def _check_sharding(report, definition_name, element) -> None:
    sharding = element.sharding or {}
    if not sharding:
        return
    axes = sharding.get("axes")
    # with no axes block the engine builds the default {"data": -1}
    # mesh (tpu_element.py get_mesh contract)
    mesh_axes = set(axes) if isinstance(axes, dict) else {"data"}
    for name in sorted(collect_sharding_axes(sharding)):
        if name not in mesh_axes:
            report.add(Diagnostic(
                "AIKO206",
                f"sharding spec names axis {name!r} but the element's "
                f"mesh axes are {sorted(mesh_axes)}",
                definition=definition_name, element=element.name))


def run_graph_pass(definition, graph=None) -> AnalysisReport:
    """Verify one parsed PipelineDefinition's graph and port flow.

    Returns the report; also attaches the resolved per-element input
    specs and the graph symbol table on the report
    (`report.input_specs[element]`, `report.symbol_bindings`) for the
    eval-shape pass to synthesize ShapeDtypeStructs from."""
    report = AnalysisReport(passes_run=["graph"])
    name = definition.name

    # element-level structural checks
    seen: set = set()
    input_specs: dict = {}
    output_specs: dict = {}
    for element in definition.elements:
        if element.name in seen:
            report.add(Diagnostic(
                "AIKO102", f"element {element.name!r} defined more "
                f"than once", definition=name, element=element.name))
        seen.add(element.name)
        input_specs[element.name] = _parse_ports(
            report, name, element, "input")
        output_specs[element.name] = _parse_ports(
            report, name, element, "output")
        for port_name in element.map_in:
            if port_name not in input_specs[element.name]:
                report.add(Diagnostic(
                    "AIKO105",
                    f"map_in names input port {port_name!r} but the "
                    f"element declares inputs "
                    f"{sorted(input_specs[element.name])}",
                    definition=name, element=element.name,
                    port=str(port_name)))
        for port_name in element.map_out:
            if port_name not in output_specs[element.name]:
                report.add(Diagnostic(
                    "AIKO106",
                    f"map_out names output port {port_name!r} but the "
                    f"element declares outputs "
                    f"{sorted(output_specs[element.name])}",
                    definition=name, element=element.name,
                    port=str(port_name)))
        _check_sharding(report, name, element)

    if graph is None:
        from ..utils import Graph
        try:
            graph = Graph.traverse(definition.graph)
        except Exception as error:
            report.add(Diagnostic(
                "AIKO100", f"graph does not traverse: {error}",
                definition=name))
            return report

    for node_name in graph.node_names():
        if definition.element(node_name) is None:
            report.add(Diagnostic(
                "AIKO101", f"graph node {node_name!r} has no element "
                f"definition", definition=name, element=node_name))

    # dataflow: walk the execution path, tracking for each swag key its
    # producing (element, port, spec) and whether it has been read
    # since (AIKO104 dead-store detection), while unifying specs over
    # the graph symbol table
    bindings: dict = {}
    produced: dict = {}   # swag key -> {"element", "port", "spec", "read"}
    heads = set(graph.head_nodes())
    descendants_cache: dict = {}

    def descendants(node):
        if node not in descendants_cache:
            try:
                descendants_cache[node] = graph.descendants(node)
            except Exception:
                descendants_cache[node] = frozenset()
        return descendants_cache[node]

    def ancestor_keys(node):
        """Swag keys produced by strict ancestors (the engine's
        validate contract: inputs must come from an ancestor, not
        merely an earlier sibling in path order)."""
        keys = set()
        frontier = list(graph.predecessors(node))
        visited = set()
        while frontier:
            ancestor = frontier.pop()
            if ancestor in visited:
                continue
            visited.add(ancestor)
            ancestor_def = definition.element(ancestor)
            if ancestor_def is not None:
                for output_name in output_specs.get(ancestor, {}):
                    keys.add(ancestor_def.map_out.get(
                        output_name, output_name))
            frontier.extend(graph.predecessors(ancestor))
        return keys

    for node_name in graph.get_path():
        element = definition.element(node_name)
        if element is None:
            continue  # AIKO101 already reported
        element_inputs = input_specs.get(node_name, {})
        element_outputs = output_specs.get(node_name, {})
        available = (None if node_name in heads
                     else ancestor_keys(node_name))
        # -- consume inputs
        for port_name, consumer_spec in element_inputs.items():
            swag_key = element.map_in.get(port_name, port_name)
            if available is not None and swag_key not in available:
                report.add(Diagnostic(
                    "AIKO103",
                    f"input {port_name!r} (swag key {swag_key!r}) "
                    f"is not produced by any ancestor; available: "
                    f"{sorted(available)}",
                    definition=name, element=node_name,
                    port=str(port_name)))
                continue
            # heads included: the engine's swag is ONE dict per frame
            # across all graph roots (create_frame data first, then
            # every map_out in path order), so a head whose input key
            # an earlier root already wrote receives THAT value at
            # runtime -- the flow check against the path-order producer
            # mirrors execution exactly
            record = produced.get(swag_key)
            if record is None:
                continue
            record["read"] = True
            for code, message in check_flow(
                    record["spec"], consumer_spec, bindings):
                report.add(Diagnostic(
                    code,
                    f"{message} (produced by "
                    f"{record['element']}.{record['port']})",
                    definition=name, element=node_name,
                    port=str(port_name)))
        # -- produce outputs
        for port_name, producer_spec in element_outputs.items():
            swag_key = element.map_out.get(port_name, port_name)
            previous = produced.get(swag_key)
            if (previous is not None and not previous["read"]
                    and node_name in descendants(previous["element"])):
                # write-before-read by a true descendant: the earlier
                # value can never be observed -- a dead output
                report.add(Diagnostic(
                    "AIKO104",
                    f"output {previous['port']!r} (swag key "
                    f"{swag_key!r}) is overwritten by descendant "
                    f"{node_name!r} before any element reads it",
                    definition=name, element=previous["element"],
                    port=str(previous["port"])))
            produced[swag_key] = {"element": node_name,
                                  "port": port_name,
                                  "spec": producer_spec, "read": False}

    report.input_specs = input_specs
    report.output_specs = output_specs
    report.symbol_bindings = bindings
    return report
