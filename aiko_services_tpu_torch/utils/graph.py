# Dataflow graph for pipeline definitions.
#
# Capability parity with the reference Graph (reference:
# src/aiko_services/main/utilities/graph.py:61-181): graph definitions are
# S-expressions like "(PE_0 (PE_1 PE_3) (PE_2 PE_3))" (PE_0 fans out to PE_1
# and PE_2, both feeding PE_3); traversal yields a deterministic topological
# execution order; iterate_after() resumes execution past a node (used when a
# frame returns from a remote element); node names may carry a "local:remote"
# split for cross-pipeline paths.
#
# Implemented fresh: explicit adjacency + Kahn ordering with DFS-discovery
# order as the tie-break, so execution order is both topological and stable,
# and cycles are detected at build time (the reference would loop).

from __future__ import annotations

from .sexpr import parse

__all__ = ["Graph", "Node", "GraphError"]


class GraphError(ValueError):
    pass


class Node:
    __slots__ = ("name", "element", "properties", "successors")

    def __init__(self, name: str, element=None, properties=None):
        self.name = name
        self.element = element
        self.properties = properties or {}
        self.successors: list[str] = []

    def add_successor(self, name: str) -> None:
        if name not in self.successors:
            self.successors.append(name)

    def __repr__(self):
        return f"Node({self.name} -> {self.successors})"


class Graph:
    """DAG of named nodes with deterministic topological traversal."""

    def __init__(self, head_nodes=None):
        self._nodes: dict[str, Node] = {}
        self._head_nodes: list[str] = list(head_nodes or [])
        self._order_cache: list[str] | None = None
        self._path_cache: dict[str, list] = {}
        self._descendants_cache: dict[str, frozenset] = {}

    # -- construction -----------------------------------------------------

    @classmethod
    def traverse(cls, graph_definition, node_properties_callback=None):
        """Build a Graph from S-expression path definitions.

        graph_definition: list of path strings, e.g.
        ["(PE_0 (PE_1 PE_3) (PE_2 PE_3))"].  Each path's head becomes a head
        node.  node_properties_callback(node_name, properties) is invoked for
        nodes carrying inline properties, mirroring the reference's
        map-in/out hook (reference graph.py:115-152).
        """
        graph = cls()
        for path in graph_definition:
            command, parameters = parse(path)
            if not command:
                raise GraphError(f"Empty graph path: {path!r}")
            graph._add_subtree(command, parameters, node_properties_callback)
            if command.split(":")[0] not in graph._head_nodes:
                graph._head_nodes.append(command.split(":")[0])
        graph.topological_order()  # validates acyclicity eagerly
        return graph

    def _add_subtree(self, head, children, callback) -> str:
        head_name = self._intern(head, callback)
        for child in children:
            if isinstance(child, str):
                child_name = self._intern(child, callback)
                self._nodes[head_name].add_successor(child_name)
            elif isinstance(child, list) and child:
                child_head = child[0]
                if not isinstance(child_head, str):
                    raise GraphError(f"Bad graph node: {child!r}")
                child_name = self._add_subtree(child_head, child[1:], callback)
                self._nodes[head_name].add_successor(child_name)
            elif isinstance(child, dict):
                self._nodes[head_name].properties.update(child)
                if callback:
                    callback(head_name, child)
            else:
                raise GraphError(f"Bad graph node: {child!r}")
        self._order_cache = None
        self._path_cache.clear()
        self._descendants_cache.clear()
        return head_name

    def _intern(self, token: str, callback) -> str:
        name = token.split(":")[0]  # strip "local:remote" annotation
        if name not in self._nodes:
            self._nodes[name] = Node(name)
        node = self._nodes[name]
        if ":" in token:
            node.properties.setdefault("remote_paths", []).append(token)
            if callback:
                callback(name, {"remote": token.split(":", 1)[1]})
        return name

    def add_node(self, node: Node, head: bool = False) -> None:
        self._nodes[node.name] = node
        if head and node.name not in self._head_nodes:
            self._head_nodes.append(node.name)
        self._order_cache = None
        self._path_cache.clear()
        self._descendants_cache.clear()

    # -- queries ----------------------------------------------------------

    def get_node(self, name: str) -> Node | None:
        return self._nodes.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def __len__(self) -> int:
        return len(self._nodes)

    def nodes(self):
        return list(self._nodes.values())

    def node_names(self):
        return list(self._nodes)

    def head_nodes(self):
        return list(self._head_nodes)

    def predecessors(self, name: str) -> list[str]:
        return [node.name for node in self._nodes.values()
                if name in node.successors]

    def topological_order(self) -> list[str]:
        """Stable topological order: DFS-discovery order tie-break."""
        if self._order_cache is not None:
            return list(self._order_cache)
        discovery: list[str] = []
        seen = set()

        def discover(name):
            if name in seen:
                return
            seen.add(name)
            discovery.append(name)
            for successor in self._nodes[name].successors:
                discover(successor)

        for head in self._head_nodes:
            discover(head)
        for name in self._nodes:  # orphans (no head path) keep insert order
            discover(name)

        indegree = {name: 0 for name in self._nodes}
        for node in self._nodes.values():
            for successor in node.successors:
                indegree[successor] += 1
        rank = {name: index for index, name in enumerate(discovery)}
        ready = sorted(
            (name for name, degree in indegree.items() if degree == 0),
            key=rank.__getitem__)
        order: list[str] = []
        while ready:
            name = ready.pop(0)
            order.append(name)
            inserted = False
            for successor in self._nodes[name].successors:
                indegree[successor] -= 1
                if indegree[successor] == 0:
                    ready.append(successor)
                    inserted = True
            if inserted:
                ready.sort(key=rank.__getitem__)
        if len(order) != len(self._nodes):
            cyclic = [name for name in self._nodes if name not in set(order)]
            raise GraphError(f"Graph contains a cycle involving: {cyclic}")
        self._order_cache = order
        return list(order)

    def get_path(self, head: str | None = None) -> list[str]:
        """Execution order (reference graph.py:61-78).  With `head`, only
        the nodes reachable from that head -- per-stream sub-paths in
        multi-root graphs (reference pipeline_paths.json capability:
        Stream.graph_path selects which root a stream executes)."""
        order = self.topological_order()
        if head is None:
            return order
        cached = self._path_cache.get(head)
        if cached is not None:  # hot path: get_path runs once per frame
            return list(cached)
        if head not in self._nodes:
            raise GraphError(f"Unknown graph path head: {head}")
        reachable = self._reachable_from([head])
        path = [name for name in order if name in reachable]
        self._path_cache[head] = path
        return list(path)

    def _reachable_from(self, starts) -> set:
        """Transitive closure over successors, INCLUDING the start nodes."""
        reachable: set = set()
        stack = list(starts)
        while stack:
            name = stack.pop()
            if name in reachable:
                continue
            reachable.add(name)
            stack.extend(self._nodes[name].successors)
        return reachable

    def descendants(self, name: str) -> frozenset:
        """Every node strictly downstream of `name` (transitive successors,
        excluding `name` itself).  Cached -- the pipeline engine consults
        this per node per execution pass to defer descendants of in-flight
        branches (graph-order data dependencies must hold even when a
        downstream input key already exists in the swag)."""
        cached = self._descendants_cache.get(name)
        if cached is not None:
            return cached
        if name not in self._nodes:
            raise GraphError(f"Unknown node: {name}")
        result = frozenset(
            self._reachable_from(self._nodes[name].successors))
        self._descendants_cache[name] = result
        return result

    def iterate_after(self, name: str, head: str | None = None) -> list:
        """Nodes strictly after `name` in execution order (restricted to
        `head`'s sub-path when given) -- used to resume a frame when a
        remote element replies (reference graph.py:96-103)."""
        path = self.get_path(head)
        try:
            index = path.index(name)
        except ValueError:
            raise GraphError(f"Unknown node: {name}") from None
        return path[index + 1:]

    def __repr__(self):
        return f"Graph({self.topological_order()})"
