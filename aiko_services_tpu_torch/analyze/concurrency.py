# Pass 5 -- whole-package static concurrency lint (AIKO6xx).
#
# The framework's worst production bugs are cross-thread races inside
# the actor fleet, not dataflow mistakes: `Pipeline.load()` once
# iterated the live stream dict while gateways routed ("dictionary
# changed size during iteration" under a 1,000-stream creation storm),
# and journal replay raced the forget flush.  Every one of those is a
# statically detectable shape, so this pass scans Python SOURCE (not
# definitions) and reports:
#
#   AIKO601  unsynchronized iteration of a container attribute that
#            another thread role mutates (the Pipeline.load() class --
#            fix: `list()` snapshot before iterating, or a shared lock)
#   AIKO602  check-then-act on a shared attribute across thread roles
#            without a lock (`if self.x: self.x.pop()` while another
#            role rebinds/mutates self.x)
#   AIKO603  blocking host call (actor_lint's _BLOCKING_* tables)
#            while holding a lock
#   AIKO604  lock-order inversion: a cycle in the per-class lock
#            acquire graph (nested `with` blocks, followed through
#            self-method calls)
#   AIKO605  mutable class-level default (class-attr dict/list/set
#            mutated through self and never rebound per-instance)
#
# Thread roles are inferred from the dispatch-registration call sites
# the runtime actually uses -- add_mailbox_handler / add_timer_handler
# / add_queue_handler / add_flatout_handler / add_message_handler /
# post_message("command") register onto the process event loop;
# threading.Thread(target=self.m) starts a dedicated worker thread --
# plus an explicit `# aiko: role=<name>` escape hatch on (or directly
# above) the `def` line.  Public methods are additionally
# "wire"-callable: another service (possibly on another thread, like
# the serving gateway reading `Pipeline.load()` per routing decision)
# may call them at any time.  Roles propagate through self-method
# calls, so a private helper inherits the roles of every caller.
#
# Two roles are POTENTIALLY CONCURRENT when they can run on different
# threads: everything registered on the event engine shares the one
# loop thread (mailbox/timer/pump/message never race each other), a
# worker thread races the loop and other workers, and "wire" races
# everything including itself.
#
# Findings integrate with the shared diagnostics registry, `# aiko:
# allow` statement suppression (any line of a multi-line statement),
# and a committed BASELINE file: pre-existing accepted findings are
# fingerprinted (code + file + class.method + attribute -- no line
# numbers, so unrelated edits don't churn it) and filtered out, while
# every NEW finding fails `aiko lint --code --strict`.  Stale baseline
# entries surface as AIKO600 info notes so they get expired.

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from .actor_lint import (
    _BLOCKING_ATTRS, _BLOCKING_CALLS, _BLOCKING_MODULES,
    statement_suppressed)
from .diagnostics import AnalysisReport, Diagnostic

__all__ = [
    "run_code_pass", "role_map", "finding_fingerprint",
    "load_baseline", "apply_baseline", "write_baseline",
]

# dispatch-registration call sites -> role of the registered method.
# Everything here runs on the process event-loop thread; the role
# names stay distinct because they document INTENT (a timer racing a
# mailbox handler is impossible today, but the roles tell a reader
# which dispatch path a method belongs to).
_REGISTRAR_ROLE = {
    "add_mailbox_handler": "mailbox",
    "add_timer_handler": "timer",
    "add_queue_handler": "pump",
    "add_flatout_handler": "pump",
    "add_message_handler": "message",
}
# roles that share the single event-loop thread
_LOOP_AFFINE = frozenset({"mailbox", "timer", "pump", "message"})

_ROLE_COMMENT = re.compile(r"#\s*aiko:\s*role=([A-Za-z_:]+)")
_KNOWN_ROLES = frozenset(
    {"mailbox", "timer", "pump", "message", "worker", "wire", "none"})

# in-place container mutators (dict/list/set/deque vocabulary)
_MUTATORS = frozenset({
    "append", "appendleft", "add", "extend", "insert", "remove",
    "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault",
})
# C-level copying calls: `list(self.x)` snapshots atomically (the GIL
# is never yielded mid-copy), so iterating the RESULT is safe
_SNAPSHOT_CALLS = frozenset(
    {"list", "tuple", "set", "frozenset", "dict", "sorted", "len",
     "sum", "min", "max", "any", "all"})
# reading calls that do not extend a check-then-act window
_SAFE_ATTR_CALLS = frozenset({"get", "items", "keys", "values", "copy"})

_BASES_FLEET = ("Actor", "Service", "Element", "Engine", "Gateway",
                "Keeper", "Worker", "Pipeline", "Manager", "Registrar",
                "Telemetry", "AutoPilot", "Autoscaler", "Journal",
                "Monitor", "Scheduler", "Producer", "Consumer",
                "Server", "Client", "Thread")


def _self_dotted(node) -> str | None:
    """Render an attribute chain rooted at `self` ("self.a.b" -> "a.b"),
    None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return ".".join(reversed(parts))
    return None


def _dotted_name(node) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _lock_name(expr) -> str | None:
    """`with self._lock:` -> "_lock" when the attribute smells like a
    lock (name contains lock/mutex/cond/sem)."""
    dotted = _self_dotted(expr)
    if dotted is None:
        return None
    leaf = dotted.rsplit(".", 1)[-1].lower()
    if any(word in leaf for word in ("lock", "mutex", "cond", "sem")):
        return dotted
    return None


def _iterated_attr(expr) -> str | None:
    """The self-attribute a `for`/comprehension iterates LIVE:
    `self.streams`, `self.streams.values()|items()|keys()`.  A
    snapshot (`list(self.streams)`) is a Call to a builtin and
    resolves to None here -- that is the sanctioned discipline."""
    dotted = _self_dotted(expr)
    if dotted is not None:
        return dotted
    if (isinstance(expr, ast.Call) and not expr.args
            and not expr.keywords
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr in ("items", "values", "keys")):
        return _self_dotted(expr.func.value)
    return None


@dataclass
class _Access:
    kind: str                 # iterate | mutate | rebind | check
    attr: str
    method: str
    lineno: int
    locks: frozenset
    node: object = None
    detail: str = ""          # mutator name, check shape, ...


@dataclass
class _MethodFacts:
    name: str
    node: object
    roles: set = field(default_factory=set)
    accesses: list = field(default_factory=list)
    blocking: list = field(default_factory=list)   # (msg, node, locks)
    acquires: list = field(default_factory=list)   # (lock, held, node)
    self_calls: list = field(default_factory=list)  # (callee, held, node)


class _MethodWalker(ast.NodeVisitor):
    """One pass over a method body: attribute access map (read /
    write / iterate / delete with the lock set held at each site),
    blocking-under-lock sites, lock-acquire nesting, self-calls."""

    def __init__(self, facts: _MethodFacts):
        self.facts = facts
        self._held: list[str] = []

    # -- locks ---------------------------------------------------------

    def _locks(self) -> frozenset:
        return frozenset(self._held)

    def visit_With(self, node):
        acquired = []
        for item in node.items:
            self.visit(item.context_expr)
            lock = _lock_name(item.context_expr)
            if lock is not None:
                self.facts.acquires.append(
                    (lock, self._locks(), node))
                self._held.append(lock)
                acquired.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._held.pop()

    visit_AsyncWith = visit_With

    # -- iteration -----------------------------------------------------

    def _note_iterate(self, iter_expr, node):
        attr = _iterated_attr(iter_expr)
        if attr is not None:
            self.facts.accesses.append(_Access(
                "iterate", attr, self.facts.name, node.lineno,
                self._locks(), node))

    def visit_For(self, node):
        self._note_iterate(node.iter, node)
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def _visit_comprehension(self, node):
        for generator in node.generators:
            self._note_iterate(generator.iter, node)
        self.generic_visit(node)

    visit_ListComp = _visit_comprehension
    visit_SetComp = _visit_comprehension
    visit_DictComp = _visit_comprehension
    visit_GeneratorExp = _visit_comprehension

    # -- stores --------------------------------------------------------

    def _note_store(self, target, node, kind="mutate"):
        if isinstance(target, (ast.Tuple, ast.List)):
            for element in target.elts:
                self._note_store(element, node, kind)
            return
        if isinstance(target, ast.Starred):
            self._note_store(target.value, node, kind)
            return
        if isinstance(target, ast.Subscript):
            attr = _self_dotted(target.value)
            if attr is not None:
                self.facts.accesses.append(_Access(
                    "mutate", attr, self.facts.name, node.lineno,
                    self._locks(), node, detail="subscript"))
            return
        if isinstance(target, ast.Attribute):
            attr = _self_dotted(target)
            if attr is not None:
                self.facts.accesses.append(_Access(
                    "rebind", attr, self.facts.name, node.lineno,
                    self._locks(), node))

    def visit_Assign(self, node):
        for target in node.targets:
            self._note_store(target, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._note_store(node.target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._note_store(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node):
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                attr = _self_dotted(target.value)
                if attr is not None:
                    self.facts.accesses.append(_Access(
                        "mutate", attr, self.facts.name, node.lineno,
                        self._locks(), node, detail="del"))
            elif isinstance(target, ast.Attribute):
                attr = _self_dotted(target)
                if attr is not None:
                    self.facts.accesses.append(_Access(
                        "rebind", attr, self.facts.name, node.lineno,
                        self._locks(), node, detail="del"))
        self.generic_visit(node)

    # -- calls ---------------------------------------------------------

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute):
            owner = _self_dotted(func.value)
            if owner is not None and func.attr in _MUTATORS:
                self.facts.accesses.append(_Access(
                    "mutate", owner, self.facts.name, node.lineno,
                    self._locks(), node, detail=func.attr))
            if (isinstance(func.value, ast.Name)
                    and func.value.id == "self"):
                self.facts.self_calls.append(
                    (func.attr, self._locks(), node))
        # blocking-call vocabulary shared with the AIKO301 actor pass.
        # Recorded with the LEXICAL lock set; the class-level rule adds
        # locks inherited from call sites (`_locked`-style helpers)
        # before deciding AIKO603.
        dotted = _dotted_name(func)
        message = None
        if dotted is not None:
            if dotted in _BLOCKING_CALLS:
                message = _BLOCKING_CALLS[dotted]
            else:
                root = dotted.split(".", 1)[0]
                if root in _BLOCKING_MODULES:
                    message = _BLOCKING_MODULES[root]
        if (message is None and isinstance(func, ast.Attribute)
                and func.attr in _BLOCKING_ATTRS):
            message = _BLOCKING_ATTRS[func.attr]
        if message is not None:
            self.facts.blocking.append(
                (message, node, self._locks()))
        self.generic_visit(node)

    # -- check-then-act ------------------------------------------------

    def visit_If(self, node):
        checked = {
            attr for attr in (
                _self_dotted(sub) for sub in ast.walk(node.test)
                if isinstance(sub, ast.Attribute))
            if attr is not None}
        if checked:
            used = self._dependent_uses(node.body, checked)
            for attr in sorted(used):
                self.facts.accesses.append(_Access(
                    "check", attr, self.facts.name, node.lineno,
                    self._locks(), node))
        self.generic_visit(node)

    def _dependent_uses(self, body, checked: set) -> set:
        """Attributes from `checked` that the if-body USES in a way
        that assumes the check still holds: subscript access, an
        in-place mutator, or a method call on the checked object."""
        used = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Subscript):
                    attr = _self_dotted(sub.value)
                    if attr in checked:
                        used.add(attr)
                elif isinstance(sub, ast.Call):
                    func = sub.func
                    if (isinstance(func, ast.Attribute)
                            and func.attr not in _SAFE_ATTR_CALLS):
                        attr = _self_dotted(func.value)
                        if attr in checked:
                            used.add(attr)
        return used


class _ClassFacts:
    def __init__(self, node: ast.ClassDef, source_lines, path: str):
        self.node = node
        self.name = node.name
        self.path = path
        self.source_lines = source_lines
        self.methods: dict[str, _MethodFacts] = {}
        self.class_level_mutables: dict[str, ast.stmt] = {}
        self.bases = [
            (_dotted_name(base) or "") for base in node.bases]

        for stmt in node.body:
            if isinstance(stmt,
                          (ast.FunctionDef, ast.AsyncFunctionDef)):
                facts = _MethodFacts(stmt.name, stmt)
                _MethodWalker(facts).visit(stmt)
                self.methods[stmt.name] = facts
            elif isinstance(stmt, ast.Assign):
                for target in stmt.targets:
                    if (isinstance(target, ast.Name)
                            and _is_mutable_literal(stmt.value)):
                        self.class_level_mutables[target.id] = stmt

    # -- role inference ------------------------------------------------

    def infer_roles(self) -> None:
        explicit: dict[str, set] = {}
        for name, facts in self.methods.items():
            roles = self._explicit_roles(facts.node)
            if roles is not None:
                explicit[name] = roles
                facts.roles |= (roles - {"none"})

        # registration call sites, scanned across EVERY method body
        for facts in self.methods.values():
            for sub in ast.walk(facts.node):
                if not isinstance(sub, ast.Call):
                    continue
                self._roles_from_call(sub, explicit)

        # public surface: wire-callable from any thread
        for name, facts in self.methods.items():
            if name in explicit or name.startswith("_"):
                continue
            facts.roles.add("wire")

        # propagate caller roles through self-method calls (a private
        # helper runs on every thread that calls it)
        changed = True
        while changed:
            changed = False
            for facts in self.methods.values():
                if not facts.roles:
                    continue
                for callee, _, _ in facts.self_calls:
                    target = self.methods.get(callee)
                    if (target is None or callee in explicit
                            or callee.startswith("__")):
                        continue
                    merged = target.roles | facts.roles
                    if merged != target.roles:
                        target.roles = merged
                        changed = True

    def _explicit_roles(self, node) -> set | None:
        """`# aiko: role=<name>` on the def line or the line above it
        (comma/colon-separated for multi-role)."""
        for lineno in (node.lineno, node.lineno - 1):
            index = lineno - 1
            if not (0 <= index < len(self.source_lines)):
                continue
            match = _ROLE_COMMENT.search(self.source_lines[index])
            if match is None:
                continue
            names = {part for part in
                     re.split(r"[:+,]", match.group(1).lower())
                     if part}
            return {name for name in names if name in _KNOWN_ROLES} \
                or {"none"}
        return None

    def _roles_from_call(self, call: ast.Call, explicit: dict) -> None:
        func = call.func

        def assign(method_name: str | None, role: str):
            facts = self.methods.get(method_name or "")
            if facts is None or method_name in explicit:
                return
            facts.roles.add(role)

        if isinstance(func, ast.Attribute):
            role = _REGISTRAR_ROLE.get(func.attr)
            if role is not None and call.args:
                handler = call.args[0]
                if isinstance(handler, ast.Attribute):
                    assign(_self_dotted(handler), role)
                return
            if func.attr in ("post_message", "post_message_later"):
                if (call.args and isinstance(call.args[0], ast.Constant)
                        and isinstance(call.args[0].value, str)):
                    assign(call.args[0].value, "mailbox")
                return
        # threading.Thread(target=self.m) -- a dedicated worker thread
        # per target method
        name = _dotted_name(func) or ""
        if name.rsplit(".", 1)[-1] == "Thread":
            for keyword in call.keywords:
                if (keyword.arg == "target"
                        and isinstance(keyword.value, ast.Attribute)):
                    target = _self_dotted(keyword.value)
                    if target is not None and "." not in target:
                        assign(target, f"worker:{target}")

    def is_fleet_class(self) -> bool:
        """Only classes with a cross-thread surface are analyzed: actor
        fleet bases, or any inferred non-default role (a handler
        registration / worker-thread spawn inside the class)."""
        for base in self.bases:
            leaf = base.rsplit(".", 1)[-1]
            if any(leaf.endswith(word) for word in _BASES_FLEET):
                return True
        return any(
            role for facts in self.methods.values()
            for role in facts.roles if role != "wire")


def _is_mutable_literal(value) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set)):
        return True
    return (isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in ("dict", "list", "set")
            and not value.args and not value.keywords)


def _affinity(role: str) -> str:
    if role in _LOOP_AFFINE:
        return "loop"
    return role  # wire, worker:<target>


def _concurrent(role_a: str, role_b: str) -> bool:
    """Can these two roles run at the same instant on different
    threads?"""
    if role_a == "wire" or role_b == "wire":
        return True
    return _affinity(role_a) != _affinity(role_b)


def _roles_concurrent(roles_a, roles_b) -> tuple | None:
    for role_a in sorted(roles_a):
        for role_b in sorted(roles_b):
            if _concurrent(role_a, role_b):
                return (role_a, role_b)
    return None


# -- per-class rules ------------------------------------------------------


def _emit(report, code, cls: _ClassFacts, access_node, method: str,
          message: str, port: str) -> None:
    if statement_suppressed(cls.source_lines, access_node):
        return
    report.add(Diagnostic(
        code, message, definition=cls.name, element=method,
        port=port, source=cls.path))


def _inherited_locks(cls: _ClassFacts) -> dict:
    """Locks a method is ALWAYS called under: for a private method,
    the intersection of the lock sets held at every in-class call
    site (transitively).  `loop()` calling `_next_work_locked()` under
    `self._condition` protects the callee's accesses exactly like a
    lexical `with`.  Public methods inherit nothing -- an external
    caller holds no lock."""
    call_sites: dict[str, list] = {}
    for name, facts in cls.methods.items():
        for callee, held, _ in facts.self_calls:
            call_sites.setdefault(callee, []).append((name, held))

    inherited = {name: frozenset() for name in cls.methods}
    changed = True
    while changed:
        changed = False
        for name in cls.methods:
            if not name.startswith("_") or name.startswith("__"):
                continue
            sites = call_sites.get(name)
            if not sites:
                continue
            merged = None
            for caller, held in sites:
                effective = held | inherited.get(caller, frozenset())
                merged = (effective if merged is None
                          else merged & effective)
            if merged and merged != inherited[name]:
                inherited[name] = frozenset(merged)
                changed = True
    return inherited


def _check_class(report: AnalysisReport, cls: _ClassFacts) -> None:
    cls.infer_roles()
    if not cls.is_fleet_class():
        return
    inherited = _inherited_locks(cls)

    by_attr: dict[str, list[_Access]] = {}
    for facts in cls.methods.values():
        if facts.name.startswith("__"):
            continue  # construction/dunder: single-threaded by contract
        for access in facts.accesses:
            by_attr.setdefault(access.attr, []).append(access)

    roles_of = {name: facts.roles
                for name, facts in cls.methods.items()}

    def effective_locks(access: _Access) -> frozenset:
        return access.locks | inherited.get(access.method, frozenset())

    def hazards(access: _Access, kinds) -> list:
        """Sites of OTHER methods whose roles can run concurrently
        with `access` and are not protected by a common lock."""
        found = []
        for other in by_attr.get(access.attr, ()):
            if other.kind not in kinds:
                continue
            if other.method == access.method:
                continue
            pair = _roles_concurrent(
                roles_of.get(access.method, ()),
                roles_of.get(other.method, ()))
            if pair is None:
                continue
            if effective_locks(access) & effective_locks(other):
                continue  # both under one shared lock
            found.append((other, pair))
        return found

    # AIKO601 / AIKO602 ---------------------------------------------------
    for attr, accesses in sorted(by_attr.items()):
        for access in accesses:
            if access.kind == "iterate":
                racing = hazards(access, ("mutate",))
                if racing:
                    other, (role_a, role_b) = racing[0]
                    _emit(
                        report, "AIKO601", cls, access.node,
                        access.method,
                        f"{access.method}() line {access.lineno} "
                        f"[role {role_a}] iterates live `self.{attr}` "
                        f"while {other.method}() line {other.lineno} "
                        f"[role {role_b}] mutates it; snapshot with "
                        f"list(self.{attr.split('.', 1)[0]}...) before "
                        f"iterating, or hold one lock at both sites",
                        port=attr)
            elif access.kind == "check":
                racing = hazards(access, ("mutate", "rebind"))
                if racing:
                    other, (role_a, role_b) = racing[0]
                    _emit(
                        report, "AIKO602", cls, access.node,
                        access.method,
                        f"{access.method}() line {access.lineno} "
                        f"[role {role_a}] checks `self.{attr}` then "
                        f"acts on it, while {other.method}() line "
                        f"{other.lineno} [role {role_b}] "
                        f"{'rebinds' if other.kind == 'rebind' else 'mutates'}"
                        f" it; bind a local snapshot "
                        f"(`x = self.{attr}`) and use that, or hold "
                        f"one lock across check and act",
                        port=attr)

    # AIKO603: blocking call while holding a lock -------------------------
    for facts in cls.methods.values():
        for message, node, locks in facts.blocking:
            held = locks | inherited.get(facts.name, frozenset())
            if not held:
                continue
            _emit(
                report, "AIKO603", cls, node, facts.name,
                f"{facts.name}() line {node.lineno}: {message} -- "
                f"while holding {', '.join(sorted(held))}; move the "
                f"blocking call outside the critical section",
                port=";".join(sorted(held)))

    # AIKO604: lock-order inversion ---------------------------------------
    _check_lock_order(report, cls)

    # AIKO605: mutable class-level defaults -------------------------------
    for attr, stmt in sorted(cls.class_level_mutables.items()):
        mutated = [
            access for facts in cls.methods.values()
            for access in facts.accesses
            if access.attr == attr and access.kind == "mutate"]
        rebound = any(
            access.attr == attr and access.kind == "rebind"
            for facts in cls.methods.values()
            for access in facts.accesses)
        if mutated and not rebound:
            site = mutated[0]
            _emit(
                report, "AIKO605", cls, stmt, "<class>",
                f"class-level default `{attr}` (line {stmt.lineno}) is "
                f"mutated through self in {site.method}() line "
                f"{site.lineno} and never rebound per-instance: every "
                f"instance shares ONE container across threads; assign "
                f"it in __init__ instead",
                port=attr)


def _check_lock_order(report: AnalysisReport, cls: _ClassFacts) -> None:
    # locks each method EVENTUALLY acquires (direct + via self-calls)
    eventual: dict[str, set] = {
        name: {lock for lock, _, _ in facts.acquires}
        for name, facts in cls.methods.items()}
    changed = True
    while changed:
        changed = False
        for name, facts in cls.methods.items():
            for callee, _, _ in facts.self_calls:
                callee_locks = eventual.get(callee)
                if callee_locks and not callee_locks <= eventual[name]:
                    eventual[name] |= callee_locks
                    changed = True

    edges: dict[str, set] = {}
    provenance: dict[tuple, tuple] = {}

    def add_edge(held, lock, method, node):
        for holder in held:
            if holder == lock:
                continue
            edges.setdefault(holder, set()).add(lock)
            provenance.setdefault((holder, lock), (method, node))

    for name, facts in cls.methods.items():
        for lock, held, node in facts.acquires:
            add_edge(held, lock, name, node)
        for callee, held, node in facts.self_calls:
            if held:
                for lock in eventual.get(callee, ()):
                    add_edge(held, lock, name, node)

    # cycle detection over the small per-class lock graph
    seen_cycles = set()
    for start in sorted(edges):
        stack = [(start, [start])]
        while stack:
            node_name, path = stack.pop()
            for successor in sorted(edges.get(node_name, ())):
                if successor == start:
                    cycle = tuple(path)
                    pivot = cycle.index(min(cycle))
                    canonical = cycle[pivot:] + cycle[:pivot]
                    if canonical in seen_cycles:
                        continue
                    seen_cycles.add(canonical)
                    method, site = provenance[
                        (path[-1], start)]
                    _emit(
                        report, "AIKO604", cls, site, method,
                        f"lock-order inversion: "
                        f"{' -> '.join(canonical + (canonical[0],))} "
                        f"(edge closed in {method}() line "
                        f"{site.lineno}); acquire these locks in one "
                        f"global order",
                        port="->".join(canonical))
                elif successor not in path:
                    stack.append((successor, path + [successor]))


# -- module / package driver ----------------------------------------------


def _scan_source(report: AnalysisReport, text: str, path: str) -> None:
    try:
        tree = ast.parse(text)
    except SyntaxError as error:
        report.add(Diagnostic(
            "AIKO600", f"source does not parse: {error}", source=path))
        return
    source_lines = text.splitlines()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            _check_class(report,
                         _ClassFacts(node, source_lines, path))


def _relative(path: Path, root: Path | None) -> str:
    try:
        if root is not None:
            return path.resolve().relative_to(
                root.resolve()).as_posix()
    except ValueError:
        pass
    return path.as_posix()


def run_code_pass(paths, root=None) -> AnalysisReport:
    """AIKO6xx concurrency lint over Python sources: files or
    directories (searched recursively for *.py, skipping __pycache__).
    Findings are deterministically ordered, so two runs over one tree
    render byte-identical reports."""
    root = Path(root) if root is not None else Path.cwd()
    files: dict[str, Path] = {}
    for entry in paths:
        entry = Path(entry)
        if entry.is_dir():
            candidates = sorted(entry.rglob("*.py"))
        else:
            candidates = [entry]
        for candidate in candidates:
            if "__pycache__" in candidate.parts:
                continue
            files[_relative(candidate, root)] = candidate

    report = AnalysisReport(passes_run=["code"])
    for label in sorted(files):
        path = files[label]
        try:
            text = path.read_text()
        except OSError as error:
            report.add(Diagnostic(
                "AIKO600", f"unreadable source: {error}", source=label))
            continue
        _scan_source(report, text, label)
    report.findings.sort(
        key=lambda d: (d.source, d.code, d.definition, d.element,
                       d.port, d.message))
    return report


def role_map(text: str, path: str = "<source>") -> dict:
    """{class: {method: sorted role list}} for one source text --
    the inference surface, exposed for tests and `aiko lint` users
    verifying an escape-hatch comment took effect."""
    tree = ast.parse(text)
    out: dict[str, dict] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            cls = _ClassFacts(node, text.splitlines(), path)
            cls.infer_roles()
            out[cls.name] = {
                name: sorted(facts.roles)
                for name, facts in cls.methods.items()}
    return out


# -- baseline -------------------------------------------------------------


def finding_fingerprint(diagnostic: Diagnostic) -> str:
    """Stable identity of one accepted finding: code + file +
    Class.method + attribute/lock detail.  Deliberately line-number
    free, so unrelated edits to the file do not churn the baseline."""
    return " ".join((
        diagnostic.code, diagnostic.source,
        f"{diagnostic.definition}.{diagnostic.element}",
        diagnostic.port or "-"))


def load_baseline(path) -> list:
    document = json.loads(Path(path).read_text())
    if not isinstance(document, dict) or "entries" not in document:
        raise ValueError(
            f"{path}: baseline must be an object with an 'entries' "
            f"list")
    return list(document["entries"])


def write_baseline(path, report: AnalysisReport) -> int:
    entries = sorted({
        finding_fingerprint(d) for d in report.findings
        if d.code != "AIKO600"})
    Path(path).write_text(json.dumps(
        {"version": 1, "entries": entries}, indent=2) + "\n")
    return len(entries)


def apply_baseline(report: AnalysisReport, entries) -> int:
    """Filter baselined findings out of `report` IN PLACE.  Matched
    entries are accepted pre-existing findings; every entry that no
    longer matches anything is STALE and surfaces as an AIKO600 info
    note (expire it by re-running with --update-baseline).  Returns
    the number of findings filtered."""
    accepted = set(entries)
    matched: set = set()
    kept = []
    for diagnostic in report.findings:
        fingerprint = finding_fingerprint(diagnostic)
        if diagnostic.code != "AIKO600" and fingerprint in accepted:
            matched.add(fingerprint)
            continue
        kept.append(diagnostic)
    filtered = len(report.findings) - len(kept)
    for stale in sorted(accepted - matched):
        kept.append(Diagnostic(
            "AIKO600",
            f"stale baseline entry (finding no longer produced): "
            f"{stale}; remove it or refresh with --update-baseline"))
    report.findings = kept
    return filtered
