# Pass 3 -- element/actor safety lint (AIKO3xx).
#
# An AST pass over the modules a definition actually deploys.  The
# engine's concurrency model makes three classes of element code wrong
# in ways that only surface under load:
#
#   AIKO301  a blocking host call (time.sleep, socket dial, subprocess,
#            .block_until_ready) inside process_frame/compute of a
#            NON-AsyncHostElement: it stalls the pipeline event loop --
#            on a tunneled TPU one 100 ms readback serializes every
#            stream.  AsyncHostElement.process_async runs on a worker
#            thread, where blocking is the point.
#   AIKO302  group_kernel on an AsyncHostElement: host work cannot
#            trace into a fused device program (the engine rejects this
#            at build; the linter catches it offline).
#   AIKO303  mutation of cross-stream shared state outside the mailbox:
#            `global` writes or attribute stores on self.pipeline /
#            self.process from inside process_frame race other streams'
#            frames; route mutations through post_message instead.
#
# Only methods DEFINED by deployed element classes are scanned (the
# framework engine's own process_frame wrappers are trusted); a line
# carrying "# aiko: allow" suppresses its findings, and an element
# parameter `lint_ignore: ["AIKO301"]` suppresses by rule code.

from __future__ import annotations

import ast
import inspect
import textwrap

from .diagnostics import AnalysisReport, Diagnostic

__all__ = ["run_actor_pass", "statement_suppressed"]

# dotted-call patterns that block the calling thread.  Matched against
# the rendered dotted name of Call nodes ("time.sleep", "socket.create_
# connection", ...) -- a prefix match on the first token catches
# module-level families (subprocess.run / .call / .Popen).
_BLOCKING_CALLS = {
    "time.sleep": "time.sleep blocks the pipeline event loop",
    "sleep": "sleep() blocks the pipeline event loop",
    "input": "input() blocks the pipeline event loop",
    "open": "file I/O on the event loop stalls every stream",
}
_BLOCKING_MODULES = {
    "socket": "socket I/O on the event loop stalls every stream",
    "subprocess": "subprocess calls block the event loop",
    "requests": "network I/O on the event loop stalls every stream",
    "urllib": "network I/O on the event loop stalls every stream",
    "http": "network I/O on the event loop stalls every stream",
}
_BLOCKING_ATTRS = {
    "block_until_ready": ".block_until_ready() stalls the event loop "
                         "on device completion (use blocking_metrics "
                         "or an AsyncHostElement)",
}

# methods that run ON the event loop (or trace into a device program)
_FRAME_PATH_METHODS = ("process_frame", "compute", "group_kernel")

_FRAMEWORK_PREFIX = "aiko_services_tpu_torch.pipeline"


def _dotted_name(node) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def statement_suppressed(source_lines, ast_node) -> bool:
    """True when ANY line a statement spans carries "# aiko: allow" --
    a multi-line call or comprehension is suppressible on whichever of
    its lines the comment reads best (shared with the AIKO6xx
    concurrency pass in concurrency.py)."""
    start = getattr(ast_node, "lineno", 0) - 1
    if start < 0 or start >= len(source_lines):
        return False
    end = getattr(ast_node, "end_lineno", None) or (start + 1)
    for index in range(start, min(end, len(source_lines))):
        if "# aiko: allow" in source_lines[index]:
            return True
    return False


_suppressed = statement_suppressed  # historical internal name


class _MethodScanner(ast.NodeVisitor):
    def __init__(self, report, definition_name, element_name,
                 method_name, source_lines, line_offset):
        self.report = report
        self.definition_name = definition_name
        self.element_name = element_name
        self.method_name = method_name
        self.source_lines = source_lines
        self.line_offset = line_offset

    def _add(self, code, message, node):
        if _suppressed(self.source_lines, node):
            return
        self.report.add(Diagnostic(
            code,
            f"{self.method_name}() line "
            f"{node.lineno + self.line_offset}: {message}",
            definition=self.definition_name,
            element=self.element_name))

    def visit_Call(self, node):
        dotted = _dotted_name(node.func)
        if dotted is not None:
            if dotted in _BLOCKING_CALLS:
                self._add("AIKO301", _BLOCKING_CALLS[dotted], node)
            else:
                root = dotted.split(".", 1)[0]
                if root in _BLOCKING_MODULES:
                    self._add("AIKO301", _BLOCKING_MODULES[root], node)
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _BLOCKING_ATTRS):
            self._add("AIKO301", _BLOCKING_ATTRS[node.func.attr], node)
        self.generic_visit(node)

    def visit_Global(self, node):
        self._add(
            "AIKO303",
            f"`global {', '.join(node.names)}` mutates process-wide "
            f"state from the frame path; cross-stream state must go "
            f"through the mailbox (post_message)", node)
        self.generic_visit(node)

    def visit_Assign(self, node):
        for target in node.targets:
            self._check_store(target)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_store(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._check_store(node.target)
        self.generic_visit(node)

    def _check_store(self, target):
        if isinstance(target, (ast.Tuple, ast.List)):
            for entry in target.elts:  # unpacking assignment targets
                self._check_store(entry)
            return
        if isinstance(target, ast.Starred):
            self._check_store(target.value)
            return
        dotted = _dotted_name(target) if isinstance(
            target, ast.Attribute) else None
        if dotted and (dotted.startswith("self.pipeline.")
                       or dotted.startswith("self.process.")):
            self._add(
                "AIKO303",
                f"assignment to {dotted} from the frame path mutates "
                f"state shared by every stream; post a mailbox message "
                f"instead", target)


def _scan_method(report, definition_name, element_name, cls,
                 method_name) -> None:
    """Scan the resolved method if a NON-framework class defines it."""
    for klass in cls.__mro__:
        function = klass.__dict__.get(method_name)
        if function is None:
            continue
        module_name = getattr(klass, "__module__", "")
        if module_name.startswith(_FRAMEWORK_PREFIX):
            return  # the engine's own implementation: trusted
        try:
            source = textwrap.dedent(inspect.getsource(function))
            _, line = inspect.getsourcelines(function)
        except (OSError, TypeError):
            return
        try:
            tree = ast.parse(source)
        except SyntaxError:
            return
        scanner = _MethodScanner(
            report, definition_name, element_name, method_name,
            source.splitlines(), line - 1)
        scanner.visit(tree)
        return


def run_actor_pass(definition) -> AnalysisReport:
    """AST-lint every locally-deployed element class of a parsed
    PipelineDefinition."""
    from ..pipeline.element import AsyncHostElement, PipelineElement
    from ..utils import load_module

    report = AnalysisReport(passes_run=["actor"])
    scanned: set = set()
    for element in definition.elements:
        if not element.is_local:
            continue
        module_name = element.deploy_local["module"]
        class_name = element.deploy_local["class_name"]
        try:
            module = load_module(module_name)
            cls = getattr(module, class_name)
        except Exception as error:
            report.add(Diagnostic(
                "AIKO304",
                f"cannot import {class_name} from {module_name}: "
                f"{error}", definition=definition.name,
                element=element.name))
            continue
        if not (isinstance(cls, type)
                and issubclass(cls, PipelineElement)):
            report.add(Diagnostic(
                "AIKO304",
                f"{module_name}.{class_name} is not a PipelineElement",
                definition=definition.name, element=element.name))
            continue
        if cls in scanned:
            continue  # one finding set per class, not per graph seat
        scanned.add(cls)
        if issubclass(cls, AsyncHostElement):
            if (cls.group_kernel
                    is not PipelineElement.group_kernel):
                report.add(Diagnostic(
                    "AIKO302",
                    f"{class_name} is an AsyncHostElement but defines "
                    f"group_kernel; host-thread work cannot trace into "
                    f"a fused device program",
                    definition=definition.name, element=element.name))
            continue  # blocking calls are legal in process_async
        for method_name in _FRAME_PATH_METHODS:
            _scan_method(report, definition.name, element.name, cls,
                         method_name)
    return report
