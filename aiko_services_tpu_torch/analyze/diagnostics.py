# Diagnostics: the stable rule-code vocabulary of the static analyzer.
#
# Every finding carries a rule code (AIKO1xx graph/ports, AIKO2xx
# shape/dtype flow, AIKO3xx element/actor safety, AIKO4xx policy
# grammars, AIKO5xx profile-guided tuning, AIKO6xx static
# concurrency), a severity, and a location
# (definition / element / port),
# so CI can diff reports across commits and operators can suppress a
# rule by code (element or pipeline parameter `lint_ignore`).
#
# Severity ladder:
#   error    the definition is wrong: construction-time validation
#            raises DefinitionError for these
#   warning  legal but suspicious (dead output, blocking call): logged
#            at construction, fails `aiko lint --strict`
#   info     analysis limits (a trace the analyzer could not run):
#            reported, never fails the build

from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = ["Diagnostic", "AnalysisReport", "RULES", "severity_of"]

# code -> (default severity, one-line summary).  This table IS the
# README rule-code table; tests assert the two stay in sync.
RULES = {
    # -- AIKO1xx: graph / ports -----------------------------------------
    "AIKO100": ("error", "definition does not parse (schema error)"),
    "AIKO101": ("error", "graph node has no element definition"),
    "AIKO102": ("error", "duplicate element name"),
    "AIKO103": ("error", "element input not produced by any ancestor"),
    "AIKO104": ("warning",
                "dead output: overwritten downstream before any read"),
    "AIKO105": ("error", "map_in names an input port the element "
                         "does not declare"),
    "AIKO106": ("error", "map_out names an output port the element "
                         "does not declare"),
    "AIKO107": ("error", "duplicate port name within an element"),
    # -- AIKO2xx: shape / dtype flow ------------------------------------
    "AIKO201": ("error", "port type is not in the tensor-spec grammar"),
    "AIKO202": ("error", "dtype clash between producer and consumer"),
    "AIKO203": ("error", "tensor rank mismatch between producer and "
                         "consumer"),
    "AIKO204": ("error", "fixed dimension mismatch between producer "
                         "and consumer"),
    "AIKO205": ("error", "symbolic dimension bound to conflicting "
                         "sizes"),
    "AIKO206": ("error", "sharding spec names an axis absent from the "
                         "element's mesh axes"),
    "AIKO207": ("error", "declared output spec disagrees with the "
                         "jax.eval_shape traced output"),
    "AIKO208": ("info", "shape trace unavailable for this element"),
    # -- AIKO3xx: element / actor safety --------------------------------
    "AIKO301": ("warning", "blocking host call inside a non-async "
                           "element's frame path"),
    "AIKO302": ("error", "group_kernel defined on an AsyncHostElement"),
    "AIKO303": ("warning", "cross-stream shared state mutated outside "
                           "the mailbox"),
    "AIKO304": ("error", "deployed element class not importable or not "
                         "a PipelineElement"),
    # -- AIKO4xx: policy grammars ---------------------------------------
    "AIKO401": ("error", "invalid fault-tolerance parameter"),
    "AIKO402": ("error", "invalid fault-injection spec"),
    "AIKO403": ("error", "invalid gateway admission-policy spec"),
    "AIKO404": ("error", "unknown directive in a policy grammar"),
    "AIKO405": ("error", "invalid continuous-batching decode parameter"),
    "AIKO406": ("error", "invalid autoscale policy spec"),
    "AIKO407": ("error", "invalid gateway HA/journal policy spec"),
    "AIKO408": ("error", "invalid prefill/decode disaggregation spec"),
    "AIKO409": ("error", "invalid decode checkpoint/recovery policy "
                         "spec"),
    "AIKO410": ("error", "invalid gateway federation spec"),
    "AIKO411": ("error", "invalid prefix-cache policy spec"),
    "AIKO412": ("error", "invalid autopilot policy spec"),
    # -- AIKO5xx: profile-guided tuning (tune/) --------------------------
    "AIKO501": ("error", "invalid tune SLO/directive spec"),
    "AIKO502": ("warning", "tune recommendation not applicable to the "
                           "definition"),
    "AIKO503": ("info", "trace metadata absent or not joinable against "
                        "the static graph"),
    # -- AIKO6xx: static concurrency (analyze/concurrency.py) ------------
    "AIKO600": ("info", "concurrency pass note (stale baseline entry "
                        "or unreadable source)"),
    "AIKO601": ("warning", "unsynchronized iteration of a container "
                           "attribute mutated from another thread "
                           "role"),
    "AIKO602": ("warning", "check-then-act on a shared attribute "
                           "across thread roles without a lock"),
    "AIKO603": ("warning", "blocking call while holding a lock"),
    "AIKO604": ("warning", "lock-order inversion: acquire-graph cycle "
                           "across methods"),
    "AIKO605": ("warning", "mutable class-level default mutated "
                           "through self"),
}


def severity_of(code: str) -> str:
    return RULES.get(code, ("error", ""))[0]


@dataclass
class Diagnostic:
    code: str
    message: str
    definition: str = ""      # pipeline definition name
    element: str = ""         # element name ("" = pipeline level)
    port: str = ""            # port name when the finding is port-scoped
    severity: str = ""        # defaulted from RULES when empty
    source: str = ""          # file path the definition came from

    def __post_init__(self):
        if not self.severity:
            self.severity = severity_of(self.code)

    @property
    def location(self) -> str:
        parts = [part for part in (self.definition, self.element,
                                   self.port) if part]
        return ".".join(parts) if parts else "<definition>"

    def render(self) -> str:
        return f"{self.code} [{self.severity}] {self.location}: " \
               f"{self.message}"

    def to_dict(self) -> dict:
        return {"code": self.code, "severity": self.severity,
                "definition": self.definition, "element": self.element,
                "port": self.port, "source": self.source,
                "message": self.message}


@dataclass
class AnalysisReport:
    """All findings from one analysis run (one or many definitions)."""

    findings: list = field(default_factory=list)
    passes_run: list = field(default_factory=list)

    def add(self, diagnostic: Diagnostic) -> None:
        self.findings.append(diagnostic)

    def extend(self, other: "AnalysisReport") -> None:
        self.findings.extend(other.findings)
        for name in other.passes_run:
            if name not in self.passes_run:
                self.passes_run.append(name)
        traced = getattr(other, "traced_elements", None)
        if traced:
            mine = getattr(self, "traced_elements", None) or []
            self.traced_elements = mine + list(traced)

    def errors(self) -> list:
        return [d for d in self.findings if d.severity == "error"]

    def warnings(self) -> list:
        return [d for d in self.findings if d.severity == "warning"]

    def failures(self, strict: bool = False) -> list:
        """Findings that should fail the run: errors always; warnings
        too under --strict.  Info diagnostics never fail."""
        if strict:
            return [d for d in self.findings
                    if d.severity in ("error", "warning")]
        return self.errors()

    def by_code(self) -> dict:
        counts: dict[str, int] = {}
        for diagnostic in self.findings:
            counts[diagnostic.code] = counts.get(diagnostic.code, 0) + 1
        return dict(sorted(counts.items()))

    def to_json(self) -> str:
        return json.dumps({
            "version": 1,
            "passes": list(self.passes_run),
            "summary": {
                "findings": len(self.findings),
                "errors": len(self.errors()),
                "warnings": len(self.warnings()),
                "by_code": self.by_code(),
            },
            "findings": [d.to_dict() for d in self.findings],
        }, indent=2, sort_keys=True)

    def render(self) -> str:
        lines = [d.render() for d in self.findings]
        by_code = self.by_code()
        summary = ", ".join(f"{code}x{count}"
                            for code, count in by_code.items())
        lines.append(
            f"{len(self.findings)} finding(s) "
            f"({len(self.errors())} error(s), "
            f"{len(self.warnings())} warning(s))"
            + (f": {summary}" if summary else ""))
        return "\n".join(lines)
