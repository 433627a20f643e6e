# Disaggregated-serving policy: the gateway-side knobs of the
# prefill/decode split (decode/disagg.py holds the data plane).
#
# Grammar (gateway parameter `disagg`, same directive style as the
# admission/autoscale/journal policies -- operators learn one shape):
#
#   policy    := directive (";" directive)*
#   directive := "role=" ("prefill"|"decode")
#                          a REPLICA-side spec pins the replica's pool;
#                          on the gateway spec it is rejected by
#                          DisaggPolicy.parse's cross-field check
#                          (a gateway fronts BOTH pools)
#              | "adopt_timeout=" float
#                          seconds a decode replica's KV fetch may take
#                          before the adopt falls back to a local
#                          re-prefill (bounds how long one dead prefill
#                          replica can stall a stream's first token)
#              | "min_replicas:" pool "=" int
#                          per-pool floor for the autoscaler (pool in
#                          prefill|decode); the two pools scale on
#                          DIFFERENT signals -- prefill on queue wait,
#                          decode on slot occupancy -- so they need
#                          separate floors
#
# Example: "adopt_timeout=2;min_replicas:prefill=1;min_replicas:decode=2"
#
# Validation is at parse time through the shared directive core
# (analyze/grammar.py): `aiko lint` checks it offline as AIKO408 with
# the same messages Gateway construction raises.

# The port's own copy of aiko_services_tpu/serve/disagg.py (host only,
# jax-free there too): the same grammar and policy.
#

from __future__ import annotations

from ..analyze.grammar import DirectiveGrammar, Field, GrammarError

__all__ = ["DISAGG_GRAMMAR", "DisaggPolicy", "DISAGG_ROLES"]

DISAGG_ROLES = ("prefill", "decode")
DEFAULT_ADOPT_TIMEOUT_S = 5.0


def _parse_pool_floor(tail, value):
    """`min_replicas:pool=n` -> (pool, floor)."""
    pool = str(tail).strip()
    if pool not in DISAGG_ROLES:
        raise GrammarError(
            f"disagg policy: min_replicas pool must be one of "
            f"{DISAGG_ROLES}, got {pool!r}", kind="unknown")
    floor = int(value)
    if floor < 0:
        raise GrammarError(
            f"disagg policy: min_replicas:{pool}={floor} is below the "
            f"minimum 0")
    return pool, floor


DISAGG_GRAMMAR = DirectiveGrammar(
    "disagg policy",
    options={
        "role": Field("str", choices=DISAGG_ROLES),
        "adopt_timeout": Field("float", minimum=0.0),
    },
    prefixes={"min_replicas": _parse_pool_floor})


class DisaggPolicy:
    """Parsed disagg spec.  `role` stays None on a gateway policy (the
    gateway fronts both pools); a replica-side spec carries exactly the
    role and nothing else."""

    __slots__ = ("role", "adopt_timeout_s", "min_replicas", "spec")

    def __init__(self):
        self.role: str | None = None
        self.adopt_timeout_s = DEFAULT_ADOPT_TIMEOUT_S
        self.min_replicas: dict[str, int] = {}
        self.spec = ""

    @classmethod
    def parse(cls, spec) -> "DisaggPolicy":
        """Parse a spec (directive string, dict of the same keys, or
        None/"" for all defaults)."""
        policy = cls()
        if spec is None or spec == "":
            return policy
        if isinstance(spec, DisaggPolicy):
            return spec
        parsed = DISAGG_GRAMMAR.parse(spec)
        if not isinstance(spec, dict):
            policy.spec = str(spec)
        if "role" in parsed.options:
            policy.role = parsed.options["role"]
        if "adopt_timeout" in parsed.options:
            policy.adopt_timeout_s = parsed.options["adopt_timeout"]
        for _, _, (pool, floor) in parsed.prefixed:
            policy.min_replicas[pool] = floor
        if policy.role is not None and (policy.min_replicas
                                        or "adopt_timeout"
                                        in parsed.options):
            raise GrammarError(
                "disagg policy: role= is a replica-side directive; a "
                "gateway spec carries adopt_timeout/min_replicas only")
        return policy

    def floor(self, pool: str, default: int = 0) -> int:
        return self.min_replicas.get(pool, default)

    def __repr__(self):
        return (f"DisaggPolicy(role={self.role}, "
                f"adopt_timeout={self.adopt_timeout_s}, "
                f"min_replicas={dict(sorted(self.min_replicas.items()))})")
