# Admission policy for the serving gateway: WHO gets in, HOW MUCH each
# replica carries, and WHEN the tier sheds instead of queueing.
#
# Grammar (gateway parameter `policy`, same directive style as the
# fault-harness spec so operators learn one shape):
#
#   policy    := directive (";" directive)*
#   directive := "max_inflight=" int     frames in flight per replica
#              | "queue=" int            bounded parked-frame queue length
#              | "hysteresis=" float     seconds a saturated replica must
#                                        stay below half cap to rejoin
#                                        stream placement
#              | "stale_after=" float    seconds without an EC share
#                                        update before a discovered
#                                        replica's load view is distrusted
#              | "throttle_high=" float  queue fraction that triggers
#                                        `(throttle ...)` to sources
#              | "throttle_low=" float   queue fraction that lifts it
#              | "throttle_rate=" float  frames/sec cap sent to throttled
#                                        sources
#              | "frame_deadline=" float seconds, injected into replica
#                                        streams (the deadline machinery: a
#                                        wedged replica releases frames
#                                        by dead-letter instead of
#                                        leaking gateway slots)
#              | "bucket:" prio "=" rate "/" burst
#                                        per-priority token bucket for
#                                        STREAM admission (priority 0 is
#                                        most important; priorities
#                                        without a bucket admit freely)
#              | "bucket:tenant:" name "=" rate "/" burst
#                                        per-TENANT token bucket --
#                                        streams declaring parameter
#                                        `tenant=<name>` draw from
#                                        their tenant's bucket IN
#                                        ADDITION to their priority
#                                        bucket, so one tenant's storm
#                                        exhausts its own tokens, never
#                                        another tenant's admission
#
# Example: "max_inflight=8;queue=64;hysteresis=0.5;bucket:2=10/4"
#          "bucket:tenant:gold=100/20;bucket:tenant:free=10/4"
#
# Validation is at parse time, like the pipeline-definition and fault
# grammars: a typo'd policy must fail the gateway's construction, not
# silently admit everything.

# The port's own copy of aiko_services_tpu/serve/policy.py (host only,
# jax-free there too): the same grammar and classes, line for line.
#

from __future__ import annotations

from ..analyze.grammar import DirectiveGrammar, Field

__all__ = ["AdmissionPolicy", "POLICY_GRAMMAR", "TokenBucket"]

DEFAULT_MAX_INFLIGHT = 8
DEFAULT_QUEUE_CAPACITY = 64
DEFAULT_HYSTERESIS_S = 0.5
DEFAULT_STALE_AFTER_S = 15.0
DEFAULT_THROTTLE_HIGH = 0.5
DEFAULT_THROTTLE_LOW = 0.125
DEFAULT_THROTTLE_RATE = 5.0


def _parse_bucket(tail, value):
    """`bucket:P=rate/burst` -> (priority, rate, burst);
    `bucket:tenant:NAME=rate/burst` -> (("tenant", name), rate, burst).
    Dict-shaped specs may carry (rate, burst) tuples."""
    tail = str(tail)
    if tail.startswith("tenant:"):
        tenant = tail[len("tenant:"):].strip()
        if not tenant:
            raise ValueError(
                "bucket:tenant:<name>= needs a non-empty tenant name")
        key = ("tenant", tenant)
    else:
        key = int(tail)
    if isinstance(value, (tuple, list)):
        rate, burst = value
    else:
        rate, _, burst = str(value).partition("/")
    return key, float(rate), float(burst or rate)


# The grammar above as a declarative table over the shared
# directive-grammar core (analyze/grammar.py): Gateway construction and
# `aiko lint` (AIKO403) validate through the SAME definition.  Range
# handling keeps the historical clamping semantics (max_inflight
# clamps up to 1, queue down to 0) -- the grammar rejects unknown
# directives and untypeable values, the policy clamps domains.
POLICY_GRAMMAR = DirectiveGrammar(
    "gateway policy",
    options={
        "max_inflight": Field("int"),
        "queue": Field("int"),
        "hysteresis": Field("float"),
        "stale_after": Field("float"),
        "throttle_high": Field("float"),
        "throttle_low": Field("float"),
        "throttle_rate": Field("float"),
        "frame_deadline": Field("float"),
    },
    prefixes={"bucket": _parse_bucket})


class TokenBucket:
    """Classic token bucket with caller-supplied time: `now` is always
    passed in (monotonic seconds) so tests drive it deterministically
    and the gateway pays no clock read when no bucket is configured."""

    __slots__ = ("rate", "burst", "tokens", "updated")

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(
                f"token bucket needs rate > 0 and burst > 0, got "
                f"{rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.updated: float | None = None

    def try_take(self, now: float) -> bool:
        if self.updated is not None:
            self.tokens = min(
                self.burst, self.tokens + (now - self.updated) * self.rate)
        self.updated = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionPolicy:
    __slots__ = ("max_inflight", "queue_capacity", "hysteresis_s",
                 "stale_after_s", "throttle_high", "throttle_low",
                 "throttle_rate", "frame_deadline_s", "buckets",
                 "tenant_buckets", "spec")

    def __init__(self):
        self.max_inflight = DEFAULT_MAX_INFLIGHT
        self.queue_capacity = DEFAULT_QUEUE_CAPACITY
        self.hysteresis_s = DEFAULT_HYSTERESIS_S
        self.stale_after_s = DEFAULT_STALE_AFTER_S
        self.throttle_high = DEFAULT_THROTTLE_HIGH
        self.throttle_low = DEFAULT_THROTTLE_LOW
        self.throttle_rate = DEFAULT_THROTTLE_RATE
        self.frame_deadline_s = 0.0
        self.buckets: dict[int, TokenBucket] = {}
        self.tenant_buckets: dict[str, TokenBucket] = {}
        self.spec = ""

    @classmethod
    def parse(cls, spec) -> "AdmissionPolicy":
        """Parse a policy spec (str in the grammar above, a dict of the
        same keys, or None for all defaults)."""
        policy = cls()
        if spec is None or spec == "":
            return policy
        if isinstance(spec, AdmissionPolicy):
            return spec
        parsed = POLICY_GRAMMAR.parse(spec)
        if not isinstance(spec, dict):
            policy.spec = str(spec)
        clamps = {
            "max_inflight": lambda v: max(1, v),
            "queue": lambda v: max(0, v),
            "hysteresis": lambda v: max(0.0, v),
            "stale_after": lambda v: max(0.0, v),
            "frame_deadline": lambda v: max(0.0, v),
        }
        attributes = {
            "max_inflight": "max_inflight",
            "queue": "queue_capacity",
            "hysteresis": "hysteresis_s",
            "stale_after": "stale_after_s",
            "throttle_high": "throttle_high",
            "throttle_low": "throttle_low",
            "throttle_rate": "throttle_rate",
            "frame_deadline": "frame_deadline_s",
        }
        for key, value in parsed.options.items():
            clamp = clamps.get(key)
            setattr(policy, attributes[key],
                    clamp(value) if clamp else value)
        for _, _, (key, rate, burst) in parsed.prefixed:
            if isinstance(key, tuple):
                policy.tenant_buckets[key[1]] = TokenBucket(rate, burst)
            else:
                policy.buckets[key] = TokenBucket(rate, burst)
        if policy.throttle_low > policy.throttle_high:
            raise ValueError(
                f"throttle_low {policy.throttle_low} must not exceed "
                f"throttle_high {policy.throttle_high}")
        return policy

    def bucket_for(self, priority: int) -> TokenBucket | None:
        return self.buckets.get(int(priority))

    def tenant_bucket_for(self, tenant) -> TokenBucket | None:
        """The per-tenant admission bucket, or None when the tenant is
        unnamed or unbucketed (unbucketed tenants admit freely -- the
        grammar only constrains tenants it names)."""
        if not tenant:
            return None
        return self.tenant_buckets.get(str(tenant))

    def __repr__(self):
        return (f"AdmissionPolicy(max_inflight={self.max_inflight}, "
                f"queue={self.queue_capacity}, "
                f"hysteresis={self.hysteresis_s}, "
                f"buckets={sorted(self.buckets)}, "
                f"tenants={sorted(self.tenant_buckets)})")
