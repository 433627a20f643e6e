# Metrics registry: counters, gauges, and log-bucketed histograms with
# MERGEABLE snapshots, serialized over the existing S-expression / EC
# machinery.
#
# No reference counterpart -- the reference's only observability is the
# log-topic Recorder (reference: src/aiko_services/main/recorder.py:50-96)
# and ad-hoc per-frame timing floats.  Here every hot-path instrument is a
# first-class metric a Recorder, dashboard, or bench harness can consume
# live, and snapshots from MANY processes merge associatively into one
# fleet view (Prometheus-style, but carried by the framework's own
# control plane instead of an HTTP scrape).
#
# Cost contract (the pipeline instruments its per-frame hot path with
# these): Counter.inc is one int add, Gauge.set one assignment, and
# Histogram.record one bisect into a precomputed geometric ladder --
# nothing allocates, nothing locks (GIL-racy increments can at worst
# drop a count; instruments are diagnostics, not ledgers).
#
# Wire format: `generate("metrics", [source, snapshot])` -- the snapshot
# is a nested keyword dict, so it rides any transport the control plane
# rides and shows up readable in `mosquitto_sub`.  The S-expression
# parser returns numbers as strings; `snapshot_from_wire` restores the
# numeric types, making to-wire/from-wire a lossless round trip for the
# supported value domain.

from __future__ import annotations

from bisect import bisect_left
from collections import deque

from ..utils import generate, parse_number

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SlidingWindow", "get_registry", "merge_snapshots",
    "parse_metrics_payload", "snapshot_from_wire", "snapshot_quantile",
]

# Geometric bucket ladder for timing histograms: 10 us doubling up to
# ~84 s (24 bounds -> 25 buckets with the overflow).  One ladder for
# every histogram keeps merges trivially associative: identical bounds
# mean bucket-wise addition, in any grouping.
DEFAULT_BOUNDS = tuple(1e-5 * (2.0 ** i) for i in range(24))


class Counter:
    """Monotonic event count; .inc(n) is one int add."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, amount: int = 1) -> None:
        self.value += amount


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value) -> None:
        self.value = float(value)


class Histogram:
    """Log-bucketed distribution: one bisect per record, fixed storage.

    Snapshots carry (count, sum, min, max, per-bucket counts); two
    snapshots with the same bounds merge by element-wise addition, so
    merge is associative and commutative -- partial aggregations from
    different processes/windows combine in any order."""

    __slots__ = ("bounds", "buckets", "count", "total", "low", "high")

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.low = None
        self.high = None

    def record(self, value) -> None:
        value = float(value)
        self.buckets[bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.total += value
        if self.low is None or value < self.low:
            self.low = value
        if self.high is None or value > self.high:
            self.high = value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile by linear interpolation inside the
        log bucket holding the rank -- the ONE quantile-extraction
        implementation (dashboard, gateway summary, and `aiko tune`
        all read it; each used to re-derive quantiles ad hoc).
        Empty -> 0.0; q<=0 -> observed min; q>=1 -> observed max;
        interior bucket edges are clamped to the observed min/max so a
        single-bucket histogram interpolates within real data, not the
        full geometric bucket span."""
        return snapshot_quantile(self.snapshot(), q, self.bounds)

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.low if self.low is not None else 0.0,
                "max": self.high if self.high is not None else 0.0,
                "buckets": list(self.buckets)}


class SlidingWindow:
    """Windowed deltas of CUMULATIVE counters over N-second buckets.

    Counters only grow, so "burn over the last W seconds" needs a
    baseline: sample() records the current cumulative values into a
    coarse bucket ring (one retained sample per `bucket_s` slot), and
    delta() reads latest-minus-trailing-edge.  Both the autopilot's
    act/back-off gate and the dashboard `slo:` row consume this -- the
    cumulative-since-start ratio goes stale as a health signal on long
    runs (an hour of 100% attainment hides a minute of 0%).

    The caller supplies `now` (monotonic seconds), like TokenBucket, so
    tests drive the window deterministically.  Samples older than the
    window are pruned except the newest one at-or-before the trailing
    edge, which serves as the baseline."""

    __slots__ = ("window_s", "bucket_s", "_samples")

    def __init__(self, window_s: float = 60.0,
                 bucket_s: float | None = None):
        self.window_s = max(float(window_s), 1e-9)
        # ~12 buckets per window by default: coarse enough that a
        # per-frame sampler costs nothing, fine enough that the window
        # edge moves smoothly
        self.bucket_s = (max(float(bucket_s), 1e-9)
                         if bucket_s is not None
                         else max(self.window_s / 12.0, 1e-9))
        self._samples: deque = deque()   # (bucket, now, {name: value})

    def sample(self, now: float, values: dict) -> None:
        """Record cumulative `values` at time `now`.  Within one bucket
        slot the LATEST sample wins (the slot's closing totals)."""
        now = float(now)
        bucket = int(now // self.bucket_s)
        snapshot = {name: float(value)
                    for name, value in values.items()}
        if self._samples and self._samples[-1][0] == bucket:
            self._samples[-1] = (bucket, now, snapshot)
        else:
            self._samples.append((bucket, now, snapshot))
        edge = now - self.window_s
        while len(self._samples) >= 2 and self._samples[1][1] <= edge:
            self._samples.popleft()

    def delta(self, name: str) -> float:
        """latest - baseline for one counter; 0.0 with fewer than two
        samples (no window to difference yet) or an unseen name."""
        if len(self._samples) < 2:
            return 0.0
        latest = self._samples[-1][2].get(name, 0.0)
        baseline = self._samples[0][2].get(name, 0.0)
        return max(latest - baseline, 0.0)

    def span(self) -> float:
        """Seconds actually covered (<= window_s during warm-up)."""
        if len(self._samples) < 2:
            return 0.0
        return self._samples[-1][1] - self._samples[0][1]

    def rate(self, name: str) -> float:
        span = self.span()
        return self.delta(name) / span if span > 0 else 0.0

    def burn(self, miss_name: str, ok_name: str) -> float | None:
        """Windowed burn rate miss/(ok+miss); None when the window saw
        no traffic at all (no signal is different from zero burn)."""
        miss = self.delta(miss_name)
        ok = self.delta(ok_name)
        total = ok + miss
        if total <= 0:
            return None
        return miss / total


def snapshot_quantile(snapshot: dict, q: float,
                      bounds=None) -> float:
    """Quantile extraction from a histogram SNAPSHOT dict (the shape
    that rides the wire / the trace metadata): the same estimate as
    Histogram.quantile, usable by consumers that only hold the
    serialized form.  `bounds` defaults to DEFAULT_BOUNDS when the
    bucket count matches it; snapshots of custom-ladder histograms
    must pass their bounds explicitly."""
    count = int(snapshot.get("count", 0) or 0)
    if count <= 0:
        return 0.0
    low = float(snapshot.get("min", 0.0))
    high = float(snapshot.get("max", 0.0))
    q = float(q)
    if q <= 0.0:
        return low
    if q >= 1.0:
        return high
    buckets = snapshot.get("buckets") or []
    if bounds is None:
        if len(buckets) == len(DEFAULT_BOUNDS) + 1:
            bounds = DEFAULT_BOUNDS
        else:
            # unknown ladder: the only defensible estimate is the
            # observed range itself
            return low + (high - low) * q
    rank = q * count
    cumulative = 0
    for index, bucket_count in enumerate(buckets):
        if not bucket_count:
            continue
        if cumulative + bucket_count >= rank:
            edge_low = bounds[index - 1] if index > 0 else 0.0
            edge_high = (bounds[index] if index < len(bounds)
                         else high)
            # clamp to observed data: a single-bucket histogram must
            # not report values outside [min, max]
            edge_low = max(edge_low, low)
            edge_high = max(min(edge_high, high), edge_low)
            fraction = (rank - cumulative) / bucket_count
            return edge_low + (edge_high - edge_low) * fraction
        cumulative += bucket_count
    return high


def _merge_histogram(left: dict, right: dict) -> dict:
    left_buckets = list(left.get("buckets") or [])
    right_buckets = list(right.get("buckets") or [])
    if len(left_buckets) < len(right_buckets):
        left_buckets += [0] * (len(right_buckets) - len(left_buckets))
    for index, value in enumerate(right_buckets):
        left_buckets[index] += value
    left_count = left.get("count", 0)
    right_count = right.get("count", 0)
    # min/max of an EMPTY side must not poison the merge with its 0.0
    # placeholder -- an all-empty merge stays at the placeholder
    if not left_count:
        low, high = right.get("min", 0.0), right.get("max", 0.0)
    elif not right_count:
        low, high = left.get("min", 0.0), left.get("max", 0.0)
    else:
        low = min(left.get("min", 0.0), right.get("min", 0.0))
        high = max(left.get("max", 0.0), right.get("max", 0.0))
    return {"count": left_count + right_count,
            "sum": left.get("sum", 0.0) + right.get("sum", 0.0),
            "min": low, "max": high, "buckets": left_buckets}


def merge_snapshots(left: dict, right: dict) -> dict:
    """Associative merge of two registry snapshots: counters add,
    gauges last-write-win (right side), histograms add bucket-wise."""
    counters = dict(left.get("counters") or {})
    for name, value in (right.get("counters") or {}).items():
        counters[name] = counters.get(name, 0) + value
    gauges = dict(left.get("gauges") or {})
    gauges.update(right.get("gauges") or {})
    histograms = {name: dict(value) for name, value
                  in (left.get("histograms") or {}).items()}
    for name, value in (right.get("histograms") or {}).items():
        if name in histograms:
            histograms[name] = _merge_histogram(histograms[name], value)
        else:
            histograms[name] = dict(value)
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}


_UNSAFE_NAME_CHARS = set(' \t\r\n()"')


def _safe_name(name: str) -> str:
    """Instrument names become UNQUOTED dict keys on the S-expression
    wire; whitespace/parens in a name (e.g. an element named with a
    space) would mis-tokenize the whole snapshot on the consumer side,
    so they are normalized to '_' at registration."""
    if any(ch in _UNSAFE_NAME_CHARS for ch in name):
        return "".join("_" if ch in _UNSAFE_NAME_CHARS else ch
                       for ch in name)
    return name


class MetricsRegistry:
    """Named instruments, get-or-create; snapshot() is wire-safe."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        instrument = self._counters.get(name)
        if instrument is None:
            name = _safe_name(name)
            instrument = self._counters.get(name)
            if instrument is None:
                instrument = self._counters[name] = Counter()
        return instrument

    def gauge(self, name: str) -> Gauge:
        instrument = self._gauges.get(name)
        if instrument is None:
            name = _safe_name(name)
            instrument = self._gauges.get(name)
            if instrument is None:
                instrument = self._gauges[name] = Gauge()
        return instrument

    def has_gauge(self, name: str) -> bool:
        """Existence probe WITHOUT the get-or-create side effect of
        gauge() -- for consumers that only want to know whether a
        subsystem (e.g. the decode engine) registered itself."""
        return name in self._gauges or _safe_name(name) in self._gauges

    def histogram(self, name: str, bounds=DEFAULT_BOUNDS) -> Histogram:
        instrument = self._histograms.get(name)
        if instrument is None:
            name = _safe_name(name)
            instrument = self._histograms.get(name)
            if instrument is None:
                instrument = self._histograms[name] = Histogram(bounds)
        return instrument

    def snapshot(self) -> dict:
        # list() the items: other threads (transfer server, mqtt
        # network loop) may register a first-time instrument while the
        # export timer snapshots -- a live-dict iteration would raise
        # mid-publish and lose the whole interval
        return {
            "counters": {name: counter.value for name, counter
                         in list(self._counters.items())},
            "gauges": {name: gauge.value for name, gauge
                       in list(self._gauges.items())},
            "histograms": {name: histogram.snapshot() for name, histogram
                           in list(self._histograms.items())},
        }

    def to_payload(self, source: str) -> str:
        """One `(metrics source snapshot)` S-expression payload."""
        return generate("metrics", [source, self.snapshot()])


def snapshot_from_wire(value) -> dict:
    """Restore a parsed wire snapshot's numeric types: the S-expression
    parser returns atoms as strings and renders empty dicts as empty
    lists; this walks the structure back to the snapshot() shape."""
    if not isinstance(value, dict):
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def section(name):
        part = value.get(name)
        return part if isinstance(part, dict) else {}

    counters = {name: int(parse_number(item, 0))
                for name, item in section("counters").items()}
    gauges = {name: float(parse_number(item, 0.0))
              for name, item in section("gauges").items()}
    histograms = {}
    for name, item in section("histograms").items():
        if not isinstance(item, dict):
            continue
        buckets = item.get("buckets")
        histograms[name] = {
            "count": int(parse_number(item.get("count"), 0)),
            "sum": float(parse_number(item.get("sum"), 0.0)),
            "min": float(parse_number(item.get("min"), 0.0)),
            "max": float(parse_number(item.get("max"), 0.0)),
            "buckets": [int(parse_number(entry, 0)) for entry in buckets]
            if isinstance(buckets, list) else [],
        }
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}


def parse_metrics_payload(payload):
    """Decode one `(metrics source snapshot)` wire payload into
    (source, snapshot) -- the ONE definition of the consumer-side
    contract (Recorder and dashboard both use it).  Returns None for
    anything that is not a well-formed metrics payload."""
    from ..utils import parse
    try:
        command, parameters = parse(
            payload if isinstance(payload, (str, bytes))
            else str(payload))
    except ValueError:
        return None
    if command != "metrics" or len(parameters) < 2:
        return None
    return str(parameters[0]), snapshot_from_wire(parameters[1])


# Process-global registry: instruments that have no pipeline context
# (tensor transfer plane, MQTT client) record here; the pipeline's
# periodic export merges it into the published snapshot.
_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL
