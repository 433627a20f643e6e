# observe/: pipeline telemetry -- metrics registry, frame tracing, and
# live export over the control plane (see ISSUE 2 / README
# "Observability").  Layerless by design: metrics.py and trace.py are
# stdlib-only so any layer (transport, transfer plane, elements) can
# record without import cycles; telemetry.py is the pipeline engine's
# glue and the only module that knows what a Pipeline is.

from .metrics import (                                      # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, SlidingWindow,
    get_registry, merge_snapshots, snapshot_from_wire,
    snapshot_quantile)
from .trace import (                                        # noqa: F401
    FrameTrace, PROGRAM, TRACE_CONTEXT_KEY, Tracer, attach_trace_context,
    chrome_trace_document, clock_epoch_unix_us,
    definition_fingerprint, make_trace_context, pop_trace_context,
    record_program_spans, trace_context_of, trace_metadata,
    trace_metadata_of)
from .collector import (                                    # noqa: F401
    collect_traces, merge_trace_documents, merge_trace_files,
    publish_trace_document, trace_summary)
from .telemetry import PipelineTelemetry                    # noqa: F401
from .gateway import GatewayTelemetry                       # noqa: F401

# NOTE: `Tracer.span_global` (global-lane duration spans -- work
# belonging to no single frame, e.g. decode-state checkpoints) and the
# span taxonomy itself are documented ONCE, in observe/trace.py's
# module docstring; every producer and the tune loader follow it.
