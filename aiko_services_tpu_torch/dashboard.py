# Dashboard: live view of services, share variables, and logs.
#
# Capability parity with the reference dashboard (reference:
# src/aiko_services/main/dashboard.py:286-648: asciimatics TUI with a
# services table, live share-variable view over ECConsumer, log page,
# variable editing publishing "(update name value)" to /control, and
# service kill).  asciimatics is not available here; the TUI is stdlib
# curses, and --snapshot mode prints one plain-text table (hermetically
# testable, usable in scripts).
#
# The port's copy of aiko_services_tpu/dashboard.py (host code: the
# same plugins, snapshot lines and key bindings).

from __future__ import annotations

import time

from .runtime import ECConsumer, Process
from .runtime.service import ServiceFilter
from .runtime.share import ServicesCache
from .utils import generate, get_logger, parse

__all__ = ["DashboardModel", "run_dashboard", "render_snapshot",
           "register_plugin", "plugin_for", "format_snapshot_lines"]

_LOGGER = get_logger("dashboard")

# Per-protocol detail renderers (reference dashboard _PLUGINS,
# dashboard.py:726-730): plugin(model) -> list[str] extra detail lines
# for the selected service.
_PLUGINS: dict = {}


def register_plugin(protocol_name: str, renderer) -> None:
    _PLUGINS[protocol_name] = renderer


def plugin_for(protocol: str):
    from .runtime.service import ServiceProtocol
    name, _ = ServiceProtocol.name_version(str(protocol))
    return _PLUGINS.get(name)


def _registrar_plugin(model: "DashboardModel") -> list:
    share = model.selected_share
    return [f"registrar state: {share.get('state', '?')}   "
            f"services: {share.get('service_count', '?')}   "
            f"started: {share.get('time_started', '?')}"]


register_plugin("registrar", _registrar_plugin)


def _pipeline_plugin(model: "DashboardModel") -> list:
    """Pipeline detail lines: the telemetry summary the pipeline mirrors
    into its EC share (observe.PipelineTelemetry.summary) plus stream
    state -- the at-a-glance serving health row."""
    share = model.selected_share
    lines = [f"streams: {share.get('stream_count', '?')}   "
             f"frames: {share.get('frame_count', '?')}   "
             f"elements: {share.get('element_count', '?')}"]
    metrics = share.get("metrics")
    if isinstance(metrics, dict):
        lines.append(
            f"telemetry: frames {metrics.get('frames', 0)}  "
            f"dropped {metrics.get('dropped', 0)}  "
            f"errors {metrics.get('errors', 0)}")
        lines.append(
            f"groups: fused {metrics.get('fused_groups', 0)}  "
            f"chained {metrics.get('chained_groups', 0)}  "
            f"compiles {metrics.get('compiles_fused', 0)}  "
            f"cohort splits {metrics.get('cohort_splits', 0)}")
        decode = metrics.get("decode")
        if isinstance(decode, dict):
            # continuous-batching engine occupancy (LMGenerate
            # `continuous: true`): the per-replica serving health row.
            # No numeric format specs: EC-share values arrive over the
            # S-expression wire as STRINGS (like every other line here)
            lines.append(
                f"decode: slots {decode.get('active_slots', 0)}  "
                f"waiting {decode.get('waiting', 0)}  "
                f"free blocks {decode.get('free_blocks', 0)}  "
                f"admitted {decode.get('admitted', 0)}  "
                f"completed {decode.get('completed', 0)}  "
                f"preempted {decode.get('preempted', 0)}  "
                f"deferred {decode.get('deferred', 0)}")
    else:
        lines.append("telemetry: (no summary yet -- disabled or "
                     "first interval pending; press m for live metrics)")
    return lines


register_plugin("pipeline", _pipeline_plugin)


def _gateway_plugin(model: "DashboardModel") -> list:
    """Serving-gateway detail lines: admission/routing totals from the
    telemetry summary plus a per-gateway `pool:` row (elastic fleet:
    size, scale decisions, last time-to-healthy) and one line per
    replica (state, load, warm/cold) -- the same view `aiko system
    status` prints from the EC share."""
    share = model.selected_share
    lines = [f"replicas: {share.get('replica_count', '?')}   "
             f"streams: {share.get('stream_count', '?')}   "
             f"policy: {share.get('policy', '') or '(defaults)'}"]
    metrics = share.get("metrics")
    if not isinstance(metrics, dict):
        lines.append("telemetry: (no summary yet -- disabled or first "
                     "interval pending; press m for live metrics)")
        return lines
    admission_line = (
        f"admission: admitted {metrics.get('admitted', 0)}  "
        f"shed {metrics.get('shed_frames', 0)}  "
        f"routed {metrics.get('routed', 0)}  "
        f"completed {metrics.get('completed', 0)}  "
        f"parked {metrics.get('parked', 0)}  "
        f"failovers {metrics.get('failovers', 0)}")
    if "admit_latency_p99_ms" in metrics:
        admission_line += (
            f"  latency p50 {metrics.get('admit_latency_p50_ms')}ms "
            f"p99 {metrics.get('admit_latency_p99_ms')}ms")
    lines.append(admission_line)
    slo = metrics.get("slo")
    if isinstance(slo, dict):
        # per-priority SLO attainment/burn (streams that declared
        # slo_ms): the per-tenant accounting row
        parts = []
        for priority in sorted(
                slo, key=lambda p: (not str(p).isdigit(),
                                    int(p) if str(p).isdigit() else 0,
                                    str(p))):
            record = slo[priority]
            if not isinstance(record, dict):
                continue
            attainment = record.get("attainment")
            part = (
                f"p{priority} {attainment if attainment is not None else '?'}"
                f" ({record.get('ok', 0)}/{record.get('miss', 0)} "
                f"ok/miss)")
            if record.get("burn_window") is not None:
                # sliding-window burn (autopilot gate input): the
                # miss fraction over the LAST window only, not the
                # lifetime ratio attainment reports
                part += f" burn {record.get('burn_window')}"
            parts.append(part)
        if parts:
            lines.append("slo: " + "  ".join(parts))
    autopilot = metrics.get("autopilot")
    if isinstance(autopilot, dict):
        convergence = autopilot.get("convergence")
        autopilot_line = (
            f"autopilot: {'apply' if autopilot.get('apply') else 'dry-run'}"
            f"/{autopilot.get('scope', 'local')}  "
            f"deltas {autopilot.get('deltas_applied', 0)} applied "
            f"{autopilot.get('deltas_clamped', 0)} clamped "
            f"{autopilot.get('deltas_skipped', 0)} skipped  "
            f"backoffs {autopilot.get('backoffs', 0)}")
        if convergence is not None:
            autopilot_line += (
                f"  convergence {convergence}"
                f"{' (converged)' if autopilot.get('converged') else ''}")
        if autopilot.get("rebalances"):
            autopilot_line += (
                f"  rebalances {autopilot.get('rebalances')}")
        lines.append(autopilot_line)
    decomposition = metrics.get("stream_decomposition")
    if isinstance(decomposition, dict):
        total = decomposition.get("_total")
        if isinstance(total, dict):
            # fleet end-to-end decomposition: where admitted streams'
            # latency went (admit+route+queue+prefill+decode+emit)
            lines.append("e2e: " + "  ".join(
                f"{stage} {total.get(stage)}ms"
                for stage in ("admit", "route", "queue", "prefill",
                              "decode", "emit") if stage in total))
    pool_line = (
        f"pool: size {metrics.get('pool_size', 0)}  "
        f"pending {metrics.get('pending_spawns', 0)}  "
        f"scale_up {metrics.get('scale_ups', 0)}  "
        f"scale_down {metrics.get('scale_downs', 0)}")
    if "time_to_healthy_ms" in metrics:
        pool_line += (f"  time_to_healthy "
                      f"{metrics.get('time_to_healthy_ms')}ms")
    lines.append(pool_line)
    ha = metrics.get("ha")
    if isinstance(ha, dict):
        ha_line = (
            f"ha: role {ha.get('role', '?')}  "
            f"journal {ha.get('backend', '?')} "
            f"({ha.get('journal_entries', 0)} entries, "
            f"{ha.get('journal_appends', 0)} appends)  "
            f"takeovers {ha.get('takeovers', 0)}  "
            f"replayed {ha.get('replayed', 0)}  "
            f"stale {ha.get('dropped_stale', 0)}")
        if "takeover_ms" in ha:
            ha_line += f"  last_takeover {ha.get('takeover_ms')}ms"
        lines.append(ha_line)
    pool = metrics.get("pool")
    if isinstance(pool, dict):
        for name in sorted(pool):
            replica = pool[name]
            if not isinstance(replica, dict):
                continue
            # EC-share values may arrive as wire STRINGS ("True")
            warm = str(replica.get("warm", False)).lower() in (
                "true", "1")
            lines.append(
                f"  {name}: {replica.get('state', '?')}  "
                f"{'warm' if warm else 'cold'}  "
                f"inflight {replica.get('outstanding', 0)}/"
                f"{replica.get('inflight', 0)}  "
                f"queue {replica.get('queue_depth', 0)}  "
                f"streams {replica.get('streams', 0)}")
    return lines


register_plugin("gateway", _gateway_plugin)


def format_snapshot_lines(snapshot: dict, limit: int = 40) -> list:
    """Human-readable lines for one metrics snapshot: counters first
    (sorted), then histograms as count/mean/p50/p99/max milliseconds.
    Quantiles come from the shared snapshot_quantile helper (the one
    implementation tune and the gateway summary also read), not an
    ad-hoc re-derivation."""
    from .observe.metrics import DEFAULT_BOUNDS, snapshot_quantile
    lines = []
    for name, value in sorted((snapshot.get("counters") or {}).items()):
        lines.append(f"{name:40} {value}")
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        lines.append(f"{name:40} {value:g}")
    for name, hist in sorted((snapshot.get("histograms") or {}).items()):
        count = hist.get("count", 0)
        mean = (hist.get("sum", 0.0) / count) if count else 0.0
        high = hist.get("max", 0.0)
        # timing histograms (the "_s" naming convention) read in ms;
        # occupancy/size histograms stay in their own unit (their
        # custom bucket ladders are not in the snapshot, so quantiles
        # are only printed for the standard timing ladder)
        if ("_s:" in name or name.endswith("_s")) and (
                len(hist.get("buckets") or []) == len(DEFAULT_BOUNDS) + 1):
            p50 = snapshot_quantile(hist, 0.5)
            p99 = snapshot_quantile(hist, 0.99)
            lines.append(f"{name:40} n={count} mean={mean * 1000:.3f}ms "
                         f"p50={p50 * 1000:.3f}ms "
                         f"p99={p99 * 1000:.3f}ms "
                         f"max={high * 1000:.3f}ms")
        elif "_s:" in name or name.endswith("_s"):
            lines.append(f"{name:40} n={count} mean={mean * 1000:.3f}ms "
                         f"max={high * 1000:.3f}ms")
        else:
            lines.append(f"{name:40} n={count} mean={mean:.2f} "
                         f"max={high:g}")
    return lines[:limit]


class DashboardModel:
    """Transport-facing half, UI-agnostic: the services table, one
    selected service's mirrored share dict, and control actions."""

    def __init__(self, process: Process):
        self.process = process
        self.services_cache = ServicesCache(process)
        self.services_cache.add_handler(self._service_event, ServiceFilter())
        self.rows: dict[str, object] = {}       # topic_path -> fields
        self.selected: str | None = None
        self.selected_share: dict = {}
        self._consumer: ECConsumer | None = None
        self.log_lines: list = []
        self._log_topic = None
        self.history_lines: list = []
        self._history_topic = None
        self.metrics_lines: list = []
        self._metrics_topic = None
        self._metrics_by_source: dict = {}

    def _service_event(self, command, fields) -> None:
        # copy-on-write: the curses thread iterates self.rows concurrently
        rows = dict(self.rows)
        if command == "add":
            rows[fields.topic_path] = fields
        else:
            rows.pop(fields.topic_path, None)
        self.rows = rows
        if command != "add" and fields.topic_path == self.selected:
            self.select(None)

    # -- selection + share mirror (reference dashboard.py:344-366) ---------

    def select(self, topic_path: str | None) -> None:
        if self._consumer is not None:
            self._consumer.terminate()
            self._consumer = None
        if self._log_topic is not None:
            self.process.remove_message_handler(
                self._log_handler, self._log_topic)
            self._log_topic = None
        if self._metrics_topic is not None:
            self.process.remove_message_handler(
                self._metrics_handler, self._metrics_topic)
            self._metrics_topic = None
        self.selected = topic_path
        self.selected_share = {}
        self.log_lines = []
        self.metrics_lines = []
        self._metrics_by_source = {}
        if topic_path is not None:
            self._consumer = ECConsumer(
                self.process, self.selected_share, topic_path)
            self._log_topic = f"{topic_path}/log"  # service.topic_log
            self.process.add_message_handler(
                self._log_handler, self._log_topic)
            # live telemetry: pipelines publish "(metrics source
            # snapshot)" here on their metrics_interval
            self._metrics_topic = f"{topic_path}/metrics"
            self.process.add_message_handler(
                self._metrics_handler, self._metrics_topic)

    def _log_handler(self, topic, payload) -> None:
        self.log_lines.append(payload)
        del self.log_lines[:-200]

    def _metrics_handler(self, topic, payload) -> None:
        from .observe.metrics import parse_metrics_payload
        decoded = parse_metrics_payload(payload)
        if decoded is None:
            return
        source, snapshot = decoded
        # one topic carries several sources (the pipeline's own
        # registry + the process-global one): keep the latest per
        # source and render them as labeled sections
        self._metrics_by_source[source] = format_snapshot_lines(snapshot)
        lines = []
        for source in sorted(self._metrics_by_source):
            lines.append(f"== {source}")
            lines.extend(self._metrics_by_source[source])
        self.metrics_lines = lines

    # -- actions (reference dashboard.py:232-235, 368-377) ------------------

    def update_variable(self, name: str, value) -> None:
        if self.selected:
            self.process.publish(f"{self.selected}/control",
                                 generate("update", [name, value]))

    def kill_selected(self) -> None:
        if self.selected:
            self.process.publish(f"{self.selected}/in",
                                 generate("terminate", []))

    # -- registrar history page (reference dashboard.py:565-648) ------------

    def request_history(self, count: int = 20) -> None:
        """Ask the selected service for its event history ring (the
        registrar's `(history response_topic count)` actor command,
        runtime/registrar.py:155).  Each request gets its OWN response
        topic (a per-request sequence number): over a real broker,
        still-in-flight replies from a previous request land on the
        retired topic -- no handler -- instead of interleaving into the
        new page."""
        if not self.selected:
            return
        self.history_lines = []
        if self._history_topic is not None:
            self.process.remove_message_handler(
                self._history_handler, self._history_topic)
        self._history_seq = getattr(self, "_history_seq", 0) + 1
        self._history_topic = (
            f"{self.process.topic_path_process}/0/dashboard/history/"
            f"{self._history_seq}")
        self.process.add_message_handler(
            self._history_handler, self._history_topic)
        self.process.publish(
            f"{self.selected}/in",
            generate("history", [self._history_topic, str(count)]))

    def _history_handler(self, topic, payload) -> None:
        try:
            command, parameters = parse(str(payload))
        except ValueError:
            return
        if command == "history" and len(parameters) >= 4:
            event, timestamp, topic_path, name = parameters[:4]
            self.history_lines.append(
                f"{event:8} {str(name):18.18} {topic_path}  @{timestamp}")
        del self.history_lines[:-200]


def render_snapshot(model: DashboardModel) -> str:
    lines = [f"{'TOPIC PATH':40} {'NAME':20} {'PROTOCOL':30} TAGS"]
    for topic_path, fields in sorted(model.rows.items()):
        protocol = str(fields.protocol).rsplit("/", 1)[-1]
        lines.append(f"{topic_path:40} {str(fields.name):20} "
                     f"{protocol:30} {','.join(fields.tags or [])}")
    lines.append(f"-- {len(model.rows)} service(s)")
    if model.selected is not None:
        lines.append(f"-- log {model.selected} "
                     f"({len(model.log_lines)} record(s))")
        lines.extend(f"  {line}" for line in model.log_lines[-10:])
    return "\n".join(lines)


def run_dashboard(transport_kind: str | None = None,
                  snapshot: bool = False, wait: float = 3.0) -> None:
    process = Process(transport_kind=transport_kind)
    model = DashboardModel(process)
    process.run(in_thread=True)
    if snapshot:
        deadline = time.time() + wait
        while time.time() < deadline and not model.rows:
            time.sleep(0.1)
        print(render_snapshot(model))
        process.terminate()
        return
    _run_curses(model)
    process.terminate()


def _run_curses(model: DashboardModel) -> None:
    import curses

    curses.wrapper(lambda screen: _dashboard_ui(model, screen, curses))


def _parse_edit_value(text: str):
    """Edit input values cross as the most natural type: int/float when
    they parse, bare string otherwise (the EC wire is text anyway)."""
    for caster in (int, float):
        try:
            return caster(text)
        except ValueError:
            continue
    return text


def _page_rows(screen, reserved: int = 4, cap: int = 40) -> int:
    """Visible line budget for a full-screen page: addstr past the
    window's last row raises curses.error and would kill the UI loop,
    so clamp to the terminal height (fake screens without getmaxyx get
    the legacy cap)."""
    getmaxyx = getattr(screen, "getmaxyx", None)
    if getmaxyx is None:
        return cap
    try:
        return max(min(cap, getmaxyx()[0] - reserved), 0)
    except Exception:
        return cap


def _dashboard_ui(model: DashboardModel, screen, curses) -> None:
    """The curses loop, with screen + curses injectable so the
    fake-curses tests drive it end-to-end.  Keys (reference
    dashboard.py:232-235 edit, 565-648 history/log pages):
      q quit | up/down select | k kill | l toggle log page
      e edit -- type "name value", Enter publishes (update name value)
        to the selected service's /control, Esc cancels
      h history -- requests the selected registrar's event ring and
        shows it; any key returns to the services page
      m metrics -- live telemetry page: counters/gauges/histograms from
        the selected service's metrics topic; any key returns
    """
    curses.curs_set(0)
    screen.nodelay(True)
    index = 0
    page = "services"
    edit_buffer: str | None = None
    status = ""
    while True:
        screen.erase()
        rows = sorted(model.rows.items())
        screen.addstr(0, 0, "aiko_services_tpu_torch dashboard   "
                      "(q quit, up/down select, k kill, e edit, "
                      "h history, l log, m metrics)", curses.A_BOLD)
        if edit_buffer is not None:
            screen.addstr(1, 0, f"update> {edit_buffer}", curses.A_BOLD)
        elif status:
            screen.addstr(1, 0, status, curses.A_DIM)
        if page == "history":
            screen.addstr(2, 0, f"history: {model.selected or '-'}",
                          curses.A_BOLD)
            if not model.history_lines:
                screen.addstr(3, 0, "(waiting for history...)",
                              curses.A_DIM)
            # newest entries: the handler trims keeping the TAIL, so
            # with >40 buffered lines the head is the stale end
            # ([-0:] would be the WHOLE buffer, hence the rows guard)
            rows_budget = _page_rows(screen)
            for row, line in enumerate(
                    model.history_lines[-rows_budget:]
                    if rows_budget else []):
                screen.addstr(row + 3, 0, str(line)[:120])
        elif page == "log":
            screen.addstr(2, 0, f"log: {model.selected or '-'}",
                          curses.A_BOLD)
            rows_budget = _page_rows(screen)
            for row, line in enumerate(
                    model.log_lines[-rows_budget:]
                    if rows_budget else []):
                screen.addstr(row + 3, 0, str(line)[:120])
        elif page == "metrics":
            screen.addstr(2, 0, f"metrics: {model.selected or '-'}",
                          curses.A_BOLD)
            if not model.metrics_lines:
                screen.addstr(3, 0, "(waiting for a metrics publish -- "
                              "pipelines export every metrics_interval)",
                              curses.A_DIM)
            for row, line in enumerate(
                    model.metrics_lines[:_page_rows(screen)]):
                screen.addstr(row + 3, 0, str(line)[:120])
        else:
            for row, (topic_path, fields) in enumerate(rows[:30]):
                marker = ">" if row == index else " "
                line = (f"{marker} {topic_path:38.38} "
                        f"{str(fields.name):18.18} "
                        f"{str(fields.protocol).rsplit('/', 1)[-1]:20.20}")
                screen.addstr(row + 3, 0, line)
            if rows and index < len(rows):
                selected_topic, selected_fields = rows[index]
                if model.selected != selected_topic:
                    model.select(selected_topic)
                base = min(len(rows), 30) + 4
                screen.addstr(base, 0, "share:", curses.A_BOLD)
                offset = 0
                for offset, (key, value) in enumerate(
                        sorted(model.selected_share.items())[:15]):
                    screen.addstr(base + 1 + offset, 2,
                                  f"{key} = {value}"[:100])
                plugin = plugin_for(selected_fields.protocol)
                if plugin is not None:
                    for extra, line in enumerate(plugin(model)):
                        screen.addstr(base + offset + 2 + extra, 2,
                                      str(line)[:100], curses.A_DIM)
        screen.refresh()
        key = screen.getch()
        if key == -1:
            time.sleep(0.1)
            continue
        if edit_buffer is not None:
            # inline edit line: printable chars accumulate, Enter
            # commits, Esc cancels, backspace erases
            if key in (10, 13):
                parts = edit_buffer.strip().split(None, 1)
                if len(parts) == 2:
                    model.update_variable(
                        parts[0], _parse_edit_value(parts[1]))
                    status = f"sent (update {parts[0]} {parts[1]})"
                else:
                    status = "edit needs: name value"
                edit_buffer = None
            elif key == 27:
                edit_buffer, status = None, "edit cancelled"
            elif key in (curses.KEY_BACKSPACE, 127, 8):
                edit_buffer = edit_buffer[:-1]
            elif 32 <= key < 127:
                edit_buffer += chr(key)
            continue
        if key == ord("q"):
            return
        if page in ("history", "log", "metrics"):
            page = "services"  # any key returns
            continue
        if key == curses.KEY_DOWN:
            index = min(index + 1, max(len(rows) - 1, 0))
        elif key == curses.KEY_UP:
            index = max(index - 1, 0)
        elif key == ord("k"):
            model.kill_selected()
        elif key == ord("e") and model.selected:
            edit_buffer, status = "", ""
        elif key == ord("h") and model.selected:
            model.request_history()
            page = "history"
        elif key == ord("l") and model.selected:
            page = "log"
        elif key == ord("m") and model.selected:
            page = "metrics"
