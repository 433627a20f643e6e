# The port's online SLO autopilot (serve/autopilot.py) on the CPU,
# mirroring tests/test_autopilot.py case by case: the AIKO412 policy
# grammar and its offline-lint parity, windowed burn-rate accounting
# (SlidingWindow), bounded per-tick delta clamping, the write-ahead delta
# journal (idempotent replay, committed-prefix truncation, HA standby
# adoption without re-apply), trace-collection early return, and
# deterministic tick_now() convergence on a live in-process fleet.  The
# replica's element is the port's PE_Busy (elements/toys.py); pipelines
# run with "device": "cpu".
#
# Parity with the JAX package: AutopilotPolicy.parse gives the same
# fields and the same diagnostic codes, and analyze_definition the same
# AIKO412 findings.

import time

import numpy as np
import pytest

from aiko_services_tpu.serve import autopilot as jax_autopilot
from aiko_services_tpu.analyze import analyze_definition as jax_analyze
from aiko_services_tpu_torch import faults as faults_module
from aiko_services_tpu_torch.elements.toys import PE_Busy
from aiko_services_tpu_torch.analyze import analyze_definition
from aiko_services_tpu_torch.observe.metrics import (
    SlidingWindow, get_registry)
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.serve import Gateway
from aiko_services_tpu_torch.serve import autopilot as torch_autopilot
from aiko_services_tpu_torch.serve.autopilot import AutopilotPolicy
from aiko_services_tpu_torch.transport import reset_brokers
from helpers import wait_for
from test_torch_cli import _invoke


ELEMENTS = PE_Busy.__module__
_JOURNAL = "backend=retained;interval=0.02;search_timeout=0.5"
_POLICY = "interval=0;apply=on;max_delta_frac=0.5;margin=0.15"


@pytest.fixture(autouse=True)
def clean():
    faults_module.reset_injector()
    reset_brokers()
    yield
    faults_module.reset_injector()
    reset_brokers()


def _definition(name, micro=16):
    """One PE_Busy replica graph: fixed host cost per frame, starved
    micro_batch groups under a closed-loop window of 2 -- the
    deterministic shrink scenario the convergence tests drive."""
    return {
        "name": name,
        "parameters": {"telemetry": True, "metrics_interval": 60.0,
                       "device": "cpu"},
        "graph": ["(busy)"],
        "elements": [
            {"name": "busy",
             "input": [{"name": "number", "type": "any"}],
             "output": [{"name": "number", "type": "any"}],
             "parameters": {"micro_batch": micro,
                            "micro_batch_wait_ms": 4,
                            "work_ms": 2, "constant": 3},
             "deploy": {"local": {"module": ELEMENTS,
                                  "class_name": "PE_Busy"}}},
        ],
    }


def _fleet(autopilot=_POLICY, micro=16, journal=None, ha=None,
           attach=True):
    """One in-process replica behind one gateway on the loopback
    broker.  Returns (gateway, pipeline, processes)."""
    processes = []
    pipeline = None
    if attach:
        process = Process(transport_kind="loopback")
        processes.append(process)
        pipeline = create_pipeline(process, _definition("ap_replica",
                                                        micro=micro))
    gateway_process = Process(transport_kind="loopback")
    processes.append(gateway_process)
    gateway = Gateway(gateway_process, policy="max_inflight=64;queue=256",
                      router_seed=3, telemetry=True,
                      metrics_interval=60.0, autopilot=autopilot,
                      journal=journal, ha=ha)
    if pipeline is not None:
        gateway.attach_replica(pipeline)
    for process in processes:
        process.run(in_thread=True)
    return gateway, pipeline, processes


def _closed_loop(gateway, total=40, window=2):
    """Closed-loop session traffic (array frames so micro-batching
    coalesces): returns {frame_id: scalar output}."""
    import queue as queue_module

    responses = queue_module.Queue()
    gateway.submit_stream("s0", queue_response=responses)
    submitted, done, outputs = 0, 0, {}
    while submitted < min(window, total):
        gateway.submit_frame(
            "s0", {"number": np.full((1, 2), float(submitted),
                                     np.float32)},
            frame_id=submitted)
        submitted += 1
    while done < total:
        _, frame_id, out, status = responses.get(timeout=60)
        done += 1
        if status == "ok":
            outputs[int(frame_id)] = float(
                np.asarray(out.get("number")).ravel()[0])
        if submitted < total:
            gateway.submit_frame(
                "s0", {"number": np.full((1, 2), float(submitted),
                                         np.float32)},
                frame_id=submitted)
            submitted += 1
    return outputs


def _terminate(processes):
    for process in processes:
        process.terminate()


# -- policy grammar (AIKO412) ------------------------------------------------


class TestAutopilotPolicy:
    def test_grammar_and_defaults(self):
        policy = AutopilotPolicy.parse(
            "interval=5;apply=on;margin=0.1;max_delta_frac=0.4;"
            "burn_window=45;burn_threshold=0.05;scope=fleet;wait=1.5;"
            "slo=latency;p99_ms=80")
        assert policy.interval_s == 5.0
        assert policy.apply is True
        assert policy.margin == 0.1
        assert policy.max_delta_frac == 0.4
        assert policy.burn_window_s == 45.0
        assert policy.burn_threshold == 0.05
        assert policy.scope == "fleet"
        assert policy.wait_s == 1.5
        assert policy.objective == "latency"
        assert policy.p99_ms == 80.0
        assert policy.slo_spec() == "slo=latency;p99_ms=80"
        defaults = AutopilotPolicy.parse(None)
        assert defaults.apply is False     # observe-only by default
        assert defaults.scope == "local"
        assert defaults.burn_window_s > 0
        assert defaults.slo_spec() == "slo=throughput"

    def test_cross_field_constraints(self):
        with pytest.raises(ValueError, match="burn_window"):
            AutopilotPolicy.parse("burn_window=0")
        with pytest.raises(ValueError, match="max_delta_frac"):
            AutopilotPolicy.parse("max_delta_frac=0")
        with pytest.raises(ValueError):
            AutopilotPolicy.parse("scope=galactic")
        with pytest.raises(ValueError):
            AutopilotPolicy.parse("warp_speed=9")

    def test_offline_lint_parity(self):
        """check_autopilot_policy reports the SAME failures Gateway
        construction raises, as AIKO412 (values/cross-field) and
        AIKO404 (unknown directive)."""
        from aiko_services_tpu_torch.analyze.policies import (
            check_autopilot_policy)
        assert check_autopilot_policy(_POLICY) == []
        codes = [code for code, _ in
                 check_autopilot_policy("burn_window=0")]
        assert codes == ["AIKO412"]
        codes = [code for code, _ in
                 check_autopilot_policy("warp_speed=9")]
        assert "AIKO404" in codes
        codes = [code for code, _ in
                 check_autopilot_policy("margin=asdf")]
        assert "AIKO412" in codes

    def test_gateway_constructor_rejects_bad_spec(self):
        gateway_process = Process(transport_kind="loopback")
        with pytest.raises(ValueError, match="AIKO412"):
            Gateway(gateway_process, autopilot="burn_window=0")
        with pytest.raises(ValueError, match="AIKO404"):
            Gateway(gateway_process, autopilot="warp_speed=9")


# -- windowed burn accounting ------------------------------------------------


class TestSlidingWindow:
    def test_needs_two_samples(self):
        window = SlidingWindow(window_s=30.0)
        assert window.delta("miss") == 0.0
        assert window.span() == 0.0
        window.sample(0.0, {"miss": 10.0})
        assert window.delta("miss") == 0.0

    def test_windowed_delta_of_cumulative_counters(self):
        window = SlidingWindow(window_s=30.0, bucket_s=5.0)
        window.sample(0.0, {"ok": 0.0, "miss": 0.0})
        window.sample(10.0, {"ok": 95.0, "miss": 5.0})
        assert window.delta("miss") == 5.0
        assert window.delta("ok") == 95.0
        assert window.span() == 10.0

    def test_old_samples_pruned_past_the_window(self):
        window = SlidingWindow(window_s=30.0, bucket_s=5.0)
        window.sample(0.0, {"miss": 0.0})
        window.sample(10.0, {"miss": 100.0})
        # an hour later: the early 100-miss burst must NOT count
        window.sample(3600.0, {"miss": 100.0})
        window.sample(3610.0, {"miss": 101.0})
        assert window.delta("miss") == 1.0

    def test_same_bucket_latest_wins(self):
        window = SlidingWindow(window_s=30.0, bucket_s=5.0)
        window.sample(0.0, {"miss": 0.0})
        window.sample(10.0, {"miss": 3.0})
        window.sample(11.0, {"miss": 7.0})  # same 5 s bucket as 10.0
        assert window.delta("miss") == 7.0


# -- bounded per-tick steps --------------------------------------------------


class TestClampStep:
    def test_clamp_bounds_and_idempotence(self):
        gateway, _, processes = _fleet(
            autopilot="max_delta_frac=0.5", attach=False)
        try:
            clamp = gateway.autopilot._clamp_step
            # nothing in effect yet: the proposal is the first step
            assert clamp(None, 40) == (40, False)
            # no move needed
            assert clamp(16, 16) == (None, False)
            # a 16 -> 2 goal moves at most 16*0.5 = 8 per tick
            assert clamp(16, 2) == (8, True)
            assert clamp(8, 2) == (4, True)
            assert clamp(4, 2) == (2, False)
            # ints always step >= 1: small knobs are never frozen
            assert clamp(2, 1) == (1, False)
            # float knobs clamp by fraction of current
            value, clamped = clamp(100.0, 10.0)
            assert value == 50.0 and clamped
        finally:
            _terminate(processes)


# -- write-ahead delta journal -----------------------------------------------


def _delta_records(values, target="element:busy", knob="micro_batch"):
    return [{"target": target, "knob": knob, "value": value,
             "before": None, "goal": values[-1], "clamped": False,
             "seq": seq}
            for seq, value in enumerate(values, start=1)]


class TestDeltaJournal:
    def test_replay_returns_deltas_in_seq_order(self):
        gateway, _, processes = _fleet(journal=_JOURNAL, attach=False)
        try:
            records = _delta_records([8, 4, 2])
            gateway.journal.write_deltas(reversed(records))
            assert [r["seq"] for r in gateway.journal.replay_deltas()] \
                == [1, 2, 3]
            assert gateway.journal.delta_appends == 3
        finally:
            _terminate(processes)

    def test_adopt_applies_committed_prefix_and_sets_high_water(self):
        """A crash between the write-ahead log and the apply leaves a
        committed prefix; adoption replays exactly that prefix and the
        next live delta numbers ABOVE the adopted high water."""
        gateway, pipeline, processes = _fleet(journal=_JOURNAL)
        try:
            pilot = gateway.autopilot
            # seq 3 was never journaled (crash before the append)
            gateway.journal.write_deltas(_delta_records([8, 4]))
            assert pilot.adopt_journal() == 2
            assert pilot._applied[("element:busy", "micro_batch")] == 4
            assert pilot._seq == 2
            wait_for(lambda: pipeline.elements["busy"].get_parameter(
                "micro_batch") == 4)
            adopted = pilot.registry.counter(
                "autopilot.deltas_adopted").value
            assert adopted == 2
            # adopted, not re-applied
            assert pilot.registry.counter(
                "autopilot.deltas_applied").value == 0
        finally:
            _terminate(processes)

    def test_double_adoption_is_idempotent(self):
        """Absolute values make replay idempotent: adopting the same
        journal twice lands on the same configuration (never
        double-steps)."""
        gateway, pipeline, processes = _fleet(journal=_JOURNAL)
        try:
            pilot = gateway.autopilot
            gateway.journal.write_deltas(_delta_records([8, 4, 2]))
            pilot.adopt_journal()
            first = dict(pilot._applied)
            pilot.adopt_journal()
            assert pilot._applied == first
            assert pilot._seq == 3
            wait_for(lambda: pipeline.elements["busy"].get_parameter(
                "micro_batch") == 2)
        finally:
            _terminate(processes)


class TestHAPromoteAdoptsDeltas:
    def test_standby_promote_mid_apply_restores_exact_config(self):
        """Kill the HA primary after it journaled+applied deltas: the
        promoted standby adopts every journaled delta (counted as
        adopted, NOT applied) and lands on the primary's exact
        configuration -- no re-apply, no skip."""
        process = Process(transport_kind="loopback")
        pipeline = create_pipeline(process, _definition("ap_replica"))
        process.run(in_thread=True)

        def make_gateway():
            gateway_process = Process(transport_kind="loopback")
            gateway = Gateway(gateway_process,
                              policy="max_inflight=64;queue=256",
                              router_seed=3, telemetry=True,
                              metrics_interval=60.0, autopilot=_POLICY,
                              journal=_JOURNAL, ha="ap_ha")
            gateway.attach_replica(pipeline)
            gateway_process.run(in_thread=True)
            return gateway, gateway_process

        gateway_a, process_a = make_gateway()
        wait_for(lambda: gateway_a.role == "primary")
        gateway_b, process_b = make_gateway()
        wait_for(lambda: gateway_b.election.state == "secondary")
        try:
            pilot_a = gateway_a.autopilot
            records = _delta_records([8, 4])
            gateway_a.journal.write_deltas(records)
            for record in records:
                pilot_a._apply_delta(record)
            # the standby's retained mirror has both deltas
            wait_for(lambda: len(gateway_b.journal.replay_deltas()) == 2)
            process_a.crash()
            wait_for(lambda: gateway_b.role == "primary", timeout=15)
            pilot_b = gateway_b.autopilot
            wait_for(lambda: pilot_b.registry.counter(
                "autopilot.deltas_adopted").value == 2)
            assert pilot_b._applied == pilot_a._applied
            assert pilot_b._seq == 2
            assert pilot_b.registry.counter(
                "autopilot.deltas_applied").value == 0
            assert pipeline.elements["busy"].get_parameter(
                "micro_batch") == 4
        finally:
            _terminate([process, process_a, process_b])


# -- trace collection --------------------------------------------------------


class TestCollectTraces:
    def test_explicit_targets_return_early_and_count_responses(self):
        from aiko_services_tpu_torch.observe import collect_traces
        process = Process(transport_kind="loopback")
        pipeline = create_pipeline(process, _definition("ap_replica"))
        process.run(in_thread=True)
        collector_process = Process(transport_kind="loopback")
        collector_process.run(in_thread=True)
        try:
            registry = get_registry()
            responses_before = registry.counter(
                "collector.responses").value
            wait_for(lambda: pipeline.topic_path)
            start = time.perf_counter()
            collected = collect_traces(
                collector_process, wait=10.0,
                targets=[pipeline.topic_path])
            elapsed = time.perf_counter() - start
            assert len(collected) == 1
            # DEADLINE semantics: one healthy target answered, so the
            # collector must return in round-trip time, not wait 10 s
            assert elapsed < 5.0
            assert registry.counter("collector.responses").value \
                == responses_before + 1
        finally:
            _terminate([process, collector_process])

    def test_dead_target_counts_a_timeout(self):
        from aiko_services_tpu_torch.observe import collect_traces
        collector_process = Process(transport_kind="loopback")
        collector_process.run(in_thread=True)
        try:
            registry = get_registry()
            timeouts_before = registry.counter(
                "collector.timeouts").value
            collected = collect_traces(
                collector_process, wait=0.2,
                targets=["aiko_test/nowhere/1"])
            assert collected == {}
            assert registry.counter("collector.timeouts").value \
                == timeouts_before + 1
        finally:
            _terminate([collector_process])


# -- the live control loop ---------------------------------------------------


class TestTickConvergence:
    def test_tick_now_converges_to_the_recommender_fixed_point(self):
        """The proven scenario: micro_batch=16 under closed-loop
        window-2 traffic is queue-bound starved; each tick_now() steps
        the live knob by at most max_delta_frac until the recommender's
        pow2-occupancy fixed point (2) -- every step clamped, applied
        through set_replica_parameter, visible to the running
        scheduler, and accounted in the ledger."""
        gateway, pipeline, processes = _fleet()
        try:
            _closed_loop(gateway, total=40)
            pilot = gateway.autopilot
            for _ in range(10):
                pilot.tick_now()
                if pilot.converged and not pilot.ledger[-1]["applied"]:
                    break
            assert pilot.converged
            assert pilot.convergence <= pilot.policy.margin
            applied = [record for tick in pilot.ledger
                       for record in tick["applied"]]
            assert [r["value"] for r in applied] == [8, 4, 2]
            assert [r["seq"] for r in applied] == [1, 2, 3]
            assert all(r["target"] == "element:busy"
                       and r["knob"] == "micro_batch" for r in applied)
            # the first two steps were clamped by max_delta_frac=0.5
            assert [r["clamped"] for r in applied] == [True, True,
                                                       False]
            assert pipeline.elements["busy"].get_parameter(
                "micro_batch") == 2
            summary = pilot.summary()
            assert summary["deltas_applied"] == 3
            assert summary["deltas_clamped"] == 2
            assert summary["converged"] is True
            # the gateway telemetry summary exposes the same block
            assert gateway.telemetry.summary()["autopilot"][
                "deltas_applied"] == 3
        finally:
            _terminate(processes)

    def test_dry_run_mode_never_touches_the_fleet(self):
        """apply=off (the default) harvests, tunes, and publishes
        convergence distance -- but applies nothing and journals
        nothing."""
        gateway, pipeline, processes = _fleet(
            autopilot="interval=0;margin=0.15", journal=_JOURNAL)
        try:
            _closed_loop(gateway, total=40)
            pilot = gateway.autopilot
            pilot.tick_now()
            assert pilot.convergence > pilot.policy.margin
            assert pilot.ledger[-1]["applied"] == []
            assert pilot.ledger[-1]["skipped"] >= 1
            assert pilot.registry.counter(
                "autopilot.deltas_applied").value == 0
            assert gateway.journal.replay_deltas() == []
            assert pipeline.elements["busy"].get_parameter(
                "micro_batch") == 16
        finally:
            _terminate(processes)

    def test_interval_zero_never_arms_the_timer(self):
        gateway, _, processes = _fleet(attach=False)
        try:
            pilot = gateway.autopilot
            pilot.start()
            assert pilot._timer_installed is False
        finally:
            _terminate(processes)


# -- dashboard ---------------------------------------------------------------


class TestDashboardRow:
    def test_gateway_plugin_renders_the_autopilot_row(self):
        from aiko_services_tpu_torch.dashboard import _gateway_plugin

        class _Model:
            selected_share = {
                "replica_count": 1, "stream_count": 0, "policy": "",
                "metrics": {
                    "admitted": 10, "shed_frames": 0, "routed": 10,
                    "completed": 10, "parked": 0, "failovers": 0,
                    "autopilot": {
                        "apply": True, "scope": "local",
                        "deltas_applied": 3, "deltas_clamped": 2,
                        "deltas_skipped": 0, "backoffs": 1,
                        "convergence": 0.0, "converged": True,
                        "rebalances": 0},
                },
            }

        lines = _gateway_plugin(_Model())
        autopilot_line = next(line for line in lines
                              if line.startswith("autopilot:"))
        assert "apply/local" in autopilot_line
        assert "deltas 3 applied 2 clamped 0 skipped" in autopilot_line
        assert "convergence 0.0 (converged)" in autopilot_line
        assert "backoffs 1" in autopilot_line


# -- CLI ---------------------------------------------------------------------


class TestTuneLiveCli:
    def test_trace_and_live_are_mutually_exclusive(self, tmp_path):
        result = _invoke("tune")
        assert result.exit_code == 2
        assert "exactly one trace source" in result.output
        trace = tmp_path / "trace.json"
        trace.write_text("{}")
        result = _invoke("tune", str(trace), "--live", "discover")
        assert result.exit_code == 2
        assert "exactly one trace source" in result.output

    def test_live_rejects_what_if(self):
        result = _invoke("tune", "--live", "discover",
                         "--what-if", "busy:micro_batch=4")
        assert result.exit_code == 2


# -- parity with the JAX package ---------------------------------------------

AUTOPILOT_SPECS = [
    None, "", _POLICY, "interval=5;apply=on;margin=0.1;max_delta_frac=0.4;"
    "burn_window=45;burn_threshold=0.05;scope=fleet;wait=1.5;"
    "slo=latency;p99_ms=80", {"apply": "on", "interval": 2},
    "burn_window=0", "max_delta_frac=0", "scope=galactic", "warp_speed=9",
    "margin=asdf", "apply=maybe", "interval=-1"]


def _parsed(module, spec):
    try:
        policy = module.AutopilotPolicy.parse(spec)
    except ValueError as error:
        return ("error", getattr(error, "kind", ""), str(error))
    return {name: getattr(policy, name) for name in policy.__slots__}


@pytest.mark.parametrize("spec", AUTOPILOT_SPECS,
                         ids=[repr(spec) for spec in AUTOPILOT_SPECS])
def test_autopilot_policy_parse_matches_jax(spec):
    """The same spec gives the same fields, or the same error, in both
    packages; the offline lint gives the same codes and messages."""
    from aiko_services_tpu.analyze.policies import (
        check_autopilot_policy as jax_check)
    from aiko_services_tpu_torch.analyze.policies import (
        check_autopilot_policy)
    assert _parsed(torch_autopilot, spec) == _parsed(jax_autopilot, spec)
    if isinstance(spec, str) and spec:
        assert check_autopilot_policy(spec) == jax_check(spec)


@pytest.mark.parametrize("spec", ["burn_window=0", "warp_speed=9", _POLICY])
def test_autopilot_lint_findings_match_jax(spec):
    """analyze_definition's policy pass on a definition carrying an
    autopilot spec: the same AIKO412 / AIKO404 findings in both."""
    definition = _definition("lint_probe")
    definition["parameters"]["autopilot_policy"] = spec
    jax_definition = _definition("lint_probe")
    jax_definition["parameters"] = {"autopilot_policy": spec}
    jax_definition["elements"][0]["deploy"]["local"] = {
        "module": "aiko_services_tpu.elements", "class_name": "PE_Busy"}
    ours = analyze_definition(definition, passes=("graph", "policy"))
    theirs = jax_analyze(jax_definition, passes=("graph", "policy"))
    assert ([(d.code, d.message) for d in ours.findings]
            == [(d.code, d.message) for d in theirs.findings])
