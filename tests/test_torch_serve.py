# The port's serving gateway (aiko_services_tpu_torch/serve/) on the
# CPU: its AIKO403/404 (admission), AIKO407 (journal) and AIKO410
# (federation) grammars give the JAX package's verdicts; one seeded
# workload through both packages' gateways gives the same placements,
# sheds, throttles and outputs; and the port's own contracts, as the JAX
# package's tests pin them (tests/test_serve.py, test_chaos.py,
# test_region.py): failover through the seeded replica_kill point loses
# no frame, a hot standby adopts the journal when the primary dies, and
# a lost region's streams are adopted by the survivor.  The elastic
# fleet and the SLO autopilot have files of their own
# (tests/test_torch_autoscale.py, test_torch_autopilot.py).

import json
import queue
import threading
import time

import numpy as np
import pytest

import aiko_services_tpu.pipeline as jax_pipeline
import aiko_services_tpu.runtime as jax_runtime
import aiko_services_tpu.serve as jax_serve
import aiko_services_tpu.transport as jax_transport
import aiko_services_tpu_torch.pipeline as torch_pipeline
import aiko_services_tpu_torch.runtime as torch_runtime
import aiko_services_tpu_torch.serve as torch_serve
import aiko_services_tpu_torch.transport as torch_transport
from aiko_services_tpu import faults as jax_faults
from aiko_services_tpu.analyze import policies as jax_policies
from aiko_services_tpu_torch import faults as torch_faults
from aiko_services_tpu_torch.analyze import policies
from aiko_services_tpu_torch.pipeline.tensors import (
    decode_frame_data, encode_frame_data)
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.serve import (
    FederationPolicy, FederationRouter, Gateway, JournalPolicy,
    assign_group)
from aiko_services_tpu_torch.utils import generate, parse


@pytest.fixture(autouse=True)
def clean():
    for reset in (jax_transport.reset_brokers, torch_transport.reset_brokers,
                  jax_faults.reset_injector, torch_faults.reset_injector):
        reset()
    yield
    for reset in (jax_transport.reset_brokers, torch_transport.reset_brokers,
                  jax_faults.reset_injector, torch_faults.reset_injector):
        reset()


def wait_for(predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached in time")


class JaxScale(jax_pipeline.PipelineElement):
    def process_frame(self, stream, x):
        return jax_pipeline.StreamEvent.OKAY, {"y": x * 10.0}


class PortScale(torch_pipeline.PipelineElement):
    def process_frame(self, stream, x):
        return torch_pipeline.StreamEvent.OKAY, {"y": x * 10.0}


JAX = {"pipeline": jax_pipeline, "runtime": jax_runtime,
       "serve": jax_serve, "element": "JaxScale"}
PORT = {"pipeline": torch_pipeline, "runtime": torch_runtime,
        "serve": torch_serve, "element": "PortScale"}


def replica_definition(name, class_name):
    return {
        "name": name,
        "graph": ["(scale)"],
        "elements": [
            {"name": "scale", "input": [{"name": "x"}],
             "output": [{"name": "y"}],
             "deploy": {"local": {"module": "tests.test_torch_serve",
                                  "class_name": class_name}}},
        ],
    }


def frame(value):
    return {"x": np.ones((1, 2), np.float32) * value}


# -- grammars: the JAX package's verdicts ------------------------------------

GATEWAY_SPECS = [
    "max_inflight=4;queue=16;hysteresis=0.25;stale_after=3;"
    "throttle_high=0.75;throttle_low=0.25;throttle_rate=7;"
    "frame_deadline=2.5;bucket:1=20/5", "max_inflght=4",
    "max_inflight=many", "throttle_low=0.9;throttle_high=0.1",
    "bucket:1=0/5", "tenant:acme=5/2", "", "queue=-1"]


@pytest.mark.parametrize("spec", GATEWAY_SPECS)
def test_gateway_policy_lint_reports_what_the_jax_grammar_reports(spec):
    assert (policies.check_gateway_policy(spec)
            == jax_policies.check_gateway_policy(spec))


JOURNAL_SPECS = ["interval=0.2;backend=retained", "path=/tmp/x.db",
                 "backend=sqlite", "backnd=retained", "interval=-1",
                 "backend=disk", "replay_timeout=0.2;compact_every=4", ""]


@pytest.mark.parametrize("spec", JOURNAL_SPECS)
def test_journal_policy_lint_reports_what_the_jax_grammar_reports(spec):
    assert (policies.check_journal_policy(spec)
            == jax_policies.check_journal_policy(spec))


FEDERATION_SPECS = ["groups=g0,g1,g2,g3;group=g1",
                    "groups=us:a,us:b,eu:c;group=eu:c", "groups=us:,eu:c",
                    "groups=us:a,eu:a", "groups=us:a,eu:c;group=eu:a",
                    "groups=a,b;group=z", "grups=a", ""]


@pytest.mark.parametrize("spec", FEDERATION_SPECS)
def test_federation_lint_reports_what_the_jax_grammar_reports(spec):
    assert (policies.check_federation_policy(spec)
            == jax_policies.check_federation_policy(spec))


def test_construction_error_codes_match_the_lint():
    process = Process(transport_kind="loopback")
    for spec, code in (("max_inflght=4", "AIKO404"),
                       ("max_inflight=many", "AIKO403"),
                       ("throttle_low=0.9;throttle_high=0.1", "AIKO403")):
        assert policies.check_gateway_policy(spec)[0][0] == code
        with pytest.raises(ValueError, match=code):
            Gateway(process, name=f"gw_{code}_{spec[:12]}", policy=spec)
    with pytest.raises(ValueError, match="AIKO407"):
        Gateway(process, name="bad_journal", journal="backend=sqlite")
    with pytest.raises(ValueError, match="AIKO410"):
        Gateway(process, name="bad_group",
                federation="groups=us:a,eu:c;group=eu:a")
    with pytest.raises(ValueError, match="requires path"):
        JournalPolicy.parse("backend=sqlite")


def test_group_assignment_and_region_placement_equal_the_jax_packages():
    """Rendezvous assignment, region affinity and region-loss remapping
    are pure functions of the stream id and the group set: the port's
    equal the JAX package's for every stream."""
    spec = "groups=us:a,us:b,eu:c,eu:d"
    port, reference = (FederationPolicy.parse(spec),
                       jax_serve.FederationPolicy.parse(spec))
    groups = ("g0", "g1", "g2", "g3", "g4")
    for index in range(300):
        stream_id = f"s{index}"
        assert (assign_group(stream_id, groups)
                == jax_serve.assign_group(stream_id, groups))
        for region in (None, "us", "eu"):
            for lost in ((), ("c",), ("a", "b")):
                assert (port.owner_of(stream_id, region=region, lost=lost)
                        == reference.owner_of(stream_id, region=region,
                                              lost=lost))


# -- one seeded workload through both packages' gateways ---------------------

POLICY = ("max_inflight=5;queue=6;throttle_high=0.5;throttle_low=0.2;"
          "throttle_rate=5;bucket:1=0.001/2")
PRIORITIES = [0, 1, 0, 1, 2, 1, 0, 2, 1, 2]
FRAMES = 4


def seeded_workload(package) -> dict:
    """Ten streams of four frames into a gateway over three replicas
    that hold their frames until every admission decision is made:
    placements, the bucket's stream sheds, the full queue's frame sheds
    and the throttle signals are decided by the same sequence of events
    in both packages; then the replicas run and answer."""
    runtime, serve = package["runtime"], package["serve"]
    processes = [runtime.Process(transport_kind="loopback")
                 for _ in range(4)]
    replicas = [package["pipeline"].create_pipeline(
        processes[index], replica_definition(f"replica{index}",
                                             package["element"]))
        for index in range(3)]
    gateway = serve.Gateway(processes[3], policy=POLICY, router_seed=11)
    for replica in replicas:
        gateway.attach_replica(replica)
    processes[3].run(in_thread=True)
    replies = queue.Queue()
    throttles = []
    try:
        for index, priority in enumerate(PRIORITIES):
            stream_id = f"s{index}"
            gateway.submit_stream(
                stream_id, {"priority": priority}, queue_response=replies,
                throttle=lambda sid, rate: throttles.append((sid, rate)),
                grace_time=300)
            for frame_id in range(FRAMES):
                gateway.submit_frame(stream_id, frame(10 * index + frame_id),
                                     frame_id=frame_id)
        telemetry = gateway.telemetry
        submitted = len(PRIORITIES) * FRAMES
        wait_for(lambda: telemetry.shed_streams.value
                 + telemetry.admitted.value == len(PRIORITIES)
                 and telemetry.shed_frames.value + len(gateway._parked)
                 + sum(replica.outstanding for replica
                       in gateway.replicas.values())
                 + FRAMES * telemetry.shed_streams.value == submitted)
        placements = {stream_id: stream.replica.name
                      for stream_id, stream in gateway.streams.items()}
        decided = {"placements": placements,
                   "parked": sorted(item[2:] for item in gateway._parked),
                   "throttles": list(throttles)}
        for process in processes[:3]:
            process.run(in_thread=True)
        answered = sum(FRAMES for _ in placements) - (
            telemetry.shed_frames.value)
        items = []
        while len([item for item in items if item[3] == "ok"]) < answered:
            items.append(replies.get(timeout=60))
        while not replies.empty():
            items.append(replies.get_nowait())
        decided["replies"] = sorted(
            (stream_id, -1 if frame_id is None else frame_id, status,
             (np.asarray(outputs["y"]).tolist() if status == "ok"
              else outputs.get("reason")))
            for stream_id, frame_id, outputs, status in items)
        decided["counters"] = {name: getattr(telemetry, name).value
                               for name in ("admitted", "shed_streams",
                                            "shed_frames", "throttled")}
        return decided
    finally:
        for process in processes:
            process.terminate()


def test_a_seeded_workload_decides_and_answers_like_the_jax_gateway():
    expected = seeded_workload(JAX)
    actual = seeded_workload(PORT)
    assert actual == expected
    # the workload exercised every decision it compares
    assert expected["counters"]["shed_streams"] > 0
    assert expected["counters"]["shed_frames"] > 0
    assert expected["throttles"]
    assert len(set(expected["placements"].values())) == 3


# -- the port's own contracts ------------------------------------------------


def _pool(replicas_n, policy, faults=None, router_seed=0):
    processes = [Process(transport_kind="loopback")
                 for _ in range(replicas_n + 1)]
    replicas = [torch_pipeline.create_pipeline(
        processes[index], replica_definition(f"replica{index}",
                                             "PortScale"))
        for index in range(replicas_n)]
    gateway = Gateway(processes[-1], policy=policy, router_seed=router_seed,
                      faults=faults)
    for replica in replicas:
        gateway.attach_replica(replica)
    for process in processes:
        process.run(in_thread=True)
    return gateway, replicas, processes


def _serve_twenty(faults):
    gateway, _, processes = _pool(2, "max_inflight=4;queue=64",
                                  faults=faults, router_seed=7)
    try:
        replies = queue.Queue()
        gateway.submit_stream("s1", {}, queue_response=replies)
        for frame_id in range(20):
            gateway.submit_frame("s1", frame(frame_id))
        got = {}
        for _ in range(20):
            _, frame_id, outputs, status = replies.get(timeout=60)
            assert status == "ok"
            got[frame_id] = np.asarray(outputs["y"]).tolist()
        return got, gateway.telemetry.summary()
    finally:
        for process in processes:
            process.terminate()


def test_replica_kill_fails_over_with_zero_lost_frames():
    """The seeded replica_kill point kills the pinned replica on its 6th
    routed frame: the stream migrates, every un-acknowledged frame
    replays, all 20 arrive with the unfaulted run's outputs."""
    baseline, base_summary = _serve_twenty(None)
    torch_transport.reset_brokers()
    faulted, summary = _serve_twenty("seed=3;replica_kill:frame=5")
    assert faulted == baseline
    assert base_summary["failovers"] == 0
    assert summary["failovers"] == 1 and summary["replica_deaths"] == 1
    assert summary["completed"] == 20


class WireClient:
    """A pipeline-protocol client over the broker that outlives a
    gateway's death and resubmits un-acked frames."""

    def __init__(self):
        self.process = Process(transport_kind="loopback")
        self.topic = f"{self.process.topic_path_process}/0/client"
        self.lock = threading.Lock()
        self.responses = {}
        self.process.add_message_handler(self._on_reply, self.topic)
        self.process.run(in_thread=True)

    def _on_reply(self, topic, payload):
        command, parameters = parse(payload)
        if command != "process_frame_response" or not parameters:
            return
        reply = parameters[0]
        key = (str(reply.get("stream_id")), int(reply.get("frame_id", -1)))
        outputs = (decode_frame_data(parameters[1])
                   if len(parameters) > 1 else {})
        with self.lock:
            self.responses.setdefault(key, []).append(
                np.asarray(outputs.get("y")).tolist())

    def create(self, gateway_topic, stream_id):
        self.process.publish(f"{gateway_topic}/in", generate(
            "create_stream", [stream_id, json.dumps({}).encode("ascii"),
                              60.0, self.topic]))

    def submit(self, gateway_topic, stream_id, frame_id):
        self.process.publish(f"{gateway_topic}/in", generate(
            "process_frame", [{"stream_id": stream_id, "frame_id": frame_id},
                              encode_frame_data(frame(frame_id))
                              .encode("ascii")]))

    def acked(self, keys):
        with self.lock:
            return all(key in self.responses for key in keys)

    def outputs(self):
        with self.lock:
            assert all(len(entries) == 1
                       for entries in self.responses.values()), \
                "exactly-once violated"
            return {key: entries[0]
                    for key, entries in self.responses.items()}


def test_standby_adopts_the_journal_when_the_primary_dies(tmp_path):
    """An HA pair over a sqlite journal: the primary crashes, the standby
    wins the election, adopts every journaled stream, dedupes the
    client's replayed tail and serves the rest -- exactly once, with the
    outputs of a run without the crash."""
    streams = ["s0", "s1", "s2"]

    def run(crash):
        spec = (f"interval=0;search_timeout=0.3;"
                f"path={tmp_path / ('crash.db' if crash else 'clean.db')}")
        group = "grp-crash" if crash else "grp-clean"
        processes = [Process(transport_kind="loopback") for _ in range(2)]
        replicas = [torch_pipeline.create_pipeline(
            processes[index], replica_definition(f"replica{index}",
                                                 "PortScale"))
            for index in range(2)]
        for process in processes:
            process.run(in_thread=True)
        gateways = []
        for _ in range(2):
            process = Process(transport_kind="loopback")
            processes.append(process)
            gateways.append(Gateway(process, policy="max_inflight=8",
                                    router_seed=7, journal=spec, ha=group))
            process.run(in_thread=True)
            if len(gateways) == 1:
                wait_for(lambda: gateways[0].role == "primary")
        primary, standby = gateways
        wait_for(lambda: standby.election.state == "secondary")
        for replica in replicas:
            primary.attach_replica(replica)
            standby.attach_replica(replica)
        client = WireClient()
        try:
            for stream_id in streams:
                client.create(primary.topic_path, stream_id)
                for frame_id in range(5):
                    client.submit(primary.topic_path, stream_id, frame_id)
            wait_for(lambda: client.acked(
                [(sid, fid) for sid in streams for fid in range(5)]),
                timeout=60)
            target = primary
            if crash:
                primary.process.crash()
                wait_for(lambda: standby.telemetry.takeovers.value == 1)
                assert standby.role == "primary"
                assert (standby.telemetry.journal_replayed.value
                        == len(streams))
                target = standby
            for stream_id in streams:
                for frame_id in range(3, 10):
                    client.submit(target.topic_path, stream_id, frame_id)
            wait_for(lambda: client.acked(
                [(sid, fid) for sid in streams for fid in range(5, 10)]),
                timeout=60)
            if crash:
                assert (standby.telemetry.duplicates.value
                        == 2 * len(streams))
            return client.outputs()
        finally:
            client.process.terminate()
            for process in processes:
                process.terminate()

    baseline = run(crash=False)
    torch_transport.reset_brokers()
    recovered = run(crash=True)
    assert set(recovered) == {(sid, fid) for sid in streams
                              for fid in range(10)}
    assert recovered == baseline


class PortEcho(torch_pipeline.PipelineElement):
    def process_frame(self, stream, number):
        return torch_pipeline.StreamEvent.OKAY, {"number": int(number) + 1}


def test_a_lost_regions_streams_are_adopted_and_keep_serving():
    """Two federated groups over shared replicas: the eu group crashes,
    the us survivor adopts exactly eu's journaled streams with warm
    restore hints armed, and their next frames serve -- no stream lost."""
    from aiko_services_tpu_torch.decode import (
        CheckpointKeeper, reset_keepers)
    keeper = CheckpointKeeper("region_k")
    journal = "backend=retained;interval=0.02;replay_timeout=0.2"
    groups = "groups=us:a,eu:c"
    processes = [Process(transport_kind="loopback") for _ in range(4)]
    try:
        replicas = [torch_pipeline.create_pipeline(processes[index], {
            "name": f"region_replica{index}",
            "parameters": {"telemetry": False},
            "graph": ["(echo)"],
            "elements": [{"name": "echo", "input": [{"name": "number"}],
                          "output": [{"name": "number"}],
                          "deploy": {"local": {
                              "module": "tests.test_torch_serve",
                              "class_name": "PortEcho"}}}]})
            for index in range(2)]
        gateways = {}
        for offset, (group, region) in enumerate((("a", "us"),
                                                  ("c", "eu"))):
            gateways[group] = Gateway(
                processes[2 + offset], name=group,
                policy="max_inflight=64;queue=256",
                federation=f"{groups};group={region}:{group}",
                journal=journal,
                checkpoint=f"recovery_rate=8;keeper={keeper.name}")
            for replica in replicas:
                gateways[group].attach_replica(replica)
        for process in processes:
            process.run(in_thread=True)
        router = FederationRouter(gateways, policy=groups)
        replies = queue.Queue()
        eu_ids = ["eu0", "eu1", "eu2"]
        for stream_id in eu_ids:
            assert router.submit_stream(stream_id, region="eu",
                                        queue_response=replies,
                                        grace_time=300) == "c"
            router.submit_frame(stream_id, {"number": 1}, frame_id=0)
        for _ in eu_ids:
            reply = replies.get(timeout=30)
            assert reply[3] == "ok" and reply[2]["number"] == 2
        gateways["c"].journal_flush()
        wait_for(lambda: gateways["c"].journal.entry_count() >= 3)
        gateways["c"].process.crash()
        router.fail_group("c")
        survivor = gateways["a"]
        wait_for(lambda: survivor.telemetry.region_migrations.value >= 3)
        replays = queue.Queue()
        for stream_id in eu_ids:
            stream = survivor.streams[stream_id]
            assert stream.restore_hint == {"keeper": "region_k"}
            stream.queue_response = replays
            assert router.group_for(stream_id) == "a"
            survivor.submit_frame(stream_id, {"number": 10}, frame_id=1)
        for _ in eu_ids:
            reply = replays.get(timeout=30)
            assert reply[3] == "ok" and reply[2]["number"] == 11
        assert all(survivor.streams[stream_id].restore_hint is None
                   for stream_id in eu_ids)
    finally:
        for process in processes:
            process.terminate()
        reset_keepers()
