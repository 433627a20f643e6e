# The port's elastic replica fleet (serve/autoscale.py) and its kernel
# build cache (runtime/compile_cache.py) on the CPU, mirroring
# tests/test_autoscale.py case by case: the AIKO406 policy grammar,
# hit/miss counting, the live weight hand-off, scale up under load, the
# warm start, loss-free scale down, pool observability, the
# ProcessManager env overlay and the process factory's glue.  Pipelines
# run with "device": "cpu".
#
# The build cache counts nvcc builds, and there is no nvcc here: the
# tests put a fake `nvcc` on PATH, a script that compiles an empty C
# file into its -o library with the host's C compiler, so
# ops/kernels.py builds (a miss), finds (a hit) and loads real shared
# libraries.  Every test points the builds at a temporary directory;
# none writes into the repo's build/kernels/.
#
# Parity with the JAX package: ScalePolicy.parse gives the same fields
# and diagnostic codes, analyze_definition the same AIKO406 findings,
# and the AutoScaler, fed the same utilization series on the same
# clock, makes the same spawn / drain decisions.

import importlib
import json
import os
import queue
import shutil
import stat
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aiko_services_tpu.serve import autoscale as jax_autoscale
from aiko_services_tpu.analyze import analyze_definition as jax_analyze
from aiko_services_tpu_torch import faults as faults_module
from aiko_services_tpu_torch.analyze import analyze_definition
from aiko_services_tpu_torch.ops import kernels
from aiko_services_tpu_torch.pipeline import (
    PipelineElement, StreamEvent, create_pipeline)
from aiko_services_tpu_torch.pipeline.compute_element import ComputeElement
from aiko_services_tpu_torch.runtime import (
    Process, ProcessManager, cache_stats, disable_compile_cache,
    enable_compile_cache)
from aiko_services_tpu_torch.runtime import compile_cache
from aiko_services_tpu_torch.serve import (
    Gateway, InProcessReplicaFactory, ProcessReplicaFactory, ScalePolicy)
from aiko_services_tpu_torch.serve import autoscale as torch_autoscale
from aiko_services_tpu_torch.transport import reset_brokers
from aiko_services_tpu_torch.utils import parse
from helpers import wait_for

FAKE_NVCC = """#!/bin/sh
# writes its -o library: an empty C file through the host compiler
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
exec {cc} -shared -fPIC -x c /dev/null -o "$out"
"""


@pytest.fixture(autouse=True)
def clean(tmp_path, monkeypatch):
    faults_module.reset_injector()
    reset_brokers()
    disable_compile_cache()
    # no build ever lands in the repo's build/kernels/
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "default_build")
    yield
    faults_module.reset_injector()
    reset_brokers()
    disable_compile_cache()


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A fake nvcc first on PATH (the script's path is returned)."""
    compiler = shutil.which("cc") or shutil.which("gcc")
    assert compiler, "the fake nvcc needs the host's C compiler"
    directory = tmp_path / "fake_bin"
    directory.mkdir()
    script = directory / "nvcc"
    script.write_text(FAKE_NVCC.format(cc=compiler))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{directory}{os.pathsep}"
                               f"{os.environ.get('PATH', '')}")
    return script


class Scale(PipelineElement):
    """x -> x*10 (deterministic: migration replay must be
    bit-identical)."""

    def process_frame(self, stream, x):
        return StreamEvent.OKAY, {"y": x * 10.0}


class SlowScale(Scale):
    """Fixed host cost per frame so saturation (and therefore the
    autoscaler's utilization signal) is test-controlled."""

    def process_frame(self, stream, x):
        time.sleep(float(self.get_parameter("work_ms", 5, stream))
                   / 1000.0)
        return super().process_frame(stream, x)


class Affine(ComputeElement):
    """Stateful device element: y = x * w + b.  The state tree is
    deliberately nested (dict + list) to exercise the hand-off tree
    walk."""

    def setup(self):
        return {"w": torch.full((1, 2), 2.0, dtype=torch.float32,
                                device=self.device),
                "b": [torch.zeros((1, 2), dtype=torch.float32,
                                  device=self.device)]}

    def compute(self, state, x):
        return {"y": x * state["w"] + state["b"][0]}


class SlowAffine(Affine):
    """Affine plus a fixed host cost, so gateway load builds while the
    device math stays deterministic."""

    def process_frame(self, stream, **inputs):
        time.sleep(0.02)
        return super().process_frame(stream, **inputs)


class KernelAffine(SlowAffine):
    """SlowAffine that asks for the forward kernel's library at every
    frame, where a K1 launch asks for it on the card
    (parallel/attention.py _launch): the build cache sees each
    replica's first request on its own thread."""

    def compute(self, state, x):
        kernels.load_kernel("flash_attention")
        return super().compute(state, x)


# the gates of the mid-frame destroy tests (set by each test): the
# first frame into GatedShift waits on "release", then destroys its own
# stream before the graph's second element runs; any later frame (the
# gateway's replay) waits on "replay"
MID_FRAME: dict = {}


class GatedShift(PipelineElement):
    """x -> h = x + 1, the first of two elements."""

    def process_frame(self, stream, x):
        if not MID_FRAME["entered"].is_set():
            MID_FRAME["entered"].set()
            assert MID_FRAME["release"].wait(30)
            # the stream's destroy lands between the two elements, on
            # the pipeline's own thread, as a queued destroy does
            self.pipeline.destroy_stream(stream.stream_id)
        else:
            assert MID_FRAME["replay"].wait(30)
        return StreamEvent.OKAY, {"h": x + 1.0}


class Tenfold(PipelineElement):
    def process_frame(self, stream, h):
        return StreamEvent.OKAY, {"y": h * 10.0}


def _two_element_definition(name):
    deploy = {"module": "tests.test_torch_autoscale"}
    return {
        "name": name,
        "parameters": {"device": "cpu"},
        "graph": ["(shift (tenfold))"],
        "elements": [
            {"name": "shift", "input": [{"name": "x"}],
             "output": [{"name": "h"}],
             "deploy": {"local": {**deploy, "class_name": "GatedShift"}}},
            {"name": "tenfold", "input": [{"name": "h"}],
             "output": [{"name": "y"}],
             "deploy": {"local": {**deploy, "class_name": "Tenfold"}}},
        ],
    }


def _definition(name, class_name="Scale", element="scale",
                element_parameters=None):
    return {
        "name": name,
        "parameters": {"device": "cpu"},
        "graph": [f"({element})"],
        "elements": [
            {"name": element, "input": [{"name": "x"}],
             "output": [{"name": "y"}],
             "parameters": dict(element_parameters or {}),
             "deploy": {"local": {"module": "tests.test_torch_autoscale",
                                  "class_name": class_name}}},
        ],
    }


def _frame(value):
    return {"x": np.ones((1, 2), np.float32) * value}


def _attach_pool(gateway, count, class_name="Scale",
                 element_parameters=None):
    """`count` in-process replicas attached directly (the fixed-pool
    baseline the autoscaler grows/shrinks)."""
    processes, replicas = [], []
    for index in range(count):
        process = Process(transport_kind="loopback")
        processes.append(process)
        pipeline = create_pipeline(process, _definition(
            f"replica{index}", class_name=class_name,
            element_parameters=element_parameters))
        replicas.append(pipeline)
        gateway.attach_replica(pipeline)
        process.run(in_thread=True)
    return processes, replicas


def _host(value) -> np.ndarray:
    return np.asarray(value.cpu() if isinstance(value, torch.Tensor)
                      else value)


# -- policy grammar (AIKO406) ------------------------------------------------


class TestScalePolicy:
    def test_defaults_and_parse(self):
        policy = ScalePolicy.parse(None)
        assert (policy.min_replicas, policy.max_replicas) == (1, 2)
        policy = ScalePolicy.parse(
            "min_replicas=2;max_replicas=8;high_water=0.9;"
            "low_water=0.1;cooldown=3;drain_timeout=1;interval=0.25;"
            "warm_start=false")
        assert policy.max_replicas == 8
        assert policy.high_water == pytest.approx(0.9)
        assert policy.warm_start is False
        assert ScalePolicy.parse({"max_replicas": 3}).max_replicas == 3

    def test_cross_field_constraints_rejected(self):
        with pytest.raises(ValueError, match="must not exceed"):
            ScalePolicy.parse("min_replicas=4;max_replicas=2")
        with pytest.raises(ValueError, match="below"):
            ScalePolicy.parse("low_water=0.8;high_water=0.5")

    def test_construction_error_codes_match_offline_lint(self):
        from aiko_services_tpu_torch.analyze.policies import (
            check_autoscale_policy)
        bad_value = "min_replicas=4;max_replicas=2"
        unknown = "replicas=4"
        process = Process(transport_kind="loopback")
        process.run(in_thread=True)
        with pytest.raises(ValueError, match="AIKO406"):
            Gateway(process, autoscale=bad_value)
        with pytest.raises(ValueError, match="AIKO404"):
            Gateway(process, name="gw2", autoscale=unknown)
        assert check_autoscale_policy(bad_value)[0][0] == "AIKO406"
        assert check_autoscale_policy(unknown)[0][0] == "AIKO404"
        assert check_autoscale_policy(
            "min_replicas=1;max_replicas=4") == []
        process.terminate()


SCALE_SPECS = [
    None, "", "min_replicas=2;max_replicas=8;high_water=0.9;"
    "low_water=0.1;cooldown=3;drain_timeout=1;interval=0.25;"
    "warm_start=false", {"max_replicas": 3}, "spawn_timeout=0",
    "min_replicas=4;max_replicas=2", "low_water=0.8;high_water=0.5",
    "replicas=4", "interval=0.001", "min_replicas=x", "warm_start=maybe",
    "max_replicas=0", "cooldown=-1"]


def _parsed(module, spec):
    try:
        policy = module.ScalePolicy.parse(spec)
    except ValueError as error:
        return ("error", getattr(error, "kind", ""), str(error))
    return {name: getattr(policy, name) for name in policy.__slots__}


@pytest.mark.parametrize("spec", SCALE_SPECS,
                         ids=[repr(spec) for spec in SCALE_SPECS])
def test_scale_policy_parse_matches_jax(spec):
    """The same spec gives the same fields, or the same error and
    message, in both packages; lint gives the same codes."""
    from aiko_services_tpu.analyze.policies import (
        check_autoscale_policy as jax_check)
    from aiko_services_tpu_torch.analyze.policies import (
        check_autoscale_policy)
    assert _parsed(torch_autoscale, spec) == _parsed(jax_autoscale, spec)
    if isinstance(spec, str) and spec:
        assert check_autoscale_policy(spec) == jax_check(spec)


def test_autoscale_lint_findings_match_jax():
    """analyze_definition's policy pass reports the same AIKO406 / AIKO404
    findings on a definition whose gateway parameters carry autoscale
    specs, in both packages."""
    for spec in ("min_replicas=4;max_replicas=2", "replicas=4",
                 "min_replicas=1;max_replicas=4"):
        definition = _definition("lint_probe")
        definition["parameters"]["autoscale_policy"] = spec
        ours = analyze_definition(definition, passes=("graph", "policy"))
        jax_definition = _definition("lint_probe")
        jax_definition["parameters"] = {"autoscale_policy": spec}
        jax_definition["elements"][0]["deploy"]["local"]["module"] = (
            "tests.test_autoscale")
        theirs = jax_analyze(jax_definition, passes=("graph", "policy"))
        assert ([(d.code, d.message) for d in ours.findings]
                == [(d.code, d.message) for d in theirs.findings])


# -- the controller against the JAX package's --------------------------------


def _decisions(module, policy: str, series: list) -> list:
    """The AutoScaler's decisions over a utilization series on a fake
    clock: the gateway is a stand-in whose live replicas carry the
    series' demand."""
    events, timers = [], []

    class Replica:
        def __init__(self, name):
            self.name = self.topic_path = name
            self.outstanding = 0
            self.streams = {}
            self.dead = self.draining = False
            self.pipeline = None

        def pool_role(self):
            return None

    counter = SimpleNamespace(inc=lambda *_: None, value=0)
    gateway = SimpleNamespace(
        name="gw", replicas={}, _parked=[], disagg=None,
        policy=SimpleNamespace(max_inflight=4),
        telemetry=SimpleNamespace(scale_ups=counter, scale_downs=counter,
                                  prefill_fallbacks=counter),
        process=SimpleNamespace(event=SimpleNamespace(
            add_timer_handler=lambda handler, interval:
            timers.append(handler),
            remove_timer_handler=lambda handler: None)))

    def drain_replica(topic_path, reason):
        events.append(("drain", topic_path))
        return gateway.replicas.pop(topic_path)

    gateway.drain_replica = drain_replica
    gateway.post_message = lambda *_: None

    class Factory:
        def spawn(self, name, warm_source=None, ready=None):
            events.append(("spawn", name))
            gateway.replicas[name] = Replica(name)
            scaler._close_pending(name)
            scaler._handles[name] = name

        def retire(self, handle):
            events.append(("retire", handle))

    for name in ("r0", "r1"):
        gateway.replicas[name] = Replica(name)
    clock = [100.0]
    original = module.time.monotonic
    module.time.monotonic = lambda: clock[0]
    try:
        scaler = module.AutoScaler(gateway, policy + ";spawn_timeout=0",
                                   Factory())
        scaler._handles.update({"r0": "r0", "r1": "r1"})
        for step, demand in enumerate(series):
            live = [replica for replica in gateway.replicas.values()]
            for index, replica in enumerate(live):
                replica.outstanding = demand // len(live) + (
                    1 if index < demand % len(live) else 0)
            clock[0] = 100.0 + 0.25 * step
            scaler._tick()
            events.append(("size", len(gateway.replicas)))
        scaler.stop()
    finally:
        module.time.monotonic = original
    return events


def test_autoscaler_decisions_match_jax():
    """Fed the same per-tick demand on the same clock, the port's
    AutoScaler spawns and drains exactly when the JAX package's does."""
    policy = ("min_replicas=1;max_replicas=4;high_water=0.75;"
              "low_water=0.2;cooldown=1;warm_start=false")
    series = ([7, 8, 8, 12, 16, 16, 15, 14, 9, 4, 2, 1, 0, 0, 0, 0, 0, 0,
               0, 0, 0, 0, 12, 20, 20, 3, 0, 0, 0, 0, 0, 0, 0, 0])
    ours = _decisions(torch_autoscale, policy, series)
    assert ours == _decisions(jax_autoscale, policy, series)
    assert ("spawn", "gw-r1") in ours
    assert any(event[0] == "drain" for event in ours)


# -- the kernel build cache --------------------------------------------------


class TestCompileCache:
    def test_hit_miss_counters_and_idempotence(self, tmp_path, fake_nvcc):
        """build_kernel counts one miss in a cold directory, the first
        request on a thread for the built library one hit (per thread),
        and nothing more on the same thread."""
        directory = enable_compile_cache(str(tmp_path / "cache"))
        assert directory == str(tmp_path / "cache")
        assert enable_compile_cache(directory) == directory  # idempotent
        before = cache_stats()
        snapshot = compile_cache.thread_cache_snapshot()
        path = kernels.build_kernel("flash_attention")
        assert path.parent == tmp_path / "cache" and path.exists()
        mid = cache_stats()
        assert mid["misses"] == before["misses"] + 1   # cold: nvcc ran
        assert kernels.build_kernel("flash_attention") == path
        assert cache_stats()["misses"] == mid["misses"]  # on disk now
        kernels.load_kernel("flash_attention")           # first request
        kernels.load_kernel("flash_attention")           # counts nothing
        after = cache_stats()
        assert after["hits"] == mid["hits"] + 1
        ident = threading.get_ident()
        assert compile_cache.thread_cache_delta(
            snapshot, compile_cache.thread_cache_snapshot(), [ident]) == {
            "hits": 1, "misses": 1, "captures": 0}
        # another thread: its own first request is its own hit
        seen = {}

        def other():
            start = compile_cache.thread_cache_snapshot()
            kernels.load_kernel("flash_attention")
            seen["delta"] = compile_cache.thread_cache_delta(
                start, compile_cache.thread_cache_snapshot(),
                [threading.get_ident()])

        thread = threading.Thread(target=other)
        thread.start()
        thread.join()
        assert seen["delta"] == {"hits": 1, "misses": 0, "captures": 0}
        # no partial library from mkstemp is left behind
        assert sorted(entry.suffix for entry in path.parent.iterdir()) == [
            ".so"]

    def test_disabled_without_directory(self):
        assert enable_compile_cache(None) is None
        assert cache_stats()["dir"] is None
        assert kernels.build_dir() == kernels.BUILD_DIR

    def test_each_directory_is_looked_in(self, tmp_path, fake_nvcc):
        """The loaded-library table is keyed by path: a process pointed
        at another directory builds there (a miss) instead of reusing
        the library it loaded from the first."""
        enable_compile_cache(str(tmp_path / "one"))
        first = kernels.load_kernel("flash_attention")
        before = cache_stats()["misses"]
        disable_compile_cache()
        enable_compile_cache(str(tmp_path / "two"))
        second = kernels.load_kernel("flash_attention")
        assert cache_stats()["misses"] == before + 1
        assert first is not second
        assert len(list((tmp_path / "two").glob("libflash_attention-*"
                                                ".so"))) == 1

    def test_the_process_snapshot_carries_the_kernel_launches(
            self, monkeypatch):
        """A replica in another OS process publishes its kernels'
        launch counts beside the build cache's counters, once each
        kernel has launched."""
        from aiko_services_tpu_torch.observe.telemetry import (
            PipelineTelemetry)
        for name in kernels.KERNELS:
            monkeypatch.setitem(kernels.launch_counts, name, 0)
        monkeypatch.setitem(kernels.launch_counts, "flash_attention", 3)
        counters = PipelineTelemetry.process_snapshot()["counters"]
        assert counters["kernel_launches.flash_attention"] == 3
        assert not any(key in counters for key in (
            "kernel_launches.flash_attention_dq",
            "kernel_launches.flash_attention_dkv"))

    def test_an_unwritable_directory_or_a_failed_build_raises(
            self, tmp_path, monkeypatch):
        """No silent cold start: a cache directory that cannot be made
        raises, and so does a build that fails."""
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        with pytest.raises(OSError):
            enable_compile_cache(str(blocker / "cache"))
        assert cache_stats()["dir"] is None
        failing = tmp_path / "bin"
        failing.mkdir()
        script = failing / "nvcc"
        script.write_text("#!/bin/sh\necho broken >&2\nexit 1\n")
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", f"{failing}{os.pathsep}"
                                   f"{os.environ.get('PATH', '')}")
        enable_compile_cache(str(tmp_path / "cache"))
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernels.build_kernel("flash_attention")
        assert list((tmp_path / "cache").iterdir()) == []


# -- live weight hand-off ----------------------------------------------------


class TestWeightHandoff:
    def _pipeline(self, name):
        process = Process(transport_kind="loopback")
        pipeline = create_pipeline(process, _definition(
            name, class_name="Affine", element="affine"))
        process.run(in_thread=True)
        return process, pipeline

    def _serve_one(self, pipeline, value):
        responses = queue.Queue()
        stream = pipeline.create_stream(
            f"probe{value}", queue_response=responses)
        pipeline.create_frame(stream, _frame(value))
        outputs = responses.get(timeout=30)[2]
        pipeline.destroy_stream(f"probe{value}")
        return _host(outputs["y"])

    def test_handoff_is_bit_identical_and_really_transfers(self):
        source_process, source = self._pipeline("source")
        sibling_process, sibling = self._pipeline("sibling")
        try:
            baseline = self._serve_one(source, 3.0)
            # mutate the source's params AFTER setup: a hand-off that
            # secretly re-ran setup() would reproduce the fresh init,
            # not these values
            element = source.elements["affine"]
            element.state = {"w": element.state["w"] * 3.0,
                             "b": [element.state["b"][0] * 3.0]}
            mutated = self._serve_one(source, 3.0)
            assert not np.array_equal(baseline, mutated)

            exported = source.export_weights()
            assert set(exported) == {"affine"}
            # the descriptor tree is wire-safe (the OS-process path
            # ships it through a JSON file)
            exported = json.loads(json.dumps(exported))
            from aiko_services_tpu_torch.observe.metrics import get_registry
            registry = get_registry()
            connections_before = registry.counter(
                "transfer.connections").value
            batched_before = registry.counter(
                "transfer.batched_fetches").value
            installed = sibling.import_weights(exported)
            assert installed == ["affine"]
            handed_off = self._serve_one(sibling, 3.0)
            assert np.array_equal(handed_off, mutated)  # bit-identical
            # the whole hand-off rode fetch_many: ONE connection per
            # producing peer, not one TCP handshake per leaf
            leaves = json.dumps(exported).count('"__tensorref__"')
            assert leaves >= 2
            connections = (registry.counter("transfer.connections").value
                           - connections_before)
            assert connections < leaves, (
                f"{connections} connections for {leaves} leaves: the "
                f"hand-off is not batching")
            assert (registry.counter("transfer.batched_fetches").value
                    > batched_before)
        finally:
            source_process.terminate()
            sibling_process.terminate()

    def test_missing_element_is_skipped_not_fatal(self):
        source_process, source = self._pipeline("source2")
        try:
            self._serve_one(source, 1.0)  # state exists only once served
            exported = source.export_weights()
            exported["ghost"] = exported["affine"]
            other_process, other = self._pipeline("other2")
            try:
                assert other.import_weights(exported) == ["affine"]
            finally:
                other_process.terminate()
        finally:
            source_process.terminate()


# -- scale up under load -----------------------------------------------------


class TestScaleUp:
    def test_overload_spawns_replica_and_completes_all(self):
        gateway_process = Process(transport_kind="loopback")
        gateway = Gateway(gateway_process,
                          policy="max_inflight=2;queue=128",
                          router_seed=7)
        processes, _ = _attach_pool(
            gateway, 1, class_name="SlowScale",
            element_parameters={"work_ms": 20})
        processes.append(gateway_process)
        factory = InProcessReplicaFactory(
            _definition("template", class_name="SlowScale",
                        element_parameters={"work_ms": 20}),
            warmup=_frame(0.0))
        gateway.enable_autoscale(
            "min_replicas=1;max_replicas=2;high_water=0.5;"
            "low_water=0.01;cooldown=0.2;interval=0.05;"
            "warm_start=false", factory)
        for process in processes:
            process.run(in_thread=True)
        try:
            responses = queue.Queue()
            streams_n, per_stream = 4, 8
            for index in range(streams_n):
                gateway.submit_stream(f"s{index}",
                                      queue_response=responses)
            for frame_id in range(per_stream):
                for index in range(streams_n):
                    gateway.submit_frame(f"s{index}", _frame(frame_id),
                                         frame_id=frame_id)
            # the burst saturates the single replica; the controller
            # must grow the pool without any manual attach
            wait_for(lambda: len(gateway.replicas) == 2, timeout=60)
            assert gateway.telemetry.scale_ups.value >= 1
            statuses = [responses.get(timeout=60)[3]
                        for _ in range(streams_n * per_stream)]
            assert statuses == ["ok"] * (streams_n * per_stream)
            spawn = gateway.autoscaler.spawns[0]
            assert spawn["time_to_healthy_ms"] > 0
            assert gateway.telemetry.last_time_to_healthy_ms is not None
            # new streams spread over the grown pool
            gateway.submit_stream("late", queue_response=responses)
            wait_for(lambda: "late" in gateway.streams, timeout=10)
        finally:
            # gateway first: its stop() retires every factory-owned
            # (autoscaler-spawned) replica process
            for process in reversed(processes):
                process.terminate()


# -- warm start --------------------------------------------------------------


class TestWarmStart:
    def test_warm_spawn_zero_recompiles_and_identical_outputs(
            self, tmp_path, fake_nvcc):
        """The cold replica builds the forward kernel's library into the
        build cache (a miss on its own threads); the warm one, handed
        the sibling's weights, serves with zero builds and a hit, and
        its outputs equal the mutated source's."""
        cache_dir = str(tmp_path / "compile_cache")
        gateway_process = Process(transport_kind="loopback")
        gateway = Gateway(gateway_process,
                          policy="max_inflight=2;queue=256",
                          router_seed=7)
        factory = InProcessReplicaFactory(
            lambda name: _definition(name, class_name="KernelAffine",
                                     element="affine"),
            warmup=_frame(0.0), compile_cache=cache_dir)

        # replica0 comes up COLD through the same factory: it pays the
        # build once and populates the shared cache
        cold_ready = queue.Queue()
        factory.spawn("replica0",
                      ready=lambda handle, info: cold_ready.put(
                          (handle, info)))
        handle0, info0 = cold_ready.get(timeout=120)
        assert handle0 is not None, info0
        assert info0["cache_misses"] > 0  # the cold arm really built
        assert info0["cache_captures"] == 0
        gateway.attach_replica(handle0.pipeline)

        # mutate replica0's params so only a REAL hand-off can match
        element = handle0.pipeline.elements["affine"]
        element.state = {"w": element.state["w"] * 3.0,
                         "b": [element.state["b"][0] * 3.0]}

        gateway.enable_autoscale(
            "min_replicas=1;max_replicas=2;high_water=0.5;"
            "low_water=0.01;cooldown=0.2;interval=0.05", factory)
        gateway_process.run(in_thread=True)
        try:
            responses = queue.Queue()
            streams_n, per_stream = 4, 6
            for index in range(streams_n):
                gateway.submit_stream(f"s{index}",
                                      queue_response=responses)
            for frame_id in range(per_stream):
                for index in range(streams_n):
                    gateway.submit_frame(f"s{index}", _frame(frame_id),
                                         frame_id=frame_id)
            wait_for(lambda: len(gateway.replicas) == 2, timeout=120)
            for _ in range(streams_n * per_stream):
                assert responses.get(timeout=120)[3] == "ok"
            spawn = gateway.autoscaler.spawns[0]
            assert spawn["warm"] is True
            assert spawn["imported_elements"] == ["affine"]
            # the warm-start proof: a populated build cache + sibling
            # hand-off means the new replica served its warmup frame
            # with ZERO builds of fleet-known libraries
            assert spawn["cache_misses"] == 0, spawn
            assert spawn["cache_hits"] > 0, spawn
            assert gateway.telemetry.warm_spawns.value == 1

            warm_replica = next(
                replica for replica in gateway.replicas.values()
                if replica.name != "replica0")
            assert warm_replica.warm is True
            # hand-off correctness: the warm replica's outputs are
            # bit-identical to the mutated source, frame for frame
            probe = _frame(7.0)
            source_out = self._direct(handle0.pipeline, probe)
            warm_out = self._direct(warm_replica.pipeline, probe)
            assert np.array_equal(source_out, warm_out)
        finally:
            # gateway stop retires the autoscaler-spawned replica;
            # replica0 was factory-spawned directly, so it is ours
            gateway_process.terminate()
            handle0.process.terminate()

    def test_a_failed_import_comes_up_cold(self):
        """The reference's semantics on a failed hand-off: the replica
        comes up cold (its own setup) and its spawn info says so."""
        factory = InProcessReplicaFactory(
            lambda name: _definition(name, class_name="Affine",
                                     element="affine"),
            warmup=_frame(0.0))
        stale = {"affine": {"w": {"__tensorref__": {
            "host": "127.0.0.1", "port": 1, "key": "00" * 16,
            "dtype": "float32", "shape": [1, 2]}}}}
        ready = queue.Queue()
        factory.spawn("stale", warm_source=stale,
                      ready=lambda handle, info: ready.put((handle, info)))
        handle, info = ready.get(timeout=120)
        try:
            assert handle is not None, info
            assert info["imported_elements"] == []
            out = self._direct(handle.pipeline, _frame(2.0))
            np.testing.assert_array_equal(out, np.full((1, 2), 4.0))
        finally:
            handle.process.terminate()

    @staticmethod
    def _direct(pipeline, frame_data):
        responses = queue.Queue()
        stream_id = f"direct_{pipeline.name}"
        stream = pipeline.create_stream(stream_id,
                                        queue_response=responses)
        pipeline.create_frame(stream, dict(frame_data))
        outputs = responses.get(timeout=60)[2]
        pipeline.destroy_stream(stream_id)
        return _host(outputs["y"])


# -- loss-free scale-down ----------------------------------------------------


class TestScaleDown:
    def _run(self, drain_mid_stream: bool):
        """20 frames through a 2-replica pool; optionally drain the
        stream's pinned replica after frame 9."""
        gateway_process = Process(transport_kind="loopback")
        gateway = Gateway(gateway_process,
                          policy="max_inflight=4;queue=64",
                          router_seed=7)
        processes, _ = _attach_pool(gateway, 2)
        processes.append(gateway_process)
        for process in processes:
            process.run(in_thread=True)
        try:
            responses = queue.Queue()
            gateway.submit_stream("s1", {}, queue_response=responses)
            wait_for(lambda: "s1" in gateway.streams, timeout=10)
            owner = gateway.streams["s1"].replica.topic_path
            for frame_id in range(20):
                gateway.submit_frame("s1", _frame(frame_id))
                if drain_mid_stream and frame_id == 9:
                    # mailbox routing keeps the drain ordered with the
                    # in-flight submissions, like every other command
                    gateway.post_message("drain_replica", [owner])
            got = {}
            for _ in range(20):
                _, frame_id, outputs, status = responses.get(timeout=60)
                assert status == "ok"
                got[frame_id] = _host(outputs["y"]).tolist()
            summary = gateway.telemetry.summary()
            return got, summary
        finally:
            for process in processes:
                process.terminate()

    def test_drain_mid_stream_is_bit_identical_to_unscaled_run(self):
        baseline, base_summary = self._run(False)
        reset_brokers()
        drained, drain_summary = self._run(True)
        assert set(drained) == set(baseline)   # zero lost frames
        assert drained == baseline             # bit-identical replay
        assert base_summary["pool_size"] == 2
        assert drain_summary["pool_size"] == 1
        assert drain_summary["completed"] == 20
        assert drain_summary["replica_deaths"] == 0  # graceful

    @pytest.fixture
    def gates(self):
        # the elements load this file as tests.test_torch_autoscale,
        # which may be another module object than the one running
        gates = importlib.import_module(
            "tests.test_torch_autoscale").MID_FRAME
        gates.update({name: threading.Event()
                      for name in ("entered", "release", "replay")})
        yield gates
        for event in list(gates.values()):
            event.set()
        gates.clear()

    def test_a_stream_destroyed_mid_frame_tells_its_caller_of_the_drop(
            self, gates):
        """A caller holding a frame parked hears a drop_frame notice
        naming the pipeline, and never the partial swag."""
        process = Process(transport_kind="loopback")
        pipeline = create_pipeline(process,
                                   _two_element_definition("mid"))
        notices = queue.Queue()
        process.add_message_handler(
            lambda topic, payload: notices.put(str(payload)),
            "test/caller")
        process.run(in_thread=True)
        try:
            stream = pipeline.create_stream("s", topic_response="test/"
                                                                "caller")
            pipeline.post_message("create_frame", [stream, _frame(1.0)])
            assert gates["entered"].wait(30)
            gates["release"].set()
            command, [meta] = parse(notices.get(timeout=30))
            assert command == "process_frame_response"
            assert meta == {"stream_id": "s", "frame_id": "0",
                            "event": "drop_frame",
                            "topic_path": pipeline.topic_path}
            time.sleep(0.2)
            assert notices.empty()
        finally:
            process.terminate()

    def test_a_stream_destroyed_mid_frame_answers_with_the_replay(
            self, gates):
        """The drained replica destroys the stream between its two
        elements: its drop notice is ignored (the stream moved), no
        partial swag is delivered, and the replay's full answer is."""
        gateway_process = Process(transport_kind="loopback")
        gateway = Gateway(gateway_process,
                          policy="max_inflight=4;queue=16", router_seed=7)
        processes = [gateway_process]
        for index in range(2):
            process = Process(transport_kind="loopback")
            processes.append(process)
            gateway.attach_replica(create_pipeline(
                process, _two_element_definition(f"mid{index}")))
        for process in processes:
            process.run(in_thread=True)
        try:
            responses = queue.Queue()
            gateway.submit_stream("s", {}, queue_response=responses)
            gateway.submit_frame("s", _frame(1.0))
            assert gates["entered"].wait(30)
            owner = gateway.streams["s"].replica.topic_path
            gateway.post_message("drain_replica", [owner])
            wait_for(lambda: gateway.streams["s"].replica.topic_path
                     != owner, timeout=30)
            gates["release"].set()
            # the drained replica's notice reaches the gateway before
            # the replay answers
            wait_for(lambda: gateway.telemetry.duplicates.value >= 1
                     or not responses.empty(), timeout=30)
            gates["replay"].set()
            _, frame_id, outputs, status = responses.get(timeout=30)
            assert (frame_id, status) == (0, "ok")
            np.testing.assert_array_equal(_host(outputs["y"]),
                                          np.full((1, 2), 20.0))
            assert gateway.telemetry.duplicates.value == 1
            time.sleep(0.2)
            assert responses.empty()
        finally:
            for process in processes:
                process.terminate()

    def test_low_watermark_drains_pool_to_min(self):
        gateway_process = Process(transport_kind="loopback")
        gateway = Gateway(gateway_process,
                          policy="max_inflight=4;queue=16")
        processes, _ = _attach_pool(gateway, 2)
        processes.append(gateway_process)
        gateway.enable_autoscale(
            "min_replicas=1;max_replicas=2;high_water=0.9;"
            "low_water=0.5;cooldown=0.1;interval=0.05;drain_timeout=0",
            None)
        for process in processes:
            process.run(in_thread=True)
        try:
            # idle pool: utilization 0 <= low_water -> drain ONE (min
            # floor holds the last replica)
            wait_for(lambda: len(gateway.replicas) == 1, timeout=30)
            time.sleep(0.3)  # more ticks must not dip below min
            assert len(gateway.replicas) == 1
            assert gateway.telemetry.scale_downs.value == 1
            # the pool still serves
            responses = queue.Queue()
            gateway.submit_stream("s", {}, queue_response=responses)
            gateway.submit_frame("s", _frame(1.0))
            assert responses.get(timeout=30)[3] == "ok"
        finally:
            for process in processes:
                process.terminate()


# -- pool observability ------------------------------------------------------


class TestPoolObservability:
    def test_summary_pool_and_dashboard_row_and_status(self):
        from aiko_services_tpu_torch.dashboard import _gateway_plugin

        gateway_process = Process(transport_kind="loopback")
        gateway = Gateway(gateway_process,
                          policy="max_inflight=4;queue=16",
                          metrics_interval=0.2)
        processes, _ = _attach_pool(gateway, 2)
        processes.append(gateway_process)
        gateway.enable_autoscale(
            "min_replicas=2;max_replicas=2;high_water=0.9;"
            "low_water=0.01", None)
        for process in processes:
            process.run(in_thread=True)
        try:
            summary = gateway.telemetry.summary()
            assert summary["pool_size"] == 2
            assert set(summary["pool"]) == {"replica0", "replica1"}
            row = summary["pool"]["replica0"]
            assert row["state"] == "live"
            assert row["warm"] is False
            assert "inflight" in row and "queue_depth" in row

            class _Model:
                selected_share = {"replica_count": 2, "stream_count": 0,
                                  "policy": "", "metrics": summary}

            lines = _gateway_plugin(_Model())
            pool_lines = [line for line in lines if "pool:" in line]
            assert pool_lines and "scale_up" in pool_lines[0]
            assert any("replica0" in line and "cold" in line
                       for line in lines)
        finally:
            for process in processes:
                process.terminate()

    def test_system_status_pool_discovers_gateway(self, tmp_path,
                                                  capsys):
        from aiko_services_tpu_torch.cli import main as cli_main
        from aiko_services_tpu_torch.runtime import Registrar

        registrar_process = Process(transport_kind="loopback")
        Registrar(registrar_process, search_timeout=0.05)
        registrar_process.run(in_thread=True)
        gateway_process = Process(transport_kind="loopback")
        gateway = Gateway(gateway_process, metrics_interval=0.2)
        gateway_process.run(in_thread=True)
        try:
            wait_for(lambda: gateway.ec_producer is not None, timeout=10)
            with pytest.raises(SystemExit):
                cli_main([
                    "system", "status", "--pool", "--transport",
                    "loopback", "--wait", "5", "--state-file",
                    str(tmp_path / "none.json")])
            output = capsys.readouterr().out
            # success-path content ONLY: the no-discovery message also
            # contains the word "pool"
            assert gateway.topic_path in output, output
            assert "replicas:" in output, output
            assert "no gateway services" not in output
        finally:
            gateway_process.terminate()
            registrar_process.terminate()


# -- satellites: ProcessManager env overlay + process factory glue -----------


class TestProcessManagerEnv:
    def test_env_overlay_merges_and_removes(self, monkeypatch):
        monkeypatch.setenv("AIKO_ENV_KEEP", "inherited")
        monkeypatch.setenv("AIKO_ENV_DROP", "doomed")
        exits = []
        manager = ProcessManager(
            lambda process_id, code: exits.append((process_id, code)))
        probe = ("import os, sys; sys.exit(0 if "
                 "os.environ.get('AIKO_ENV_NEW') == 'set' and "
                 "os.environ.get('AIKO_ENV_KEEP') == 'inherited' and "
                 "'AIKO_ENV_DROP' not in os.environ else 3)")
        manager.spawn("probe", sys.executable, arguments=["-c", probe],
                      use_interpreter=False,
                      env={"AIKO_ENV_NEW": "set", "AIKO_ENV_DROP": None})
        wait_for(lambda: exits, timeout=30)
        assert exits[0] == ("probe", 0)
        manager.terminate()

    def test_process_factory_spawn_env_and_handoff_file(self, tmp_path):
        """ProcessReplicaFactory glue, hermetically: the process
        manager is a recorder, so the test asserts exactly what a real
        spawn would inherit -- the build-cache env overlay (and nothing
        that pins a JAX platform), the warm-weights descriptor file, and
        name-keyed retirement."""

        class _Recorder:
            def __init__(self):
                self.created, self.deleted = [], []

            def spawn(self, process_id, command, arguments=(),
                      use_interpreter=True, env=None, **streams):
                assert not use_interpreter and not streams
                self.created.append((process_id, command,
                                     list(arguments), env))

            def kill(self, process_id):
                self.deleted.append(process_id)

        recorder = _Recorder()
        factory = ProcessReplicaFactory(
            recorder, str(tmp_path / "defn.json"), transport="mqtt",
            compile_cache=str(tmp_path / "cache"))
        exports = {"affine": {"w": {"__tensorref__": {
            "host": "127.0.0.1", "port": 1, "key": "00" * 16,
            "dtype": "float32", "shape": [1, 2]}}}}
        launch = factory.spawn("gw-r1", warm_source=exports)
        launch.join(timeout=30)
        process_id, command, arguments, env = recorder.created[0]
        assert process_id == "gw-r1" and command == sys.executable
        assert arguments[:3] == ["-m", "aiko_services_tpu_torch",
                                 "pipeline"]
        assert "--name" in arguments and "gw-r1" in arguments
        assert "--transport" in arguments and "mqtt" in arguments
        assert set(env) == {"AIKO_COMPILE_CACHE", "AIKO_WARM_WEIGHTS"}
        assert env["AIKO_COMPILE_CACHE"] == str(tmp_path / "cache")
        with open(env["AIKO_WARM_WEIGHTS"]) as handoff:
            assert json.load(handoff) == exports
        os.unlink(env["AIKO_WARM_WEIGHTS"])
        factory.retire("gw-r1")
        assert recorder.deleted == ["gw-r1"]
        factory.retire("gw-r1")  # idempotent
        assert recorder.deleted == ["gw-r1"]


# -- one OS-process replica ---------------------------------------------------

FLEET_ELEMENTS = """from aiko_services_tpu_torch.elements.compute import JaxMLP
from aiko_services_tpu_torch.ops import kernels


class KernelMLP(JaxMLP):
    # asks for the forward kernel's library where a K1 launch would
    def compute(self, state, tensor):
        kernels.load_kernel("flash_attention")
        return super().compute(state, tensor)
"""


class TestProcessReplica:
    def test_os_process_replica_attaches_warm_serves_and_retires(
            self, tmp_path, fake_nvcc, monkeypatch):
        """ProcessReplicaFactory over the port's ProcessManager: the
        child (`python -m aiko_services_tpu_torch pipeline`, no lifecycle
        handshake) imports a live sibling's mutated weights, points its
        kernel builds at the shared cache (one hit, no miss, read from
        the process snapshot it publishes), attaches through registrar
        discovery over a real MQTT broker, serves a frame equal to the
        sibling's, and is retired; no library file is added to the
        cache."""
        from aiko_services_tpu_torch.runtime import Recorder, Registrar
        from aiko_services_tpu_torch.transport.minimqtt import (
            MiniMqttBroker)

        broker = MiniMqttBroker()
        monkeypatch.setenv("AIKO_MQTT_HOST", "127.0.0.1")
        monkeypatch.setenv("AIKO_MQTT_PORT", str(broker.port))
        (tmp_path / "fleet_elements.py").write_text(FLEET_ELEMENTS)
        monkeypatch.syspath_prepend(str(tmp_path))
        cache = tmp_path / "cache"
        enable_compile_cache(str(cache))
        kernels.build_kernel("flash_attention")
        libraries = sorted(path.name for path in cache.iterdir())

        def definition(name):
            return {
                "name": name,
                "parameters": {"device": "cpu", "metrics_interval": 0.2},
                "graph": ["(mlp)"],
                "elements": [{
                    "name": "mlp", "input": [{"name": "tensor"}],
                    "output": [{"name": "tensor"}],
                    "parameters": {"features": 8, "hidden": 16,
                                   "seed": 5},
                    "deploy": {"local": {"module": "fleet_elements",
                                         "class_name": "KernelMLP"}}}]}

        source_process = Process(transport_kind="loopback")
        source = create_pipeline(source_process, definition("source"))
        source_process.run(in_thread=True)
        frame = {"tensor": np.linspace(-1, 1, 16, dtype=np.float32)
                 .reshape(2, 8)}
        process = Process(transport_kind="mqtt")
        registrar = Registrar(process, search_timeout=0.05)
        recorder = Recorder(process)
        gateway = Gateway(process, name="osgw",
                          policy="max_inflight=4;queue=16")
        manager = ProcessManager()
        try:
            probe = queue.Queue()
            stream = source.create_stream("probe", queue_response=probe)
            source.create_frame(stream, dict(frame))
            probe.get(timeout=60)
            element = source.elements["mlp"]
            element.state = {name: leaf * 1.5
                             for name, leaf in element.state.items()}
            source.create_frame(stream, dict(frame))
            expected = _host(probe.get(timeout=60)[2]["tensor"])
            process.run(in_thread=True)
            gateway.discover(name="osr*")
            path = tmp_path / "definition.json"
            path.write_text(json.dumps(definition("template")))
            factory = ProcessReplicaFactory(
                manager, str(path), transport="mqtt",
                env={"PYTHONPATH": os.pathsep.join(
                    [str(tmp_path), os.getcwd()])},
                compile_cache=str(cache), log_dir=str(tmp_path / "logs"))
            started = time.perf_counter()
            factory.spawn("osr1", warm_source=source).join(timeout=60)
            replica = wait_for(lambda: next(
                (replica for replica in gateway.replicas.values()
                 if replica.name == "osr1"), None), timeout=90)
            # placeable once its load mirror has synced
            wait_for(lambda: replica.fresh(
                time.monotonic(), gateway.policy.stale_after_s),
                timeout=30)
            attached = time.perf_counter() - started
            responses = queue.Queue()
            gateway.submit_stream("s", queue_response=responses)
            gateway.submit_frame("s", dict(frame))
            _, _, outputs, status = responses.get(timeout=60)
            assert status == "ok", outputs
            np.testing.assert_array_equal(_host(outputs["tensor"]),
                                          expected)

            def child_counters():
                for name in recorder.metrics_sources():
                    counters = (recorder.metrics_for(name) or {}).get(
                        "counters", {})
                    if (name.endswith("/process")
                            and f"/{os.getpid()}/" not in name
                            and "compile_cache.hits" in counters):
                        return counters
                return None

            counters = wait_for(child_counters, timeout=30)
            assert counters["compile_cache.hits"] >= 1
            assert counters.get("compile_cache.misses", 0) == 0
            assert attached > 0
            factory.retire("osr1")
            wait_for(lambda: "osr1" not in manager, timeout=30)
            wait_for(lambda: not gateway.replicas, timeout=60)
            assert sorted(path.name for path in cache.iterdir()) \
                == libraries
        finally:
            manager.terminate()
            process.terminate()
            source_process.terminate()
            broker.stop()
