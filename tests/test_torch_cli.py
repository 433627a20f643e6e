# The port's CLI (cli.py, on argparse) and dashboard (dashboard.py) on
# the CPU, mirroring the dashboard and CLI cases of
# tests/test_checkpoint_dashboard.py, the `system start|stop` cases of
# tests/test_orchestration.py and the `lint --code` case of
# tests/test_concurrency_lint.py.  The CLI runs in this process through
# main(argv) (SystemExit carries the exit code) or, where a test needs
# the module's entry point, as `python -m aiko_services_tpu_torch` in a
# subprocess.

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from aiko_services_tpu_torch.runtime import Process, Registrar
from aiko_services_tpu_torch.transport import get_broker, reset_brokers
from helpers import wait_for

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def clean_brokers():
    reset_brokers()
    yield
    reset_brokers()


def _invoke(*args):
    """The port's CLI in this process: (exit code, stdout + stderr)."""
    from aiko_services_tpu_torch.cli import main
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        try:
            main(list(args))
        except SystemExit as exit:
            code = exit.code if isinstance(exit.code, int) else 1
    return SimpleNamespace(exit_code=code, output=out.getvalue())


def _module(*args, env=None, timeout=120):
    """`python -m aiko_services_tpu_torch ARGS` from the repo root."""
    return subprocess.run(
        [sys.executable, "-m", "aiko_services_tpu_torch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, **(env or {})))


class TestDashboard:
    def test_model_tracks_services_and_share(self):
        from aiko_services_tpu_torch.dashboard import (
            DashboardModel, render_snapshot)
        registrar_process = Process(transport_kind="loopback")
        Registrar(registrar_process, search_timeout=0.05)
        registrar_process.run(in_thread=True)

        worker_process = Process(transport_kind="loopback")
        from aiko_services_tpu_torch.runtime import Actor, ECProducer
        worker = Actor(worker_process, "worker")
        ECProducer(worker)
        worker_process.run(in_thread=True)

        viewer_process = Process(transport_kind="loopback")
        model = DashboardModel(viewer_process)
        viewer_process.run(in_thread=True)

        wait_for(lambda: any("worker" == str(fields.name)
                             for fields in model.rows.values()),
                 timeout=10)
        snapshot = render_snapshot(model)
        assert "worker" in snapshot and "service(s)" in snapshot

        worker_topic = next(topic for topic, fields in model.rows.items()
                            if str(fields.name) == "worker")
        model.select(worker_topic)
        worker.ec_producer.update("temperature", 42)
        # EC values cross the S-expression wire as text
        wait_for(lambda: model.selected_share.get("temperature") == "42",
                 timeout=10)

        # variable edit flows back to the worker's share
        model.update_variable("temperature", 7)
        get_broker().drain()
        wait_for(lambda: worker.share.get("temperature") == "7",
                 timeout=10)

        for process in (registrar_process, worker_process, viewer_process):
            process.terminate()


class TestCursesUI:
    def test_curses_loop_renders_selects_and_quits(self, monkeypatch):
        """Exercise the real curses draw loop (previously '# pragma: no
        cover') against a fake curses module: renders the service table,
        selects a row (EC share mirror kicks in), k publishes terminate,
        q exits."""
        import sys
        import types
        import time as time_module
        from aiko_services_tpu_torch.dashboard import DashboardModel, _run_curses
        from aiko_services_tpu_torch.runtime import Process, Registrar
        from aiko_services_tpu_torch.runtime.actor import Actor
        from aiko_services_tpu_torch.transport.loopback import get_broker

        process = Process(transport_kind="loopback")
        Registrar(process, search_timeout=0.05)
        actor = Actor(process, name="victim")
        process.run(in_thread=True)
        model = DashboardModel(process)
        deadline = time_module.monotonic() + 5
        # wait for BOTH rows (registrar + victim): starting the UI on a
        # partial table makes every later assertion timing-dependent
        while len(model.rows) < 2 and time_module.monotonic() < deadline:
            get_broker().drain()
            time_module.sleep(0.01)
        assert len(model.rows) >= 2, model.rows

        drawn = []
        messages = []
        process.add_message_handler(
            lambda topic, payload: messages.append((topic, str(payload))),
            "#")

        def terminate_seen():
            return any(topic.endswith("/in") and "terminate" in payload
                       for topic, payload in list(messages))

        class FakeScreen:
            """Event-driven key feed: navigate once, press 'k' only
            while a selection is live (a transient cache re-sync can
            clear model.selected between render and keypress -- a
            fixed key script raced that and flaked ~1/10), quit once
            the terminate hit the wire."""

            def __init__(self):
                self.deadline = time_module.monotonic() + 20
                self.navigated = False

            def erase(self):
                pass

            def nodelay(self, flag):
                pass

            def addstr(self, y, x, text, *attrs):
                drawn.append(text)

            def refresh(self):
                pass

            def getch(self):
                if (terminate_seen()
                        or time_module.monotonic() > self.deadline):
                    return ord("q")
                if not self.navigated:  # exercise the arrow keys once
                    self.navigated = True
                    return fake_curses.KEY_DOWN
                if model.selected is not None:
                    return ord("k")
                get_broker().drain()
                return -1

        fake_curses = types.ModuleType("curses")
        fake_curses.A_BOLD = 1
        fake_curses.A_DIM = 2
        fake_curses.KEY_DOWN = 258
        fake_curses.KEY_UP = 259
        fake_curses.KEY_BACKSPACE = 263
        fake_curses.curs_set = lambda n: None
        fake_curses.wrapper = lambda ui: ui(FakeScreen())
        monkeypatch.setitem(sys.modules, "curses", fake_curses)

        _run_curses(model)
        joined = " ".join(drawn)
        assert "dashboard" in joined and "victim" in joined
        get_broker().drain()
        # "k" published (terminate) to the selected service's /in
        assert terminate_seen(), messages[-5:]
        process.terminate()

    def test_curses_edit_flow_updates_live_share_variable(self):
        """VERDICT r4 item 6: the UI's edit keybinding round-trips --
        'e' opens the input line, typed "name value" + Enter publishes
        (update ...) to the selected service's /control, and the
        worker's OWN share dict changes."""
        import time as time_module
        import types
        from aiko_services_tpu_torch.dashboard import DashboardModel, _dashboard_ui
        from aiko_services_tpu_torch.runtime import Actor, ECProducer, Process, Registrar
        from aiko_services_tpu_torch.transport.loopback import get_broker

        process = Process(transport_kind="loopback")
        Registrar(process, search_timeout=0.05)
        worker = Actor(process, name="editable")
        ECProducer(worker)
        worker.ec_producer.update("rate", 1)
        process.run(in_thread=True)
        model = DashboardModel(process)
        deadline = time_module.monotonic() + 5
        while not any(str(f.name) == "editable"
                      for f in model.rows.values()):
            assert time_module.monotonic() < deadline
            get_broker().drain()
            time_module.sleep(0.01)

        # select the worker row deterministically
        rows = sorted(model.rows.items())
        worker_index = next(i for i, (_, f) in enumerate(rows)
                            if str(f.name) == "editable")

        keys = [curses_key for _ in range(worker_index)
                for curses_key in (258,)]        # KEY_DOWN to the row
        keys += [-1]                             # render pass: selects
        keys += [ord("e")]
        keys += [ord(c) for c in "rate 7"]
        keys += [10]                             # Enter commits
        keys += [ord("q")]

        class FakeScreen:
            def __init__(self, queued):
                self.queued = list(queued)

            def erase(self):
                pass

            def nodelay(self, flag):
                pass

            def addstr(self, y, x, text, *attrs):
                pass

            def refresh(self):
                pass

            def getch(self):
                return self.queued.pop(0) if self.queued else ord("q")

        fake_curses = types.SimpleNamespace(
            A_BOLD=1, A_DIM=2, KEY_DOWN=258, KEY_UP=259,
            KEY_BACKSPACE=263, curs_set=lambda n: None)
        _dashboard_ui(model, FakeScreen(keys), fake_curses)
        get_broker().drain()
        wait_for(lambda: worker.share.get("rate") == "7", timeout=10)
        process.terminate()

    def test_curses_history_page_shows_registrar_ring(self):
        """'h' on the selected registrar requests its (history ...) ring
        and the page renders add events for registered services."""
        import time as time_module
        import types
        from aiko_services_tpu_torch.dashboard import DashboardModel, _dashboard_ui
        from aiko_services_tpu_torch.runtime import Actor, Process, Registrar
        from aiko_services_tpu_torch.transport.loopback import get_broker

        process = Process(transport_kind="loopback")
        Registrar(process, search_timeout=0.05)
        Actor(process, name="historic")
        process.run(in_thread=True)
        model = DashboardModel(process)
        deadline = time_module.monotonic() + 5
        while not any("registrar" in str(f.protocol)
                      for f in model.rows.values()):
            assert time_module.monotonic() < deadline
            get_broker().drain()
            time_module.sleep(0.01)

        rows = sorted(model.rows.items())
        registrar_index = next(i for i, (_, f) in enumerate(rows)
                               if "registrar" in str(f.protocol))
        keys = [258] * registrar_index + [-1, ord("h")]

        drawn = []

        class FakeScreen:
            def __init__(self, queued):
                self.queued = list(queued)

            def erase(self):
                pass

            def nodelay(self, flag):
                pass

            def addstr(self, y, x, text, *attrs):
                drawn.append(str(text))

            def refresh(self):
                pass

            def getch(self, _deadline=[None]):
                if _deadline[0] is None:
                    _deadline[0] = time_module.monotonic() + 30
                if self.queued:
                    return self.queued.pop(0)
                get_broker().drain()
                # keep rendering (-1) until history arrived, then quit;
                # the deadline keeps a lost reply from hanging the suite
                if (model.history_lines
                        or time_module.monotonic() > _deadline[0]):
                    return ord("q")
                return -1

        fake_curses = types.SimpleNamespace(
            A_BOLD=1, A_DIM=2, KEY_DOWN=258, KEY_UP=259,
            KEY_BACKSPACE=263, curs_set=lambda n: None)
        _dashboard_ui(model, FakeScreen(keys), fake_curses)
        assert model.history_lines, "history never arrived"
        joined = " ".join(drawn)
        assert "history:" in joined
        assert any("historic" in line for line in model.history_lines)
        process.terminate()


class TestSystemBootstrap:
    """`aiko system start|stop`: the one-command local deployment
    (registrar + named pipeline as detached children, pids recorded in
    a state file the stop command consumes)."""

    def _definition(self, tmp_path):
        import json
        path = tmp_path / "tiny.json"
        path.write_text(json.dumps({
            "name": "tiny", "graph": ["(source)"],
            "elements": [
                {"name": "source",
                 "output": [{"name": "text", "type": "str"}],
                 "parameters": {"data_sources": ["x"]},
                 "deploy": {"local": {
                     "module": "aiko_services_tpu_torch.elements",
                     "class_name": "TextSource"}}}]}))
        return path

    def test_start_then_stop(self, tmp_path):
        from aiko_services_tpu_torch.cli import _pid_alive, _system_state

        state_file = tmp_path / "system.json"
        result = _invoke(*[
            "system", "start", str(self._definition(tmp_path)),
            "--name", "boot_pipe", "--transport", "loopback",
            "--no-dashboard", "--state-file", str(state_file)])
        assert result.exit_code == 0, result.output
        state = _system_state(str(state_file))
        pids = state["pids"]
        assert set(pids) == {"registrar", "pipeline:boot_pipe"}
        assert all(_pid_alive(pid) for pid in pids.values())

        # double-start refuses while the recorded pids are alive
        again = _invoke(*[
            "system", "start", str(self._definition(tmp_path)),
            "--no-dashboard", "--state-file", str(state_file)])
        assert again.exit_code == 1

        status = _invoke(*[
            "system", "status", "--state-file", str(state_file)])
        assert status.exit_code == 0 and "up" in status.output

        result = _invoke(*[
            "system", "stop", "--state-file", str(state_file)])
        assert result.exit_code == 0, result.output
        wait_for(lambda: not any(_pid_alive(pid)
                                 for pid in pids.values()), timeout=15)
        assert not state_file.exists()

    def test_stop_without_state_is_an_error(self, tmp_path):
        result = _invoke(*[
            "system", "stop", "--state-file",
            str(tmp_path / "missing.json")])
        assert result.exit_code == 1

    @pytest.mark.skipif(not os.path.exists("/proc"),
                        reason="pid identity check needs /proc; without "
                               "it the fallback would SIGTERM this very "
                               "test process")
    def test_stop_refuses_recycled_pid(self, tmp_path):
        """A stale state file whose pid now belongs to an UNRELATED
        process (reboot/pid reuse) must not be signalled: this very
        test process is alive but is not an `aiko_services_tpu_torch`
        child, so stop leaves it alone."""
        import json
        import os

        state_file = tmp_path / "system.json"
        state_file.write_text(json.dumps(
            {"pids": {"registrar": os.getpid()}}))
        result = _invoke(*[
            "system", "stop", "--state-file", str(state_file)])
        assert result.exit_code == 0, result.output
        assert "leaving it alone" in result.output
        assert not state_file.exists()




class TestCli:
    def test_cli_help_lists_commands(self):
        result = _invoke("--help")
        assert result.exit_code == 0
        for command in ("registrar", "pipeline", "storage", "recorder",
                        "dashboard", "bench", "lint", "deadletter", "tune",
                        "trace", "system", "bootstrap"):
            assert command in result.output

    def test_help_runs_without_click(self, tmp_path):
        """`python -m aiko_services_tpu_torch --help` with `click`
        masked (an import of it raises): the port's CLI needs none, as
        on the machine with the card."""
        mask = tmp_path / "mask"
        (mask / "click").mkdir(parents=True)
        (mask / "click" / "__init__.py").write_text(
            "raise ImportError('click is masked')\n")
        result = _module("--help", env={
            "PYTHONPATH": os.pathsep.join(
                [str(mask), str(REPO), os.environ.get("PYTHONPATH", "")])})
        assert result.returncode == 0, result.stderr
        assert "tune" in result.stdout and "system" in result.stdout
        probe = subprocess.run(
            [sys.executable, "-c", "import click"], capture_output=True,
            env=dict(os.environ, PYTHONPATH=str(mask)))
        assert probe.returncode != 0  # the mask really masks

    def test_bench_names_the_roadmap_item_and_runs_nothing(self):
        result = _invoke("bench")
        assert result.exit_code == 1
        assert "no benchmark yet" in result.output
        assert "ROADMAP" in result.output
        result = _invoke("lint", "--bench")
        assert result.exit_code == 2 and "no benchmark yet" in result.output

    def test_subcommand_groups_print_their_help(self):
        for group, subcommands in (("system", ("start", "stop", "status")),
                                   ("trace", ("merge", "collect")),
                                   ("deadletter", ("ls", "replay"))):
            result = _invoke(group)
            assert result.exit_code == 0
            assert all(name in result.output for name in subcommands)

    def test_usage_errors_exit_two(self, tmp_path):
        assert _invoke("nonsense").exit_code == 2
        assert _invoke("pipeline", str(tmp_path / "missing.json")
                       ).exit_code == 2
        assert _invoke("lint", "--format", "xml", "x.json").exit_code == 2


class TestLintCli:
    def _definition(self, tmp_path, **parameters):
        path = tmp_path / "scaled.json"
        path.write_text(json.dumps({
            "name": "scaled", "parameters": {"device": "cpu", **parameters},
            "graph": ["(scale)"],
            "elements": [{
                "name": "scale",
                "input": [{"name": "tensor", "type": "f32[2,8]"}],
                "output": [{"name": "tensor", "type": "f32[2,8]"}],
                "deploy": {"local": {
                    "module": "aiko_services_tpu_torch.elements",
                    "class_name": "JaxScale"}}}]}))
        return path

    def test_lint_eval_pass_on_the_meta_device(self, tmp_path):
        """`lint --passes eval` instantiates each element on the meta
        device (no card); a clean definition exits 0, a bad autoscale
        spec in the policy pass exits 1 naming AIKO406."""
        path = self._definition(tmp_path)
        result = _invoke("lint", str(path), "--passes", "graph,eval",
                         "--format", "json")
        assert result.exit_code == 0, result.output
        assert json.loads(result.output)["summary"]["errors"] == 0
        bad = self._definition(tmp_path,
                               autoscale_policy="min_replicas=3;"
                                                "max_replicas=2")
        result = _invoke("lint", str(bad), "--passes", "policy")
        assert result.exit_code == 1
        assert "AIKO406" in result.output
        assert _invoke("lint", str(path), "--passes", "bogus"
                       ).exit_code == 2

    def test_cli_code_mode_clean_against_baseline(self, tmp_path):
        """The baseline lifecycle of tests/test_concurrency_lint.py's
        CLI case, over the port's own package: --update-baseline writes
        the accepted findings, and a --strict run against it is clean,
        twice byte-identical."""
        package = str(REPO / "aiko_services_tpu_torch")
        baseline = tmp_path / "baseline.json"
        result = _invoke("lint", "--code", package, "--baseline",
                         str(baseline), "--update-baseline")
        assert result.exit_code == 0, result.output
        assert "baseline written" in result.output
        outputs = []
        for run in range(2):
            output = tmp_path / f"report{run}.json"
            result = _invoke("lint", "--code", package, "--strict",
                             "--format", "json", "--baseline",
                             str(baseline), "--output", str(output))
            assert result.exit_code == 0, result.output
            document = json.loads(output.read_text())
            assert document["summary"]["errors"] == 0
            assert document["summary"]["warnings"] == 0
            outputs.append(output.read_text())
        assert outputs[0] == outputs[1]
        assert _invoke("lint", "--baseline", str(baseline), package
                       ).exit_code == 2


class TestTraceCli:
    def test_merge_twice_is_byte_identical(self, tmp_path):
        traces = sorted((REPO / "tests" / "assets" / "traces").glob(
            "*.json"))[:2]
        first, second = tmp_path / "one.json", tmp_path / "two.json"
        for output in (first, second):
            result = _invoke("trace", "merge", str(output),
                             *map(str, traces))
            assert result.exit_code == 0, result.output
            assert "merged 2 artifact(s)" in result.output
        assert first.read_bytes() == second.read_bytes()
        result = _invoke("trace", "merge", str(tmp_path / "x.json"),
                         str(REPO / "pyproject.toml"))
        assert result.exit_code == 2
