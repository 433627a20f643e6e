# ProcessManager: spawn and reap OS child processes.
#
# Capability parity with the reference ProcessManager (reference:
# src/aiko_services/main/process_manager.py:48-110): Popen children keyed
# by id, bare module names resolved to file paths via importlib, a
# background poll thread reaping exits into a process_exit_handler.

from __future__ import annotations

import importlib.util
import subprocess
import sys
import threading

from ..utils import get_logger

__all__ = ["ProcessManager"]

_LOGGER = get_logger("process_manager")
_POLL_INTERVAL = 0.2  # reference process_manager.py poll cadence


class ProcessManager:
    def __init__(self, process_exit_handler=None):
        self.process_exit_handler = process_exit_handler
        self.processes: dict = {}   # id -> {"process": Popen, "command":..}
        self._escalating: list = []  # children awaiting SIGKILL escalation
        self._lock = threading.Lock()
        self._monitor: threading.Thread | None = None
        self._terminated = False

    @staticmethod
    def resolve_command(command: str) -> str:
        """Bare module name -> source file path (reference
        process_manager.py:63-80); paths and executables pass through."""
        if "/" in command or command.endswith(".py"):
            return command
        specification = importlib.util.find_spec(command)
        if specification is not None and specification.origin:
            return specification.origin
        return command

    def spawn(self, process_id, command: str, arguments=(),
              use_interpreter: bool = True,
              start_new_session: bool = False,
              stdout=None, stderr=None, env=None):
        """`start_new_session` detaches the child from the caller's
        terminal session (its own setsid), so closing the terminal
        does not SIGHUP it -- what `aiko system start` needs for a
        deployment that outlives the shell.  Detached children should
        also get their own `stdout`/`stderr` (a log file): inheriting
        the caller's keeps any pipe on it open forever.

        `env` is an OVERLAY merged over the parent's os.environ, not a
        replacement: autoscaled replica children must inherit the
        ambient environment (PATH, PYTHONPATH, proxy settings) plus the
        handful of knobs the spawner pins -- JAX_PLATFORMS, the
        persistent compile-cache directory, telemetry switches.  A None
        value in the overlay REMOVES that variable from the child."""
        import os
        command_path = self.resolve_command(command)
        argv = ([sys.executable, command_path] if use_interpreter
                else [command_path])
        argv += [str(argument) for argument in arguments]
        merged_env = None
        if env:
            merged_env = dict(os.environ)
            for key, value in env.items():
                if value is None:
                    merged_env.pop(str(key), None)
                else:
                    merged_env[str(key)] = str(value)
        child = subprocess.Popen(argv,
                                 start_new_session=start_new_session,
                                 stdout=stdout, stderr=stderr,
                                 env=merged_env)
        with self._lock:
            self.processes[process_id] = {
                "process": child, "command": command_path}
            if self._monitor is None:
                self._monitor = threading.Thread(
                    target=self._monitor_loop, name="process-manager",
                    daemon=True)
                self._monitor.start()
        _LOGGER.info("Spawned %s: pid %d: %s",
                     process_id, child.pid, " ".join(argv))
        return child

    def kill(self, process_id, timeout: float = 5.0) -> None:
        """Synchronously pop the record and send SIGTERM, so membership
        reflects the kill the moment this returns; the grace wait and
        SIGKILL escalation happen off-thread so callers (e.g. the event
        loop) never block on a stubborn child.  The pop and the
        _escalating registration share one lock acquisition so a
        concurrent terminate() can never miss the child."""
        with self._lock:
            record = self.processes.pop(process_id, None)
            if record is None:
                return
            child = record["process"]
            self._escalating.append(child)
        child.terminate()
        threading.Thread(target=self._reap, args=(child, timeout),
                         name=f"process-manager-kill-{process_id}",
                         daemon=True).start()

    def _reap(self, child, timeout: float) -> None:
        try:
            child.wait(timeout)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
        finally:
            with self._lock:
                if child in self._escalating:
                    self._escalating.remove(child)

    def kill_all(self) -> None:
        for process_id in list(self.processes):
            self.kill(process_id)

    def __contains__(self, process_id) -> bool:
        return process_id in self.processes

    def _monitor_loop(self) -> None:
        import time
        from ..faults import get_injector
        while not self._terminated:
            injector = get_injector()
            if injector is not None:
                # seeded chaos (faults.py process_kill): one consult
                # per poll per child -- frame=k kills that child on
                # its k-th poll, deterministically.  Disabled (the
                # production state) this is one is-None check per poll
                with self._lock:
                    records = list(self.processes.items())
                for process_id, record in records:
                    if injector.process_kill(process_id):
                        _LOGGER.warning(
                            "Injected process_kill fired on %s",
                            process_id)
                        # SIGKILL without popping the record: the child
                        # dies ABNORMALLY and the reap below observes
                        # the exit, so process_exit_handler fires
                        # exactly as for a real crash (kill() is the
                        # deliberate-retirement path and suppresses it)
                        try:
                            record["process"].kill()
                        except OSError:
                            pass
            exited = []
            with self._lock:
                for process_id, record in list(self.processes.items()):
                    return_code = record["process"].poll()
                    if return_code is not None:
                        exited.append((process_id, record, return_code))
                        del self.processes[process_id]
            for process_id, record, return_code in exited:
                _LOGGER.info("Process %s exited: %d",
                             process_id, return_code)
                if self.process_exit_handler:
                    try:
                        self.process_exit_handler(process_id, return_code)
                    except Exception:
                        _LOGGER.exception("process_exit_handler failed")
            time.sleep(_POLL_INTERVAL)

    def terminate(self, grace: float = 5.0) -> None:
        """Shutdown path must not rely on daemon escalation threads (they
        die with the interpreter): all children get SIGTERM concurrently,
        then ONE shared grace window to exit cleanly, then SIGKILL for
        stragglers -- so no SIGTERM-ignoring child survives as an orphan
        and shutdown is bounded by `grace`, not grace-per-child."""
        import time
        self._terminated = True    # stops the monitor loop
        self.kill_all()            # concurrent SIGTERM + async reaps
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            with self._lock:
                if not self._escalating:
                    return
            time.sleep(0.02)
        with self._lock:
            stragglers = list(self._escalating)
            self._escalating.clear()
        for child in stragglers:
            if child.poll() is None:
                child.kill()
            child.wait()
