# Remote service proxies + AOP method tracing.
#
# Capability parity with the reference remote-proxy maker (reference:
# src/aiko_services/main/transport/transport_mqtt.py:109-141): reflect the
# public methods of an interface class and build an object whose every method
# publishes "(method arg ...)" to the target's "{topic_path}/in" -- and with
# the reference's ProxyAllMethods/proxy_trace AOP wrapper (reference:
# src/aiko_services/main/proxy.py:39-72), here without the wrapt dependency.

from __future__ import annotations

import time

from ..utils import generate, get_logger

__all__ = ["get_public_methods", "make_proxy", "RemoteProxy",
           "TracingProxy", "trace_all_methods", "log_trace"]

_LOGGER = get_logger("proxy")


def get_public_methods(interface_class) -> list[str]:
    return sorted(
        name for name in dir(interface_class)
        if not name.startswith("_")
        and callable(getattr(interface_class, name)))


class RemoteProxy:
    """Dynamic proxy: attribute access returns a publisher for any method
    name; an optional interface class restricts the surface."""

    def __init__(self, process, topic_in: str, interface_class=None):
        object.__setattr__(self, "_process", process)
        object.__setattr__(self, "_topic_in", topic_in)
        methods = (set(get_public_methods(interface_class))
                   if interface_class is not None else None)
        object.__setattr__(self, "_methods", methods)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if self._methods is not None and name not in self._methods:
            raise AttributeError(
                f"{name} is not part of the proxied interface")

        def remote_call(*args):
            self._process.publish(self._topic_in, generate(name, args))

        remote_call.__name__ = name
        return remote_call

    def __repr__(self):
        return f"RemoteProxy({self._topic_in})"


def make_proxy(process, topic_path: str, interface_class=None) -> RemoteProxy:
    """topic_path may be the service root or the /in topic itself."""
    topic_in = (topic_path if topic_path.endswith("/in")
                else f"{topic_path}/in")
    return RemoteProxy(process, topic_in, interface_class)


def log_trace(name: str, phase: str, elapsed: float | None,
              args: tuple, result) -> None:
    """Default tracer: enter/exit lines with wall time (the reference's
    proxy_trace printer, proxy.py:64-72)."""
    if phase == "enter":
        _LOGGER.info("TRACE > %s%r", name, args)
    elif phase == "error":
        _LOGGER.info("TRACE ! %s raised %r (%.3f ms)", name, result,
                     (elapsed or 0.0) * 1e3)
    else:
        _LOGGER.info("TRACE < %s -> %r (%.3f ms)", name, result,
                     (elapsed or 0.0) * 1e3)


class TracingProxy:
    """AOP wrapper: every public method call on the wrapped object passes
    through `tracer(name, phase, elapsed, args, result)` -- the
    reference's ProxyAllMethods capability (proxy.py:39-62) built on
    plain __getattr__ delegation instead of wrapt.  Non-callable and
    underscore attributes pass through untraced.  LIMITATION: special-
    method protocol lookups (`with`, `len()`, iteration, calling the
    proxy itself) resolve on the proxy TYPE and bypass __getattr__ --
    wrap objects whose API is named methods, not protocol objects."""

    def __init__(self, target, tracer=None):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_tracer", tracer or log_trace)
        object.__setattr__(self, "_traced_cache", {})

    def __getattr__(self, name):
        value = getattr(self._target, name)
        if name.startswith("_") or not callable(value):
            return value
        cached = self._traced_cache.get(name)
        if cached is not None and cached.__wrapped__ == value:
            return cached  # stable identity: proxy.m is proxy.m
        tracer = self._tracer

        def traced(*args, **kwargs):
            tracer(name, "enter", None, args, None)
            start = time.perf_counter()
            try:
                result = value(*args, **kwargs)
            except BaseException as error:
                tracer(name, "error", time.perf_counter() - start, args,
                       error)
                raise
            tracer(name, "exit", time.perf_counter() - start, args,
                   result)
            return result

        traced.__name__ = name
        traced.__wrapped__ = value
        self._traced_cache[name] = traced
        return traced

    def __setattr__(self, name, value):
        setattr(self._target, name, value)

    def __repr__(self):
        return f"TracingProxy({self._target!r})"


def trace_all_methods(target, tracer=None) -> TracingProxy:
    return TracingProxy(target, tracer)
