"""Span tracer with Chrome/Perfetto ``trace_event`` JSON export.

One flag produces a load-able timeline of the whole pipeline —
compress -> serialize -> commit on the write side, prefetch -> decode
on the read side, including queue-wait and backpressure-stall spans:

    CEAZ_TRACE=/tmp/run.trace.json python my_job.py      # env var, or
    comp = CEAZ(CEAZConfig(trace="/tmp/run.trace.json")) # config flag

and then load the file in ``chrome://tracing`` or https://ui.perfetto.dev.

Design constraints (why this module looks the way it does):

  * disabled must be (nearly) free — the hot paths call :func:`span`
    unconditionally, so when no tracer is installed it returns a shared
    no-op context manager after ONE global check;
  * thread-aware — the async engines run compress / serialize / commit
    / prefetch on named threads; events record their thread and the
    export emits ``thread_name`` metadata so Perfetto lays the overlap
    out one track per stage;
  * nestable — spans are plain "X" (complete) events; nesting falls out
    of the timestamps, no per-thread stack is kept.

The span taxonomy (which names mean what, and their units) is normative
in ``docs/OBSERVABILITY.md``.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "span", "traced", "enable", "disable", "active",
           "save"]


class _NoopSpan:
    """Shared do-nothing span: the disabled-path fast exit."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _Span:
    """One live span; records a complete ("X") event when it exits."""
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **args) -> "_Span":
        """Attach/override event args from inside the span body."""
        self.args.update(args)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._record(self.name, self._t0, time.perf_counter(),
                             self.args)
        return False


class Tracer:
    """Thread-safe collector of ``trace_event`` spans.

    Events are buffered in memory (one append under a lock per span —
    spans are per pipeline stage, not per value, so the buffer stays
    small) and exported with :meth:`save` as Chrome's JSON object
    format: ``{"traceEvents": [...]}`` with microsecond timestamps
    relative to tracer start plus ``process_name`` / ``thread_name``
    metadata events.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._tids: Dict[int, str] = {}
        self._t0 = time.perf_counter()

    def _record(self, name: str, t0: float, t1: float,
                args: Dict[str, Any]) -> None:
        th = threading.current_thread()
        ev = {"name": name, "ph": "X", "pid": os.getpid(),
              "tid": th.ident,
              "ts": (t0 - self._t0) * 1e6,
              "dur": (t1 - t0) * 1e6}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)
            self._tids.setdefault(th.ident, th.name)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def events(self) -> List[Dict[str, Any]]:
        """A snapshot copy of the recorded events (test/export use)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome ``trace_event`` JSON object (dict form)."""
        pid = os.getpid()
        with self._lock:
            meta: List[Dict[str, Any]] = [
                {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": "ceaz"}}]
            for tid, tname in sorted(self._tids.items()):
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {"name": tname}})
            return {"traceEvents": meta + list(self._events),
                    "displayTimeUnit": "ms"}

    def save(self, path: Optional[str] = None) -> str:
        """Write the Chrome trace JSON; returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("no trace path: Tracer(path=...) or save(path)")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


_tracer: Optional[Tracer] = None
_atexit_registered = False


def active() -> Optional[Tracer]:
    """The installed tracer, or None when tracing is disabled."""
    return _tracer


def span(name: str, **args):
    """A span context manager under the installed tracer; the shared
    no-op when tracing is disabled (ONE global check — this is the
    call the instrumented hot paths make unconditionally)."""
    t = _tracer
    if t is None:
        return _NOOP
    return t.span(name, **args)


def traced(name: Optional[str] = None):
    """Decorator form: ``@traced()`` / ``@traced("my.name")`` wraps the
    call in a span (function qualname when no name is given)."""
    def deco(fn):
        label = name or fn.__qualname__

        def wrapper(*a, **kw):
            t = _tracer
            if t is None:
                return fn(*a, **kw)
            with t.span(label):
                return fn(*a, **kw)
        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def enable(path: Optional[str] = None, *,
           save_at_exit: Optional[bool] = None) -> Tracer:
    """Install (or return) the process tracer.

    Idempotent: a second ``enable`` returns the existing tracer (its
    path is upgraded if it had none). With a ``path``,
    ``save_at_exit`` defaults to True so a traced run needs no explicit
    save call — ``CEAZ_TRACE=...`` and ``CEAZConfig(trace=...)`` both
    go through here.
    """
    global _tracer, _atexit_registered
    if _tracer is None:
        _tracer = Tracer(path)
    elif path and not _tracer.path:
        _tracer.path = path
    if save_at_exit is None:
        save_at_exit = path is not None
    if save_at_exit and not _atexit_registered:
        _atexit_registered = True
        atexit.register(_save_at_exit)
    return _tracer


def _save_at_exit() -> None:
    t = _tracer
    if t is not None and t.path:
        try:
            t.save()
        except OSError:
            pass                    # exit-time best effort


def disable() -> None:
    """Uninstall the tracer (events are dropped unless saved first)."""
    global _tracer
    _tracer = None


def save(path: Optional[str] = None) -> Optional[str]:
    """Save the active tracer's events now; None when disabled."""
    t = _tracer
    if t is None:
        return None
    return t.save(path)


# one env check at import: CEAZ_TRACE=path turns the whole process on
# without touching any code (the instrumented modules import this one)
_env_path = os.environ.get("CEAZ_TRACE")
if _env_path:
    enable(_env_path)
