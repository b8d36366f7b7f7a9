"""Host-side wall-clock spans (the ``span`` part of
``repro/telemetry/spans.py``).

Instrumented call sites go through :func:`span`, which returns a shared
null context manager when no :class:`Profiler` is installed — the
off-path cost is one global read and an ``is None`` test.  Events are
Chrome trace-event ``B``/``E`` pairs in wall-clock microseconds.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

TRACE_PID_HOST = 1


class _NullSpan:
    """Shared do-nothing context manager returned when profiling is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()
_ACTIVE: Optional["Profiler"] = None


def span(name: str, cat: str = "host", **args: Any):
    """Context manager timing ``name`` on the active profiler.

    With no profiler installed (the default) this returns a shared
    null context — safe to leave in hot-ish host paths.
    """
    p = _ACTIVE
    if p is None:
        return _NULL_SPAN
    return p.span(name, cat, **args)


class _Span:
    __slots__ = ("_prof", "_name", "_cat", "_args")

    def __init__(self, prof: "Profiler", name: str, cat: str,
                 args: Dict[str, Any]):
        self._prof = prof
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        ev = {"name": self._name, "cat": self._cat, "ph": "B",
              "ts": self._prof._now_us(), "pid": TRACE_PID_HOST, "tid": 1}
        if self._args:
            ev["args"] = dict(self._args)
        self._prof.events.append(ev)
        return self

    def __exit__(self, *exc: object) -> bool:
        self._prof.events.append(
            {"name": self._name, "cat": self._cat, "ph": "E",
             "ts": self._prof._now_us(), "pid": TRACE_PID_HOST, "tid": 1})
        return False


class Profiler:
    """Collects host-side trace events relative to its construction time.
    Use as a context manager to make module-level :func:`span` calls
    route here."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.events: List[Dict[str, Any]] = []

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def span(self, name: str, cat: str = "host", **args: Any) -> _Span:
        return _Span(self, name, cat, args)

    def __enter__(self) -> "Profiler":
        global _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc: object) -> bool:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None
        return False
