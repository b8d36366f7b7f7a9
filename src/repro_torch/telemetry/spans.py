"""Host-side wall-clock spans and Chrome trace-event JSON export (a
copy of ``repro/telemetry/spans.py``).

Two clocks feed one trace file:

* **Host spans** — a nestable :class:`Profiler` records ``B``/``E``
  duration events in wall-clock microseconds around expensive host
  phases (quantization calibration, trace lowering, engine swaps, DSE
  evaluations).  Instrumented call sites go through the
  module-level :func:`span` helper, which returns a shared null context
  manager when no profiler is installed — the off-path cost is one
  global read and an ``is None`` test, and *nothing* is allocated.

* **Simulator timelines** — :func:`stream_timeline_events` converts a
  :class:`repro_torch.core.network.StreamResult` stage x frame ``start`` /
  ``finish`` schedule into trace events on a separate "pid" so pipeline
  fill, bubbles and straggler frames render as rows in Perfetto /
  ``chrome://tracing``.  Simulated cycles are mapped to microseconds at
  a caller-supplied clock (``STEP_CLOCK_HZ`` by default), keeping both
  clock domains on one zoomable axis.

The output follows the Chrome trace-event JSON-array format: a dict
``{"traceEvents": [...]}`` where each event carries ``name``, ``ph``,
``ts`` (us), ``pid``/``tid`` and optional ``dur``/``id``/``args``.
:func:`validate_chrome_trace` checks the invariants the viewers rely
on (monotone ``ts``, LIFO-matched ``B``/``E`` pairs per thread).
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Trace "process" ids: host wall-clock vs simulated mesh cycles.  They
# are separate top-level groups in Perfetto so the two clock domains
# never visually interleave.
TRACE_PID_HOST = 1
TRACE_PID_SIM = 2


class _NullSpan:
    """Shared do-nothing context manager returned when profiling is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()
_ACTIVE: Optional["Profiler"] = None


def active_profiler() -> Optional["Profiler"]:
    """The currently installed :class:`Profiler`, or ``None``."""
    return _ACTIVE


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

    Use as a context manager (or call :meth:`install` / :meth:`uninstall`)
    to make module-level :func:`span` calls route here::

        with Profiler() as prof:
            sim = NetworkSimulator(...)      # calibration/lowering spans land
            sim.run(x)
        write_chrome_trace("trace.json", prof.events)
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.events: List[Dict[str, Any]] = []

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def span(self, name: str, cat: str = "host", **args: Any) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._now_us(), "pid": TRACE_PID_HOST, "tid": 1}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    def counter(self, name: str, values: Dict[str, float],
                ts_us: Optional[float] = None) -> None:
        self.events.append(
            {"name": name, "cat": "host", "ph": "C",
             "ts": self._now_us() if ts_us is None else ts_us,
             "pid": TRACE_PID_HOST, "tid": 1, "args": dict(values)})

    def install(self) -> "Profiler":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "Profiler":
        return self.install()

    def __exit__(self, *exc: object) -> bool:
        self.uninstall()
        return False


# ---------------------------------------------------------------------------
# Streaming timeline -> trace events
# ---------------------------------------------------------------------------


def stream_timeline_events(res, stage_names: Optional[Sequence[str]] = None,
                           clock_hz: Optional[float] = None,
                           ) -> List[Dict[str, Any]]:
    """Convert a ``StreamResult`` into Chrome trace events.

    Three views of the same schedule, all under ``pid=TRACE_PID_SIM``:

    * per-stage **occupancy slices** (``X`` events, one thread per
      pipeline stage): each frame occupies stage ``k`` for ``occ[k]``
      cycles starting at ``start[t, k]`` — by the streaming recurrence
      these never overlap within a stage, so bubbles show as gaps;
    * per-frame **async tracks** (``b``/``e`` events keyed by frame id):
      an outer span from injection to exit with the per-stage residency
      spans nested inside — pipeline skew reads as a staircase;
    * a **queue-depth counter** (``C`` events) stepped at every arrival
      and exit, when the result carries arrivals.

    The timeline is sourced entirely from the result's timing pass
    (``start``/``finish``/``occupancy``/``arrivals``) — it never touches
    the numerics, so batched and per-cell stream executions render the
    same trace.  When the result carries ``batch_sizes`` (the batched
    path's realized micro-batches), each frame's outer span is annotated
    with the micro-batch it rode in (``numerics_batch``/``batch_size``).
    """
    if clock_hz is None:
        from repro_torch.core.energy import STEP_CLOCK_HZ
        clock_hz = STEP_CLOCK_HZ
    c2us = 1e6 / float(clock_hz)
    start, finish = res.start, res.finish
    t_n, s_n = start.shape
    occ = res.occupancy
    events: List[Dict[str, Any]] = []

    names = [f"stage {k}" if stage_names is None or k >= len(stage_names)
             else f"stage {k}: {stage_names[k]}" for k in range(s_n)]
    for k in range(s_n):
        events.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                       "pid": TRACE_PID_SIM, "tid": k,
                       "args": {"name": names[k]}})
    events.append({"name": "process_name", "ph": "M", "ts": 0.0,
                   "pid": TRACE_PID_SIM,
                   "args": {"name": "mesh (simulated cycles)"}})

    arrivals = getattr(res, "arrivals", None)
    # frame -> (micro-batch index, size) from the numerics pass, if any
    frame_batch: Dict[int, Tuple[int, int]] = {}
    t0 = 0
    for bi, size in enumerate(getattr(res, "batch_sizes", ()) or ()):
        for t in range(t0, t0 + size):
            frame_batch[t] = (bi, size)
        t0 += size
    for t in range(t_n):
        inject = float(start[t, 0]) if arrivals is None else float(arrivals[t])
        exit_c = float(finish[t, s_n - 1])
        frame_id = str(t)
        args: Dict[str, Any] = {"latency_cycles": int(exit_c - inject)}
        if t in frame_batch:
            args["numerics_batch"], args["batch_size"] = frame_batch[t]
        events.append({"name": f"frame {t}", "cat": "frame", "ph": "b",
                       "id": frame_id, "ts": inject * c2us,
                       "pid": TRACE_PID_SIM, "tid": 0,
                       "args": args})
        for k in range(s_n):
            s_us = float(start[t, k]) * c2us
            events.append({"name": names[k], "cat": "frame", "ph": "b",
                           "id": frame_id, "ts": s_us,
                           "pid": TRACE_PID_SIM, "tid": 0})
            events.append({"name": names[k], "cat": "frame", "ph": "e",
                           "id": frame_id,
                           "ts": float(finish[t, k]) * c2us,
                           "pid": TRACE_PID_SIM, "tid": 0})
            # occupancy slice: the cycles the stage is actually busy on
            # this frame (occ[k] <= finish - start; the rest is wait)
            events.append({"name": f"f{t}", "cat": "stage", "ph": "X",
                           "ts": s_us, "dur": float(occ[k]) * c2us,
                           "pid": TRACE_PID_SIM, "tid": k,
                           "args": {"frame": t,
                                    "start_cycle": int(start[t, k]),
                                    "finish_cycle": int(finish[t, k])}})
        events.append({"name": f"frame {t}", "cat": "frame", "ph": "e",
                       "id": frame_id, "ts": exit_c * c2us,
                       "pid": TRACE_PID_SIM, "tid": 0})

    if arrivals is not None:
        exits = sorted(float(finish[t, s_n - 1]) for t in range(t_n))
        steps = [(float(a), 1) for a in arrivals] + [(e, -1) for e in exits]
        depth = 0
        for ts, d in sorted(steps):
            depth += d
            events.append({"name": "queue_depth", "ph": "C",
                           "ts": ts * c2us, "pid": TRACE_PID_SIM, "tid": 0,
                           "args": {"frames": depth}})
    return events


# ---------------------------------------------------------------------------
# Assembly / validation / IO
# ---------------------------------------------------------------------------


def chrome_trace(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Assemble events into a Chrome trace-event JSON document.

    Sorting is stable and keyed on ``ts`` alone, so causally-ordered
    appends with equal timestamps (a ``B`` immediately followed by its
    ``E``) keep their order; ``M`` metadata records sort to the front
    at ``ts=0``.
    """
    evs = sorted(events, key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: Sequence[Dict[str, Any]]) -> str:
    doc = chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f, indent=None, separators=(",", ":"))
        f.write("\n")
    return path


def validate_chrome_trace(doc: Any) -> List[str]:
    """Check the invariants trace viewers rely on; returns problems
    (empty list = valid).

    * top level is ``{"traceEvents": [...]}`` or a bare event list;
    * every event has a string ``name``, a known ``ph`` and numeric
      non-negative ``ts``;
    * ``ts`` is non-decreasing across non-metadata events;
    * ``B``/``E`` events nest LIFO per ``(pid, tid)`` with matching
      names, and every ``B`` is closed.
    """
    errors: List[str] = []
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level dict lacks a traceEvents list"]
    elif isinstance(doc, list):
        events = doc
    else:
        return [f"unsupported top-level type {type(doc).__name__}"]

    known_ph = {"B", "E", "X", "i", "I", "C", "M", "b", "e", "n"}
    last_ts = None
    stacks: Dict[tuple, List[str]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in known_ph:
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        name = ev.get("name")
        if not isinstance(name, str):
            errors.append(f"event {i}: missing/non-string name")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "M":
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(f"event {i}: ts {ts} < previous {last_ts}")
        last_ts = ts
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(name)  # type: ignore[arg-type]
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errors.append(f"event {i}: E {name!r} with no open B on "
                              f"pid/tid {key}")
            elif stack[-1] != name:
                errors.append(f"event {i}: E {name!r} closes B "
                              f"{stack[-1]!r} on pid/tid {key}")
                stack.pop()
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            errors.append(f"unclosed B spans on pid/tid {key}: {stack}")
    return errors


def load_chrome_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        doc = {"traceEvents": doc}
    return doc
