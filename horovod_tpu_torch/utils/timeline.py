"""Horovod Timeline: Chrome-tracing (catapult) JSON writer.

A copy of the JAX package's ``utils/timeline.py`` (framework-neutral),
with the reference's contract (``timeline.h``/``timeline.cc``):

* Enabled by ``HOROVOD_TIMELINE=<file>``, written by rank 0 only.
* Each tensor is a fake "process" (pid) with a metadata event naming it
  (``timeline.cc:59-76``).
* Per-tensor state machine UNKNOWN→NEGOTIATING→TOP_LEVEL→ACTIVITY
  (``timeline.h:37-42``), enforced.
* ``End`` logs the output dtype+shape (``timeline.cc:203-220``); writes are
  mutex-guarded; ~1 s flush interval (``timeline.h:35``).

The training hot path emits the host-plane phases below (input staging,
checkpoint snapshot and write, skipped steps) so a trace shows what the
host was doing while the device ran.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time
from typing import Iterable, Optional


class _State:
    UNKNOWN = 0
    NEGOTIATING = 1
    TOP_LEVEL = 2
    ACTIVITY = 3


# Host-plane phase names (beyond the reference's collective activities):
# the training hot path emits these so a trace shows WHAT the host was
# doing while the device ran — input staging and checkpointing, the two
# host activities kept off the step's critical path.
H2D = "H2D"                      # prefetch thread: host→device batch copy
CKPT_SNAPSHOT = "CKPT_SNAPSHOT"  # step loop: device→host state snapshot
CKPT_WRITE = "CKPT_WRITE"        # background writer: leaf files + GC
BAD_STEP = "BAD_STEP"            # guard: non-finite grads, update skipped


@contextlib.contextmanager
def maybe_op(tl: Optional["Timeline"], tensor_name: str, op_kind: str):
    """Scoped :meth:`Timeline.op` that no-ops when ``tl`` is None — the
    emitters on the training hot path (prefetch thread, checkpoint writer)
    run with or without a timeline and must not branch at every call site.
    Each concurrent emitter uses its own ``tensor_name`` row, so the
    per-row state machine never sees interleaved ops from two threads."""
    if tl is None:
        yield None
        return
    with tl.op(tensor_name, op_kind):
        yield tl


class TimelineStateError(RuntimeError):
    """Illegal timeline transition — a B event would be left unbalanced
    (the reference asserts these transitions, ``timeline.h:37-42`` enforced
    in ``timeline.cc:118-135``)."""


class Timeline:
    """Chrome-tracing writer (JSON array format, streaming).

    The per-tensor state machine UNKNOWN→NEGOTIATING→TOP_LEVEL→ACTIVITY is
    ENFORCED (not just tracked): a call out of order raises
    :class:`TimelineStateError` instead of silently writing an unbalanced
    B/E stream. Activities nest; ``_depth`` counts open activity frames.
    Every duration/instant event carries ``tid: 0`` — Perfetto and some
    catapult builds require a tid to pair B/E events within a pid.
    """

    FLUSH_INTERVAL_SECS = 1.0  # timeline.h:35

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._file = open(path, "w")
        self._file.write("[\n")
        self._start = time.monotonic()
        self._pids: dict[str, int] = {}
        self._states: dict[str, int] = {}
        self._depth: dict[str, int] = {}
        self._last_flush = self._start
        self._closed = False
        # Crash safety: the ~1 s flush cadence means a killed rank loses
        # the buffered tail of its trace — the very events that explain
        # the death. An atexit close catches normal-but-uncloseed exits;
        # the fatal-signal path is covered by the flight recorder's
        # crash hooks (runtime.init registers self.flush there).
        atexit.register(self.close)

    # -- low-level ---------------------------------------------------------

    def _ts_us(self) -> int:
        return int((time.monotonic() - self._start) * 1e6)

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._file.write(json.dumps(ev) + ",\n")
            now = time.monotonic()
            if now - self._last_flush > self.FLUSH_INTERVAL_SECS:
                self._file.flush()
                self._last_flush = now

    def flush(self, fsync: bool = True) -> None:
        """Push buffered events to disk NOW (fsync by default): called
        from error paths (:meth:`abort`) and crash hooks, where "the OS
        probably would have written it" is not good enough — the reader
        is a post-mortem."""
        with self._lock:
            if self._closed:
                return
            try:
                self._file.flush()
                if fsync:
                    os.fsync(self._file.fileno())
            except (OSError, ValueError):
                pass  # a dying process keeps dying
            self._last_flush = time.monotonic()

    def _pid(self, tensor_name: str) -> int:
        pid = self._pids.get(tensor_name)
        if pid is None:
            pid = len(self._pids)
            self._pids[tensor_name] = pid
            # Metadata event registering the tensor as a pseudo-process
            # (timeline.cc:59-76).
            self._emit({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": tensor_name}})
            self._emit({"name": "process_sort_index", "ph": "M", "pid": pid,
                        "args": {"sort_index": pid}})
        return pid

    def _expect(self, tensor_name: str, allowed: tuple, call: str) -> None:
        state = self._states.get(tensor_name, _State.UNKNOWN)
        if state not in allowed:
            names = {0: "UNKNOWN", 1: "NEGOTIATING", 2: "TOP_LEVEL",
                     3: "ACTIVITY"}
            raise TimelineStateError(
                f"timeline: {call}({tensor_name!r}) illegal in state "
                f"{names[state]} (allowed: "
                f"{'/'.join(names[s] for s in allowed)})")

    # -- negotiation phase (timeline.cc:107-140) ---------------------------

    def negotiate_start(self, tensor_name: str, op_kind: str) -> None:
        pid = self._pid(tensor_name)
        self._expect(tensor_name, (_State.UNKNOWN,), "negotiate_start")
        self._states[tensor_name] = _State.NEGOTIATING
        self._emit({"name": f"NEGOTIATE_{op_kind}", "ph": "B", "pid": pid,
                    "tid": 0, "ts": self._ts_us()})

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        pid = self._pid(tensor_name)
        self._expect(tensor_name, (_State.NEGOTIATING,),
                     "negotiate_rank_ready")
        self._emit({"name": str(rank), "ph": "i", "pid": pid, "tid": 0,
                    "ts": self._ts_us(), "s": "p"})

    def negotiate_end(self, tensor_name: str) -> None:
        pid = self._pid(tensor_name)
        self._expect(tensor_name, (_State.NEGOTIATING,), "negotiate_end")
        self._states[tensor_name] = _State.UNKNOWN
        self._emit({"name": "", "ph": "E", "pid": pid, "tid": 0,
                    "ts": self._ts_us()})

    def negotiate_instant(self, tensor_name: str, op_kind: str,
                          ready_ranks: Iterable[int] = ()) -> None:
        """Single-controller mode: SPMD needs no negotiation; record the
        would-be negotiation as an instantaneous phase for trace parity."""
        self.negotiate_start(tensor_name, op_kind)
        for r in ready_ranks:
            self.negotiate_rank_ready(tensor_name, r)
        self.negotiate_end(tensor_name)

    # -- processing phase (timeline.cc:142-220) ----------------------------

    def start(self, tensor_name: str, op_kind: str) -> None:
        pid = self._pid(tensor_name)
        self._expect(tensor_name, (_State.UNKNOWN,), "start")
        self._states[tensor_name] = _State.TOP_LEVEL
        self._depth[tensor_name] = 0
        self._emit({"name": op_kind, "ph": "B", "pid": pid, "tid": 0,
                    "ts": self._ts_us()})

    def activity_start(self, tensor_name: str, activity: str) -> None:
        pid = self._pid(tensor_name)
        self._expect(tensor_name, (_State.TOP_LEVEL, _State.ACTIVITY),
                     "activity_start")
        self._states[tensor_name] = _State.ACTIVITY
        self._depth[tensor_name] = self._depth.get(tensor_name, 0) + 1
        self._emit({"name": activity, "ph": "B", "pid": pid, "tid": 0,
                    "ts": self._ts_us()})

    def activity_end(self, tensor_name: str) -> None:
        pid = self._pid(tensor_name)
        self._expect(tensor_name, (_State.ACTIVITY,), "activity_end")
        depth = self._depth.get(tensor_name, 1) - 1
        self._depth[tensor_name] = depth
        self._states[tensor_name] = (
            _State.TOP_LEVEL if depth == 0 else _State.ACTIVITY)
        self._emit({"name": "", "ph": "E", "pid": pid, "tid": 0,
                    "ts": self._ts_us()})

    def end(self, tensor_name: str, output=None) -> None:
        """End the top-level event, logging output dtype+shape
        (timeline.cc:203-220)."""
        pid = self._pid(tensor_name)
        self._expect(tensor_name, (_State.TOP_LEVEL,), "end")
        args = {}
        if output is not None:
            shape = getattr(output, "shape", None)
            dtype = getattr(output, "dtype", None)
            if shape is not None:
                args["shape"] = list(shape)
            if dtype is not None:
                args["dtype"] = str(dtype)
        self._states[tensor_name] = _State.UNKNOWN
        ev = {"name": "", "ph": "E", "pid": pid, "tid": 0,
              "ts": self._ts_us()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def abort(self, tensor_name: str, error: Optional[str] = None) -> None:
        """Close every open B event for ``tensor_name`` after a dispatch
        failure so the trace stays balanced (error paths must not corrupt
        the stream). Safe to call in any state."""
        state = self._states.get(tensor_name, _State.UNKNOWN)
        if state == _State.UNKNOWN:
            return
        pid = self._pid(tensor_name)
        if state == _State.NEGOTIATING:
            self.negotiate_end(tensor_name)
            self.flush(fsync=True)
            return
        while self._depth.get(tensor_name, 0) > 0:
            self.activity_end(tensor_name)
        ev = {"name": "", "ph": "E", "pid": pid, "tid": 0,
              "ts": self._ts_us()}
        if error:
            ev["args"] = {"error": error}
        self._states[tensor_name] = _State.UNKNOWN
        self._emit(ev)
        # An abort usually precedes a death (dispatch failure, world
        # ABORT): make the trace durable now instead of trusting the
        # 1 s cadence to get another turn.
        self.flush(fsync=True)

    # -- scoped helpers ----------------------------------------------------
    #
    # Whole code regions (a checkpoint write, an H2D copy) are bracketed
    # with these, where scope-exit safety matters: an exception mid-phase
    # must not leave a B event unbalanced.

    @contextlib.contextmanager
    def op(self, tensor_name: str, op_kind: str):
        """Scoped top-level event; aborts (balanced close + error arg) if
        the body raises."""
        self.start(tensor_name, op_kind)
        try:
            yield self
        except BaseException as e:
            self.abort(tensor_name, error=repr(e))
            raise
        else:
            self.end(tensor_name)

    @contextlib.contextmanager
    def activity(self, tensor_name: str, name: str):
        """Scoped nested activity under an open :meth:`op`."""
        self.activity_start(tensor_name, name)
        try:
            yield self
        finally:
            if self._states.get(tensor_name) == _State.ACTIVITY:
                self.activity_end(tensor_name)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                atexit.unregister(self.close)
            except Exception:  # noqa: BLE001 — interpreter may be exiting
                pass
            # Chrome's trace viewer tolerates the trailing comma; close the
            # array for strict-JSON consumers.
            self._file.write("{}]\n")
            self._file.close()
