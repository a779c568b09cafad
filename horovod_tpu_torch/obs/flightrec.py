"""Crash-safe flight recorder: a bounded ring of recent structured
events, dumped to disk when the process dies badly.

A copy of the JAX package's ``obs/flightrec.py`` (framework-neutral). It
keeps the last K events (step boundaries, checkpoint commits, bad steps,
faults) in memory at near-zero cost (one deque append per event) and
writes ``hvd_flightrec.rank{N}.json`` when something terminal happens:

* a fatal signal (SIGTERM — what a launcher's teardown and every real
  preemption notice deliver first; SIGKILL is untrappable);
* ``runtime.shutdown(error=...)`` — the programmatic "this world is dying
  for a reason" path;
* the fault injector's ``kill``/``exit`` actions dump just before pulling
  the trigger, so a drilled "dead" rank leaves the record a real
  preempted rank would;
* the coordination plane's world abort, the moment it surfaces on a
  surviving rank (``coord.client.CoordClient._abort_record``: an
  ``abort`` event naming the dead rank, then the dump).

Knobs: ``HVD_FLIGHTREC_DIR`` (dump directory, default cwd),
``HVD_FLIGHTREC_EVENTS`` (ring capacity, default 256; 0 disables both
recording and dumping).
"""

from __future__ import annotations

import json
import os
import signal as _signal
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

DEFAULT_CAPACITY = 256
FILENAME = "hvd_flightrec.rank{rank}.json"


def _capacity() -> int:
    raw = os.environ.get("HVD_FLIGHTREC_EVENTS")
    if raw is None or raw == "":
        return DEFAULT_CAPACITY
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_CAPACITY


def _directory() -> str:
    return os.path.abspath(os.environ.get("HVD_FLIGHTREC_DIR") or ".")


def _my_rank() -> int:
    # Lazy imports: this module must stay import-light (the runtime and
    # the fault injector import it on their error paths).
    from .. import runtime
    from ..utils import config as _config
    if runtime.is_initialized():
        return runtime.process_index()
    return _config.launcher_rank(default=0)


class FlightRecorder:
    """Bounded ring of ``{"t": wall-clock, "kind": ..., **fields}``
    events. ``record`` is the hot call: one lock + one deque append —
    cheap enough for once-per-step emitters (NOT for per-element inner
    loops; callers aggregate first)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        # RLock, not Lock: the SIGTERM dump handler runs on the MAIN
        # thread between bytecodes, and the main thread may be inside
        # record()/dump() holding this very lock when the signal lands —
        # a non-reentrant lock would deadlock the dying rank instead of
        # writing its post-mortem.
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._dumps = 0

    def record(self, kind: str, **fields: Any) -> None:
        ev = {"t": round(time.time(), 6), "kind": str(kind)}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def last(self, kind: str) -> Optional[Dict]:
        with self._lock:
            for ev in reversed(self._ring):
                if ev["kind"] == kind:
                    return ev
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, reason: str, *, directory: Optional[str] = None,
             rank: Optional[int] = None) -> Optional[str]:
        """Write the ring as one JSON object (atomic rename, fsync'd —
        the reader may be a post-mortem on a machine that lost power).
        Repeated dumps overwrite: the LAST record before death wins.
        Returns the path, or None when recording is disabled."""
        if _capacity() == 0:
            return None
        rank = _my_rank() if rank is None else int(rank)
        base = _directory() if directory is None else os.path.abspath(
            directory)
        events = self.events()
        last_step = None
        for ev in reversed(events):
            if "step" in ev:
                last_step = ev["step"]
                break
        record = {
            "rank": rank,
            "reason": str(reason),
            "dumped_at": time.time(),
            "last_step": last_step,
            "n_events": len(events),
            "events": events,
        }
        path = os.path.join(base, FILENAME.format(rank=rank))
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(base, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(record, f)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            # Dumping is a courtesy on a dying process — never let the
            # post-mortem writer mask the original failure.
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        with self._lock:
            self._dumps += 1
        return path


_recorder = FlightRecorder(_capacity())
_crash_hooks: List[Callable[[], Any]] = []
_hooks_lock = threading.Lock()
_installed = False


def recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, **fields: Any) -> None:
    """Append one event to the process-default ring (no-op when
    ``HVD_FLIGHTREC_EVENTS=0``)."""
    if _capacity() == 0:
        return
    _recorder.record(kind, **fields)


def dump(reason: str, **kw) -> Optional[str]:
    return _recorder.dump(reason, **kw)


def add_crash_hook(fn: Callable[[], Any]) -> None:
    """Register a flush-style callback to run (best-effort) after the
    fatal-signal dump — e.g. the timeline writer's fsync, so a killed
    rank's trace survives alongside its flight record."""
    with _hooks_lock:
        if fn not in _crash_hooks:
            _crash_hooks.append(fn)


def remove_crash_hook(fn: Callable[[], Any]) -> None:
    with _hooks_lock:
        try:
            _crash_hooks.remove(fn)
        except ValueError:
            pass


def run_crash_hooks() -> None:
    with _hooks_lock:
        hooks = list(_crash_hooks)
    for fn in hooks:
        try:
            fn()
        except Exception:  # noqa: BLE001 — a dying process keeps dying
            pass


def _on_fatal(signum, frame):
    record("signal", signum=int(signum))
    dump(reason=f"fatal signal {int(signum)}")
    run_crash_hooks()
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    # Default disposition: restore it and re-deliver so the exit status
    # still says "killed by signal" (supervisors key on that).
    _signal.signal(signum, _signal.SIG_DFL)
    os.kill(os.getpid(), signum)


_prev_handlers: Dict[int, Any] = {}


def install_signal_dump() -> bool:
    """Install the SIGTERM dump hook (idempotent; main thread only —
    returns False elsewhere or when a prior non-default handler would be
    better left alone is NOT a concern: we chain to it)."""
    global _installed
    if _installed or _capacity() == 0:
        return _installed
    try:
        prev = _signal.getsignal(_signal.SIGTERM)
        _prev_handlers[_signal.SIGTERM] = (
            prev if callable(prev) and prev not in (
                _signal.SIG_DFL, _signal.SIG_IGN) else None)
        _signal.signal(_signal.SIGTERM, _on_fatal)
        _installed = True
    except (ValueError, OSError):
        # Not the main thread (jupyter, server worker) — the other dump
        # triggers (abort / shutdown(error=) / fault injector) still run.
        return False
    return True
