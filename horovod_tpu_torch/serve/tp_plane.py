"""The step plane of an engine served under a tp mesh.

The JAX package serves a model too big for one chip from one controller:
its engine's device programs run on every device of the tp mesh at once.
The port runs one process per GPU, so a tp group serves as a leader and
its followers. Every rank builds the same engine with the same arguments
(a launcher script). The group's rank 0, the **leader**, runs the
engine's loop unchanged: it admits, schedules, samples and answers.
Before each call that touches device state it broadcasts a small
descriptor to the other ranks, the **followers**: the op's name and its
host arguments (tokens, positions, block tables, slot, lengths, the
write and read rows, block ids, adapter rows). Each follower then runs
the same call on its shards, so every rank issues the same collectives
(the row-parallel sums of the forwards) in the same order. After those
sums every rank holds bitwise the same hidden states; only the leader
copies logits to the host.

The wire is a gloo group over the tp ranks, created with the plane
(collective over the world). A descriptor is a fixed ``int64[4]`` header
``(kind, seq, nbytes, 0)`` broadcast from the leader, then, for a call,
its pickled ``(op, args)`` payload of ``nbytes`` bytes. ``kind`` is
:data:`CALL`, :data:`BEAT` (the idle leader's heartbeat), :data:`STOP`
(the leader's loop ended: followers return) or :data:`ABORT` (the
leader failed after a descriptor went out: followers raise). ``seq``
counts descriptors, so a follower that lost step with its leader raises
instead of running the wrong op.

**One thread at a time issues collectives on the tp group**: on the
leader, the thread holding the plane's :attr:`StepPlane.lock` — the
engine's loop thread, or a caller's ``warmup()`` — which the engine
holds across a descriptor and the device call it announces, so the
followers see the calls in the order the leader ran them; on a
follower, its loop. No other thread may run a forward of the tp model.

**Nothing waits without a bound.** The plane's group has the world's
collective timeout (:attr:`~..runtime.World.timeout_s`, set by
``init(timeout=)`` or by the adopted group), the one bound of a tp group:
it also ends a rank's wait inside a forward's row-parallel sum. An idle
leader sends a heartbeat every quarter of it,
so a follower waiting for the next descriptor gives up only when the
leader is gone or wedged. A peer's death surfaces as the runtime's
errors (:func:`~..runtime.peer_failures`): :class:`~..exceptions.
WorkerFailureError` when its sockets close, :class:`~..exceptions.
StalledError` past the timeout. A failure on the leader after a
descriptor went out leaves the followers' collectives unmatched, so the
plane goes down for good (every later call raises the first error), and
the leader sends :data:`ABORT` where the followers can still hear it;
where they cannot (they wait inside a collective), the process group's
timeout ends their wait.
"""

from __future__ import annotations

import datetime
import pickle
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from .. import runtime
from ..exceptions import TransportError
from ..parallel.transformer import serving_tp

CALL, BEAT, STOP, ABORT = 1, 2, 3, 4


class StepPlane:
    """The descriptor channel of one tp group (see the module docstring).

    Args:
      mesh: the model's mesh; its ``tp`` axis is the group. Every rank of
        the world must construct the plane at the same point (it creates
        a process group). Every wait is bounded by the world's timeout.

    Counters (read on either role): ``calls``, ``beats``,
    ``payload_bytes`` and ``send_s`` (the leader's host seconds spent
    broadcasting descriptors, or a follower's waiting for them).
    """

    def __init__(self, mesh):
        ranks = list(mesh.ranks["tp"])
        self.tp = len(ranks)
        self.leader_rank = ranks[0]
        self.is_leader = mesh.coords["tp"] == 0
        self.timeout_s = runtime.world().timeout_s
        #: The world's backend, which carries the forwards' row-parallel
        #: sums (the plane's own group is gloo).
        self.backend = runtime.world().backend
        self.beat_s = self.timeout_s / 4
        self._group = dist.new_group(
            ranks, backend="gloo",
            timeout=datetime.timedelta(seconds=self.timeout_s))
        self._seq = 0
        self._error: Optional[BaseException] = None
        self._stopped = False
        self._lock = threading.Lock()
        #: Held by the leader's engine across a descriptor and the call
        #: it announces (reentrant: every send takes it too).
        self.lock = threading.RLock()
        self.calls = 0
        self.beats = 0
        self.payload_bytes = 0
        self.send_s = 0.0

    def _raise_if_down(self) -> None:
        err = self._error
        if err is not None:
            raise TransportError(
                f"the tp step plane is down since an earlier failure: "
                f"{err!r}") from err
        if self._stopped:
            raise TransportError("the tp step plane was stopped")

    def _bcast(self, t: torch.Tensor) -> None:
        with runtime.peer_failures():
            dist.broadcast(t, src=self.leader_rank, group=self._group)

    # -- the leader ---------------------------------------------------------

    def _send(self, kind: int, payload: bytes = b"") -> None:
        with self.lock:
            t0 = time.perf_counter()
            self._seq += 1
            head = torch.tensor([kind, self._seq, len(payload), 0],
                                dtype=torch.int64)
            try:
                self._bcast(head)
                if payload:
                    self._bcast(torch.frombuffer(bytearray(payload),
                                                 dtype=torch.uint8))
            except BaseException as e:
                self.fail(e, notify=False)
                raise
            self.send_s += time.perf_counter() - t0
            self.payload_bytes += len(payload)

    def call(self, op: str, args: Dict[str, Any]) -> None:
        """Send one device call to the followers (the leader's loop
        thread only; raises once the plane is down)."""
        self._raise_if_down()
        self.calls += 1
        self._send(CALL, pickle.dumps((op, args),
                                      protocol=pickle.HIGHEST_PROTOCOL))

    def run(self, op: str, args: Dict[str, Any], fn: Callable[[], Any]):
        """The leader's device call: send ``op`` to the followers, then
        ``fn()`` here, under :attr:`lock`. A failure of ``fn`` takes the
        plane down (the followers' collectives are left unmatched)."""
        with self.lock:
            self.call(op, args)
            try:
                with runtime.peer_failures():
                    return fn()
            except BaseException as e:
                self.fail(e)
                raise

    def beat(self) -> None:
        """The idle leader's heartbeat (a no-op once the plane is down)."""
        with self.lock:
            if self._error is None and not self._stopped:
                self.beats += 1
                self._send(BEAT)

    def stop(self) -> None:
        """Release the followers: their loops return. Idempotent; a plane
        that is down has nothing to release."""
        with self._lock:
            if self._stopped or self._error is not None:
                return
            self._stopped = True
        try:
            self._send(STOP)
        except BaseException:   # noqa: BLE001 — the followers are gone
            pass

    def fail(self, exc: BaseException, notify: bool = True) -> None:
        """Take the plane down after ``exc`` (the first error is kept).
        With ``notify``, send :data:`ABORT` so followers waiting for a
        descriptor raise at once (best effort: a follower inside a
        collective ends through the timeout)."""
        with self._lock:
            if self._error is not None or self._stopped:
                return
            self._error = exc
        if notify:
            try:
                with self.lock:
                    self._seq += 1
                    self._bcast(torch.tensor([ABORT, self._seq, 0, 0],
                                             dtype=torch.int64))
            except BaseException:   # noqa: BLE001 — best effort
                pass

    # -- a follower ---------------------------------------------------------

    def serve(self, run: Callable[[str, Dict[str, Any]], Any]) -> None:
        """The follower's loop: receive descriptors and ``run(op, args)``
        each call, until the leader stops the plane (returns), aborts it
        or a collective fails (raises the runtime's error)."""
        if self.is_leader:
            raise ValueError("serve() runs on a follower; the leader sends")
        head = torch.empty(4, dtype=torch.int64)
        while True:
            t0 = time.perf_counter()
            try:
                self._bcast(head)
                kind, seq, nbytes, _ = (int(x) for x in head.tolist())
                if seq != self._seq + 1:
                    raise TransportError(
                        f"tp step plane out of step: descriptor {seq} "
                        f"after {self._seq} (the leader and this rank ran "
                        f"different calls)")
                self._seq = seq
                if kind == STOP:
                    self._stopped = True
                    return
                if kind == ABORT:
                    raise TransportError(
                        f"the tp leader (rank {self.leader_rank}) aborted "
                        f"the step plane after a failure")
                if kind == BEAT:
                    self.beats += 1
                    continue
                if kind != CALL:
                    raise TransportError(f"unknown descriptor kind {kind}")
                buf = torch.empty(nbytes, dtype=torch.uint8)
                self._bcast(buf)
                self.send_s += time.perf_counter() - t0
                self.payload_bytes += nbytes
                op, args = pickle.loads(buf.numpy().tobytes())
            except BaseException as e:
                with self._lock:
                    if self._error is None:
                        self._error = e
                raise
            self.calls += 1
            try:
                run(op, args)
            except BaseException as e:
                with self._lock:
                    if self._error is None:
                        self._error = e
                raise

    def stats(self) -> Dict[str, Any]:
        return {"role": "leader" if self.is_leader else "follower",
                "tp": self.tp, "leader_rank": self.leader_rank,
                "calls": self.calls, "beats": self.beats,
                "payload_bytes": self.payload_bytes,
                "send_ms": self.send_s * 1e3,
                "timeout_s": self.timeout_s, "backend": self.backend,
                "error": None if self._error is None else repr(self._error)}


def plane_for(mesh, what: str) -> Optional[StepPlane]:
    """The step plane of an engine over ``mesh``'s tp axis, None off a
    mesh and at tp 1 (one rank: nothing to send). Refuses a mesh whose
    dp, pp, ep or sp axis is above 1 (``ValueError`` naming it)."""
    if serving_tp(mesh, what) == 1:
        return None
    return StepPlane(mesh)


class TpRole:
    """The leader/follower role an engine takes on a tp mesh, shared by
    :class:`~.generate.GenerationEngine` and :class:`~.engine.Engine`.
    The host sets ``_plane`` (:func:`plane_for`) and ``_thread`` (its loop
    on the leader, :meth:`_follow` on a follower), and keeps
    ``_closed``."""

    _plane: Optional[StepPlane] = None
    _follow_error: Optional[BaseException] = None

    @property
    def is_leader(self) -> bool:
        """Whether this rank serves: off a tp mesh, or the tp group's
        rank 0."""
        return self._plane is None or self._plane.is_leader

    @property
    def plane_error(self) -> Optional[BaseException]:
        """The error that took this rank's step plane down: a peer's
        death or silence, or a failed call after its descriptor went out
        (None while the plane is up, and off a mesh)."""
        return None if self._plane is None else self._plane._error

    @property
    def leader_rank(self) -> Optional[int]:
        """The global rank of the tp group's leader (None off a mesh)."""
        return None if self._plane is None else self._plane.leader_rank

    def _leader_only(self, what: str) -> None:
        if not self.is_leader:
            raise ValueError(
                f"{what} runs on the tp leader (global rank "
                f"{self.leader_rank}); this rank follows it and serves no "
                f"requests — call wait() here")

    def _follow(self, run: Callable[[str, Dict[str, Any]], Any],
                device: torch.device) -> None:
        """A follower's loop: ``run(op, args)`` for each call the leader
        sends, until it stops (or the plane fails: :meth:`wait` raises
        the error)."""
        if device.type == "cuda":
            torch.cuda.set_device(device)
        try:
            self._plane.serve(run)
        except BaseException as e:  # noqa: BLE001 — wait() raises it
            self._follow_error = e
        finally:
            self._closed = True

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until this engine's loop has ended: on a follower, until
        the leader stops the plane (raising the error that ended it
        otherwise: the leader's death or silence past the world's
        timeout); on the leader, until :meth:`shutdown` has drained it.
        Raises ``TimeoutError`` when the loop still runs after
        ``timeout``."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"the engine's loop still runs after "
                               f"{timeout} s")
        if self._follow_error is not None:
            raise self._follow_error

    def _shutdown_follower(self, timeout: float) -> bool:
        """On a follower, :meth:`shutdown`'s whole work: wait up to
        ``timeout`` for the leader to stop the plane. False on the
        leader."""
        if self.is_leader:
            return False
        self._thread.join(timeout)
        return True

    def _stop_followers(self) -> None:
        """The leader's loop ended on its own terms: release the
        followers (nothing to do off a mesh)."""
        if self._plane is not None:
            self._plane.stop()

    def _tp_stats(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """``snap`` with the plane's counters under ``"tp"`` on a mesh."""
        if self._plane is not None:
            snap["tp"] = self._plane.stats()
        return snap
