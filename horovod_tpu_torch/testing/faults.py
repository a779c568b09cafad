"""Deterministic fault injection, driven by ``HVD_FAULT_SPEC``.

The fault-tolerance subsystem (heartbeats, world abort, supervised
restart, elastic recovery) is only trustworthy if every failure path can
be exercised on CPU in CI — the reference had no way to kill a rank
deterministically, so its stall handling shipped warn-only and untested.
This module turns an env spec into precise failures:

    HVD_FAULT_SPEC=rank=2:kill@step=3          # SIGKILL rank 2 at step 3
    HVD_FAULT_SPEC=rank=1:mute@step=2          # rank 1 goes silent (alive)
    HVD_FAULT_SPEC=coord:mute@step=2           # coordinator stops acking
    HVD_FAULT_SPEC=coord:delay_ms=50           # slow coordination plane
    HVD_FAULT_SPEC=rank=0:exit@step=4@epoch=1  # only on restart epoch 1
    HVD_FAULT_SPEC=ckpt:truncate@step=5        # tear the step-5 checkpoint
    HVD_FAULT_SPEC=ckpt:flip@step=5            # flip one byte in it
    HVD_FAULT_SPEC=ckpt:drop_marker@step=5     # lose its commit marker
    HVD_FAULT_SPEC=resize:shrink=2@step=3      # live-shrink the world by 2
    HVD_FAULT_SPEC=resize:grow=4@step=3        # live-grow the world by 4
    HVD_FAULT_SPEC=resize:world=2@step=3       # live-resize to exactly 2
    HVD_FAULT_SPEC=replica_kill=r1@stream=3    # serving: kill replica r1's
                                               #   engine loop at its 3rd stream
    HVD_FAULT_SPEC=replica_hang=r0@stream=2    # serving: hang the loop instead
    HVD_FAULT_SPEC=replica_proc_kill=r1@stream=3  # serving: SIGKILL the
                                               #   subprocess replica's worker
    HVD_FAULT_SPEC=slow_step=50                # serving: 50 ms per decode step

Grammar: comma-separated clauses, each ``rank=<r>:<action>@step=<s>``,
``coord:mute@step=<s>`` / ``coord:delay_ms=<n>``,
``ckpt:<truncate|flip|drop_marker>@step=<s>``,
``resize:<shrink|grow|world>=<k>@step=<s>``, or a serving-plane clause
``replica_kill=<name>@stream=<k>`` / ``replica_hang=<name>@stream=<k>``
/ ``replica_proc_kill=<name>@stream=<k>`` / ``slow_step=<ms>``.
Step-scoped actions
REQUIRE ``@step`` (a clause that could never fire is rejected loudly);
``delay_ms`` is unconditional — it has no step context and rejects
``@step``. Every clause takes an optional ``@epoch=<e>`` suffix
(default 0) matched against ``HVD_RESTART_EPOCH`` — so a kill drill fires
on the first launch and NOT again after ``tpurun --restarts`` relaunches
the world.

``ckpt`` clauses fire from :func:`ckpt_hook`, which
``elastic.ElasticState`` calls right after each two-phase commit; the
serving-plane clauses from :func:`serve_hook`, which every
``GenerationEngine`` loop iteration calls. The ``resize`` clauses belong
to a plane the port has not ported yet (live resize): they parse, so one
spec serves both packages, and fire once that plane calls its hook.

Actions:

* ``kill``  — ``SIGKILL`` this process: the kernel closes its sockets, the
  coordinator sees the disconnect and aborts the world (fast path).
* ``exit``  — ``os._exit(1)``: same, with a nonzero code of our choosing.
* ``hang``  — sleep forever while heartbeats keep flowing: the *stall*
  scenario (``HOROVOD_STALL_TIMEOUT`` / stall warnings), not a death.
* ``mute``  — stop heartbeats, then sleep forever: the process and its
  socket stay alive but the rank goes silent on the liveness plane — the
  only way to exercise the ``HVD_HEARTBEAT_TIMEOUT`` abort path (a kill
  trips the faster disconnect path instead).
* ``delay_ms=<n>`` — (``coord`` target) sleep ``n`` ms in every
  coordination-plane submit, simulating a slow/congested control plane.
* ``mute`` on the ``coord`` target — rank 0 stops acking heartbeats, so
  every client independently detects a dead coordinator.

* ``truncate`` / ``flip`` (``ckpt`` target) — cut the committed
  checkpoint's largest params leaf file to half its size, or add one to
  the middle byte of its array data: either fails
  ``verify_checkpoint``. ``drop_marker`` deletes the commit marker.

Hooks: :func:`step_hook` is called once per training step by
``Trainer.fit``, :func:`ckpt_hook` after each elastic commit,
:func:`serve_hook` once per serving-engine loop iteration,
:func:`coord_delay` in every coordination-plane submit; all are
near-zero-cost no-ops when ``HVD_FAULT_SPEC`` is unset.

This is a copy of the JAX package's ``testing/faults.py``. The parser
takes the whole grammar, so one spec serves both packages; the hook of
the plane the port has not ported yet (live resize) comes with that
plane, and until then its clauses never fire. The corruption acts on the
port's checkpoint format (one ``.npy`` file a leaf) where the JAX
package's acts on its own. ``mute`` and ``coord:mute`` act on the
coordination plane of a coordinated world (``runtime.World.coord``); in
a plain world, which has no heartbeats, ``mute`` parks the rank like
``hang`` and ``coord:mute`` does nothing.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import List, Optional

ENV_VAR = "HVD_FAULT_SPEC"

_ACTIONS = ("kill", "exit", "hang", "mute", "delay_ms",
            "truncate", "flip", "drop_marker",
            "shrink", "grow", "world")
_CKPT_ACTIONS = ("truncate", "flip", "drop_marker")
_RESIZE_ACTIONS = ("shrink", "grow", "world")
_SERVE_ACTIONS = ("replica_kill", "replica_hang", "replica_proc_kill",
                  "slow_step")


@dataclasses.dataclass(frozen=True)
class Fault:
    target: str              # "rank", "coord", "ckpt", "resize" or "serve"
    rank: Optional[int]      # rank the fault applies to (None for coord)
    action: str              # one of _ACTIONS / _SERVE_ACTIONS
    step: Optional[int]      # fire at this step (None = unconditional)
    epoch: int = 0           # fire only on this HVD_RESTART_EPOCH
    value: int = 0           # delay_ms / slow_step payload
    name: Optional[str] = None    # serving replica name (serve target)
    stream: Optional[int] = None  # fire at this admitted-stream count


class FaultSpecError(ValueError):
    """Malformed ``HVD_FAULT_SPEC`` — loud, like every other env knob."""


def _parse_serve_clause(clause: str) -> Fault:
    """One serving-plane clause: ``replica_kill=<name>@stream=<k>`` /
    ``replica_hang=<name>@stream=<k>`` /
    ``replica_proc_kill=<name>@stream=<k>`` (real SIGKILL of a
    subprocess replica's worker) / ``slow_step=<ms>`` — same
    loud-validation standard as the training-plane grammar (a drill
    that could never fire is a spec bug, not a no-op)."""
    parts = clause.split("@")
    action, _, val = parts[0].partition("=")
    stream: Optional[int] = None
    epoch = 0
    for cond in parts[1:]:
        key, _, cval = cond.partition("=")
        try:
            if key == "stream":
                stream = int(cval)
            elif key == "epoch":
                epoch = int(cval)
            else:
                raise FaultSpecError(
                    f"{ENV_VAR}: unknown condition {cond!r} in clause "
                    f"{clause!r} (expected stream=<k> or epoch=<n>)")
        except ValueError:
            raise FaultSpecError(
                f"{ENV_VAR}: bad condition {cond!r} in clause "
                f"{clause!r}") from None
    if action == "slow_step":
        try:
            ms = int(val)
        except ValueError:
            raise FaultSpecError(
                f"{ENV_VAR}: bad delay in clause {clause!r} (expected "
                f"slow_step=<ms>)") from None
        if ms < 1:
            raise FaultSpecError(
                f"{ENV_VAR}: slow_step={ms} in clause {clause!r} — the "
                f"per-step delay must be >= 1 ms")
        if stream is not None:
            # The delay applies to EVERY loop iteration on EVERY replica
            # (a slow chip, not an event); accepting @stream would
            # silently drop the condition.
            raise FaultSpecError(
                f"{ENV_VAR}: slow_step does not support @stream (clause "
                f"{clause!r}) — the delay applies to every engine loop "
                f"iteration")
        return Fault(target="serve", rank=None, action="slow_step",
                     step=None, epoch=epoch, value=ms)
    if not val:
        raise FaultSpecError(
            f"{ENV_VAR}: clause {clause!r} — {action} needs a replica "
            f"name ({action}=<name>@stream=<k>)")
    if stream is None or stream < 1:
        # serve_hook fires on an admitted-stream count, so a clause
        # without @stream>=1 could never fire deterministically.
        raise FaultSpecError(
            f"{ENV_VAR}: {action} requires @stream=<k> with k >= 1 "
            f"(clause {clause!r}); the kill must land on a definite "
            f"stream to be a drill")
    return Fault(target="serve", rank=None, action=action, step=None,
                 epoch=epoch, name=val, stream=stream)


def parse_spec(text: str) -> List[Fault]:
    faults: List[Fault] = []
    for clause in filter(None, (c.strip() for c in text.split(","))):
        if any(clause.startswith(a + "=") for a in _SERVE_ACTIONS):
            # Serving-plane clauses carry no '<target>:' prefix — the
            # action name IS the discriminator.
            faults.append(_parse_serve_clause(clause))
            continue
        target, _, rest = clause.partition(":")
        rank: Optional[int] = None
        if target.startswith("rank="):
            try:
                rank = int(target[len("rank="):])
            except ValueError:
                raise FaultSpecError(
                    f"{ENV_VAR}: bad rank in clause {clause!r}") from None
            target = "rank"
        elif target not in ("coord", "ckpt", "resize"):
            raise FaultSpecError(
                f"{ENV_VAR}: clause {clause!r} must start with "
                f"'rank=<r>:', 'coord:', 'ckpt:' or 'resize:'")
        if not rest:
            raise FaultSpecError(f"{ENV_VAR}: clause {clause!r} has no action")
        parts = rest.split("@")
        action, step, epoch, value = parts[0], None, 0, 0
        if action.startswith("delay_ms="):
            try:
                value = int(action[len("delay_ms="):])
            except ValueError:
                raise FaultSpecError(
                    f"{ENV_VAR}: bad delay in clause {clause!r}") from None
            action = "delay_ms"
        elif any(action.startswith(a + "=") for a in _RESIZE_ACTIONS):
            key, _, val = action.partition("=")
            try:
                value = int(val)
            except ValueError:
                raise FaultSpecError(
                    f"{ENV_VAR}: bad {key} value in clause {clause!r} "
                    f"(expected {key}=<positive int>)") from None
            if value < 1:
                raise FaultSpecError(
                    f"{ENV_VAR}: {key}={value} in clause {clause!r} — a "
                    f"resize delta/target must be >= 1 (a world cannot "
                    f"shrink by zero or resize to zero ranks)")
            action = key
        elif action in _RESIZE_ACTIONS:
            raise FaultSpecError(
                f"{ENV_VAR}: clause {clause!r} — {action} needs a value "
                f"({action}=<k>); a resize with no size tests nothing")
        if action not in _ACTIONS:
            raise FaultSpecError(
                f"{ENV_VAR}: unknown action {action!r} in clause "
                f"{clause!r}; expected one of {_ACTIONS}")
        for cond in parts[1:]:
            key, _, val = cond.partition("=")
            try:
                if key == "step":
                    step = int(val)
                elif key == "epoch":
                    epoch = int(val)
                else:
                    raise FaultSpecError(
                        f"{ENV_VAR}: unknown condition {cond!r} in clause "
                        f"{clause!r} (expected step=<n> or epoch=<n>)")
            except ValueError:
                raise FaultSpecError(
                    f"{ENV_VAR}: bad condition {cond!r} in clause "
                    f"{clause!r}") from None
        if target == "rank" and rank is None:
            raise FaultSpecError(
                f"{ENV_VAR}: rank clause {clause!r} missing rank number")
        if (action in _CKPT_ACTIONS) != (target == "ckpt"):
            # Checkpoint corruption only makes sense on the ckpt target
            # (it fires from the commit hook, not the step hook), and the
            # ckpt target supports nothing else.
            raise FaultSpecError(
                f"{ENV_VAR}: clause {clause!r} — actions {_CKPT_ACTIONS} "
                f"require (and are the only actions of) the 'ckpt:' "
                f"target")
        if (action in _RESIZE_ACTIONS) != (target == "resize"):
            # Same discipline for the resize plane: shrink/grow/world fire
            # from the step-boundary resize hook, not the rank/coord/ckpt
            # hooks, and the resize target supports nothing else (killing
            # a rank is a failure, not a resize).
            raise FaultSpecError(
                f"{ENV_VAR}: clause {clause!r} — actions {_RESIZE_ACTIONS} "
                f"require (and are the only actions of) the 'resize:' "
                f"target")
        if action == "delay_ms" and step is not None:
            # The delay applies to EVERY submit (there is no step context
            # inside the coordination-plane client); accepting @step here
            # would silently drop the condition.
            raise FaultSpecError(
                f"{ENV_VAR}: delay_ms does not support @step (clause "
                f"{clause!r}) — the delay applies to every "
                f"coordination-plane submit")
        if action != "delay_ms" and step is None:
            # step_hook only fires on an exact step match, so a clause
            # without @step could never fire — a drill that silently
            # tests nothing. Same loud-validation standard as above.
            raise FaultSpecError(
                f"{ENV_VAR}: {action} requires @step=<n> (clause "
                f"{clause!r}); without it the fault would never fire")
        faults.append(Fault(target=target, rank=rank, action=action,
                            step=step, epoch=epoch, value=value))
    return faults


# Parsed-spec cache keyed by the raw env value, so tests can mutate the
# env between worlds while the hot no-fault path stays one dict lookup.
_cache: dict = {}
_fired: set = set()


def _active() -> List[Fault]:
    raw = os.environ.get(ENV_VAR) or ""
    if raw not in _cache:
        _cache[raw] = parse_spec(raw) if raw else []
    return _cache[raw]


def _restart_epoch() -> int:
    from ..utils import config as _config
    return _config.restart_epoch()


def _my_rank() -> int:
    from .. import runtime
    from ..utils import config as _config
    if runtime.is_initialized():
        return runtime.process_index()
    return _config.launcher_rank(default=0)


def _fire(fault: Fault) -> None:
    tag = f"epoch {_restart_epoch()} step {fault.step}"
    from ..obs import flightrec
    flightrec.record("fault", action=fault.action, rank=_my_rank(),
                     step=fault.step)
    if fault.action in ("kill", "exit"):
        # Flight-recorder dump BEFORE the trigger: SIGKILL is untrappable
        # by the kernel's contract, so the drilled rank's own ring would
        # otherwise be lost. A real preemption delivers SIGTERM first
        # (which the obs.flightrec signal hook catches); the injector
        # stands in for that notice — the drill's "dead" rank leaves the
        # same hvd_flightrec.rank{N}.json a preempted rank would, naming
        # its final completed step. Survivors additionally dump on the
        # WorkerFailureError the abort hands them.
        flightrec.dump(reason=f"fault injection: {fault.action} at {tag}")
        flightrec.run_crash_hooks()
    if fault.action == "kill":
        print(f"[faults] rank {_my_rank()}: SIGKILL at {tag}", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    elif fault.action == "exit":
        print(f"[faults] rank {_my_rank()}: exit(1) at {tag}", flush=True)
        os._exit(1)
    elif fault.action in ("hang", "mute"):
        client = None
        from .. import runtime
        if runtime.is_initialized():
            client = runtime.world().coord
        if fault.action == "mute":
            if fault.target == "coord":
                if client is not None:
                    print(f"[faults] rank {_my_rank()}: coordinator mutes "
                          f"heartbeat-acks at {tag}", flush=True)
                    client.mute_coordinator_acks(True)
                return  # the coordinator keeps serving; clients abort
            if client is not None:
                client.mute_heartbeats(True)
        print(f"[faults] rank {_my_rank()}: {fault.action} (sleeping "
              f"forever) at {tag}", flush=True)
        while True:  # parked until the launcher or the test kills us
            time.sleep(3600)


def step_hook(step: int) -> None:
    """Fire any fault scoped to this process at training step ``step``.

    Called by ``Trainer.fit`` after each batch and by elastic training
    loops; a no-op (one dict lookup) unless ``HVD_FAULT_SPEC`` is set.
    """
    faults = _active()
    if not faults:
        return
    epoch = _restart_epoch()
    for i, f in enumerate(faults):
        if f.target in ("ckpt", "resize", "serve"):
            continue  # those planes' own hooks fire them
        if f.action == "delay_ms" or f.step != step or f.epoch != epoch:
            continue
        if f.target == "rank" and f.rank != _my_rank():
            continue
        if f.target == "coord" and _my_rank() != 0:
            continue  # the coordinator lives in rank 0's process
        key = (i, epoch)
        if key in _fired:
            continue
        _fired.add(key)
        _fire(f)


def _ckpt_data_file(ckpt_dir: str) -> Optional[str]:
    """The corruption target: the largest ``.params`` leaf file of the
    checkpoint's index (the first of equal sizes, in the index's leaf
    order), or None when the checkpoint is unreadable or has none."""
    from ..exceptions import CheckpointCorruptError
    from ..parallel import checkpoint as _ckpt
    try:
        leaves = _ckpt._flatten(_ckpt.read_index(ckpt_dir))
    except CheckpointCorruptError:
        return None
    files = [os.path.join(ckpt_dir, stub.file) for kp, stub in leaves
             if _ckpt.keystr(kp).startswith(("['params']", ".params"))]
    files = [f for f in files if os.path.isfile(f)]
    return max(files, key=os.path.getsize, default=None)


def _data_offset(path: str) -> int:
    """Where a ``.npy`` file's array bytes begin (past its header)."""
    import numpy as np
    with open(path, "rb") as f:
        if np.lib.format.read_magic(f) == (1, 0):
            np.lib.format.read_array_header_1_0(f)
        else:
            np.lib.format.read_array_header_2_0(f)
        return f.tell()


def _corrupt_checkpoint(fault: Fault, ckpt_dir: str, marker: str) -> None:
    tag = f"epoch {_restart_epoch()} step {fault.step}"
    if fault.action == "drop_marker":
        print(f"[faults] rank {_my_rank()}: dropping commit marker "
              f"{os.path.basename(marker)} at {tag}", flush=True)
        try:
            os.unlink(marker)
        except OSError:
            pass
        return
    victim = _ckpt_data_file(ckpt_dir)
    if victim is None:
        print(f"[faults] rank {_my_rank()}: no data file to corrupt "
              f"under {ckpt_dir} at {tag}", flush=True)
        return
    size = os.path.getsize(victim)
    rel = os.path.relpath(victim, ckpt_dir)
    if fault.action == "truncate":
        print(f"[faults] rank {_my_rank()}: truncating {rel} "
              f"{size}->{size // 2} bytes at {tag}", flush=True)
        with open(victim, "r+b") as f:
            f.truncate(size // 2)
        return
    start = _data_offset(victim)
    off = start + (size - start) // 2
    with open(victim, "r+b") as f:
        f.seek(off)
        b = f.read(1) or b"\x00"
        f.seek(off)
        # Increment, not XOR, as the JAX package's hook does.
        f.write(bytes([(b[0] + 1) & 0xFF]))
    print(f"[faults] rank {_my_rank()}: flipped byte {off} of {rel} at "
          f"{tag}", flush=True)


def ckpt_hook(step: int, ckpt_dir: str, marker: str) -> None:
    """Fire any ``ckpt:*`` clause scoped to the checkpoint just committed
    at ``step``. Called by ``ElasticState`` right after the two-phase
    commit finished (bytes, manifest and marker all durable), so the
    corruption models post-commit rot: the marker keeps promising bytes
    the disk no longer holds, which the verified fallback walk must
    survive. A no-op (one dict lookup) unless ``HVD_FAULT_SPEC`` has a
    ``ckpt:`` clause."""
    faults = _active()
    if not faults:
        return
    epoch = _restart_epoch()
    for i, f in enumerate(faults):
        if f.target != "ckpt" or f.step != step or f.epoch != epoch:
            continue
        key = (i, epoch)
        if key in _fired:
            continue
        _fired.add(key)
        _corrupt_checkpoint(f, ckpt_dir, marker)


def serve_hook(replica: str, streams_admitted: int) -> Optional[str]:
    """Fire any serving-plane clause scoped to engine ``replica``. Called
    once per :class:`~horovod_tpu_torch.serve.generate.GenerationEngine`
    loop iteration (a near-zero-cost no-op unless the spec has a serve
    clause). Returns ``"kill"`` (the loop must die abruptly, stranding
    its handles: the failover drill), ``"proc_kill"`` (the loop must
    SIGKILL its own process after dumping a post-mortem: the subprocess
    replica drill, whose parent sees a dead pid), ``"hang"`` (the loop
    must park forever with its thread alive: only a stale-beat liveness
    probe catches it), or None. ``slow_step`` clauses sleep here, every
    call.

    ``streams_admitted`` is the replica's cumulative count of streams
    admitted into decode slots; a ``@stream=k`` clause fires once that
    count reaches k, i.e. with stream k mid-flight, deterministically.
    """
    faults = _active()
    if not faults:
        return None
    epoch = _restart_epoch()
    out: Optional[str] = None
    for i, f in enumerate(faults):
        if f.target != "serve" or f.epoch != epoch:
            continue
        if f.action == "slow_step":
            time.sleep(f.value / 1000.0)
            continue
        if f.name != replica or streams_admitted < (f.stream or 0):
            continue
        key = (i, epoch)
        if key in _fired:
            continue
        _fired.add(key)
        from ..obs import flightrec
        flightrec.record("fault", action=f.action, replica=replica,
                         stream=f.stream)
        print(f"[faults] serving replica {replica}: {f.action} at "
              f"admitted stream {f.stream} (epoch {epoch})", flush=True)
        out = {"replica_kill": "kill",
               "replica_proc_kill": "proc_kill"}.get(f.action, "hang")
    return out


def coord_delay() -> None:
    """Sleep per ``coord:delay_ms=<n>``: called from every
    coordination-plane submit; a no-op unless the spec targets the
    coordinator."""
    faults = _active()
    if not faults:
        return
    epoch = _restart_epoch()
    for f in faults:
        if (f.target == "coord" and f.action == "delay_ms"
                and f.epoch == epoch):
            time.sleep(f.value / 1000.0)


def reset() -> None:
    """Forget which faults already fired (tests re-run drills in one
    process; production worlds never need this)."""
    _fired.clear()
