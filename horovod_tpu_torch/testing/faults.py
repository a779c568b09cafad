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

``ckpt``, ``resize`` and serving-plane clauses belong to planes the
port has not ported yet (elastic recovery's commit marker, live resize,
the serving fleet): they parse, so one spec serves both packages, and
fire once those planes call their hooks.

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

Hook: :func:`step_hook` is called once per training step by
``Trainer.fit``, a near-zero-cost no-op when ``HVD_FAULT_SPEC`` is unset.

This is a copy of the JAX package's ``testing/faults.py``. The parser
takes the whole grammar, so one spec serves both packages; the hooks of
the planes the port has not ported yet (the checkpoint commit marker of
elastic recovery, live resize, the serving fleet, the coordination
plane) come with those planes, and until then their clauses never fire.
The port has no heartbeat plane yet, so ``mute`` parks the rank like
``hang`` does.
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
        if fault.action == "mute" and fault.target == "coord":
            return  # no coordinator to mute in a torch.distributed world
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


def reset() -> None:
    """Forget which faults already fired (tests re-run drills in one
    process; production worlds never need this)."""
    _fired.clear()
