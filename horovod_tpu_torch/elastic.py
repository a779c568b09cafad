"""Elastic recovery: commit the training state, and resume it after the
launcher relaunches a failed world.

Port of the JAX package's ``elastic.py`` (``ElasticState`` :77-372,
``run_with_recovery`` :1026-1091) on the port's world, where every rank
is its own process (the JAX package's env world):

* a dead or silent peer surfaces as :class:`WorkerFailureError`,
  :class:`StalledError` or :class:`TransportError`
  (``runtime.peer_failures``), instead of hanging the survivors; in a
  coordinated world (the launcher's, ``HVD_COORD_ADDR``) the
  coordinator's abort — a disconnect, or no heartbeat for
  ``HVD_HEARTBEAT_TIMEOUT`` — raises :class:`WorkerFailureError` naming
  the dead rank, on the plane's own calls and on the process group's;
* ``python -m horovod_tpu_torch.launcher --restarts N`` tears the world
  down at the first failure and relaunches it, exporting
  ``HVD_RESTART_EPOCH``;
* :class:`ElasticState` commits (params, optimizer state, step) through
  the per-rank checkpoints of :mod:`horovod_tpu_torch.parallel.
  checkpoint`, and :func:`run_with_recovery` restores the newest commit
  every rank holds and can verify, then resumes.

Commits follow CheckFreq's two-phase discipline (Mohan et al., FAST
'21): the checkpoint bytes first, then a ``ckpt_<step>.committed``
marker, fsync'd; a restore trusts only marked steps whose bytes still
match their manifest, walking back past corrupt ones.

Usage (the whole loop runs again after a supervised restart)::

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic

    hvd.init()
    state = elastic.ElasticState(model, optimizer, directory="/tmp/el",
                                 commit_every=1)

    def train(state):
        while state.step < TOTAL_STEPS:
            train_step(state.params, state.opt_state, batch_for(state.step))
            state.advance()        # step += 1, commit on cadence
        return state.params

    model = elastic.run_with_recovery(train, state)

``params`` is the model (its parameters and buffers) and ``opt_state``
its ``DistributedOptimizer`` (or None): both are restored in place.
Live resize (``ResizeCoordinator``, ``resize_join``) is ``ROADMAP.md``
Queue 1 item 15.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Callable, Optional

from . import runtime
from .exceptions import (CheckpointCorruptError, StalledError,
                         TransportError, WorkerFailureError)
from .obs import flightrec as _flightrec
from .obs.registry import registry as _metrics_registry

RECOVERABLE = (WorkerFailureError, StalledError, TransportError)


def _m(kind: str, name: str, help_: str):
    """A named metric of the process-default registry (commits and
    restores are rare: a lookup per event is fine)."""
    return getattr(_metrics_registry(), kind)(name, help_)


def _log(msg: str) -> None:
    """An operator-facing line on stdout, flushed (the stream the
    launcher and the fault drills grep)."""
    print(f"[elastic] {msg}", flush=True)


def restart_epoch() -> int:
    """Which (re)launch of the world this is (``HVD_RESTART_EPOCH``,
    exported by the launcher; 0 when unset or on the first launch)."""
    from .utils import config as _config
    return _config.restart_epoch()


class ElasticState:
    """Committable training state: the model, its optimizer, the step.

    Each rank commits its own tree, with no collective: in a world above
    one rank to ``<directory>/rank_<r>``, each rank owning its markers
    (the JAX package's env-world layout); in a world of one to
    ``directory`` itself. ``directory`` defaults to ``HVD_ELASTIC_DIR``,
    then ``.hvd_elastic``. :meth:`latest_committed` agrees on the newest
    step every rank has committed and verified, so a failure mid-write
    rolls back at most ``commit_every`` steps and never diverges.

    A ZeRO optimizer commits this rank's own shard (not N copies of the
    canonical state), so such a commit restores at the same world size
    only, as the JAX package's env-world commits do; on a hybrid mesh
    the shard is the rank's dp row of its non-scatter block, so it
    restores on the same mesh only (the manifest's ``zero_mesh`` and
    ``zero_coords`` say which). A reshape goes through
    :func:`~.parallel.checkpoint.save_sharded`'s 2-D canonical form."""

    def __init__(self, params: Any, opt_state: Any = None, step: int = 0,
                 *, directory: Optional[str] = None, commit_every: int = 1,
                 max_to_keep: int = 3, writer: Any = None):
        from .utils import config as _config
        self.params = params
        self.opt_state = opt_state
        self.step = int(step)
        self.directory = os.path.abspath(
            directory or _config.elastic_dir() or ".hvd_elastic")
        self.commit_every = max(1, int(commit_every))
        self.max_to_keep = max_to_keep
        # Optional trainer.AsyncCheckpointer: the snapshot happens in
        # commit(), the write on the writer's thread, and the marker hangs
        # off its on_durable hook, strictly after the bytes.
        self.writer = writer
        # Committed-but-corrupt checkpoints the verified walk skipped.
        self.discarded_corrupt = 0
        # Steps THIS rank's walk verified. The cross-rank minimum can land
        # below this rank's own candidate; such a step is verified at
        # restore time.
        self._verified_steps: set = set()

    # -- layout ------------------------------------------------------------
    def _dir(self) -> str:
        if runtime.is_initialized() and runtime.size() > 1:
            return os.path.join(self.directory,
                                f"rank_{runtime.process_index()}")
        return self.directory

    def _marker(self, step: int) -> str:
        return os.path.join(self._dir(), f"ckpt_{int(step)}.committed")

    # -- commit --------------------------------------------------------------
    # Phase 1 writes the checkpoint (leaf files into a temporary directory
    # renamed on completion, then the manifest); phase 2 writes the marker.
    # A rank killed mid-write leaves no marker, and restores consider
    # marked steps only.

    def commit(self) -> str:
        """Commit the current state at ``step``. Synchronous by default
        (durable on return). With a ``writer`` only the device-to-host
        snapshot happens here; the write, the marker and the retention run
        on the writer's thread, durable after :meth:`wait`."""
        from .parallel import checkpoint as _ckpt
        step = self.step
        _m("counter", "hvd_commits_total",
           "Elastic two-phase commits started").inc()
        _flightrec.record("commit", step=step)
        tree = _ckpt.local_tree(self.params, self.opt_state)
        meta = _ckpt.local_meta(self.opt_state)
        base = self._dir()
        timeline = (self.writer.timeline if self.writer is not None else
                    runtime.world().timeline if runtime.is_initialized()
                    else None)
        host = _ckpt.snapshot_to_host(tree, timeline=timeline)

        def write() -> str:
            return _ckpt.save_local(base, step, host,
                                    max_to_keep=self.max_to_keep,
                                    extra_meta=meta)
        path = _ckpt._ckpt_path(base, step)
        if self.writer is None:
            from .utils import timeline as _tl
            with _tl.maybe_op(timeline, "ckpt.write", _tl.CKPT_WRITE):
                write()
            self._mark_durable(step, path)
            return path
        self.writer.submit(write,
                           on_durable=lambda: self._mark_durable(step, path))
        return path

    def _mark_durable(self, step: int, path: str) -> None:
        """Phase 2: the marker, only ever after the bytes of ``step`` are
        written (``save_local`` already applied this rank's retention)."""
        with open(self._marker(step), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        # Drop markers whose checkpoint retention deleted.
        for s in self._marked_steps():
            if not os.path.isdir(os.path.join(self._dir(), f"ckpt_{s}")):
                try:
                    os.unlink(self._marker(s))
                except OSError:
                    pass
        # HVD_FAULT_SPEC's ckpt:* drills fire here, strictly after the
        # commit: a marker promising bytes the disk no longer holds.
        from .testing import faults as _faults
        _faults.ckpt_hook(step, path, self._marker(step))

    def wait(self) -> None:
        """Barrier for async commits: returns once every enqueued commit
        is durable (bytes and marker), re-raising writer errors. A no-op
        without a writer."""
        if self.writer is not None:
            self.writer.wait()

    def advance(self, n: int = 1) -> None:
        """Bump the step counter and commit on the ``commit_every``
        cadence (call once per completed training step)."""
        self.step += n
        if self.step % self.commit_every == 0:
            self.commit()

    # -- the verified walk -------------------------------------------------
    def _marked_steps(self):
        base = self._dir()
        if not os.path.isdir(base):
            return []
        steps = []
        for n in os.listdir(base):
            if n.startswith("ckpt_") and n.endswith(".committed"):
                try:
                    steps.append(int(n[len("ckpt_"):-len(".committed")]))
                except ValueError:
                    continue
        return sorted(steps)

    def _local_latest(self, verify: bool = True) -> Optional[int]:
        """The newest step with a marker, its checkpoint directory and
        (when ``verify``) bytes that match its manifest. A committed step
        that fails verification (truncated, bit-flipped, or corrupted by a
        ``ckpt:*`` drill) is logged, counted in ``discarded_corrupt`` and
        skipped. Each verification reads that checkpoint in full, once
        per restore."""
        from .parallel import checkpoint as _ckpt
        base = self._dir()
        for s in reversed(self._marked_steps()):
            path = os.path.join(base, f"ckpt_{s}")
            if not os.path.isdir(path):
                continue
            if not verify:
                return s
            try:
                _ckpt.verify_checkpoint(path)
            except CheckpointCorruptError as e:
                self.discarded_corrupt += 1
                _m("counter", "hvd_discarded_corrupt_total",
                   "Committed-but-corrupt checkpoints skipped by the "
                   "verified fallback walk").inc()
                _flightrec.record("discard_corrupt", step=s)
                print(f"[elastic] committed step {s} failed integrity "
                      f"verification — discarding and walking back "
                      f"({e})", file=sys.stderr, flush=True)
                continue
            self._verified_steps.add(s)
            return s
        return None

    def latest_committed(self) -> Optional[int]:
        """The newest step EVERY rank has committed and verified (None:
        no common verified commit). Ranks can be one commit apart when a
        failure lands mid-write, so the world's minimum over
        ``allgather_object`` is the step all ranks can restore."""
        self.wait()  # async commits count once durable, not before
        mine = self._local_latest()
        if runtime.is_initialized() and runtime.size() > 1:
            from .ops.collectives import allgather_object
            steps = allgather_object(mine)
            if any(s is None for s in steps):
                return None
            return min(steps)
        return mine

    # -- restore -------------------------------------------------------------
    def restore(self, step: Optional[int] = None) -> "ElasticState":
        """Restore the model, the optimizer and the step from the newest
        common verified commit (or an explicit ``step``), in place.

        With ``step=None`` the restore re-verifies only a step this rank's
        walk did not prove itself; an explicit ``step`` is always
        verified and raises :class:`~horovod_tpu_torch.exceptions.
        CheckpointCorruptError` when its bytes no longer match."""
        self.wait()
        explicit = step is not None
        if step is None:
            step = self.latest_committed()
        if step is None:
            raise FileNotFoundError(
                f"no committed elastic state under {self.directory} "
                f"survived integrity verification"
                if self.discarded_corrupt else
                f"no committed elastic state under {self.directory}")
        self._restore_step(int(step), force_verify=explicit)
        return self

    def _restore_step(self, step: int, force_verify: bool = False) -> None:
        """Restore ``step``, verifying unless this rank's walk already
        proved that step (the one place that decision lives)."""
        from .parallel import checkpoint as _ckpt
        _ckpt.restore_local(
            self._dir(), step, self.params, self.opt_state,
            verify=force_verify or step not in self._verified_steps)
        self.step = int(step)
        _m("counter", "hvd_restores_total",
           "Elastic restores completed (recovery, rollback, resume)"
           ).inc()
        _flightrec.record("restore", step=int(step))


def run_with_recovery(train_fn: Callable[[ElasticState], Any],
                      state: ElasticState):
    """Run ``train_fn(state)`` with checkpoint-recovery semantics.

    Before running, when a committed state exists (always after a
    supervised restart that got past the first commit), restore it so
    ``train_fn`` resumes from the last committed step. When the world
    dies underneath the loop (:data:`RECOVERABLE`: a dead or silent
    peer, a stalled collective, the coordinator's abort), tear the local
    world down (the coordination plane with it) and re-raise,
    so the process exits non-zero and ``--restarts N`` relaunches the
    world, which lands back here and resumes.

    Returns whatever ``train_fn`` returns."""
    committed = state.latest_committed()  # one cross-rank agreement
    if committed is not None:
        # _restore_step skips the second verification only for a step
        # THIS rank's walk proved; the cross-rank minimum may be one it
        # never verified, and a corrupt local copy of it must raise.
        state._restore_step(int(committed))
        if state.discarded_corrupt:
            print(f"[elastic] discarded {state.discarded_corrupt} "
                  f"committed-but-corrupt checkpoint(s); resuming from "
                  f"verified step {state.step}", flush=True)
        _log(f"recovery: resumed from committed step {state.step} "
             f"(restore walk: discarded_corrupt={state.discarded_corrupt}"
             f", {'fallback walk engaged' if state.discarded_corrupt else 'clean latest commit'})")
        if restart_epoch() > 0:
            print(f"[elastic] restart epoch {restart_epoch()}: resumed "
                  f"from committed step {state.step}", flush=True)
    else:
        _log("recovery: no committed state found — starting from "
             "scratch (restore walk: nothing to restore)")
    try:
        return train_fn(state)
    except RECOVERABLE as e:
        sys.stderr.write(
            f"[elastic] world failure at step {state.step}: {e}\n"
            f"[elastic] exiting for supervised restart (run under "
            f"the launcher's --restarts N to resume from the last "
            f"committed step)\n")
        _flightrec.record("world_failure", step=int(state.step),
                          error=repr(e))
        # error= dumps the flight recorder first (this rank's post-mortem,
        # naming its last completed step); the teardown tolerates a dead
        # peer.
        runtime.shutdown(error=e)
        raise
