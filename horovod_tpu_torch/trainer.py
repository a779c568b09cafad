"""Trainer: the ``model.fit`` analog driving the train step and callbacks,
and the rank-0 checkpoints with broadcast-on-restore.

Port of the JAX package's ``trainer.py``: :class:`Trainer` (:35-419),
:class:`AsyncCheckpointer` (:421), :func:`save_checkpoint` (:570),
:func:`apply_retention` (:617), :func:`latest_checkpoint_step` (:656) and
:func:`restore_checkpoint` (:666). The reference's training loops are
Keras ``model.fit`` with Horovod callbacks
(``examples/keras_mnist_advanced.py:80-110``): epochs × steps invoking
:mod:`horovod_tpu_torch.callbacks` hooks, rank-0-only verbosity and
rank-0-only checkpointing with a broadcast on restore (SURVEY §5.4).

The step loop reads nothing back from the device per step: the running
metric sums stay on the device and are read once per epoch; the one
per-step host read is the consecutive bad-step count, and only when the
step emits ``bad_step`` (a step built with ``guard_nonfinite``).
With ``elastic=`` (an :class:`~horovod_tpu_torch.elastic.ElasticState`)
an exhausted bad-step budget rolls back to the newest verified commit
instead of raising (the JAX package's ``Trainer._contain`` :178-226);
live resize (``resize=``) is ``ROADMAP.md`` Queue 1 item 15.
"""

from __future__ import annotations

import atexit
import os
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from . import runtime
from .data import batch_rows, prefetch_to_device, shard_batch, shard_iterator
from .obs import flightrec as _flightrec
from .obs.registry import registry as _metrics_registry
from .testing import faults as _faults
from .utils import config as _config
from .utils import timeline as _timeline


def _timeline_of_world():
    return runtime.world().timeline if runtime.is_initialized() else None


class Trainer:
    """Host training loop; owns the mutable ``state`` that callbacks adjust.

    ``train_step(state, batch) -> (state, metrics)`` takes this rank's
    shard of a global batch (placed on the world's device) and returns
    scalar metrics — :func:`horovod_tpu_torch.training.make_train_step`'s
    step, or any function of that shape over any state object."""

    def __init__(self, train_step: Callable, state: Any,
                 *, eval_step: Optional[Callable] = None,
                 steps_per_epoch: Optional[int] = None,
                 verbose: Optional[bool] = None,
                 prefetch: int = 2,
                 max_bad_steps: Optional[int] = None,
                 elastic: Any = None,
                 resize: Any = None):
        if resize is not None:
            raise NotImplementedError(
                "Trainer(resize=) — live elastic resize is ROADMAP.md "
                "Queue 1 item 15")
        self.train_step = train_step
        self.eval_step = eval_step
        self.state = state
        self.steps_per_epoch = steps_per_epoch
        if verbose is None:
            verbose = not runtime.is_initialized() or runtime.rank() == 0
        self.verbose = verbose
        # Background input staging depth (0 disables): keeps `prefetch`
        # batches ahead of the step on the device.
        self.prefetch = prefetch
        self.history: List[Dict[str, float]] = []
        # Global step counter across epochs — drives the fault hook.
        self._global_step = 0
        self.max_bad_steps = (_config.max_bad_steps()
                              if max_bad_steps is None
                              else max(1, int(max_bad_steps)))
        self._bad_counter: Optional[torch.Tensor] = None
        # The ElasticState a budget overrun rolls back onto (None: raise).
        self.elastic = elastic
        # Hot-path metrics: registered once here. Names are API.
        reg = _metrics_registry()
        self._m_steps = reg.counter(
            "hvd_steps_total",
            "Train steps completed by this rank's loop (skipped "
            "bad steps included — they consumed a batch)")
        self._m_step_seconds = reg.histogram(
            "hvd_step_seconds",
            "Per-step wall time: input wait + dispatch + host-side work "
            "between consecutive step completions")
        self._m_samples = reg.counter(
            "hvd_samples_total",
            "Training examples consumed (leading batch-axis rows seen "
            "by this process's loop)")
        self._m_bad = reg.counter(
            "hvd_bad_steps_total",
            "Steps skipped by the non-finite gradient guard")
        self._m_epochs = reg.counter("hvd_epochs_total",
                                     "Epochs completed")
        self._m_gstep = reg.gauge(
            "hvd_global_step",
            "Global step counter (across epochs and restarts of this "
            "process)")

    def _stream(self, data: Iterable):
        if self.prefetch and self.prefetch > 0:
            return prefetch_to_device((shard_batch(b) for b in data),
                                      self.prefetch)
        return shard_iterator(data)

    # -- running metrics (device-resident, fetched once per epoch) ---------

    @staticmethod
    def _accumulate_metrics(sums, metrics):
        if sums is None:
            for k, v in metrics.items():
                if torch.as_tensor(v).dim() != 0:
                    raise ValueError(
                        f"train-step metric {k!r} has shape "
                        f"{tuple(torch.as_tensor(v).shape)}; metrics_fn "
                        f"must return scalars (reduce to a per-batch mean "
                        f"before returning) — a non-scalar here would "
                        f"silently broadcast into the epoch mean")
            return {k: torch.as_tensor(v).detach().float().clone()
                    for k, v in metrics.items()}
        for k, v in metrics.items():
            sums[k].add_(torch.as_tensor(v).float())
        return sums

    # -- bad-step containment (guard_nonfinite train steps) ----------------

    def _track_bad_step(self, bad_flag) -> bool:
        """Fold this step's ``bad_step`` flag into the device-resident
        consecutive-skip counter; returns True when the step was skipped.
        The ``int()`` read of one scalar per step is the whole host-side
        cost of containment. Reaching ``max_bad_steps`` consecutive skips
        rolls back or raises (:meth:`_contain`)."""
        flag = torch.as_tensor(bad_flag)
        if self._bad_counter is None:
            self._bad_counter = torch.zeros((), dtype=torch.int32,
                                            device=flag.device)
        self._bad_counter = torch.where(flag > 0, self._bad_counter + 1,
                                        torch.zeros_like(self._bad_counter))
        consec = int(self._bad_counter)
        if consec == 0:
            return False
        with _timeline.maybe_op(_timeline_of_world(), "train.guard",
                                _timeline.BAD_STEP):
            pass  # instantaneous marker: this step was skipped
        self._m_bad.inc()
        _flightrec.record("bad_step", step=self._global_step,
                          consecutive=consec)
        if self.verbose:
            print(f"[trainer] non-finite gradients at global step "
                  f"{self._global_step}: update skipped "
                  f"({consec}/{self.max_bad_steps} consecutive)",
                  file=sys.stderr, flush=True)
        if consec >= self.max_bad_steps:
            self._contain(consec)
        return True

    def _contain(self, consec: int) -> None:
        """The bad-step budget is exhausted: the params (or the data
        feeding them) are presumed poisoned beyond what skipped steps can
        absorb. With an attached :class:`~horovod_tpu_torch.elastic.
        ElasticState`, roll back to the newest commit that passes
        verification (the fallback walk) and keep training; without one,
        raise :class:`~horovod_tpu_torch.exceptions.NonFiniteGradError` —
        skipping forever would burn the reservation training nothing."""
        from .exceptions import NonFiniteGradError
        if self.elastic is None:
            raise NonFiniteGradError(
                f"{consec} consecutive non-finite-gradient steps at "
                f"global step {self._global_step} and no elastic state "
                f"to roll back to — a persistent NaN source (bad data "
                f"shard, broken loss scale, flaky chip) will not fix "
                f"itself. Attach Trainer(elastic=ElasticState(...)) for "
                f"automatic rollback, or raise HVD_MAX_BAD_STEPS if "
                f"longer transients are expected")
        es = self.elastic
        # The live model and optimizer are the restore's templates: it
        # overwrites their parameters, buffers and state in place.
        es.params, es.opt_state = self.state.model, self.state.optimizer
        try:
            es.restore()   # latest_committed's walk skips corrupt steps
        except FileNotFoundError as e:
            # Nothing committed, or every commit corrupt: the same
            # terminal diagnosis as without elastic state.
            raise NonFiniteGradError(
                f"{consec} consecutive non-finite-gradient steps at "
                f"global step {self._global_step} and no verified "
                f"committed checkpoint to roll back to ({e}) — commit "
                f"via ElasticState before the storm, or fix the NaN "
                f"source (bad data shard, broken loss scale, flaky "
                f"chip)") from e
        self.state.step = es.step
        self._bad_counter = torch.zeros_like(self._bad_counter)
        _flightrec.record("rollback", step=es.step, consecutive_bad=consec)
        if self.verbose:
            print(f"[trainer] bad-step budget exhausted ({consec} "
                  f"consecutive skips) — rolled back to verified "
                  f"elastic step {es.step}", file=sys.stderr, flush=True)

    def fit(self, data: Callable[[], Iterable], epochs: int = 1,
            callbacks: Optional[List] = None,
            eval_data: Optional[Callable[[], Iterable]] = None,
            initial_epoch: int = 0):
        """Run the training loop.

        Args:
          data: zero-arg callable returning a fresh per-epoch iterable of
            ``(inputs, labels)`` host batches (global batch; sharded here).
          epochs: final epoch (exclusive).
          callbacks: list of :class:`horovod_tpu_torch.callbacks.Callback`.
          eval_data: optional eval-batch iterable factory, run at epoch end.
          initial_epoch: first epoch — nonzero after checkpoint resume.
        """
        callbacks = list(callbacks or [])
        for cb in callbacks:
            cb.set_trainer(self)
        for cb in callbacks:
            cb.on_train_begin()
        for epoch in range(initial_epoch, epochs):
            t0 = time.perf_counter()
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            nsteps = 0
            bad_steps = 0
            guard_active = False
            metric_sums = None
            stream = self._stream(data())
            step_t0 = time.perf_counter()
            try:
                for batch_idx, batch in enumerate(stream):
                    if self.steps_per_epoch is not None \
                            and batch_idx >= self.steps_per_epoch:
                        break
                    for cb in callbacks:
                        cb.on_batch_begin(batch_idx)
                    self.state, metrics = self.train_step(self.state, batch)
                    # The guard's flag rides the metrics dict but is a
                    # count, not a mean.
                    bad_flag = (metrics.pop("bad_step", None)
                                if isinstance(metrics, dict) else None)
                    metric_sums = self._accumulate_metrics(metric_sums,
                                                           metrics)
                    if bad_flag is not None:
                        guard_active = True
                        if self._track_bad_step(bad_flag):
                            bad_steps += 1
                    for cb in callbacks:
                        cb.on_batch_end(batch_idx)
                    nsteps += 1
                    now = time.perf_counter()
                    self._m_step_seconds.observe(now - step_t0)
                    step_t0 = now
                    self._m_steps.inc()
                    self._m_gstep.set(self._global_step + 1)
                    rows = batch_rows(batch)
                    if rows:
                        self._m_samples.inc(rows)
                    _flightrec.record("step", step=self._global_step,
                                      epoch=epoch)
                    _faults.step_hook(self._global_step)
                    self._global_step += 1
            finally:
                close = getattr(stream, "close", None)
                if close is not None:
                    close()
            if self.steps_per_epoch is None:
                self.steps_per_epoch = nsteps

            # Epoch logs: the running mean over the epoch's good steps
            # (skipped steps contributed zeros), read in one device fetch.
            logs: Dict[str, float] = {}
            if metric_sums is not None:
                good = max(1, nsteps - bad_steps)
                keys = list(metric_sums)
                host = torch.stack([metric_sums[k] for k in keys]).cpu()
                for k, v in zip(keys, host.tolist()):
                    logs[k] = float(v) / good
            if guard_active:
                logs["bad_steps"] = float(bad_steps)
            if eval_data is not None and self.eval_step is not None:
                evals = []
                for b in eval_data():
                    rows = batch_rows(b)
                    placed = next(shard_iterator([b]))
                    evals.append((rows, self.eval_step(self.state, placed)))
                if evals:
                    total = sum(r for r, _ in evals)
                    for k in evals[0][1]:
                        logs[f"val_{k}"] = float(sum(
                            r * float(e[k]) for r, e in evals) / total)
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            self._m_epochs.inc()
            self.history.append(logs)
            if self.verbose:
                dt = time.perf_counter() - t0
                msg = " ".join(f"{k}={v:.4f}" for k, v in logs.items())
                print(f"epoch {epoch + 1}/{epochs} [{dt:.1f}s, "
                      f"{nsteps} steps] {msg}")
        for cb in callbacks:
            cb.on_train_end()
        return self.history


# ---------------------------------------------------------------------------
# Checkpoint / resume — rank-0-only write + broadcast-on-restore (SURVEY §5.4).
# ---------------------------------------------------------------------------

class AsyncCheckpointer:
    """Background checkpoint writer: the step loop pays only the
    device→host snapshot; serialization happens off the critical path.

    1. **snapshot** (caller thread, ``CKPT_SNAPSHOT`` timeline phase) —
       the state copied into pinned host memory, one synchronize. The
       training loop may overwrite the device state afterwards.
    2. **write** (this writer's thread, ``CKPT_WRITE`` phase) — the leaf
       files, the rename, the manifest and retention of the host copy.
    3. **durable hook** — ``on_durable`` runs only after the write
       succeeded.

    ``wait()`` blocks until every submitted write is durable and re-raises
    the first writer error; ``close()`` waits, stops the thread, re-raises
    too and makes further submits fail. ``max_pending`` bounds host
    memory: the queue holds at most that many snapshots before ``submit``
    blocks. The thread is a daemon (a wedged write must never hang
    interpreter exit); an ``atexit`` hook drains queued writes with a
    bounded wait and reports their errors on stderr. Prefer an explicit
    ``close()`` / ``with`` block: only those re-raise writer failures."""

    def __init__(self, max_pending: int = 2,
                 timeline: Optional[Any] = None):
        if timeline is None:
            timeline = _timeline_of_world()
        self.timeline = timeline
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, max_pending))
        self._errors: List[BaseException] = []
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="hvd-ckpt-writer", daemon=True)
        self._thread.start()
        atexit.register(self._drain_at_exit)

    def submit(self, write_fn: Callable[[], Any],
               on_durable: Optional[Callable[[], Any]] = None) -> None:
        """Enqueue a write job (host data must already be snapshotted).
        Blocks only when ``max_pending`` writes are already in flight."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._q.put((write_fn, on_durable))

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                write_fn, on_durable = item
                try:
                    with _timeline.maybe_op(self.timeline, "ckpt.write",
                                            _timeline.CKPT_WRITE):
                        write_fn()
                    if on_durable is not None:
                        on_durable()
                except BaseException as e:  # noqa: BLE001 — to wait()
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Barrier: returns once every submitted write is durable on disk,
        re-raising the first writer failure. With ``timeout`` (seconds), a
        write still in flight at the deadline raises
        :class:`~horovod_tpu_torch.exceptions.CheckpointTimeoutError`; the
        write itself is NOT cancelled."""
        if timeout is None:
            self._q.join()
        else:
            deadline = time.monotonic() + timeout
            with self._q.all_tasks_done:
                while self._q.unfinished_tasks:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        from .exceptions import CheckpointTimeoutError
                        raise CheckpointTimeoutError(
                            f"checkpoint write still in flight after "
                            f"{timeout:.1f}s — filesystem hung or writer "
                            f"wedged ({self._q.unfinished_tasks} job(s) "
                            f"pending); the write was NOT cancelled")
                    self._q.all_tasks_done.wait(remaining)
        if self._errors:
            raise self._errors.pop(0)

    def close(self) -> None:
        """Drain pending writes, stop the thread, surface any error (a
        durability barrier, however long the pending writes take)."""
        atexit.unregister(self._drain_at_exit)
        if self._closed:
            self._thread.join(timeout=60)
            if self._errors:
                raise self._errors.pop(0)
            return
        self._closed = True
        self._q.put(None)
        self._q.join()
        self._thread.join(timeout=60)
        if self._errors:
            raise self._errors.pop(0)

    def _drain_at_exit(self) -> None:
        """Bounded best-effort drain at interpreter shutdown."""
        if self._closed or not self._thread.is_alive():
            return
        self._closed = True
        try:
            self._q.put(None, timeout=60)
        except queue.Full:
            return
        self._thread.join(timeout=60)
        for e in self._errors:
            print(f"[hvd-ckpt-writer] checkpoint write failed at exit: {e!r}",
                  file=sys.stderr)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_checkpoint(directory: str, state: Any,
                    step: Optional[int] = None,
                    max_to_keep: Optional[int] = None,
                    writer: Optional[AsyncCheckpointer] = None
                    ) -> Optional[str]:
    """Write a checkpoint of ``state`` (a ``TrainState``: ``model``,
    ``optimizer``, ``step``) — rank 0 only, like the reference. Returns
    the path written, or None on other ranks. A ZeRO optimizer's state is
    gathered to its canonical form first, a collective every rank enters.

    ``max_to_keep``: after a successful write, delete the oldest
    checkpoints beyond the newest ``max_to_keep``. With ``writer`` (an
    :class:`AsyncCheckpointer`) only the device→host snapshot happens
    here; the write and retention run on the writer's thread, and the
    path is durable only after ``writer.wait()``."""
    from .parallel.checkpoint import (snapshot_to_host, state_tree,
                                      write_manifest, write_tree)
    tree = state_tree(state)
    if runtime.is_initialized() and runtime.rank() != 0:
        return None
    step = int(state.step) if step is None else int(step)
    path = os.path.join(os.path.abspath(directory), f"ckpt_{step}")
    tl = writer.timeline if writer is not None else _timeline_of_world()
    host = snapshot_to_host(tree, timeline=tl)

    def _write():
        # Leaf files into a tmp dir renamed on completion, so a writer
        # killed mid-write never leaves a visible ckpt_<step>; the
        # manifest lands right after the rename.
        write_tree(path, host)
        write_manifest(path, host, step=step)
        apply_retention(directory, path, max_to_keep)

    if writer is None:
        with _timeline.maybe_op(tl, "ckpt.write", _timeline.CKPT_WRITE):
            _write()
    else:
        writer.submit(_write)
    return path


def apply_retention(directory: str, just_written: str,
                    max_to_keep: Optional[int]) -> None:
    """Delete the oldest checkpoints beyond the newest ``max_to_keep``, by
    WRITE recency (not step number), never the path just written."""
    if max_to_keep is None or max_to_keep <= 0:
        return
    import shutil
    base = os.path.abspath(directory)
    entries = []
    for n in os.listdir(base):
        if _step_of(n) is None:
            continue
        full = os.path.join(base, n)
        try:
            entries.append((os.path.getmtime(full), full))
        except OSError:
            continue
    entries.sort()
    for _, old in entries[:-max_to_keep]:
        if old != just_written:
            shutil.rmtree(old, ignore_errors=True)


def _step_of(name: str) -> Optional[int]:
    if not name.startswith("ckpt_"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def latest_checkpoint_step(directory: str) -> Optional[int]:
    """The newest checkpoint's step (the resume scan rank 0 performs
    before broadcasting the epoch)."""
    if not os.path.isdir(directory):
        return None
    steps = [s for s in (_step_of(n) for n in os.listdir(directory))
             if s is not None]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, state: Any,
                       step: Optional[int] = None,
                       verify: bool = True) -> Any:
    """Restore ``state`` in place (on every rank, from the shared
    filesystem), then broadcast it from rank 0 so all ranks are
    bit-identical — the reference's load + ``BroadcastGlobalVariables``
    protocol. ``verify`` (default on) checks the integrity manifest
    before anything is loaded and raises
    :class:`~horovod_tpu_torch.exceptions.CheckpointCorruptError` naming
    the offending leaf; a manifest-less checkpoint restores unverified.
    Returns ``state``."""
    from .optimizer import broadcast_global_variables
    from .parallel.checkpoint import load_state_, read_checkpoint
    if step is None:
        step = latest_checkpoint_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"ckpt_{step}")
    load_state_(state, read_checkpoint(path, verify=verify))
    if runtime.is_initialized() and runtime.size() > 1:
        broadcast_global_variables(state, root_rank=0)
    return state
