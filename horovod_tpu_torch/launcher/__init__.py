"""tpurun for the port: one process per GPU, supervised.

Port of the JAX package's launcher (``launcher/__init__.py``), the
counterpart of the reference's ``mpirun -np N python train.py``. It
spawns ``-np`` ranks of a command on this host and exports to each:

* ``HVD_RANK`` / ``HVD_SIZE`` / ``HVD_LOCAL_RANK`` — the process grid,
  which ``runtime.init()`` reads;
* ``HVD_COORD_ADDR`` — the host coordination plane's rank-0
  coordinator (``--coordinator host:port`` on multi-node runs, else
  ``127.0.0.1`` and ``--coord-port`` or a free port), as the JAX
  launcher exports it: a world of more than one rank is coordinated
  (``runtime.init``);
* ``MASTER_ADDR`` / ``MASTER_PORT`` — the ``env://`` rendezvous of the
  ``torch.distributed`` world. Rank 0 hosts both servers, so they take
  two ports, by the JAX launcher's rule for its second server: the
  coordinator's port + 1 when ``--coordinator`` or ``--coord-port``
  fixes it, else a second free port;
* ``HVD_RESTART_EPOCH`` — which (re)launch of the world this is, read by
  elastic recovery and the fault injector's ``@epoch``;
* ``HVD_METRICS_PORT`` with ``--metrics-port``;
* under ``--cpu``: ``HVD_DEVICE=cpu`` and an empty
  ``CUDA_VISIBLE_DEVICES`` (ranks on gloo, no GPU visible), and, unless
  it is set, ``OMP_NUM_THREADS`` = the host's cores / ``-np``.

Every launch is supervised in any order: the first rank to fail tears
its siblings down after ``FAILFAST_GRACE_SECS`` (SIGTERM, then SIGKILL
after ``TERMINATE_GRACE_SECS``), so a dead rank never hangs the job.
``--restarts K`` relaunches a failed world up to K times on fresh
coordinator and rendezvous ports (an explicit multi-node
``--coordinator`` stays), after a capped, jittered exponential backoff
(``HVD_RESTART_BACKOFF_MAX``). SIGINT and SIGTERM are forwarded to the
ranks, give ``128 + signal`` and never relaunch.

NCCL refuses two ranks on one GPU, so without ``--cpu`` an ``-np`` above
the GPUs visible on this host exits before spawning. The GPU count never
creates a CUDA context here (``utils.config.visible_gpus``).

Not ported yet, refused naming its ``ROADMAP.md`` Queue 1 item:
``--max-np`` and live resize (item 15). The JAX launcher's
``--jax-distributed`` has no counterpart: every world of the port is
already one ``torch.distributed`` world.

Usage::

    python -m horovod_tpu_torch.launcher -np 4 python train.py
    bin/tpurun_torch -np 2 --cpu --restarts 1 python train.py
"""

from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

from ..utils import config as _config

# How long a worker gets between SIGTERM and SIGKILL during teardown.
TERMINATE_GRACE_SECS = 5.0

# After the FIRST worker failure, how long the siblings get to exit on
# their own (a survivor blocked in a collective gets the dead peer's
# error and exits with its diagnosis) before the supervisor terminates
# them.
FAILFAST_GRACE_SECS = 3.0

# The coordinator's port when --coordinator names none (the JAX
# launcher's default).
DEFAULT_COORD_PORT = 29521


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _reap(procs: List[subprocess.Popen],
          grace_secs: float = TERMINATE_GRACE_SECS) -> None:
    """Terminate, then kill, every still-running worker, and reap them
    all: SIGTERM → wait up to ``grace_secs`` → SIGKILL → wait (SIGKILL
    cannot be ignored, so the last wait returns)."""
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace_secs
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
    for p in procs:
        try:
            p.wait()
        except OSError:
            pass


def _gpu_refusal(np_: int, cpu: bool) -> Optional[str]:
    """Why ``np_`` ranks cannot each have a GPU of this host (None when
    they can, or under ``--cpu``)."""
    if cpu:
        return None
    n = _config.visible_gpus()
    if np_ <= n:
        return None
    return (f"-np {np_} exceeds the {n} GPU(s) visible on this host: one "
            f"rank a GPU, as NCCL refuses two ranks on one GPU (pass --cpu "
            f"for gloo ranks on the CPU)")


def _fleet_poller(world: int, metrics_port: Optional[int],
                  interval: float, ranks=None):
    """The ``--metrics-summary`` poller when a metrics base port is known
    (the flag or an inherited ``HVD_METRICS_PORT``), else None.
    ``ranks`` restricts the scrape to this node's rank block."""
    base = metrics_port or _config.metrics_port()
    if not base:
        sys.stderr.write(
            "tpurun: --metrics-summary needs a metrics base port "
            "(--metrics-port or HVD_METRICS_PORT) — no fleet view\n")
        return None
    from ..obs.summary import FleetPoller
    return FleetPoller("127.0.0.1", base, world, timeout=max(
        0.2, min(2.0, interval / 2)), ranks=ranks)


def _start_fleet_thread(fleet, interval: float) -> threading.Event:
    """Print the fleet line every ``interval`` seconds on a daemon thread
    of its own: a hung rank listener must never stall the fail-fast
    poll."""
    stop = threading.Event()

    def loop():
        stop.wait(min(interval, 2.0))
        while not stop.is_set():
            try:
                sys.stderr.write(f"tpurun: {fleet.line()}\n")
            except Exception:  # noqa: BLE001 — telemetry must never
                pass           # kill supervision
            stop.wait(interval)
    threading.Thread(target=loop, daemon=True, name="tpurun-fleet").start()
    return stop


def world_ports(coordinator: Optional[str], coord_port: Optional[int]
                ) -> Tuple[str, int, int]:
    """``(host, coordinator port, rendezvous port)`` of one launch: the
    coordinator at ``coordinator`` (``host:port``, port 29521 when it
    names none) or at ``coord_port`` on this host, the rendezvous at the
    next port; with neither, two distinct free ports."""
    if coordinator:
        host, _, cport = coordinator.partition(":")
        port = int(cport or DEFAULT_COORD_PORT)
        return host, port, port + 1
    if coord_port:
        return "127.0.0.1", coord_port, coord_port + 1
    port = _free_port()
    rdzv = _free_port()
    while rdzv == port:
        rdzv = _free_port()
    return "127.0.0.1", port, rdzv


def _launch_once(np_: int, command: List[str], *,
                 coord_port: Optional[int], cpu: bool, node_rank: int,
                 nnodes: int, coordinator: Optional[str],
                 extra_env: Optional[dict], restart_epoch: int,
                 metrics_summary: bool = False,
                 metrics_port: Optional[int] = None,
                 metrics_interval: float = 10.0) -> Tuple[int, bool]:
    """One supervised launch of the world: spawn this node's ranks, watch
    all of them, fail fast. Returns ``(rc, interrupted)``: the first
    non-zero exit code (0 when every rank succeeded) and whether the
    launcher itself was signalled."""
    world = nnodes * np_
    addr, cport, port = world_ports(coordinator, coord_port)
    procs: List[subprocess.Popen] = []
    interrupted = {"sig": None}

    def _forward(signum, frame):
        # The launcher's own termination (Ctrl-C, a scheduler's SIGTERM)
        # goes to every worker; the loop below then reaps.
        interrupted["sig"] = signum
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass

    old_term = signal.signal(signal.SIGTERM, _forward)
    old_int = signal.signal(signal.SIGINT, _forward)
    fleet_stop = None
    try:
        domain = np_ if cpu else _config.visible_gpus()
        threads = max(1, (os.cpu_count() or 1) // np_)
        for local_rank in range(np_):
            env = dict(os.environ)
            env.update(extra_env or {})
            if metrics_port:
                env["HVD_METRICS_PORT"] = str(metrics_port)
            env.update(HVD_RANK=str(node_rank * np_ + local_rank),
                       HVD_SIZE=str(world),
                       HVD_LOCAL_RANK=str(local_rank % max(1, domain)),
                       HVD_RESTART_EPOCH=str(restart_epoch),
                       HVD_COORD_ADDR=f"{addr}:{cport}",
                       MASTER_ADDR=addr, MASTER_PORT=str(port))
            if cpu:
                env.update(HVD_DEVICE="cpu", CUDA_VISIBLE_DEVICES="")
                # The host's cores shared out, so the ranks' intra-op
                # thread pools do not oversubscribe it.
                env.setdefault("OMP_NUM_THREADS", str(threads))
            procs.append(subprocess.Popen(command, env=env))
        if metrics_summary:
            ranks = (None if nnodes == 1 else
                     range(node_rank * np_, (node_rank + 1) * np_))
            fleet = _fleet_poller(world, metrics_port, metrics_interval,
                                  ranks=ranks)
            if fleet is not None:
                fleet_stop = _start_fleet_thread(fleet, metrics_interval)
        rc = 0
        while True:
            running = 0
            for p in procs:
                code = p.poll()
                if code is None:
                    running += 1
                elif code and not rc:
                    rc = code
            if rc or not running or interrupted["sig"] is not None:
                break
            time.sleep(0.05)
        if rc and running:
            # Let the survivors surface the dead peer's error themselves
            # before tearing them down.
            deadline = time.monotonic() + FAILFAST_GRACE_SECS
            while time.monotonic() < deadline and any(
                    p.poll() is None for p in procs):
                time.sleep(0.05)
            running = sum(1 for p in procs if p.poll() is None)
            if running:
                sys.stderr.write(
                    f"tpurun: a worker exited with code {rc}; terminating "
                    f"{running} surviving rank(s)\n")
        _reap(procs)
        if not rc:
            for p in procs:
                if p.returncode and not rc:
                    rc = p.returncode
        if interrupted["sig"] is not None:
            # The ranks' own codes are then those of the forwarded
            # SIGTERM; an operator's Ctrl-C or a scheduler's SIGTERM is
            # never a worker failure to relaunch: the flag travels beside
            # rc.
            rc = 128 + int(interrupted["sig"])
        return rc, interrupted["sig"] is not None
    finally:
        if fleet_stop is not None:
            fleet_stop.set()
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        _reap(procs)


def launch(np_: int, command: List[str], *,
           coord_port: Optional[int] = None, cpu: bool = False,
           node_rank: int = 0, nnodes: int = 1,
           coordinator: Optional[str] = None,
           extra_env: Optional[dict] = None, restarts: int = 0,
           metrics_summary: bool = False,
           metrics_port: Optional[int] = None,
           metrics_interval: float = 10.0) -> int:
    """Spawn ``np_`` local ranks of ``command`` with the world's
    environment, supervised.

    Multi-host: run the launcher on every host with the same
    ``coordinator="host0:port"`` and ``nnodes``, each with its
    ``node_rank``; the world is ``nnodes * np_`` and this host's ranks are
    ``node_rank * np_ .. node_rank * np_ + np_ - 1``. ``coord_port`` fixes
    the single-node coordinator port of the first launch (the rendezvous
    takes the next one).

    With ``restarts > 0`` a failed world is relaunched up to ``restarts``
    times on fresh coordinator and rendezvous ports (the explicit
    multi-host ``coordinator`` stays), after a backoff of ``2^epoch`` seconds capped
    at ``HVD_RESTART_BACKOFF_MAX`` (default 30) and jittered ±50%.

    Returns the first non-zero exit code (0 when all succeeded). Raises
    ``ValueError`` when ``np_`` exceeds this host's GPUs without
    ``cpu``."""
    refusal = _gpu_refusal(np_, cpu)
    if refusal:
        raise ValueError(refusal)
    rc = 0
    backoff_cap = _config.restart_backoff_max()
    for epoch in range(restarts + 1):
        rc, interrupted = _launch_once(
            np_, command, coord_port=coord_port if epoch == 0 else None,
            cpu=cpu, node_rank=node_rank, nnodes=nnodes,
            coordinator=coordinator, extra_env=extra_env,
            restart_epoch=epoch, metrics_summary=metrics_summary,
            metrics_port=metrics_port, metrics_interval=metrics_interval)
        if interrupted or rc == 0 or epoch == restarts:
            break
        base = min(1.0 * (2 ** epoch), backoff_cap)
        backoff = min(backoff_cap, base * random.uniform(0.5, 1.5))
        sys.stderr.write(
            f"tpurun: world failed with exit code {rc} (restart epoch "
            f"{epoch}); relaunching {np_} rank(s) in {backoff:.1f}s "
            f"(base {base:.1f}s, jitter ±50%, cap {backoff_cap:.0f}s; "
            f"{restarts - epoch} restart(s) left)\n")
        time.sleep(backoff)
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpurun",
        description="Launch N ranks of a training script on this host, "
                    "one process per GPU (mpirun replacement).")
    parser.add_argument("-np", type=int, required=True,
                        help="number of ranks (processes) to spawn")
    parser.add_argument("--cpu", action="store_true",
                        help="run the ranks on the CPU over gloo "
                             "(HVD_DEVICE=cpu, no GPU visible; CI/testing)")
    parser.add_argument("--coord-port", type=int, default=None,
                        help="coordinator port of the first launch "
                             "(HVD_COORD_ADDR; the torch rendezvous, "
                             "MASTER_PORT, takes the next port; free "
                             "ports by default)")
    parser.add_argument("--node-rank", type=int, default=0,
                        help="this host's index among --nnodes hosts")
    parser.add_argument("--nnodes", type=int, default=1,
                        help="total hosts in the job (world = nnodes * np)")
    parser.add_argument("--coordinator", default=None,
                        help="host0:port of the coordinator shared by all "
                             "hosts; the rendezvous takes port + 1 "
                             "(required when nnodes > 1)")
    parser.add_argument("--restarts", type=int, default=0,
                        help="relaunch the whole world up to N times after "
                             "a failure (fresh rendezvous port, capped + "
                             "jittered exponential backoff "
                             "[HVD_RESTART_BACKOFF_MAX], HVD_RESTART_EPOCH "
                             "exported); pair with "
                             "horovod_tpu_torch.elastic.run_with_recovery "
                             "to resume from the last committed state")
    parser.add_argument("--max-np", type=int, default=None,
                        help="grow ceiling of live resize (not ported yet: "
                             "ROADMAP.md Queue 1 item 15)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="base port of the per-rank /metrics "
                             "listeners: rank r serves on port+r "
                             "(exports HVD_METRICS_PORT to every rank)")
    parser.add_argument("--metrics-summary", action="store_true",
                        help="scrape every rank's /metrics and print one "
                             "aggregated fleet line. With a command: "
                             "every --metrics-interval seconds while "
                             "supervising. WITHOUT a command: one shot "
                             "against an already-running job's ranks, "
                             "then exit (needs -np + --metrics-port or "
                             "HVD_METRICS_PORT)")
    parser.add_argument("--metrics-interval", type=float, default=10.0,
                        help="seconds between fleet lines under "
                             "--metrics-summary (default 10)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the command to run, e.g. python train.py")
    args = parser.parse_args(argv)
    if args.metrics_interval <= 0:
        parser.error("--metrics-interval must be > 0")
    if args.metrics_summary and not args.command:
        # One shot against a job launched elsewhere: exit 0 when any
        # rank answered, 1 when none did.
        fleet = _fleet_poller(args.np, args.metrics_port,
                              args.metrics_interval)
        if fleet is None:
            return 2
        print(f"tpurun: {fleet.line()}", flush=True)
        # Exit 1 only when no training rank answered: a serving fleet's
        # scrape that answered is a live endpoint whatever its replicas.
        return 0 if (fleet.last_mode == "serving"
                     or fleet.last_up > 0) else 1
    if not args.command:
        parser.error("no command given")
    if args.nnodes > 1 and not args.coordinator:
        parser.error("--nnodes > 1 requires --coordinator host0:port")
    if args.restarts < 0:
        parser.error("--restarts must be >= 0")
    if args.max_np is not None:
        parser.error("--max-np (the live-resize grow ceiling) is not "
                     "ported yet: ROADMAP.md Queue 1 item 15")
    refusal = _gpu_refusal(args.np, args.cpu)
    if refusal:
        parser.error(refusal)
    return launch(args.np, args.command, coord_port=args.coord_port,
                  cpu=args.cpu, node_rank=args.node_rank,
                  nnodes=args.nnodes, coordinator=args.coordinator,
                  restarts=args.restarts,
                  metrics_summary=args.metrics_summary,
                  metrics_port=args.metrics_port,
                  metrics_interval=args.metrics_interval)


if __name__ == "__main__":
    sys.exit(main())
