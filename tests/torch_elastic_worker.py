"""One rank of the port's launcher and elastic-recovery drills
(tests/test_torch_launcher.py, tests/test_torch_elastic.py).

Started by ``python -m horovod_tpu_torch.launcher --cpu``; it imports only
torch and the port. ``HVD_WORKER_MODE`` picks what it does:

* ``elastic`` (the default) — the JAX package's ``tests/elastic_worker.py``
  loop through ``elastic.run_with_recovery``: per-step pseudo-gradients
  that are a pure function of (step, rank), averaged with
  ``allreduce``, so a run killed and resumed from a committed step must
  end with the bits of an uninterrupted run. Env: ``HVD_ELASTIC_DIR``,
  ``HVD_TOTAL_STEPS`` (default 6), ``HVD_COMMIT_EVERY`` (default 1),
  ``HVD_FAULT_SPEC``. Prints ``rank <r>/<s>: FINAL <checksum> step <n>``
  and ``rank <r>/<s>: PARAMS <hex of w then m>``.
* ``collectives`` — a few eager collectives over the launched world;
  prints ``rank <r>/<s>: LAUNCHER OK``.
* ``park`` — prints ``rank <r>: READY`` and sleeps until SIGTERM, on
  which it exits 0 (the signal drills).
"""

import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import elastic  # noqa: E402
from horovod_tpu_torch.testing import faults  # noqa: E402

TOTAL_STEPS = int(os.environ.get("HVD_TOTAL_STEPS", "6"))


def say(line: str) -> None:
    """One line in one write: the ranks share the launcher's stdout."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def grad_for(step: int, rank: int) -> np.ndarray:
    """The JAX drill's deterministic per-(step, rank) pseudo-gradient."""
    base = np.arange(8, dtype=np.float32)
    return (np.sin(base * (step + 1)) * (rank + 1) / 10.0).astype(
        np.float32)


class Recurrence(torch.nn.Module):
    """The drill's state: ``w`` and ``m``, f32 zeros."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(8))
        self.m = torch.nn.Parameter(torch.zeros(8))


def update(model: Recurrence, g: torch.Tensor) -> None:
    """``w -= 0.1 g; m = 0.9 m + g`` (the JAX drill's rule)."""
    with torch.no_grad():
        w = model.w - 0.1 * g
        m = model.m * 0.9 + g
        model.w.copy_(w)
        model.m.copy_(m)


def train(state: elastic.ElasticState):
    r = hvd.rank()
    while state.step < TOTAL_STEPS:
        step = state.step
        # The fault hook may kill THIS rank here, before the step's
        # collective: a worker lost mid-epoch.
        faults.step_hook(step)
        g = hvd.allreduce(torch.from_numpy(grad_for(step, r)), average=True)
        update(state.params, g)
        state.advance()
    return state


def run_elastic() -> None:
    hvd.init()
    r, s = hvd.rank(), hvd.size()
    state = elastic.ElasticState(
        Recurrence(), opt_state=None, step=0,
        commit_every=int(os.environ.get("HVD_COMMIT_EVERY", "1")))
    state = elastic.run_with_recovery(train, state)
    w, m = state.params.w.detach(), state.params.m.detach()
    checksum = float(w.abs().sum() + m.abs().sum())
    say(f"rank {r}/{s}: FINAL {checksum:.10f} step {state.step}")
    say(f"rank {r}/{s}: PARAMS {w.numpy().tobytes().hex()}"
        f"{m.numpy().tobytes().hex()}")
    hvd.shutdown()


def run_collectives() -> None:
    hvd.init()
    r, s = hvd.rank(), hvd.size()
    out = hvd.allreduce(torch.full((4,), float(r + 1)), average=False)
    assert torch.all(out == sum(i + 1 for i in range(s))), out
    g = hvd.allgather(torch.full((r + 1, 2), float(r)))
    assert g.shape == (s * (s + 1) // 2, 2), g.shape
    b = hvd.broadcast(torch.tensor([r * 1.0, 2.0]), root_rank=0)
    assert b.tolist() == [0.0, 2.0], b
    objs = hvd.allgather_object({"rank": r})
    assert [o["rank"] for o in objs] == list(range(s)), objs
    assert hvd.local_rank() == int(os.environ["HVD_LOCAL_RANK"])
    say(f"rank {r}/{s}: LAUNCHER OK")
    hvd.shutdown()


def park() -> None:
    signal.signal(signal.SIGTERM, lambda *_: os._exit(0))
    say(f"rank {os.environ['HVD_RANK']}: READY")
    time.sleep(120)


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"elastic": run_elastic, "collectives": run_collectives,
     "park": park}[os.environ.get("HVD_WORKER_MODE", "elastic")]()
