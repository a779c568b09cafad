"""One rank of a coordinated world, for the coordination-plane parity and
fault tests (``tests/test_torch_coord.py``, ``tests/test_torch_coord_
faults.py``).

    python tests/torch_coord_worker.py <jax|torch> <out_dir> <scenario>

Rank, size and the coordinator's address come from ``HVD_RANK``,
``HVD_SIZE`` and ``HVD_COORD_ADDR`` (the port's ranks also read
``MASTER_ADDR``/``MASTER_PORT``). ``jax`` runs the JAX package
(``horovod_tpu``, its env world), ``torch`` the port; a port rank never
imports JAX. Scenarios:

* ``parity`` — one seeded script of eager collectives (dtypes, ops,
  ragged gathers, planes, async handles, objects, then cross-rank
  mismatches): through the public API in a world of 2 or more, through
  the ``CoordClient`` itself in a world of 1. Writes ``<pkg>.<rank>.npz``
  (every result, bf16 as its raw bits) and ``<pkg>.<rank>.json`` (dtypes,
  error texts, counters, and for the port the modules and files its
  process maps).
* ``timeline`` — a short named script with ``HOROVOD_TIMELINE`` set.
* ``faults`` — the fault drills: the ranks step through eager allreduces
  calling the fault injector's ``step_hook`` (and sleeping
  ``HVD_TEST_STEP_SLEEP`` seconds); the outcome (the error's class and
  text, or ``done``) goes to ``<pkg>.<rank>.json``.
* ``stall`` — rank 1 skips one collective: rank 0 gets ``StalledError``
  under ``HOROVOD_STALL_TIMEOUT``, and the stalled name is refused on
  reuse.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PKG, OUT, SCENARIO = sys.argv[1], sys.argv[2], sys.argv[3]
RANK = int(os.environ["HVD_RANK"])
SIZE = int(os.environ["HVD_SIZE"])
RING_ELEMS = 32768      # 128 KiB of f32: above the tests' ring threshold


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> the raw bits of its bf16 rounding (round to nearest even)."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return u.astype(np.uint16)


class Side:
    """One package's eager plane: ``call`` runs one collective on a host
    array and returns ``(array, dtype name)``; bf16 travels as bits."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        if pkg == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
            import ml_dtypes
            import horovod_tpu as hvd
            from horovod_tpu.coord.client import CoordClient
            from horovod_tpu.ops.collectives import Op
            self.bf16 = ml_dtypes.bfloat16
        else:
            import torch
            import horovod_tpu_torch as hvd
            from horovod_tpu_torch.coord.client import CoordClient
            from horovod_tpu_torch.ops.collectives import Op
            self.torch = torch
        self.hvd, self.Op = hvd, Op
        self.client = None
        if SIZE == 1:
            host, _, port = os.environ["HVD_COORD_ADDR"].partition(":")
            self.client = CoordClient(0, 1, host, int(port))
        elif pkg == "jax":
            hvd.init()
        else:
            hvd.init(device="cpu")
        self.coord = self.client or hvd.world().coord

    def tensor(self, x: np.ndarray, bf16: bool = False):
        if self.pkg == "jax":
            import jax.numpy as jnp
            return jnp.asarray(x.view(self.bf16) if bf16 else x)
        t = self.torch.from_numpy(x.copy())
        return t.view(self.torch.bfloat16) if bf16 else t

    def host(self, out):
        if self.pkg == "jax":
            a = np.asarray(out)
            name = a.dtype.name
            return (a.view(np.uint16) if name == "bfloat16" else a), name
        name = str(out.dtype).replace("torch.", "")
        if name == "bfloat16":
            return out.view(self.torch.int16).numpy().view(np.uint16), name
        return out.numpy(), name

    def call(self, kind, x, name, op=None, root=0, plane="auto",
             bf16=False):
        t = self.tensor(x, bf16)
        op = getattr(self.Op, op) if op else None
        if self.client is not None:
            out = self.client.collective(kind, t, name, op=op,
                                         root_rank=root, plane=plane)
        elif kind == "allreduce":
            out = self.hvd.allreduce(t, name=name, op=op or self.Op.SUM,
                                     plane=plane)
        elif kind == "allgather":
            out = self.hvd.allgather(t, name=name, plane=plane)
        elif kind == "broadcast":
            out = self.hvd.broadcast(t, root_rank=root, name=name,
                                     plane=plane)
        elif kind == "alltoall":
            out = self.hvd.alltoall(t, name=name, plane=plane)
        else:
            out = self.hvd.reducescatter(t, name=name, op=op or self.Op.SUM,
                                         plane=plane)
        return self.host(out)

    def shutdown(self):
        if self.client is not None:
            self.client.shutdown()
        else:
            self.hvd.shutdown()


def parity(side: Side) -> None:
    rng = np.random.default_rng(1234 + RANK)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    bf = _bf16_bits
    seq = [
        ("ar_f32", "allreduce", f32(5, 3), dict(op="SUM")),
        ("ar_f32_avg", "allreduce", f32(7), dict(op="AVERAGE")),
        ("ar_bf16", "allreduce", bf(f32(4, 8)), dict(op="SUM", bf16=True)),
        ("ar_bf16_avg", "allreduce", bf(f32(9)),
         dict(op="AVERAGE", bf16=True)),
        ("ar_i32", "allreduce", rng.integers(-50, 50, 6).astype(np.int32),
         dict(op="SUM")),
        ("ar_i32_avg", "allreduce", rng.integers(-50, 50, 6).astype(
            np.int32), dict(op="AVERAGE")),
        ("ar_u8", "allreduce", rng.integers(0, 10, 3).astype(np.uint8),
         dict(op="SUM")),
        ("ar_bool", "allreduce", rng.random(5) > 0.5, dict(op="SUM")),
        ("ar_min", "allreduce", f32(6), dict(op="MIN")),
        ("ar_max", "allreduce", f32(6), dict(op="MAX")),
        ("ar_prod", "allreduce", f32(6), dict(op="PRODUCT")),
        ("ag_ragged", "allgather", f32(RANK + 1, 3), {}),
        ("ag_i32", "allgather", np.arange(2 * RANK + 1, dtype=np.int32), {}),
        ("bc_last", "broadcast", f32(4, 2), dict(root=SIZE - 1)),
        ("bc_bf16", "broadcast", bf(f32(6)), dict(root=0, bf16=True)),
        ("a2a", "alltoall", f32(2 * SIZE, 3), {}),
        ("rs_sum", "reducescatter", f32(3 * SIZE, 2), dict(op="SUM")),
        ("rs_avg", "reducescatter", f32(3 * SIZE), dict(op="AVERAGE")),
        # Planes: HOROVOD_RING_THRESHOLD is 64 KiB in these worlds.
        ("ring_auto", "allreduce", f32(RING_ELEMS), dict(op="SUM")),
        ("ring_forced_small", "allreduce", f32(16),
         dict(op="SUM", plane="ring")),
        ("star_forced_big", "allreduce", f32(RING_ELEMS),
         dict(op="SUM", plane="star")),
        ("ring_bf16", "allreduce", bf(f32(2 * RING_ELEMS)),
         dict(op="SUM", plane="ring", bf16=True)),
        ("ring_ag_ragged", "allgather", f32(4096 * (RANK + 1), 2),
         dict(plane="ring")),
        ("ring_bc", "broadcast", f32(RING_ELEMS), dict(root=0)),
        ("ring_rs", "reducescatter", f32(SIZE * 8192), dict(plane="ring")),
        ("ring_a2a", "alltoall", f32(SIZE * 8192), dict(plane="ring")),
    ]
    results, dtypes, errors = {}, {}, {}
    for key, kind, x, kw in seq:
        results[key], dtypes[key] = side.call(kind, x, f"p.{key}", **kw)

    hvd, Op = side.hvd, side.Op
    if side.client is None:
        # Async handles, redeemed in reverse order.
        xs = [f32(8) for _ in range(4)]
        hs = [hvd.allreduce_async_(side.tensor(x), name=f"async.{i}",
                                   op=Op.SUM) for i, x in enumerate(xs)]
        hg = hvd.allgather_async_(side.tensor(f32(RANK + 2, 2)),
                                  name="async.g")
        hb = hvd.broadcast_async_(side.tensor(f32(3)), root_rank=SIZE - 1,
                                  name="async.b")
        for key, h in [("async_b", hb), ("async_g", hg)] + [
                (f"async_{i}", h) for i, h in reversed(list(enumerate(hs)))]:
            results[key], dtypes[key] = side.host(hvd.synchronize(h))
        # A name in flight cannot be submitted again.
        h = hvd.allreduce_async_(side.tensor(f32(2)), name="dup", op=Op.SUM)
        try:
            hvd.allreduce_async_(side.tensor(f32(2)), name="dup", op=Op.SUM)
        except ValueError as e:
            errors["dup"] = f"ValueError: {e}"
        results["dup"], dtypes["dup"] = side.host(hvd.synchronize(h))
        obj = hvd.broadcast_object({"rank": RANK, "s": "x" * (RANK + 3)},
                                   root_rank=SIZE - 1, name="obj.b")
        objs = hvd.allgather_object([RANK] * (RANK + 1), name="obj.g")
        errors["objects"] = json.dumps([obj, objs], sort_keys=True)
        try:
            side.call("allreduce", np.zeros(3, np.float16), "f16")
        except TypeError as e:
            errors["float16"] = f"TypeError: {e}"

    if SIZE > 1:
        mismatches = [
            ("shape", "allreduce", np.zeros(RANK + 1, np.float32), {}),
            ("dtype", "allreduce", np.zeros(3, np.float32) if RANK == 0
             else np.zeros(3, np.int32), {}),
            ("root", "broadcast", np.zeros(2, np.float32),
             dict(root=RANK % 2)),
            ("op", "allreduce", np.zeros(3, np.float32),
             dict(op="SUM" if RANK == 0 else "MAX")),
            ("ag_trailing", "allgather", np.zeros((2, RANK + 1), np.float32),
             {}),
        ]
        for key, kind, x, kw in mismatches:
            try:
                side.call(kind, x, f"err.{key}", **kw)
                errors[key] = "no error"
            except Exception as e:  # noqa: BLE001 — the text is the result
                errors[key] = f"{type(e).__name__}: {e}"
        errors["nonroot_ring_bcast"] = _nonroot_ring_broadcast(side.coord)
        # The world still works after every refusal.
        results["after"], dtypes["after"] = side.call(
            "allreduce", f32(4), "p.after", op="SUM")

    coord = side.coord
    ring_ops, ops_completed = coord.ring_ops(), coord.ops_completed()
    port_only = {}
    if PKG == "torch" and side.client is None:
        # grouped_allreduce: every tensor submitted at once under
        # <name>.<i>, fused by the coordinator; bitwise one allreduce each.
        grng = np.random.default_rng(99 + RANK)
        ts = [side.tensor(grng.standard_normal(n).astype(np.float32))
              for n in (5, 7, 3, 8, 2, 6)]
        r0, o0 = coord.responses_received(), coord.ops_completed()
        grouped = hvd.grouped_allreduce(ts, average=False, name="grp")
        port_only["grouped_fused"] = [coord.responses_received() - r0,
                                      coord.ops_completed() - o0]
        single = [hvd.allreduce(t, op=Op.SUM, name=f"grp.one.{i}")
                  for i, t in enumerate(ts)]
        port_only["grouped_bitwise"] = all(
            a.numpy().tobytes() == b.numpy().tobytes()
            for a, b in zip(grouped, single))
    info = {"dtypes": dtypes, "errors": errors, "port_only": port_only,
            "ring_ops": ring_ops, "ops_completed": ops_completed}
    if PKG == "torch":
        with open("/proc/self/maps") as f:
            maps = f.read()
        info["jax_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
        info["maps_jax"] = [ln.split()[-1] for ln in maps.splitlines()
                            if "jaxlib" in ln or "libhvdcoord.so" in ln
                            and "/horovod_tpu/coord/" in ln]
        info["maps_coord"] = sorted({ln.split()[-1]
                                     for ln in maps.splitlines()
                                     if "libhvdcoord" in ln})
    side.shutdown()
    np.savez(os.path.join(OUT, f"{PKG}.{RANK}.npz"), **results)
    with open(os.path.join(OUT, f"{PKG}.{RANK}.json"), "w") as f:
        json.dump(info, f)


def _nonroot_ring_broadcast(coord) -> str:
    """Announce BROADCAST_RING (wire type 7) with root 1 from every rank
    through the raw ABI — rank 0 is then a non-root ring announcer, which
    the conforming client never produces — and return the refusal."""
    import ctypes
    data = np.ones(4, np.float32)
    shape = (ctypes.c_longlong * 1)(4)
    err = ctypes.create_string_buffer(4096)
    lib = coord._lib
    rc = lib.hvdcoord_submit(b"evil.bcast", 7, 6, 0, 1, 1, shape,
                             data.ctypes.data, data.nbytes, 0, err, len(err))
    assert rc == 0, err.value
    out, nb = ctypes.c_void_p(), ctypes.c_longlong()
    sizes = (ctypes.c_longlong * SIZE)()
    rc = lib.hvdcoord_wait(b"evil.bcast", ctypes.byref(out), ctypes.byref(nb),
                           sizes, err, len(err))
    return f"rc={rc}: {err.value.decode()}"


def timeline(side: Side) -> None:
    x = np.arange(6, dtype=np.float32) + RANK
    side.call("allreduce", x, "tl.sum", op="SUM")
    side.call("allgather", np.ones((RANK + 1, 2), np.float32), "tl.gather")
    side.call("broadcast", x, "tl.bcast", root=SIZE - 1)
    side.call("reducescatter", np.ones(2 * SIZE, np.float32), "tl.rs",
              op="SUM")
    side.call("alltoall", np.ones(2 * SIZE, np.float32), "tl.a2a")
    side.call("allreduce", np.ones(RING_ELEMS, np.float32), "tl.ring",
              op="SUM", plane="ring")
    side.shutdown()
    with open(os.path.join(OUT, f"{PKG}.{RANK}.json"), "w") as f:
        json.dump({"done": True}, f)


def faults(side: Side) -> None:
    """Steps of eager allreduces with the fault injector's step hook
    between them: a ``kill`` or ``mute`` drill on one rank shows as the
    other ranks' ``WorkerFailureError``."""
    if PKG == "jax":
        from horovod_tpu.testing import faults as fi
    else:
        from horovod_tpu_torch.testing import faults as fi
    out = {"outcome": "done"}
    t0 = time.monotonic()
    try:
        for step in range(1, 9):
            side.call("allreduce", np.full(4, float(step), np.float32),
                      f"step.{step}", op="SUM")
            fi.step_hook(step)
            time.sleep(float(os.environ.get("HVD_TEST_STEP_SLEEP", "0")))
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        out = {"outcome": type(e).__name__, "error": str(e),
               "seconds": time.monotonic() - t0}
    out["coord_delay_s"] = time.monotonic() - t0
    with open(os.path.join(OUT, f"{PKG}.{RANK}.json"), "w") as f:
        json.dump(out, f)
    try:
        side.shutdown()
    except Exception:  # noqa: BLE001 — an aborted world's teardown
        pass


def stall(side: Side) -> None:
    """Rank 1 never announces ``stall.x``: under HOROVOD_STALL_TIMEOUT
    rank 0's wait raises StalledError, and a second submit of the name
    is refused."""
    out = {}
    if RANK == 0:
        try:
            side.call("allreduce", np.ones(2, np.float32), "stall.x",
                      op="SUM")
            out["first"] = "no error"
        except Exception as e:  # noqa: BLE001
            out["first"] = f"{type(e).__name__}: {e}"
        try:
            side.call("allreduce", np.ones(2, np.float32), "stall.x",
                      op="SUM")
            out["reuse"] = "no error"
        except Exception as e:  # noqa: BLE001
            out["reuse"] = f"{type(e).__name__}: {e}"
    # Both ranks meet again under a fresh name.
    r, _ = side.call("allreduce", np.ones(2, np.float32), "stall.after",
                     op="SUM")
    out["after"] = r.tolist()
    with open(os.path.join(OUT, f"{PKG}.{RANK}.json"), "w") as f:
        json.dump(out, f)
    side.shutdown()


if __name__ == "__main__":
    s = Side(PKG)
    {"parity": parity, "timeline": timeline, "faults": faults,
     "stall": stall}[SCENARIO](s)
