"""Host coordination client: the ctypes binding over the native core.

Port of the JAX package's ``coord/client.py``. Every rank's eager
collective is announced by name to a rank-0 coordinator over TCP, which
validates dtype, shape, root and op across ranks (a mismatch raises
:class:`~..exceptions.FailedPreconditionError` on every rank instead of
hanging), fuses responses, warns on stalls (and raises
:class:`~..exceptions.StalledError` under ``HOROVOD_STALL_TIMEOUT``),
writes the timeline and aborts the world on a dead or silent rank
(heartbeats, ``HVD_HEARTBEAT_TIMEOUT``). The core is ``csrc/
coordinator.cc``, built by :mod:`._build`.

Tensors go in and come out as ``torch.Tensor``: a CUDA tensor is staged
to host bytes and its result returns to the input's device. bf16 travels
as its 16 raw bits (dtype code 9). A dtype outside the wire's table
(:data:`_DTYPES`), for example ``float16``, raises ``TypeError``.

The admin RPC (:func:`resize_status`, :func:`request_resize`) speaks the
coordinator's v7 admin frames over a plain socket, with no native code.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..exceptions import (FailedPreconditionError, StalledError,
                          TransportError, WorkerFailureError)
from ..testing import faults as _faults
from ..utils import config as _config
from . import _build


class PendingResize(NamedTuple):
    """A live resize announced by the coordinator (v7 admin plane)."""

    target_world: int   # new world size the job must quiesce into
    coord_port: int     # coordinator port reserved for the NEW world
    generation: int     # monotonically increasing resize counter


# -- admin RPC (v7): 8-byte native-order length prefix, then
# {u8 kResizeRequest, i32 target}; reply {u8 kResizeReply, u8 ok, str msg,
# i32 world, i32 pending_target, i32 new_port, i32 generation}, where str
# is {i64 len, bytes}.

_MSG_RESIZE_REQUEST = 7
_MSG_RESIZE_REPLY = 8


def _admin_rpc(addr: str, target: int, timeout: float) -> dict:
    host, _, port_s = addr.partition(":")
    port = int(port_s) if port_s else 29521
    # A wall-clock budget for the whole exchange, not a per-recv bound: a
    # foreign process on the port cannot park the caller a byte at a time.
    deadline = time.monotonic() + timeout

    def _recv_exact(s, n, what):
        buf = b""
        while len(buf) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TransportError(
                    f"admin exchange with {addr} exceeded its {timeout}s "
                    f"budget while reading the {what}")
            s.settimeout(min(left, timeout))
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise TransportError(
                    f"coordinator at {addr} closed the admin connection "
                    f"while sending the {what}")
            buf += chunk
        return buf

    with socket.create_connection((host or "127.0.0.1", port),
                                  timeout=timeout) as s:
        body = struct.pack("<Bi", _MSG_RESIZE_REQUEST, int(target))
        s.sendall(struct.pack("<Q", len(body)) + body)
        (length,) = struct.unpack("<Q", _recv_exact(s, 8, "length prefix"))
        if length > 4096:
            raise TransportError(
                f"oversized admin reply ({length} bytes) from {addr} — "
                f"not a horovod_tpu coordinator?")
        reply = _recv_exact(s, length, "reply frame")
    try:
        tag, ok = struct.unpack_from("<BB", reply, 0)
        if tag != _MSG_RESIZE_REPLY:
            raise TransportError(
                f"unexpected admin reply tag {tag} from {addr} (mixed "
                f"horovod_tpu builds? the admin plane is protocol v7+)")
        (msg_len,) = struct.unpack_from("<q", reply, 2)
        off = 10
        if msg_len < 0 or off + msg_len + 16 > len(reply):
            raise TransportError(
                f"malformed admin reply from {addr} (message length "
                f"{msg_len} does not fit the {len(reply)}-byte frame)")
        msg = reply[off:off + msg_len].decode(errors="replace")
        off += msg_len
        world, pending, new_port, generation = struct.unpack_from(
            "<iiii", reply, off)
    except struct.error as e:
        raise TransportError(
            f"truncated admin reply from coordinator at {addr}: {e}"
        ) from None
    return {"ok": bool(ok), "message": msg, "world": world,
            "pending_target": pending, "coord_port": new_port,
            "generation": generation}


def resize_status(addr: str, *, timeout: float = 5.0,
                  supervisor: bool = False) -> dict:
    """The coordinator's world size and pending resize, if any:
    ``{"world", "pending_target", "coord_port", "generation", ...}``.
    Raises :class:`TransportError` or ``OSError`` when the coordinator is
    unreachable. ``supervisor=True`` marks the supervising launcher's
    poll (it releases the coordinator's teardown linger)."""
    return _admin_rpc(addr, -1 if supervisor else 0, timeout)


def request_resize(addr: str, target_world: int, *,
                   timeout: float = 10.0) -> dict:
    """Ask the running world at ``addr`` to resize to ``target_world``
    ranks. Idempotent for the same target; raises
    :class:`TransportError` when the coordinator refuses."""
    if int(target_world) < 1:
        raise ValueError(
            f"resize target must be >= 1 rank, got {target_world}")
    out = _admin_rpc(addr, int(target_world), timeout)
    if not out["ok"]:
        raise TransportError(
            f"coordinator at {addr} refused resize to {target_world}: "
            f"{out['message']}")
    return out


_REQ_TYPES = {"allreduce": 0, "allgather": 1, "broadcast": 2,
              "alltoall": 3, "reducescatter": 4}

# dtype name -> wire enum (coordinator.cc DType), the JAX package's table.
_DTYPES = {
    "uint8": 0, "int8": 1, "uint16": 2, "int16": 3, "int32": 4,
    "int64": 5, "float32": 6, "float64": 7, "bool": 8, "bfloat16": 9,
}
# The numpy dtype a wire dtype's bytes are read as on the host (bf16 as
# its raw bits).
_HOST = {torch.bfloat16: np.uint16, torch.uint16: np.uint16}

_PLANES = {"auto": 0, "star": 1, "ring": 2}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _host_array(t: torch.Tensor) -> np.ndarray:
    """``t``'s bytes on the host as a contiguous numpy array."""
    t = t.detach().contiguous().cpu()
    if t.dtype in _HOST:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(raw: bytes, dtype: torch.dtype) -> torch.Tensor:
    arr = np.frombuffer(raw, dtype=_HOST.get(dtype) or
                        torch.empty(0, dtype=dtype).numpy().dtype).copy()
    if dtype in _HOST:
        return torch.from_numpy(arr.view(np.int16)).view(dtype)
    return torch.from_numpy(arr)


class CoordClient:
    """Per-process handle on the coordination plane."""

    def __init__(self, rank: int, size: int, host: str, port: int):
        self._lib = _build.library()
        self.rank = rank
        self.size = size
        tl_path = _config.timeline_path() if rank == 0 else None
        err = ctypes.create_string_buffer(1024)
        rc = self._lib.hvdcoord_init(
            rank, size, host.encode(), port,
            _config.fusion_threshold_bytes(),
            _config.stall_warning_secs(),
            tl_path.encode() if tl_path else None, err, len(err))
        if rc != 0:
            detail = err.value.decode() or f"rc={rc}"
            raise TransportError(
                f"coordination plane init failed (rank {rank}, "
                f"{host}:{port}): {detail}")
        # Names this rank announced and has not waited for: the
        # coordinator drops a rank's second announcement of an in-flight
        # name, so a second submit would wait forever; fail fast instead.
        self._inflight: set = set()
        # Names whose wait raised StalledError: still half-announced at
        # the coordinator, never usable again.
        self._stalled: set = set()

    @classmethod
    def from_env(cls, rank: int, size: int) -> "CoordClient":
        addr = _config.coordinator_address()
        if addr is None:
            raise TransportError(
                "multi-process world without HVD_COORD_ADDR; launch via "
                "tpurun or set HVD_COORD_ADDR=host:port")
        host, _, port_s = addr.partition(":")
        try:
            port = int(port_s) if port_s else 29521
        except ValueError:
            raise ValueError(
                f"malformed HVD_COORD_ADDR {addr!r}: the port part "
                f"{port_s!r} is not an integer (expected host:port, e.g. "
                f"10.0.0.1:29521)") from None
        if not 1 <= port <= 65535:
            raise ValueError(
                f"malformed HVD_COORD_ADDR {addr!r}: port {port} outside "
                f"1-65535")
        return cls(rank, size, host or "127.0.0.1", port)

    # -- eager collectives ---------------------------------------------------
    def collective(self, kind: str, x, name: str, *, op=None, root_rank=0,
                   plane: str = "auto") -> torch.Tensor:
        """Run one named eager collective through the plane."""
        return self.wait(self.submit(kind, x, name, op=op,
                                     root_rank=root_rank, plane=plane))

    def submit(self, kind: str, x, name: str, *, op=None,
               root_rank=0, plane: str = "auto") -> "CoordHandle":
        """Announce and send without waiting; complete with :meth:`wait`.
        Many submits may be in flight at once, which is what feeds the
        coordinator's response fusion. ``plane``: ``"auto"``
        (``HOROVOD_RING_THRESHOLD`` elects), ``"star"`` (the
        coordinator relays) or ``"ring"`` (client to client); it must
        agree across ranks, and a non-root broadcast always announces the
        star (the root alone elects)."""
        from ..ops.collectives import Op

        t = x if torch.is_tensor(x) else torch.as_tensor(x)
        average = False
        red_op = 0
        if kind in ("allreduce", "reducescatter"):
            resolved = op if op is not None else Op.SUM
            average = resolved is Op.AVERAGE
            red_op = {Op.SUM: 0, Op.AVERAGE: 0, Op.MIN: 1, Op.MAX: 2,
                      Op.PRODUCT: 3}[resolved]
        dtype_name = _dtype_name(t.dtype)
        if dtype_name not in _DTYPES:
            raise TypeError(f"unsupported dtype {dtype_name} for eager "
                            f"coordination-plane collective")
        if name in self._stalled:
            raise ValueError(
                f"tensor name {name!r} previously raised StalledError and "
                f"is still pending at the coordinator; a stalled "
                f"collective cannot be retried under the same name — use "
                f"a fresh name (name=None auto-names)")
        if name in self._inflight:
            raise ValueError(
                f"tensor name {name!r} is already in flight on rank "
                f"{self.rank}; synchronize() the first handle before "
                f"reusing the name (or pass name=None for auto-naming)")
        if plane not in _PLANES:
            raise ValueError(f"plane must be one of {sorted(_PLANES)}, "
                             f"got {plane!r}")

        # HVD_FAULT_SPEC coord:delay_ms=N; a no-op unless the spec has it.
        _faults.coord_delay()

        send_payload = not (kind == "broadcast" and self.rank != root_rank)
        data = _host_array(t) if send_payload else None
        shape = (ctypes.c_longlong * max(t.dim(), 1))(*t.shape)
        err = ctypes.create_string_buffer(4096)
        rc = self._lib.hvdcoord_submit(
            name.encode(), _REQ_TYPES[kind], _DTYPES[dtype_name], red_op,
            root_rank, t.dim(), shape,
            data.ctypes.data if data is not None else None,
            data.nbytes if data is not None else 0, _PLANES[plane],
            err, len(err))
        if rc == 4:
            # The world already aborted: fail fast with the diagnosis.
            raise WorkerFailureError(self._abort_record(err.value.decode()))
        if rc != 0:
            raise TransportError(err.value.decode())
        self._inflight.add(name)
        return CoordHandle(self, kind, name, tuple(t.shape), t.dtype,
                           t.device, average)

    def wait(self, handle: "CoordHandle") -> torch.Tensor:
        """Block until ``handle``'s collective completes and return its
        result (any in-flight handle may be waited first)."""
        if handle._result is not None:
            return handle._result
        out = ctypes.c_void_p()
        out_nbytes = ctypes.c_longlong()
        sizes = (ctypes.c_longlong * self.size)()
        err = ctypes.create_string_buffer(4096)
        try:
            rc = self._lib.hvdcoord_wait(
                handle.name.encode(), ctypes.byref(out),
                ctypes.byref(out_nbytes), sizes, err, len(err))
        finally:
            self._inflight.discard(handle.name)
        if rc == 1:
            raise FailedPreconditionError(err.value.decode())
        if rc == 3:
            # HOROVOD_STALL_TIMEOUT strict mode.
            self._stalled.add(handle.name)
            raise StalledError(err.value.decode())
        if rc == 4:
            # World abort: the message names the dead party.
            raise WorkerFailureError(self._abort_record(err.value.decode()))
        if rc != 0:
            raise TransportError(err.value.decode())

        raw = ctypes.string_at(out.value, out_nbytes.value)
        self._lib.hvdcoord_free(out)
        result = _from_host(raw, handle.dtype)

        kind, shape = handle.kind, handle.shape
        if kind == "allgather":
            total_rows = int(sum(sizes[i] for i in range(self.size)))
            result = result.reshape((total_rows,) + tuple(shape[1:]))
        elif kind == "reducescatter":
            result = result.reshape((shape[0] // self.size,)
                                    + tuple(shape[1:]))
        else:
            result = result.reshape(shape)
        if handle.average:
            # The JAX client's host division (numpy, then jnp.asarray
            # without x64): bf16 promotes to f32, an integer sum divides
            # in f64 and lands in f32.
            if result.dtype == torch.bfloat16:
                result = result.float() / self.size
            elif result.is_floating_point():
                result = result / self.size
            else:
                result = (result.double() / self.size).float()
        handle._result = result.to(handle.device)
        return handle._result

    # -- observability: fusion and the ring plane ---------------------------
    def responses_received(self) -> int:
        return int(self._lib.hvdcoord_responses_received())

    def ops_completed(self) -> int:
        return int(self._lib.hvdcoord_ops_completed())

    def ring_ops(self) -> int:
        return int(self._lib.hvdcoord_ring_ops())

    def ring_bytes_sent(self) -> int:
        return int(self._lib.hvdcoord_ring_bytes_sent())

    # -- liveness plane ------------------------------------------------------
    def aborted(self) -> bool:
        """Whether the world has aborted (a rank or the coordinator
        died)."""
        return bool(self._lib.hvdcoord_aborted())

    def abort_message(self) -> Optional[str]:
        """The abort's diagnosis (it names the dead party), or None while
        the world lives. A submit into an aborted world returns the
        message before it sends anything."""
        if not self.aborted():
            return None
        err = ctypes.create_string_buffer(4096)
        shape = (ctypes.c_longlong * 1)(0)
        rc = self._lib.hvdcoord_submit(b"__abort_probe__", 0, 6, 0, 0, 1,
                                       shape, None, 0, 0, err, len(err))
        return err.value.decode() if rc == 4 else None

    def _abort_record(self, msg: str) -> str:
        """Leave this rank's post-mortem the moment an abort surfaces: an
        ``abort`` flight-recorder event and a dump of the ring. Returns
        ``msg`` unchanged."""
        try:
            from ..obs import flightrec
            flightrec.record("abort", rank=self.rank, error=msg)
            flightrec.dump(reason=f"coordinator abort: {msg}",
                           rank=self.rank)
        except Exception:  # noqa: BLE001 — never mask the abort itself
            pass
        return msg

    def mute_heartbeats(self, mute: bool = True) -> None:
        """Fault hook: stop this rank's heartbeats while the process and
        its socket stay alive; the coordinator aborts the world after
        ``HVD_HEARTBEAT_TIMEOUT``."""
        self._lib.hvdcoord_mute_heartbeats(1 if mute else 0)

    def mute_coordinator_acks(self, mute: bool = True) -> None:
        """Fault hook (rank 0 only): stop the coordinator's heartbeat
        acks, so every client detects a dead coordinator."""
        self._lib.hvdcoord_coord_mute_acks(1 if mute else 0)

    def pending_resize(self) -> Optional[PendingResize]:
        """The live resize the coordinator announced, if one is pending,
        else None (one atomic load)."""
        t, p, gen = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        if not self._lib.hvdcoord_pending_resize(
                ctypes.byref(t), ctypes.byref(p), ctypes.byref(gen)):
            return None
        return PendingResize(target_world=int(t.value),
                             coord_port=int(p.value),
                             generation=int(gen.value))

    def shutdown(self) -> None:
        self._lib.hvdcoord_shutdown()


class CoordHandle:
    """An eager collective in flight: redeem it with
    :meth:`CoordClient.wait` (or ``synchronize``)."""

    def __init__(self, client: CoordClient, kind: str, name: str,
                 shape: tuple, dtype: torch.dtype, device: torch.device,
                 average: bool):
        self.client = client
        self.kind = kind
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.device = device
        self.average = average
        self._result = None

    def wait(self) -> torch.Tensor:
        return self.client.wait(self)
