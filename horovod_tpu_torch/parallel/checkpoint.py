"""Integrity-checked checkpoints of the port's training state.

Port of the JAX package's ``parallel/checkpoint.py``: per-leaf CRC32
manifests (``write_manifest`` :81, ``read_manifest`` :119,
``_verify_leaves`` :133, ``verify_checkpoint`` :204), the host snapshot
(``snapshot_to_host`` :317), the sharded flavour (``save_sharded`` :333,
``restore_sharded`` :389, ZeRO state in its world-agnostic canonical form
as ``_canonicalize_zero`` :284 writes it) and the serving restore
(``restore_for_inference`` :552).

**One canonical tree.** Every checkpoint holds the tree the JAX package
would save for the same state, in flax form: params and BatchNorm
statistics by their flax paths (conv kernels ``[kh, kw, Cin, Cout]``, the
LM's ``layers`` a list), the optimizer state per parameter on the same
paths (ZeRO state as its canonical flat bucket vectors, identical at
every world size), the wrapped optimizer's numeric hyperparameters, and
the step as a 0-d int32. Leaf paths are printed as the JAX tree utilities
print key paths (``.params['Conv_0']['kernel']``), so a manifest written
here verifies against the JAX tree of the same state, and the other way
round.

**Storage.** The JAX package's on-disk format belongs to a JAX-only
library, so the port writes its own: one ``.npy`` file per leaf under
``leaves/`` and a JSON index of the tree (``hvd_tree.json``), written into
a temporary directory, fsync'd, then renamed to ``ckpt_<step>`` — a
killed writer never leaves a visible step. The manifest
(``hvd_manifest.json``, the JAX package's format) lands after the rename,
inside the directory, so retention removes it with its bytes. bf16
tensors are stored as f32 (numpy has no bfloat16); every other dtype as
it is.

**One rank's own commit.** Elastic recovery (:mod:`horovod_tpu_torch.
elastic`) commits without a collective: each rank writes its own tree
(:func:`local_tree`, :func:`save_local`) into its own directory and
loads it back (:func:`restore_local`). A ZeRO optimizer contributes this
rank's physical shard, not the canonical form, so such a commit restores
at the same world size only (the JAX package's rule for its env-world
commits).

The hybrid meshes' 2-D canonical form (a ``ZeroPlan`` with a non-scatter
axis) and ``restore_for_inference(mesh=)`` are ``ROADMAP.md`` Queue 1
item 11; int8 serving weights and LoRA adapters are item 12.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..exceptions import CheckpointCorruptError
from ..utils import timeline as _tl

MANIFEST_NAME = "hvd_manifest.json"
INDEX_NAME = "hvd_tree.json"
LEAF_DIR = "leaves"


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"ckpt_{step}")


# -- the canonical tree -----------------------------------------------------
#
# Nodes: ``Fields`` (a dataclass's fields: insertion order, printed
# ``.name``), ``dict`` (sorted keys, printed ``['key']``), ``list``
# (printed ``[i]``) and None (no leaves). Leaves: numpy arrays, or
# ``_Live`` tensors not yet copied to the host.


class Fields(dict):
    """A tree node whose keys are attribute names (the JAX ``TrainState``
    dataclass's fields): flattened in insertion order, printed ``.name``."""


class _Live:
    """A tensor leaf of a live state, with the permutation that takes it
    to its flax layout (None: same layout). ``owned`` tensors are already
    private host copies (ZeRO's canonical gather)."""

    __slots__ = ("tensor", "perm", "owned")

    def __init__(self, tensor: torch.Tensor, perm=None, owned=False):
        self.tensor, self.perm, self.owned = tensor, perm, owned


def keystr(path: Tuple) -> str:
    """A key path as the JAX tree utilities print it: ``("attr", name)``
    as ``.name``, ``("key", k)`` as ``['k']``, ``("idx", i)`` as ``[i]``."""
    out = []
    for kind, k in path:
        out.append(f".{k}" if kind == "attr" else f"[{k!r}]")
    return "".join(out)


def _flatten(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(key path, leaf)`` pairs in the JAX flatten order."""
    if tree is None:
        return []
    if isinstance(tree, Fields):
        return [kv for k, v in tree.items()
                for kv in _flatten(v, path + (("attr", k),))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], path + (("key", k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, path + (("idx", i),))]
    return [(path, tree)]


def _map(fn, tree: Any, path: Tuple = (), with_path: bool = False) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)`` (``fn(key path,
    leaf)`` with ``with_path``)."""
    if tree is None:
        return None
    if isinstance(tree, Fields):
        return Fields((k, _map(fn, v, path + (("attr", k),), with_path))
                      for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (("key", k),), with_path)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, path + (("idx", i),), with_path)
                for i, v in enumerate(tree)]
    return fn(path, tree) if with_path else fn(tree)


def _flax_path(name: str) -> Tuple:
    # A purely numeric part is a list index (the LM's "layers.10"); every
    # other part is a dict key (the flax scope names).
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _perm_of(path: Tuple, ndim: int):
    # Conv kernels: [Cout, Cin, kh, kw] in the port, [kh, kw, Cin, Cout]
    # in flax (convert._to_flax).
    return (2, 3, 1, 0) if path[-1] == "kernel" and ndim == 4 else None


def _build(entries) -> Any:
    """Nested dicts (lists where every key of a level is an index) from
    ``(flax path, leaf)`` pairs; None when there are none."""
    root: Dict = {}
    for path, leaf in entries:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out
    return listify(root) if root else None


def module_tree(named) -> Any:
    """``(dotted name, tensor)`` pairs (``named_parameters()``,
    ``named_buffers()``, or the per-parameter optimizer state under the
    parameters' names) as a flax-form tree of live leaves; None when
    there are none."""
    entries = []
    for name, t in named:
        path = _flax_path(name)
        entries.append((path, _Live(t, _perm_of(path, t.dim()))))
    return _build(entries)


def _hyper_tree(optimizer) -> List[Dict[str, np.ndarray]]:
    """The numeric hyperparameters of each parameter group (lr, momentum,
    betas, …) as f64 host leaves: what the LR callbacks change."""
    out = []
    for g in optimizer.param_groups:
        h = {}
        for k, v in g.items():
            if k == "params" or isinstance(v, bool):
                continue
            if torch.is_tensor(v) and v.numel() == 1:
                v = v.item()
            if isinstance(v, (int, float)):
                h[k] = np.asarray(float(v), np.float64)
            elif isinstance(v, tuple) and v and all(
                    isinstance(x, (int, float)) and not isinstance(x, bool)
                    for x in v):
                h[k] = np.asarray([float(x) for x in v], np.float64)
        out.append(h)
    return out


def _check_plan(plan) -> None:
    if any(plan.extra_axes or ()) or plan.nonscatter:
        raise NotImplementedError(
            "the hybrid meshes' 2-D canonical ZeRO form (a plan with a "
            "non-scatter axis) is ROADMAP.md Queue 1 item 11")


def _zero_mesh_meta(optimizer) -> Optional[dict]:
    """The ZeRO plan's layout (diagnostic manifest metadata), or None."""
    plan = getattr(optimizer, "plan", None)
    if not getattr(optimizer, "zero", False) or plan is None:
        return None
    meta = {"nshards": int(plan.nshards)}
    if plan.hybrid:
        meta["scatter_axis"] = plan.scatter_axis
        meta["nonscatter"] = {a: int(n) for a, n in plan.nonscatter}
    return meta


def opt_tree(optimizer) -> Dict[str, Any]:
    """A ``DistributedOptimizer``'s state in canonical form:
    ``{"hyperparams": [per group], "state": {key: flax tree}}`` on the
    all-reduce plane (one flax tree of the parameters per state key, e.g.
    ``momentum_buffer``), ``{"hyperparams", "zero": [per bucket {key:
    flat vector}]}`` on the ZeRO plane (:func:`~horovod_tpu_torch.
    optimizer.zero_to_canonical`: a collective every rank must enter)."""
    from ..optimizer import zero_to_canonical
    hyper = _hyper_tree(optimizer)
    if getattr(optimizer, "zero", False):
        _check_plan(optimizer.plan)
        canon = zero_to_canonical(optimizer.zero_state())
        return {"hyperparams": hyper,
                "zero": [{k: _Live(v, owned=True) for k, v in st.items()
                          if torch.is_tensor(v)} for st in canon.inner]}
    named = getattr(optimizer, "named_parameters", None)
    if named is None:
        raise TypeError("checkpointing an optimizer needs its parameter "
                        "names: wrap it in DistributedOptimizer")
    per_key: Dict[str, list] = {}
    for name, p in named:
        for k, v in optimizer.state.get(p, {}).items():
            if torch.is_tensor(v):
                per_key.setdefault(k, []).append((name, v))
    return {"hyperparams": hyper,
            "state": {k: module_tree(v) for k, v in per_key.items()}}


def _model_of(params):
    if isinstance(params, torch.nn.Module):
        return params
    raise NotImplementedError(
        "checkpoints hold a model's parameters (an nn.Module); the "
        "pipelined stages' parameter dicts need the hybrid canonical form "
        "of ROADMAP.md Queue 1 item 11")


def state_tree(state) -> Fields:
    """A ``TrainState`` (``model``, ``optimizer``, ``step``) as the
    canonical tree the JAX package saves for its ``TrainState``: ``.step``
    (0-d int32), ``.params``, ``.opt_state``, ``.batch_stats`` (None when
    the model has no buffers)."""
    model = _model_of(getattr(state, "model", None))
    return Fields(
        step=np.asarray(int(state.step), np.int32),
        params=module_tree(model.named_parameters()),
        opt_state=opt_tree(state.optimizer),
        batch_stats=module_tree(model.named_buffers()))


# -- host snapshot -----------------------------------------------------------

def snapshot_to_host(tree: Any, timeline: Any = None) -> Any:
    """The snapshot half of an async checkpoint (``CKPT_SNAPSHOT``
    timeline phase): every live leaf copied into pinned host memory with
    ``non_blocking`` copies and ONE synchronize, then viewed as numpy in
    its flax layout. The result is immutable, so the training loop may
    overwrite the device state while a writer serializes it."""
    with _tl.maybe_op(timeline, "ckpt.snapshot", _tl.CKPT_SNAPSHOT):
        copies = []

        def copy(leaf):
            if not isinstance(leaf, _Live):
                return leaf
            t = leaf.tensor.detach()
            if t.dtype == torch.bfloat16:   # numpy has no bfloat16
                t = t.float()
            if leaf.owned and t.device.type == "cpu":
                host = t
            elif t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                copies.append(t.device)
            else:
                host = t.clone()
            return _Live(host, leaf.perm, owned=True)
        staged = _map(copy, tree)
        for dev in set(copies):
            torch.cuda.synchronize(dev)

        def view(leaf):
            if not isinstance(leaf, _Live):
                return leaf
            arr = leaf.tensor.numpy()
            return arr if leaf.perm is None else arr.transpose(leaf.perm)
        return _map(view, staged)


# -- storage -----------------------------------------------------------------

def _contiguous(a) -> np.ndarray:
    # np.ascontiguousarray turns a 0-d array into shape (1,).
    a = np.asarray(a)
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _encode(tree: Any, files: List[Tuple[str, np.ndarray]]) -> Any:
    if tree is None:
        return {"none": True}
    if isinstance(tree, Fields):
        return {"fields": [[k, _encode(v, files)] for k, v in tree.items()]}
    if isinstance(tree, dict):
        return {"dict": [[k, _encode(tree[k], files)] for k in sorted(tree)]}
    if isinstance(tree, (list, tuple)):
        return {"list": [_encode(v, files) for v in tree]}
    arr = _contiguous(tree)
    name = f"{LEAF_DIR}/{len(files):06d}.npy"
    files.append((name, arr))
    return {"leaf": name, "shape": list(arr.shape), "dtype": str(arr.dtype)}


def write_tree(path: str, tree: Any) -> None:
    """Write a host tree as ``path`` (replacing a checkpoint already
    there): leaf files and the index into ``<path>.tmp-<pid>``, each
    fsync'd, then one rename."""
    files: List[Tuple[str, np.ndarray]] = []
    index = {"format": 1, "tree": _encode(tree, files)}
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, LEAF_DIR))
    for name, arr in files:
        with open(os.path.join(tmp, name), "wb") as f:
            np.save(f, arr, allow_pickle=False)
            f.flush()
            os.fsync(f.fileno())
    with open(os.path.join(tmp, INDEX_NAME), "w") as f:
        json.dump(index, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(os.path.join(tmp, LEAF_DIR))
    _fsync_dir(tmp)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(parent)


class _Stub:
    """A leaf of a read index, not loaded yet."""

    __slots__ = ("file", "shape", "dtype")

    def __init__(self, rec: dict):
        self.file = rec["leaf"]
        self.shape = tuple(rec["shape"])
        self.dtype = rec["dtype"]


def _decode(node: Any) -> Any:
    if "none" in node:
        return None
    if "fields" in node:
        return Fields((k, _decode(v)) for k, v in node["fields"])
    if "dict" in node:
        return {k: _decode(v) for k, v in node["dict"]}
    if "list" in node:
        return [_decode(v) for v in node["list"]]
    return _Stub(node)


def read_index(path: str) -> Any:
    """The checkpoint's tree with :class:`_Stub` leaves (reads no array
    bytes). Raises :class:`CheckpointCorruptError` naming the path when
    the directory or its index is missing or unreadable."""
    if not os.path.isdir(path):
        raise CheckpointCorruptError(path, "checkpoint directory missing")
    try:
        with open(os.path.join(path, INDEX_NAME)) as f:
            index = json.load(f)
        return _decode(index["tree"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointCorruptError(
            path, f"unreadable checkpoint: {type(e).__name__}: {e}") from e


def _load(path: str, tree: Any, prefix: Tuple = ()) -> Any:
    """Load every stub of ``tree`` (a subtree at key path ``prefix``);
    a truncated or garbled leaf file raises :class:`CheckpointCorruptError`
    naming the path and the leaf."""
    def one(kp, stub):
        name = keystr(kp)
        try:
            arr = np.load(os.path.join(path, stub.file), allow_pickle=False)
        except (OSError, ValueError, EOFError) as e:
            raise CheckpointCorruptError(
                path, f"leaf {name} ({stub.file}) unreadable: "
                      f"{type(e).__name__}: {e}") from e
        if arr.shape != stub.shape or str(arr.dtype) != stub.dtype:
            raise CheckpointCorruptError(
                path, f"leaf {name} ({stub.file}) holds {arr.dtype}"
                      f"{list(arr.shape)}, the index records "
                      f"{stub.dtype}{list(stub.shape)}")
        return arr
    return _map(one, tree, prefix, with_path=True)


# -- integrity manifests -----------------------------------------------------

def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(_contiguous(arr)).cast("B"))


def _leaf_records(tree: Any) -> List[dict]:
    return [{"path": keystr(kp), "shape": list(np.shape(leaf)),
             "dtype": str(np.asarray(leaf).dtype), "crc32": _crc(leaf)}
            for kp, leaf in _flatten(tree)]


def write_manifest(path: str, tree: Any, step: Optional[int] = None,
                   extra_meta: Optional[dict] = None) -> str:
    """Write the integrity manifest of the checkpoint at ``path`` (the JAX
    package's format: ``"format": 1``, per-leaf path, shape, dtype and
    CRC32, the step, and the world and mesh shape that wrote it). Called
    strictly after the checkpoint's rename, so a crash leaves either no
    manifest or a complete one."""
    meta: dict = {"format": 1, "leaves": _leaf_records(tree)}
    if extra_meta:
        meta.update(extra_meta)
    if step is not None:
        meta["step"] = int(step)
    if runtime.is_initialized():
        meta["world_size"] = runtime.size()
        meta["mesh_shape"] = {"hvd": runtime.size()}
    manifest_path = os.path.join(path, MANIFEST_NAME)
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, manifest_path)
    return manifest_path


def read_manifest(path: str) -> Optional[dict]:
    """The manifest of the checkpoint at ``path``; None when the
    checkpoint has none (legacy, unverifiable)."""
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        return None
    try:
        with open(manifest_path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            path, f"unreadable manifest {MANIFEST_NAME}: {e!r}") from e


def _verify_leaves(path: str, manifest: dict, tree: Any,
                   subset: bool = False) -> int:
    """Match a read tree's leaves against the manifest records; raises
    :class:`CheckpointCorruptError` naming the first offending leaf.

    The JAX package's algorithm: a multiset match over (shape, dtype,
    crc), so the save-time and restore-time key paths need not agree but
    the bytes must. ``subset`` lets the tree cover part of the manifest
    (:func:`restore_for_inference`). Returns the number of leaves whose
    CRC was checked."""
    expected: dict = {}
    for rec in manifest.get("leaves", []):
        key = (tuple(rec["shape"]), str(rec["dtype"]))
        expected.setdefault(key, []).append(rec)
    flat = _flatten(tree)
    if not subset:
        n_expected = sum(len(v) for v in expected.values())
        if len(flat) != n_expected:
            raise CheckpointCorruptError(
                path, f"manifest records {n_expected} leaves but the "
                      f"checkpoint restored {len(flat)}")
    checked = 0
    for kp, leaf in flat:
        name = keystr(kp)
        arr = np.asarray(leaf)
        key = (tuple(arr.shape), str(arr.dtype))
        candidates = expected.get(key)
        if not candidates:
            raise CheckpointCorruptError(
                path, f"leaf {name} with shape {arr.shape} dtype "
                      f"{arr.dtype} matches no manifest record")
        crc = _crc(arr)
        hit = next((r for r in candidates if r["crc32"] == crc), None)
        if hit is None:
            hit = next((r for r in candidates if r["crc32"] is None), None)
            if hit is None:
                want = ", ".join(r["path"] for r in candidates[:3])
                raise CheckpointCorruptError(
                    path, f"leaf {name} (shape {arr.shape}, dtype "
                          f"{arr.dtype}) CRC mismatch — bytes differ from "
                          f"what the manifest recorded for {want}")
            candidates.remove(hit)
            continue
        candidates.remove(hit)
        checked += 1
    return checked


def read_checkpoint(path: str, verify: bool = True) -> Any:
    """Read the whole checkpoint at ``path`` into host numpy, checked
    against its manifest first when ``verify`` (a manifest-less checkpoint
    reads unverified). Raises :class:`CheckpointCorruptError` on any
    mismatch or unreadable file."""
    tree = _load(path, read_index(path))
    if verify:
        manifest = read_manifest(path)
        if manifest is not None:
            _verify_leaves(path, manifest, tree)
    return tree


def verify_checkpoint(path: str, *, allow_unverified: bool = True) -> bool:
    """Verify the checkpoint at ``path`` against its integrity manifest:
    a full read, every leaf's CRC32/shape/dtype and the leaf count.
    Raises :class:`CheckpointCorruptError` naming the path and the
    offending leaf on any mismatch, including a file that fails to read.
    Returns True when verification ran, False for a manifest-less
    checkpoint (tolerated when ``allow_unverified``, raised otherwise)."""
    if not os.path.isdir(path):
        raise CheckpointCorruptError(path, "checkpoint directory missing")
    manifest = read_manifest(path)
    if manifest is None:
        if allow_unverified:
            return False
        raise CheckpointCorruptError(
            path, f"no {MANIFEST_NAME} — cannot verify integrity")
    _verify_leaves(path, manifest, _load(path, read_index(path)))
    return True


# -- loading a tree into a live state ----------------------------------------

def _inverse(perm):
    return None if perm is None else tuple(int(i) for i in np.argsort(perm))


def _leaves_by_path(tree: Any) -> Dict[str, Any]:
    return {keystr(kp): leaf for kp, leaf in _flatten(tree)}


def _to_tensor(arr: np.ndarray, perm, like: torch.Tensor,
               device=None) -> torch.Tensor:
    inv = _inverse(perm)
    arr = _contiguous(arr if inv is None else arr.transpose(inv))
    return torch.from_numpy(arr).to(device=like.device if device is None
                                    else device, dtype=like.dtype)


def _match(template: Any, saved: Any, what: str):
    """Pair the live template's leaves with the saved ones by key path;
    a missing or extra leaf raises ``ValueError``."""
    want, got = _leaves_by_path(template), _leaves_by_path(saved)
    if set(want) != set(got):
        missing = sorted(set(want) - set(got))[:3]
        extra = sorted(set(got) - set(want))[:3]
        raise ValueError(f"the checkpoint's {what} do not match this "
                         f"state's: missing {missing}, extra {extra}")
    return [(want[k], got[k]) for k in want]


def load_module_(named, saved: Any, what: str) -> None:
    """Copy a saved flax-form tree into the tensors ``named`` lists."""
    with torch.no_grad():
        for live, arr in _match(module_tree(named), saved, what):
            live.tensor.copy_(_to_tensor(arr, live.perm, live.tensor))


def _load_hyper(optimizer, saved: List[Dict[str, np.ndarray]]) -> None:
    for g, h in zip(optimizer.param_groups, saved):
        for k, v in h.items():
            cur = g.get(k)
            if torch.is_tensor(cur):
                cur.fill_(float(v))
            elif isinstance(cur, tuple):
                g[k] = tuple(float(x) for x in np.asarray(v))
            elif isinstance(cur, int) and not isinstance(cur, bool):
                g[k] = int(v)
            else:
                g[k] = float(v)


def load_opt_(optimizer, saved: Dict[str, Any], broadcast: bool = False
              ) -> None:
    """Put a saved canonical optimizer state into ``optimizer`` (a
    ``DistributedOptimizer``), replacing its state. ZeRO state is
    re-sharded onto this world's plan (:func:`~horovod_tpu_torch.
    optimizer.zero_from_canonical`); with ``broadcast`` (a world above
    one) every rank first takes rank 0's canonical vectors."""
    from ..optimizer import ZeroShardedState, zero_from_canonical
    _load_hyper(optimizer, saved.get("hyperparams") or [])
    if getattr(optimizer, "zero", False):
        if "zero" not in saved:
            raise ValueError("a ZeRO optimizer restores from a checkpoint "
                             "of ZeRO state (the saving run had zero=False)")
        inner = [{k: torch.from_numpy(np.array(v)) for k, v in st.items()}
                 for st in saved["zero"]]
        if broadcast:
            dev = runtime.device()
            for st in inner:
                for k in sorted(st):
                    t = st[k].to(dev)
                    dist.broadcast(t, src=0)
                    st[k] = t.cpu()
        template = optimizer.zero_state()
        optimizer.load_zero_state(zero_from_canonical(
            ZeroShardedState(inner=inner, plan=template.plan), template))
        return
    if "state" not in saved:
        raise ValueError("a replicated optimizer restores from a checkpoint "
                         "of replicated state (the saving run had zero=True)")
    params = dict(optimizer.named_parameters)
    group = optimizer.param_groups[0]
    on_device = group.get("capturable") or group.get("fused")
    for p in params.values():
        optimizer.state[p] = {}
    for key, tree in saved["state"].items():
        got = _leaves_by_path(tree)
        for kp, live in _flatten(module_tree(params.items())):
            arr = got.get(keystr(kp))
            if arr is None:
                continue
            p = live.tensor
            if arr.ndim:
                t = _to_tensor(arr, live.perm, p)
            else:
                t = torch.from_numpy(np.array(arr)).to(
                    p.device if on_device else "cpu")
            optimizer.state[p][key] = t


def load_state_(state, tree: Any) -> None:
    """Load a saved ``TrainState`` tree into ``state`` in place: params,
    BatchNorm buffers, the optimizer's state and hyperparameters, the
    step."""
    model = _model_of(state.model)
    load_module_(model.named_parameters(), tree["params"], "params")
    load_module_(model.named_buffers(), tree.get("batch_stats"),
                 "batch_stats")
    load_opt_(state.optimizer, tree["opt_state"],
              broadcast=runtime.is_initialized() and runtime.size() > 1)
    state.step = int(np.asarray(tree["step"]))


# -- the sharded flavour -----------------------------------------------------

@runtime.maps_peer_failures
def save_sharded(directory: str, step: int, params: Any, opt_state: Any,
                 max_to_keep: Optional[int] = None) -> str:
    """Write ``{"params", "opt_state"}`` at ``step``: ``params`` a model,
    ``opt_state`` its ``DistributedOptimizer``. Every rank must call it
    (ZeRO state is gathered to its canonical form, a collective); rank 0
    writes the bytes, the manifest and the retention, and every rank
    returns once the checkpoint is durable. The manifest records the
    writing plan's layout (``zero_mesh``)."""
    from ..trainer import apply_retention
    path = _ckpt_path(directory, step)
    live = {"params": module_tree(_model_of(params).named_parameters()),
            "opt_state": opt_tree(opt_state)}
    zero_mesh = _zero_mesh_meta(opt_state)
    if not runtime.is_initialized() or runtime.rank() == 0:
        tl = runtime.world().timeline if runtime.is_initialized() else None
        host = snapshot_to_host(live, timeline=tl)
        with _tl.maybe_op(tl, "ckpt.write", _tl.CKPT_WRITE):
            write_tree(path, host)
            write_manifest(path, host, step=step,
                           extra_meta={"zero_mesh": zero_mesh}
                           if zero_mesh else None)
            apply_retention(directory, path, max_to_keep)
    if runtime.is_initialized() and runtime.size() > 1:
        dist.barrier()
    return path


def _resolve_step(directory: str, step: Optional[int]) -> int:
    from ..ops.collectives import broadcast_object
    from ..trainer import latest_checkpoint_step
    if step is None:
        step = latest_checkpoint_step(directory)
    if runtime.is_initialized() and runtime.size() > 1:
        step = broadcast_object(step, root_rank=0)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return int(step)


@runtime.maps_peer_failures
def restore_sharded(directory: str, params_template: Any,
                    opt_state_template: Any, step: Optional[int] = None,
                    verify: bool = True) -> Tuple[Any, Any, int]:
    """Restore ``(params, opt_state)`` into the templates — the live model
    and its ``DistributedOptimizer``, loaded in place and returned with
    the step. The resolved step comes from rank 0's directory scan
    (broadcast), so every rank resumes the same step. ``verify`` checks
    the manifest before anything is loaded. ZeRO state is re-sharded onto
    this world, which may differ from the writing one, provided the model
    and ``HOROVOD_FUSION_THRESHOLD`` (the bucket plan) are unchanged."""
    step = _resolve_step(directory, step)
    path = _ckpt_path(directory, step)
    tree = read_checkpoint(path, verify=verify)
    if getattr(opt_state_template, "zero", False):
        manifest = read_manifest(path)
        saved_world = manifest.get("world_size") if manifest else None
        if (runtime.is_initialized() and saved_world is not None
                and saved_world != runtime.size()):
            print(f"[ckpt] re-sharding ZeRO optimizer state: checkpoint "
                  f"written by a world of {saved_world}, restoring into "
                  f"{runtime.size()}", file=sys.stderr, flush=True)
    model = _model_of(params_template)
    load_module_(model.named_parameters(), tree["params"], "params")
    load_opt_(opt_state_template, tree["opt_state"],
              broadcast=runtime.is_initialized() and runtime.size() > 1)
    return params_template, opt_state_template, step


# -- one rank's own commit ----------------------------------------------------

def local_tree(params: Any, opt_state: Any) -> Dict[str, Any]:
    """This rank's commit of a model and its ``DistributedOptimizer``
    (or None), with no collective: ``{"params", "opt_state"}`` as
    :func:`save_sharded` names them, plus ``"batch_stats"`` when the
    model has buffers. A ZeRO optimizer's state is this rank's own shard
    (``"zero_shard"``: per bucket ``{key: shard}``), not the canonical
    form."""
    model = _model_of(params)
    opt = None
    if opt_state is not None and getattr(opt_state, "zero", False):
        _check_plan(opt_state.plan)
        opt = {"hyperparams": _hyper_tree(opt_state),
               "zero_shard": [{k: _Live(v) for k, v in st.items()
                               if torch.is_tensor(v)}
                              for st in opt_state.zero_state().inner]}
    elif opt_state is not None:
        opt = opt_tree(opt_state)
    tree = {"params": module_tree(model.named_parameters()),
            "opt_state": opt}
    stats = module_tree(model.named_buffers())
    if stats is not None:
        tree["batch_stats"] = stats
    return tree


def local_meta(opt_state: Any) -> Optional[dict]:
    """Manifest metadata of a rank's commit: the ZeRO plan's layout and
    the rank whose shard it holds (None without ZeRO)."""
    zero_mesh = _zero_mesh_meta(opt_state)
    if zero_mesh is None:
        return None
    return {"zero_mesh": zero_mesh,
            "zero_rank": runtime.rank() if runtime.is_initialized() else 0}


def save_local(directory: str, step: int, host: Any,
               max_to_keep: Optional[int] = None,
               extra_meta: Optional[dict] = None) -> str:
    """Write ``host`` (a :func:`snapshot_to_host` of :func:`local_tree`)
    as ``<directory>/ckpt_<step>``: leaf files and the rename, the
    manifest, then the retention of ``directory``. No collective: every
    rank writes its own directory. Returns the path."""
    from ..trainer import apply_retention
    path = _ckpt_path(directory, step)
    write_tree(path, host)
    write_manifest(path, host, step=step, extra_meta=extra_meta)
    apply_retention(directory, path, max_to_keep)
    return path


def restore_local(directory: str, step: int, params: Any, opt_state: Any,
                  verify: bool = True) -> None:
    """Load this rank's commit at ``step`` into ``params`` (the model:
    parameters and buffers) and ``opt_state`` (its
    ``DistributedOptimizer``, or None) in place, verified against the
    manifest first when ``verify``. A ZeRO shard loads only into the
    rank of the world size that wrote it."""
    from ..optimizer import ZeroShardedState
    path = _ckpt_path(directory, step)
    tree = read_checkpoint(path, verify=verify)
    model = _model_of(params)
    load_module_(model.named_parameters(), tree["params"], "params")
    load_module_(model.named_buffers(), tree.get("batch_stats"),
                 "batch_stats")
    saved = tree.get("opt_state")
    if opt_state is None:
        return
    if saved is None:
        raise ValueError(f"{path} holds no optimizer state")
    if "zero_shard" not in saved:
        load_opt_(opt_state, saved)
        return
    if not getattr(opt_state, "zero", False):
        raise ValueError(f"{path} holds a ZeRO shard; the optimizer has "
                         f"zero=False")
    manifest = read_manifest(path) or {}
    here = (runtime.size(), runtime.rank()) if runtime.is_initialized() \
        else (1, 0)
    there = (manifest.get("world_size", 1), manifest.get("zero_rank", 0))
    if there != here:
        raise ValueError(
            f"{path} holds the ZeRO shard of rank {there[1]} of a world of "
            f"{there[0]}; a rank's own commit restores at the same world "
            f"size and rank only (this is rank {here[1]} of {here[0]})")
    _load_hyper(opt_state, saved.get("hyperparams") or [])
    template = opt_state.zero_state()
    inner = [{k: torch.from_numpy(np.array(v)) for k, v in st.items()}
             for st in saved["zero_shard"]]
    opt_state.load_zero_state(ZeroShardedState(inner=inner,
                                               plan=template.plan))


# -- serving restore ----------------------------------------------------------

#: restore_for_inference's serving dtypes (None = as stored).
INFERENCE_DTYPES = (None, "fp32", "bf16")


def _inference_cast(variables: Any, dtype: Optional[str]) -> Any:
    """The serving dtype, applied after verification (manifests record the
    stored bytes). bf16 leaves come back as CPU ``torch.bfloat16``
    tensors: numpy has no bfloat16."""
    if dtype is None:
        return variables

    def one(a):
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.floating):
            return a
        if dtype == "fp32":
            return a.astype(np.float32)
        return torch.from_numpy(_contiguous(a)).to(torch.bfloat16)
    return _map(one, variables)


def restore_for_inference(directory: str, step: Optional[int] = None, *,
                          mesh=None, spec_fn=None,
                          dtype: Optional[str] = None) -> Dict[str, Any]:
    """Load a checkpoint's serving state: ``{"params": ...}`` plus
    ``"batch_stats"`` when the checkpoint carries them, as flax-form host
    numpy (what :func:`horovod_tpu_torch.convert.params_from_jax` and
    ``resnet_from_jax`` take). Works on both flavours —
    ``save_checkpoint``'s ``TrainState`` and ``save_sharded``'s
    ``{params, opt_state}`` — and reads only those subtrees: the
    optimizer state's files are never opened.

    ``dtype``: ``None`` serves the stored dtypes, ``"fp32"``/``"bf16"``
    cast every float leaf after verification (bf16 as CPU
    ``torch.bfloat16`` tensors). A truncated file, a garbage directory or
    a flipped byte raises :class:`~horovod_tpu_torch.exceptions.
    CheckpointCorruptError` naming the path (and the leaf at fault); when
    a manifest is present the read leaves are CRC-checked against it as
    a subset.

    ``dtype="int8"`` is ``ROADMAP.md`` Queue 1 item 12; ``mesh=``/
    ``spec_fn=`` (sharded serving placement) item 11."""
    if dtype == "int8":
        raise NotImplementedError(
            "restore_for_inference(dtype='int8') — int8 serving weights "
            "are ROADMAP.md Queue 1 item 12")
    if dtype not in INFERENCE_DTYPES:
        raise ValueError(
            f"restore_for_inference dtype={dtype!r} is not supported; "
            f"supported: {INFERENCE_DTYPES} (None = as stored)")
    if mesh is not None or spec_fn is not None:
        raise NotImplementedError(
            "restore_for_inference(mesh=, spec_fn=) — sharded serving "
            "placement comes with the hybrid meshes, ROADMAP.md Queue 1 "
            "item 11")
    from ..trainer import latest_checkpoint_step
    if step is None:
        step = latest_checkpoint_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _ckpt_path(directory, int(step))
    index = read_index(path)
    if not isinstance(index, dict) or "params" not in index:
        raise ValueError(
            f"{path} has no 'params' subtree — not a checkpoint this "
            f"framework wrote")
    attrs = isinstance(index, Fields)
    variables: Dict[str, Any] = {}
    for k in ("params", "batch_stats"):
        if index.get(k) is not None:
            prefix = (("attr", k),) if attrs else (("key", k),)
            variables[k] = _load(path, index[k], prefix)
    manifest = read_manifest(path)
    if manifest is not None:
        _verify_leaves(path, manifest,
                       (Fields if attrs else dict)(variables), subset=True)
    return _inference_cast(variables, dtype)


def save_adapter(*args, **kwargs):
    """LoRA adapter persistence is ``ROADMAP.md`` Queue 1 item 12."""
    raise NotImplementedError(
        "save_adapter — LoRA adapters are ROADMAP.md Queue 1 item 12")


def restore_adapter(*args, **kwargs):
    """LoRA adapter persistence is ``ROADMAP.md`` Queue 1 item 12."""
    raise NotImplementedError(
        "restore_adapter — LoRA adapters are ROADMAP.md Queue 1 item 12")
