"""Port parity: the rest of the eager collectives (``ops.collectives``)
and the sparse path (``ops.sparse``) against the JAX package, on the CPU.

Each rank of a spawned gloo world of 2 and of 4
(``torch_dist_worker.run_collectives``, one spawn each) runs every
collective on its slice of the same numpy inputs; the JAX functions run
in-trace, inside ``shard_map`` over a CPU mesh of as many devices, on
the whole inputs:

* ``allreduce`` for every op on f32, on bool (SUM and AVERAGE count in
  int32 as JAX's ``psum`` of a bool does; MIN/MAX stay bool) and int16;
* ``allgather`` (equal first dims against JAX's; variable first dims and
  a 0-dim tensor against the concatenation ``MPI_Allgatherv`` defines,
  and against JAX's ``allgather_ragged`` trimmed to the valid rows),
  ``allgather_ragged``, ``broadcast`` from every root, ``alltoall``,
  ``reducescatter`` (SUM against JAX; AVERAGE is JAX's SUM / world,
  which the JAX function computes with the initialized world's size;
  MAX against numpy), ``grouped_allreduce``;
* the async handles against the synchronous calls, redeemed in reverse
  order, and twice; ``broadcast_object`` and ``allgather_object``;
* ``allreduce_indexed_slices`` against JAX's, and an
  ``nn.Embedding(sparse=True)`` gradient's sparse average against the
  dense one;
* the refusals: a bad root, shapes that differ past the first
  dimension, rows past ``max_size`` or a bad ``valid_size``, an op other
  than SUM/AVERAGE on slices, indivisible rows — and the world still
  works after them;
* the rest of the core API: ``Compression.bf16`` is bitwise
  ``wire_dtype="bf16"`` on the all-reduce and the ZeRO planes and
  matches JAX's ``allreduce_gradients(compression=Compression.bf16)``
  within 2^-7 of each leaf's largest value (bf16 rounding of the wire,
  in other orders: ``tests/test_torch_wire.py``'s bf16 limit), with
  JAX's refusals; ``process_index``/``process_count``; the exceptions'
  names, bases and messages.

Tolerance: f32 sums and averages rtol 1e-6 (other summation orders);
everything else exact.
"""

import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from horovod_tpu import exceptions as jexc
from horovod_tpu import optimizer as jopt
from horovod_tpu.ops import collectives as jc
from horovod_tpu.ops import sparse as jsparse
from horovod_tpu_torch import exceptions as texc

WORLDS = (2, 4)
F32 = dict(rtol=1e-6, atol=1e-6)


def _inputs(world):
    rng = np.random.RandomState(world)
    return {
        "f32": rng.randn(world, 6, 5).astype(np.float32),
        "bools": rng.rand(world, 7) > 0.5,
        "i16": rng.randint(-300, 300, (world, 5)).astype(np.int16),
        "var": [rng.randn(r + 1, 3).astype(np.float32)
                for r in range(world)],
        "ragged": rng.randn(world, 4, 3).astype(np.float32),
        "valid": np.array([(r * 3 + 1) % 5 for r in range(world)],
                          np.int32),
        "a2a": rng.randn(world, world * 2, 3).astype(np.float32),
        "rs": rng.randn(world, world * 3, 2).astype(np.float32),
        "group": [rng.randn(world, 9).astype(np.float32),
                  rng.randn(world, 3, 4).astype(np.float32),
                  rng.randn(world, 40).astype(np.float32)],
        "values": rng.randn(world, 3, 4).astype(np.float32),
        "indices": rng.randint(0, 10, (world, 3)).astype(np.int64),
        "dense_shape": (10, 4),
        "emb": rng.randn(10, 4).astype(np.float32),
        "tokens": rng.randint(0, 10, (world, 6)).astype(np.int64),
        "comp": [rng.randn(world, 37).astype(np.float32) * 3,
                 rng.randn(world, 5, 7).astype(np.float32) * 1e-3,
                 rng.randn(world, 300).astype(np.float32)],
    }


def _spawn(world, tmp_path_factory):
    workdir = tmp_path_factory.mktemp(f"torch_coll{world}")
    inp = _inputs(world)
    with open(workdir / "coll_inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run_collectives,
             args=(world, port, str(workdir)), nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(workdir / f"coll_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inp, ranks


@pytest.fixture(scope="module", params=WORLDS)
def world(request, tmp_path_factory):
    return (request.param,) + _spawn(request.param, tmp_path_factory)


def _jax(fn, world, *arrays, out_per_rank=False):
    """``fn`` of each rank's block in-trace over a ``world``-device mesh;
    the output replicated (rank 0's), or stacked per rank."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("hvd",))
    spec = P("hvd") if out_per_rank else P()

    def body(*xs):
        out = fn(*[x[0] for x in xs])
        if out_per_rank:
            out = jax.tree_util.tree_map(lambda o: o[None], out)
        return out
    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P("hvd"),) * len(arrays),
                              out_specs=spec, check_vma=False))
    return jax.tree_util.tree_map(np.asarray,
                                  f(*[jnp.asarray(a) for a in arrays]))


def _all_ranks(ranks, key, fn):
    for r, got in enumerate(ranks):
        fn(r, got[key])


def test_allreduce_every_op_matches_jax(world):
    n, inp, ranks = world
    for op in jc.Op:
        want = _jax(lambda x: jc.allreduce(x, op=op), n, inp["f32"])
        for got in ranks:
            np.testing.assert_allclose(got["allreduce"][op.name], want,
                                       **F32, err_msg=op.name)


def test_allreduce_of_bool_and_int16_follows_the_carrier_table(world):
    n, inp, ranks = world
    for op in ("SUM", "AVERAGE", "MIN", "MAX"):
        want = _jax(lambda x: jc.allreduce(x, op=jc.Op[op]), n,
                    inp["bools"])
        for got in ranks:
            g = got["bool"][op]
            np.testing.assert_allclose(g, want, **F32, err_msg=op)
            assert g.dtype == {"SUM": np.int32, "AVERAGE": np.float32,
                               "MIN": np.bool_, "MAX": np.bool_}[op], op
    for op in ("SUM", "MAX"):
        want = _jax(lambda x: jc.allreduce(x, op=jc.Op[op]), n, inp["i16"])
        for got in ranks:
            assert got["i16"][op].dtype == np.int16
            np.testing.assert_array_equal(got["i16"][op], want)


def test_allgather_matches_jax_and_concatenates_variable_rows(world):
    n, inp, ranks = world
    want = _jax(jc.allgather, n, inp["f32"])
    var = np.concatenate(inp["var"])
    # JAX's in-trace form of a variable-first-dim gather: each rank's
    # rows padded to the longest, then trimmed by the gathered sizes.
    width = max(len(v) for v in inp["var"])
    padded = np.stack([np.pad(v, ((0, width - len(v)), (0, 0)))
                       for v in inp["var"]])
    sizes = np.array([len(v) for v in inp["var"]], np.int32)
    g, s = _jax(lambda x, vs: jc.allgather_ragged(x, vs, width), n, padded,
                sizes)
    ragged = np.concatenate([g[r * width:r * width + c]
                             for r, c in enumerate(s)])
    np.testing.assert_array_equal(ragged, var)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["allgather"], want)
        np.testing.assert_array_equal(got["allgather_var"], var)
        np.testing.assert_array_equal(got["allgather_scalar"],
                                      np.arange(n, dtype=np.float32) + 0.5)


def test_allgather_ragged_matches_jax(world):
    n, inp, ranks = world
    g, s = _jax(lambda x, vs: jc.allgather_ragged(x, vs, 4), n,
                inp["ragged"], inp["valid"])
    for got in ranks:
        np.testing.assert_array_equal(got["ragged"][0], g)
        np.testing.assert_array_equal(got["ragged"][1], s)
        assert got["ragged"][1].dtype == np.int32


def test_broadcast_from_every_root_matches_jax(world):
    n, inp, ranks = world
    for root in range(n):
        want = _jax(lambda x: jc.broadcast(x, root_rank=root), n,
                    inp["f32"])
        np.testing.assert_array_equal(want, inp["f32"][root])
        for got in ranks:
            np.testing.assert_array_equal(got["broadcast"][root], want)
    for got in ranks:
        np.testing.assert_array_equal(got["broadcast_bool"],
                                      inp["bools"][1])


def test_alltoall_matches_jax(world):
    n, inp, ranks = world
    want = _jax(jc.alltoall, n, inp["a2a"], out_per_rank=True)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["alltoall"], want[r])


def test_reducescatter_matches_jax(world):
    n, inp, ranks = world
    want = _jax(lambda x: jc.reducescatter(x, op=jc.Op.SUM), n, inp["rs"],
                out_per_rank=True)
    rows = inp["rs"].shape[1] // n
    for r, got in enumerate(ranks):
        rs = got["reducescatter"]
        np.testing.assert_allclose(rs["SUM"], want[r], **F32)
        np.testing.assert_allclose(rs["AVERAGE"], want[r] / n, **F32)
        np.testing.assert_array_equal(
            rs["MAX"], inp["rs"].max(0)[r * rows:(r + 1) * rows])


def test_async_handles_equal_the_synchronous_calls(world):
    n, inp, ranks = world
    for got in ranks:
        avg, var, bcast = got["async"]
        np.testing.assert_array_equal(avg, got["allreduce"]["AVERAGE"])
        np.testing.assert_array_equal(var, got["allgather_var"])
        np.testing.assert_array_equal(bcast, inp["f32"][n - 1])
        np.testing.assert_array_equal(got["async_again"], avg)


def test_object_collectives(world):
    n, _, ranks = world
    for got in ranks:
        assert got["broadcast_object"] == {"rank": 1, "epoch": 7}
        assert got["allgather_object"] == [["x"] * r for r in range(n)]


def test_grouped_allreduce_matches_jax(world):
    n, inp, ranks = world
    want = _jax(lambda *xs: jc.grouped_allreduce(list(xs),
                                                 fusion_threshold=64),
                n, *inp["group"])
    for got in ranks:
        for g, w in zip(got["grouped"], want):
            np.testing.assert_allclose(g, w, **F32)


def test_allreduce_indexed_slices_matches_jax(world):
    n, inp, ranks = world

    def fn(v, i):
        out = jsparse.allreduce_indexed_slices(
            jsparse.IndexedSlices(v, i, inp["dense_shape"]))
        return out.values, out.indices
    values, indices = _jax(fn, n, inp["values"], inp["indices"])
    for got in ranks:
        gv, gi, shape = got["slices"]
        np.testing.assert_allclose(gv, values, **F32)
        np.testing.assert_array_equal(gi, indices)
        assert shape == inp["dense_shape"]
        np.testing.assert_allclose(got["slices_sum"], values * n, **F32)


def test_sparse_embedding_gradient_averages_as_the_dense_one(world):
    _, _, ranks = world
    for got in ranks:
        e = got["emb"]
        assert e["is_sparse"] and e["roundtrip"]
        np.testing.assert_allclose(e["sparse_avg"], e["dense_avg"], **F32)


@pytest.mark.parametrize("case,needle", [
    ("bad_root", "out of range"), ("bad_root_async", "out of range"),
    ("bad_root_object", "out of range"),
    ("ragged_shapes", "first dimension only"),
    ("ragged_rows", "max_size is 4"), ("ragged_valid", "valid_size 5"),
    ("sparse_op", "SUM/AVERAGE"), ("alltoall_rows", "divisible"),
    ("alltoall_axis", "split_axis=0"), ("reducescatter_rows", "divisible"),
])
def test_refusals(world, case, needle):
    n, inp, ranks = world
    for got in ranks:
        assert needle in got["refusals"][case], got["refusals"][case]
        np.testing.assert_allclose(got["after_refusals"],
                                   inp["f32"].sum(0), **F32)


def test_compression_bf16_is_the_bf16_wire_and_matches_jax(world):
    n, inp, ranks = world
    want = _jax(lambda *xs: jopt.allreduce_gradients(
        list(xs), compression=jopt.Compression.bf16,
        fusion_threshold=1 << 20), n, *inp["comp"])
    for got in ranks:
        c = got["compression"]
        for zero in (False, True):
            for a, b in zip(c[zero]["compression"], c[zero]["wire"]):
                assert a.tobytes() == b.tobytes()
            for a, w in zip(c[zero]["compression"], want):
                np.testing.assert_allclose(
                    a, w, rtol=0, atol=2.0 ** -7 * np.abs(w).max())
            # Compression.none keeps full precision: the bf16 rounding
            # shows against it.
            assert any(not np.array_equal(a, b) for a, b in
                       zip(c[zero]["none"], c[zero]["compression"]))
        for a, b in zip(c["alias"], c[True]["wire"]):
            assert a.tobytes() == b.tobytes()
        ref = c["refusals"]
        assert "compression= and wire_dtype= both set" in ref["both"]
        assert "conflicts with wire_dtype" in ref["zero_fp8"]
        assert "unsupported compression" in ref["unknown"]


def test_process_index_and_count(world):
    n, _, ranks = world
    assert [r["process"] for r in ranks] == [(i, n) for i in range(n)]


def test_exceptions_match_jax():
    names = ("HorovodError", "NotInitializedError", "FailedPreconditionError",
             "TransportError", "WorkerFailureError",
             "CheckpointCorruptError", "CheckpointTimeoutError",
             "NonFiniteGradError", "StalledError", "ServerOverloadedError",
             "DeadlineExceededError", "ServerClosedError")
    for name in names:
        t, j = getattr(texc, name), getattr(jexc, name)
        assert [b.__name__ for b in t.__mro__] == \
            [b.__name__ for b in j.__mro__], name
    e_t = texc.CheckpointCorruptError("/ck/ckpt_3", "leaf .step bad")
    e_j = jexc.CheckpointCorruptError("/ck/ckpt_3", "leaf .step bad")
    assert str(e_t) == str(e_j)
    assert (e_t.path, e_t.detail) == (e_j.path, e_j.detail)
    assert str(texc.CheckpointCorruptError("/p")) == \
        str(jexc.CheckpointCorruptError("/p"))
    assert str(texc.NotInitializedError()) == str(
        jexc.NotInitializedError()).replace("horovod_tpu.", "horovod_tpu_torch.")
    import horovod_tpu_torch as hvd
    assert all(getattr(hvd, name) is getattr(texc, name) for name in names)
