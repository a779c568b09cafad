"""Port parity: the host-side ``BlockManager`` (free list, refcounts, the
salted prefix registry, reclaim, the host tier, the owner ledger) and
``prefix_route_digest`` against the JAX package's, and copy-on-write
prefix sharing in the port's engine.

The manager is host-side numpy on both sides: one script of operations
drives a JAX manager and a port manager, and after every step their
refcounts, free-list order, registry (keys, blocks and LRU order), host
tier (keys and order), route digests, owner ledger and return values
must be equal.
"""

import numpy as np
import pytest

import torch_serve_common as common
from horovod_tpu.parallel import kv_blocks as jkv
from horovod_tpu_torch.parallel import kv_blocks as tkv

BS = 4
A = np.arange(12, dtype=np.int32)          # 3 full blocks
B = np.array([7] * 8, np.int32)            # 2 full blocks
C = np.concatenate([A[:8], [9, 9, 9, 9]]).astype(np.int32)  # shares 2
SALT = b"t\x003\x00"


def _state(bm):
    return {"ref": bm._ref.tolist(), "free": list(bm._free),
            "registry": list(bm._registry.items()),
            "host": list(bm._host.items()),
            "route": sorted(bm._route.items()),
            "owner": sorted(bm._owner.items()),
            "owned": sorted(bm._owned.items()),
            "gauges": bm.gauges(), "tenants": bm.tenant_gauges(),
            "digests": bm.route_digests()}


def _script():
    """(name, fn(bm, blocks) -> return value) in order; ``blocks`` is a
    dict the steps share, filled by the same allocations on both sides
    (compared through the return values)."""
    def alloc(key, n, owner=None):
        def f(bm, b):
            b[key] = bm.alloc(n, owner=owner)
            return b[key]
        return f

    def register(toks, key, n, salt=b"", digest=True):
        def f(bm, b):
            bm.register_prefix(
                toks, b[key], n, salt=salt,
                route_digest=(jkv.prefix_route_digest(toks, BS)
                              if digest else None))
        return f

    def offload(n, owner=None):
        def f(bm, b):
            out = []
            for key, blk in bm.offload_candidates(n, owner=owner):
                out.append((key, blk, bm.offload_commit(
                    key, {"blk": int(blk)})))
            return out
        return f

    def promote(toks, start, salt=b""):
        def f(bm, b):
            out = []
            for key, _ in bm.host_lookup(toks, start, salt=salt):
                blk = bm.alloc(1)[0]
                out.append((blk, bm.promote(key, blk)))
            return out
        return f

    return [
        ("alloc a", alloc("a", 3, owner="base")),
        ("register a", register(A, "a", 3)),
        ("lookup a", lambda bm, b: bm.lookup_prefix(A)),
        ("lookup c", lambda bm, b: bm.lookup_prefix(C)),
        ("release a", lambda bm, b: bm.release(b["a"])),
        ("alloc c", alloc("c", 2, owner="base")),
        ("retain hits", lambda bm, b: bm.retain(bm.lookup_prefix(C)[:2])),
        ("register c", lambda bm, b: bm.register_prefix(
            C, bm.lookup_prefix(C)[:2] + b["c"][:1], 3)),
        ("salted miss", lambda bm, b: bm.lookup_prefix(A, salt=SALT)),
        ("alloc b", alloc("b", 2, owner="t")),
        ("register b salted", register(B, "b", 2, salt=SALT)),
        ("set budget", lambda bm, b: bm.set_budget("t", 4)),
        ("budget", lambda bm, b: (bm.budget("t"), bm.owned_count("t"),
                                  bm.owned_count("base"))),
        ("reclaim blocked", lambda bm, b: bm.reclaim(bm.usable)),
        ("release c", lambda bm, b: bm.release(
            bm.lookup_prefix(C)[:2] + b["c"])),
        ("release b", lambda bm, b: bm.release(b["b"])),
        ("reclaim owner t", lambda bm, b: bm.reclaim(bm.free_count + 1,
                                                     owner="t")),
        ("offload 2", offload(2)),
        ("host lookup", lambda bm, b: [k for k, _ in bm.host_lookup(A, 0)]),
        ("offload owner base", offload(1, owner="base")),
        ("promote a", promote(A, 0)),
        ("lookup a again", lambda bm, b: bm.lookup_prefix(A)),
        ("reclaim all", lambda bm, b: bm.reclaim(bm.usable)),
        ("double free", lambda bm, b: _raises(bm.release, b["c"][:1])),
        ("exhausted", lambda bm, b: _raises(bm.alloc, bm.usable + 1)),
    ]


def _raises(fn, *args):
    try:
        fn(*args)
    except RuntimeError as e:
        return str(e).split(" —")[0]
    return None


def test_block_manager_matches_jax_step_for_step():
    jbm = jkv.BlockManager(10, BS, host_blocks=2)
    tbm = tkv.BlockManager(10, BS, host_blocks=2)
    jb, tb = {}, {}
    for name, step in _script():
        got, want = step(tbm, tb), step(jbm, jb)
        assert got == want, name
        assert _state(tbm) == _state(jbm), name


def test_reclaim_skips_stream_referenced_entries():
    """A reclaim that cannot reach its target evicts only the cold
    entries (JAX ``test_paged_kv``), on both sides alike."""
    for mod in (jkv, tkv):
        bm = mod.BlockManager(4, 4)
        cold = bm.alloc(1)
        bm.register_prefix(np.arange(4, dtype=np.int32), cold, 1)
        bm.release(cold)
        hot = bm.alloc(1)
        bm.register_prefix(np.full(4, 9, np.int32), hot, 1)
        assert bm.reclaim(3) is False
        assert bm.free_count == 2 and bm.registry_size == 1
        assert bm.lookup_prefix(np.full(4, 9, np.int32)) == hot
        bm.release(hot)
        assert bm.reclaim(3) is True
        assert bm.free_count == 3 and bm.registry_size == 0


@pytest.mark.parametrize("block_size", [1, 4, 16])
@pytest.mark.parametrize("adapter", [None, "a0", "tenant\x00x"])
def test_prefix_route_digest_matches_jax(block_size, adapter):
    rng = np.random.RandomState(block_size)
    for n in (0, block_size - 1, block_size, 3 * block_size + 1):
        toks = rng.randint(0, 50000, n).astype(np.int32)
        for form in (toks, toks.tolist(), toks.astype(np.int64)):
            assert (tkv.prefix_route_digest(form, block_size, adapter)
                    == jkv.prefix_route_digest(form, block_size, adapter))
    assert tkv.prefix_route_digest([1, 2], 4) is None


@pytest.fixture(scope="module")
def model():
    return common.torch_model(common.make_tree())


PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5]


def test_cow_divergence_counters_and_block_accounting(model):
    """A shared full-block prefix is written once and read by every
    sharer; divergent suffixes land in private blocks; every block not
    pinned by the registry returns to the pool after each drain (JAX
    ``test_paged_kv``'s counters, exactly)."""
    eng = common.engine(model, kv_layout="paged", paged_kernel=True,
                        block_size=4, prefix_reuse=True,
                        default_max_new_tokens=3)
    ref = common.engine(model, kv_layout="paged", paged_kernel=True,
                        block_size=4)
    try:
        a = eng.generate(PROMPT, timeout=common.TIMEOUT)
        snap = eng.stats()
        assert snap["generation"]["prefix_misses_total"] == 1
        assert snap["blocks"]["registered_prefix_blocks"] == 2
        free_after_a = snap["blocks"]["free"]
        b = eng.generate(PROMPT, timeout=common.TIMEOUT)
        assert b["tokens"] == a["tokens"]
        c = eng.generate(PROMPT + [9, 8], timeout=common.TIMEOUT)
        r = ref.generate(PROMPT + [9, 8], timeout=common.TIMEOUT,
                         max_new_tokens=3)
        assert c["tokens"] == r["tokens"]
        snap = eng.stats()
        assert snap["generation"]["prefix_hits_total"] == 2
        assert snap["generation"]["prefix_hit_blocks_total"] == 4
        assert snap["prefix_hit_rate"] == pytest.approx(2 / 3)
        assert snap["blocks"]["free"] == free_after_a
        assert snap["active_slots"] == 0
        h1 = eng.submit(PROMPT + [7], max_new_tokens=5)
        h2 = eng.submit(PROMPT + [6], max_new_tokens=5)
        assert h1.result(common.TIMEOUT)["n_tokens"] == 5
        assert h2.result(common.TIMEOUT)["n_tokens"] == 5
        snap = eng.stats()
        assert snap["blocks"]["free"] == free_after_a
        # the streams hold nothing: what is used is the registry's pin
        assert (snap["blocks"]["used"]
                == snap["blocks"]["registered_prefix_blocks"])
        assert snap["prefix_digests"] == [
            tkv.prefix_route_digest(PROMPT, 4)]
        assert eng.prefix_digests() == (tkv.prefix_route_digest(PROMPT, 4),)
        assert eng.route_block_size == 4
    finally:
        eng.shutdown()
        ref.shutdown()
    assert ref.prefix_digests() == () and ref.stats()["prefix_digests"] == []


def test_prefix_streams_match_jax_engine(model):
    """Greedy streams of the port's prefix-sharing engine equal the JAX
    engine's, cold and on a hit."""
    tree = common.make_tree()
    jeng = common.jax_engine(tree, kv_layout="paged", block_size=4,
                             prefix_reuse=True)
    eng = common.engine(model, kv_layout="paged", paged_kernel=True,
                        block_size=4, prefix_reuse=True)
    try:
        for p in (PROMPT, PROMPT + [9, 8], PROMPT):
            want = jeng.generate(p, timeout=600)["tokens"]
            assert eng.generate(p, timeout=common.TIMEOUT)["tokens"] == want
        assert (eng.stats()["generation"]["prefix_hits_total"]
                == jeng.stats()["generation"]["prefix_hits_total"] == 2)
    finally:
        jeng.shutdown()
        eng.shutdown()
