"""The port's paged KV pool, prefix trie and request queue against the
reference's, op for op on the same inputs.

The port keeps the pools as torch tensors (on the device when serving, on
the CPU here) where the reference keeps numpy; block tables, refcounts,
free lists, copy-on-write copies, scrubs and gathered views must agree
exactly after every operation.
"""
import numpy as np
import pytest
import torch

from repro.models import registry as RR
from repro.serve.batching import PagedKVCache as RKV
from repro.serve.batching import Request as RRequest
from repro.serve.batching import RequestQueue as RQueue
from repro.serve.prefix import PrefixTrie as RTrie
from repro_torch.models import registry as TR
from repro_torch.serve.batching import PagedKVCache as TKV
from repro_torch.serve.batching import Request, RequestQueue
from repro_torch.serve.prefix import PrefixTrie

BS = 4


def _pair(tiers=1, n_blocks=12):
    rcfg = RR.get_smoke_config("yi-6b", dtype="float32")
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32")
    ref = RKV(rcfg, n_slots=3, n_blocks=n_blocks, block_size=BS, tiers=tiers)
    port = TKV(tcfg, n_slots=3, n_blocks=n_blocks, block_size=BS,
               device="cpu", tiers=tiers)
    return ref, port


def _same(ref, port):
    assert port.tables == ref.tables
    assert port._free == ref._free
    np.testing.assert_array_equal(port.refcnt, ref.refcnt)
    np.testing.assert_array_equal(port.pool_k.numpy(), ref.pool_k)
    np.testing.assert_array_equal(port.pool_v.numpy(), ref.pool_v)
    for k, v in port.stats().items():
        assert ref.stats()[k] == v, k


def _kv(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return (a, b), (torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))


@pytest.mark.parametrize("tiers", [1, 2])
def test_paged_pool_lifecycle_matches_reference(tiers):
    """Prefill, prefix adoption, copy-on-write on a decode write into a
    shared block (every tier), runs, frees with scrub, trie eviction and an
    atomic failed ensure."""
    ref, port = _pair(tiers)
    rtrie, ttrie = RTrie(ref), PrefixTrie(port)
    rng = np.random.default_rng(0)
    L, KV, dh = ref.pool_k.shape[2], ref.pool_k.shape[4], ref.pool_k.shape[5]
    prompt = rng.integers(0, 256, 10).astype(np.int32)

    (rk, rv), (tk, tv) = _kv(rng, L, 12, KV, dh)
    for tier in range(tiers):
        ref.write_prefill(0, rk, rv, 10, tier=tier)
        port.write_prefill(0, tk, tv, 10, tier=tier)
    rtrie.insert(prompt[:8], ref.tables[0][:2])
    ttrie.insert(prompt[:8], port.tables[0][:2])
    _same(ref, port)

    other = np.concatenate([prompt[:8], [1, 2, 3]]).astype(np.int32)
    shared = rtrie.match(other)
    assert shared and ttrie.match(other) == shared
    ref.adopt(1, shared)
    port.adopt(1, shared)
    ref.ensure(1, 12)
    port.ensure(1, 12)
    _same(ref, port)

    # a decode step writing slot 0 at 10 and slot 1 INSIDE a shared block
    pos = [10, 5, None]
    rpb, roff = ref.write_coords(pos)
    tpb, toff = port.write_coords(pos)
    assert list(rpb) == tpb and list(roff) == toff
    assert port.n_cow == 1
    (rk, rv), (tk, tv) = _kv(rng, L, 3, KV, dh)
    for tier in range(tiers):
        ref.write_token(rpb, roff, rk, rv, tier=tier)
        port.write_token(tpb, toff, tk, tv, tier=tier)
    (rk, rv), (tk, tv) = _kv(rng, L, 3, KV, dh)
    ref.write_run(1, 8, rk, rv, tier=tiers - 1)
    port.write_run(1, 8, tk, tv, tier=tiers - 1)
    _same(ref, port)
    for slots in (None, [1]):
        for tier in range(tiers):
            for r, t in zip(ref.gather(4, tier=tier, slots=slots),
                            port.gather(4, tier=tier, slots=slots)):
                np.testing.assert_array_equal(t.numpy(), np.asarray(r))

    ref.free_slot(0)
    port.free_slot(0)
    _same(ref, port)
    assert rtrie.evict(2) == ttrie.evict(2)
    _same(ref, port)
    assert ttrie.stats() == rtrie.stats()

    free = port.free_blocks
    with pytest.raises(RuntimeError):
        port.ensure(2, (free + 1) * BS)
    with pytest.raises(RuntimeError):
        ref.ensure(2, (free + 1) * BS)
    assert port.tables[2] == [] and port.free_blocks == free
    _same(ref, port)
    port.free_slot(1)
    assert port.blocks_in_use + port.free_blocks == port.n_blocks - 1
    freed = torch.tensor(port._free)
    assert torch.count_nonzero(port.pool_k[:, freed]) == 0  # scrubbed
    assert torch.count_nonzero(port.pool_v[:, freed]) == 0


def test_request_queue_matches_reference():
    """Arrival order, priorities, FIFO ties and front-of-class requeue."""
    spec = [("a", 0.0, 0), ("b", 0.0, 1), ("c", 0.5, 0), ("d", 0.0, 1),
            ("e", 0.2, 2), ("f", 0.0, 0)]
    rq = RQueue([RRequest(r, [1], 1, arrival=t, priority=p)
                 for r, t, p in spec])
    tq = RequestQueue([Request(r, [1], 1, arrival=t, priority=p)
                       for r, t, p in spec])
    order = []
    for now in (0.0, 0.0, 0.3, 0.3, 1.0, 1.0, 1.0, 1.0):
        a, b = rq.pop_ready(now), tq.pop_ready(now)
        assert (a and a.rid) == (b and b.rid)
        if b is not None and b.rid == "d" and "d" not in order:
            rq.requeue(a)  # bounced once by backpressure
            tq.requeue(b)
        order.append(b and b.rid)
        assert len(rq) == len(tq) and rq.next_arrival() == tq.next_arrival()
    assert order == ["b", "d", "e", "d", "a", "c", "f", None]
    with pytest.raises(ValueError):
        Request("x", [], 1)
