"""Request-level batching state: queue, slots, and a paged KV cache.

  * :class:`Request` / :class:`RequestQueue` - arrival- and priority-ordered
    intake.
  * :class:`Slot` - one occupied batch lane.
  * :class:`PagedKVCache` - a block pool with a free list. Every slot's KV
    lives in fixed-size blocks named by a per-slot block table.

The pools ``pool_k``/``pool_v`` are DEVICE tensors; the block tables,
refcounts and free list stay on the host. Gathers, token writes,
copy-on-write copies and scrubs are indexed ops on the device, so no step
copies the pool between host and device.

Physical block 0 is scratch: idle lanes read and write it so every decode
step keeps a fixed shape, and no live slot attends to it.

Block lifecycle: every non-scratch block carries a REFCOUNT; the last
``release`` scrubs it to zero and returns it to the LIFO free list. Every
write path is copy-on-write: a write landing in a block with refcount > 1
first copies the block (all tiers) into a fresh allocation and repoints
only the writer's table entry. ``ensure`` is all-or-nothing: on exhaustion
it raises without growing the table.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is seconds relative to the start
    of the serve loop (0 = already waiting); higher ``priority`` admits
    first, equal priorities keep FIFO."""

    rid: str
    prompt: np.ndarray  # (S,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0
    priority: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"{self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"{self.rid}: max_new_tokens must be >= 1")


class RequestQueue:
    """Two-stage intake: a time heap for not-yet-arrived requests and a
    priority heap for ready ones. ``requeue`` puts a popped-but-unadmitted
    request back at the FRONT of its priority class."""

    def __init__(self, requests: Optional[List[Request]] = None):
        self._arrivals: list = []  # (arrival, seq, req)
        self._ready: list = []     # (-priority, seq, req)
        self._seq = 0
        self._front = -1
        for r in requests or []:
            self.push(r)

    def push(self, req: Request) -> None:
        heapq.heappush(self._arrivals, (req.arrival, self._seq, req))
        self._seq += 1

    def requeue(self, req: Request) -> None:
        heapq.heappush(self._ready, (-req.priority, self._front, req))
        self._front -= 1

    def _promote(self, now: float) -> None:
        while self._arrivals and self._arrivals[0][0] <= now:
            _, seq, req = heapq.heappop(self._arrivals)
            heapq.heappush(self._ready, (-req.priority, seq, req))

    def pop_ready(self, now: float) -> Optional[Request]:
        self._promote(now)
        if self._ready:
            return heapq.heappop(self._ready)[2]
        return None

    def next_arrival(self) -> Optional[float]:
        """Earliest instant at which SOME request is (or was) ready."""
        vals = []
        if self._arrivals:
            vals.append(self._arrivals[0][0])
        if self._ready:
            vals.append(min(t[2].arrival for t in self._ready))
        return min(vals) if vals else None

    def __len__(self) -> int:
        return len(self._arrivals) + len(self._ready)


@dataclasses.dataclass
class Slot:
    """Per-lane decode state while a request occupies a batch slot."""

    req: Request
    pos: int  # next KV write position == current sequence length
    next_token: int  # pending input token (last sampled)
    out: List[int]
    t_admit: float
    token_times: List[float]
    queue_wait_s: float = 0.0
    prefix_tokens: int = 0  # prompt tokens adopted from the prefix cache

    @property
    def done(self) -> bool:
        return len(self.out) >= self.req.max_new_tokens

    @property
    def worst_positions(self) -> int:
        return len(self.req.prompt) + self.req.max_new_tokens


class PagedKVCache:
    """Block-pooled KV storage on the device.

    pool_k / pool_v: (tiers, n_blocks, L, block_size, KV, dh). ``gather``
    produces the contiguous (L, B, Sv, KV, dh) view a decode step attends
    over, sized by the deepest active slot. ``tiers`` > 1 keeps several
    pools behind one block layout (shared tables, free list, refcounts)."""

    def __init__(self, cfg: ModelConfig, n_slots: int, n_blocks: int,
                 block_size: int, device: torch.device, dtype=None,
                 tiers: int = 1):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        if tiers < 1:
            raise ValueError("need >= 1 KV tier")
        self.cfg = cfg
        self.n_slots = n_slots
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.tiers = tiers
        self.device = torch.device(device)
        shape = (tiers, n_blocks, cfg.n_layers, block_size,
                 cfg.n_kv_heads_eff, cfg.dh)
        dtype = dtype or cfg.param_dtype
        self.pool_k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.pool_v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(1, n_blocks))  # LIFO
        self.tables: List[List[int]] = [[] for _ in range(n_slots)]
        # 0 = free (or scratch), 1 = exclusively owned, >1 = shared
        self.refcnt = np.zeros(n_blocks, np.int32)
        self._ever_used: set = set()
        self.n_alloc = 0
        self.n_reused = 0
        self.n_cow = 0
        self.peak_blocks = 0

    # -- accounting ---------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """PHYSICAL live blocks: a shared block counts once."""
        return int((self.refcnt[1:] > 0).sum())

    def blocks_for(self, n_pos: int) -> int:
        return -(-n_pos // self.block_size)

    def stats(self) -> dict:
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "kv_tiers": self.tiers,
            "allocations": self.n_alloc,
            "reused_blocks": self.n_reused,
            "cow_copies": self.n_cow,
            "peak_blocks": self.peak_blocks,
        }

    # -- allocation ---------------------------------------------------------

    def _alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                "paged KV pool exhausted - admission control should have "
                "reserved worst-case blocks; raise n_blocks")
        b = self._free.pop()
        if b in self._ever_used:
            self.n_reused += 1
        self._ever_used.add(b)
        self.n_alloc += 1
        self.refcnt[b] = 1
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use)
        return b

    def retain(self, block: int) -> None:
        if block <= 0 or block >= self.n_blocks or self.refcnt[block] < 1:
            raise ValueError(f"retain: block {block} is not a live block")
        self.refcnt[block] += 1

    def release(self, block: int) -> None:
        """Drop one reference; the last release scrubs the block."""
        if block <= 0 or block >= self.n_blocks or self.refcnt[block] < 1:
            raise ValueError(f"release: block {block} is not a live block")
        self.refcnt[block] -= 1
        if self.refcnt[block] == 0:  # scrub: no K/V leaks into a reuse
            self.pool_k[:, block] = 0
            self.pool_v[:, block] = 0
            self._free.append(block)

    def adopt(self, slot: int, blocks: List[int]) -> None:
        """Append already-live shared blocks to ``slot``'s table."""
        t = self.tables[slot]
        for b in blocks:
            self.retain(b)
            t.append(b)

    def ensure(self, slot: int, n_pos: int) -> None:
        """Grow ``slot``'s table until positions [0, n_pos) fit, or raise
        without growing it."""
        t = self.tables[slot]
        need = self.blocks_for(n_pos) - len(t)
        if need > len(self._free):
            raise RuntimeError(
                "paged KV pool exhausted - admission control should have "
                "reserved worst-case blocks; raise n_blocks")
        for _ in range(need):
            t.append(self._alloc())

    def free_slot(self, slot: int) -> None:
        # reversed: the slot's FIRST block is re-granted first
        for b in reversed(self.tables[slot]):
            self.release(b)
        self.tables[slot] = []

    def _ensure_owned(self, slot: int, block_idx: int) -> int:
        """Copy-on-write before a write into a shared block."""
        pb = self.tables[slot][block_idx]
        if self.refcnt[pb] == 1:
            return pb
        nb = self._alloc()  # raises on exhaustion BEFORE any state moves
        self.pool_k[:, nb] = self.pool_k[:, pb]
        self.pool_v[:, nb] = self.pool_v[:, pb]
        self.tables[slot][block_idx] = nb
        self.release(pb)
        self.n_cow += 1
        return nb

    # -- data movement ------------------------------------------------------

    def _put(self, tier: int, blocks: List[int], offs: List[int],
             k: torch.Tensor, v: torch.Tensor) -> None:
        """pool[tier][blocks[i], :, offs[i]] = k[i] for (n, L, KV, dh) k."""
        b = torch.tensor(blocks, dtype=torch.long, device=self.device)
        o = torch.tensor(offs, dtype=torch.long, device=self.device)
        self.pool_k[tier][b, :, o] = k.to(self.pool_k.dtype)
        self.pool_v[tier][b, :, o] = v.to(self.pool_v.dtype)

    def write_prefill(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                      true_len: int, tier: int = 0, start: int = 0) -> None:
        """Scatter a prefill cache (L, S_pad, KV, dh) into ``slot``'s blocks
        covering positions ``start .. start+true_len-1`` (``start``
        block-aligned). Pad positions inside the last block carry garbage
        that decode overwrites before its mask reaches them."""
        bs = self.block_size
        if start % bs:
            raise ValueError(f"write_prefill start={start} must be a "
                             f"multiple of block_size={bs}")
        self.ensure(slot, start + true_len)
        n = self.blocks_for(true_len)
        pbs = [self._ensure_owned(slot, start // bs + i) for i in range(n)]
        span = n * bs
        self._put(tier, [pb for pb in pbs for _ in range(bs)],
                  list(range(bs)) * n,
                  k[:, :span].transpose(0, 1), v[:, :span].transpose(0, 1))

    def view_tables(self, n_view: int,
                    slots: Optional[List[int]] = None) -> np.ndarray:
        """(len(slots), n_view) physical ids; short/idle slots pad with the
        scratch block."""
        sl = list(range(self.n_slots)) if slots is None else slots
        tbl = np.zeros((len(sl), n_view), np.int64)
        for r, s in enumerate(sl):
            t = self.tables[s][:n_view]
            tbl[r, :len(t)] = t
        return tbl

    def gather(self, n_view: int, tier: int = 0,
               slots: Optional[List[int]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(L, B, n_view*block_size, KV, dh) contiguous K/V views."""
        tbl = torch.from_numpy(self.view_tables(n_view, slots)).to(
            self.device)
        L, B = self.cfg.n_layers, tbl.shape[0]

        def _g(pool):
            g = pool[tier][tbl]  # (B, n_view, L, bs, KV, dh)
            return g.permute(2, 0, 1, 3, 4, 5).reshape(
                L, B, n_view * self.block_size, *g.shape[-2:])

        return _g(self.pool_k), _g(self.pool_v)

    def write_coords(self, positions: List[Optional[int]]
                     ) -> Tuple[List[int], List[int]]:
        """Physical (block, offset) per lane for a decode-step write; idle
        lanes (None) target the scratch block. Copy-on-write fires here."""
        pb = [0] * self.n_slots
        off = [0] * self.n_slots
        for s, pos in enumerate(positions):
            if pos is None:
                continue
            pb[s] = self._ensure_owned(s, pos // self.block_size)
            off[s] = pos % self.block_size
        return pb, off

    def write_token(self, pb: List[int], off: List[int],
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    tier: int = 0) -> None:
        """Write one decode step's K/V (L, B, KV, dh) into the pool."""
        self._put(tier, pb, off, k_new.transpose(0, 1), v_new.transpose(0, 1))

    def write_run(self, slot: int, start: int, k_run: torch.Tensor,
                  v_run: torch.Tensor, tier: int = 0) -> None:
        """Commit a run of K/V entries (L, T, KV, dh) for ONE slot at
        positions ``start .. start+T-1``."""
        bs = self.block_size
        n = k_run.shape[1]
        if n == 0:
            return
        for bi in range(start // bs, (start + n - 1) // bs + 1):
            self._ensure_owned(slot, bi)
        t = self.tables[slot]
        self._put(tier, [t[(start + i) // bs] for i in range(n)],
                  [(start + i) % bs for i in range(n)],
                  k_run.transpose(0, 1), v_run.transpose(0, 1))
