"""Radix-tree prefix KV reuse over the paged block pool (host side).

:class:`PrefixTrie` maps block_size-sized chunks of prompt token ids to the
physical block holding that chunk's K/V, so an admission whose prompt
shares a prefix with an earlier request ADOPTS the matched block chain
(refcount bump, zero copy) and prefills only the unshared suffix.

  * only FULL blocks are shared, and a match is capped so at least one
    suffix token remains to produce the first output token;
  * the trie holds its OWN reference on every registered block, so shared
    KV survives ``free_slot`` of the request that produced it; every pool
    write path is copy-on-write;
  * eviction is LRU over leaves the trie is the LAST holder of.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("key", "parent", "children", "block", "last_used")

    def __init__(self, key: Optional[Tuple[int, ...]],
                 parent: Optional["_Node"], block: int):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.block = block  # physical block id (-1 for the root)
        self.last_used = 0


class PrefixTrie:
    """Maps prompt-token prefixes (in block_size chunks) to live KV blocks."""

    def __init__(self, kv) -> None:
        self.kv = kv
        self.block_size = kv.block_size
        self._root = _Node(None, None, -1)
        self._clock = 0
        self.n_lookups = 0
        self.n_hits = 0
        self.n_hit_blocks = 0
        self.n_inserted = 0
        self.n_evicted = 0

    def _chunks(self, prompt: np.ndarray, n: int) -> List[Tuple[int, ...]]:
        bs = self.block_size
        toks = np.asarray(prompt).reshape(-1)
        return [tuple(int(x) for x in toks[j * bs:(j + 1) * bs])
                for j in range(n)]

    def held_blocks(self) -> int:
        n = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    def match(self, prompt: np.ndarray) -> List[int]:
        """Longest registered full-block prefix of ``prompt`` -> physical
        block chain, capped so >= 1 suffix token stays unmatched."""
        self.n_lookups += 1
        self._clock += 1
        n_max = (len(np.asarray(prompt).reshape(-1)) - 1) // self.block_size
        blocks: List[int] = []
        node = self._root
        for key in self._chunks(prompt, n_max):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            blocks.append(child.block)
            node = child
        if blocks:
            self.n_hits += 1
            self.n_hit_blocks += len(blocks)
        return blocks

    def insert(self, prompt: np.ndarray, blocks: List[int]) -> None:
        """Register ``blocks`` (the K/V of the first ``len(blocks)`` full
        blocks of ``prompt``), retaining every newly registered block; call
        AFTER the KV writes land."""
        self._clock += 1
        node = self._root
        for key, b in zip(self._chunks(prompt, len(blocks)), blocks):
            child = node.children.get(key)
            if child is None:
                self.kv.retain(b)
                child = _Node(key, node, b)
                node.children[key] = child
                self.n_inserted += 1
            child.last_used = self._clock
            node = child

    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def evict(self, n_blocks: int) -> int:
        """Drop least-recently-used leaves until ``n_blocks`` pool blocks
        were freed or no evictable leaf remains. Returns blocks freed."""
        freed = 0
        while freed < n_blocks:
            evictable = [nd for nd in self._leaves()
                         if self.kv.refcnt[nd.block] == 1]
            if not evictable:
                break
            victim = min(evictable, key=lambda nd: nd.last_used)
            del victim.parent.children[victim.key]
            self.kv.release(victim.block)
            self.n_evicted += 1
            freed += 1
        return freed

    def stats(self) -> dict:
        return {
            "lookups": self.n_lookups,
            "hits": self.n_hits,
            "hit_rate": self.n_hits / max(1, self.n_lookups),
            "hit_blocks": self.n_hit_blocks,
            "hit_tokens": self.n_hit_blocks * self.block_size,
            "inserted_blocks": self.n_inserted,
            "evicted_blocks": self.n_evicted,
            "held_blocks": self.held_blocks(),
        }
