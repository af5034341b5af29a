"""Shared-prefix KV reuse: a host-side trie over token prefixes whose
values are KV slices on the device (the port's own copy of the JAX
package's ``serving/prefix_cache.py``, standard library only, the same
behaviour line for line).

Requests arriving with a shared head (system prompts, few-shot headers)
should not recompute it: after a prompt is admitted through chunked
admission, the engine keeps the KV of its first ``P`` positions (``P`` =
the largest bucket ``<= L - 1``) and inserts it here. A later prompt that
starts with the same tokens gets the slice copied into its fresh slot in
place (contiguous rings: one device copy of each K/V leaf) or its pages
aliased (the paged pool: refcount bumps, no copy), and resumes chunked
admission at that offset: reuse costs at most one HBM copy instead of
``P`` tokens of compute.

Invariants (relied on by the engine; ``tests/test_torch_prefix.py``
holds them against the JAX package's copy):

* **Bucketed entry lengths.** Every stored (and served) prefix length is
  a power-of-two multiple of ``chunk`` (C, 2C, 4C, ...): on the rings
  ``chunk`` is the engine's prefill chunk, so a hit resumes on a chunk
  boundary; on the paged pool it is the page size, so every hit aliases
  whole pages.
* **Partial-entry lookup.** A prompt need not match a whole stored
  entry: ``lookup`` walks the trie to the deepest matched node, rounds
  down to a bucket Q (``<= len(prompt) - 1``: at least one token must
  remain to produce the first-token logits), and serves the first Q
  tokens of *any* entry passing through that node. K/V at position p
  depends only on tokens ``<= p`` (causality), so the slice is exact.
* **Token-budget LRU.** Total stored tokens never exceed
  ``capacity_tokens``; insertion evicts least-recently-used entries
  (lookup hits refresh recency). Entries larger than the whole budget
  are never stored.
* **Bit-fidelity.** Entries hold the exact cache leaves (int8 KV payloads
  and their scales included) or the exact pages, so a hit's slot state
  is bit-identical to recomputing the prefix.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("children", "entry_key")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        self.entry_key = None           # set iff a stored prefix ends here


class PrefixCache:
    def __init__(self, capacity_tokens: int, chunk: int,
                 on_evict: Optional[Callable[[Dict], None]] = None):
        """``on_evict(entry)`` fires when an entry leaves the cache: the
        paged engine releases the entry's page references there (the
        pages outlive the entry while a live slot still aliases them)."""
        assert chunk > 0
        self.capacity = int(capacity_tokens)
        self.chunk = int(chunk)
        self.on_evict = on_evict
        self.root = _Node()
        # key (tuple of ids) -> {"kv": KV slices or page list, "length": P}
        self._entries: "collections.OrderedDict[Tuple[int, ...], Dict]" = \
            collections.OrderedDict()
        self.tokens = 0                 # total stored tokens
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0             # prompt tokens served from cache
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> List[Any]:
        """Every stored entry's ``kv``, least recently used first."""
        return [e["kv"] for e in self._entries.values()]

    # ------------------------------------------------------------ #
    def lookup(self, prompt) -> Tuple[Optional[Any], int, int]:
        """Longest bucketed stored prefix of ``prompt`` shorter than the
        prompt. Returns ``(kv, entry length, hit length Q)`` (the caller
        uses the first Q positions of the entry) or ``(None, 0, 0)``. A
        hit refreshes the donor entry's LRU recency."""
        node = self.root
        depth = 0
        limit = len(prompt) - 1
        for tok in prompt:
            if depth >= limit:
                break
            nxt = node.children.get(int(tok))
            if nxt is None:
                break
            node = nxt
            depth += 1
        Q = self.bucket(depth)
        key = self._entry_through(self.root, prompt, Q) if Q else None
        if key is None:
            self.misses += 1
            return None, 0, 0
        entry = self._entries[key]
        self._entries.move_to_end(key)
        self.hits += 1
        self.hit_tokens += Q
        return entry["kv"], entry["length"], Q

    def _entry_through(self, root: _Node, prompt, Q: int):
        """Any entry whose key starts with ``prompt[:Q]`` (every live
        trie node lies on the path of at least one entry, so the search
        below the depth-Q node always ends)."""
        node = root
        for tok in prompt[:Q]:
            node = node.children.get(int(tok))
            if node is None:
                return None
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry_key is not None and len(n.entry_key) >= Q:
                return n.entry_key
            stack.extend(n.children.values())
        return None

    # ------------------------------------------------------------ #
    def bucket(self, n: int) -> int:
        """Largest power-of-two chunk multiple <= n (0 if n < chunk)."""
        if n < self.chunk:
            return 0
        return self.chunk << ((n // self.chunk).bit_length() - 1)

    def wants(self, prompt) -> int:
        """The prefix length ``insert`` would store for this prompt: the
        largest bucket <= len(prompt) - 1 that fits the token budget and
        is not already *covered*; 0 = nothing to store (the caller skips
        the extraction). Covered means any stored entry passes through
        ``prompt[:P]``, not just an exact key: partial-entry lookup
        serves the first P positions of such an entry already."""
        P = self.bucket(len(prompt) - 1)
        if not P or P > self.capacity:
            return 0
        if self._entry_through(self.root, prompt, P) is not None:
            return 0
        return P

    def insert(self, prompt, P: int, kv) -> None:
        """Store ``kv`` (the KV of prompt[:P]) and evict LRU entries past
        the token budget."""
        key = tuple(int(t) for t in prompt[:P])
        if not P or key in self._entries:
            return
        node = self.root
        for tok in key:
            node = node.children.setdefault(tok, _Node())
        node.entry_key = key
        self._entries[key] = {"kv": kv, "length": P}
        self.tokens += P
        while self.tokens > self.capacity and len(self._entries) > 1:
            self._evict_lru(keep=key)

    def drop_lru(self) -> bool:
        """Evict the least-recently-used entry unconditionally (the paged
        engine's reclaim under page pressure). Returns False when the
        cache is empty."""
        if not self._entries:
            return False
        self._evict_lru()
        return True

    def _evict_lru(self, keep=None) -> None:
        for key in self._entries:
            if key != keep:
                break
        else:
            return
        entry = self._entries.pop(key)
        self.tokens -= entry["length"]
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(entry)
        # unlink from the trie and prune now-empty nodes
        path: List[Tuple[_Node, int]] = []
        node = self.root
        for tok in key:
            path.append((node, tok))
            node = node.children[tok]
        node.entry_key = None
        for parent, tok in reversed(path):
            child = parent.children[tok]
            if child.children or child.entry_key is not None:
                break
            del parent.children[tok]

    # ------------------------------------------------------------ #
    def stats(self) -> Dict[str, float]:
        return {
            "prefix_entries": len(self._entries),
            "prefix_tokens": self.tokens,
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_evictions": self.evictions,
        }
