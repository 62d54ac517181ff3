"""Paged KV cache in the object-store arena.

The vLLM/PagedAttention insight applied to this runtime's object plane:
a decoding request's KV state is not one monolithic padded buffer but a
list of **fixed-size pages**, each a sealed object in the sharded
shm arena.  The :class:`KVPageTable` maps ``request_id -> page list``
and the continuous batcher admits/evicts requests by allocating/freeing
pages against a budget instead of re-padding a cache tensor:

- **Admission** reserves pages for the request's worst-case length; a
  request whose demand exceeds the free budget stays queued until
  eviction frees pages (no monolithic-cache re-pad, no OOM).
- **Full pages seal into the arena** (``put(_force_plasma=True)``), so
  they are ordinary objects: cold pages ride the spill tier under
  arena pressure and restore transparently on the next pull.
- **Migration / prefill handoff** is by reference, not by copy:
  :meth:`handoff` exports the page refs (the prefill->decode protocol
  and replica migration both ride the object-transfer plane when the
  adopting replica materializes them).
- **Accounting is airtight**: every page allocated is eventually freed
  or handed off, and every adopted page is eventually dropped — the
  chaos suite asserts ``active == 0`` after a drain (no leaked pages).
- **Prefix caching** (``prefix_cache_pages > 0``): sealed prompt pages
  are also registered in a per-table prefix-chain table keyed by the
  cumulative hash of ``(model, token chunks)``.  A later request whose
  prompt extends a cached chain adopts those pages by ref (pinned while
  in use) and the engine prefills only the tail — copy-on-write at the
  mutable tail page, which is per-request and never shared.  Cache
  ownership is explicit: donated pages belong to the CACHE (the entry
  holds a borrow, released through the same funnel as handoff borrows),
  so the ledger invariant survives sharing; unpinned chains evict LRU
  leaf-first and a drain flush restores ``allocated == freed +
  handed_off`` exactly.

A page's value is ``{"t": int32[<=page_tokens] token ids, "kv":
optional engine payload}``.  Token ids make a page self-describing (an
adopting replica rebuilds decode state from pages alone — for the toy
engine the KV is recomputable from tokens; for a real engine ``kv``
carries the actual K/V blocks via the engine's ``kv_page_payload``
hook).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from ray_tpu_torch.util import failpoint as _fp

__all__ = ["KVPageTable", "KVPagesExhausted", "resolve_export"]


class KVPagesExhausted(Exception):
    """The table's page budget cannot cover the request (admission-time
    signal; the batcher keeps the request queued instead of raising to
    the client)."""


def _default_put(value: Any):
    import ray_tpu_torch
    from ray_tpu_torch.serve._internal import _serve_knob

    return ray_tpu_torch.put(
        value, _force_plasma=bool(_serve_knob("serve_kv_pages_in_arena",
                                              True)))


def _default_free(refs: List[Any]) -> None:
    import ray_tpu_torch

    try:
        ray_tpu_torch.free(refs)
    except Exception:  # noqa: BLE001 — refcounting frees on drop anyway
        pass


class _Entry:
    __slots__ = ("pages", "tail", "reserved", "adopted",
                 "adopted_pages", "borrowed_idx", "prefix_keys")

    def __init__(self, reserved: int, adopted: bool = False):
        self.pages: List[Any] = []     # sealed page ObjectRefs, in order
        self.tail: List[int] = []      # tokens not yet sealed into a page
        self.reserved = reserved       # admission-time worst-case pages
        self.adopted = adopted         # entry began from a handoff
        #: first ``adopted_pages`` of ``pages`` are BORROWED (sealed by
        #: another table); pages sealed here after adoption are owned
        self.adopted_pages = 0
        #: page indices borrowed from THIS table's prefix cache (matched
        #: chain pages + donated prompt pages) — the cache owns those
        #: blobs; release drops the borrow instead of freeing
        self.borrowed_idx: Set[int] = set()
        #: prefix-chain keys this entry pins (unpinned on release)
        self.prefix_keys: List[str] = []


class _PrefixNode:
    """One cached prompt page: the chain key it lives under commits to
    the model id and every token up to the page's end, so a key match
    IS a prefix match."""

    __slots__ = ("ref", "parent", "children", "pins", "last_used")

    def __init__(self, ref: Any, parent: Optional[str]):
        self.ref = ref                   # sealed page ObjectRef (owned)
        self.parent = parent             # parent chain key (None = root)
        self.children: Set[str] = set()  # extending chain keys
        self.pins = 0                    # live entries borrowing this page
        self.last_used = 0               # LRU tick (monotonic counter)


class KVPageTable:
    """Per-replica page table: request -> page refs + mutable tail.

    The working token list stays with the engine (the decode hot path
    never re-reads the arena); the table is the *durable* paged copy,
    updated incrementally — a full page seals exactly once.
    """

    def __init__(self, page_tokens: int, max_pages: int,
                 deployment: str = "",
                 kv_payload: Optional[Callable[[List[int]], Any]] = None,
                 put: Optional[Callable[[Any], Any]] = None,
                 free: Optional[Callable[[List[Any]], None]] = None,
                 prefix_cache_pages: int = 0):
        if page_tokens <= 0:
            raise ValueError("page_tokens must be positive")
        self.page_tokens = int(page_tokens)
        self.max_pages = int(max_pages)
        self.prefix_cache_pages = int(prefix_cache_pages)
        self._deployment = deployment
        self._kv_payload = kv_payload
        self._put = put or _default_put
        self._free = free or _default_free
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        # cumulative accounting (the no-leak invariant's raw series)
        self.allocated_total = 0
        self.freed_total = 0
        self.handed_off_total = 0
        self.adopted_total = 0
        self.dropped_total = 0  # adopted borrows released (not owned)
        self.peak_reserved = 0  # high-water mark of the page budget
        # prefix-chain cache (chain key -> node); budget is SEPARATE
        # from max_pages: resident <= max_pages + prefix_cache_pages
        self._prefix: Dict[str, _PrefixNode] = {}
        self._prefix_tick = 0
        self.prefix_hits_total = 0
        self.prefix_partial_total = 0
        self.prefix_misses_total = 0
        self.prefix_evicted_total = 0
        self.prefix_inserted_total = 0
        self.prefix_tokens_matched_total = 0

    @property
    def prefix_enabled(self) -> bool:
        return self.prefix_cache_pages > 0

    # -- admission ---------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.page_tokens))

    def can_admit(self, n_tokens: int) -> bool:
        """True when the worst-case page demand fits the free budget."""
        if self.max_pages <= 0:
            return True
        with self._lock:
            return self._reserved_locked() + self.pages_for(n_tokens) \
                <= self.max_pages

    def reserve(self, request_id: str, n_tokens: int) -> bool:
        """Atomically reserve the request's worst-case page demand at
        ADMISSION time (before any page is sealed) — the batcher gates
        on this so two same-boundary admissions cannot both pass a
        stale budget check.  Idempotent; False = over budget (keep the
        request queued).  ``release`` drops the reservation."""
        with self._lock:
            if request_id in self._entries:
                return True
            reserved = self.pages_for(n_tokens)
            total = self._reserved_locked() + reserved
            if self.max_pages > 0 and total > self.max_pages:
                return False
            self._entries[request_id] = _Entry(reserved)
            self.peak_reserved = max(self.peak_reserved, total)
            return True

    def _reserved_locked(self) -> int:
        return sum(e.reserved for e in self._entries.values())

    def begin(self, request_id: str, tokens: List[int],
              reserve_tokens: Optional[int] = None,
              model: str = "") -> int:
        """Page the request's prompt (under a prior :meth:`reserve`, or
        reserving here for standalone use — the prefill tier); full
        pages seal into the arena immediately.

        With the prefix cache enabled, the prompt's full-page chunks are
        first matched against the chain table: the longest cached chain
        is adopted by ref (pinned, borrowed — the cache keeps ownership)
        and only the remainder seals fresh; freshly sealed PROMPT pages
        are donated into the cache under their chain keys (ownership
        transfers to the cache, the entry keeps a borrow).  Returns the
        number of prompt tokens covered by adopted pages — the engine
        can skip prefill for exactly that many (``state["prefix_len"]``).
        """
        tokens = list(tokens)
        reserved = self.pages_for(reserve_tokens
                                  if reserve_tokens is not None
                                  else len(tokens))
        chain: List[Tuple[str, List[int]]] = []
        adopt_ok = True
        if self.prefix_enabled:
            chain = self._chain_of(model, tokens)
            if chain:
                try:
                    _fp.failpoint("serve.kv_prefix.adopt_fail")
                except Exception:  # noqa: BLE001 — adoption is an
                    # optimization; fall back to a cold full prefill
                    # (never a wrong answer)
                    adopt_ok = False
        result = None  # hit | partial | miss (chain non-empty only)
        with self._lock:
            entry = self._entries.get(request_id)
            if entry is not None and (entry.pages or entry.tail):
                raise ValueError(f"request {request_id} already paged")
            if entry is None:
                if self.max_pages > 0 and \
                        self._reserved_locked() + reserved \
                        > self.max_pages:
                    raise KVPagesExhausted(
                        f"{reserved} pages over budget {self.max_pages}")
                entry = self._entries[request_id] = _Entry(reserved)
                self.peak_reserved = max(self.peak_reserved,
                                         self._reserved_locked())
            matched = 0
            if chain and adopt_ok:
                self._prefix_tick += 1
                for key, _chunk in chain:
                    node = self._prefix.get(key)
                    if node is None:
                        break
                    node.pins += 1
                    node.last_used = self._prefix_tick
                    entry.pages.append(node.ref)
                    entry.borrowed_idx.add(len(entry.pages) - 1)
                    entry.prefix_keys.append(key)
                    matched += 1
            matched_tokens = matched * self.page_tokens
            if chain:
                if matched == len(chain):
                    result = "hit"
                    self.prefix_hits_total += 1
                elif matched > 0:
                    result = "partial"
                    self.prefix_partial_total += 1
                else:
                    result = "miss"
                    self.prefix_misses_total += 1
                self.prefix_tokens_matched_total += matched_tokens
            entry.tail = tokens[matched_tokens:]
            chunks = self._take_full_chunks_locked(entry)
        if result is not None:
            self._emit_prefix_result(result)
        for j, chunk in enumerate(chunks):
            idx = matched + j
            donate_key = chain[idx][0] if idx < len(chain) else None
            parent_key = chain[idx - 1][0] if donate_key and idx > 0 \
                else None
            self._seal_chunk(request_id, chunk, donate_key=donate_key,
                             parent_key=parent_key)
        return matched_tokens

    def _chain_of(self, model: str,
                  tokens: List[int]) -> List[Tuple[str, List[int]]]:
        """Cumulative chunk-hash chain over the prompt's FULL pages.
        Each key hashes the previous key + the chunk's tokens (root is
        salted with the model id), so equal keys imply byte-equal
        ``(model, prefix)`` — collision odds are blake2b-128's."""
        out: List[Tuple[str, List[int]]] = []
        prev = "m:" + str(model or "")
        n = (len(tokens) // self.page_tokens) * self.page_tokens
        for i in range(0, n, self.page_tokens):
            chunk = [int(t) for t in tokens[i:i + self.page_tokens]]
            h = hashlib.blake2b(digest_size=16)
            h.update(prev.encode())
            h.update(np.asarray(chunk, dtype=np.int64).tobytes())
            prev = h.hexdigest()
            out.append((prev, chunk))
        return out

    def _emit_prefix_result(self, result: str) -> None:
        try:
            from ray_tpu_torch.core import telemetry as _tm

            _tm.serve_prefix_cache(self._deployment, result)
        except Exception:  # noqa: BLE001 — stats must not fail serving
            pass

    def append(self, request_id: str, token: int) -> None:
        with self._lock:
            entry = self._entries.get(request_id)
            if entry is None:
                return  # released concurrently (eviction raced the step)
            entry.tail.append(int(token))
            chunks = self._take_full_chunks_locked(entry)
        for chunk in chunks:
            self._seal_chunk(request_id, chunk)

    def _take_full_chunks_locked(self, entry: _Entry) -> List[List[int]]:
        chunks: List[List[int]] = []
        while len(entry.tail) >= self.page_tokens:
            chunks.append(entry.tail[:self.page_tokens])
            entry.tail = entry.tail[self.page_tokens:]
        return chunks

    def _seal_chunk(self, request_id: str, chunk: List[int],
                    donate_key: Optional[str] = None,
                    parent_key: Optional[str] = None) -> None:
        """Seal one full page OUTSIDE the lock (the put is an arena
        RPC), then attach it to the entry — unless the request was
        released mid-seal (cancel racing the decode step), in which
        case the orphan page frees immediately so nothing leaks.

        ``donate_key`` registers the page in the prefix cache under its
        chain key: ownership moves to the cache and the entry's hold
        becomes a borrow.  If another request donated the same chain
        key first (a same-prompt race), the entry simply keeps its
        duplicate page as owned."""
        page = {"t": np.asarray(chunk, dtype=np.int32), "kv": None}
        if self._kv_payload is not None:
            try:
                page["kv"] = self._kv_payload(chunk)
            except Exception:  # noqa: BLE001 — payload is optional
                page["kv"] = None
        ref = self._put(page)
        to_free: List[Any] = []
        with self._lock:
            self.allocated_total += 1
            entry = self._entries.get(request_id)
            if entry is None:
                self.freed_total += 1
                to_free = [ref]
            else:
                entry.pages.append(ref)
                if donate_key is not None and self.prefix_enabled \
                        and donate_key not in self._prefix:
                    node = _PrefixNode(ref, parent_key)
                    node.pins = 1
                    self._prefix_tick += 1
                    node.last_used = self._prefix_tick
                    self._prefix[donate_key] = node
                    parent = self._prefix.get(parent_key) \
                        if parent_key else None
                    if parent is not None:
                        parent.children.add(donate_key)
                    entry.borrowed_idx.add(len(entry.pages) - 1)
                    entry.prefix_keys.append(donate_key)
                    self.prefix_inserted_total += 1
                    to_free = self._evict_prefix_locked()
        if to_free:
            self._free(to_free)

    def _evict_prefix_locked(self) -> List[Any]:
        """LRU-evict unpinned LEAF chains while over the cache budget
        (a pinned child keeps its parent non-leaf, so in-use chains are
        never broken).  Returns the evicted refs for the caller to free
        outside the lock; each eviction counts into ``freed_total`` —
        the cache is the owner."""
        evicted: List[Any] = []
        while len(self._prefix) > self.prefix_cache_pages:
            best_key, best_node = None, None
            for key, node in self._prefix.items():
                if node.pins > 0 or node.children:
                    continue
                if best_node is None or node.last_used < best_node.last_used:
                    best_key, best_node = key, node
            if best_key is None:
                break  # everything pinned or interior — stop, don't spin
            del self._prefix[best_key]
            parent = self._prefix.get(best_node.parent) \
                if best_node.parent else None
            if parent is not None:
                parent.children.discard(best_key)
            evicted.append(best_node.ref)
            self.prefix_evicted_total += 1
            self.freed_total += 1
        return evicted

    # -- release / handoff / adoption --------------------------------------
    def release(self, request_id: str) -> int:
        """Free the request's pages (eviction, completion, cancel).
        Owned pages — including ones sealed HERE after an adoption
        (decode-generated tokens on a prefilled request) — free eagerly
        and count into ``freed_total``; borrowed (adopted) pages just
        drop their borrow (the owner's refcount frees the blob) and
        count into ``dropped_total`` — keeping the per-table invariant
        ``allocated == freed + handed_off`` exact.  Returns pages
        released either way."""
        with self._lock:
            entry = self._entries.pop(request_id, None)
        if entry is None:
            return 0
        n = len(entry.pages)
        owned = [p for j, p in enumerate(entry.pages)
                 if j >= entry.adopted_pages
                 and j not in entry.borrowed_idx]
        borrowed = n - len(owned)
        if owned:
            self._free(owned)
        entry.pages = []
        evict: List[Any] = []
        with self._lock:
            self.dropped_total += borrowed
            self.freed_total += len(owned)
            for key in entry.prefix_keys:
                node = self._prefix.get(key)
                if node is not None and node.pins > 0:
                    node.pins -= 1
            if entry.prefix_keys:
                evict = self._evict_prefix_locked()
        if evict:
            self._free(evict)
        return n

    def handoff(self, request_id: str) -> Dict[str, Any]:
        """Export the request's paged state for another replica (the
        prefill->decode protocol): page REFS plus the unsealed tail —
        no KV bytes travel in the reply.  The entry leaves this table
        un-freed; the export's refs keep the pages alive until the
        adopter drops them."""
        with self._lock:
            entry = self._entries.pop(request_id, None)
        if entry is None:
            raise KeyError(request_id)
        with self._lock:
            owned = sum(1 for j in range(len(entry.pages))
                        if j >= entry.adopted_pages
                        and j not in entry.borrowed_idx)
            self.handed_off_total += owned
            # prefix borrows leave as drops: the cache stays the owner
            # (the export's refs stay valid while the chain is cached;
            # a later eviction surfaces as a retryable resolve failure)
            self.dropped_total += len(entry.pages) - owned
            for key in entry.prefix_keys:
                node = self._prefix.get(key)
                if node is not None and node.pins > 0:
                    node.pins -= 1
        return {"pages": list(entry.pages), "tail": list(entry.tail),
                "page_tokens": self.page_tokens}

    def adopt(self, request_id: str, export: Dict[str, Any],
              tokens: List[int], reserve_tokens: Optional[int] = None
              ) -> None:
        """Register a request whose pages were sealed elsewhere (the
        decode side of a handoff, or cross-replica migration).  The
        SAME arena objects back the request — cache survives migration.
        ``tokens`` is the already-materialized token list (the adopter
        pulled pages via :func:`resolve_export` on its handler thread,
        off the decode loop)."""
        reserved = self.pages_for(
            reserve_tokens if reserve_tokens is not None else len(tokens))
        with self._lock:
            entry = self._entries.get(request_id)
            if entry is not None and (entry.pages or entry.tail):
                raise ValueError(f"request {request_id} already paged")
            if entry is None:
                entry = self._entries[request_id] = _Entry(reserved)
            entry.adopted = True
            self.adopted_total += len(export.get("pages") or [])
            entry.pages = list(export.get("pages") or [])
            entry.adopted_pages = len(entry.pages)
            entry.tail = list(export.get("tail") or [])

    def release_all(self) -> int:
        n = 0
        with self._lock:
            ids = list(self._entries)
        for rid in ids:
            n += self.release(rid)
        self.flush_prefix()
        return n

    def flush_prefix(self) -> int:
        """Free every UNPINNED cached prefix page (drain/shutdown):
        with all entries released this empties the cache and restores
        ``allocated == freed + handed_off`` exactly.  Pinned chains
        (still borrowed by a live entry) survive."""
        with self._lock:
            refs = [node.ref for node in self._prefix.values()
                    if node.pins == 0]
            survivors = {k: v for k, v in self._prefix.items()
                         if v.pins > 0}
            for node in survivors.values():
                node.children &= set(survivors)
            self._prefix = survivors
            self.freed_total += len(refs)
        if refs:
            self._free(refs)
        return len(refs)

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            active = sum(len(e.pages) for e in self._entries.values())
            reserved = self._reserved_locked()
            out: Dict[str, Any] = {}
            if self.prefix_enabled:
                out = {
                    "kv_prefix_pages_cached": len(self._prefix),
                    "kv_prefix_pages_shared": sum(
                        1 for v in self._prefix.values() if v.pins > 0),
                    "kv_prefix_hits_total": self.prefix_hits_total,
                    "kv_prefix_partial_total": self.prefix_partial_total,
                    "kv_prefix_misses_total": self.prefix_misses_total,
                    "kv_prefix_evicted_total": self.prefix_evicted_total,
                    "kv_prefix_inserted_total":
                        self.prefix_inserted_total,
                    "kv_prefix_tokens_matched_total":
                        self.prefix_tokens_matched_total,
                }
            out.update({
                "kv_page_tokens": self.page_tokens,
                "kv_max_pages": self.max_pages,
                "kv_pages_active": active,
                "kv_pages_reserved": reserved,
                "kv_requests_active": len(self._entries),
                "kv_pages_allocated_total": self.allocated_total,
                "kv_pages_freed_total": self.freed_total,
                "kv_pages_handed_off_total": self.handed_off_total,
                "kv_pages_adopted_total": self.adopted_total,
                "kv_pages_dropped_total": self.dropped_total,
                "kv_occupancy": (reserved / self.max_pages)
                if self.max_pages > 0 else 0.0,
                "kv_pages_peak": self.peak_reserved,
                "kv_occupancy_peak": (self.peak_reserved / self.max_pages)
                if self.max_pages > 0 else 0.0,
            })
            return out


def resolve_export(export: Dict[str, Any],
                   get: Optional[Callable] = None) -> List[int]:
    """Materialize an exported paged state back into the full token
    list: pulls each page (transfer plane / spill restore as needed)
    and concatenates with the tail.  Runs on the adopter's request
    handler thread — never on the decode loop."""
    if get is None:
        import ray_tpu_torch
        get = lambda refs: ray_tpu_torch.get(refs, timeout=60)  # noqa: E731
    tokens: List[int] = []
    pages = list(export.get("pages") or [])
    if pages:
        for page in get(pages):
            tokens.extend(int(t) for t in np.asarray(page["t"]).tolist())
    tokens.extend(int(t) for t in (export.get("tail") or []))
    return tokens
