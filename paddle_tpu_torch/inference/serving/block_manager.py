"""Paged KV block pool: the memory half of the serving subsystem.

Reference frame: vLLM's BlockSpaceManager / PaddleNLP's block-attention
cache pool — the allocator that lets `block_multihead_attention_` serve a
ragged request mix from one fixed pool of fixed-size cache pages instead
of per-slot max_len reservations:

- fixed ``block_size`` pages, allocated/freed with **ref-counting** so
  several sequences can map the same physical page;
- per-sequence **block tables** (the [B, max_blocks] int32 rows the paged
  kernel consumes, -1 = unassigned);
- a **hash-keyed prefix cache**: every full block is content-addressed by
  the rolling hash of all tokens up to its end, so a new request whose
  prompt shares a prefix with anything the pool has seen maps those pages
  instead of recomputing them. Full-block hits share pages by refcount;
  a partial hit on the following block is served **copy-on-write**: the
  manager hands out a private copy (the engine executes the device-side
  page copy from :meth:`take_copies`) and the matched tokens still skip
  recompute;
- freed-but-cached pages park in an LRU side pool and keep serving prefix
  hits until allocation pressure reclaims them (hash entries drop at
  reclaim, never silently);
- utilization accounting for the observability gauges and the
  scheduler's admission/preemption decisions.

Pure host-side bookkeeping: no device state. The engine owns the actual
[num_blocks, KV, block_size, hd] cache tensors; block ids here index
those tensors.

A copy of `paddle_tpu/inference/serving/block_manager.py` (the port
imports nothing of the reference), with the router's prefix-affinity
probe (`prefix_chain`, `lookup_prefix`), the adapter residency that
shares the byte gauges (`extra_bytes`) and the page-migration surface
disaggregated serving adopts and evicts migrated pages through
(`chain_blocks`, `adopt_page`, `evict_hashes`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["BlockManager", "NoFreeBlocksError"]


class NoFreeBlocksError(RuntimeError):
    """The pool cannot satisfy an allocation — the scheduler's signal to
    preempt (never surfaced to clients; admission checks first)."""


def _chain_hash(prev_hash: int, tokens: Tuple[int, ...]) -> int:
    return hash((prev_hash, tokens))


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int,
                 page_bytes: int = 0):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"need num_blocks>=1 and block_size>=1, got "
                             f"{num_blocks}/{block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # optional () -> (in_use, total) callback for paged device
        # residency beside the KV pages (the AdapterManager's slot packs),
        # so a replica stuffed with adapters never scores as empty in the
        # router's byte tiebreak
        self.extra_bytes = None
        # dtype-aware device footprint of one page across all layers, both
        # cache sides (+ per-page scales when quantized) — supplied by the
        # engine so byte gauges and router placement stay truthful when
        # int8 pages make a "block" 2-4x cheaper than its fp32 twin
        self.page_bytes = int(page_bytes)
        self._free: List[int] = list(range(num_blocks))[::-1]  # pop() = lowest
        self._refs: Dict[int, int] = {}
        # content-addressed full blocks: chain hash -> block id, the inverse
        # (so frees drop entries without scanning), and the chunk content
        # (prev_hash, tokens) behind each hash for partial/COW matching
        self._hash_to_block: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        self._hash_info: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        # refcount-0 blocks still holding cached KV, oldest first (LRU)
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        # per-sequence block tables
        self._tables: Dict[int, List[int]] = {}
        # pending device copies (src, dst) the engine must execute before
        # the next step touches dst. src pages are ref-pinned while a copy
        # is pending so allocation pressure cannot reclaim (and another
        # sequence reuse) the source before the device copy runs; the pin
        # is released by take_copies() or by purging the pair when the
        # owning sequence is freed first (cancel mid-chunked-prefill).
        self._pending_copies: List[Tuple[int, int]] = []
        self.stats = {"allocs": 0, "frees": 0, "prefix_hit_blocks": 0,
                      "prefix_hit_tokens": 0, "cow_copies": 0,
                      "cache_evictions": 0, "cow_purged": 0,
                      "adopted_pages": 0}

    # -- capacity ---------------------------------------------------------
    def num_free(self) -> int:
        return len(self._free) + len(self._cached_free)

    def num_allocated(self) -> int:
        return self.num_blocks - self.num_free()

    def utilization(self) -> float:
        return self.num_allocated() / self.num_blocks

    def bytes_total(self) -> int:
        """Device bytes of the whole page pool (0 when the engine did not
        report a page size — e.g. unit tests building bare managers),
        plus any registered extra residency (adapter slot packs)."""
        extra = self.extra_bytes()[1] if self.extra_bytes else 0
        return self.num_blocks * self.page_bytes + extra

    def bytes_in_use(self) -> int:
        """Device bytes behind allocated pages, dtype-aware, plus any
        registered extra residency (adapter slot packs)."""
        extra = self.extra_bytes()[0] if self.extra_bytes else 0
        return self.num_allocated() * self.page_bytes + extra

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-int(num_tokens) // self.block_size)

    def can_allocate(self, n_blocks: int) -> bool:
        return self.num_free() >= n_blocks

    # -- raw page pool ----------------------------------------------------
    def _drop_hash(self, blk: int):
        h = self._block_hash.pop(blk, None)
        if h is not None:
            if self._hash_to_block.get(h) == blk:
                del self._hash_to_block[h]
            self._hash_info.pop(h, None)

    def _take_free(self) -> int:
        if self._free:
            return self._free.pop()
        if self._cached_free:  # reclaim the LRU cached page
            blk, _ = self._cached_free.popitem(last=False)
            self._drop_hash(blk)
            self.stats["cache_evictions"] += 1
            return blk
        raise NoFreeBlocksError(
            f"KV pool exhausted: {self.num_blocks} blocks x "
            f"{self.block_size} tokens all referenced")

    def _alloc_block(self) -> int:
        blk = self._take_free()
        self._refs[blk] = 1
        self.stats["allocs"] += 1
        return blk

    def _incref(self, blk: int):
        if blk in self._cached_free:           # revive a parked cached page
            del self._cached_free[blk]
            self._refs[blk] = 1
        else:
            self._refs[blk] += 1

    def _decref(self, blk: int):
        self._refs[blk] -= 1
        if self._refs[blk] > 0:
            return
        del self._refs[blk]
        self.stats["frees"] += 1
        if blk in self._block_hash:            # keep serving prefix hits
            self._cached_free[blk] = None
        else:
            self._free.append(blk)

    # -- sequence lifecycle -----------------------------------------------
    def allocate_sequence(self, seq_id: int, tokens: Sequence[int]) -> int:
        """Map a sequence's first `len(tokens)` positions, reusing cached
        prefix pages. Returns the number of tokens whose KV is already in
        the pool (always < len(tokens) so the caller computes at least the
        last token's logits). Raises NoFreeBlocksError leaving no state."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already has a block table")
        tokens = [int(t) for t in tokens]
        bs = self.block_size
        table: List[int] = []
        new_copies: List[Tuple[int, int]] = []
        cached = 0
        prev_h = 0
        try:
            # full-block prefix hits: share pages by refcount
            i, full_run = 0, True
            while i + bs <= len(tokens):
                h = _chain_hash(prev_h, tuple(tokens[i:i + bs]))
                blk = self._hash_to_block.get(h)
                if blk is None:
                    full_run = False
                    break
                self._incref(blk)
                table.append(blk)
                self.stats["prefix_hit_blocks"] += 1
                cached += bs
                prev_h = h
                i += bs
            # partial hit on the next block (whether the chain ran out of
            # full-sized chunks or broke on content): copy-on-write. The
            # cached page holds another sequence's KV for these positions;
            # the matched leading tokens are identical, the page's tail is
            # garbage this sequence's causal mask never attends
            # (kv_pos <= tok_pos).
            if i < len(tokens):
                best = self._partial_match(prev_h, tokens[i:i + bs])
                if best is not None:
                    src, n_match = best
                    dst = self._alloc_block()
                    self._incref(src)          # pin until the copy executes
                    new_copies.append((src, dst))
                    table.append(dst)
                    self.stats["cow_copies"] += 1
                    cached += n_match
            # fresh pages for the rest
            while len(table) * bs < len(tokens):
                table.append(self._alloc_block())
            # the caller always recomputes at least the final prompt token
            # (cached is capped below), and that token's KV WRITE must not
            # land on a page other sequences can read: when the whole
            # prompt was full-block hits, demote the final hit to a
            # private copy-on-write page.
            if full_run and i >= len(tokens):
                src = table[-1]
                dst = self._alloc_block()
                new_copies.append((src, dst))   # table drop keeps src's ref
                table[-1] = dst
                self.stats["cow_copies"] += 1
        except NoFreeBlocksError:
            for src, _ in new_copies:
                self._decref(src)              # release the copy pins
            for b in table:
                self._decref(b)
            raise
        cached = min(cached, len(tokens) - 1)
        self.stats["prefix_hit_tokens"] += cached
        self._pending_copies.extend(new_copies)
        self._tables[seq_id] = table
        return cached

    def _partial_match(self, prev_h: int,
                       rest: Sequence[int]) -> Optional[Tuple[int, int]]:
        """Longest cached full block sharing chain `prev_h` whose leading
        tokens match `rest`; None below 2 matched tokens (a COW page copy
        is not worth one token)."""
        rest = list(rest)
        best_blk, best_n = None, 1
        for h, (ph, chunk) in self._hash_info.items():
            if ph != prev_h:
                continue
            blk = self._hash_to_block.get(h)
            if blk is None or (blk not in self._refs
                               and blk not in self._cached_free):
                continue
            n = 0
            for a, b in zip(chunk, rest):
                if a != b:
                    break
                n += 1
            if n > best_n:
                best_blk, best_n = blk, n
        return (best_blk, best_n) if best_blk is not None else None

    def ensure_capacity(self, seq_id: int, num_tokens: int) -> int:
        """Grow a sequence's table to cover `num_tokens` positions (decode
        growth), allocating fresh pages as block boundaries are crossed.
        Pages reachable by other sequences are always FULL, so growth never
        writes into shared data. Returns pages added; raises
        NoFreeBlocksError (leaving the table unchanged) when the pool is
        exhausted — the scheduler's preemption trigger."""
        table = self._tables[seq_id]
        need = self.blocks_needed(num_tokens) - len(table)
        if need <= 0:
            return 0
        if not self.can_allocate(need):
            raise NoFreeBlocksError(
                f"cannot grow sequence {seq_id} by {need} blocks "
                f"({self.num_free()} free)")
        for _ in range(need):
            table.append(self._alloc_block())
        return need

    def register_computed(self, seq_id: int, tokens: Sequence[int],
                          num_computed: int):
        """Content-address every full block covered by the first
        `num_computed` computed tokens of `tokens`, making them
        prefix-cache hits for future sequences."""
        bs = self.block_size
        table = self._tables.get(seq_id)
        if table is None:
            return
        prev_h = 0
        for bi in range(min(num_computed, len(tokens)) // bs):
            chunk = tuple(int(t) for t in tokens[bi * bs:(bi + 1) * bs])
            h = _chain_hash(prev_h, chunk)
            blk = table[bi]
            if h not in self._hash_to_block and blk not in self._block_hash:
                self._hash_to_block[h] = blk
                self._block_hash[blk] = h
                self._hash_info[h] = (prev_h, chunk)
            prev_h = h

    def free_sequence(self, seq_id: int):
        table = self._tables.pop(seq_id, None)
        if not table:
            return
        if self._pending_copies:
            # drop not-yet-executed COW copies whose destination dies with
            # this table (cancel mid-chunked-prefill): the dst page is
            # about to be freed and may be handed to another sequence — a
            # stale device copy into it would corrupt that sequence's KV.
            # Destinations are private (ref==1, exactly one table), so
            # membership in this table identifies this sequence's pairs.
            dsts = set(table)
            kept: List[Tuple[int, int]] = []
            for src, dst in self._pending_copies:
                if dst in dsts:
                    self._decref(src)          # release the copy pin
                    self.stats["cow_purged"] += 1
                else:
                    kept.append((src, dst))
            self._pending_copies = kept
        for blk in table:
            self._decref(blk)

    def block_table(self, seq_id: int) -> List[int]:
        return list(self._tables[seq_id])

    def has_sequence(self, seq_id: int) -> bool:
        return seq_id in self._tables

    def ref_count(self, blk: int) -> int:
        return self._refs.get(blk, 0)

    def take_copies(self) -> List[Tuple[int, int]]:
        """Drain the pending (src, dst) COW page copies; the engine must
        execute them on the device cache before its next step (the src
        pin is released here, so the copy must run before any further
        allocation can recycle the page)."""
        out, self._pending_copies = self._pending_copies, []
        for src, _ in out:
            self._decref(src)
        return out

    def prefix_chain(self,
                     tokens: Sequence[int]) -> List[Tuple[int, int]]:
        """Content-address the full-block prefix chain of `tokens`
        without touching the pool: ``[(depth, chain_hash), ...]``, where
        ``depth`` is the token count covered through each full block. A
        pure function of the token list (tuples of ints hash the same in
        every process)."""
        tokens = [int(t) for t in tokens]
        bs = self.block_size
        out: List[Tuple[int, int]] = []
        prev_h, i = 0, 0
        while i + bs <= len(tokens):
            prev_h = _chain_hash(prev_h, tuple(tokens[i:i + bs]))
            i += bs
            out.append((i, prev_h))
        return out

    def _chain_live(self, chain_hash: int) -> Optional[int]:
        """Block id serving `chain_hash` right now (referenced or parked
        in the cached-free LRU), else None."""
        blk = self._hash_to_block.get(chain_hash)
        if blk is None or (blk not in self._refs
                           and blk not in self._cached_free):
            return None
        return blk

    def lookup_prefix(self, tokens: Sequence[int]) -> int:
        """How many leading tokens of `tokens` the pool could serve from
        the prefix cache right now (full-block chain hits only), without
        allocating: the router's prefix-affinity signal. Capped at
        len(tokens) - 1 like allocate_sequence's `cached`."""
        return self.lookup_chain(self.prefix_chain(tokens), len(tokens))

    def lookup_chain(self, chain: Sequence[Tuple[int, int]],
                     num_tokens: int) -> int:
        """`lookup_prefix` of a prompt of `num_tokens` tokens whose
        :meth:`prefix_chain` is `chain` (hashed once by the caller)."""
        n = 0
        for depth, h in chain:
            if self._chain_live(h) is None:
                break
            n = depth
        return min(n, max(num_tokens - 1, 0))

    def chain_blocks(self,
                     chain: Sequence[Tuple[int, int]]) -> Optional[List[int]]:
        """Resolve a :meth:`prefix_chain` to live block ids, or None when
        any link is missing (pages partially evicted — this pool cannot
        serve the chain and a sender must decline the page pull)."""
        out: List[int] = []
        for _, h in chain:
            blk = self._chain_live(h)
            if blk is None:
                return None
            out.append(blk)
        return out

    def adopt_page(self, chain_hash: int, prev_hash: int,
                   chunk: Sequence[int]) -> Optional[int]:
        """Park an externally computed (migrated) full page in the prefix
        cache: take a free block, register the chain hash, and leave it
        in the cached-free LRU so the next ``allocate_sequence`` revives
        it like any freed-but-cached page — and allocation pressure can
        reclaim it (migrated pages are an optimization, never pinned
        state). Returns the block id the caller must fill on device, or
        None when the hash is already live here (nothing to write).
        Raises NoFreeBlocksError when every block is referenced."""
        if self._chain_live(chain_hash) is not None:
            return None
        blk = self._take_free()
        self._drop_hash(blk)       # fresh-list blocks may carry no hash;
        #                            reclaim path already dropped theirs
        self._hash_to_block[chain_hash] = blk
        self._block_hash[blk] = chain_hash
        self._hash_info[chain_hash] = (
            int(prev_hash), tuple(int(t) for t in chunk))
        self._cached_free[blk] = None
        self.stats["adopted_pages"] += 1
        return blk

    def evict_hashes(self, hashes: Sequence[int]) -> int:
        """Drop prefix-cache entries by chain hash (migrated pages found
        bad at confirm time): parked pages return to the raw free list;
        pages still referenced by live sequences only lose their hash
        (the data stays until their refs drain). Returns entries
        dropped."""
        n = 0
        for h in list(hashes):
            blk = self._hash_to_block.get(h)
            if blk is None:
                continue
            self._drop_hash(blk)
            if blk in self._cached_free:
                del self._cached_free[blk]
                self._free.append(blk)
            n += 1
        return n
