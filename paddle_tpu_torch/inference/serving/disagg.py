"""Disaggregated prefill/decode serving with lease-fenced KV page
migration — the port of `paddle_tpu/inference/serving/disagg.py`.

Prefill is compute-bound and decode is memory-bound, so a fleet split
into a prefill pool and a decode pool can serve both phases better than
the same replicas each serving both. :class:`DisaggRouter` places every
new stream on the prefill pool with a one-token budget; when that token
lands (the client's TTFT), the prompt's full-block KV pages ship to a
decode replica over the page transport and the stream continues there.
The handoff rides the router's replay-and-confirm machinery: the decode
replica regenerates the first token, which is confirmed against what the
client already saw and suppressed.

**The failure ladder.** Every transfer is stamped with a migration epoch
``(sender replica id, sender incarnation)``; ingest re-checks the
sender's lease and incarnation, so the pages of a sender that has died
since are rejected, never adopted. Page pulls get a typed timeout with
capped exponential-backoff retries. Any terminal failure (timeout, CRC
corruption, stale epoch, a bad payload, or a confirm mismatch after the
adopt) degrades to the decode side recomputing the prefill from the
prompt, which regenerates the streamed token exactly. Sustained
migration failure trips the route back to monolithic same-replica
serving for a cooldown window instead of shedding.

The confirm covers only the tokens the client has already seen (the
first one): a payload that is wrong in a way that leaves the first
regenerated token right is adopted, and later tokens can then differ
from a monolithic engine's. Zeroed pages do that on the tiny test model
(`tests/test_torch_disagg.py`), as in the reference; the port keeps the
reference's semantics.

On top sit :class:`FleetPrefixIndex` (the block manager's rolling-hash
chains lifted fleet-global, so a prompt routes to wherever its prefix
already lives) and :class:`PoolAutoscaler`, which grows the decode pool
through probation and shrinks it through drain from an explicit SLO
summary.

Wire format: a JSON header line (version, epoch, chain, tokens, dtype,
wire, field table, the body's CRC32), then the body. ``wire="int8"``
runs float32 / float16 K/V planes through the block-scaled int8 codec
(`distributed/quant_comm.py`, the reference's bytes); int8 pages and
their f32 scale planes always travel as they are, and so do bf16 pages,
as in the reference, whose ``dtype.kind == "f"`` test does not hold for
bf16. bf16 pages are carried as their 16-bit patterns (numpy has no
bf16; the header names them ``"bfloat16"``), so a blob packed by either
package unpacks in the other. Chaos site ``migration`` (drop / delay /
corrupt / rank_dead) hooks the transport.

The reference's `FLAGS_router_pools`, `FLAGS_migration_*` and
`FLAGS_autoscale_*` defaults (`disagg.py:66-108`) are constructor
defaults here. Metric emits and the distress section stay with the
observability port; :meth:`DisaggRouter.disagg_snapshot` and
``disagg_stats`` are plain dicts.
"""
from __future__ import annotations

import json
import time
import weakref
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...distributed import quant_comm as QC
from .engine import TokenEvent
from .replica import DEAD, DEGRADED, HEALTHY, ReplicaHandle
from .router import RouterRequest, ServingRouter

__all__ = ["DisaggRouter", "PageTransport", "FleetPrefixIndex",
           "PoolAutoscaler", "MigrationError", "MigrationTimeout",
           "StaleEpochError", "PageCorruptError", "parse_pools",
           "pack_pages", "unpack_pages", "set_chaos_hook"]

# chaos hook (site "migration"): installed by
# distributed/fault_tolerance/chaos.py while a spec is active. Called as
# hook(op, victim) with op "offer" or "pull" and the sending replica id;
# may sleep (delay), kill the sender (rank_dead), or return "drop" /
# "corrupt" for the transport to apply.
_CHAOS_HOOK = [None]


def set_chaos_hook(fn):
    _CHAOS_HOOK[0] = fn


class MigrationError(RuntimeError):
    """Base of the page-migration failures (each degrades to decode-side
    recompute, never to a dropped stream)."""


class MigrationTimeout(MigrationError, TimeoutError):
    """A page pull exhausted its per-attempt timeout."""


class StaleEpochError(MigrationError):
    """The payload's migration epoch no longer matches a live sender
    lease: the engine that computed the pages has died (or been
    reincarnated) since, and they must not be adopted."""


class PageCorruptError(MigrationError):
    """The payload failed its CRC (or did not parse) at ingest."""


def parse_pools(spec: str) -> Optional[Dict[str, int]]:
    """``'prefill=1,decode=2' -> {'prefill': 1, 'decode': 2}``; empty ->
    None (a monolithic fleet). Both pools must be present and positive."""
    spec = (spec or "").strip()
    if not spec:
        return None
    out: Dict[str, int] = {}
    for part in spec.split(","):
        name, sep, val = part.partition("=")
        name = name.strip()
        if not sep or name not in ("prefill", "decode"):
            raise ValueError(
                f"router_pools entry {part!r}: want "
                f"'prefill=<n>,decode=<n>'")
        out[name] = int(val)
        if out[name] < 1:
            raise ValueError(f"router_pools: pool {name!r} must be >= 1")
    if set(out) != {"prefill", "decode"}:
        raise ValueError(f"router_pools={spec!r}: both pools required")
    return out


# ---------------------------------------------------------------------------
# Page payload wire codec (quant_comm layout + CRC + epoch header)
# ---------------------------------------------------------------------------

BF16 = "bfloat16"


def _field_dtype(pages: Dict[str, Any], name: str, a: np.ndarray) -> str:
    """The dtype a field is named by on the wire: bf16 pages are held as
    their 16-bit patterns but named "bfloat16", as the reference's."""
    if name in ("k", "v") and pages["dtype"] == BF16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 pages must be held as 16-bit "
                             f"patterns, got {a.dtype}")
        return BF16
    return a.dtype.name


def pack_pages(pages: Dict[str, Any], epoch: Sequence[int],
               wire: str = "") -> bytes:
    """Serialize an ``engine.extract_pages`` payload: one JSON header line
    (version, epoch stamp, chain, CRC, field table), then the array
    bytes. ``wire='int8'`` runs float32 / float16 K/V planes through the
    block-scaled codec; int8 pages, bf16 pages and f32 scale planes
    travel as they are. The arrays' bytes are copied once, into the
    blob; the CRC runs over them in place."""
    fields: List[List[Any]] = []
    parts: List[memoryview] = []
    crc = 0
    wire_used = "raw"
    for name in ("k", "v", "kdq", "vdq"):
        if name not in pages:
            continue
        a = np.ascontiguousarray(pages[name])
        dt = _field_dtype(pages, name, a)
        if wire == "int8" and name in ("k", "v") and dt != BF16 \
                and a.dtype.kind == "f":
            flat = np.asarray(a, np.float32).reshape(-1)
            block = QC.block_size()
            qpadded, nblocks, _ = QC.wire_layout(flat.size, block)
            padded = np.zeros((qpadded,), np.float32)
            padded[:flat.size] = flat
            w = QC.encode_flat(padded, block)[0]
            fields.append([name, "q8", list(a.shape), dt, int(w.size),
                           nblocks, block, int(flat.size)])
            a = w
            wire_used = "int8"
        else:
            fields.append([name, "raw", list(a.shape), dt, int(a.nbytes),
                           0, 0, 0])
        part = memoryview(a).cast("B")
        crc = zlib.crc32(part, crc)
        parts.append(part)
    header = {"v": 1, "epoch": [int(e) for e in epoch],
              "chain": [[int(d), int(h)] for d, h in pages["chain"]],
              "tokens": [int(t) for t in pages["tokens"]],
              "dtype": pages["dtype"], "wire": wire_used,
              "fields": fields, "crc": crc & 0xFFFFFFFF}
    return b"".join([json.dumps(header).encode("utf-8"), b"\n", *parts])


def unpack_pages(blob: bytes) -> Tuple[Dict[str, Any], Tuple[int, ...]]:
    """Inverse of :func:`pack_pages`: ``(payload for ingest_pages,
    epoch)``; bf16 fields come back as 16-bit patterns. Raises
    :class:`PageCorruptError` on a CRC or parse failure, the signal the
    failure ladder maps to a recompute."""
    blob = bytes(blob)               # no copy when it already is bytes
    nl = blob.find(b"\n")
    if nl < 0:
        raise PageCorruptError("migration payload truncated (no header)")
    head, body = blob[:nl], memoryview(blob)[nl + 1:]   # body: a view
    try:
        header = json.loads(head.decode("utf-8"))
    except Exception as e:
        raise PageCorruptError(
            f"migration header does not parse: {e}") from e
    if zlib.crc32(body) & 0xFFFFFFFF != header.get("crc"):
        raise PageCorruptError(
            "migration payload CRC mismatch: pages rejected at ingest")
    out: Dict[str, Any] = {
        "chain": [(int(d), int(h)) for d, h in header["chain"]],
        "tokens": [int(t) for t in header["tokens"]],
        "dtype": header["dtype"],
    }
    offset = 0
    for name, enc, shape, dtype, size, nblocks, block, numel \
            in header["fields"]:
        if enc == "q8":
            w = np.frombuffer(body, np.int8, count=size, offset=offset)
            offset += size
            flat = QC.decode_flat(w, nblocks, block)[:numel]
            out[name] = flat.reshape(shape).astype(np.dtype(dtype))
        else:
            dt = np.dtype(np.int16) if dtype == BF16 else np.dtype(dtype)
            count = int(np.prod(shape)) if shape else 1
            out[name] = np.frombuffer(
                body, dt, count=count, offset=offset).reshape(shape)
            offset += size
    return out, tuple(int(e) for e in header["epoch"])


def _flip_tail(blob: bytes) -> bytes:
    """Chaos 'corrupt': flip the final payload byte. The header still
    parses; the CRC check trips."""
    if not blob:
        return blob
    return blob[:-1] + bytes([blob[-1] ^ 0xFF])


# ---------------------------------------------------------------------------
# Page transport
# ---------------------------------------------------------------------------

class PageTransport:
    """Content-keyed page plane: ``offer(key, blob)`` / ``pull_once(key)``
    over a store when the fleet spans processes, or an in-process dict.
    The store is ``torch.distributed.TCPStore``'s surface: ``set``,
    ``get`` (bytes), ``check([key])`` and ``delete_key``. The chaos
    ``migration`` site hooks both verbs; ``stats["bytes_offered"]``
    counts the wire bytes published."""

    def __init__(self, store=None):
        self.store = store
        self._local: Dict[str, bytes] = {}
        self.stats = {"offers": 0, "pulls": 0, "dropped": 0,
                      "corrupted": 0, "bytes_offered": 0}

    def offer(self, key: str, blob: bytes,
              victim: Optional[int] = None) -> bool:
        """Publish a payload; False when a chaos drop ate it (the pull
        side then times out into the retry and fallback ladder)."""
        hook = _CHAOS_HOOK[0]
        fault = hook("offer", victim) if hook is not None else None
        if fault == "drop":
            self.stats["dropped"] += 1
            return False
        if fault == "corrupt":
            blob = _flip_tail(blob)
            self.stats["corrupted"] += 1
        if self.store is not None:
            self.store.set(key, blob)
        else:
            self._local[key] = bytes(blob)
        self.stats["offers"] += 1
        self.stats["bytes_offered"] += len(blob)
        return True

    def pull_once(self, key: str, timeout_s: float,
                  victim: Optional[int] = None) -> bytes:
        """One pull attempt; raises :class:`MigrationTimeout` when the
        payload is absent past ``timeout_s`` (the caller owns retries and
        backoff)."""
        hook = _CHAOS_HOOK[0]
        fault = hook("pull", victim) if hook is not None else None
        if fault == "drop":
            raise MigrationTimeout(f"migration pull dropped (chaos): {key}")
        blob: Optional[bytes] = None
        if self.store is not None:
            deadline = time.monotonic() + max(timeout_s, 0.0)
            while True:
                try:
                    if self.store.check([key]):
                        blob = self.store.get(key)
                        break
                except Exception:  # noqa: BLE001 — a store hiccup: retry
                    pass
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.005)
        else:
            blob = self._local.get(key)
        if blob is None:
            raise MigrationTimeout(
                f"migration pull timed out after {timeout_s}s: {key}")
        if fault == "corrupt":
            blob = _flip_tail(blob)
            self.stats["corrupted"] += 1
        self.stats["pulls"] += 1
        return blob

    def forget(self, key: str):
        self._local.pop(key, None)
        if self.store is not None:
            try:
                self.store.delete_key(key)
            except Exception:  # noqa: BLE001 — best effort
                pass


# ---------------------------------------------------------------------------
# Fleet-global prefix index
# ---------------------------------------------------------------------------

class FleetPrefixIndex:
    """``chain_hash -> depth`` per replica: the block manager's rolling-
    hash prefix cache lifted fleet-global, so placement can route a
    prompt to wherever its prefix already lives. Store-backed when a
    store is given (one JSON key a replica, last write wins), in-process
    otherwise."""

    KEY = "paddle_disagg/prefix"

    def __init__(self, store=None, cap: int = 4096):
        self.store = store
        self.cap = int(cap)
        self._local: Dict[int, Dict[int, int]] = {}

    def publish(self, replica_id: int, chain: Sequence[Tuple[int, int]]):
        m = self._local.setdefault(int(replica_id), {})
        for depth, h in chain:
            m[int(h)] = int(depth)
        while len(m) > self.cap:          # FIFO bound, oldest claims out
            m.pop(next(iter(m)))
        if self.store is not None:
            self.store.set(f"{self.KEY}/{int(replica_id)}",
                           json.dumps([[h, d] for h, d in m.items()]))

    def drop(self, replica_id: int):
        self._local.pop(int(replica_id), None)
        if self.store is not None:
            try:
                self.store.delete_key(f"{self.KEY}/{int(replica_id)}")
            except Exception:  # noqa: BLE001 — best effort
                pass

    def _view(self, replica_id: int) -> Dict[int, int]:
        if self.store is not None:
            try:
                key = f"{self.KEY}/{int(replica_id)}"
                if self.store.check([key]):
                    raw = self.store.get(key)
                    return {int(h): int(d) for h, d in json.loads(
                        raw if isinstance(raw, str)
                        else raw.decode("utf-8"))}
            except Exception:  # noqa: BLE001 — fall back to the local view
                pass
        return self._local.get(int(replica_id), {})

    def depth(self, replica_id: int,
              chain: Sequence[Tuple[int, int]]) -> int:
        """Deepest contiguous prefix of `chain` this replica has published
        (0 = no claim)."""
        m = self._view(replica_id)
        best = 0
        for d, h in chain:
            if m.get(int(h)) is None:
                break
            best = int(d)
        return best


# ---------------------------------------------------------------------------
# SLO autoscaler
# ---------------------------------------------------------------------------

class PoolAutoscaler:
    """Grow or shrink the decode pool from an SLO summary: grow when TTFT
    p99, TPOT p99 or the queue-shed rate breaches its target, shrink when
    comfortably below all three. Deadline expiries never grow the pool
    (more replicas do not relax a deadline). The defaults are the
    reference's `FLAGS_autoscale_*`; a target of 0 turns its rule off."""

    def __init__(self, router: "DisaggRouter", ttft_p99_s: float = 0.0,
                 shed_rate: float = 0.05, min_decode: int = 1,
                 max_decode: int = 4, cooldown_s: float = 5.0,
                 tpot_p99_s: float = 0.0):
        self.router = router
        self.ttft_p99_s = float(ttft_p99_s)
        self.tpot_p99_s = float(tpot_p99_s)
        self.shed_rate = float(shed_rate)
        self.min_decode = int(min_decode)
        self.max_decode = int(max_decode)
        self.cooldown_s = float(cooldown_s)
        self._last: Optional[float] = None
        self.stats = {"grows": 0, "shrinks": 0, "holds": 0}

    def tick(self, summary: Optional[dict] = None,
             now: Optional[float] = None) -> Optional[str]:
        """One decision from ``summary`` (``ttft_p99_s``, ``tpot_p99_s``,
        ``shed_queue_rate``, ``deadline_expired``): 'grow', 'shrink' or
        'hold'; None inside the cooldown window. ``now`` defaults to
        ``time.monotonic()``. The reference reads a missing summary from
        its fleet metrics, which the port does not have yet: None
        raises."""
        if summary is None:
            raise NotImplementedError(
                "PoolAutoscaler.tick needs an explicit summary: the fleet "
                "SLO digest (fleet_summary) waits for the observability "
                "port (ROADMAP Queue A item 8)")
        now = time.monotonic() if now is None else float(now)
        if self._last is not None and now - self._last < self.cooldown_s:
            return None
        self._last = now
        pool = self.router.decode_pool_size()
        ttft = float(summary.get("ttft_p99_s", 0.0))
        tpot = float(summary.get("tpot_p99_s", 0.0))
        shed_q = float(summary.get("shed_queue_rate",
                                   summary.get("shed_rate", 0.0)))
        breach = ((self.ttft_p99_s > 0 and ttft > self.ttft_p99_s)
                  or (self.tpot_p99_s > 0 and tpot > self.tpot_p99_s)
                  or (self.shed_rate > 0 and shed_q > self.shed_rate))
        if breach and pool < self.max_decode:
            self.router.grow_decode()
            self.stats["grows"] += 1
            return "grow"
        if (not breach and pool > self.min_decode and shed_q == 0.0
                and (self.ttft_p99_s <= 0 or ttft < 0.5 * self.ttft_p99_s)
                and (self.tpot_p99_s <= 0
                     or tpot < 0.5 * self.tpot_p99_s)):
            self.router.shrink_decode()
            self.stats["shrinks"] += 1
            return "shrink"
        self.stats["holds"] += 1
        return "hold"


# ---------------------------------------------------------------------------
# chaos: the rank-kill hook
# ---------------------------------------------------------------------------

# One hook serves every router: migration:rank_dead kills a replica of the
# newest DisaggRouter (the reference's newest router takes the hook over),
# held weakly, so a process that builds routers one after another keeps
# none of them, nor their engines, alive. Other sites go to the hook that
# was installed before this one.
_NEWEST_ROUTER: List[Optional["weakref.ref[DisaggRouter]"]] = [None]
_PREV_KILL_HOOK: List[Any] = [None]


def _rank_kill(victim: int, site: str):
    if site != "migration":
        if _PREV_KILL_HOOK[0] is not None:
            _PREV_KILL_HOOK[0](victim, site)
        return
    ref = _NEWEST_ROUTER[0]
    router = ref() if ref is not None else None
    if router is not None:
        router._chaos_rank_kill(victim)


def _install_rank_kill(router: "DisaggRouter"):
    from ...distributed.fault_tolerance import chaos as _chaos
    _NEWEST_ROUTER[0] = weakref.ref(router)
    prev = _chaos.set_rank_kill_hook(_rank_kill)
    if prev is not _rank_kill:
        _PREV_KILL_HOOK[0] = prev


# ---------------------------------------------------------------------------
# The disaggregated router
# ---------------------------------------------------------------------------

class DisaggRouter(ServingRouter):
    """:class:`ServingRouter` with prefill / decode pools and lease-fenced
    KV page migration::

        router = DisaggRouter(factory, pools="prefill=1,decode=1")
        rid = router.submit(prompt, max_new_tokens=16)
        for tok in router.stream(rid):   # TTFT from the prefill pool,
            ...                          # the rest from the decode pool

    ``pools=""`` serves monolithic (the base router); with a spec,
    ``num_replicas`` follows from it. ``store``: a store shared by the
    fleet's processes for pages and prefix claims (in process without).
    The autoscaler is a separate :class:`PoolAutoscaler` ticked with
    explicit summaries (the reference's ``autoscale=True`` ticks it from
    fleet metrics, which wait for the observability port)."""

    def __init__(self, engine_factory, pools: str = "", store=None,
                 migration_timeout_s: float = 0.2,
                 migration_retries: int = 3,
                 migration_backoff_s: float = 0.01,
                 migration_wire_dtype: str = "",
                 migration_monolithic_after: int = 3,
                 migration_monolithic_cooldown_s: float = 30.0, **kw):
        if migration_wire_dtype not in ("", "int8"):
            raise ValueError(f"migration_wire_dtype="
                             f"{migration_wire_dtype!r}: want '' or 'int8'")
        self.pools = parse_pools(pools)
        if self.pools is not None:
            kw.setdefault("num_replicas",
                          self.pools["prefill"] + self.pools["decode"])
        super().__init__(engine_factory, **kw)
        if self.pools is not None:
            for i, h in enumerate(self.replicas):
                h.role = ("prefill" if i < self.pools["prefill"]
                          else "decode")
        self.migration_timeout_s = float(migration_timeout_s)
        self.migration_retries = int(migration_retries)
        self.migration_backoff_s = float(migration_backoff_s)
        self.migration_wire_dtype = migration_wire_dtype
        self.migration_monolithic_after = int(migration_monolithic_after)
        self.migration_monolithic_cooldown_s = float(
            migration_monolithic_cooldown_s)
        self.transport = PageTransport(store)
        self.prefix_index = FleetPrefixIndex(store)
        # rid -> handoff state: phase ("prefill" / "decode"), src replica,
        # epoch, transport key, chain, outcome
        self._handoffs: Dict[int, Dict[str, Any]] = {}
        self._mig_failures = 0          # consecutive; trips monolithic
        self._monolithic_until = 0.0
        self.disagg_stats = {"handoffs": 0, "handoffs_ok": 0,
                             "handoffs_local": 0, "fallbacks": 0,
                             "retries": 0, "pages_shipped": 0,
                             "re_pulls": 0, "monolithic_trips": 0}
        # chaos migration:rank_dead kills the sending replica of the newest
        # router (`_rank_kill`)
        _install_rank_kill(self)

    # -- pools -------------------------------------------------------------
    def pool(self, role: str) -> List[ReplicaHandle]:
        return [h for h in self.replicas if h.role == role]

    def decode_pool_size(self) -> int:
        """Accepting decode replicas (the autoscaler's sizing view)."""
        return sum(1 for h in self.replicas
                   if h.role == "decode" and h.state in (HEALTHY, DEGRADED))

    def _monolithic_active(self) -> bool:
        return time.monotonic() < self._monolithic_until

    def grow_decode(self) -> int:
        """Autoscaler grow: a fresh decode replica admitted on probation
        (DEGRADED until its first good step; one strike kills it)."""
        h = ReplicaHandle(len(self.replicas), self.engine_factory,
                          role="decode", **self.replica_kw)
        h.begin_probation()
        self.replicas.append(h)
        self._assigned[h.replica_id] = {}
        return h.replica_id

    def shrink_decode(self) -> Optional[int]:
        """Autoscaler shrink: gracefully drain the least-loaded active
        decode replica (a DRAINED replica stays in place, retired: list
        positions are stable ids)."""
        cands = [h for h in self.replicas
                 if h.role == "decode" and h.state in (HEALTHY, DEGRADED)]
        if len(cands) <= 1:
            return None

        def load(h):
            return (h.engine.scheduler.queue_depth()
                    + h.engine.scheduler.num_running()
                    if h.engine is not None else 0)

        victim = min(cands, key=lambda h: (load(h), -h.replica_id))
        self.drain(victim.replica_id)
        return victim.replica_id

    def _chaos_rank_kill(self, victim: int):
        if 0 <= int(victim) < len(self.replicas):
            h = self.replicas[int(victim)]
            if h.state != DEAD:
                h._kill("chaos_migration_rank_dead")

    # -- placement hooks ---------------------------------------------------
    def _request_chain(self, req: RouterRequest) -> List[Tuple[int, int]]:
        probe = next((h.engine for h in self.replicas
                      if h.engine is not None), None)
        if probe is None:
            return []
        return self._chain(req, probe.blocks)

    def _placement_candidates(self, req):
        base = super()._placement_candidates(req)
        if self.pools is None:
            return base
        hs = self._handoffs.get(req.rid)
        if hs is None:
            if req.max_new_tokens <= 1 or self._monolithic_active():
                return base        # same-replica serving, no handoff
            hs = self._handoffs[req.rid] = {"phase": "prefill"}
        role = "prefill" if hs["phase"] == "prefill" else "decode"
        pool = [h for h in base if h.role == role]
        # a wiped-out pool degrades to any accepting replica: serving
        # beats purity (a same-replica handoff short-circuits anyway)
        return pool or base

    def _prefix_signal(self, req, h):
        local = super()._prefix_signal(req, h)
        if self.pools is None:
            return local
        claimed = self.prefix_index.depth(h.replica_id,
                                          self._request_chain(req))
        return max(local, min(claimed, max(len(req.prompt) - 1, 0)))

    def _submit_budget(self, req):
        hs = self._handoffs.get(req.rid)
        if hs is not None and hs["phase"] == "prefill":
            return 1               # the prefill pool computes TTFT only
        return req.max_new_tokens

    def _prepare_submit(self, req, h):
        hs = self._handoffs.get(req.rid)
        if (hs is None or hs["phase"] != "decode" or hs.get("done")
                or hs.get("src") is None):
            return
        self._migrate(req, hs, h)

    # -- the handoff -------------------------------------------------------
    def _process_event(self, h, amap, req, ev):
        hs = self._handoffs.get(req.rid)
        if (hs is not None and hs["phase"] == "prefill" and ev.finished
                and ev.reason == "length" and ev.token >= 0
                and not req.confirming()):
            # prefill complete: the client sees its first token now
            # (TTFT); the stream does not finish, it hands off
            req.emitted.append(ev.token)
            req.events.append(TokenEvent(req.rid, ev.token, False, None))
            amap.pop(ev.rid, None)
            self._begin_handoff(req, h, hs)
            return
        if (hs is not None and hs["phase"] == "decode"
                and hs.get("done") == "pulled" and req.confirming()
                and ev.token >= 0 and not ev.finished
                and ev.token != req.emitted[req.confirmed]):
            # a confirm mismatch on migrated pages is a migration failure
            # (lossy wire, bad page), not a determinism violation: evict
            # the adopted pages and recompute
            self._mismatch_fallback(req, h, amap, ev, hs)
            return
        super()._process_event(h, amap, req, ev)

    def _begin_handoff(self, req: RouterRequest, src: ReplicaHandle,
                       hs: Dict[str, Any]):
        req.replica = None
        req.engine_rid = None
        req.confirm_target = len(req.emitted)   # decode replays token 1
        req.confirmed = 0
        req.status = "waiting"
        hs["phase"] = "decode"
        hs["src"] = src.replica_id
        hs["epoch"] = (src.replica_id, src.incarnation)
        hs["started"] = time.monotonic()
        self.disagg_stats["handoffs"] += 1
        chain = (src.engine.blocks.prefix_chain(req.prompt)
                 if src.engine is not None else [])
        hs["chain"] = chain
        if chain:
            hs["key"] = (f"paddle_disagg/pages/{src.replica_id}/"
                         f"{src.incarnation}/"
                         f"{chain[-1][1] & 0xFFFFFFFFFFFFFFFF:x}")
            pages = src.engine.extract_pages(req.prompt)
            if pages is not None:
                blob = pack_pages(pages, hs["epoch"],
                                  self.migration_wire_dtype)
                self.transport.offer(hs["key"], blob,
                                     victim=src.replica_id)
                self.disagg_stats["pages_shipped"] += len(chain)
                self.prefix_index.publish(src.replica_id, chain)
        # the sender may have been killed by a chaos rank_dead riding the
        # offer itself: the epoch check at pull time catches it
        self._pending.setdefault(req.tenant, deque()).appendleft(req)

    def _check_epoch(self, hs: Dict[str, Any]):
        src_id, src_inc = hs["epoch"]
        src = self.replicas[src_id]
        if (src.state == DEAD or src.incarnation != src_inc
                or not src.lease_live()):
            raise StaleEpochError(
                f"sender replica {src_id} epoch {src_inc} is stale "
                f"(state={src.state}, incarnation={src.incarnation}, "
                f"lease_live={src.lease_live()}): pages rejected at ingest")

    def _migrate(self, req: RouterRequest, hs: Dict[str, Any],
                 dst: ReplicaHandle):
        hs["dst"] = dst.replica_id
        if hs["src"] == dst.replica_id:
            # the pages already live here: nothing crosses the wire
            hs["done"] = "local"
            self.disagg_stats["handoffs_local"] += 1
            self._mig_failures = 0
            return
        if not hs.get("chain") or not hs.get("key"):
            self._fallback(req, hs, "no_pages")
            return
        retries = self.migration_retries
        repull = bool(hs.pop("repull", False))
        last: Optional[Exception] = None
        for attempt in range(retries + 1):
            try:
                # both leases fence the transfer: the sender must still be
                # the live engine that computed the pages, and the receiver
                # must itself hold a live lease
                self._check_epoch(hs)
                if dst.state == DEAD or not dst.lease_live():
                    raise StaleEpochError(
                        f"receiver replica {dst.replica_id} lease is not "
                        f"live: refusing to adopt pages")
                blob = self.transport.pull_once(
                    hs["key"], self.migration_timeout_s, victim=hs["src"])
                payload, epoch = unpack_pages(blob)
                if tuple(epoch) != tuple(hs["epoch"]):
                    raise StaleEpochError(
                        f"payload epoch {tuple(epoch)} != expected "
                        f"{tuple(hs['epoch'])}: stale sender")
                self._check_epoch(hs)   # died between offer and ingest
                n = dst.engine.ingest_pages(payload)
                hs["done"] = "pulled"
                hs["pages"] = n
                self._mig_failures = 0
                self.disagg_stats["handoffs_ok"] += 1
                if repull:
                    self.disagg_stats["re_pulls"] += 1
                self.prefix_index.publish(dst.replica_id, hs["chain"])
                return
            except MigrationTimeout as e:
                last = e
                if attempt < retries:
                    self.disagg_stats["retries"] += 1
                    time.sleep(min(self.migration_backoff_s * (2 ** attempt),
                                   1.0))
                continue
            except (StaleEpochError, PageCorruptError, ValueError) as e:
                last = e            # not retryable: stale or bad payload
                break
        reason = {MigrationTimeout: "timeout",
                  StaleEpochError: "stale_epoch",
                  PageCorruptError: "corrupt",
                  ValueError: "bad_payload"}.get(type(last), "error")
        self._fallback(req, hs, reason)

    def _fallback(self, req: RouterRequest, hs: Dict[str, Any],
                  reason: str):
        """Degrade to decode-side recompute: the submit proceeds with no
        adopted pages, the engine prefills from the prompt, and the
        streamed token is regenerated exactly."""
        hs["done"] = "fallback"
        hs["fallback_reason"] = reason
        self.disagg_stats["fallbacks"] += 1
        self._note_failure()

    def _note_failure(self):
        self._mig_failures += 1
        trip_after = self.migration_monolithic_after
        if trip_after > 0 and self._mig_failures >= trip_after:
            self._monolithic_until = (time.monotonic()
                                      + self.migration_monolithic_cooldown_s)
            self._mig_failures = 0
            self.disagg_stats["monolithic_trips"] += 1

    def _mismatch_fallback(self, req: RouterRequest, h: ReplicaHandle,
                           amap, ev, hs: Dict[str, Any]):
        amap.pop(ev.rid, None)
        if h.engine is not None:
            h.engine.cancel(ev.rid)
            # the adopted chain produced a wrong token: drop those pages
            # so the recompute (here or anywhere) cannot hit them again
            h.engine.blocks.evict_hashes(
                [ch for _, ch in hs.get("chain", [])])
        req.replica = None
        req.engine_rid = None
        req.confirmed = 0
        req.status = "waiting"
        self._fallback(req, hs, "mismatch")
        self._pending.setdefault(req.tenant, deque()).appendleft(req)

    # -- router tick / failover integration --------------------------------
    def step(self) -> int:
        # out-of-band deaths (chaos migration:rank_dead kills a replica
        # between ticks): fail its streams over before a probation
        # readmit could hand the id a fresh engine with orphaned work
        for h in self.replicas:
            if h.state == DEAD and self._assigned[h.replica_id]:
                self._failover(h)
        return super().step()

    def _failover(self, h):
        for req in list(self._assigned[h.replica_id].values()):
            hs = self._handoffs.get(req.rid)
            if (hs is not None and hs["phase"] == "decode"
                    and hs.get("done")):
                # the decode replica died mid-decode: pull the pages again
                # on the survivor if the offer is still live, else the
                # epoch / timeout ladder lands on recompute
                hs["done"] = None
                hs["repull"] = True
        self.prefix_index.drop(h.replica_id)
        super()._failover(h)

    def _finish(self, req, reason, terminal_logged: bool = False):
        hs = self._handoffs.pop(req.rid, None)
        if hs is not None and hs.get("key"):
            # drop the offered payload unless another in-flight handoff
            # (same prompt content, same sender) still needs it
            if not any(o.get("key") == hs["key"]
                       for o in self._handoffs.values()):
                self.transport.forget(hs["key"])
        super()._finish(req, reason, terminal_logged)

    # -- introspection -----------------------------------------------------
    def disagg_snapshot(self) -> Dict[str, Any]:
        """In-flight handoffs and the pool picture, as a plain dict."""
        now = time.monotonic()
        return {
            "pools": {role: [h.replica_id for h in self.pool(role)]
                      for role in ("prefill", "decode", "any")
                      if self.pool(role)},
            "decode_pool_accepting": self.decode_pool_size(),
            "monolithic_for_s": round(
                max(self._monolithic_until - now, 0.0), 3),
            "consecutive_failures": self._mig_failures,
            "in_flight_handoffs": {
                str(rid): {"phase": hs.get("phase"),
                           "src": hs.get("src"),
                           "dst": hs.get("dst"),
                           "done": hs.get("done"),
                           "epoch": list(hs.get("epoch", ())),
                           "age_s": round(now - hs["started"], 3)
                           if "started" in hs else None}
                for rid, hs in self._handoffs.items()},
            "transport": dict(self.transport.stats),
            **self.disagg_stats,
        }
