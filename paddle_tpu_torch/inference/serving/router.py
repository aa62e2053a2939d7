"""Multi-replica serving router: failover the client never sees — the
port of `paddle_tpu/inference/serving/router.py`.

``ServingRouter`` fronts N :class:`PagedServingEngine` replicas, each
behind a :class:`~.replica.ReplicaHandle` circuit breaker. A preempted
sequence already resumes with exact recompute inside one engine, so a
request replayed onto another replica of the same weights regenerates
the same tokens: replica death becomes a retry, not a dropped stream.

**Failover by replay-and-confirm.** When a replica dies mid-stream
(chaos kill, step failure, strike-out, lease expiry), every live stream
assigned to it is requeued and resubmitted to a healthy replica with its
original prompt, sampling knobs and seed. Each request's own generator
and rows whose bits do not depend on the tick they sit in (`engine.py`)
make the new replica regenerate the streamed prefix token for token; the
router confirms each regenerated token against what the client already
saw (a divergence finishes the stream as ``failover_mismatch`` and
raises :class:`FailoverMismatchError` from ``stream``), suppresses the
duplicates, and the client's iterator goes on.

**Placement** prefers the replica whose prefix cache already holds the
longest prefix of the prompt (:meth:`BlockManager.lookup_prefix`), then
the one holding the request's adapter, then the least loaded.
**Admission** is per-tenant weighted round-robin with per-tenant queue
caps, so one tenant's storm sheds that tenant only. **Drain** stops new
assignments, moves streams still in prefill, and lets decodes finish in
place.

The reference's `FLAGS_router_*` defaults (`router.py:58-77`) are the
constructor's defaults here. Metrics, tracing spans and distress
sections are left for a later slice; :meth:`snapshot` and
:attr:`router_stats` are plain dicts.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

from .adapters import AdapterMissingError
from .engine import Completion, PagedServingEngine, TokenEvent
from .replica import (DEAD, DEGRADED, DRAINED, DRAINING, HEALTHY,
                      ReplicaHandle, ReplicaKilledError)
from .scheduler import DeadlineExceededError, RejectedError

__all__ = ["ServingRouter", "RouterRequest", "FailoverMismatchError"]

FINISHED = "finished"


class FailoverMismatchError(RuntimeError):
    """A replayed stream diverged from what was already sent to the
    client: determinism is broken. The stream fails loudly."""


@dataclass(eq=False)
class RouterRequest:
    """Router-side record of one client stream (router rids are the
    client-visible ids; engine rids are per replica and change across
    failovers)."""
    rid: int
    tenant: str
    prompt: List[int]
    max_new_tokens: int
    eos: int = -1
    priority: int = 0
    deadline: Optional[float] = None    # absolute time.monotonic()
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    seed: int = 0
    adapter: Optional[str] = None
    # live state
    emitted: List[int] = field(default_factory=list)  # client-visible
    events: List[TokenEvent] = field(default_factory=list)
    replica: Optional[int] = None
    engine_rid: Optional[int] = None
    confirmed: int = 0        # replay progress through `emitted`
    confirm_target: int = 0   # len(emitted) at failover time
    failovers: int = 0
    migrations: int = 0
    status: str = "waiting"
    finish_reason: Optional[str] = None
    # the prompt's full-block prefix chain, by block size: hashed once,
    # probed against every replica's prefix cache at each placement
    chains: Dict[int, list] = field(default_factory=dict, repr=False)

    def confirming(self) -> bool:
        return self.confirmed < self.confirm_target


class ServingRouter:
    """Health-checked fan-out over N identical serving replicas::

        router = ServingRouter(lambda: PagedServingEngine(cfg, params),
                               num_replicas=2)
        rid = router.submit([1, 2, 3], max_new_tokens=32, tenant="batch")
        for tok in router.stream(rid):   # survives a replica kill
            ...
        done = router.run()

    ``engine_factory`` must build identical engines (same weights and
    geometry): failover rests on any replica regenerating any other's
    tokens exactly. A factory may hand every engine the same device
    weights (`params_to_device` keeps tensors already in place)."""

    def __init__(self, engine_factory: Callable[[], PagedServingEngine],
                 num_replicas: int = 2, ttl: float = 5.0,
                 stall_timeout_s: float = 5.0, dead_after: int = 2,
                 probation_s: float = 0.25, tenant_max_queue: int = 64,
                 tenant_weights: Optional[Dict[str, int]] = None,
                 max_failovers: int = 2, adapter_transport=None):
        n = int(num_replicas)
        if n < 1:
            raise ValueError("num_replicas must be >= 1")
        self.engine_factory = engine_factory
        self.replica_kw = dict(ttl=float(ttl),
                               stall_timeout_s=float(stall_timeout_s),
                               dead_after=int(dead_after),
                               probation_s=float(probation_s))
        self.replicas = [ReplicaHandle(i, engine_factory, **self.replica_kw)
                         for i in range(n)]
        self.tenant_max_queue = int(tenant_max_queue)
        self.tenant_weights = dict(tenant_weights or {})
        self.max_failovers = int(max_failovers)
        self._pending: Dict[str, Deque[RouterRequest]] = {}
        self._reqs: Dict[int, RouterRequest] = {}
        self._live: set = set()           # rids not yet finished
        # replica_id -> {engine_rid -> RouterRequest}
        self._assigned: Dict[int, Dict[int, RouterRequest]] = {
            h.replica_id: {} for h in self.replicas}
        self._wrr_pos = 0
        self._next_rid = 0
        self._completions: List[Completion] = []
        # replicas missing a requested adapter prefetch its wire pack
        # over this transport instead of shedding the stream
        self.adapter_transport = adapter_transport
        self.stats = {"admitted": 0, "shed": 0, "assigned": 0,
                      "failovers": 0, "failover_exhausted": 0,
                      "migrations": 0, "drains": 0, "mismatches": 0,
                      "adapter_routed": 0, "adapter_prefetches": 0}

    # -- client API -------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, tenant: str = "default",
               priority: int = 0, deadline_s: Optional[float] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None, seed: int = 0,
               adapter: Optional[str] = None) -> int:
        """Enqueue a stream. Raises RejectedError when `tenant`'s router
        queue is at its cap (other tenants are unaffected), ValueError
        when the request can never fit a replica."""
        prompt = [int(t) for t in tokens]
        probe = next((h.engine for h in self.replicas
                      if h.engine is not None), None)
        if probe is not None:
            total = len(prompt) + max(int(max_new_tokens), 0)
            if total > probe.max_len:
                raise ValueError(
                    f"prompt {len(prompt)} + new {max_new_tokens} exceeds "
                    f"replica max_len {probe.max_len}")
            if probe.blocks.blocks_needed(total) > probe.num_blocks:
                raise ValueError(
                    f"request needs "
                    f"{probe.blocks.blocks_needed(total)} KV blocks but "
                    f"each replica pool has {probe.num_blocks}")
        q = self._pending.setdefault(tenant, deque())
        if len(q) >= self.tenant_max_queue:
            self.stats["shed"] += 1
            raise RejectedError(
                f"router queue for tenant {tenant!r} full ({len(q)} >= "
                f"{self.tenant_max_queue}); request shed — back off")
        rid = self._next_rid
        self._next_rid += 1
        req = RouterRequest(
            rid, tenant, prompt, int(max_new_tokens),
            eos=-1 if eos_token_id is None else int(eos_token_id),
            priority=int(priority),
            deadline=(time.monotonic() + float(deadline_s)
                      if deadline_s is not None else None),
            temperature=temperature, top_p=top_p, seed=int(seed),
            adapter=adapter)
        self._reqs[rid] = req
        self._live.add(rid)
        self.stats["admitted"] += 1
        if max_new_tokens <= 0:
            self._finish(req, "length")   # no engine step will see it
            return rid
        q.append(req)
        return rid

    def cancel(self, rid: int) -> bool:
        req = self._reqs.get(rid)
        if req is None or req.status == FINISHED:
            return False
        if req.replica is not None:
            h = self.replicas[req.replica]
            self._assigned[req.replica].pop(req.engine_rid, None)
            if h.engine is not None:
                h.engine.cancel(req.engine_rid)
        else:
            try:
                self._pending[req.tenant].remove(req)
            except ValueError:
                pass
        self._finish(req, "cancelled")
        return True

    def has_work(self) -> bool:
        return bool(self._live)

    def run(self) -> List[Completion]:
        while self.has_work():
            self.step()
        out, self._completions = self._completions, []
        return out

    def stream(self, rid: int) -> Iterator[int]:
        """Yield rid's tokens as they are produced, driving the whole
        router (failovers happen under this loop unseen). Typed failures
        as the engine's: DeadlineExceededError, RejectedError (shed,
        failover exhausted, adapter missing), FailoverMismatchError."""
        req = self._reqs.get(rid)
        if req is None:
            raise KeyError(f"unknown rid {rid}")
        i = 0
        while True:
            while i < len(req.events):
                ev = req.events[i]
                i += 1
                if ev.token >= 0:
                    yield ev.token
                if ev.finished:
                    if ev.reason == "deadline":
                        raise DeadlineExceededError(
                            f"request {rid} expired mid-stream after "
                            f"{len(req.emitted)} tokens")
                    if ev.reason in ("shed", "failover_exhausted",
                                     "adapter_missing"):
                        raise RejectedError(
                            f"request {rid} shed mid-stream "
                            f"(reason={ev.reason})")
                    if ev.reason == "failover_mismatch":
                        raise FailoverMismatchError(
                            f"request {rid}: replayed continuation "
                            f"diverged from streamed prefix")
                    return
            if req.status == FINISHED:
                return
            self.step()

    # -- the router tick --------------------------------------------------
    def step(self) -> int:
        """One tick: probation readmits, WRR admission, guarded replica
        steps with failover, drain progress. Returns the number of
        harvested engine events."""
        for h in self.replicas:
            h.maybe_readmit()
        self._admit()
        progress = 0
        for h in self.replicas:
            if not h.steppable():
                continue
            try:
                h.check_lease()
            except ReplicaKilledError:
                self._failover(h)
                continue
            if h.engine.has_work():
                try:
                    events = h.guarded_step()
                except ReplicaKilledError:
                    self._failover(h)
                    continue
                progress += self._harvest(h, events)
            else:
                h.beat()
            h.drain_tick()
        return progress

    # -- admission / placement --------------------------------------------
    def _weight(self, tenant: str) -> int:
        return max(int(self.tenant_weights.get(tenant, 1)), 1)

    def _admit(self):
        tenants = sorted(t for t, q in self._pending.items() if q)
        if not tenants:
            return
        if not any(h.accepts_new() for h in self.replicas):
            # no target now; shed only when none can come back (every
            # replica drained or draining — a dead one gets a readmit)
            if not any(h.state == DEAD for h in self.replicas):
                for t in tenants:
                    while self._pending[t]:
                        req = self._pending[t].popleft()
                        self.stats["shed"] += 1
                        self._finish(req, "shed")
            return
        # weighted round-robin: rotate the tenant cycle each tick, up to
        # `weight` placements a tenant a pass
        start = self._wrr_pos % len(tenants)
        order = tenants[start:] + tenants[:start]
        self._wrr_pos += 1
        for t in order:
            q = self._pending[t]
            for _ in range(self._weight(t)):
                if not q or not self._place(q[0]):
                    break
                q.popleft()

    def _placement_candidates(self,
                              req: RouterRequest) -> List[ReplicaHandle]:
        """Replicas eligible to receive `req` now (subclass hook: the
        disagg router narrows this to the request's pool)."""
        return [h for h in self.replicas
                if h.accepts_new() and h.engine is not None]

    @staticmethod
    def _chain(req: RouterRequest, blocks) -> list:
        """req's prefix chain for `blocks`' block size, hashed once."""
        chain = req.chains.get(blocks.block_size)
        if chain is None:
            chain = req.chains[blocks.block_size] = blocks.prefix_chain(
                req.prompt)
        return chain

    def _prefix_signal(self, req: RouterRequest, h: ReplicaHandle) -> int:
        """Prefix-affinity score for placing `req` on `h` (subclass hook:
        the disagg router folds in the fleet-global index)."""
        blocks = h.engine.blocks
        return blocks.lookup_chain(self._chain(req, blocks), len(req.prompt))

    def _submit_budget(self, req: RouterRequest) -> int:
        """max_new_tokens of the engine submit (subclass hook: the disagg
        router caps prefill-phase placements at one token)."""
        return req.max_new_tokens

    def _prepare_submit(self, req: RouterRequest, h: ReplicaHandle):
        """Runs just before `req` is submitted to `h` (subclass hook: the
        disagg router pulls migrated pages here)."""

    def _adapter_signal(self, req: RouterRequest, h: ReplicaHandle) -> int:
        """Adapter affinity: 2 device-resident, 1 registered (a slot
        write away), 0 absent (needs a prefetch, or cannot run there)."""
        if req.adapter is None:
            return 0
        mgr = h.engine.adapters
        if not mgr.registered(req.adapter):
            return 0
        return 2 if mgr.has(req.adapter) else 1

    def publish_adapter(self, adapter) -> None:
        """Register a LoRA adapter on every live replica and, with a
        transport, publish its wire pack so later and readmitted replicas
        can prefetch it."""
        for h in self.replicas:
            if h.engine is not None:
                h.engine.adapters.register(adapter)
        if self.adapter_transport is not None:
            self.adapter_transport.publish(adapter)

    def _place(self, req: RouterRequest) -> bool:
        """Prefix- and adapter-affinity placement with least-loaded
        fallback; False when no accepting replica has room right now (the
        request stays queued)."""
        cands = self._placement_candidates(req)
        if not cands:
            return False
        # equal outstanding work can hide different device pressure
        # (int8 pages, adapter packs): bytes break the tie when they vary
        mixed = (len({h.engine.kv_page_bytes for h in cands}) > 1
                 or len({h.engine.adapters.bytes_in_use()
                         for h in cands}) > 1)

        def load(h):
            return (h.engine.scheduler.queue_depth()
                    + h.engine.scheduler.num_running(),
                    h.engine.blocks.bytes_in_use() if mixed else 0)

        # each candidate scored once: (prefix, adapter, load, id, handle)
        scored = [(self._prefix_signal(req, h), self._adapter_signal(req, h),
                   load(h), h.replica_id, h) for h in cands]
        if max(sc[0] for sc in scored) > 0:
            # paid-for KV beats a cheap slot write; adapters break ties
            order = sorted(scored, key=lambda sc: (-sc[0], -sc[1], sc[2],
                                                   sc[3]))
        elif req.adapter is not None and any(sc[1] for sc in scored):
            order = sorted(scored, key=lambda sc: (-sc[1], sc[2], sc[3]))
        else:
            order = sorted(scored, key=lambda sc: (sc[2], sc[3]))
        adapter_missing = 0
        for _, ad, _, _, h in order:
            deadline_s = None
            if req.deadline is not None:
                deadline_s = req.deadline - time.monotonic()
            if (req.adapter is not None and ad == 0
                    and self.adapter_transport is not None):
                # landed on a replica without the adapter: pull its pack
                if h.engine.adapters.prefetch(
                        req.adapter, self.adapter_transport) == "ok":
                    self.stats["adapter_prefetches"] += 1
            self._prepare_submit(req, h)
            try:
                engine_rid = h.engine.submit(
                    req.prompt, max_new_tokens=self._submit_budget(req),
                    eos_token_id=None if req.eos < 0 else req.eos,
                    priority=req.priority, deadline_s=deadline_s,
                    temperature=req.temperature, top_p=req.top_p,
                    seed=req.seed, adapter=req.adapter)
            except RejectedError:
                continue   # this replica's queue is full; try the next
            except AdapterMissingError:
                adapter_missing += 1
                continue   # not registered here, no transport copy
            req.replica = h.replica_id
            req.engine_rid = engine_rid
            req.status = "assigned"
            self._assigned[h.replica_id][engine_rid] = req
            h.beat()   # accepting work starts the lease's clock
            self.stats["assigned"] += 1
            if req.adapter is not None:
                self.stats["adapter_routed"] += 1
            return True
        if adapter_missing == len(order):
            # every replica refused for a reason that will not pass: shed
            # rather than leave it pending forever
            self.stats["shed"] += 1
            self._finish(req, "adapter_missing")
            return True
        return False

    # -- failover / drain -------------------------------------------------
    def _failover(self, h: ReplicaHandle):
        """The dead replica's streams requeue for replay, ahead of new
        arrivals; the client iterators keep waiting on the same events."""
        orphans = self._assigned[h.replica_id]
        self._assigned[h.replica_id] = {}
        for req in orphans.values():
            if req.status == FINISHED:
                continue
            req.failovers += 1
            if req.failovers > self.max_failovers:
                self.stats["failover_exhausted"] += 1
                self._finish(req, "failover_exhausted")
                continue
            req.replica = None
            req.engine_rid = None
            req.confirm_target = len(req.emitted)
            req.confirmed = 0
            req.status = "waiting"
            self._pending.setdefault(req.tenant, deque()).appendleft(req)
            self.stats["failovers"] += 1

    def drain(self, replica_id: int):
        """Graceful drain: no new assignments; streams still in prefill
        (nothing emitted) move to other replicas, decodes finish in
        place; the replica reads DRAINED once idle."""
        h = self.replicas[replica_id]
        h.start_drain()
        self.stats["drains"] += 1
        amap = self._assigned[replica_id]
        for engine_rid, req in list(amap.items()):
            if req.emitted or req.status == FINISHED:
                continue   # decoding (or done): let it finish here
            amap.pop(engine_rid)
            if h.engine is not None:
                h.engine.cancel(engine_rid)   # its event is unmapped
            req.replica = None
            req.engine_rid = None
            req.confirm_target = 0
            req.confirmed = 0
            req.status = "waiting"
            req.migrations += 1
            self._pending.setdefault(req.tenant, deque()).appendleft(req)
            self.stats["migrations"] += 1
        h.drain_tick()

    # -- harvest ----------------------------------------------------------
    def _harvest(self, h: ReplicaHandle, events: List[TokenEvent]) -> int:
        amap = self._assigned[h.replica_id]
        n = 0
        for ev in events:
            req = amap.get(ev.rid)
            if req is None:
                continue   # unmapped (moved or cancelled) engine stream
            n += 1
            self._process_event(h, amap, req, ev)
        return n

    def _process_event(self, h: ReplicaHandle,
                       amap: Dict[int, RouterRequest], req: RouterRequest,
                       ev: TokenEvent):
        if req.confirming():
            if ev.token >= 0 and not ev.finished \
                    and ev.token == req.emitted[req.confirmed]:
                req.confirmed += 1   # a duplicate, confirmed and dropped
                return
            if ev.finished and ev.token < 0 \
                    and ev.reason in ("deadline", "shed", "cancelled"):
                # the replay itself expired or was shed before catching
                # up: a typed outcome, not a determinism failure
                amap.pop(ev.rid, None)
                req.events.append(TokenEvent(req.rid, -1, True, ev.reason))
                self._finish(req, ev.reason, terminal_logged=True)
                return
            # anything else mid-confirm is a divergence: a wrong token, or
            # the replay ended before reaching the streamed prefix
            amap.pop(ev.rid, None)
            if h.engine is not None and not ev.finished:
                h.engine.cancel(ev.rid)
            self.stats["mismatches"] += 1
            self._finish(req, "failover_mismatch")
            return
        # the engine's event goes on the stream as it is: `stream` reads
        # its token, finished flag and reason (the rid is the engine's)
        if ev.token >= 0:
            req.emitted.append(ev.token)
            req.events.append(ev)
        if ev.finished:
            amap.pop(ev.rid, None)
            if ev.token < 0:
                req.events.append(ev)
            self._finish(req, ev.reason or "stop", terminal_logged=True)

    def _finish(self, req: RouterRequest, reason: str,
                terminal_logged: bool = False):
        if req.status == FINISHED:
            return
        req.status = FINISHED
        req.finish_reason = reason
        self._live.discard(req.rid)
        if not terminal_logged:
            req.events.append(TokenEvent(req.rid, -1, True, reason))
        self._completions.append(Completion(req.rid, list(req.prompt),
                                            list(req.emitted), reason))

    # -- introspection ----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Per-replica breaker state and the fleet's queues."""
        counts = {s: 0 for s in (HEALTHY, DEGRADED, DEAD, DRAINING,
                                 DRAINED)}
        for h in self.replicas:
            counts[h.state] += 1
        return {
            "replicas": {str(h.replica_id): h.snapshot()
                         for h in self.replicas},
            "states": counts,
            "pending_by_tenant": {t: len(q)
                                  for t, q in self._pending.items() if q},
            "live_streams": len(self._live),
            **self.stats,
        }

    @property
    def router_stats(self) -> dict:
        return dict(self.stats)
