"""Health-checked replica: one `PagedServingEngine` behind a lease — the
port of `paddle_tpu/inference/serving/replica.py`.

A replica is alive because it keeps proving it: every good step refreshes
a TTL lease, judged by the rule of `distributed/membership.live_by_beat`
(a beat at most `ttl` seconds old), which the reference's training
membership judges ranks by. On
top of the lease sits a circuit breaker::

    healthy ──strike──▶ degraded ──strike──▶ dead
       ▲                   │                  │
       └────good step──────┘        probation_s elapses
                                              │
                                              ▼
                          degraded (probation: a fresh engine from the
                          factory; first good step → healthy, any
                          strike → dead again)

A strike is a step slower than ``stall_timeout_s`` (a step that captured
a CUDA graph is warm-up, not a stall), a chaos ``replica:stall`` /
``replica:flap``, or a lease that lapsed while the replica had work. A
step that raises anything is an immediate kill (the engine's device
state is untrusted after it), as is chaos ``replica:kill``. A dead
replica drops its engine; readmission after ``probation_s`` builds a
fresh one, since recompute rebuilds any stream from its tokens alone.
The router (`router.py`) owns placement and failover; this module owns
the judgment.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from .engine import PagedServingEngine, TokenEvent

__all__ = ["ReplicaHandle", "ReplicaDeadError", "ReplicaKilledError",
           "HEALTHY", "DEGRADED", "DEAD", "DRAINING", "DRAINED",
           "set_chaos_hook"]

# chaos hook (site "replica"): installed by
# distributed/fault_tolerance/chaos.py while a spec is active. Called as
# hook("step", replica_id) before each guarded step; may raise
# ReplicaKilledError (kill) or return "stall" / "flap" for the handle to
# judge.
_CHAOS_HOOK = [None]


def set_chaos_hook(fn):
    _CHAOS_HOOK[0] = fn


class ReplicaKilledError(RuntimeError):
    """The replica died mid-step (chaos kill or a failed engine step).
    Streams assigned to it must fail over."""


class ReplicaDeadError(RuntimeError):
    """An operation on a replica the breaker already declared dead (or
    drained)."""


HEALTHY, DEGRADED, DEAD = "healthy", "degraded", "dead"
DRAINING, DRAINED = "draining", "drained"


class ReplicaHandle:
    """Circuit breaker and TTL lease around one serving engine.

    ``engine_factory`` builds a fresh :class:`PagedServingEngine`; it is
    called once here and again on every probation readmit."""

    def __init__(self, replica_id: int,
                 engine_factory: Callable[[], PagedServingEngine],
                 ttl: float = 5.0, stall_timeout_s: float = 5.0,
                 dead_after: int = 2, probation_s: float = 0.0,
                 role: str = "any"):
        self.replica_id = int(replica_id)
        self.factory = engine_factory
        self.engine: Optional[PagedServingEngine] = engine_factory()
        self.ttl = float(ttl)
        self.stall_timeout_s = float(stall_timeout_s)
        self.dead_after = int(dead_after)
        self.probation_s = float(probation_s)
        self.state = HEALTHY
        self.probation = False
        self.strikes = 0
        # disagg pool role: "prefill", "decode" or "any" (monolithic);
        # placement policy only, the engine underneath is the same
        self.role = str(role)
        # epoch fence for page migration: bumped on every death, so a
        # payload stamped under incarnation N is rejected at ingest once
        # this replica has died
        self.incarnation = 0
        self._beats: Dict[int, float] = {0: time.monotonic()}
        self._died_at: Optional[float] = None
        self.death_reason: Optional[str] = None
        self.stats = {"strikes": 0, "stalls": 0, "flaps": 0, "kills": 0,
                      "readmits": 0, "steps": 0}

    # -- lease ------------------------------------------------------------
    def beat(self):
        self._beats[0] = time.monotonic()

    def lease_live(self) -> bool:
        # live_by_beat's rule for the handle's one member, without its
        # sorted list: the router asks every replica every tick
        return time.monotonic() - self._beats[0] <= self.ttl

    def lease_age(self) -> float:
        return time.monotonic() - self._beats.get(0, 0.0)

    # -- breaker transitions ----------------------------------------------
    def _strike(self, why: str):
        self.strikes += 1
        self.stats["strikes"] += 1
        if why in ("stall", "flap"):
            self.stats[why + "s"] += 1
        if self.probation or self.strikes >= self.dead_after:
            self._kill(f"strikes:{why}")
        else:
            self.state = DEGRADED

    def _kill(self, why: str):
        self.stats["kills"] += 1
        self.incarnation += 1     # fence: in-flight migrations go stale
        self.engine = None        # device state untrusted past this point
        self._died_at = time.monotonic()
        self.death_reason = why
        self.probation = False
        self.state = DEAD

    def _recover(self):
        if self.state == DEGRADED:
            self.strikes = 0
            self.probation = False
            self.state = HEALTHY

    def maybe_readmit(self) -> bool:
        """Dead → probation once ``probation_s`` has passed: a fresh
        engine, DEGRADED until its first good step; any strike on
        probation kills it again."""
        if self.state != DEAD or self._died_at is None:
            return False
        if time.monotonic() - self._died_at < self.probation_s:
            return False
        self.engine = self.factory()
        self.strikes = self.dead_after - 1   # one misstep re-kills
        self.probation = True
        self._died_at = None
        self.beat()
        self.stats["readmits"] += 1
        self.state = DEGRADED
        return True

    def begin_probation(self):
        """Enter probation with the current engine: how the autoscaler
        admits a fresh replica through the machinery a readmitted one
        faces, DEGRADED until its first good step, any strike kills it."""
        self.strikes = self.dead_after - 1
        self.probation = True
        self.beat()
        self.state = DEGRADED

    # -- drain ------------------------------------------------------------
    def start_drain(self):
        if self.state in (HEALTHY, DEGRADED):
            self.state = DRAINING

    def drain_tick(self):
        if self.state == DRAINING and (
                self.engine is None or not self.engine.has_work()):
            self.state = DRAINED

    # -- predicates the router routes on ----------------------------------
    def accepts_new(self) -> bool:
        return self.state in (HEALTHY, DEGRADED)

    def steppable(self) -> bool:
        return (self.state in (HEALTHY, DEGRADED, DRAINING)
                and self.engine is not None)

    # -- the guarded step -------------------------------------------------
    def guarded_step(self) -> List[TokenEvent]:
        """One engine tick under the breaker. Raises
        :class:`ReplicaKilledError` when the replica dies during the tick
        (the router fails its streams over); a stall or flap strike that
        does not kill yields no events this tick."""
        if not self.steppable():
            raise ReplicaDeadError(
                f"replica {self.replica_id} is {self.state}")
        hook = _CHAOS_HOOK[0]
        if hook is not None:
            try:
                fault = hook("step", self.replica_id)
            except ReplicaKilledError:
                self._kill("chaos_kill")
                raise
            if fault in ("stall", "flap"):
                self._strike(fault)
                if self.state == DEAD:
                    raise ReplicaKilledError(
                        f"replica {self.replica_id} dead after repeated "
                        f"{fault}s")
                return []   # the tick produced nothing; lease not beaten
        captures = self.engine.stats["graph_captures"]
        t0 = time.perf_counter()
        try:
            events = self.engine.step()
        except Exception as e:  # noqa: BLE001 — any step failure = death
            self._kill(f"step_error:{type(e).__name__}")
            raise ReplicaKilledError(
                f"replica {self.replica_id} step failed: {e}") from e
        dur = time.perf_counter() - t0
        self.stats["steps"] += 1
        warm = self.engine.stats["graph_captures"] != captures
        if dur > self.stall_timeout_s and not warm:
            self._strike("stall")
            if self.state == DEAD:
                raise ReplicaKilledError(
                    f"replica {self.replica_id} dead: step took "
                    f"{dur:.3f}s > stall_timeout {self.stall_timeout_s}s")
        else:
            self._recover()
            self.beat()
        return events

    def check_lease(self):
        """Lease judgment (the router ticks it): a replica that has work
        but whose lease lapsed is dead."""
        if (self.state in (HEALTHY, DEGRADED, DRAINING)
                and self.engine is not None and self.engine.has_work()
                and not self.lease_live()):
            self._kill("lease_expired")
            raise ReplicaKilledError(
                f"replica {self.replica_id} lease expired "
                f"({self.lease_age():.3f}s > ttl {self.ttl}s)")

    # -- introspection ----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out = {"state": self.state, "strikes": self.strikes,
               "probation": self.probation, "role": self.role,
               "incarnation": self.incarnation,
               "lease_age_s": round(self.lease_age(), 3),
               "death_reason": self.death_reason, **self.stats}
        if self.engine is not None:
            eng = self.engine
            out["kv_utilization"] = round(eng.blocks.utilization(), 4)
            out["kv_bytes_in_use"] = eng.blocks.bytes_in_use()
            out["queue_depth"] = eng.scheduler.queue_depth()
            out["running"] = eng.scheduler.num_running()
            out["graph_captures"] = eng.stats["graph_captures"]
            mgr = eng.adapters
            out["adapters_resident"] = sorted(mgr.snapshot()["resident"])
            out["adapter_bytes_in_use"] = mgr.bytes_in_use()
            out["adapter_swaps"] = mgr.stats["swaps"]
            out["adapter_hits"] = mgr.stats["hits"]
            if eng.spec is not None:
                out["spec_acceptance_rate"] = eng.spec.acceptance_rate
        return out
