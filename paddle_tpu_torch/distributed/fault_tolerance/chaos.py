"""Chaos harness: deterministic, spec-driven fault injection — the port
of `paddle_tpu/distributed/fault_tolerance/chaos.py`, serving sites only.

A spec is a comma-separated list of injections, the reference's
grammar::

    site:kind[@sel=val[;sel=val...]]

:func:`parse_spec` is the reference's (`chaos.py:171`): the same sites,
kinds and selectors, so a spec string means the same injections in both
packages, and a malformed one raises ValueError. :func:`reconfigure`
installs the hooks of the sites the port has:

- ``serving`` — ``stall`` (sleep ``delay=`` s at the start of the paged
  engine's tick), ``reject`` (raise the engine's ``RejectedError`` there);
- ``replica`` — at the ReplicaHandle's guarded step, filtered by
  ``victim=<replica_id>`` (other replicas do not count toward
  ``call=``): ``kill`` (raise ``ReplicaKilledError``: the replica is
  dead, its streams fail over), ``stall`` (sleep ``delay=`` s and strike),
  ``flap`` (a strike with no sleep);
- ``adapter`` — at the engine's per-tick residency check (``op=use``)
  and the AdapterTransport (``op=publish`` / ``op=fetch``): ``evict``
  (drop the adapter's device slot mid-stream: the tick reloads it, a
  swap), ``corrupt`` (flip a wire byte: the CRC rejects it), ``delay``;
- ``migration`` — at the disagg page transport's ``offer`` / ``pull``
  (`inference/serving/disagg.py`), filtered by ``victim=<sending replica
  id>``: ``drop`` (the payload is lost, the pull times out) and
  ``corrupt`` (flip the last byte: the CRC rejects it) are returned to
  the transport, ``delay`` sleeps in place, ``rank_dead`` kills the
  sending replica through the rank-kill hook
  (:func:`set_rank_kill_hook`, which the disagg router installs), so the
  epoch fence must reject its in-flight pages.

A spec that names any other site of the reference (``collective``,
``store``, ``dispatch``, ``fetch``, ``save``, ``pipeline``) raises
NotImplementedError naming it: the port has no such choke point, and an
injection that could never fire is refused, not ignored. Selectors:
``op=``, ``rank=``, ``victim=``, ``step=`` (the chaos step clock,
:func:`note_step`), ``call=`` (the Nth matching call, 0-based),
``count=`` (most firings, default 1; 0 = unlimited),
``delay=`` (seconds), ``prob=`` (seeded by ``seed``), ``stage=`` /
``microbatch=``. Each firing counts in :func:`injections`' ``fired``.
"""
from __future__ import annotations

import random
import time
from typing import List, Optional

__all__ = ["Injection", "parse_spec", "reconfigure", "active",
           "injections", "note_step", "set_rank_kill_hook",
           "PORTED_SITES"]


_SITES = ("collective", "store", "dispatch", "fetch", "save", "serving",
          "replica", "pipeline", "migration", "adapter")
_KINDS = {
    "collective": ("delay", "timeout", "hang", "rank_dead"),
    "store": ("drop", "garble", "delay", "partition"),
    "dispatch": ("nan", "inf", "rank_dead"),
    "fetch": ("stall",),
    "save": ("crash", "rank_dead"),
    "serving": ("stall", "reject"),
    "replica": ("kill", "stall", "flap"),
    "pipeline": ("hang", "rank_dead"),
    "migration": ("drop", "delay", "corrupt", "rank_dead"),
    "adapter": ("evict", "corrupt", "delay"),
}
#: the sites whose choke points the port has
PORTED_SITES = ("serving", "replica", "adapter", "migration")

_FLOAT_SELECTORS = ("delay", "prob")
_INT_SELECTORS = ("rank", "victim", "step", "call", "count", "stage",
                  "microbatch")


class Injection:
    __slots__ = ("site", "kind", "op", "rank", "victim", "step", "call",
                 "count", "delay", "prob", "stage", "microbatch", "seen",
                 "fired")

    def __init__(self, site, kind, op=None, rank=None, victim=None,
                 step=None, call=None, count=1, delay=0.05, prob=None,
                 stage=None, microbatch=None):
        self.site = site
        self.kind = kind
        self.op = op
        self.rank = rank
        self.victim = victim
        self.step = step
        self.call = call
        self.count = count
        self.delay = delay
        self.prob = prob
        self.stage = stage
        self.microbatch = microbatch
        self.seen = 0    # calls that matched the filters
        self.fired = 0   # injections applied

    def __repr__(self):
        sel = {k: getattr(self, k) for k in
               ("op", "rank", "victim", "step", "call", "count", "delay",
                "prob", "stage", "microbatch")
               if getattr(self, k) is not None}
        return f"Injection({self.site}:{self.kind} {sel} fired={self.fired})"


def parse_spec(spec: str) -> List[Injection]:
    """Parse a chaos spec; raises ValueError on a malformed entry, so a
    typo fails the run instead of injecting nothing."""
    out = []
    for raw in (spec or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        head, _, selpart = raw.partition("@")
        site, sep, kind = head.partition(":")
        site, kind = site.strip(), kind.strip()
        if not sep or site not in _SITES or kind not in _KINDS[site]:
            raise ValueError(
                f"chaos_spec entry {raw!r}: want site:kind with site in "
                f"{_SITES} and kind in {_KINDS.get(site, ())}")
        kw = {}
        for pair in selpart.split(";"):
            pair = pair.strip()
            if not pair:
                continue
            k, sep, v = pair.partition("=")
            k = k.strip()
            if not sep or k not in ("op",) + _INT_SELECTORS + _FLOAT_SELECTORS:
                raise ValueError(f"chaos_spec entry {raw!r}: bad selector "
                                 f"{pair!r}")
            if k == "op":
                kw[k] = v.strip()
            elif k in _INT_SELECTORS:
                kw[k] = int(v)
            else:
                kw[k] = float(v)
        out.append(Injection(site, kind, **kw))
    return out


# ---------------------------------------------------------------------------
# Live state: rebuilt by reconfigure; the hooks are installed only while a
# spec is active.
# ---------------------------------------------------------------------------

_injections: List[Injection] = []
_rng = random.Random(0)
_STEP = [0]           # the chaos step clock (note_step)
_installed = [False]
# rank-kill hook fn(victim, site): a rank_dead injection kills the victim
# through it (the disagg router installs one; without it rank_dead does
# nothing)
_rank_kill_hook = [None]


def set_rank_kill_hook(fn):
    """Install the rank-kill hook; returns the previous one, so an
    installer can chain the sites it does not own to it."""
    prev = _rank_kill_hook[0]
    _rank_kill_hook[0] = fn
    return prev


def _kill_victim(inj: Injection, rank: int, site: str):
    kill = _rank_kill_hook[0]
    victim = inj.victim if inj.victim is not None else rank
    if kill is not None:
        try:
            kill(victim, site)
        except Exception:  # noqa: BLE001 — the drill must not crash the job
            pass


def note_step(step: int):
    """Advance the chaos step clock (``step=`` selectors match it)."""
    _STEP[0] = int(step)


def active() -> bool:
    return bool(_injections)


def injections() -> List[Injection]:
    return list(_injections)


def _match(site: str, op: Optional[str] = None,
           rank: Optional[int] = None,
           victim: Optional[int] = None) -> Optional[Injection]:
    for inj in _injections:
        if inj.site != site:
            continue
        if inj.op is not None and inj.op != op:
            continue
        if inj.rank is not None and rank is not None and inj.rank != rank:
            continue
        # victim= filters the replica site: another replica's steps do not
        # count toward call=, so call=3 is the victim's 4th own step
        if (victim is not None and inj.victim is not None
                and inj.victim != victim):
            continue
        idx = inj.seen
        inj.seen += 1
        if inj.count and inj.fired >= inj.count:
            continue
        if inj.call is not None and idx != inj.call:
            continue
        if inj.step is not None and _STEP[0] != inj.step:
            continue
        if inj.prob is not None and _rng.random() >= inj.prob:
            continue
        inj.fired += 1
        return inj
    return None


# ---------------------------------------------------------------------------
# Site hooks
# ---------------------------------------------------------------------------

def _serving_hook(phase: str):
    """PagedServingEngine.step, each tick: 'stall' sleeps, 'reject' raises
    the engine's load-shed error."""
    inj = _match("serving", op=phase)
    if inj is None:
        return
    if inj.kind == "stall":
        time.sleep(inj.delay)
        return
    from ...inference.serving.scheduler import RejectedError

    raise RejectedError(
        f"[chaos] injected serving rejection: phase={phase} "
        f"step={_STEP[0]}")


def _replica_hook(phase: str, replica_id: int):
    """ReplicaHandle.guarded_step, before each engine tick: 'kill' raises
    ReplicaKilledError; 'stall' (after sleeping ``delay=``) and 'flap'
    are returned for the handle's breaker to judge."""
    inj = _match("replica", op=phase, victim=replica_id)
    if inj is None:
        return None
    if inj.kind == "kill":
        from ...inference.serving.replica import ReplicaKilledError

        raise ReplicaKilledError(
            f"[chaos] injected replica kill: replica={replica_id} "
            f"phase={phase} step={_STEP[0]}")
    if inj.kind == "stall" and inj.delay:
        time.sleep(inj.delay)
    return inj.kind


def _adapter_hook(op: str, name: Optional[str] = None):
    """The engine's residency check (op 'use', once per adapter a tick)
    and the AdapterTransport (op 'publish' / 'fetch'): 'delay' sleeps,
    'evict' and 'corrupt' are returned for the caller to apply.
    ``op=<adapter name>`` selects by adapter too."""
    inj = _match("adapter", op=op)
    if inj is None and name is not None:
        inj = _match("adapter", op=name)
    if inj is None:
        return None
    if inj.kind == "delay":
        time.sleep(inj.delay)
        return None
    return inj.kind


def _migration_hook(op: str, victim: Optional[int] = None):
    """The disagg page transport's ``offer`` / ``pull``, with the sending
    replica id as the ``victim=`` filter: 'delay' sleeps; 'drop' and
    'corrupt' are returned for the transport to apply; 'rank_dead' kills
    the sending replica mid-handoff through the rank-kill hook."""
    inj = _match("migration", op=op, victim=victim)
    if inj is None:
        return None
    if inj.kind == "delay":
        time.sleep(inj.delay)
        return None
    if inj.kind == "rank_dead":
        _kill_victim(inj, victim if victim is not None else 0, "migration")
        return None
    return inj.kind


def _set_hooks(on: bool):
    from ...inference.serving import adapters, disagg, engine, replica
    engine.set_chaos_hook(_serving_hook if on else None)
    replica.set_chaos_hook(_replica_hook if on else None)
    adapters.set_chaos_hook(_adapter_hook if on else None)
    disagg.set_chaos_hook(_migration_hook if on else None)
    _installed[0] = on


def reconfigure(spec: str = "", seed: int = 0):
    """(Re)build the injection set from `spec` and install or remove the
    serving hooks. Raises ValueError on a malformed spec and
    NotImplementedError on a site the port does not have."""
    global _injections
    parsed = parse_spec(spec)
    missing = sorted({i.site for i in parsed} - set(PORTED_SITES))
    if missing:
        raise NotImplementedError(
            f"chaos site(s) {missing} have no choke point in the port "
            f"(it injects at {PORTED_SITES}); an injection there would "
            f"never fire")
    _injections = parsed
    _rng.seed(int(seed))
    _STEP[0] = 0
    if _injections:
        _set_hooks(True)
    elif _installed[0]:
        _set_hooks(False)
