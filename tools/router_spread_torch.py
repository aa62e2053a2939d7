"""Why an engine's step takes longer inside the router twin than alone:
each step's host time, the cyclic collector's runs inside it, and the
router tick's own parts.

    python3 tools/router_spread_torch.py                # on the card
    python3 tools/router_spread_torch.py --device cpu   # plain versions

Runs `tools/router_smoke_torch.py`'s share pass (one engine) and its
timed router pass (two replicas), same config, trace and warm-up, in
three collector modes: `on` (as the twin runs), `frozen` (`gc.freeze()`
after the warm-up: every object alive then leaves the collector's
generations) and `off` (`gc.disable()` over the timed pass). For every
engine `step` it keeps the host time and whether a collection ran inside
it (`gc.callbacks`), and for the router tick the time of each part
(`maybe_readmit`, `_admit`, `check_lease`, `guarded_step` outside the
engine's step, `_harvest`, `beat`, `drain_tick`). Prints ONE JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import router_smoke_torch as RS  # noqa: E402


class _GcWatch:
    """Collections seen through gc.callbacks: (generation, start, end)."""

    def __init__(self):
        self.runs = []
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.runs.append((info["generation"], self._t0,
                              time.perf_counter()))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def _wrap_steps(engines, spans):
    for eng in engines:
        fn = eng.step

        def timed(_fn=fn):
            t0 = time.perf_counter()
            try:
                return _fn()
            finally:
                spans.append((t0, time.perf_counter()))

        eng.step = timed


def _unwrap(engines):
    for eng in engines:
        del eng.step


def _pct(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]


def _step_summary(spans, gcs):
    """Per-step ms, split by whether a collection ran inside the step."""
    with_gc, without = [], []
    gc_ms_in_steps = 0.0
    for a, b in spans:
        inside = [(g, s, e) for g, s, e in gcs if s >= a and e <= b]
        ms = (b - a) * 1e3
        (with_gc if inside else without).append(ms)
        gc_ms_in_steps += sum((e - s) * 1e3 for _, s, e in inside)
    allms = [(b - a) * 1e3 for a, b in spans]
    by_gen = {str(g): sum(1 for gg, _, _ in gcs if gg == g)
              for g in (0, 1, 2)}
    return {"steps": len(spans),
            "step_ms_p50": _pct(allms, 0.5), "step_ms_p90": _pct(allms, 0.9),
            "step_ms_max": max(allms) if allms else None,
            "step_ms_mean": statistics.fmean(allms) if allms else None,
            "steps_with_gc": len(with_gc),
            "step_ms_mean_with_gc": (statistics.fmean(with_gc)
                                     if with_gc else None),
            "step_ms_mean_without_gc": (statistics.fmean(without)
                                        if without else None),
            "gc_runs_by_gen": by_gen,
            "gc_ms_total": sum((e - s) * 1e3 for _, s, e in gcs),
            "gc_ms_in_steps": gc_ms_in_steps}


def _mode_enter(mode):
    if mode == "frozen":
        gc.collect()
        gc.freeze()
    elif mode == "off":
        gc.collect()
        gc.disable()


def _mode_exit(mode):
    if mode == "frozen":
        gc.unfreeze()
    elif mode == "off":
        gc.enable()


def share_pass(factory, prompts, dev, mode):
    eng = factory()
    batch = prompts[:RS.N_REQS // 2]

    def one(b):
        RS._sync(dev)
        for p in b:
            eng.submit(p, max_new_tokens=RS.NEW_TOKENS)
        eng.run()
        RS._sync(dev)

    one(prompts)
    one(prompts)
    spans = []
    _wrap_steps([eng], spans)
    _mode_enter(mode)
    try:
        with _GcWatch() as w:
            RS._sync(dev)
            t0 = time.perf_counter()
            for p in batch:
                eng.submit(p, max_new_tokens=RS.NEW_TOKENS)
            eng.run()
            RS._sync(dev)
            wall = time.perf_counter() - t0
    finally:
        _mode_exit(mode)
        _unwrap([eng])
    out = _step_summary(spans, w.runs)
    out["tokens_per_s"] = len(batch) * RS.NEW_TOKENS / wall
    return out


_PARTS = ("maybe_readmit", "check_lease", "beat", "drain_tick")


def router_pass(factory, prompts, dev, mode):
    from paddle_tpu_torch.inference.serving import ServingRouter

    router = ServingRouter(factory, num_replicas=2,
                           tenant_weights={"default": RS.N_REQS})

    def one():
        RS._sync(dev)
        for p in prompts:
            router.submit(p, max_new_tokens=RS.NEW_TOKENS)
        router.run()
        RS._sync(dev)

    one()
    spans = []
    engines = [h.engine for h in router.replicas]
    _wrap_steps(engines, spans)
    parts = {k: 0.0 for k in _PARTS + ("_admit", "_harvest",
                                       "guarded_step")}
    undo = []

    def clock(obj, name):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[name] += time.perf_counter() - t0

        setattr(obj, name, timed)
        undo.append((obj, name))

    for h in router.replicas:
        for name in _PARTS + ("guarded_step",):
            clock(h, name)
    clock(router, "_admit")
    clock(router, "_harvest")
    ticks = [0]
    step = router.step

    def tick():
        ticks[0] += 1
        return step()

    router.step = tick
    undo.append((router, "step"))
    _mode_enter(mode)
    try:
        with _GcWatch() as w:
            RS._sync(dev)
            t0 = time.perf_counter()
            for p in prompts:
                router.submit(p, max_new_tokens=RS.NEW_TOKENS)
            router.run()
            RS._sync(dev)
            wall = time.perf_counter() - t0
    finally:
        _mode_exit(mode)
        _unwrap(engines)
        for obj, name in undo:
            delattr(obj, name)
    out = _step_summary(spans, w.runs)
    in_steps = sum(b - a for a, b in spans)
    n = max(ticks[0], 1)
    out["ticks"] = ticks[0]
    out["tokens_per_s"] = len(prompts) * RS.NEW_TOKENS / wall
    out["parts_ms_a_tick"] = {k: v * 1e3 / n for k, v in parts.items()}
    out["parts_ms_a_tick"]["guarded_step_outside_engine_step"] = (
        (parts["guarded_step"] - in_steps) * 1e3 / n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default the card")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--modes", default="on,frozen,off")
    args = ap.parse_args(argv)
    dev, cfg, params = RS._tiny(args.device)
    prompts = RS._trace(cfg.vocab_size)
    factory = RS._factory(cfg, params, dev)
    rows = []
    for r in range(args.rounds):
        for mode in args.modes.split(","):
            share = share_pass(factory, prompts, dev, mode)
            router = router_pass(factory, prompts, dev, mode)
            rows.append({"round": r, "gc": mode, "share": share,
                         "router": router,
                         "ratio": router["tokens_per_s"]
                         / share["tokens_per_s"]})
    print(json.dumps({"device": str(dev), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
