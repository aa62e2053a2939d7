"""Where the router twin's time goes: the router's host work a tick
against one engine's `step`, over the twin's own passes.

    python3 tools/router_tax_torch.py                # on the card
    python3 tools/router_tax_torch.py --device cpu   # plain versions

`tools/router_smoke_torch.py` gates the 2-replica router's tokens/s at
>= 0.9x one replica serving its half-trace share. Both passes do the
same device work, one engine after the other, so whatever the router
pays a tick on the host beyond its replicas' `engine.step` is what the
gate measures. This tool runs the twin's share pass and its timed
router pass (same config, trace, warm-up and pass counts) with every
engine `step` and every `router.step` timed on the host clock, and
prints ONE JSON line: per pass the wall time, the ticks, the time inside the
engines' steps, and the rest (`outside_step_ms`: the router's tick
minus its replicas' steps, or the engine's `run` loop minus its steps),
each also per tick.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import router_smoke_torch as RS  # noqa: E402


class _Clock:
    """Sums host seconds and calls of one wrapped method."""

    def __init__(self):
        self.s = 0.0
        self.n = 0

    def wrap(self, obj, name, count=True):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s += time.perf_counter() - t0
                self.n += count

        setattr(obj, name, timed)


def _summary(wall, ticks, step_s, step_n, tick_s=None):
    outside = (tick_s if tick_s is not None else wall) - step_s
    return {"wall_ms": wall * 1e3, "ticks": ticks, "engine_steps": step_n,
            "in_engine_step_ms": step_s * 1e3,
            "outside_step_ms": outside * 1e3,
            "engine_step_ms_each": step_s * 1e3 / max(step_n, 1),
            "outside_step_ms_a_tick": outside * 1e3 / max(ticks, 1),
            "tokens_per_s": None}


def share_pass(factory, prompts, dev):
    """The twin's `_run_single` share passes (after its warm and full
    passes), timed inside."""
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
    out = []
    for _ in range(2):
        clock = _Clock()
        clock.wrap(eng, "step")
        RS._sync(dev)
        t0 = time.perf_counter()
        for p in batch:
            eng.submit(p, max_new_tokens=RS.NEW_TOKENS)
        eng.run()
        RS._sync(dev)
        wall = time.perf_counter() - t0
        del eng.step
        row = _summary(wall, clock.n, clock.s, clock.n)
        row["tokens_per_s"] = len(batch) * RS.NEW_TOKENS / wall
        out.append(row)
    return out


def router_pass(factory, prompts, dev):
    """The twin's `_run_router_timed` passes, timed inside."""
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
    out = []
    for _ in range(2):
        ticks, steps = _Clock(), _Clock()
        ticks.wrap(router, "step")
        for h in router.replicas:
            steps.wrap(h.engine, "step")
        RS._sync(dev)
        t0 = time.perf_counter()
        one_rids = [router.submit(p, max_new_tokens=RS.NEW_TOKENS)
                    for p in prompts]
        router.run()
        RS._sync(dev)
        wall = time.perf_counter() - t0
        del router.step
        for h in router.replicas:
            del h.engine.step
        row = _summary(wall, ticks.n, steps.s, steps.n, tick_s=ticks.s)
        row["outside_tick_ms"] = (wall - ticks.s) * 1e3
        row["tokens_per_s"] = len(one_rids) * RS.NEW_TOKENS / wall
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default the card")
    ap.add_argument("--rounds", type=int, default=3,
                    help="share and router passes, alternated")
    args = ap.parse_args(argv)
    dev, cfg, params = RS._tiny(args.device)
    prompts = RS._trace(cfg.vocab_size)
    factory = RS._factory(cfg, params, dev)
    rounds = []
    for _ in range(args.rounds):
        share = share_pass(factory, prompts, dev)
        row = {"share": share}
        best_s = max(r["tokens_per_s"] for r in share)
        row["router"] = router_pass(factory, prompts, dev)
        row["ratio_best_of_2"] = max(
            r["tokens_per_s"] for r in row["router"]) / best_s
        rounds.append(row)
    print(json.dumps({"device": str(dev), "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
