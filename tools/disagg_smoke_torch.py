"""Disaggregated-serving smoke of the PyTorch port: prefill/decode pools
under a mid-handoff sender kill — the twin of `tools/disagg_smoke.py`.
Prints ONE JSON line; exit 0 iff ok.

    python3 tools/disagg_smoke_torch.py                # on the card
    python3 tools/disagg_smoke_torch.py --device cpu   # plain versions

It imports `paddle_tpu_torch` only. The reference's tiny config, trace,
chaos spec and check names, read for the port:
- a prefill replica is chaos-killed mid-handoff (`migration:rank_dead`
  riding the page offer, through the port's `chaos.reconfigure`, the
  reference's `FLAGS_chaos_spec`; `probation_s=1e9` keeps the victim
  down, the reference's `FLAGS_router_probation_s`): the epoch fence
  advances and the decode side recomputes the prefill — exactly one
  recompute fallback, counted by the router's `disagg_stats["fallbacks"]`
  (the reference reads it from its `paddle_migration_*` metrics), zero
  confirm mismatches, zero dropped streams;
- bit-exact: the merged client streams (kill run and steady run) equal
  a monolithic engine's on the same trace;
- steady state migrates: handoffs complete by page pull, pages are
  adopted, and a warm fleet serves a repeat trace with zero new CUDA-
  graph captures on any replica (`stats["graph_captures"]`, the port's
  counterpart of the reference's step-executable builds);
- the autoscaler grows the decode pool on a TTFT breach (the new replica
  admitted through probation, healthy once it serves) and drains it
  once the breach clears. Its summaries are explicit, as in the
  reference's smoke; the port's `PoolAutoscaler.tick` needs one.

All greedy: seeded determinism is what both the handoff confirm and the
recompute fallback rest on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

N_REQS = 8
SHARED_LEN = 16      # shared prompt prefix (2 full 8-token pages)
UNIQ_LEN = 4
NEW_TOKENS = 8
ENGINE_KW = dict(num_blocks=96, block_size=8, max_batch=8, token_budget=32)
DRILL_SPEC = "migration:rank_dead@op=offer;victim=0;count=1"


def _trace(vocab: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    shared = rs.randint(1, vocab, size=SHARED_LEN).tolist()
    return [shared + rs.randint(1, vocab, size=UNIQ_LEN).tolist()
            for _ in range(N_REQS)]


def _factory(cfg, params, dev):
    from paddle_tpu_torch.inference.serving import PagedServingEngine

    def build():
        return PagedServingEngine(cfg, params, max_len=cfg.max_seq_len,
                                  device=dev, **ENGINE_KW)

    return build


def _run_single(factory, prompts):
    """Monolithic single-engine reference: the bit-exact target every
    disagg run must reproduce."""
    eng = factory()
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    done = {c.rid: c.output_tokens for c in eng.run()}
    return [done[r] for r in rids]


def _run_kill_drill(factory, prompts):
    """Disagg fleet with the prefill replica killed mid-handoff."""
    from paddle_tpu_torch.distributed.fault_tolerance import chaos
    from paddle_tpu_torch.inference.serving import DisaggRouter

    router = DisaggRouter(factory, pools="prefill=1,decode=1",
                          probation_s=1e9,
                          tenant_weights={"default": N_REQS})
    chaos.reconfigure(DRILL_SPEC)
    try:
        rids = [router.submit(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        done = {c.rid: c for c in router.run()}
    finally:
        chaos.reconfigure("")
    return {
        "outputs": [done[r].output_tokens if r in done else None
                    for r in rids],
        "completed": len(done),
        "all_length_finish": all(done[r].finish_reason == "length"
                                 for r in rids if r in done),
        "recompute_fallbacks": router.disagg_stats["fallbacks"],
        "mismatches": router.stats["mismatches"],
        "shed": router.stats["shed"],
        "dead_prefill_state": router.replicas[0].state,
        "dead_prefill_incarnation": router.replicas[0].incarnation,
    }


def _run_steady(factory, prompts, dev):
    """No chaos: handoffs land by page pull; a warm repeat trace must
    capture no new graph anywhere in the fleet."""
    import torch

    from paddle_tpu_torch.inference.serving import DisaggRouter

    router = DisaggRouter(factory, pools="prefill=1,decode=1",
                          tenant_weights={"default": N_REQS})

    def one_pass():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [router.submit(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        done = {c.rid: c.output_tokens for c in router.run()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return [done[r] for r in rids], N_REQS * NEW_TOKENS / dt

    one_pass()                                    # warm + capture
    captures0 = [h.engine.stats["graph_captures"] for h in router.replicas]
    outputs, tps = one_pass()
    captures1 = [h.engine.stats["graph_captures"] for h in router.replicas]
    return {
        "outputs": outputs,
        "tokens_per_s": tps,
        "handoffs_ok": router.disagg_stats["handoffs_ok"],
        "fallbacks": router.disagg_stats["fallbacks"],
        "pages_shipped": router.disagg_stats["pages_shipped"],
        "adopted_pages": router.pool("decode")[0]
        .engine.blocks.stats["adopted_pages"],
        "graph_captures": captures1,
        "retraces": sum(c1 - c0 for c0, c1 in zip(captures0, captures1)),
    }


def _run_autoscale(factory, vocab):
    """Grow on a TTFT breach, heal through probation, drain on calm."""
    from paddle_tpu_torch.inference.serving import (DisaggRouter,
                                                    PoolAutoscaler)
    from paddle_tpu_torch.inference.serving.replica import (DRAINED,
                                                            DRAINING,
                                                            HEALTHY)

    # DISTINCT prefixes: prefix affinity would pin a shared-prefix trace
    # to the incumbent decode replica; the grown one must get real work
    rs = np.random.RandomState(99)
    prompts = [rs.randint(1, vocab, size=12).tolist() for _ in range(4)]
    router = DisaggRouter(factory, pools="prefill=1,decode=1",
                          tenant_weights={"default": N_REQS})
    scaler = PoolAutoscaler(router, ttft_p99_s=0.05, shed_rate=0.0,
                            min_decode=1, max_decode=2, cooldown_s=0.0)
    breach = {"ttft_p99_s": 1.0, "shed_queue_rate": 0.0,
              "deadline_expired": 0}
    calm = {"ttft_p99_s": 0.001, "shed_queue_rate": 0.0,
            "deadline_expired": 0}
    grew = scaler.tick(summary=breach) == "grow"
    pool_after_grow = router.decode_pool_size()
    grown = router.replicas[-1]
    probation_admitted = grown.probation and grown.role == "decode"
    # the grown replica must actually serve (probation heals on its
    # first good steps)
    for p in prompts:
        router.submit(p, max_new_tokens=NEW_TOKENS)
    router.run()
    healed = grown.state == HEALTHY
    drained = scaler.tick(summary=calm) == "shrink"
    router.step()                                 # let drain_tick settle
    drain_states = [h.state for h in router.replicas
                    if h.state in (DRAINING, DRAINED)]
    return {
        "grew": grew,
        "pool_after_grow": pool_after_grow,
        "probation_admitted": probation_admitted,
        "healed": healed,
        "drained": drained,
        "pool_after_drain": router.decode_pool_size(),
        "drain_states": drain_states,
    }


def _tiny(device):
    import torch

    from paddle_tpu_torch.device import resolve
    from paddle_tpu_torch.models import llama as L

    dev = resolve(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = L.LlamaConfig(vocab_size=97, hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        max_seq_len=96, dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return dev, cfg, L.params_to_device(params, dev)


def run(device=None) -> dict:
    """The smoke on `device` (default the card; "cpu" runs every kernel's
    plain version). Returns the JSON payload."""
    dev, cfg, params = _tiny(device)
    prompts = _trace(cfg.vocab_size)
    factory = _factory(cfg, params, dev)

    single_out = _run_single(factory, prompts)
    drill = _run_kill_drill(factory, prompts)
    steady = _run_steady(factory, prompts, dev)
    scale = _run_autoscale(factory, cfg.vocab_size)

    checks = {
        "zero_dropped_streams": (drill["completed"] == N_REQS
                                 and drill["all_length_finish"]),
        "kill_parity_bit_exact": drill["outputs"] == single_out,
        "exactly_one_recompute_fallback": (
            drill["recompute_fallbacks"] == 1),
        "zero_confirm_mismatches": drill["mismatches"] == 0,
        "nothing_shed": drill["shed"] == 0,
        "epoch_fence_advanced": drill["dead_prefill_incarnation"] == 1,
        "steady_parity_bit_exact": steady["outputs"] == single_out,
        "steady_handoffs_by_pull": (steady["handoffs_ok"] >= N_REQS
                                    and steady["fallbacks"] == 0
                                    and steady["adopted_pages"] > 0),
        "steady_zero_retrace": steady["retraces"] == 0,
        "autoscaler_grew_via_probation": (
            scale["grew"] and scale["pool_after_grow"] == 2
            and scale["probation_admitted"] and scale["healed"]),
        "autoscaler_drained_gracefully": (
            scale["drained"] and scale["pool_after_drain"] == 1
            and len(scale["drain_states"]) == 1),
    }
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "device": str(dev),
        "requests": N_REQS,
        "prompt_len": SHARED_LEN + UNIQ_LEN,
        "new_tokens": NEW_TOKENS,
        "chaos_spec": DRILL_SPEC,
        "dead_prefill_state": drill["dead_prefill_state"],
        "recompute_fallbacks": drill["recompute_fallbacks"],
        "steady_handoffs_ok": steady["handoffs_ok"],
        "steady_pages_shipped": steady["pages_shipped"],
        "steady_graph_captures": steady["graph_captures"],
        "steady_tokens_per_s": round(steady["tokens_per_s"], 1),
        "autoscale": {k: v for k, v in scale.items()
                      if k != "drain_states"},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default the card")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        payload = run(args.device)
    except Exception as e:  # noqa: BLE001 — the artifact must exist
        payload = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-800:]}
    payload["wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(payload))
    return 0 if payload.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
