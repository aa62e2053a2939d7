"""Speculative-decoding + LoRA-adapter smoke of the PyTorch port: the
bit-exactness gate for multi-tenant serving — the twin of
`tools/spec_smoke.py`. Prints ONE JSON line; exit 0 iff ok.

    python3 tools/spec_smoke_torch.py                # on the card
    python3 tools/spec_smoke_torch.py --device cpu   # plain versions

It imports `paddle_tpu_torch` only. The reference's tiny config, draft
(the target's first layer), trace, chaos specs and check names, read
for the port:
- spec parity: greedy outputs with the draft attached equal plain
  greedy decode token-for-token, twice;
- parity survives preemption on a starved block pool (and a preemption
  fired);
- adapter hot-swap under traffic with zero steady-state retraces: after
  one warm pass per adapter mix, alternating adapters (and a chaos
  mid-stream device evict, `adapter:evict@op=use;call=2`) add no CUDA-
  graph captures (`stats["graph_captures"]`, the port's counterpart of
  the reference's step-executable builds); the evicted adapter reloads
  (a swap) and the stream stays bit-exact;
- parity survives failover: a 2-replica router of spec engines with
  replica 0 chaos-killed mid-decode — exactly one failover wave, zero
  replay mismatches, nothing shed, outputs equal plain greedy. The
  reference holds its wave as `stats["failovers"] == 1`, but both
  routers count a failover a stream, and two streams sit on the victim
  at this trace (the reference's own run reports 2 and fails the
  check): the wave is held here as one dead replica whose streams each
  moved exactly once;
- acceptance_rate > 0; tokens/s speculated against plain is reported,
  not held.
Chaos specs go through the port's `chaos.reconfigure` (the reference's
`FLAGS_chaos_spec`).
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
PROMPT_LEN = 8
NEW_TOKENS = 10
SPEC_K = 3
ENGINE_KW = dict(num_blocks=96, block_size=8, max_batch=8, token_budget=32)
STARVED_KW = dict(num_blocks=10, block_size=8, max_batch=8, token_budget=32)
KILL_CALL = 5


def _trace(vocab: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=PROMPT_LEN).tolist()
            for _ in range(N_REQS)]


def _run(eng, prompts, dev, adapters=None, max_new=NEW_TOKENS):
    import torch

    rids = []
    for i, p in enumerate(prompts):
        kw = {}
        if adapters is not None and adapters[i] is not None:
            kw["adapter"] = adapters[i]
        rids.append(eng.submit(p, max_new_tokens=max_new, **kw))
    t0 = time.perf_counter()
    done = {c.rid: c.output_tokens for c in eng.run()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [done.get(r) for r in rids], dt


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
    import dataclasses

    from paddle_tpu_torch.distributed.fault_tolerance import chaos
    from paddle_tpu_torch.inference.serving import (DraftModel,
                                                    PagedServingEngine,
                                                    ServingRouter,
                                                    make_adapter)

    dev, cfg, params = _tiny(device)
    # draft: half the layers of the TARGET's own weights (views of its
    # tensors) — cheap enough to matter, correlated enough that
    # acceptance is well above zero
    dcfg = dataclasses.replace(cfg, num_layers=1)
    dparams = {"embed": params["embed"],
               "final_norm": params["final_norm"],
               "lm_head": params["lm_head"],
               "blocks": {k: v[:1] for k, v in params["blocks"].items()}}
    prompts = _trace(cfg.vocab_size)

    def build(spec=False, **over):
        kw = dict(ENGINE_KW, **over)
        if spec:
            kw.update(draft=DraftModel(dcfg, dparams), spec_k=SPEC_K)
        return PagedServingEngine(cfg, params, max_len=cfg.max_seq_len,
                                  device=dev, **kw)

    # -- plain parity + informational throughput --------------------------
    base = build()
    base_out, _ = _run(base, prompts, dev)       # warm + capture
    base_out2, base_dt = _run(base, prompts, dev)
    spec = build(spec=True)
    spec_out, _ = _run(spec, prompts, dev)
    spec_out2, spec_dt = _run(spec, prompts, dev)
    acceptance = spec.spec.acceptance_rate
    spec_ticks = spec.stats["spec_ticks"]

    # -- parity under forced preemption -----------------------------------
    sb_out, _ = _run(build(**STARVED_KW), prompts, dev)
    ss = build(spec=True, **STARVED_KW)
    ss_out, _ = _run(ss, prompts, dev)
    preemptions = ss.scheduler.stats["preemptions"]

    # -- adapter hot-swap + chaos evict, zero steady-state retraces -------
    ad_a = make_adapter(cfg, "tenant-a", rank=4, alpha=8.0, seed=3)
    ad_b = make_adapter(cfg, "tenant-b", rank=4, alpha=8.0, seed=4)
    eng = build(spec=True, adapter_slots=2)
    eng.adapters.register(ad_a)
    eng.adapters.register(ad_b)
    sel_a = ["tenant-a"] * N_REQS
    sel_ab = [("tenant-a" if i % 2 else "tenant-b") for i in range(N_REQS)]
    ref_a, _ = _run(eng, prompts, dev, adapters=sel_a)   # warm: loads both
    ref_ab, _ = _run(eng, prompts, dev, adapters=sel_ab)
    captures0 = eng.stats["graph_captures"]
    hot_a, _ = _run(eng, prompts, dev, adapters=sel_a)
    hot_ab, _ = _run(eng, prompts, dev, adapters=sel_ab)
    swap_captures = eng.stats["graph_captures"] - captures0
    swaps0 = eng.adapters.stats["swaps"]
    chaos.reconfigure("adapter:evict@op=use;call=2")
    try:
        chaos_ab, _ = _run(eng, prompts, dev, adapters=sel_ab)
    finally:
        chaos.reconfigure("")
    evict_swaps = eng.adapters.stats["swaps"] - swaps0
    chaos_captures = eng.stats["graph_captures"] - captures0

    # -- failover mid-spec: replica kill, bit-exact continuation ----------
    chaos.reconfigure(f"replica:kill@victim=0;call={KILL_CALL}")
    try:
        router = ServingRouter(lambda: build(spec=True), num_replicas=2,
                               probation_s=1e9,
                               tenant_weights={"default": N_REQS})
        rids = [router.submit(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        done = {c.rid: c for c in router.run()}
    finally:
        chaos.reconfigure("")
    fo_out = [done[r].output_tokens if r in done else None for r in rids]
    # one failover wave: one replica died and each of its streams moved
    # once (the router counts a failover a stream: 2 here, in the
    # reference too, whose `== 1` its own run at this trace fails)
    per_stream = [router._reqs[r].failovers for r in rids]
    one_wave = (sum(h.state == "dead" for h in router.replicas) == 1
                and max(per_stream) == 1
                and router.stats["failovers"] == sum(per_stream))

    checks = {
        "spec_parity": spec_out == base_out and spec_out2 == base_out
        and base_out2 == base_out,
        "spec_actually_ran": spec_ticks > 0,
        "acceptance_rate_positive": acceptance > 0.0,
        "preemption_parity": ss_out == sb_out,
        "preemption_happened": preemptions >= 1,
        "hot_swap_parity": hot_a == ref_a and hot_ab == ref_ab,
        "hot_swap_zero_retrace": swap_captures == 0,
        "chaos_evict_bit_exact": chaos_ab == ref_ab,
        "chaos_evict_reloaded": evict_swaps >= 1,
        "chaos_evict_zero_retrace": chaos_captures == 0,
        "failover_parity": fo_out == base_out,
        "exactly_one_failover": one_wave,
        "zero_replay_mismatches": router.stats["mismatches"] == 0,
        "nothing_shed": router.stats["shed"] == 0,
    }
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "device": str(dev),
        "requests": N_REQS,
        "spec_k": SPEC_K,
        "acceptance_rate": acceptance,
        "spec_ticks": spec_ticks,
        "preemptions": preemptions,
        "adapter_swaps_on_evict": evict_swaps,
        "failovers": router.stats["failovers"],
        # informational only, not held
        "tokens_per_s_ratio_spec_vs_plain": round(base_dt / spec_dt, 3)
        if spec_dt else None,
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
