"""Paged-vs-dense serving smoke of the PyTorch port: the paged
continuous-batching engine against the dense slot engine on the same
request trace — the twin of `tools/serving_smoke.py`. Prints ONE JSON
line; exit 0 iff ok.

    python3 tools/serving_smoke_torch.py                # on the card
    python3 tools/serving_smoke_torch.py --device cpu   # plain versions

It imports `paddle_tpu_torch` only. The reference's tiny config, trace
and check names, read for the port:
- parity: paged greedy outputs match the dense slot engine's
  token-for-token across the whole trace;
- throughput: paged tokens/s >= dense tokens/s (a time: the tests on
  the CPU do not hold it);
- steady state: the timed passes add ZERO CUDA-graph captures
  (`stats["graph_captures"]`, the port's counterpart of the reference's
  step-executable builds);
- the prefix cache served tokens during the timed pass;
- the reference's `pallas=` / `pallas_ffn=` legs are one leg here (the
  port has no such switches: on the card every tick runs its kernels),
  so `pallas_parity`, `pallas_zero_retraces`, `fused_parity` and the
  two `*_not_slower_when_enabled` ratios have nothing to compare and are
  left out. What stays of them: `fused_ticks_ran` (decode ticks, which
  replay the captured tick on the card), `fused_tick_launch_budget`
  (launches a tick, by kernel from `ops.cuda.KERNELS`, within
  3·layers + 1; the CPU runs no kernel and passes it),
  `fused_sampled_parity` (the trace with mixed greedy and sampled rows
  gives the same streams when served again on the warm engine, and its
  greedy rows the greedy trace's tokens) and `fused_zero_retraces`.
TTFT and TPOT p50 come from the engine's own clocks (each sequence's
arrival, first and last token) over the last timed pass; the reference
reads them from its metrics, which the port does not have yet.
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

N_REQS = 24          # > dense slots, so the dense engine queues
SHARED_LEN = 56      # shared prompt prefix (7 full 8-token pages)
UNIQ_LEN = 4         # per-request unique suffix
NEW_TOKENS = 6
TIMED_REPEATS = 2    # best-of to tame host scheduling noise


def _trace(vocab: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    shared = rs.randint(1, vocab, size=SHARED_LEN).tolist()
    return [shared + rs.randint(1, vocab, size=UNIQ_LEN).tolist()
            for _ in range(N_REQS)]


def _submit_all(eng, prompts, sampled=False):
    # sampled=True mixes greedy and sampled rows in one batch (odd
    # requests sample with fixed per-request temperature/top_p/seed)
    rids = []
    for i, p in enumerate(prompts):
        kw = {"max_new_tokens": NEW_TOKENS}
        if sampled and i % 2:
            kw.update(temperature=0.7 + 0.02 * i, top_p=0.85,
                      seed=1000 + i)
        rids.append(eng.submit(p, **kw))
    return rids


def _drain(eng, rids):
    by_rid = {c.rid: c.output_tokens for c in eng.run()}
    return [by_rid[r] for r in rids]


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _run_dense(cfg, params, prompts, dev):
    from paddle_tpu_torch.inference.serving import ServingEngine

    eng = ServingEngine(cfg, params, num_slots=4, max_len=cfg.max_seq_len,
                        chunk=NEW_TOKENS, device=dev)
    _drain(eng, _submit_all(eng, prompts))            # warm (captures)
    best_tps, ttft_ms, outputs = 0.0, None, None
    for _ in range(TIMED_REPEATS):
        _sync(dev)
        t0 = time.perf_counter()
        rids = _submit_all(eng, prompts)
        eng.step()                                    # first tokens exist now
        ttft = time.perf_counter() - t0
        outputs = _drain(eng, rids)
        _sync(dev)
        wall = time.perf_counter() - t0
        best_tps = max(best_tps, N_REQS * NEW_TOKENS / wall)
        ttft_ms = ttft * 1e3 if ttft_ms is None else min(ttft_ms, ttft * 1e3)
    return outputs, best_tps, ttft_ms


def _run_paged(cfg, params, prompts, dev, sampled=False):
    from paddle_tpu_torch.inference.serving import PagedServingEngine
    from paddle_tpu_torch.ops import cuda as C

    # paged memory is why the batch can be wider than the dense engine's
    # slot count: no per-slot max_len reservation, and the shared prefix
    # is stored once — the whole trace decodes in one wave
    eng = PagedServingEngine(cfg, params, num_blocks=224, block_size=8,
                             max_batch=N_REQS, token_budget=32,
                             max_len=cfg.max_seq_len, device=dev)
    warm = _drain(eng, _submit_all(eng, prompts, sampled))  # + prefix cache
    captures0 = eng.stats["graph_captures"]
    hits0 = eng.blocks.stats["prefix_hit_tokens"]
    steps0 = eng.stats["steps"]
    for k in C.KERNELS:
        k.reset()
    best_tps, ttft_ms, outputs, seqs = 0.0, None, None, []
    for _ in range(TIMED_REPEATS):
        _sync(dev)
        t0 = time.perf_counter()
        rids = _submit_all(eng, prompts, sampled)
        ttft = None
        while ttft is None and eng.has_work():
            if any(e.token >= 0 for e in eng.step()):
                ttft = time.perf_counter() - t0
        outputs = _drain(eng, rids)
        _sync(dev)
        wall = time.perf_counter() - t0
        best_tps = max(best_tps, N_REQS * NEW_TOKENS / wall)
        if ttft is not None:
            ttft_ms = (ttft * 1e3 if ttft_ms is None
                       else min(ttft_ms, ttft * 1e3))
        seqs = [eng.scheduler.get(r) for r in rids]
    ticks = eng.stats["steps"] - steps0
    launches = {k.name: k.launches for k in C.KERNELS if k.launches}
    return {"outputs": outputs, "warm_outputs": warm, "tps": best_tps,
            "ttft_ms": ttft_ms,
            "captures_timed": eng.stats["graph_captures"] - captures0,
            "prefix_hit_tokens": eng.blocks.stats["prefix_hit_tokens"]
            - hits0, "stats": dict(eng.stats), "ticks": ticks,
            "launches": launches,
            "launches_per_tick": sum(launches.values()) / max(ticks, 1),
            "ttft_p50_s": float(np.median(
                [s.first_token_at - s.arrival for s in seqs])),
            "tpot_p50_s": float(np.median(
                [(s.last_token_at - s.first_token_at)
                 / max(len(s.generated) - 1, 1) for s in seqs]))}


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

    dense_out, dense_tps, dense_ttft_ms = _run_dense(cfg, params, prompts,
                                                     dev)
    paged = _run_paged(cfg, params, prompts, dev)
    sampled = _run_paged(cfg, params, prompts, dev, sampled=True)
    greedy_rows = all(s == p for i, (s, p) in enumerate(
        zip(sampled["outputs"], paged["outputs"])) if i % 2 == 0)
    launch_budget = 3 * cfg.num_layers + 1

    checks = {
        "parity": paged["outputs"] == dense_out,
        "throughput_paged_ge_dense": bool(paged["tps"] >= dense_tps),
        "zero_retraces_steady_state": paged["captures_timed"] == 0,
        "prefix_cache_served": paged["prefix_hit_tokens"] > 0,
        "fused_sampled_parity": (sampled["outputs"]
                                 == sampled["warm_outputs"]
                                 and greedy_rows),
        "fused_zero_retraces": (paged["captures_timed"] == 0
                                and sampled["captures_timed"] == 0),
        "fused_ticks_ran": paged["stats"]["decode_fast_steps"] > 0,
        "fused_tick_launch_budget": bool(
            dev.type == "cpu"
            or 0 < paged["launches_per_tick"] <= launch_budget),
    }
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "device": str(dev),
        "requests": N_REQS,
        "prompt_len": SHARED_LEN + UNIQ_LEN,
        "new_tokens": NEW_TOKENS,
        "paged_tokens_per_s": round(paged["tps"], 1),
        "dense_tokens_per_s": round(dense_tps, 1),
        "throughput_ratio": round(paged["tps"] / dense_tps, 3)
        if dense_tps else None,
        "paged_ttft_ms": round(paged["ttft_ms"], 2)
        if paged["ttft_ms"] is not None else None,
        "dense_ttft_ms": round(dense_ttft_ms, 2)
        if dense_ttft_ms is not None else None,
        "prefix_hit_tokens_timed": paged["prefix_hit_tokens"],
        "graph_captures_timed": paged["captures_timed"],
        "graph_captures": paged["stats"]["graph_captures"],
        "decode_fast_steps": paged["stats"]["decode_fast_steps"],
        "launches_timed": paged["launches"],
        "launches_per_tick": round(paged["launches_per_tick"], 3),
        "tick_launch_budget": launch_budget,
        "ttft_p50_s": paged["ttft_p50_s"],
        "tpot_p50_s": paged["tpot_p50_s"],
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
