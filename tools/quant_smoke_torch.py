"""Quantized-serving smoke of the PyTorch port: w8 weights + int8 paged
KV cache against the fp paged engine on the same request trace — the
twin of `tools/quant_smoke.py`. Prints ONE JSON line; exit 0 iff ok.

    python3 tools/quant_smoke_torch.py                # on the card
    python3 tools/quant_smoke_torch.py --device cpu   # plain versions

It imports `paddle_tpu_torch` only. The reference's tiny config, trace,
calibration batches, constants (`LOGIT_REL_TOL`, `CAPACITY_FLOOR`,
`AGREEMENT_FLOOR`) and check names, read for the port:
- logit parity: the quantized `LLMPredictor`'s scores within
  LOGIT_REL_TOL of the fp predictor's on the same prompt;
- token agreement: the quantized engine's greedy outputs agree with the
  fp engine's on >= AGREEMENT_FLOOR of the tokens;
- capacity: fp page bytes / int8 page bytes >= CAPACITY_FLOOR;
- preemption bit-exactness: the trace on a starved pool (preemptions >
  0) reproduces the ample pool's outputs bit-for-bit;
- steady state: the timed passes add ZERO CUDA-graph captures
  (`stats["graph_captures"]`, the port's counterpart of the reference's
  step-executable builds), and the prefix cache serves int8 pages;
- the reference's `pallas=` / `pallas_ffn=` legs are one leg here (the
  port has no such switches: on the card every tick runs its kernels,
  A5 on int8 pages, A6 and A7), so `pallas_parity`,
  `pallas_zero_retraces`, `fused_parity` and the two
  `*_not_slower_when_enabled` ratios have nothing to compare and are left
  out. What stays: `fused_zero_retraces`, `fused_ticks_ran` (decode
  ticks) and `fused_tick_launch_budget` (launches a tick, by kernel from
  `ops.cuda.KERNELS`, within 3·layers + 1; the CPU runs no kernel and
  passes it).
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

N_REQS = 16
SHARED_LEN = 40      # shared prompt prefix (5 full 8-token pages)
UNIQ_LEN = 4
NEW_TOKENS = 6
TIMED_REPEATS = 2
LOGIT_REL_TOL = 0.05
CAPACITY_FLOOR = 1.8
AGREEMENT_FLOOR = 0.9


def _trace(vocab: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    shared = rs.randint(1, vocab, size=SHARED_LEN).tolist()
    return [shared + rs.randint(1, vocab, size=UNIQ_LEN).tolist()
            for _ in range(N_REQS)]


def _drain(eng, rids):
    by_rid = {c.rid: c.output_tokens for c in eng.run()}
    return [by_rid[r] for r in rids]


def _engine(cfg, params, manifest, num_blocks, dev, **kw):
    from paddle_tpu_torch.inference.serving import PagedServingEngine

    return PagedServingEngine(cfg, params, num_blocks=num_blocks,
                              block_size=8, max_batch=N_REQS,
                              token_budget=32, max_len=cfg.max_seq_len,
                              quant_manifest=manifest, device=dev, **kw)


def _run_trace(eng, prompts):
    return _drain(eng, [eng.submit(p, max_new_tokens=NEW_TOKENS)
                        for p in prompts])


def _logit_parity(cfg, params, manifest, dev):
    from paddle_tpu_torch.inference import LLMPredictor

    rs = np.random.RandomState(3)
    toks = rs.randint(1, cfg.vocab_size, (1, 12))
    fp = LLMPredictor(cfg, params, max_len=cfg.max_seq_len, device=dev)
    q = LLMPredictor(cfg, params, max_len=cfg.max_seq_len, quant_mode="w8",
                     quant_manifest=manifest, device=dev)
    _, sc_fp = fp.generate(toks, max_new_tokens=4, return_scores=True)
    _, sc_q = q.generate(toks, max_new_tokens=4, return_scores=True)
    sc_fp, sc_q = sc_fp.cpu().numpy(), sc_q.cpu().numpy()
    return float(np.max(np.abs(sc_fp - sc_q))
                 / (np.max(np.abs(sc_fp)) + 1e-9))


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
    import torch

    from paddle_tpu_torch.inference import quant as Q
    from paddle_tpu_torch.ops import cuda as C

    dev, cfg, params = _tiny(device)
    prompts = _trace(cfg.vocab_size)
    rs = np.random.RandomState(7)
    calib = [rs.randint(1, cfg.vocab_size, (2, 16)) for _ in range(2)]
    manifest = Q.calibrate(cfg, params, calib)

    logit_rel = _logit_parity(cfg, params, manifest, dev)

    fp_eng = _engine(cfg, params, None, 160, dev)
    fp_out = _run_trace(fp_eng, prompts)

    q_eng = _engine(cfg, params, manifest, 160, dev, quant_mode="w8",
                    quant_kv=True)
    q_out = _run_trace(q_eng, prompts)        # warm + seed prefix cache
    captures_warm = q_eng.stats["graph_captures"]
    hits0 = q_eng.blocks.stats["prefix_hit_tokens"]
    steps0 = q_eng.stats["steps"]
    for k in C.KERNELS:
        k.reset()
    best_tps = 0.0
    for _ in range(TIMED_REPEATS):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_out = _run_trace(q_eng, prompts)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        best_tps = max(best_tps, N_REQS * NEW_TOKENS / wall)
    captures_timed = q_eng.stats["graph_captures"] - captures_warm
    prefix_hit = q_eng.blocks.stats["prefix_hit_tokens"] - hits0
    ticks = q_eng.stats["steps"] - steps0
    launches = {k.name: k.launches for k in C.KERNELS if k.launches}
    per_tick = sum(launches.values()) / max(ticks, 1)
    launch_budget = 3 * cfg.num_layers + 1

    # forced preemption on a starved pool must reproduce bit-for-bit
    tight = _engine(cfg, params, manifest, 14, dev, quant_mode="w8",
                    quant_kv=True)
    tight_out = _run_trace(tight, prompts)
    preemptions = tight.engine_stats["preemptions"]

    capacity_ratio = fp_eng.kv_page_bytes / q_eng.kv_page_bytes
    pairs = [(x, y) for a, b in zip(q_out, fp_out) for x, y in zip(a, b)]
    agreement = sum(x == y for x, y in pairs) / max(len(pairs), 1)
    checks = {
        "logit_parity": logit_rel < LOGIT_REL_TOL,
        "token_agreement": bool(agreement >= AGREEMENT_FLOOR),
        "kv_capacity_ratio": bool(capacity_ratio >= CAPACITY_FLOOR),
        "preemption_bit_exact": (preemptions > 0
                                 and tight_out == q_out),
        "zero_retraces_steady_state": captures_timed == 0,
        "prefix_cache_served": prefix_hit > 0,
        "fused_zero_retraces": captures_timed == 0,
        "fused_ticks_ran": q_eng.stats["decode_fast_steps"] > 0,
        "fused_tick_launch_budget": bool(
            dev.type == "cpu" or 0 < per_tick <= launch_budget),
    }
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "device": str(dev),
        "requests": N_REQS,
        "prompt_len": SHARED_LEN + UNIQ_LEN,
        "new_tokens": NEW_TOKENS,
        "logit_rel_err_w8": round(logit_rel, 5),
        "token_agreement_vs_fp": round(agreement, 4),
        "kv_capacity_ratio": round(capacity_ratio, 3),
        "fp_page_bytes": fp_eng.kv_page_bytes,
        "quant_page_bytes": q_eng.kv_page_bytes,
        "preemptions_starved": preemptions,
        "quant_tokens_per_s": round(best_tps, 1),
        "prefix_hit_tokens_timed": prefix_hit,
        "graph_captures_timed": captures_timed,
        "graph_captures": q_eng.stats["graph_captures"],
        "decode_fast_steps": q_eng.stats["decode_fast_steps"],
        "launches_timed": launches,
        "launches_per_tick": round(per_tick, 3),
        "tick_launch_budget": launch_budget,
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
