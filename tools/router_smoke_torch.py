"""Resilient-serving smoke of the PyTorch port: the multi-replica router
under a chaos replica kill — the twin of `tools/router_smoke.py`.
Prints ONE JSON line; exit 0 iff ok.

    python3 tools/router_smoke_torch.py                # on the card
    python3 tools/router_smoke_torch.py --device cpu   # plain versions

It imports `paddle_tpu_torch` only. The reference's tiny config, trace,
chaos spec and check names, read for the port:
- zero dropped streams: every admitted stream completes though one of
  the two replicas is chaos-killed mid-trace;
- failover parity: the merged outputs equal one replica-shaped engine's
  on the same trace, token-for-token;
- mid-stream failover happened, with replay-and-confirm and zero
  confirm mismatches; nothing shed;
- survivor zero-retrace: the surviving replica absorbs the failed-over
  streams with its one decode-tick capture (`stats["graph_captures"]`
  is 1 on the card; 0 on the CPU, where ticks run eagerly), the port's
  counterpart of the reference's one step-executable build;
- throughput: the 2-replica router stays >= 0.9x one replica serving
  its half-trace share (a time: the tests on the CPU do not hold it).
  Each side is the best of TIMED_PASSES passes, the share's and the
  router's interleaved, so both sample the same stretch of the host's
  speed; the reference times each side in a window of its own, best of
  two. On the card, pairs of passes back to back put the router at a
  median 0.957-0.966 of the share (`tools/router_ratio_torch.py`),
  while two separate windows of two passes each fell under 0.9 one run
  in four. Interleaved, one run in twenty still falls under it (ten
  passes a side did no better): in such a run the router is slower in
  every pair. A timed pass serves its trace PASS_REPEATS times back to
  back on the card, the same number for both sides, so a pass lasts
  well over 100 ms there where the reference's one serving of the
  trace (8 steps of ~0.5 ms) lasted ~4 ms, and a best-of-5 no longer
  compares the maxima of windows a few host hiccups wide; the CPU,
  where the tests do not hold the time, serves it once.
The chaos spec goes through the port's `chaos.reconfigure` (the
reference's `FLAGS_chaos_spec`). Left out: the reference's `ttft_p50_s`
and `tpot_p50_s`, which it reads from its fleet metrics; the port's
router keeps no clocks before its observability port.

All greedy (seeded determinism is what failover correctness rests on).
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

N_REQS = 12
SHARED_LEN = 16      # shared prompt prefix (2 full 8-token pages)
UNIQ_LEN = 4
NEW_TOKENS = 8
KILL_CALL = 7        # replica 0's 8th own step: its streams are decoding
TIMED_PASSES = 5     # timed passes a side, share and router interleaved
PASS_REPEATS = 32    # servings of the trace in one timed pass on the card
ENGINE_KW = dict(num_blocks=96, block_size=8, max_batch=8, token_budget=32)


def _trace(vocab: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    shared = rs.randint(1, vocab, size=SHARED_LEN).tolist()
    return [shared + rs.randint(1, vocab, size=UNIQ_LEN).tolist()
            for _ in range(N_REQS)]


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _factory(cfg, params, dev):
    from paddle_tpu_torch.inference.serving import PagedServingEngine

    def build():
        return PagedServingEngine(cfg, params, max_len=cfg.max_seq_len,
                                  device=dev, **ENGINE_KW)

    return build


def pass_repeats(dev) -> int:
    """Servings of the trace in one timed pass: PASS_REPEATS on the card,
    one on the CPU. The same for the share and the router."""
    return PASS_REPEATS if dev.type == "cuda" else 1


def _run_single(factory, prompts, dev):
    """One replica-shaped engine: the warm pass, then the full-trace pass
    for the parity reference. Returns (outputs, full tokens/s, share_pass):
    share_pass() times one half-trace pass, one replica serving the share
    the router would hand it (the single-replica throughput baseline),
    `pass_repeats(dev)` times back to back."""
    eng = factory()

    def one_pass(batch, repeats=1):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in batch]
            done = {c.rid: c.output_tokens for c in eng.run()}
        _sync(dev)
        dt = time.perf_counter() - t0
        return [done[r] for r in rids], repeats * len(batch) * NEW_TOKENS / dt

    one_pass(prompts)                             # warm + capture
    outputs, full_tps = one_pass(prompts)
    return outputs, full_tps, lambda: one_pass(prompts[:N_REQS // 2],
                                               pass_repeats(dev))[1]


def _run_router_drill(factory, prompts):
    """2-replica router with replica 0 chaos-killed mid-decode."""
    from paddle_tpu_torch.distributed.fault_tolerance import chaos
    from paddle_tpu_torch.inference.serving import ServingRouter

    chaos.reconfigure(f"replica:kill@victim=0;call={KILL_CALL}")
    try:
        router = ServingRouter(factory, num_replicas=2, probation_s=1e9,
                               tenant_weights={"default": N_REQS})
        rids = [router.submit(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        done = {c.rid: c for c in router.run()}
    finally:
        chaos.reconfigure("")
    survivor = router.replicas[1].engine
    return {
        "outputs": [done[r].output_tokens if r in done else None
                    for r in rids],
        "all_length_finish": all(done[r].finish_reason == "length"
                                 for r in rids if r in done),
        "completed": len(done),
        "failovers": router.stats["failovers"],
        "mismatches": router.stats["mismatches"],
        "shed": router.stats["shed"],
        "tokens_confirmed_on_replay": sum(router._reqs[r].confirm_target
                                          for r in rids),
        "dead_replica_state": router.replicas[0].state,
        "survivor_graph_captures": (survivor.stats["graph_captures"]
                                    if survivor is not None else None),
    }


def _router_pass(factory, prompts, dev):
    """2-replica router, no chaos, after its warm pass. Returns
    router_pass(): one timed pass, the full trace served
    `pass_repeats(dev)` times back to back -> (the outputs of every
    serving, tokens/s)."""
    from paddle_tpu_torch.inference.serving import ServingRouter

    router = ServingRouter(factory, num_replicas=2,
                           tenant_weights={"default": N_REQS})

    def one_pass(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        outs = []
        for _ in range(repeats):
            rids = [router.submit(p, max_new_tokens=NEW_TOKENS)
                    for p in prompts]
            done = {c.rid: c.output_tokens for c in router.run()}
            outs.append([done[r] for r in rids])
        _sync(dev)
        dt = time.perf_counter() - t0
        return outs, repeats * N_REQS * NEW_TOKENS / dt

    one_pass(1)                                   # warm both replicas
    return lambda: one_pass(pass_repeats(dev))


def _timed_passes(share_pass, router_pass):
    """TIMED_PASSES share passes and as many router passes, interleaved
    (the order alternating pass to pass), so both sides sample the same
    stretch of the host's speed. Returns (router outputs of every serving,
    share tokens/s of every pass, router tokens/s of every pass)."""
    outs, share, router = [], [], []
    for i in range(TIMED_PASSES):
        if i % 2:
            out, tps = router_pass()
            share.append(share_pass())
        else:
            share.append(share_pass())
            out, tps = router_pass()
        outs.extend(out)
        router.append(tps)
    return outs, share, router


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

    single_out, single_tps, share_pass = _run_single(factory, prompts, dev)
    drill = _run_router_drill(factory, prompts)
    router_outs, share_all, router_all = _timed_passes(
        share_pass, _router_pass(factory, prompts, dev))
    share_tps, router_tps = max(share_all), max(router_all)

    checks = {
        "zero_dropped_streams": (drill["completed"] == N_REQS
                                 and drill["all_length_finish"]),
        "failover_parity": drill["outputs"] == single_out,
        "failover_happened": drill["failovers"] >= 1,
        "midstream_replay_confirmed": (
            drill["tokens_confirmed_on_replay"] > 0
            and drill["mismatches"] == 0),
        "nothing_shed": drill["shed"] == 0,
        "survivor_zero_retrace": drill["survivor_graph_captures"] == (
            1 if dev.type == "cuda" else 0),
        "steady_parity": all(o == single_out for o in router_outs),
        "throughput_router_ge_0p9x_share": bool(
            router_tps >= 0.9 * share_tps),
    }
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "device": str(dev),
        "requests": N_REQS,
        "prompt_len": SHARED_LEN + UNIQ_LEN,
        "new_tokens": NEW_TOKENS,
        "pass_repeats": pass_repeats(dev),
        "failovers": drill["failovers"],
        "tokens_confirmed_on_replay": drill["tokens_confirmed_on_replay"],
        "dead_replica_state": drill["dead_replica_state"],
        "survivor_graph_captures": drill["survivor_graph_captures"],
        "router_tokens_per_s": round(router_tps, 1),
        "single_full_tokens_per_s": round(single_tps, 1),
        "single_share_tokens_per_s": round(share_tps, 1),
        "throughput_ratio_vs_share": round(router_tps / share_tps, 3)
        if share_tps else None,
        "share_pass_tokens_per_s": [round(v, 1) for v in share_all],
        "router_pass_tokens_per_s": [round(v, 1) for v in router_all],
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
