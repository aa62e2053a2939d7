"""The router twin's throughput ratio, measured in pairs.

    python3 tools/router_ratio_torch.py                 # on the card
    python3 tools/router_ratio_torch.py --device cpu    # plain versions
    python3 tools/router_ratio_torch.py --pairs 40

`tools/router_smoke_torch.py` gates the 2-replica router's tokens/s at
>= 0.9x one replica serving its half-trace share, each side the best of
two passes timed in its own window. This tool asks whether the router
really falls under 0.9 or whether the two windows differ: it builds the
twin's tiny config, trace, engine and router with the twin's own
functions (`_run_single`, `_router_pass`: the same warm passes), and
then runs `--pairs` pairs back to back.
A pair is one share pass (one engine, `prompts[:N_REQS // 2]`) and one
router pass (the full trace), each serving its trace the twin's
`pass_repeats` times back to back (PASS_REPEATS on the card); the order
inside a pair alternates from pair to pair. Each pair's ratio is router tokens/s over share tokens/s.
Prints ONE JSON line: every pair's times and ratio, and the ratios'
median and 10th / 90th percentiles.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import router_smoke_torch as RS  # noqa: E402


def measure(device=None, pairs: int = 20) -> dict:
    dev, cfg, params = RS._tiny(device)
    prompts = RS._trace(cfg.vocab_size)
    factory = RS._factory(cfg, params, dev)
    _, _, share_pass = RS._run_single(factory, prompts, dev)
    timed_router = RS._router_pass(factory, prompts, dev)
    rows = []
    for i in range(pairs):
        if i % 2 == 0:
            s = share_pass()
            r = timed_router()[1]
        else:
            r = timed_router()[1]
            s = share_pass()
        rows.append({"order": "share_first" if i % 2 == 0
                     else "router_first",
                     "share_tokens_per_s": s, "router_tokens_per_s": r,
                     "ratio": r / s})
    ratios = np.array([x["ratio"] for x in rows])
    by_order = {o: float(np.median([x["ratio"] for x in rows
                                    if x["order"] == o]))
                for o in ("share_first", "router_first")}
    return {
        "device": str(dev),
        "pairs": pairs,
        "pass_repeats": RS.pass_repeats(dev),
        "median_ratio": float(np.median(ratios)),
        "p10_ratio": float(np.percentile(ratios, 10)),
        "p90_ratio": float(np.percentile(ratios, 90)),
        "share_of_pairs_ge_0p9": float((ratios >= 0.9).mean()),
        "median_ratio_by_order": by_order,
        "pair_rows": rows,
    }


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default the card")
    ap.add_argument("--pairs", type=int, default=20)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    payload = measure(args.device, args.pairs)
    payload["card"] = _card() if payload["device"].startswith("cuda") \
        else None
    payload["wall_s"] = time.perf_counter() - t0
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
