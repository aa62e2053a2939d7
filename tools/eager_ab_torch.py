"""A/B of the eager API's host-side settings on the card, in one process.

    python3 tools/eager_ab_torch.py [--root DIR] [--rounds 5]
        [--variants '[{}, {"flag": false}]']

Imports `paddle_tpu_torch` from DIR (default: this checkout), so two trees
can be timed by one script. Each round runs every variant in turn, each a
dict of `core.flags` settings applied before it runs (an empty dict is
the tree's defaults):

- dispatch: `bench.py:1114`'s loop, two 256 x 256 f32 tensors on gpu:0,
  8 warm-up `a + b` then 2,000 timed, closed by a host read; beside it
  the same loop over the bare torch tensors;
- lenet: LeNet, B = 64, Momentum (lr 0.01, 0.9), 4 seeded batches,
  2 warm-up then `--lenet-steps` timed steps, pipelined at the async
  depth as `chip_smoke.py`'s LENET phase.

Then, once per variant, SGD, Momentum and Adam each take 8 LeNet steps on
the card and on the CPU from one state dict, TF32 off; the largest
relative loss difference is printed with the optimizer's `last_mode`
where the tree has one. Prints ONE JSON line.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dispatch(torch, P, n=2000, warm=8):
    rs = np.random.RandomState(0)
    a = P.to_tensor(rs.rand(256, 256).astype(np.float32))
    b = P.to_tensor(rs.rand(256, 256).astype(np.float32))
    for _ in range(warm):
        c = a + b
    float(c.sum().numpy())
    t0 = time.perf_counter()
    for _ in range(n):
        c = a + b
    float(c.sum().numpy())
    port = (time.perf_counter() - t0) * 1e6 / n
    ta, tb = a._data, b._data
    for _ in range(warm):
        tc = ta + tb
    float(tc.sum())
    t0 = time.perf_counter()
    for _ in range(n):
        tc = ta + tb
    float(tc.sum())
    bare = (time.perf_counter() - t0) * 1e6 / n
    return {"us_per_dispatch": port, "bare_torch_us_per_dispatch": bare}


def _batches(B=64):
    rs = np.random.RandomState(0)
    return [(rs.randn(B, 1, 28, 28).astype(np.float32),
             rs.randint(0, 10, (B,))) for _ in range(4)]


def _lenet(torch, P, steps, warm=2):
    from paddle_tpu_torch.core import async_engine as AE
    P.seed(0)
    model = P.vision.models.LeNet()
    opt = P.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                               parameters=model.parameters())
    host = _batches()
    data = [(P.to_tensor(x), P.to_tensor(y)) for x, y in host]

    def one(i):
        x, y = data[i % len(data)]
        loss = P.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    for i in range(warm):
        loss = one(i)
    float(loss.numpy())
    depth = AE.depth()
    pending = collections.deque()
    t0 = time.perf_counter()
    for i in range(steps):
        pending.append(one(i))
        if len(pending) > depth:
            float(pending.popleft().numpy())
    while pending:
        float(pending.popleft().numpy())
    dt = time.perf_counter() - t0
    return {"samples_per_s": 64 * steps / dt, "batch_ms": dt * 1e3 / steps,
            "mode": getattr(opt, "last_mode", None)}


def _losses(P, opt_name, state, place, steps=8):
    P.set_device(place)
    model = P.vision.models.LeNet()
    model.set_state_dict(state)
    kw = {"momentum": 0.9} if opt_name == "Momentum" else {}
    opt = getattr(P.optimizer, opt_name)(learning_rate=0.01,
                                         parameters=model.parameters(), **kw)
    data = [(P.to_tensor(x), P.to_tensor(y)) for x, y in _batches()]
    out = []
    for i in range(steps):
        x, y = data[i % len(data)]
        loss = P.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out, getattr(opt, "last_mode", None)


def _agreement(torch, P):
    P.set_device("gpu:0")
    P.seed(0)
    state = {k: v.numpy()
             for k, v in P.vision.models.LeNet().state_dict().items()}
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for name in ("SGD", "Momentum", "Adam"):
            card, mode = _losses(P, name, state, "gpu:0")
            cpu, _ = _losses(P, name, state, "cpu")
            out[name] = {"mode": mode, "max_rel_diff": max(
                abs(a - b) / abs(b) for a, b in zip(card, cpu))}
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
        P.set_device("gpu:0")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="the tree whose paddle_tpu_torch is imported")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--lenet-steps", type=int, default=100)
    ap.add_argument("--variants", default="[{}]",
                    help="JSON list of flag dicts, alternated each round")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("eager_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import flags
    variants = json.loads(args.variants)
    P.set_device("gpu:0")
    rows = [{"flags": v, "dispatch": [], "lenet": []} for v in variants]
    for _ in range(args.rounds):
        for v, row in zip(variants, rows):
            flags.set_flags(v)
            row["dispatch"].append(_dispatch(torch, P))
            row["lenet"].append(_lenet(torch, P, args.lenet_steps))
    for v, row in zip(variants, rows):
        flags.set_flags(v)
        row["agreement"] = _agreement(torch, P)
        for key, field in (("dispatch", "us_per_dispatch"),
                           ("lenet", "samples_per_s")):
            vals = sorted(r[field] for r in row[key])
            row[key + "_median_" + field] = vals[len(vals) // 2]
    print(json.dumps({"root": os.path.abspath(args.root),
                      "device": torch.cuda.get_device_name(0),
                      "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
