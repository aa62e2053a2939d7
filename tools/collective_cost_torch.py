"""What one collective costs the host and the card over a group of one.

    python3 tools/collective_cost_torch.py              # on the card (NCCL)
    python3 tools/collective_cost_torch.py --device cpu # gloo
    python3 tools/collective_cost_torch.py --iters 500

For each call, `iters` back to back after a warm-up: the host's time a
call (the loop on the host clock, the card synchronized after it) and
the card's (CUDA events around the loop), for torch's own
`dist.all_reduce` and `dist.all_gather_into_tensor`, the port's eager
`collective.all_reduce`, and the mesh's torch ops `mesh.psum` and
`mesh.all_gather` along dim 1 (the sequence gather of the hybrid
step's blocks, at the bench config's activations [4, 2,048, 1,536]
bf16), beside a plain in-place add on the same buffer. One JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def _time(torch, fn, iters, cuda):
    for _ in range(5):
        fn()
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    if cuda:
        end.record()
        torch.cuda.synchronize()
        return {"host_us": host / iters * 1e6,
                "card_us": start.elapsed_time(end) / iters * 1e3}
    return {"host_us": host / iters * 1e6, "card_us": None}


def measure(device=None, iters=200) -> dict:
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.device import resolve
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M

    dev = resolve(device)
    cuda = dev.type == "cuda"
    g = C.init_parallel_env(dev)
    if cuda:
        dev = torch.device("cuda", torch.cuda.current_device())
    small = torch.ones(262144, dtype=torch.float32, device=dev)   # 1 MiB
    act = torch.ones((4, 2048, 1536), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(small)
    rows = {
        "add_": lambda: small.add_(0.0),
        "dist.all_reduce": lambda: dist.all_reduce(small, group=g.pg),
        "dist.all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            out, small, group=g.pg),
        "collective.all_reduce": lambda: C.all_reduce(small, group=g),
        "mesh.psum": lambda: M.psum(small, g),
        "mesh.all_gather_dim1_bench_act": lambda: M.all_gather(act, g, 1),
    }
    res = {name: _time(torch, fn, iters, cuda) for name, fn in rows.items()}
    C.destroy_process_group()
    return {"device": str(dev), "backend": g.backend, "iters": iters,
            "torch": torch.__version__, "calls": res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo; default the card (NCCL)")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    payload = measure(args.device, args.iters)
    if payload["device"].startswith("cuda"):
        payload["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
