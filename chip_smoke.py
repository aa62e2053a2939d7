#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (nvcc); it imports nothing of
jax and nothing of the JAX package `paddle_tpu`. Phases, in order — any
failed check raises and exits non-zero before the final line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the serving and training paths from
   `paddle_tpu_torch/ops/cuda/csrc/*.cu`, one nvcc per source, all
   started together, with ptxas's registers, shared memory and spills;
3. kernels: each kernel against its plain PyTorch version at its path's
   LLaMA-7B shapes (serving: decode and prefill rows; training: B = 2,
   T = 2,048, with a grouped-query attention case), with its error and
   tolerance, its time (CUDA events, warmed up), the plain version's
   time, its bound and, where PyTorch has one, a library yardstick the
   port never calls (SDPA for attention, the cuBLAS matmul chain and
   its autograd backward for the FFN);
4. engine: `PagedServingEngine` serves 8 requests at LLaMA-7B width in
   bf16 (random weights from a seed); every kernel's launch count must
   move by the expected amount per tick; then a few decode ticks of a
   fresh batch run under torch.profiler (device time by kernel, busy
   share);
5. training: `make_train_step`'s default path (flash attention and fused
   FFN kernels, remat, AdamW) at LLaMA-7B width cut to 8 of 32 layers,
   B = 2, T = 2,048, bf16 compute over f32 master weights, 2 warm-up and
   3 timed steps on one seeded batch: the loss must be finite and fall,
   and every kernel's launch count must equal what the code implies;
   tokens/s, step time, MFU and peak memory, then one step under
   torch.profiler;
6. agreement: a tiny float32 model served on the CPU (plain versions) and
   on the card (kernels) must agree on logits and greedy tokens; a tiny
   float32 model trained on both must agree on first-step gradients and
   on the losses of 3 AdamW steps, and remat must not change the card's
   gradients;
7. summary: one `{"kernels": [...]}` line, then the last line
   `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,      # dense tensor-core rate
            "float32": 67e12}        # float32 outside the tensor cores


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound(nbytes, ops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, iters, warmup=3):
    """Mean device time of fn over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def build_kernels(C, build):
    for k in C.KERNELS:              # always build from the checkout's sources
        k.lib_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    build.build_all(C.KERNELS)
    print(f"[build] {len(C.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for k in C.KERNELS:
        for line in k.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[build] {k.name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(torch, dev, B, KV, G, past, this, max_q, hd=128, bs=16,
               seed=0):
    g = torch.Generator().manual_seed(seed)
    pages = [-(-(p + t) // bs) for p, t in zip(past, this)]
    nb = sum(pages) + 8
    mb = -(-2048 // bs)
    q = torch.randn(B, KV, max_q * G, hd, generator=g)
    kc = torch.randn(nb, KV, bs, hd, generator=g)
    vc = torch.randn(nb, KV, bs, hd, generator=g)
    perm = torch.randperm(nb, generator=g).tolist()
    tables = torch.full((B, mb), -1, dtype=torch.int32)
    for b in range(B):
        for p in range(pages[b]):
            tables[b, p] = perm.pop()
    bf = torch.bfloat16
    args = (q.to(dev, bf), kc.to(dev, bf), vc.to(dev, bf), tables.to(dev),
            torch.tensor(past, dtype=torch.int32, device=dev),
            torch.tensor(this, dtype=torch.int32, device=dev), G,
            1.0 / math.sqrt(hd))
    # the work this run's data needs: every live token's K and V once,
    # q and out once, 4*hd operations per (live row, visible position)
    kv_bytes = sum(p + t for p, t in zip(past, this)) * KV * hd * 2 * 2
    io_bytes = 2 * q.numel() * 2 + tables.numel() * 4 + 2 * B * 4
    ops = sum((p + t + 1) * G * KV * 4 * hd
              for p, n in zip(past, this) for t in range(n))
    return args, kv_bytes + io_bytes, ops


def check_paged_attention(torch, PA, dev):
    cases = {
        # decode tick: max_q = 1, contexts 64 .. 2048, LLaMA-7B heads
        "decode": dict(B=8, KV=32, G=1, max_q=1,
                       past=[63, 300, 511, 800, 1023, 1400, 1800, 2047],
                       this=[1] * 8),
        # mixed tick: token_budget = 64 rows per sequence, prefill chunks
        # beside decode rows and an idle slot
        "mixed": dict(B=8, KV=32, G=1, max_q=64,
                      past=[0, 128, 700, 1500, 63, 2000, 40, 0],
                      this=[20, 30, 1, 1, 1, 1, 10, 0]),
        # grouped-query geometry (H = 32, KV = 8), decode
        "gqa_decode": dict(B=8, KV=8, G=4, max_q=1,
                           past=[63, 300, 511, 800, 1023, 1400, 1800, 2047],
                           this=[1] * 8),
    }
    tol = 2e-2   # bf16 outputs: both sides round once to bf16 (2^-8 rel)
    rows = []
    for name, c in cases.items():
        args, nbytes, ops = paged_case(torch, dev, c["B"], c["KV"], c["G"],
                                       c["past"], c["this"], c["max_q"])
        out = PA.paged_attention(*args)
        ref = PA.paged_attention_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        require(err <= tol, f"paged_attention[{name}] max err {err} > {tol}")
        ms = cuda_ms(torch, lambda: PA.paged_attention(*args), 50)
        plain_ms = cuda_ms(torch, lambda: PA.paged_attention_plain(*args), 5,
                           warmup=1)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        rows.append(dict(case=name, max_abs_err=err, tolerance=tol, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"[kernel] paged_attention[{name}] err={err:.3g} (tol {tol}) "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={b_ms:.4f} ms ({b_by})")
    return rows


BF16_RTOL = 2 ** -7     # one bf16 ulp of |ref|: 7 stored mantissa bits
TOL_RULE = "|got - ref| <= 2^-7 |ref| + 1e-3 rms(ref), elementwise"


def held(what, got, ref):
    """Hold a bf16 kernel output against its plain version elementwise:
    |got - ref| <= 2^-7 |ref| + 1e-3 rms(ref). Both sides sum in f32 and
    round once to bf16, so they differ by at most one bf16 ulp, 2^-7 of
    |ref|; the atol covers the f32 sums' own order differences where ref
    is near 0. Returns max_abs_err, err_over_tol (the worst error over
    its tolerance, at most 1) and tol_at_median (the tolerance at the
    median |ref|, over that median: how tight the check is)."""
    a, b = got.float(), ref.float()
    atol = 1e-3 * b.square().mean().sqrt().item()
    diff = (a - b).abs()
    worst = (diff / (BF16_RTOL * b.abs() + atol)).max().item()
    med = b.abs().median().item()
    out = {"max_abs_err": diff.max().item(), "err_over_tol": worst,
           "tol_at_median": BF16_RTOL + atol / med}
    require(worst <= 1, f"{what}: max abs err {out['max_abs_err']:.3g}, "
            f"{worst:.3g} x its tolerance ({TOL_RULE})")
    return out


def held_str(name, h):
    return (f"{name} err={h['max_abs_err']:.3g} "
            f"({h['err_over_tol']:.2f} of tol, tol {h['tol_at_median']:.4f} "
            f"of the median |ref|)")


def ffn_operands(torch, dev, seed, d, f):
    """A seeded generator and bf16 FFN weights w1, w3 [d, f], w2 [f, d]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w1, w3, w2 = ((0.02 * torch.randn(*shape, generator=g, device=dev))
                  .to(torch.bfloat16) for shape in ((d, f), (d, f), (f, d)))
    return g, w1, w3, w2


def check_fused_ffn(torch, FF, dev, d=4096, f=11008):
    """A3 at the serving path's rows (a decode tick of 8, a prefill chunk
    of 64) and the training step's (B * T = 4,096), bf16."""
    g, w1, w3, w2 = ffn_operands(torch, dev, 1, d, f)
    rows = []
    for name, R, n in (("decode_R8", 8, 20), ("prefill_R64", 64, 20),
                       ("train_R4096", 4096, 3)):
        x = torch.randn(R, d, generator=g, device=dev).to(torch.bfloat16)
        out = FF.fused_ffn(x, w1, w3, w2)
        ref = FF.fused_ffn_plain(x, w1, w3, w2)
        torch.cuda.synchronize()
        h = held(f"fused_ffn[{name}]", out, ref)
        del out, ref
        ms = cuda_ms(torch, lambda: FF.fused_ffn(x, w1, w3, w2), n, warmup=1)
        plain_ms = cuda_ms(torch, lambda: FF.fused_ffn_plain(x, w1, w3, w2),
                           3, warmup=1)
        chain_ms = cuda_ms(torch, lambda: (torch.nn.functional.silu(x @ w1)
                                           * (x @ w3)) @ w2, 10)
        nbytes = (2 * R * d + 3 * d * f) * 2
        b_ms, b_by = bound(nbytes, 6 * R * d * f, "bfloat16")
        rows.append(dict(case=name, **h, tolerance=TOL_RULE, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         torch_matmul_chain_ms=chain_ms))
        print(f"[kernel] fused_ffn[{name}] {held_str('out', h)} "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) "
              f"three-matmul chain (yardstick)={chain_ms:.4f} ms")
    return rows


def check_fused_ffn_bwd(torch, FF, dev, R=4096, d=4096, f=11008):
    """A4 at the training step's rows (B = 2, T = 2,048), bf16."""
    g, w1, w3, w2 = ffn_operands(torch, dev, 3, d, f)
    x, do = (torch.randn(R, d, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    got = FF.fused_ffn_bwd(x, w1, w3, w2, do)
    want = FF.fused_ffn_bwd_plain(x, w1, w3, w2, do)
    torch.cuda.synchronize()
    errs = {name: held(f"fused_ffn_bwd {name}", a, b)
            for name, a, b in zip(("dx", "dw1", "dw3", "dw2"), got, want)}
    again = FF.fused_ffn_bwd(x, w1, w3, w2, do)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "fused_ffn_bwd is not deterministic")
    del got, want, again
    ms = cuda_ms(torch, lambda: FF.fused_ffn_bwd(x, w1, w3, w2, do), 3,
                 warmup=1)
    plain_ms = cuda_ms(torch, lambda: FF.fused_ffn_bwd_plain(x, w1, w3, w2,
                                                             do), 3, warmup=1)
    # the library yardstick: autograd's backward of the bf16 matmul chain
    leaves = [t.detach().requires_grad_() for t in (x, w1, w3, w2)]
    xl, w1l, w3l, w2l = leaves
    chain = (torch.nn.functional.silu(xl @ w1l) * (xl @ w3l)) @ w2l
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        chain, leaves, do, retain_graph=True), 5)
    del chain, leaves
    # x, do and the weights read once; dx and the weight gradients written
    nbytes = (3 * R * d + 6 * d * f) * 2
    b_ms, b_by = bound(nbytes, 8 * 2 * R * d * f, "bfloat16")
    bwd_row = dict(case=f"train_R{R}",
                   max_abs_err=max(h["max_abs_err"] for h in errs.values()),
                   tolerance=TOL_RULE, errors=errs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms)
    print(f"[kernel] fused_ffn_bwd[train_R{R}] "
          + " ".join(held_str(k, h) for k, h in errs.items())
          + f" kernel={ms:.3f} ms plain={plain_ms:.3f} ms bound={b_ms:.3f} ms "
          f"({b_by}) autograd matmul chain backward={lib_ms:.3f} ms")
    torch.cuda.empty_cache()
    return [bwd_row]


def check_flash_attention(torch, FA, dev, B=2, T=2048, H=32, hd=128):
    """A1 and A2 at the training step's shapes, causal, bf16: LLaMA-7B's
    32 heads, and a grouped-query case with 8 kv heads."""
    F = torch.nn.functional
    fwd_rows, bwd_rows = [], []
    for name, KV in (("mha", H), ("gqa_kv8", 8)):
        g = torch.Generator(device=dev).manual_seed(4 + KV)
        bf = torch.bfloat16
        q = torch.randn(B, H, T, hd, generator=g, device=dev).to(bf)
        k, v = (torch.randn(B, KV, T, hd, generator=g, device=dev).to(bf)
                for _ in range(2))
        do = torch.randn(B, H, T, hd, generator=g, device=dev).to(bf)
        scale = hd ** -0.5
        o, lse = FA.flash_attention_fwd(q, k, v, True, scale)
        o_ref, lse_ref = FA.flash_attention_fwd_plain(q, k, v, True, scale)
        torch.cuda.synchronize()
        h = held(f"flash_attention[{name}] o", o, o_ref)
        lse_err, lse_tol = (lse - lse_ref).abs().max().item(), 1e-4
        require(lse_err <= lse_tol,
                f"flash_attention[{name}] lse err {lse_err} > {lse_tol}")
        ms = cuda_ms(torch, lambda: FA.flash_attention_fwd(q, k, v, True,
                                                           scale), 10)
        plain_ms = cuda_ms(torch, lambda: FA.flash_attention_fwd_plain(
            q, k, v, True, scale), 3, warmup=1)
        gqa = {"enable_gqa": True} if KV != H else {}
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, **gqa), 10)
        pairs = T * (T + 1) // 2 * B * H         # visible (row, key) pairs
        io = (2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4
        b_ms, b_by = bound(io, 2 * 2 * hd * pairs, "bfloat16")
        fwd_rows.append(dict(case=name, **h, tolerance=TOL_RULE,
                             lse_max_abs_err=lse_err, lse_tolerance=lse_tol,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms))
        print(f"[kernel] flash_attention[{name}] {held_str('o', h)} "
              f"lse err={lse_err:.3g} (tol {lse_tol}) "
              f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms bound={b_ms:.4f} "
              f"ms ({b_by}) sdpa (yardstick)={lib_ms:.3f} ms")

        got = FA.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, True, scale)
        torch.cuda.synchronize()
        errs = {gname: held(f"flash_attention_bwd[{name}] {gname}", a, b)
                for gname, a, b in zip(("dq", "dk", "dv"), got, want)}
        again = FA.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"flash_attention_bwd[{name}] is not deterministic")
        del got, want, again
        ms = cuda_ms(torch, lambda: FA.flash_attention_bwd(
            q, k, v, o, lse, do, True, scale), 5)
        plain_ms = cuda_ms(torch, lambda: FA.flash_attention_bwd_plain(
            q, k, v, o, lse, do, True, scale), 2, warmup=1)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, **gqa)
        lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 10)
        del out, leaves
        # q, k, v, o, do, lse read; dq, dk, dv written. The backward needs
        # five products per visible pair (q·kᵀ, do·vᵀ, dq, dk, dv); the
        # kernels do seven, recomputing q·kᵀ and do·vᵀ in both the dq and
        # the dk/dv kernel
        io = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
        b_ms, b_by = bound(io, 5 * 2 * hd * pairs, "bfloat16")
        bwd_rows.append(dict(
            case=name, max_abs_err=max(h["max_abs_err"] for h in errs.values()),
            tolerance=TOL_RULE, errors=errs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))
        print(f"[kernel] flash_attention_bwd[{name}] "
              + " ".join(held_str(k_, h) for k_, h in errs.items())
              + f" kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) sdpa backward (yardstick)="
              f"{lib_ms:.3f} ms")
        del q, k, v, do, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def prefix_mass(torch, logits, temps, top_k):
    """Each entry's exclusive prefix mass in the descending sort that the
    top-p cut walks (the plain version's arithmetic), in vocab order."""
    l = logits / torch.clamp(temps, min=1e-6)[:, None]
    if top_k:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, float("-inf"), l)
    sl, idx = torch.sort(l, dim=-1, descending=True)
    probs = torch.softmax(sl, dim=-1)
    excl = torch.cumsum(probs, dim=-1) - probs
    return torch.empty_like(excl).scatter_(1, idx, excl)


def check_fused_sample(torch, FS, dev):
    B, V = 8, 32000
    g = torch.Generator(device=dev).manual_seed(2)
    logits = 3 * torch.randn(B, V, generator=g, device=dev)
    temps = torch.tensor([1.0, 0.8, 0.8, 0.8, 1.0, 0.8, 0.7, 1.2],
                         device=dev)
    top_ps = torch.tensor([1.0, 0.9, 0.9, 0.9, 1.0, 0.9, 0.5, 0.95],
                          device=dev)
    rows = []
    for top_k in (0, 50):
        masked, amax = FS.fused_sample_prep(logits, temps, top_ps, top_k)
        ref, ref_amax = FS.fused_sample_prep_plain(logits, temps, top_ps,
                                                   top_k)
        torch.cuda.synchronize()
        require(torch.equal(amax, ref_amax), f"fused_sample top_k={top_k}: "
                "argmax differs from the plain version")
        # the -inf pattern must match, except where an entry's exclusive
        # prefix mass sits within 1e-4 of top_p: the two sides sum 32k f32
        # probabilities in different orders, so the top-p boundary may
        # move by an entry there
        differ = torch.isneginf(masked) != torch.isneginf(ref)
        mass = prefix_mass(torch, logits, temps, top_k)
        near = (mass - top_ps[:, None]).abs() <= 1e-4
        require(bool((near | ~differ).all()),
                f"fused_sample top_k={top_k}: -inf pattern differs away "
                "from the top-p boundary")
        boundary = int(differ.sum())
        boundary_rows = differ.sum(dim=1).tolist()
        fin = torch.isfinite(ref) & torch.isfinite(masked)
        err = (masked[fin] - ref[fin]).abs().max().item()
        tol = 1e-6   # the same division on both sides
        require(err <= tol, f"fused_sample top_k={top_k}: err {err}")
        ms = cuda_ms(torch, lambda: FS.fused_sample_prep(logits, temps,
                                                         top_ps, top_k), 50)
        plain_ms = cuda_ms(torch, lambda: FS.fused_sample_prep_plain(
            logits, temps, top_ps, top_k), 10)
        # bytes: logits in, masked out, argmax, temps, top_ps; operations:
        # a comparison sort needs V*log2(V) per row, plus ~8 per element
        nbytes = 2 * B * V * 4 + 3 * B * 4
        ops = B * V * (math.log2(V) + 8)
        b_ms, b_by = bound(nbytes, ops, "float32")
        rows.append(dict(case=f"top_k={top_k}", max_abs_err=err,
                         tolerance=tol, boundary_entries=boundary,
                         boundary_entries_by_row=boundary_rows, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"[kernel] fused_sample_prep[top_k={top_k}] err={err:.3g} "
              f"(argmax exact; {boundary} entries differ at the top-p "
              f"boundary, by row {boundary_rows} for top_p "
              f"{[round(p, 3) for p in top_ps.tolist()]}) kernel={ms:.4f} ms "
              f"plain={plain_ms:.4f} ms bound={b_ms:.4f} ms ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the engine at LLaMA-7B width
# ---------------------------------------------------------------------------

def serve_llama7b(torch, np, C, L, Engine, dev):
    cfg = L.CONFIGS["llama-7b"]          # full width and depth
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = L.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    eng = Engine(cfg, params, block_size=16, max_batch=8, token_budget=64,
                 max_len=2048, device=dev)
    torch.cuda.synchronize()
    print(f"[engine] llama-7b bf16, {cfg.num_layers} layers, "
          f"{cfg.num_params() / 1e9:.2f} B params, {eng.num_blocks} KV "
          f"blocks, set up in {time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(0)
    lens = rs.randint(64, 513, 8)
    torch.cuda.reset_peak_memory_stats()
    for k in C.KERNELS:          # count only the main path's launches
        k.launches = 0
    t0 = time.perf_counter()
    rids = []
    for i, n in enumerate(lens):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_p=0.9, seed=i)
        rids.append(eng.submit(rs.randint(0, cfg.vocab_size, n).tolist(),
                               max_new_tokens=32, **kw))
    ticks = 0
    while eng.has_work():
        eng.step()
        ticks += 1
        require(bool(torch.isfinite(eng.last_logits).all()),
                f"non-finite logits at tick {ticks}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in C.KERNELS}
    done = {c.rid: c for c in eng.run()}
    require(sorted(done) == sorted(rids), "not every request completed")
    require(all(len(done[r].output_tokens) == 32 for r in rids),
            "a request ended short of 32 tokens")
    require(ticks == eng.stats["steps"], "ticks and engine steps disagree")
    expect = {k.name: 0 for k in C.KERNELS}    # the training kernels: 0
    expect.update({"paged_attention": cfg.num_layers * ticks,
                   "fused_ffn": cfg.num_layers * ticks,
                   "fused_sample": ticks})
    require(launches == expect, f"launch counts {launches} != {expect}")
    seqs = [eng.scheduler.get(r) for r in rids]
    ttft = [s.first_token_at - s.arrival for s in seqs]
    tpot = [(s.last_token_at - s.first_token_at) / (len(s.generated) - 1)
            for s in seqs]
    gen_tokens = sum(len(s.generated) for s in seqs)
    out = {"layers": cfg.num_layers, "requests": len(rids),
           "prompt_tokens": int(lens.sum()), "generated_tokens": gen_tokens,
           "ticks": ticks, "decode_ticks": eng.stats["decode_fast_steps"],
           "mixed_ticks": eng.stats["mixed_steps"], "wall_s": wall,
           "tokens_per_s": gen_tokens / wall,
           "ttft_p50_s": float(np.median(ttft)),
           "tpot_p50_s": float(np.median(tpot)),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    print(f"[engine] {out['requests']} requests, {gen_tokens} tokens in "
          f"{wall:.2f} s over {ticks} ticks ({out['decode_ticks']} decode, "
          f"{out['mixed_ticks']} mixed): {out['tokens_per_s']:.1f} tok/s, "
          f"TTFT p50 {out['ttft_p50_s']:.3f} s, TPOT p50 "
          f"{out['tpot_p50_s'] * 1e3:.2f} ms, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    print(f"[engine] launches {launches} (expected {expect})")
    print("ENGINE " + json.dumps(out))
    profile_decode(torch, np, eng)
    del eng, params
    torch.cuda.empty_cache()
    return launches


def profile_decode(torch, np, eng, ticks=5):
    """Where a decode tick's time goes: a fresh batch of 8 requests is
    prefilled, then `ticks` all-decode ticks run on the host clock (ended
    by a synchronize) and `ticks` more under torch.profiler. Prints
    device time by kernel and the device's busy share of a tick."""
    from torch.profiler import ProfilerActivity, profile

    def timed_ticks():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / ticks

    rs = np.random.RandomState(2)
    for _ in range(eng.max_batch):
        eng.submit(rs.randint(0, eng.cfg.vocab_size, 256).tolist(),
                   max_new_tokens=2 * ticks + 4)
    while eng.has_work() and any(s.num_computed < len(s.tokens) - 1
                                 for s in eng.scheduler.running
                                 + list(eng.scheduler.waiting)):
        eng.step()
    eng.step()                       # every request now decodes
    tick_ms = timed_ticks()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed_ticks()
    eng.run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    out = {"ticks": ticks, "tick_ms": tick_ms,
           "tick_ms_under_profiler": profiled_ms,
           "device_ms_per_tick": busy,
           "device_busy_share": busy / tick_ms if busy else None,
           "top": [{"kernel": e.key[:80], "ms_per_tick":
                    e.self_device_time_total / 1e3 / ticks,
                    "calls_per_tick": e.count / ticks}
                   for e in sorted(kernels, key=lambda e:
                                   -e.self_device_time_total)[:10]]}
    if not busy:
        print("[profile] torch.profiler saw no device time; busy share not "
              "measured")
    print(f"[profile] decode tick {tick_ms:.2f} ms ({profiled_ms:.2f} ms "
          f"under the profiler); device busy {busy:.2f} ms per tick")
    for t in out["top"]:
        print(f"[profile]   {t['ms_per_tick']:.3f} ms/tick "
              f"x{t['calls_per_tick']:.0f} {t['kernel']}")
    print("PROFILE " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 5: the training step at LLaMA-7B width
# ---------------------------------------------------------------------------

def train_llama7b(torch, np, C, L, H, dev, layers=8, B=2, T=2048, warmup=2,
                  timed=3):
    """AdamW steps of `make_train_step`'s default path (flash attention
    and fused FFN kernels, remat, bf16 compute, f32 master weights) at
    LLaMA-7B width cut to `layers` layers, on one fixed seeded batch."""
    import dataclasses
    cfg = dataclasses.replace(L.CONFIGS["llama-7b"], num_layers=layers)
    t0 = time.perf_counter()
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = H.init_opt_state(params)
    step = H.make_train_step(cfg, device=dev, hp=H.AdamWConfig(lr=1e-4))
    rs = np.random.RandomState(0)
    seq = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, T + 1)))
    tokens, targets = seq[:, :-1].to(dev), seq[:, 1:].to(dev)
    torch.cuda.synchronize()
    print(f"[train] llama-7b width, {layers} of 32 layers, "
          f"{cfg.num_params() / 1e9:.2f} B params (f32 master, bf16 "
          f"compute), B={B} T={T}, set up in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for k in C.KERNELS:            # count only the main path's launches
        k.launches = 0
    losses, times = [], []
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))     # waits for the step
        times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in C.KERNELS}
    steps = warmup + timed
    # remat runs each block's forward twice: A1 and A3 2x per layer; the
    # serving kernels stay at 0
    expect = {k.name: 0 for k in C.KERNELS}
    expect.update({"flash_attention": 2 * layers * steps,
                   "flash_attention_bwd": layers * steps,
                   "fused_ffn": 2 * layers * steps,
                   "fused_ffn_bwd": layers * steps})
    require(launches == expect, f"train launches {launches} != {expect}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = sum(times[warmup:]) / timed
    tok_s = B * T / step_s
    out = {"layers": layers, "batch": B, "seq": T, "tokens_per_step": B * T,
           "warmup_steps": warmup, "timed_steps": timed, "step_s": step_s,
           "step_s_each": times, "tokens_per_s": tok_s,
           "flops_per_token": cfg.flops_per_token(),
           "mfu": cfg.flops_per_token() * tok_s / PEAK_OPS["bfloat16"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "launches": launches,
           "launches_per_step": {n: c // steps for n, c in launches.items()}}
    print(f"[train] {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"step {step_s:.3f} s, {tok_s:.1f} tokens/s, MFU "
          f"{out['mfu'] * 100:.2f} % of 989 TFLOP/s, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    print(f"[train] launches {launches} (expected {expect})")
    print("TRAIN " + json.dumps(out))
    profile_train_step(torch, step, params, opt, tokens, targets)
    del params, opt, step
    torch.cuda.empty_cache()
    return launches


def profile_train_step(torch, step, params, opt, tokens, targets):
    """Where a train step's time goes: one step under torch.profiler,
    device time by kernel and the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, tokens, targets)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {"step_ms_under_profiler": step_ms, "device_ms": busy,
           "device_busy_share": busy / step_ms if busy else None,
           "top": [{"kernel": e.key[:80],
                    "ms": e.self_device_time_total / 1e3, "calls": e.count}
                   for e in sorted(kernels, key=lambda e:
                                   -e.self_device_time_total)[:12]]}
    if not busy:
        print("[profile] torch.profiler saw no device time; busy share not "
              "measured")
    print(f"[profile] train step {step_ms:.1f} ms under the profiler; device "
          f"busy {busy:.1f} ms")
    for t in out["top"]:
        print(f"[profile]   {t['ms']:.2f} ms x{t['calls']} {t['kernel']}")
    print("PROFILE_TRAIN " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 6: CPU (plain versions) against the card (kernels)
# ---------------------------------------------------------------------------

def agreement(torch, np, L, Engine, dev):
    import dataclasses
    # float32 matmuls in full precision on the card, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    rs = np.random.RandomState(1)
    for prompt_len in (40, 7):
        prompt = rs.randint(0, cfg.vocab_size, prompt_len).tolist()
        runs = {}
        for where in ("cpu", dev):
            eng = Engine(cfg, params, block_size=16, max_batch=4,
                         token_budget=16, max_len=128, device=where)
            eng.submit(prompt, max_new_tokens=24)
            logits, tokens = [], []
            first = None
            while eng.has_work():
                events = eng.step()
                row = eng.last_logits[0].float().cpu()
                if first is None:
                    first = row
                for ev in events:
                    if ev.token >= 0:
                        tokens.append(ev.token)
                        logits.append(row)
            runs[str(where)] = (first, tokens, logits)
        (f_cpu, t_cpu, l_cpu), (f_gpu, t_gpu, _) = runs["cpu"], runs[str(dev)]
        scale = f_cpu.abs().max().item()
        torch.testing.assert_close(f_gpu, f_cpu, rtol=1e-4, atol=1e-4 * scale)
        # greedy tokens must agree up to the first position where the CPU's
        # top-2 logit gap is under 1e-4 (there a rounding may flip argmax)
        gaps = [float(torch.topk(r, 2).values[0] - torch.topk(r, 2).values[1])
                for r in l_cpu]
        tight = next((i for i, gp in enumerate(gaps) if gp < 1e-4), None)
        upto = len(t_cpu) if tight is None else tight
        require(t_gpu[:upto] == t_cpu[:upto],
                f"greedy tokens differ before position {upto}: "
                f"{t_gpu} vs {t_cpu}")
        print(f"[agree] prompt {prompt_len}: first-tick logits within rtol "
              f"1e-4; {len(t_cpu)} greedy tokens, equal "
              + ("throughout" if tight is None else
                 f"up to the near-tie at position {tight}")
              + f" (min top-2 gap {min(gaps):.3g})")


def train_agreement(torch, np, L, H, dev, steps=3):
    """A tiny float32 model trained on the CPU (plain versions) and on the
    card (kernels), TF32 off: first-step loss gradients, the losses of
    `steps` AdamW steps, and remat against saving every activation."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    rs = np.random.RandomState(3)
    seq = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 65)))
    tokens, targets = seq[:, :-1], seq[:, 1:]

    def fresh(where):
        leaves, rebuild = H._flatten(L.init_params(
            cfg, torch.Generator().manual_seed(1), device="cpu"))
        return rebuild([p.to(where) for p in leaves])

    runs = []
    for where, remat in (("cpu", True), (dev, True), (dev, False)):
        loss, g = H.loss_and_grads(fresh(where), tokens.to(where),
                                   targets.to(where), cfg, remat=remat)
        runs.append((float(loss), [t.cpu() for t in H._flatten(g)[0]]))
    (l_cpu, g_cpu), (l_gpu, g_gpu), (l_save, g_save) = runs
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-5, atol=0)
    # f32 on both sides, sums in other orders through 4 layers of
    # products and softmaxes: 1e-4 of each leaf's largest entry
    worst = 0.0
    for a, b in zip(g_gpu, g_cpu):
        err = (a - b).abs().max().item() / b.abs().max().item()
        worst = max(worst, err)
    require(worst <= 1e-4, f"first-step gradients differ by {worst:.3g} of "
            "a leaf's largest entry")
    require(l_save == l_gpu and all(torch.equal(a, b)
                                    for a, b in zip(g_save, g_gpu)),
            "remat=True and remat=False give different gradients on the card")
    losses = {}
    for where in ("cpu", dev):
        params = fresh(where)
        opt = H.init_opt_state(params)
        step = H.make_train_step(cfg, device=where,
                                 hp=H.AdamWConfig(lr=1e-3))
        losses[str(where)] = [float(step(params, opt, tokens, targets)[2])
                              for _ in range(steps)]
    l_cpu, l_gpu = losses["cpu"], losses[str(dev)]
    require(np.allclose(l_gpu, l_cpu, rtol=1e-4, atol=0),
            f"train losses card {l_gpu} vs cpu {l_cpu}")
    print(f"[agree-train] first-step gradients within {worst:.3g} of each "
          f"leaf's largest entry (limit 1e-4); remat gradients bit-equal "
          f"to saved activations; {steps} AdamW steps card {l_gpu} vs cpu "
          f"{l_cpu} (rtol 1e-4)")


def summary_row(k, rows, launches, by_path, root):
    """One entry of the `kernels` line; rows[0] is the main path's shape."""
    main_row = rows[0]
    lib = main_row.get("library_ms", main_row.get("torch_matmul_chain_ms"))
    return {"name": k.name, "route": "cuda",
            "source": str(k.source.relative_to(root)),
            "replaces": k.replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "kernel_ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": lib,
            "cases": rows}


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need a card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}, capability "
          f"{torch.cuda.get_device_capability(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    from paddle_tpu_torch.distributed import hybrid as H
    from paddle_tpu_torch.inference import PagedServingEngine
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import cuda as C
    from paddle_tpu_torch.ops.cuda import build
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    build_kernels(C, build)
    cases = {"paged_attention": check_paged_attention(torch, C.paged_attention,
                                                      dev),
             "fused_ffn": check_fused_ffn(torch, C.fused_ffn, dev),
             "fused_sample": check_fused_sample(torch, C.fused_sample, dev),
             "fused_ffn_bwd": check_fused_ffn_bwd(torch, C.fused_ffn, dev)}
    cases["flash_attention"], cases["flash_attention_bwd"] = \
        check_flash_attention(torch, C.flash_attention, dev)
    serving = serve_llama7b(torch, np, C, L, PagedServingEngine, dev)
    training = train_llama7b(torch, np, C, L, H, dev)
    agreement(torch, np, L, PagedServingEngine, dev)
    train_agreement(torch, np, L, H, dev)

    kernels = []
    for k in C.KERNELS:
        by_path = {p: n[k.name] for p, n in (("serving", serving),
                                              ("training", training))
                   if n[k.name]}
        # a kernel of both paths reports the serving path's count, the
        # path whose shape its first case row times
        launches = by_path.get("serving", by_path.get("training"))
        kernels.append(summary_row(k, cases[k.name], launches, by_path,
                                   build.REPO_ROOT))
    print(f"[summary] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
