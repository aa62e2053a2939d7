#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (nvcc); it imports nothing of
jax and nothing of the JAX package `paddle_tpu`. Phases, in order — any
failed check raises and exits non-zero before the final line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the serving and training paths from
   `paddle_tpu_torch/ops/cuda/csrc/*.cu`, one nvcc per source, all
   started together, with ptxas's registers, shared memory and spills,
   and the dynamic shared memory of the tensor-core flash and fused FFN
   kernels;
3. kernels: each kernel against its plain PyTorch version at its path's
   LLaMA-7B shapes (serving: decode and prefill rows; training: B = 2,
   T = 2,048, with a grouped-query attention case), with its error and
   tolerance, its time (CUDA events, warmed up), the plain version's
   time, its bound and, where PyTorch has one, a library yardstick the
   port never calls (SDPA for attention, the cuBLAS matmul chain and
   its autograd backward for the FFN, the dequantize-to-bf16 chain for
   the int8-weight FFN, `act(torch.addmm(...))` for the GEMM epilogue,
   `F.silu(u) * v` for the GLU); the fused-op path's kernels too: the
   GEMM epilogue (A8) at LLaMA-7B's projection shapes, the GLU (A9) on
   strided halves, and flash attention's segment-id mode over a packed
   batch of lengths [700, 1100, 1300, 996]; for A1/A2 also the tile
   pairs the kernels' blocks walk, counted on the card and held equal
   to `tile_walk`'s count (segment mode skips the tiles whose ids do not
   overlap), beside the causal triangle's, the TFLOP/s over the products
   they issue (per walked pair, as the built kernels state it), and
   whether P and dS enter them as bf16 hi/lo pairs; for A3 and A4 a
   bit-identical rerun and the TFLOP/s over the product units the built
   library says a call issues, beside the matmul chain's rate;
4. engine: `PagedServingEngine` serves 8 requests at LLaMA-7B width in
   bf16 (random weights from a seed); every kernel's launch count must
   move by the expected amount per tick; then a few decode ticks of a
   fresh batch run under torch.profiler (device time by kernel, busy
   share). Then the same traffic on the quantized engine: w8 weights and
   int8 KV pages, with a manifest calibrated on the card over two seeded
   batches of 256 tokens; int8-weight FFN (A6) and int8-page attention
   (A5 int8) each 32 launches a tick, the fp A3 and A5 none;
5. training: `make_train_step`'s default path (flash attention and fused
   FFN kernels, remat, AdamW) at LLaMA-7B width cut to 8 of 32 layers,
   B = 2, T = 2,048, bf16 compute over f32 master weights, 2 warm-up and
   3 timed steps on one seeded batch: the loss must be finite and fall,
   and every kernel's launch count must equal what the code implies;
   tokens/s, step time, MFU and peak memory, then one step under
   torch.profiler;
6. varlen layer stack: LLaMA-7B width in PaddleNLP's fused form (8 of 32
   layers, bf16, seeded weights) over one packed batch of 4,096 tokens,
   every op through `paddle_tpu_torch._C_ops` and
   `incubate.nn.functional`; one forward and backward with the launch
   counts the code implies (A8 4, A9 1, A1 1 and A2 1 a layer), a finite
   output, one layer's FFN against `llama.ffn` (A3) and its attention
   against `flash_attention` on each sequence alone; forward and step
   time, tokens/s, peak memory, one step under torch.profiler;
7. agreement: a tiny float32 model served on the CPU (plain versions) and
   on the card (kernels) must agree on logits and greedy tokens, in bf16
   pages and in the quantized mode (where int8 page entries may differ by
   one step, and the count of those is printed); a tiny
   float32 model trained on both must agree on first-step gradients and
   on the losses of 3 AdamW steps, and remat must not change the card's
   gradients; a tiny float32 varlen stack on both must agree on its
   output and its input and weight gradients;
8. summary: one `{"kernels": [...]}` line, then the last line
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
            if any(w in line for w in ("Compiling entry", "Used", "spill",
                                       "wgmma")):
                print(f"[build] {k.name}: {line.strip()}")
    # the tensor-core kernels keep their tiles in dynamic shared memory,
    # which ptxas does not report
    FF = C.fused_ffn
    for nc in (1, 2):
        gate_up, down = (FF.KERNEL.fn("fused_ffn_fwd_smem")(k, nc)
                         for k in (0, 1))
        act, dx = (FF.KERNEL_BWD.fn("fused_ffn_bwd_smem")(k, nc)
                   for k in (0, 1))
        print(f"[build] fused FFN bf16, {nc} consumer warpgroup(s) "
              f"({64 * nc}-row tiles): dynamic shared memory a block: A3 "
              f"gate/up {gate_up:,} B, down {down:,} B; A4 act {act:,} B, "
              f"dx {dx:,} B")
    print(f"[build] fused FFN bf16: A4 dw (128 x 128 tiles) "
          f"{FF.KERNEL_BWD.fn('fused_ffn_bwd_smem')(2, 2):,} B a block")
    FA = C.flash_attention
    for hd in (64, 128):
        fwd = FA.KERNEL_FWD.fn("flash_attention_fwd_smem")(hd)
        dq, dkv = (FA.KERNEL_BWD.fn("flash_attention_bwd_smem")(hd, w)
                   for w in (0, 1))
        print(f"[build] flash attention bf16, head_dim padded to {hd}: "
              f"dynamic shared memory a block: forward {fwd:,} B, dq "
              f"{dq:,} B, dk/dv {dkv:,} B")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(torch, dev, B, KV, G, past, this, max_q, hd=128, bs=16,
               seed=0, int8=False):
    """Seeded bf16 q rows over a paged pool, bf16 pages or (int8=True)
    int8 pages with per-page dequant scales. Returns (args, kwargs,
    bytes, operations) of one launch."""
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
    kw = {}
    if int8:
        kc, vc = ((40 * t).round().clamp(-127, 127).to(dev, torch.int8)
                  for t in (kc, vc))
        kw = {name: torch.empty(nb, KV).uniform_(0.005, 0.05, generator=g)
              .to(dev) for name in ("k_dequant", "v_dequant")}
    else:
        kc, vc = kc.to(dev, bf), vc.to(dev, bf)
    args = (q.to(dev, bf), kc, vc, tables.to(dev),
            torch.tensor(past, dtype=torch.int32, device=dev),
            torch.tensor(this, dtype=torch.int32, device=dev), G,
            1.0 / math.sqrt(hd))
    # the work this run's data needs: every live token's K and V once
    # (and each live page's two scales), q and out once, 4*hd operations
    # per (live row, visible position)
    page_item = 1 if int8 else 2
    kv_bytes = sum(p + t for p, t in zip(past, this)) * KV * hd * 2 * page_item
    if int8:
        kv_bytes += sum(pages) * KV * 2 * 4
    io_bytes = 2 * q.numel() * 2 + tables.numel() * 4 + 2 * B * 4
    ops = sum((p + t + 1) * G * KV * 4 * hd
              for p, n in zip(past, this) for t in range(n))
    return args, kw, kv_bytes + io_bytes, ops


PAGED_CASES = {
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


def check_paged_attention(torch, PA, dev):
    tol = 2e-2   # bf16 outputs: both sides round once to bf16 (2^-8 rel)
    rows = []
    for name, c in PAGED_CASES.items():
        args, _, nbytes, ops = paged_case(torch, dev, c["B"], c["KV"],
                                          c["G"], c["past"], c["this"],
                                          c["max_q"])
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


def units_tflops(units, ms):
    """TFLOP/s over `units` 64 x 64 x 64 products (2 * 64^3 flops each)."""
    return units * 2 * 64 ** 3 / ms * 1e-9


def check_fused_ffn(torch, FF, dev, d=4096, f=11008):
    """A3 at the serving path's rows (a decode tick of 8, a prefill chunk
    of 64) and the training step's (B * T = 4,096), bf16: held against the
    plain version, rerun bit for bit, timed beside the matmul chain."""
    g, w1, w3, w2 = ffn_operands(torch, dev, 1, d, f)
    units_of = FF.KERNEL.fn("fused_ffn_fwd_units")
    rows = []
    for name, R, n in (("decode_R8", 8, 20), ("prefill_R64", 64, 20),
                       ("train_R4096", 4096, 10)):
        x = torch.randn(R, d, generator=g, device=dev).to(torch.bfloat16)
        out = FF.fused_ffn(x, w1, w3, w2)
        ref = FF.fused_ffn_plain(x, w1, w3, w2)
        torch.cuda.synchronize()
        h = held(f"fused_ffn[{name}]", out, ref)
        require(torch.equal(FF.fused_ffn(x, w1, w3, w2), out),
                f"fused_ffn[{name}] is not deterministic")
        del out, ref
        ms = cuda_ms(torch, lambda: FF.fused_ffn(x, w1, w3, w2), n, warmup=1)
        plain_ms = cuda_ms(torch, lambda: FF.fused_ffn_plain(x, w1, w3, w2),
                           3, warmup=1)
        chain_ms = cuda_ms(torch, lambda: (torch.nn.functional.silu(x @ w1)
                                           * (x @ w3)) @ w2, 10)
        nbytes = (2 * R * d + 3 * d * f) * 2
        flops = 6 * R * d * f
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        tflops = units_tflops(units_of(R, d, f), ms)
        rows.append(dict(case=name, **h, tolerance=TOL_RULE, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         torch_matmul_chain_ms=chain_ms, tflops=tflops,
                         chain_tflops=flops / chain_ms * 1e-9,
                         rerun_identical=True))
        print(f"[kernel] fused_ffn[{name}] {held_str('out', h)} rerun "
              f"bit-identical; kernel={ms:.4f} ms ({tflops:.1f} TFLOP/s over "
              f"its product units) plain={plain_ms:.4f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) three-matmul chain "
              f"(yardstick)={chain_ms:.4f} ms "
              f"({flops / chain_ms * 1e-9:.1f} TFLOP/s)")
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
    ms = cuda_ms(torch, lambda: FF.fused_ffn_bwd(x, w1, w3, w2, do), 5,
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
    flops = 8 * 2 * R * d * f
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    tflops = units_tflops(FF.KERNEL_BWD.fn("fused_ffn_bwd_units")(R, d, f), ms)
    bwd_row = dict(case=f"train_R{R}",
                   max_abs_err=max(h["max_abs_err"] for h in errs.values()),
                   tolerance=TOL_RULE, errors=errs, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   tflops=tflops, chain_tflops=flops / lib_ms * 1e-9,
                   rerun_identical=True)
    print(f"[kernel] fused_ffn_bwd[train_R{R}] "
          + " ".join(held_str(k, h) for k, h in errs.items())
          + f" rerun bit-identical; kernel={ms:.3f} ms ({tflops:.1f} TFLOP/s "
          f"over its product units) plain={plain_ms:.3f} ms bound="
          f"{b_ms:.3f} ms ({b_by}) autograd matmul chain backward="
          f"{lib_ms:.3f} ms ({flops / lib_ms * 1e-9:.1f} TFLOP/s)")
    torch.cuda.empty_cache()
    return [bwd_row]


VARLEN_LENS = (700, 1100, 1300, 996)     # one packed batch, 4,096 tokens


def counted_walk(name, cnt, expect):
    """The tile pairs that a kernel's blocks recorded in `cnt`, one slot a
    block, held equal to `expect` (tile_walk's count); every block must
    have written its slot."""
    require(int(cnt.min()) >= 0, f"{name}: a block recorded no walk")
    n = int(cnt.sum())
    require(n == expect, f"{name}: its blocks walked {n} tile pairs, "
            f"tile_walk gives {expect}")
    return n


def check_flash_attention(torch, FA, dev, B=2, T=2048, H=32, hd=128,
                          lens=None):
    """A1 and A2, causal, bf16: LLaMA-7B's 32 heads and a grouped-query
    case with 8 kv heads. Without `lens`, at the training step's shapes
    (B sequences of T tokens; the yardstick is SDPA); with `lens`, in
    segment-id mode over one packed batch of those lengths (B = 1; the
    yardstick is SDPA over each sequence in turn, summed)."""
    F = torch.nn.functional
    spans, segs, tag, seg = [(0, T)], (), "", None
    if lens is not None:
        B, T, tag = 1, sum(lens), "seg_"
        ends = [sum(lens[:i + 1]) for i in range(len(lens))]
        spans = list(zip([0] + ends[:-1], ends))
        seg = torch.repeat_interleave(torch.arange(len(lens)),
                                      torch.tensor(lens))
        segs = (seg[None].to(dev, torch.int32),) * 2
    # visible (row, key) pairs, all heads
    pairs = B * H * sum((b - a) * (b - a + 1) // 2 for a, b in spans)
    # the tile pairs a head that `tile_walk` says the kernels walk
    # (segment mode skips the tiles whose ids do not overlap) and the
    # causal triangle's; every case reads the pairs the kernels' blocks
    # walked off the card and holds them to this count
    tile = FA.TILE
    model, triangle = FA.tile_walk(T, causal=True, q_seg=seg, kv_seg=seg)
    model = len(model)
    # 64 x 64 x hd products a bf16 block issues per walked tile pair, as
    # the built kernels state them: forward 3, dq 4, dk/dv 6 when P and dS
    # enter as bf16 hi/lo pairs (2, 3 and 4 with one bf16 each)
    per_fwd = FA.KERNEL_FWD.fn("flash_attention_fwd_products")()
    per_dq, per_dkv = (FA.KERNEL_BWD.fn("flash_attention_bwd_products")(w)
                       for w in (0, 1))
    hi_lo = (per_fwd, per_dq, per_dkv) == (3, 4, 6)
    unit = 2 * tile * tile * hd          # flops of one product a tile pair
    print(f"[kernel] flash_attention{'[' + tag[:-1] + ']' if tag else ''}: "
          f"{pairs // (B * H):,} visible (row, key) pairs a head; tile_walk "
          f"gives {model:,} of the causal triangle's {triangle:,} {tile} x "
          f"{tile} tile pairs ({model * tile * tile * B * H / pairs:.2f}x "
          f"the visible pairs); products a walked pair: forward {per_fwd}, "
          f"dq {per_dq}, dk/dv {per_dkv} (P and dS as bf16 hi/lo pairs: "
          f"{hi_lo})")
    fwd_rows, bwd_rows = [], []
    for name, KV in ((tag + "mha", H), (tag + "gqa_kv8", 8)):
        g = torch.Generator(device=dev).manual_seed(
            4 + KV + (36 if lens else 0))
        bf = torch.bfloat16
        q = torch.randn(B, H, T, hd, generator=g, device=dev).to(bf)
        k, v = (torch.randn(B, KV, T, hd, generator=g, device=dev).to(bf)
                for _ in range(2))
        do = torch.randn(B, H, T, hd, generator=g, device=dev).to(bf)
        scale = hd ** -0.5
        args = (q, k, v, True, scale, *segs)
        o, lse = FA.flash_attention_fwd(*args)
        o_ref, lse_ref = FA.flash_attention_fwd_plain(*args)
        torch.cuda.synchronize()
        h = held(f"flash_attention[{name}] o", o, o_ref)
        lse_err, lse_tol = (lse - lse_ref).abs().max().item(), 1e-4
        require(lse_err <= lse_tol,
                f"flash_attention[{name}] lse err {lse_err} > {lse_tol}")
        del o_ref, lse_ref
        fwd_slots, bwd_slots = FA.walk_slots(B, H, KV, T)
        cnt = torch.full((fwd_slots,), -1, dtype=torch.int32, device=dev)
        FA.flash_attention_fwd(*args, walked=cnt)
        walked = counted_walk(f"flash_attention[{name}]", cnt, B * H * model)
        fwd_flop = per_fwd * unit * walked
        ms = cuda_ms(torch, lambda: FA.flash_attention_fwd(*args), 10)
        plain_ms = cuda_ms(torch, lambda: FA.flash_attention_fwd_plain(
            *args), 3 if lens is None else 2, warmup=1)
        gqa = {"enable_gqa": True} if KV != H else {}
        lib_ms = cuda_ms(torch, lambda: [F.scaled_dot_product_attention(
            q[:, :, a:b], k[:, :, a:b], v[:, :, a:b], is_causal=True, **gqa)
            for a, b in spans], 10)
        # q, k, v and o moved once, lse (and the segment ids) once
        io = (2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4 \
            + sum(t.numel() * 4 for t in segs)
        b_ms, b_by = bound(io, 2 * 2 * hd * pairs, "bfloat16")
        yard = "sdpa" if lens is None else "sdpa per sequence, summed"
        # tiles_walked: counted by the kernels' blocks, a batch row and
        # head (equal to tile_walk's count, or the run fails above)
        walk = dict(tiles_walked=walked // (B * H), tiles_triangle=triangle,
                    tile=f"{tile}x{tile}", hi_lo=hi_lo)
        fwd_rows.append(dict(case=name, **h, tolerance=TOL_RULE,
                             lse_max_abs_err=lse_err, lse_tolerance=lse_tol,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms, **walk,
                             tflops=fwd_flop / ms * 1e-9))
        walk_str = (f"its blocks walked {walked // (B * H)}/{triangle} tile "
                    f"pairs a head, hi/lo {hi_lo}")
        print(f"[kernel] flash_attention[{name}] {held_str('o', h)} "
              f"lse err={lse_err:.3g} (tol {lse_tol}) "
              f"kernel={ms:.3f} ms ({fwd_flop / ms * 1e-9:.1f} TFLOP/s over "
              f"its products; {walk_str}) plain={plain_ms:.3f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) {yard} (yardstick)="
              f"{lib_ms:.3f} ms")

        bargs = (q, k, v, o, lse, do, True, scale, *segs)
        got = FA.flash_attention_bwd(*bargs)
        want = FA.flash_attention_bwd_plain(*bargs)
        torch.cuda.synchronize()
        errs = {gname: held(f"flash_attention_bwd[{name}] {gname}", a, b)
                for gname, a, b in zip(("dq", "dk", "dv"), got, want)}
        again = FA.flash_attention_bwd(*bargs)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"flash_attention_bwd[{name}] is not deterministic")
        del got, want, again
        cnt = torch.full((bwd_slots,), -1, dtype=torch.int32, device=dev)
        FA.flash_attention_bwd(*bargs, walked=cnt)
        walked = counted_walk(f"flash_attention_bwd[{name}] dq",
                              cnt[:fwd_slots], B * H * model)
        counted_walk(f"flash_attention_bwd[{name}] dk/dv", cnt[fwd_slots:],
                     B * H * model)
        bwd_flop = (per_dq + per_dkv) * unit * walked
        ms = cuda_ms(torch, lambda: FA.flash_attention_bwd(*bargs), 5)
        plain_ms = cuda_ms(torch, lambda: FA.flash_attention_bwd_plain(
            *bargs), 2, warmup=1)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        outs = [F.scaled_dot_product_attention(
            *(t[:, :, a:b] for t in leaves), is_causal=True, **gqa)
            for a, b in spans]
        dos = [do[:, :, a:b] for a, b in spans]
        lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            outs, leaves, dos, retain_graph=True), 10)
        del outs, leaves
        # q, k, v, o, do, lse (and the ids) read; dq, dk, dv written. The
        # backward needs five products per visible pair (q·kᵀ, do·vᵀ, dq,
        # dk, dv); the kernels do seven, recomputing q·kᵀ and do·vᵀ in
        # both the dq and the dk/dv kernel
        io = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4 \
            + sum(t.numel() * 4 for t in segs)
        b_ms, b_by = bound(io, 5 * 2 * hd * pairs, "bfloat16")
        bwd_rows.append(dict(
            case=name, max_abs_err=max(h["max_abs_err"] for h in errs.values()),
            tolerance=TOL_RULE, errors=errs, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, **walk,
            tflops=bwd_flop / ms * 1e-9))
        print(f"[kernel] flash_attention_bwd[{name}] "
              + " ".join(held_str(k_, h) for k_, h in errs.items())
              + f" kernel={ms:.3f} ms ({bwd_flop / ms * 1e-9:.1f} TFLOP/s "
              f"over its products; {walk_str}) plain={plain_ms:.3f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) {yard} backward (yardstick)="
              f"{lib_ms:.3f} ms")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def check_paged_attention_int8(torch, PA, dev):
    """A5's int8-page mode in the decode, mixed and GQA cases of the fp
    check, bf16 q, int8 pages, per-page f32 scales."""
    rows = []
    for name, c in PAGED_CASES.items():
        args, kw, nbytes, ops = paged_case(torch, dev, c["B"], c["KV"],
                                           c["G"], c["past"], c["this"],
                                           c["max_q"], seed=5, int8=True)
        out = PA.paged_attention(*args, **kw)
        ref = PA.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        # live rows held elementwise; pad rows and idle slots must be 0
        t = torch.arange(out.shape[2], device=dev) // c["G"]
        live = (t[None, :] < args[5][:, None])[:, None, :, None].expand_as(
            out)
        require(not bool(out[~live].any()),
                f"paged_attention_int8[{name}]: a dead row is not 0")
        h = held(f"paged_attention_int8[{name}]", out[live], ref[live])
        ms = cuda_ms(torch, lambda: PA.paged_attention(*args, **kw), 50)
        plain_ms = cuda_ms(torch, lambda: PA.paged_attention_plain(
            *args, **kw), 5, warmup=1)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        rows.append(dict(case=name, **h, tolerance=TOL_RULE, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None))
        print(f"[kernel] paged_attention_int8[{name}] {held_str('out', h)} "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={b_ms:.4f} ms ({b_by})")
    return rows


def check_fused_ffn_w8(torch, FF, dev, d=4096, f=11008):
    """A6 at the serving path's rows (a decode tick of 8, a prefill chunk
    of 64), bf16 x, int8 weights quantized from seeded bf16 ones. The
    yardstick is the chain the port avoids: dequantize the three weights
    to bf16, then the cuBLAS bf16 matmul chain."""
    from paddle_tpu_torch.inference.quant import quantize_weight
    g, *ws = ffn_operands(torch, dev, 6, d, f)
    leaves = [t for w in ws for t in quantize_weight(w, in_axis=0)]
    del ws
    w1q, s1, w3q, s3, w2q, s2 = leaves
    bf = torch.bfloat16

    def dequant_chain(x):
        w1, w3, w2 = ((q.to(bf) * (s / 127).to(bf))
                      for q, s in ((w1q, s1), (w3q, s3), (w2q, s2)))
        return (torch.nn.functional.silu(x @ w1) * (x @ w3)) @ w2

    rows = []
    for name, R in (("decode_R8", 8), ("prefill_R64", 64)):
        x = torch.randn(R, d, generator=g, device=dev).to(bf)
        out = FF.fused_ffn_w8(x, *leaves)
        ref = FF.fused_ffn_w8_plain(x, *leaves)
        torch.cuda.synchronize()
        h = held(f"fused_ffn_w8[{name}]", out, ref)
        require(torch.equal(FF.fused_ffn_w8(x, *leaves), out),
                "fused_ffn_w8 is not deterministic")
        del out, ref
        ms = cuda_ms(torch, lambda: FF.fused_ffn_w8(x, *leaves), 20)
        plain_ms = cuda_ms(torch, lambda: FF.fused_ffn_w8_plain(x, *leaves),
                           3, warmup=1)
        lib_ms = cuda_ms(torch, lambda: dequant_chain(x), 10)
        # int8 weights, their f32 scales, x in and out once
        nbytes = 3 * d * f + (2 * f + d) * 4 + 2 * R * d * 2
        b_ms, b_by = bound(nbytes, 6 * R * d * f, "bfloat16")
        rows.append(dict(case=name, **h, tolerance=TOL_RULE, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
        print(f"[kernel] fused_ffn_w8[{name}] {held_str('out', h)} "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) dequantize + bf16 chain "
              f"(yardstick)={lib_ms:.4f} ms")
    del leaves
    torch.cuda.empty_cache()
    return rows


EPILOGUE_CASES = (
    # (case, m, k, n, activation, bias): the varlen stack's projections
    # at LLaMA-7B width over 4,096 tokens, a decode tick's 8 rows, an
    # activation with a bias, and a shape off every tile
    ("qkv", 4096, 4096, 12288, "none", False),
    ("gate_up", 4096, 4096, 22016, "none", False),
    ("down", 4096, 11008, 4096, "none", False),
    ("decode_R8", 8, 4096, 22016, "none", False),
    ("bias_gelu", 4096, 4096, 11008, "gelu", True),
    ("odd_silu", 100, 72, 40, "silu", True),
)


def check_gemm_epilogue(torch, FF, dev):
    """A8 at the varlen stack's shapes, bf16, against its plain version;
    the yardstick is the cuBLAS chain act(torch.addmm(bias, x, y))."""
    F = torch.nn.functional
    lib_act = {"none": lambda t: t, "silu": F.silu,
               "gelu": lambda t: F.gelu(t, approximate="tanh")}
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    rows = []
    for name, m, k, n, act, has_bias in EPILOGUE_CASES:
        x = torch.randn(m, k, generator=g, device=dev).to(bf)
        y = (torch.randn(k, n, generator=g, device=dev) / math.sqrt(k)).to(bf)
        b = (torch.randn(n, generator=g, device=dev).to(bf) if has_bias
             else None)
        out = FF.fused_gemm_epilogue_fwd(x, y, b, act)
        ref = FF.fused_gemm_epilogue_plain(x, y, b, act)
        torch.cuda.synchronize()
        h = held(f"fused_gemm_epilogue[{name}]", out, ref)
        del out, ref
        n_it = 5 if m * k * n > 1e10 else 20
        ms = cuda_ms(torch, lambda: FF.fused_gemm_epilogue_fwd(x, y, b, act),
                     n_it)
        plain_ms = cuda_ms(torch, lambda: FF.fused_gemm_epilogue_plain(
            x, y, b, act), 3, warmup=1)
        if b is None:
            lib_ms = cuda_ms(torch, lambda: lib_act[act](x @ y), n_it)
        else:
            lib_ms = cuda_ms(torch, lambda: lib_act[act](
                torch.addmm(b, x, y)), n_it)
        # x, y (and the bias) read once, out written once
        nbytes = (m * k + k * n + m * n + (n if has_bias else 0)) * 2
        b_ms, b_by = bound(nbytes, 2 * m * k * n, "bfloat16")
        rows.append(dict(case=name, **h, tolerance=TOL_RULE, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms,
                         tflops=2 * m * k * n / ms / 1e9))
        print(f"[kernel] fused_gemm_epilogue[{name} {m}x{k}@{k}x{n} {act}"
              f"{' +bias' if has_bias else ''}] {held_str('out', h)} "
              f"kernel={ms:.4f} ms ({2 * m * k * n / ms / 1e9:.1f} TFLOP/s) "
              f"plain={plain_ms:.4f} ms bound={b_ms:.4f} ms ({b_by}) "
              f"cublas chain (yardstick)={lib_ms:.4f} ms")
    torch.cuda.empty_cache()
    return rows


def check_fused_glu(torch, FF, dev, f=11008):
    """A9 on the strided halves of one [rows, 2f] bf16 tensor, at the
    varlen stack's 4,096 rows (silu, gelu) and a decode tick's 8; the
    yardstick is the chain act(u) * v."""
    F = torch.nn.functional
    lib_act = {"silu": F.silu,
               "gelu": lambda t: F.gelu(t, approximate="tanh")}
    g = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for name, R, act in (("R4096_silu", 4096, "silu"),
                         ("R4096_gelu", 4096, "gelu"), ("R8_silu", 8, "silu")):
        x = torch.randn(R, 2 * f, generator=g, device=dev).to(torch.bfloat16)
        u, v = x[:, :f], x[:, f:]
        out = FF.fused_glu_fwd(u, v, act)
        ref = FF.fused_glu_plain(u, v, act)
        torch.cuda.synchronize()
        h = held(f"fused_glu[{name}]", out, ref)
        ms = cuda_ms(torch, lambda: FF.fused_glu_fwd(u, v, act), 50)
        plain_ms = cuda_ms(torch, lambda: FF.fused_glu_plain(u, v, act), 10)
        lib_ms = cuda_ms(torch, lambda: lib_act[act](u) * v, 50)
        # u and v read once, out written once; ~10 f32 operations an
        # element (the activation's exp or tanh, the products)
        b_ms, b_by = bound(3 * R * f * 2, 10 * R * f, "float32")
        rows.append(dict(case=name, **h, tolerance=TOL_RULE, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
        print(f"[kernel] fused_glu[{name}] {held_str('out', h)} "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) act(u) * v chain "
              f"(yardstick)={lib_ms:.4f} ms")
    return rows


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
    """The bf16 engine: A5 (fp pages), A3 and A7 on every tick."""
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
    del params
    encoded = C.fused_ffn.KERNEL.fn("fused_ffn_maps_encoded")
    enc0 = encoded()
    launches = drive_engine(torch, np, C, eng, "ENGINE", {
        "paged_attention": cfg.num_layers, "fused_ffn": cfg.num_layers,
        "fused_sample": 1})
    # A3 takes six TMA tensor maps a launch, from a cache keyed by address
    # and shape; these are the ones it had to encode on the host
    n_enc, n_a3 = encoded() - enc0, C.fused_ffn.KERNEL.launches
    print(f"[engine] A3 encoded {n_enc} tensor maps over {n_a3} launches "
          f"({6 * n_a3} maps; {n_enc / n_a3:.3f} encoded a launch, the rest "
          f"from its cache)")
    return launches


def serve_llama7b_w8(torch, np, C, L, Q, Engine, dev):
    """The quantized engine: w8 weights and int8 KV pages, the manifest
    calibrated on the card; A5 int8, A6 and A7 on every tick."""
    cfg = L.CONFIGS["llama-7b"]          # full width and depth
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = L.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    rs = np.random.RandomState(4)
    batches = [rs.randint(0, cfg.vocab_size, (1, 256)) for _ in range(2)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    manifest = Q.calibrate(cfg, params, batches)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t1
    kab = np.asarray(manifest.kv_scales["k"])
    vab = np.asarray(manifest.kv_scales["v"])
    require(kab.shape == (cfg.num_layers, cfg.num_kv_heads)
            and np.all(np.isfinite(kab)) and np.all(kab > 0)
            and np.all(np.isfinite(vab)) and np.all(vab > 0),
            "calibrated KV scales are not finite and positive")
    eng = Engine(cfg, params, block_size=16, max_batch=8, token_budget=64,
                 max_len=2048, quant_mode="w8", quant_kv=True,
                 quant_manifest=manifest, device=dev)
    del params                   # the engine keeps no bf16 block weight
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = eng.params["blocks"]
    require(all(blocks[f"{n}_q"].dtype == torch.int8
                and blocks[f"{n}_s"].dtype == torch.float32
                for n in Q.WEIGHT_NAMES) and not any(
                    n in blocks for n in Q.WEIGHT_NAMES),
            "the quantized engine holds fp block weights")
    wbytes = sum(t.numel() * t.element_size() for n, t in blocks.items()
                 if n.endswith(("_q", "_s")))
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in (eng._key_cache, eng._value_cache,
                             *eng._kv_dequant))
    print(f"[engine-w8] llama-7b w8 + int8 KV, {cfg.num_layers} layers: "
          f"calibrated over {len(batches)} x 256 tokens in {t_cal:.1f} s "
          f"(k absmax {kab.min():.3g}..{kab.max():.3g}, v "
          f"{vab.min():.3g}..{vab.max():.3g}); block weights "
          f"{wbytes / 1e9:.2f} GB int8 + scales, {eng.num_blocks} KV blocks "
          f"{kv_bytes / 1e9:.2f} GB int8 + scales; set up in "
          f"{time.perf_counter() - t0:.1f} s")
    return drive_engine(torch, np, C, eng, "ENGINE_W8", {
        "paged_attention_int8": cfg.num_layers,
        "fused_ffn_w8": cfg.num_layers, "fused_sample": 1})


def drive_engine(torch, np, C, eng, tag, per_tick):
    """Serve the phase's traffic — 8 requests at once, prompts seeded in
    64..512 tokens, 32 new tokens each, half greedy and half sampled —
    with every launch count set to 0 just before. Each kernel in
    `per_tick` must have launched that many times a tick, every other
    kernel not at all. Prints tokens/s, TTFT and TPOT p50 and peak
    memory, then profiles decode ticks of a fresh batch."""
    cfg = eng.cfg
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
                f"{tag}: non-finite logits at tick {ticks}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in C.KERNELS}
    done = {c.rid: c for c in eng.run()}
    require(sorted(done) == sorted(rids), f"{tag}: not every request "
            "completed")
    require(all(len(done[r].output_tokens) == 32 for r in rids),
            f"{tag}: a request ended short of 32 tokens")
    require(ticks == eng.stats["steps"], "ticks and engine steps disagree")
    expect = {k.name: per_tick.get(k.name, 0) * ticks for k in C.KERNELS}
    require(launches == expect, f"{tag}: launch counts {launches} != "
            f"{expect}")
    seqs = [eng.scheduler.get(r) for r in rids]
    ttft = [s.first_token_at - s.arrival for s in seqs]
    tpot = [(s.last_token_at - s.first_token_at) / (len(s.generated) - 1)
            for s in seqs]
    gen_tokens = sum(len(s.generated) for s in seqs)
    out = {"layers": cfg.num_layers, "quant_mode": eng.quant_mode,
           "quant_kv": eng.quant_kv, "requests": len(rids),
           "prompt_tokens": int(lens.sum()), "generated_tokens": gen_tokens,
           "ticks": ticks, "decode_ticks": eng.stats["decode_fast_steps"],
           "mixed_ticks": eng.stats["mixed_steps"], "wall_s": wall,
           "tokens_per_s": gen_tokens / wall,
           "ttft_p50_s": float(np.median(ttft)),
           "tpot_p50_s": float(np.median(tpot)),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    label = tag.lower().replace("_", "-")
    print(f"[{label}] {out['requests']} requests, {gen_tokens} tokens in "
          f"{wall:.2f} s over {ticks} ticks ({out['decode_ticks']} decode, "
          f"{out['mixed_ticks']} mixed): {out['tokens_per_s']:.1f} tok/s, "
          f"TTFT p50 {out['ttft_p50_s']:.3f} s, TPOT p50 "
          f"{out['tpot_p50_s'] * 1e3:.2f} ms, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    print(f"[{label}] launches {launches} (expected {expect})")
    print(f"{tag} " + json.dumps(out))
    profile_decode(torch, np, eng, tag.replace("ENGINE", "PROFILE"))
    return launches


def profile_decode(torch, np, eng, tag, ticks=5):
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
    print(f"[profile] {tag}: decode tick {tick_ms:.2f} ms ({profiled_ms:.2f} "
          f"ms under the profiler); device busy {busy:.2f} ms per tick")
    for t in out["top"]:
        print(f"[profile]   {t['ms_per_tick']:.3f} ms/tick "
              f"x{t['calls_per_tick']:.0f} {t['kernel']}")
    print(f"{tag} " + json.dumps(out))


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
    profile_once(torch, lambda: step(params, opt, tokens, targets),
                 "train step", "PROFILE_TRAIN")


def profile_once(torch, fn, what, tag):
    """One call of fn under torch.profiler: device time by kernel and the
    device's busy share of the call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3

    def row(e):
        return {"kernel": e.key[:80], "ms": e.self_device_time_total / 1e3,
                "calls": e.count}

    out = {"step_ms_under_profiler": step_ms, "device_ms": busy,
           "device_busy_share": busy / step_ms if busy else None,
           "top": [row(e) for e in sorted(kernels, key=lambda e:
                                          -e.self_device_time_total)[:12]],
           # A1 and A2 by name, in or out of the top twelve
           "flash": [row(e) for e in kernels
                     if any(f in e.key for f in ("flash_fwd", "flash_dq",
                                                 "flash_dkv"))],
           # A3's and A4's kernels by name
           "ffn": [row(e) for e in kernels if "ffn_" in e.key]}
    if not busy:
        print("[profile] torch.profiler saw no device time; busy share not "
              "measured")
    print(f"[profile] {what} {step_ms:.1f} ms under the profiler; device "
          f"busy {busy:.1f} ms")
    for t in out["top"]:
        print(f"[profile]   {t['ms']:.2f} ms x{t['calls']} {t['kernel']}")
    for part in ("flash", "ffn"):
        for t in out[part]:
            print(f"[profile]   {part}: {t['ms']:.2f} ms x{t['calls']} "
                  f"{t['kernel']}")
    print(f"{tag} " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 6: the varlen layer stack through the fused ops
# ---------------------------------------------------------------------------

def varlen_attention(ops, IF, x, lw, cu, pos, heads, kv_heads):
    """The attention half of a PaddleNLP-style LLaMA layer over packed
    tokens x [total, d] (normed): fused qkv projection, rope at each
    token's position in its sequence, varlen flash attention. Returns
    the attention output [total, heads, hd] and the roped q, k and v."""
    total, d = x.shape
    hd = d // heads
    qkv = ops.gemm_epilogue(x, lw["w_qkv"])
    q = qkv[:, :heads * hd].reshape(1, total, heads, hd)
    k = qkv[:, heads * hd:(heads + kv_heads) * hd].reshape(1, total,
                                                          kv_heads, hd)
    v = qkv[:, (heads + kv_heads) * hd:].reshape(total, kv_heads, hd)
    q, k = IF.fused_rotary_position_embedding(q, k, position_ids=pos[None])
    o = IF.flash_attn_unpadded(q[0], k[0], v, cu, cu, causal=True)[0]
    return o, q[0], k[0], v


def varlen_ffn(ops, x, lw):
    """The FFN half: x @ [w1 | w3], swiglu of the halves, @ w2."""
    g = ops.fused_bias_act(ops.gemm_epilogue(x, lw["w_gate_up"]), None,
                           "swiglu")
    return ops.gemm_epilogue(g, lw["w2"])


def varlen_layer(ops, IF, h, lw, cu, pos, heads, kv_heads):
    """One LLaMA layer in PaddleNLP's fused form over packed tokens h
    [total, d]: every op through `_C_ops` and `incubate.nn.functional`."""
    o = varlen_attention(ops, IF, IF.fused_rms_norm(h, lw["ln1"]), lw, cu,
                         pos, heads, kv_heads)[0]
    h = h + ops.gemm_epilogue(o.reshape(h.shape), lw["wo"])
    return h + varlen_ffn(ops, IF.fused_rms_norm(h, lw["ln2"]), lw)


def varlen_weights(torch, gen, dev, dtype, layers, d, f, heads, kv_heads,
                   scale=0.02):
    """Seeded weights of `layers` layers, leaves that take gradients."""
    hd = d // heads

    def leaf(*shape, ones=False):
        t = torch.randn(*shape, generator=gen, device=dev)
        t = 1 + 0.1 * t if ones else scale * t
        return t.to(dtype).requires_grad_()

    return [{"ln1": leaf(d, ones=True),
             "w_qkv": leaf(d, (heads + 2 * kv_heads) * hd),
             "wo": leaf(d, d), "ln2": leaf(d, ones=True),
             "w_gate_up": leaf(d, 2 * f), "w2": leaf(f, d)}
            for _ in range(layers)]


def packed_batch(torch, dev, lens):
    """cu_seqlens [B+1] int32 and each token's position in its sequence."""
    cu = torch.tensor([0] + [sum(lens[:i + 1]) for i in range(len(lens))],
                      dtype=torch.int32, device=dev)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    return cu, pos


def varlen_stack(torch, np, C, L, dev, layers=8, lens=VARLEN_LENS, timed=3):
    """LLaMA-7B width cut to `layers` layers, bf16, over one packed batch:
    one forward and backward from a seeded cotangent with every launch
    count at 0 just before; then the cross-checks, the timings and one
    profiled step."""
    from paddle_tpu_torch import _C_ops as ops
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    cfg = L.CONFIGS["llama-7b"]
    d, f = cfg.hidden_size, cfg.intermediate_size
    H, KV = cfg.num_heads, cfg.num_kv_heads
    T = sum(lens)
    bf = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    weights = varlen_weights(torch, gen, dev, bf, layers, d, f, H, KV)
    leaves = [t for lw in weights for t in lw.values()]
    h0 = torch.randn(T, d, generator=gen, device=dev).to(bf).requires_grad_()
    cot = torch.randn(T, d, generator=gen, device=dev).to(bf)
    cu, pos = packed_batch(torch, dev, lens)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in leaves)
    print(f"[varlen] llama-7b width, {layers} of 32 layers, "
          f"{nparams / 1e9:.2f} B params (bf16), one packed batch of "
          f"{list(lens)} = {T} tokens, set up in "
          f"{time.perf_counter() - t0:.1f} s")

    def forward():
        h = h0
        for lw in weights:
            h = varlen_layer(ops, IF, h, lw, cu, pos, H, KV)
        return h

    def step():
        out = forward()
        return out, torch.autograd.grad(out, [h0] + leaves, cot)

    torch.cuda.reset_peak_memory_stats()
    for k in C.KERNELS:              # count only the main path's launches
        k.launches = 0
    out, grads = step()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in C.KERNELS}
    expect = {k.name: 0 for k in C.KERNELS}
    expect.update({"fused_gemm_epilogue": 4 * layers, "fused_glu": layers,
                   "flash_attention": layers, "flash_attention_bwd": layers})
    require(launches == expect, f"varlen launches {launches} != {expect}")
    require(out.shape == (T, d) and bool(torch.isfinite(out).all()),
            "varlen stack output is not finite")
    require(all(bool(torch.isfinite(g).all()) for g in grads),
            "varlen stack gradients are not finite")
    peak = torch.cuda.max_memory_allocated()
    del out, grads

    # one layer's halves against the port's other kernels
    with torch.no_grad():
        lw = weights[0]
        x = IF.fused_rms_norm(h0, lw["ln1"])
        o, q, k, v = varlen_attention(ops, IF, x, lw, cu, pos, H, KV)
        bounds = cu.tolist()
        alone = torch.cat([FA.flash_attention(q[None, a:b], k[None, a:b],
                                              v[None, a:b], causal=True)[0]
                           for a, b in zip(bounds[:-1], bounds[1:])])
        h_attn = held("varlen attention vs flash_attention per sequence", o,
                      alone)
        h1 = h0 + ops.gemm_epilogue(o.reshape(T, d), lw["wo"])
        x = IF.fused_rms_norm(h1, lw["ln2"])
        wgu = lw["w_gate_up"]
        a3 = L.ffn(x, {"w1": wgu[:, :f].contiguous(),
                       "w3": wgu[:, f:].contiguous(), "w2": lw["w2"]})
        h_ffn = held_xcheck("varlen FFN vs llama.ffn (A3)",
                            varlen_ffn(ops, x, lw), a3)
        del o, q, k, v, alone, h1, x, a3
    print(f"[varlen] layer 0 cross-checks: {held_str('attention', h_attn)}; "
          f"{held_str('ffn', h_ffn)}, rms err "
          f"{h_ffn['rms_err_over_rms_ref']:.3g} of rms(ref) (rule "
          f"{XCHECK_RULE}: the fused ops round u, v and g to bf16, A3 "
          f"does not)")

    def timed_s(fn, n):
        fn()                                      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    with torch.no_grad():
        fwd_s = timed_s(forward, timed)
    step_s = timed_s(step, timed)
    flops_fwd = layers * (2 * T * d * (H + 2 * KV) * d // H + 2 * T * d * d
                          + 2 * T * d * 2 * f + 2 * T * f * d)
    out = {"layers": layers, "lens": list(lens), "tokens": T,
           "forward_s": fwd_s, "step_s": step_s, "tokens_per_s": T / step_s,
           "forward_projection_tflop": flops_fwd / 1e12,
           "max_memory_allocated_bytes": peak, "launches": launches,
           "xcheck_attention": h_attn, "xcheck_ffn": h_ffn}
    print(f"[varlen] forward {fwd_s * 1e3:.1f} ms, step (forward + backward) "
          f"{step_s * 1e3:.1f} ms, {T / step_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; projections {flops_fwd / 1e12:.2f} TFLOP "
          f"a forward")
    print(f"[varlen] launches {launches} (expected {expect})")
    print("VARLEN " + json.dumps(out))
    profile_once(torch, step, "varlen step", "PROFILE_VARLEN")
    del weights, leaves, h0, cot
    torch.cuda.empty_cache()
    return launches


XCHECK_RULE = ("|got - ref| <= 2^-7 |ref| + 2^-5 rms(ref) elementwise, and "
               "rms(got - ref) <= 2^-7 rms(ref)")


def held_xcheck(what, got, ref):
    """Hold the fused-op FFN against A3. The fused ops round u and v (the
    gate/up product's output) and g (A9's) to bf16 where A3 keeps them
    in f32: every term g_i w2_ij of the down projection carries up to
    three roundings of at most 2^-9, which add over d_ff terms to an
    error of about 2^-8 rms(ref) an element (0.0037 rms(ref), the plain
    versions on the CPU at d = 1,024, d_ff = 2,752), Gaussian in its
    tail. The elementwise atol 2^-5 rms(ref) is eight times that spread,
    above the ~6-sigma largest of 16.8 M such errors; the rms of the
    difference must stay within one bf16 ulp of rms(ref)."""
    a, b = got.float(), ref.float()
    rms = b.square().mean().sqrt().item()
    diff = (a - b).abs()
    worst = (diff / (BF16_RTOL * b.abs() + 2 ** -5 * rms)).max().item()
    rms_err = diff.square().mean().sqrt().item() / rms
    out = {"max_abs_err": diff.max().item(), "err_over_tol": worst,
           "tol_at_median": (BF16_RTOL
                             + 2 ** -5 * rms / b.abs().median().item()),
           "rms_err_over_rms_ref": rms_err}
    require(worst <= 1 and rms_err <= BF16_RTOL,
            f"{what}: max abs err {out['max_abs_err']:.3g}, {worst:.3g} x its "
            f"tolerance, rms err {rms_err:.3g} of rms(ref) ({XCHECK_RULE})")
    return out


# ---------------------------------------------------------------------------
# phase 7: CPU (plain versions) against the card (kernels)
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


def agreement_w8(torch, np, L, Q, Engine, dev):
    """The quantized engine (w8 weights, int8 pages) on a tiny float32
    model, on the CPU (plain versions) and on the card (A6, A5 int8),
    one manifest calibrated on the CPU: identical greedy tokens, int8
    page entries at most one step apart (a value at a rounding boundary
    may round either way after f32 sums in another order; the count is
    printed), and first-tick logits within 1e-3 of their largest entry.
    That limit is ten times the f32 agreement's because each flipped
    entry moves its scores by a whole quant step (absmax / 127), not by
    an f32 rounding."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    rs = np.random.RandomState(6)
    manifest = Q.calibrate(cfg, params,
                           [rs.randint(0, cfg.vocab_size, (2, 48))])
    for prompt_len in (40, 7):
        prompt = rs.randint(0, cfg.vocab_size, prompt_len).tolist()
        runs = {}
        for where in ("cpu", dev):
            eng = Engine(cfg, params, block_size=16, max_batch=4,
                         token_budget=16, max_len=128, quant_mode="w8",
                         quant_kv=True, quant_manifest=manifest,
                         device=where)
            eng.submit(prompt, max_new_tokens=24)
            first, tokens, gaps = None, [], []
            while eng.has_work():
                events = eng.step()
                row = eng.last_logits[0].float().cpu()
                if first is None:
                    first = row
                for ev in events:
                    if ev.token >= 0:
                        tokens.append(ev.token)
                        top2 = torch.topk(row, 2).values
                        gaps.append(float(top2[0] - top2[1]))
            pages = [t.cpu().int() for t in (eng._key_cache,
                                             eng._value_cache)]
            runs[str(where)] = (first, tokens, gaps, pages)
        (f_cpu, t_cpu, gaps, p_cpu), (f_gpu, t_gpu, _, p_gpu) = \
            runs["cpu"], runs[str(dev)]
        scale = f_cpu.abs().max().item()
        err = (f_gpu - f_cpu).abs().max().item()
        require(err <= 1e-3 * scale, f"quantized first-tick logits differ "
                f"by {err:.3g} (limit {1e-3 * scale:.3g})")
        require(t_gpu == t_cpu, f"quantized greedy tokens differ: {t_gpu} "
                f"vs {t_cpu}")
        steps = [(a - b).abs() for a, b in zip(p_gpu, p_cpu)]
        worst = max(int(d.max()) for d in steps)
        require(worst <= 1, f"int8 pages differ by {worst} steps")
        one = sum(int((d == 1).sum()) for d in steps)
        total = sum(d.numel() for d in steps)
        print(f"[agree-w8] prompt {prompt_len}: first-tick logits within "
              f"{err / scale:.3g} of the largest (limit 1e-3); "
              f"{len(t_cpu)} greedy tokens equal (min top-2 gap "
              f"{min(gaps):.3g}); {one} of {total} int8 page entries one "
              f"step apart, none more")


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


def varlen_agreement(torch, dev, layers=2, lens=(37, 100, 19, 100)):
    """A tiny float32 varlen stack (hidden 64, 4 heads, 2 kv heads) on the
    CPU (plain versions) and on the card (A8, A9, A1/A2 segment mode),
    TF32 off: the output and the input and weight gradients within 1e-4
    of each leaf's largest entry (f32 sums in other orders through two
    layers of norms, products and softmaxes)."""
    from paddle_tpu_torch import _C_ops as ops
    from paddle_tpu_torch.incubate.nn import functional as IF
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d, f, H, KV, T = 64, 128, 4, 2, sum(lens)
    gen = torch.Generator().manual_seed(12)
    weights = varlen_weights(torch, gen, "cpu", torch.float32, layers, d, f,
                             H, KV, scale=0.15)
    h0 = torch.randn(T, d, generator=gen)
    cot = torch.randn(T, d, generator=gen)
    runs = []
    for where in ("cpu", dev):
        ws = [{n: t.detach().to(where).requires_grad_() for n, t in lw.items()}
              for lw in weights]
        h_in = h0.to(where).requires_grad_()
        cu, pos = packed_batch(torch, where, lens)
        h = h_in
        for lw in ws:
            h = varlen_layer(ops, IF, h, lw, cu, pos, H, KV)
        leaves = [h_in] + [t for lw in ws for t in lw.values()]
        grads = torch.autograd.grad(h, leaves, cot.to(where))
        runs.append([t.detach().cpu() for t in (h, *grads)])
    worst = 0.0
    for a, b in zip(runs[1], runs[0]):
        worst = max(worst, (a - b).abs().max().item() / b.abs().max().item())
    require(worst <= 1e-4, f"varlen stack card vs cpu differ by {worst:.3g} "
            "of a leaf's largest entry")
    print(f"[agree-varlen] {layers}-layer f32 stack over {list(lens)}: output "
          f"and {len(runs[0]) - 1} gradients within {worst:.3g} of each "
          f"leaf's largest entry (limit 1e-4)")


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
    from paddle_tpu_torch.inference import quant as Q
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
             "fused_ffn_bwd": check_fused_ffn_bwd(torch, C.fused_ffn, dev),
             "paged_attention_int8": check_paged_attention_int8(
                 torch, C.paged_attention, dev),
             "fused_ffn_w8": check_fused_ffn_w8(torch, C.fused_ffn, dev)}
    cases["flash_attention"], cases["flash_attention_bwd"] = \
        check_flash_attention(torch, C.flash_attention, dev)
    seg_fwd, seg_bwd = check_flash_attention(torch, C.flash_attention, dev,
                                             lens=VARLEN_LENS)
    cases["flash_attention"] += seg_fwd
    cases["flash_attention_bwd"] += seg_bwd
    cases["fused_gemm_epilogue"] = check_gemm_epilogue(torch, C.fused_ffn,
                                                       dev)
    cases["fused_glu"] = check_fused_glu(torch, C.fused_ffn, dev)
    paths = {"serving": serve_llama7b(torch, np, C, L, PagedServingEngine,
                                      dev)}
    torch.cuda.empty_cache()
    paths["serving_w8"] = serve_llama7b_w8(torch, np, C, L, Q,
                                           PagedServingEngine, dev)
    torch.cuda.empty_cache()
    paths["training"] = train_llama7b(torch, np, C, L, H, dev)
    paths["varlen"] = varlen_stack(torch, np, C, L, dev)
    agreement(torch, np, L, PagedServingEngine, dev)
    agreement_w8(torch, np, L, Q, PagedServingEngine, dev)
    train_agreement(torch, np, L, H, dev)
    varlen_agreement(torch, dev)

    kernels = []
    for k in C.KERNELS:
        by_path = {p: n[k.name] for p, n in paths.items() if n[k.name]}
        # a kernel of several paths reports the first path's count (a
        # serving path, or training for A1/A2), whose shape its first
        # case row times
        launches = next(iter(by_path.values()))
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
