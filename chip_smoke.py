#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --paged   # A5's check alone (`paged_only`)
    python3 chip_smoke.py --sample  # A7's check alone (`sample_only`)
    python3 chip_smoke.py --disagg  # phase 4c alone (`disagg_only`)
    python3 chip_smoke.py --quant   # the quantized phases alone (`quant_only`)
    python3 chip_smoke.py --eager   # phases 8a and 8b alone (`eager_only`)
    python3 chip_smoke.py --transformer  # phases 8c-8f (`transformer_only`)
    python3 chip_smoke.py --detect  # phases 8g-8i (`detect_only`)
    python3 chip_smoke.py --surface  # phase 9 (`surface_only`)
    python3 chip_smoke.py --hybrid  # phase 5b (`hybrid_only`)
    python3 chip_smoke.py --dp      # phase 5c and `HYBRID` (`dp_only`)

needs one CUDA card and the CUDA toolkit (nvcc); it imports nothing of
jax and nothing of the JAX package `paddle_tpu`. Phases, in order — any
failed check raises and exits non-zero before the final line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the serving and training paths from
   `paddle_tpu_torch/ops/cuda/csrc/*.cu`, one nvcc per source, all
   started together, with ptxas's registers, shared memory and spills,
   and the dynamic shared memory of the tensor-core flash, fused FFN,
   int8-weight FFN, GEMM epilogue and paged attention (decode and mixed
   kernels, bf16 and int8 pages) kernels; the tiles the A6 and A8
   libraries take must be the wrappers' plans (`w8_tile`,
   `epilogue_tile`) and fit their blocks an SM; A7's plan at each of its
   vocabularies (`sample_plan`), its shared memory held to `plan_smem`,
   and how many of its clusters the card holds at once;
3. kernels: each kernel against its plain PyTorch version at its path's
   LLaMA-7B shapes (serving: decode and prefill rows; training: B = 2,
   T = 2,048, with a grouped-query attention case) and, for A1-A4, at
   the bench's training config (B = 4, T = 2,048, 12 heads; 8,192 rows
   at hidden 1,536, d_ff 4,096), with its error and
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
   library says a call issues, beside the matmul chain's rate; for A8
   the path each case takes (`epilogue_path`: six on the wgmma kernel,
   one whose rows TMA cannot address on the mma.sync one, held to the
   kernel's count by path) and a bit-identical rerun, for A6 (on its
   wgmma path) the int8 weights' bandwidth; for both the kernels' own
   device time from torch.profiler beside the call's event time; A5,
   fp and int8 pages, in six cases (decode, mixed, GQA decode and the
   engine's profiled decode tick, that tick also in tables of 8,192 and
   32,768 positions) and the rows of verify and prefill chunks bit-equal
   to the same tokens' decode rows (`check_paged_rows`), each held to
   TOL_RULE with its dead rows 0, a
   bit-identical rerun, its path (the tensor-core "mma"), its device
   time beside the event time and its planned split partials' bytes; A7
   (one cluster a row, radix selects) at B = 8 and V = 32,000, 128,256
   and 152,064, B = 1 and 64 at 32,000, and B = 1 at an odd V of
   1,048,583 that streams, each at top_k 0 and 50: argmax exact, the
   -inf pattern under the top-p boundary rule, kept values within 1e-6,
   a bit-identical rerun, row 5 alone bit for bit as in its batch, the
   plan, device time beside the event time, and where the time of row
   0's first block goes (the kernel's phase stamps); then crafted edge
   rows, exact;
4. engine: `PagedServingEngine` serves 8 requests at LLaMA-7B width in
   bf16 (random weights from a seed); every kernel's launch count must
   move by the expected amount per tick, A5's all on its "mma" path;
   then a few decode ticks of a fresh batch run under torch.profiler
   (device time by kernel, A5's and A7's kernels by name, busy share).
   Then the same traffic on the quantized engines, one after the other
   on the same bf16 weights (each engine freed before the next), with a
   manifest calibrated on the card over two seeded batches of 256
   tokens: w8 weights and int8 KV pages (`ENGINE_W8`: int8-weight FFN
   (A6) and int8-page attention (A5 int8) each 32 launches a tick, every
   A6 launch on its wgmma path and every A5 one on "mma", the fp A3 and
   A5 none; the profile lists A6's, A5's and A7's kernels by name); w8a8
   weights with int8 KV pages (`ENGINE_W8A8`: A5 int8 32 and A7 1 a
   tick, A3 and A6 none — every product, the FFN's too, rounds its
   activations to int8 and runs the int8 product `Q.int8_matmul`; the
   card's int32 sums held equal to the CPU's, and rows at 1-17 rows to
   the same rows at 64); fp8 weights with bf16 pages (`ENGINE_FP8`: A5
   32 and A7 1, A3 and A6 none; the card's float8 -> bf16 cast held to
   the CPU's bit for bit); for w8a8 and fp8 each part of one product
   (rounding, int8 product, rescale; cast, bf16 product, rescale) timed
   alone at the tick's rows (`ENGINE_*_PRODUCT` lines, the int8 product
   also with a row-major weight) and its kernels' device time summed in
   the tick's profile (`PROFILE_W8A8`, `PROFILE_FP8`). Decode ticks replay the
   engine's captured CUDA graph (launches counted at replay); the bf16
   engine then serves the same traffic twice more, on its now warm
   prefix cache: its decode ticks run eagerly (the function the graph
   holds; lines `ENGINE_EAGER`, `PROFILE_EAGER`), then replayed again
   (`ENGINE_WARM`, `PROFILE_WARM`), and `ENGINE_CAPTURE` puts the warm
   runs' TPOT p50, tokens/s, decode tick time and busy share side by
   side; each quantized engine serves it once more replayed (`_WARM`;
   their eager passes were cut to make room for phases 8c-8f);
   every profile holds a replayed tick bit-equal to the eager tick on
   the same inputs;
4a. fleet (LLaMA-7B width cut to FLEET_LAYERS = 16 of its 32 layers, to
   keep the script near its 300 s budget; bf16, the engine geometry of
   phase 4):
   `INVARIANCE` — one request's logits rows bit-equal whether computed
   alone in captured decode ticks, beside prefill chunks in mixed
   ticks, beside seven decode rows, or as rows of verify chunks of 4
   across the 256-position span boundary (an oracle draft proposing the
   known tokens), with how far cuBLAS's rows at M = 8 differ from the
   same rows at M = 64 (what the engine's one row count avoids);
   `ADAPTERS` — phase 4's traffic with tenants [None, a, b] in turn (2
   slots, rank 4, alpha 8, scale 0.3): base rows equal an adapter-free
   engine's streams, adapter rows differ, a repeat is identical with no
   new capture, A5 and A3 once a layer and A7 once a tick, the captured
   tick with and without adapters; `SPEC` — a draft of the target's first 8
   layers sharing its tensors, spec_k 3, greedy traffic: streams equal
   plain greedy, acceptance above 0, tokens/s beside plain, ms a
   proposal, launches split into verify and draft; `ROUTER` — two
   replicas on one set of device weights under
   `replica:kill@victim=0;call=5`: every stream equal to one engine's,
   0 dropped, 0 mismatches, failovers >= 1, the survivor's graph
   captured once, tokens/s and peak memory;
4c. slot engine and disaggregated serving (run after 4a): `SLOT_BENCH` —
   `bench.py:587-640`'s paged-vs-dense sub-config, nothing cut (tiny f32
   model, 24 requests on a shared prefix, 6 new): the paged streams equal
   the dense slot engine's, tokens/s of both; then at LLaMA-7B width
   (FLEET_LAYERS, bf16, the fleet geometry): `SLOT` —
   `ServingEngine(num_slots=8, chunk=8, max_len=2048)` on the standard
   greedy trace beside the paged
   engine, both warmed: one captured chunk, replayed bit-equal to the eager
   chunk, A1 and A3 once a layer a prefill and nowhere else; both engines
   held to a plain f32 forward of the same weights (every logits row along
   each engine's stream within SLOT_F32_TOL of its largest |logit|; a
   divergence only where the two contested tokens lie within that limit of
   its largest logit, and the paged top-2 gap no larger than the rows'
   difference; whether the two engines' rows lie within 2^-6 of the largest
   |logit| of each other is printed), ms a chunk and a step, tokens/s and
   their ratio; `DISAGG` —
   `DisaggRouter(pools="prefill=1,decode=1")`, raw wire: every stream equal
   to the monolithic engine's, every handoff by page pull, pages adopted,
   the decode replica's graph captured once and replayed over pages
   ingested after the capture, no new capture on a warm repeat, each
   pool's launches (A5 and A3 once a layer, A7 once a tick), MiB shipped
   and ms/MiB of each handoff half; `DISAGG_CHAOS` — the sender killed
   riding its offer (`migration:rank_dead@op=offer;victim=0;count=1`):
   one recompute
   fallback, 0 mismatches, 0 dropped, equal streams; a `drop` and a
   `corrupt` drill on the first 4 requests, one fallback each; `DISAGG_Q8`
   — the int8 wire on the first 4 requests: wire bytes against raw, no
   dropped stream, no mismatch error (stream equality is not required: the
   confirm covers one token, the reference's fault); `DISAGG_W8` — w8
   weights and int8 pages with a manifest calibrated as ENGINE_W8's, on
   the fleet's layers, first 4 requests:
   streams equal the monolithic quantized engine's, pages and dequant
   planes adopted as sent; `AUTOSCALE` — explicit summaries: a TTFT breach
   grows the decode pool through probation, the grown replica serves, calm
   drains it; peak memory;
4b. predictor: `LLMPredictor` at the bench's own decode config
   (`bench.py:937-943`: vocab 32,000, hidden 1,536, d_ff 4,096, 12
   layers and heads, bf16) at B = 8 and 32, at LLaMA-7B width (cut to
   PRED_7B_LAYERS = 8 of its 32 layers since the detection phases came,
   B = 8) and with w8, w8a8 and fp8 weights (B = 8; w8a8's
   decode rows padded to 17 for the int8 product): a 128-token prompt, a
   32-token warm-up `generate` (which captures the 32-step chunk), then
   128 new tokens (four replays) with A1's and A3's (A6's) launches held
   to the code's (prefill: one a layer each; decode: A3/A6 one a layer a
   step, counted at replay; no FFN kernel under w8a8 and fp8), the
   first PRED_EAGER_NEW = 64 tokens bit-equal to the eager steps' (128
   before the eager phases came, cut with the 7B depth to keep the
   script in its budget); tokens/s and ms a step captured beside eager (whole
   `generate`; one replayed 32-step chunk under CUDA events), and one
   replayed chunk under torch.profiler (lines `PREDICTOR*`,
   `PROFILE_PREDICTOR*`);
5. training: `make_train_step` (flash attention and fused FFN kernels,
   AdamW, bf16 compute over f32 master weights) at remat=True and at
   remat="dots", on one seeded batch: LLaMA-7B width cut to 8 of 32
   layers, B = 2, T = 2,048, 2 warm-up and 3 timed steps (lines
   `TRAIN`); then the bench's own training config (`bench.py:84-87`,
   ~438 M parameters, 12 layers, B = 4, T = 2,048), nothing cut, 2
   warm-up and 5 timed steps (lines `TRAIN_BENCH`), where
   `make_eval_step`'s loss must equal the first step's. The loss must be
   finite and fall, and every kernel's launch count must equal what the
   policy implies (A1 and A3 twice a layer a step under True, once under
   "dots"); tokens/s, step time, MFU and peak memory, then one step of
   each run under torch.profiler, with device time by kind of kernel;
   last, each policy's cost to the host: the bench config's forward and
   backward on 128 tokens, where the card waits on Python (`TRAIN_HOST`);
5b. the hybrid-parallel step and the collective layer over a world of
   one (one card: NCCL does not let two ranks of one communicator share
   a device), the card's memory freed first: `HYBRID` — the bench's
   training config (nothing cut, B 4, T 2,048, remat "dots") through
   `make_train_step(cfg, build_mesh())`, dp = pp = cp = tp = 1 over a
   one-rank NCCL group, every collective issued through it (counted by
   kind and axis); A1-A4 once a layer a step; its first 3 losses within
   1e-3 of `TRAIN_BENCH`'s "dots" losses from the same params and
   batch; step time beside that step's, tokens/s, MFU, one step
   profiled; `HYBRID_AGREE` — the reference test's tiny f32 config on
   the card and on the CPU (gloo): the synced gradients, and after one
   AdamW step the loss and every updated leaf, within 1e-4 of the
   leaf's largest; `HYBRID_MOE` — Mixtral-8x7B's
   widths (hidden 4,096, d_ff 14,336, 32 heads, 8 kv heads, 8 experts,
   top-2, rope 1e6) cut to MOE_LAYERS = 2 of 32 layers, B 1, T 2,048,
   bf16 over f32 masters, the memory reckoned first (peak <= 70 GB), ms
   a step, tokens/s, A1 / A2 launches, pairs dropped by the capacity,
   the first loss within 1e-3 of the single-device `moe_mlp` loss;
   `COLLECTIVE` — every eager collective and every op name with a
   world-one result over the NCCL group, exact; µs of a 1 MiB
   all_reduce; the issued counts. The mesh step's gradient sync packs
   the leaves that share their sync axes into the DataParallel reducer's
   buckets (one all_reduce a bucket an axis), so `HYBRID`'s all_reduce
   count a step is the buckets', A1-A4 still once a layer a step;
5c. DataParallel and fleet at world one over NCCL (`bench.py:310`):
   `BERT_DP` — `bench_bert_dp_sharding`, nothing cut (the `BERT` phase's
   model: V 8,192, T 128, D 256, 8 heads, FFN 1,024, 4 layers, B 16,
   AdamW 1e-4), through `fleet.init(is_collective=True)`,
   `distributed_model` and `distributed_optimizer`, eagerly, 3 warm-up
   and 5 timed steps pipelined as `bench.py:356-370`: tokens/s, ms a
   batch, the mode (fleet's; a fleet failure fails the run, where the
   bench would fall back to plain eager), the collectives a step and
   the buckets DataParallel's reducer would issue above one rank, peak
   memory; 3 card losses within 1e-5 of the CPU's (TF32 off) and within
   1e-6 of the same model's plain loop without fleet; `DP_OVERLAP` —
   `_dp_overlap_details` (`bench.py:384-468`) at world one: ms a step of
   DataParallel's barrier, overlapped and ZeRO-1 modes, on the f32 and
   the int8 wire (a group of one reduces nothing, as in the reference),
   the int8 wire's ratio from the buckets' own sizes, ZeRO-1's
   optimizer-state bytes, the overlapped run's parameters bit-equal to
   the barrier run's;
6. varlen layer stack: LLaMA-7B width in PaddleNLP's fused form (8 of 32
   layers, bf16, seeded weights) over one packed batch of 4,096 tokens,
   every op through `paddle_tpu_torch._C_ops` and
   `incubate.nn.functional`; one forward and backward with the launch
   counts the code implies (A8 4, A9 1, A1 1 and A2 1 a layer; all of
   A8's on its wgmma path, and the profile names its kernel), a finite
   output, one layer's FFN against `llama.ffn` (A3) and its attention
   against `flash_attention` on each sequence alone; forward and step
   time, tokens/s, peak memory, one step under torch.profiler;
7. agreement: a tiny float32 model served on the CPU (plain versions) and
   on the card (kernels) must agree on logits and greedy tokens, in bf16
   pages and in the quantized modes w8, w8a8 (both with int8 pages, whose
   entries may differ by one step, and the count of those is printed, as
   is the count of w8a8's int8 activations that differ) and fp8, and a
   sampled top_p = 0 row beside a greedy one must give tokens 0 (as the
   reference); the
   tiny predictor (CPU eager, card replayed) must give identical greedy
   tokens and logits within rtol 1e-4 of the largest; a tiny
   float32 model trained on both must agree on first-step gradients
   (remat True and "dots") and on the losses of 3 AdamW steps, and the
   remat policy (True, False, "dots") must not change the card's
   gradients by a bit; a tiny float32 varlen stack on both must agree on
   its output and its input and weight gradients; bf16 cases of the
   quantized engine (A6's tensor-core kernels end to end) and of the
   varlen stack (A8's wgmma kernel) with the rules their docstrings
   state;
8a. eager dispatch (`EAGER_DISPATCH`, `bench.py:1114` as it stands):
   the eager paddle API (`paddle_tpu_torch.to_tensor`, `Tensor.__add__`
   through `ops.dispatch.call_op`) on two 256 x 256 f32 tensors on
   `gpu:0`, 8 warm-up `a + b`, then 2,000 timed, closed by reading the
   sum: dispatches/s, us a dispatch, and the dispatch counters (every
   timed `a + b` counted through the port layer; `traces` 0 and
   `hit_rate` None, as the port caches and traces nothing), beside the
   same loop over the bare torch tensors (the yardstick of the port's
   host layer); the two sums bit-equal;
8b. LeNet (`LENET`, `bench.py:171` as it stands): `vision.models.LeNet`
   on `gpu:0`, B = 64, Momentum (lr 0.01, 0.9), the bench's 4 seeded
   batches, 2 warm-up and LENET_STEPS = 20 timed steps in the pipelined
   loop (the loss fetched `async_engine.depth()` steps late): samples/s,
   batch time, peak memory, the in-flight depth and backpressure waits;
   then from one state dict 8 steps on the card and 8 on the CPU (TF32
   off for both cuDNN and matmul), every loss within LENET_RTOL; no
   kernel of the port is on either path (torch ops, cuDNN, cuBLAS);
8c. BERT (`BERT`, `bench.py:310-400`'s model and loop, nothing cut: V
   8,192, T 128, D 256, 8 heads, FFN 1,024, 4 `TransformerEncoderLayer`s,
   B = 16, AdamW, eagerly at world size 1): 3 warm-up and 5 timed steps
   in the pipelined loop, tokens/s, batch time, peak memory; then 5 steps
   on the card and on the CPU from one state dict, TF32 off, every loss
   within BERT_RTOL;
8d. BERT-base under AMP (`BERT_BASE_AMP`: hidden 768, 12 heads, FFN
   3,072, 12 layers, vocab 30,522, T 512, B 8, dropout 0): bf16 O1 with
   a pass-through `GradScaler` (its first loss within
   BERT_BASE_BF16_ATOL of the f32 loss), then float16 O1 with dynamic
   loss scaling (scale and found_inf after each of 5 steps);
8e. `flash_attn` through the paddle op (`FLASH_ATTN_OP`): A1 and A2 once
   each a call at BERT-base's and LLaMA-7B's attention, held to their
   plain versions; masked, dropout and biased calls launch neither; the
   op's event times beside SDPA's;
8f. `fused_multi_transformer` at LLaMA-7B width, 8 of 32 layers
   (`FUSED_MT`): a 128-token prefill and 32 decode steps at B = 8, each
   decode step held to a prefill over the same tokens (bf16, and an
   f32 witness on the same weights); ms a prefill and a step;
8g. the bench's detector (`DETECT`, `bench.py:472-578`, nothing cut: B 8,
   3 x 640 x 640, width 32, 80 classes, eval, bf16 `auto_cast` O1,
   `yolo_box` in f32 on the three heads): 2 warm-up and 5 timed passes,
   images/s, ms a batch, peak memory, one pass profiled; `nms` over image
   0's boxes (IoU 0.5, top_k 100), kept and ms; an f32 pass on the card
   and the CPU from one state dict: boxes and scores within DETECT_REL of
   the largest |value|, and the card's `nms` on the CPU's boxes keeps
   the CPU's indices;
8h. the detection ops (`DETECT_OPS`) at the detector's shapes, card
   against CPU: `multiclass_nms3` over [8, 8400, 4] x [8, 80, 8400]
   (indices and nms_num exact), `roi_align` (512 boxes, 7 x 7),
   `deform_conv2d` (B 8, 128 -> 128, 80 x 80, with a mask) and
   `yolo_loss` (three heads, 50 boxes an image), forward and backward,
   within DETECT_OPS_REL; the time of each;
8i. the `rnn` op (`RNN_OP`: LSTM, 2 layers, bidirectional, 512 / 512, T
   128, B 32, f32): card against CPU within RNN_REL, outputs and
   gradients; ms forward and forward + backward;
9a. the paddle op `block_multihead_attention_` under ops.yaml's
   signature (`BMHA_OP`) at LLaMA-7B's attention (32 heads of 128, block
   16, rope on; four prefill rows of 64-512 tokens and four decode rows
   at 1,000-2,000 past positions), bf16 pages and int8 pages with
   calibrated scales: A5 / A5 int8 once a call; fmha_out and the written
   pages bit-equal to the engine's `paged_block_attention` call and held
   to the CPU's plain version; the op's event time beside the bare A5
   call's;
9b. `paddle_tpu_torch.nn.LSTM(512, 512, num_layers=2,
   direction="bidirect")` under a Linear head and `nn.CTCLoss`
   (`LSTM_LAYER`: T 128, B 32, f32, AdamW, 5 timed steps after 2):
   samples/s, ms a step; card losses within 1e-5 of the CPU's over 3
   steps, TF32 off;
9c. `SURFACE`: jacobian and hessian of a small MLP card against CPU; a
   `save` on the card loaded on the CPU; `flash_attn_qkvpacked` at
   BERT-base's attention onto A1 once, held to its plain version; a w8 +
   int8-KV engine built from `FLAGS_quant_*` alone (LLaMA-7B width, 8
   layers) serving `standard_trace`'s 8 requests with the greedy tokens
   of the engine built from arguments;
10. summary: each phase's seconds, one `{"kernels": [...]}` line, then
   the last line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings

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


def device_ms(torch, fn, iters, names):
    """Device time of one call of fn: the mean device time of each of its
    kernels whose names hold one of `names` (each launched once a call),
    summed, from torch.profiler over `iters` calls after a warm-up. The
    kernels' own time, without the host's launch gaps that a call's event
    time includes when its kernels are shorter than its Python. Means over
    the records the profiler kept, so a record it drops does not count as
    a call of zero time; a window in which it kept none of the kernels'
    is profiled again (up to three times; 0.0 if it never kept one)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total / e.count
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.count and any(n in e.key for n in names)) / 1e3
        if ms:
            return ms
    return 0.0


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
    # the tiles the libraries take, held to the wrappers' plans
    # (`epilogue_tile`, `w8_tile`), whose blocks an SM must fit
    for nc in (1, 2):
        epi = FF.KERNEL_EPILOGUE.fn("fused_gemm_epilogue_smem")(nc)
        cols = FF.KERNEL_EPILOGUE.fn("fused_gemm_epilogue_tile_n")(nc)
        rows, want_cols, per_sm = FF.epilogue_tile(64 * nc)
        require(rows == 64 * nc and cols == want_cols
                and per_sm * (epi + 1024) <= 233472,
                f"A8's library tiles {64 * nc} x {cols} ({epi} B) against "
                f"epilogue_tile's {FF.epilogue_tile(64 * nc)}")
        print(f"[build] A8 wgmma, {64 * nc} x {cols} tiles, {per_sm} an SM: "
              f"dynamic shared memory {epi:,} B a block")
    for R in (8, 64):
        n = FF.KERNEL_W8.fn("fused_ffn_w8_tile_rows")(R)
        per_sm = FF.KERNEL_W8.fn("fused_ffn_w8_blocks_per_sm")(R)
        w8 = [FF.KERNEL_W8.fn("fused_ffn_w8_smem")(k, n) for k in (0, 1)]
        require((n, per_sm) == FF.w8_tile(R)
                and per_sm * (max(w8) + 1024) <= 233472,
                f"A6's library tiles {n} rows, {per_sm} an SM ({w8} B) "
                f"against w8_tile's {FF.w8_tile(R)}")
        print(f"[build] A6 bf16, {n}-row tiles, {per_sm} an SM: dynamic "
              f"shared memory gate/up {w8[0]:,} B, down {w8[1]:,} B a block")
    sample_plans(C.fused_sample)
    PA = C.paged_attention
    for hd in (64, 128):
        for dec, kind in ((1, "decode (<= 8 rows)"), (0, "mixed")):
            fp, i8 = (k.fn(f"{k.name}_smem")(hd, dec)
                      for k in (PA.KERNEL, PA.KERNEL_INT8))
            print(f"[build] paged attention bf16 q, head_dim {hd}, {kind} "
                  f"kernel: dynamic shared memory a block: bf16 pages "
                  f"{fp:,} B, int8 pages {i8:,} B")
    FA = C.flash_attention
    for hd in (64, 128):
        fwd = FA.KERNEL_FWD.fn("flash_attention_fwd_smem")(hd)
        dq, dkv = (FA.KERNEL_BWD.fn("flash_attention_bwd_smem")(hd, w)
                   for w in (0, 1))
        print(f"[build] flash attention bf16, head_dim padded to {hd}: "
              f"dynamic shared memory a block: forward {fwd:,} B, dq "
              f"{dq:,} B, dk/dv {dkv:,} B")


def sample_plans(FS):
    """A7's plan at each SAMPLE_CASES vocabulary: the library's shared
    memory a block held to `plan_smem`, and the clusters of that plan
    the card holds at once (cudaOccupancyMaxActiveClusters)."""
    for V in sorted({V for _, V in SAMPLE_CASES}):
        p = FS.sample_plan(V)
        smem = FS.KERNEL.fn("fused_sample_smem")(p.cluster, p.tile, *p.bits)
        at_once = FS.KERNEL.fn("fused_sample_max_clusters")(
            p.cluster, p.slice, p.tile, *p.bits)
        require(smem == FS.plan_smem(p.cluster, p.tile, p.bits)
                and at_once > 0, f"A7 at V={V}: the library's {smem} B a "
                f"block against plan_smem's "
                f"{FS.plan_smem(p.cluster, p.tile, p.bits)}, {at_once} "
                "clusters at once")
        where = ("resident" if p.resident
                 else f"streamed in {p.tile}-float tiles")
        print(f"[build] A7 V={V}: clusters of {p.cluster} blocks, "
              f"{p.slice} floats a block, {where}, digits {p.bits}, masses "
              f"x 2^{p.shift}; dynamic shared memory {smem:,} B a block; "
              f"{at_once} clusters on the card at once")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(torch, dev, B, KV, G, past, this, max_q, hd=128, bs=16,
               seed=0, int8=False, max_len=2048):
    """Seeded bf16 q rows over a paged pool, bf16 pages or (int8=True)
    int8 pages with per-page dequant scales, block tables of max_len
    positions. Returns (args, kwargs, bytes, operations) of one launch."""
    g = torch.Generator().manual_seed(seed)
    pages = [-(-(p + t) // bs) for p, t in zip(past, this)]
    nb = sum(pages) + 8
    mb = -(-max_len // bs)
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
    # the engine phases' profiled decode ticks: 8 requests of 256-token
    # prompts (`profile_decode`), about 260 cached tokens a sequence
    "engine_decode": dict(B=8, KV=32, G=1, max_q=1, past=[260] * 8,
                          this=[1] * 8),
    # the same tick in an engine of max_len 8,192 and 32,768: the block
    # tables are wider, the work the same
    "engine_decode_8k": dict(B=8, KV=32, G=1, max_q=1, past=[260] * 8,
                             this=[1] * 8, max_len=8192),
    "engine_decode_32k": dict(B=8, KV=32, G=1, max_q=1, past=[260] * 8,
                              this=[1] * 8, max_len=32768),
}


def check_paged_attention(torch, PA, dev):
    """A5, fp pages (bf16 q and pages), in every `PAGED_CASES` case."""
    return check_paged(torch, PA, dev, int8=False)


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


# A3's cases: (d, f) and its (name, rows, timed calls) at that width. At
# LLaMA-7B width the serving path's rows (every engine tick runs 64; 8,
# the 7B-width predictor's decode step), the training step's (B * T =
# 4,096) and the 7B-width predictor's prefill (B * T = 8 * 128); at the
# bench's width (hidden 1,536, d_ff 4,096) the predictor's decode steps
# (B = 8 and 32) and prefills (B * T = 8 * 128 and 32 * 128) and the
# bench's training step (B * T = 4 * 2,048)
FFN_CASES = (((4096, 11008), (("tick_R64", 64, 20), ("decode_R8", 8, 20),
                              ("train_R4096", 4096, 10),
                              ("pred7b_prefill_R1024", 1024, 10))),
             ((1536, 4096), (("pred_decode_R8", 8, 20),
                             ("pred_decode_R32", 32, 20),
                             ("pred_prefill_R1024", 1024, 10),
                             ("pred_prefill_R4096", 4096, 10),
                             ("train_bench_R8192", 8192, 10))))


def check_fused_ffn(torch, FF, dev, cases=FFN_CASES):
    """A3 at every `FFN_CASES` shape, bf16: held against the plain
    version, rerun bit for bit, timed beside the matmul chain."""
    units_of = FF.KERNEL.fn("fused_ffn_fwd_units")
    rows = []
    for (d, f), shapes in cases:
        rows += fused_ffn_rows(torch, FF, dev, units_of, d, f, shapes)
    return rows


def fused_ffn_rows(torch, FF, dev, units_of, d, f, shapes):
    """check_fused_ffn's rows at one width."""
    g, w1, w3, w2 = ffn_operands(torch, dev, 1, d, f)
    rows = []
    for name, R, n in shapes:
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
        rows.append(dict(case=name, d=d, f=f, **h, tolerance=TOL_RULE, ms=ms,
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


def check_fused_ffn_bwd(torch, FF, dev, R=4096, d=4096, f=11008,
                        case="train"):
    """A4 at a training step's rows, bf16: by default LLaMA-7B width at
    B = 2, T = 2,048; the case is named `case` and the rows."""
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
    bwd_row = dict(case=f"{case}_R{R}",
                   max_abs_err=max(h["max_abs_err"] for h in errs.values()),
                   tolerance=TOL_RULE, errors=errs, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   tflops=tflops, chain_tflops=flops / lib_ms * 1e-9,
                   rerun_identical=True)
    print(f"[kernel] fused_ffn_bwd[{case}_R{R}] "
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
                          lens=None, kv_heads=(None, 8), backward=True,
                          prefix=""):
    """A1 and A2, causal, bf16: by default LLaMA-7B's 32 heads and a
    grouped-query case with 8 kv heads (`kv_heads`, None for H). Without
    `lens`, at the training step's shapes (B sequences of T tokens; the
    yardstick is SDPA); with `lens`, in segment-id mode over one packed
    batch of those lengths (B = 1; the yardstick is SDPA over each
    sequence in turn, summed). `backward=False` holds and times A1 alone;
    `prefix` starts each case's name."""
    F = torch.nn.functional
    spans, segs, tag, seg = [(0, T)], (), prefix, None
    if lens is not None:
        B, T, tag = 1, sum(lens), prefix + "seg_"
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
    for KV in (kv or H for kv in kv_heads):
        name = tag + ("mha" if KV == H else f"gqa_kv{KV}")
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
        if not backward:
            del q, k, v, do, o, lse
            continue

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
    """A5's int8-page mode in the cases of the fp check, bf16 q, int8
    pages, per-page f32 scales."""
    return check_paged(torch, PA, dev, int8=True)


def check_paged(torch, PA, dev, int8):
    """A5 in every `PAGED_CASES` case: live rows held elementwise to
    TOL_RULE, dead rows (pad rows, idle slots) exactly 0, a bit-identical
    rerun, one launch on the tensor-core path ("mma"); the call's event
    time beside its kernels' device time (the split kernel and its
    merge), the plain version's time and the bound. The text line also
    gives the split partials' bytes as the plan (`paged_splits`) sets
    them, a share of the K/V bytes; planned, not measured."""
    kernel = PA.KERNEL_INT8 if int8 else PA.KERNEL
    what = "paged_attention_int8" if int8 else "paged_attention"
    rows = []
    for name, c in PAGED_CASES.items():
        args, kw, nbytes, ops = paged_case(
            torch, dev, c["B"], c["KV"], c["G"], c["past"], c["this"],
            c["max_q"], seed=5 if int8 else 0, int8=int8,
            max_len=c.get("max_len", 2048))
        kernel.reset()
        out = PA.paged_attention(*args, **kw)
        ref = PA.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        path = dict(kernel.paths)
        require(path == {"mma": 1}, f"{what}[{name}] took {path}")
        t = torch.arange(out.shape[2], device=dev) // c["G"]
        live = (t[None, :] < args[5][:, None])[:, None, :, None].expand_as(
            out)
        require(not bool(out[~live].any()),
                f"{what}[{name}]: a dead row is not 0")
        h = held(f"{what}[{name}]", out[live], ref[live])
        require(torch.equal(PA.paged_attention(*args, **kw), out),
                f"{what}[{name}] is not deterministic")
        ms = cuda_ms(torch, lambda: PA.paged_attention(*args, **kw), 50)
        dev_ms = device_ms(torch, lambda: PA.paged_attention(*args, **kw),
                           20, ("paged_attention",))
        plain_ms = cuda_ms(torch, lambda: PA.paged_attention_plain(
            *args, **kw), 5, warmup=1)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        hd, bs, elem = args[0].shape[3], args[1].shape[2], args[1].itemsize
        kv_bytes = (sum(c["past"]) + sum(c["this"])) * c["KV"] * hd * 2 * elem
        plan = PA.paged_splits(c["G"], hd, bs, args[3].shape[1], c["B"],
                               c["KV"], elem)
        part = PA.partial_bytes(c["past"], c["this"], c["G"], hd, c["KV"],
                                plan)
        rows.append(dict(case=name, **h, tolerance=TOL_RULE, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None, path="mma",
                         rerun_identical=True))
        print(f"[kernel] {what}[{name}] {held_str('out', h)} dead rows 0, "
              f"rerun bit-identical, path mma; kernel={ms:.4f} ms (device "
              f"{dev_ms:.4f} ms) plain={plain_ms:.4f} ms bound={b_ms:.4f} ms "
              f"({b_by}); planned split partials (span {plan.span}) "
              f"{part / 1e6:.3f} MB, {100 * part / kv_bytes:.2f} % of the "
              f"K/V bytes")
    return rows


# A5's row cases: (past, this) of a chunk whose rows are held, bit for
# bit, to the same tokens as decode rows (this = 1 at past + t). Spans are
# 256 positions at LLaMA-7B (`paged_splits`): verify chunks (k + 1 = 4
# rows, split across blocks) below, across and above a span boundary; a
# chunk of 7 (past part_rows = 6) and prefill chunks of 40 and 64, whose
# row groups merge their spans inside one block
PAGED_ROW_CASES = ((120, 4), (254, 4), (700, 4), (1790, 4), (253, 7),
                   (230, 40), (600, 64))


def check_paged_rows(torch, PA, dev, int8, G=1, KV=32, hd=128, bs=16,
                     count_only=False):
    """A5's rows independent of the launch's shape: for each
    `PAGED_ROW_CASES` chunk (past, this) of one sequence, launched as a
    mixed tick's row (max_q 64) beside a sequence prefilling and an idle
    slot, each of its `this` token rows must equal, bit for bit, the same
    q row launched as a decode row (max_q 1, past + t cached) of a batch
    of such rows over the same pages. Returns the rows compared;
    `count_only` (for a kernel that does not promise it) returns
    (compared, differing) and requires nothing."""
    g = torch.Generator().manual_seed(11)
    max_len = 2048
    mb = max_len // bs
    nb = 2 * mb + 4
    bf = torch.bfloat16
    kc = torch.randn(nb, KV, bs, hd, generator=g)
    vc = torch.randn(nb, KV, bs, hd, generator=g)
    kw = {}
    if int8:
        kc, vc = ((40 * t).round().clamp(-127, 127).to(dev, torch.int8)
                  for t in (kc, vc))
        kw = {name: torch.empty(nb, KV).uniform_(0.005, 0.05, generator=g)
              .to(dev) for name in ("k_dequant", "v_dequant")}
    else:
        kc, vc = kc.to(dev, bf), vc.to(dev, bf)
    perm = torch.randperm(nb, generator=g)
    row = perm[:mb].to(torch.int32)              # the sequence's pages
    other = perm[mb:2 * mb].to(torch.int32)      # a prefilling neighbour
    sm = 1.0 / math.sqrt(hd)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    compared = differing = 0
    for past, this in PAGED_ROW_CASES:
        q = torch.randn(this, KV, G, hd, generator=g).to(dev, bf)
        mixed = torch.zeros(3, KV, 64 * G, hd, dtype=bf, device=dev)
        mixed[0, :, :this * G] = q.permute(1, 0, 2, 3).reshape(
            KV, this * G, hd)
        mixed[1] = torch.randn(KV, 64 * G, hd, generator=g).to(dev, bf)
        tables = torch.stack([row, other, torch.full_like(row, -1)]).to(dev)
        out = PA.paged_attention(mixed, kc, vc, tables, i32([past, 500, 0]),
                                 i32([this, 37, 0]), G, sm, **kw)
        dec = PA.paged_attention(
            q.reshape(this, KV, G, hd), kc, vc,
            row.to(dev)[None].expand(this, mb).contiguous(),
            i32([past + t for t in range(this)]), i32([1] * this), G, sm,
            **kw)
        got = out[0, :, :this * G].reshape(KV, this, G, hd).permute(
            1, 0, 2, 3)
        bad = [t for t in range(this) if not torch.equal(got[t], dec[t])]
        differing += len(bad)
        require(count_only or not bad,
                f"A5 ({'int8' if int8 else 'bf16'} pages): chunk "
                f"rows {bad} of (past {past}, this {this}) differ from the "
                f"same tokens' decode rows")
        compared += this
    if count_only:
        print(f"[kernel] paged_attention{'_int8' if int8 else ''} rows: "
              f"{differing} of {compared} chunk rows differ from the same "
              f"tokens' decode rows")
        return compared, differing
    print(f"[kernel] paged_attention{'_int8' if int8 else ''} rows: "
          f"{compared} chunk rows in {len(PAGED_ROW_CASES)} chunks "
          f"(verify, prefill) bit-equal to the same tokens' decode rows")
    return compared


# A6's cases: at LLaMA-7B width the serving path's rows (every engine
# tick runs 64) and a decode tile's 8; at the bench's decode width
# the w8 predictor's decode step (B = 8) and prefill (B * T = 8 * 128)
FFN_W8_CASES = (((4096, 11008), (("tick_R64", 64), ("decode_R8", 8))),
                ((1536, 4096), (("pred_decode_R8", 8),
                                ("pred_prefill_R1024", 1024))))


def check_fused_ffn_w8(torch, FF, dev, cases=FFN_W8_CASES):
    """A6 at every `FFN_W8_CASES` shape, bf16 x, int8 weights quantized
    from seeded bf16 ones. The yardstick is the chain the port avoids:
    dequantize the three weights to bf16, then the cuBLAS bf16 matmul
    chain."""
    rows = []
    for (d, f), shapes in cases:
        rows += fused_ffn_w8_rows(torch, FF, dev, d, f, shapes)
    return rows


def fused_ffn_w8_rows(torch, FF, dev, d, f, shapes):
    """check_fused_ffn_w8's rows at one width."""
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
    for name, R in shapes:
        x = torch.randn(R, d, generator=g, device=dev).to(bf)
        FF.KERNEL_W8.reset()
        out = FF.fused_ffn_w8(x, *leaves)
        ref = FF.fused_ffn_w8_plain(x, *leaves)
        torch.cuda.synchronize()
        require(FF.KERNEL_W8.paths == {"wgmma": 1},
                f"fused_ffn_w8[{name}] took {FF.KERNEL_W8.paths}")
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
        dev_ms = device_ms(torch, lambda: FF.fused_ffn_w8(x, *leaves), 20,
                           ("w8_",))
        # the int8 weights' bytes over the call's time and over its
        # kernels' device time
        wtb_s, dev_tb_s = (3 * d * f / t * 1e-9 for t in (ms, dev_ms))
        rows.append(dict(case=name, d=d, f=f, **h, tolerance=TOL_RULE, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, path="wgmma",
                         weight_tb_per_s=wtb_s,
                         weight_tb_per_s_device=dev_tb_s,
                         rerun_identical=True))
        print(f"[kernel] fused_ffn_w8[{name}] {held_str('out', h)} rerun "
              f"bit-identical, path wgmma; kernel={ms:.4f} ms (int8 weights "
              f"at {wtb_s:.2f} TB/s; its kernels' device time {dev_ms:.4f} "
              f"ms, {dev_tb_s:.2f} TB/s) plain={plain_ms:.4f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) dequantize + bf16 chain "
              f"(yardstick)={lib_ms:.4f} ms")
    del leaves
    torch.cuda.empty_cache()
    return rows


EPILOGUE_CASES = (
    # (case, m, k, n, activation, bias): the varlen stack's projections
    # at LLaMA-7B width over 4,096 tokens, a decode tick's 8 rows, an
    # activation with a bias, a shape off every tile, and one whose rows
    # (140 and 72 bytes) TMA cannot address
    ("qkv", 4096, 4096, 12288, "none", False),
    ("gate_up", 4096, 4096, 22016, "none", False),
    ("down", 4096, 11008, 4096, "none", False),
    ("decode_R8", 8, 4096, 22016, "none", False),
    ("bias_gelu", 4096, 4096, 11008, "gelu", True),
    ("odd_silu", 100, 72, 40, "silu", True),
    ("odd_stride", 100, 70, 36, "silu", True),
)


def check_gemm_epilogue(torch, FF, dev):
    """A8 at the varlen stack's shapes, bf16, against its plain version,
    with the path each case takes (`epilogue_path`; the kernel's count by
    path must agree) and a bit-identical rerun; the yardstick is the
    cuBLAS chain act(torch.addmm(bias, x, y))."""
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
        path = FF.epilogue_path(x, y)
        FF.KERNEL_EPILOGUE.reset()
        out = FF.fused_gemm_epilogue_fwd(x, y, b, act)
        ref = FF.fused_gemm_epilogue_plain(x, y, b, act)
        torch.cuda.synchronize()
        require(FF.KERNEL_EPILOGUE.paths == {path: 1},
                f"fused_gemm_epilogue[{name}]: epilogue_path says {path}, "
                f"the launch counted {FF.KERNEL_EPILOGUE.paths}")
        h = held(f"fused_gemm_epilogue[{name}]", out, ref)
        require(torch.equal(FF.fused_gemm_epilogue_fwd(x, y, b, act), out),
                f"fused_gemm_epilogue[{name}] is not deterministic")
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
        dev_ms = device_ms(torch, lambda: FF.fused_gemm_epilogue_fwd(
            x, y, b, act), n_it, ("epilogue",))
        # x, y (and the bias) read once, out written once
        nbytes = (m * k + k * n + m * n + (n if has_bias else 0)) * 2
        b_ms, b_by = bound(nbytes, 2 * m * k * n, "bfloat16")
        rows.append(dict(case=name, **h, tolerance=TOL_RULE, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, path=path,
                         tflops=2 * m * k * n / ms / 1e9,
                         rerun_identical=True))
        print(f"[kernel] fused_gemm_epilogue[{name} {m}x{k}@{k}x{n} {act}"
              f"{' +bias' if has_bias else ''}] path {path}; "
              f"{held_str('out', h)} rerun bit-identical; "
              f"kernel={ms:.4f} ms ({2 * m * k * n / ms / 1e9:.1f} TFLOP/s; "
              f"device time {dev_ms:.4f} ms) plain={plain_ms:.4f} ms "
              f"bound={b_ms:.4f} ms ({b_by}) cublas chain (yardstick)="
              f"{lib_ms:.4f} ms")
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


# A7's cases (B, V), each at top_k 0 and 50: the engine's decode tick
# first (its row is the summary's), then LLaMA-3's and Qwen2's
# vocabularies, one row, a wide batch, and an odd vocabulary past what a
# cluster keeps resident in shared memory (streamed from L2)
SAMPLE_CASES = ((8, 32000), (8, 128256), (8, 152064), (1, 32000),
                (64, 32000), (1, 1048583))
SAMPLE_TEMPS = (1.0, 0.8, 0.8, 0.8, 1.0, 0.8, 0.7, 1.2)
SAMPLE_TOP_PS = (1.0, 0.9, 0.9, 0.9, 1.0, 0.9, 0.5, 0.95)
SAMPLE_SLOT = 5        # the row also run alone, bit for bit
SAMPLE_EDGE_V = 40000  # the crafted rows' vocabulary: ten blocks a row


def sample_edge_cases(np, V=SAMPLE_EDGE_V):
    """Crafted sampler batches, as numpy: (name, logits f32 [B, V], temps
    [B], top_ps [B], top_k). Each row's finite values sit at spread
    positions among -inf (whose masking is moot), so the blocks of a row
    hold different parts and ties cross blocks: one finite entry; all
    entries equal; ties at the top-p cutoff; top_p 0, 1e-3, 1.0 and 1.5;
    temperature 1e-9; +0.0 beside -0.0; ties at the k-th value; top_k 1
    and top_k = V (the reference's largest). No kept entry's exclusive
    prefix mass lies near its top_p, so the -inf pattern is exact."""
    rs = np.random.RandomState(7)
    ninf = np.float32(-np.inf)
    at = (np.arange(64) * (V // 64) + 17) % V     # spread positions

    def row(vals):
        r = np.full(V, ninf, np.float32)
        r[at[:len(vals)]] = np.asarray(vals, np.float32)
        return r

    moderate = (2.0 * rs.randn(48)).astype(np.float32)
    ties_cut = [3.0, 2.0, 2.0, 2.0, 1.0, 0.0, -1.0]  # p(3) = 0.437
    zeros = [1.0, 0.0, -0.0, -0.0, 0.0, -1.0, 0.5]
    kth = [9.0, 8.0, 7.0, 6.0, 5.0, 5.0, 5.0, 4.0, 3.0, 5.0]
    cases = []
    rows = [(row([1.5]), 1.0, 0.9),                       # one finite entry
            (np.full(V, 0.25, np.float32), 1.0, 0.5),     # all equal
            (row(ties_cut), 1.0, 0.6),                    # cutoff among 2s
            (row(moderate), 1.0, 0.0),                    # masks the row
            (row(moderate), 0.7, 1e-3),                   # the max alone
            (row(moderate), 1.3, 1.0),                    # keeps all
            (row(moderate), 1e-9, 0.9),                   # t clamps to 1e-6
            (row(zeros), 1.0, 0.95),                      # +-0.0
            (row(zeros), 1.0, 0.6),                       # cutoff at 0.0
            (row(moderate), 0.8, 1.5)]                    # top_p past 1
    cases.append(("top_k0", rows))
    cases.append(("top_k1", [(row([2.0, 7.0, 7.0, 1.0]), 1.0, 1.0),
                             (row(moderate), 0.9, 0.9)]))
    cases.append(("top_k3", [(row(zeros), 1.0, 1.0)]))   # k-th is 0.0
    cases.append(("top_k5", [(row(kth), 1.0, 1.0),       # four 5s kept
                             (row(kth), 2.0, 0.8),
                             (row(zeros), 1.0, 1.0)]))    # +-0.0 at the k-th
    cases.append((f"top_k{V}", [(row(moderate), 1.0, 0.9),
                                (row(ties_cut), 0.5, 0.95),
                                (row(moderate), 1.0, 0.97)]))
    out = []
    for name, rs_ in cases:
        logits = np.stack([r for r, _, _ in rs_])
        temps = np.array([t for _, t, _ in rs_], np.float32)
        top_ps = np.array([p for _, _, p in rs_], np.float32)
        out.append((name, logits, temps, top_ps, int(name[len("top_k"):])))
    return out


def prefix_mass(torch, logits, temps, top_k):
    """Each entry's exclusive prefix mass in the descending sort that the
    top-p cut walks (the plain version's arithmetic), in vocab order."""
    l = logits / torch.clamp(temps, min=1e-6)[:, None]
    if top_k:
        kth = torch.topk(l, min(top_k, l.shape[-1]), dim=-1).values[..., -1:]
        l = torch.where(l < kth, float("-inf"), l)
    sl, idx = torch.sort(l, dim=-1, descending=True)
    probs = torch.softmax(sl, dim=-1)
    excl = torch.cumsum(probs, dim=-1) - probs
    return torch.empty_like(excl).scatter_(1, idx, excl)


def sample_boundary(torch, what, masked, ref, logits, temps, top_ps, top_k):
    """Hold masked's -inf pattern to ref's except where an entry's
    exclusive prefix mass sits within 1e-4 of top_p: the two sides sum
    the probabilities in different orders (the kernel exactly, in fixed
    point), so the top-p boundary may move by an entry there. Returns the
    count of entries that differ, by row."""
    differ = torch.isneginf(masked) != torch.isneginf(ref)
    if bool(differ.any()):
        mass = prefix_mass(torch, logits, temps, top_k)
        near = (mass - top_ps[:, None]).abs() <= 1e-4
        require(bool((near | ~differ).all()),
                f"{what}: -inf pattern differs away from the top-p boundary")
    return differ.sum(dim=1).tolist()


def sample_phases(torch, FS, logits, temps, top_ps, top_k):
    """Where one A7 launch's time goes, in µs, from the kernel's phase
    stamps (clock64 of thread 0 of row 0's first block, converted at the
    rate %globaltimer gives over the launch): the load, the argmax round,
    each digit's histogram, cluster barrier, group gather and bin gather,
    and the write. The third of three launches."""
    stamps = torch.zeros(64, dtype=torch.int64, device=logits.device)
    for _ in range(3):
        FS.fused_sample_prep(logits, temps, top_ps, top_k, stamps=stamps)
    torch.cuda.synchronize()
    clk, ns = zip(*[p for p in stamps.view(32, 2).tolist() if p[1]])
    ghz = (clk[-1] - clk[0]) / (ns[-1] - ns[0])
    us = [(b - a) / ghz / 1e3 for a, b in zip(clk, clk[1:])]
    digits = us[2:-1]
    return {"load": us[0], "argmax_round": us[1],
            "histogram": digits[0::4], "barrier": digits[1::4],
            "group_gather": digits[2::4], "bin_gather": digits[3::4],
            "write": us[-1], "block_us": sum(us), "clock_ghz": ghz}


def check_fused_sample(torch, FS, dev):
    """A7 at every SAMPLE_CASES shape, top_k 0 and 50, against its plain
    version: argmax exact, the -inf pattern under the top-p boundary rule,
    kept values within 1e-6, a bit-identical rerun, row SAMPLE_SLOT alone
    bit for bit as in its batch, the plan taken, the kernel's device time
    beside the event time, the plain version's and the bound; then the
    crafted rows of `sample_edge_cases`, exact."""
    import numpy as np

    def bits(t):
        return t.view(torch.int32)

    rows = []
    for B, V in SAMPLE_CASES:
        g = torch.Generator(device=dev).manual_seed(2)
        logits = 3 * torch.randn(B, V, generator=g, device=dev)
        temps = torch.tensor([SAMPLE_TEMPS[i % 8] for i in range(B)],
                             device=dev)
        top_ps = torch.tensor([SAMPLE_TOP_PS[i % 8] for i in range(B)],
                              device=dev)
        plan = FS.sample_plan(V)
        for top_k in (0, 50):
            what = f"fused_sample[B={B} V={V} top_k={top_k}]"
            masked, amax = FS.fused_sample_prep(logits, temps, top_ps, top_k)
            ref, ref_amax = FS.fused_sample_prep_plain(logits, temps, top_ps,
                                                       top_k)
            torch.cuda.synchronize()
            require(torch.equal(amax, ref_amax),
                    f"{what}: argmax differs from the plain version")
            by_row = sample_boundary(torch, what, masked, ref, logits, temps,
                                     top_ps, top_k)
            fin = torch.isfinite(ref) & torch.isfinite(masked)
            err = (masked[fin] - ref[fin]).abs().max().item()
            tol = 1e-6   # the same division on both sides
            require(err <= tol, f"{what}: err {err}")
            again, again_amax = FS.fused_sample_prep(logits, temps, top_ps,
                                                     top_k)
            require(torch.equal(bits(again), bits(masked))
                    and torch.equal(again_amax, amax),
                    f"{what}: a rerun differs")
            if B > SAMPLE_SLOT:
                sl = slice(SAMPLE_SLOT, SAMPLE_SLOT + 1)
                alone, alone_amax = FS.fused_sample_prep(
                    logits[sl].contiguous(), temps[sl].contiguous(),
                    top_ps[sl].contiguous(), top_k)
                require(torch.equal(bits(alone[0]), bits(masked[SAMPLE_SLOT]))
                        and int(alone_amax[0]) == int(amax[SAMPLE_SLOT]),
                        f"{what}: row {SAMPLE_SLOT} alone differs from the "
                        "same row in its batch")

            def call():
                return FS.fused_sample_prep(logits, temps, top_ps, top_k)

            ms = cuda_ms(torch, call, 50)
            dev_ms = device_ms(torch, call, 20, ("sample_prep",))
            plain_ms = cuda_ms(torch, lambda: FS.fused_sample_prep_plain(
                logits, temps, top_ps, top_k), 10)
            ph = sample_phases(torch, FS, logits, temps, top_ps, top_k)
            # bytes: logits in, masked out, argmax, temps, top_ps;
            # operations: ~8 an element (a select needs no V log2 V sort)
            b_ms, b_by = bound(2 * B * V * 4 + 3 * B * 4, 8 * B * V,
                               "float32")
            rows.append(dict(case=f"B{B}_V{V}_top_k{top_k}", B=B, V=V,
                             top_k=top_k, plan=plan._asdict(),
                             max_abs_err=err, tolerance=tol,
                             boundary_entries=sum(by_row),
                             boundary_entries_by_row=by_row, ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             phases_us=ph))
            where = ("resident" if plan.resident
                     else f"streamed in {plan.tile}-float tiles")
            print(f"[kernel] {what} plan: clusters of {plan.cluster}, "
                  f"{plan.slice} floats a block, {where}; err={err:.3g} "
                  f"(argmax exact; {sum(by_row)} entries differ at the "
                  f"top-p boundary; rerun and row {SAMPLE_SLOT} alone bit "
                  f"for bit) device={dev_ms:.4f} ms kernel={ms:.4f} ms "
                  f"plain={plain_ms:.4f} ms bound={b_ms:.4f} ms ({b_by})")
            r1 = [round(x, 2) for x in ph["histogram"]]
            print(f"[kernel] {what} phases of row 0's first block, us "
                  f"(at {ph['clock_ghz']:.2f} GHz): load {ph['load']:.2f}, "
                  f"argmax round {ph['argmax_round']:.2f}, by digit: "
                  f"histogram {r1}, barrier "
                  f"{[round(x, 2) for x in ph['barrier']]}, group gather "
                  f"{[round(x, 2) for x in ph['group_gather']]}, bin gather "
                  f"{[round(x, 2) for x in ph['bin_gather']]}; write "
                  f"{ph['write']:.2f}; {ph['block_us']:.2f} in all")
    for name, lg, tp, pp, top_k in sample_edge_cases(np):
        logits, temps, top_ps = (torch.from_numpy(a).to(dev)
                                 for a in (lg, tp, pp))
        masked, amax = FS.fused_sample_prep(logits, temps, top_ps, top_k)
        ref, ref_amax = FS.fused_sample_prep_plain(logits, temps, top_ps,
                                                   top_k)
        again, _ = FS.fused_sample_prep(logits, temps, top_ps, top_k)
        torch.cuda.synchronize()
        fin = torch.isfinite(ref)
        require(torch.equal(amax, ref_amax)
                and torch.equal(torch.isneginf(masked), torch.isneginf(ref))
                and torch.equal(bits(masked[fin]), bits(ref[fin]))
                and torch.equal(bits(again), bits(masked)),
                f"fused_sample edge rows {name}: differ from the plain "
                "version or between reruns")
    print(f"[kernel] fused_sample edge rows at V={SAMPLE_EDGE_V} "
          f"({', '.join(c[0] for c in sample_edge_cases(np))}): argmax, "
          "-inf pattern and kept bits exact, reruns bit for bit")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the engine at LLaMA-7B width
# ---------------------------------------------------------------------------

def init_llama7b(torch, L, dev):
    """LLaMA-7B at full width and depth, seeded random bf16 weights on the
    card: the bf16 engine serves them and the quantized engines quantize
    them in turn."""
    cfg = L.CONFIGS["llama-7b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, L.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)


def serve_llama7b(torch, np, C, L, Engine, dev, cfg, params):
    """The bf16 engine: A5 (fp pages), A3 and A7 on every tick."""
    t0 = time.perf_counter()
    eng = Engine(cfg, params, block_size=16, max_batch=8, token_budget=64,
                 max_len=2048, device=dev)
    torch.cuda.synchronize()
    print(f"[engine] llama-7b bf16, {cfg.num_layers} layers, "
          f"{cfg.num_params() / 1e9:.2f} B params, {eng.num_blocks} KV "
          f"blocks, set up in {time.perf_counter() - t0:.1f} s")
    encoded = C.fused_ffn.KERNEL.fn("fused_ffn_maps_encoded")
    enc0 = encoded()
    per_tick = {"paged_attention": cfg.num_layers,
                "fused_ffn": cfg.num_layers, "fused_sample": 1}
    kw = dict(paths={"paged_attention": "mma"},
              names=("paged_attention", "sample_prep"))
    launches = drive_engine(torch, np, C, eng, "ENGINE", per_tick, **kw)[0]
    # A3 takes six TMA tensor maps a launch, from a cache keyed by address
    # and shape; these are the ones it had to encode on the host
    n_enc, n_a3 = encoded() - enc0, C.fused_ffn.KERNEL.launches
    print(f"[engine] A3 encoded {n_enc} tensor maps over {n_a3} launches "
          f"({6 * n_a3} maps; {n_enc / n_a3:.3f} encoded a launch, the rest "
          f"from its cache)")
    _, *eager = drive_engine(torch, np, C, eng, "ENGINE_EAGER", per_tick,
                             eager=True, **kw)
    _, *warm = drive_engine(torch, np, C, eng, "ENGINE_WARM", per_tick, **kw)
    compare_capture("ENGINE", warm, eager)
    return launches


CALIB_BATCHES = 2


def calibrate_w8(np, Q, cfg, params):
    """The quantized phases' manifest, calibrated on the card over
    CALIB_BATCHES seeded batches of 256 tokens."""
    rs = np.random.RandomState(4)
    batches = [rs.randint(0, cfg.vocab_size, (1, 256))
               for _ in range(CALIB_BATCHES)]
    return Q.calibrate(cfg, params, batches)


# the quantized engines, in turn on one set of bf16 weights: (tag,
# quant_mode, quant_kv)
QUANT_ENGINES = (("ENGINE_W8", "w8", True), ("ENGINE_W8A8", "w8a8", True),
                 ("ENGINE_FP8", "fp8", False))


def serve_llama7b_quant(torch, np, C, L, Q, Engine, dev, cfg, params):
    """The quantized engines on LLaMA-7B's bf16 weights, one after the
    other (each freed before the next), with one manifest calibrated on
    the card: w8 weights and int8 KV pages (A5 int8, A6 and A7 on every
    tick), w8a8 with int8 KV pages (A5 int8 and A7; the FFN and every
    product on the int8 product `Q.int8_matmul`, A3 and A6 never), fp8
    weights with bf16 pages (A5 and A7; the FFN a plain chain). Returns
    {"serving_<mode>": launches}."""
    t1 = time.perf_counter()
    manifest = calibrate_w8(np, Q, cfg, params)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t1
    kab = np.asarray(manifest.kv_scales["k"])
    vab = np.asarray(manifest.kv_scales["v"])
    require(kab.shape == (cfg.num_layers, cfg.num_kv_heads)
            and np.all(np.isfinite(kab)) and np.all(kab > 0)
            and np.all(np.isfinite(vab)) and np.all(vab > 0),
            "calibrated KV scales are not finite and positive")
    print(f"[engine-quant] manifest calibrated over {CALIB_BATCHES} x 256 "
          f"tokens in {t_cal:.1f} s (k absmax {kab.min():.3g}.."
          f"{kab.max():.3g}, v {vab.min():.3g}..{vab.max():.3g})")
    paths = {}
    for tag, mode, kv in QUANT_ENGINES:
        t0 = time.perf_counter()
        eng = Engine(cfg, params, block_size=16, max_batch=8,
                     token_budget=64, max_len=2048, quant_mode=mode,
                     quant_kv=kv, quant_manifest=manifest, device=dev)
        torch.cuda.synchronize()
        label = tag.lower().replace("_", "-")
        blocks = eng.params["blocks"]
        qtype = torch.float8_e4m3fn if mode == "fp8" else torch.int8
        require(all(blocks[f"{n}_q"].dtype == qtype
                    and blocks[f"{n}_s"].dtype == torch.float32
                    and ((f"{n}_a" in blocks) == (mode == "w8a8"))
                    for n in Q.WEIGHT_NAMES) and not any(
                        n in blocks for n in Q.WEIGHT_NAMES),
                f"{tag}: the engine's block leaves are not {mode}'s")
        wbytes = sum(t.numel() * t.element_size() for n, t in blocks.items()
                     if n.endswith(("_q", "_s", "_a")))
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in (eng._key_cache, eng._value_cache,
                                 *eng._kv_dequant))
        print(f"[{label}] llama-7b {mode} weights, "
              f"{'int8' if kv else 'bf16'} KV pages, {cfg.num_layers} "
              f"layers: block weights {wbytes / 1e9:.2f} GB with scales, "
              f"{eng.num_blocks} KV blocks {kv_bytes / 1e9:.2f} GB; set up "
              f"in {time.perf_counter() - t0:.1f} s")
        attn = "paged_attention_int8" if kv else "paged_attention"
        per_tick = {attn: cfg.num_layers, "fused_sample": 1}
        kw = dict(paths={attn: "mma"},
                  names=("paged_attention", "sample_prep"))
        if mode == "w8":
            per_tick["fused_ffn_w8"] = cfg.num_layers
            kw["paths"]["fused_ffn_w8"] = "wgmma"
            kw["names"] += ("w8_",)
        else:
            kw["families"] = quant_products(torch, Q, eng, mode, label)
        paths[f"serving_{mode}"] = drive_engine(torch, np, C, eng, tag,
                                                per_tick, **kw)[0]
        # no eager pass for these engines (its time went to phases
        # 8c-8f); the replay is still held to the eager tick bit for bit
        # inside each profile (`profile_decode`)
        drive_engine(torch, np, C, eng, f"{tag}_WARM", per_tick, **kw)
        del eng, blocks
        torch.cuda.empty_cache()
    return paths


# the products' kernels by name: cuBLASLt's int8 kernels (CUTLASS
# "i16832gemm_s8" on the H100) and cuBLAS's bf16 ones
GEMM_NAMES = {"int8_gemm": ("gemm_s8",),
              "bf16_gemm": ("nvjet", "gemm", "gemv")}


def quant_products(torch, Q, eng, mode, label):
    """The w8a8 and fp8 products outside any kernel, at the engine tick's
    row count (token_budget) on layer 0's w1 leaves (hidden 4,096 ->
    d_ff 11,008): each part's event time and device time alone, and the
    names of its kernels (torch.profiler), which the tick's profile sums
    by part (a name another op of the tick shares counts there too, as
    the calls a tick show: 225 products a tick at 32 layers). w8a8
    also holds the int8 product exact and row-independent: the card's
    sums equal the CPU's, rows 1-16 (padded to 17) and 17 equal the same
    rows inside 64, and its time with the weight column-major (as
    stored) beside row-major. fp8 holds the card's float8 -> bf16 cast
    of the weight equal to the CPU's, bit for bit. Returns {part: (kernel
    names, name parts)}: a tick's kernel belongs to a part if its name is
    one of the first or holds one of the second (`GEMM_NAMES`)."""
    from torch.profiler import ProfilerActivity, profile
    lp = eng._layers[0]
    wq, s = lp["w1_q"], lp["w1_s"]
    K, N = wq.shape
    R = eng.token_budget
    gen = torch.Generator(device=wq.device).manual_seed(5)
    h = torch.randn((R, K), generator=gen, device=wq.device,
                    dtype=torch.float32).to(torch.bfloat16)
    if mode == "w8a8":
        a = lp["w1_a"]
        xq = Q.quantize_act(h, a)
        acc = Q.int8_matmul(xq, wq)
        require(torch.equal(acc.cpu(), torch._int_mm(xq.cpu(),
                                                     wq.cpu().contiguous())),
                f"[{label}] the card's int8 sums differ from the CPU's")
        for r in (1, 8, 16, 17):
            require(torch.equal(Q.int8_matmul(xq[:r].contiguous(), wq),
                                acc[:r]),
                    f"[{label}] int8 rows at {r} rows differ from the same "
                    f"rows at {R}")
        row_major = wq.contiguous()
        parts = {
            "act_round": lambda: Q.quantize_act(h, a),
            "int8_gemm": lambda: Q.int8_matmul(xq, wq),
            "rescale": lambda: (acc.float() * ((a * s) / (Q.QMAX * Q.QMAX))
                                ).to(torch.bfloat16)}
        extra = {"int8_gemm_row_major_ms": cuda_ms(
            torch, lambda: torch._int_mm(xq, row_major), 20)}
        print(f"[{label}] int8 product: the card's sums equal the CPU's; "
              f"rows 1, 8, 16 (padded to 17) and 17 equal the same rows at "
              f"{R}")
    else:
        wbf = wq.to(torch.bfloat16)
        require(torch.equal(wbf.cpu(), wq.cpu().to(torch.bfloat16)),
                f"[{label}] the card's float8 -> bf16 cast differs from "
                f"the CPU's")
        accb = h @ wbf
        parts = {"fp8_cast": lambda: wq.to(torch.bfloat16),
                 "bf16_gemm": lambda: h @ wbf,
                 "rescale": lambda: accb * (s / Q.FP8_MAX).to(torch.bfloat16)}
        extra = {}
        print(f"[{label}] the card's float8 -> bf16 weight cast equals the "
              f"CPU's, bit for bit")
    times = {f"{p}_ms": cuda_ms(torch, fn, 20) for p, fn in parts.items()}
    times.update(extra)
    families = {}
    for p, fn in parts.items():
        keys = set()
        for _ in range(3):       # the profiler may drop a window's records
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            keys |= {e.key for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0}
        # each kernel's mean device time, summed: the part's device time
        times[f"{p}_device_ms"] = device_ms(torch, fn, 5, sorted(keys))
        # the library's products pick a kernel by shape: in the tick they
        # are known by name (the profiler can miss them in a short window)
        families[p] = (keys, GEMM_NAMES.get(p, ()))
    out = {"rows": R, "k": K, "n": N, **times,
           "kernels": {p: [k[:100] for k in keys]
                       for p, (keys, _) in families.items()}}
    print(f"[{label}] one product at {R} x {K} x {N}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    print(f"{label.upper().replace('-', '_')}_PRODUCT " + json.dumps(out))
    return families


def drive_engine(torch, np, C, eng, tag, per_tick, paths=None, names=(),
                 eager=False, families=None):
    """Serve the phase's traffic — 8 requests at once, prompts seeded in
    64..512 tokens, 32 new tokens each, half greedy and half sampled —
    with every launch count set to 0 just before. Each kernel in
    `per_tick` must have launched that many times a tick (decode ticks
    replay the engine's captured graph, counted at replay), every other
    kernel not at all; each kernel in `paths` must have taken that path
    every time. Prints tokens/s, TTFT and TPOT p50 and peak memory, then
    profiles decode ticks of a fresh batch (kernels whose names hold one
    of `names` listed by name, and the kernels of each part of
    `families`, summed). `eager` runs the decode ticks through the
    function the graph captures instead, for the comparison. A second run
    on one engine finds every prompt in its prefix cache. Returns
    (launches, the run's metrics, the profile's)."""
    if eager:                        # shadow the replay, for this run only
        eng._replay_decode = eng._decode_tick
    cfg = eng.cfg
    rs = np.random.RandomState(0)
    lens = rs.randint(64, 513, 8)
    stats0 = dict(eng.stats)         # the engine may have served before
    torch.cuda.reset_peak_memory_stats()
    for k in C.KERNELS:          # count only the main path's launches
        k.reset()
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
    by_path = {k.name: dict(k.paths) for k in C.KERNELS if k.paths}
    for name, path in (paths or {}).items():
        require(by_path.get(name) == {path: launches[name]},
                f"{tag}: {name} launches by path {by_path.get(name)}, "
                f"expected all {launches[name]} on {path}")
    done = {c.rid: c for c in eng.run()}
    require(sorted(done) == sorted(rids), f"{tag}: not every request "
            "completed")
    require(all(len(done[r].output_tokens) == 32 for r in rids),
            f"{tag}: a request ended short of 32 tokens")
    stats = {k: v - stats0[k] for k, v in eng.stats.items()}
    require(ticks == stats["steps"], "ticks and engine steps disagree")
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
           "ticks": ticks, "decode_ticks": stats["decode_fast_steps"],
           "mixed_ticks": stats["mixed_steps"], "wall_s": wall,
           "tokens_per_s": gen_tokens / wall,
           "ttft_p50_s": float(np.median(ttft)),
           "tpot_p50_s": float(np.median(tpot)),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_by_path": by_path}
    label = tag.lower().replace("_", "-")
    print(f"[{label}] {out['requests']} requests, {gen_tokens} tokens in "
          f"{wall:.2f} s over {ticks} ticks ({out['decode_ticks']} decode, "
          f"{out['mixed_ticks']} mixed): {out['tokens_per_s']:.1f} tok/s, "
          f"TTFT p50 {out['ttft_p50_s']:.3f} s, TPOT p50 "
          f"{out['tpot_p50_s'] * 1e3:.2f} ms, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    print(f"[{label}] launches {launches} (expected {expect}); by path "
          f"{by_path}")
    print(f"{tag} " + json.dumps(out))
    prof = profile_decode(torch, np, eng, tag.replace("ENGINE", "PROFILE"),
                          names, check_replay=not eager, families=families)
    if eager:
        del eng._replay_decode
    return launches, out, prof


def compare_capture(tag, captured, eager):
    """Print a captured engine run beside the eager one (the same traffic,
    both on a warm prefix cache): TPOT p50, tokens/s, the profiled decode
    tick's host time and busy share."""
    (out_g, prof_g), (out_e, prof_e) = captured, eager
    row = {"tpot_p50_ms": [out_g["tpot_p50_s"] * 1e3,
                           out_e["tpot_p50_s"] * 1e3],
           "tokens_per_s": [out_g["tokens_per_s"], out_e["tokens_per_s"]],
           "decode_tick_ms": [prof_g["tick_ms"], prof_e["tick_ms"]],
           "device_ms_per_tick": [prof_g["device_ms_per_tick"],
                                  prof_e["device_ms_per_tick"]],
           "device_busy_share": [prof_g["device_busy_share"],
                                 prof_e["device_busy_share"]]}
    print(f"[{tag.lower()}] captured / eager decode tick: TPOT p50 "
          f"{row['tpot_p50_ms'][0]:.2f} / {row['tpot_p50_ms'][1]:.2f} ms, "
          f"{row['tokens_per_s'][0]:.1f} / {row['tokens_per_s'][1]:.1f} "
          f"tok/s, tick {row['decode_tick_ms'][0]:.2f} / "
          f"{row['decode_tick_ms'][1]:.2f} ms, busy "
          f"{row['device_ms_per_tick'][0]:.2f} / "
          f"{row['device_ms_per_tick'][1]:.2f} ms a tick")
    print(f"{tag}_CAPTURE " + json.dumps(row))


def profile_decode(torch, np, eng, tag, names=(), ticks=5,
                   check_replay=False, families=None):
    """Where a decode tick's time goes: a fresh batch of 8 requests is
    prefilled, then `ticks` all-decode ticks run on the host clock (ended
    by a synchronize) and `ticks` more under torch.profiler. Prints
    device time by kernel (and, by name, the kernels whose names hold one
    of `names`; for each part of `families`, {part: (kernel names, name
    parts)} as `quant_products` gives them, its kernels' time and calls a
    tick, where a kernel another op of the tick shares counts too) and
    the device's busy share of a tick. `check_replay`:
    the last tick's inputs, replayed through the captured graph and run
    through the eager function it holds, must give the same logits,
    masked logits and tokens, bit for bit (the tick's page writes repeat
    the same values)."""
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
    if check_replay:
        replayed = [t.clone() for t in eng._dec_graph.replay()]
        eager = eng._decode_tick()
        require(all(torch.equal(a, b) for a, b in zip(replayed, eager)),
                f"{tag}: the captured decode tick differs from the eager "
                f"tick on the same inputs")
        print(f"[profile] {tag}: a replayed decode tick's logits, masked "
              f"logits and tokens equal the eager tick's, bit for bit")
    eng.run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    def row(e):
        return {"kernel": e.key[:80], "ms_per_tick":
                e.self_device_time_total / 1e3 / ticks,
                "calls_per_tick": e.count / ticks}

    out = {"ticks": ticks, "tick_ms": tick_ms,
           "tick_ms_under_profiler": profiled_ms,
           "device_ms_per_tick": busy,
           "device_busy_share": busy / tick_ms if busy else None,
           "top": [row(e) for e in sorted(kernels, key=lambda e:
                                          -e.self_device_time_total)[:10]],
           "named": [row(e) for e in kernels
                     if any(n in e.key for n in names)]}
    for part, (keys, parts) in (families or {}).items():
        mine = [e for e in kernels
                if e.key in keys or any(p in e.key for p in parts)]
        out.setdefault("parts", {})[part] = {
            "ms_per_tick": sum(e.self_device_time_total
                               for e in mine) / 1e3 / ticks,
            "calls_per_tick": sum(e.count for e in mine) / ticks}
    if not busy:
        print("[profile] torch.profiler saw no device time; busy share not "
              "measured")
    for part, r in out.get("parts", {}).items():
        print(f"[profile]   {part}: {r['ms_per_tick']:.3f} ms/tick "
              f"x{r['calls_per_tick']:.0f}")
    print(f"[profile] {tag}: decode tick {tick_ms:.2f} ms ({profiled_ms:.2f} "
          f"ms under the profiler); device busy {busy:.2f} ms per tick")
    for t in out["top"]:
        print(f"[profile]   {t['ms_per_tick']:.3f} ms/tick "
              f"x{t['calls_per_tick']:.0f} {t['kernel']}")
    for t in out["named"]:
        print(f"[profile]   by name: {t['ms_per_tick']:.3f} ms/tick "
              f"x{t['calls_per_tick']:.0f} {t['kernel']}")
    print(f"{tag} " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 4a: the fleet — rows independent of the tick's shape, LoRA
# adapters, speculative decoding, the router through a replica kill
# ---------------------------------------------------------------------------

FLEET_GEOM = dict(block_size=16, max_batch=8, token_budget=64, max_len=2048)
# phases 4a and 4c run LLaMA-7B width at this depth (of 32): with the
# quantized engines of PR 15 the script passed its 300 s budget
FLEET_LAYERS = 16


def fleet_model(torch, L, dev):
    """LLaMA-7B width at FLEET_LAYERS layers, seeded bf16 weights."""
    import dataclasses
    cfg = dataclasses.replace(L.CONFIGS["llama-7b"], num_layers=FLEET_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, L.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
TENANTS = (None, "tenant-a", "tenant-b")     # in turn over the trace
ROUTER_CHAOS = "replica:kill@victim=0;call=5"     # bench.py:676


def launch_counts(C):
    return {k.name: k.launches for k in C.KERNELS}


def standard_trace(np, cfg, greedy=False):
    """The engine phases' traffic (`drive_engine`): 8 requests, prompts
    seeded in 64..512 tokens, half sampled (all greedy with `greedy`)."""
    rs = np.random.RandomState(0)
    lens = rs.randint(64, 513, 8)
    out = []
    for i, n in enumerate(lens):
        kw = ({} if greedy or i % 2 == 0
              else dict(temperature=0.8, top_p=0.9, seed=i))
        out.append((rs.randint(0, cfg.vocab_size, n).tolist(), kw))
    return out


def serve_trace(torch, eng, trace, tenants=None, max_new=32):
    """Serve `trace` to the end; (streams, wall seconds, ticks)."""
    rids = [eng.submit(p, max_new_tokens=max_new, **kw,
                       **({"adapter": tenants[i]}
                          if tenants and tenants[i] else {}))
            for i, (p, kw) in enumerate(trace)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = 0
    while eng.has_work():
        eng.step()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {c.rid: c for c in eng.run()}
    require(sorted(done) == sorted(rids), "a request did not complete")
    return [done[r].output_tokens for r in rids], wall, ticks


def decode_tick_ms(torch, np, eng, tenants=None, ticks=10):
    """Host ms of a captured decode tick with 8 live rows (256-token
    prompts, `tenants` in turn), after every row reached decode."""
    rs = np.random.RandomState(2)
    for i in range(eng.max_batch):
        t = tenants[i % len(tenants)] if tenants else None
        eng.submit(rs.randint(0, eng.cfg.vocab_size, 256).tolist(),
                   max_new_tokens=2 * ticks + 4,
                   **({"adapter": t} if t else {}))
    while any(s.num_computed < len(s.tokens) - 1
              for s in eng.scheduler.running + list(eng.scheduler.waiting)):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / ticks
    eng.run()
    return ms


class OracleDraft:
    """A draft that proposes what plain greedy decode gave (`streams`:
    rid -> generated tokens), so every verify row is kept: the INVARIANCE
    phase's way to put known tokens into verify chunks. The engine calls
    only these methods of a draft."""

    def __init__(self, streams):
        self.streams = streams
        self.stats = {"proposed": 0, "accepted": 0}

    def propose(self, seq, k):
        g = len(seq.generated)
        return list(self.streams[seq.rid][g:g + k])

    def commit(self, seq, accepted):
        pass

    def record_tick(self, proposed, accepted):
        self.stats["proposed"] += proposed
        self.stats["accepted"] += accepted

    def forget(self, rid):
        pass

    def copy_blocks(self, pairs):
        pass

    @property
    def acceptance_rate(self):
        return self.stats["accepted"] / max(1, self.stats["proposed"])


def step_rows(eng, rid):
    """One engine tick; the logits rows it gave `rid`'s generated
    positions, as [(generated index, f32 row, tick kind)]. A row at
    position q predicts generated index q + 1 - (prompt length); a plain
    tick keeps each slot's last row, a speculative tick every row."""
    seq = eng.scheduler.get(rid)
    live = seq is not None and seq.status != "finished"
    nc, nt, g = ((seq.num_computed, len(seq.tokens), len(seq.generated))
                 if live else (0, 0, 0))
    fast = eng.stats["decode_fast_steps"]
    eng.step()
    if not live or rid not in eng.last_rids:
        return []
    i = eng.last_rids.index(rid)
    cu, P = eng.last_cu, nt - g
    n = int(cu[i + 1] - cu[i])
    if eng.last_all_logits is not None:      # a speculative tick
        kind = "verify" if n > 1 and nc == nt - 1 else "spec-mixed"
        return [(nc + m + 1 - P,
                 eng.last_all_logits[int(cu[i]) + m].clone(), kind)
                for m in range(n) if nc + m >= P - 1]
    if nc + n != nt:
        return []                            # mid-prompt: no token yet
    kind = "decode" if eng.stats["decode_fast_steps"] > fast else "mixed"
    return [(g, eng.last_logits[i].clone(), kind)]


def product_rows_gap(torch, L, dev, T=64, B=8):
    """What the engine's one row count guards against: the tick's
    products (q/k/v/o at 4,096 x 4,096, the lm_head at 4,096 x 32,000,
    bf16 on cuBLAS) and its rms_norm with B live rows against the same
    rows inside T; returns how many of the B rows differ in any bit."""
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn(T, 4096, generator=g, device=dev).to(torch.bfloat16)
    ops = {"rms_norm": lambda x: L.rms_norm(x, torch.ones(4096, device=dev),
                                            1e-6)}
    for name, n in (("qkvo", 4096), ("lm_head", 32000)):
        w = (torch.randn(4096, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        ops[name] = lambda x, w=w: x @ w
    out = {}
    for name, op in ops.items():
        small, full = op(h[:B]), op(h)
        out[name] = sum(not torch.equal(small[i], full[i])
                        for i in range(B))
    return out


def invariance(torch, np, L, Engine, cfg, params, dev, prompt_len=240,
               new=40):
    """One request's logits rows, bit for bit, wherever they are
    computed: run A, the request alone (its decode rows in captured
    decode ticks); run B, first among 8 (its decode rows beside prefill
    chunks in mixed ticks, then beside 7 decode rows); run C, alone with
    an oracle draft (`OracleDraft`, spec_k 3), its rows in verify chunks
    of 4 across the 256-position span boundary. Every row of B and C
    must equal A's row of the same generated position."""
    eng = Engine(cfg, params, device=dev, **FLEET_GEOM)
    rs = np.random.RandomState(7)
    prompt = rs.randint(0, cfg.vocab_size, prompt_len).tolist()
    others = [rs.randint(0, cfg.vocab_size, 200).tolist() for _ in range(7)]

    def run(extra=(), spec=None):
        eng.spec, eng.spec_k = (spec, 3) if spec else (None, 0)
        rid = eng.submit(prompt, max_new_tokens=new)
        for p in extra:
            eng.submit(p, max_new_tokens=new)
        rows = []
        while eng.has_work():
            rows += step_rows(eng, rid)
        toks = {c.rid: c.output_tokens for c in eng.run()}[rid]
        return rid, toks, rows

    _, toks_a, rows_a = run()
    ref = {g: r for g, r, _ in rows_a}
    require(sorted(ref) == list(range(new)), f"INVARIANCE: run A gave "
            f"rows {sorted(ref)}")
    _, toks_b, rows_b = run(others)
    rid_c = eng._next_rid
    _, toks_c, rows_c = run(spec=OracleDraft({rid_c: toks_a}))
    eng.spec, eng.spec_k = None, 0
    kinds, bad = {}, []
    for tag, rows in (("B", rows_b), ("C", rows_c)):
        for g, row, kind in rows:
            key = f"{tag}:{kind}"
            kinds[key] = kinds.get(key, 0) + 1
            if not torch.equal(row, ref[g]):
                bad.append((tag, kind, g))
    require(toks_b == toks_a and toks_c == toks_a,
            "INVARIANCE: the request's tokens differ between runs")
    require(not bad, f"INVARIANCE: logits rows differ from the request "
            f"alone in a decode tick: {bad[:8]} ({len(bad)} rows)")
    require(kinds.get("B:mixed", 0) > 0 and kinds.get("B:decode", 0) > 0
            and kinds.get("C:verify", 0) > 0,
            f"INVARIANCE: not every tick kind was compared: {kinds}")
    span = 256
    verify_pos = [prompt_len + g - 1 for g, _, k in rows_c if k == "verify"]
    out = {"rows_compared": sum(kinds.values()), "by_kind": kinds,
           "reference_rows": {k: sum(1 for *_, kk in rows_a if kk == k)
                              for k in ("mixed", "decode")},
           "verify_positions": [min(verify_pos), max(verify_pos)],
           "verify_rows_past_span": sum(p >= span for p in verify_pos),
           "graph_captures": eng.stats["graph_captures"],
           "rows_differing_at_8_vs_64": product_rows_gap(torch, L, dev)}
    print(f"[invariance] {out['rows_compared']} logits rows bit-equal to "
          f"the request alone in decode ticks: {kinds}; verify rows at "
          f"positions {out['verify_positions'][0]}..{out['verify_positions'][1]} "
          f"({out['verify_rows_past_span']} past the {span}-position span)")
    print(f"[invariance] without the one row count: rows at M = 8 against "
          f"the same rows in M = 64 differ in "
          f"{out['rows_differing_at_8_vs_64']} of 8")
    print("INVARIANCE " + json.dumps(out))
    del eng
    return out


def adapters_phase(torch, np, C, Engine, S, cfg, params, dev, base_out):
    """The standard trace with tenants [None, a, b] in turn (2 slots,
    rank 4, alpha 8, scale 0.3: `bench.py:888-892`): base rows equal the
    adapter-free engine's streams (`base_out`), adapter rows differ; a
    repeat gives the same streams with no new capture; A5 and A3 once a
    layer and A7 once a tick. Returns the first run's launches."""
    eng = Engine(cfg, params, device=dev, adapter_slots=2, **FLEET_GEOM)
    ads = [S.make_adapter(cfg, name, rank=4, alpha=8.0, seed=seed,
                          scale=0.3)
           for name, seed in (("tenant-a", 3), ("tenant-b", 4))]
    for a in ads:
        eng.adapters.register(a)
    trace = standard_trace(np, cfg)
    tenants = [TENANTS[i % 3] for i in range(len(trace))]
    for k in C.KERNELS:
        k.reset()
    out1, wall, ticks = serve_trace(torch, eng, trace, tenants)
    launches = launch_counts(C)
    per_tick = {"paged_attention": cfg.num_layers,
                "fused_ffn": cfg.num_layers, "fused_sample": 1}
    expect = {k.name: per_tick.get(k.name, 0) * ticks for k in C.KERNELS}
    require(launches == expect, f"ADAPTERS: launches {launches} != "
            f"{expect}")
    captures = eng.stats["graph_captures"]
    out2, wall2, _ = serve_trace(torch, eng, trace, tenants)
    require(out2 == out1 and eng.stats["graph_captures"] == captures,
            "ADAPTERS: the repeat changed a stream or captured again")
    for i, t in enumerate(tenants):
        require((out1[i] == base_out[i]) == (t is None),
                f"ADAPTERS: row {i} (adapter {t}) "
                f"{'differs from' if t is None else 'equals'} the "
                f"adapter-free engine's stream")
    ms_ad = decode_tick_ms(torch, np, eng, TENANTS)
    ms_base = decode_tick_ms(torch, np, eng)
    mgr = eng.adapters
    out = {"requests": len(trace), "tenants": tenants, "ticks": ticks,
           "tokens_per_s": sum(map(len, out1)) / wall,
           "tokens_per_s_repeat": sum(map(len, out2)) / wall2,
           "decode_tick_ms": ms_ad, "decode_tick_ms_adapter_free": ms_base,
           "graph_captures": eng.stats["graph_captures"],
           "adapter_bytes": mgr.bytes_total(),
           "adapter_bytes_host": sum(a.nbytes for a in ads),
           **{k: mgr.stats[k] for k in ("loads", "hits", "swaps",
                                        "evictions")},
           "launches": launches}
    print(f"[adapters] base rows equal the adapter-free engine's, adapter "
          f"rows differ; repeat identical, {captures} captures; decode "
          f"tick {ms_ad:.2f} ms with adapters, {ms_base:.2f} ms without; "
          f"packs {out['adapter_bytes'] / 1e6:.1f} MB on the card; loads "
          f"{mgr.stats['loads']}, hits {mgr.stats['hits']}, swaps "
          f"{mgr.stats['swaps']}")
    print("ADAPTERS " + json.dumps(out))
    del eng
    return launches


def spec_phase(torch, np, C, Engine, S, cfg, params, dev, layers=16):
    """The target with a draft of its first `layers` layers, sharing its
    tensors (`bench.py:796-803`), spec_k 3, over the standard trace,
    greedy: the streams equal the same engine's plain greedy streams,
    acceptance above 0. Returns (verify launches, draft launches)."""
    import dataclasses
    dcfg = dataclasses.replace(cfg, num_layers=layers)
    draft = S.DraftModel(dcfg, {
        "embed": params["embed"], "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
        "blocks": {k: v[:layers] for k, v in params["blocks"].items()}})
    eng = Engine(cfg, params, device=dev, draft=draft, spec_k=3,
                 **FLEET_GEOM)
    require(eng.spec.params["blocks"]["wq"].data_ptr()
            == params["blocks"]["wq"].data_ptr(),
            "SPEC: the draft copied the target's weights")
    trace = standard_trace(np, cfg, greedy=True)
    eng.spec_k = 0
    plain, wall_p, ticks_p = serve_trace(torch, eng, trace)
    drafted = dict.fromkeys(launch_counts(C), 0)
    propose = eng.spec.propose

    def counted(seq, k):
        before = launch_counts(C)
        props = propose(seq, k)
        for n, v in launch_counts(C).items():
            drafted[n] += v - before[n]
        return props

    eng.spec.propose = counted
    eng.spec_k = 3
    for k in C.KERNELS:
        k.reset()
    spec, wall_s, ticks_s = serve_trace(torch, eng, trace)
    total = launch_counts(C)
    verify = {n: total[n] - drafted[n] for n in total}
    require(spec == plain, "SPEC: speculative streams differ from plain "
            "greedy decode")
    st, ds = eng.stats, eng.spec.stats
    require(st["spec_ticks"] > 0 and ds["accepted"] > 0,
            f"SPEC: acceptance {eng.spec.acceptance_rate}")
    n_tok = sum(map(len, spec))
    out = {"draft_layers": layers, "spec_k": 3, "ticks": ticks_s,
           "ticks_plain": ticks_p, "spec_ticks": st["spec_ticks"],
           "proposed": st["spec_proposed"], "accepted": st["spec_accepted"],
           "acceptance_rate": eng.spec.acceptance_rate,
           "tokens_per_s": n_tok / wall_s,
           "tokens_per_s_plain": sum(map(len, plain)) / wall_p,
           "ms_per_proposal": ds["propose_s"] * 1e3 / ds["proposals"],
           "catchup_tokens": ds["catchup_tokens"],
           "launches_verify": verify, "launches_draft": drafted}
    print(f"[spec] streams equal plain greedy; {st['spec_ticks']} spec "
          f"rows, {st['spec_proposed']} proposed, {st['spec_accepted']} "
          f"accepted ({eng.spec.acceptance_rate:.3f}); "
          f"{out['tokens_per_s']:.1f} tok/s against "
          f"{out['tokens_per_s_plain']:.1f} plain; "
          f"{out['ms_per_proposal']:.2f} ms a draft proposal")
    print("SPEC " + json.dumps(out))
    del eng
    return verify, drafted


def router_phase(torch, np, C, Engine, S, cfg, params, dev, base_out):
    """Two replicas on the card, one set of device weights, the standard
    trace, chaos `ROUTER_CHAOS`: every stream equal to one engine's
    (`base_out`), none dropped, no mismatch, at least one failover, the
    survivor's decode graph captured once. Returns the launches."""
    from paddle_tpu_torch.distributed.fault_tolerance import chaos

    def factory():
        return Engine(cfg, params, device=dev, **FLEET_GEOM)

    trace = standard_trace(np, cfg)
    for k in C.KERNELS:
        k.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chaos.reconfigure(ROUTER_CHAOS)
    try:
        t0 = time.perf_counter()
        router = S.ServingRouter(factory, num_replicas=2, probation_s=1e9,
                                 tenant_weights={"default": len(trace)})
        rids = [router.submit(p, max_new_tokens=32, **kw)
                for p, kw in trace]
        done = {c.rid: c for c in router.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fired = [i.fired for i in chaos.injections()]
    finally:
        chaos.reconfigure("")
    launches = launch_counts(C)
    outs = [done[r].output_tokens if r in done else None for r in rids]
    dropped = sum(1 for r in rids
                  if r not in done or done[r].finish_reason != "length")
    survivor = router.replicas[1].engine
    st = router.stats
    confirmed = sum(router._reqs[r].confirm_target for r in rids)
    require(fired == [1], f"ROUTER: the kill fired {fired}")
    require(dropped == 0 and st["mismatches"] == 0 and st["failovers"] >= 1,
            f"ROUTER: dropped {dropped}, stats {st}")
    require(outs == base_out, "ROUTER: a stream differs from the single "
            "engine's")
    require(survivor.stats["graph_captures"] == 1,
            f"ROUTER: the survivor captured "
            f"{survivor.stats['graph_captures']} graphs")
    out = {"requests": len(rids), "chaos": ROUTER_CHAOS,
           "failovers": st["failovers"], "mismatches": st["mismatches"],
           "dropped": dropped, "replayed_tokens_confirmed": confirmed,
           "survivor_graph_captures": survivor.stats["graph_captures"],
           "drill_tokens_per_s": sum(map(len, outs)) / wall,
           "wall_s": wall,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    print(f"[router] 2 replicas, {ROUTER_CHAOS}: {st['failovers']} "
          f"failovers, {confirmed} streamed tokens replayed and confirmed, "
          f"0 mismatches, 0 dropped; every stream equals one engine's; "
          f"{out['drill_tokens_per_s']:.1f} tok/s, peak "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    print("ROUTER " + json.dumps(out))
    del router, survivor
    return launches


def serve_fleet(torch, np, C, L, Engine, dev):
    """Phase 4a at LLaMA-7B width, FLEET_LAYERS deep, bf16 (one set of
    weights): INVARIANCE, then the adapter-free baseline of the standard
    trace, ADAPTERS, SPEC (a draft of half the layers) and ROUTER.
    Returns their launches by path."""
    import gc
    from paddle_tpu_torch.inference import serving as S
    cfg, params = fleet_model(torch, L, dev)
    t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    invariance(torch, np, L, Engine, cfg, params, dev)
    free()
    base = Engine(cfg, params, device=dev, **FLEET_GEOM)
    base_out, _, _ = serve_trace(torch, base, standard_trace(np, cfg))
    del base
    free()
    paths = {"adapters": adapters_phase(torch, np, C, Engine, S, cfg,
                                        params, dev, base_out)}
    free()
    paths["spec_verify"], paths["spec_draft"] = spec_phase(
        torch, np, C, Engine, S, cfg, params, dev,
        layers=cfg.num_layers // 2)
    free()
    paths["router"] = router_phase(torch, np, C, Engine, S, cfg, params,
                                   dev, base_out)
    free()
    print(f"[fleet] INVARIANCE, ADAPTERS, SPEC, ROUTER in "
          f"{time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 4c: the dense slot engine and disaggregated prefill / decode pools
# ---------------------------------------------------------------------------

SLOT_GEOM = dict(num_slots=8, chunk=8, max_len=2048)
DISAGG_POOLS = "prefill=1,decode=1"
# tools/disagg_smoke.py:43
DISAGG_CHAOS = "migration:rank_dead@op=offer;victim=0;count=1"
DISAGG_DRILLS = ("migration:drop@op=offer;count=1",
                 "migration:corrupt@op=offer;count=1")
DISAGG_CUT = 4      # DISAGG_Q8, DISAGG_W8 and the drills: the first 4 requests


def slot_bench(torch, np, L, S, dev):
    """SLOT_BENCH: `bench.py:587-640`'s sub-config, nothing cut: its tiny
    f32 model (vocab 256, hidden 64, 2 layers, 4 heads), 24 requests on a
    48-token shared prefix, 6 new tokens each; the dense slot engine (4
    slots, chunk 6) and the paged engine (224 blocks of 8, max_batch 24,
    token_budget 32), each warmed on the trace, then the better of two
    timed repeats. The paged streams must equal the dense streams (the
    reference's `parity`); tokens/s, their ratio and `red_signal` are
    printed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = L.LlamaConfig(vocab_size=256, hidden_size=64,
                        intermediate_size=128, num_layers=2, num_heads=4,
                        num_kv_heads=4, max_seq_len=96, dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    n_req, new = 24, 6
    rs = np.random.RandomState(0)
    shared = rs.randint(1, cfg.vocab_size, size=48).tolist()
    prompts = [shared + rs.randint(1, cfg.vocab_size, size=4).tolist()
               for _ in range(n_req)]

    def timed(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
        eng.run()                        # warm pass (and prefix cache seed)
        best, outs = 0.0, None
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
            out = {c.rid: c.output_tokens for c in eng.run()}
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            best, outs = max(best, n_req * new / dt), [out[r] for r in rids]
        return outs, best

    dense_out, dense_tps = timed(S.ServingEngine(
        cfg, params, num_slots=4, max_len=96, chunk=new, device=dev))
    paged = S.PagedServingEngine(cfg, params, num_blocks=224, block_size=8,
                                 max_batch=n_req, token_budget=32,
                                 max_len=96, device=dev)
    paged_out, paged_tps = timed(paged)
    out = {"requests": n_req, "new_tokens": new,
           "paged_tokens_per_s": paged_tps, "dense_tokens_per_s": dense_tps,
           "ratio": paged_tps / dense_tps, "parity": paged_out == dense_out,
           "prefix_hit_tokens": paged.blocks.stats["prefix_hit_tokens"],
           "graph_captures": paged.stats["graph_captures"],
           "red_signal": bool(paged_out != dense_out
                              or paged_tps < dense_tps)}
    require(out["parity"], "SLOT_BENCH: the paged streams differ from the "
            "dense slot engine's")
    print(f"[slot-bench] bench.py's paged-vs-dense sub-config: parity, "
          f"paged {paged_tps:.1f} / dense {dense_tps:.1f} tok/s (ratio "
          f"{out['ratio']:.3f}), red_signal {out['red_signal']}")
    print("SLOT_BENCH " + json.dumps(out))


def slot_chunk_check(torch, np, eng, trace):
    """The trace freshly admitted into the slots: one chunk run eagerly
    (the steps the captured graph holds), then the same chunk replayed
    from the same state; tokens and last logits bit for bit (the eager
    chunk's cache columns are rewritten before any read). The batch then
    finishes through the engine."""
    for p, _ in trace:
        eng.submit(p, max_new_tokens=32)
    eng._admit()
    bufs = (eng._last_logits, eng._pos)
    saved = [t.clone() for t in bufs]
    toks_e = eng.decode_chunk(eager=True).copy()
    logits_e = eng._last_logits.clone()
    for t, v in zip(bufs, saved):
        t.copy_(v)
    toks_g = eng.decode_chunk()
    require(np.array_equal(toks_g, toks_e)
            and torch.equal(eng._last_logits, logits_e),
            "SLOT: the replayed chunk differs from the eager chunk")
    eng._harvest(toks_g)
    eng.stats["decode_chunks"] += 1
    eng.stats["decode_steps"] += eng.chunk
    eng.run()


def slot_rows_dense(torch, eng, trace, upto):
    """The dense engine's logits rows behind generated tokens 0..upto of
    every request, {(request, token): f32 row}: the trace admitted into
    slots 0..7 as in its served run, then eager decode steps (the steps
    the captured chunk holds), each row read before the step that picks
    its token. Every decode row runs at num_slots rows, so a row does not
    depend on the other slots. Leaves the engine empty."""
    for p, _ in trace:
        eng.submit(p, max_new_tokens=32)
    eng._admit()
    eng._finished.zero_()
    rows = {}
    for step in range(upto + 1):
        for i in range(len(trace)):
            rows[(i, step)] = eng._last_logits[i].clone()
        if step < upto:
            eng._decode_step(0)
    eng._slots = [type(s)() for s in eng._slots]
    return rows


def slot_rows_paged(eng, trace, upto):
    """The paged engine's logits rows behind generated tokens 0..upto of
    every request, read from the ticks that emit them."""
    rids = [eng.submit(p, max_new_tokens=32) for p, _ in trace]
    rows = {}
    while eng.has_work():
        before = {i: len(eng.scheduler.get(rid).generated)
                  for i, rid in enumerate(rids)}
        eng.step()
        for i, g in before.items():
            seq = eng.scheduler.get(rids[i])
            if g <= upto and len(seq.generated) > g:    # emitted token g
                k = eng.last_rids.index(rids[i])
                rows[(i, g)] = eng.last_logits[k].clone()
    eng.run()
    return rows


# SLOT's witness: a plain f32 forward of the same bf16 weights. Every
# logits row of each engine, along its own stream, lies within
# SLOT_F32_TOL of the largest |logit| of the witness's row at the same
# position and inputs. Set from the readings on the H100 (LLaMA-7B, 32
# random layers, bf16, the standard greedy trace): the dense engine's
# rows 0.0838 and the paged engine's 0.0800 of the largest |logit| from
# the witness at worst, a plain bf16 forward with no kernel 0.0833 (the
# distance bf16 rounding alone gives), the contested tokens of 8
# divergences within 0.0297 of its largest logit; 0.1 leaves a fifth
# above the worst. The phase runs FLEET_LAYERS deep since PR 15: fewer
# layers carry less bf16 rounding, so the limit holds with more room.
SLOT_F32_TOL = 0.1


def plain_rows(torch, L, cfg, params, seqs, starts, dtype):
    """A plain teacher-forced forward of LLaMA over each token sequence,
    no kernel and no TF32. float32: the weights widened a layer at a
    time, f32 throughout (SLOT's witness). bfloat16: activations and
    products in bf16 as the port's forward rounds them, attention's
    scores, softmax and sum in f32 (a third bf16 path beside the two
    engines). Returns, for each sequence, its logits rows [n, V] in f32
    at positions starts[i]..end."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = params["embed"].device
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    xs = [params["embed"][torch.tensor(s, device=dev)].to(dtype)
          for s in seqs]
    ropes = [L.rope_cos_sin(torch.arange(len(s), device=dev), hd,
                            cfg.rope_theta) for s in seqs]
    with torch.no_grad():
        for layer in range(cfg.num_layers):
            lp = {k: v.to(dtype) for k, v in L.layer(params, layer).items()}
            for j, x in enumerate(xs):
                T = x.shape[0]
                h = L.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
                q = L.apply_rope((h @ lp["wq"]).reshape(1, T, nh, hd),
                                 *ropes[j])[0].float()
                k = L.apply_rope((h @ lp["wk"]).reshape(1, T, nkv, hd),
                                 *ropes[j])[0].float()
                v = (h @ lp["wv"]).reshape(T, nkv, hd).float()
                k = k.repeat_interleave(nh // nkv, dim=1)
                v = v.repeat_interleave(nh // nkv, dim=1)
                sc = torch.einsum("qhd,khd->hqk", q, k) / hd ** 0.5
                sc.masked_fill_(torch.ones(T, T, dtype=torch.bool,
                                           device=dev).triu(1), -1e30)
                o = torch.einsum("hqk,khd->qhd", sc.softmax(-1), v)
                x = x + o.reshape(T, nh * hd).to(dtype) @ lp["wo"]
                h = L.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
                x = x + (torch.nn.functional.silu(h @ lp["w1"])
                         * (h @ lp["w3"])) @ lp["w2"]
                xs[j] = x
            del lp
        head = params["lm_head"].to(dtype)
        out = [(L.rms_norm(x[s:], params["final_norm"], cfg.rms_eps)
                @ head).float() for x, s in zip(xs, starts)]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def slot_witness(torch, L, cfg, params, trace, streams, rows, firsts):
    """Hold both engines to the f32 witness. streams / rows: {"dense":
    ..., "paged": ...}, each engine's token streams and its logits rows
    {(request, token): f32 row}. Every row of each engine, along its own
    stream, must lie within SLOT_F32_TOL of the witness's largest |logit|
    (the witness fed that engine's tokens); at a divergence (the dense
    engine picks a, the paged engine b, after the same tokens) both a and
    b must lie within SLOT_F32_TOL of the witness's largest logit, so the
    witness itself cannot tell them apart at that limit. ISSUE's
    conditions between the two engines' rows are reported beside it: the
    rows within W8_BF16_LOGIT_TOL (2^-6) of the largest |logit|, and the
    paged row's top-two gap no larger than the rows' difference (this
    one required). Returns the record."""
    seqs, starts, keys = [], [], []
    for name, outs in streams.items():
        for i, ((p, _), s) in enumerate(zip(trace, outs)):
            seqs.append(list(p) + list(s[:-1]))
            starts.append(len(p) - 1)
            keys.append((name, i))
    t0 = time.perf_counter()
    witness = dict(zip(keys, plain_rows(torch, L, cfg, params, seqs, starts,
                                        torch.float32)))
    secs = time.perf_counter() - t0
    # the plain bf16 forward along the dense streams: how far bf16
    # rounding alone puts a third path from the witness (reported)
    n = len(trace)
    plain = dict(zip(keys[:n], plain_rows(torch, L, cfg, params, seqs[:n],
                                          starts[:n], torch.bfloat16)))
    err = {name: {} for name in streams}
    err["plain_bf16"] = {}
    for (name, i), f in witness.items():
        for g in range(f.shape[0]):
            row = rows[name].get((i, g))
            if row is not None:
                err[name][(i, g)] = ((row - f[g]).abs().max()
                                     / f[g].abs().max()).item()
            if name == "dense":
                err["plain_bf16"][(i, g)] = (
                    (plain[(name, i)][g] - f[g]).abs().max()
                    / f[g].abs().max()).item()
    out = {"witness_s": secs, "tolerance": SLOT_F32_TOL}
    for name, e in err.items():
        want = sum(map(len, streams.get(name, streams["dense"])))
        require(len(e) == want, f"SLOT: {len(e)} {name} rows for {want} "
                f"tokens")
        worst = max(e, key=e.get)
        out[name] = {"rows": len(e), "max_relative": e[worst],
                     "at": list(worst),
                     "first_token": [e[(i, 0)] for i in range(len(trace))],
                     "by_token": [max(v for (_, g), v in e.items() if g == t)
                                  for t in range(max(g for _, g in e) + 1)]}
    divergences = []
    for i, j in enumerate(firsts):
        if j is None:
            continue
        f = witness[("dense", i)][j]
        d_row, p_row = rows["dense"][(i, j)], rows["paged"][(i, j)]
        a, b = streams["dense"][i][j], streams["paged"][i][j]
        scale = f.abs().max().item()
        top = torch.topk(p_row, 2).values
        diff = (d_row - p_row).abs().max().item()
        divergences.append({
            "request": i, "token": j, "dense_token": a, "paged_token": b,
            "witness_slack": (f.max() - torch.minimum(f[a], f[b])).item()
            / scale,
            "witness_token": int(torch.argmax(f)),
            "rows_relative": diff / p_row.abs().max().item(),
            "paged_gap": (top[0] - top[1]).item(), "rows_diff": diff,
            "within_2^-6": diff <= W8_BF16_LOGIT_TOL
            * p_row.abs().max().item()})
    out["divergences"] = divergences
    out["within_2^-6"] = all(d["within_2^-6"] for d in divergences)
    print(f"[slot] f32 witness ({secs:.1f} s): dense rows within "
          f"{out['dense']['max_relative']:.4f}, paged rows within "
          f"{out['paged']['max_relative']:.4f} of its largest |logit| "
          f"(limit {SLOT_F32_TOL:.4f}; a plain bf16 forward "
          f"{out['plain_bf16']['max_relative']:.4f}); {len(divergences)} "
          f"divergences, contested tokens within "
          f"{max([d['witness_slack'] for d in divergences] or [0]):.4f} of "
          f"its largest logit")
    print("SLOT_WITNESS " + json.dumps(out))
    for name in streams:
        require(out[name]["max_relative"] <= SLOT_F32_TOL,
                f"SLOT: the {name} engine's row {out[name]['at']} is "
                f"{out[name]['max_relative']:.4g} of the largest |logit| "
                f"from the f32 witness (limit {SLOT_F32_TOL:.4g})")
    for d in divergences:
        require(d["witness_slack"] <= SLOT_F32_TOL
                and d["paged_gap"] <= d["rows_diff"],
                f"SLOT: request {d['request']} diverges at token "
                f"{d['token']} ({d['dense_token']} against "
                f"{d['paged_token']}) where the f32 witness tells them "
                f"apart: {d['witness_slack']:.4g} of its largest logit "
                f"(limit {SLOT_F32_TOL:.4g}), or the paged top-2 gap "
                f"{d['paged_gap']:.4g} exceeds the rows' difference "
                f"{d['rows_diff']:.4g}")
    return out


def slot_phase(torch, np, C, L, S, Engine, cfg, params, dev):
    """SLOT at LLaMA-7B: `ServingEngine(num_slots=8, chunk=8,
    max_len=2048)` on the standard greedy trace (8 requests, 64-512
    prompt tokens, 32 new), then the paged engine (the fleet geometry) on
    the same trace, each warmed. Required: one captured chunk, replayed
    bit-equal to the eager chunk; A1 and A3 once a layer a prefill and
    nowhere else (the decode rows are plain, as the reference's). The
    streams are compared up to each request's first divergence, and both
    engines are held to a plain f32 forward of the same weights
    (`slot_witness`): every row of each within SLOT_F32_TOL of it, and a
    divergence only where it cannot tell the two contested tokens apart
    at that limit. Whether the two engines' rows at the divergences lie
    within W8_BF16_LOGIT_TOL (2^-6 of the largest |logit|, set at 4
    layers) of each other is printed. Returns (the slot run's launches,
    the paged streams)."""
    trace = standard_trace(np, cfg, greedy=True)
    slot = S.ServingEngine(cfg, params, device=dev, **SLOT_GEOM)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in slot._cache.values())
    cold, _, _ = serve_trace(torch, slot, trace)       # captures the chunk
    slot_chunk_check(torch, np, slot, trace)
    chunk_s = []
    replay = slot.decode_chunk

    def timed_chunk(eager=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = replay(eager)             # ends in the chunk's one sync
        chunk_s.append(time.perf_counter() - t0)
        return out

    slot.decode_chunk = timed_chunk
    for k in C.KERNELS:
        k.reset()
    dense, wall_d, _ = serve_trace(torch, slot, trace)
    launches = launch_counts(C)
    del slot.decode_chunk
    n = len(trace) * cfg.num_layers
    expect = {k.name: 0 for k in C.KERNELS}
    expect.update(flash_attention=n, fused_ffn=n)
    require(dense == cold, "SLOT: a repeat of the trace gave other streams")
    require(slot.stats["graph_captures"] == 1,
            f"SLOT: {slot.stats['graph_captures']} captured chunks")
    require(launches == expect, f"SLOT: launches {launches} != {expect}")
    paged = Engine(cfg, params, device=dev, **FLEET_GEOM)
    paged_cold, _, _ = serve_trace(torch, paged, trace)
    paged_out, wall_p, ticks_p = serve_trace(torch, paged, trace)
    require(paged_out == paged_cold, "SLOT: the paged repeat differs")
    firsts = [next((j for j, (a, b) in enumerate(zip(d, p)) if a != b),
                   None) for d, p in zip(dense, paged_out)]
    upto = max(map(len, dense)) - 1
    d_rows = slot_rows_dense(torch, slot, trace, upto)
    p_rows = slot_rows_paged(paged, trace, upto)
    first_token = [((d_rows[(i, 0)] - p_rows[(i, 0)]).abs().max()
                    / p_rows[(i, 0)].abs().max()).item()
                   for i in range(len(trace))]
    witness = slot_witness(torch, L, cfg, params, trace,
                           {"dense": dense, "paged": paged_out},
                           {"dense": d_rows, "paged": p_rows}, firsts)
    tokens = sum(map(len, dense))
    chunk_ms = float(np.median(chunk_s)) * 1e3
    out = {"requests": len(trace), "new_tokens": 32,
           "prompt_tokens": sum(len(p) for p, _ in trace),
           "matching_prefix": sum(len(d) if j is None else j
                                  for d, j in zip(dense, firsts)),
           "tokens": tokens, "witness": witness,
           "first_token_relative": first_token,
           "within_2^-6": witness["within_2^-6"],
           "dense_tokens_per_s": tokens / wall_d,
           "paged_tokens_per_s": tokens / wall_p,
           "ratio": wall_d / wall_p, "dense_chunks": len(chunk_s),
           "dense_ms_per_chunk": chunk_ms,
           "dense_ms_per_step": chunk_ms / slot.chunk,
           "paged_ticks": ticks_p, "dense_cache_bytes": cache_bytes,
           "graph_captures": slot.stats["graph_captures"],
           "launches": launches}
    print(f"[slot] dense slot engine, 8 slots x 2048: {tokens} tokens "
          f"in {wall_d:.2f} s ({out['dense_tokens_per_s']:.1f} tok/s), "
          f"{chunk_ms:.2f} ms a chunk of 8 ({chunk_ms / 8:.2f} a step); "
          f"paged {out['paged_tokens_per_s']:.1f} tok/s (ratio "
          f"{out['ratio']:.3f}); streams equal for {out['matching_prefix']}"
          f" of {tokens} tokens, {len(witness['divergences'])} divergences,"
          f" each where the f32 witness ties within {SLOT_F32_TOL:.4f}; "
          f"the engines' rows at the first token "
          f"{min(first_token):.4f}-{max(first_token):.4f} of the largest "
          f"|logit| apart, 2^-6 = {W8_BF16_LOGIT_TOL:.4f} "
          f"{'holds' if out['within_2^-6'] else 'does not hold'} at the "
          f"divergences; replayed chunk bit-equal to eager; cache "
          f"{cache_bytes / 1e9:.2f} GB")
    print("SLOT " + json.dumps(out))
    del slot, paged
    return launches, paged_out


def serve_router(torch, router, trace, max_new=32):
    """Serve `trace` through a router; (streams, finish reasons, wall
    seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [router.submit(p, max_new_tokens=max_new) for p, _ in trace]
    done = {c.rid: c for c in router.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([done[r].output_tokens if r in done else None for r in rids],
            [done[r].finish_reason if r in done else None for r in rids],
            wall)


def watch_disagg(torch, C, router):
    """Wrap a disagg router's handoff halves and its engines' ticks:
    seconds to extract and pack (and offer) and to pull, unpack and
    ingest, the bytes of each offer, the pulls that landed after the
    receiver had captured its decode tick, and each pool's launches and
    ticks. Returns the record it fills."""
    rec = {"offer_s": [], "ingest_s": [], "bytes": {}, "after_capture": 0,
           "launches": {r: {k.name: 0 for k in C.KERNELS}
                        for r in ("prefill", "decode")},
           "ticks": {"prefill": 0, "decode": 0}}
    begin, migrate = router._begin_handoff, router._migrate

    def timed_begin(req, src, hs):
        b0 = router.transport.stats["bytes_offered"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        begin(req, src, hs)
        rec["offer_s"].append(time.perf_counter() - t0)
        rec["bytes"][req.rid] = router.transport.stats["bytes_offered"] - b0

    def timed_migrate(req, hs, dst):
        captured = bool(dst.engine._dec_graphs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        migrate(req, hs, dst)
        torch.cuda.synchronize()
        if hs.get("done") == "pulled":
            rec["ingest_s"].append(time.perf_counter() - t0)
            rec["after_capture"] += captured and hs.get("pages", 0) > 0

    router._begin_handoff, router._migrate = timed_begin, timed_migrate
    for h in router.replicas:
        eng, role = h.engine, h.role
        tick = eng.step

        def step(tick=tick, role=role, eng=eng):
            before, s0 = launch_counts(C), eng.stats["steps"]
            try:
                return tick()
            finally:
                for name, n in launch_counts(C).items():
                    rec["launches"][role][name] += n - before[name]
                rec["ticks"][role] += eng.stats["steps"] - s0
        eng.step = step
    return rec


def disagg_router(torch, C, S, factory, trace, spec="", max_new=32, **kw):
    """A DisaggRouter (one prefill and one decode replica, `factory`'s
    engines; a killed replica stays dead) serving `trace` under chaos
    `spec`: (router, streams, reasons, wall, the watch record, the
    injections' firings)."""
    from paddle_tpu_torch.distributed.fault_tolerance import chaos
    router = S.DisaggRouter(factory, pools=DISAGG_POOLS, probation_s=1e9,
                            tenant_weights={"default": len(trace)}, **kw)
    rec = watch_disagg(torch, C, router)
    chaos.reconfigure(spec)
    try:
        streams, reasons, wall = serve_router(torch, router, trace, max_new)
        fired = [i.fired for i in chaos.injections()]
    finally:
        chaos.reconfigure("")
    return router, streams, reasons, wall, rec, fired


def disagg_phase(torch, np, C, S, Engine, cfg, params, dev, mono, manifest,
                 smi):
    """DISAGG, DISAGG_CHAOS, DISAGG_Q8, DISAGG_W8 and AUTOSCALE at
    LLaMA-7B (the fleet geometry; replicas share one set of device
    weights), against `mono`, one paged engine's streams of the standard
    greedy trace. Returns the DISAGG run's launches by pool."""
    import gc
    from paddle_tpu_torch.inference.serving import disagg as D
    from paddle_tpu_torch.inference.serving.replica import (DEAD, DEGRADED,
                                                            DRAINED, HEALTHY)

    def factory(**kw):
        return lambda: Engine(cfg, params, device=dev, **FLEET_GEOM, **kw)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    trace = standard_trace(np, cfg, greedy=True)
    mib = 2.0 ** 20

    # DISAGG: the raw wire, then the same trace again on the warm fleet
    router, outs, why, wall, rec, _ = disagg_router(torch, C, S, factory(),
                                                    trace)
    st, dec = dict(router.disagg_stats), router.pool("decode")[0].engine
    require(outs == mono, "DISAGG: a stream differs from the monolithic "
            "engine's")
    require(st["handoffs"] == st["handoffs_ok"] == len(trace)
            and st["fallbacks"] == 0 and router.stats["mismatches"] == 0,
            f"DISAGG: {st}, mismatches {router.stats['mismatches']}")
    adopted = dec.blocks.stats["adopted_pages"]
    require(adopted > 0, "DISAGG: the decode replica adopted no page")
    require(dec.stats["graph_captures"] == 1 and rec["after_capture"] > 0,
            f"DISAGG: the decode replica captured "
            f"{dec.stats['graph_captures']} graphs, "
            f"{rec['after_capture']} pulls landed after its capture")
    for role, n in rec["ticks"].items():
        want = {k.name: 0 for k in C.KERNELS}
        want.update(paged_attention=cfg.num_layers * n,
                    fused_ffn=cfg.num_layers * n, fused_sample=n)
        require(rec["launches"][role] == want,
                f"DISAGG: {role} launches {rec['launches'][role]} over {n} "
                f"ticks, expected {want}")
    launches = {f"disagg_{r}": dict(v) for r, v in rec["launches"].items()}
    ticks = dict(rec["ticks"])
    raw = dict(rec["bytes"])
    shipped = sum(raw.values()) / mib
    offer_ms = sum(rec["offer_s"]) * 1e3
    ingest_ms = sum(rec["ingest_s"]) * 1e3
    captures = [h.engine.stats["graph_captures"] for h in router.replicas]
    again, _, wall2 = serve_router(torch, router, trace)
    require(again == mono, "DISAGG: the warm repeat differs")
    require([h.engine.stats["graph_captures"] for h in router.replicas]
            == captures, "DISAGG: the warm repeat captured again")
    out = {"requests": len(trace), "handoffs": st["handoffs"],
           "handoffs_ok": st["handoffs_ok"], "fallbacks": st["fallbacks"],
           "mismatches": router.stats["mismatches"],
           "pages_shipped": st["pages_shipped"], "pages_adopted": adopted,
           "mib_shipped": shipped, "tokens_per_s": sum(map(len, outs)) / wall,
           "warm_tokens_per_s": sum(map(len, again)) / wall2,
           "extract_pack_ms_per_handoff": offer_ms / len(trace),
           "extract_pack_ms_per_mib": offer_ms / shipped,
           "pull_unpack_ingest_ms_per_handoff": ingest_ms / len(trace),
           "pull_unpack_ingest_ms_per_mib": ingest_ms / shipped,
           "pulls_after_capture": rec["after_capture"],
           "decode_graph_captures": captures[1],
           "ticks": ticks, "launches": launches, "card": smi}
    print(f"[disagg] {DISAGG_POOLS}, raw wire: {st['handoffs_ok']} of "
          f"{st['handoffs']} handoffs by page pull, {st['pages_shipped']} "
          f"pages ({shipped:.1f} MiB) shipped, {adopted} adopted; extract "
          f"+ pack {out['extract_pack_ms_per_mib']:.3f} ms/MiB, pull + "
          f"unpack + ingest {out['pull_unpack_ingest_ms_per_mib']:.3f} "
          f"ms/MiB; every stream equals the monolithic engine's, the warm "
          f"repeat too with no new capture; {out['tokens_per_s']:.1f} / "
          f"{out['warm_tokens_per_s']:.1f} tok/s ({smi})")
    print("DISAGG " + json.dumps(out))
    del router, dec
    free()

    # DISAGG_CHAOS: the sender dies riding its first offer
    router, outs, why, _, _, fired = disagg_router(
        torch, C, S, factory(), trace, DISAGG_CHAOS)
    st = router.disagg_stats
    dropped = sum(1 for r in why if r != "length")
    require(fired == [1] and st["fallbacks"] == 1
            and router.stats["mismatches"] == 0 and dropped == 0,
            f"DISAGG_CHAOS: fired {fired}, {st}, mismatches "
            f"{router.stats['mismatches']}, dropped {dropped}")
    require(outs == mono, "DISAGG_CHAOS: a stream differs from the "
            "monolithic engine's")
    require(router.replicas[0].state == DEAD
            and router.replicas[0].incarnation == 1,
            "DISAGG_CHAOS: the sender is not dead and fenced")
    out = {"chaos": DISAGG_CHAOS, "fallbacks": st["fallbacks"],
           "mismatches": 0, "dropped": 0, "handoffs": st["handoffs"],
           "handoffs_ok": st["handoffs_ok"],
           "handoffs_local": st["handoffs_local"], "drills": {}}
    del router
    free()
    cut = trace[:DISAGG_CUT]
    for spec in DISAGG_DRILLS:
        router, outs, why, _, _, fired = disagg_router(torch, C, S,
                                                       factory(), cut, spec)
        st = router.disagg_stats
        require(fired == [1] and st["fallbacks"] == 1
                and router.stats["mismatches"] == 0
                and outs == mono[:DISAGG_CUT],
                f"DISAGG_CHAOS {spec}: fired {fired}, {st}")
        out["drills"][spec] = {"fallbacks": 1, "handoffs_ok":
                               st["handoffs_ok"], "transport":
                               dict(router.transport.stats)}
        del router
        free()
    print(f"[disagg-chaos] {DISAGG_CHAOS}: 1 recompute fallback, 0 "
          f"mismatches, 0 dropped, the sender dead at incarnation 1; "
          f"drills {', '.join(DISAGG_DRILLS)} on {DISAGG_CUT} requests: 1 "
          f"fallback each; every stream equals the monolithic engine's")
    print("DISAGG_CHAOS " + json.dumps(out))

    # DISAGG_Q8: the int8 wire, on the first DISAGG_CUT requests
    router, outs, why, _, rec, _ = disagg_router(
        torch, C, S, factory(), cut, migration_wire_dtype="int8")
    st = router.disagg_stats
    dropped = sum(1 for r in why if r != "length")
    require(dropped == 0 and router.stats["mismatches"] == 0,
            f"DISAGG_Q8: dropped {dropped}, mismatches "
            f"{router.stats['mismatches']}")
    q8 = sum(rec["bytes"].values())
    raw_cut = sum(raw[r] for r in range(DISAGG_CUT))
    out = {"requests": DISAGG_CUT, "cut": f"the trace's first {DISAGG_CUT} "
           f"of {len(trace)} requests", "wire_bytes": q8,
           "raw_wire_bytes": raw_cut, "ratio": q8 / raw_cut,
           "streams_equal_monolithic": sum(
               o == m for o, m in zip(outs, mono)),
           "fallbacks": st["fallbacks"],
           "mismatches": router.stats["mismatches"], "dropped": 0}
    print(f"[disagg-q8] migration_wire_dtype=int8 on {DISAGG_CUT} requests: "
          f"{q8 / mib:.1f} MiB on the wire against {raw_cut / mib:.1f} raw "
          f"(ratio {out['ratio']:.4f}; bf16 pages ship raw, as in the "
          f"reference); {out['streams_equal_monolithic']} of {DISAGG_CUT} "
          f"streams equal the monolithic engine's, {st['fallbacks']} "
          f"fallbacks, 0 mismatches, 0 dropped ({smi})")
    print("DISAGG_Q8 " + json.dumps(out))
    del router
    free()

    # DISAGG_W8: w8 weights and int8 pages with their dequant planes
    w8 = dict(quant_mode="w8", quant_kv=True, quant_manifest=manifest)
    mono_eng = factory(**w8)()
    mono_w8, _, _ = serve_trace(torch, mono_eng, cut)
    del mono_eng
    free()
    router, outs, why, _, rec, _ = disagg_router(torch, C, S,
                                                 factory(**w8), cut)
    st = router.disagg_stats
    require(outs == mono_w8 and st["handoffs_ok"] == DISAGG_CUT
            and st["fallbacks"] == 0,
            f"DISAGG_W8: streams equal {outs == mono_w8}, {st}")
    src_eng = router.replicas[0].engine
    sent = src_eng.extract_pages(cut[0][0])
    landed = router.replicas[1].engine.extract_pages(cut[0][0])
    same = all(np.array_equal(sent[n], landed[n])
               for n in ("k", "v", "kdq", "vdq"))
    blob = D.pack_pages(sent, (0, 0), "int8")
    back, _ = D.unpack_pages(blob)
    as_is = (b'"wire": "raw"' in blob and all(
        back[n].dtype == sent[n].dtype and np.array_equal(back[n], sent[n])
        for n in ("k", "v", "kdq", "vdq")))
    require(same and as_is, f"DISAGG_W8: the adopted pages equal the "
            f"sender's {same}; int8 pages and f32 planes as they are "
            f"{as_is}")
    out = {"requests": DISAGG_CUT, "handoffs_ok": st["handoffs_ok"],
           "pages_adopted":
               router.replicas[1].engine.blocks.stats["adopted_pages"],
           "wire_mib": sum(rec["bytes"].values()) / mib,
           "planes": {n: str(sent[n].dtype) for n in ("k", "v", "kdq",
                                                      "vdq")}}
    print(f"[disagg-w8] w8 + int8 KV: {DISAGG_CUT} streams equal the "
          f"monolithic quantized engine's; int8 pages and their kdq / vdq "
          f"planes adopted as sent ({out['wire_mib']:.1f} MiB)")
    print("DISAGG_W8 " + json.dumps(out))
    del router, src_eng
    free()

    # AUTOSCALE: a TTFT breach grows the decode pool through probation,
    # the grown replica serves, calm drains it
    torch.cuda.reset_peak_memory_stats()
    router = S.DisaggRouter(factory(), pools=DISAGG_POOLS,
                            tenant_weights={"default": len(trace)})
    scaler = D.PoolAutoscaler(router, ttft_p99_s=0.05, shed_rate=0.0,
                              min_decode=1, max_decode=2, cooldown_s=0.0)
    breach = {"ttft_p99_s": 1.0, "shed_queue_rate": 0.0,
              "deadline_expired": 0}
    calm = {"ttft_p99_s": 0.001, "shed_queue_rate": 0.0,
            "deadline_expired": 0}
    grew = scaler.tick(breach, now=0.0)
    grown = router.replicas[-1]
    require(grew == "grow" and grown.role == "decode" and grown.probation
            and grown.state == DEGRADED and router.decode_pool_size() == 2,
            f"AUTOSCALE: {grew}, the grown replica {grown.snapshot()}")
    tail = trace[DISAGG_CUT:]
    outs, _, _ = serve_router(torch, router, tail, max_new=8)
    require(outs == [m[:8] for m in mono[DISAGG_CUT:]],
            "AUTOSCALE: a stream differs from the monolithic engine's")
    require(grown.state == HEALTHY and grown.stats["steps"] > 0,
            f"AUTOSCALE: the grown replica {grown.state} after "
            f"{grown.stats['steps']} steps")
    shrank = scaler.tick(calm, now=1.0)
    router.step()
    require(shrank == "shrink" and grown.state == DRAINED
            and router.decode_pool_size() == 1,
            f"AUTOSCALE: {shrank}, the grown replica {grown.state}")
    out = {"grow": grew, "grown_steps": grown.stats["steps"],
           "shrink": shrank, "states": [h.state for h in router.replicas],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(f"[autoscale] a TTFT breach grew the decode pool to 2 (probation, "
          f"then healthy after {grown.stats['steps']} steps serving), calm "
          f"drained it back to 1; peak "
          f"{out['max_memory_allocated_bytes'] / 1e9:.2f} GB ({smi})")
    print("AUTOSCALE " + json.dumps(out))
    del router, grown, scaler
    free()
    return launches


def serve_disagg(torch, np, C, L, Q, Engine, dev, smi):
    """Phase 4c at LLaMA-7B width, FLEET_LAYERS deep, bf16 (one set of
    weights; DISAGG_W8's manifest calibrated on them as `calibrate_w8`
    does), after the bench's own SLOT_BENCH: SLOT, then the disagg
    phases. Returns their launches by path."""
    import gc
    from paddle_tpu_torch.inference import serving as S
    t0 = time.perf_counter()
    slot_bench(torch, np, L, S, dev)
    cfg, params = fleet_model(torch, L, dev)
    manifest = calibrate_w8(np, Q, cfg, params)
    paths = {}
    paths["slot"], mono = slot_phase(torch, np, C, L, S, Engine, cfg,
                                     params, dev)
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(disagg_phase(torch, np, C, S, Engine, cfg, params, dev,
                              mono, manifest, smi))
    print(f"[fleet-disagg] SLOT_BENCH, SLOT, DISAGG, DISAGG_CHAOS, "
          f"DISAGG_Q8, DISAGG_W8, AUTOSCALE in "
          f"{time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 4b: the predictor (inference/llm.py), decode chunks as CUDA graphs
# ---------------------------------------------------------------------------

# the bench's own decode config (`bench.py:937-943`) with torch dtypes
BENCH_DECODE = dict(vocab_size=32000, hidden_size=1536,
                    intermediate_size=4096, num_layers=12, num_heads=12,
                    num_kv_heads=12, max_seq_len=2048)
PRED_T, PRED_NEW, PRED_WARM = 128, 128, 32      # bench.py:944
# the 7B predictor's depth, cut from 32 to keep the script in its budget
# once the eager phases (8a, 8b) came, and from 16 to 8 for phases 8g-8i
PRED_7B_LAYERS = 8
# the eager yardstick's length: the replay held bit-equal to the eager
# steps over two chunks (a chunk boundary), not all 128 new tokens
PRED_EAGER_NEW = 64
# A1's shapes on the predictors' prefills, (B, heads) at T = PRED_T: the
# bench config at B = 8 and 32, LLaMA-7B width at B = 8
PRED_ATTN = ((8, 12), (32, 12), (8, 32))


def predict(torch, np, C, L, Predictor, dev, tag, cfg, batches=(8,),
            quant_mode=""):
    """`bench_llama_decode`'s measurement on the port's predictor: seeded
    random bf16 weights, max_len T + new + warm + 1 = 289, a seeded B x
    128 prompt; per batch size a 32-token warm-up `generate` (it captures
    the 32-step chunk), then 128 new tokens (four replays) with every
    launch count at 0 just before: A1 must launch once a layer (prefill),
    A3 (A6 with w8 weights) once a layer for the prefill and once a layer
    a decode step, counted at replay, and nothing else (w8a8 and fp8: no
    FFN kernel, the plain chain; w8a8's manifest calibrated on the card).
    The first PRED_EAGER_NEW of those tokens from the eager steps
    (`_generate(capture=False)`) must be bit-equal; tokens/s and ms a step
    for both; then one replayed chunk under torch.profiler. Returns the
    first batch size's launches."""
    t0 = time.perf_counter()
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.bfloat16)
    manifest = None
    if quant_mode == "w8a8":
        from paddle_tpu_torch.inference import quant as Q
        manifest = calibrate_w8(np, Q, cfg, params)
    pred = Predictor(cfg, params, max_len=PRED_T + PRED_NEW + PRED_WARM + 1,
                     weight_dtype=torch.bfloat16, quant_mode=quant_mode,
                     quant_manifest=manifest, device=dev)
    del params
    torch.cuda.synchronize()
    Lyr = cfg.num_layers
    # the FFN's kernel: A3 on bf16 weights, A6 on w8; none on w8a8 and fp8
    ffn = {"": "fused_ffn", "w8": "fused_ffn_w8"}.get(quant_mode)
    label = tag.lower().replace("_", "-")
    print(f"[{label}] {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"{cfg.num_params() / 1e9:.2f} B params, "
          f"{quant_mode or 'bf16'} weights, set up in "
          f"{time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(1)
    base = rs.randint(0, cfg.vocab_size, (batches[0], PRED_T))
    first = None
    for B in batches:
        prompt = np.tile(base, (B // batches[0], 1))
        t1 = time.perf_counter()
        pred.generate(prompt, max_new_tokens=PRED_WARM)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        graph = pred._slots[B].graphs[(32, False, 0, False)]
        require(set(graph.delta) == ({ffn} if ffn else set())
                and (not ffn or graph.delta[ffn][0] == 32 * Lyr),
                f"{tag}: a 32-step chunk captured {graph.delta}")
        torch.cuda.reset_peak_memory_stats()
        for k in C.KERNELS:          # count only the main path's launches
            k.reset()
        t1 = time.perf_counter()
        toks = pred.generate(prompt, max_new_tokens=PRED_NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches = {k.name: k.launches for k in C.KERNELS}
        expect = {k.name: 0 for k in C.KERNELS}
        expect["flash_attention"] = Lyr
        if ffn:
            expect[ffn] = Lyr * (1 + PRED_NEW)
        require(launches == expect, f"{tag} B={B}: launches {launches} != "
                f"{expect}")
        if quant_mode == "w8":
            a6 = dict(C.fused_ffn.KERNEL_W8.paths)
            require(a6 == {"wgmma": expect[ffn]}, f"{tag} B={B}: A6's "
                    f"launches by path {a6}, expected all on wgmma")
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        eager = pred._generate(prompt, PRED_EAGER_NEW, None, False, None, 0,
                               None, 0, capture=False)
        torch.cuda.synchronize()
        dt_eager = time.perf_counter() - t1
        require(toks.shape == (B, PRED_T + PRED_NEW)
                and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"{tag} B={B}: tokens out of range")
        require(torch.equal(toks[:, :PRED_T + PRED_EAGER_NEW], eager),
                f"{tag} B={B}: replayed chunks' tokens differ from the eager "
                f"steps'")
        out = {"batch": B, "prompt": PRED_T, "new_tokens": PRED_NEW,
               "layers": Lyr, "quant_mode": quant_mode,
               "warmup_generate_s": warm_s, "generate_s": dt,
               "decode_tokens_per_s": B * PRED_NEW / dt,
               "ms_per_step": dt * 1e3 / PRED_NEW,
               "eager_new_tokens": PRED_EAGER_NEW,
               "eager_generate_s": dt_eager,
               "eager_decode_tokens_per_s": B * PRED_EAGER_NEW / dt_eager,
               "eager_ms_per_step": dt_eager * 1e3 / PRED_EAGER_NEW,
               "replay_equals_eager": True,
               "max_memory_allocated_bytes": peak, "launches": launches}
        print(f"[{label}] B={B}: {PRED_NEW} new tokens in {dt:.3f} s "
              f"captured ({out['decode_tokens_per_s']:.1f} tok/s, "
              f"{out['ms_per_step']:.3f} ms a step, prefill included), "
              f"{PRED_EAGER_NEW} eager in {dt_eager:.3f} s "
              f"({out['eager_decode_tokens_per_s']:.1f} tok/s, "
              f"{out['eager_ms_per_step']:.3f} ms a step); tokens bit-equal; "
              f"peak memory {peak / 2**30:.2f} GiB")
        st = pred._slots[B]

        def chunk():
            st.pos.fill_(PRED_T)
            graph.replay()

        # one chunk of 32 decode steps, CUDA events around back-to-back
        # replays (the eager steps' yardstick is the eager generate above)
        out["chunk_ms_per_step"] = cuda_ms(torch, chunk, 3, warmup=1) / 32
        step = out["chunk_ms_per_step"]
        print(f"[{label}] B={B}: a 32-step chunk, {step:.3f} ms a step "
              f"replayed ({B * 1e3 / step:.1f} tok/s)")
        print(f"[{label}] B={B}: launches {launches} (expected {expect})")
        print(f"{tag} " + json.dumps(out))

        prof = profile_once(torch, chunk, f"{tag} B={B} replayed 32-step "
                            f"chunk", f"PROFILE_{tag}_B{B}",
                            names=("w8_", "Float8", "round", "_s8",
                                   "s8s8", "imma", "i16832"))
        # the profiler's own host work stretches the replay's wall time;
        # the busy share is taken against the chunk's event time instead
        busy = prof["device_ms"] / (32 * out["chunk_ms_per_step"])
        print(f"[{label}] B={B}: device {prof['device_ms'] / 32:.3f} ms a "
              f"step, busy {busy:.3f} of a replayed chunk's event time")
        first = first or launches
    del pred
    torch.cuda.empty_cache()
    return first


def serve_predictors(torch, np, C, L, Predictor, dev):
    """The predictor's cells: the bench config at B = 8 and 32, LLaMA-7B
    width (PRED_7B_LAYERS of 32 layers) at B = 8, and the bench config
    with w8, w8a8 and
    fp8 weights (B = 8; w8a8's decode rows padded to 17 for the int8
    product)."""
    bench = L.LlamaConfig(**BENCH_DECODE, dtype=torch.bfloat16)
    paths = {"predictor": predict(torch, np, C, L, Predictor, dev,
                                  "PREDICTOR", bench, batches=(8, 32))}
    import dataclasses
    predict(torch, np, C, L, Predictor, dev, "PREDICTOR_7B",
            dataclasses.replace(L.CONFIGS["llama-7b"],
                                num_layers=PRED_7B_LAYERS))
    for mode in ("w8", "w8a8", "fp8"):
        paths[f"predictor_{mode}"] = predict(
            torch, np, C, L, Predictor, dev, f"PREDICTOR_{mode.upper()}",
            bench, quant_mode=mode)
    return paths


# ---------------------------------------------------------------------------
# phase 5: the training step, LLaMA-7B width and the bench's config
# ---------------------------------------------------------------------------

# bench.py:84-87, the headline training config: the decode config's widths
BENCH_TRAIN = BENCH_DECODE
# A1 and A2 at B = 4, T = 2,048 with 12 heads; A3 and A4 at its 8,192 rows
BENCH_TRAIN_B, BENCH_TRAIN_T = 4, 2048


def train_run(torch, np, C, L, H, dev, cfg, remat, B, T, warmup, timed,
              tag, profile_tag, eval_check=False):
    """AdamW steps of `make_train_step` (flash attention and fused FFN
    kernels, bf16 compute, f32 master weights, lr 1e-4) at `remat` from
    seeded params, on one fixed seeded batch. Every kernel's launch count
    over the steps must equal what the policy implies: A1 and A3 twice a
    layer a step under remat=True (the recompute), once under "dots" (the
    selective checkpoint keeps their outputs); A2 and A4 once. With
    `eval_check`, `make_eval_step`'s loss of the fresh params (run before
    the counts are reset) must equal the first step's reported loss
    within rtol 1e-6. Prints `tag` and the run's JSON, then profiles one
    more step (`profile_tag`). Returns (launches, losses, step seconds)."""
    t0 = time.perf_counter()
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = H.init_opt_state(params)
    step = H.make_train_step(cfg, device=dev, hp=H.AdamWConfig(lr=1e-4),
                             remat=remat)
    rs = np.random.RandomState(0)
    seq = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, T + 1)))
    tokens, targets = seq[:, :-1].to(dev), seq[:, 1:].to(dev)
    eval_loss = None
    if eval_check:
        eval_loss = float(H.make_eval_step(cfg, device=dev)(params, tokens,
                                                            targets))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for k in C.KERNELS:            # count only the main path's launches
        k.reset()
    losses, times = [], []
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))     # waits for the step
        times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in C.KERNELS}
    steps, layers = warmup + timed, cfg.num_layers
    fwd = (2 if remat is True else 1) * layers * steps
    expect = {k.name: 0 for k in C.KERNELS}
    expect.update({"flash_attention": fwd,
                   "flash_attention_bwd": layers * steps,
                   "fused_ffn": fwd, "fused_ffn_bwd": layers * steps})
    require(launches == expect,
            f"{tag} remat={remat!r}: launches {launches} != {expect}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    if eval_check:
        require(abs(eval_loss - losses[0]) <= 1e-6 * abs(losses[0]),
                f"{tag}: make_eval_step's loss {eval_loss!r} != the first "
                f"train step's {losses[0]!r} (rtol 1e-6)")
    step_s = sum(times[warmup:]) / timed
    tok_s = B * T / step_s
    out = {"remat": remat, "layers": layers, "hidden": cfg.hidden_size,
           "batch": B, "seq": T, "tokens_per_step": B * T,
           "params": cfg.num_params(), "setup_s": setup_s,
           "warmup_steps": warmup, "timed_steps": timed, "step_s": step_s,
           "step_s_each": times, "tokens_per_s": tok_s,
           "flops_per_token": cfg.flops_per_token(),
           "mfu": cfg.flops_per_token() * tok_s / PEAK_OPS["bfloat16"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "eval_loss": eval_loss, "launches": launches,
           "launches_per_step": {n: c / steps for n, c in launches.items()}}
    print(f"[train] {tag} remat={remat!r}: {steps} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {step_s:.4f} s, "
          f"{tok_s:.1f} tokens/s, MFU {out['mfu'] * 100:.2f} % of 989 "
          f"TFLOP/s, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB"
          + ("" if eval_loss is None else
             f"; eval loss {eval_loss:.6f} (first step's {losses[0]:.6f})"))
    print(f"[train] launches {launches} (expected {expect})")
    print(f"{tag} " + json.dumps(out))
    profile_train_step(torch, step, params, opt, tokens, targets,
                       profile_tag)
    del params, opt, step
    torch.cuda.empty_cache()
    return launches, losses, step_s


def train_llama7b(torch, np, C, L, H, dev, layers=8, B=2, T=2048, warmup=2,
                  timed=3):
    """LLaMA-7B width cut to `layers` layers (`train_run`), at remat=True
    (the port's default) and at "dots": lines `TRAIN`, profiles
    `PROFILE_TRAIN` and `PROFILE_TRAIN_DOTS`. Returns the launches of
    each path."""
    import dataclasses
    cfg = dataclasses.replace(L.CONFIGS["llama-7b"], num_layers=layers)
    print(f"[train] llama-7b width, {layers} of 32 layers, "
          f"{cfg.num_params() / 1e9:.2f} B params (f32 master, bf16 "
          f"compute), B={B} T={T}")
    paths = {}
    for remat, name, ptag in ((True, "training", "PROFILE_TRAIN"),
                              ("dots", "training_dots",
                               "PROFILE_TRAIN_DOTS")):
        paths[name] = train_run(torch, np, C, L, H, dev, cfg, remat, B, T,
                                warmup, timed, "TRAIN", ptag)[0]
    return paths


def train_bench(torch, np, C, L, H, dev, warmup=2, timed=5):
    """The bench's own training config (`bench.py:84-87`: vocab 32,000,
    hidden 1,536, d_ff 4,096, 12 layers, 12 heads and kv heads; B = 4,
    T = 2,048, M = 1, lr 1e-4, 2 warm-up and 5 timed steps), nothing cut,
    at its ladder's top two rungs, remat="dots" and True (`train_run`,
    with the eval step's check): lines `TRAIN_BENCH`, profiles
    `PROFILE_TRAIN_BENCH` ("dots") and `PROFILE_TRAIN_BENCH_REMAT`.
    Returns the launches of each path, and the "dots" run's losses and
    step time (`HYBRID`'s yardstick)."""
    cfg = L.LlamaConfig(**BENCH_TRAIN)
    B, T = BENCH_TRAIN_B, BENCH_TRAIN_T
    print(f"[train] bench config, {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {cfg.num_params() / 1e6:.1f} M params (f32 "
          f"master, bf16 compute), B={B} T={T}")
    paths, losses, step_s = {}, {}, {}
    for remat, name, ptag in (("dots", "training_bench",
                               "PROFILE_TRAIN_BENCH"),
                              (True, "training_bench_remat",
                               "PROFILE_TRAIN_BENCH_REMAT")):
        paths[name], losses[remat], step_s[remat] = train_run(
            torch, np, C, L, H, dev, cfg, remat, B, T, warmup, timed,
            "TRAIN_BENCH", ptag, eval_check=True)
    print(f"[train] bench config: the two policies' losses over "
          f"{warmup + timed} steps bit-equal: "
          f"{losses['dots'] == losses[True]}")
    host_cost(torch, np, H, L, dev, cfg)
    return paths, {"losses": losses["dots"], "step_s": step_s["dots"]}


def host_cost(torch, np, H, L, dev, cfg, B=1, T=128, steps=5):
    """What each remat policy costs the host: `loss_and_grads` at the
    config's widths and depth on a batch so short (B = 1, T = 128) that
    the card waits on Python, timed on the host clock (mean of `steps`
    after one warm-up, each ended by a synchronize) beside the card's
    busy time in one profiled call. Line `TRAIN_HOST`."""
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rs = np.random.RandomState(1)
    seq = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, T + 1)))
    tokens, targets = seq[:, :-1].to(dev), seq[:, 1:].to(dev)
    out = {"batch": B, "seq": T, "layers": cfg.num_layers}
    for remat in (True, "dots"):
        def run():
            H.loss_and_grads(params, tokens, targets, cfg, remat=remat)
        run()
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        prof = profile_once(torch, run, f"loss_and_grads remat={remat!r}",
                            "PROFILE_TRAIN_HOST")
        out[str(remat)] = {"ms": sum(times) / steps * 1e3,
                           "device_ms": prof["device_ms"]}
    per_layer = (out["dots"]["ms"] - out["True"]["ms"]) / cfg.num_layers
    print(f"[train] host cost at B={B} T={T}: remat=True "
          f"{out['True']['ms']:.1f} ms (card busy "
          f"{out['True']['device_ms']:.1f}), 'dots' {out['dots']['ms']:.1f} "
          f"ms (busy {out['dots']['device_ms']:.1f}): {per_layer:+.2f} ms a "
          f"layer for the selective checkpoint")
    print("TRAIN_HOST " + json.dumps(out))
    del params
    torch.cuda.empty_cache()


def profile_train_step(torch, step, params, opt, tokens, targets, tag):
    """Where a train step's time goes: one step under torch.profiler,
    device time by kernel and the device's busy share of the step."""
    profile_once(torch, lambda: step(params, opt, tokens, targets),
                 "train step", tag)


# kinds of kernel in a profile, the first whose name holds one of the
# strings: the port's kernels, cuBLAS's products, torch's elementwise and
# reduction kernels; the rest (copies, indexing, cat) is "other"
KERNEL_FAMILIES = (
    ("A1/A2 flash", ("flash_fwd", "flash_dq", "flash_dkv")),
    ("A3/A4 ffn", ("ffn_",)),
    ("A5 paged", ("paged_attention",)),
    ("A6 w8", ("w8_",)),
    ("A7 sample", ("sample_prep",)),
    ("A8 epilogue", ("epilogue",)),
    ("A9 glu", ("glu_kernel",)),
    ("cublas", ("gemm", "xmma", "nvjet", "cutlass", "gemv")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce_kernel", "Reduce", "softmax", "Softmax")),
)


def profile_once(torch, fn, what, tag, names=()):
    """One call of fn under torch.profiler: device time by kernel and the
    device's busy share of the call (kernels whose names hold one of
    `names` also listed by name)."""
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

    families = {}
    for e in kernels:
        fam = next((f for f, keys in KERNEL_FAMILIES
                    if any(k in e.key for k in keys)), "other")
        families[fam] = (families.get(fam, 0.0)
                         + e.self_device_time_total / 1e3)
    out = {"step_ms_under_profiler": step_ms, "device_ms": busy,
           # device ms by kind of kernel (`KERNEL_FAMILIES`)
           "families": families,
           "device_busy_share": busy / step_ms if busy else None,
           "top": [row(e) for e in sorted(kernels, key=lambda e:
                                          -e.self_device_time_total)[:12]],
           # A1 and A2 by name, in or out of the top twelve
           "flash": [row(e) for e in kernels
                     if any(f in e.key for f in ("flash_fwd", "flash_dq",
                                                 "flash_dkv"))],
           # A3's and A4's kernels by name
           "ffn": [row(e) for e in kernels if "ffn_" in e.key],
           # A8's kernels by name
           "epilogue": [row(e) for e in kernels if "epilogue" in e.key],
           "named": [row(e) for e in kernels
                     if any(n in e.key for n in names)]}
    if not busy:
        print("[profile] torch.profiler saw no device time; busy share not "
              "measured")
    print(f"[profile] {what} {step_ms:.1f} ms under the profiler; device "
          f"busy {busy:.1f} ms")
    print("[profile]   by kind: " + ", ".join(
        f"{f} {ms:.2f} ms" for f, ms in sorted(families.items(),
                                               key=lambda kv: -kv[1])))
    for t in out["top"]:
        print(f"[profile]   {t['ms']:.2f} ms x{t['calls']} {t['kernel']}")
    for part in ("flash", "ffn", "epilogue", "named"):
        for t in out[part]:
            print(f"[profile]   {part}: {t['ms']:.2f} ms x{t['calls']} "
                  f"{t['kernel']}")
    print(f"{tag} " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 5b: the hybrid-parallel step over a world of one, and the
# collective layer, on NCCL
# ---------------------------------------------------------------------------

# the reference test's tiny f32 config (tests/test_hybrid_parallel.py:23)
HYBRID_TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_layers=4, num_heads=4, num_kv_heads=2, max_seq_len=16)
# Mixtral-8x7B's published widths (Jiang et al., 2024), cut to 2 of its
# 32 layers for the card's memory (the AdamW state of 3.2 B params)
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1e6,
               num_experts=8, top_k=2)
MOE_LAYERS, MOE_B, MOE_T = 2, 1, 2048


def mesh_step_run(torch, C, step, params, opt, tokens, targets, steps):
    """`steps` calls of a mesh train step, each ended by reading its loss:
    (losses, seconds of each, the kernels' launches, the collectives
    issued), counted over the run."""
    from paddle_tpu_torch.distributed import collective as CL
    for k in C.KERNELS:
        k.reset()
    CL.reset_issued()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    return (losses, times, {k.name: k.launches for k in C.KERNELS},
            CL.issued())


def hybrid_phase(torch, np, C, L, H, dev, bench, warmup=2, timed=5):
    """`HYBRID`: the bench's training config (`bench.py:84-87`, nothing
    cut; B 4, T 2,048, M 1, lr 1e-4, remat "dots") through
    `make_train_step(cfg, build_mesh())`: dp = pp = cp = tp = 1 over a
    one-rank NCCL group, every collective issued through it (the
    pipeline's ppermute to itself is a local copy). From `train_run`'s
    params and batch, so its first 3 losses must equal the single-device
    step's (`TRAIN_BENCH` "dots", `bench`) within 1e-3 relative. A1-A4
    launches a step (A1 and A3 once a layer under "dots", A2 and A4
    once), collectives a step by kind and axis, step time beside the
    single-device step's, tokens/s, MFU, one step profiled (busy share;
    where the time goes when the gap passes 10 %). Returns the launches
    of the run."""
    cfg = L.LlamaConfig(**BENCH_TRAIN)
    B, T = BENCH_TRAIN_B, BENCH_TRAIN_T
    mesh = H.build_mesh(device=dev)
    full = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    params = H.shard_params(full, mesh, cfg)
    del full
    opt = H.init_opt_state(params)
    step = H.make_train_step(cfg, mesh, hp=H.AdamWConfig(lr=1e-4),
                             remat="dots")
    rs = np.random.RandomState(0)
    seq = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, T + 1)))
    tokens, targets = seq[:, :-1].to(dev), seq[:, 1:].to(dev)
    torch.cuda.reset_peak_memory_stats()
    steps = warmup + timed
    losses, times, launches, issued = mesh_step_run(
        torch, C, step, params, opt, tokens, targets, steps)
    layers = cfg.num_layers
    expect = {k.name: 0 for k in C.KERNELS}
    expect.update({"flash_attention": layers * steps,
                   "flash_attention_bwd": layers * steps,
                   "fused_ffn": layers * steps,
                   "fused_ffn_bwd": layers * steps})
    require(launches == expect,
            f"HYBRID: launches {launches} != {expect}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    ref = bench["losses"][:3]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:3], ref)]
    require(max(rel) <= 1e-3,
            f"HYBRID: losses {losses[:3]} against the single-device "
            f"step's {ref} (rel {rel}, limit 1e-3)")
    require(all(n > 0 for n in issued.values()) and issued,
            f"HYBRID: no collective issued: {issued}")
    step_s = sum(times[warmup:]) / timed
    tok_s = B * T / step_s
    gap = step_s / bench["step_s"] - 1
    prof = profile_once(torch, lambda: step(params, opt, tokens, targets),
                        "hybrid train step", "PROFILE_HYBRID",
                        names=("nccl", "Memcpy", "copy_"))
    out = {"mesh": dict(mesh.shape), "backend": mesh.backend,
           "layers": layers, "batch": B, "seq": T, "remat": "dots",
           "steps": steps, "losses": losses, "losses_single_device": ref,
           "rel_to_single_device": rel, "step_s": step_s,
           "step_s_each": times, "step_s_single_device": bench["step_s"],
           "gap_to_single_device": gap, "tokens_per_s": tok_s,
           "mfu": cfg.flops_per_token() * tok_s / PEAK_OPS["bfloat16"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": {n: c / steps for n, c in launches.items()
                                 if c},
           "collectives_per_step": {n: c / steps for n, c in issued.items()},
           "device_busy_share": prof["device_busy_share"]}
    print(f"[hybrid] bench config over a {mesh.backend} mesh "
          f"{dict(mesh.shape)}: step {step_s * 1e3:.2f} ms (single device "
          f"{bench['step_s'] * 1e3:.2f}, {gap * 100:+.1f} %), {tok_s:.1f} "
          f"tokens/s, MFU {out['mfu'] * 100:.2f} %, busy "
          f"{(prof['device_busy_share'] or 0) * 100:.1f} %; losses "
          f"{losses[:3]} against {ref}")
    print(f"[hybrid] collectives a step: {out['collectives_per_step']}")
    if gap > 0.10:
        print(f"[hybrid] the mesh step is {gap * 100:.1f} % slower than "
              f"the single-device step: PROFILE_HYBRID's families and "
              f"named kernels above say where it goes")
    print("HYBRID " + json.dumps(out))
    del params, opt, step
    torch.cuda.empty_cache()
    return launches


def hybrid_agree(torch, np, L, H, dev, lr=1e-4):
    """`HYBRID_AGREE`: the reference test's tiny f32 config at dp = pp =
    tp = 1, the same seeded params and batch (M 2), on the card (NCCL,
    the kernels) and on the CPU (a gloo group of one, the plain
    versions), TF32 off: the synced gradients, and after one AdamW step
    at `HYBRID`'s lr the loss and every updated leaf, within 1e-4 of the
    leaf's largest entry. (At the reference test's lr of 1e-2 AdamW's
    first step, g / (|g| + 1e-8), turns a difference of 1e-6 in a
    gradient within a few eps of zero into one of up to lr in the leaf:
    the gradients are the comparison that sees the step's arithmetic.)"""
    old = _no_tf32(torch)
    cfg = L.LlamaConfig(**HYBRID_TINY, dtype=torch.float32)
    full = L.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rs = np.random.RandomState(1)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 16)))
    targets = torch.roll(tokens, -1, 1)
    hp = H.AdamWConfig(lr=lr, weight_decay=0.0)
    got = {}

    def flat(tree, mesh):
        return {k: v.cpu() for k, v in _flat_tree(H.unstack_pipeline(
            H.unshard_params(tree, mesh, cfg))).items()}

    for where in (dev, torch.device("cpu")):
        mesh = H.build_mesh(device=where)
        params = H.shard_params(full, mesh, cfg)
        _, grads = H.loss_and_grads(params, tokens, targets, cfg, 2,
                                    mesh=mesh)
        step = H.make_train_step(cfg, mesh, num_microbatches=2, hp=hp)
        params, _, loss = step(params, H.init_opt_state(params), tokens,
                               targets)
        got[where.type] = (float(loss), flat(grads, mesh),
                           flat(params, mesh))
    _restore_tf32(torch, old)
    (lc, gc, pc), (lx, gx, px) = got["cuda"], got["cpu"]

    def rel(a, b):
        return {k: float((a[k] - b[k]).abs().max()
                         / b[k].abs().max().clamp_min(1e-30)) for k in b}

    grads_rel, leaves_rel = rel(gc, gx), rel(pc, px)
    require(abs(lc - lx) <= 1e-4 * abs(lx),
            f"HYBRID_AGREE: loss {lc} on the card against {lx} on the CPU")
    require(max(grads_rel.values()) <= 1e-4,
            f"HYBRID_AGREE: gradients off by {grads_rel} of their largest")
    require(max(leaves_rel.values()) <= 1e-4,
            f"HYBRID_AGREE: leaves off by {leaves_rel} of their largest")
    out = {"loss_card": lc, "loss_cpu": lx, "lr": lr,
           "grad_rel": grads_rel, "leaf_rel": leaves_rel}
    print(f"[hybrid] agreement, card against CPU: loss {lc:.7f} / "
          f"{lx:.7f}, worst gradient {max(grads_rel.values()):.2e} and "
          f"worst leaf {max(leaves_rel.values()):.2e} of its largest")
    print("HYBRID_AGREE " + json.dumps(out))


def _flat_tree(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k2: v2 for k, v in tree.items()
            for k2, v2 in _flat_tree(v, f"{prefix}/{k}" if prefix
                                     else k).items()}


def hybrid_moe(torch, np, C, L, H, dev, warmup=1, timed=3):
    """`HYBRID_MOE`: Mixtral-8x7B's widths cut to MOE_LAYERS of 32 layers,
    B 1, T 2,048, bf16 compute over f32 masters, through the mesh step at
    world size one (ep = 1: the expert all_to_all over a one-rank group),
    remat True. The memory is reckoned first (params, gradients and the
    two AdamW moments in f32: 16 bytes a param); a peak above 70 GB
    fails. The first step's loss must equal the single-device
    `moe_mlp` loss of the same params and batch within 1e-3 relative when
    no token was dropped. ms a step, tokens/s, peak memory, A1 / A2
    launches, (token, expert) pairs dropped by the capacity. Returns the
    launches of the run."""
    import dataclasses
    cfg = dataclasses.replace(L.LlamaConfig(**MIXTRAL),
                              num_layers=MOE_LAYERS)
    need = cfg.num_params() * 16
    print(f"[hybrid] Mixtral-8x7B widths, {MOE_LAYERS} of 32 layers: "
          f"{cfg.num_params() / 1e9:.2f} B params, {need / 1e9:.1f} GB of "
          f"f32 params, gradients and AdamW moments")
    require(need < 70e9, f"HYBRID_MOE reckons {need / 1e9:.1f} GB")
    mesh = H.build_mesh(device=dev)
    full = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rs = np.random.RandomState(0)
    seq = torch.from_numpy(rs.randint(0, cfg.vocab_size, (MOE_B, MOE_T + 1)))
    tokens, targets = seq[:, :-1].to(dev), seq[:, 1:].to(dev)
    with torch.no_grad():
        single = float(L.loss_fn(full, tokens, targets, cfg))
    params = H.shard_params(full, mesh, cfg)
    del full
    torch.cuda.empty_cache()
    opt = H.init_opt_state(params)
    step = H.make_train_step(cfg, mesh, hp=H.AdamWConfig(lr=1e-4))
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches, issued = mesh_step_run(
        torch, C, step, params, opt, tokens, targets, warmup + timed)
    # the last step's count; every step routes the same batch
    dropped = int(step.last_dropped)
    peak = torch.cuda.max_memory_allocated()
    require(peak <= 70e9, f"HYBRID_MOE: peak {peak / 1e9:.1f} GB")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    steps, layers = warmup + timed, cfg.num_layers
    require(launches["flash_attention"] == 2 * layers * steps
            and launches["flash_attention_bwd"] == layers * steps,
            f"HYBRID_MOE: A1 / A2 launches {launches}")
    rel = abs(losses[0] - single) / abs(single)
    if dropped == 0:
        require(rel <= 1e-3, f"HYBRID_MOE: first loss {losses[0]} against "
                f"moe_mlp's {single} (rel {rel})")
    step_s = sum(times[warmup:]) / timed
    out = {"layers": layers, "batch": MOE_B, "seq": MOE_T,
           "params": cfg.num_params(), "reckoned_bytes": need,
           "losses": losses, "single_device_moe_mlp_loss": single,
           "rel_first_loss": rel, "dropped_pairs": dropped,
           "capacity": H.moe_capacity(MOE_B * MOE_T, cfg),
           "step_s": step_s, "step_s_each": times,
           "tokens_per_s": MOE_B * MOE_T / step_s,
           "max_memory_allocated_bytes": peak,
           "launches_per_step": {n: c / steps for n, c in launches.items()
                                 if c},
           "collectives_per_step": {n: c / steps for n, c in issued.items()}}
    print(f"[hybrid] MoE: step {step_s * 1e3:.1f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s, peak {peak / 2**30:.2f} GiB, "
          f"dropped {dropped}, first loss {losses[0]:.5f} against moe_mlp's "
          f"{single:.5f} ({rel:.1e})")
    print("HYBRID_MOE " + json.dumps(out))
    del params, opt, step
    torch.cuda.empty_cache()
    return launches


def collective_phase(torch, np, dev, iters=200):
    """`COLLECTIVE`: every eager collective over the one-rank NCCL group
    on card tensors, and every op name with a world-one result (all but
    the four point-to-point ones), each equal to that result exactly
    (c_softmax_with_cross_entropy within 1e-6 of torch's own softmax and
    cross entropy); µs of a 1 MiB all_reduce (CUDA events over `iters`);
    the collectives issued, by kind."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import _C_ops
    from paddle_tpu_torch.distributed import collective as CL
    from paddle_tpu_torch.distributed.communication import stream
    _eager_place(P, dev)
    CL.reset_issued()
    g = CL.init_parallel_env(dev)
    require(g.backend == "nccl" and g.nranks == 1, f"COLLECTIVE: {g}")
    x = torch.arange(12, dtype=torch.float32, device=dev).reshape(4, 3) + 1
    checked = []

    def same(name, got, want):
        require(torch.equal(got, want), f"COLLECTIVE: {name} {got} != {want}")
        checked.append(name)

    for op in ("sum", "max", "min", "prod", "avg"):
        t = x.clone()
        CL.all_reduce(t, op=op)
        same(f"all_reduce_{op}", t, x)
    lst = []
    CL.all_gather(lst, x)
    same("all_gather", torch.stack(lst), x[None])
    t = torch.empty_like(x)
    CL.all_gather_into_tensor(t, x)
    same("all_gather_into_tensor", t, x)
    t = torch.empty_like(x)
    CL.reduce_scatter(t, x)
    same("reduce_scatter", t, x)
    lst = []
    CL.alltoall(lst, [x])
    same("alltoall", lst[0], x)
    same("alltoall_single", CL.alltoall_single(None, x), x)
    for name, fn in (("broadcast", lambda t: CL.broadcast(t, src=0)),
                     ("reduce", lambda t: CL.reduce(t, dst=0)),
                     ("stream.all_reduce", lambda t: stream.all_reduce(
                         t, use_calc_stream=True))):
        t = x.clone()
        fn(t)
        same(name, t, x)
    t = torch.empty_like(x)
    CL.scatter(t, [x], src=0)
    same("scatter", t, x)
    CL.barrier()
    objs = []
    CL.all_gather_object(objs, {"rank": 0})
    require(objs == [{"rank": 0}], f"COLLECTIVE: all_gather_object {objs}")
    X = P.to_tensor(x.cpu().numpy())
    xs = x.cpu()
    for name in ("all_reduce", "c_allreduce_sum", "c_allreduce_max",
                 "c_allreduce_min", "c_allreduce_prod", "mp_allreduce_sum",
                 "broadcast", "c_broadcast", "c_identity", "npu_identity",
                 "share_data", "depend", "copy_to", "sync_calc_stream",
                 "memcpy_h2d", "all_gather", "c_allgather", "c_concat",
                 "reduce_scatter", "all_to_all", "c_scatter", "reduce",
                 "c_reduce_sum", "dist_concat", "partial_allgather",
                 "barrier", "global_scatter", "global_gather", "assign_out_"):
        args = {"global_scatter": ([3, 1], [3, 1]),
                "global_gather": ([3, 1], [3, 1]),
                "assign_out_": (X,)}.get(name, ())
        same(f"op {name}", getattr(_C_ops, name)(X, *args)._data.cpu(), xs)
    same("op memcpy_d2h", _C_ops.memcpy_d2h(X)._data, xs)
    same("op shape", _C_ops.shape(X)._data.cpu(),
         torch.tensor([4, 3], dtype=torch.int32))
    same("op full_", _C_ops.full_(X, value=7.0)._data.cpu(),
         torch.full((4, 3), 7.0))
    same("op full_int_array", _C_ops.full_int_array([2, 5, 9])._data.cpu(),
         torch.tensor([2, 5, 9]))
    same("op full_with_tensor", _C_ops.full_with_tensor(
        P.to_tensor(np.float32(3.5)),
        P.to_tensor(np.array([2, 2], np.int64)))._data.cpu(),
        torch.full((2, 2), 3.5))
    same("op assign_value_", _C_ops.assign_value_(
        X, shape=(2, 2), values=(1.0, 2.0, 3.0, 4.0))._data.cpu(),
        torch.tensor([[1.0, 2.0], [3.0, 4.0]]))
    same("op set", _C_ops.set(X, X)._data.cpu(), xs)
    same("op slice", _C_ops.slice(X, axes=[0], starts=[1],
                                  ends=[3])._data.cpu(), xs[1:3])
    want = xs.clone()
    want[1:3] = 0
    same("op set_value_with_tensor", _C_ops.set_value_with_tensor(
        X, P.to_tensor(np.zeros((2, 3), np.float32)), starts=[1], ends=[3],
        steps=[1], axes=[0])._data.cpu(), want)
    same("op trans_layout", _C_ops.trans_layout(X, perm=[1, 0])._data.cpu(),
         xs.T)
    views, fused = _C_ops.coalesce_tensor([X])
    same("op coalesce_tensor", fused._data.cpu(), xs.reshape(-1))
    same("op fetch_barrier", _C_ops.fetch_barrier([X])[0]._data.cpu(), xs)
    same("op comm_init_all", _C_ops.comm_init_all()._data.cpu(),
         torch.zeros((), dtype=torch.int32))
    labels = torch.tensor([0, 2, 1, 0])
    sm, loss = _C_ops.c_softmax_with_cross_entropy(
        X, P.to_tensor(labels.numpy()))
    ce = torch.nn.functional.cross_entropy(x, labels.to(dev),
                                           reduction="none")
    require(torch.allclose(loss._data[:, 0], ce, rtol=1e-6, atol=0)
            and torch.allclose(sm._data, torch.softmax(x, -1), rtol=1e-6,
                               atol=0),
            "COLLECTIVE: c_softmax_with_cross_entropy")
    checked.append("op c_softmax_with_cross_entropy")
    # 1 MiB all_reduce, in place, CUDA events
    buf = torch.ones(262144, dtype=torch.float32, device=dev)
    for _ in range(10):
        CL.all_reduce(buf)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        CL.all_reduce(buf)
    end.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(end) / iters * 1e3
    issued = CL.issued()
    require(issued.get("all_reduce/world", 0) > 0,
            f"COLLECTIVE: no all_reduce issued: {issued}")
    out = {"checked": len(checked), "names": checked,
           "all_reduce_1MiB_us": us, "issued": issued}
    print(f"[collective] {len(checked)} results exact over the one-rank "
          f"NCCL group; a 1 MiB all_reduce {us:.2f} us; issued {issued}")
    print("COLLECTIVE " + json.dumps(out))
    CL.destroy_process_group()


def hybrid_phases(torch, np, C, L, H, dev, bench):
    """Phase 5b: `HYBRID`, `HYBRID_AGREE`, `HYBRID_MOE`, `COLLECTIVE`,
    with the card's memory freed first. Returns the launches of the
    hybrid and MoE paths."""
    torch.cuda.empty_cache()
    paths = {"hybrid": hybrid_phase(torch, np, C, L, H, dev, bench)}
    hybrid_agree(torch, np, L, H, dev)
    paths["hybrid_moe"] = hybrid_moe(torch, np, C, L, H, dev)
    collective_phase(torch, np, dev)
    return paths


def hybrid_only(torch, np, C, L, H, build, smi):
    """`python3 chip_smoke.py --hybrid`: phase 5b alone, with A1-A4's
    libraries built first and the single-device yardstick (`TRAIN_BENCH`
    "dots") run before it."""
    print(f"[hybrid] {smi}")
    build.build_all([C.flash_attention.KERNEL_FWD,
                     C.flash_attention.KERNEL_BWD, C.fused_ffn.KERNEL,
                     C.fused_ffn.KERNEL_BWD])
    dev = torch.device("cuda")
    cfg = L.LlamaConfig(**BENCH_TRAIN)
    _, losses, step_s = train_run(torch, np, C, L, H, dev, cfg, "dots",
                                  BENCH_TRAIN_B, BENCH_TRAIN_T, 2, 5,
                                  "TRAIN_BENCH", "PROFILE_TRAIN_BENCH")
    hybrid_phases(torch, np, C, L, H, dev,
                  {"losses": losses, "step_s": step_s})


# ---------------------------------------------------------------------------
# phase 5c: DataParallel and fleet at world one (bench.py:310-468)
# ---------------------------------------------------------------------------
BERT_DP_AGREE_STEPS = 3
BERT_DP_CPU_RTOL = 1e-5          # card against CPU, TF32 off
BERT_DP_PLAIN_RTOL = 1e-6        # fleet against the plain loop, the card
DP_OVERLAP = dict(din=256, dhid=512, B=32, steps=5)   # bench.py:413-431


def bert_dp_losses(np, P, c, state, place, steps, use_fleet):
    """From `state`, `steps` AdamW steps on `place`, through fleet (a
    world of one on `place`'s backend) or the plain loop; the losses."""
    from paddle_tpu_torch.distributed import collective as CL
    from paddle_tpu_torch.distributed import fleet
    P.set_device(place)
    model = bert_model(P, c)
    missing, unexpected = model.set_state_dict(state)
    require(not missing and not unexpected,
            f"BERT_DP state dict: missing {missing}, unexpected "
            f"{unexpected}")
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters())
    if use_fleet:
        CL.init_parallel_env("cpu" if place == "cpu" else "cuda")
        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    batch = bert_batch(np, P, c)
    return [float(bert_step(P, c, model, opt, batch)) for _ in range(steps)]


def bert_dp_phase(torch, np, dev, c=None):
    """`BERT_DP`: `bench_bert_dp_sharding` (`bench.py:310-380`) at its own
    config (the `BERT` phase's model), through fleet at world one:
    `fleet.init(is_collective=True)`, `distributed_model` (the model
    itself at dp 1, as the reference's), `distributed_optimizer`
    (`HybridParallelOptimizer` over AdamW 1e-4); 3 warm-up and 5 timed
    steps pipelined (the loss read `async_engine.depth()` steps late):
    tokens/s, ms a batch, the mode, the collectives a step, the buckets
    DataParallel's reducer would issue above one rank, peak
    memory. Then 3 steps from one state dict, TF32 off: fleet on the
    card against fleet on the CPU (gloo) within BERT_DP_CPU_RTOL, and
    against the plain loop on the card within BERT_DP_PLAIN_RTOL."""
    import collections

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import async_engine as AE
    from paddle_tpu_torch.distributed import collective as CL
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel import _build_plan
    c = c or BERT
    place = _eager_place(P, dev)
    cuda = dev.type == "cuda"
    P.seed(0)
    model = bert_model(P, c)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    CL.init_parallel_env(dev.type)
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(P.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()))
    mode = (f"fleet dp+sharding (world="
            f"{fleet.get_hybrid_communicate_group().nranks}) (pipelined)")
    require(type(opt).__name__ == "HybridParallelOptimizer",
            f"BERT_DP: distributed_optimizer gave {type(opt).__name__}")
    batch = bert_batch(np, P, c)
    for _ in range(BERT_WARM):
        loss = bert_step(P, c, model, opt, batch)
    float(loss.numpy())
    depth = AE.depth()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    CL.reset_issued()
    pending = collections.deque()
    t0 = time.perf_counter()
    for _ in range(BERT_STEPS):
        pending.append(bert_step(P, c, model, opt, batch))
        if len(pending) > depth:
            float(pending.popleft().numpy())
    losses = []
    while pending:
        losses.append(float(pending.popleft().numpy()))
    dt = time.perf_counter() - t0
    issued = {k: v / BERT_STEPS for k, v in CL.issued().items()}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    require(all(math.isfinite(v) for v in losses),
            f"BERT_DP losses {losses}")
    out = {"config": c, "mode": mode, "warmup": BERT_WARM,
           "steps": BERT_STEPS, "model": type(model).__name__,
           "optimizer": type(opt).__name__,
           "tokens_per_s": c["B"] * c["T"] * BERT_STEPS / dt,
           "batch_ms": dt * 1e3 / BERT_STEPS, "async_depth": depth,
           "collectives_per_step": issued,
           "reducer_buckets_above_one_rank": len(_build_plan(
               list(model.parameters()), None, 25, 1, None).buckets),
           "max_memory_allocated_bytes": peak, "last_loss": losses[-1]}
    print(f"[bert_dp] {mode}: {out['tokens_per_s']:.1f} tokens/s, "
          f"{out['batch_ms']:.3f} ms a batch, peak "
          f"{(peak or 0) / 2**20:.1f} MiB; collectives a step {issued}; "
          f"{out['reducer_buckets_above_one_rank']} reducer buckets above "
          f"one rank")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = bert_dp_losses(np, P, c, state, place, BERT_DP_AGREE_STEPS,
                              True)
        plain = bert_dp_losses(np, P, c, state, place, BERT_DP_AGREE_STEPS,
                               False)
        if cuda:
            # the CPU's fleet needs a gloo world: the card's goes first
            CL.destroy_process_group()
        cpu = bert_dp_losses(np, P, c, state, "cpu", BERT_DP_AGREE_STEPS,
                             True)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
        CL.destroy_process_group()
        P.set_device(place)
    rel_cpu = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    rel_plain = max(abs(a - b) / abs(b) for a, b in zip(card, plain))
    require(rel_cpu <= BERT_DP_CPU_RTOL,
            f"BERT_DP losses card {card} against CPU {cpu}: rel "
            f"{rel_cpu:.3g} > {BERT_DP_CPU_RTOL}")
    require(rel_plain <= BERT_DP_PLAIN_RTOL,
            f"BERT_DP losses through fleet {card} against the plain loop "
            f"{plain}: rel {rel_plain:.3g} > {BERT_DP_PLAIN_RTOL}")
    out.update(card_losses=card, cpu_losses=cpu, plain_losses=plain,
               max_rel_to_cpu=rel_cpu, max_rel_to_plain=rel_plain)
    print(f"[bert_dp] {BERT_DP_AGREE_STEPS} steps, TF32 off: card against "
          f"CPU rel {rel_cpu:.3g} (limit {BERT_DP_CPU_RTOL}), fleet against "
          f"the plain loop rel {rel_plain:.3g} (limit {BERT_DP_PLAIN_RTOL})")
    print("BERT_DP " + json.dumps(out))
    return out


def dp_overlap_phase(torch, np, dev, c=None):
    """`DP_OVERLAP`: `_dp_overlap_details` (`bench.py:384-468`) at world
    one over the card's group: DataParallel over Linear 256-512, relu,
    Linear 512-256 with Adam 1e-3, 5 steps on one batch of 32, the median
    ms of steps 2-5 (the bench's host clock, each step ended by a
    synchronize) in barrier, overlapped and ZeRO-1 modes, on the f32 and
    the int8 wire; the int8 wire's ratio
    from the buckets' own sizes (their f32 bytes over `wire_layout`'s
    int8 bytes); ZeRO-1's optimizer-state bytes; the overlapped run's
    parameters bit-equal to the barrier run's."""
    import statistics

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed import collective as CL
    from paddle_tpu_torch.distributed import parallel as DP
    c = c or DP_OVERLAP
    place = _eager_place(P, dev)
    g = CL.init_parallel_env(dev.type)

    def train(overlap, shard, wire=""):
        flags.set_flags({"dp_overlap": overlap, "dp_shard_update": shard,
                         "dp_grad_comm_dtype": wire})
        try:
            P.seed(0)
            m = P.nn.Sequential(P.nn.Linear(c["din"], c["dhid"]),
                                P.nn.ReLU(),
                                P.nn.Linear(c["dhid"], c["din"]))
            d = DP.DataParallel(m, group=g)
            o = P.optimizer.Adam(learning_rate=1e-3,
                                 parameters=m.parameters())
            so = DP.sharded_update(o, d) if shard else o
            x = P.to_tensor(np.random.RandomState(0).randn(
                c["B"], c["din"]).astype(np.float32))
            times = []
            for _ in range(c["steps"]):
                t0 = time.perf_counter()
                d(x).mean().backward()
                so.step()
                so.clear_grad()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            plan = d._reducer._ensure_plan()
            params = [p.numpy() for p in m.parameters()]
        finally:
            flags.set_flags({"dp_overlap": True, "dp_shard_update": False,
                             "dp_grad_comm_dtype": ""})
        return statistics.median(times[1:]) * 1e3, so, plan, params

    out = {"world": g.nranks, "config": c}
    runs = {}
    for wire in ("", "int8"):
        for name, overlap, shard in (("barrier", False, False),
                                     ("overlap", True, False),
                                     ("shard", True, True)):
            key = name + ("_int8" if wire else "") + "_ms"
            out[key], so, plan, params = train(overlap, shard, wire)
            runs[key] = params
            if wire and name == "overlap":
                ref = sum(b.ref_bytes for b in plan.buckets)
                wire_b = sum(b.nbytes for b in plan.buckets)
                out.update(buckets=len(plan.buckets), wire_bytes=wire_b,
                           ref_bytes=ref, int8_wire_ratio=ref / wire_b)
            if not wire and name == "shard":
                out["opt_state_bytes_per_dev"] = \
                    so.optimizer_state_bytes_per_device()
    same = all(np.array_equal(a, b) for a, b in
               zip(runs["overlap_ms"], runs["barrier_ms"]))
    require(same, "DP_OVERLAP: the overlapped run's parameters differ "
            "from the barrier run's")
    out["overlap_params_equal_barrier"] = same
    CL.destroy_process_group()
    P.set_device(place)
    print(f"[dp_overlap] world {out['world']}: barrier "
          f"{out['barrier_ms']:.3f} ms, overlap {out['overlap_ms']:.3f}, "
          f"shard {out['shard_ms']:.3f}; int8 wire "
          f"{out['barrier_int8_ms']:.3f} / {out['overlap_int8_ms']:.3f} / "
          f"{out['shard_int8_ms']:.3f}; "
          f"wire ratio {out['int8_wire_ratio']:.4f} over {out['buckets']} "
          f"buckets; ZeRO-1 state {out['opt_state_bytes_per_dev']} bytes")
    print("DP_OVERLAP " + json.dumps(out))
    return out


def dp_phases(torch, np, dev):
    """Phase 5c: `BERT_DP`, `DP_OVERLAP`."""
    torch.cuda.empty_cache()
    bert_dp_phase(torch, np, dev)
    dp_overlap_phase(torch, np, dev)


def dp_only(torch, np, C, L, H, build, smi):
    """`python3 chip_smoke.py --dp`: phase 5c, then `HYBRID` on the
    bucketed gradient sync with its single-device yardstick
    (`TRAIN_BENCH` "dots") and A1-A4's libraries built first."""
    print(f"[dp] {smi}")
    dev = torch.device("cuda")
    dp_phases(torch, np, dev)
    build.build_all([C.flash_attention.KERNEL_FWD,
                     C.flash_attention.KERNEL_BWD, C.fused_ffn.KERNEL,
                     C.fused_ffn.KERNEL_BWD])
    cfg = L.LlamaConfig(**BENCH_TRAIN)
    _, losses, step_s = train_run(torch, np, C, L, H, dev, cfg, "dots",
                                  BENCH_TRAIN_B, BENCH_TRAIN_T, 2, 5,
                                  "TRAIN_BENCH", "PROFILE_TRAIN_BENCH")
    torch.cuda.empty_cache()
    hybrid_phase(torch, np, C, L, H, dev,
                 {"losses": losses, "step_s": step_s})


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
        k.reset()
    out, grads = step()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in C.KERNELS}
    a8_paths = dict(C.fused_ffn.KERNEL_EPILOGUE.paths)
    expect = {k.name: 0 for k in C.KERNELS}
    expect.update({"fused_gemm_epilogue": 4 * layers, "fused_glu": layers,
                   "flash_attention": layers, "flash_attention_bwd": layers})
    require(launches == expect, f"varlen launches {launches} != {expect}")
    require(a8_paths == {"wgmma": 4 * layers}, f"varlen: A8's launches by "
            f"path {a8_paths}, expected all {4 * layers} on wgmma")
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
           "epilogue_launches_by_path": a8_paths,
           "xcheck_attention": h_attn, "xcheck_ffn": h_ffn}
    print(f"[varlen] forward {fwd_s * 1e3:.1f} ms, step (forward + backward) "
          f"{step_s * 1e3:.1f} ms, {T / step_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; projections {flops_fwd / 1e12:.2f} TFLOP "
          f"a forward")
    print(f"[varlen] launches {launches} (expected {expect}); A8 by path "
          f"{a8_paths}")
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
    # a sampled row at top_p = 0 beside a greedy row: masking leaves the
    # sampled row all -inf, whose draw is token 0 (as the reference's)
    streams = {}
    prompt = rs.randint(0, cfg.vocab_size, 9).tolist()
    for where in ("cpu", dev):
        eng = Engine(cfg, params, block_size=16, max_batch=4,
                     token_budget=16, max_len=128, device=where)
        greedy = eng.submit(prompt, max_new_tokens=8)
        zero = eng.submit([1, 2, 3, 4], max_new_tokens=8, temperature=1.0,
                          top_p=0.0, seed=1)
        done = {c.rid: c.output_tokens for c in eng.run()}
        streams[str(where)] = (done[greedy], done[zero])
    require(streams[str(dev)][1] == [0] * 8 and streams[str(dev)][0]
            == streams["cpu"][0], f"top_p = 0 beside a greedy row: card "
            f"{streams[str(dev)]}, CPU {streams['cpu']}")
    print(f"[agree] a top_p = 0 row beside a greedy row: tokens 0 x 8 on "
          f"the card; the greedy row's 8 tokens equal the CPU's")


def predictor_agreement(torch, np, L, Predictor, dev):
    """A tiny float32 predictor on the CPU (plain versions, eager steps)
    and on the card (kernels, replayed chunks of 32, 8 and 1): identical
    greedy tokens over 41 new tokens, and each step's logits (the
    per-token loop, greedy chunks of one replayed) within rtol 1e-4 of
    their largest entry."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    prompt = np.random.RandomState(9).randint(0, cfg.vocab_size, (3, 20))
    runs = {}
    for where in ("cpu", dev):
        pred = Predictor(cfg, params, max_len=96, device=where)
        toks = pred.generate(prompt, max_new_tokens=41).cpu()
        _, scores = pred.generate(prompt, max_new_tokens=12,
                                  return_scores=True)
        runs[str(where)] = (toks, scores.cpu())
    (t_cpu, s_cpu), (t_gpu, s_gpu) = runs["cpu"], runs[str(dev)]
    require(torch.equal(t_gpu, t_cpu), f"predictor greedy tokens differ: "
            f"{t_gpu[:, 20:].tolist()} vs {t_cpu[:, 20:].tolist()}")
    scale = s_cpu.abs().max().item()
    err = (s_gpu - s_cpu).abs().max().item()
    require(err <= 1e-4 * scale, f"predictor logits differ by {err:.3g} "
            f"(limit {1e-4 * scale:.3g})")
    print(f"[agree-predictor] 3 x 41 greedy tokens equal (chunks 32, 8, 1 "
          f"replayed on the card); 12 steps' logits within {err / scale:.3g} "
          f"of the largest (limit 1e-4)")


W8_BF16_LOGIT_TOL = 2 ** -6
# the quantized engines of the agreement: (quant_mode, quant_kv)
AGREE_QUANT = (("w8", True), ("w8a8", True), ("fp8", False))


def recorded_xq(Q):
    """A context that records the int8 activations every w8a8 product of
    the port rounds (`Q.int8_matmul`'s first operand), on the host, in
    call order: the CPU's and the card's, compared entry for entry."""
    import contextlib

    T = sys.modules[Q.int8_matmul.__module__]

    @contextlib.contextmanager
    def recording():
        rec, orig = [], T.int8_matmul

        def int8_matmul(xq, wq):
            rec.append(xq.cpu())
            return orig(xq, wq)

        T.int8_matmul = int8_matmul
        try:
            yield rec
        finally:
            T.int8_matmul = orig
    return recording()


def agreement_w8(torch, np, L, Q, Engine, dev):
    """The quantized engines on a tiny model, on the CPU (plain versions)
    and on the card (kernels), one manifest calibrated on the CPU: w8
    weights with int8 pages (A6, A5 int8), w8a8 with int8 pages (the int8
    product, A5 int8) and fp8 weights with fp pages (A5).

    float32: identical greedy tokens, int8 page entries at most one step
    apart (a value at a rounding boundary may round either way after f32
    sums in another order; the count is printed), and first-tick logits
    within 1e-3 of their largest entry. That limit is ten times the f32
    agreement's because each flipped entry moves its scores by a whole
    quant step (absmax / 127), not by an f32 rounding. w8a8 rounds its
    activations to int8 the same way: the count of those entries that
    differ between the CPU and the card over the first tick is printed.

    bfloat16 (A6's tensor-core kernels end to end; the int8 and fp8
    products): first-tick logits within 2^-6 of their largest entry; the
    count of greedy tokens that differ is printed. Every bf16
    intermediate rounds once on each side, and where f32 sums in another
    order put a value across a rounding boundary the two sides differ by
    one bf16 ulp, which the next layers carry on: the logits are bf16 and
    differ by about one ulp of the largest entry, 2^-8 to 2^-7 of it
    (0.42-0.69 % on the CPU when only A6's summation order changes, over
    4 layers). 1e-3 is below that resolution; 2^-6 is two to four of
    those ulps."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=dtype)
        params = L.init_params(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
        rs = np.random.RandomState(6)
        manifest = Q.calibrate(cfg, params,
                               [rs.randint(0, cfg.vocab_size, (2, 48))])
        prompts = [rs.randint(0, cfg.vocab_size, n).tolist()
                   for n in (40, 7)]
        for mode, kv in AGREE_QUANT:
            for prompt in prompts:
                agree_quant_case(torch, Q, Engine, dev, cfg, params,
                                 manifest, mode, kv, prompt)


def agree_quant_case(torch, Q, Engine, dev, cfg, params, manifest, mode, kv,
                     prompt):
    """One prompt of `agreement_w8` in one quant mode and dtype."""
    runs = {}
    for where in ("cpu", dev):
        eng = Engine(cfg, params, block_size=16, max_batch=4,
                     token_budget=16, max_len=128, quant_mode=mode,
                     quant_kv=kv, quant_manifest=manifest, device=where)
        eng.submit(prompt, max_new_tokens=24)
        first, tokens, gaps = None, [], []
        with recorded_xq(Q) as xq:       # the first tick: eager on both
            ticks = [eng.step()]
        while True:
            row = eng.last_logits[0].float().cpu()
            if first is None:
                first = row
            for ev in ticks.pop():
                if ev.token >= 0:
                    tokens.append(ev.token)
                    top2 = torch.topk(row, 2).values
                    gaps.append(float(top2[0] - top2[1]))
            if not eng.has_work():
                break
            ticks.append(eng.step())
        pages = [t.cpu().int() for t in (eng._key_cache, eng._value_cache)]
        runs[str(where)] = (first, tokens, gaps, pages, xq)
    (f_cpu, t_cpu, gaps, p_cpu, x_cpu), (f_gpu, t_gpu, _, p_gpu, x_gpu) = \
        runs["cpu"], runs[str(dev)]
    scale = f_cpu.abs().max().item()
    err = (f_gpu - f_cpu).abs().max().item()
    label = f"[agree-{mode}] {str(cfg.dtype).split('.')[-1]}, prompt " \
            f"{len(prompt)}"
    require(len(x_gpu) == len(x_cpu) == (
        0 if mode != "w8a8" else 7 * cfg.num_layers + 1),
        f"{label}: {len(x_gpu)} / {len(x_cpu)} int8 products in a tick")
    xq_diff = sum(int((a != b).sum()) for a, b in zip(x_gpu, x_cpu))
    xq_total = sum(a.numel() for a in x_cpu)
    xq_note = (f"; {xq_diff} of {xq_total} int8 activation entries of the "
               f"first tick differ" if mode == "w8a8" else "")
    if cfg.dtype == torch.bfloat16:
        require(bool(torch.isfinite(f_gpu).all())
                and err <= W8_BF16_LOGIT_TOL * scale,
                f"{label}: quantized bf16 first-tick logits differ by "
                f"{err:.3g} (limit {W8_BF16_LOGIT_TOL * scale:.3g})")
        differ = sum(a != b for a, b in zip(t_gpu, t_cpu))
        print(f"{label}: first-tick logits within {err / scale:.3g} of the "
              f"largest (limit 2^-6; 1e-3 is below bf16's resolution); "
              f"{differ} of {len(t_cpu)} greedy tokens differ{xq_note}")
        return
    require(err <= 1e-3 * scale, f"{label}: quantized first-tick logits "
            f"differ by {err:.3g} (limit {1e-3 * scale:.3g})")
    require(t_gpu == t_cpu, f"{label}: quantized greedy tokens differ: "
            f"{t_gpu} vs {t_cpu}")
    pages_note = ""
    if kv:
        steps = [(a - b).abs() for a, b in zip(p_gpu, p_cpu)]
        worst = max(int(d.max()) for d in steps)
        require(worst <= 1, f"{label}: int8 pages differ by {worst} steps")
        one = sum(int((d == 1).sum()) for d in steps)
        total = sum(d.numel() for d in steps)
        pages_note = (f"; {one} of {total} int8 page entries one step "
                      f"apart, none more")
    print(f"{label}: first-tick logits within {err / scale:.3g} of the "
          f"largest (limit 1e-3); {len(t_cpu)} greedy tokens equal (min "
          f"top-2 gap {min(gaps):.3g}){pages_note}{xq_note}")


def train_agreement(torch, np, L, H, dev, steps=3):
    """A tiny float32 model trained on the CPU (plain versions) and on the
    card (kernels), TF32 off: first-step loss gradients (remat True and
    "dots"), the losses of `steps` AdamW steps, and remat True against
    saving every activation and against "dots", bit for bit."""
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
    for where, remat in (("cpu", True), (dev, True), (dev, False),
                         (dev, "dots")):
        loss, g = H.loss_and_grads(fresh(where), tokens.to(where),
                                   targets.to(where), cfg, remat=remat)
        runs.append((float(loss), [t.cpu() for t in H._flatten(g)[0]]))
    (l_cpu, g_cpu), (l_gpu, g_gpu), (l_save, g_save), (l_dots, g_dots) = \
        runs
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-5, atol=0)
    # f32 on both sides, sums in other orders through 4 layers of
    # products and softmaxes: 1e-4 of each leaf's largest entry
    worst = 0.0
    for g_card in (g_gpu, g_dots):
        for a, b in zip(g_card, g_cpu):
            err = (a - b).abs().max().item() / b.abs().max().item()
            worst = max(worst, err)
    require(worst <= 1e-4, f"first-step gradients differ by {worst:.3g} of "
            "a leaf's largest entry")
    for other, l_other, g_other in (("False", l_save, g_save),
                                    ("'dots'", l_dots, g_dots)):
        require(l_other == l_gpu and all(torch.equal(a, b)
                                         for a, b in zip(g_other, g_gpu)),
                f"remat=True and remat={other} give different gradients on "
                f"the card")
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
    print(f"[agree-train] first-step gradients (remat True and 'dots') "
          f"within {worst:.3g} of each leaf's largest entry (limit 1e-4); "
          f"the card's gradients bit-equal under remat True, False and "
          f"'dots'; {steps} AdamW steps card {l_gpu} vs cpu {l_cpu} (rtol "
          f"1e-4)")


def varlen_agreement(torch, FF, dev, layers=2, lens=(37, 100, 19, 100)):
    """A tiny varlen stack (hidden 64, 4 heads, 2 kv heads) on the CPU
    (plain versions) and on the card (A8, A9, A1/A2 segment mode), TF32
    off, forward and backward.

    float32: the output and the input and weight gradients within 1e-4
    of each leaf's largest entry (f32 sums in other orders through two
    layers of norms, products and softmaxes).

    bfloat16 (A8 on its wgmma kernel): the output under the bf16
    cross-check rule (XCHECK_RULE) against the CPU's bf16 output; each
    leaf (output and gradients) no further from the f32 result than the
    CPU's bf16 run is, by rms: rms(card - f32) <= 1.5 rms(cpu - f32).
    The gradients are not held to XCHECK_RULE elementwise: one bf16
    rounding flipped by another summation order is carried through two
    layers forward and back, and on the CPU alone, with only A8's
    summation order changed, the input gradient reaches 1.0-1.3 x that
    rule's elementwise bound."""
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

    def run(where, dtype):
        ws = [{n: t.detach().to(where, dtype).requires_grad_()
               for n, t in lw.items()} for lw in weights]
        h_in = h0.to(where, dtype).requires_grad_()
        cu, pos = packed_batch(torch, where, lens)
        h = h_in
        for lw in ws:
            h = varlen_layer(ops, IF, h, lw, cu, pos, H, KV)
        leaves = [h_in] + [t for lw in ws for t in lw.values()]
        grads = torch.autograd.grad(h, leaves, cot.to(where, dtype))
        return [t.detach().cpu().float() for t in (h, *grads)]

    truth, card = run("cpu", torch.float32), run(dev, torch.float32)
    worst = 0.0
    for a, b in zip(card, truth):
        worst = max(worst, (a - b).abs().max().item() / b.abs().max().item())
    require(worst <= 1e-4, f"varlen stack card vs cpu differ by {worst:.3g} "
            "of a leaf's largest entry")
    print(f"[agree-varlen] {layers}-layer f32 stack over {list(lens)}: output "
          f"and {len(truth) - 1} gradients within {worst:.3g} of each "
          f"leaf's largest entry (limit 1e-4)")

    bf = torch.bfloat16
    FF.KERNEL_EPILOGUE.reset()
    card, cpu = run(dev, bf), run("cpu", bf)
    require(FF.KERNEL_EPILOGUE.paths == {"wgmma": 4 * layers},
            f"bf16 varlen agreement: A8 by path {FF.KERNEL_EPILOGUE.paths}")
    h_out = held_xcheck("bf16 varlen output, card vs cpu", card[0], cpu[0])
    ratio = 0.0
    for a, b, t in zip(card, cpu, truth):
        e_card = (a - t).square().mean().sqrt().item()
        e_cpu = (b - t).square().mean().sqrt().item()
        ratio = max(ratio, e_card / e_cpu)
    require(ratio <= 1.5, f"bf16 varlen stack: a leaf of the card is "
            f"{ratio:.3g} x as far from f32 as the cpu's (limit 1.5)")
    print(f"[agree-varlen] {layers}-layer bf16 stack: A8 on wgmma "
          f"({4 * layers} launches); {held_str('output', h_out)} (rule "
          f"{XCHECK_RULE}); every leaf's rms distance from f32 at most "
          f"{ratio:.3g} x the cpu's bf16 run's (limit 1.5)")


# ---------------------------------------------------------------------------
# phase 8: the eager paddle API (the eager core, LeNet)
# ---------------------------------------------------------------------------

EAGER_N, EAGER_WARM = 2000, 8          # bench.py:1114-1126
LENET_B, LENET_WARM, LENET_STEPS = 64, 2, 20
LENET_AGREE_STEPS = 8
# card against CPU, f32 with TF32 off: cuDNN's and the CPU's convolutions
# sum in different orders (and cuDNN's backward may vary run to run), and
# 8 Momentum steps compound it; the tolerance is relative, per loss
LENET_RTOL = 1e-4


def eager_dispatch(torch, np, dev):
    """`EAGER_DISPATCH`: bench_eager_dispatch_add on the port's eager API,
    beside the same loop on the bare torch tensors."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops import dispatch as D
    place = _eager_place(P, dev)
    rs = np.random.RandomState(0)
    a = P.to_tensor(rs.rand(256, 256).astype(np.float32))
    b = P.to_tensor(rs.rand(256, 256).astype(np.float32))
    require(a.place == place and a._data.device.type == dev.type,
            f"to_tensor not on {place}")
    for _ in range(EAGER_WARM):
        c = a + b
    float(c.sum().numpy())
    D.reset_dispatch_cache_stats()
    t0 = time.perf_counter()
    for _ in range(EAGER_N):
        c = a + b
    total = float(c.sum().numpy())
    dt = time.perf_counter() - t0
    cache = D.dispatch_cache_stats()
    ta, tb = a._data, b._data
    for _ in range(EAGER_WARM):
        tc = ta + tb
    float(tc.sum())
    t0 = time.perf_counter()
    for _ in range(EAGER_N):
        tc = ta + tb
    bare_total = float(tc.sum())
    dt_bare = time.perf_counter() - t0
    require(type(c._data) is torch.Tensor and c._data.device.type == dev.type,
            f"the port's a + b did not run on {place}")
    require(total == bare_total, f"sums differ: {total} != {bare_total}")
    require(cache["dispatches"] == EAGER_N + 1 and cache["traces"] == 0,
            f"not every a + b went through the port's dispatch: {cache}")
    out = {"dispatches": EAGER_N, "dispatches_per_s": EAGER_N / dt,
           "us_per_dispatch": 1e6 * dt / EAGER_N,
           "bare_torch_dispatches_per_s": EAGER_N / dt_bare,
           "bare_torch_us_per_dispatch": 1e6 * dt_bare / EAGER_N,
           "port_layer_us_per_dispatch": 1e6 * (dt - dt_bare) / EAGER_N,
           "hit_rate": cache["hit_rate"], "traces": cache["traces"],
           "cache": cache}
    print(f"[eager] a + b, 256 x 256 f32 on {place}: "
          f"{out['dispatches_per_s']:.1f} dispatches/s, "
          f"{out['us_per_dispatch']:.2f} us a dispatch (bare torch "
          f"{out['bare_torch_us_per_dispatch']:.2f} us); hit_rate "
          f"{cache['hit_rate']}, traces {cache['traces']} (no cache, "
          f"nothing traced)")
    print("EAGER_DISPATCH " + json.dumps(out))
    return out


def _eager_place(P, dev):
    """Point the eager API at `dev` (the card, "gpu:0"; "cpu" for the
    tests' run of these phases) and return the place's name."""
    place = "gpu:0" if dev.type == "cuda" else "cpu"
    P.set_device(place)
    return place


def lenet_losses(np, P, state, place, steps, batches):
    """LeNet from `state` on `place`, `steps` Momentum steps over the
    batches; the losses."""
    P.set_device(place)
    model = P.vision.models.LeNet()
    missing, unexpected = model.set_state_dict(state)
    require(not missing and not unexpected,
            f"LeNet state dict: missing {missing}, unexpected {unexpected}")
    opt = P.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                               parameters=model.parameters())
    data = [(P.to_tensor(x), P.to_tensor(y)) for x, y in batches]
    losses = []
    for i in range(steps):
        x, y = data[i % len(data)]
        loss = P.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def lenet_phase(torch, np, dev):
    """`LENET`: bench_mnist_lenet on the port, then card against CPU."""
    import collections

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import async_engine as AE
    from paddle_tpu_torch.ops import dispatch as D
    place = _eager_place(P, dev)
    P.seed(0)
    B = LENET_B
    model = P.vision.models.LeNet()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    opt = P.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                               parameters=model.parameters())
    rs = np.random.RandomState(0)
    host = [(rs.randn(B, 1, 28, 28).astype(np.float32),
             rs.randint(0, 10, (B,))) for _ in range(4)]
    batches = [(P.to_tensor(x), P.to_tensor(y)) for x, y in host]

    def one_step(i):
        x, y = batches[i % len(batches)]
        loss = P.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    for i in range(LENET_WARM):
        loss = one_step(i)
    float(loss.numpy())
    AE.reset_stats()
    D.reset_dispatch_cache_stats()
    depth = AE.depth()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pending = collections.deque()
    t0 = time.perf_counter()
    for i in range(LENET_STEPS):
        pending.append(one_step(i))
        if len(pending) > depth:
            float(pending.popleft().numpy())      # the lagged sync point
    losses = []
    while pending:
        losses.append(float(pending.popleft().numpy()))
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    st, cache = AE.stats(), D.dispatch_cache_stats()
    require(all(math.isfinite(v) for v in losses), f"LeNet losses {losses}")
    require(st["steps_marked"] == LENET_STEPS
            and (st["max_depth_seen"] >= 1 or not cuda), f"async steps {st}")
    out = {"batch": B, "steps": LENET_STEPS, "samples_per_s": B * LENET_STEPS
           / dt, "batch_ms": dt * 1e3 / LENET_STEPS, "async_depth": depth,
           "max_in_flight": st["max_depth_seen"],
           "backpressure_waits": st["backpressure_waits"],
           "wait_s": st["wait_s"], "hit_rate": cache["hit_rate"],
           "traces": cache["traces"], "max_memory_allocated_bytes": peak,
           "last_loss": losses[-1]}
    print(f"[lenet] B={B}, {LENET_STEPS} steps: {out['samples_per_s']:.1f} "
          f"samples/s, {out['batch_ms']:.3f} ms a batch, depth {depth} "
          f"(max in flight {st['max_depth_seen']}, "
          f"{st['backpressure_waits']} backpressure waits), peak "
          f"{(peak or 0) / 2**20:.1f} MiB, hit_rate {cache['hit_rate']}")
    # card against CPU from one state dict, TF32 off on both paths
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = lenet_losses(np, P, state, place, LENET_AGREE_STEPS, host)
        cpu = lenet_losses(np, P, state, "cpu", LENET_AGREE_STEPS, host)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
        P.set_device(place)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    require(rel <= LENET_RTOL, f"LeNet losses card {card} against CPU {cpu}:"
            f" rel {rel:.3g} > {LENET_RTOL}")
    out.update(card_losses=card, cpu_losses=cpu, max_rel_diff=rel,
               rtol=LENET_RTOL)
    print(f"[lenet] {LENET_AGREE_STEPS} steps card against CPU, TF32 off: "
          f"largest relative loss difference {rel:.3g} (limit {LENET_RTOL})")
    print("LENET " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 8c-8f: the transformer-layer surface (BERT, AMP, flash_attn, the
# fused serving stack)
# ---------------------------------------------------------------------------
BERT = dict(V=8192, T=128, D=256, heads=8, ffn=1024, layers=4, B=16,
            activation="relu")                  # bench.py:316-330
BERT_WARM, BERT_STEPS, BERT_AGREE_STEPS = 3, 5, 5   # bench.py:315
BERT_RTOL = 1e-5
# BERT-base (Devlin et al., 2018): hidden 768, 12 heads, FFN 3,072, 12
# layers, vocab 30,522, GELU; T = 512, B = 8; dropout 0 so the bf16 and
# f32 losses of one step compare
BERT_BASE = dict(V=30522, T=512, D=768, heads=12, ffn=3072, layers=12, B=8,
                 activation="gelu")
BERT_BASE_STEPS = 5
BERT_BASE_BF16_ATOL = 2e-2
# flash_attn through the paddle op: (name, B, T, H, hd, causal, dtypes)
FLASH_OP_CASES = (("bert_base", 8, 512, 12, 64, False,
                   ("float32", "bfloat16")),
                  ("llama7b", 2, 2048, 32, 128, True, ("bfloat16",)))
FLASH_OP_F32_RTOL = (1e-5, 1e-4)         # A1 forward, A2 gradients (f32)
# fused_multi_transformer_ at LLaMA-7B width, 8 of 32 layers
FUSED_MT = dict(hidden=4096, heads=32, hd=128, ffn=11008, layers=8, B=8,
                prefill=128, decode=32)
# decode against prefill: bf16 within 2^-4 of the row's largest |value|
# (PERF.md §7: bf16 paths sit ~8 % of the largest logit from an f32
# forward after 32 random layers; 8 layers, two bf16 paths); the f32
# witness within 1e-4 of it, at these steps
FUSED_MT_BF16_REL = 2 ** -4
FUSED_MT_F32_REL = 1e-4
FUSED_MT_F32_STEPS = (0, 7, 15, 23, 31)


def bert_model(P, c):
    """bench.py's BERT (`bench_bert_dp_sharding`): token and position
    embeddings, `TransformerEncoder` of `c["layers"]` layers, a Linear
    head; dropout 0."""
    class Bert(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.tok = P.nn.Embedding(c["V"], c["D"])
            self.pos = P.nn.Embedding(c["T"], c["D"])
            layer = P.nn.TransformerEncoderLayer(
                c["D"], c["heads"], c["ffn"], dropout=0.0,
                activation=c["activation"])
            self.encoder = P.nn.TransformerEncoder(layer, c["layers"])
            self.head = P.nn.Linear(c["D"], c["V"])

        def forward(self, tokens, positions):
            x = self.tok(tokens) + self.pos(positions)
            return self.head(self.encoder(x))

    return Bert()


def bert_batch(np, P, c, seed=0):
    rs = np.random.RandomState(seed)
    return (P.to_tensor(rs.randint(0, c["V"], (c["B"], c["T"]))),
            P.to_tensor(np.arange(c["T"])),
            P.to_tensor(rs.randint(0, c["V"], (c["B"] * c["T"],))))


def bert_step(P, c, model, opt, batch, amp=None, scaler=None):
    tokens, positions, labels = batch
    if amp is None:
        logits = model(tokens, positions)
    else:
        with P.amp.auto_cast(dtype=amp):
            logits = model(tokens, positions)
    loss = P.nn.functional.cross_entropy(
        logits.reshape([-1, c["V"]]).astype("float32"), labels)
    if scaler is None:
        loss.backward()
        opt.step()
    else:
        scaler.scale(loss).backward()
        scaler.step(opt)
    opt.clear_grad()
    return loss


def bert_losses(np, P, c, state, place, steps):
    """From `state`, `steps` AdamW steps on `place`; the losses."""
    P.set_device(place)
    model = bert_model(P, c)
    missing, unexpected = model.set_state_dict(state)
    require(not missing and not unexpected,
            f"BERT state dict: missing {missing}, unexpected {unexpected}")
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters())
    batch = bert_batch(np, P, c)
    return [float(bert_step(P, c, model, opt, batch)) for _ in range(steps)]


def bert_phase(torch, np, dev):
    """`BERT`: `bench.py:310-400`'s model and loop at its own config,
    nothing cut (V 8,192, T 128, D 256, 8 heads, FFN 1,024, 4 layers,
    B = 16, AdamW 1e-4, cross_entropy), eagerly at world size 1 (the
    bench's path when fleet is unavailable, `bench.py:341-345`): 3
    warm-up and 5 timed steps in the pipelined loop (the loss read
    `async_engine.depth()` steps late): tokens/s, ms a batch, peak
    memory, one step under torch.profiler (`PROFILE_BERT`); then 5 steps
    on the card and on the CPU from one state dict,
    TF32 off, every loss within BERT_RTOL. No kernel of the port is on
    the path (cuBLAS products, torch ops)."""
    import collections

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import async_engine as AE
    c = BERT
    place = _eager_place(P, dev)
    P.seed(0)
    model = bert_model(P, c)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters())
    batch = bert_batch(np, P, c)
    for _ in range(BERT_WARM):
        loss = bert_step(P, c, model, opt, batch)
    float(loss.numpy())
    depth = AE.depth()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pending = collections.deque()
    t0 = time.perf_counter()
    for _ in range(BERT_STEPS):
        pending.append(bert_step(P, c, model, opt, batch))
        if len(pending) > depth:
            float(pending.popleft().numpy())
    losses = []
    while pending:
        losses.append(float(pending.popleft().numpy()))
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    require(all(math.isfinite(v) for v in losses), f"BERT losses {losses}")
    out = {"config": c, "warmup": BERT_WARM, "steps": BERT_STEPS,
           "tokens_per_s": c["B"] * c["T"] * BERT_STEPS / dt,
           "batch_ms": dt * 1e3 / BERT_STEPS, "async_depth": depth,
           "max_memory_allocated_bytes": peak, "last_loss": losses[-1]}
    print(f"[bert] B={c['B']} T={c['T']} D={c['D']} {c['layers']} layers: "
          f"{out['tokens_per_s']:.1f} tokens/s, {out['batch_ms']:.3f} ms a "
          f"batch, peak {(peak or 0) / 2**20:.1f} MiB")
    if cuda:
        profile_once(torch, lambda: float(bert_step(P, c, model, opt, batch)),
                     "BERT train step", "PROFILE_BERT")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = bert_losses(np, P, c, state, place, BERT_AGREE_STEPS)
        cpu = bert_losses(np, P, c, state, "cpu", BERT_AGREE_STEPS)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
        P.set_device(place)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    require(rel <= BERT_RTOL, f"BERT losses card {card} against CPU {cpu}: "
            f"rel {rel:.3g} > {BERT_RTOL}")
    out.update(card_losses=card, cpu_losses=cpu, max_rel_diff=rel,
               rtol=BERT_RTOL)
    print(f"[bert] {BERT_AGREE_STEPS} steps card against CPU, TF32 off: "
          f"largest relative loss difference {rel:.3g} (limit {BERT_RTOL})")
    print("BERT " + json.dumps(out))
    return out


def bert_base_amp(torch, np, dev):
    """`BERT_BASE_AMP`: the same classes at BERT-base width (BERT_BASE),
    AdamW 1e-4, from one state dict: the f32 loss of the first batch;
    BERT_BASE_STEPS steps under `amp.auto_cast(dtype="bfloat16")` O1 with
    a `GradScaler` (a pass-through for bf16), whose first loss must be
    within BERT_BASE_BF16_ATOL of the f32 loss; then BERT_BASE_STEPS
    steps under float16 O1 with dynamic loss scaling, the scale and
    found_inf after each. tokens/s, ms a batch and peak memory of each
    run (host clock over the steps, closed by reading the last loss);
    one more bf16 step under torch.profiler (`PROFILE_BERT_BASE_BF16`)."""
    import paddle_tpu_torch as P
    c = BERT_BASE
    place = _eager_place(P, dev)
    P.seed(1)
    model = bert_model(P, c)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    batch = bert_batch(np, P, c, seed=1)
    with P.no_grad():
        logits = model(batch[0], batch[1])
        f32_loss = float(P.nn.functional.cross_entropy(
            logits.reshape([-1, c["V"]]), batch[2]))
    del logits
    out = {"config": c, "f32_first_loss": f32_loss}
    for amp in ("bfloat16", "float16"):
        model.set_state_dict(state)
        opt = P.optimizer.AdamW(learning_rate=1e-4,
                                parameters=model.parameters())
        scaler = P.amp.GradScaler()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, trail = [], []
        t0 = time.perf_counter()
        for _ in range(BERT_BASE_STEPS):
            loss = bert_step(P, c, model, opt, batch, amp=amp,
                             scaler=scaler)
            trail.append({"scale": scaler._scale,
                          "found_inf": scaler._found_inf})
            scaler.update()
            losses.append(loss)
        losses = [float(v) for v in losses]
        dt = time.perf_counter() - t0
        if amp == "bfloat16":
            profile_once(torch, lambda: float(bert_step(
                P, c, model, opt, batch, amp=amp, scaler=scaler)),
                "BERT-base bf16 O1 train step", "PROFILE_BERT_BASE_BF16")
            scaler.update()
        require(math.isfinite(losses[0]), f"{amp} losses {losses}")
        run = {"losses": losses, "scaler": trail,
               "tokens_per_s": c["B"] * c["T"] * BERT_BASE_STEPS / dt,
               "batch_ms": dt * 1e3 / BERT_BASE_STEPS,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        out[amp] = run
        print(f"[bert_base] {amp} O1: {run['tokens_per_s']:.1f} tokens/s, "
              f"{run['batch_ms']:.2f} ms a batch, peak "
              f"{run['max_memory_allocated_bytes'] / 2**30:.2f} GiB; losses "
              f"{[round(v, 5) for v in losses]}; scaler {trail}")
    diff = abs(out["bfloat16"]["losses"][0] - f32_loss)
    require(diff <= BERT_BASE_BF16_ATOL,
            f"BERT-base bf16 first loss {out['bfloat16']['losses'][0]} "
            f"against f32 {f32_loss}: {diff:.3g} > {BERT_BASE_BF16_ATOL}")
    require(all(t["scale"] == 2.0 ** 16 and not t["found_inf"]
                for t in out["bfloat16"]["scaler"]),
            "the bfloat16 GradScaler did not pass through")
    out["bf16_first_loss_diff"] = diff
    print(f"[bert_base] bf16 first loss {out['bfloat16']['losses'][0]:.6f} "
          f"against f32 {f32_loss:.6f}: {diff:.3g} (limit "
          f"{BERT_BASE_BF16_ATOL})")
    print("BERT_BASE_AMP " + json.dumps(out))
    P.set_device(place)
    return out


def flash_attn_op(torch, np, C, dev):
    """`FLASH_ATTN_OP`: `flash_attn` (`ops/kernels/tail_alias.py`) through
    the paddle op on port Tensors, forward and backward, at BERT-base's
    attention (B 8, T 512, 12 heads of 64, non-causal; f32 and bf16) and
    LLaMA-7B's (B 2, T 2,048, 32 heads of 128, causal; bf16): A1 and A2
    one launch each a call (the main path, counted from 0), outputs and
    gradients held to their plain versions (A1's f32 forward and FA-2
    backward) under A1's and A2's tolerances (bf16: TOL_RULE; f32: rtol
    FLASH_OP_F32_RTOL, atol rtol x rms); a masked call, a dropout call
    and `memory_efficient_attention` with a bias launch none. Then CUDA
    event times of the op on bare tensors (forward; forward + backward)
    beside SDPA's. Returns the path's launches (each call's counts, read
    from 0 just after it, summed; the comparisons launch A1 again after
    the reading)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import _C_ops
    FA = C.flash_attention
    F = torch.nn.functional
    _eager_place(P, dev)
    rows, calls = [], 0
    launches = {k.name: 0 for k in C.KERNELS}
    for name, B, T, H, hd, causal, dtypes in FLASH_OP_CASES:
        for dt in dtypes:
            tdt = getattr(torch, dt)
            g = torch.Generator(device=dev).manual_seed(B + T + hd)
            qkv = [torch.randn(B, T, H, hd, generator=g, device=dev).to(tdt)
                   for _ in range(3)]
            do = torch.randn(B, T, H, hd, generator=g, device=dev).to(tdt)
            ts = [P.to_tensor(a) for a in qkv]
            for t in ts:
                t.stop_gradient = False
            # the main path, counted from 0: one call, forward + backward
            for k in C.KERNELS:
                k.reset()
            o = _C_ops.flash_attn(ts[0], ts[1], ts[2], causal=causal)
            o.backward(P.to_tensor(do))
            torch.cuda.synchronize()
            n = launch_counts(C)
            calls += 1
            require(n["flash_attention"] == 1 and n["flash_attention_bwd"] == 1
                    and sum(n.values()) == 2,
                    f"flash_attn[{name} {dt}]: launches {n}, not A1 and A2 "
                    f"once each")
            for k, v in n.items():
                launches[k] += v
            # the plain versions on the inputs each kernel got: A1 on q, k,
            # v; A2 on q, k, v, A1's o and lse (A1 again, which returns the
            # op's o bit for bit) and dO
            scale = hd ** -0.5
            qt, kt, vt, dot = (a.transpose(1, 2).contiguous()
                               for a in (*qkv, do))
            o_ref, _ = FA.flash_attention_fwd_plain(qt, kt, vt, causal, scale)
            o_k, lse_k = FA.flash_attention_fwd(qt, kt, vt, causal, scale)
            require(torch.equal(o_k.transpose(1, 2), o._data),
                    f"flash_attn[{name} {dt}]: A1 again gave other bits")
            grads_ref = FA.flash_attention_bwd_plain(qt, kt, vt, o_k, lse_k,
                                                     dot, causal, scale)
            got = [o._data] + [t.grad._data for t in ts]
            want = [o_ref.transpose(1, 2)] + [r.transpose(1, 2)
                                              for r in grads_ref]
            errs = {}
            for what, a, b in zip(("o", "dq", "dk", "dv"), got, want):
                if tdt == torch.bfloat16:
                    errs[what] = held(f"flash_attn[{name}] {what}", a, b)
                    continue
                rtol = FLASH_OP_F32_RTOL[what != "o"]
                bf = b.float()
                atol = rtol * bf.square().mean().sqrt().item()
                diff = (a.float() - bf).abs()
                worst = (diff / (rtol * bf.abs() + atol)).max().item()
                require(worst <= 1, f"flash_attn[{name} f32] {what}: "
                        f"{worst:.3g} x its tolerance")
                errs[what] = {"max_abs_err": diff.max().item(),
                              "err_over_tol": worst}
            del o_ref, o_k, lse_k, grads_ref, got, want, ts, o
            rows.append({"case": f"{name}_{dt}", "B": B, "T": T, "H": H,
                         "hd": hd, "causal": causal, "dtype": dt,
                         "errors": errs})
    # masked, dropout and biased calls take the plain SDPA: no launch
    q = torch.randn(1, 128, 4, 64, device=dev, dtype=torch.bfloat16)
    mask = torch.zeros(1, 4, 128, 128, device=dev, dtype=torch.bfloat16)
    before = (FA.KERNEL_FWD.launches, FA.KERNEL_BWD.launches)
    qq = q.clone().requires_grad_()
    _C_ops.flash_attn(qq, qq, qq, attn_mask=mask).sum().backward()
    _C_ops.flash_attn(qq, qq, qq, dropout=0.1).sum().backward()
    _C_ops.memory_efficient_attention(q, q, q, bias=mask)
    torch.cuda.synchronize()
    require((FA.KERNEL_FWD.launches, FA.KERNEL_BWD.launches) == before,
            "a masked, dropout or biased flash_attn call launched A1/A2")
    # times: the op on bare tensors (the function's own call) beside SDPA
    for row in rows:
        tdt = getattr(torch, row["dtype"])
        B, T, H, hd = row["B"], row["T"], row["H"], row["hd"]
        g = torch.Generator(device=dev).manual_seed(7)
        q, k, v = (torch.randn(B, T, H, hd, generator=g, device=dev).to(tdt)
                   .requires_grad_() for _ in range(3))
        do = torch.randn(B, T, H, hd, generator=g, device=dev).to(tdt)
        qh, kh, vh = (a.detach().transpose(1, 2).contiguous()
                      .requires_grad_() for a in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        causal = row["causal"]

        def op_fwd():
            with torch.no_grad():
                _C_ops.flash_attn(q, k, v, causal=causal)

        def op_both():
            torch.autograd.grad(_C_ops.flash_attn(q, k, v, causal=causal),
                                (q, k, v), do)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

        def sdpa_both():
            torch.autograd.grad(F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal), (qh, kh, vh), doh)

        iters = 10 if T >= 2048 else 20
        row.update(op_fwd_ms=cuda_ms(torch, op_fwd, iters),
                   op_fwd_bwd_ms=cuda_ms(torch, op_both, iters),
                   sdpa_fwd_ms=cuda_ms(torch, sdpa_fwd, iters),
                   sdpa_fwd_bwd_ms=cuda_ms(torch, sdpa_both, iters))
        print(f"[flash_attn] {row['case']} (B {B}, T {T}, {H} x {hd}, "
              f"causal {causal}): op {row['op_fwd_ms']:.4f} ms forward, "
              f"{row['op_fwd_bwd_ms']:.4f} forward + backward; SDPA "
              f"{row['sdpa_fwd_ms']:.4f} / {row['sdpa_fwd_bwd_ms']:.4f}; "
              + ", ".join(f"{w} {e['err_over_tol']:.2f} of tol"
                          for w, e in row["errors"].items()))
    print("FLASH_ATTN_OP " + json.dumps({"launches": launches,
                                         "calls": calls, "cases": rows}))
    return launches


def fused_mt_weights(torch, dev, c, seed=0):
    """Seeded bf16 weights of a `fused_multi_transformer_` LLaMA stack
    (rmsnorm scales, qkv [3, H, hd, D], out [D, D], gate+up [D, 2F],
    down [F, D]; std 0.02, the LLaMA init), on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D, F, bf = c["hidden"], c["ffn"], torch.bfloat16

    def w(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 0.02).to(bf)

    ones = [torch.ones(D, device=dev, dtype=bf) for _ in range(c["layers"])]
    nones = [None] * c["layers"]
    return dict(
        ln_scales=ones, ln_biases=nones,
        qkv_weights=[w(3, c["heads"], c["hd"], D) for _ in ones],
        qkv_biases=None, linear_weights=[w(D, D) for _ in ones],
        linear_biases=None, ffn_ln_scales=list(ones), ffn_ln_biases=nones,
        ffn1_weights=[w(D, 2 * F) for _ in ones], ffn1_biases=None,
        ffn2_weights=[w(F, D) for _ in ones], ffn2_biases=None)


def fused_mt(torch, np, dev):
    """`FUSED_MT`: `incubate.nn.functional.fused_multi_transformer` at
    LLaMA-7B width (hidden 4,096, 32 heads of 128, rmsnorm, swiglu with
    d_ff 11,008, rotate-half rope, bf16), 8 of its 32 layers (cut to keep
    the weights at 3.2 GB and the phase short): B = 8, a prefill of 128
    tokens, then 32 decode steps through `masked_multihead_attention_`
    (the cache written in place); ms a prefill and a decode step (CUDA
    events), peak memory, one decode step under torch.profiler
    (`PROFILE_FUSED_MT_DECODE`). Each decode step's output is held to
    the last row of a prefill over the same tokens: in bf16 within
    FUSED_MT_BF16_REL of the row's largest |value| (the two round their
    products at 8 and at up to 1,280 rows, and a rounding step of a
    residual summand survives the add however small the sum, so the
    kernel rule TOL_RULE, one rounding a side, cannot hold through 8
    layers; its ratio is printed), and, on the same weights in f32, at
    FUSED_MT_F32_STEPS within FUSED_MT_F32_REL (the check that the
    cache, the rope positions and the masks are right). No kernel of the
    port is on the path (the reference's plain chains: cuBLAS products,
    torch ops)."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    c = FUSED_MT
    B, T0, N, L = c["B"], c["prefill"], c["decode"], c["layers"]
    S, D, H, hd = T0 + N, c["hidden"], c["heads"], c["hd"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w = fused_mt_weights(torch, dev, c)
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, device=dev) / hd))
    ang = torch.arange(S, device=dev)[:, None] * inv[None, :]
    rope = torch.stack([torch.cat([ang.cos()] * 2, -1),
                        torch.cat([ang.sin()] * 2, -1)])[:, None, None]
    rope = rope.expand(2, B, 1, S, hd).contiguous()
    kw = dict(pre_layer_norm=True, epsilon=1e-6, rotary_embs=rope,
              rotary_emb_dims=1, norm_type="rmsnorm", activation="swiglu",
              use_neox_rotary_style=True)
    g = torch.Generator(device=dev).manual_seed(1)
    xs = torch.randn(B, S, D, generator=g, device=dev).to(torch.bfloat16)

    def caches(dtype):
        return [torch.zeros(2, B, H, S, hd, device=dev, dtype=dtype)
                for _ in range(L)]

    def run(w, x, cache, t=None):
        return IF.fused_multi_transformer(
            x, w["ln_scales"], w["ln_biases"], w["qkv_weights"],
            w["qkv_biases"], w["linear_weights"], w["linear_biases"],
            w["ffn_ln_scales"], w["ffn_ln_biases"], w["ffn1_weights"],
            w["ffn1_biases"], w["ffn2_weights"], w["ffn2_biases"],
            cache_kvs=cache, time_step=t, **kw)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    with torch.no_grad():
        cache = caches(torch.bfloat16)
        run(w, xs[:, :T0], cache)                      # warm-up
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(3):
            out, cache = run(w, xs[:, :T0], cache)
        end.record()
        torch.cuda.synchronize()
        prefill_ms = start.elapsed_time(end) / 3
        require(bool(torch.isfinite(out).all()), "FUSED_MT prefill not finite")
        decoded = []
        start.record()
        for t in range(T0, S):
            o, cache = run(w, xs[:, t:t + 1], cache, t)
            decoded.append(o[:, 0])
        end.record()
        torch.cuda.synchronize()
        decode_ms = start.elapsed_time(end) / N
        # one more step at the last position (rewrites it), profiled
        profile_once(torch, lambda: run(w, xs[:, S - 1:], cache, S - 1),
                     "FUSED_MT decode step", "PROFILE_FUSED_MT_DECODE")
        fresh, bf16_rel, kernel_rule = caches(torch.bfloat16), [], []
        for i, t in enumerate(range(T0, S)):
            full, _ = run(w, xs[:, :t + 1], fresh)
            ref = full[:, -1]
            bf16_rel.append(rel(decoded[i], ref))
            atol = 1e-3 * ref.float().square().mean().sqrt()
            kernel_rule.append(((decoded[i].float() - ref.float()).abs()
                                / (BF16_RTOL * ref.float().abs() + atol))
                               .max().item())
        del fresh, cache, decoded
        # the f32 witness: the same weights widened, decode against prefill
        w32 = {k: None if v is None else [None if a is None else a.float()
                                          for a in v] for k, v in w.items()}
        x32, cache = xs.float(), caches(torch.float32)
        run(w32, x32[:, :T0], cache)
        f32_rel = {}
        for i, t in enumerate(range(T0, S)):
            o, cache = run(w32, x32[:, t:t + 1], cache, t)
            if i in FUSED_MT_F32_STEPS:
                full, _ = run(w32, x32[:, :t + 1], caches(torch.float32))
                f32_rel[i] = rel(o[:, 0], full[:, -1])
        del w32, cache
    peak = torch.cuda.max_memory_allocated()
    worst_bf16 = max(bf16_rel)
    require(max(f32_rel.values()) <= FUSED_MT_F32_REL,
            f"FUSED_MT f32 decode against prefill: {f32_rel} (limit "
            f"{FUSED_MT_F32_REL} of the largest |value|)")
    require(worst_bf16 <= FUSED_MT_BF16_REL,
            f"FUSED_MT bf16 decode against prefill: worst {worst_bf16:.3g} "
            f"of the largest |value| (limit {FUSED_MT_BF16_REL})")
    out = {"config": c, "cut": "8 of 32 layers", "prefill_ms": prefill_ms,
           "decode_step_ms": decode_ms,
           "prefill_tokens_per_s": B * T0 / prefill_ms * 1e3,
           "decode_tokens_per_s": B / decode_ms * 1e3,
           "max_memory_allocated_bytes": peak,
           "bf16_decode_vs_prefill_rel": bf16_rel,
           "bf16_kernel_rule_ratio": kernel_rule,
           "f32_decode_vs_prefill_rel": f32_rel}
    print(f"[fused_mt] LLaMA-7B width, {L} of 32 layers, B={B}: prefill of "
          f"{T0} tokens {prefill_ms:.3f} ms, decode step {decode_ms:.3f} ms, "
          f"peak {peak / 2**30:.2f} GiB; {N} decode steps against the "
          f"prefill's last row: bf16 worst {worst_bf16:.3g} of the largest "
          f"|value| (limit {FUSED_MT_BF16_REL}; TOL_RULE's ratio up to "
          f"{max(kernel_rule):.1f}), f32 worst {max(f32_rel.values()):.3g} "
          f"(limit {FUSED_MT_F32_REL})")
    print("FUSED_MT " + json.dumps(out))
    del w
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 8g-8i: the bench's detector, the detection ops, the rnn op
# ---------------------------------------------------------------------------

DETECT = dict(B=8, S=640, w=32, nc=80)       # bench.py:483-484 on its chip
DETECT_HEADS = ((8, [8, 8]), (16, [16, 16]), (32, [32, 32]))
DETECT_CONF = 0.005
DETECT_WARM, DETECT_STEPS = 2, 5              # bench.py:485
DETECT_NMS = dict(iou_threshold=0.5, top_k=100)
DETECT_REL = 1e-4      # f32 boxes and scores, card against CPU, of the largest
# a PP-YOLOE deployment's post-processing
DETECT_MCNMS = dict(score_threshold=0.05, nms_top_k=1000, keep_top_k=100,
                    nms_threshold=0.45)
DETECT_ROIS = 64                              # a image: 512 in the batch
DETECT_GT = 50                                # ground-truth boxes an image
DETECT_OPS_REL = 1e-4   # the ops' f32 outputs and gradients, card vs CPU
RNN_OP = dict(T=128, B=32, I=512, H=512, layers=2)
RNN_REL = 1e-4


def detector_model(P, nc, w):
    """The bench's Detector (`bench.py:489-523`) from the port's layers."""
    nn = P.nn

    class ConvBN(nn.Layer):
        def __init__(self, cin, cout, k=3, s=1):
            super().__init__()
            self.conv = nn.Conv2D(cin, cout, k, stride=s, padding=k // 2,
                                  bias_attr=False)
            self.bn = nn.BatchNorm2D(cout)
            self.act = nn.Silu()

        def forward(self, x):
            return self.act(self.bn(self.conv(x)))

    class Detector(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = ConvBN(3, w, 3, 2)
            self.s1 = nn.Sequential(ConvBN(w, 2 * w, 3, 2),
                                    ConvBN(2 * w, 2 * w))
            self.s2 = nn.Sequential(ConvBN(2 * w, 4 * w, 3, 2),
                                    ConvBN(4 * w, 4 * w))
            self.s3 = nn.Sequential(ConvBN(4 * w, 8 * w, 3, 2),
                                    ConvBN(8 * w, 8 * w))
            self.s4 = nn.Sequential(ConvBN(8 * w, 16 * w, 3, 2),
                                    ConvBN(16 * w, 16 * w))
            self.h3 = nn.Conv2D(4 * w, 5 + nc, 1)
            self.h4 = nn.Conv2D(8 * w, 5 + nc, 1)
            self.h5 = nn.Conv2D(16 * w, 5 + nc, 1)
            self.nc = nc

        def p3(self, x):
            return self.s2(self.s1(self.stem(x)))

        def forward(self, x):
            p3 = self.p3(x)
            p4 = self.s3(p3)
            return self.h3(p3), self.h4(p4), self.h5(self.s4(p4))

    return Detector()


def detect_decode(P, heads, img_shape, nc):
    """`vision.ops.yolo_box` in f32 on each head, as the bench's Infer."""
    return [P.vision.ops.yolo_box(h.astype("float32"), img_shape, anchor, nc,
                                  conf_thresh=DETECT_CONF,
                                  downsample_ratio=stride)
            for h, (stride, anchor) in zip(heads, DETECT_HEADS)]


def detect_image0(P, outs):
    """Image 0's boxes and best class scores over the three heads."""
    boxes = P.concat([b[0] for b, _ in outs])
    scores = P.concat([s[0].max(-1) for _, s in outs])
    return boxes, scores


def _rel(torch, got, ref):
    """max |got - ref| over the largest |ref|."""
    g, r = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((g - r).abs().max() / max(float(r.abs().max()), 1e-30))


def _no_tf32(torch):
    """Turn TF32 off for cuDNN and matmul; returns the old flags."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return old


def _restore_tf32(torch, old):
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = old


def detect_phase(torch, np, dev):
    """`DETECT`: `bench.py:472-578`'s detector at the size the bench runs
    on its chip, nothing cut (B 8, 3 x 640 x 640, width 32, 80 classes,
    eval, bf16 `auto_cast` O1), eagerly under no_grad (the bench's
    `to_static` is ROADMAP item 9): 2 warm-up and 5 timed passes, each
    ended by reading one value as the bench's loop; images/s, ms a batch,
    peak memory; one pass under torch.profiler (`PROFILE_DETECT`); `nms`
    over image 0's boxes (IoU 0.5, top_k 100) on the card: kept, ms. Then
    one f32 pass (auto_cast off, TF32 off) on the card and on the CPU from
    one state dict: boxes and scores within DETECT_REL of their largest
    |value|, and the card's `nms` fed the CPU's boxes and scores keeps
    exactly the CPU's indices. No kernel of the port is on the path
    (cuDNN convolutions, torch elementwise ops). Returns the decoded
    bf16 outputs and the f32 model's stride-8 map and heads for
    DETECT_OPS."""
    import paddle_tpu_torch as P
    c = DETECT
    B, S, nc = c["B"], c["S"], c["nc"]
    place = _eager_place(P, dev)
    P.seed(0)
    net = detector_model(P, nc, c["w"])
    net.eval()
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    rs = np.random.RandomState(0)                  # bench.py:548-549
    x_h = rs.rand(B, 3, S, S).astype(np.float32)
    shape_h = np.tile(np.asarray([[S, S]], np.int32), (B, 1))
    x, img_shape = P.to_tensor(x_h), P.to_tensor(shape_h)

    def infer():
        with P.amp.auto_cast(enable=True, dtype="bfloat16"):
            heads = net(x)
        return detect_decode(P, heads, img_shape, nc)

    def one_pass():
        return float(infer()[-1][0].numpy().ravel()[0])

    cuda = dev.type == "cuda"
    with P.no_grad():
        for _ in range(DETECT_WARM):
            one_pass()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(DETECT_STEPS):
            one_pass()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else None
        prof = profile_once(torch, one_pass, "detector pass (B=8, bf16)",
                            "PROFILE_DETECT") if cuda else None
        outs = infer()
        boxes, scores = detect_image0(P, outs)
        keep = P.vision.ops.nms(boxes, scores=scores, **DETECT_NMS)
        nms_s = []
        for _ in range(5):
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            again = P.vision.ops.nms(boxes, scores=scores, **DETECT_NMS)
            nms_s.append(time.perf_counter() - t1)
        require(bool((again.numpy() == keep.numpy()).all()),
                "DETECT: nms not repeatable")
    kept = int(keep.shape[0])
    require(0 < kept <= DETECT_NMS["top_k"], f"DETECT: nms kept {kept}")
    for b, s in outs:
        require(bool(P.isfinite(b).all()) and bool(P.isfinite(s).all()),
                "DETECT: boxes or scores not finite")
    out = {"config": c, "amp": "bfloat16 O1", "warmup": DETECT_WARM,
           "steps": DETECT_STEPS, "images_per_s": B * DETECT_STEPS / dt,
           "batch_ms": dt * 1e3 / DETECT_STEPS,
           "max_memory_allocated_bytes": peak, "nms_kept": kept,
           "nms_candidates": int(boxes.shape[0]),
           "nms_ms": [v * 1e3 for v in nms_s],
           "nms_where": "IoU tests on the card (float32, the pairs near "
                        "the threshold in float64), greedy order on the host "
                        "64 candidates a round",
           "busy_share": prof["device_busy_share"] if prof else None}
    print(f"[detect] B={B} {S}x{S} width {c['w']} {nc} classes, bf16 O1: "
          f"{out['images_per_s']:.2f} images/s, {out['batch_ms']:.2f} ms a "
          f"batch, peak {(peak or 0) / 2**30:.2f} GiB; nms over "
          f"{out['nms_candidates']} boxes kept {kept}, "
          f"{min(out['nms_ms']):.3f}-{max(out['nms_ms']):.3f} ms")

    old = _no_tf32(torch)
    try:
        with P.no_grad():
            card_heads = net(x)
            card = detect_decode(P, card_heads, img_shape, nc)
            p3 = net.p3(x)
            P.set_device("cpu")
            cnet = detector_model(P, nc, c["w"])
            missing, unexpected = cnet.set_state_dict(state)
            require(not missing and not unexpected,
                    f"DETECT state dict: {missing} {unexpected}")
            cnet.eval()
            cpu = detect_decode(P, cnet(P.to_tensor(x_h)),
                                P.to_tensor(shape_h), nc)
            cb, cs = detect_image0(P, cpu)
            cpu_keep = P.vision.ops.nms(cb, scores=cs, **DETECT_NMS)
            P.set_device(place)
            card_keep = P.vision.ops.nms(P.to_tensor(cb.numpy()),
                                         scores=P.to_tensor(cs.numpy()),
                                         **DETECT_NMS)
    finally:
        _restore_tf32(torch, old)
        P.set_device(place)
    rels = {}
    for i, ((bc, sc), (bh, sh)) in enumerate(zip(card, cpu)):
        rels[f"boxes_{i}"] = _rel(torch, bc._data, bh._data)
        rels[f"scores_{i}"] = _rel(torch, sc._data, sh._data)
    worst = max(rels.values())
    require(worst <= DETECT_REL, f"DETECT f32 card against CPU: {rels}")
    same = bool(np.array_equal(card_keep.numpy(), cpu_keep.numpy()))
    require(same, "DETECT: the card's nms on the CPU's boxes kept other "
                  "indices than the CPU's")
    out.update(f32_card_vs_cpu_rel=rels, f32_worst_rel=worst,
               f32_rel_limit=DETECT_REL, nms_card_equals_cpu=same,
               nms_cpu_kept=int(cpu_keep.shape[0]))
    print(f"[detect] f32 card against CPU, TF32 off: worst {worst:.3g} of "
          f"the largest |value| (limit {DETECT_REL}); the card's nms on the "
          f"CPU's boxes keeps the CPU's {int(cpu_keep.shape[0])} indices")
    print("DETECT " + json.dumps(out))
    return {"outs": outs, "p3": p3._data, "heads": [h._data
                                                    for h in card_heads]}


def _card_vs_cpu(torch, fn, inputs, grad_of, label):
    """fn on the card's inputs and on their CPU copies; outputs and the
    gradients (of the outputs' sum against seeded weights) of the inputs
    named in grad_of, each held to DETECT_OPS_REL of its largest |value|.
    Returns the worst share."""
    worst = {}
    res = {}
    for where in ("card", "cpu"):
        ins = {k: (v if where == "card" else v.cpu()).detach().clone()
               for k, v in inputs.items()}
        for k in grad_of:
            ins[k].requires_grad_(True)
        outs = fn(**ins)
        outs = [o for o in (outs if isinstance(outs, (list, tuple))
                            else [outs]) if o.is_floating_point()]
        g = torch.Generator().manual_seed(7)
        loss = sum((o.float() * torch.rand(o.shape, generator=g).to(
            o.device)).sum() for o in outs)
        grads = torch.autograd.grad(loss, [ins[k] for k in grad_of])
        res[where] = (outs, grads)
    for i, (a, b) in enumerate(zip(res["card"][0], res["cpu"][0])):
        worst[f"out{i}"] = _rel(torch, a, b)
    for k, a, b in zip(grad_of, res["card"][1], res["cpu"][1]):
        worst[f"grad_{k}"] = _rel(torch, a, b)
    require(max(worst.values()) <= DETECT_OPS_REL,
            f"{label} card against CPU: {worst}")
    return worst


def detect_ops(torch, np, dev, det):
    """`DETECT_OPS`: the post-processing family at the detector's shapes,
    on the card against the CPU on the same inputs (TF32 off):
    `multiclass_nms3` over the bf16 pass's boxes [8, 8400, 4] and scores
    [8, 80, 8400] (DETECT_MCNMS, a PP-YOLOE deployment's: indices and
    nms_num exact, boxes and scores within 1e-5); `roi_align` of 512
    seeded boxes on the f32 stride-8 map, 7 x 7, sampling ratio 2;
    `deform_conv2d` at the backbone's s2 shape (B 8, 128 -> 128, 80 x
    80, 3 x 3, seeded offsets and a mask); `yolo_loss` on the three f32
    heads with DETECT_GT seeded boxes an image: each forward and
    backward, outputs and gradients within DETECT_OPS_REL of their
    largest |value|; the card's time of each."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import _C_ops
    B, S, nc = DETECT["B"], DETECT["S"], DETECT["nc"]
    rs = np.random.RandomState(1)
    bb = torch.cat([b._data for b, _ in det["outs"]], 1).contiguous()
    sc = torch.cat([s._data for _, s in det["outs"]], 1).transpose(
        1, 2).contiguous()
    out = {"multiclass_nms3": {"bboxes": list(bb.shape),
                               "scores": list(sc.shape), **DETECT_MCNMS}}
    card = _C_ops.multiclass_nms3(bb, sc, None, **DETECT_MCNMS)
    mc_ms = cuda_ms(torch, lambda: _C_ops.multiclass_nms3(
        bb, sc, None, **DETECT_MCNMS), 2, warmup=0)
    cpu = _C_ops.multiclass_nms3(bb.cpu(), sc.cpu(), None, **DETECT_MCNMS)
    require(torch.equal(card[1].cpu(), cpu[1])
            and torch.equal(card[2].cpu(), cpu[2]),
            "DETECT_OPS multiclass_nms3: index or nms_num differ")
    box_err = float((card[0].cpu() - cpu[0]).abs().max()) \
        if cpu[0].numel() else 0.0
    require(box_err <= 1e-5, f"DETECT_OPS multiclass_nms3 rows {box_err}")
    out["multiclass_nms3"].update(ms=mc_ms, kept=int(cpu[0].shape[0]),
                                  nms_num=cpu[2].tolist(),
                                  max_abs_err=box_err)
    print(f"[detect_ops] multiclass_nms3 {list(bb.shape)} x "
          f"{list(sc.shape)}: {mc_ms:.2f} ms, kept {int(cpu[0].shape[0])}, "
          f"indices and nms_num equal to the CPU's")

    old = _no_tf32(torch)
    try:
        p3 = det["p3"].float()
        xy = rs.uniform(0, S * 0.8, (B * DETECT_ROIS, 2))
        wh = rs.uniform(16, S * 0.3, (B * DETECT_ROIS, 2))
        boxes = torch.tensor(np.concatenate([xy, xy + wh], 1),
                             dtype=torch.float32, device=dev)
        nums = torch.full((B,), DETECT_ROIS, dtype=torch.int32, device=dev)
        roi_kw = dict(pooled_height=7, pooled_width=7, spatial_scale=1 / 8,
                      sampling_ratio=2, aligned=True)

        def roi(x, boxes, nums):
            return _C_ops.roi_align(x, boxes, nums, **roi_kw)

        rows = {"roi_align": (roi, {"x": p3, "boxes": boxes, "nums": nums},
                              ("x",))}
        C = p3.shape[1]
        H = p3.shape[2]
        x = torch.randn(B, C, H, H, generator=torch.Generator().manual_seed(
            2)).to(dev)
        g = torch.Generator().manual_seed(3)
        offset = (torch.rand(B, 18, H, H, generator=g) * 4 - 2).to(dev)
        mask = torch.rand(B, 9, H, H, generator=g).to(dev)
        weight = (torch.randn(C, C, 3, 3, generator=g) * 0.03).to(dev)

        def dcn(x, offset, weight, mask):
            return _C_ops.deformable_conv(x, offset, weight, mask, stride=1,
                                          padding=1)

        rows["deform_conv2d"] = (dcn, {"x": x, "offset": offset,
                                       "weight": weight, "mask": mask},
                                 ("x", "offset", "weight", "mask"))
        heads = [h.float() for h in det["heads"]]
        gt_xy = rs.uniform(0.05, 0.95, (B, DETECT_GT, 2))
        gt_wh = rs.uniform(0.01, 0.3, (B, DETECT_GT, 2))
        gt_box = torch.tensor(np.concatenate([gt_xy, gt_wh], 2),
                              dtype=torch.float32, device=dev)
        gt_label = torch.tensor(rs.randint(0, nc, (B, DETECT_GT)),
                                dtype=torch.int32, device=dev)

        def yolo(h8, h16, h32, gt_box, gt_label):
            return [_C_ops.yolo_loss(h, gt_box, gt_label,
                                     anchors=(8, 8, 16, 16, 32, 32),
                                     anchor_mask=(i,), class_num=nc,
                                     ignore_thresh=0.7, downsample_ratio=st)[0]
                    for i, (h, (st, _)) in enumerate(zip((h8, h16, h32),
                                                         DETECT_HEADS))]

        rows["yolo_loss"] = (yolo, {"h8": heads[0], "h16": heads[1],
                                    "h32": heads[2], "gt_box": gt_box,
                                    "gt_label": gt_label},
                             ("h8", "h16", "h32"))
        for name, (fn, ins, grad_of) in rows.items():
            worst = _card_vs_cpu(torch, fn, ins, grad_of, name)
            live = {k: v.detach().clone().requires_grad_(k in grad_of)
                    for k, v in ins.items()}

            def fwd():
                with torch.no_grad():
                    fn(**{k: v.detach() for k, v in live.items()})

            def fwd_bwd():
                o = fn(**live)
                o = o if isinstance(o, list) else [o]
                sum(t.float().sum() for t in o).backward()

            out[name] = {"forward_ms": cuda_ms(torch, fwd, 5, warmup=1),
                         "forward_backward_ms": cuda_ms(torch, fwd_bwd, 3,
                                                        warmup=1),
                         "card_vs_cpu_rel": worst,
                         "shapes": {k: list(v.shape) for k, v in ins.items()}}
            print(f"[detect_ops] {name}: forward {out[name]['forward_ms']:.3f}"
                  f" ms, forward + backward "
                  f"{out[name]['forward_backward_ms']:.3f} ms; card against "
                  f"CPU worst {max(worst.values()):.3g} of the largest "
                  f"|value| (limit {DETECT_OPS_REL})")
    finally:
        _restore_tf32(torch, old)
    out["rel_limit"] = DETECT_OPS_REL
    print("DETECT_OPS " + json.dumps(out))
    return out


def rnn_op(torch, np, dev):
    """`RNN_OP`: the `rnn` op, LSTM, 2 layers, bidirectional, input and
    hidden 512, T 128, B 32, f32 (cuDNN on the card through torch.lstm,
    as `ops/kernels/rnn_ops.py` says), card against CPU from one set of
    seeded weights, TF32 off: outputs and the gradients of x, h0 and
    layer 0's weights within RNN_REL of their largest |value|; ms forward
    and ms forward + backward (CUDA events)."""
    from paddle_tpu_torch import _C_ops
    c = RNN_OP
    T, B, I, H, L = c["T"], c["B"], c["I"], c["H"], c["layers"]
    g = torch.Generator().manual_seed(4)
    k = 1 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(*shape, generator=g) * 2 - 1) * k

    weights = [[u(4 * H, I if layer == 0 else 2 * H), u(4 * H, H),
                u(4 * H), u(4 * H)] for layer in range(L) for _ in range(2)]
    x = torch.randn(B, T, I, generator=g)
    h0 = torch.randn(2 * L, B, H, generator=g)
    c0 = torch.randn(2 * L, B, H, generator=g)
    kw = dict(mode="LSTM", num_layers=L, is_bidirec=True)

    def run(where, grad):
        def mv(t):
            t = t.to(where).clone()
            return t.requires_grad_(grad)
        xs, hs, cs = mv(x), mv(h0), mv(c0)
        ws = [[mv(w) for w in bundle] for bundle in weights]
        out, hn, cn = _C_ops.rnn(xs, hs, cs, ws, **kw)
        return (xs, hs, ws), (out, hn, cn)

    old = _no_tf32(torch)
    try:
        res = {}
        for where in (dev, "cpu"):
            (xs, hs, ws), outs = run(where, True)
            gw = torch.Generator().manual_seed(5)
            loss = sum((o * torch.rand(o.shape, generator=gw).to(o.device)
                        ).sum() for o in outs)
            grads = torch.autograd.grad(loss, [xs, hs] + ws[0])
            res[str(where)] = (outs, grads)
        card, cpu = res[str(dev)], res["cpu"]
        names = ["out", "h_n", "c_n"]
        worst = {n: _rel(torch, a, b) for n, a, b in zip(names, card[0],
                                                          cpu[0])}
        worst.update({f"grad_{n}": _rel(torch, a, b) for n, a, b in zip(
            ["x", "h0", "w_ih0", "w_hh0", "b_ih0", "b_hh0"], card[1],
            cpu[1])})
        require(max(worst.values()) <= RNN_REL,
                f"RNN_OP card against CPU: {worst}")
        (xs, hs, ws), _ = run(dev, True)
        cs = c0.to(dev)

        def fwd():
            with torch.no_grad():
                _C_ops.rnn(xs, hs, cs, ws, **kw)

        def fwd_bwd():
            out = _C_ops.rnn(xs, hs, cs, ws, **kw)[0]
            out.sum().backward()

        fwd_ms = cuda_ms(torch, fwd, 5, warmup=2)
        step_ms = cuda_ms(torch, fwd_bwd, 5, warmup=2)
    finally:
        _restore_tf32(torch, old)
    out = {"config": c, "forward_ms": fwd_ms, "forward_backward_ms": step_ms,
           "card_vs_cpu_rel": worst, "rel_limit": RNN_REL,
           "library": "cuDNN through torch.lstm (the reference's lax.scan "
                      "has no Pallas kernel)"}
    print(f"[rnn_op] LSTM {L} layers, bidirectional, {I}/{H}, T={T}, B={B}, "
          f"f32: forward {fwd_ms:.3f} ms, forward + backward {step_ms:.3f} "
          f"ms; card against CPU worst {max(worst.values()):.3g} of the "
          f"largest |value| (limit {RNN_REL})")
    print("RNN_OP " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 9: the generated op surface and the layer tail (BMHA_OP,
# LSTM_LAYER, SURFACE)
# ---------------------------------------------------------------------------

# the paddle op block_multihead_attention_ at LLaMA-7B's attention: 32
# heads of 128, block 16, rope (rotate-half) on; four prefill rows and
# four decode rows at 1,000-2,000 past positions, one layer's pool
BMHA = dict(H=32, hd=128, bs=16, prefill=(64, 192, 320, 512),
            decode_past=(1000, 1333, 1667, 2000), rope_len=4096)


def bmha_inputs(torch, np, dev, int8):
    """One BMHA_OP call's inputs on `dev`: the packed qkv [T, 3·H·hd]
    bf16, the pool (bf16 pages, or int8 pages with the four scale
    tensors calibrated on the pool's and this call's K/V: per-head
    127 / absmax, pages absmax / 127), the block tables, the lengths,
    cu_seqlens_q and the rope table [2, 1, S, hd] f32. Seeded; every
    page of the pool is filled."""
    c = BMHA
    H = KV = c["H"]
    hd, bs = c["hd"], c["bs"]
    past = [0] * len(c["prefill"]) + list(c["decode_past"])
    this = list(c["prefill"]) + [1] * len(c["decode_past"])
    B = len(past)
    cu = np.concatenate([[0], np.cumsum(this)]).astype(np.int32)
    T = int(cu[-1])
    need = [-(-(p + t) // bs) for p, t in zip(past, this)]
    tables = -np.ones((B, max(need)), np.int32)
    nxt = 0
    for b, n in enumerate(need):
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    nb = nxt
    g = torch.Generator(device=dev).manual_seed(19 + int8)
    qkv = torch.randn(T, 3 * H * hd, generator=g, device=dev
                      ).to(torch.bfloat16)
    kc, vc = (torch.randn(nb, KV, bs, hd, generator=g, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))
    ang = np.arange(c["rope_len"])[:, None] * inv[None, :]
    from paddle_tpu_torch.ops.kernels import serving_attention as SA
    rope = SA.rope_table(torch.tensor(np.cos(ang), dtype=torch.float32),
                         torch.tensor(np.sin(ang), dtype=torch.float32)
                         ).to(dev)
    scales = {}
    if int8:
        q3 = qkv.view(T, 3 * H, hd)
        absk = torch.maximum(kc.float().abs().amax((0, 2, 3)),
                             q3[:, H:2 * H].float().abs().amax((0, 2)))
        absv = torch.maximum(vc.float().abs().amax((0, 2, 3)),
                             q3[:, 2 * H:].float().abs().amax((0, 2)))
        # rope keeps each pair's norm, so |k| after it stays under
        # sqrt(2) of the absmax before it
        absk = absk * math.sqrt(2.0)
        kq, vq = 127.0 / absk, 127.0 / absv
        kc = torch.clamp(torch.round(kc.float() * kq[None, :, None, None]),
                         -127, 127).to(torch.int8)
        vc = torch.clamp(torch.round(vc.float() * vq[None, :, None, None]),
                         -127, 127).to(torch.int8)
        scales = dict(
            cache_k_quant_scales=kq, cache_v_quant_scales=vq,
            cache_k_dequant_scales=(absk / 127.0)[None].repeat(nb, 1)
            .contiguous(),
            cache_v_dequant_scales=(absv / 127.0)[None].repeat(nb, 1)
            .contiguous())
    lens = dict(seq_lens_encoder=torch.tensor(
                    [t if p == 0 else 0 for p, t in zip(past, this)],
                    dtype=torch.int32, device=dev),
                seq_lens_decoder=torch.tensor(past, dtype=torch.int32,
                                              device=dev),
                seq_lens_this_time=torch.tensor(this, dtype=torch.int32,
                                                device=dev))
    return dict(qkv=qkv, kc=kc, vc=vc, scales=scales, lens=lens,
                cu=torch.from_numpy(cu).to(dev),
                tables=torch.from_numpy(tables).to(dev), rope=rope,
                np_cu=cu, np_tables=tables, past=past, this=this, T=T)


def bmha_call(op, inp, kc, vc, wrap=lambda t: t):
    """`block_multihead_attention_` under ops.yaml's signature on `inp`
    (with the caches kc, vc), each tensor through `wrap`."""
    lens = inp["lens"]
    return op(wrap(inp["qkv"]), wrap(kc), wrap(vc),
              wrap(lens["seq_lens_encoder"]), wrap(lens["seq_lens_decoder"]),
              wrap(lens["seq_lens_this_time"]), cu_seqlens_q=wrap(inp["cu"]),
              block_tables=wrap(inp["tables"]), rope_emb=wrap(inp["rope"]),
              use_neox_style=True, block_size=BMHA["bs"],
              **{k: wrap(v) for k, v in inp["scales"].items()})


def bmha_op(torch, np, C, dev):
    """`BMHA_OP`: the paddle op `block_multihead_attention_` under
    ops.yaml's signature (`ops/kernels/serving_attention.py`) on port
    Tensors at LLaMA-7B's attention (BMHA: 32 heads of 128, block 16,
    rope on; four prefill rows of 64-512 tokens, four decode rows at
    1,000-2,000 past positions), on bf16 pages and on int8 pages with
    calibrated scales. Each call launches A5 (bf16) or A5 int8 once and
    nothing else (the main path, counted from 0). Its fmha_out and the
    pages it wrote are held bit-equal to the engine's form,
    `paged_block_attention` over `paged_metadata` on the same inputs,
    and against the CPU's run of the op (the plain version) under
    TOL_RULE (int8 pages: entries at most one step apart, counted).
    Then CUDA event times of the op on bare tensors beside the bare A5
    call at the same q rows: the difference is the entry's host work
    (metadata built on the host from the device tensors, one copy to
    the host). Returns the path's launches."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import _C_ops
    from paddle_tpu_torch.ops.kernels import serving_attention as SA
    PA = C.paged_attention
    _eager_place(P, dev)
    op = _C_ops.block_multihead_attention_
    launches = {k.name: 0 for k in C.KERNELS}
    out = {"config": BMHA}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        kernel = "paged_attention_int8" if int8 else "paged_attention"
        inp = bmha_inputs(torch, np, dev, int8)
        kc0, vc0 = inp["kc"].clone(), inp["vc"].clone()
        kc_t, vc_t = P.to_tensor(inp["kc"]), P.to_tensor(inp["vc"])
        # the main path, counted from 0: the op on port Tensors
        for k in C.KERNELS:
            k.reset()
        res = bmha_call(op, inp, kc_t, vc_t, lambda t: t if isinstance(
            t, P.Tensor) else P.to_tensor(t))
        torch.cuda.synchronize()
        n = launch_counts(C)
        require(n[kernel] == 1 and sum(n.values()) == 1,
                f"BMHA_OP {tag}: launches {n}, not {kernel} once")
        launches[kernel] += 1
        require(len(res) == 4 and res[2]._data is kc_t._data
                and res[3]._data is vc_t._data,
                f"BMHA_OP {tag}: not (fmha_out, qkv_out, key_cache_out, "
                f"value_cache_out) with the caches written in place")
        fmha = res[0]._data
        T = inp["T"]
        max_q = max(inp["this"])        # the op packs its longest chunk
        require(tuple(fmha.shape) == (T, BMHA["H"] * BMHA["hd"])
                and bool(torch.isfinite(fmha.float()).all()),
                f"BMHA_OP {tag}: fmha_out {tuple(fmha.shape)} not finite")
        # the engine's form on the same inputs: bit for bit
        kc2, vc2 = kc0.clone(), vc0.clone()
        meta = SA.paged_metadata(inp["np_cu"], np.array(inp["past"]),
                                 np.array(inp["this"]), inp["np_tables"], T,
                                 BMHA["bs"], inp["rope"], max_q=max_q)
        o2 = SA.paged_block_attention(inp["qkv"], kc2, vc2, meta,
                                      **inp["scales"])
        require(torch.equal(fmha, o2) and torch.equal(kc_t._data, kc2)
                and torch.equal(vc_t._data, vc2),
                f"BMHA_OP {tag}: the op and the engine's PagedMeta call "
                f"differ")
        del kc2, vc2, o2, meta
        # the CPU's run of the op: the plain version
        cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in inp.items() if k not in ("lens", "scales")}
        cpu["lens"] = {k: v.cpu() for k, v in inp["lens"].items()}
        cpu["scales"] = {k: v.cpu() for k, v in inp["scales"].items()}
        kc3, vc3 = kc0.cpu(), vc0.cpu()
        o3 = bmha_call(op, cpu, kc3, vc3)[0]
        errs = {"fmha_out": held(f"BMHA_OP {tag} fmha_out", fmha.cpu(), o3)}
        for what, a, b in (("key_cache", kc_t._data.cpu(), kc3),
                           ("value_cache", vc_t._data.cpu(), vc3)):
            if int8:
                d = (a.int() - b.int()).abs()
                require(int(d.max()) <= 1, f"BMHA_OP int8 {what}: entries "
                        f"{int(d.max())} steps apart")
                errs[what] = {"entries_one_step_apart": int((d > 0).sum())}
            else:
                errs[what] = held(f"BMHA_OP bf16 {what}", a, b)
        del o3, kc3, vc3, cpu
        # times: the op on bare tensors, and the bare A5 call on q rows
        # of the same shape (max_q rows a sequence, G = 1)
        bare_kc, bare_vc = inp["kc"], inp["vc"]
        op_ms = cuda_ms(torch, lambda: bmha_call(op, inp, bare_kc, bare_vc),
                        10)
        B = len(inp["past"])
        q_rows = torch.randn(B, BMHA["H"], max_q, BMHA["hd"], device=dev
                             ).to(torch.bfloat16)
        sc = inp["scales"]
        lens = inp["lens"]
        kernel_ms = cuda_ms(torch, lambda: PA.paged_attention(
            q_rows, bare_kc, bare_vc, inp["tables"],
            lens["seq_lens_decoder"], lens["seq_lens_this_time"], 1,
            BMHA["hd"] ** -0.5, k_dequant=sc.get("cache_k_dequant_scales"),
            v_dequant=sc.get("cache_v_dequant_scales")), 10)
        out[tag] = {"tokens": T, "op_ms": op_ms, "kernel_ms": kernel_ms,
                    "entry_host_ms": op_ms - kernel_ms, "errors": errs,
                    "launches_per_call": n[kernel]}
        print(f"[bmha_op] {tag} pages, {T} tokens (prefill "
              f"{list(BMHA['prefill'])}, decode at {list(BMHA['decode_past'])}"
              f"): op {op_ms:.3f} ms, bare A5 {kernel_ms:.3f} ms, entry "
              f"{op_ms - kernel_ms:.3f} ms; "
              + held_str("fmha_out", errs["fmha_out"]))
        del inp, kc_t, vc_t, res, fmha, q_rows, kc0, vc0
        torch.cuda.empty_cache()
    out["tol_rule"] = TOL_RULE
    print("BMHA_OP " + json.dumps(out))
    return launches


# paddle_tpu_torch.nn.LSTM at RNN_OP's encoder shape, a Linear head and
# CTC; AdamW, timed steps after warm-up; card against CPU over
# LSTM_AGREE_STEPS steps, TF32 off, within LSTM_REL of the largest loss
LSTM_LAYER = dict(T=128, B=32, I=512, H=512, layers=2, classes=32,
                  label_len=(20, 40), steps=5, warmup=2, lr=1e-3)
LSTM_AGREE_STEPS = 3
LSTM_REL = 1e-5


def lstm_model(P, seed):
    """The LSTM_LAYER model, seeded: (lstm, head)."""
    c = LSTM_LAYER
    P.seed(seed)
    lstm = P.nn.LSTM(c["I"], c["H"], num_layers=c["layers"],
                     direction="bidirect")
    head = P.nn.Linear(2 * c["H"], c["classes"])
    return lstm, head


def lstm_batch(np, P):
    """A seeded batch: x [B, T, I] f32, labels [B, max_len] int32 in
    1..classes-1 (0 is the blank), input and label lengths."""
    c = LSTM_LAYER
    rs = np.random.RandomState(7)
    lo, hi = c["label_len"]
    lab_len = rs.randint(lo, hi + 1, c["B"]).astype(np.int64)
    labels = rs.randint(1, c["classes"], (c["B"], hi)).astype(np.int32)
    x = rs.randn(c["B"], c["T"], c["I"]).astype(np.float32)
    return (P.to_tensor(x), P.to_tensor(labels),
            P.to_tensor(np.full(c["B"], c["T"], np.int64)),
            P.to_tensor(lab_len))


def lstm_steps(P, lstm, head, opt, batch, steps, split=None):
    """`steps` AdamW steps, each ended by reading the loss; the losses.
    With `split` (a dict), each step's parts are timed on the host's
    clock, the card synchronized between them: the LSTM forward, the
    head and CTC forward, the backward, and the AdamW step with the
    loss read, summed into split in ms."""
    import torch
    x, labels, in_len, lab_len = batch
    ctc = P.nn.CTCLoss(blank=0, reduction="mean")
    losses = []

    def mark(part, t0):
        if split is None:
            return t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        split[part] = split.get(part, 0.0) + (t1 - t0) * 1e3
        return t1

    for _ in range(steps):
        t = mark("start", time.perf_counter())
        y, _ = lstm(x)
        t = mark("lstm_forward", t)
        logits = head(y).transpose([1, 0, 2])            # [T, B, classes]
        loss = ctc(logits, labels, in_len, lab_len)
        t = mark("head_ctc_forward", t)
        loss.backward()
        t = mark("backward", t)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        mark("adamw_and_read", t)
    if split is not None:
        split.pop("start")
    return losses


def lstm_layer(torch, np, dev):
    """`LSTM_LAYER`: paddle_tpu_torch.nn.LSTM(512, 512, num_layers=2,
    direction="bidirect") (RNN_OP's encoder shape) under a Linear head
    and nn.CTCLoss, T 128, B 32, f32, AdamW: LSTM_LAYER["steps"] timed
    steps after LSTM_LAYER["warmup"], each ended by reading the loss
    (samples/s, ms a step); then the card's losses against the CPU's
    from the same seeded weights over LSTM_AGREE_STEPS steps, TF32 off,
    within LSTM_REL of the largest. The forward is the `rnn` op, cuDNN
    on the card (no kernel of the port)."""
    import paddle_tpu_torch as P
    c = LSTM_LAYER
    old = _no_tf32(torch)
    try:
        losses, state = {}, None
        for where in ("cpu", dev.type):
            P.set_device("cpu" if where == "cpu" else "gpu:0")
            lstm, head = lstm_model(P, 11)
            # one set of weights, the CPU's as built, carried to the card
            # (copied: numpy() shares the tensors the CPU's steps update)
            if state is None:
                state = [{k: v.numpy().copy()
                          for k, v in m.state_dict().items()}
                         for m in (lstm, head)]
            else:
                for m, sd in zip((lstm, head), state):
                    m.set_state_dict(sd)
            opt = P.optimizer.AdamW(
                learning_rate=c["lr"],
                parameters=lstm.parameters() + head.parameters())
            losses[where] = lstm_steps(P, lstm, head, opt, lstm_batch(np, P),
                                       LSTM_AGREE_STEPS)
        card, cpu = losses[dev.type], losses["cpu"]
        top = max(abs(v) for v in cpu)
        worst = max(abs(a - b) for a, b in zip(card, cpu)) / top
        require(all(math.isfinite(v) for v in card) and worst <= LSTM_REL,
                f"LSTM_LAYER card losses {card} against the CPU's {cpu}: "
                f"{worst:.3g} of the largest (limit {LSTM_REL})")
    finally:
        _restore_tf32(torch, old)
    P.set_device("gpu:0")
    lstm, head = lstm_model(P, 12)
    opt = P.optimizer.AdamW(learning_rate=c["lr"],
                            parameters=lstm.parameters() + head.parameters())
    batch = lstm_batch(np, P)
    lstm_steps(P, lstm, head, opt, batch, c["warmup"])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        timed_losses = lstm_steps(P, lstm, head, opt, batch, c["steps"])
        dt = time.perf_counter() - t0
    require(all(math.isfinite(v) for v in timed_losses),
            f"LSTM_LAYER losses not finite: {timed_losses}")
    # cuDNN reads the weights in place: each layer's are views into one
    # buffer of their own (RNNBase.flatten_parameters), and no call warns
    # that it compacts them
    per_layer = 4 * lstm.num_directions
    ws = [lstm._parameters[n]._data for n in lstm._flat_names]
    buffers = [len({w.untyped_storage().data_ptr()
                    for w in ws[i:i + per_layer]})
               for i in range(0, len(ws), per_layer)]
    compacted = sum("contiguous chunk" in str(w.message) for w in caught)
    require(buffers == [1] * c["layers"] and compacted == 0,
            f"LSTM_LAYER weights: buffers a layer {buffers}, {compacted} "
            f"compaction warnings")
    # where a step's time goes: the same steps again, the card
    # synchronized between their parts
    split = {}
    lstm_steps(P, lstm, head, opt, batch, c["steps"], split)
    split = {k: v / c["steps"] for k, v in split.items()}
    out = {"config": c, "samples_per_s": c["B"] * c["steps"] / dt,
           "ms_per_step": dt * 1e3 / c["steps"], "losses": timed_losses,
           "card_losses": card, "cpu_losses": cpu,
           "card_vs_cpu_rel": worst, "rel_limit": LSTM_REL,
           "weight_buffers_per_layer": buffers,
           "compaction_warnings": compacted, "split_ms_per_step": split}
    print(f"[lstm_layer] nn.LSTM {c['layers']} layers bidirect "
          f"{c['I']}/{c['H']}, T={c['T']}, B={c['B']}, CTC, AdamW: "
          f"{out['samples_per_s']:.1f} samples/s, {out['ms_per_step']:.2f} "
          f"ms a step; card against CPU over {LSTM_AGREE_STEPS} steps "
          f"{worst:.3g} of the largest loss (limit {LSTM_REL}); split "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " ms")
    print("LSTM_LAYER " + json.dumps(out))
    return out


SURFACE_MLP = (6, 16, 3)                 # in, hidden, out
SURFACE_REL = 1e-5
SURFACE_FLASH = dict(B=8, T=512, H=12, hd=64)     # BERT-base's attention
SURFACE_ENGINE_LAYERS = 8
SURFACE_MAX_NEW = 16


def surface_autograd(torch, np, P, dev):
    """jacobian and hessian of a small seeded MLP on the card against
    the CPU's, TF32 off, within SURFACE_REL of the largest entry; a
    `save` of its state_dict on the card, `load`ed on the CPU, equal."""
    import tempfile
    n_in, n_hid, n_out = SURFACE_MLP
    rs = np.random.RandomState(3)
    w1 = rs.randn(n_in, n_hid).astype(np.float32) * 0.5
    w2 = rs.randn(n_hid, n_out).astype(np.float32) * 0.5
    x0 = rs.randn(n_in).astype(np.float32)
    got = {}
    old = _no_tf32(torch)
    try:
        for place in ("cpu", "gpu:0"):
            P.set_device(place)
            a, b = P.to_tensor(w1), P.to_tensor(w2)
            x = P.to_tensor(x0)
            x.stop_gradient = False
            y = P.tanh(x.reshape([1, -1]) @ a) @ b
            jac = P.autograd.jacobian(y.reshape([-1]), x)[:]
            x2 = P.to_tensor(x0)
            x2.stop_gradient = False
            s = (P.tanh(x2.reshape([1, -1]) @ a) @ b).square().sum()
            hes = P.autograd.hessian(s, x2)[:]
            got[place] = (jac.numpy(), hes.numpy())
    finally:
        _restore_tf32(torch, old)
    rel = {}
    for i, what in enumerate(("jacobian", "hessian")):
        c, g = got["cpu"][i], got["gpu:0"][i]
        require(g.shape == c.shape and np.all(np.isfinite(g)),
                f"SURFACE {what}: {g.shape} against {c.shape}")
        rel[what] = float(np.abs(g - c).max() / np.abs(c).max())
        require(rel[what] <= SURFACE_REL, f"SURFACE {what}: card against CPU "
                f"{rel[what]:.3g} of the largest (limit {SURFACE_REL})")
    P.set_device("gpu:0")
    layer = P.nn.Sequential(P.nn.Linear(n_in, n_hid), P.nn.Tanh(),
                            P.nn.Linear(n_hid, n_out))
    sd = layer.state_dict()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/mlp.pdparams"
        P.save(sd, path)
        P.set_device("cpu")
        back = P.load(path)
    require(list(back) == list(sd)
        and all(back[k]._data.device.type == "cpu" for k in back)
        and all(np.array_equal(back[k].numpy(), sd[k].numpy()) for k in sd),
        "SURFACE save on the card, load on the CPU: the state differs")
    P.set_device("gpu:0")
    return {"autograd_card_vs_cpu_rel": rel, "rel_limit": SURFACE_REL,
            "saved_entries": len(sd)}


def surface_flash(torch, np, P, C, dev):
    """nn.functional.flash_attn_qkvpacked at BERT-base's attention (B 8,
    T 512, 12 heads of 64, bf16, non-causal) on port Tensors: A1 once
    (counted from 0), its output held to A1's plain version under
    TOL_RULE. Returns the launches."""
    FA = C.flash_attention
    c = SURFACE_FLASH
    B, T, H, hd = c["B"], c["T"], c["H"], c["hd"]
    g = torch.Generator(device=dev).manual_seed(31)
    qkv = torch.randn(B, T, 3, H, hd, generator=g, device=dev
                      ).to(torch.bfloat16)
    t = P.to_tensor(qkv)
    for k in C.KERNELS:
        k.reset()
    o = P.nn.functional.flash_attn_qkvpacked(t)
    o = o[0] if isinstance(o, (list, tuple)) else o
    torch.cuda.synchronize()
    n = launch_counts(C)
    require(n["flash_attention"] == 1 and sum(n.values()) == 1,
            f"SURFACE flash_attn_qkvpacked: launches {n}, not A1 once")
    qt, kt, vt = (qkv[:, :, i].transpose(1, 2).contiguous()
                  for i in range(3))
    ref, _ = FA.flash_attention_fwd_plain(qt, kt, vt, False, hd ** -0.5)
    err = held("SURFACE flash_attn_qkvpacked", o._data,
               ref.transpose(1, 2))
    return n, err


def surface_flags_engine(torch, np, Q, L, Engine, dev):
    """A w8 + int8-KV engine built from FLAGS_quant_mode,
    FLAGS_quant_kv_cache and FLAGS_quant_manifest alone, at LLaMA-7B
    width cut to SURFACE_ENGINE_LAYERS layers, serving standard_trace's
    8 requests greedily: its tokens equal those of the engine built from
    arguments on the same weights and manifest."""
    import dataclasses
    import tempfile
    import paddle_tpu_torch as P
    cfg = dataclasses.replace(L.CONFIGS["llama-7b"],
                              num_layers=SURFACE_ENGINE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = L.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    manifest = calibrate_w8(np, Q, cfg, params)
    trace = standard_trace(np, cfg, greedy=True)
    geom = dict(block_size=16, max_batch=8, token_budget=64, max_len=2048,
                device=dev)
    names = ("FLAGS_quant_mode", "FLAGS_quant_kv_cache",
             "FLAGS_quant_manifest")
    prev = P.get_flags(list(names))
    streams = {}
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/manifest.json"
        Q.save_manifest(manifest, path)
        P.set_flags({"FLAGS_quant_mode": "w8", "FLAGS_quant_kv_cache": True,
                     "FLAGS_quant_manifest": path})
        try:
            eng = Engine(cfg, params, **geom)
        finally:
            P.set_flags(prev)
    require(eng.quant_mode == "w8" and eng.quant_kv
            and eng._key_cache.dtype == torch.int8,
            "SURFACE: the engine built from the flags is not w8 + int8 KV")
    streams["flags"] = serve_trace(torch, eng, trace,
                                   max_new=SURFACE_MAX_NEW)[0]
    del eng
    torch.cuda.empty_cache()
    eng = Engine(cfg, params, quant_mode="w8", quant_kv=True,
                 quant_manifest=manifest, **geom)
    streams["arguments"] = serve_trace(torch, eng, trace,
                                       max_new=SURFACE_MAX_NEW)[0]
    del eng, params
    torch.cuda.empty_cache()
    require(streams["flags"] == streams["arguments"],
            "SURFACE: the flag-built engine's greedy tokens differ from "
            "the argument-built engine's")
    return {"layers": SURFACE_ENGINE_LAYERS, "requests": len(trace),
            "tokens": sum(len(s) for s in streams["flags"]),
            "streams_equal": True}


def surface(torch, np, C, L, Q, Engine, dev):
    """`SURFACE`: a few cheap checks of the generated surface and the
    layer tail on the card: `surface_autograd` (jacobian, hessian, save
    on the card and load on the CPU), `surface_flash` (the packed
    flash-attention wrapper onto A1) and `surface_flags_engine` (the
    FLAGS_quant_* surface). Returns the path's launches (A1 once)."""
    import paddle_tpu_torch as P
    _eager_place(P, dev)
    out = surface_autograd(torch, np, P, dev)
    launches, out["flash_attn_qkvpacked"] = surface_flash(torch, np, P, C,
                                                          dev)
    out["flags_engine"] = surface_flags_engine(torch, np, Q, L, Engine, dev)
    print(f"[surface] jacobian / hessian card against CPU "
          f"{out['autograd_card_vs_cpu_rel']}; save on the card, load on "
          f"the CPU: {out['saved_entries']} entries equal; "
          + held_str("flash_attn_qkvpacked",
                     out["flash_attn_qkvpacked"])
          + f"; flag-built w8 + int8-KV engine: "
          f"{out['flags_engine']['tokens']} greedy tokens equal")
    print("SURFACE " + json.dumps(out))
    return launches


def surface_only(torch, np, C, L, Q, build, Engine, smi):
    """`python3 chip_smoke.py --surface`: phase 9 alone (BMHA_OP,
    LSTM_LAYER, SURFACE), with the kernels on its paths built first
    (A5's two libraries, A1; A3, A6 and A7 for SURFACE's engines)."""
    print(f"[surface] {smi}")
    build_kernels(C, build)
    dev = torch.device("cuda")
    bmha_op(torch, np, C, dev)
    lstm_layer(torch, np, dev)
    surface(torch, np, C, L, Q, Engine, dev)


def detect_only(torch, np, smi):
    """`python3 chip_smoke.py --detect`: phases 8g-8i alone (no kernel of
    the port is on their path, so none is built)."""
    print(f"[detect] {smi}")
    dev = torch.device("cuda")
    det = detect_phase(torch, np, dev)
    detect_ops(torch, np, dev, det)
    del det
    torch.cuda.empty_cache()
    rnn_op(torch, np, dev)


def transformer_only(torch, np, C, build, smi):
    """`python3 chip_smoke.py --transformer`: phases 8c-8f alone (A1's and
    A2's libraries built first)."""
    print(f"[transformer] {smi}")
    build.build_all([C.flash_attention.KERNEL_FWD,
                     C.flash_attention.KERNEL_BWD])
    dev = torch.device("cuda")
    bert_phase(torch, np, dev)
    bert_base_amp(torch, np, dev)
    flash_attn_op(torch, np, C, dev)
    fused_mt(torch, np, dev)


def eager_only(torch, np, smi):
    """`python3 chip_smoke.py --eager`: phases 8a and 8b alone (no kernel
    of the port is on their path, so none is built)."""
    print(f"[eager] {smi}")
    eager_dispatch(torch, np, torch.device("cuda"))
    lenet_phase(torch, np, torch.device("cuda"))


def paged_only(torch, C, build, dev):
    """`python3 chip_smoke.py --paged`: build A5's two libraries from the
    checkout and run `check_paged` alone, fp then int8 pages, then print
    one JSON line of every case's event and device time. For A/B runs of
    A5 from two trees in one chip call, in turns A B B A."""
    PA = C.paged_attention
    build.build_all([PA.KERNEL, PA.KERNEL_INT8])
    times = {}
    for int8 in (False, True):
        check_paged_rows(torch, PA, dev, int8)
        for r in check_paged(torch, PA, dev, int8):
            times[f"{'int8' if int8 else 'fp'}:{r['case']}"] = {
                k: r[k] for k in ("ms", "device_ms", "bound_ms")}
    print(json.dumps({"paged": times}))


def sample_only(torch, C, build, dev):
    """`python3 chip_smoke.py --sample`: build A7 from the checkout and
    run `check_fused_sample` alone, then print one JSON line of every
    case's event, device and plain time and its bound. For A/B runs of
    A7 from two trees in one chip call, in turns A B B A."""
    FS = C.fused_sample
    build.build_all([FS.KERNEL])
    sample_plans(FS)
    print(json.dumps({"sample": {
        r["case"]: {k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                      "bound_ms")}
        for r in check_fused_sample(torch, FS, dev)}}))


def disagg_only(torch, np, C, L, Q, build, Engine, dev, smi):
    """`python3 chip_smoke.py --disagg`: build every kernel from the
    checkout and run phase 4c alone (SLOT_BENCH through AUTOSCALE)."""
    build_kernels(C, build)
    serve_disagg(torch, np, C, L, Q, Engine, dev, smi)


def check_kernels(torch, C, dev):
    """Phase 3: every kernel against its plain version at its paths'
    shapes. Returns {kernel name: case rows}."""
    cases = {"paged_attention": check_paged_attention(torch, C.paged_attention,
                                                      dev),
             "fused_ffn": check_fused_ffn(torch, C.fused_ffn, dev),
             "fused_sample": check_fused_sample(torch, C.fused_sample, dev),
             "fused_ffn_bwd": check_fused_ffn_bwd(torch, C.fused_ffn, dev),
             "paged_attention_int8": check_paged_attention_int8(
                 torch, C.paged_attention, dev),
             "fused_ffn_w8": check_fused_ffn_w8(torch, C.fused_ffn, dev)}
    for int8 in (False, True):
        check_paged_rows(torch, C.paged_attention, dev, int8)
    cases["flash_attention"], cases["flash_attention_bwd"] = \
        check_flash_attention(torch, C.flash_attention, dev)
    seg_fwd, seg_bwd = check_flash_attention(torch, C.flash_attention, dev,
                                             lens=VARLEN_LENS)
    cases["flash_attention"] += seg_fwd
    cases["flash_attention_bwd"] += seg_bwd
    bench_fwd, bench_bwd = check_flash_attention(
        torch, C.flash_attention, dev, B=BENCH_TRAIN_B, T=BENCH_TRAIN_T,
        H=BENCH_TRAIN["num_heads"], kv_heads=(None,), prefix="train_bench_")
    cases["flash_attention"] += bench_fwd
    cases["flash_attention_bwd"] += bench_bwd
    cases["fused_ffn_bwd"] += check_fused_ffn_bwd(
        torch, C.fused_ffn, dev, R=BENCH_TRAIN_B * BENCH_TRAIN_T,
        d=BENCH_TRAIN["hidden_size"], f=BENCH_TRAIN["intermediate_size"],
        case="train_bench")
    for B, heads in PRED_ATTN:
        cases["flash_attention"] += check_flash_attention(
            torch, C.flash_attention, dev, B=B, T=PRED_T, H=heads,
            kv_heads=(None,), backward=False,
            prefix=f"pred_B{B}_H{heads}_")[0]
    cases["fused_gemm_epilogue"] = check_gemm_epilogue(torch, C.fused_ffn,
                                                       dev)
    cases["fused_glu"] = check_fused_glu(torch, C.fused_ffn, dev)
    return cases


def quant_only(torch, np, C, L, Q, build, Engine, Predictor, dev):
    """`python3 chip_smoke.py --quant`: build every kernel from the
    checkout and run the quantized phases alone: the three quantized
    engines at LLaMA-7B (ENGINE_W8, ENGINE_W8A8, ENGINE_FP8), the
    quantized predictors at the bench's decode config and the quantized
    CPU-against-card agreement."""
    build_kernels(C, build)
    cfg, params = init_llama7b(torch, L, dev)
    serve_llama7b_quant(torch, np, C, L, Q, Engine, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    bench = L.LlamaConfig(**BENCH_DECODE, dtype=torch.bfloat16)
    for mode in ("w8", "w8a8", "fp8"):
        predict(torch, np, C, L, Predictor, dev, f"PREDICTOR_{mode.upper()}",
                bench, quant_mode=mode)
    agreement_w8(torch, np, L, Q, Engine, dev)


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
    from paddle_tpu_torch.inference import LLMPredictor, PagedServingEngine
    from paddle_tpu_torch.inference import quant as Q
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import cuda as C
    from paddle_tpu_torch.ops.cuda import build
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--paged"]:
        paged_only(torch, C, build, dev)
        return 0
    if sys.argv[1:] == ["--sample"]:
        sample_only(torch, C, build, dev)
        return 0
    if sys.argv[1:] == ["--disagg"]:
        disagg_only(torch, np, C, L, Q, build, PagedServingEngine, dev, smi)
        return 0
    if sys.argv[1:] == ["--quant"]:
        quant_only(torch, np, C, L, Q, build, PagedServingEngine,
                   LLMPredictor, dev)
        return 0
    if sys.argv[1:] == ["--eager"]:
        eager_only(torch, np, smi)
        return 0
    if sys.argv[1:] == ["--transformer"]:
        transformer_only(torch, np, C, build, smi)
        return 0
    if sys.argv[1:] == ["--detect"]:
        detect_only(torch, np, smi)
        return 0
    if sys.argv[1:] == ["--surface"]:
        surface_only(torch, np, C, L, Q, build, PagedServingEngine, smi)
        return 0
    if sys.argv[1:] == ["--hybrid"]:
        hybrid_only(torch, np, C, L, H, build, smi)
        return 0
    if sys.argv[1:] == ["--dp"]:
        dp_only(torch, np, C, L, H, build, smi)
        return 0
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] {name}: {phase_s[name]:.1f} s")
        return out

    timed("build", build_kernels, C, build)
    cases = timed("kernels", check_kernels, torch, C, dev)
    cfg7, params7 = init_llama7b(torch, L, dev)
    paths = {"serving": timed("engine", serve_llama7b, torch, np, C, L,
                              PagedServingEngine, dev, cfg7, params7)}
    torch.cuda.empty_cache()
    quant_paths = timed("engine_quant", serve_llama7b_quant, torch, np, C, L,
                        Q, PagedServingEngine, dev, cfg7, params7)
    paths.update(quant_paths)
    del params7
    torch.cuda.empty_cache()
    paths.update(timed("fleet", serve_fleet, torch, np, C, L,
                       PagedServingEngine, dev))
    torch.cuda.empty_cache()
    fleet_disagg = timed("slot_disagg", serve_disagg, torch, np, C, L, Q,
                         PagedServingEngine, dev, smi)
    torch.cuda.empty_cache()
    predictors = timed("predictors", serve_predictors, torch, np, C, L,
                       LLMPredictor, dev)
    paths.update(timed("train_7b", train_llama7b, torch, np, C, L, H, dev))
    bench_paths, bench_dots = timed("train_bench", train_bench, torch, np, C,
                                    L, H, dev)
    paths.update(bench_paths)
    paths.update(timed("hybrid", hybrid_phases, torch, np, C, L, H, dev,
                       bench_dots))
    timed("dp", dp_phases, torch, np, dev)
    paths.update(predictors)
    paths.update(fleet_disagg)
    paths["varlen"] = timed("varlen", varlen_stack, torch, np, C, L, dev)
    timed("agreement", agreement, torch, np, L, PagedServingEngine, dev)
    timed("agreement_predictor", predictor_agreement, torch, np, L,
          LLMPredictor, dev)
    timed("agreement_quant", agreement_w8, torch, np, L, Q,
          PagedServingEngine, dev)
    timed("agreement_train", train_agreement, torch, np, L, H, dev)
    timed("agreement_varlen", varlen_agreement, torch, C.fused_ffn, dev)
    timed("eager_dispatch", eager_dispatch, torch, np, dev)
    timed("lenet", lenet_phase, torch, np, dev)
    timed("bert", bert_phase, torch, np, dev)
    timed("bert_base_amp", bert_base_amp, torch, np, dev)
    paths["flash_attn_op"] = timed("flash_attn_op", flash_attn_op, torch, np,
                                   C, dev)
    timed("fused_mt", fused_mt, torch, np, dev)
    det = timed("detect", detect_phase, torch, np, dev)
    timed("detect_ops", detect_ops, torch, np, dev, det)
    del det
    torch.cuda.empty_cache()
    timed("rnn_op", rnn_op, torch, np, dev)
    paths["bmha_op"] = timed("bmha_op", bmha_op, torch, np, C, dev)
    torch.cuda.empty_cache()
    timed("lstm_layer", lstm_layer, torch, np, dev)
    paths["surface"] = timed("surface", surface, torch, np, C, L, Q,
                             PagedServingEngine, dev)

    kernels = []
    for k in C.KERNELS:
        by_path = {p: n[k.name] for p, n in paths.items() if n[k.name]}
        # a kernel of several paths reports the first path's count, in
        # the order serving, serving_w8, serving_w8a8, serving_fp8, the
        # fleet (adapters, spec_verify, spec_draft, router), training
        # (LLaMA-7B width at remat=True, then "dots"), training_bench
        # ("dots", then True), hybrid (the mesh step at the bench config)
        # and hybrid_moe (A1, A2), the predictors, the slot engine and the
        # disagg pools (slot, disagg_prefill, disagg_decode), varlen, the
        # flash_attn op (A1, A2), the block_multihead_attention_ op (A5,
        # A5 int8), the surface (A1): the path whose shape its first case row
        # times (A5, A3 and A7:
        # serving; A6: serving_w8; A1, A2 and A4: training; A8 and A9:
        # varlen). Every path's count is in launches_by_path
        launches = next(iter(by_path.values()))
        kernels.append(summary_row(k, cases[k.name], launches, by_path,
                                   build.REPO_ROOT))
    print(f"[summary] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s; by phase " + json.dumps(
              {k: round(v, 1) for k, v in phase_s.items()}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
