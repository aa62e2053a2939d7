"""Kernel A7: sampler prep — argmax, temperature, top-k and top-p masks.

Replaces `paddle_tpu/ops/pallas/fused_sample.py:78 fused_sample_prep`
(`_sample_kernel` :59, `pl.pallas_call` :113). In the reference only
decode ticks reach the kernel; in the port every tick does, so no plain
version sits on the card's path.

Bound on the H100: bytes — one read and one write of the [B, V] f32
logits (2 MB at B = 8, V = 32000) against a few operations an element;
finding two thresholds needs no sort.

Design (`csrc/fused_sample.cu`): one launch, one thread-block cluster of
up to 16 blocks a row. Each block bulk-copies its slice of the row into
shared memory once and keeps it there (a slice past `_RESIDENT_SMEM`
is streamed from L2 tile by tile on each pass instead); the blocks agree
on the argmax and on each digit of two radix selects — the count select
for the top-k threshold, a mass-weighted one (fixed-point masses, exact
integer sums) for the top-p cutoff — through distributed shared memory
and cluster barriers; the masked row is written from shared memory.
`sample_plan(V)` is the one place of the policy: the cluster, the
slices, resident or streamed, the mass scale and the digit widths, a
function of V alone, so a row's bits do not depend on the batch. Any
vocabulary is served. CUDA rather than Triton: the design rests on
clusters, distributed shared memory and bulk copies.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from . import build
from .build import INT, PTR

__all__ = ["fused_sample_prep", "fused_sample_prep_plain", "supported",
           "sample_plan", "plan_smem", "SamplePlan", "KERNEL"]

KERNEL = build.Kernel(
    "fused_sample",
    {"fused_sample_prep_fwd": [PTR] * 5 + [INT] * 10 + [PTR] * 2,
     "fused_sample_smem": [INT] * 5,
     "fused_sample_max_clusters": [INT] * 6},
    replaces="paddle_tpu/ops/pallas/fused_sample.py:78")

_BLOCK_SHARE = 4096       # floats a block aims at: V / 4096 blocks a row
MAX_CLUSTER = 16          # the card's largest (non-portable) cluster
DIGITS = (11, 11, 10)     # radix digits from the top of the 32-bit keys
_GROUPS = 64              # a digit's bins come in 64 groups
# two blocks an SM: 228 KB of shared memory, 1 KB reserved a block, and
# 1 KB left for the kernel's static shared memory
_RESIDENT_SMEM = 233472 // 2 - 2 * 1024
_STREAM_TILE = 16384      # floats a tile of a streamed slice


class SamplePlan(NamedTuple):
    cluster: int          # blocks a row, one thread-block cluster
    slice: int            # floats a block (the last may hold fewer)
    tile: int             # floats a tile; == slice when the slice stays
    shift: int            # mass scale: round(exp(l - max) * 2^shift)
    bits: Tuple[int, ...]  # digit widths from the top, summing to 32

    @property
    def resident(self) -> bool:
        return self.tile == self.slice


def plan_smem(cluster: int, tile: int, bits=DIGITS) -> int:
    """Dynamic shared memory of a block, as the kernel lays it out: two
    histograms of nb bins (two 32-bit words a bin), two sets of 64 group
    totals and a table of cluster x 64 (u64), then tile + 4 floats."""
    nb = 1 << max(bits)
    return 8 * (2 * nb + 2 * _GROUPS + cluster * _GROUPS) + 4 * (tile + 4)


@functools.lru_cache(maxsize=None)
def sample_plan(vocab: int) -> SamplePlan:
    """The kernel's plan for a row of `vocab` logits, from V alone: one
    block for each 4,096 floats up to a cluster of 16; the slice stays
    resident while two blocks of it fit an SM, else it is streamed in
    16,384-float tiles; masses carry 63 - ceil(log2 V) fraction bits, so
    V of them sum within 2^63."""
    if vocab < 1:
        raise ValueError(f"sampler vocabulary V={vocab} must be >= 1")
    cluster = min(MAX_CLUSTER, -(-vocab // _BLOCK_SHARE))
    slice_ = -(-vocab // cluster)
    tile = (slice_ if plan_smem(cluster, slice_) <= _RESIDENT_SMEM
            else _STREAM_TILE)
    shift = 63 - (vocab - 1).bit_length()
    return SamplePlan(cluster, slice_, tile, shift, DIGITS)


def supported(vocab: int) -> bool:
    """Can the CUDA kernel serve this vocabulary size? Any V >= 1."""
    return vocab >= 1


def fused_sample_prep_plain(logits, temps, top_ps, top_k: int = 0):
    """Plain PyTorch version, op for op the reference's `_sample_rows`
    masking: returns (masked logits [B, V] f32, argmax [B] int32)."""
    l = logits.float()
    amax = torch.argmax(l, dim=-1).to(torch.int32)
    l = l / torch.clamp(temps.float(), min=1e-6)[:, None]
    if top_k:
        kth = torch.topk(l, min(int(top_k), l.shape[-1]), dim=-1).values
        l = torch.where(l < kth[..., -1:], float("-inf"), l)
    sl = torch.sort(l, dim=-1, descending=True).values
    probs = torch.softmax(sl, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_ps.float()[:, None]     # exclusive prefix mass
    cutoff = torch.where(keep, sl, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(l < cutoff, float("-inf"), l), amax


def fused_sample_prep(logits, temps, top_ps, top_k: int = 0, stamps=None):
    """Sampling prep over f32 logits [B, V]; temps/top_ps [B] f32; top_k
    0 = off. Returns (masked logits [B, V] f32 — draw from them per row —
    and greedy argmax [B] int32). CPU tensors run the plain version;
    CUDA tensors launch the kernel. `stamps`, an int64 [64] CUDA tensor,
    gets the kernel's phase stamps (`chip_smoke.sample_phases` reads
    them)."""
    if logits.device.type == "cpu":
        return fused_sample_prep_plain(logits, temps, top_ps, top_k)
    B, V = logits.shape
    if logits.dtype != torch.float32 or temps.dtype != torch.float32 \
            or top_ps.dtype != torch.float32:
        raise ValueError("sampler prep takes float32 logits, temps, top_ps")
    if temps.numel() != B or top_ps.numel() != B:
        raise ValueError("temps and top_ps need one value per row")
    plan = sample_plan(V)
    stream = build.launch_stream("fused_sample_prep", logits, temps, top_ps,
                                 *([] if stamps is None else [stamps]))
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.numel() != 64):
        raise ValueError("stamps takes 64 int64 values")
    masked = torch.empty_like(logits)
    amax = torch.empty((B,), dtype=torch.int32, device=logits.device)
    err = KERNEL.fn("fused_sample_prep_fwd")(
        logits.data_ptr(), temps.data_ptr(), top_ps.data_ptr(),
        masked.data_ptr(), amax.data_ptr(), B, V, int(top_k), plan.cluster,
        plan.slice, plan.tile, plan.shift, *plan.bits,
        None if stamps is None else stamps.data_ptr(), stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return masked, amax
