"""What of the int8-weight FFN's (A6's) tensor-core redesign runs on the
CPU: its split plan for the down product, the wrapper's refusal of int8
operands TMA cannot read, the exactness of the on-chip int8 -> bf16
widening, and the design's rounding held against the reference.

The bf16 kernels (`csrc/fused_ffn_w8.cu`) take x in bf16, widen each
int8 weight tile to bf16 in shared memory, sum every product in f32 on
the tensor cores, put the scales s1, s3 on the f32 sums, write g as bf16
planes hi = bf16(g), lo = bf16(g - hi), and sum the down product over
both planes in f32 before s2 and the one rounding to bf16.
`_emulate_bf16_a6` below does that arithmetic in torch on the CPU; it is
held against `paddle_tpu.ops.pallas.fused_ffn.fused_ffn_w8(...,
interpret=True)` on the same bf16 x under the kernels' rule on the card
(TOL_RULE of chip_smoke.py: |got - ref| <= 2^-7 |ref| + 1e-3 rms(ref),
elementwise: one bf16 ulp, both sides rounding f32 sums once). The
kernels themselves run only on the card (`tests/test_torch_w8_hopper.py`).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import quant as JQ
from paddle_tpu.ops.pallas import fused_ffn as JFF
from paddle_tpu_torch.ops.cuda import fused_ffn as FF

_SMS = 132
ORDER = ("w1_q", "w1_s", "w3_q", "w3_s", "w2_q", "w2_s")


def _w8_layer(rows, d, f, seed):
    """x [rows, d] f32 and one layer's w8 FFN leaves, quantized by the
    reference's `quantize_llama_params`."""
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d).astype(np.float32)
    blocks = {n: (0.1 * rs.randn(1, *shape)).astype(np.float32)
              for n, shape in (("w1", (d, f)), ("w3", (d, f)),
                               ("w2", (f, d)))}
    blocks.update({n: np.zeros((1, d, d), np.float32)
                   for n in ("wq", "wk", "wv", "wo")})
    qp = JQ.quantize_llama_params(
        {"blocks": blocks, "lm_head": np.zeros((d, 8), np.float32)}, "w8")
    return x, {k: np.array(v[0]) for k, v in qp["blocks"].items()
               if k[:2] in ("w1", "w3", "w2")}


@pytest.mark.parametrize("rows,d,f,want", [
    (8, 4096, 11008, 8),        # decode tick: 64 column blocks, 8 slices
    (1, 4096, 11008, 8),
    (64, 4096, 11008, 4),       # prefill chunk: 64-row tiles two an SM
    (65, 4096, 11008, 2),       # two row tiles: 128 blocks, 2 slices
    (300, 4096, 11008, 1),
    (1, 64, 128, 2),            # llama-test widths: a slice per 64-deep tile
])
def test_a6_split_plan(rows, d, f, want):
    assert FF.w8_splits(rows, d, f, torch.bfloat16) == want
    assert FF.w8_splits(rows, d, f, torch.float32) == FF.splits(rows, d, f)


@pytest.mark.parametrize("rows", [1, 8, 9, 37, 63, 64, 65, 128, 300, 4096])
@pytest.mark.parametrize("d,f", [(64, 128), (4096, 11008), (5120, 13824),
                                 (8192, 28672)])
def test_a6_split_plan_keeps_the_launch_resident(rows, d, f):
    """At least one slice and at most one per 64-deep tile (and 16); a
    split bf16 launch never holds more blocks than the card keeps
    resident (`w8_tile`: 64 columns by 8 rows four to an SM, by 64 rows
    two)."""
    n = FF.w8_splits(rows, d, f, torch.bfloat16)
    assert 1 <= n <= min(16, math.ceil(f / 64))
    tile, per_sm = FF.w8_tile(rows)
    assert tile == (8 if rows <= 8 else 64)
    blocks = math.ceil(rows / tile) * math.ceil(d / 64)
    if n > 1:
        assert blocks * n <= _SMS * per_sm


def test_tma_ready_takes_int8_operands_and_scales():
    w = torch.zeros(64 * 128 + 16, dtype=torch.int8)
    FF._tma_ready("fused_ffn_w8", w[:64 * 128].view(64, 128))
    FF._tma_ready("fused_ffn_w8", w[16:16 + 64 * 128].view(64, 128))
    with pytest.raises(ValueError, match="16-byte"):
        FF._tma_ready("fused_ffn_w8", w[1:1 + 64 * 128].view(64, 128))
    rows = torch.zeros(64, 136, dtype=torch.int8)[:, :120]   # 136-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        FF._tma_ready("fused_ffn_w8", rows)
    s = torch.zeros(128 + 4)
    FF._tma_ready("fused_ffn_w8", s[4:])                      # 16 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        FF._tma_ready("fused_ffn_w8", s[1:])


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 numpy arrays: byte n of the result is
    byte (sel >> 4n) & 7 of the eight bytes {x, y}."""
    out = np.zeros_like(x)
    for n in range(4):
        b = (sel >> (4 * n)) & 7
        src = x if b < 4 else y
        out |= ((src >> np.uint32(8 * (b % 4))) & np.uint32(0xFF)) \
            << np.uint32(8 * n)
    return out


def test_int8_to_bf16_widening_is_exact():
    """`gemm::i8x4_bf16x4`'s recipe, step for step, for every int8 value:
    the sign-flipped byte into the mantissa of 2^23, 2^23 + 128 taken off
    in f32, the high half of the f32 as bf16. It equals the int8 value."""
    q = np.arange(-128, 128, dtype=np.int8)
    words = q.view(np.uint8).astype(np.uint32)
    words = words[0::4] | words[1::4] << 8 | words[2::4] << 16 \
        | words[3::4] << 24
    u = words ^ np.uint32(0x80808080)
    magic = np.full_like(u, 0x4B000000)
    lanes = [(_byte_perm(u, magic, 0x7540 + i).view(np.float32)
              - np.float32(8388736.0)).view(np.uint32) for i in range(4)]
    lo = _byte_perm(lanes[0], lanes[1], 0x7632)
    hi = _byte_perm(lanes[2], lanes[3], 0x7632)
    halves = np.stack([lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16],
                      axis=1).reshape(-1).astype(np.uint16)
    got = torch.from_numpy(halves.view(np.int16)).view(torch.bfloat16)
    want = torch.from_numpy(q).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(got.float(), torch.from_numpy(q).float())


def _emulate_bf16_a6(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s):
    """The bf16 kernels' arithmetic: bf16 x, weights widened to bf16
    (exact), f32 sums, s1 and s3 on the sums, g as hi + lo bf16 planes,
    the down product over both planes in f32, times s2, one rounding."""
    s1, s3, s2 = FF._w8_scales(w1_s, w3_s, w2_s)
    xb = x.to(torch.bfloat16).float()
    w1, w3, w2 = (w.to(torch.bfloat16).float() for w in (w1_q, w3_q, w2_q))
    u = (xb @ w1) * s1
    v = (xb @ w3) * s3
    g = torch.nn.functional.silu(u) * v
    hi = g.to(torch.bfloat16)
    lo = (g - hi.float()).to(torch.bfloat16)
    return ((hi.float() @ w2 + lo.float() @ w2) * s2).to(torch.bfloat16)


@pytest.mark.parametrize("rows", [8, 37])
def test_bf16_design_rounding_matches_reference(rows):
    """At llama-test widths (d 64, d_ff 128) the design's rounding stays
    inside TOL_RULE against the reference kernel on the same bf16 x."""
    x, lp = _w8_layer(rows, 64, 128, seed=rows + 40)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = JFF.fused_ffn_w8(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                           *(jnp.asarray(lp[k]) for k in ORDER),
                           interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    got = _emulate_bf16_a6(xb, *(torch.from_numpy(lp[k]) for k in ORDER))
    assert got.dtype == torch.bfloat16
    rms = ref.square().mean().sqrt()
    err = (got.float() - ref).abs()
    assert bool((err <= 2 ** -7 * ref.abs() + 1e-3 * rms).all()), \
        float((err / (2 ** -7 * ref.abs() + 1e-3 * rms)).max())
