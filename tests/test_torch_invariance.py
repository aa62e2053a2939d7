"""A row's bits independent of the tick's shape, on the card.

The paged engine runs every tick's row-wise work at token_budget rows
(`engine.py`), so a token's logits do not depend on whether its row sits
in a decode tick (max_batch live rows), a mixed tick or a speculative
verify chunk. What that rests on, held here bit for bit:

- the tick's products (q/k/v/o at LLaMA-7B width, the lm_head to 32,000,
  the LoRA deltas) at 64 rows: row 0 gives the same bits with 1, 8 or 64
  live rows, whatever the other rows hold;
- A3 (fused FFN) at R = 8 and R = 64: the same 64-row tile and d_ff
  split, so the same bits for rows 0..7;
- A5: rows of verify chunks and prefill chunks equal the same tokens'
  decode rows, bf16 and int8 pages (`chip_smoke.check_paged_rows`).

Marked `gpu`: without a CUDA device every test skips. No jax import:

    python -m pytest tests/test_torch_invariance.py --noconftest -q
"""
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.inference import quant as Q
from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from paddle_tpu_torch.ops.cuda import paged_attention as PA
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu

T = 64          # the engine's token_budget: every tick's row count


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _padded(h, live, g):
    """h's first `live` rows, the rest of the tick's T rows other values."""
    x = torch.randn(T, h.shape[1], generator=g, device=h.device).to(h.dtype)
    x[:live] = h[:live]
    return x


@pytest.mark.parametrize("d_in,d_out", [(4096, 4096), (4096, 32000)])
def test_tick_products_row_bits_at_1_8_64_live_rows(cuda, d_in, d_out):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = (torch.randn(d_in, d_out, generator=g, device=cuda) * 0.02).to(
        torch.bfloat16)
    h = torch.randn(T, d_in, generator=g, device=cuda).to(torch.bfloat16)
    rows = [Q.matmul_param(_padded(h, live, g), {"w": w}, "w")[0]
            for live in (1, 8, 64)]
    assert all(torch.equal(rows[0], r) for r in rows[1:])


def test_lora_delta_row_bits_at_1_8_64_live_rows(cuda):
    """The engine's LoRA delta (f32 einsums over 2 slots, rank 4) at T
    rows: row 0's delta does not move with the other rows."""
    g = torch.Generator(device=cuda).manual_seed(1)
    A = torch.randn(2, 4096, 4, generator=g, device=cuda) * 0.3
    B = torch.randn(2, 4, 4096, generator=g, device=cuda) * 0.3
    h = torch.randn(T, 4096, generator=g, device=cuda).to(torch.bfloat16)
    outs = []
    for live in (1, 8, 64):
        x = _padded(h, live, g)
        sel = torch.zeros(T, 2, device=cuda)
        sel[:, 1] = 2.0
        u = torch.einsum("td,sdr->tsr", x.float(), A)
        w = torch.einsum("tsr,sro->tso", u, B)
        outs.append(torch.einsum("tso,ts->to", w, sel)[0])
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_fused_ffn_rows_equal_at_8_and_64(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    d, f = 4096, 11008
    bf = torch.bfloat16
    x = torch.randn(64, d, generator=g, device=cuda).to(bf)
    w1, w3 = ((torch.randn(d, f, generator=g, device=cuda) * 0.02).to(bf)
              for _ in range(2))
    w2 = (torch.randn(f, d, generator=g, device=cuda) * 0.02).to(bf)
    assert FF.ffn_splits(8, d, f) == FF.ffn_splits(64, d, f)
    small = FF.fused_ffn(x[:8].contiguous(), w1, w3, w2)
    full = FF.fused_ffn(x, w1, w3, w2)
    assert torch.equal(small, full[:8])


@pytest.mark.parametrize("int8", [False, True])
def test_paged_verify_and_prefill_rows_equal_decode_rows(cuda, int8):
    assert chip_smoke.check_paged_rows(torch, PA, cuda, int8) == sum(
        t for _, t in chip_smoke.PAGED_ROW_CASES)
