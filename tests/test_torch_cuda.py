"""The port's CUDA kernels held against their plain versions, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture, never at import). On the card each wrapper is called on CUDA
tensors — which builds its kernel from `paddle_tpu_torch/ops/cuda/csrc`
with nvcc on first use — and compared with the plain PyTorch version on
the same inputs. This file imports neither jax nor the reference, so it
runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances, elementwise (`_close`): |got - want| <= rtol |want| + atol.
f32 inputs, f32 math in another summation order: rtol 1e-5 (attention
forward), 1e-4 for the FFN's deep sums and for every gradient, atol
rtol x the RMS of want. bf16 kernel outputs, rounded once to bf16 on
both sides after f32 sums: rtol 2^-7 (one bf16 ulp of |want|), atol
1e-3 x the RMS of want for the sums' order differences near 0. Paged
attention keeps 2e-2 for bf16. The sampler does the same division
as its plain version: argmax and the -inf pattern match exactly. The
training step on the card (kernels) and on the CPU (plain versions), f32
with TF32 off: losses rtol 1e-5, gradients 1e-4 of each leaf's largest
entry.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from paddle_tpu_torch.ops.cuda import fused_sample as FS
from paddle_tpu_torch.ops.cuda import paged_attention as PA

pytestmark = pytest.mark.gpu

_BF16 = 2 ** -7          # one bf16 ulp of |want|


def _close(got, want, rtol):
    """|got - want| <= rtol |want| + atol elementwise; atol is 1e-3 x the
    RMS of want for bf16 (rtol 2^-7), rtol x that RMS for f32."""
    want = want.float()
    rms = want.square().mean().sqrt().item()
    atol = (1e-3 if rtol == _BF16 else rtol) * rms
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _paged_case(dev, dtype, B, KV, G, hd, bs, past, this, max_q, seed=0):
    g = torch.Generator().manual_seed(seed)
    mb = max(-(-(p + t) // bs) for p, t in zip(past, this)) + 1
    nb = B * mb + 3
    q = torch.randn(B, KV, max_q * G, hd, generator=g)
    kc = torch.randn(nb, KV, bs, hd, generator=g)
    vc = torch.randn(nb, KV, bs, hd, generator=g)
    perm = torch.randperm(nb, generator=g).tolist()
    tables = torch.full((B, mb), -1, dtype=torch.int32)
    for b in range(B):
        for p in range(-(-(past[b] + this[b]) // bs)):
            tables[b, p] = perm.pop()
    lens = [torch.tensor(v, dtype=torch.int32) for v in (past, this)]
    return [t.to(dev, dtype) for t in (q, kc, vc)] + \
        [t.to(dev) for t in (tables, *lens)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G,max_q,past,this,hd,bs", [
    (1, 1, [63, 2047, 700, 0], [1, 1, 1, 0], 128, 16),   # decode, idle slot
    (4, 1, [5, 300, 17, 1], [1, 1, 1, 1], 128, 16),      # GQA decode
    (1, 20, [0, 33, 64, 5], [20, 1, 7, 0], 128, 16),     # mixed, pad rows
    (4, 12, [3, 0, 40, 9], [12, 5, 1, 2], 128, 16),      # GQA, > 32 rows
    (2, 3, [9, 250, 0], [3, 1, 2], 256, 16),             # widest head
    (1, 4, [130, 0, 300], [1, 4, 2], 64, 128),           # page > 64 keys
    (2, 2, [3, 17, 0], [2, 1, 1], 8, 4),                 # tiny head, page
])
def test_paged_attention_matches_plain(cuda, dtype, tol, G, max_q, past,
                                       this, hd, bs):
    q, kc, vc, tables, past_t, this_t = _paged_case(
        cuda, dtype, len(past), 2, G, hd, bs, past, this, max_q)
    PA.KERNEL.launches = 0
    out = PA.paged_attention(q, kc, vc, tables, past_t, this_t, G, hd ** -0.5)
    torch.cuda.synchronize()
    assert PA.KERNEL.launches == 1
    ref = PA.paged_attention_plain(q, kc, vc, tables, past_t, this_t, G,
                                   hd ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    for b, n in enumerate(this):
        assert torch.all(out[b, :, n * G:] == 0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, _BF16)])
@pytest.mark.parametrize("rows,d,f", [(1, 64, 128), (8, 256, 1024),
                                      (40, 128, 264), (300, 96, 520)])
def test_fused_ffn_matches_plain(cuda, dtype, rtol, rows, d, f):
    g = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, d, generator=g).to(cuda, dtype)
    w1, w3 = (0.1 * torch.randn(d, f, generator=g)).to(cuda, dtype), \
        (0.1 * torch.randn(d, f, generator=g)).to(cuda, dtype)
    w2 = (0.1 * torch.randn(f, d, generator=g)).to(cuda, dtype)
    out = FF.fused_ffn(x, w1, w3, w2)
    ref = FF.fused_ffn_plain(x, w1, w3, w2)
    _close(out, ref, rtol)
    # deterministic: no atomics in the split reduction
    assert torch.equal(FF.fused_ffn(x, w1, w3, w2), out)


@pytest.mark.parametrize("V,top_k", [(97, 0), (32000, 0), (32000, 50)])
def test_fused_sample_prep_matches_plain(cuda, V, top_k):
    rs = np.random.RandomState(V + top_k)
    B = 8
    logits = torch.from_numpy((3 * rs.randn(B, V)).astype(np.float32)).to(cuda)
    temps = torch.tensor([1.0, 0.8, 1e-9, 1.3, 0.8, 1.0, 0.5, 2.0],
                         device=cuda)
    top_ps = torch.tensor([1.0, 0.9, 0.9, 0.5, 0.95, 0.2, 0.9, 0.99],
                          device=cuda)
    masked, amax = FS.fused_sample_prep(logits, temps, top_ps, top_k)
    ref, ref_amax = FS.fused_sample_prep_plain(logits, temps, top_ps, top_k)
    assert torch.equal(amax, ref_amax)
    assert torch.equal(torch.isneginf(masked), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    assert torch.equal(masked[fin], ref[fin])


def test_engine_greedy_matches_cpu(cuda):
    from paddle_tpu_torch.inference import PagedServingEngine
    from paddle_tpu_torch.models import llama as L

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = L.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        max_seq_len=128, dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, n).tolist() for n in (5, 40, 17)]

    def run(device):
        eng = PagedServingEngine(cfg, params, block_size=16, max_batch=4,
                                 token_budget=32, device=device)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        done = {c.rid: c.output_tokens for c in eng.run()}
        return [done[r] for r in rids], eng

    PA.KERNEL.launches = FF.KERNEL.launches = FS.KERNEL.launches = 0
    on_card, eng = run(cuda)
    steps = eng.stats["steps"]
    assert PA.KERNEL.launches == FF.KERNEL.launches == 2 * steps
    assert FS.KERNEL.launches == steps
    on_cpu, _ = run("cpu")
    assert on_card == on_cpu


def _close_to_max(got, want, rtol):
    """Within rtol of want's largest entry: the training-agreement rule."""
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=rtol * want.float().abs().max().item())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, _BF16)])
@pytest.mark.parametrize("B,H,KV,T,hd,causal", [
    (1, 2, 2, 40, 16, True),        # one ragged tile
    (2, 4, 2, 130, 64, True),       # GQA, three tiles, ragged
    (1, 4, 1, 77, 128, False),      # one kv head, non-causal
    (1, 2, 2, 64, 8, True),         # smallest head
])
def test_flash_attention_matches_plain(cuda, dtype, tol, B, H, KV, T, hd,
                                       causal):
    g = torch.Generator().manual_seed(T + hd)
    q = torch.randn(B, H, T, hd, generator=g).to(cuda, dtype)
    k, v = (torch.randn(B, KV, T, hd, generator=g).to(cuda, dtype)
            for _ in range(2))
    do = torch.randn(B, H, T, hd, generator=g).to(cuda, dtype)
    scale = hd ** -0.5
    FA.KERNEL_FWD.launches = FA.KERNEL_BWD.launches = 0
    o, lse = FA.flash_attention_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = FA.flash_attention_fwd_plain(q, k, v, causal, scale)
    _close(o, o_ref, tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    for a, b in zip(grads, want):
        _close(a, b, 1e-4 if dtype == torch.float32 else tol)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert FA.KERNEL_FWD.launches == 1 and FA.KERNEL_BWD.launches == 2


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, _BF16)])
@pytest.mark.parametrize("rows,d,f", [(5, 32, 64), (70, 64, 264),
                                      (300, 136, 520)])
def test_fused_ffn_bwd_matches_plain(cuda, dtype, rtol, rows, d, f):
    g = torch.Generator().manual_seed(rows)
    x, do = (torch.randn(rows, d, generator=g).to(cuda, dtype)
             for _ in range(2))
    w1, w3 = ((0.1 * torch.randn(d, f, generator=g)).to(cuda, dtype)
              for _ in range(2))
    w2 = (0.1 * torch.randn(f, d, generator=g)).to(cuda, dtype)
    FF.KERNEL_BWD.launches = 0
    got = FF.fused_ffn_bwd(x, w1, w3, w2, do)
    want = FF.fused_ffn_bwd_plain(x, w1, w3, w2, do)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a, b, rtol)
    assert all(torch.equal(a, b) for a, b in
               zip(got, FF.fused_ffn_bwd(x, w1, w3, w2, do)))
    assert FF.KERNEL_BWD.launches == 2


def test_train_step_matches_cpu(cuda):
    from paddle_tpu_torch.distributed import hybrid as H
    from paddle_tpu_torch.models import llama as L

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = L.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        max_seq_len=128, dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, 256, (2, 40)))
    targets = tokens.roll(-1, dims=1)
    cpu = H.loss_and_grads(params, tokens, targets, cfg)
    on_card = {k: v.to(cuda) if torch.is_tensor(v) else
               {n: t.to(cuda) for n, t in v.items()}
               for k, v in params.items()}
    kernels = (FA.KERNEL_FWD, FA.KERNEL_BWD, FF.KERNEL, FF.KERNEL_BWD)
    for k in kernels:
        k.launches = 0
    runs = [H.loss_and_grads(on_card, tokens.to(cuda), targets.to(cuda), cfg,
                             remat=remat) for remat in (True, False)]
    # remat runs A1 and A3 twice per layer; both runs backpropagate once
    assert [k.launches for k in kernels] == [6, 4, 6, 4]
    for loss, grads in runs:
        torch.testing.assert_close(loss.cpu(), cpu[0], rtol=1e-5, atol=0)
        for a, b in zip(H._flatten(grads)[0], H._flatten(cpu[1])[0]):
            _close_to_max(a.cpu(), b, 1e-4)
    for a, b in zip(H._flatten(runs[0][1])[0], H._flatten(runs[1][1])[0]):
        assert torch.equal(a, b)
