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
attention keeps 2e-2 for bf16; its int8-page mode, the int8-weight FFN,
the GEMM epilogue (A8), the GLU (A9) and flash attention's segment-id
mode take the rules above. The sampler does the same division
as its plain version: argmax and kept values match exactly, at
vocabularies up to 1,048,583 (streamed), and so does the -inf pattern
but where an entry's exclusive prefix mass lies within 1e-4 of top_p
(the kernel sums masses exactly, the plain version in f32); on crafted
edge rows all of it exactly; a rerun, and a row alone against the same
row at slot 5 of 8, bit for bit. The
training step on the card (kernels) and on the CPU (plain versions), f32
with TF32 off: losses rtol 1e-5, gradients 1e-4 of each leaf's largest
entry. The quantized engine (w8 weights, int8 pages) on the card and on
the CPU: identical greedy tokens, and int8 page entries at most one
step apart.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from paddle_tpu_torch.ops.cuda import fused_sample as FS
from paddle_tpu_torch.ops.cuda import paged_attention as PA
from torch_threads import one_torch_thread

one_torch_thread()

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


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("B,V,top_k", [
    (2, 1, 0), (2, 1, 50), (8, 97, 0), (8, 32000, 0), (8, 32000, 50),
    (8, 128256, 0), (8, 128256, 50), (8, 152064, 0), (8, 152064, 50),
    (1, 32000, 0), (1, 32000, 50), (1, 1048583, 0), (1, 1048583, 50)])
def test_fused_sample_prep_matches_plain(cuda, B, V, top_k):
    import chip_smoke

    rs = np.random.RandomState(V + top_k)
    logits = torch.from_numpy((3 * rs.randn(B, V)).astype(np.float32)).to(cuda)
    temps = torch.tensor([1.0, 0.8, 1e-9, 1.3, 0.8, 1.0, 0.5, 2.0][:B],
                         device=cuda)
    top_ps = torch.tensor([1.0, 0.9, 0.9, 0.5, 0.95, 0.2, 0.9, 0.99][:B],
                          device=cuda)
    masked, amax = FS.fused_sample_prep(logits, temps, top_ps, top_k)
    ref, ref_amax = FS.fused_sample_prep_plain(logits, temps, top_ps, top_k)
    assert torch.equal(amax, ref_amax)
    # the kernel sums the masses exactly (fixed point), the plain version
    # in f32: the -inf pattern may differ only where an entry's exclusive
    # prefix mass lies within 1e-4 of top_p (chip_smoke's boundary rule)
    chip_smoke.sample_boundary(torch, f"B={B} V={V} top_k={top_k}", masked,
                               ref, logits, temps, top_ps, top_k)
    fin = torch.isfinite(ref) & torch.isfinite(masked)
    assert torch.equal(masked[fin], ref[fin])
    again, again_amax = FS.fused_sample_prep(logits, temps, top_ps, top_k)
    assert torch.equal(_bits(again), _bits(masked))
    assert torch.equal(again_amax, amax)
    if B == 8:            # row 5 alone: the same bits as at slot 5 of 8
        alone, alone_amax = FS.fused_sample_prep(
            logits[5:6].contiguous(), temps[5:6].contiguous(),
            top_ps[5:6].contiguous(), top_k)
        assert torch.equal(_bits(alone[0]), _bits(masked[5]))
        assert int(alone_amax[0]) == int(amax[5])
    # phase stamps change nothing: start, load, argmax, 4 a digit, write
    stamps = torch.zeros(64, dtype=torch.int64, device=cuda)
    stamped, _ = FS.fused_sample_prep(logits, temps, top_ps, top_k,
                                      stamps=stamps)
    assert torch.equal(_bits(stamped), _bits(masked))
    digits = 3 * (1 + (0 < top_k < V))
    assert int((stamps.view(32, 2)[:, 1] > 0).sum()) == 4 + 4 * digits


@pytest.mark.parametrize("share", [2048, 8192])
def test_fused_sample_prep_bits_do_not_depend_on_the_cluster(cuda, share,
                                                           monkeypatch):
    # masses are summed exactly, so 16 or 4 blocks a row give the bits
    # of the plan's 8
    rs = np.random.RandomState(3)
    logits = torch.from_numpy((3 * rs.randn(2, 32000)).astype(np.float32)
                              ).to(cuda)
    temps = torch.tensor([1.0, 0.7], device=cuda)
    top_ps = torch.tensor([0.9, 1.0], device=cuda)
    for top_k in (0, 50):
        want, want_amax = FS.fused_sample_prep(logits, temps, top_ps, top_k)
        FS.sample_plan.cache_clear()
        monkeypatch.setattr(FS, "_BLOCK_SHARE", share)
        try:
            assert FS.sample_plan(32000).cluster == -(-32000 // share)
            got, got_amax = FS.fused_sample_prep(logits, temps, top_ps,
                                                 top_k)
        finally:
            monkeypatch.undo()
            FS.sample_plan.cache_clear()
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(got_amax, want_amax)


def test_fused_sample_prep_replays_in_a_cuda_graph(cuda):
    # no host sync, no allocation in the kernel, nothing read back: a
    # captured launch replays on new logits as a direct launch computes
    rs = np.random.RandomState(4)
    logits = torch.from_numpy((3 * rs.randn(8, 32000)).astype(np.float32)
                              ).to(cuda)
    temps = torch.full((8,), 0.8, device=cuda)
    top_ps = torch.full((8,), 0.9, device=cuda)
    FS.fused_sample_prep(logits, temps, top_ps, 50)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        FS.fused_sample_prep(logits, temps, top_ps, 50)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        masked, amax = FS.fused_sample_prep(logits, temps, top_ps, 50)
    logits.copy_(torch.from_numpy(
        (3 * rs.randn(8, 32000)).astype(np.float32)))
    graph.replay()
    want, want_amax = FS.fused_sample_prep(logits, temps, top_ps, 50)
    torch.cuda.synchronize()
    assert torch.equal(_bits(masked), _bits(want))
    assert torch.equal(amax, want_amax)


def test_fused_sample_prep_edge_rows_match_plain(cuda):
    import chip_smoke

    for name, lg, tp, pp, top_k in chip_smoke.sample_edge_cases(np):
        logits, temps, top_ps = (torch.from_numpy(a).to(cuda)
                                 for a in (lg, tp, pp))
        masked, amax = FS.fused_sample_prep(logits, temps, top_ps, top_k)
        ref, ref_amax = FS.fused_sample_prep_plain(logits, temps, top_ps,
                                                   top_k)
        assert torch.equal(amax, ref_amax), name
        assert torch.equal(torch.isneginf(masked), torch.isneginf(ref)), name
        fin = torch.isfinite(ref)
        assert torch.equal(_bits(masked[fin]), _bits(ref[fin])), name
        again, _ = FS.fused_sample_prep(logits, temps, top_ps, top_k)
        assert torch.equal(_bits(again), _bits(masked)), name
        if top_k == logits.shape[1]:      # top_k past V masks no more
            past, _ = FS.fused_sample_prep(logits, temps, top_ps, top_k + 5)
            assert torch.equal(_bits(past), _bits(masked)), name


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dots_and_eval_steps_on_card(cuda, dtype):
    """remat="dots" on the card: A1 and A3 launch once a layer a step
    (twice under remat=True), A2 and A4 once under both; the two
    policies give the same losses and parameters bit for bit; the eval
    step (A1 and A3 once a layer) gives the loss the next train step
    reports, bit for bit."""
    from paddle_tpu_torch.distributed import hybrid as H
    from paddle_tpu_torch.models import llama as L

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = L.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        max_seq_len=128, dtype=dtype)
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, 256, (2, 40))).to(cuda)
    targets = tokens.roll(-1, dims=1)
    kernels = (FA.KERNEL_FWD, FA.KERNEL_BWD, FF.KERNEL, FF.KERNEL_BWD)
    runs = {}
    for remat in ("dots", True):
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = L.init_params(cfg, gen, device=cuda)
        opt = H.init_opt_state(params)
        step = H.make_train_step(cfg, device=cuda, remat=remat,
                                 hp=H.AdamWConfig(lr=1e-3))
        evaluate = H.make_eval_step(cfg, device=cuda)
        for k in kernels:
            k.reset()
        losses = []
        for _ in range(2):
            before = evaluate(params, tokens, targets)
            params, opt, loss = step(params, opt, tokens, targets)
            assert torch.equal(before, loss)
            losses.append(loss)
        runs[remat] = (losses, params, [k.launches for k in kernels])
    (l_dots, p_dots, n_dots), (l_full, p_full, n_full) = runs.values()
    # 2 layers, 2 steps, 2 eval calls: A1 and A3 4 in the evals, then 4
    # ("dots") or 8 (True) in the steps
    assert n_dots == [8, 4, 8, 4] and n_full == [12, 4, 12, 4]
    assert all(torch.equal(a, b) for a, b in zip(l_dots, l_full))
    for a, b in zip(H._flatten(p_dots)[0], H._flatten(p_full)[0]):
        assert torch.equal(a, b)
    assert float(l_dots[1]) < float(l_dots[0])


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, _BF16)])
@pytest.mark.parametrize("rows,d,f", [(1, 64, 128), (8, 256, 1024),
                                      (40, 128, 272), (300, 96, 528)])
def test_fused_ffn_w8_matches_plain(cuda, dtype, rtol, rows, d, f):
    from paddle_tpu_torch.inference.quant import quantize_weight

    g = torch.Generator().manual_seed(rows + 1)
    x = torch.randn(rows, d, generator=g).to(cuda, dtype)
    leaves = {}
    for n, shape in (("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d))):
        q, s = quantize_weight(0.1 * torch.randn(*shape, generator=g), 0)
        leaves[n + "_q"], leaves[n + "_s"] = q.to(cuda), s.to(cuda)
    args = [leaves[k] for k in ("w1_q", "w1_s", "w3_q", "w3_s", "w2_q",
                                "w2_s")]
    FF.KERNEL_W8.launches = 0
    out = FF.fused_ffn_w8(x, *args)
    assert FF.KERNEL_W8.launches == 1 and out.dtype == dtype
    _close(out, FF.fused_ffn_w8_plain(x, *args), rtol)
    assert torch.equal(FF.fused_ffn_w8(x, *args), out)    # deterministic


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, _BF16)])
@pytest.mark.parametrize("G,max_q,past,this,hd,bs", [
    (1, 1, [63, 2047, 700, 0], [1, 1, 1, 0], 128, 16),   # decode, idle slot
    (4, 1, [5, 300, 17, 1], [1, 1, 1, 1], 128, 16),      # GQA decode
    (1, 20, [0, 33, 64, 5], [20, 1, 7, 0], 128, 16),     # mixed, pad rows
    (2, 2, [3, 17, 0], [2, 1, 1], 8, 4),                 # tiny head, page
])
def test_paged_attention_int8_matches_plain(cuda, dtype, rtol, G, max_q,
                                            past, this, hd, bs):
    q, kc, vc, tables, past_t, this_t = _paged_case(
        cuda, torch.float32, len(past), 2, G, hd, bs, past, this, max_q)
    q = q.to(dtype)
    kc, vc = ((40 * t).round().clamp(-127, 127).to(torch.int8)
              for t in (kc, vc))
    g = torch.Generator().manual_seed(len(past) + hd)
    kdq, vdq = (torch.empty(kc.shape[0], 2).uniform_(0.005, 0.05,
                                                     generator=g).to(cuda)
                for _ in range(2))
    PA.KERNEL_INT8.launches = PA.KERNEL.launches = 0
    args = (q, kc, vc, tables, past_t, this_t, G, hd ** -0.5)
    out = PA.paged_attention(*args, k_dequant=kdq, v_dequant=vdq)
    torch.cuda.synchronize()
    assert PA.KERNEL_INT8.launches == 1 and PA.KERNEL.launches == 0
    _close(out, PA.paged_attention_plain(*args, k_dequant=kdq,
                                         v_dequant=vdq), rtol)
    for b, n in enumerate(this):
        assert torch.all(out[b, :, n * G:] == 0)


def test_quant_engine_greedy_matches_cpu(cuda):
    from paddle_tpu_torch.inference import PagedServingEngine
    from paddle_tpu_torch.inference import quant as Q
    from paddle_tpu_torch.models import llama as L

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = L.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        max_seq_len=128, dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rs = np.random.RandomState(0)
    manifest = Q.calibrate(cfg, params, [rs.randint(0, 256, (2, 32))])
    prompts = [rs.randint(0, 256, n).tolist() for n in (5, 40, 17)]

    def run(device):
        eng = PagedServingEngine(cfg, params, block_size=16, max_batch=4,
                                 token_budget=32, quant_mode="w8",
                                 quant_kv=True, quant_manifest=manifest,
                                 device=device)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        done = {c.rid: c.output_tokens for c in eng.run()}
        return [done[r] for r in rids], eng

    kernels = (PA.KERNEL_INT8, FF.KERNEL_W8, FS.KERNEL, PA.KERNEL, FF.KERNEL)
    for k in kernels:
        k.launches = 0
    on_card, eng = run(cuda)
    steps = eng.stats["steps"]
    assert [k.launches for k in kernels] == [2 * steps, 2 * steps, steps,
                                             0, 0]
    on_cpu, eng_cpu = run("cpu")
    assert on_card == on_cpu
    for a, b in ((eng._key_cache, eng_cpu._key_cache),
                 (eng._value_cache, eng_cpu._value_cache)):
        assert (a.cpu().int() - b.int()).abs().max().item() <= 1


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, _BF16)])
@pytest.mark.parametrize("m,k,n,act,bias", [
    (100, 72, 40, "silu", True),        # the odd shape of chip_smoke
    (1, 8, 8, "none", False),           # one row
    (130, 257, 136, "gelu", True),      # ragged k and tiles
    (37, 21, 19, "relu", True),         # rows not 16-byte aligned
    (256, 512, 384, "sigmoid", False),  # whole tiles
])
def test_gemm_epilogue_matches_plain(cuda, dtype, rtol, m, k, n, act, bias):
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g).to(cuda, dtype)
    y = (torch.randn(k, n, generator=g) / k ** 0.5).to(cuda, dtype)
    b = torch.randn(n, generator=g).to(cuda, dtype) if bias else None
    FF.KERNEL_EPILOGUE.launches = 0
    out = FF.fused_gemm_epilogue(x, y, b, act)
    assert FF.KERNEL_EPILOGUE.launches == 1 and out.dtype == dtype
    _close(out, FF.fused_gemm_epilogue_plain(x, y, b, act), rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, _BF16)])
@pytest.mark.parametrize("rows,f,act", [(8, 11008, "silu"), (33, 40, "gelu"),
                                        (5, 13, "silu"), (1, 8, "sigmoid")])
def test_fused_glu_matches_plain(cuda, dtype, rtol, rows, f, act):
    g = torch.Generator().manual_seed(rows + f)
    x = torch.randn(rows, 2 * f, generator=g).to(cuda, dtype)
    u, v = x[:, :f], x[:, f:]                   # strided halves
    FF.KERNEL_GLU.launches = 0
    out = FF.fused_glu(u, v, act)
    assert FF.KERNEL_GLU.launches == 1 and out.dtype == dtype
    _close(out, FF.fused_glu_plain(u, v, act), rtol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, _BF16)])
@pytest.mark.parametrize("lens,H,KV,causal", [
    ([37, 100, 19, 100], 4, 2, True),   # boundaries off the 64-row tiles
    ([200, 56], 2, 2, False),
    ([1, 130, 5], 4, 1, True),          # a one-token sequence
])
def test_flash_attention_segments_match_plain(cuda, dtype, tol, lens, H, KV,
                                              causal):
    T, hd = sum(lens), 64
    g = torch.Generator().manual_seed(T + H)
    q = torch.randn(1, H, T, hd, generator=g).to(cuda, dtype)
    k, v = (torch.randn(1, KV, T, hd, generator=g).to(cuda, dtype)
            for _ in range(2))
    do = torch.randn(1, H, T, hd, generator=g).to(cuda, dtype)
    seg = torch.repeat_interleave(torch.arange(len(lens)),
                                  torch.tensor(lens))[None]
    seg = seg.to(cuda, torch.int32)
    scale = hd ** -0.5
    o, lse = FA.flash_attention_fwd(q, k, v, causal, scale, seg, seg)
    o_ref, lse_ref = FA.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                  seg, seg)
    _close(o, o_ref, tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, causal, scale, seg,
                                   seg)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                        seg, seg)
    for a, b in zip(grads, want):
        _close(a, b, 1e-4 if dtype == torch.float32 else tol)
