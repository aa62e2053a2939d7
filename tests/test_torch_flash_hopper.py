"""Flash attention's tensor-core kernels (A1 forward, A2 backward) held
against their plain versions, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture, never at import). The bf16 kernels run on the tensor cores from
TMA-filled, swizzled tiles; these cases walk the corners of that design:
head dims that are zero-padded to the product depth (8, 24, 96) beside
64 and 128, lengths ragged against the 64-row tiles, non-causal attention
with S != T, grouped-query heads, and segment ids that are not sorted,
so that a wrong tile skip or a wrong mask shows. f32 takes the
CUDA-core kernels, which skip tiles by the same test. Every case reruns
both kernels and requires bit-identical outputs, and reads the tile
pairs each kernel's blocks walked off the card: they must equal
`tile_walk`'s count. This file imports
neither jax nor the reference, so it runs on a machine without them:

    python -m pytest tests/test_torch_flash_hopper.py -m gpu --noconftest -q

Tolerances, elementwise (`_close`, as in `tests/test_torch_cuda.py`):
|got - want| <= rtol |want| + atol. bf16 outputs round once to bf16 on
both sides after f32 sums: rtol 2^-7 (one bf16 ulp of |want|), atol 1e-3
x the RMS of want. f32: rtol 1e-5 for the forward, 1e-4 for the
gradients, atol rtol x the RMS of want. lse (f32 on both sides): rtol
1e-5, atol 1e-5. Where every row sees a single key (T = 1 causal, or S =
1), dq and dk are 0 in exact arithmetic and both sides hold only the
rounding of dp - delta: those two take the atol of dv, the case's
nonzero gradient, instead of their own RMS.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as FA
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


def _check(dev, B, H, KV, T, hd, causal, S=None, seg=None, kv_seg=None,
           dtype=torch.bfloat16, seed=0):
    """Both kernels against the plain versions, launch counts, and
    bit-identical reruns. seg: int ids [B, T], for the keys too unless
    kv_seg [B, S] is given."""
    S = T if S is None else S
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, T, hd, generator=g).to(dev, dtype)
    k, v = (torch.randn(B, KV, S, hd, generator=g).to(dev, dtype)
            for _ in range(2))
    do = torch.randn(B, H, T, hd, generator=g).to(dev, dtype)
    segs = () if seg is None else tuple(
        torch.as_tensor(np.asarray(ids), dtype=torch.int32).to(dev)
        for ids in (seg, seg if kv_seg is None else kv_seg))
    scale = hd ** -0.5
    tol = _BF16 if dtype == torch.bfloat16 else 1e-5
    FA.KERNEL_FWD.launches = FA.KERNEL_BWD.launches = 0
    o, lse = FA.flash_attention_fwd(q, k, v, causal, scale, *segs)
    o_ref, lse_ref = FA.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                  *segs)
    _close(o, o_ref, tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    bargs = (q, k, v, o, lse, do, causal, scale, *segs)
    grads = FA.flash_attention_bwd(*bargs)
    want = FA.flash_attention_bwd_plain(*bargs)
    gtol = tol if dtype == torch.bfloat16 else 1e-4
    if S == 1 or (causal and T == 1):
        # every row sees one key: p = 1 and dp = delta, so dq and dk are
        # 0 in exact arithmetic and both sides return the rounding of dp -
        # delta; those two take dv's atol, the scale of this case's
        # gradients
        _close(grads[2], want[2], gtol)
        rms = want[2].float().square().mean().sqrt().item()
        atol = (1e-3 if gtol == _BF16 else gtol) * rms
        for a, b in zip(grads[:2], want[:2]):
            torch.testing.assert_close(a.float(), b.float(), rtol=gtol,
                                       atol=atol)
    else:
        for a, b in zip(grads, want):
            _close(a, b, gtol)
    o2, lse2 = FA.flash_attention_fwd(q, k, v, causal, scale, *segs)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    again = FA.flash_attention_bwd(*bargs)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert FA.KERNEL_FWD.launches == 2 and FA.KERNEL_BWD.launches == 2
    _check_walk(dev, q, k, v, causal, scale, segs, bargs)


def _check_walk(dev, q, k, v, causal, scale, segs, bargs):
    """The tile pairs the kernels' blocks record walking, read off the
    card: every block writes its slot, and the forward, dq and dk/dv
    each walk exactly `tile_walk`'s pairs, summed over batch rows and
    heads (with unsorted ids too: a tile the test keeps is never
    dropped, one it skips is never walked)."""
    B, H, T, _ = q.shape
    KV, S = k.shape[1], k.shape[2]
    rows = ([(None, None)] * B if not segs
            else list(zip(segs[0].cpu(), segs[1].cpu())))
    model = H * sum(len(FA.tile_walk(T, S, causal, qs, ks)[0])
                    for qs, ks in rows)
    n_fwd, n_bwd = FA.walk_slots(B, H, KV, T, S)
    walked_fwd, walked_bwd = (torch.full((n,), -1, dtype=torch.int32,
                                         device=dev) for n in (n_fwd, n_bwd))
    FA.flash_attention_fwd(q, k, v, causal, scale, *segs, walked=walked_fwd)
    FA.flash_attention_bwd(*bargs, walked=walked_bwd)
    assert int(walked_fwd.min()) >= 0 and int(walked_bwd.min()) >= 0
    assert (int(walked_fwd.sum()), int(walked_bwd[:n_fwd].sum()),
            int(walked_bwd[n_fwd:].sum())) == (model, model, model)


@pytest.mark.parametrize("hd", [8, 24, 64, 96, 128])
def test_head_dims_padded_to_product_depth(cuda, hd):
    _check(cuda, B=2, H=4, KV=2, T=130, hd=hd, causal=True, seed=hd)


@pytest.mark.parametrize("T", [1, 63, 65, 130, 200])
def test_lengths_ragged_against_tiles(cuda, T):
    _check(cuda, B=1, H=2, KV=2, T=T, hd=128, causal=True, seed=T)


@pytest.mark.parametrize("T,S,hd", [(77, 200, 128), (130, 64, 64),
                                    (1, 65, 128), (200, 1, 24)])
def test_non_causal_with_s_unequal_t(cuda, T, S, hd):
    _check(cuda, B=2, H=2, KV=1, T=T, S=S, hd=hd, causal=False, seed=T + S)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_four_q_heads_a_kv_head(cuda, causal):
    _check(cuda, B=1, H=8, KV=2, T=200, hd=128, causal=causal,
           seed=8 + int(causal))


def _ids(kind):
    """One batch row of segment ids [T] of the named kind."""
    rs = np.random.RandomState(17)
    if kind == "interleaved":          # every tile holds every id
        return np.arange(300) % 3
    if kind == "permuted":             # a packing, positions shuffled
        return rs.permutation(np.repeat(np.arange(4), [50, 90, 20, 140]))
    if kind == "blocks_unsorted":      # ids 2, 3 before 0, 1, then 0, 1 again
        return np.concatenate([rs.randint(2, 4, 128), rs.randint(0, 2, 128),
                               rs.randint(0, 2, 70)])
    if kind == "boundaries":           # on and off 64 and 128, one token
        return np.repeat(np.arange(5), [64, 64, 128, 1, 63])
    if kind == "late_prefix":          # q tile 2's rows of segment 1 see
        return np.repeat(np.arange(2), [130, 70])   # none of tiles 0 and 1
    if kind == "one_token_first":
        return np.repeat(np.arange(3), [1, 130, 5])
    raise ValueError(kind)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["interleaved", "permuted", "blocks_unsorted",
                                  "boundaries", "late_prefix",
                                  "one_token_first"])
def test_segment_ids_unsorted_and_ragged(cuda, kind, dtype):
    ids = _ids(kind)
    seg = np.stack([ids, ids[::-1].copy()])      # two batch rows differ
    _check(cuda, B=2, H=4, KV=2, T=len(ids), hd=64, causal=True, seg=seg,
           dtype=dtype, seed=len(ids))


@pytest.mark.parametrize("kind", ["permuted", "blocks_unsorted"])
def test_segment_ids_non_causal_gqa(cuda, kind):
    ids = _ids(kind)
    _check(cuda, B=1, H=8, KV=2, T=len(ids), hd=128, causal=False,
           seg=ids[None], seed=3)


def test_segment_ids_non_causal_s_unequal_t(cuda):
    """q and kv packings of different lengths (S != T): every q segment
    has keys, in other tiles than its rows."""
    q_ids = np.repeat(np.arange(3), [40, 50, 40])
    kv_ids = np.repeat(np.arange(3), [70, 30, 100])
    _check(cuda, B=1, H=4, KV=2, T=130, S=200, hd=128, causal=False,
           seg=q_ids[None], kv_seg=kv_ids[None], seed=5)
