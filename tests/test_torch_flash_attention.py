"""Port kernels A1 and A2 (flash attention forward and backward) held
against the reference.

The port's plain versions — what its wrappers run for CPU tensors — and
the reference's Pallas kernels in interpret mode get the same numpy
inputs, f32, with grouped-query heads (H = 4, KV = 2) and T = 384, which
the reference cuts into three 128-row tiles. Tolerances: the forward (o
and lse) sums in another order, rtol 1e-5 with atol 1e-6 for values near
0; the backward goes through the port's autograd Function (the FA-2
formulas from lse) against `jax.grad` of the reference with a
non-trivial cotangent, and differences of f32 rounding in p feed three
more products: rtol 1e-4, atol 1e-5. Segment mode (packed sequences)
takes the forward's tolerances. `tile_walk`, the count of the tile pairs
the kernels walk in segment mode, is checked against the varlen path's
packing and, by brute force, for keeping every visible pair; `walk_slots`,
the size of the buffer in which the kernels record their walks, against
the grids' block counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from torch_threads import one_torch_thread

one_torch_thread()


def _inputs(B, H, KV, T, hd, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, T, hd).astype(np.float32)
    k = rs.randn(B, KV, T, hd).astype(np.float32)
    v = rs.randn(B, KV, T, hd).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 2), (2, 2)])
def test_fwd_plain_matches_reference_kernel(causal, H, KV):
    q, k, v = _inputs(1, H, KV, 384, 16, seed=H + KV + int(causal))
    scale = 0.25
    o_ref, lse_ref = JFA._fwd(*(jnp.asarray(a) for a in (q, k, v)), scale,
                              causal, interpret=True)
    o, lse = FA.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-5,
                               atol=1e-6)
    # the reference broadcasts lse over 8 lanes; the port keeps [B, H, T]
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_autograd_matches_reference_grad(causal):
    B, H, KV, T, hd = 2, 4, 2, 384, 16
    q, k, v = _inputs(B, H, KV, T, hd, seed=7 + int(causal))
    # BTHD, the public layout of both packages
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    ct = np.random.RandomState(3).randn(B, T, H, hd).astype(np.float32)

    def ref_loss(q_, k_, v_):
        o = JFA.flash_attention(q_, k_, v_, causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(ct))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad((o * torch.from_numpy(ct)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_segment_mode_plain_matches_reference_kernel(causal):
    """Segment ids (packed sequences) with boundaries off the 64- and
    128-row tiles; the reference's segment mode in interpret mode."""
    B, H, KV, T, hd = 2, 4, 2, 384, 16
    q, k, v = _inputs(B, H, KV, T, hd, seed=21 + int(causal))
    seg = np.stack([np.repeat(np.arange(3), [37, 200, 147]),
                    np.repeat(np.arange(4), [130, 1, 190, 63])]
                   ).astype(np.int32)
    o_ref, lse_ref = JFA._fwd(*(jnp.asarray(a) for a in (q, k, v)), 0.25,
                              causal, True, jnp.asarray(seg),
                              jnp.asarray(seg))
    ts = torch.from_numpy(seg)
    o, lse = FA.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal, 0.25, ts, ts)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               rtol=1e-5, atol=1e-6)
    # the FA-2 backward with the segment mask is autograd's of the forward
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = FA.flash_attention_fwd_plain(tq, tk, tv, causal, 0.25, ts, ts)
    do = torch.from_numpy(np.random.RandomState(2).randn(*o.shape)
                          .astype(np.float32))
    want = torch.autograd.grad(o, (tq, tk, tv), do)
    got = FA.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                       o.detach(), lse.detach(), do, causal,
                                       0.25, ts, ts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_plain_backward_is_the_fa2_form_of_autograd():
    """The plain backward (formulas from lse) equals autograd through the
    plain forward, on a ragged length and a single kv head."""
    q, k, v = _inputs(1, 3, 1, 45, 8, seed=11)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = FA.flash_attention_fwd_plain(tq, tk, tv, True, 0.3)
    do = torch.from_numpy(np.random.RandomState(5).randn(*o.shape)
                          .astype(np.float32))
    want = torch.autograd.grad(o, (tq, tk, tv), do)
    got = FA.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                       o.detach(), lse.detach(), do, True, 0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_supported_and_rejections():
    assert FA.supported(32, 32, 128) and FA.supported(32, 8, 128)
    assert FA.supported(4, 2, 8)
    assert not FA.supported(32, 5, 128)       # groups must be whole
    assert not FA.supported(32, 32, 136)      # past the 128-wide tiles
    assert not FA.supported(32, 32, 12)       # 16-byte loads
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="both"):      # ids come in pairs
        FA.flash_attention(q, q, q, q_segment_ids=torch.zeros(1, 8))


@pytest.mark.parametrize("q_tile,kv_tile,walked,triangle", [
    (64, 64, 620, 2080), (128, 64, 350, 1056), (128, 128, 175, 528)])
def test_tile_walk_skips_at_the_varlen_lengths(q_tile, kv_tile, walked,
                                               triangle):
    """The varlen path's packing, [700, 1100, 1300, 996]: segment mode
    walks only the tile pairs whose ids overlap; without segments the
    whole causal triangle."""
    seg = np.repeat(np.arange(4), [700, 1100, 1300, 996])
    pairs, total = FA.tile_walk(4096, q_seg=seg, kv_seg=seg, q_tile=q_tile,
                                kv_tile=kv_tile)
    assert (len(pairs), total) == (walked, triangle)
    pairs, total = FA.tile_walk(4096, q_tile=q_tile, kv_tile=kv_tile)
    assert len(pairs) == total == triangle


def _needed_tiles(seg, causal, q_tile, kv_tile):
    """The tile pairs that hold a visible (row, key) pair, brute force."""
    T = len(seg)
    vis = seg[:, None] == seg[None, :]
    if causal:
        vis &= np.tri(T, dtype=bool)
    rows, cols = np.nonzero(vis)
    return set(zip((rows // q_tile).tolist(), (cols // kv_tile).tolist()))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["sorted", "permuted", "blocks_unsorted"])
def test_tile_skip_keeps_every_visible_pair(kind, causal):
    """For any ids the walked pairs hold every visible pair; for sorted
    consecutive ids (a packing) they are exactly the pairs that hold
    one."""
    rs = np.random.RandomState(4)
    sorted_ids = np.repeat(np.arange(5), [37, 100, 64, 1, 98])
    seg = {"sorted": sorted_ids,
           "permuted": rs.permutation(sorted_ids),
           "blocks_unsorted": np.concatenate([rs.randint(2, 4, 128),
                                              rs.randint(0, 2, 130)])}[kind]
    for q_tile, kv_tile in ((64, 64), (128, 64)):
        walked, triangle = FA.tile_walk(len(seg), causal=causal, q_seg=seg,
                                        kv_seg=seg, q_tile=q_tile,
                                        kv_tile=kv_tile)
        needed = _needed_tiles(seg, causal, q_tile, kv_tile)
        assert needed <= set(walked) and len(walked) <= triangle
        if kind == "sorted":
            assert set(walked) == needed


def test_walk_slots_and_no_walk_count_on_the_cpu():
    """A `walked` buffer takes one slot a block: the forward's (batch,
    head, q tile) blocks, the backward's dq blocks and then its (batch,
    kv head, kv tile) dk/dv blocks. The plain versions walk no tiles and
    refuse one."""
    assert FA.walk_slots(2, 32, 8, 2048) == (2048, 2048 + 512)
    assert FA.walk_slots(1, 4, 2, 130, 200) == (12, 20)
    q = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8)
    walked = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="walks no tiles"):
        FA.flash_attention_fwd(q, q, q, True, 0.25, walked=walked)
    with pytest.raises(ValueError, match="walks no tiles"):
        FA.flash_attention_bwd(q, q, q, q, lse, q, True, 0.25, walked=walked)
