"""Kernel A5's bf16-q design on the card: split positions, the cp.async
ring, the tensor-core products.

Marked `gpu`: without a CUDA device every test skips (decided in a
fixture). On the card each case launches `paged_attention` on bf16 q
over bf16 or int8 pages and holds the live rows to the plain version
elementwise, |got - ref| <= 2^-7 |ref| + 1e-3 rms(ref) (both sides sum
in f32 and round once to bf16: one bf16 ulp, the atol for the sums'
order near 0), the dead rows to exactly 0, a rerun to the same bits, and
the launch to one count on the "mma" path. Cases: contexts one short of
a split span, at it and one past it, and 2,047 / 2,048 of a 2,048 table;
page sizes 4, 16 and 128; every head_dim the gate admits; GQA groups 1,
4 and 8; max_q 1, 20 and 64; contexts around the longer span of 8
int8 rows; a 32,768-position table, whose units outnumber the grid's
blocks. Then the design's invariances, bit for bit:
a sequence alone and at another slot of a batch of 8, and a decode row
in a max_q = 1 launch and in a mixed launch. No jax, no reference:

    python -m pytest tests/test_torch_paged_hopper.py -m gpu --noconftest -q
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import paged_attention as PA
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu

SPAN = PA.paged_splits(1, 128, 16, 128, 1, 1, 2).span


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _pool(dev, nb, KV, bs, hd, int8, g):
    kc = torch.randn(nb, KV, bs, hd, generator=g)
    vc = torch.randn(nb, KV, bs, hd, generator=g)
    if not int8:
        return kc.to(dev, torch.bfloat16), vc.to(dev, torch.bfloat16), {}
    kc, vc = ((40 * t).round().clamp(-127, 127).to(dev, torch.int8)
              for t in (kc, vc))
    return kc, vc, {name: torch.empty(nb, KV).uniform_(
        0.005, 0.05, generator=g).to(dev) for name in ("k_dequant",
                                                       "v_dequant")}


def _case(dev, past, this, G=1, KV=2, hd=128, bs=16, max_q=1, max_len=2048,
          int8=False, seed=0):
    """bf16 q rows and a seeded pool; each sequence's pages at random
    places of the pool, -1 past its length."""
    g = torch.Generator().manual_seed(seed)
    B = len(past)
    mb = -(-max_len // bs)
    pages = [-(-(p + t) // bs) for p, t in zip(past, this)]
    nb = sum(pages) + 3
    q = torch.randn(B, KV, max_q * G, hd, generator=g).to(dev, torch.bfloat16)
    kc, vc, kw = _pool(dev, nb, KV, bs, hd, int8, g)
    perm = torch.randperm(nb, generator=g).tolist()
    tables = torch.full((B, mb), -1, dtype=torch.int32)
    for b in range(B):
        for p in range(pages[b]):
            tables[b, p] = perm.pop()
    lens = [torch.tensor(v, dtype=torch.int32, device=dev)
            for v in (past, this)]
    return (q, kc, vc, tables.to(dev), *lens, G, hd ** -0.5), kw


def _run(args, kw):
    kernel = PA.KERNEL_INT8 if kw else PA.KERNEL
    kernel.reset()
    out = PA.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.paths == {"mma": 1}
    return out


def _check(args, kw):
    """Live rows within the rule, dead rows 0, a bit-identical rerun."""
    out = _run(args, kw)
    ref = PA.paged_attention_plain(*args, **kw)
    q, G, this = args[0], args[6], args[5]
    t = torch.arange(q.shape[2], device=q.device) // G
    live = (t[None, :] < this[:, None])[:, None, :, None].expand_as(out)
    assert not out[~live].any()
    got, want = out[live].float(), ref[live].float()
    atol = 1e-3 * want.square().mean().sqrt().item()
    assert torch.all((got - want).abs() <= 2 ** -7 * want.abs() + atol), \
        f"max err {(got - want).abs().max().item():.3g}"
    assert torch.equal(PA.paged_attention(*args, **kw), out)
    return out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("positions", [SPAN - 1, SPAN, SPAN + 1,
                                       2 * SPAN + 1, 2047, 2048])
def test_contexts_around_the_span(cuda, int8, positions):
    """Decode rows whose live length (past + 1) sits one short of a span
    boundary, on it and one past it; 2,047 and 2,048 fill a 2,048 table.
    The other slots hold shorter rows and an idle one."""
    past = [positions - 1, 63, positions - 2, 0]
    this = [1, 1, 1, 0]
    _check(*_case(cuda, past, this, KV=4, int8=int8))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("bs", [4, 16, 128])
def test_page_sizes(cuda, int8, bs):
    """Decode rows that split, and a chunk of 3 over 1,500 cached tokens
    that one block walks: at block 4 its 376 pages pass the 256 table
    entries a block stages, and the rest are read from the table."""
    _check(*_case(cuda, [700, 5, 1500, 300], [1, 1, 3, 1], bs=bs, max_q=3,
                  int8=int8))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd", list(range(8, 257, 8)))
def test_every_head_dim(cuda, int8, hd):
    """Every head_dim the gate admits (multiples of 8 up to 256), with a
    long row that splits and a chunk of 3 that does not."""
    args, kw = _case(cuda, [600, 9, 40], [1, 3, 0], hd=hd, max_q=3, KV=1,
                     max_len=1024, int8=int8)
    assert PA.supported(1, 1, hd, 16)
    _check(args, kw)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("max_q", [1, 20, 64])
def test_groups_and_rows(cuda, int8, G, max_q):
    """GQA groups 1, 4, 8 and max_q 1, 20, 64: decode rows beside chunks
    (more than 8 live rows, the warps split rows) and pad rows."""
    this = [1, min(max_q, 20), 1, max_q, 0]
    past = [1800, 300, 520, 100, 7]
    _check(*_case(cuda, past, this, G=G, max_q=max_q, int8=int8))


@pytest.mark.parametrize("positions", [-1, 0, 1, 2 ** 10])
def test_group8_int8_pages_around_their_span(cuda, positions):
    """G = 8 rows over int8 pages split at a longer span (their partials
    weigh more against the pages' bytes): live lengths one short of it,
    on it, one past it, and further on, beside a short row."""
    span = PA.paged_splits(8, 128, 16, 128, 1, 1, 1).span
    assert span > SPAN
    args, kw = _case(cuda, [span + positions - 1, 40], [1, 1], G=8, KV=2,
                     int8=True, seed=6)
    _check(args, kw)


@pytest.mark.parametrize("int8", [False, True])
def test_long_table_units_outnumber_the_grid(cuda, int8):
    """max_len 32,768: the grid stays at most four waves of resident
    blocks, so each block loops over many units, most of them skipped
    (short rows, an idle slot) and several live (two long rows split into
    ~120 spans a kv head each)."""
    past = [30000, 260, 32767, 5, 0, 17000, 2047, 1]
    this = [1, 1, 0, 1, 1, 1, 1, 1]
    _check(*_case(cuda, past, this, KV=8, max_len=32768, int8=int8,
                  seed=7))


@pytest.mark.parametrize("int8", [False, True])
def test_batch_invariance(cuda, int8):
    """A sequence alone and the same sequence at slot 5 of a batch of 8
    give the same bits: splits sit at fixed positions and a row's
    partials depend only on its own lengths."""
    args, kw = _case(cuda, [260, 1900, 33, 700, 1200, 1031, 5, 2000],
                     [1, 1, 1, 1, 1, 1, 1, 1], KV=8, int8=int8, seed=3)
    q, kc, vc, tables, past, this, G, scale = args
    batch = _run(args, kw)
    for b in (5, 7, 0):
        one = _run((q[b:b + 1].contiguous(), kc, vc,
                    tables[b:b + 1].contiguous(), past[b:b + 1].contiguous(),
                    this[b:b + 1].contiguous(), G, scale), kw)
        assert torch.equal(one[0], batch[b])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 4])
def test_decode_row_same_in_a_mixed_launch(cuda, int8, G):
    """A decode row's bits do not depend on max_q: the same sequence in
    a max_q = 1 launch and in a max_q = 20 launch beside a chunk."""
    args, kw = _case(cuda, [1500, 300], [1, 1], G=G, max_q=1, KV=4,
                     int8=int8, seed=4)
    q, kc, vc, tables, past, this, _, scale = args
    decode = _run(args, kw)
    qm = torch.zeros(2, 4, 20 * G, q.shape[3], dtype=q.dtype,
                     device=q.device)
    qm[:, :, :G] = q
    qm[1, :, G:] = torch.randn_like(qm[1, :, G:].float()).to(q.dtype)
    this_m = torch.tensor([1, 20], dtype=torch.int32, device=q.device)
    past_m = torch.tensor([1500, 280], dtype=torch.int32, device=q.device)
    mixed = _run((qm, kc, vc, tables, past_m, this_m, G, scale), kw)
    assert torch.equal(mixed[0, :, :G], decode[0, :, :G])


def test_f32_q_takes_the_cuda_core_kernel(cuda):
    args, kw = _case(cuda, [700, 20], [1, 2], max_q=2)
    args = (args[0].float(), args[1].float(), args[2].float(), *args[3:])
    PA.KERNEL.reset()
    out = PA.paged_attention(*args)
    torch.cuda.synchronize()
    assert PA.KERNEL.paths == {"fma": 1}
    torch.testing.assert_close(out, PA.paged_attention_plain(*args),
                               atol=1e-5, rtol=1e-5)
