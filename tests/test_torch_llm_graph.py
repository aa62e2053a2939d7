"""CUDA-graph capture of the predictor's decode chunks and of the paged
engine's decode tick, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture). The file imports neither jax nor the reference:

    python -m pytest tests/test_torch_llm_graph.py --noconftest -q

- The predictor's replayed chunks of 32, 8 and 1 steps give the tokens
  and the final logits of the same steps run eagerly, bit for bit, in
  f32 and bf16, fp and w8 weights.
- Two sampled `generate` calls with one seed give the same tokens; a
  `top_p = 0` row gives token 0.
- The engine's captured decode tick gives the eager tick's logits, bit
  for bit, with fewer live sequences than `max_batch` (the page writes
  padded by repeating the first), and the pages it writes equal the
  eager tick's.
- Launch counts after replays equal the capture's delta times the
  replays, and the delta is what the code implies.
- The predictor holds one batch size's cache and graphs: a generate at
  another B frees them, and its memory does not grow across batch sizes.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import LLMPredictor, PagedServingEngine
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops import cuda as C
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu

# head_dim 64, GQA G = 2, widths the kernels' 16-byte rules admit
DIMS = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: capture replays the port's kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(dtype, dev="cpu", seed=0):
    cfg = L.LlamaConfig(**DIMS, dtype=dtype)
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev, dtype=dtype)
    return cfg, params


def _reset():
    for k in C.KERNELS:
        k.reset()


@pytest.mark.parametrize("dtype,quant", [(torch.float32, ""),
                                         (torch.bfloat16, ""),
                                         (torch.bfloat16, "w8")])
def test_predictor_replayed_chunks_equal_eager_steps(cuda, dtype, quant):
    cfg, params = _model(dtype, cuda)
    pred = LLMPredictor(cfg, params, max_len=96, quant_mode=quant,
                        device=cuda)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (3, 20))
    args = (prompt, 41, None, False, None, 0, None, 0)   # chunks 32, 8, 1
    eager = pred._generate(*args, capture=False)
    eager_logits = pred._slots[3].last_logits.clone()
    graph = pred._generate(*args, capture=True)
    assert sorted(pred._slots[3].graphs) == [(1, False, 0, False),
                                             (8, False, 0, False),
                                             (32, False, 0, False)]
    assert graph.dtype == torch.int32 and graph.shape == (3, 61)
    assert torch.equal(graph, eager)
    assert torch.equal(pred._slots[3].last_logits, eager_logits)
    assert torch.equal(pred.generate(prompt, max_new_tokens=41), eager)


def test_predictor_sampled_replays_repeat_per_seed(cuda):
    cfg, params = _model(torch.bfloat16, cuda)
    pred = LLMPredictor(cfg, params, max_len=96, device=cuda)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (4, 16))
    kw = dict(max_new_tokens=40, temperature=0.8, top_k=20, top_p=0.9)
    first = pred.generate(prompt, seed=3, **kw)
    assert torch.equal(pred.generate(prompt, seed=3, **kw), first)
    assert not torch.equal(pred.generate(prompt, seed=4, **kw), first)
    zeros = pred.generate(prompt, max_new_tokens=9, temperature=1.0,
                          top_p=0.0)
    assert (zeros[:, 16:] == 0).all()


def test_predictor_replay_counts_launches(cuda):
    cfg, params = _model(torch.bfloat16, cuda)
    pred = LLMPredictor(cfg, params, max_len=96, device=cuda)
    prompt = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 24))
    pred.generate(prompt, max_new_tokens=32)        # captures the 32-chunk
    graph = pred._slots[2].graphs[(32, False, 0, False)]
    assert graph.delta == {"fused_ffn": (32 * cfg.num_layers, {})}
    _reset()
    pred.generate(prompt, max_new_tokens=64)
    # prefill: A1 and A3 once a layer; decode: A3 once a layer a step
    assert C.flash_attention.KERNEL_FWD.launches == cfg.num_layers
    assert C.fused_ffn.KERNEL.launches == cfg.num_layers * (1 + 64)
    assert sum(k.launches for k in C.KERNELS) == cfg.num_layers * 66


def test_predictor_holds_one_batch_size_on_card(cuda):
    """A generate at another B frees the last B's cache and graphs: back
    at the first B, the predictor holds no more memory than it did."""
    cfg, params = _model(torch.bfloat16, cuda)
    pred = LLMPredictor(cfg, params, max_len=96, device=cuda)
    rs = np.random.RandomState(5)
    held = []
    for B in (2, 3, 2):
        prompt = rs.randint(0, cfg.vocab_size, (B, 16))
        got = pred.generate(prompt, max_new_tokens=9)        # chunks 8, 1
        assert list(pred._slots) == [B]
        assert sorted(pred._slots[B].graphs) == [(1, False, 0, False),
                                                 (8, False, 0, False)]
        assert torch.equal(got, pred._generate(
            prompt, 9, None, False, None, 0, None, 0, capture=False))
        del got
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[2] <= held[0]


def _engine_with_graph(dev, quant):
    cfg, params = _model(torch.bfloat16, dev)
    kw = {}
    if quant:
        from paddle_tpu_torch.inference import quant as Q
        rs = np.random.RandomState(3)
        kw = dict(quant_mode="w8", quant_kv=True, quant_manifest=Q.calibrate(
            cfg, params, [rs.randint(0, cfg.vocab_size, (2, 32))]))
    eng = PagedServingEngine(cfg, params, block_size=16, max_batch=4,
                             token_budget=32, max_len=96, device=dev, **kw)
    rs = np.random.RandomState(4)
    for n in (9, 30, 17):                           # 3 live of max_batch 4
        eng.submit(rs.randint(0, cfg.vocab_size, n).tolist(),
                   max_new_tokens=12)
    while eng._dec_graph is None or eng.stats["decode_fast_steps"] < 3:
        eng.step()
    return cfg, eng


@pytest.mark.parametrize("quant", [False, True])
def test_engine_captured_tick_equals_eager_tick(cuda, quant):
    cfg, eng = _engine_with_graph(cuda, quant)
    assert len(eng.scheduler.running) == 3 < eng.max_batch
    eng.step()                                      # a replayed decode tick
    pages = [t.clone() for t in (eng._key_cache, eng._value_cache)]
    replayed = [t.clone() for t in eng._dec_graph.outputs]
    eager = eng._decode_tick()                      # the same static inputs
    for a, b in zip(eager, replayed):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in
               zip(pages, (eng._key_cache, eng._value_cache)))
    _reset()
    for _ in range(5):
        eng._dec_graph.replay()
    ffn, attn = (("fused_ffn_w8", "paged_attention_int8") if quant
                 else ("fused_ffn", "paged_attention"))
    want = {ffn: 5 * cfg.num_layers, attn: 5 * cfg.num_layers,
            "fused_sample": 5}
    assert {k.name: k.launches for k in C.KERNELS if k.launches} == want
    assert {n: d[0] for n, d in eng._dec_graph.delta.items()} == {
        n: c // 5 for n, c in want.items()}
    eng.run()


def test_engine_top_p_zero_row_beside_greedy_on_card(cuda):
    cfg, params = _model(torch.float32)             # on the CPU, moved
    streams = {}
    for where in ("cpu", cuda):
        eng = PagedServingEngine(cfg, params, block_size=16, max_batch=4,
                                 token_budget=32, max_len=96, device=where)
        greedy = eng.submit([5, 6, 7, 8, 9], max_new_tokens=6)
        zero = eng.submit([1, 2, 3, 4], max_new_tokens=6, temperature=1.0,
                          top_p=0.0, seed=1)
        done = {c.rid: (c.output_tokens, c.finish_reason) for c in eng.run()}
        streams[str(where)] = (done[greedy], done[zero])
    assert streams[str(cuda)][1] == ([0] * 6, "length")
    assert streams[str(cuda)] == streams["cpu"]
