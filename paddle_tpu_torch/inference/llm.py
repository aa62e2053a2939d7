"""LLM serving: KV-cached prefill and chunked decode over the flagship
LLaMA — the port of `paddle_tpu/inference/llm.py` `LLMPredictor`.

The reference runs each decode chunk as one jitted program: a
`lax.scan` of C whole decode steps (argmax or draw, embed, the L cached
blocks, the logits) with the dense KV cache as a donated carry, one
program per chunk size (`_DECODE_CHUNKS`). On the card the port captures
each chunk into one CUDA graph (`ops/cuda/graphs.py`) over static
buffers, one graph per (B, C, sample, top_k, use_top_p) — the
reference's chunk key plus B, as jax also retraces on shape — and
replays it with one host call. The step inside the graph is
`LLMPredictor._decode_step`, run eagerly on the CPU (and by the card's
checks that hold a replay to it); nothing in it reads a device value or
a Python number derived from the position, which lives on the device
and which the graph advances a step at a time.

Per block (`_block_cached`): the q/k/v/o and lm_head products through
`inference.quant.matmul_param`; rope from a device tensor of positions;
the cache write at `pos` (`index_copy_` along the sequence axis in
place of `lax.dynamic_update_slice_in_dim`); prefill attention over the
new span through `llama.attention` (kernel A1 on the card); decode
attention as the reference's plain masked attention over the whole
cache (`_cached_attention`, outside any kernel, as the reference's
"xla" path); the FFN through `inference.quant.ffn_param` (A3 on fp
leaves, A6 on w8 leaves, the reference's plain chain of products on
w8a8 and fp8 leaves). Sampling (`_sample_next`) is the reference's
plain math with a Gumbel-argmax draw (`inference/sampling.py`); it does
not use the sampler kernel A7, as the reference's predictor does not
use its own.

Not ported: MoE blocks (the port's LlamaConfig is dense, ROADMAP Queue
A) and the `attn_impl` / `pallas_ffn` switches (on the card they could
only turn kernels off). `quant_mode=None` and `quant_manifest=None`
read `FLAGS_quant_mode` and `FLAGS_quant_manifest`, as the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..models import llama as L
from ..ops.cuda.graphs import CapturedGraph, warm_up
from . import quant as Q
from .sampling import gumbel

__all__ = ["LLMPredictor", "init_cache"]

_DECODE_CHUNKS = (32, 8, 1)


def _chunk_plan(n: int):
    """Exact greedy decomposition of n into chunk sizes from _DECODE_CHUNKS
    (32a + 8b + c) so any request reuses at most 3 captured loops."""
    plan = []
    for c in _DECODE_CHUNKS:
        k, n = divmod(n, c)
        plan.extend([c] * k)
    return plan


def init_cache(cfg: L.LlamaConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    """Dense KV cache {"k", "v"}, each [L, B, S, KV, hd] zeros in `dtype`
    (default cfg.dtype) on `device` (default the card)."""
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _cached_attention(q, ck, cv, pos_limit):
    """q [B, T, H, hd]; ck/cv [B, S, KV, hd]; row t attends to cache
    positions <= pos_limit + t (a device scalar). Scores in f32, masked
    with -1e30, softmax in f32 and cast to q's type before the PV
    product, as the reference."""
    B, T, H, hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    if KV != H:
        ck = ck.repeat_interleave(H // KV, dim=2)
        cv = cv.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), ck.float()) / (hd ** 0.5)
    cols = torch.arange(S, device=q.device)[None, None, None, :]
    rows = pos_limit + torch.arange(T, device=q.device)[None, None, :, None]
    s = torch.where(cols <= rows, s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.promote_types(p.dtype, cv.dtype)
    return torch.einsum("bhts,bshd->bthd", p.to(out), cv.to(out))


def _block_cached(x, lp, cfg: L.LlamaConfig, cache_k, cache_v, pos):
    """One transformer block writing its k/v into the cache at `pos` (a
    device int scalar). x [B, T, d]; cache_k/v [B, S, KV, hd], written in
    place. A prefill (T > 1, always at pos 0) attends over the new span
    through the flash kernel; a decode step over the whole cache."""
    B, T, d = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    h = L.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = Q.matmul_param(h, lp, "wq").reshape(B, T, nh, hd)
    k = Q.matmul_param(h, lp, "wk").reshape(B, T, nkv, hd)
    v = Q.matmul_param(h, lp, "wv").reshape(B, T, nkv, hd)
    positions = pos + torch.arange(T, device=x.device)
    cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    cache_k.index_copy_(1, positions, k.to(cache_k.dtype))
    cache_v.index_copy_(1, positions, v.to(cache_v.dtype))
    if T > 1:
        # prefill: the fresh tokens only see themselves (the cache ahead
        # of pos 0 is empty) — the flash kernel on the new span
        o = L.attention(q, k, v)
    else:
        o = _cached_attention(q, cache_k, cache_v, pos)
    x = x + Q.matmul_param(o.reshape(B, T, nh * hd), lp, "wo")
    h = L.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + Q.ffn_param(h, lp)


def _forward_cached(params, tokens, cache, pos, cfg: L.LlamaConfig):
    """tokens [B, T] starting at absolute position `pos` (a device int
    scalar). Writes the cache in place; returns (logits [B, T, V] f32,
    cache)."""
    x = params["embed"][tokens].to(cfg.dtype)
    for i in range(cfg.num_layers):
        x = _block_cached(x, L.layer(params, i), cfg, cache["k"][i],
                          cache["v"][i], pos)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return Q.matmul_param(x, params, "lm_head").float(), cache


def _mask_logits(logits, temperature, top_p, top_k: int):
    """The reference's `_sample_next` masking on f32 logits [B, V]:
    divide by temperature; static top_k (0 = off) masks below the k-th
    value; top_p (None = off, else a scalar) masks below the smallest
    sorted value whose exclusive prefix mass is under top_p. Masked
    entries are -inf."""
    l = logits / temperature
    if top_k:
        kth = torch.topk(l, int(top_k), dim=-1).values[..., -1:]
        l = torch.where(l < kth, float("-inf"), l)
    if top_p is not None:
        sl = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sl, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p           # exclusive prefix mass
        cutoff = torch.where(keep, sl, float("inf")).amin(dim=-1,
                                                          keepdim=True)
        l = torch.where(l < cutoff, float("-inf"), l)
    return l


def _sample_next(logits, generator, temperature, top_p, top_k: int):
    """Temperature / top-k / top-p selection on f32 logits [B, V]: the
    reference's masking, then a Gumbel-argmax draw from `generator`
    (token 0 for a row masked out entirely, as the reference's)."""
    l = _mask_logits(logits, temperature, top_p, top_k)
    return torch.argmax(l + gumbel(l.shape, generator, l.device), dim=-1)


class _Slots:
    """One batch size's static buffers, allocated once outside every
    graph: the cache, the last logits, the position (an int device
    scalar the decode step advances), finished flags, eos, the chunk's
    tokens, temperature, top_p and the draw's generator. The graphs of
    this B read and write only these and their one memory pool."""

    def __init__(self, cfg: L.LlamaConfig, B: int, max_len: int,
                 cache_dtype, device):
        self.cache = init_cache(cfg, B, max_len, cache_dtype, device)
        self.last_logits = torch.zeros((B, cfg.vocab_size),
                                       dtype=torch.float32, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.finished = torch.zeros((B,), dtype=torch.bool, device=device)
        self.eos = torch.full((), -1, dtype=torch.long, device=device)
        self.toks = torch.zeros((B, max(_DECODE_CHUNKS)), dtype=torch.long,
                                device=device)
        self.temperature = torch.ones((), dtype=torch.float32, device=device)
        self.top_p = torch.ones((), dtype=torch.float32, device=device)
        self.generator = torch.Generator(device=device)
        self.graphs: Dict[Tuple, CapturedGraph] = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if torch.device(device).type == "cuda" else None)


class LLMPredictor:
    """Greedy / temperature decode over a functional LLaMA with a resident
    KV cache; `generate` is the serving entry.

    ``params`` is the port's parameter dict (`models.llama`; the
    reference's pytree through `params_from_numpy`). It is moved to
    ``device`` (default the card; ``"cpu"`` runs the kernels' plain
    versions) and, with ``weight_dtype``, its floating leaves cast once
    before quantization. ``quant_mode``: "" serves the weights as they
    are (None reads FLAGS_quant_mode); "w8", "w8a8" or "fp8" quantizes
    the block matmuls and the lm_head (`inference.quant.quantize_llama_params`, with
    ``quant_manifest`` checked against cfg; "w8a8" needs it for its
    activation scales).

    On the card each decode chunk replays a CUDA graph (see the module
    docstring); the prefill runs eagerly (its T varies). A capture or
    replay failure raises.

    The predictor keeps the buffers and graphs of one batch size: the
    dense cache [L, B, max_len, KV, hd] and the last logits, with the
    graphs captured over them. A `generate` at another B frees them
    first (graphs and their pool with them) and allocates and captures
    anew, so what it holds is that of one B, as the reference's one
    cache a `generate`."""

    def __init__(self, cfg: L.LlamaConfig, params: Dict[str, Any],
                 max_len: Optional[int] = None, cache_dtype=None,
                 weight_dtype=None, quant_mode: Optional[str] = None,
                 quant_manifest=None, device=None):
        self.device = resolve(device)
        self.cfg = cfg
        mode = Q.resolve_quant_mode(quant_mode)
        manifest = Q.resolve_manifest(quant_manifest) if mode else None
        if manifest is not None:
            manifest.validate_for(cfg)
        # stored in weight_dtype first, then quantized, as the reference
        self.params = Q.quantize_llama_params(
            L.params_to_device(params, self.device, weight_dtype), mode,
            manifest)
        self.quant_mode = mode
        self.max_len = int(max_len or cfg.max_seq_len)
        self.cache_dtype = cache_dtype or cfg.dtype
        self._slots: Dict[int, _Slots] = {}
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)

    # -- the decode step and its chunks ------------------------------------
    def _slots_for(self, B: int) -> _Slots:
        st = self._slots.get(B)
        if st is None:
            # one B at a time: the last B's graphs go first (they hold
            # its buffers through their closures), then its buffers, and
            # only then are the new B's allocated
            for old in self._slots.values():
                old.graphs.clear()
            self._slots.clear()
            st = self._slots[B] = _Slots(self.cfg, B, self.max_len,
                                         self.cache_dtype, self.device)
        return st

    def _decode_step(self, st: _Slots, j: int, sample: bool, top_k: int,
                     use_top_p: bool):
        """One decode step over st's buffers, in place: choose token j of
        the chunk from the last logits, embed it, run the L cached blocks
        at st.pos, keep the new logits, advance st.pos. The function each
        captured chunk holds C times."""
        if sample:
            nxt = _sample_next(st.last_logits, st.generator, st.temperature,
                               st.top_p if use_top_p else None, top_k)
        else:
            nxt = torch.argmax(st.last_logits, dim=-1)
        nxt = torch.where(st.finished, st.eos, nxt)
        st.finished |= nxt == st.eos
        logits, _ = _forward_cached(self.params, nxt[:, None], st.cache,
                                    st.pos, self.cfg)
        st.last_logits.copy_(logits[:, -1])
        st.pos += 1
        st.toks[:, j] = nxt

    def _decode_chunk_eager(self, st: _Slots, C: int, sample: bool = False,
                            top_k: int = 0, use_top_p: bool = False):
        """C decode steps run eagerly; st.toks[:, :C] gets their tokens."""
        for j in range(C):
            self._decode_step(st, j, sample, top_k, use_top_p)

    def _decode_chunk_fn(self, st: _Slots, C: int, top_k: int = 0,
                         use_top_p: bool = False, sample: bool = False):
        """The captured loop of C decode steps for st's batch size, made
        on first use: one eager step on the capture stream first (the
        kernels build, cuBLAS sets up its workspace), whose effects on
        st's buffers and generator are then undone, then the capture,
        into the memory pool of st's graphs."""
        key = (C, sample, int(top_k), bool(use_top_p))
        g = st.graphs.get(key)
        if g is None:
            saved = [t.clone() for t in (st.last_logits, st.pos,
                                         st.finished, st.toks)]
            rng = st.generator.get_state()
            warm_up(lambda: self._decode_step(st, 0, sample, top_k,
                                              use_top_p), self._stream)
            for t, s in zip((st.last_logits, st.pos, st.finished, st.toks),
                            saved):
                t.copy_(s)
            st.generator.set_state(rng)
            g = st.graphs[key] = CapturedGraph(
                lambda: self._decode_chunk_eager(st, C, sample, top_k,
                                                 use_top_p),
                pool=st.pool, stream=self._stream,
                generators=(st.generator,))
        return g

    # -- generation --------------------------------------------------------
    def generate(self, tokens, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 return_scores: bool = False,
                 temperature: Optional[float] = None,
                 top_k: int = 0, top_p: Optional[float] = None,
                 seed: int = 0):
        """tokens [B, T] int prompt -> [B, T + max_new] int32 completion on
        the predictor's device. Greedy by default; `temperature` (with
        optional `top_k`/`top_p`) samples, seeded by `seed`. Decode runs
        in chunks of 32, 8 and 1 steps; with an eos, generation stops
        after the chunk in which every row has finished, and the rest is
        eos. `return_scores=True` runs the greedy per-token loop and also
        returns each step's logits [B, steps, V]."""
        return self._generate(tokens, max_new_tokens, eos_token_id,
                              return_scores, temperature, top_k, top_p,
                              seed, capture=self.device.type == "cuda")

    @torch.no_grad()
    def _generate(self, tokens, max_new_tokens, eos_token_id, return_scores,
                  temperature, top_k, top_p, seed, capture: bool):
        """`generate`, its chunks replayed as graphs (`capture`) or run
        eagerly (the CPU, and the card's checks of a replay against the
        eager steps)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
        tokens = tokens.to(self.device)
        B, T = tokens.shape
        if T + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {T} + new {max_new_tokens} exceeds "
                             f"max_len {self.max_len}")
        if temperature is None and (top_k or top_p is not None):
            temperature = 1.0        # top-k/top-p imply sampling
        sample = temperature is not None and temperature > 0.0
        if temperature is not None and temperature <= 0.0:
            top_k, top_p = 0, None   # temperature<=0 = greedy by convention
        if return_scores and sample:
            raise NotImplementedError(
                "return_scores=True uses the greedy host loop; "
                "sampling + per-step scores is not supported")
        st = self._slots_for(B)
        for name in ("k", "v"):
            st.cache[name].zero_()
        st.pos.zero_()
        logits, _ = _forward_cached(self.params, tokens, st.cache, st.pos,
                                    self.cfg)
        st.last_logits.copy_(logits[:, -1])
        st.finished.zero_()
        st.eos.fill_(-1 if eos_token_id is None else int(eos_token_id))
        if return_scores:
            return self._generate_hostloop(st, tokens, max_new_tokens,
                                           eos_token_id, capture)
        st.generator.manual_seed(int(seed))
        st.temperature.fill_(float(temperature) if sample else 1.0)
        st.top_p.fill_(float(top_p) if top_p is not None else 1.0)
        kw = dict(sample=sample, top_k=int(top_k),
                  use_top_p=top_p is not None)
        out = [tokens]
        done = 0
        for C in _chunk_plan(max_new_tokens):
            st.pos.fill_(T + done)
            if capture:
                self._decode_chunk_fn(st, C, **kw).replay()
            else:
                self._decode_chunk_eager(st, C, **kw)
            out.append(st.toks[:, :C].clone())
            done += C
            if eos_token_id is not None and bool(st.finished.all()):
                rem = max_new_tokens - done
                if rem:
                    out.append(torch.full((B, rem), int(eos_token_id),
                                          dtype=torch.long,
                                          device=self.device))
                break
        return torch.cat(out, dim=1).to(torch.int32)

    def _generate_hostloop(self, st: _Slots, tokens, max_new_tokens,
                           eos_token_id, capture: bool):
        """Per-token host loop; surfaces each step's logits (scores). The
        sequence is eos-padded to [B, T + max_new] so both generate paths
        return the same shape; `scores` covers only the steps that ran
        (an early eos stop ends the loop). Each step is a greedy chunk of
        one (a replayed graph on the card)."""
        B, T = tokens.shape
        out = [tokens]
        scores = []
        done = 0
        for i in range(max_new_tokens):
            scores.append(st.last_logits.clone())
            done = i + 1
            if i == max_new_tokens - 1:   # last token decided: the next
                nxt = torch.argmax(st.last_logits, dim=-1)   # forward's
                out.append(torch.where(st.finished, st.eos,  # logits
                                       nxt)[:, None])        # are unused
                break
            st.pos.fill_(T + i)
            if capture:
                self._decode_chunk_fn(st, 1).replay()
            else:
                self._decode_chunk_eager(st, 1)
            out.append(st.toks[:, :1].clone())
            if eos_token_id is not None and bool(st.finished.all()):
                break
        if eos_token_id is not None and done < max_new_tokens:
            out.append(torch.full((B, max_new_tokens - done),
                                  int(eos_token_id), dtype=torch.long,
                                  device=self.device))
        return (torch.cat(out, dim=1).to(torch.int32),
                torch.stack(scores, dim=1))
