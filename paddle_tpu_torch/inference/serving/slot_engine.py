"""Continuous-batching LLM serving over dense slots — the port of
`paddle_tpu/inference/serving/slot_engine.py` `ServingEngine`.

A fixed number of SLOTS shares one resident KV cache [L, slots, S, KV,
hd]. Each slot has its own write position: the decode step takes a
per-row `pos` vector and writes each row's k/v at its own column.
Admission happens between decode chunks: a new request is prefilled
alone, right-padded to a multiple of 16 tokens (the reference's bucket),
through `llm._forward_cached` straight into its slot of the resident
cache, in place (on the card: the flash kernel A1 over the new span and
the fused FFN A3, once a layer). The cache columns past the prompt are
never attended: decode masks columns <= pos and writes column pos before
reading it. Completion (eos or the request's token budget) frees the
slot on the host after each chunk; freed slots refill from the queue.

The decode rows (`_decode_rows`) are plain torch, as the reference's:
per-row rope, a per-row cache write, f32 masked attention over the whole
cache (-1e30 mask), the plain SwiGLU `silu(h@w1)*(h@w3)@w2`. The
reference runs no kernel there and neither does the port. A decode
chunk is C greedy steps with eos latching and `pos` clamped at
`max_len - 1`; the reference compiles it once, and on the card the port
captures it once into a CUDA graph over static buffers (the cache, the
last logits, `pos`, `eos`, the chunk's tokens; `ops/cuda/graphs.py`)
and replays it, a chunk a host call. On the CPU the same chunk runs
eagerly.

Greedy decoding only (parity with `LLMPredictor.generate` per request).
This dense-slot engine is the serving baseline the paged engine
(`engine.py`) is held against: every slot reserves `max_len` positions
of KV and there is no prefix sharing, preemption or admission control.

Not ported: MoE blocks (the port's LlamaConfig is dense), the
`attn_impl` switch, and the metric emits (observability, a later slice).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from ...device import resolve
from ...models import llama as L
from ...ops.cuda.graphs import CapturedGraph, warm_up
from .. import quant as Q
from ..llm import _cached_attention, _forward_cached, init_cache
from .engine import Completion

__all__ = ["Request", "Completion", "ServingEngine"]

PROMPT_BUCKET = 16    # prefill pads the prompt to a multiple of this


@dataclass
class Request:
    rid: int
    tokens: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None


@dataclass
class _Slot:
    rid: int = -1
    prompt: List[int] = field(default_factory=list)
    generated: List[int] = field(default_factory=list)
    budget: int = 0
    eos: int = -1
    active: bool = False


def _apply_rope_rows(x, cos, sin):
    """x [B, 1, H, hd]; cos / sin [B, hd/2]: each row at its own
    position. f32 math, cast back to x's type."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    c = cos[:, None, None, :]
    s = sin[:, None, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _block_decode_rows(x, lp, cfg: L.LlamaConfig, ck, cv, pos, rows):
    """One decode block with per-row positions. x [B, 1, d]; ck / cv
    [B, S, KV, hd], written in place at column pos[b] of row b; pos [B]
    long; rows = arange(B)."""
    B = x.shape[0]
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    h = L.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = Q.matmul_param(h, lp, "wq").reshape(B, 1, nh, hd)
    k = Q.matmul_param(h, lp, "wk").reshape(B, 1, nkv, hd)
    v = Q.matmul_param(h, lp, "wv").reshape(B, 1, nkv, hd)
    cos, sin = L.rope_cos_sin(pos, hd, cfg.rope_theta)      # [B, hd/2]
    q = _apply_rope_rows(q, cos, sin)
    k = _apply_rope_rows(k, cos, sin)
    ck[rows, pos] = k[:, 0].to(ck.dtype)
    cv[rows, pos] = v[:, 0].to(cv.dtype)
    # each row attends over its own prefix, columns <= pos[b]
    o = _cached_attention(q, ck, cv, pos[:, None, None, None])
    x = x + Q.matmul_param(o.reshape(B, 1, nh * hd), lp, "wo")
    h = L.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    gate = (torch.nn.functional.silu(Q.matmul_param(h, lp, "w1"))
            * Q.matmul_param(h, lp, "w3"))
    return x + Q.matmul_param(gate, lp, "w2")


def _decode_rows(params, tokens, cache, pos, cfg: L.LlamaConfig, rows):
    """tokens [B] -> last logits [B, V] f32; per-row positions, the cache
    written in place."""
    x = params["embed"][tokens[:, None]].to(cfg.dtype)
    for i in range(cfg.num_layers):
        x = _block_decode_rows(x, L.layer(params, i), cfg, cache["k"][i],
                               cache["v"][i], pos, rows)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return Q.matmul_param(x, params, "lm_head").float()[:, 0]


class ServingEngine:
    """Slot scheduler and per-row decode. Typical use::

        eng = ServingEngine(cfg, params, num_slots=8)    # on the card
        rid = eng.submit([1, 2, 3], max_new_tokens=32, eos_token_id=2)
        done = eng.run()          # drains queue and slots: Completions

    ``params`` is the port's parameter dict (`models.llama`), moved to
    ``device`` (default the card; ``"cpu"`` runs the plain versions) and,
    with ``weight_dtype``, its floating leaves cast once."""

    def __init__(self, cfg: L.LlamaConfig, params: Dict[str, Any],
                 num_slots: int = 8, max_len: Optional[int] = None,
                 chunk: int = 8, cache_dtype=None, weight_dtype=None,
                 device=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.device = resolve(device)
        self.cfg = cfg
        self.params = L.params_to_device(params, self.device, weight_dtype)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len or cfg.max_seq_len)
        self.chunk = int(chunk)
        self.cache_dtype = cache_dtype or cfg.dtype
        self._queue: Deque[Request] = deque()
        self._slots = [_Slot() for _ in range(self.num_slots)]
        self._next_rid = 0
        self._completions: List[Completion] = []
        self.stats = {"admitted": 0, "completed": 0, "decode_chunks": 0,
                      "decode_steps": 0, "graph_captures": 0}

        # device state: the static buffers the captured chunk reads and
        # writes, allocated once
        B, dev = self.num_slots, self.device
        self._cache = init_cache(cfg, B, self.max_len, self.cache_dtype,
                                 dev)
        self._last_logits = torch.zeros((B, cfg.vocab_size),
                                        dtype=torch.float32, device=dev)
        self._pos = torch.zeros((B,), dtype=torch.long, device=dev)
        self._eos = torch.full((B,), -1, dtype=torch.long, device=dev)
        self._finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._toks = torch.zeros((B, self.chunk), dtype=torch.long,
                                 device=dev)
        self._rows = torch.arange(B, device=dev)
        self._zero = torch.zeros((), dtype=torch.long, device=dev)
        # the captured chunk, keyed by (num_slots, chunk): one an engine
        self._graphs: Dict[tuple, CapturedGraph] = {}
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)

    # -- client API ------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None) -> int:
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if len(tokens) + max(max_new_tokens, 0) > self.max_len:
            raise ValueError(f"prompt {len(tokens)} + new {max_new_tokens} "
                             f"exceeds max_len {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        if max_new_tokens <= 0:   # parity with generate(max_new_tokens=0)
            self._completions.append(Completion(rid, tokens, [], "length"))
            self.stats["completed"] += 1
            return rid
        self._queue.append(Request(rid, tokens, int(max_new_tokens),
                                   eos_token_id))
        return rid

    def has_work(self) -> bool:
        return bool(self._queue) or any(s.active for s in self._slots)

    def run(self) -> List[Completion]:
        """Drive until queue and slots drain; completions in finish
        order."""
        while self.has_work():
            self.step()
        out, self._completions = self._completions, []
        return out

    # -- device work -----------------------------------------------------
    def _prefill_into(self, b: int, tokens: List[int]):
        """Prefill one prompt, right-padded to the bucket, into slot b's
        rows of the resident cache (in place); its next-token logits land
        in row b of the last logits, its position in pos[b]."""
        T = len(tokens)
        bucket = min(self.max_len, -(-T // PROMPT_BUCKET) * PROMPT_BUCKET)
        padded = torch.tensor([tokens + [0] * (bucket - T)],
                              dtype=torch.long, device=self.device)
        view = {key: self._cache[key][:, b:b + 1] for key in ("k", "v")}
        logits, _ = _forward_cached(self.params, padded, view, self._zero,
                                    self.cfg)
        self._last_logits[b] = logits[0, T - 1]
        self._pos[b] = T

    def _decode_step(self, j: int):
        """One greedy step over the static buffers, in place: choose token
        j of the chunk from the last logits (finished rows repeat their
        eos), run the L decode blocks at each row's pos, keep the new
        logits, advance pos (clamped at max_len - 1)."""
        nxt = torch.argmax(self._last_logits, dim=-1)
        has_eos = self._eos >= 0
        nxt = torch.where(self._finished & has_eos, self._eos, nxt)
        self._finished |= (nxt == self._eos) & has_eos
        self._last_logits.copy_(_decode_rows(self.params, nxt, self._cache,
                                             self._pos, self.cfg,
                                             self._rows))
        self._pos.copy_(torch.clamp(self._pos + 1, max=self.max_len - 1))
        self._toks[:, j] = nxt

    def _decode_chunk_eager(self):
        """C decode steps run eagerly; _toks gets their tokens."""
        self._finished.zero_()
        for j in range(self.chunk):
            self._decode_step(j)

    def _chunk_graph(self) -> CapturedGraph:
        """The captured chunk, made on first use: one eager step on the
        capture stream first (the libraries load, cuBLAS sets up its
        workspace), whose effects on the buffers are undone (the cache
        column it wrote is rewritten before any read), then the
        capture."""
        key = (self.num_slots, self.chunk)
        g = self._graphs.get(key)
        if g is None:
            bufs = (self._last_logits, self._pos, self._finished,
                    self._toks)
            saved = [t.clone() for t in bufs]
            warm_up(lambda: self._decode_step(0), self._stream)
            for t, s in zip(bufs, saved):
                t.copy_(s)
            g = self._graphs[key] = CapturedGraph(
                self._decode_chunk_eager, stream=self._stream)
            self.stats["graph_captures"] += 1
        return g

    def decode_chunk(self, eager: bool = False) -> np.ndarray:
        """One chunk of C greedy steps over every slot: [slots, C] tokens.
        On the card the captured chunk is replayed (``eager=True`` runs
        the steps it holds instead, the card check's reference)."""
        if self.device.type == "cuda" and not eager:
            self._chunk_graph().replay()
        else:
            self._decode_chunk_eager()
        return self._toks.cpu().numpy()

    # -- scheduler internals ---------------------------------------------
    def _admit(self):
        for b, slot in enumerate(self._slots):
            if slot.active or not self._queue:
                continue
            req = self._queue.popleft()
            self._prefill_into(b, req.tokens)
            eos = -1 if req.eos_token_id is None else int(req.eos_token_id)
            self._eos[b] = eos
            self._slots[b] = _Slot(rid=req.rid, prompt=req.tokens,
                                   generated=[], budget=req.max_new_tokens,
                                   eos=eos, active=True)
            self.stats["admitted"] += 1

    def _harvest(self, toks: np.ndarray):
        for b, slot in enumerate(self._slots):
            if not slot.active:
                continue
            for t in toks[b]:
                t = int(t)
                if slot.eos >= 0 and t == slot.eos:
                    self._finish(b, "stop")
                    break
                slot.generated.append(t)
                if len(slot.generated) >= slot.budget:
                    self._finish(b, "length")
                    break

    def _finish(self, b: int, reason: str):
        slot = self._slots[b]
        self._completions.append(Completion(slot.rid, slot.prompt,
                                            slot.generated, reason))
        self._slots[b] = _Slot()
        self.stats["completed"] += 1

    def step(self):
        """One scheduler tick: admit into free slots, decode one chunk,
        harvest finished requests."""
        self._admit()
        if not any(s.active for s in self._slots):
            return
        toks = self.decode_chunk()          # the tick's one sync
        self.stats["decode_chunks"] += 1
        self.stats["decode_steps"] += self.chunk
        self._harvest(toks)
