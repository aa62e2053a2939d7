"""Paged-KV continuous-batching serving engine — the port of
`paddle_tpu/inference/serving/engine.py` `PagedServingEngine`.

Every scheduler tick packs its chunk mix (chunked prefill and decode
rows together) into one `[token_budget]` token vector plus `[max_batch]`
length and block-table rows, and runs one forward over the stacked
LLaMA layers. On the card every tick goes through three kernels, with
no fallback:

- paged attention once per layer, through
  `ops/kernels/serving_attention.block_multihead_attention_`: A5 on fp
  pages, A5's int8 mode when the engine keeps int8 pages
  (`quant_kv=True`); when every chunk is one token the tick packs
  `[max_batch]` tokens and launches it with `max_q = 1` (the decode fast
  path), otherwise with `max_q = token_budget`;
- the fused SwiGLU FFN once per layer: A3 on fp weights, A6 on w8
  weights (`quant_mode="w8"`), which it reads as int8;
- the sampler prep (A7) once per tick, on every tick (the reference runs
  its Pallas sampler on decode ticks only).

Quantized serving follows the reference (`engine.py:161-196`,
`:287-309`): `quant_mode="w8"` quantizes the block matmuls and the
lm_head after the weights are stored in `weight_dtype` (scales stay
f32); q/k/v/o and the lm_head run `inference.quant.matmul_param`, a
plain product over the int8 weight cast to the compute type, as in the
reference. `quant_kv=True` needs a calibration manifest: its per-(layer,
kv head) absmax gives the quant multipliers 127/absmax [L, KV] used on
append and per-page dequant arrays absmax/127 [L, num_blocks, KV], which
copy-on-write moves with their pages.

On the CPU the same code runs each kernel's plain PyTorch version, which
is how the tests hold the engine against the reference.

The KV cache is one tensor per side, [L, num_blocks, KV, block_size, hd],
updated in place (the reference donates it to its jitted step); prefix
sharing and preemption are block-table edits in the BlockManager, and
copy-on-write pages are copied with one indexed assignment.

Sampling: greedy rows take the kernel's argmax; sampled rows draw from
the masked logits by a Gumbel argmax (`inference/sampling.py`, the
method of the reference's `jax.random.categorical`) with the request's
own `torch.Generator` (seeded from `seed`, on the engine's device),
which advances only when the request emits a token — so the same seed
gives the same stream, preemption recompute included. A row that
masking left all -inf (top_p <= 0) draws token 0, as in the reference.
The draw will not match the reference's threefry keys.

The decode fast path is captured: the reference compiles each tick
signature into one executable (`engine.py:573` `_build_step`); here the
first all-decode tick on the card warms up and captures the forward and
A7 over static `[max_batch]` buffers into one CUDA graph
(`ops/cuda/graphs.py`), and every later decode tick copies its host
arrays into those buffers (from pinned host tensors) and replays it.
The page-append lists, one entry per live token, are padded to
`max_batch` by repeating the first entry's write (the same value into
the same slot), so one graph serves any number of live sequences and
the page pool keeps its size. Mixed (prefill) ticks run eagerly; the
draw and the tick's one sync follow the replay. A capture or replay
failure raises. On the CPU the same static-buffer tick runs eagerly.

Left for later slices: LoRA adapters, speculative decoding, the `w8a8`
and `fp8` quant modes, chaos hooks, tracing spans, tuned profiles and
the `FLAGS_quant_*` defaults.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve
from ...models import llama as L
from .. import quant as Q
from ...ops.cuda import fused_ffn as FF
from ...ops.cuda import fused_sample as FS
from ...ops.cuda import paged_attention as PA
from ...ops.cuda.graphs import CapturedGraph, warm_up
from ...ops.kernels.serving_attention import (META_DTYPES,
                                              block_multihead_attention_,
                                              metadata_from, paged_metadata,
                                              paged_metadata_arrays,
                                              rope_table)
from ..sampling import gumbel
from .block_manager import BlockManager
from .scheduler import (DEFAULT_MAX_QUEUE, DeadlineExceededError,
                        RejectedError, Scheduler, Sequence)

__all__ = ["PagedServingEngine", "TokenEvent", "Completion",
           "RejectedError", "DeadlineExceededError"]


@dataclass
class TokenEvent:
    """One streamed token (or a terminal event with token < 0)."""
    rid: int
    token: int                 # -1 for compute-free terminal events
    finished: bool
    reason: Optional[str] = None   # stop | length | deadline | cancelled


@dataclass
class Completion:
    rid: int
    prompt_tokens: List[int]
    output_tokens: List[int]
    finish_reason: str  # "stop" (eos) | "length" | "deadline" | "cancelled"


class PagedServingEngine:
    """Continuous batching over a paged KV cache. Typical use::

        eng = PagedServingEngine(cfg, params, block_size=16, max_batch=8,
                                 token_budget=64)          # on the card
        rid = eng.submit([1, 2, 3], max_new_tokens=32, eos_token_id=2)
        for tok in eng.stream(rid):   # streaming
            ...
        done = eng.run()              # or drain everything

    ``params`` is the port's parameter dict (`models.llama`); it is moved
    to ``device`` and its floating leaves stored in ``weight_dtype``
    (default cfg.dtype), quantization scales excepted. As in the
    reference, each weight meets the activations in the compute type
    cfg.dtype; with the default no cast runs at all.

    Quantized serving: ``quant_mode="w8"`` serves weight-only int8
    matmuls; ``quant_kv=True`` int8 KV pages, which need
    ``quant_manifest`` (a :class:`~..quant.QuantManifest` or its path,
    from `inference.quant.calibrate`). ``cache_dtype`` may only restate
    the page type: int8 with ``quant_kv``, cfg.dtype without.
    """

    def __init__(self, cfg: L.LlamaConfig, params: Dict,
                 num_blocks: Optional[int] = None, block_size: int = 16,
                 max_batch: int = 8, token_budget: int = 64,
                 max_len: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, top_k: int = 0,
                 max_queue: int = DEFAULT_MAX_QUEUE,
                 cache_dtype: Optional[torch.dtype] = None,
                 weight_dtype: Optional[torch.dtype] = None,
                 quant_mode: str = "", quant_kv: bool = False,
                 quant_manifest=None, device=None):
        self.device = resolve(device)
        self.cfg = cfg
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        # the kernels' limits bind on the card only: on the CPU every
        # wrapper runs its plain version, which serves any geometry, as
        # the reference falls back past its kernels' gates; the sampler
        # kernel serves any vocabulary
        if self.device.type == "cuda":
            if not PA.supported(cfg.num_heads, kvh, hd, block_size):
                raise ValueError(
                    f"paged-attention kernel does not support "
                    f"H={cfg.num_heads} KV={kvh} hd={hd} "
                    f"block_size={block_size}")
            if not FF.supported(cfg.hidden_size, cfg.intermediate_size,
                                w8=quant_mode == "w8"):
                raise ValueError(
                    f"fused FFN kernel does not support d={cfg.hidden_size} "
                    f"d_ff={cfg.intermediate_size}")
        self.quant_mode = quant_mode
        self.quant_kv = bool(quant_kv)
        manifest = Q.resolve_manifest(quant_manifest)
        if self.quant_kv and manifest is None:
            raise ValueError(
                "quant_kv needs calibrated KV scales: run "
                "inference.quant.calibrate over a sample workload, "
                "save_manifest it, and pass quant_manifest")
        if manifest is not None:
            manifest.validate_for(cfg)
        self.cache_dtype = torch.int8 if self.quant_kv else cfg.dtype
        if cache_dtype is not None and cache_dtype != self.cache_dtype:
            why = ("quant_kv serves int8 pages" if self.quant_kv else
                   f"fp pages are of the compute type {cfg.dtype}")
            raise ValueError(f"{why}; cache_dtype={cache_dtype} conflicts "
                             f"(drop it, or toggle quant_kv)")
        # stored in weight_dtype first, then quantized, as the reference
        # casts before its transform: the int8 weights come from the
        # stored values, and their scales stay f32
        wdt = weight_dtype or cfg.dtype
        self.params = Q.quantize_llama_params(
            L.params_to_device(params, self.device, wdt), quant_mode,
            manifest)
        self._layers = [L.layer(self.params, i) for i in range(cfg.num_layers)]
        self.max_len = int(max_len or cfg.max_seq_len)
        self.block_size = int(block_size)
        self.max_batch = int(max_batch)
        self.token_budget = int(token_budget)
        self.top_k = int(top_k)
        self.max_blocks_per_seq = -(-self.max_len // self.block_size)
        if num_blocks is None:
            num_blocks = self.max_batch * self.max_blocks_per_seq
        self.num_blocks = int(num_blocks)
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        # both cache sides, all layers, plus the per-page f32 scale rows
        # when quantized
        self.kv_page_bytes = (2 * cfg.num_layers * kvh * self.block_size
                              * hd * itemsize)
        if self.quant_kv:
            self.kv_page_bytes += 2 * cfg.num_layers * kvh * 4
        self.blocks = BlockManager(self.num_blocks, self.block_size,
                                   page_bytes=self.kv_page_bytes)
        self.scheduler = Scheduler(self.blocks, self.token_budget,
                                   self.max_batch,
                                   prefill_chunk=prefill_chunk,
                                   max_queue=max_queue)
        self._next_rid = 0
        self._completions: List[Completion] = []
        self._events_by_rid: Dict[int, List[TokenEvent]] = {}
        self._generators: Dict[int, torch.Generator] = {}
        self.stats = {"steps": 0, "tokens_computed": 0,
                      "cow_block_copies": 0, "decode_fast_steps": 0,
                      "mixed_steps": 0}
        shape = (cfg.num_layers, self.num_blocks, kvh, self.block_size, hd)
        self._key_cache = torch.zeros(shape, dtype=self.cache_dtype,
                                      device=self.device)
        self._value_cache = torch.zeros(shape, dtype=self.cache_dtype,
                                        device=self.device)
        # int8 pages: per-head quant multipliers [L, KV] for the append and
        # per-page dequant arrays [L, num_blocks, KV] for the read (every
        # page of a layer starts at the calibrated value; copy-on-write
        # moves a page's rows with it)
        self._kv_quant: Tuple[torch.Tensor, ...] = ()
        self._kv_dequant: Tuple[torch.Tensor, ...] = ()
        if self.quant_kv:
            absmax = [torch.tensor(manifest.kv_scales.get(side),
                                   dtype=torch.float32, device=self.device)
                      for side in ("k", "v")]
            want = (cfg.num_layers, kvh)
            if any(tuple(a.shape) != want for a in absmax):
                raise ValueError(
                    f"manifest kv_scales must be [num_layers, num_kv_heads]"
                    f"={want}; got {[tuple(a.shape) for a in absmax]} — "
                    f"re-run calibration against this model")
            self._kv_quant = tuple(Q.QMAX / a for a in absmax)
            self._kv_dequant = tuple(
                (a / Q.QMAX)[:, None, :].repeat(1, self.num_blocks, 1)
                for a in absmax)
        cos, sin = L.rope_cos_sin(torch.arange(self.max_len,
                                               device=self.device),
                                  hd, cfg.rope_theta)
        self._rope_emb = rope_table(cos, sin)            # [2, 1, S, hd]
        # the last tick's [max_batch, V] f32 logits (rows past the batch
        # are padding): what tests and the card check hold against; after
        # a captured tick it is the graph's output, rewritten by the next
        self.last_logits: Optional[torch.Tensor] = None
        self._alloc_decode()
        self._dec_graph = None

    # -- client API -------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, priority: int = 0,
               deadline_s: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               seed: int = 0) -> int:
        """Enqueue a request. Raises ValueError when it cannot ever fit,
        RejectedError (load shed) when the wait queue is full."""
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        total = len(tokens) + max(int(max_new_tokens), 0)
        if total > self.max_len:
            raise ValueError(f"prompt {len(tokens)} + new {max_new_tokens} "
                             f"exceeds max_len {self.max_len}")
        if self.blocks.blocks_needed(total) > self.num_blocks:
            raise ValueError(
                f"request needs {self.blocks.blocks_needed(total)} KV "
                f"blocks but the pool has {self.num_blocks}; raise "
                f"num_blocks or lower max_new_tokens")
        if top_k is not None and int(top_k) != self.top_k:
            raise ValueError(
                f"per-request top_k={top_k} != engine top_k={self.top_k}: "
                "build the engine with the top_k you serve")
        rid = self._next_rid
        self._next_rid += 1
        self._events_by_rid[rid] = []
        if max_new_tokens <= 0:
            self._finish_event(Sequence(rid, tokens, 0), "length")
            return rid
        if temperature is None and (self.top_k or top_p is not None):
            temperature = 1.0      # top-k/top-p imply sampling
        sample = temperature is not None and float(temperature) > 0.0
        seq = Sequence(
            rid, tokens, int(max_new_tokens),
            eos=-1 if eos_token_id is None else int(eos_token_id),
            priority=int(priority),
            deadline=(time.monotonic() + float(deadline_s)
                      if deadline_s is not None else None),
            temperature=float(temperature) if sample else 0.0,
            top_p=float(top_p) if top_p is not None else 1.0,
            seed=int(seed))
        self.scheduler.add_request(seq)   # RejectedError on overflow
        if sample:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            self._generators[rid] = gen
        return rid

    def cancel(self, rid: int) -> bool:
        seq = self.scheduler.get(rid)
        if seq is None or seq.status == "finished":
            return False
        self.scheduler.cancel(rid)
        self._finish_event(seq, "cancelled", already_finished=True)
        return True

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def run(self) -> List[Completion]:
        """Drive until queue and batch drain; completions in finish order."""
        while self.has_work():
            self.step()
        out, self._completions = self._completions, []
        return out

    def stream(self, rid: int) -> Iterator[int]:
        """Yield rid's tokens as they are produced, driving the engine
        while the request is live (other requests progress too). A
        deadline expiry raises :class:`DeadlineExceededError`; stop,
        length and cancel end the iterator."""
        events = self._events_by_rid.get(rid)
        if events is None:
            raise KeyError(f"unknown rid {rid}")
        i = 0
        while True:
            while i < len(events):
                ev = events[i]
                i += 1
                if ev.token >= 0:
                    yield ev.token
                if ev.finished:
                    if ev.reason == "deadline":
                        raise DeadlineExceededError(
                            f"request {rid} expired mid-stream after "
                            f"{i - 1} tokens (reason=deadline)")
                    return
            if not self.has_work():
                return
            self.step()

    # -- device work ------------------------------------------------------
    def _copy_blocks(self, pairs: List[Tuple[int, int]]):
        """Copy-on-write page copies, every layer and both sides at once."""
        src = torch.tensor([s for s, _ in pairs], device=self.device)
        dst = torch.tensor([d for _, d in pairs], device=self.device)
        for t in (self._key_cache, self._value_cache, *self._kv_dequant):
            t[:, dst] = t[:, src]   # int8 pages' scale rows move with them
        self.stats["cow_block_copies"] += len(pairs)

    def _forward(self, tokens, meta, last_idx) -> torch.Tensor:
        """The tick's forward: packed tokens [tok] -> f32 logits of each
        batch slot's last token [max_batch, V]."""
        cfg = self.cfg
        # weights meet activations in the compute type: matmul_param casts
        # fp weights (no copy when equal) and int8 ones; the FFN kernels
        # take int8 weights as they are
        x = self.params["embed"][tokens].to(cfg.dtype)
        for i, lp in enumerate(self._layers):
            scales = {}
            if self.quant_kv:
                scales = dict(
                    cache_k_quant_scales=self._kv_quant[0][i],
                    cache_v_quant_scales=self._kv_quant[1][i],
                    cache_k_dequant_scales=self._kv_dequant[0][i],
                    cache_v_dequant_scales=self._kv_dequant[1][i])
            h = L.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
            qkv = torch.cat([Q.matmul_param(h, lp, n)
                             for n in ("wq", "wk", "wv")], -1)
            o = block_multihead_attention_(qkv, self._key_cache[i],
                                           self._value_cache[i], meta,
                                           **scales)
            x = x + Q.matmul_param(o, lp, "wo")
            h = L.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
            x = x + FF.apply_ffn(h, lp)
        hlast = L.rms_norm(x[last_idx], self.params["final_norm"],
                           cfg.rms_eps)
        return Q.matmul_param(hlast, self.params, "lm_head").float()

    def _tick(self, tokens, meta, last_idx, temps, top_ps):
        """The tick's device work: the forward, then the sampler prep
        (A7). Returns (logits [max_batch, V] f32, masked logits, greedy
        tokens int32)."""
        logits = self._forward(tokens, meta, last_idx)
        masked, greedy = FS.fused_sample_prep(logits, temps, top_ps,
                                              self.top_k)
        return logits, masked, greedy

    def _decode_tick(self):
        """The decode fast path's tick over its static buffers
        (`_stage_decode` fills them): the function the captured graph
        holds, run eagerly. On the CPU every decode tick runs it; on the
        card the graph's warm-up, and the checks that hold a replay to
        it, do."""
        t = self._dec
        meta = metadata_from(t, self._rope_emb, max_q=1)
        return self._tick(t["tokens"], meta, t["last_idx"], t["temps"],
                          t["top_ps"])

    def _replay_decode(self):
        """The decode tick on the card: the first call warms up (one
        eager `_decode_tick` on the capture stream, whose results are
        this tick's) and captures the graph; later calls replay it. A
        failed capture or replay raises."""
        if self._dec_graph is None:
            stream = torch.cuda.Stream(self.device)
            out = warm_up(self._decode_tick, stream)
            self._dec_graph = CapturedGraph(self._decode_tick,
                                            stream=stream)
            return out
        return self._dec_graph.replay()

    def _stage_decode(self, arrays: Dict[str, np.ndarray]):
        """Copy a decode tick's host arrays into the static buffers: on
        the card through pinned host tensors, with no new device tensor."""
        for k, a in arrays.items():
            self._dec_host[k].numpy()[...] = a.reshape(
                self._dec_host[k].shape)
        if self._dec_host is not self._dec:
            for k, t in self._dec.items():
                t.copy_(self._dec_host[k], non_blocking=True)

    def _alloc_decode(self):
        """The decode tick's static buffers: each metadata field at its
        `[max_batch]` decode shape (write lists padded to max_batch),
        tokens, last_idx, temps and top_ps; host twins pinned on the card
        (on the CPU the buffers are their own host twins)."""
        B, mb = self.max_batch, self.max_blocks_per_seq
        shapes = {k: (B,) for k in META_DTYPES}
        shapes.update(row_tok=(B, 1), block_tables=(B, mb), tokens=(B,),
                      last_idx=(B,), temps=(B,), top_ps=(B,))
        types = {**META_DTYPES, "tokens": torch.long,
                 "last_idx": torch.long, "temps": torch.float32,
                 "top_ps": torch.float32}
        cuda = self.device.type == "cuda"
        self._dec_host = {k: torch.zeros(shapes[k], dtype=types[k],
                                         pin_memory=cuda) for k in shapes}
        self._dec = ({k: torch.zeros_like(t, device=self.device)
                      for k, t in self._dec_host.items()} if cuda
                     else self._dec_host)

    def _draw(self, batch, masked, greedy):
        """The tick's next token a slot: the greedy argmax, or for a
        sampled row that emits a token this tick a categorical draw from
        its masked row with the request's own generator (so a request's
        stream depends only on its seed). A row that masking left all
        -inf gets token 0, as the reference's draw gives. No device value
        is read here; the tick's one sync is the caller's."""
        nxt = greedy.to(torch.long)
        rows = [i for i, (seq, n) in enumerate(batch.items)
                if seq.temperature > 0.0
                and seq.num_computed + n == len(seq.tokens)]
        if rows:
            V = masked.shape[-1]
            noise = torch.stack([
                gumbel((V,), self._generators[batch.items[i][0].rid],
                       self.device) for i in rows])
            idx = torch.tensor(rows).to(self.device, non_blocking=True)
            nxt[idx] = torch.argmax(masked[idx] + noise, dim=-1)
        return nxt

    def step(self) -> List[TokenEvent]:
        """One tick: schedule a mixed batch, run it, harvest tokens.
        Returns this tick's streamed events."""
        batch, expired = self.scheduler.schedule()
        events: List[TokenEvent] = []
        for seq in expired:
            events.append(self._finish_event(seq, "deadline",
                                             already_finished=True))
        if not batch:
            return events
        pairs = self.blocks.take_copies()
        if pairs:
            self._copy_blocks(pairs)

        tok_pad, B = self.token_budget, self.max_batch
        decode = all(n == 1 for _, n in batch.items)
        if decode:
            # decode fast path: [max_batch] tokens, one q row per sequence
            tok_pad = B
        tokens = np.zeros((tok_pad,), np.int64)
        cu = np.zeros((B + 1,), np.int64)
        dec_lens = np.zeros((B,), np.int32)
        this_lens = np.zeros((B,), np.int32)
        tables = np.full((B, self.max_blocks_per_seq), -1, np.int32)
        temps = np.ones((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        pos = 0
        for i, (seq, n) in enumerate(batch.items):
            tokens[pos:pos + n] = seq.tokens[seq.num_computed:
                                             seq.num_computed + n]
            pos += n
            cu[i + 1] = pos
            dec_lens[i] = seq.num_computed
            this_lens[i] = n
            row = self.blocks.block_table(seq.rid)
            tables[i, :len(row)] = row
            if seq.temperature > 0.0:
                temps[i] = seq.temperature
                top_ps[i] = seq.top_p
        cu[len(batch.items) + 1:] = pos

        dev = self.device
        last_idx = np.clip(cu[1:] - 1, 0, tok_pad - 1)
        if decode:
            # fixed shapes: the page writes padded to max_batch, so the
            # captured tick serves any number of live sequences
            arrays = paged_metadata_arrays(
                cu, dec_lens, this_lens, tables, tok_pad, self.block_size,
                self.max_len, max_q=1, writes=B)
            self._stage_decode(dict(arrays, tokens=tokens,
                                    last_idx=last_idx, temps=temps,
                                    top_ps=top_ps))
            logits, masked, greedy = (self._replay_decode()
                                      if dev.type == "cuda"
                                      else self._decode_tick())
        else:
            meta = paged_metadata(cu, dec_lens, this_lens, tables, tok_pad,
                                  self.block_size, self._rope_emb,
                                  max_q=tok_pad)
            logits, masked, greedy = self._tick(
                torch.from_numpy(tokens).to(dev), meta,
                torch.from_numpy(last_idx).to(dev),
                torch.from_numpy(temps).to(dev),
                torch.from_numpy(top_ps).to(dev))
        self.last_logits = logits
        nxt = self._draw(batch, masked, greedy)
        nxt = nxt.cpu().numpy()           # the tick's one sync point

        self.stats["steps"] += 1
        self.stats["decode_fast_steps" if decode else "mixed_steps"] += 1
        self.stats["tokens_computed"] += batch.total_tokens

        # harvest: a slot yields a token iff its chunk reached the end of
        # the sequence's current tokens (final prefill chunk or decode row)
        for i, (seq, n) in enumerate(batch.items):
            self.scheduler.on_computed(seq, n)
            if seq.num_computed < len(seq.tokens):
                continue   # mid-prefill: logits row is not a next token
            tok = int(nxt[i])
            if seq.eos >= 0 and tok == seq.eos:
                self.scheduler.append_token(seq, tok)  # timestamps
                seq.generated.pop()                    # eos not surfaced
                seq.tokens.pop()
                events.append(self._finish_event(seq, "stop"))
                continue
            self.scheduler.append_token(seq, tok)
            if len(seq.generated) >= seq.max_new_tokens:
                ev = TokenEvent(seq.rid, tok, True, "length")
                self._record_completion(seq, "length")
                self.scheduler.finish(seq, "length")
            else:
                ev = TokenEvent(seq.rid, tok, False)
            events.append(ev)
            self._events_by_rid[seq.rid].append(ev)
        return events

    # -- bookkeeping ------------------------------------------------------
    def _finish_event(self, seq: Sequence, reason: str,
                      already_finished: bool = False) -> TokenEvent:
        if not already_finished:
            self.scheduler.finish(seq, reason)
        self._record_completion(seq, reason)
        ev = TokenEvent(seq.rid, -1, True, reason)
        self._events_by_rid.setdefault(seq.rid, []).append(ev)
        return ev

    def _record_completion(self, seq: Sequence, reason: str):
        self._generators.pop(seq.rid, None)
        self._completions.append(Completion(seq.rid, list(seq.prompt),
                                            list(seq.generated), reason))

    @property
    def engine_stats(self) -> dict:
        """One merged host-side view (engine + scheduler + block pool)."""
        return {**self.stats, **self.scheduler.stats,
                "kv_utilization": round(self.blocks.utilization(), 4),
                "kv_page_bytes": self.kv_page_bytes,
                "kv_bytes_in_use": self.blocks.bytes_in_use(),
                **{f"blocks_{k}": v for k, v in self.blocks.stats.items()}}
