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
  weights (`quant_mode="w8"`), which it reads as int8; under `w8a8`
  and `fp8` the reference's plain chain of products instead
  (`inference.quant.ffn_param`), as no kernel serves those leaves;
- the sampler prep (A7) once per tick, on every tick (the reference runs
  its Pallas sampler on decode ticks only).

Quantized serving follows the reference (`engine.py:161-196`,
`:287-309`): `quant_mode` "w8", "w8a8" or "fp8" quantizes the block
matmuls and the lm_head after the weights are stored in `weight_dtype`
(scales stay f32); q/k/v/o and the lm_head run
`inference.quant.matmul_param`, a plain product as in the reference (w8
and fp8: the weight cast to the compute type; w8a8: int8 activations
from the manifest's static scales, an int8 x int8 -> int32 product).
`w8a8` and `quant_kv=True` need a calibration manifest: its per-(layer,
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

Every tick runs its row-wise work (embedding, norms, the q/k/v/o and
lm_head products, the LoRA deltas, the FFN) at one row count,
`token_budget`, whatever its kind: a decode-fast-path tick pads its
`max_batch` tokens to `token_budget` rows and launches only attention at
`max_q = 1` over the live rows. So a token's logits bits do not depend
on the tick it sits in: a decode row of a decode tick, of a mixed tick
and a row of a speculative verify chunk give the same bits on the card
(cuBLAS may pick another kernel, or split K, for another M; A5 walks
every row alike, `ops/cuda/paged_attention.py`; A3 at up to 64 rows
takes one tile, so `token_budget` must stay <= 64 for its part). Router
failover, speculative decoding and mixed-adapter batches rest on this.

The decode fast path is captured: the reference compiles each tick
signature into one executable (`engine.py:573` `_build_step`); here the
first all-decode tick on the card for each set of active LoRA rank
classes warms up and captures the forward and A7 over static buffers
into one CUDA graph (`ops/cuda/graphs.py`), and every later decode tick
copies its host arrays into those buffers (from pinned host tensors) and
replays it. The page-append lists, one entry per live token, are padded
to `max_batch` by repeating the first entry's write (the same value into
the same slot), so one graph serves any number of live sequences and
the page pool keeps its size. Mixed (prefill) and speculative ticks run
eagerly; the draw and the tick's one sync follow. A capture or replay
failure raises. On the CPU the same static-buffer tick runs eagerly.

LoRA adapters (`adapters.py`): ``submit(adapter=...)`` pins a registered
adapter; each tick loads the batch's adapters into device slots and
gives every active rank class a [rows, slots] selector holding
alpha/rank at an adapter row's slot and 0 elsewhere. q, k, v and o take
``y += sum_s ((h A_s) B_s) sel_s`` in f32, as the reference's einsums;
a base row's delta is exactly 0.0. The packs and the decode tick's
selectors are static tensors, written in place, so only a new set of
rank classes captures again.

Speculative decoding (`speculative.py`, ``draft=``): a greedy decode row
is widened by up to ``spec_k`` draft tokens; the tick (mixed, eager)
reads the target's argmax at every row and keeps the longest matching
prefix plus one token — the plain greedy stream, more of it a tick.

Chaos site ``serving`` (`distributed/fault_tolerance/chaos.py`) is called
at the start of every tick. Page migration (`extract_pages`,
`ingest_pages`) carries a prompt's full-block pages between replicas
for disaggregated serving (`disagg.py`). Left for later slices: tracing
spans, tuned profiles and the `FLAGS_quant_*` defaults.
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
from . import adapters as AD
from . import speculative as SP
from .block_manager import BlockManager, NoFreeBlocksError
from .scheduler import (DEFAULT_MAX_QUEUE, DeadlineExceededError,
                        RejectedError, Scheduler, Sequence)

__all__ = ["PagedServingEngine", "TokenEvent", "Completion",
           "RejectedError", "DeadlineExceededError", "set_chaos_hook"]

# chaos hook (site "serving"): installed by
# distributed/fault_tolerance/chaos.py while a spec is active
_CHAOS_HOOK = [None]


def set_chaos_hook(fn):
    _CHAOS_HOOK[0] = fn


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("bfloat16" for torch.bfloat16), as
    the reference names its cache dtype in a page payload."""
    return str(dtype).removeprefix("torch.")


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

    Quantized serving: ``quant_mode`` "w8" serves weight-only int8
    matmuls, "w8a8" int8 x int8 products with static activation scales,
    "fp8" weight-only float8_e4m3fn; ``quant_kv=True`` int8 KV pages.
    "w8a8" and ``quant_kv`` need ``quant_manifest`` (a
    :class:`~..quant.QuantManifest` or its path, from
    `inference.quant.calibrate`). ``cache_dtype`` may only restate
    the page type: int8 with ``quant_kv``, cfg.dtype without.

    ``adapter_slots``: device slots per LoRA rank class (``adapters``, an
    :class:`~.adapters.AdapterManager`, registers adapters). ``draft``: a
    :class:`~.speculative.DraftModel` (or a (cfg, params) pair) for
    speculative decoding, ``spec_k`` tokens proposed a tick (0: off).
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
                 quant_manifest=None,
                 adapter_slots: int = AD.DEFAULT_SLOTS,
                 draft=None, spec_k: int = SP.DEFAULT_SPEC_K,
                 device=None):
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
            # only fp and w8 leaves reach the fused FFN (A3, A6)
            if quant_mode in ("", "w8") and not FF.supported(
                    cfg.hidden_size, cfg.intermediate_size,
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
                      "mixed_steps": 0, "graph_captures": 0,
                      "spec_ticks": 0, "spec_proposed": 0,
                      "spec_accepted": 0}
        # LoRA adapters: slot packs allocate on a class's first adapter;
        # their bytes join the pool's gauges (the router's tiebreak)
        self.adapters = AD.AdapterManager(cfg, slots=adapter_slots,
                                          device=self.device)
        self.blocks.extra_bytes = lambda: (self.adapters.bytes_in_use(),
                                           self.adapters.bytes_total())
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
        # are padding) and the rid of each live row: what tests and the
        # card check hold against; after a captured tick it is the
        # graph's output, rewritten by the next. A speculative tick also
        # keeps every packed row's logits [token_budget, V] and each
        # row's offset (`last_cu`)
        self.last_logits: Optional[torch.Tensor] = None
        self.last_rids: List[int] = []
        self.last_all_logits: Optional[torch.Tensor] = None
        self.last_cu: Optional[np.ndarray] = None
        self._alloc_decode()
        # captured decode ticks, one per set of active LoRA rank classes
        self._dec_graphs: Dict[Tuple[int, ...], CapturedGraph] = {}
        self.spec: Optional[SP.DraftModel] = None
        self.spec_k = int(spec_k)
        if draft is not None:
            self.spec = (draft if isinstance(draft, SP.DraftModel)
                         else SP.DraftModel(*draft))
            self.spec.bind(self)

    # -- client API -------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, priority: int = 0,
               deadline_s: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               seed: int = 0, adapter: Optional[str] = None) -> int:
        """Enqueue a request. Raises ValueError when it cannot ever fit,
        RejectedError (load shed) when the wait queue is full,
        :class:`~.adapters.AdapterMissingError` when ``adapter`` names an
        unregistered LoRA adapter (pinned while the request is live)."""
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
        if adapter is not None:
            # pinned before enqueue (an unknown name moves no count);
            # unpinned on every completion path (_record_completion)
            self.adapters.pin(adapter)
            seq.adapter = adapter
        try:
            self.scheduler.add_request(seq)   # RejectedError on overflow
        except BaseException:
            if adapter is not None:
                seq.adapter = None
                self.adapters.unpin(adapter)
            raise
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

    # -- cross-replica page migration (serving/disagg.py) ------------------
    def extract_pages(self, tokens) -> Optional[Dict[str, object]]:
        """Host copy of the full-block prefix pages covering `tokens`: the
        payload a prefill replica ships to a decode replica (`disagg.py`
        packs it), in the reference's layout, k / v [L, n, KV, bs, hd]
        and, on int8-page engines, kdq / vdq [L, n, KV]. None when this
        pool cannot serve the whole chain (never a partial payload: the
        receiver recomputes instead). bf16 pages travel as their 16-bit
        patterns (numpy has no bf16), with ``"dtype": "bfloat16"``."""
        chain = self.blocks.prefix_chain(tokens)
        if not chain:
            return None
        blks = self.blocks.chain_blocks(chain)
        if blks is None:
            return None
        ids = torch.tensor(blks, dtype=torch.long, device=self.device)

        def host(t):
            t = t.index_select(1, ids)
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            return t.cpu().numpy()

        out: Dict[str, object] = {
            "chain": [(int(d), int(h)) for d, h in chain],
            "tokens": [int(t) for t in tokens][:chain[-1][0]],
            "dtype": _dtype_name(self.cache_dtype),
            "k": host(self._key_cache), "v": host(self._value_cache)}
        if self.quant_kv:
            out["kdq"], out["vdq"] = (host(t) for t in self._kv_dequant)
        return out

    def ingest_pages(self, payload: Dict[str, object]) -> int:
        """Adopt migrated pages into this engine's pool. They park in the
        prefix cache like locally computed freed-but-cached pages, so the
        next ``allocate_sequence`` over the same prompt hits them. The
        pages (and on int8-page engines their dequant rows) are written
        into the pool in place: the captured decode tick holds the pool's
        address and reads what lands there. Returns the pages adopted (0:
        all already present). Raises ValueError on a cache geometry or
        dtype mismatch (pools of other shapes recompute instead)."""
        mine = _dtype_name(self.cache_dtype)
        if payload["dtype"] != mine:
            raise ValueError(
                f"migrated pages are {payload['dtype']} but this engine "
                f"caches {mine}: recompute instead of adopting across "
                f"cache dtypes")
        k, v = payload["k"], payload["v"]
        L_, _, kvh, bs, hd = self._key_cache.shape
        want = (L_, kvh, bs, hd)
        got = (k.shape[0],) + tuple(k.shape[2:])
        if got != want or k.shape != v.shape:
            raise ValueError(
                f"migrated page geometry {got} != engine cache {want}: "
                f"pools must share [L, KV, block_size, hd] to adopt pages")
        chain = payload["chain"]
        toks = payload["tokens"]
        adopted: List[Tuple[int, int]] = []   # (payload row, block id)
        # Adopted pages park at the young end of the cached-free LRU, and a
        # take reclaims from the old end: only the blocks free or parked on
        # entry can be taken without reclaiming a page adopted in this call
        # (two chain pages in one block, one of them over the other's K/V).
        room = self.blocks.num_free()
        for idx, (depth, h) in enumerate(chain):
            if len(adopted) == room:
                break   # pool full: keep what landed so far
            prev_h = 0 if idx == 0 else int(chain[idx - 1][1])
            chunk = toks[depth - self.block_size:depth]
            blk = self.blocks.adopt_page(int(h), prev_h, chunk)
            if blk is not None:
                adopted.append((idx, blk))
        if not adopted:
            return 0
        rows = np.asarray([r for r, _ in adopted], np.int64)
        ids = torch.tensor([b for _, b in adopted], dtype=torch.long,
                           device=self.device)

        def put(dst, src):
            t = torch.from_numpy(np.ascontiguousarray(src[:, rows]))
            if dst.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            dst.index_copy_(1, ids, t.to(self.device, dst.dtype))

        put(self._key_cache, k)
        put(self._value_cache, v)
        if self.quant_kv and "kdq" in payload:
            put(self._kv_dequant[0], payload["kdq"])
            put(self._kv_dequant[1], payload["vdq"])
        return len(adopted)

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
        """Copy-on-write page copies, every layer and both sides at once
        (mirrored into the draft's caches)."""
        src = torch.tensor([s for s, _ in pairs], device=self.device)
        dst = torch.tensor([d for _, d in pairs], device=self.device)
        for t in (self._key_cache, self._value_cache, *self._kv_dequant):
            t[:, dst] = t[:, src]   # int8 pages' scale rows move with them
        if self.spec is not None:
            self.spec.copy_blocks(pairs)
        self.stats["cow_block_copies"] += len(pairs)

    def _lora(self, h, y, i: int, target: str, lora) -> torch.Tensor:
        """y plus layer i's LoRA delta on `target` for every active rank
        class: u = h A, w = u B per slot, in f32, summed over the slots by
        the [rows, slots] selector (alpha/rank at a row's slot, else 0)."""
        for sel, packs in lora:
            A, Bm = packs[target]
            u = torch.einsum("td,sdr->tsr", h.float(), A[i])
            w = torch.einsum("tsr,sro->tso", u, Bm[i])
            y = y + torch.einsum("tso,ts->to", w, sel).to(y.dtype)
        return y

    def _forward(self, tokens, meta, last_idx, lora=(),
                 spec: bool = False):
        """The tick's forward: packed tokens [token_budget] -> f32 logits
        of each batch slot's last token [max_batch, V] (and, for a
        speculative tick, of every packed row [token_budget, V]). Every
        row-wise op runs at token_budget rows (the module docstring);
        attention reads meta's rows. `lora`: (selector, packs) of each
        active rank class."""
        cfg = self.cfg
        # weights meet activations in the compute type: matmul_param casts
        # fp weights (no copy when equal) and int8 or fp8 ones, or rounds
        # the activations to int8 (w8a8); the FFN kernels take int8
        # weights as they are
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
            qkv = torch.cat([self._lora(h, Q.matmul_param(h, lp, n), i, n,
                                        lora)
                             for n in ("wq", "wk", "wv")], -1)
            o = block_multihead_attention_(qkv, self._key_cache[i],
                                           self._value_cache[i], meta,
                                           **scales)
            x = x + self._lora(o, Q.matmul_param(o, lp, "wo"), i, "wo",
                               lora)
            h = L.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
            x = x + Q.ffn_param(h, lp)
        if spec:
            h = L.rms_norm(x, self.params["final_norm"], cfg.rms_eps)
            every = Q.matmul_param(h, self.params, "lm_head").float()
            return every[last_idx], every
        # the batch slots' last rows, padded to token_budget rows with
        # row 0 for the norm and the product
        rows = torch.zeros(x.shape[0], dtype=last_idx.dtype,
                           device=x.device)
        rows[:last_idx.shape[0]] = last_idx
        h = L.rms_norm(x[rows], self.params["final_norm"], cfg.rms_eps)
        logits = Q.matmul_param(h, self.params, "lm_head").float()
        return logits[:last_idx.shape[0]], None

    def _tick(self, tokens, meta, last_idx, temps, top_ps, lora=(),
              spec: bool = False):
        """The tick's device work: the forward, then the sampler prep
        (A7). Returns (logits [max_batch, V] f32, masked logits, greedy
        tokens int32, every row's logits or None)."""
        logits, every = self._forward(tokens, meta, last_idx, lora, spec)
        masked, greedy = FS.fused_sample_prep(logits, temps, top_ps,
                                              self.top_k)
        return logits, masked, greedy, every

    def _lora_args(self, ad_sig: Tuple[int, ...], sels) -> tuple:
        return tuple((sels[cls], self.adapters.device_packs(cls))
                     for cls in ad_sig)

    def _decode_tick(self, ad_sig: Tuple[int, ...] = ()):
        """The decode fast path's tick over its static buffers
        (`_stage_decode` fills them): the function a captured graph
        holds, run eagerly. On the CPU every decode tick runs it; on the
        card the graph's warm-up, and the checks that hold a replay to
        it, do."""
        t = self._dec
        meta = metadata_from(t, self._rope_emb, max_q=1)
        return self._tick(t["tokens"], meta, t["last_idx"], t["temps"],
                          t["top_ps"], self._lora_args(ad_sig, t))[:3]

    def _replay_decode(self, ad_sig: Tuple[int, ...] = ()):
        """The decode tick on the card: the first call for a set of
        active rank classes warms up (one eager `_decode_tick` on the
        capture stream, whose results are this tick's) and captures its
        graph; later calls replay it. A failed capture or replay
        raises."""
        graph = self._dec_graphs.get(ad_sig)
        if graph is None:
            stream = torch.cuda.Stream(self.device)
            out = warm_up(lambda: self._decode_tick(ad_sig), stream)
            self._dec_graphs[ad_sig] = CapturedGraph(
                lambda: self._decode_tick(ad_sig), stream=stream)
            self.stats["graph_captures"] += 1
            return out
        return graph.replay()

    @property
    def _dec_graph(self) -> Optional[CapturedGraph]:
        """The adapter-free decode tick's graph (None until captured)."""
        return self._dec_graphs.get(())

    def _stage_decode(self, arrays: Dict[str, np.ndarray]):
        """Copy a decode tick's host arrays into the static buffers: on
        the card through pinned host tensors, with no new device tensor."""
        for k, a in arrays.items():
            self._dec_host[k].numpy()[...] = a.reshape(
                self._dec_host[k].shape)
        if self._dec_host is not self._dec:
            for k in arrays:
                self._dec[k].copy_(self._dec_host[k], non_blocking=True)

    def _alloc_decode(self):
        """The decode tick's static buffers: the per-token metadata and
        tokens at token_budget rows, the per-sequence fields at
        max_batch (write lists padded to max_batch), last_idx, temps and
        top_ps; the LoRA selectors, [token_budget, slots] a rank class,
        are added on a class's first use (`_dec_selector`). Host twins
        pinned on the card (on the CPU the buffers are their own host
        twins)."""
        B, T, mb = self.max_batch, self.token_budget, self.max_blocks_per_seq
        shapes = {k: (B,) for k in META_DTYPES}
        for k in ("tok_b", "tok_local", "tok_valid", "pos"):
            shapes[k] = (T,)
        shapes.update(row_tok=(B, 1), block_tables=(B, mb), tokens=(T,),
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

    def _dec_selector(self, cls: int) -> int:
        """The key of rank class `cls`'s static selector buffer in the
        decode tick's buffers (allocated on first use, before any graph
        reads it)."""
        if cls not in self._dec:
            shape = (self.token_budget, self.adapters.slots)
            cuda = self.device.type == "cuda"
            self._dec_host[cls] = torch.zeros(shape, dtype=torch.float32,
                                              pin_memory=cuda)
            if cuda:
                self._dec[cls] = torch.zeros(shape, dtype=torch.float32,
                                             device=self.device)
        return cls

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

    def _spec_plan(self, batch) -> Dict[int, List[int]]:
        """Widen each greedy decode-ready chunk by up to spec_k draft
        tokens, inside the token budget and the block pool."""
        plan: Dict[int, List[int]] = {}
        budget_left = self.token_budget - batch.total_tokens
        for i, (seq, n) in enumerate(batch.items):
            if budget_left < 1:
                break
            if (n != 1 or seq.temperature > 0.0
                    or seq.num_computed + 1 != len(seq.tokens)):
                continue
            k_eff = min(self.spec_k, budget_left,
                        seq.max_new_tokens - len(seq.generated) - 1)
            if k_eff < 1:
                continue
            try:
                self.blocks.ensure_capacity(seq.rid,
                                            len(seq.tokens) + k_eff)
            except NoFreeBlocksError:
                continue   # pool exhausted: this row goes unspeculated
            plan[i] = self.spec.propose(seq, k_eff)
            budget_left -= k_eff
        return plan

    def step(self) -> List[TokenEvent]:
        """One tick: schedule a mixed batch, run it, harvest tokens.
        Returns this tick's streamed events."""
        hook = _CHAOS_HOOK[0]
        if hook is not None:
            hook("step")
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

        # adapter residency for this tick: every adapter of the batch in
        # a device slot (loading or LRU-swapping as needed); the chaos
        # "adapter" site's evict reloads here, counted as a swap
        ad_hook = AD._CHAOS_HOOK[0]
        active: Dict[str, Tuple[int, int]] = {}
        for seq, _ in batch.items:
            name = seq.adapter
            if name is None or name in active:
                continue
            if ad_hook is not None and ad_hook("use", name=name) == "evict":
                self.adapters.evict_device(name)
            active[name] = self.adapters.ensure_loaded(name)
        ad_sig = tuple(sorted({cls for cls, _ in active.values()}))

        spec_plan = (self._spec_plan(batch)
                     if self.spec is not None and self.spec_k > 0 else {})
        T, B = self.token_budget, self.max_batch
        decode = not spec_plan and all(n == 1 for _, n in batch.items)
        tokens = np.zeros((T,), np.int64)
        cu = np.zeros((B + 1,), np.int64)
        dec_lens = np.zeros((B,), np.int32)
        this_lens = np.zeros((B,), np.int32)
        tables = np.full((B, self.max_blocks_per_seq), -1, np.int32)
        temps = np.ones((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        pos = 0
        for i, (seq, n) in enumerate(batch.items):
            chunk = seq.tokens[seq.num_computed:seq.num_computed + n]
            props = spec_plan.get(i)
            if props is not None:
                chunk = list(chunk) + props    # [t_c, d1..dk]: verify rows
                n = len(chunk)
            tokens[pos:pos + n] = chunk
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
        # per-class [token_budget, slots] selectors: an adapter row's slot
        # carries alpha/rank, everything else 0.0
        sels = {cls: np.zeros((T, self.adapters.slots), np.float32)
                for cls in ad_sig}
        for i, (seq, _) in enumerate(batch.items):
            if seq.adapter is not None:
                cls, slot = active[seq.adapter]
                sels[cls][cu[i]:cu[i + 1], slot] = \
                    self.adapters.get(seq.adapter).scaling

        dev = self.device
        last_idx = np.clip(cu[1:] - 1, 0, T - 1)
        every = None
        if decode:
            # fixed shapes: the page writes padded to max_batch, so the
            # captured tick serves any number of live sequences
            arrays = paged_metadata_arrays(
                cu, dec_lens, this_lens, tables, T, self.block_size,
                self.max_len, max_q=1, writes=B)
            arrays.update(tokens=tokens, last_idx=last_idx, temps=temps,
                          top_ps=top_ps)
            for cls in ad_sig:
                arrays[self._dec_selector(cls)] = sels[cls]
            self._stage_decode(arrays)
            logits, masked, greedy = (self._replay_decode(ad_sig)
                                      if dev.type == "cuda"
                                      else self._decode_tick(ad_sig))
        else:
            meta = paged_metadata(cu, dec_lens, this_lens, tables, T,
                                  self.block_size, self._rope_emb, max_q=T)
            lora = self._lora_args(ad_sig, {
                cls: torch.from_numpy(sels[cls]).to(dev) for cls in ad_sig})
            logits, masked, greedy, every = self._tick(
                torch.from_numpy(tokens).to(dev), meta,
                torch.from_numpy(last_idx).to(dev),
                torch.from_numpy(temps).to(dev),
                torch.from_numpy(top_ps).to(dev), lora, bool(spec_plan))
        self.last_logits = logits
        self.last_rids = [seq.rid for seq, _ in batch.items]
        self.last_all_logits, self.last_cu = every, cu
        nxt = self._draw(batch, masked, greedy)
        all_arg = None
        if every is not None:
            # the verify read: the target's argmax at every packed row,
            # fetched with the tick's tokens in its one sync
            both = torch.cat([nxt, torch.argmax(every, dim=-1)]).cpu()
            nxt, all_arg = both[:B].numpy(), both[B:].numpy()
        else:
            nxt = nxt.cpu().numpy()           # the tick's one sync point

        spec_extra = sum(len(p) for p in spec_plan.values())
        self.stats["steps"] += 1
        self.stats["decode_fast_steps" if decode else "mixed_steps"] += 1
        self.stats["tokens_computed"] += batch.total_tokens + spec_extra

        # harvest: a slot yields a token iff its chunk reached the end of
        # the sequence's current tokens (final prefill chunk or decode row)
        for i, (seq, n) in enumerate(batch.items):
            props = spec_plan.get(i)
            if props is not None:
                events.extend(self._harvest_spec(seq, props, int(cu[i]),
                                                 all_arg))
                continue
            self.scheduler.on_computed(seq, n)
            if seq.num_computed < len(seq.tokens):
                continue   # mid-prefill: logits row is not a next token
            events.extend(self._emit_token(seq, int(nxt[i])))
        return events

    def _emit_token(self, seq: Sequence, tok: int) -> List[TokenEvent]:
        """Append a generated token to seq; its event(s): the token, or a
        stop at eos (not surfaced), or the token finishing at length."""
        if seq.eos >= 0 and tok == seq.eos:
            self.scheduler.append_token(seq, tok)  # timestamps
            seq.generated.pop()                    # eos not surfaced
            seq.tokens.pop()
            return [self._finish_event(seq, "stop")]
        self.scheduler.append_token(seq, tok)
        if len(seq.generated) >= seq.max_new_tokens:
            ev = TokenEvent(seq.rid, tok, True, "length")
            self._record_completion(seq, "length")
            self.scheduler.finish(seq, "length")
        else:
            ev = TokenEvent(seq.rid, tok, False)
        self._events_by_rid[seq.rid].append(ev)
        return [ev]

    def _harvest_spec(self, seq: Sequence, props: List[int], base: int,
                      all_arg: np.ndarray) -> List[TokenEvent]:
        """Greedy-verify one widened decode chunk. Row ``base`` held the
        scheduled token, rows ``base+1..base+k`` the draft's proposals;
        ``all_arg[base+j]`` is the target's argmax given the chunk through
        row j. Accept the longest matching proposal prefix, then emit it
        and one bonus token: the stream plain greedy decode gives, more of
        it a tick. ``num_computed`` advances over verified rows only, so
        preemption recompute and prefix caching stay exact."""
        k = len(props)
        g = [int(all_arg[base + j]) for j in range(k + 1)]
        a = 0
        while a < k and props[a] == g[a]:
            a += 1
        self.spec.commit(seq, a)
        self.spec.record_tick(k, a)
        self.stats["spec_ticks"] += 1
        self.stats["spec_proposed"] += k
        self.stats["spec_accepted"] += a
        events: List[TokenEvent] = []
        for tok in props[:a] + [g[a]]:
            self.scheduler.on_computed(seq, 1)
            evs = self._emit_token(seq, tok)
            events.extend(evs)
            if evs[-1].finished:
                break
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
        if seq.adapter is not None:
            name, seq.adapter = seq.adapter, None   # unpin once
            self.adapters.unpin(name)
        if self.spec is not None:
            self.spec.forget(seq.rid)
        self._generators.pop(seq.rid, None)
        self._completions.append(Completion(seq.rid, list(seq.prompt),
                                            list(seq.generated), reason))

    @property
    def engine_stats(self) -> dict:
        """One merged host-side view (engine + scheduler + block pool)."""
        out = {**self.stats, **self.scheduler.stats,
               "kv_utilization": round(self.blocks.utilization(), 4),
               "kv_page_bytes": self.kv_page_bytes,
               "kv_bytes_in_use": self.blocks.bytes_in_use(),
               **{f"blocks_{k}": v for k, v in self.blocks.stats.items()},
               "adapters_resident": self.adapters.num_resident(),
               "adapter_bytes_in_use": self.adapters.bytes_in_use(),
               "adapter_swaps": self.adapters.stats["swaps"],
               "adapter_evictions": self.adapters.stats["evictions"]}
        if self.spec is not None:
            out["spec_acceptance_rate"] = self.spec.acceptance_rate
        return out
