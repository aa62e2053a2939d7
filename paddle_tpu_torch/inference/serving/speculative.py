"""Speculative decoding over the paged engine: draft-propose, verify in
the engine's tick, greedy-accept — the port of
`paddle_tpu/inference/serving/speculative.py`.

A small draft model proposes ``k`` tokens per tick for each greedy
decode-ready sequence; the engine widens that sequence's chunk from 1 to
``k + 1`` tokens, so one forward verifies every proposal, and reads the
target's argmax at every packed row. Greedy verification accepts the
longest proposal prefix that matches the target's own argmax and always
emits one bonus token, so the stream is the one plain greedy decode
gives: a wrong draft costs acceptance, never correctness. That holds on
the card because a row's logits bits do not depend on the tick it sits
in (`engine.py`'s geometry; A5's spans, `ops/cuda/paged_attention.py`).

The draft shares the engine's paging: its own caches
[L_d, num_blocks, KV_d, block_size, hd_d], indexed by the engine's block
ids, so paging, copy-on-write and preemption need no second allocator:

- a sequence's draft progress is tagged with ``seq.preemptions``: a
  preempted sequence's draft KV is recomputed by the catch-up pass, as
  the target recomputes;
- the engine's copy-on-write page copies are mirrored into the draft
  caches;
- catch-up runs chunks of ``token_budget`` tokens, proposals one token
  at a time; both go through `paged_block_attention` (A5 on the
  card) and the FFN as `inference.quant.ffn_param` routes the draft's
  leaves (A3 or A6; the plain chain for w8a8 and fp8), eagerly.

The draft's leaves may be quantized: a slice of a quantized target's
leaves (or `quantize_llama_params` output) runs the same products as
the target's engine.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models import llama as L
from ...ops.kernels.serving_attention import (paged_block_attention,
                                              paged_metadata, rope_table)
from .. import quant as Q

__all__ = ["DraftModel", "DEFAULT_SPEC_K"]

DEFAULT_SPEC_K = 4      # FLAGS_spec_k's default


class DraftModel:
    """The proposer half of speculative decoding. Construct with the
    draft config and params, attach with
    ``PagedServingEngine(..., draft=DraftModel(dcfg, dparams))`` (the
    engine calls :meth:`bind`, which puts the params on the engine's
    device; tensors already there are used as they are, so a draft may
    share the target's). The draft must share the target's vocabulary;
    its layers, width and heads may be smaller."""

    def __init__(self, cfg: L.LlamaConfig, params: Dict):
        self.cfg = cfg
        self.params = params
        self.engine = None
        self._kc: Optional[torch.Tensor] = None
        self._vc: Optional[torch.Tensor] = None
        self._rope: Optional[torch.Tensor] = None
        self._layers: List[Dict[str, torch.Tensor]] = []
        self._chunk = 0
        # rid -> (draft tokens computed, seq.preemptions epoch)
        self._state: Dict[int, Tuple[int, int]] = {}
        # rid -> (num_computed at propose, k) awaiting commit
        self._pending: Dict[int, Tuple[int, int]] = {}
        self.stats = {"draft_steps": 0, "ticks": 0, "proposed": 0,
                      "accepted": 0, "bonus": 0, "catchup_tokens": 0,
                      "proposals": 0, "propose_s": 0.0}

    # -- engine attachment -------------------------------------------------
    def bind(self, engine) -> "DraftModel":
        """Adopt the engine's paged geometry and device: draft caches
        [L_d, num_blocks, KV_d, block_size, hd_d], indexed by the block
        ids the engine's BlockManager hands out."""
        if self.cfg.vocab_size != engine.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {self.cfg.vocab_size} != target vocab "
                f"{engine.cfg.vocab_size}: greedy verification compares "
                f"token ids, the vocabularies must match")
        if self.cfg.max_seq_len < engine.max_len:
            raise ValueError(
                f"draft max_seq_len {self.cfg.max_seq_len} < engine "
                f"max_len {engine.max_len}: the draft must cover every "
                f"position the target serves")
        self.engine = engine
        cfg, dev = self.cfg, engine.device
        self.params = L.params_to_device(self.params, dev)
        self._layers = [L.layer(self.params, i)
                        for i in range(cfg.num_layers)]
        shape = (cfg.num_layers, engine.num_blocks, cfg.num_kv_heads,
                 engine.block_size, cfg.head_dim)
        self._kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self._vc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        cos, sin = L.rope_cos_sin(torch.arange(engine.max_len, device=dev),
                                  cfg.head_dim, cfg.rope_theta)
        self._rope = rope_table(cos, sin)
        self._chunk = max(1, int(engine.token_budget))
        return self

    # -- the draft step ----------------------------------------------------
    def _run(self, toks: np.ndarray, table: np.ndarray, start: int,
             n: int, logits: bool) -> Optional[int]:
        """One draft forward over `toks` (n live of len(toks)) at
        positions start.. of one sequence; with `logits`, the argmax of
        row n - 1 (the tick's one sync)."""
        cfg, eng = self.cfg, self.engine
        meta = paged_metadata(np.asarray([0, n]), np.asarray([start]),
                              np.asarray([n]), table, len(toks),
                              eng.block_size, self._rope)
        tokens = torch.from_numpy(np.asarray(toks, np.int64)).to(eng.device)
        x = self.params["embed"][tokens].to(cfg.dtype)
        for i, lp in enumerate(self._layers):
            h = L.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
            qkv = torch.cat([Q.matmul_param(h, lp, w)
                             for w in ("wq", "wk", "wv")], -1)
            o = paged_block_attention(qkv, self._kc[i], self._vc[i], meta)
            x = x + Q.matmul_param(o, lp, "wo")
            h = L.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
            x = x + Q.ffn_param(h, lp)
        self.stats["draft_steps"] += 1
        if not logits:
            return None
        h = L.rms_norm(x[n - 1:n], self.params["final_norm"], cfg.rms_eps)
        out = Q.matmul_param(h, self.params, "lm_head").float()
        return int(torch.argmax(out[0]))

    # -- propose / commit --------------------------------------------------
    def propose(self, seq, k: int) -> List[int]:
        """Draft k tokens for a decode-ready sequence. The caller has
        already grown the block table to cover ``len(tokens) + k``
        positions. Catch-up recomputes any draft-KV gap first — after a
        preemption the whole sequence, as the target recomputes; writes
        into prefix-shared pages are benign, since draft KV is a function
        of the token chain alone."""
        t0 = time.perf_counter()
        eng = self.engine
        rid = seq.rid
        c = seq.num_computed
        st = self._state.get(rid)
        dc = 0
        if st is not None and st[1] == seq.preemptions and st[0] <= c:
            dc = st[0]
        row = eng.blocks.block_table(rid)
        table = np.full((1, eng.max_blocks_per_seq), -1, np.int32)
        table[0, :len(row)] = row
        pos = dc
        while pos < c:
            m = min(self._chunk, c - pos)
            toks = np.zeros((self._chunk,), np.int64)
            toks[:m] = seq.tokens[pos:pos + m]
            self._run(toks, table, pos, m, logits=False)
            self.stats["catchup_tokens"] += m
            pos += m
        props: List[int] = []
        tok = int(seq.tokens[c])
        for _ in range(int(k)):
            tok = self._run(np.asarray([tok]), table, pos, 1, logits=True)
            props.append(tok)
            pos += 1
        self._pending[rid] = (c, int(k))
        self.stats["proposals"] += int(k)
        self.stats["propose_s"] += time.perf_counter() - t0
        return props

    def commit(self, seq, accepted: int) -> None:
        """Record verified progress: draft KV is valid through the last
        position whose input token the target confirmed."""
        pend = self._pending.pop(seq.rid, None)
        if pend is None:
            return
        c, k = pend
        self._state[seq.rid] = (c + 1 + min(int(accepted), k - 1),
                                seq.preemptions)

    def forget(self, rid: int) -> None:
        self._state.pop(rid, None)
        self._pending.pop(rid, None)

    # -- paged-KV mirroring ------------------------------------------------
    def copy_blocks(self, pairs) -> None:
        """Mirror the engine's copy-on-write page copies into the draft
        caches."""
        src = torch.tensor([s for s, _ in pairs], device=self._kc.device)
        dst = torch.tensor([d for _, d in pairs], device=self._kc.device)
        for t in (self._kc, self._vc):
            t[:, dst] = t[:, src]

    # -- accounting --------------------------------------------------------
    def record_tick(self, proposed: int, accepted: int) -> None:
        self.stats["ticks"] += 1
        self.stats["proposed"] += int(proposed)
        self.stats["accepted"] += int(accepted)
        self.stats["bonus"] += 1

    @property
    def acceptance_rate(self) -> float:
        p = self.stats["proposed"]
        return round(self.stats["accepted"] / p, 4) if p else 0.0
