"""LLaMA-family decoder in PyTorch — the port of `paddle_tpu/models/llama.py`.

Parameters are a plain dict shaped like the reference's pytree, so the
same arrays go through both packages: ``{"embed" [V, d], "blocks":
{name: [L, ...]}, "final_norm" [d], "lm_head" [d, V]}``. Weights are
``[in, out]`` and block leaves are stacked on a leading layer axis, as
in the reference. :func:`params_from_numpy` carries the reference's
weights over.

Attention and the FFN always go through the differentiable kernel
pairs, A1/A2 (`ops/cuda/flash_attention.py`) and A3/A4
(`ops/cuda/fused_ffn.py`): CUDA tensors launch the kernels and an
unsupported shape raises; CPU tensors run the kernels' plain versions,
which are this module's plain path. The reference's `attn_impl` /
`ffn_impl` switches (attention's "auto" with its XLA einsum fallback,
the FFN's "stock" three matmuls) are not ported: nothing selects a path
that skips the kernels on the card. The training step
(`distributed/hybrid.py`) runs `loss_fn`; the serving engine runs the
same blocks with the paged attention and fused FFN kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve
from ..ops.cuda import flash_attention as _fa
from ..ops.cuda import fused_ffn as _ff

__all__ = ["LlamaConfig", "CONFIGS", "init_params", "params_from_numpy",
           "rms_norm", "rope_cos_sin", "apply_rope", "attention", "ffn",
           "block", "layer", "forward", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The reference's config with torch dtypes, dense models only (the
    reference's MoE fields come with the MoE slice)."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def _attn_params(self) -> int:
        d, hd = self.hidden_size, self.head_dim
        return (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)

    def num_params(self) -> int:
        d, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = self._attn_params() + 3 * d * f + 2 * d
        return v * d + self.num_layers * per_layer + d + d * v

    def flops_per_token(self) -> int:
        """Approximate training FLOPs per token, 6 x the matmul
        parameters (forward and backward), as the reference counts them
        (`paddle_tpu/models/llama.py:62`); attention scores are left out."""
        mlp = 3 * self.hidden_size * self.intermediate_size
        dense = (self.num_layers * (self._attn_params() + mlp)
                 + 2 * self.hidden_size * self.vocab_size)
        return 6 * dense


# the reference's predefined sizes (paddle_tpu/models/llama.py:74)
CONFIGS = {
    "llama-test": LlamaConfig(vocab_size=256, hidden_size=64,
                              intermediate_size=128, num_layers=4,
                              num_heads=4, num_kv_heads=2, max_seq_len=128),
    "llama-7b": LlamaConfig(hidden_size=4096, intermediate_size=11008,
                            num_layers=32, num_heads=32, num_kv_heads=32),
    "llama-13b": LlamaConfig(hidden_size=5120, intermediate_size=13824,
                             num_layers=40, num_heads=40, num_kv_heads=40),
}


def _shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd, nh, nkv, L = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, \
        cfg.num_layers
    blocks = {"wq": (L, d, nh * hd), "wk": (L, d, nkv * hd),
              "wv": (L, d, nkv * hd), "wo": (L, nh * hd, d),
              "w1": (L, d, f), "w3": (L, d, f), "w2": (L, f, d)}
    return {"embed": (v, d), "blocks": blocks, "lm_head": (d, v)}


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None
                ) -> Dict[str, Any]:
    """Random parameters N(0, 0.02), norms at one, drawn from `generator`
    (which must live on `device`). `dtype` defaults to cfg.param_dtype;
    each leaf is drawn in f32 on the device and cast, so a bf16 LLaMA-7B
    never holds more than one f32 leaf at a time."""
    dev = resolve(device)
    dtype = dtype or cfg.param_dtype

    def normal(shape):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)

    shapes = _shapes(cfg)
    L, d = cfg.num_layers, cfg.hidden_size
    blocks = {name: normal(shape) for name, shape in shapes["blocks"].items()}
    blocks["attn_norm"] = torch.ones((L, d), dtype=dtype, device=dev)
    blocks["mlp_norm"] = torch.ones((L, d), dtype=dtype, device=dev)
    return {"embed": normal(shapes["embed"]), "blocks": blocks,
            "final_norm": torch.ones((d,), dtype=dtype, device=dev),
            "lm_head": normal(shapes["lm_head"])}


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """The reference's parameter pytree (nested dicts of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's dict of tensors
    on `device`. Floating leaves are cast to `dtype` when given; arrays
    numpy cannot hand to torch directly (bfloat16) go through float32."""
    dev = resolve(device)

    def conv(a):
        a = np.array(a)                       # a writable copy for torch
        if a.dtype.kind not in "biuf":        # e.g. ml_dtypes bfloat16
            a = a.astype(np.float32)
        t = torch.from_numpy(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return conv(node)

    return walk(tree)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * w.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [T] int -> (cos, sin) [T, head_dim/2] in f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, hd]; rotate-half convention, f32 math."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal MHA/GQA: q [B,T,H,hd], k/v [B,T,KV,hd] -> [B,T,H,hd],
    through the flash attention kernel pair (A1 forward, A2 backward)."""
    return _fa.flash_attention(q, k, v, causal=True)


def ffn(h: torch.Tensor, lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """SwiGLU FFN over normed activations h [..., d], through the fused
    kernel pair (A3 forward, A4 backward) on the weights cast to h's
    type, as the reference casts them."""
    d = h.shape[-1]
    out = _ff.FusedFFN.apply(h.reshape(-1, d),
                             *(lp[n].to(h.dtype) for n in ("w1", "w3", "w2")))
    return out.reshape(h.shape)


def block(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: LlamaConfig,
          cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One transformer block; lp leaves have the layer axis indexed."""
    B, T, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = (h @ lp["wq"].to(h.dtype)).reshape(B, T, nh, hd)
    k = (h @ lp["wk"].to(h.dtype)).reshape(B, T, nkv, hd)
    v = (h @ lp["wv"].to(h.dtype)).reshape(B, T, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attention(q, k, v).reshape(B, T, nh * hd)
    x = x + o @ lp["wo"].to(o.dtype)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + ffn(h, lp)


def layer(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's block leaves (views into the stacked tensors)."""
    return {k: v[i] for k, v in params["blocks"].items()}


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: LlamaConfig, remat: bool = False) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] (f32). remat=True
    recomputes each block in the backward (`torch.utils.checkpoint`,
    non-reentrant) instead of keeping its activations, as the
    reference's `jax.checkpoint` of the block body does."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    T = tokens.shape[1]
    cos, sin = rope_cos_sin(torch.arange(T, device=tokens.device),
                            cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.num_layers):
        args = (x, layer(params, i), cfg, cos, sin)
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, *args,
                                                  use_reentrant=False)
        else:
            x = block(*args)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"].to(x.dtype)).float()


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor,
            targets: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy, mean over tokens."""
    logits = forward(params, tokens, cfg, remat)
    logz = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - true).mean()
