"""The LLaMA training and eval steps, on one device or over a mesh of
processes — the port of `paddle_tpu/distributed/hybrid.py`.

`make_train_step(cfg, mesh_or_device)` (reference :443) returns
`step(params, opt_state, tokens, targets) -> (params, opt_state, loss)`;
`make_eval_step` (reference :534) returns `step(params, tokens,
targets) -> loss`, the same loss without gradients. Parameters are f32
master tensors in the port's dict layout (`models.llama`); compute runs
in `cfg.dtype`, each block casting its weights as the reference does.
The loss is the mean next-token cross entropy over every token of the
global batch. The optimizer is the reference's AdamW (:143-190):
global-norm clipping, bias correction and decoupled weight decay on
every leaf. Unlike the reference's functional, jitted step, these run
eagerly and update in place: `params` and `opt_state` are modified and
returned, so one copy of the master weights, the AdamW moments and the
gradients lives on each device.

**One device** (a device, or None: the card): with `num_microbatches`
= M the batch is cut into M row slices whose gradients are summed.

**A mesh** (`build_mesh(dp, pp, tp, cp)`: one process a rank, the axes
("dp", "pp", "cp", "tp") of `MESH_AXES`, groups from `distributed.mesh`;
NCCL on the card, gloo on the CPU): the reference's `shard_map`ped step,
rank by rank. Every rank passes the whole global batch [B, T] and the
step takes its block (rows over dp, the sequence over cp); params are
this rank's shards in the reference's layout (`shard_params`: block
leaves [1, L/pp, ...], Megatron TP over "tp", vocab-parallel embedding
and head, MoE experts over "dp"). Inside a step:
- TP + sequence parallelism (`_block_sp`): activations stay sequence-
  sharded over tp between blocks, all_gather(seq) before the
  column-parallel products, reduce_scatter(seq) after the row-parallel
  ones; attention on each shard through A1/A2 (or ring attention over
  cp > 1), the dense FFN through A3/A4 on f/tp;
- MoE (`_moe_ffn`): GShard top-k dispatch with a capacity of
  2·N·k/E a expert and all_to_all over dp; tokens past it are dropped
  and counted (`step.last_dropped`, a 0-d tensor);
- GPipe (`_make_shard_loss`): the reference's tick loop as it is: every
  stage runs all M + pp - 1 ticks, the masks are tensors, so every rank
  builds the same autograd graph and one backward covers the schedule
  with every rank issuing its collectives in the same order; one
  `ppermute` over pp a tick (a local copy at pp = 1);
- `sync_grads` sums a leaf's gradient over every axis it is replicated
  on (the embedding over pp too: only stage 0 uses it), and the
  gradient norm sums each leaf's squares over the axes it is sharded on
  (:517-522). `mesh.psum` transposes to psum, as the reference's psum
  does under `check_vma=False`, so the gradients are the reference's:
  tp·pp·cp (cp when above one) times the global loss's, a factor that
  AdamW's normalisation absorbs (`distributed/mesh.py`).
- The reported loss is the global batch's mean, on every rank.
The reference's `nn.Layer` path (`GenericHybridEngine`) comes with ROADMAP
item 7b: both factories raise for anything but a `LlamaConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..models import llama as L
from ..ops.ring_attention import ring_attention_shard
from . import collective as C
from . import mesh as M
from .mesh import Mesh

__all__ = ["AdamWConfig", "init_opt_state", "loss_and_grads",
           "make_train_step", "make_eval_step", "MESH_AXES", "build_mesh",
           "stack_pipeline", "unstack_pipeline", "param_specs",
           "shard_params", "unshard_params", "sync_grads", "moe_capacity"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable[[list], Any]]:
    """Leaves of a nested dict in sorted-key order (the order
    `jax.tree.flatten` uses) and a function that rebuilds the dict from
    a list of leaves."""
    if not isinstance(tree, dict):
        return [tree], lambda leaves: leaves[0]
    keys = sorted(tree)
    parts = [_flatten(tree[k]) for k in keys]

    def rebuild(leaves):
        out, i = {}, 0
        for k, (sub, rb) in zip(keys, parts):
            out[k] = rb(leaves[i:i + len(sub)])
            i += len(sub)
        return out

    return [leaf for sub, _ in parts for leaf in sub], rebuild


def init_opt_state(params) -> Dict[str, Any]:
    """AdamW moments m and v, f32 zeros shaped like params, and the step
    count (a host int32 scalar)."""
    leaves, rebuild = _flatten(params)

    def zeros():
        return rebuild([torch.zeros_like(p, dtype=torch.float32)
                        for p in leaves])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32)}


def _adamw_update(params, grads, opt, hp: AdamWConfig, global_sq_sum):
    """One AdamW step, the reference's formula (:157): grads scaled by
    min(1, clip / (|g| + 1e-6)) when hp.grad_clip is set, m and v
    updated, u = m̂ / (sqrt(v̂) + eps) + weight_decay * p, p -= lr * u.
    `global_sq_sum` is the sum of the squares of every gradient.

    In place, under no_grad: params, opt["m"] and opt["v"] are updated
    and the gradient tensors are scaled by the clip factor; returns
    (params, opt) with opt["step"] advanced."""
    lr = hp.lr
    step = int(opt["step"]) + 1
    ps, _ = _flatten(params)
    gs, _ = _flatten(grads)
    ms, _ = _flatten(opt["m"])
    vs, _ = _flatten(opt["v"])
    b1, b2 = hp.beta1, hp.beta2
    # bias corrections in f32, as the reference computes them
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    with torch.no_grad():
        scale = None
        if hp.grad_clip is not None:
            gnorm = torch.sqrt(torch.as_tensor(global_sq_sum,
                                               dtype=torch.float32))
            scale = torch.clamp(hp.grad_clip / (gnorm + 1e-6), max=1.0)
        for p, g, m, v in zip(ps, gs, ms, vs):
            g = g.float()
            if scale is not None:
                g.mul_(scale.to(g.device))
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
            u.add_(hp.weight_decay * p.float())
            p.copy_((p.float() - lr * u).to(p.dtype))
    opt["step"] = torch.tensor(step, dtype=torch.int32)
    return params, opt


def _check_microbatches(num_microbatches: int) -> None:
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got "
                         f"{num_microbatches}")


def _row_slices(B: int, num_microbatches: int) -> List[slice]:
    """The batch's rows cut into `num_microbatches` equal slices."""
    if B % num_microbatches:
        raise ValueError(f"batch {B} is not divisible by "
                         f"num_microbatches {num_microbatches}")
    bm = B // num_microbatches
    return [slice(i * bm, (i + 1) * bm) for i in range(num_microbatches)]


def loss_and_grads(params, tokens, targets, cfg: L.LlamaConfig,
                   num_microbatches: int = 1,
                   remat: Union[bool, str] = True, mesh=None):
    """(loss, grads) of the mean next-token cross entropy over every
    token of tokens/targets [B, T]: the batch is cut into
    `num_microbatches` equal row slices, each slice's loss (its mean
    over 1 / num_microbatches of the tokens) is differentiated on its
    own and the gradients are summed. grads has params' layout, f32.
    remat: True, False or "dots" (`models.llama.forward`).
    With a `Mesh`: params are this rank's shards, tokens / targets the
    global batch, and grads this rank's synced shards, as the mesh train
    step feeds them to AdamW (the reference's scale: module docstring)."""
    if mesh is not None:
        _member(mesh)
        tok, tgt = _local_batch(tokens, targets, mesh, num_microbatches,
                                cfg)
        loss, grads, _ = _mesh_loss_and_grads(
            _make_shard_loss(cfg, num_microbatches, mesh, remat),
            param_specs(cfg), mesh, params, tok, tgt)
        return loss, grads
    leaves, rebuild = _flatten(params)
    grads, loss = None, None
    for rows in _row_slices(tokens.shape[0], num_microbatches):
        live = [p.detach().requires_grad_() for p in leaves]
        part = L.loss_fn(rebuild(live), tokens[rows], targets[rows], cfg,
                         remat) / num_microbatches
        gs = torch.autograd.grad(part, live)
        if grads is None:
            grads, loss = list(gs), part.detach()
        else:
            for a, b in zip(grads, gs):
                a.add_(b)
            loss = loss + part.detach()
    return loss, rebuild(grads)


def _llama_only(cfg, factory: str) -> None:
    if not isinstance(cfg, L.LlamaConfig):
        raise NotImplementedError(
            f"{factory} takes a LlamaConfig; the reference's nn.Layer path "
            f"(GenericHybridEngine) comes with ROADMAP item 7b, got "
            f"{type(cfg).__name__}")


def _checked_inputs(params, tokens, targets, dev):
    if any(p.device.type != dev.type for p in _flatten(params)[0]):
        raise ValueError(f"params must live on {dev}")
    return tokens.to(dev), targets.to(dev)


# ---------------------------------------------------------------------------
# the mesh and the sharded layout (reference :61-141)
# ---------------------------------------------------------------------------

MESH_AXES = ("dp", "pp", "cp", "tp")


def build_mesh(dp: int = 1, pp: int = 1, tp: int = 1, cp: int = 1,
               device=None) -> Mesh:
    """The dp x pp x cp x tp mesh over the first dp·pp·cp·tp ranks of
    the world (forming the default group if there is none: a world of
    one without a launcher), on `device` (the card unless the caller
    names the CPU). Every rank of the world calls it; ranks past the mesh
    get one they are not members of."""
    return M.build([("dp", dp), ("pp", pp), ("cp", cp), ("tp", tp)], device)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_pipeline(params, pp: int):
    """Block leaves [L, ...] -> [pp, L/pp, ...] (stage-major)."""
    def f(x):
        if x.shape[0] % pp:
            raise ValueError(f"num_layers {x.shape[0]} is not divisible by "
                             f"pp {pp}")
        return x.reshape(pp, x.shape[0] // pp, *x.shape[1:])
    return dict(params, blocks=_map(f, params["blocks"]))


def unstack_pipeline(params):
    """Block leaves [pp, L/pp, ...] -> [L, ...]."""
    def f(x):
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
    return dict(params, blocks=_map(f, params["blocks"]))


def param_specs(cfg: L.LlamaConfig) -> Dict[str, Any]:
    """Each leaf's layout over the mesh, one entry a dim (an axis name or
    None; the reference's PartitionSpecs): block leaves carry the leading
    pp stage dim; wq / wk / wv / w1 / w3 are tp-sharded on their output
    dim, wo / w2 on their input dim; embed and lm_head are
    vocab-parallel; MoE experts are sharded over dp (the ep axis)."""
    blocks = {"wq": ("pp", None, None, "tp"), "wk": ("pp", None, None, "tp"),
              "wv": ("pp", None, None, "tp"), "wo": ("pp", None, "tp", None),
              "attn_norm": ("pp", None, None),
              "mlp_norm": ("pp", None, None)}
    if cfg.num_experts:
        blocks.update(router=("pp", None, None, None),
                      w1=("pp", None, "dp", None, "tp"),
                      w3=("pp", None, "dp", None, "tp"),
                      w2=("pp", None, "dp", "tp", None))
    else:
        blocks.update(w1=("pp", None, None, "tp"), w3=("pp", None, None, "tp"),
                      w2=("pp", None, "tp", None))
    return {"embed": ("tp", None), "blocks": blocks, "final_norm": (),
            "lm_head": (None, "tp")}


def _member(mesh: Mesh) -> None:
    if not mesh.is_member:
        raise ValueError(f"rank {C.get_rank()} is not in the mesh {mesh}")


def shard_params(params, mesh: Mesh, cfg: L.LlamaConfig):
    """This rank's shards of the full parameter tree (tensors or arrays,
    any device), stage-stacked as the reference lays them out, as f32
    copies on the mesh's device."""
    _member(mesh)

    def f(x, spec):
        t = torch.as_tensor(x)
        for d, a in enumerate(spec):
            if a is None:
                continue
            n = mesh.shape[a]
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of a {tuple(t.shape)} leaf is not "
                                 f"divisible by {a} = {n}")
            t = torch.chunk(t, n, dim=d)[mesh.index(a)]
        return t.to(mesh.device, copy=True).contiguous()

    return _map(f, stack_pipeline(params, mesh.shape["pp"]),
                param_specs(cfg))


def unshard_params(params, mesh: Mesh, cfg: L.LlamaConfig):
    """The full stage-stacked tree, gathered from every rank's shards
    onto every rank (the counterpart of `jax.device_get` of the sharded
    arrays); `unstack_pipeline` gives the [L, ...] layout."""
    _member(mesh)

    def f(x, spec):
        with torch.no_grad():
            for d, a in reversed(list(enumerate(spec))):
                if a is not None:
                    x = M.all_gather(x, mesh.axis(a), dim=d)
        return x

    return _map(f, params, param_specs(cfg))


# ---------------------------------------------------------------------------
# per-shard building blocks (reference :196-333)
# ---------------------------------------------------------------------------

def _vp_embed_lookup(embed_local, tok, mesh: Mesh):
    """Vocab-parallel embedding with a sequence-parallel output: every tp
    rank looks the whole sequence up in its vocab block (zeros for other
    ids), and one reduce_scatter over the sequence both sums the blocks
    and scatters the sequence (its backward, an all_gather, gives each
    block the gradient of every position). tok [B, T] -> [B, T/tp, D]."""
    vloc = embed_local.shape[0]
    local = tok.long() - mesh.index("tp") * vloc
    in_range = (local >= 0) & (local < vloc)
    emb = embed_local[local.clamp(0, vloc - 1)]
    emb = torch.where(in_range[..., None], emb, 0.0)
    return M.reduce_scatter(emb, mesh.axis("tp"), dim=1)


def _vp_cross_entropy(logits_local, targets, vloc: int, mesh: Mesh):
    """Vocab-parallel softmax cross entropy per token from this rank's
    logits block [..., V/tp] over the whole sequence; replicated over
    tp. The shift is the gathered max, held out of the gradient as the
    reference's stop_gradient (logsumexp does not depend on it)."""
    tp = mesh.axis("tp")
    start = mesh.index("tp") * vloc
    gmax = M.all_gather(logits_local.detach().amax(dim=-1)[None], tp, dim=0)
    shifted = logits_local - gmax.amax(dim=0)[..., None]
    sumexp = M.psum(shifted.exp().sum(dim=-1), tp)
    local_t = targets.long() - start
    in_range = (local_t >= 0) & (local_t < vloc)
    true_shift = shifted.gather(
        -1, local_t.clamp(0, vloc - 1)[..., None])[..., 0]
    true_shift = M.psum(torch.where(in_range, true_shift, 0.0), tp)
    return sumexp.log() - true_shift


def moe_capacity(tokens: int, cfg: L.LlamaConfig) -> int:
    """`_moe_ffn`'s slots an expert: capacity factor 2 over an even
    share, at most every token (reference :253)."""
    return min(max(1, tokens * cfg.top_k // cfg.num_experts) * 2, tokens)


def _moe_ffn(h_full, lp, cfg: L.LlamaConfig, mesh: Mesh, drops: list):
    """GShard top-k MoE, experts sharded over dp (the ep axis) and their
    FFN over tp: a capacity of `moe_capacity` slots an expert, tokens
    dispatched by all_to_all over dp, the experts' outputs left partial
    over tp (the caller's reduce_scatter sums them). A token routed past
    an expert's capacity is dropped; each call appends its count of
    dropped (token, expert) pairs to `drops` (a 0-d tensor, no sync).
    h_full [B, T, D] (the whole sequence); lp's w1 [E/ep, D, F/tp]."""
    B, T, D = h_full.shape
    N, E, k = B * T, cfg.num_experts, cfg.top_k
    dp = mesh.axis("dp")
    if E % dp.nranks:
        raise ValueError(f"num_experts {E} is not divisible by ep (dp) "
                         f"{dp.nranks}")
    x = h_full.reshape(N, D)
    gates = torch.softmax(x.float() @ lp["router"].float(), dim=-1)
    cap = moe_capacity(N, cfg)
    topw, topi = torch.topk(gates, k, dim=-1)
    topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)
    disp = torch.zeros((N, E, cap), dtype=torch.float32, device=x.device)
    comb = torch.zeros_like(disp)
    counts = torch.zeros((E,), dtype=torch.long, device=x.device)
    dropped = torch.zeros((), dtype=torch.long, device=x.device)
    for c in range(k):
        e_idx = topi[:, c]
        onehot = F.one_hot(e_idx, E)
        pos = torch.cumsum(onehot, dim=0) - 1 + counts[None]
        counts = counts + onehot.sum(dim=0)
        p = pos.gather(1, e_idx[:, None])[:, 0]
        ok = p < cap
        oh = (onehot.float()[:, :, None]
              * F.one_hot(p.clamp(0, cap - 1), cap).float()[:, None, :]
              * ok[:, None, None])
        disp = disp + oh
        comb = comb + oh * topw[:, c][:, None, None]
        dropped = dropped + (~ok).sum()
    drops.append(dropped)
    xe = torch.einsum("nd,nec->ecd", x.float(), disp).to(x.dtype)
    xe = M.all_to_all(xe, dp, split_axis=0, concat_axis=1)  # [E/ep, C·ep, D]
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, lp["w1"].to(xe.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", xe, lp["w3"].to(xe.dtype))
    ye = torch.einsum("ecf,efd->ecd", h, lp["w2"].to(h.dtype))
    ye = M.all_to_all(ye, dp, split_axis=1, concat_axis=0)  # [E, C, D]
    y = torch.einsum("ecd,nec->nd", ye.float(), comb)
    return y.reshape(B, T, D).to(h_full.dtype)


def _block_sp(x, lp, cfg: L.LlamaConfig, cos, sin, mesh: Mesh, drops: list):
    """One block with Megatron TP and sequence parallelism: x
    [B, T/tp, D] sequence-sharded, lp this layer's shards."""
    Bm = x.shape[0]
    hd = cfg.head_dim
    tp = mesh.axis("tp")
    h = L.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    h_full = M.all_gather(h, tp, dim=1)                   # [B, T, D]
    T = h_full.shape[1]
    nh = lp["wq"].shape[-1] // hd
    nkv = lp["wk"].shape[-1] // hd
    q = (h_full @ lp["wq"].to(h_full.dtype)).reshape(Bm, T, nh, hd)
    kk = (h_full @ lp["wk"].to(h_full.dtype)).reshape(Bm, T, nkv, hd)
    vv = (h_full @ lp["wv"].to(h_full.dtype)).reshape(Bm, T, nkv, hd)
    q = L.apply_rope(q, cos, sin)
    kk = L.apply_rope(kk, cos, sin)
    if mesh.shape["cp"] > 1:
        # T is the cp block; K/V blocks rotate over the cp ring
        o = ring_attention_shard(q, kk, vv, mesh.axis("cp"), causal=True)
    else:
        o = L.attention(q, kk, vv)                        # A1 / A2
    o = o.to(h_full.dtype).reshape(Bm, T, nh * hd)
    partial = o @ lp["wo"].to(o.dtype)                    # row-parallel
    x = x + M.reduce_scatter(partial, tp, dim=1)
    h = L.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    h_full = M.all_gather(h, tp, dim=1)
    if cfg.num_experts:
        partial = _moe_ffn(h_full, lp, cfg, mesh, drops)
    else:
        partial = L.ffn(h_full, lp)                       # A3 / A4 on f/tp
    return x + M.reduce_scatter(partial, tp, dim=1)


def _check_layout(cfg: L.LlamaConfig, mesh: Mesh, B: int, T: int,
                  num_microbatches: int) -> None:
    s = mesh.shape
    for what, n, by in (("num_heads", cfg.num_heads, "tp"),
                        ("num_kv_heads", cfg.num_kv_heads, "tp"),
                        ("vocab_size", cfg.vocab_size, "tp"),
                        ("num_layers", cfg.num_layers, "pp"),
                        ("batch", B, "dp"), ("seq", T, "cp")):
        if n % s[by]:
            raise ValueError(f"{what} {n} is not divisible by {by} {s[by]}")
    if (B // s["dp"]) % num_microbatches:
        raise ValueError(f"local batch {B // s['dp']} is not divisible by "
                         f"num_microbatches {num_microbatches}")
    if (T // s["cp"]) % s["tp"]:
        raise ValueError(f"sequence block {T // s['cp']} is not divisible "
                         f"by tp {s['tp']}")


def _make_shard_loss(cfg: L.LlamaConfig, num_microbatches: int, mesh: Mesh,
                     remat: Union[bool, str] = True):
    """`shard_loss(params, tokens, targets, drops)`: this rank's share of
    the global mean loss (after its psums over pp and cp; a dp rank's
    share, summed over dp by the caller), from its shards and its block
    of the batch [B/dp, T/cp]: the GPipe tick loop over
    `num_microbatches`, TP/SP blocks, the vocab-parallel head and loss on
    the last stage."""
    Mb = num_microbatches
    dp, pp, cp = (mesh.shape[a] for a in ("dp", "pp", "cp"))
    stage = mesh.index("pp")

    def block(x, lp, cos, sin, drops):
        return _block_sp(x, lp, cfg, cos, sin, mesh, drops)

    def stage_fn(x, blocks_local, cos, sin, drops):
        for i in range(blocks_local["wq"].shape[0]):
            args = (x, {k: v[i] for k, v in blocks_local.items()}, cos, sin,
                    drops)
            if remat == "dots":
                x = checkpoint(block, *args, use_reentrant=False,
                               context_fn=L._save_dots)
            elif remat:
                x = checkpoint(block, *args, use_reentrant=False)
            else:
                x = block(*args)
        return x

    def mb_loss(y, tgt, params, vloc):
        # leave the SP region (all_gather the sequence), then the
        # vocab-parallel head and loss over the whole sequence
        h = L.rms_norm(y, params["final_norm"], cfg.rms_eps)
        h_full = M.all_gather(h, mesh.axis("tp"), dim=1)
        logits = (h_full @ params["lm_head"].to(h_full.dtype)).float()
        return _vp_cross_entropy(logits, tgt, vloc, mesh).sum()

    def shard_loss(params, tokens, targets, drops):
        blocks_local = {k: v[0] for k, v in params["blocks"].items()}
        Bloc, T = tokens.shape
        Bm, Tloc = Bloc // Mb, T // mesh.shape["tp"]
        dev = tokens.device
        tok_mb = tokens.reshape(Mb, Bm, T)
        tgt_mb = targets.reshape(Mb, Bm, T)
        # T is the cp block; rope positions start at its global offset
        cos, sin = L.rope_cos_sin(
            mesh.index("cp") * T + torch.arange(T, device=dev),
            cfg.head_dim, cfg.rope_theta)
        vloc = params["lm_head"].shape[1]
        first = torch.tensor(stage == 0, device=dev)
        x_in = torch.zeros((Bm, Tloc, cfg.hidden_size), dtype=cfg.dtype,
                           device=dev)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(Mb + pp - 1):
            m = min(max(t - stage, 0), Mb - 1)
            take = torch.tensor(0 <= t - stage < Mb and stage == pp - 1,
                                device=dev)
            x0 = _vp_embed_lookup(params["embed"], tok_mb[m],
                                  mesh).to(cfg.dtype)
            x = torch.where(first, x0, x_in)
            y = stage_fn(x, blocks_local, cos, sin, drops)
            loss_acc = loss_acc + torch.where(
                take, mb_loss(y, tgt_mb[m], params, vloc), 0.0)
            x_in = M.shift(y, mesh.axis("pp"), 1)
        # the last stage's sum, replicated over tp already; over the
        # global token count, so the sum over dp is the global mean
        loss_sum = M.psum(loss_acc, mesh.axis("pp"))
        if cp > 1:
            loss_sum = M.psum(loss_sum, mesh.axis("cp"))
        return loss_sum / (Mb * Bm * T * cp * dp)

    return shard_loss


def _sync_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a leaf is replicated on."""
    return tuple(a for a in MESH_AXES if a not in spec)


def sync_grads(grads, specs, mesh: Mesh):
    """Sum each gradient leaf, in place, over the mesh axes its param is
    replicated on (an all_reduce an axis; reference :431)."""
    for g, s in zip(_flatten(grads)[0], _flatten(specs)[0]):
        for a in _sync_axes(s):
            C.all_reduce(g, group=mesh.axis(a))
    return grads


def _global_sq_sum(grads, specs, mesh: Mesh):
    """The squared global gradient norm (reference :517-522): each
    leaf's local sum of squares, summed over the axes it is sharded on
    (leaves grouped by those axes, one psum an axis a group)."""
    by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, s in zip(_flatten(grads)[0], _flatten(specs)[0]):
        axes = tuple(a for a in MESH_AXES if a in s)
        loc = g.float().square().sum()
        by_axes[axes] = loc if axes not in by_axes else by_axes[axes] + loc
    sq = None
    for axes, loc in by_axes.items():
        for a in axes:
            loc = M.psum(loc, mesh.axis(a))
        sq = loc if sq is None else sq + loc
    return sq


def _local_batch(tokens, targets, mesh: Mesh, num_microbatches: int, cfg):
    """This rank's block of the global batch: rows over dp, the sequence
    over cp."""
    B, T = tokens.shape
    _check_layout(cfg, mesh, B, T, num_microbatches)
    b, t = B // mesh.shape["dp"], T // mesh.shape["cp"]
    rows = slice(mesh.index("dp") * b, (mesh.index("dp") + 1) * b)
    cols = slice(mesh.index("cp") * t, (mesh.index("cp") + 1) * t)
    dev = mesh.device
    return (torch.as_tensor(tokens)[rows, cols].to(dev),
            torch.as_tensor(targets)[rows, cols].to(dev))


def _mesh_loss_and_grads(shard_loss, specs, mesh: Mesh, params, tok, tgt):
    """(global mean loss, synced gradients in params' layout, the MoE
    blocks' dropped-pair count or None) of one forward and backward."""
    leaves, rebuild = _flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    drops: list = []
    loss = shard_loss(rebuild(live), tok, tgt, drops)
    # counted before the backward: a recomputed MoE block appends again
    dropped = torch.stack(drops).sum() if drops else None
    gs = torch.autograd.grad(loss, live, allow_unused=True)
    with torch.no_grad():
        grads = rebuild([torch.zeros_like(p) if g is None else g.contiguous()
                         for g, p in zip(gs, live)])
        sync_grads(grads, specs, mesh)
        loss = M.psum(loss.detach(), mesh.axis("dp"))
    return loss, grads, dropped


def _mesh_train_step(cfg, mesh: Mesh, num_microbatches: int,
                     hp: AdamWConfig, remat):
    specs = param_specs(cfg)
    shard_loss = _make_shard_loss(cfg, num_microbatches, mesh, remat)

    def step(params, opt_state, tokens, targets):
        _member(mesh)
        tok, tgt = _local_batch(tokens, targets, mesh, num_microbatches,
                                cfg)
        loss, grads, step.last_dropped = _mesh_loss_and_grads(
            shard_loss, specs, mesh, params, tok, tgt)
        with torch.no_grad():
            sq = _global_sq_sum(grads, specs, mesh)
        params, opt_state = _adamw_update(params, grads, opt_state, hp, sq)
        return params, opt_state, loss

    step.last_dropped = None
    return step


def _mesh_eval_step(cfg, mesh: Mesh, num_microbatches: int):
    shard_loss = _make_shard_loss(cfg, num_microbatches, mesh, remat=False)

    def step(params, tokens, targets):
        _member(mesh)
        tok, tgt = _local_batch(tokens, targets, mesh, num_microbatches,
                                cfg)
        with torch.no_grad():
            return M.psum(shard_loss(params, tok, tgt, []), mesh.axis("dp"))

    return step


def make_train_step(cfg: L.LlamaConfig, mesh=None,
                    num_microbatches: int = 1,
                    hp: Optional[AdamWConfig] = None,
                    remat: Union[bool, str] = True, *, device=None):
    """Build `step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)` (reference :443, :511-531).

    mesh: a `Mesh` (`build_mesh`) runs the sharded step of the module
    docstring: params from `shard_params`, tokens / targets the global
    [B, T] batch on every rank, loss the global mean on every rank.
    Otherwise a device (`mesh`, or `device=`; default the card; without
    one it raises) runs the single-device step.
    On the card the step launches the flash attention kernels (A1
    forward, A2 backward) and, for dense models, the fused FFN kernels
    (A3 forward, A4 backward); an unsupported shape raises — nothing
    falls back. On the CPU the kernels' plain versions run.
    remat, the reference's policies (`models.llama.forward`): True
    recomputes every block in the backward, so A1 and A3 run twice per
    layer and microbatch; "dots" keeps the matrix products' and A1's and
    A3's outputs and recomputes the rest, so they run once; False keeps
    every activation. The three give the same values.
    The update is in place (see `_adamw_update`); loss is the step's
    mean loss as a 0-d f32 tensor on the device, before the update."""
    _llama_only(cfg, "make_train_step")
    L.check_remat(remat)
    _check_microbatches(num_microbatches)
    hp = hp or AdamWConfig()
    if isinstance(mesh, Mesh):
        return _mesh_train_step(cfg, mesh, num_microbatches, hp, remat)
    dev = resolve(device if mesh is None else mesh)

    def step(params, opt_state, tokens, targets):
        tokens, targets = _checked_inputs(params, tokens, targets, dev)
        loss, grads = loss_and_grads(params, tokens, targets, cfg,
                                     num_microbatches, remat)
        with torch.no_grad():
            sq = sum(g.float().square().sum() for g in _flatten(grads)[0])
        params, opt_state = _adamw_update(params, grads, opt_state, hp, sq)
        return params, opt_state, loss

    return step


def make_eval_step(cfg: L.LlamaConfig, mesh=None,
                   num_microbatches: int = 1, *, device=None):
    """Build `step(params, tokens, targets) -> loss`, the loss-only step
    (reference :534 on its LlamaConfig path): the mean next-token cross
    entropy over every token of the batch, a 0-d f32 tensor on the
    device, summed over `num_microbatches` row slices as the train step
    sums it, so it equals the loss the train step reports for the same
    params. No gradients and no remat: on the card it launches A1 and A3
    only. mesh / device as in `make_train_step`."""
    _llama_only(cfg, "make_eval_step")
    _check_microbatches(num_microbatches)
    if isinstance(mesh, Mesh):
        return _mesh_eval_step(cfg, mesh, num_microbatches)
    dev = resolve(device if mesh is None else mesh)

    def step(params, tokens, targets):
        tokens, targets = _checked_inputs(params, tokens, targets, dev)
        loss = None
        with torch.no_grad():
            for rows in _row_slices(tokens.shape[0], num_microbatches):
                part = L.loss_fn(params, tokens[rows], targets[rows], cfg,
                                 remat=False) / num_microbatches
                loss = part if loss is None else loss + part
        return loss

    return step
