"""The single-device LLaMA training and eval steps — the port of the
LlamaConfig path of `paddle_tpu/distributed/hybrid.py` at dp = pp = cp =
tp = 1.

`make_train_step` (reference :443) returns `step(params, opt_state,
tokens, targets) -> (params, opt_state, loss)`; `make_eval_step`
(reference :534) returns `step(params, tokens, targets) -> loss`, the
same loss without gradients. Parameters are f32
master tensors in the port's dict layout (`models.llama`); compute runs
in `cfg.dtype`, each block casting its weights as the reference does.
The loss is the mean next-token cross entropy over every token of the
batch; with `num_microbatches` = M the batch is cut into M equal row
slices whose gradients are summed, so the loss and gradients are those
of the whole batch (reference :414 at dp = pp = cp = 1). The optimizer
is the reference's AdamW (:143-190): global-norm clipping, bias
correction and decoupled weight decay on every leaf.

Unlike the reference's functional, jitted step, this one runs eagerly
and updates in place: `params` and `opt_state` are modified and
returned, which keeps one copy of the f32 master weights, the AdamW
moments and the gradients on the card. There is no mesh argument:
multi-device training (TP/SP, the GPipe schedule, context parallelism)
is a later slice, and so is the reference's `nn.Layer` path
(`GenericHybridEngine`): both factories take a `LlamaConfig` only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve
from ..models import llama as L

__all__ = ["AdamWConfig", "init_opt_state", "loss_and_grads",
           "make_train_step", "make_eval_step"]


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
                   remat: Union[bool, str] = True):
    """(loss, grads) of the mean next-token cross entropy over every
    token of tokens/targets [B, T]: the batch is cut into
    `num_microbatches` equal row slices, each slice's loss (its mean
    over 1 / num_microbatches of the tokens) is differentiated on its
    own and the gradients are summed. grads has params' layout, f32.
    remat: True, False or "dots" (`models.llama.forward`)."""
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
            f"(GenericHybridEngine) is not ported yet, got "
            f"{type(cfg).__name__}")


def _checked_inputs(params, tokens, targets, dev):
    if any(p.device.type != dev.type for p in _flatten(params)[0]):
        raise ValueError(f"params must live on {dev}")
    return tokens.to(dev), targets.to(dev)


def make_train_step(cfg: L.LlamaConfig, device=None,
                    num_microbatches: int = 1,
                    hp: Optional[AdamWConfig] = None,
                    remat: Union[bool, str] = True):
    """Build `step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)` for one device (reference :443, :511-531).

    device: "cuda" unless the caller names another; without a card the
    default raises. On the card the step launches the flash attention
    kernels (A1 forward, A2 backward) and the fused FFN kernels (A3
    forward, A4 backward); an unsupported shape raises — nothing falls
    back. On the CPU the kernels' plain versions run.
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
    dev = resolve(device)
    hp = hp or AdamWConfig()

    def step(params, opt_state, tokens, targets):
        tokens, targets = _checked_inputs(params, tokens, targets, dev)
        loss, grads = loss_and_grads(params, tokens, targets, cfg,
                                     num_microbatches, remat)
        with torch.no_grad():
            sq = sum(g.float().square().sum() for g in _flatten(grads)[0])
        params, opt_state = _adamw_update(params, grads, opt_state, hp, sq)
        return params, opt_state, loss

    return step


def make_eval_step(cfg: L.LlamaConfig, device=None,
                   num_microbatches: int = 1):
    """Build `step(params, tokens, targets) -> loss`, the loss-only step
    (reference :534 on its LlamaConfig path): the mean next-token cross
    entropy over every token of the batch, a 0-d f32 tensor on the
    device, summed over `num_microbatches` row slices as the train step
    sums it, so it equals the loss the train step reports for the same
    params. No gradients and no remat: on the card it launches A1 and A3
    only. device as in `make_train_step`."""
    _llama_only(cfg, "make_eval_step")
    _check_microbatches(num_microbatches)
    dev = resolve(device)

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
