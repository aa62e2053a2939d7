"""Optimizer base and built-ins: port of `paddle_tpu/optimizer/optimizer.py`.

The reference's update rules, written in torch: each optimizer's
`_update(param, grad, lr)` returns the parameter's new value from its
accumulators (plain tensors keyed by parameter name, the reference's
names: `velocity`, `moment1`, ...), and the step writes it into the
parameter in place, so the Parameter keeps its torch leaf.

The reference traces each parameter group's whole update into one jitted
executable (FLAGS_fused_optimizer), and falls back to a per-parameter
update for RAdam (a host-side branch on rho_t) and LBFGS (a
closure-driven line search). The port has nothing to trace: every
optimizer runs the plain per-parameter loop, RAdam's and LBFGS's
fallback included. A `torch._foreach_*` path over the group did not run
LeNet's Momentum step faster on the card (`tools/eager_ab_torch.py`),
so there is none. `step` ends by marking the step in
`core/async_engine`, which bounds how many steps the host runs ahead of
the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core import async_engine
from ..core.tensor import Parameter, Tensor, _unwrap
from ..nn.clip import ClipGradBase
from .lr import LRScheduler

_pre_step_hooks: List = []


def register_pre_step_hook(fn):
    if fn not in _pre_step_hooks:
        _pre_step_hooks.append(fn)
    return fn


def _f32(t):
    return t.float()


def _lr_mult(p) -> float:
    return getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)


class Optimizer:
    # Whether `_update` is elementwise over a flat parameter buffer: the
    # condition for the ZeRO-1 sharded update (`distributed/parallel.py`),
    # as in the reference. Lamb's per-parameter trust ratio and LBFGS's
    # line search are not.
    _flat_shardable = True

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list: Optional[List[Parameter]] = (
            list(parameters) if parameters is not None else None)
        self._weight_decay = weight_decay
        self._grad_clip: Optional[ClipGradBase] = grad_clip
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- state ---------------------------------------------------------------
    def _acc(self, param, name: str, init=None):
        store = self._accumulators.setdefault(param.name, {})
        if name not in store:
            store[name] = (torch.zeros_like(param._data) if init is None
                           else init)
        return store[name]

    def _set_acc(self, param, name: str, value):
        self._accumulators.setdefault(param.name, {})[name] = value

    def _zeros32(self, param):
        return torch.zeros(param._data.shape, dtype=torch.float32,
                           device=param._data.device)

    def state_dict(self):
        out = {}
        for pname, accs in self._accumulators.items():
            for aname, arr in accs.items():
                out[f"{pname}.{aname}"] = Tensor._wrap(arr)
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        for key, val in state.items():
            if key == "@step":
                self._step_count = int(val)
            elif key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(val)
            elif "." in key:
                pname, aname = key.rsplit(".", 1)
                arr = _unwrap(val)
                if not isinstance(arr, torch.Tensor):
                    arr = torch.as_tensor(arr)
                self._accumulators.setdefault(pname, {})[aname] = arr

    load_state_dict = set_state_dict

    # -- stepping ------------------------------------------------------------
    def _collect_params_grads(self):
        return [(p, p._data.grad) for p in self._parameter_list or []
                if p.trainable]

    def _apply_decay(self, param, grad, lr):
        """L2 regularization folded into the gradient; AdamW overrides with
        decoupled decay."""
        wd = self._weight_decay
        if wd is None or isinstance(wd, str):
            return grad
        return grad + float(wd) * param._data

    @torch.no_grad()
    def step(self):
        for hook in _pre_step_hooks:
            hook()
        pg = self._collect_params_grads()
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        lr = self.get_lr()
        pg = [(p, g) for p, g in pg if g is not None]
        if not pg:
            self._step_count += 1
            return
        for p, g in pg:
            plr = lr * _lr_mult(p)
            g = self._apply_decay(p, g, plr)
            p._data.copy_(self._update(p, g, plr))
        self._step_count += 1
        async_engine.mark_step([p for p, _ in pg],
                               tag=f"{type(self).__name__}.step")

    def _update(self, param, grad, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            p.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None


class SGD(Optimizer):
    """Reference: python/paddle/optimizer/sgd.py."""

    def _update(self, param, grad, lr):
        return param._data - lr * grad.to(param._data.dtype)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, param, grad, lr):
        v = self._momentum * self._acc(param, "velocity") + grad
        self._set_acc(param, "velocity", v)
        if self._nesterov:
            return param._data - lr * (grad + self._momentum * v)
        return param._data - lr * v


class Adam(Optimizer):
    """Reference: python/paddle/optimizer/adam.py."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, param, grad, lr):
        t = self._step_count + 1
        g32 = _f32(grad)
        m = self._acc(param, "moment1", self._zeros32(param))
        v = self._acc(param, "moment2", self._zeros32(param))
        m = self._beta1 * m + (1 - self._beta1) * g32
        v = self._beta2 * v + (1 - self._beta2) * torch.square(g32)
        self._set_acc(param, "moment1", m)
        self._set_acc(param, "moment2", v)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        upd = lr * mhat / (torch.sqrt(vhat) + self._epsilon)
        return (_f32(param._data) - upd).to(param._data.dtype)

class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, name=name)
        self._coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_decay(self, param, grad, lr):
        return grad  # decay applied decoupled in _update

    def _update(self, param, grad, lr):
        decay = self._coeff
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(param.name)):
            decay = 0.0
        out = super()._update(param, grad, lr)
        if decay:
            out = out - (lr * decay) * param._data.to(out.dtype)
        return out


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update(self, param, grad, lr):
        acc = self._acc(param, "moment", torch.full(
            param._data.shape, self._init_acc, dtype=torch.float32,
            device=param._data.device))
        acc = acc + torch.square(_f32(grad))
        self._set_acc(param, "moment", acc)
        return (_f32(param._data) - lr * _f32(grad)
                / (torch.sqrt(acc) + self._epsilon)).to(param._data.dtype)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update(self, param, grad, lr):
        g32 = _f32(grad)
        ms = self._acc(param, "mean_square", self._zeros32(param))
        ms = self._rho * ms + (1 - self._rho) * torch.square(g32)
        self._set_acc(param, "mean_square", ms)
        if self._centered:
            mg = self._acc(param, "mean_grad", self._zeros32(param))
            mg = self._rho * mg + (1 - self._rho) * g32
            self._set_acc(param, "mean_grad", mg)
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._acc(param, "momentum", self._zeros32(param))
        mom = self._momentum * mom + lr * g32 / denom
        self._set_acc(param, "momentum", mom)
        return (_f32(param._data) - mom).to(param._data.dtype)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _update(self, param, grad, lr):
        g32 = _f32(grad)
        avg_sq = self._acc(param, "avg_squared_grad", self._zeros32(param))
        avg_upd = self._acc(param, "avg_squared_update", self._zeros32(param))
        avg_sq = self._rho * avg_sq + (1 - self._rho) * torch.square(g32)
        update = (-torch.sqrt(avg_upd + self._epsilon)
                  / torch.sqrt(avg_sq + self._epsilon) * g32)
        avg_upd = self._rho * avg_upd + (1 - self._rho) * torch.square(update)
        self._set_acc(param, "avg_squared_grad", avg_sq)
        self._set_acc(param, "avg_squared_update", avg_upd)
        return (_f32(param._data) + lr * update).to(param._data.dtype)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, param, grad, lr):
        t = self._step_count + 1
        g32 = _f32(grad)
        m = self._acc(param, "moment", self._zeros32(param))
        u = self._acc(param, "inf_norm", self._zeros32(param))
        m = self._beta1 * m + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * u, torch.abs(g32))
        self._set_acc(param, "moment", m)
        self._set_acc(param, "inf_norm", u)
        return (_f32(param._data) - lr / (1 - self._beta1 ** t) * m
                / (u + self._epsilon)).to(param._data.dtype)


class Lamb(Optimizer):
    """Reference: python/paddle/optimizer/lamb.py."""

    _flat_shardable = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, param, grad, lr):
        t = self._step_count + 1
        g32, p32 = _f32(grad), _f32(param._data)
        m = self._acc(param, "moment1", self._zeros32(param))
        v = self._acc(param, "moment2", self._zeros32(param))
        m = self._beta1 * m + (1 - self._beta1) * g32
        v = self._beta2 * v + (1 - self._beta2) * torch.square(g32)
        self._set_acc(param, "moment1", m)
        self._set_acc(param, "moment2", v)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        wd = 0.0 if (self._exclude_fn is not None
                     and self._exclude_fn(param)) else self._lamb_wd
        r = r + wd * p32
        w_norm = torch.sqrt(torch.sum(torch.square(p32)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return (p32 - lr * trust * r).to(param._data.dtype)


class LBFGS(Optimizer):
    """Limited-memory BFGS (reference: python/paddle/optimizer/lbfgs.py).

    `step(closure)` re-evaluates the loss and gradients as needed: the
    two-loop recursion over the last `history_size` (s, y) pairs, a
    strong-Wolfe or fixed-step line search; host-driven, as the
    reference's."""

    _flat_shardable = False

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._line_search = line_search_fn
        self._s, self._y = [], []
        self._prev_flat_grad = None
        self._prev_loss = None

    @property
    def _params(self):
        return self._parameter_list or []

    def _flat(self, arrs):
        return torch.cat([a.reshape(-1).float() for a in arrs])

    def _gather_grads(self):
        return self._flat([p._data.grad if p._data.grad is not None
                           else torch.zeros_like(p._data)
                           for p in self._params])

    @torch.no_grad()
    def _assign_flat(self, flat):
        off = 0
        for p in self._params:
            n = p._data.numel()
            p._data.copy_(flat[off:off + n].reshape(p._data.shape))
            off += n

    def _direction(self, flat_grad):
        q = flat_grad
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            gamma = torch.dot(s_last, y_last) / torch.clamp(
                torch.dot(y_last, y_last), min=1e-10)
            q = q * gamma
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return -q

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that "
                             "re-evaluates the model and returns the loss")
        loss = closure()
        lr = self.get_lr()
        n_eval = 1
        for _ in range(self._max_iter):
            flat_grad = self._gather_grads()
            if float(torch.abs(flat_grad).max()) <= self._tol_grad:
                break
            if self._prev_flat_grad is not None:
                y = flat_grad - self._prev_flat_grad
                s = self._last_step
                if float(torch.dot(y, s)) > 1e-10:
                    self._s.append(s)
                    self._y.append(y)
                    if len(self._s) > self._history:
                        self._s.pop(0)
                        self._y.pop(0)
            d = self._direction(flat_grad)
            x0 = self._flat([p._data.detach() for p in self._params])
            t = lr if self._y else min(1.0, 1.0 / max(
                float(torch.abs(flat_grad).sum()), 1e-10)) * lr
            if self._line_search == "strong_wolfe":
                t, loss, n_ls = self._strong_wolfe(closure, x0, d, t, loss,
                                                   flat_grad)
                n_eval += n_ls
            else:
                self._assign_flat(x0 + t * d)
                self.clear_grad()
                loss = closure()
                n_eval += 1
            self._last_step = self._flat(
                [p._data.detach() for p in self._params]) - x0
            self._prev_flat_grad = flat_grad
            cur = float(loss.numpy())
            if (self._prev_loss is not None
                    and abs(cur - self._prev_loss) < self._tol_change):
                self._prev_loss = cur
                break
            self._prev_loss = cur
            if n_eval >= self._max_eval:
                break
        self._step_count += 1
        return loss

    def _strong_wolfe(self, closure, x0, d, t, f0, g0, c1=1e-4, c2=0.9,
                      max_ls=10):
        """Backtracking satisfying Armijo + curvature (the reference's
        compact variant)."""
        f0v = float(f0.numpy())
        gtd0 = float(torch.dot(g0, d))
        n_eval = 0
        best_t, best_loss = t, f0
        for _ in range(max_ls):
            self._assign_flat(x0 + t * d)
            self.clear_grad()
            loss = closure()
            n_eval += 1
            fv = float(loss.numpy())
            gtd = float(torch.dot(self._gather_grads(), d))
            if fv <= f0v + c1 * t * gtd0 and abs(gtd) <= c2 * abs(gtd0):
                return t, loss, n_eval
            best_t, best_loss = t, loss
            t *= 0.5
        return best_t, best_loss, n_eval


class ASGD(Optimizer):
    """Averaged SGD (reference: python/paddle/optimizer/asgd.py)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = max(1, int(batch_num))

    def _update(self, param, grad, lr):
        g32 = _f32(grad)
        n = self._batch_num
        d = self._acc(param, "d", self._zeros32(param))
        idx = self._step_count % n
        ys = self._acc(param, "ys", torch.zeros(
            (n, *param._data.shape), dtype=torch.float32,
            device=param._data.device))
        d = d - ys[idx] + g32
        ys = ys.clone()
        ys[idx] = g32
        self._set_acc(param, "d", d)
        self._set_acc(param, "ys", ys)
        return (_f32(param._data) - lr * d / n).to(param._data.dtype)


class NAdam(Optimizer):
    """Reference: python/paddle/optimizer/nadam.py."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update(self, param, grad, lr):
        t = self._step_count + 1
        g32 = _f32(grad)
        m = self._acc(param, "moment1", self._zeros32(param))
        v = self._acc(param, "moment2", self._zeros32(param))
        mu_t = self._beta1 * (1.0 - 0.5 * 0.96 ** (self._psi * t))
        mu_next = self._beta1 * (1.0 - 0.5 * 0.96 ** (self._psi * (t + 1)))
        prod = self._acc(param, "mu_product", torch.ones(
            (), dtype=torch.float32, device=param._data.device))
        prod_t = prod * mu_t
        m = self._beta1 * m + (1 - self._beta1) * g32
        v = self._beta2 * v + (1 - self._beta2) * torch.square(g32)
        self._set_acc(param, "moment1", m)
        self._set_acc(param, "moment2", v)
        self._set_acc(param, "mu_product", prod_t)
        m_hat = (mu_next * m / (1 - prod_t * mu_next)
                 + (1 - mu_t) * g32 / (1 - prod_t))
        v_hat = v / (1 - self._beta2 ** t)
        upd = lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)
        return (_f32(param._data) - upd).to(param._data.dtype)


class RAdam(Optimizer):
    """Rectified Adam (reference: python/paddle/optimizer/radam.py): SGD
    with momentum while rho_t <= 5; the per-parameter loop always."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, param, grad, lr):
        t = self._step_count + 1
        g32 = _f32(grad)
        m = self._acc(param, "moment1", self._zeros32(param))
        v = self._acc(param, "moment2", self._zeros32(param))
        m = self._beta1 * m + (1 - self._beta1) * g32
        v = self._beta2 * v + (1 - self._beta2) * torch.square(g32)
        self._set_acc(param, "moment1", m)
        self._set_acc(param, "moment2", v)
        rho_inf = 2.0 / (1 - self._beta2) - 1.0
        beta2_t = self._beta2 ** t
        rho_t = rho_inf - 2.0 * t * beta2_t / (1 - beta2_t)
        m_hat = m / (1 - self._beta1 ** t)
        if rho_t > 5.0:
            r = ((rho_t - 4) * (rho_t - 2) * rho_inf
                 / ((rho_inf - 4) * (rho_inf - 2) * rho_t)) ** 0.5
            v_hat = torch.sqrt(v / (1 - beta2_t))
            upd = lr * r * m_hat / (v_hat + self._epsilon)
        else:
            upd = lr * m_hat
        return (_f32(param._data) - upd).to(param._data.dtype)


class Rprop(Optimizer):
    """Resilient backprop (reference: python/paddle/optimizer/rprop.py)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _update(self, param, grad, lr):
        g32 = _f32(grad)
        prev = self._acc(param, "prev_grad", self._zeros32(param))
        steps = self._acc(param, "step_size", torch.full(
            param._data.shape, float(lr), dtype=torch.float32,
            device=param._data.device))
        sign = torch.sign(prev * g32)
        factor = torch.where(sign > 0, self._eta_pos,
                             torch.where(sign < 0, self._eta_neg, 1.0))
        steps = torch.clamp(steps * factor, self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(g32), g32)
        self._set_acc(param, "prev_grad", g_eff)
        self._set_acc(param, "step_size", steps)
        return (_f32(param._data) - steps * torch.sign(g_eff)).to(
            param._data.dtype)
