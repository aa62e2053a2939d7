"""GradScaler: dynamic loss scaling — port of `paddle_tpu/amp/grad_scaler.py`.

bfloat16 needs no loss scaling (its exponent is float32's): a scaler
whose training runs under `auto_cast(dtype="bfloat16")` is a pass-through
(`scale` returns the loss, `step` is the optimizer's, the scale stays).
float16 gets the reference's dynamic scaling: the loss times the scale,
gradients unscaled before the step, a step skipped when any gradient is
not finite, and the same `incr_every_n_steps` / `decr_every_n_nan_or_inf`
state machine. Finding a non-finite gradient is one fused device pass
over all gradients of a type (`torch._amp_foreach_non_finite_check_and_unscale_`,
which also unscales them) and one host read a step; the reference reads
the host once for every parameter (`grad_scaler.py:55`).
"""
from __future__ import annotations

import torch

from .auto_cast import last_amp_dtype

__all__ = ["AmpScaler", "GradScaler"]


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def _passthrough(self) -> bool:
        """True when the last auto_cast of this thread was bfloat16."""
        return last_amp_dtype() == "bfloat16"

    def _active(self) -> bool:
        return self._enable and not self._passthrough()

    def scale(self, var):
        if not self._active():
            return var
        return var * self._scale

    def _unscale(self, optimizer):
        if not self._active() or self._unscaled:
            return
        groups = {}
        for p in optimizer._parameter_list or []:
            g = p._data.grad
            if g is not None:
                groups.setdefault((g.device, g.dtype), []).append(g)
        found = None
        for (dev, _), grads in groups.items():
            f = torch.zeros((), dtype=torch.float32, device=dev)
            inv = torch.full((), 1.0 / self._scale, dtype=torch.float32,
                             device=dev)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, f, inv)
            found = f if found is None else found + f.to(found.device)
        self._found_inf = bool(found.item()) if found is not None else False
        self._unscaled = True

    def unscale_(self, optimizer):
        return self._unscale(optimizer)

    @torch.no_grad()
    def step(self, optimizer):
        if not self._active():
            optimizer.step()
            return
        self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not self._active() or not self._dynamic:
            self._unscaled = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, loss):
        """The step and the update (the caller ran `scale(loss).backward()`)."""
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


class GradScaler(AmpScaler):
    pass
