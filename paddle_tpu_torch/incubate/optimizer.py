"""paddle.incubate.optimizer: `LookAhead` and `ModelAverage`, the port of
`paddle_tpu/incubate/optimizer/__init__.py` (Paddle's lookahead.py,
modelaverage.py). Both wrap the parameters of an inner optimizer with a
few extra tensors a parameter; updates write the parameters in place, so
they keep their torch leaves.

The reference's LookAhead reads the inner optimizer's `_params`, which its
optimizers do not have, so its slow weights never move (ROADMAP Queue C,
reference-side); the port's reads `_parameter_list` and does what the
reference's docstring says.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """k steps forward, 1 step back (reference :18; Paddle's
    lookahead.py:30): every k inner steps the slow weights move alpha
    toward the fast ones and the fast weights take the slow ones."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._slow: Dict[int, torch.Tensor] = {}
        self._count = 0

    @property
    def _params(self):
        return list(getattr(self.inner_optimizer, "_parameter_list", None)
                    or [])

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._count += 1
        if self._count % self.k:
            return
        for p in self._params:
            fast = p._data
            slow = self._slow.get(id(p))
            if slow is None:
                slow = fast.float()          # the first sync: fast is slow
            slow = slow + self.alpha * (fast.float() - slow)
            self._slow[id(p)] = slow
            fast.copy_(slow.to(fast.dtype))

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def minimize(self, loss):
        loss.backward()
        self.step()
        self.clear_grad()

    def __getattr__(self, item):
        return getattr(self.__dict__["inner_optimizer"], item)


class ModelAverage:
    """The running average of the parameters, applied at eval time
    (reference :61; Paddle's modelaverage.py:33): `step` accumulates,
    `apply()` swaps the averages in, `restore()` the live values back."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.rate = float(average_window_rate)
        self.min_w = int(min_average_window)
        self.max_w = int(max_average_window)
        self._params = list(parameters or [])
        self._sum: Dict[int, torch.Tensor] = {}
        self._num = 0
        self._backup: Dict[int, torch.Tensor] = {}

    @torch.no_grad()
    def step(self):
        self._num += 1
        for p in self._params:
            s = self._sum.get(id(p))
            cur = p._data.float()
            self._sum[id(p)] = cur.clone() if s is None else s + cur
        # the window restarts once it outgrows its bounds (the reference's
        # collapse of Paddle's sum_1/sum_2/sum_3 rotation)
        if self._num > self.max_w and \
                self._num > self.min_w * max(self.rate, 1e-9):
            for p in self._params:
                self._sum[id(p)] = p._data.float().clone()
            self._num = 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        for p in self._params:
            s = self._sum.get(id(p))
            if s is None or not self._num:
                continue
            self._backup[id(p)] = p._data.clone()
            p._data.copy_((s / self._num).to(p._data.dtype))

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            b = self._backup.pop(id(p), None)
            if b is not None:
                p._data.copy_(b)

    def minimize(self, loss):
        self.step()
