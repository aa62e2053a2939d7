"""Recurrent layers: port of `paddle_tpu/nn/layer/rnn.py` (paddle's
python/paddle/nn/layer/rnn.py).

The cells `SimpleRNNCell`, `LSTMCell` and `GRUCell`; the generic `RNN`
and `BiRNN` wrappers, which step any cell in a Python loop; and
`SimpleRNN`, `LSTM` and `GRU` over `RNNBase`, with the reference's flat
parameter names (`weight_ih_l{k}[_reverse]`, ...). `RNNBase.forward`
runs the whole recurrence through the registered `rnn` op
(`ops/kernels/rnn_ops.py`), which calls torch's LSTM / GRU / RNN
functions a layer at a time: cuDNN on the card. The weights need no
remapping: paddle's gate orders are torch's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import _C_ops
from ...core.tensor import Tensor
from .. import functional as F
from .. import initializer as I
from ..param_attr import ParamAttr
from .container import LayerList
from .layers import Layer

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
]


def _stdv_uniform(hidden_size):
    stdv = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-stdv, stdv)


class RNNCellBase(Layer):
    """Base for single-step cells (reference rnn.py:692)."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        if isinstance(shape[0], (list, tuple)):
            return tuple(
                _C_ops.full([batch] + list(s), init_value,
                            dtype or "float32") for s in shape)
        return _C_ops.full([batch] + list(shape), init_value,
                           dtype or "float32")


class SimpleRNNCell(RNNCellBase):
    """h' = act(W_ih x + b_ih + W_hh h + b_hh). Reference rnn.py:811."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if hidden_size <= 0:
            raise ValueError("hidden_size must be positive")
        if activation not in ("tanh", "relu"):
            raise ValueError(
                "activation for SimpleRNNCell should be tanh or relu, "
                f"but get {activation}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        init = _stdv_uniform(hidden_size)
        self.weight_ih = self.create_parameter(
            [hidden_size, input_size], ParamAttr._to_attr(weight_ih_attr),
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [hidden_size, hidden_size], ParamAttr._to_attr(weight_hh_attr),
            default_initializer=init)
        self.bias_ih = (None if bias_ih_attr is False else
                        self.create_parameter(
                            [hidden_size], ParamAttr._to_attr(bias_ih_attr),
                            is_bias=True, default_initializer=init))
        self.bias_hh = (None if bias_hh_attr is False else
                        self.create_parameter(
                            [hidden_size], ParamAttr._to_attr(bias_hh_attr),
                            is_bias=True, default_initializer=init))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        pre_h = states
        h = _C_ops.matmul(inputs, self.weight_ih, transpose_y=True)
        if self.bias_ih is not None:
            h = h + self.bias_ih
        h = h + _C_ops.matmul(pre_h, self.weight_hh, transpose_y=True)
        if self.bias_hh is not None:
            h = h + self.bias_hh
        h = _C_ops.tanh(h) if self.activation == "tanh" else F.relu(h)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def extra_repr(self):
        s = "{input_size}, {hidden_size}"
        if self.activation != "tanh":
            s += ", activation={activation}"
        return s.format(**self.__dict__)


class LSTMCell(RNNCellBase):
    """Gate order [i, f, g, o] (reference rnn.py:1118). States (h, c)."""

    def __init__(self, input_size, hidden_size,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None):
        super().__init__()
        if hidden_size <= 0:
            raise ValueError("hidden_size must be positive")
        if proj_size < 0:
            raise ValueError("proj_size must be >= 0")
        if proj_size >= hidden_size:
            raise ValueError("proj_size must be smaller than hidden_size")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.proj_size = proj_size
        out_size = proj_size or hidden_size
        init = _stdv_uniform(hidden_size)
        self.weight_ih = self.create_parameter(
            [4 * hidden_size, input_size], ParamAttr._to_attr(weight_ih_attr),
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [4 * hidden_size, out_size], ParamAttr._to_attr(weight_hh_attr),
            default_initializer=init)
        if proj_size:
            self.weight_ho = self.create_parameter(
                [proj_size, hidden_size], None, default_initializer=init)
        else:
            self.weight_ho = None
        self.bias_ih = (None if bias_ih_attr is False else
                        self.create_parameter(
                            [4 * hidden_size], ParamAttr._to_attr(bias_ih_attr),
                            is_bias=True, default_initializer=init))
        self.bias_hh = (None if bias_hh_attr is False else
                        self.create_parameter(
                            [4 * hidden_size], ParamAttr._to_attr(bias_hh_attr),
                            is_bias=True, default_initializer=init))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        pre_h, pre_c = states
        gates = _C_ops.matmul(inputs, self.weight_ih, transpose_y=True)
        if self.bias_ih is not None:
            gates = gates + self.bias_ih
        gates = gates + _C_ops.matmul(pre_h, self.weight_hh, transpose_y=True)
        if self.bias_hh is not None:
            gates = gates + self.bias_hh
        i, f, g, o = _C_ops.split(gates, 4, axis=-1)
        i = _C_ops.sigmoid(i)
        f = _C_ops.sigmoid(f)
        o = _C_ops.sigmoid(o)
        c = f * pre_c + i * _C_ops.tanh(g)
        h = o * _C_ops.tanh(c)
        if self.weight_ho is not None:
            h = _C_ops.matmul(h, self.weight_ho, transpose_y=True)
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.proj_size or self.hidden_size,), (self.hidden_size,))

    def extra_repr(self):
        return "{input_size}, {hidden_size}".format(**self.__dict__)


class GRUCell(RNNCellBase):
    """Gate order [r, z, c]; reset applied after the recurrent matmul
    (reference rnn.py:1316-1324)."""

    def __init__(self, input_size, hidden_size,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if hidden_size <= 0:
            raise ValueError("hidden_size must be positive")
        self.input_size = input_size
        self.hidden_size = hidden_size
        init = _stdv_uniform(hidden_size)
        self.weight_ih = self.create_parameter(
            [3 * hidden_size, input_size], ParamAttr._to_attr(weight_ih_attr),
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [3 * hidden_size, hidden_size], ParamAttr._to_attr(weight_hh_attr),
            default_initializer=init)
        self.bias_ih = (None if bias_ih_attr is False else
                        self.create_parameter(
                            [3 * hidden_size], ParamAttr._to_attr(bias_ih_attr),
                            is_bias=True, default_initializer=init))
        self.bias_hh = (None if bias_hh_attr is False else
                        self.create_parameter(
                            [3 * hidden_size], ParamAttr._to_attr(bias_hh_attr),
                            is_bias=True, default_initializer=init))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        pre_h = states
        x_gates = _C_ops.matmul(inputs, self.weight_ih, transpose_y=True)
        if self.bias_ih is not None:
            x_gates = x_gates + self.bias_ih
        h_gates = _C_ops.matmul(pre_h, self.weight_hh, transpose_y=True)
        if self.bias_hh is not None:
            h_gates = h_gates + self.bias_hh
        x_r, x_z, x_c = _C_ops.split(x_gates, 3, axis=-1)
        h_r, h_z, h_c = _C_ops.split(h_gates, 3, axis=-1)
        r = _C_ops.sigmoid(x_r + h_r)
        z = _C_ops.sigmoid(x_z + h_z)
        c = _C_ops.tanh(x_c + r * h_c)
        h = (pre_h - c) * z + c
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def extra_repr(self):
        return "{input_size}, {hidden_size}".format(**self.__dict__)


class RNN(Layer):
    """Wraps a cell to run over a sequence (paddle's rnn.py:320): a
    Python loop over the time steps, so any cell works."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        if not hasattr(self.cell, "call") and not hasattr(self.cell, "forward"):
            raise TypeError("cell must have a forward method")
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        batch_index = 1 if self.time_major else 0
        time_axis = 0 if self.time_major else 1
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                inputs, batch_dim_idx=batch_index)
        T = inputs.shape[time_axis]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states = initial_states
        outputs = []
        if sequence_length is not None:
            seq = sequence_length
            if not isinstance(seq, Tensor):
                seq = Tensor(np.asarray(seq))
        for t in steps:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            out, new_states = self.cell(x_t, states, **kwargs)
            if sequence_length is not None:
                valid = (seq > t).astype(out.dtype).unsqueeze(-1)
                out = out * valid
                new_states = _map_structure(
                    lambda ns, s: ns * valid + s * (1.0 - valid),
                    new_states, states)
            outputs.append(out)
            states = new_states
        if self.is_reverse:
            outputs = outputs[::-1]
        out = _C_ops.stack(outputs, axis=time_axis)
        return out, states


def _map_structure(fn, a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_map_structure(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


class BiRNN(Layer):
    """Forward + backward cells over a sequence (reference rnn.py:450)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major
        self._fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self._bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        if initial_states is None:
            states_fw = states_bw = None
        else:
            states_fw, states_bw = initial_states
        out_fw, st_fw = self._fw(inputs, states_fw, sequence_length, **kwargs)
        out_bw, st_bw = self._bw(inputs, states_bw, sequence_length, **kwargs)
        out = _C_ops.concat([out_fw, out_bw], axis=-1)
        return out, (st_fw, st_bw)


class RNNBase(LayerList):
    """Multi-layer (bi)directional recurrence dispatching to the fused `rnn`
    op (reference rnn.py:1514; fused path :1730). Parameters are exposed with
    the reference's flat names (weight_ih_l{k}[_reverse], ...)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, proj_size=0):
        super().__init__()
        bidirectional = direction in ("bidirect", "bidirectional")
        if not bidirectional and direction != "forward":
            raise ValueError(
                "direction should be forward or bidirect (or bidirectional), "
                f"received direction = {direction}")
        if mode == "LSTM" and proj_size:
            raise NotImplementedError(
                "proj_size on the fused path is not implemented; use "
                "RNN(LSTMCell(..., proj_size=...)) for projections")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.num_directions = 2 if bidirectional else 1
        self.proj_size = proj_size
        G = {"LSTM": 4, "GRU": 3}.get(mode, 1)
        self._has_bias_ih = bias_ih_attr is not False
        self._has_bias_hh = bias_hh_attr is not False
        init = _stdv_uniform(hidden_size)
        self._flat_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                suffix = "_reverse" if d == 1 else ""
                in_sz = (input_size if layer == 0
                         else hidden_size * self.num_directions)
                w_ih = self.create_parameter(
                    [G * hidden_size, in_sz], ParamAttr._to_attr(weight_ih_attr),
                    default_initializer=init)
                w_hh = self.create_parameter(
                    [G * hidden_size, hidden_size],
                    ParamAttr._to_attr(weight_hh_attr),
                    default_initializer=init)
                names = [f"weight_ih_l{layer}{suffix}",
                         f"weight_hh_l{layer}{suffix}"]
                self.add_parameter(names[0], w_ih)
                self.add_parameter(names[1], w_hh)
                if self._has_bias_ih:
                    b = self.create_parameter(
                        [G * hidden_size], ParamAttr._to_attr(bias_ih_attr),
                        is_bias=True, default_initializer=init)
                    names.append(f"bias_ih_l{layer}{suffix}")
                    self.add_parameter(names[-1], b)
                if self._has_bias_hh:
                    b = self.create_parameter(
                        [G * hidden_size], ParamAttr._to_attr(bias_hh_attr),
                        is_bias=True, default_initializer=init)
                    names.append(f"bias_hh_l{layer}{suffix}")
                    self.add_parameter(names[-1], b)
                self._flat_names.extend(names)
        # the reference's flag; the `rnn` op runs cuDNN on the card
        self.could_use_cudnn = True
        self.state_components = 2 if mode == "LSTM" else 1
        self._cudnn_flat_ptrs = None

    def flatten_parameters(self):
        """On the card, seat each layer's weights as views into one
        contiguous buffer in cuDNN's layout (torch.nn.LSTM's
        flatten_parameters), so cuDNN reads them in place instead of
        compacting them into a copy at every call. The `rnn` op runs one
        layer a call, so each layer has a buffer of its own. Called by
        forward; it does nothing while the weights have not moved since
        the last call, and flattens again after they are re-seated
        (`Layer.to`, a new tensor). Weights without both biases are left
        as they are: the op passes zero biases in their place."""
        ps = [self._parameters[n]._data for n in self._flat_names]
        ptrs = tuple(p.data_ptr() for p in ps)
        if ptrs == self._cudnn_flat_ptrs:
            return
        if not (ps[0].is_cuda and self._has_bias_ih and self._has_bias_hh
                and torch._use_cudnn_rnn_flatten_weight()
                and torch.backends.cudnn.is_acceptable(ps[0])
                and len({p.dtype for p in ps}) == 1):
            return
        mode = {"RNN_RELU": 0, "RNN_TANH": 1, "LSTM": 2, "GRU": 3}[self.mode]
        per_layer = 4 * self.num_directions
        with torch.cuda.device_of(ps[0]), torch.no_grad():
            for layer in range(self.num_layers):
                in_sz = (self.input_size if layer == 0
                         else self.hidden_size * self.num_directions)
                torch._cudnn_rnn_flatten_weight(
                    ps[layer * per_layer:(layer + 1) * per_layer], 4, in_sz,
                    mode, self.hidden_size, 0, 1, False,
                    self.num_directions == 2)
        self._cudnn_flat_ptrs = tuple(p.data_ptr() for p in ps)

    def _weight_list(self):
        """Bundles [w_ih, w_hh, b_ih|None, b_hh|None] per (layer, direction)."""
        bundles = []
        it = iter(self._flat_names)
        for _ in range(self.num_layers * self.num_directions):
            w_ih = self._parameters[next(it)]
            w_hh = self._parameters[next(it)]
            b_ih = self._parameters[next(it)] if self._has_bias_ih else None
            b_hh = self._parameters[next(it)] if self._has_bias_hh else None
            bundles.append([w_ih, w_hh, b_ih, b_hh])
        return bundles

    def forward(self, inputs, initial_states=None, sequence_length=None):
        self.flatten_parameters()
        batch_index = 1 if self.time_major else 0
        B = inputs.shape[batch_index]
        LD = self.num_layers * self.num_directions
        if initial_states is None:
            zero = _C_ops.full([LD, B, self.hidden_size], 0.0, inputs.dtype)
            initial_states = ((zero, zero) if self.mode == "LSTM" else zero)
        if self.mode == "LSTM":
            init_h, init_c = initial_states
        else:
            init_h, init_c = initial_states, None
        mask = None
        if self.dropout > 0.0 and self.training and self.num_layers > 1:
            # scaled masks through the registered dropout op, so
            # paddle.seed governs them
            T = inputs.shape[0 if self.time_major else 1]
            feat = self.hidden_size * self.num_directions
            ones = _C_ops.full([self.num_layers - 1, T, B, feat], 1.0,
                               inputs.dtype)
            mask = _C_ops.dropout(ones, p=self.dropout, training=True,
                                  mode="upscale_in_train")
        seq = None
        if sequence_length is not None:
            seq = (sequence_length if isinstance(sequence_length, Tensor)
                   else Tensor(np.asarray(sequence_length)))
        res = _C_ops.rnn(
            inputs, init_h, init_c, self._weight_list(), seq, mask,
            mode=self.mode, num_layers=self.num_layers,
            is_bidirec=self.num_directions == 2,
            time_major=self.time_major, activation=self.activation)
        if self.mode == "LSTM":
            out, h_n, c_n = res
            return out, (h_n, c_n)
        out, h_n = res
        return out, h_n

    def extra_repr(self):
        s = "{input_size}, {hidden_size}"
        if self.num_layers != 1:
            s += ", num_layers={num_layers}"
        if self.time_major:
            s += ", time_major=True"
        if self.dropout:
            s += ", dropout={dropout}"
        return s.format(**self.__dict__)


class SimpleRNN(RNNBase):
    """Reference rnn.py:1860 (mode RNN_TANH / RNN_RELU)."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        if activation not in ("tanh", "relu"):
            raise ValueError("activation should be tanh or relu")
        super().__init__("RNN_TANH" if activation == "tanh" else "RNN_RELU",
                         input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation,
                         weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr)


class LSTM(RNNBase):
    """Reference rnn.py:1975."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, proj_size=0, name=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, "tanh",
                         weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, proj_size)


class GRU(RNNBase):
    """Reference rnn.py:2115."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, "tanh",
                         weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr)
