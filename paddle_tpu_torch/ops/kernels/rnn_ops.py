"""The fused recurrent-network op `rnn` — port of
`paddle_tpu/ops/kernels/rnn_ops.py`.

The reference runs the (layers x directions x time) recurrence as a
`lax.scan` with no Pallas kernel. The port calls torch's RNN functions
(`torch.lstm`, `torch.gru`, `torch.rnn_tanh`, `torch.rnn_relu`: cuDNN on
the card, ATen's loop on the CPU) one layer at a time, both directions
in one call, so the reference's inter-layer `dropout_mask` applies
between layers. `seq_lens` runs the layer on a packed sequence: the
state freezes at each row's length, outputs past it are 0, and the
reverse direction starts from its row's last valid step, as the
reference's masked scan does.

Weights need no remapping: the reference stores them as torch does,
W_ih [G*H, in], W_hh [G*H, H], biases [G*H], LSTM gates [i, f, g, o],
GRU gates [r, z, c] with h = (h_prev - c) * z + c (torch's
(1 - z) * n + z * h) and b_hh inside the reset product. A missing bias
is a zero bias. A simple RNN's nonlinearity is `activation`'s.
"""
from __future__ import annotations

import torch
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, \
    pad_packed_sequence

from ..dispatch import register_op


def _fn(mode, activation):
    if mode == "LSTM":
        return torch.lstm
    if mode == "GRU":
        return torch.gru
    return torch.rnn_tanh if activation == "tanh" else torch.rnn_relu


def _params(bundles):
    out = []
    for w_ih, w_hh, b_ih, b_hh in bundles:
        zero = torch.zeros(w_ih.shape[0], dtype=w_ih.dtype,
                           device=w_ih.device)
        out += [w_ih, w_hh, zero if b_ih is None else b_ih,
                zero if b_hh is None else b_hh]
    return out


@register_op("rnn")
def rnn(x, initial_h, initial_c, weight_list, seq_lens=None, dropout_mask=None,
        *, mode="LSTM", num_layers=1, is_bidirec=False, time_major=False,
        activation="tanh"):
    """Multi-layer (bi)directional recurrence.

    x [B, T, in] ([T, B, in] when time_major); initial_h / initial_c
    [L*D, B, H] (initial_c only for LSTM); weight_list: the [w_ih, w_hh,
    b_ih | None, b_hh | None] bundles by (layer, direction); dropout_mask
    [num_layers-1, ...] scaled masks applied to the outputs of layers
    0..L-2. Returns (out, h_n, c_n), or (out, h_n) but for LSTM."""
    D = 2 if is_bidirec else 1
    fn = _fn(mode, activation)
    lstm = mode == "LSTM"
    x_tm = x if time_major else x.transpose(0, 1)
    T = x_tm.shape[0]
    lens = None if seq_lens is None else seq_lens.reshape(-1).to(
        "cpu", torch.int64)
    hs, cs = [], []
    for layer in range(num_layers):
        sl = slice(layer * D, (layer + 1) * D)
        params = _params(weight_list[sl])
        h0 = initial_h[sl]
        if lstm:
            c0 = initial_c[sl] if initial_c is not None \
                else torch.zeros_like(h0)
        if lens is None:
            hx = (h0, c0) if lstm else h0
            res = fn(x_tm, hx, params, True, 1, 0.0, True, is_bidirec,
                     False)
            out = res[0]
            hT = res[1]
            cT = res[2] if lstm else None
        else:
            pk = pack_padded_sequence(x_tm, lens, enforce_sorted=False)
            order, back = pk.sorted_indices, pk.unsorted_indices
            hx = ((h0.index_select(1, order), c0.index_select(1, order))
                  if lstm else h0.index_select(1, order))
            res = fn(pk.data, pk.batch_sizes, hx, params, True, 1, 0.0,
                     True, is_bidirec)
            out = pad_packed_sequence(
                PackedSequence(res[0], pk.batch_sizes, order, back),
                total_length=T)[0]
            hT = res[1].index_select(1, back)
            cT = res[2].index_select(1, back) if lstm else None
        hs.append(hT)
        if lstm:
            cs.append(cT)
        x_tm = out
        if dropout_mask is not None and layer < num_layers - 1:
            x_tm = x_tm * dropout_mask[layer]
    out = x_tm if time_major else x_tm.transpose(0, 1)
    h_n = torch.cat(hs)
    if not lstm:
        return out, h_n
    return out, h_n, torch.cat(cs)
