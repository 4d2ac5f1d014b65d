"""LSTM prediction-network step, gate order [i, f, g, o] (port of
nemotron_tpu/ops/lstm.py)."""

from __future__ import annotations

import torch


def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """x: [B, I]; h, c: [B, H]; weights (4H, I) / (4H, H)."""
    gates = x @ w_ih.T + h @ w_hh.T + (b_ih + b_hh)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def lstm2_step(dec, x, h, c):
    """Two stacked LSTM layers. h, c: [B, 2, H]. Returns (out, h', c')."""
    h0, c0 = lstm_cell(x, h[:, 0], c[:, 0], dec.w_ih[0], dec.w_hh[0],
                       dec.b_ih[0], dec.b_hh[0])
    h1, c1 = lstm_cell(h0, h[:, 1], c[:, 1], dec.w_ih[1], dec.w_hh[1],
                       dec.b_ih[1], dec.b_hh[1])
    return h1, torch.stack([h0, h1], dim=1), torch.stack([c0, c1], dim=1)
