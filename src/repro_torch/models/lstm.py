"""Single-layer char-LSTM (paper Task 2: Shakespeare next-char prediction).

McMahan-style FL Shakespeare model: embedding → 1-layer LSTM → linear
head, over a params dict with the JAX package's leaf names and shapes
(``embed (V, E)``, ``wx (E, 4H)``, ``wh (H, 4H)``, ``b (4H)``,
``head/kernel (H, V)``, ``head/bias (V)``); every leaf keeps its JAX
layout, since ``x @ wx`` reads the same in both packages.

The cell is written out rather than taken from ``torch.nn.LSTM``: the
gate order i, f, g, o is PyTorch's, but the forget bias of +1.0 is added
inside the sigmoid after the sum (``σ(f + 1.0)``; folding it into ``b``
would round differently), there is one bias vector, and the cell runs
under ``torch.func.vmap(grad)`` over the clients. The time loop is a
Python loop (the JAX package's ``lax.scan``).

The embedding lookup is ``F.embedding``, whose gradient on the card sums
each row's contributions in a fixed order (its backward sorts the
indices, with no atomics): two runs from the same state give the same
bits, so top-k masks do not move at ties between runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_lstm(generator: torch.Generator, vocab: int, embed_dim: int = 8, hidden: int = 256,
              device="cpu") -> dict:
    """Random params in the JAX package's distributions (scaled normals,
    zero biases), drawn from ``generator`` on the CPU and moved to
    ``device``. ``jax.random`` draws other numbers from the same seed."""
    normal = lambda *shape: torch.randn(*shape, generator=generator)
    params = {
        "embed": normal(vocab, embed_dim) * 0.1,
        "wx": normal(embed_dim, 4 * hidden) * embed_dim**-0.5,
        "wh": normal(hidden, 4 * hidden) * hidden**-0.5,
        "b": torch.zeros(4 * hidden),
        "head": {"kernel": normal(hidden, vocab) * hidden**-0.5,
                 "bias": torch.zeros(vocab)},
    }
    return {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(device)) for k, v in params.items()}


def lstm_forward(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, T) integer → logits (B, T, vocab)."""
    b, t = tokens.shape
    wx, wh, bias = params["wx"], params["wh"], params["b"]
    x = F.embedding(tokens, params["embed"])  # (B, T, E)
    h = c = torch.zeros(b, wh.shape[0], dtype=wh.dtype, device=wh.device)
    hs = []
    for step in range(t):
        gates = x[:, step] @ wx + h @ wh + bias
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1) @ params["head"]["kernel"] + params["head"]["bias"]
