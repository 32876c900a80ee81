"""The numbers that decide ``correct``: relative gaps to the reference."""
from __future__ import annotations

import torch

_CHUNK = 1 << 24


def rel_l2(got, want) -> float:
    """``||got - want|| / ||want||`` in float64, in chunks."""
    g, w = got.reshape(-1), want.reshape(-1)
    if g.numel() != w.numel():
        return float("inf")
    num = den = 0.0
    for s in range(0, w.numel(), _CHUNK):
        gw = g[s:s + _CHUNK].double()
        ww = w[s:s + _CHUNK].double().to(gw.device)
        num += float(torch.sum((gw - ww) ** 2))
        den += float(torch.sum(ww * ww))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return (num / den) ** 0.5

