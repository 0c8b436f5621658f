"""Plain full-softmax attention: the single-device oracle.

Port of ``full_attention_reference`` (``theanompi_tpu/ops/ring_attention.py``):
the test oracle of the flash kernels and the local step of
``attn="ring"`` without sequence parallelism. ``ring_attention`` and
``ulysses_attention`` come with the sequence-parallel slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# masked-logit sentinel (finite: keeps exp/max NaN-free), as the reference
NEG = -1e30


def full_attention_reference(q, k, v, causal: bool = False, scale: Optional[float] = None,
                             precision=None) -> torch.Tensor:
    """``[B, Tq, H, D], [B, Tk, H, D] x2 -> [B, Tq, H, D]`` in q's dtype.

    Scores and the softmax in fp32; the causal mask is ``row >= col``
    aligned at the start, valid for Tq != Tk. ``precision`` is accepted
    for the reference's signature: the products run in fp32 here either
    way (the port keeps TF32 off, ``device.py``)."""
    del precision
    B, T, H, D = q.shape
    Tk = k.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
    if causal:
        mask = torch.arange(T, device=q.device)[:, None] >= torch.arange(Tk, device=q.device)[None]
        s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)
