"""Blockwise-int8 quantized tensors for optimizer state and gradient
compression.

The port of the reference's ``optim/quant.py``.  A ``QTensor`` stores int8
values plus one fp32 scale per block of ``BLOCK`` elements of the
flattened tensor, zero-padded to a whole block: the standard 8-bit
optimizer-state layout (Dettmers et al.).  Rounding and clipping are the
reference's: scale = max(|block|) / 127 (at least 1e-12), values rounded
half to even and clipped to [-127, 127], so both give the same bytes for
the same fp32 input.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

BLOCK = 128


@dataclass
class QTensor:
    q: torch.Tensor                  # int8, (numel padded to BLOCK,)
    scale: torch.Tensor              # fp32, (n_blocks,)
    shape: tuple = ()

    @property
    def dtype(self):
        return torch.int8


def _pad_len(n: int) -> int:
    return (-n) % BLOCK


def quantize(x: torch.Tensor) -> QTensor:
    """Symmetric blockwise int8 quantization of an arbitrary-shape tensor."""
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    blocks = F.pad(flat, (0, _pad_len(flat.numel()))).reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QTensor(q=q.reshape(-1), scale=scale[:, 0], shape=shape)


def dequantize(t: QTensor) -> torch.Tensor:
    blocks = t.q.reshape(-1, BLOCK).float() * t.scale[:, None]
    n = 1
    for s in t.shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(t.shape)


def zeros_like_q(x) -> QTensor:
    """Quantized zeros matching ``x``'s shape (and device, where it has
    one)."""
    n = 1
    for s in x.shape:
        n *= s
    npad = n + _pad_len(n)
    dev = getattr(x, "device", None)
    return QTensor(q=torch.zeros((npad,), dtype=torch.int8, device=dev),
                   scale=torch.zeros((npad // BLOCK,), dtype=torch.float32,
                                     device=dev),
                   shape=tuple(x.shape))
