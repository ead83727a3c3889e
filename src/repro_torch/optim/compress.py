"""Int8 error-feedback gradient compression for the cross-``data`` reduce.

The port of the reference's ``optim/compress.py``: each gradient leaf plus
its bf16 residual is quantized to blockwise int8 (``quant.quantize``), and
the quantization error becomes the next residual, so the error is
re-injected next step instead of lost (1-bit SGD / Deep Gradient
Compression family).

    cg, new_resid = compress_with_feedback(grads, resid)
    # ship cg across hosts, then
    g = decompress(cg)

Trees are dicts of tensors by name, as the optimizers take them.
"""
from __future__ import annotations

import torch

from repro_torch.optim.quant import dequantize, quantize


def init_residual(params):
    return {k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
            for k, p in params.items()}


def compress_with_feedback(grads, resid):
    """Returns (dict of QTensor grads, dict of new bf16 residuals)."""
    qs, rs = {}, {}
    for k, g in grads.items():
        gf = g.float() + resid[k].float()
        q = quantize(gf)
        qs[k], rs[k] = q, (gf - dequantize(q)).to(torch.bfloat16)
    return qs, rs


def decompress(qgrads):
    return {k: dequantize(q) for k, q in qgrads.items()}
