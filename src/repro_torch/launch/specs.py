"""Concrete model inputs and caches for the LM stack.

The port of the reference's ``launch/specs.py`` helpers that serving uses
(``make_batch``, ``init_cache``); the ``ShapeDtypeStruct`` stand-ins for
lowering have no counterpart here (PyTorch runs eagerly) and port with the
mesh tooling (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as mdl

MODEL_DTYPE = torch.bfloat16
POS_EMPTY = 1 << 30     # an unwritten cache slot's position: always masked


def make_batch(cfg, S: int, B: int, generator: torch.Generator,
               device=None):
    """Random prompt tokens and, for the vlm and audio families, the
    modality inputs (``patches`` (B, n_patches, vit_dim), ``frames``
    (B, encoder_len, d_model), N(0, 1) in ``MODEL_DTYPE``), drawn from
    ``generator`` (on ``device``) in that order; the reference's labels
    port with training."""
    b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                 generator=generator, dtype=torch.int32,
                                 device=device)}
    shape = {"vlm": (B, cfg.n_patches, cfg.vit_dim),
             "audio": (B, cfg.encoder_len, cfg.d_model)}.get(cfg.family)
    if shape is not None:
        name = "patches" if cfg.family == "vlm" else "frames"
        b[name] = torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32).to(MODEL_DTYPE)
    return b


def init_cache(cfg, B: int, T: int, *, dtype=MODEL_DTYPE, device=None):
    """Fresh (empty) cache, in ``mdl.cache_specs``'s tree (a list of
    blocks; for the MoE family a dict of ``scan`` and ``prefix``, for the
    audio family of ``dec`` and ``cross``).  Attention ``pos`` slots, of
    KV, ring and latent caches alike, hold ``POS_EMPTY`` so unwritten
    entries are masked out (cpos <= pos fails); the xLSTM stabilizers
    (fp32 leaves named ``m``) hold -1e30, as the reference's; floating
    leaves without a dtype of their own take ``dtype``."""
    def mk(tree, key=None):
        if isinstance(tree, dict):
            return {k: mk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mk(v, key) for v in tree]
        dt = tree.dtype or dtype
        if key == "pos":
            return torch.full(tree.shape, POS_EMPTY, dtype=dt, device=device)
        if key == "m" and dt == torch.float32:
            return torch.full(tree.shape, -1e30, dtype=dt, device=device)
        return torch.zeros(tree.shape, dtype=dt, device=device)

    return mk(mdl.cache_specs(cfg, B, T))
