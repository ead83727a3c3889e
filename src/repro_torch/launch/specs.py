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
    """Random prompt tokens drawn from ``generator`` (on ``device``); the
    reference's labels and modality inputs port with training and their
    families."""
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                    generator=generator, dtype=torch.int32,
                                    device=device)}


def init_cache(cfg, B: int, T: int, *, dtype=MODEL_DTYPE, device=None):
    """Fresh (empty) cache, in ``mdl.cache_specs``'s tree (a list of
    blocks; for the MoE family a dict of ``scan`` and ``prefix``).
    Attention ``pos`` slots, of KV, ring and latent caches alike, hold
    ``POS_EMPTY`` so unwritten entries are masked out (cpos <= pos fails);
    floating leaves without a dtype of their own take ``dtype``."""
    def mk(tree, key=None):
        if isinstance(tree, dict):
            return {k: mk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mk(v, key) for v in tree]
        if key == "pos":
            return torch.full(tree.shape, POS_EMPTY, dtype=tree.dtype,
                              device=device)
        return torch.zeros(tree.shape, dtype=tree.dtype or dtype,
                           device=device)

    return mk(mdl.cache_specs(cfg, B, T))
