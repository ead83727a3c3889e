"""Carry the reference's state across to the port.

Input is the reference's parameters and state as numpy arrays; output is
the port's modules and a ``SecureGallery`` that compute the same:

* detector and embedder convolution weights, HWIO -> OIHW;
* the embedder's ``lin`` (16*8*8, EMB_DIM), as it is: its rows are in the
  reference's NHWC flatten order, and the port's ``Embedder`` flattens its
  features in that order;
* the gallery's rotation Q (the encrypted blobs themselves do not carry
  over: the two at-rest ciphers differ), and the enrolled raw templates,
  labels and tenants, which are enrolled again in the same order;
* an LM's parameter tree (``lm_params``): the reference stacks every
  block's parameters, and the audio encoder's, on a leading axis (two
  for the hybrid's Mamba-2 layers, gemma3's attention and MLP layers and
  the xLSTM's mLSTM layers: superblock, then layer), the port holds one
  module per block and a list per superblock; the MoE family's ``prefix``
  layers, the ``mtp`` head, the vlm ``projector`` and the encoder's
  ``enc_ln`` are carried as they are, int8 expert matrices and their f32
  scales in their own dtypes.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.crypto import SecureGallery
from repro_torch.models import model as mdl


def conv_weight(w_hwio) -> torch.Tensor:
    """(kh, kw, cin, cout) HWIO -> (cout, cin, kh, kw) OIHW, fp32."""
    w = np.asarray(w_hwio, np.float32)
    if w.ndim != 4:
        raise ValueError(f"conv weight must be 4-D HWIO, got {w.shape}")
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def pipeline_params(detector, embedder: dict) -> dict:
    """The ``params`` of ``build_biometric_pipeline`` from the reference's
    detector weight (HWIO) and embedder params ({"conv": HWIO, "lin"})."""
    return {"detector": conv_weight(detector),
            "embedder": {"conv": conv_weight(embedder["conv"]),
                         "lin": torch.from_numpy(np.array(
                             embedder["lin"], np.float32))}}


def gallery(q, enrollments: Iterable[tuple], *, n_shards: int = 1,
            match_dtype: str = "fp32", seed: int = 7,
            device=None) -> SecureGallery:
    """A ``SecureGallery`` under the reference's rotation ``q`` holding the
    same rows: ``enrollments`` is the reference's enroll calls in order,
    each ``(raw_templates, labels, tenant)``."""
    q = np.asarray(q, np.float32)
    out = SecureGallery(q.shape[0], seed=seed, n_shards=n_shards,
                        match_dtype=match_dtype, device=device, rotation=q)
    for raw, labels, tenant in enrollments:
        out.enroll(np.asarray(raw, np.float32), list(labels), tenant=tenant)
    return out


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor of its dtype; a bf16 array (numpy's
    ``bfloat16`` extension type) goes through fp32, which holds it
    exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _unstack(stacked, n: int, per_layer=None):
    """Entries 0 .. n - 1 of a tree stacked on its leading axis, each
    subtree named in ``per_layer`` ({name: m}) unstacked once more into a
    list of m."""
    out = []
    for i in range(n):
        b = _map(lambda a: np.asarray(a)[i], stacked)
        for name, m in (per_layer or {}).items():
            b[name] = [_map(lambda a: a[j], b[name]) for j in range(m)]
        out.append(b)
    return out


def lm_params(cfg, params_np) -> "mdl.LM":
    """The port's model holding the reference's parameters (a tree of
    numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives):
    ``embed``, ``final_ln``, ``prefix``, ``shared``, ``projector``,
    ``enc_ln`` and ``mtp`` as they are, ``blocks`` and ``encoder`` unstacked
    into one entry per block (and the hybrid's ``mamba``, gemma3's
    ``attn`` and ``mlp`` and the xLSTM's ``m`` into one per layer)."""
    sb = cfg.superblock
    per_layer = {"hybrid": {"mamba": sb}, "gemma3": {"attn": sb, "mlp": sb},
                 "ssm": {"m": sb - 1}}.get(cfg.family)
    tree = {k: v for k, v in params_np.items()
            if k not in ("blocks", "encoder")}
    tree["blocks"] = _unstack(params_np["blocks"], cfg.n_superblocks,
                              per_layer)
    if "encoder" in params_np:
        tree["encoder"] = _unstack(params_np["encoder"], cfg.encoder_layers)
    return mdl.LM(cfg, _map(_tensor, tree))
