"""Carry the reference's state across to the port.

Input is the reference's parameters and state as numpy arrays; output is
the port's modules and a ``SecureGallery`` that compute the same:

* detector and embedder convolution weights, HWIO -> OIHW;
* the embedder's ``lin`` (16*8*8, EMB_DIM), as it is: its rows are in the
  reference's NHWC flatten order, and the port's ``Embedder`` flattens its
  features in that order;
* the gallery's rotation Q (the encrypted blobs themselves do not carry
  over: the two at-rest ciphers differ), and the enrolled raw templates,
  labels and tenants, which are enrolled again in the same order.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.crypto import SecureGallery


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
