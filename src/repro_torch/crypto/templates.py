"""Cryptographically protected biometric templates (paper §3.1/§3.2).

The paper's database cartridge stores galleries encrypted and matches
templates "under encryption" with VDiSK's template-privacy layer.  Two
complementary mechanisms:

1. ``KeyedRotation`` — a secret orthogonal transform Q (the QR of a seeded
   Gaussian).  Protected templates t' = Q t preserve inner products and
   norms, so cosine-similarity matching runs directly on protected
   templates without revealing the raw embedding basis.  Revocability:
   re-key by drawing a new Q (cancellable biometrics).

2. ``encrypt_bytes`` / ``decrypt_bytes`` — a counter-mode XOR stream cipher
   for templates and metadata at rest on the storage cartridge (byte-exact
   decrypt).

Differences from the reference, which draws both from ``jax.random``:
the Gaussian behind Q comes from a seeded CPU ``torch.Generator`` (an
explicit ``q`` can be given instead, to carry a reference gallery's key
across), and the keystream is numpy's Philox counter-based generator keyed
by an integer.  So blobs do not interoperate with the reference's Threefry
blobs; match results do, given the same Q.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# 1. Cosine-preserving keyed rotation
# ---------------------------------------------------------------------------
class KeyedRotation:
    def __init__(self, dim: int, seed: int, q=None):
        self.dim = dim
        self.seed = seed
        if q is None:
            gen = torch.Generator().manual_seed(seed)
            g = torch.randn((dim, dim), generator=gen, dtype=torch.float32)
            qm, r = torch.linalg.qr(g)
            # fix signs so Q is unique given the seed (deterministic re-keying)
            q = qm * torch.sign(torch.diagonal(r))[None, :]
        if not isinstance(q, torch.Tensor):
            q = torch.from_numpy(np.array(q, np.float32))
        q = q.float().cpu()
        if tuple(q.shape) != (dim, dim):
            raise ValueError(f"rotation must be ({dim}, {dim}), not "
                             f"{tuple(q.shape)}")
        self._by_device = {q.device: q}

    def q(self, device="cpu") -> torch.Tensor:
        """The (dim, dim) rotation on ``device`` (copied there once)."""
        device = torch.device(device)
        if device not in self._by_device:
            self._by_device[device] = self._by_device[torch.device("cpu")] \
                .to(device)
        return self._by_device[device]

    def protect(self, t: torch.Tensor) -> torch.Tensor:
        """t: (..., dim) raw templates -> protected templates."""
        return t.float() @ self.q(t.device)

    def unprotect(self, tp: torch.Tensor) -> torch.Tensor:
        return tp.float() @ self.q(tp.device).T


def cosine_scores(queries: torch.Tensor, gallery: torch.Tensor):
    """(Q,d) x (N,d) -> (Q,N) cosine similarity (works on protected or raw
    templates identically when both sides share the same KeyedRotation)."""
    qn = queries / torch.clamp(
        torch.linalg.vector_norm(queries, dim=-1, keepdim=True), min=1e-9)
    gn = gallery / torch.clamp(
        torch.linalg.vector_norm(gallery, dim=-1, keepdim=True), min=1e-9)
    return qn @ gn.T


# ---------------------------------------------------------------------------
# 2. Philox counter-mode stream cipher (encryption at rest)
# ---------------------------------------------------------------------------
def _keystream(key: int, n_words: int) -> np.ndarray:
    """n_words of uint32 keystream: Philox-4x64 blocks for counters 0, 1,
    2, ... under ``key``."""
    raw = np.random.Philox(key=key).random_raw((n_words + 1) // 2)
    return raw.view(np.uint32)[:n_words]


def encrypt_bytes(key: int, data: bytes) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    pad = (-len(buf)) % 4
    buf = np.pad(buf, (0, pad))
    words = buf.view(np.uint32)
    enc = (words ^ _keystream(key, len(words))).view(np.uint8)
    return np.concatenate([enc, np.array([pad], np.uint8)])


def decrypt_bytes(key: int, blob: np.ndarray) -> bytes:
    pad = int(blob[-1])
    words = blob[:-1].view(np.uint32)
    dec = (words ^ _keystream(key, len(words))).view(np.uint8)
    return dec[: len(dec) - pad].tobytes()


def encrypt_array(key: int, x: np.ndarray) -> dict:
    blob = encrypt_bytes(key, np.ascontiguousarray(x).tobytes())
    return {"blob": blob, "shape": x.shape, "dtype": str(x.dtype)}


def decrypt_array(key: int, enc: dict) -> np.ndarray:
    raw = decrypt_bytes(key, enc["blob"])
    return np.frombuffer(raw, enc["dtype"]).reshape(enc["shape"]).copy()
