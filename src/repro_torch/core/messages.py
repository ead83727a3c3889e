"""Typed message contracts between cartridges (the CHAMP bus framing).

Every payload traveling the bus is a ``Message``: a sequence-numbered, typed
pytree of tensors. Cartridges advertise ``consumes``/``produces`` as ``MessageSpec``s;
VDiSK type-checks chains at registration time (paper §3.2: "a common protocol
for data exchange ... framing for messages ... tagged with metadata about
type and size").
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

# Canonical message kinds (paper §3.2 cartridge list)
IMAGE_FRAME = "image_frame"          # (H, W, 3) uint8/float
BBOXES = "bboxes"                    # (N, 5) [x0,y0,x1,y1,score]
FACE_CROPS = "face_crops"            # (N, h, w, 3)
EMBEDDING = "embedding"              # (N, D) float
QUALITY = "quality"                  # (N,) float
MATCH_RESULT = "match_result"        # (N, k) ids + scores
TOKENS = "tokens"                    # (S,) int32 (document/NLP cartridges)
LOGITS = "logits"
ENCRYPTED_BLOB = "encrypted_blob"


@dataclass(frozen=True)
class MessageSpec:
    """A typed port: message kind + array schema (None entries = wildcard)."""
    kind: str
    shape: Optional[Tuple[Optional[int], ...]] = None
    dtype: Any = None

    def accepts(self, other: "MessageSpec") -> bool:
        if self.kind != other.kind:
            return False
        if self.shape is not None and other.shape is not None:
            if len(self.shape) != len(other.shape):
                return False
            for a, b in zip(self.shape, other.shape):
                if a is not None and b is not None and a != b:
                    return False
        if self.dtype is not None and other.dtype is not None:
            if np.dtype(self.dtype) != np.dtype(other.dtype):
                return False
        return True

    def describe(self) -> str:
        return f"{self.kind}{list(self.shape) if self.shape else ''}"


@dataclass
class Message:
    """One bus message. ``payload`` is a pytree of arrays."""
    kind: str
    seq: int
    payload: Any
    meta: dict = field(default_factory=dict)
    t_created: float = 0.0

    def nbytes(self) -> int:
        # counted as the reference counts its JAX pytrees, byte for byte:
        # bus transfer times in virtual time follow this number.  torch's
        # pytree keeps None as a leaf where JAX drops it, so skip it here.
        total = 0
        for x in tree_leaves(self.payload):
            if x is None:
                continue
            if isinstance(x, torch.Tensor):
                total += x.numel() * x.element_size()
            elif hasattr(x, "shape") and hasattr(x, "dtype"):
                total += int(np.prod(x.shape) * np.dtype(x.dtype).itemsize)
            elif isinstance(x, (bytes, str)):
                total += len(x)
            else:
                total += 8
        return total

    def with_payload(self, payload, kind=None) -> "Message":
        return dataclasses.replace(self, payload=payload,
                                   kind=kind or self.kind)


class TypeError_(Exception):
    """Chain type mismatch (named to avoid shadowing builtins)."""
