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

Both draw their bits as the reference does, from JAX's Threefry-2x32
generator (``prng_key`` is ``jax.random.PRNGKey``'s key, ``_keystream``
``jax.random.bits``, ``_normal`` ``jax.random.normal``), written here in
torch integer ops: the same seed gives the reference's Q and the
reference's keystream, so blobs interoperate both ways.  An explicit ``q``
can still be given in place of the drawn one.
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
            g = _normal(prng_key(seed), (dim, dim))
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
# 2. Threefry-2x32, as jax.random draws it
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# words made at once: on the CPU few enough that a chunk's int64 temporaries
# stay in cache, on the card enough to keep it busy between launches
_CHUNK_WORDS = {"cpu": 1 << 16, "cuda": 1 << 24}


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``'s two uint32 words, as JAX builds them
    in its default 32-bit mode: the seed taken as an int64 (out of that
    range raises, as JAX does), cut to its low 32 bits, then split into
    (seed >> 32, seed & 0xFFFFFFFF), i.e. (0, seed mod 2^32)."""
    low = int(np.int64(seed)) & _M32
    return 0, low


def _threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) of the
    counter pairs (x0, x1) under the key (k1, k2): int64 tensors holding
    uint32 values, updated in place and returned.  Every sum is masked to
    32 bits; a right shift of a value below 2^32 held in int64 is a logical
    one (torch's ``>>`` on int32 is arithmetic)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            rot = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(rot) \
                .bitwise_and_(_M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def _keystream(key: tuple, n_words: int, device="cpu") -> np.ndarray:
    """n_words of uint32 keystream, ``jax.random.bits(key, (n_words,),
    uint32)`` bit for bit: word n is bits1 ^ bits2 of the Threefry hash of
    the counter pair (n >> 32, n & 0xFFFFFFFF) (JAX's partitionable
    counters).  Made on ``device`` in chunks, returned on the host."""
    k1, k2 = (int(w) & _M32 for w in key)
    kind = torch.device(device).type
    if kind not in _CHUNK_WORDS:
        raise ValueError(f"no keystream on a {kind} device")
    chunk = _CHUNK_WORDS[kind]
    out = np.empty(n_words, np.uint32)
    for at in range(0, n_words, chunk):
        n = torch.arange(at, min(n_words, at + chunk),
                         dtype=torch.int64, device=device)
        b0, b1 = _threefry2x32(k1, k2, n >> 32, n.bitwise_and_(_M32))
        words = b0.bitwise_xor_(b1).view(torch.int32)[0::2].contiguous()
        out[at:at + len(words)] = words.cpu().numpy().view(np.uint32)
    return out


# XLA's single-precision ErfInv polynomial (Giles), which JAX's erf_inv
# lowers to: coefficients for w < 5, then for w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv32(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 of fp32 ``x`` by XLA's ``ErfInv32``: w = -log1p(-x^2), then a
    degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-1 go
    to +-inf."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0]),
                    torch.tensor(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, torch.tensor(a), torch.tensor(b)) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _normal(key: tuple, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on the CPU: the Threefry
    bits, their top 23 as the mantissa of a float in [1, 2) less 1, scaled
    to (nextafter(-1, 0), 1), then sqrt(2) * erf^-1."""
    n = int(np.prod(shape))
    bits = torch.from_numpy(_keystream(key, n).view(np.int32))
    mant = (bits.long() & _M32) >> 9
    floats = (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(np.nextafter(np.float32(-1), np.float32(0)))
    hi = torch.tensor(1.0)
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    return (torch.tensor(np.float32(np.sqrt(2))) * _erf_inv32(u)) \
        .reshape(shape)


# ---------------------------------------------------------------------------
# 3. Threefry counter-mode stream cipher (encryption at rest)
# ---------------------------------------------------------------------------
# The keystream is made on ``device`` (a CUDA gallery's on its card); the
# XOR and the blob stay on the host, as the reference's do.
def encrypt_bytes(key: tuple, data: bytes, device="cpu") -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    pad = (-len(buf)) % 4
    buf = np.pad(buf, (0, pad))
    words = buf.view(np.uint32)
    enc = (words ^ _keystream(key, len(words), device)).view(np.uint8)
    return np.concatenate([enc, np.array([pad], np.uint8)])


def decrypt_bytes(key: tuple, blob: np.ndarray, device="cpu") -> bytes:
    pad = int(blob[-1])
    words = blob[:-1].view(np.uint32)
    dec = (words ^ _keystream(key, len(words), device)).view(np.uint8)
    return dec[: len(dec) - pad].tobytes()


def encrypt_array(key: tuple, x: np.ndarray, device="cpu") -> dict:
    blob = encrypt_bytes(key, np.ascontiguousarray(x).tobytes(), device)
    return {"blob": blob, "shape": x.shape, "dtype": str(x.dtype)}


def decrypt_array(key: tuple, enc: dict, device="cpu") -> np.ndarray:
    raw = decrypt_bytes(key, enc["blob"], device)
    return np.frombuffer(raw, enc["dtype"]).reshape(enc["shape"]).copy()
