"""Secure gallery store — the paper's Database/Storage cartridge brain.

Holds a biometric gallery (N templates + identity labels) where templates
live in the protected (rotated) space and the backing arrays are encrypted
at rest with the stream cipher.  Matching happens entirely in protected
space via the ``gallery_match`` kernel (cosine top-k); raw embeddings never
exist inside the store.

The store also "defines the necessary matching calculation for the
template type it stores" (paper fig. 2): `match()` is the store's own
calculation, parameterized by template kind.

Identification fast path (sharded + quantized).  The protected gallery is
held as ``n_shards`` independently encrypted shards — one per lane-group
replica in the engine topology: a slot with N replicas searches an
N×-larger gallery at the per-shard latency, and ``match`` merges the
per-shard top-k into a global top-k on the host.  Each shard keeps a
*prepared* match-time view on the store's device (decrypt once →
L2-normalize → optionally bf16-cast or int8 per-row quantize with scales),
built lazily and invalidated by ``enroll``/``rekey``/``reshard``;
``seal()`` drops the plaintext views so only the encrypted-at-rest blobs
remain resident.  Match dtypes: ``"fp32"`` (oracle), ``"bf16"``,
``"int8"``.

This is the port of the reference's exact mode.  The two-level ANN tier
(``build_ann_index``, ``match(mode="ann")``) comes with the next slice of
the port, with its rescore kernel; here it raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.crypto.templates import (KeyedRotation, decrypt_array,
                                          encrypt_array)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K

MATCH_DTYPES = ("fp32", "bf16", "int8")
MATCH_MODES = ("exact", "ann")
_ANN_LATER = ("the ANN tier (build_ann_index, match(mode='ann')) is not "
              "ported yet: it comes with the next slice of the PyTorch "
              "port, with the cell rescore kernel")


def _deficit_alloc(sizes: np.ndarray, n_new: int) -> np.ndarray:
    """How many of ``n_new`` rows each shard gets so final sizes are as
    level as possible *without moving existing rows*: water-fill the
    smallest shards up to a common level, remainder to the smallest
    results first (stable by shard id, so allocation is deterministic)."""
    sizes = np.asarray(sizes, np.int64)
    if n_new <= 0:
        return np.zeros(len(sizes), np.int64)
    lo, hi = int(sizes.min()), int(sizes.max()) + n_new
    while lo < hi:                     # max level T reachable with n_new
        mid = (lo + hi + 1) // 2
        if int(np.maximum(mid - sizes, 0).sum()) <= n_new:
            lo = mid
        else:
            hi = mid - 1
    alloc = np.maximum(lo - sizes, 0)
    rem = n_new - int(alloc.sum())
    if rem:
        order = np.argsort(sizes + alloc, kind="stable")
        alloc[order[:rem]] += 1
    return alloc


def _cipher_key(seed: int) -> int:
    return seed ^ 0x5EC2E7


class SecureGallery:
    def __init__(self, dim: int, *, seed: int = 7, template_kind: str =
                 "face_embedding", n_shards: int = 1,
                 match_dtype: str = "fp32", device=None, rotation=None):
        """``device``: where the prepared match views live and the kernel
        runs (None = the card).  ``rotation``: an explicit (dim, dim)
        rotation Q in place of the one drawn from ``seed``."""
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if match_dtype not in MATCH_DTYPES:
            raise ValueError(f"match_dtype must be one of {MATCH_DTYPES}")
        self.device = resolve_device(device)
        self.dim = dim
        self.template_kind = template_kind
        self.match_dtype = match_dtype
        self.rotation = KeyedRotation(dim, seed, rotation)
        self._cipher_key = _cipher_key(seed)
        # per-shard encrypted blobs + the global row ids each shard holds
        self._shards: List[Optional[dict]] = [None] * n_shards
        self._shard_ids: List[np.ndarray] = [
            np.empty((0,), np.int64) for _ in range(n_shards)]
        self._prep: List[dict] = [{} for _ in range(n_shards)]
        self._labels: list = []
        self._label_arr: Optional[np.ndarray] = None
        self._n = 0
        # multi-tenant isolation: every row carries its enrolling
        # tenant's code (gid-indexed, so tags survive reshard/failover);
        # code 0 = the untagged / fleet-operator pool.  match(tenant=...)
        # scopes scoring to that tenant's rows
        self._tenant_codes: dict = {None: 0}
        self._tenant_names: list = [None]
        self._tenant_tags = np.empty((0,), np.int32)
        self.ann_stats = {"trainings": 0, "assign_calls": 0, "packs": 0}
        self.failovers = 0                 # shard rebuilds after lane death
        self.last_match_stats: dict = {}
        # optional FlightRecorder: failovers emit instants at
        # tracer.clock() (the gallery has no clock of its own)
        self.tracer = None

    # -- enrollment ------------------------------------------------------------
    def _tenant_code(self, tenant, create: bool = False) -> int:
        code = self._tenant_codes.get(tenant)
        if code is None:
            if not create:
                raise KeyError(f"unknown tenant {tenant!r}: no rows "
                               "enrolled under that name")
            code = len(self._tenant_names)
            self._tenant_codes[tenant] = code
            self._tenant_names.append(tenant)
        return code

    def has_tenant(self, tenant) -> bool:
        """True when ``tenant`` has enrolled rows to match against."""
        code = self._tenant_codes.get(tenant)
        return code is not None and bool((self._tenant_tags == code).any())

    def tenant_rows(self) -> dict:
        """Enrolled row count per tenant (None = the untagged pool)."""
        out = {}
        for name, code in self._tenant_codes.items():
            n = int((self._tenant_tags == code).sum())
            if n or name is None:
                out[name] = n
        return out

    def _protect_host(self, raw) -> np.ndarray:
        """Raw templates (array or tensor) -> protected fp32 rows on the
        host, where the at-rest cipher runs.  The rotation runs on the
        store's device."""
        raw = torch.as_tensor(raw).to(self.device)
        return self.rotation.protect(raw).cpu().numpy().astype(np.float32)

    def enroll(self, raw_templates, labels, tenant=None):
        """raw (N, dim) embeddings -> protected + encrypted at rest,
        distributed across shards by *deficit* (each shard receives
        enough rows to level the sizes).  ``tenant`` tags the rows for
        scoped matching (None = the shared fleet pool)."""
        prot = self._protect_host(raw_templates)
        n_new = prot.shape[0]
        gids = np.arange(self._n, self._n + n_new, dtype=np.int64)
        code = self._tenant_code(tenant, create=True)
        self._tenant_tags = np.concatenate(
            [self._tenant_tags, np.full(n_new, code, np.int32)])
        alloc = _deficit_alloc([len(ids) for ids in self._shard_ids], n_new)
        offsets = np.concatenate([[0], np.cumsum(alloc)])
        for shard in range(self.n_shards):
            rows = np.arange(offsets[shard], offsets[shard + 1])
            if len(rows) == 0:
                continue
            self._append_to_shard(int(shard), prot[rows], gids[rows])
        self._labels = list(self._labels) + list(labels)
        self._label_arr = None
        self._n = len(self._labels)

    def _append_to_shard(self, s: int, prot: np.ndarray, gids: np.ndarray):
        if self._shards[s] is not None:
            prev = decrypt_array(self._cipher_key, self._shards[s])
            prot = np.concatenate([prev, prot], axis=0)
        self._shards[s] = encrypt_array(self._cipher_key, prot)
        self._shard_ids[s] = np.concatenate([self._shard_ids[s], gids])
        self._prep[s] = {}                         # plaintext view is stale

    def __len__(self):
        return self._n

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    def shard_sizes(self) -> List[int]:
        return [len(ids) for ids in self._shard_ids]

    # -- matching ----------------------------------------------------------------
    def protected_gallery(self) -> torch.Tensor:
        """All protected templates, in global enrollment order (on the
        host)."""
        assert self._n > 0, "empty gallery"
        out = np.empty((self._n, self.dim), np.float32)
        for s in range(self.n_shards):
            if len(self._shard_ids[s]):
                out[self._shard_ids[s]] = decrypt_array(
                    self._cipher_key, self._shards[s])
        return torch.from_numpy(out)

    def _prepare(self, s: int, dtype: str) -> dict:
        """Decrypt-once match-time view of shard ``s`` for ``dtype`` on the
        store's device: pre-normalized rows, plus the int8 values/scales
        for the quantized path (queries are normalized in the kernel; the
        gallery is normalized here)."""
        prep = self._prep[s]
        if "gn" not in prep:
            g = torch.from_numpy(decrypt_array(
                self._cipher_key, self._shards[s])).to(self.device)
            prep["gn"] = g / torch.clamp(torch.linalg.vector_norm(
                g, dim=-1, keepdim=True), min=1e-9)
        if dtype == "bf16" and "gn_bf16" not in prep:
            prep["gn_bf16"] = prep["gn"].to(torch.bfloat16)
        if dtype == "int8" and "q8" not in prep:
            prep["q8"], prep["scale"] = K.prepare_gallery_quant(prep["gn"])
        return prep

    def seal(self):
        """Drop every plaintext match-time view; only the encrypted-at-rest
        blobs stay resident (next ``match`` re-prepares)."""
        self._prep = [{} for _ in self._shards]

    def _tenant_shard_rows(self, s: int, code: int) -> np.ndarray:
        """Shard-local row indices belonging to a tenant (cached in the
        shard's prep view, so invalidation follows the same
        enroll/rekey/reshard lifecycle as the decrypted arrays)."""
        cache = self._prep[s].setdefault("tenant_rows", {})
        rows = cache.get(code)
        if rows is None:
            rows = cache[code] = np.nonzero(
                self._tenant_tags[self._shard_ids[s]] == code)[0]
        return rows

    def _match_shard(self, s: int, q: torch.Tensor, k: int, dtype: str,
                     rows: Optional[np.ndarray] = None):
        """Exact top-k over one shard; ``rows`` restricts scoring to a
        tenant's subset view (the int8 path subsets the per-row quantized
        values/scales directly — per-row quantization makes the subset
        bit-identical to quantizing the subset).  Returns host arrays;
        indices are shard-local."""
        prep = self._prepare(s, dtype)
        sel = None
        if rows is not None:
            sel = torch.from_numpy(rows).to(self.device)
        if dtype == "int8":
            q8, scale = prep["q8"], prep["scale"]
            if sel is not None:
                q8, scale = q8[sel], scale[sel]
            scores, idx = K.gallery_match_quant(q, q8, scale, k=k)
        else:
            gn = prep["gn_bf16"] if dtype == "bf16" else prep["gn"]
            if sel is not None:
                gn = gn[sel]
            scores, idx = K.gallery_match_fused(q, gn, k=k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        if rows is not None:
            idx = rows[idx]
        return scores, idx

    # -- two-level ANN tier ------------------------------------------------------
    def build_ann_index(self, *, n_cells: Optional[int] = None,
                        iters: int = 6, seed: int = 0):
        raise NotImplementedError(_ANN_LATER)

    # -- matching entry ----------------------------------------------------------
    def match(self, raw_queries, k: int = 5, dtype: Optional[str] = None, *,
              mode: str = "exact", nprobe: int = 8, tenant=None):
        """Match raw query embeddings; returns (labels, scores).

        Queries are protected with the same rotation, then matched in
        protected space (cosine is invariant under the shared rotation).
        Each shard is searched in full (one kernel call per shard, i.e.
        per replica lane).  The per-shard top-k merge to a global top-k
        runs on the host and breaks score ties by **global id**, so
        results are invariant to the shard topology; ``dtype`` selects
        the score path (default: the store's ``match_dtype``).

        ``tenant`` scopes the search to rows enrolled under that tenant
        (one tenant's watchlist never serves another's match).
        ``tenant=None`` searches the whole gallery.  ``labels`` is a host
        object array; ``scores`` a host float32 tensor.
        """
        assert self._n > 0, "empty gallery"
        dtype = dtype or self.match_dtype
        if dtype not in MATCH_DTYPES:
            raise ValueError(f"dtype must be one of {MATCH_DTYPES}")
        if mode not in MATCH_MODES:
            raise ValueError(f"mode must be one of {MATCH_MODES}")
        if mode == "ann":
            raise NotImplementedError(_ANN_LATER)
        code = None
        n_scope = self._n
        if tenant is not None:
            code = self._tenant_code(tenant)
            n_scope = int((self._tenant_tags == code).sum())
            if n_scope == 0:
                raise ValueError(f"tenant {tenant!r} has no enrolled rows")
        k = min(k, n_scope)
        q = self.rotation.protect(torch.as_tensor(raw_queries)
                                  .to(self.device))
        cell_rows = 0
        shard_scores, shard_gids = [], []
        for s in range(self.n_shards):
            rows = None
            n_s = len(self._shard_ids[s])
            if code is not None and n_s:
                rows = self._tenant_shard_rows(s, code)
                n_s = len(rows)
            if n_s == 0:
                continue
            scores, idx = self._match_shard(s, q, min(k, n_s), dtype, rows)
            shard_scores.append(scores)
            shard_gids.append(self._shard_ids[s][idx])
            cell_rows += n_s          # exact: the whole scope scored
        all_s = np.concatenate(shard_scores, axis=1)       # (Q, sum ks)
        all_g = np.concatenate(shard_gids, axis=1)
        if len(shard_scores) > 1:                          # top-k merge
            # primary key: score desc; tie-break: global id asc — equal
            # scores order identically for every reshard() topology
            # (sentinel slots sink: NEG scores with id -1)
            sort_g = np.where(all_g < 0, np.iinfo(np.int64).max, all_g)
            top = np.lexsort((sort_g, -all_s), axis=1)[:, :k]
            all_s = np.take_along_axis(all_s, top, axis=1)
            all_g = np.take_along_axis(all_g, top, axis=1)
        self.last_match_stats = {
            "mode": mode, "dtype": dtype, "rows_total": self._n,
            "centroid_rows": 0, "cell_rows": cell_rows,
            "rows_scored": cell_rows,
            "scan_fraction": cell_rows / self._n,
        }
        if tenant is not None:
            self.last_match_stats["tenant"] = tenant
            self.last_match_stats["tenant_rows"] = n_scope
        if self._label_arr is None:     # built once per enroll, not per
            # match: at a million rows the object array costs milliseconds
            self._label_arr = np.asarray(self._labels, object)
        labels = np.where(all_g >= 0,
                          self._label_arr[np.clip(all_g, 0, None)], None)
        return labels, torch.from_numpy(np.ascontiguousarray(all_s))

    # -- topology ----------------------------------------------------------------
    def failover_shard(self, dead: int, into: Optional[int] = None) -> int:
        """A replica lane died: absorb its shard into a survivor.

        The rebuild reads the dead shard's *encrypted-at-rest* blob —
        never a decrypted ``_prep`` view — so failover works after
        ``seal()`` and a crashed lane's plaintext working set is never
        the recovery source.  Global row ids ride along.  The dead shard
        stays in the topology as an empty slot — matching a lane group
        running one replica short until the operator reshards.  Returns
        the absorbing shard's index."""
        if not 0 <= dead < self.n_shards:
            raise ValueError(f"no shard {dead}; this gallery has "
                             f"{self.n_shards}")
        if self.n_shards < 2:
            raise ValueError("cannot fail over a single-shard gallery: "
                             "no surviving shard to absorb into")
        if into is None:
            survivors = [s for s in range(self.n_shards) if s != dead]
            into = min(survivors,
                       key=lambda s: (len(self._shard_ids[s]), s))
        elif into == dead or not 0 <= into < self.n_shards:
            raise ValueError(f"bad failover target {into} for dead "
                             f"shard {dead}")
        if self._shards[dead] is not None and len(self._shard_ids[dead]):
            prot = decrypt_array(self._cipher_key, self._shards[dead])
            self._append_to_shard(into, prot, self._shard_ids[dead])
        self._shards[dead] = None
        self._shard_ids[dead] = np.empty((0,), np.int64)
        self._prep[dead] = {}
        self.failovers += 1
        if self.tracer is not None:
            self.tracer.instant("gallery.failover", self.tracer.clock(),
                                track="gallery", dead=dead, into=into,
                                rows=int(len(self._shard_ids[into])))
        return into

    def metrics(self) -> dict:
        """Scalar counters for the ``gallery.*`` registry namespace:
        topology, failovers, and the last match's scan accounting."""
        out = {"rows": self._n, "shards": self.n_shards,
               "failovers": self.failovers,
               "ann": dict(self.ann_stats)}
        if len(self._tenant_names) > 1:
            out["tenants"] = {str(name): n for name, n
                              in self.tenant_rows().items()
                              if name is not None}
        if self.last_match_stats:
            out["match"] = dict(self.last_match_stats)
        return out

    def reshard(self, n_shards: int):
        """Re-split the gallery across ``n_shards`` shards (mirror the lane
        group gaining/losing a replica cartridge)."""
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self._n == 0:
            self._shards = [None] * n_shards
            self._shard_ids = [np.empty((0,), np.int64)
                               for _ in range(n_shards)]
            self._prep = [{} for _ in range(n_shards)]
            return
        full = self.protected_gallery().numpy()
        gids = np.arange(self._n, dtype=np.int64)
        self._shards = [None] * n_shards
        self._shard_ids = [np.empty((0,), np.int64) for _ in range(n_shards)]
        self._prep = [{} for _ in range(n_shards)]
        for s, rows in enumerate(np.array_split(gids, n_shards)):
            if len(rows):
                self._append_to_shard(s, full[rows], rows)

    # -- revocation --------------------------------------------------------------
    def rekey(self, new_seed: int, rotation=None):
        """Cancellable biometrics: re-protect the gallery under a new key
        (``rotation``: an explicit new Q, as in the constructor)."""
        assert self._n > 0, "empty gallery"
        raws = []
        for s in range(self.n_shards):
            if len(self._shard_ids[s]):
                g = torch.from_numpy(decrypt_array(self._cipher_key,
                                                   self._shards[s]))
                raws.append(self.rotation.unprotect(g.to(self.device)))
            else:
                raws.append(None)
        self.rotation = KeyedRotation(self.dim, new_seed, rotation)
        self._cipher_key = _cipher_key(new_seed)
        for s, raw in enumerate(raws):
            if raw is None:
                continue
            self._shards[s] = encrypt_array(self._cipher_key,
                                            self._protect_host(raw))
            self._prep[s] = {}
