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

Planet-scale tier (two-level ANN).  Exact per-shard scan is linear in N;
``build_ann_index()`` trains one global spherical-k-means codebook (K
cells, encrypted at rest like everything else) and assigns every row to
a cell, and ``match(mode="ann", nprobe=c)`` scores only K centroids plus
the rows of each query's top-c cells (``kernels/ann_match``: coarse
centroid scan on the gallery-match kernel → exact rescore in the probed
cells on the rescore kernel, both storage-dtype aware).  Index maintenance
is **incremental**: ``enroll`` assigns new rows to existing cells (never
retrains), ``rekey`` rotates the codebook through the key change (cosine
geometry is rotation-invariant, so assignments survive), and ``reshard``
only re-packs the per-shard physical layouts — ``ann_stats["trainings"]``
stays at one unless ``build_ann_index`` is called again explicitly.
``last_match_stats`` reports rows scored vs rows resident.  The codebook
is trained and the cells are packed on the host, as in the reference; the
packed cells and the codebook's match forms live on the store's device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.crypto.templates import (KeyedRotation, decrypt_array,
                                          encrypt_array, prng_key)
from repro_torch.device import resolve_device
from repro_torch.kernels import ann_match as A
from repro_torch.kernels import ops as K

MATCH_DTYPES = ("fp32", "bf16", "int8")
MATCH_MODES = ("exact", "ann")


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


def _cipher_key(seed: int) -> tuple:
    """The stream cipher's key for ``seed``: the reference's
    ``jax.random.PRNGKey(seed ^ 0x5EC2E7)``."""
    return prng_key(seed ^ 0x5EC2E7)


def _to_host(tensors):
    """Numpy copies of ``tensors`` (each of 4-byte elements), brought from
    the device in one transfer."""
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].view(_NP_DTYPE[t.dtype]).reshape(t.shape))
        at += n
    return out


_NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32}


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
        # two-level ANN tier: encrypted global codebook + per-gid cell
        # assignment (ints, not biometric data); physical packed layouts
        # live in the per-shard _prep caches
        self._ann_blob: Optional[dict] = None      # encrypted (K, D) f32
        self._ann_codebook: Optional[np.ndarray] = None   # decrypt-once
        self._ann_dev: dict = {}          # match dtype -> codebook tensors
        self._ann_assign = np.empty((0,), np.int32)       # gid -> cell
        self._ann_n_cells = 0
        self.ann_stats = {"trainings": 0, "assign_calls": 0, "packs": 0}
        self.failovers = 0                 # shard rebuilds after lane death
        self.last_match_stats: dict = {}
        # optional FlightRecorder: failovers/ANN trainings emit instants
        # at tracer.clock() (the gallery has no clock of its own)
        self.tracer = None

    # -- enrollment ------------------------------------------------------------
    def _encrypt(self, x: np.ndarray) -> dict:
        """``x`` sealed at rest under the store's key; the keystream is
        made on the store's device, the XOR on the host."""
        return encrypt_array(self._cipher_key, x, self.device)

    def _decrypt(self, enc: dict) -> np.ndarray:
        return decrypt_array(self._cipher_key, enc, self.device)

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
        if self._ann_blob is not None and n_new:
            # incremental index maintenance: new rows join existing cells
            # (nearest centroid in protected space); the codebook is NOT
            # retrained — ann_stats["trainings"] must not move here
            new_cells = A.assign_cells(prot, self._codebook())
            self._ann_assign = np.concatenate([self._ann_assign, new_cells])
            self.ann_stats["assign_calls"] += 1
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
            prev = self._decrypt(self._shards[s])
            prot = np.concatenate([prev, prot], axis=0)
        self._shards[s] = self._encrypt(prot)
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
                out[self._shard_ids[s]] = self._decrypt(self._shards[s])
        return torch.from_numpy(out)

    def _prepare(self, s: int, dtype: str) -> dict:
        """Decrypt-once match-time view of shard ``s`` for ``dtype`` on the
        store's device: pre-normalized rows, plus the int8 values/scales
        for the quantized path (queries are normalized in the kernel; the
        gallery is normalized here)."""
        prep = self._prep[s]
        if "gn" not in prep:
            g = torch.from_numpy(self._decrypt(self._shards[s])) \
                .to(self.device)
            prep["gn"] = g / torch.clamp(torch.linalg.vector_norm(
                g, dim=-1, keepdim=True), min=1e-9)
        if dtype == "bf16" and "gn_bf16" not in prep:
            prep["gn_bf16"] = prep["gn"].to(torch.bfloat16)
        if dtype == "int8" and "q8" not in prep:
            prep["q8"], prep["scale"] = K.prepare_gallery_quant(prep["gn"])
        return prep

    def seal(self):
        """Drop every plaintext match-time view — including the decrypted
        ANN codebook and packed cell layouts; only the encrypted-at-rest
        blobs stay resident (next ``match`` re-prepares)."""
        self._prep = [{} for _ in self._shards]
        self._ann_codebook = None
        self._ann_dev = {}

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
        """Train the global centroid codebook (spherical k-means-lite over
        every row, on the host) and assign each row to a cell.  The one
        expensive, explicit operation — everything after it
        (enroll/rekey/reshard) maintains the index incrementally."""
        assert self._n > 0, "empty gallery"
        gn = np.empty((self._n, self.dim), np.float32)
        for s in range(self.n_shards):
            if len(self._shard_ids[s]):
                gn[self._shard_ids[s]] = self._prepare(s, "fp32")["gn"] \
                    .cpu().numpy()
        if n_cells is None:
            n_cells = max(1, int(round(float(np.sqrt(self._n)))))
        n_cells = max(1, min(n_cells, self._n))
        codebook = A.kmeans_lite(gn, n_cells, iters=iters, seed=seed)
        self._ann_n_cells = codebook.shape[0]
        self._ann_blob = self._encrypt(codebook)
        self._ann_codebook = codebook
        self._ann_dev = {}
        self._ann_assign = A.assign_cells(gn, codebook)
        self.ann_stats["trainings"] += 1
        if self.tracer is not None:
            self.tracer.instant("gallery.ann_train", self.tracer.clock(),
                                track="gallery", rows=self._n,
                                n_cells=self._ann_n_cells)
        for s in range(self.n_shards):             # packed layouts are stale
            self._prep[s].pop("ann", None)
            self._prep[s].pop("tenant_ann", None)

    @property
    def ann_indexed(self) -> bool:
        return self._ann_blob is not None

    def _codebook(self) -> np.ndarray:
        """Decrypt-once cached codebook (dropped by ``seal``)."""
        if self._ann_codebook is None:
            self._ann_codebook = self._decrypt(self._ann_blob)
        return self._ann_codebook

    def _prepare_ann(self, s: int, dtype: str,
                     code: Optional[int] = None) -> dict:
        """Padded cell-major physical view of shard ``s`` for ``dtype``,
        built lazily from the prepared (decrypt-once) view + the global
        assignment — an *affected-shard-only* repack, never a retrain.
        With a tenant ``code``, the layout and packed arrays cover only
        that tenant's rows (``ann["rows"]`` maps back to shard-local).
        Layouts are packed on the host; the packed cells and the cell
        lengths are kept on the store's device."""
        prep = self._prepare(s, dtype)
        if code is None:
            if "ann" not in prep:
                assign = self._ann_assign[self._shard_ids[s]]
                prep["ann"] = {"layout": A.build_cell_layout(
                    assign, self._ann_n_cells)}
                self.ann_stats["packs"] += 1
            ann = prep["ann"]
        else:
            ann = prep.setdefault("tenant_ann", {}).setdefault(code, {})
            if "layout" not in ann:
                rows = self._tenant_shard_rows(s, code)
                ann["rows"] = rows
                assign = self._ann_assign[self._shard_ids[s][rows]]
                ann["layout"] = A.build_cell_layout(assign,
                                                    self._ann_n_cells)
                self.ann_stats["packs"] += 1
        layout = ann["layout"]
        if "lens" not in ann:
            ann["lens"] = torch.from_numpy(layout.cell_lens).to(self.device)
        need_q8 = dtype == "int8" and "q8" not in ann
        need_packed = dtype in ("fp32", "bf16") and "packed" not in ann
        if need_q8 or need_packed:
            gn = prep["gn"].cpu().numpy()
            if code is not None:
                gn = gn[ann["rows"]]
            if need_q8:
                q8, scale = A.pack_cells_quant(gn, layout)
                ann["q8"] = torch.from_numpy(q8).to(self.device)
                ann["scale"] = torch.from_numpy(scale).to(self.device)
            else:
                ann["packed"] = torch.from_numpy(
                    A.pack_cells(gn, layout)).to(self.device)
        if dtype == "bf16" and "packed_bf16" not in ann:
            ann["packed_bf16"] = ann["packed"].to(torch.bfloat16)
        return ann

    def _coarse_scan(self, q: torch.Tensor, nprobe: int, dtype: str):
        """Query-vs-codebook probe selection in the match dtype (the
        codebook is small, so its device forms are derived from the
        decrypt-once cache, once per dtype)."""
        cb = self._ann_dev.get(dtype)
        if cb is None:
            cents = torch.from_numpy(self._codebook()).to(self.device)
            if dtype == "int8":
                cb = K.prepare_gallery_quant(cents)
            else:
                cb = (cents.to(torch.bfloat16) if dtype == "bf16"
                      else cents,)
            self._ann_dev[dtype] = cb
        if dtype == "int8":
            return K.centroid_topc_quant(q, *cb, c=nprobe)
        return K.centroid_topc(q, *cb, c=nprobe)

    def _rescore_shard_ann(self, s: int, q: torch.Tensor,
                           cell_ids: torch.Tensor, k: int, dtype: str,
                           code: Optional[int] = None):
        """Launch the exact rescore of shard ``s`` restricted to the probed
        cells (and, with a tenant ``code``, to that tenant's rows).
        Returns (the shard's packed view, scores, padded positions), the
        last two still on the device."""
        ann = self._prepare_ann(s, dtype, code)
        layout = ann["layout"]
        if dtype == "int8":
            scores, pos = K.cell_rescore_quant(
                q, ann["q8"], ann["scale"], cell_ids, ann["lens"], k=k,
                L=layout.L)
        else:
            packed = ann["packed_bf16"] if dtype == "bf16" \
                else ann["packed"]
            scores, pos = K.cell_rescore(q, packed, cell_ids, ann["lens"],
                                         k=k, L=layout.L)
        return ann, scores, pos

    def _shard_ann_gids(self, s: int, ann: dict, pos: np.ndarray,
                        ids: np.ndarray, code: Optional[int] = None):
        """Shard ``s``'s padded positions -> global ids (-1 on unfilled
        slots), and the gallery rows rescored per query in the shard;
        ``ids`` is the probe table, all on the host."""
        layout = ann["layout"]
        rows = np.where(pos >= 0,
                        layout.pos_to_row[np.clip(pos, 0, None)], -1)
        if code is not None:          # subset-local -> shard-local rows
            rows = np.where(rows >= 0,
                            ann["rows"][np.clip(rows, 0, None)], -1)
        gids = np.where(rows >= 0,
                        self._shard_ids[s][np.clip(rows, 0, None)], -1)
        # average gallery rows rescored per query in this shard
        scored = float(layout.cell_lens[ids.clip(0)][ids >= 0].sum()
                       / max(ids.shape[0], 1))
        return gids, scored

    # -- matching entry ----------------------------------------------------------
    def match(self, raw_queries, k: int = 5, dtype: Optional[str] = None, *,
              mode: str = "exact", nprobe: int = 8, tenant=None):
        """Match raw query embeddings; returns (labels, scores).

        Queries are protected with the same rotation, then matched in
        protected space (cosine is invariant under the shared rotation).
        ``mode="exact"``: each shard is searched in full (one kernel call
        per shard, i.e. per replica lane).  ``mode="ann"``: one coarse
        scan against the global codebook picks each query's top-``nprobe``
        cells, then every shard rescores only the probed cells — rows
        scored per query drops from N to ~K + nprobe·N/K (tracked in
        ``last_match_stats``).  The per-shard top-k merge to a global
        top-k runs on the host and breaks score ties by **global id**, so
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
        if mode == "ann" and not self.ann_indexed:
            raise ValueError("ANN index not built — call "
                             "build_ann_index() before match(mode='ann')")
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
        centroid_rows = 0
        cell_rows = 0
        if mode == "ann":
            nprobe = max(1, min(nprobe, self._ann_n_cells))
            _, cell_ids = self._coarse_scan(q, nprobe, dtype)
            centroid_rows = self._ann_n_cells
        shard_scores, shard_gids = [], []
        launched = []     # ANN: (shard, packed view, scores, positions)
        for s in range(self.n_shards):
            rows = None
            n_s = len(self._shard_ids[s])
            if code is not None and n_s:
                rows = self._tenant_shard_rows(s, code)
                n_s = len(rows)
            if n_s == 0:
                continue
            ks = min(k, n_s)
            if mode == "ann":
                launched.append((s, *self._rescore_shard_ann(
                    s, q, cell_ids, ks, dtype, code)))
            else:
                scores, idx = self._match_shard(s, q, ks, dtype, rows)
                shard_scores.append(scores)
                shard_gids.append(self._shard_ids[s][idx])
                cell_rows += n_s          # exact: the whole scope scored
        if mode == "ann":
            # every shard's rescore is in flight: the probe table and each
            # shard's (scores, positions) come back in one transfer
            ids, *host = _to_host([cell_ids] + [
                t for _, _, scores, pos in launched for t in (scores, pos)])
            for (s, ann, _, _), scores, pos in zip(launched, host[0::2],
                                                   host[1::2]):
                gids, scored = self._shard_ann_gids(s, ann, pos, ids, code)
                cell_rows += scored
                shard_scores.append(scores)
                shard_gids.append(gids)
        all_s = np.concatenate(shard_scores, axis=1)       # (Q, sum ks)
        all_g = np.concatenate(shard_gids, axis=1)
        if len(shard_scores) > 1 or mode == "ann":         # top-k merge
            # primary key: score desc; tie-break: global id asc — equal
            # scores order identically for every reshard() topology
            # (sentinel slots sink: NEG scores with id -1)
            sort_g = np.where(all_g < 0, np.iinfo(np.int64).max, all_g)
            top = np.lexsort((sort_g, -all_s), axis=1)[:, :k]
            all_s = np.take_along_axis(all_s, top, axis=1)
            all_g = np.take_along_axis(all_g, top, axis=1)
        self.last_match_stats = {
            "mode": mode, "dtype": dtype, "rows_total": self._n,
            "centroid_rows": centroid_rows, "cell_rows": cell_rows,
            "rows_scored": centroid_rows + cell_rows,
            "scan_fraction": (centroid_rows + cell_rows) / self._n,
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
        the recovery source.  Global row ids ride along, so the ANN
        codebook and per-gid cell assignments survive untouched (the
        absorbing shard's packed layout rebuilds lazily on its next ANN
        match).  The dead shard stays in the topology as an empty slot —
        matching a lane group running one replica short until the
        operator reshards.  Returns the absorbing shard's index."""
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
            prot = self._decrypt(self._shards[dead])
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
        topology, failovers, ANN maintenance, and the last match's scan
        accounting (rows_scored / scan_fraction)."""
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
        group gaining/losing a replica cartridge).  The ANN codebook and
        per-row cell assignments survive untouched — only the per-shard
        packed layouts are rebuilt (lazily, on next ANN match)."""
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
        (``rotation``: an explicit new Q, as in the constructor).  The ANN
        codebook rides the rotation change (cosine geometry is
        rotation-invariant), so cell assignments — and recall — survive
        without retraining or reassignment."""
        assert self._n > 0, "empty gallery"
        raws = []
        for s in range(self.n_shards):
            if len(self._shard_ids[s]):
                g = torch.from_numpy(self._decrypt(self._shards[s]))
                raws.append(self.rotation.unprotect(g.to(self.device)))
            else:
                raws.append(None)
        raw_codebook = None
        if self._ann_blob is not None:
            raw_codebook = self.rotation.unprotect(
                torch.from_numpy(self._codebook()).to(self.device))
        self.rotation = KeyedRotation(self.dim, new_seed, rotation)
        self._cipher_key = _cipher_key(new_seed)
        for s, raw in enumerate(raws):
            if raw is None:
                continue
            self._shards[s] = self._encrypt(self._protect_host(raw))
            self._prep[s] = {}
        if raw_codebook is not None:
            codebook = self._protect_host(raw_codebook)
            self._ann_blob = self._encrypt(codebook)
            self._ann_codebook = codebook
            self._ann_dev = {}
