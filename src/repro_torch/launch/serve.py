"""Serving driver: CHAMP biometric serving behind the multi-tenant front door.

Builds the paper's flagship pipeline — face detection -> quality scoring ->
embedding extraction -> encrypted watchlist match — as VDiSK cartridges
whose payload compute is real (small CNN/MLP stand-ins for the RetinaFace/
CR-FIQA/FaceNet bitstreams), and serves it two ways:

* ``--mode fleet`` (the canonical entry point): several tenants share the
  box through the ``FrontDoor`` admission controller, each screening
  against its *own* watchlist (tenant-scoped gallery views).
* ``--mode biometric``: the single-operator scenario with a live hot-swap.

The port of the reference's ``launch/serve.py`` biometric half (LM serving
ports with the LM stack).  The stages are ``nn.Module``s computing in NCHW;
the public functions keep the reference's NHWC frames, crops and weights
layout at their edges.  Everything runs on the card unless the caller
passes ``device="cpu"``.  The serving path turns TF32 off for cuDNN
convolutions and matmuls (``_strict_fp32``): with TF32 a convolution could
move the detector's argmax and so crop a different face.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.bus import SharedBus, calibrated
from repro_torch.core import messages as msg
from repro_torch.core.cartridge import Cartridge, DeviceModel, FnCartridge
from repro_torch.crypto import SecureGallery
from repro_torch.data import FrameStream
from repro_torch.device import resolve_device
from repro_torch.runtime import (CapabilityRegistry, FrontDoor, StreamEngine,
                                 Tenant)


# ---------------------------------------------------------------------------
# Biometric cartridges (real payload compute)
# ---------------------------------------------------------------------------
EMB_DIM = 128


def _strict_fp32():
    """IEEE fp32 for the serving path's convolutions and matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _conv_weight(gen: torch.Generator, cin: int, cout: int) -> torch.Tensor:
    """(cout, cin, 3, 3) OIHW weights, N(0, 0.1^2)."""
    return torch.randn((cout, cin, 3, 3), generator=gen) * 0.1


def _conv_same_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3, stride-2 convolution with JAX's "SAME" padding: the total pad
    is max((ceil(n/2) - 1) * 2 + 3 - n, 0) per spatial dim, the extra
    pixel going after (so an even size pads (0, 1), not torch's (1, 1))."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):           # F.pad order: W then H
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=2)


class Detector(nn.Module):
    """'RetinaFace' stand-in: blob-center detector -> one 64x64 crop.

    Takes an (H, W, 3) NHWC frame and returns the (64, 64, 3) crop around
    the argmax of the mean ReLU heat map."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)     # (8, 3, 3, 3)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        H, W = img.shape[0], img.shape[1]
        x = _conv_same_s2(img.permute(2, 0, 1)[None], self.w)
        heat = F.relu(x).mean(dim=1)[0]                    # (H/2, W/2)
        flat = torch.argmax(heat)                          # first max, as JAX
        cy = torch.div(flat, heat.shape[1], rounding_mode="floor") * 2
        cx = (flat % heat.shape[1]) * 2
        ar = torch.arange(64, device=img.device)
        rows = torch.clamp(cy - 32, 0, H - 64) + ar
        cols = torch.clamp(cx - 32, 0, W - 64) + ar
        return img.index_select(0, rows).index_select(1, cols)


class Quality(nn.Module):
    """'CR-FIQA' stand-in: sharpness-gated passthrough of an NHWC crop."""

    def forward(self, crop: torch.Tensor) -> torch.Tensor:
        g = torch.mean(torch.abs(torch.diff(crop, dim=0))) + \
            torch.mean(torch.abs(torch.diff(crop, dim=1)))
        return crop * torch.clamp(g * 10, 0.5, 1.5)


class Embedder(nn.Module):
    """'FaceNet' stand-in: conv + pool + linear -> L2-normalized embedding.

    ``lin`` keeps the reference's (16*8*8, EMB_DIM) layout, whose rows are
    in NHWC flatten order, so the pooled features are flattened in NHWC
    order too (an NCHW flatten gives a wrong embedding of unit norm)."""

    def __init__(self, conv: torch.Tensor, lin: torch.Tensor):
        super().__init__()
        self.conv = nn.Parameter(conv, requires_grad=False)   # (16, 3, 3, 3)
        self.lin = nn.Parameter(lin, requires_grad=False)     # (1024, 128)

    def forward(self, crop: torch.Tensor) -> torch.Tensor:
        x = F.relu(_conv_same_s2(crop.permute(2, 0, 1)[None], self.conv))
        # jax.image.resize(..., "linear") antialiases when it downsamples
        x = F.interpolate(x, size=(8, 8), mode="bilinear", antialias=True,
                          align_corners=False)
        x = x.permute(0, 2, 3, 1).reshape(-1)              # NHWC flatten
        e = x @ self.lin
        return e / torch.clamp(torch.linalg.vector_norm(e), min=1e-9)


def _apply(module, x):
    return module(x)


def make_detector(gen: torch.Generator, device="cpu", weight=None):
    """The detector cartridge; ``weight`` (OIHW) overrides the draw from
    ``gen``."""
    w = _conv_weight(gen, 3, 8) if weight is None else weight
    return FnCartridge("retinaface", _apply, msg.MessageSpec(msg.IMAGE_FRAME),
                       msg.MessageSpec(msg.FACE_CROPS, (64, 64, 3)),
                       params=Detector(w).to(device), capability_id=2,
                       device=DeviceModel(service_s=0.030),
                       torch_device=device)


def make_quality(gen: torch.Generator, device="cpu"):
    return FnCartridge("crfiqa", _apply, msg.MessageSpec(msg.FACE_CROPS),
                       msg.MessageSpec(msg.FACE_CROPS, (64, 64, 3)),
                       params=Quality(), capability_id=3,
                       device=DeviceModel(service_s=0.030),
                       torch_device=device)


def make_embedder(gen: torch.Generator, device="cpu", params=None):
    """The embedder cartridge; ``params`` ({"conv": OIHW, "lin": (1024,
    EMB_DIM)}) overrides the draws from ``gen``."""
    if params is None:
        params = {"conv": _conv_weight(gen, 3, 16),
                  "lin": torch.randn((16 * 8 * 8, EMB_DIM),
                                     generator=gen) * 0.05}
    return FnCartridge("facenet", _apply, msg.MessageSpec(msg.FACE_CROPS),
                       msg.MessageSpec(msg.EMBEDDING, (EMB_DIM,)),
                       params=Embedder(params["conv"], params["lin"])
                       .to(device), capability_id=4,
                       device=DeviceModel(service_s=0.030),
                       torch_device=device)


class WatchlistCartridge(Cartridge):
    """Database cartridge: encrypted gallery + in-protected-space match.

    A *batched match stage*: when the engine drains a micro-batch of
    queued embedding frames, ``process_batch`` stacks them on the device
    into one ``SecureGallery.match`` call — one gallery-match kernel
    launch per shard per engine service cycle instead of one per frame.

    ``tenant_scoped=True`` (fleet serving): frames are grouped by the
    tenant id they carry and each group matches only against that
    tenant's gallery view.  Frames without a tenant tag (or whose tenant
    has no enrolled rows) fall back to the shared fleet pool.
    """

    capability_id = 9
    name = "watchlist_db"
    consumes = msg.MessageSpec(msg.EMBEDDING, (EMB_DIM,))
    produces = msg.MessageSpec(msg.MATCH_RESULT)

    def __init__(self, gallery: SecureGallery, *, mode: str = "exact",
                 nprobe: int = 8, tenant_scoped: bool = False,
                 hit_threshold: float = 0.5):
        super().__init__(device=DeviceModel(service_s=0.010, load_s=0.8),
                         torch_device=gallery.device)
        self.gallery = gallery
        self.mode = mode
        self.nprobe = nprobe
        self.tenant_scoped = tenant_scoped
        self.hit_threshold = hit_threshold
        self.stats["match_calls"] = 0
        self.stats["hits"] = 0           # matches at/above hit_threshold

    def fn(self, params, emb):
        return emb  # the match runs in process_batch (host-side store)

    def process(self, m):
        return self.process_batch([m])[0]

    def _scope_of(self, m) -> object:
        """Which gallery view this frame screens against: its tenant's,
        or None (the shared pool) when untagged / not enrolled."""
        if not self.tenant_scoped:
            return None
        tenant = m.meta.get("tenant")
        if tenant is None or not self.gallery.has_tenant(tenant):
            return None
        return tenant

    def process_batch(self, ms):
        live = [m for m in ms if m.payload is not None]
        if not live:
            return ms
        # one gallery.match (a kernel launch per shard) per tenant scope in
        # the micro-batch (a single call when not tenant-scoped)
        groups: dict = {}
        for i, m in enumerate(live):
            groups.setdefault(self._scope_of(m), []).append(i)
        labels = [None] * len(live)
        scores = [0.0] * len(live)
        for tenant, idxs in groups.items():
            q = torch.stack([torch.as_tensor(live[i].payload)
                             .to(self.torch_device) for i in idxs])
            lab, sc = self.gallery.match(q, k=1, mode=self.mode,
                                         nprobe=self.nprobe, tenant=tenant)
            self.stats["match_calls"] += 1
            for j, i in enumerate(idxs):
                labels[i] = lab[j, 0]
                scores[i] = float(sc[j, 0])
        self.stats["hits"] += sum(1 for s in scores
                                  if s >= self.hit_threshold)
        self.stats["processed"] += len(live)
        results = iter(zip(labels, scores))
        out = []
        for m in ms:
            if m.payload is None:
                out.append(m)
            else:
                lab, sc = next(results)
                out.append(m.with_payload({"label": lab, "score": sc},
                                          msg.MATCH_RESULT))
        return out

    def load(self):
        self._loaded = True
        self._fn = lambda p, x: x
        return 0.0


def build_biometric_pipeline(seed=0, with_quality=True, n_shards=1,
                             match_dtype="fp32", match_mode="exact",
                             nprobe=8, tenant_scoped=False, *, device=None,
                             params=None, rotation=None):
    """The four-stage pipeline and its gallery, on ``device`` (None = the
    card).  Weights are drawn from a CPU generator seeded with ``seed``
    unless ``params`` gives them (``repro_torch.convert`` makes that dict
    from the reference's weights); ``rotation`` is the gallery's explicit
    Q, likewise."""
    device = resolve_device(device)
    _strict_fp32()
    gen = torch.Generator().manual_seed(seed)
    params = params or {}
    reg = CapabilityRegistry()
    reg.insert(0, make_detector(gen, device, params.get("detector")))
    if with_quality:
        reg.insert(1, make_quality(gen, device))
    reg.insert(2, make_embedder(gen, device, params.get("embedder")))
    # one gallery shard per watchlist replica lane (cartridge scaling)
    gallery = SecureGallery(EMB_DIM, seed=7, n_shards=n_shards,
                            match_dtype=match_dtype, device=device,
                            rotation=rotation)
    reg.insert(3, WatchlistCartridge(gallery, mode=match_mode,
                                     nprobe=nprobe,
                                     tenant_scoped=tenant_scoped))
    return reg, gallery


def _frame(src: FrameStream, i: int, device) -> torch.Tensor:
    return torch.from_numpy(src.frame_at(i)).to(device)


def _pipeline_embed(reg, src, frame_ids):
    """Offline enrollment embeddings: the same det->quality->embed path
    the streamed frames take.  Returns a (len(frame_ids), EMB_DIM) tensor
    on the pipeline's device."""
    det, qual, emb = (reg.slots[0].cartridge, reg.slots[1].cartridge,
                      reg.slots[2].cartridge)
    for c in (det, qual, emb):
        c.load()
    out = []
    with torch.no_grad():
        for i in frame_ids:
            crop = det._fn(det.params, _frame(src, i, det.torch_device))
            crop = qual._fn(qual.params, crop)
            out.append(emb._fn(emb.params, crop))
    return torch.stack(out)


def random_templates(n: int, *, seed: int, device) -> torch.Tensor:
    """``n`` random unit templates (watchlist distractors), drawn on
    ``device`` from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn((n, EMB_DIM), generator=gen, device=device)
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def run_biometric(n_frames=30, hotswap=True, *, device=None, n_shards=1,
                  match_dtype="fp32", distractors=0, params=None,
                  rotation=None):
    """The single-operator scenario: enroll 10 subjects (plus
    ``distractors`` random unit templates, a city-scale watchlist), stream
    ``n_frames`` frames through the pipeline, and pull the quality
    cartridge live at t=1 s when ``hotswap``."""
    reg, gallery = build_biometric_pipeline(
        n_shards=n_shards, match_dtype=match_dtype, device=device,
        params=params, rotation=rotation)
    # enroll: run a few frames through det->quality->embed offline
    src = FrameStream(seed=3)
    gallery.enroll(_pipeline_embed(reg, src, range(10)),
                   [f"subject{i}" for i in range(10)])
    if distractors:
        gallery.enroll(random_templates(distractors, seed=11,
                                        device=gallery.device),
                       ["distractor"] * distractors)

    eng = StreamEngine(reg, SharedBus(calibrated("ncs2")),
                       execute_payloads=True)
    eng.feed(n_frames, interval_s=0.12,
             payload_fn=lambda i: _frame(src, i % 10, gallery.device))
    if hotswap:
        eng.schedule_remove(1.0, slot=1)   # pull the quality cartridge live
    rep = eng.run(until=60)
    wl = reg.slots[3].cartridge.stats      # watchlist match-hit accounting
    print(f"[serve] frames={rep.frames_out}/{rep.frames_in} "
          f"lost={rep.lost} hits={wl['hits']} "
          f"mean_latency={rep.mean_latency()*1e3:.1f}ms "
          f"downtime={rep.total_downtime():.2f}s")
    return rep


# ---------------------------------------------------------------------------
# Fleet serving: multi-tenant admission through the front door
# ---------------------------------------------------------------------------
# the three conventional tiers: checkpoint operators screening live
# subjects (tight SLO, sheds last), recon feeds, archive backfill (bulk)
FLEET_TENANTS = (
    Tenant("field_ops", priority=0, weight=8.0, slo_s=0.5, queue_cap=64),
    Tenant("recon", priority=1, weight=3.0, queue_cap=128),
    Tenant("backfill", priority=2, weight=1.0, queue_cap=64),
)
# offered load per tenant, as a fraction of the pipeline's bottleneck
# rate; summing past 1.0 = deliberate overload (backfill sheds first)
FLEET_LOAD = {"field_ops": 0.2, "recon": 0.6, "backfill": 1.2}


def run_fleet(duration_s=3.0, load=None, hotswap=False, *, device=None,
              params=None, rotation=None):
    """The canonical fleet-serving entry point: the biometric pipeline
    behind the multi-tenant front door.  Each tenant enrolls its own
    watchlist (tenant-scoped gallery views) and streams frames at its
    offered rate; the door does weighted-fair admission with
    lowest-class shed, and the run prints the per-tenant ledger."""
    reg, gallery = build_biometric_pipeline(
        tenant_scoped=True, device=device, params=params, rotation=rotation)
    dev = gallery.device
    src = FrameStream(seed=3)
    # disjoint per-tenant watchlists from the shared frame bank: tenant
    # i's subjects are frames [10*i, 10*i+10)
    tenant_base = {}
    for i, t in enumerate(FLEET_TENANTS):
        base = 10 * i
        tenant_base[t.name] = base
        gallery.enroll(_pipeline_embed(reg, src, range(base, base + 10)),
                       [f"{t.name}/subject{j}" for j in range(10)],
                       tenant=t.name)

    fd = FrontDoor()
    for t in FLEET_TENANTS:
        fd.add_tenant(t)
    eng = StreamEngine(reg, SharedBus(calibrated("ncs2")),
                       execute_payloads=True, frontdoor=fd)
    # bottleneck stage service time sets the capacity the load fractions
    # scale from
    bottleneck_s = max(r.cartridge.device.service_s for r in reg.records())
    cap_fps = 1.0 / bottleneck_s
    for t in FLEET_TENANTS:
        rate = (load or FLEET_LOAD)[t.name] * cap_fps
        n = int(rate * duration_s)
        base = tenant_base[t.name]
        eng.feed_tenant(
            t.name, n, interval_s=1.0 / rate,
            payload_fn=lambda i, b=base: _frame(src, b + i % 10, dev))
    if hotswap:
        eng.schedule_remove(1.0, slot=1)
    rep = eng.run(until=float("inf"))
    wl = reg.slots[3].cartridge.stats
    fdd = rep.frontdoor
    print(f"[serve-fleet] frames={rep.frames_out}/{rep.frames_in} "
          f"lost={rep.lost} hits={wl['hits']} "
          f"shed={fdd['shed']} credit={fdd['credit']:.2f}")
    for name, t in fdd["tenants"].items():
        print(f"  {name:10s} [{t['class']:11s}] offered={t['offered']:4d} "
              f"admitted={t['admitted']:4d} shed={t['shed']:4d} "
              f"goodput={t['goodput']:.2f} p99={t['latency'].get('p99', 0.0) * 1e3:7.1f}ms "
              f"slo_miss={t['slo_miss']}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["fleet", "biometric"],
                    default="fleet")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--duration", type=float, default=3.0,
                    help="fleet mode: seconds of offered traffic")
    ap.add_argument("--no-hotswap", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.mode == "fleet":
        run_fleet(args.duration, device=args.device)
    else:
        run_biometric(args.frames, hotswap=not args.no_hotswap,
                      device=args.device)


if __name__ == "__main__":
    main()
