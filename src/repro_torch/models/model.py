"""The LM: every family of the reference as ``nn.Module``s.

The port of the reference's ``models/model.py``:

  dense   n_layers x {attn (GQA), mlp}          tinyllama, codeqwen, starcoder2
  vlm     the dense blocks, and a ``projector`` whose projected patches
          replace the first ``n_patches`` token embeddings   internvl2
  hybrid  n_layers / superblock x {superblock x mamba}, each followed by
          one weight-tied shared {attn, mlp}              zamba2
  moe     first_dense_layers x {attn (MLA), mlp} (``prefix``), then
          {attn (MLA), moe} per layer                     deepseek-v2/v3
  gemma3  n_layers / superblock x {superblock x {attn, mlp}}: the last
          layer of each superblock global (``rope_theta_global``, full
          attention), the others local (``rope_theta``, a sliding window)
                                                          gemma3
  ssm     n_layers / superblock x {m: (superblock - 1) x mLSTM, s: sLSTM}
                                                          xlstm
  audio   an ``encoder`` of encoder_layers x {attn (non-causal), mlp} over
          the frames, then ``enc_ln``; decoder blocks {self (causal GQA),
          cross, mlp}; sinusoid positions, no RoPE        whisper

The reference stacks each layer's parameters on a leading axis and scans
over it; here every block is its own module in an ``nn.ModuleList`` and the
layers run as a Python loop.  Parameter names are the reference's
(``embed.tok``, ``blocks[i].attn.wq``, ``blocks[i].mamba[j].w_in``,
``blocks[i].m[j].w_up``, ``encoder[i].attn.wq``, ``prefix.l0.attn.wdq``,
``shared.mlp.w_up``, ``projector.w1``, ...), so ``convert.lm_params`` is a
walk over the reference's tree that unstacks ``blocks`` and ``encoder``.
Caches follow the same layout: a list with one dict per block (for the MoE
family ``{"scan": [...], "prefix": {"l0": ...}}``, for the audio family
``{"dec": [...], "cross": [...]}``, as the reference's).  DeepSeek-V3's
``mtp`` head is in the parameter tree, as the reference's; only the train
loss reads it.  The reference runs the MoE prefix layers a second time to
build their caches, and projects the encoder's output to the cross keys
and values a second time for the cross cache; here each is done once (the
same result, one flash launch a layer).

Entry points (of ``(params, cfg, ...)``, as the reference's):
  loss_fn      train loss (CE + router_aux_coef x MoE aux [+ 0.3 x MTP])
               and its metrics; ``batch`` adds ``labels`` (and an optional
               ``mask``)
  forward      logits over a full sequence (prefill path, optional caches),
               and the MoE layers' summed aux loss; ``batch`` holds
               ``tokens`` and, for the vlm and audio families, ``patches``
               (B, n_patches, vit_dim) or ``frames`` (B, encoder_len, d)
  prefill      run a prompt, return (last-token logits, cache)
  decode_step  one token through the cache -> (logits, cache); the cache is
               updated in place
  serve_step   greedy decode of one token

Training: ``params.trainable`` turns the weights' gradients on.  With
``cfg.remat`` (the full configs; the smoke configs turn it off, as the
reference's) each block, encoder block and prefix layer runs under
``torch.utils.checkpoint`` where autograd records, and backward runs it
again (the reference's ``nothing_saveable`` policy), kernels included.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.params import Params, Spec, init_params
from repro_torch.sharding import gather, shard, under_current_rules

FAMILIES = ("dense", "vlm", "hybrid", "moe", "gemma3", "ssm", "audio")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: no family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def _mlp_specs(cfg, d=None):
    d = d or cfg.d_model
    if cfg.mlp_gated:
        return L.mlp_specs(d, cfg.d_ff)
    # non-gated (starcoder2 / whisper style)
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        "w_up": Spec((d, cfg.d_ff), ("embed", "mlp")),
        "w_down": Spec((cfg.d_ff, d), ("mlp", "embed")),
    }


def _mlp_fwd(p, x, cfg):
    if "w_gate" in p:
        return L.mlp_fwd(p, x, cfg.act, cfg.norm_eps)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    u = shard(L.act_fn(cfg.act)(h @ gather(p["w_up"])), "batch", "seq",
              "mlp")
    return shard(u @ gather(p["w_down"]), "batch", "seq", "embed")


def _block_specs(cfg):
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {"attn": A.gqa_specs(cfg), "mlp": _mlp_specs(cfg)}
    if fam == "gemma3":
        return {"attn": [A.gqa_specs(cfg) for _ in range(cfg.superblock)],
                "mlp": [_mlp_specs(cfg) for _ in range(cfg.superblock)]}
    if fam == "moe":
        return {"attn": A.mla_specs(cfg), "moe": M.moe_specs(cfg)}
    if fam == "ssm":
        return {"m": [X.mlstm_specs(cfg) for _ in range(cfg.superblock - 1)],
                "s": X.slstm_specs(cfg)}
    if fam == "audio":  # a decoder block
        return {"self": A.gqa_specs(cfg), "cross": A.cross_specs(cfg),
                "mlp": _mlp_specs(cfg)}
    return {"mamba": [S.mamba2_specs(cfg) for _ in range(cfg.superblock)]}


def param_specs(cfg):
    """The parameter tree: ``blocks`` is a list with one entry per block
    (a layer, or a hybrid or gemma3 superblock)."""
    _check_family(cfg)
    d = cfg.d_model
    p = {"embed": L.embed_specs(cfg.vocab_size, d, cfg.tie_embeddings),
         "final_ln": Spec((d,), ("embed",), "zeros"),
         "blocks": [_block_specs(cfg) for _ in range(cfg.n_superblocks)]}
    if cfg.family == "moe" and cfg.first_dense_layers:
        p["prefix"] = {
            f"l{i}": {"attn": A.mla_specs(cfg), "mlp": _mlp_specs(cfg)}
            for i in range(cfg.first_dense_layers)}
    if cfg.family == "hybrid":
        p["shared"] = {"attn": A.gqa_specs(cfg), "mlp": _mlp_specs(cfg)}
    if cfg.family == "vlm":
        dv = cfg.vit_dim
        p["projector"] = {"ln": Spec((dv,), ("embed",), "zeros"),
                          "w1": Spec((dv, d), ("embed", "embed2")),
                          "w2": Spec((d, d), ("embed", "embed2"))}
    if cfg.family == "audio":
        p["encoder"] = [{"attn": A.gqa_specs(cfg), "mlp": _mlp_specs(cfg)}
                        for _ in range(cfg.encoder_layers)]
        p["enc_ln"] = Spec((d,), ("embed",), "zeros")
    if cfg.mtp:
        p["mtp"] = {"proj": Spec((2 * d, d), ("embed", "embed2")),
                    "attn": A.mla_specs(cfg), "mlp": _mlp_specs(cfg),
                    "ln": Spec((d,), ("embed",), "zeros")}
    return p


def cache_specs(cfg, B: int, T: int):
    _check_family(cfg)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        one = lambda: {"attn": A.cache_spec_gqa(cfg, B, T)}  # noqa: E731
    elif fam == "gemma3":
        one = lambda: {  # noqa: E731
            "local": [A.cache_spec_gqa(cfg, B, T, window=cfg.sliding_window)
                      for _ in range(cfg.superblock - 1)],
            "global": A.cache_spec_gqa(cfg, B, T)}
    elif fam == "moe":
        c = {"scan": [{"attn": A.cache_spec_mla(cfg, B, T)}
                      for _ in range(cfg.n_superblocks)]}
        if cfg.first_dense_layers:
            c["prefix"] = {f"l{i}": A.cache_spec_mla(cfg, B, T)
                           for i in range(cfg.first_dense_layers)}
        return c
    elif fam == "ssm":
        one = lambda: {  # noqa: E731
            "m": [X.mlstm_cache_spec(cfg, B)
                  for _ in range(cfg.superblock - 1)],
            "s": X.slstm_cache_spec(cfg, B)}
    elif fam == "audio":
        kv = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
        shape = (B, cfg.encoder_len, cfg.n_kv_heads, cfg.dh)
        return {"dec": [{"self": A.cache_spec_gqa(cfg, B, T)}
                        for _ in range(cfg.n_superblocks)],
                "cross": [{"k": Spec(shape, kv, "zeros"),
                           "v": Spec(shape, kv, "zeros")}
                          for _ in range(cfg.n_superblocks)]}
    else:
        one = lambda: {  # noqa: E731
            "mamba": [S.mamba2_cache_spec(cfg, B)
                      for _ in range(cfg.superblock)],
            "shared": A.cache_spec_gqa(cfg, B, T)}
    return [one() for _ in range(cfg.n_superblocks)]


# ---------------------------------------------------------------------------
# Blocks: forward(cfg, x, shared, want_cache) -> (x, cache | None, aux) and
# step(cfg, x, shared, cache, pos) -> (x, cache); ``shared`` is the hybrid
# family's weight-tied block, or the audio family's cross keys and values
# for the block, unused by the others
# ---------------------------------------------------------------------------
_NO_AUX = 0.0


class DenseBlock(Params):
    """{attn, mlp}: one GQA layer, then its MLP."""

    def forward(self, cfg, x, shared=None, want_cache=False):
        y, c = A.gqa_fwd(self["attn"], x, cfg, theta=cfg.rope_theta,
                         window=cfg.sliding_window, want_cache=want_cache)
        x = x + y
        x = x + _mlp_fwd(self["mlp"], x, cfg)
        return x, ({"attn": c} if want_cache else None), _NO_AUX

    def step(self, cfg, x, shared, cache, pos):
        y, c = A.gqa_step(self["attn"], x, cfg, cache["attn"], pos,
                          theta=cfg.rope_theta, window=cfg.sliding_window)
        x = x + y
        x = x + _mlp_fwd(self["mlp"], x, cfg)
        return x, {"attn": c}


class HybridBlock(Params):
    """{mamba: [superblock x Mamba-2]}, then the weight-tied shared block."""

    def forward(self, cfg, x, shared, want_cache=False):
        mcs = []
        for mp in self["mamba"]:
            y, c = S.mamba2_fwd(mp, x, cfg, want_cache=want_cache)
            x = x + y
            mcs.append(c)
        y, c = A.gqa_fwd(shared["attn"], x, cfg, theta=cfg.rope_theta,
                         want_cache=want_cache)
        x = x + y
        x = x + _mlp_fwd(shared["mlp"], x, cfg)
        return x, ({"mamba": mcs, "shared": c} if want_cache else None), \
            _NO_AUX

    def step(self, cfg, x, shared, cache, pos):
        mcs = []
        for mp, ci in zip(self["mamba"], cache["mamba"]):
            y, c = S.mamba2_step(mp, x, cfg, ci)
            x = x + y
            mcs.append(c)
        y, c = A.gqa_step(shared["attn"], x, cfg, cache["shared"], pos,
                          theta=cfg.rope_theta)
        x = x + y
        x = x + _mlp_fwd(shared["mlp"], x, cfg)
        return x, {"mamba": mcs, "shared": c}


class PrefixBlock(Params):
    """{attn (MLA), mlp}: one of the MoE family's first dense layers; its
    cache is the MLA latent cache itself."""

    def forward(self, cfg, x, shared=None, want_cache=False):
        y, c = A.mla_fwd(self["attn"], x, cfg, want_cache=want_cache)
        x = x + y
        x = x + _mlp_fwd(self["mlp"], x, cfg)
        return x, c, _NO_AUX

    def step(self, cfg, x, shared, cache, pos):
        y, c = A.mla_step(self["attn"], x, cfg, cache, pos)
        x = x + y
        x = x + _mlp_fwd(self["mlp"], x, cfg)
        return x, c


class MoEBlock(Params):
    """{attn (MLA), moe}; returns the MoE layer's aux loss."""

    def forward(self, cfg, x, shared=None, want_cache=False):
        y, c = A.mla_fwd(self["attn"], x, cfg, want_cache=want_cache)
        x = x + y
        y, aux = M.moe_fwd(self["moe"], x, cfg)
        return x + y, ({"attn": c} if want_cache else None), aux

    def step(self, cfg, x, shared, cache, pos):
        y, c = A.mla_step(self["attn"], x, cfg, cache["attn"], pos)
        x = x + y
        y, _ = M.moe_fwd(self["moe"], x, cfg)
        return x + y, {"attn": c}


class Gemma3Block(Params):
    """{attn: [superblock x GQA], mlp: [superblock x MLP]}: the last layer
    global (``rope_theta_global``, no window), the others local
    (``rope_theta``, ``sliding_window``)."""

    def _layers(self, cfg):
        n = cfg.superblock
        for i, (ap, mp) in enumerate(zip(self["attn"], self["mlp"])):
            glob = i == n - 1
            yield ap, mp, glob, (cfg.rope_theta_global if glob
                                 else cfg.rope_theta), \
                (0 if glob else cfg.sliding_window)

    def forward(self, cfg, x, shared=None, want_cache=False):
        locals_, glob_c = [], None
        for ap, mp, glob, theta, win in self._layers(cfg):
            y, c = A.gqa_fwd(ap, x, cfg, theta=theta, window=win,
                             want_cache=want_cache)
            x = x + y
            x = x + _mlp_fwd(mp, x, cfg)
            if glob:
                glob_c = c
            else:
                locals_.append(c)
        cache = {"local": locals_, "global": glob_c} if want_cache else None
        return x, cache, _NO_AUX

    def step(self, cfg, x, shared, cache, pos):
        local_c = iter(cache["local"])
        out = {"local": []}
        for ap, mp, glob, theta, win in self._layers(cfg):
            ci = cache["global"] if glob else next(local_c)
            y, c = A.gqa_step(ap, x, cfg, ci, pos, theta=theta, window=win)
            x = x + y
            x = x + _mlp_fwd(mp, x, cfg)
            if glob:
                out["global"] = c
            else:
                out["local"].append(c)
        return x, out


class XLSTMBlock(Params):
    """{m: [(superblock - 1) x mLSTM], s: sLSTM}."""

    def forward(self, cfg, x, shared=None, want_cache=False):
        mcs = []
        for mp in self["m"]:
            y, c = X.mlstm_fwd(mp, x, cfg, want_cache=want_cache)
            x = x + y
            mcs.append(c)
        y, c = X.slstm_fwd(self["s"], x, cfg, want_cache=want_cache)
        return x + y, ({"m": mcs, "s": c} if want_cache else None), _NO_AUX

    def step(self, cfg, x, shared, cache, pos):
        mcs = []
        for mp, ci in zip(self["m"], cache["m"]):
            y, c = X.mlstm_step(mp, x, cfg, ci)
            x = x + y
            mcs.append(c)
        y, c = X.slstm_step(self["s"], x, cfg, cache["s"])
        return x + y, {"m": mcs, "s": c}


class EncoderBlock(Params):
    """{attn, mlp}: one layer of the audio encoder, non-causal, no RoPE."""

    def forward(self, cfg, h):
        y, _ = A.gqa_fwd(self["attn"], h, cfg, theta=0.0, causal=False)
        h = h + y
        return h + _mlp_fwd(self["mlp"], h, cfg)


class DecoderBlock(Params):
    """{self, cross, mlp}: the audio family's decoder layer; ``shared`` is
    its cross keys and values."""

    def forward(self, cfg, x, shared, want_cache=False):
        y, c = A.gqa_fwd(self["self"], x, cfg, theta=0.0,
                         want_cache=want_cache)
        x = x + y
        x = x + A.cross_fwd(self["cross"], x, shared, cfg)
        x = x + _mlp_fwd(self["mlp"], x, cfg)
        return x, ({"self": c} if want_cache else None), _NO_AUX

    def step(self, cfg, x, shared, cache, pos):
        y, c = A.gqa_step(self["self"], x, cfg, cache["self"], pos, theta=0.0)
        x = x + y
        x = x + A.cross_step(self["cross"], x, shared, cfg)
        x = x + _mlp_fwd(self["mlp"], x, cfg)
        return x, {"self": c}


_BLOCK = {"dense": DenseBlock, "vlm": DenseBlock, "hybrid": HybridBlock,
          "moe": MoEBlock, "gemma3": Gemma3Block, "ssm": XLSTMBlock,
          "audio": DecoderBlock}


class LM(nn.Module):
    """The parameters of one model: ``embed``, ``final_ln``, ``blocks``
    (one block module each) and, where the family has them, ``prefix``
    (the MoE family's dense layers, ``PrefixBlock``s by name), ``shared``
    (the hybrid family's tied block), ``projector`` (vlm), ``encoder``
    (``EncoderBlock``s) and ``enc_ln`` (audio) and ``mtp``."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        block = _BLOCK[cfg.family]
        self.embed = Params(tree["embed"])
        self.final_ln = nn.Parameter(tree["final_ln"], requires_grad=False)
        self.blocks = nn.ModuleList(block(b) for b in tree["blocks"])
        self.prefix = nn.ModuleDict(
            {k: PrefixBlock(v) for k, v in tree["prefix"].items()}) \
            if "prefix" in tree else None
        self.shared = Params(tree["shared"]) if "shared" in tree else None
        self.projector = Params(tree["projector"]) \
            if "projector" in tree else None
        self.encoder = nn.ModuleList(
            EncoderBlock(e) for e in tree["encoder"]) \
            if "encoder" in tree else None
        self.enc_ln = nn.Parameter(tree["enc_ln"], requires_grad=False) \
            if "enc_ln" in tree else None
        self.mtp = Params(tree["mtp"]) if "mtp" in tree else None

    @property
    def dtype(self) -> torch.dtype:
        return self.embed["tok"].dtype

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default=None):
        v = getattr(self, name, None)
        return default if v is None else v


def init(cfg, generator: torch.Generator, dtype=torch.bfloat16,
         device=None) -> LM:
    """A model with weights drawn from ``generator`` (on ``device``)."""
    return LM(cfg, init_params(param_specs(cfg), generator, dtype, device))


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------
def _cache_tree(cfg, prefix_caches, caches, cross):
    if cfg.family == "moe":
        out = {"scan": caches}
        if prefix_caches:
            out["prefix"] = prefix_caches
        return out
    if cfg.family == "audio":
        return {"dec": caches, "cross": cross}
    return caches


def _inject_inputs(params, cfg, batch):
    """Token embeddings (B,S,d), with the vlm family's projected patches in
    place of the first ``n_patches`` (rms_norm over vit_dim, tanh-GELU,
    w2) and the audio family's sinusoid positions added."""
    x = L.embed(params["embed"], batch["tokens"], cfg.d_model)
    if cfg.family == "vlm" and "patches" in batch:
        pp = params["projector"]
        h = L.rms_norm(batch["patches"], pp["ln"], cfg.norm_eps)
        h = L.act_fn("gelu")(h.to(pp["w1"].dtype) @ gather(pp["w1"]))
        h = (h @ gather(pp["w2"])).to(x.dtype)
        x = torch.cat([h, x[:, h.shape[1]:]], dim=1)
    if cfg.family == "audio":
        x = x + L.sinusoid_pos_emb(x.shape[1], cfg.d_model,
                                   device=x.device).to(x.dtype)
    return x


def _remat(block, cfg, *args):
    """``block(cfg, *args)``, under ``torch.utils.checkpoint`` where
    ``cfg.remat`` is on and autograd records: nothing inside is saved, and
    backward recomputes it.  The model draws no random numbers, so the RNG
    state is not stashed."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(under_current_rules(block), cfg, *args,
                          use_reentrant=False, preserve_rng_state=False)
    return block(cfg, *args)


def _encode(params, cfg, frames):
    """The audio encoder over ``frames`` (B, encoder_len, d): sinusoid
    positions, the non-causal layers, then ``enc_ln``."""
    h = frames + L.sinusoid_pos_emb(frames.shape[1], cfg.d_model,
                                    device=frames.device).to(frames.dtype)
    for ep in params["encoder"]:
        h = _remat(ep, cfg, h)
    return L.rms_norm(h, params["enc_ln"], cfg.norm_eps)


def forward(params, cfg, batch, *, want_cache=False, return_hidden=False):
    """Full-sequence forward. Returns (logits | hidden, aux, cache|None)."""
    x = _inject_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix = {}
    for name, bp in (params.get("prefix") or {}).items():
        x, prefix[name], _ = _remat(bp, cfg, x, None, want_cache)
    shared = params.get("shared")
    memory = _encode(params, cfg, batch["frames"]) \
        if cfg.family == "audio" else None
    caches, cross = [], []
    for bp in params["blocks"]:
        if memory is not None:
            shared = A.cross_memory(bp["cross"], memory, cfg)
            cross.append(shared)
        x, c, a = _remat(bp, cfg, x, shared, want_cache)
        # sequence-parallel boundary: under "fsdp_sp" rules the carry (the
        # dominant activation buffer) is seq-sharded over "model"
        x = shard(x, "batch", "act_seq", "embed")
        aux = aux + a
        caches.append(c)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x if return_hidden else L.unembed(params["embed"], x)
    return logits, aux, (_cache_tree(cfg, prefix, caches, cross)
                         if want_cache else None)


def loss_fn(params, cfg, batch):
    """(loss, {"ce", "aux"[, "mtp"]}): next-token CE of the hidden states
    at positions :-1 against ``labels[:, 1:]`` (masked by ``mask[:, 1:]``
    where the batch has one), through the fused unembed + CE, plus
    ``router_aux_coef`` x the MoE layers' aux loss and, for DeepSeek-V3,
    0.3 x the MTP head's loss."""
    x, aux, _ = forward(params, cfg, batch, return_hidden=True)
    mask = batch.get("mask")
    ce = L.softmax_xent_fused(params["embed"], x[:, :-1],
                              batch["labels"][:, 1:],
                              None if mask is None else mask[:, 1:])
    loss = ce + cfg.router_aux_coef * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        mtp_loss = _mtp_loss(params, cfg, batch)
        loss = loss + 0.3 * mtp_loss
        metrics["mtp"] = mtp_loss
    return loss, metrics


def _mtp_loss(params, cfg, batch):
    """DeepSeek-V3 multi-token prediction: the depth-1 extra head, its
    input the embeddings of tokens t and t + 1 side by side, its target
    ``labels[:, 2:]``."""
    mp = params["mtp"]
    x = L.embed(params["embed"], batch["tokens"], cfg.d_model)
    h = torch.cat([x[:, :-1], x[:, 1:]], dim=-1) @ gather(mp["proj"])
    y, _ = A.mla_fwd(mp["attn"], h, cfg)
    h = h + y
    h = h + _mlp_fwd(mp["mlp"], h, cfg)
    h = L.rms_norm(h, mp["ln"], cfg.norm_eps)
    return L.softmax_xent_fused(params["embed"], h[:, :-1],
                                batch["labels"][:, 2:])


def prefill(params, cfg, batch):
    """Run a prompt: (last-token logits (B, V), cache).  Only the last
    position is unembedded."""
    x, _, cache = forward(params, cfg, batch, want_cache=True,
                          return_hidden=True)
    logits = L.unembed(params["embed"], x[:, -1:])
    return logits[:, -1], cache


def decode_step(params, cfg, token, pos, cache):
    """token: (B,1) int; pos: int. Returns (logits (B,V), cache), the cache
    updated in place."""
    x = L.embed(params["embed"], token, cfg.d_model)
    if cfg.family == "audio":
        # the sinusoid at ``pos``, computed in fp32
        x = x + L.sinusoid_pos_emb(1, cfg.d_model, offset=int(pos),
                                   device=x.device).to(x.dtype)
    prefix = {}
    for name, bp in (params.get("prefix") or {}).items():
        x, prefix[name] = bp.step(cfg, x, None, cache["prefix"][name], pos)
    blocks = params["blocks"]
    if cfg.family == "audio":
        block_caches, shared = cache["dec"], cache["cross"]
    else:
        block_caches = cache["scan"] if cfg.family == "moe" else cache
        shared = [params.get("shared")] * len(blocks)
    new = []
    for bp, ci, sh in zip(blocks, block_caches, shared):
        x, c = bp.step(cfg, x, sh, ci, pos)
        new.append(c)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], \
        _cache_tree(cfg, prefix, new, shared)


def serve_step(params, cfg, token, pos, cache):
    """Greedy decode of one token."""
    logits, cache = decode_step(params, cfg, token, pos, cache)
    # under a mesh the vocab is gathered first: each rank picks the same
    logits = shard(logits, "batch", None)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return nxt, cache
