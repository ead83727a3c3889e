"""The LM: the dense and hybrid families as ``nn.Module``s.

The port of the reference's ``models/model.py`` for two families:

  dense   n_layers x {attn (GQA), mlp}                   tinyllama
  hybrid  n_layers / superblock x {superblock x mamba}, each followed by
          one weight-tied shared {attn, mlp}              zamba2

The reference stacks each layer's parameters on a leading axis and scans
over it; here every block is its own module in an ``nn.ModuleList`` and the
layers run as a Python loop.  Parameter names are the reference's
(``embed.tok``, ``blocks[i].attn.wq``, ``blocks[i].mamba[j].w_in``,
``shared.mlp.w_up``, ...), so ``convert.lm_params`` is a walk over the
reference's tree that unstacks ``blocks``.  Caches follow the same layout:
a list with one dict per block.

Entry points (of ``(params, cfg, ...)``, as the reference's):
  forward      logits over a full sequence (prefill path, optional caches)
  prefill      run a prompt, return (last-token logits, cache)
  decode_step  one token through the cache -> (logits, cache); the cache is
               updated in place
  serve_step   greedy decode of one token
Any other family raises, naming its ROADMAP item.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import Params, Spec, init_params

FAMILIES = ("dense", "hybrid")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP Queue 1 item 9)")


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
    return L.act_fn(cfg.act)(h @ p["w_up"]) @ p["w_down"]


def _block_specs(cfg):
    if cfg.family == "dense":
        return {"attn": A.gqa_specs(cfg), "mlp": _mlp_specs(cfg)}
    return {"mamba": [S.mamba2_specs(cfg) for _ in range(cfg.superblock)]}


def param_specs(cfg):
    """The parameter tree: ``blocks`` is a list with one entry per block
    (a layer, or a hybrid superblock)."""
    _check_family(cfg)
    d = cfg.d_model
    p = {"embed": L.embed_specs(cfg.vocab_size, d, cfg.tie_embeddings),
         "final_ln": Spec((d,), ("embed",), "zeros"),
         "blocks": [_block_specs(cfg) for _ in range(cfg.n_superblocks)]}
    if cfg.family == "hybrid":
        p["shared"] = {"attn": A.gqa_specs(cfg), "mlp": _mlp_specs(cfg)}
    return p


def cache_specs(cfg, B: int, T: int):
    _check_family(cfg)
    if cfg.family == "dense":
        one = lambda: {"attn": A.cache_spec_gqa(cfg, B, T)}  # noqa: E731
    else:
        one = lambda: {  # noqa: E731
            "mamba": [S.mamba2_cache_spec(cfg, B)
                      for _ in range(cfg.superblock)],
            "shared": A.cache_spec_gqa(cfg, B, T)}
    return [one() for _ in range(cfg.n_superblocks)]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
class DenseBlock(Params):
    """{attn, mlp}: one GQA layer, then its MLP (``shared`` is unused: the
    blocks of both families take the same arguments)."""

    def forward(self, cfg, x, shared=None, want_cache=False):
        y, c = A.gqa_fwd(self["attn"], x, cfg, theta=cfg.rope_theta,
                         window=cfg.sliding_window, want_cache=want_cache)
        x = x + y
        x = x + _mlp_fwd(self["mlp"], x, cfg)
        return x, ({"attn": c} if want_cache else None)

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
        return x, ({"mamba": mcs, "shared": c} if want_cache else None)

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


class LM(nn.Module):
    """The parameters of one model: ``embed``, ``final_ln``, ``blocks``
    (``DenseBlock`` or ``HybridBlock`` each) and, for the hybrid family,
    ``shared``."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        block = DenseBlock if cfg.family == "dense" else HybridBlock
        self.embed = Params(tree["embed"])
        self.final_ln = nn.Parameter(tree["final_ln"], requires_grad=False)
        self.blocks = nn.ModuleList(block(b) for b in tree["blocks"])
        self.shared = Params(tree["shared"]) if "shared" in tree else None

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
def forward(params, cfg, batch, *, want_cache=False, return_hidden=False):
    """Full-sequence forward. Returns (logits | hidden, aux, cache|None)."""
    x = L.embed(params["embed"], batch["tokens"], cfg.d_model)
    shared = params.get("shared")
    caches = []
    for bp in params["blocks"]:
        x, c = bp(cfg, x, shared, want_cache)
        caches.append(c)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x if return_hidden else L.unembed(params["embed"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, (caches if want_cache else None)


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
    shared = params.get("shared")
    new = []
    for bp, ci in zip(params["blocks"], cache):
        x, c = bp.step(cfg, x, shared, ci, pos)
        new.append(c)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], new


def serve_step(params, cfg, token, pos, cache):
    """Greedy decode of one token."""
    logits, cache = decode_step(params, cfg, token, pos, cache)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return nxt, cache
