"""Blocked cosine top-k gallery matching: the Hopper kernel and its plain
version.

The Database cartridge's hot path: score Q protected query templates
against an N-row protected gallery and keep the top-k matches per query.
``gallery_match_cuda`` / ``gallery_match_quant_cuda`` are the port of the
reference's ``gallery_match_pallas`` / ``gallery_match_quant_pallas``.  On a
CUDA tensor they launch the hand-written kernel in
``csrc/gallery_match.cu`` (built with ``nvcc`` for ``sm_90a`` at first use
into ``build/kernels/``, bound through ``ctypes``); on a CPU tensor they run
``gallery_match_plain``, the same function in plain PyTorch.  Any other
device raises: there is no fallback from the kernel to the plain version.
The kernel has two paths, a small-Q one for the serving path's one to a
few queries at small k and a tiled one for the rest; ``plan`` chooses.
Any k and any row width D: above ``MAX_K`` the call runs ``rounds(k)``
rounds of the tiled path, each finding the next ``MAX_K`` entries after
the last round's last one, and rows wider than ``MAX_D`` are scored a
chunk of ``MAX_D`` values at a time.

Contract (the reference kernel's):

  * fp32 dots with fp32 accumulation for every storage dtype — fp32, bf16
    (the query is cast to bf16 first, as the gallery) and int8 (per-row
    symmetric quantization; the row's scale multiplies the score after the
    dot, the query stays fp32);
  * ``fuse_norm=True`` L2-normalizes the query in the kernel as
    ``q * rsqrt(max(sum(q^2), 1e-18))``; the gallery comes pre-normalized;
  * top-k ordered by score descending, then gallery index ascending (ties
    go to the lowest index);
  * ``k > N`` is clamped to N and the trailing columns hold the sentinels
    (``NEG``, -1).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -3.0e38
MAX_K = 64              # entries a round finds: two list entries a lane
MAX_D = 512             # row values staged at once: a query tile and a
                        # gallery tile of that width fit the 227 KB of smem
SMALL_Q = 8             # the small-Q path's most queries (kSmallQ in the .cu)
SMALL_D = 128           # and the one row width it takes
SMALL_QK = 32           # its most Q * k: above, its per-warp lists and last
                        # merge cost more than it saves (measured, PERF.md)
_SMALL_WARPS = 8        # warps a block of the small-Q path
_GROUP_BYTES = 4096     # gallery bytes a warp reads per group (32 x 8 x 16)
_TILE_ROWS = 64         # gallery rows a tile of the tiled path

# launches of the CUDA kernel (one a round; the tiled path's two kernels
# count as one), and the path, split count and rounds of the last call
launches = 0
last_plan = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_vp, _ci = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/gallery_match.cu: (argument types, result type)
_SIGNATURES = {
    "gm_match": ([_ci, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci,
                  _vp, _vp, _vp, _vp, _vp], _ci),
    "gm_match_small": ([_ci, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci,
                        _vp, _vp, _vp, _vp, _vp, _vp], _ci),
    "gm_small_blocks_per_sm": ([_ci, _ci, _ci, ctypes.POINTER(_ci)], _ci),
    "gm_error_string": ([_ci], ctypes.c_char_p),
    "gm_max_k": ([], _ci),
    "gm_small_q": ([], _ci),
    "gm_small_d": ([], _ci),
}
_lib = None


def build(verbose: bool = False):
    """Compile ``csrc/gallery_match.cu`` into ``build/kernels/`` unless a
    library built from the same sources and flags is already there;
    returns its path."""
    return _build.build("gallery_match", verbose)


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("gallery_match")
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        assert (lib.gm_max_k(), lib.gm_small_q(), lib.gm_small_d()) == \
            (MAX_K, SMALL_Q, SMALL_D)
        _lib = lib
    return _lib


def rounds(k: int) -> int:
    """Rounds of the kernel a call at ``k`` runs: each finds at most
    ``MAX_K`` entries."""
    return -(-k // MAX_K)


def plan(Q: int, k: int, N: int, D: int, itemsize: int, aligned: bool,
         sms: int, small_blocks_per_sm: int):
    """Which path of the kernel a call takes, and its split count; all
    ``rounds(k)`` rounds of the call take that path.

    ``("small", S)`` for Q <= SMALL_Q queries of width SMALL_D with
    Q * k <= SMALL_QK against a 16-byte aligned gallery: a persistent grid
    of S blocks, as many as fit on the ``sms`` SMs at
    ``small_blocks_per_sm`` each, but no more than the gallery has tiles (a
    block's warps each take one group of ``_GROUP_BYTES``); one round, as
    Q * k <= SMALL_QK < MAX_K.  ``("tiled", S)`` otherwise, at any k and
    D: S splits of the gallery per 32-query tile, enough blocks for a few
    waves over the SMs, each split at least one 64-row tile."""
    if Q <= SMALL_Q and Q * k <= SMALL_QK and D == SMALL_D and aligned:
        tile = _SMALL_WARPS * _GROUP_BYTES // (D * itemsize)
        return "small", max(1, min(small_blocks_per_sm * sms, -(-N // tile)))
    n_qtiles = -(-Q // 32)
    return "tiled", max(1, min(-(-N // _TILE_ROWS), -(-4 * sms // n_qtiles)))


_blocks_per_sm = {}
_arrivals = {}


def _arrival_count(dev, stream: int) -> torch.Tensor:
    """The small-Q path's arrival count for ``dev`` and ``stream``: zeroed
    once here, left at 0 by every launch that completes."""
    key = (dev.index, stream)
    if key not in _arrivals:
        _arrivals[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _arrivals[key]


def _small_blocks_per_sm(lib, code: int, Q: int, k: int, dev) -> int:
    """Blocks of the small-Q kernel that fit on one SM of ``dev`` (the
    CUDA occupancy calculator, once per kernel instance and device)."""
    key = (code, Q, k, dev.index)
    if key not in _blocks_per_sm:
        n = ctypes.c_int(0)
        err = lib.gm_small_blocks_per_sm(code, Q, k, ctypes.byref(n))
        if err != 0 or n.value < 1:
            raise RuntimeError("gallery_match: no block of the small-Q "
                               "kernel fits an SM: "
                               + lib.gm_error_string(err).decode())
        _blocks_per_sm[key] = n.value
    return _blocks_per_sm[key]


def _match_cuda(q, g, g_scale, k_eff: int, fuse_norm: bool):
    global launches, last_plan
    Q, D = q.shape
    N = g.shape[0]
    if g.dtype not in _DTYPE_CODE:
        raise ValueError(f"gallery_match: no kernel for a {g.dtype} gallery")
    want_q = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
    if q.dtype != want_q or (g_scale is not None
                             and g_scale.dtype != torch.float32):
        raise ValueError(f"gallery_match: a {g.dtype} gallery takes {want_q} "
                         "queries and fp32 scales")
    if not (q.is_contiguous() and g.is_contiguous()):
        raise ValueError("gallery_match: q and g must be contiguous")
    if g_scale is not None and not g_scale.is_contiguous():
        raise ValueError("gallery_match: g_scale must be contiguous")
    lib = _library()
    dev = q.device
    code = _DTYPE_CODE[g.dtype]
    with torch.cuda.device(dev):
        bps = _small_blocks_per_sm(lib, code, Q, k_eff, dev) \
            if Q <= SMALL_Q and Q * k_eff <= SMALL_QK else 0
        path, S = plan(Q, k_eff, N, D, g.element_size(),
                       g.data_ptr() % 16 == 0,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count, bps)
        n_rounds = rounds(k_eff)
        k_round = min(k_eff, MAX_K)        # a round's partials
        part_s = torch.empty((Q, S, k_round), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((Q, S, k_round), dtype=torch.int32, device=dev)
        out_s = torch.empty((Q, k_eff), dtype=torch.float32, device=dev)
        out_i = torch.empty((Q, k_eff), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [code, q.data_ptr(), g.data_ptr(),
                g_scale.data_ptr() if g_scale is not None else None,
                Q, N, D, k_eff, int(fuse_norm), S, part_s.data_ptr(),
                part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream]
        if path == "small":
            count = _arrival_count(dev, stream)
            args.insert(12, count.data_ptr())
            err = lib.gm_match_small(*args)
            if err != 0:
                count.zero_()
        else:
            err = lib.gm_match(*args)
    if err != 0:
        raise RuntimeError("gallery_match: kernel launch failed: "
                           + lib.gm_error_string(err).decode())
    launches += n_rounds
    last_plan = (path, S, n_rounds)
    return out_s, out_i


def _topk_sorted(s: torch.Tensor, k_eff: int):
    """Top-k of each row by score descending, index ascending on ties (a
    stable sort; ``torch.topk`` promises no order among ties)."""
    scores, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return scores[:, :k_eff].contiguous(), \
        idx[:, :k_eff].to(torch.int32).contiguous()


def gallery_match_plain(q, g, g_scale=None, *, k: int, fuse_norm: bool):
    """The kernel's function in plain PyTorch, on whatever device the
    tensors are on (``k`` already clamped to N): the CPU path, and what the
    kernel is held against on the card."""
    qf = q.float()
    if fuse_norm:
        qf = qf * torch.rsqrt(torch.clamp(
            (qf * qf).sum(dim=-1, keepdim=True), min=1e-18))
    s = qf @ g.float().T
    if g_scale is not None:
        s = s * g_scale.float()[None, :]
    return _topk_sorted(s, k)


def _check(q, g, g_scale):
    if q.dim() != 2 or g.dim() != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(f"gallery_match: bad shapes q{tuple(q.shape)} "
                         f"g{tuple(g.shape)}")
    if g.shape[0] == 0:
        raise ValueError("gallery_match: empty gallery")
    if q.shape[0] == 0:
        raise ValueError("gallery_match: no queries")
    devs = {q.device, g.device} | ({g_scale.device} if g_scale is not None
                                   else set())
    if len(devs) != 1:
        raise ValueError(f"gallery_match: tensors on several devices {devs}")
    if g_scale is not None and tuple(g_scale.shape) != (g.shape[0],):
        raise ValueError("gallery_match: g_scale must be (N,)")


def _launch(q, g, g_scale, *, k: int, fuse_norm: bool):
    _check(q, g, g_scale)
    N = g.shape[0]
    k_eff = max(1, min(k, N))                          # clamp k > N
    if q.device.type == "cpu":
        scores, idx = gallery_match_plain(q, g, g_scale, k=k_eff,
                                          fuse_norm=fuse_norm)
    elif q.device.type == "cuda":
        scores, idx = _match_cuda(q, g, g_scale, k_eff, fuse_norm)
    else:
        raise ValueError(f"gallery_match: no kernel for device {q.device}")
    if k_eff < k:                                      # k > N sentinels
        Q = q.shape[0]
        scores = torch.cat([scores, scores.new_full((Q, k - k_eff), NEG)], 1)
        idx = torch.cat([idx, idx.new_full((Q, k - k_eff), -1)], 1)
    return scores, idx


def gallery_match_cuda(q: torch.Tensor, g: torch.Tensor, *, k: int = 5,
                       fuse_norm: bool = False):
    """q: (Q, D) queries; g: (N, D) gallery rows, fp32 or bf16 (both
    normalized unless ``fuse_norm`` handles the queries in the kernel).
    Returns (scores (Q, k) f32, idx (Q, k) i32), scores descending; when
    ``k > N`` the trailing columns hold (NEG, -1)."""
    if g.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    else:
        q = q.float()
        g = g.float()
    return _launch(q.contiguous(), g, None, k=k, fuse_norm=fuse_norm)


def gallery_match_quant_cuda(q: torch.Tensor, g_q: torch.Tensor,
                             g_scale: torch.Tensor, *, k: int = 5,
                             fuse_norm: bool = False):
    """int8 path: ``g_q`` (N, D) int8 per-row quantized gallery with fp32
    ``g_scale`` (N,); the query stays fp32, scores are fp32-accumulated then
    scaled per gallery row."""
    if g_q.dtype != torch.int8:
        raise ValueError(f"gallery_match_quant: g_q must be int8, not "
                         f"{g_q.dtype}")
    return _launch(q.float().contiguous(), g_q, g_scale.float(), k=k,
                   fuse_norm=fuse_norm)


def quantize_gallery(g: torch.Tensor):
    """Symmetric per-row int8 quantization: returns (values (N, D) int8,
    scale (N,) f32) with ``values * scale[:, None] ~= g``.  ``torch.round``
    rounds half to even, as the reference does."""
    g = g.float()
    amax = g.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_gallery(g_q: torch.Tensor, g_scale: torch.Tensor):
    """Inverse of ``quantize_gallery`` (the int8 oracle's input)."""
    return g_q.float() * g_scale.float()[:, None]
