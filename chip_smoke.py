#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. card: the GPU's name and power limit, from nvidia-smi;
2. build: compile the four CUDA kernels, the flash forward's training
   instances (``flash_attention_lse.cu``) and the two backward kernels
   from ``src/repro_torch/kernels/csrc`` (one nvcc each for sm_90a,
   started together) and print each build time; count the tensor-core
   (HGMMA) and TMA-load (UTMALDG) instructions in the flash library's SASS
   (``cuobjdump``), which must hold both, the tensor-core instructions
   (HMMA, HGMMA) in the SSD library's and the SSD backward library's, which
   must hold some, and HGMMA, UTMALDG (the wgmma path) and HMMA (the
   general bf16 path) in the flash backward library's, which must hold
   all three;
3. gallery-match kernel vs plain: the kernel against its plain PyTorch
   version on the card, for fp32, bf16 and int8 galleries at Q in
   {1, 16, 256}, N in {1000, 262144}, D = 128, k in {1, 5}, plus k > N,
   galleries that take the tiled path's element-wise loads, and the
   small-Q path's edges: Q in {1, 2, 3, Q_S, Q_S + 1} x N in {1, 63, 64,
   65, 1000, 1024, 262144} x k in {1, 8, 64}, and its largest Q * k
   (Q = 1, k = 32; Q = 4, k = 8); equal rows scored by two
   blocks (one in the ragged last range) must tie to the lower index on
   both paths; two runs at the serving and coarse-scan shapes must be
   bit-identical; the check must reject a planted fault (top score x1.05,
   first two indices swapped); then the kernel's (with the path it took),
   the plain version's and ``torch.topk(q @ g.T)``'s device times at
   N = 262144, Q in {1, Q_S, 16, 256} (from a profiler trace) beside the
   card's bound for the same work; then any k and D at N = 262144: k in
   {64, 65, 100, 1000, N + 3} (``ROUND_KS``: one round of the tiled path
   finds 64) at Q in {1, 16} and D in {768, 2048} (``WIDE_DS``) at k in
   {1, 100}, each held against the plain version (every query's rows
   distinct), the first 64 entries of each k > 64 call equal to the k =
   64 call's, planted faults rejected at k = 100 (also entry 64 repeating
   entry 63, a row repeated across two rounds), and each call's rounds
   (its launches) and device time (CUDA events) beside the bound;
4. rescore kernel vs plain: the cell-rescore kernel against its plain
   version over the ragged cells of one 262,144-row shard (pad rows
   poisoned, so a read of one shows), at Q in {1, 16, 256}, c in
   {1, 8, 16}, k in {1, 5}, plus -1 probes (c > K), k past the probed
   rows, empty cells, D = 36 and 260 and a misaligned array (the
   two-pass path), equal rows in two probed cells (positions equal), a
   query whose every probe is -1, k = MAX_K at Q = 16 and 256 with
   c = 16, cells whose valid rows are exact multiples of a warp's rows
   for each block shape and with one and several passes a block, and 40
   probes a query; the count of inputs each path took; two runs
   bit-identical at the serving shape; the check must reject a planted
   fault at k = 5 (top score x1.05, first two positions swapped); then
   its device and per-call times at the serving shape (Q = 1, c = 8,
   k = 1), with the path ``plan()`` took and the kernels launched a call
   (from a trace: one, on the fused path), beside the plain version's,
   an empty kernel's on the same grid (the latency floor) and the bound;
   then on the same cells k in {65, 100}, and on the same cells at D = 768
   k in {1, 100}, at Q in {1, 16} with c = 8, as phase 3's rounds; then
   the cipher's keystream made on the card: bit-identical to the CPU's
   for 2^20 + 3 words (a flipped bit caught), and the wall time to make
   one 262,144-row shard's keystream and to encrypt and decrypt the shard;
5. flash-attention kernel vs plain: in fp32 and bf16, on the CPU tests'
   shapes (GQA, MQA, bidirectional, window 128, S = 384, 192/128 head
   dims, D = 80, Sq < Sk), the kernel's edges (D = 240 with window 1024,
   192/128 at S = 1024, Sq = Sk = 1000 as strided views), every (D, Dv)
   pair the kernel is instantiated for at S = 136, and the ten
   serving shapes, (8, 32, 2048, 80) MHA, (8, 32/4, 2048, 64) GQA,
   (8, 128, 2048, 192/128) MLA, gemma3's (8, 16/8, 2048, 240) with
   window 1024 (local) and without (global), whisper's non-causal encoder
   (8, 8, 1500, 64) and cross attention (416 queries over 1500 keys),
   codeqwen's (8, 32, 2048, 128) MHA, starcoder2's (8, 48/4, 2048, 128)
   and internvl2's (8, 48/8, 2048, 128), these as the model's strided
   (B, S, H, D) views and run twice, the two outputs bit-identical; bf16
   outputs are held element by element, relative to one bf16 ulp and the
   row's RMS, and every check must also reject a planted 5 % error on the
   later positions; then the kernel's, the plain version's and
   ``F.scaled_dot_product_attention``'s (with the window's mask written
   out, or no mask) device times at the serving shapes beside the bound
   (the kept (query, key) pairs' flops), with each one's share of it;
   then the backward kernels in both dtypes: dq, dk and dv through
   ``FlashAttention`` against ``flash_attention_backward`` (autograd
   through the plain version) at the serving shapes' masks and head dims
   at batch 1-2, the smoke MLA pair (24, 16), padded to (32, 32), and a
   window with Sq >= Sk + window (rows that see no key), on the path
   ``plan_backward`` gives (wgmma for head dims 64, 80 and 128, else
   general) and, where that is wgmma, on the general path too, each
   gradient by its relative Frobenius error (``FLASH_BWD_REL``), two calls
   bit-identical, a planted 5 % fault rejected, and the forward's
   log-sum-exp against the plain one; then timed, split by kernel, at
   the training shapes (``FLASH_TRAIN``, which must take the wgmma path;
   the general path timed beside it) beside the plain backward,
   ``scaled_dot_product_attention``'s backward and the bound of each
   path's arithmetic (2.5 times the forward's flops; in fp32 three bf16
   products each on the wgmma path, fp32 FMAs on the general one);
6. SSD kernel vs plain: in fp32 and bf16, on the CPU tests' shapes, the
   kernel's edges (one chunk; a chunk of 100; P = 8 with N = 4; the smoke
   config, P = N = 16 and L = 32, as strided views; one sequence of one
   head) and the serving shape (8, 2048, 80, 64), N = 64, chunk 256, as
   the model's strided slices, each printing the path ``plan()`` took; on
   the staged path each stage's output (chunk states, chunk totals,
   passed states) is held against the plain version's, then y and the
   final state, and a failure names the stage, dtype and shape; the
   serving shape runs twice, bit-identical, and every output's check must
   reject a planted 5 % fault there; then the kernel's (split by stage)
   and the plain version's device times at the serving shape in both
   dtypes beside the bound on tensor cores and on the FMA units; then the
   backward kernels: dx, ddt, dA, dB and dC through ``MambaSSD`` against
   ``mamba2_ssd_backward`` at zamba2's training microbatch
   (``SSD_TRAIN``, strided: the tensor path) and on the backward's general
   path (``SSD_BWD_GENERAL``, and ``SSD_BWD_LONG``, a chunk of 4096), as
   phase 5's (``SSD_BWD_REL``), then timed, split by kernel, beside the
   plain backward and the bounds (the tensor path's arithmetic, and the
   fp32 FMA peak);
7. the reference check: the biometric stages on the card vs on the CPU;
8. exact main path: ``run_biometric`` on the card once per match dtype,
   over a 4-shard watchlist of the 10 pipeline subjects plus 1,048,576
   random unit distractors (512 MiB of fp32 templates), 30 frames with the
   live hot-swap; then ``run_fleet`` for 3 s of offered traffic; and how
   many gallery-match calls had each query count Q, and which path each
   took; in each dtype, one ``match`` at k = 100 (``RANKED_K``: two
   rounds on each shard) of a served frame over the watchlist, its labels
   equal to the plain version's;
9. ANN main path: one such watchlist, indexed once (1024 cells), served by
   ``run_biometric(match_mode="ann", nprobe=8)`` once per match dtype; the
   served labels are held against the plain versions run on the kernels'
   own probe tables; then in each dtype the 30 served frames matched at
   ``nprobe=128`` (``WIDE_NPROBE``: the coarse scan runs two rounds), held
   the same way;
10. LM main path: ``run_lm`` serving full-width ``zamba2-2.7b`` and then
   ``tinyllama-1.1b`` (weights drawn on the card from a seeded generator),
   batch 8, prompt 2048, 32 generated tokens, in bf16 and then in fp32;
   then in bf16 ``deepseek-v2-236b`` (4 layers) and ``deepseek-v3-671b``
   (6 layers), both with int8 experts quantised from bf16 draws, the whole
   ``gemma3-12b``; ``codeqwen1.5-7b``, ``starcoder2-15b`` and
   ``internvl2-26b`` (with 256 random patches) cut to 20 layers each;
   ``whisper-base`` (1500 random frames, prompt 416, so 448 positions)
   and ``xlstm-1.3b`` (``LM_CUTS``, ``LM_PROMPTS``); each run must launch
   the SSD kernel once per Mamba-2 layer and the flash kernel once per
   attention application (gemma3: 40 windowed, 8 global; whisper: 6
   causal, 12 non-causal; xlstm none); the first call of each kernel and
   of each layer holding one in a prefill (``gqa_fwd``, gemma3's first
   local and first global one, whisper's first non-causal encoder one,
   ``cross_fwd``, ``mla_fwd``, ``mamba2_fwd``) is rerun on its recorded
   inputs with the plain versions and with a planted fault, and must
   agree with the first and reject the second (the xLSTM layers, which
   hold no kernel, ``mlstm_fwd`` and ``slstm_fwd``, against the same call
   in fp32); the prefill logits and the teacher-forced decode logits are
   held against the same model run with the kernels' plain versions (bf16
   runs against an fp32 run of the same weights: the bf16 weights move to
   the host first, so the two copies never share the card), and the
   token agreement is printed with the prefill time, decode rate and
   peak memory from ``run_lm``'s own line; then where the time goes: the
   teacher-forced run's prefill and decode device time split by kernel
   (profiler traces) against ``run_lm``'s wall times, and for xlstm the
   wall time of its sLSTM scans; last, ``codeqwen1.5-7b`` and
   ``deepseek-v2-236b`` once more with ``kv_cache_dtype="int8"``: served
   by ``run_lm``, then their teacher-forced decode held against the full
   forward within 2e-2 of max |logit| with fp32 weights, and in bf16 at
   most 1.5x as far from it as the decode on the bf16 cache, with the
   cache's GiB against the bf16 cache's;
11. the LM entry point as called with no arguments: ``run_lm(arch)`` for
   each of the ten archs, which serves the smoke config (head dim 16,
   or MLA's 24 / 16, which the wrapper pads to the kernel's 32 / 32) in
   bf16 on the card; its tokens must be in range and the flash kernel
   must have launched once per attention application (xlstm: none);
12. LM training: ``tinyllama-1.1b`` (global batch 16) and ``zamba2-2.7b``
   (4) at their published widths in fp32, sequence 2048, AdamW with
   clipping at 1.0, remat on, ``auto_microbatches`` giving 2 microbatches
   each.  For each model: one microbatch's loss and every gradient with
   the kernels, with their plain versions and with the planted fault,
   on the same weights and batch (the kernels' gradients wait on the
   host; the kernels' run with the plain backwards patched to raise, so
   its gradients come from the backward kernels), the loss held by its
   relative error and each leaf's gradient by its relative Frobenius
   error against the plain run's, each bound between the readings and
   the planted fault's; the launches of that microbatch (each block
   twice: forward and remat's recompute; one backward kernel an
   attention application and a Mamba-2 layer); then
   ``train.main`` for TRAIN_STEPS steps, the loss falling, and for
   tinyllama a second run that crashes at TRAIN_FAIL_AT, restores the
   step-TRAIN_CKPT_EVERY checkpoint and replays, its final loss within
   1e-3 of the clean run's; the step wall ms, tokens/s and peak memory
   from ``train.main``'s own lines; and, from two steps of the clean
   run traced in place (``TRAIN_TRACES``), the device idle share of one
   step against its own wall time (the device's activity alone traced,
   the least the profiler adds on the host), and the device ms of the
   flash and SSD forwards, of the backward kernels and of the rest in
   the next (the host's activity traced too), beside the step walls
   with the plain backwards (``TRAIN_WALL_PLAIN``);
13. the mesh (run after phase 6, before the serving phases): (a) the flash
   kernel at each serving shape's share of one rank of the production
   mesh's model axis (8): H / 8 query heads and the kv heads they read,
   and the SSD at zamba2's 80 / 8 = 10 heads, in both dtypes, held
   against the plain versions with a planted fault rejected, and timed
   ("local" rows); (b) on a world-1 NCCL group and a (data=1, model=1)
   ``DeviceMesh``, the sharded steps beside the unsharded path on the
   same seeded weights, through the steps the dry run traces
   (``steps.step_fn_for``'s prefill and serve steps, ``make_train_step``):
   ``tinyllama-1.1b`` bf16 prefill under ``tp`` and 4 greedy serve steps
   under ``decode``, ``zamba2-2.7b`` bf16 prefill under ``tp``,
   ``deepseek-v2-236b`` at 2 layers (1 dense + 1 MoE, int8 experts) bf16
   prefill and serve steps under ``decode_moe``, and one fp32
   ``tinyllama-1.1b`` train step under ``fsdp`` at 4 x 2048 in 2
   microbatches (then a second, timed): the prefill's logits, every
   step's token, the cache after the steps, the loss, the grad norm and
   every updated parameter bit-identical (a planted fault rejected); each
   sharded and unsharded run counted alone (launch counts set to 0 just
   before it), each count equal to the launches a profiler trace of that
   run saw and each sharded run's to its unsharded run's; both wall
   times printed (their difference is DTensor's host cost);
14. the port's examples, each a process of its own on the card (its
   default): ``quickstart_torch.py``, ``serve_biometric_torch.py``,
   ``arch_smoke_all_torch.py`` and ``elastic_recovery_torch.py`` (a clean
   and a recovered training run whose final losses agree within 1e-3)
   must exit 0 with their OK lines, and the flash kernel must have
   launched in ``arch_smoke_all_torch.py`` (``EXAMPLES_ON_CARD``).
Every profiler trace that times kernels or counts their launches is
bracketed by two marker kernels and counts only the launches between them;
a timing takes two whole traces in a row that hold the same launches and
agree within 1.25x in device time, a launch count a whole trace that saw
what the wrappers counted; up to eight tries (the host idle around the
calls from the second on), then the run fails.
Each run of a main path sets the kernels' launch counts to 0 just before
it and reads them just after.

The last two lines before the final one are the card's name and power
limit and a JSON object with each kernel's numbers; the final line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
TOL = 1e-5              # kernel vs plain, max abs score error (see phase 3)
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
PEAK_OPS_S = {          # H100 SXM dense peaks for the multiply-adds' type
    "tf32": 495e12,     # fp32-precise products on the tensor cores (SSD)
    "fp32": 67e12,      # fp32 query x fp32 gallery: CUDA cores, no TF32
    "bf16": 989e12,     # bf16 x bf16 with fp32 accumulation: tensor cores
    "int8": 67e12,      # fp32 query x int8 gallery: an fp32 product
}
N_BIG = 262_144
DISTRACTORS = 1_048_576
SHARDS = 4
DTYPES = ("fp32", "bf16", "int8")
LM_DTYPES = ("bf16", "fp32")
LM_ARCHS = ("zamba2-2.7b", "tinyllama-1.1b")
# served in bf16 only, each cut where 80 GB forces it: as many layers as
# leave the fp32 reference run of the same weights about 8 GiB under the
# card's 79.18 GiB (PERF.md §4 sizes each cut from the bytes a layer added
# to that run's peak on the card).  DeepSeek-V3 to 6 (3 dense + 3 MoE),
# with int8 experts quantised from bf16 draws.  DeepSeek-V2 (14 layers fit)
# to 4 (1 dense + 3 MoE, int8 experts), codeqwen1.5-7b (32 layers),
# starcoder2-15b (40) and internvl2-26b (48; its fp32 copy alone is 74 GiB)
# to 20 each, for the script's time: with phase 12 it reached 1099 s of
# its 1200, and phase 13 (the mesh) adds 25-40 s (PERF.md §4); their
# layers are the ones the whole runs hold (gemma3's and tinyllama's dense
# GQA layers, DeepSeek-V3's MoE layers).  The others whole
LM_BF16_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b", "gemma3-12b",
                 "codeqwen1.5-7b", "starcoder2-15b", "internvl2-26b",
                 "whisper-base", "xlstm-1.3b")
LM_CUTS = {"deepseek-v2-236b": {"n_layers": 4,
                                "expert_weights_dtype": "int8"},
           "deepseek-v3-671b": {"n_layers": 6,
                                "expert_weights_dtype": "int8"},
           "codeqwen1.5-7b": {"n_layers": 20},
           "starcoder2-15b": {"n_layers": 20},
           "internvl2-26b": {"n_layers": 20}}
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32
# whisper's prompt: prompt + generated tokens = 448, its decoder context
LM_PROMPTS = {"whisper-base": 416}
# served once more with kv_cache_dtype="int8": decode held against the full
# forward within the reference's bound (tests/test_archs.py)
LM_INT8_KV = ("codeqwen1.5-7b", "deepseek-v2-236b")
INT8_KV_REL = 2e-2
# flash kernel vs plain (flash_err): in fp32 the max abs error, as the
# outputs agree to rounding; in bf16 each output is rounded to bf16 and the
# kernel rounds its probabilities before normalising them, the plain version
# after, so an element may differ by one bf16 ulp of itself (2^-7 |p|) and
# by a share of its row's RMS, the bound on that share (readings in PERF.md)
FLASH_TOL = {"fp32": 1e-5, "bf16": 0.03}
# the SSD is held to its reference tests' allclose bounds
SSD_ATOL, SSD_RTOL = 2e-4, 1e-3
# a planted fault that every check of a kernel must catch: the outputs of
# the later half of the positions made PLANT times too large
PLANT = 1.05
# the first call of each kernel and of each layer that holds one in a
# prefill at full width, rerun on its recorded inputs with the plain
# versions: the flash kernel's output as above, the SSD's y and state by
# the Frobenius norm of the difference relative to the plain output's
# (SSD_REL; fp32 math on both sides), the layers' outputs by the same norm
# (LAYER_TOL).  With random weights the SSD adds ~3e-4 of the Mamba-2
# layer's signal, so that layer's bounds are small; each bound sits between
# the readings of the kernels and of a planted fault (PERF.md)
SSD_REL = 1e-4
# (a gqa_fwd call with a window, gemma3's local layers, is checked as
# "gqa_fwd[window]", a flash call with one as "flash_attention[window]")
# (a gqa_fwd call without the causal mask, whisper's encoder, as
# "gqa_fwd[noncausal]").  The xLSTM layers hold no kernel: their first
# calls in bf16 are held against the same call in fp32 (weights and
# inputs upcast), and the planted fault goes into the layer's output
LAYER_TOL = {("gqa_fwd", "fp32"): 1e-5, ("gqa_fwd", "bf16"): 7.5e-3,
             ("gqa_fwd[window]", "bf16"): 7.5e-3,
             ("gqa_fwd[noncausal]", "bf16"): 7.5e-3,
             ("cross_fwd", "bf16"): 7.5e-3,
             ("mla_fwd", "bf16"): 7.5e-3,
             ("mlstm_fwd", "bf16"): 2e-2, ("slstm_fwd", "bf16"): 2e-2,
             ("mamba2_fwd", "fp32"): 1e-6, ("mamba2_fwd", "bf16"): 1e-5}
NO_KERNEL = ("mlstm_fwd", "slstm_fwd")
# kernels vs plain through the whole model, logits relative to max |logit|:
# in fp32 the two agree to rounding (LM_REL); in bf16 two roundings of a
# 54-layer model with random weights drift apart by a few percent, so each
# is measured against an fp32 run of the same weights, and the kernels' run
# may stray at most LM_BF16_RATIO times as far as the plain versions' run
# (the layer check above is the tight one)
LM_REL = 1e-4
LM_BF16_RATIO = 1.5
CELLS = 1024            # cells of one N_BIG shard at the index's sqrt(N)
NPROBE = 8              # the serving path's probes per query
# k above the kernels' MAX_K (one round of the tiled path finds 64; k > N
# ends in sentinels) and rows wider than their MAX_D (staged in chunks)
ROUND_KS = (64, 65, 100, 1000, N_BIG + 3)
WIDE_DS = (768, 2048)
RANKED_K = 100          # the ranked candidate list phases 8 and 9 ask for
WIDE_NPROBE = 128       # the ANN probes past MAX_K that phase 9 asks for
DEV = "cuda"
T_START = time.perf_counter()


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def gallery(torch, gm, dtype, N, D, gen):
    """A unit-row gallery in the storage dtype: (g, scale or None)."""
    g = torch.randn((N, D), generator=gen, device=DEV)
    g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    if dtype == "int8":
        return gm.quantize_gallery(g)
    return (g.to(torch.bfloat16) if dtype == "bf16" else g), None


def run_kernel(gm, q, g, scale, k):
    if scale is not None:
        return gm.gallery_match_quant_cuda(q, g, scale, k=k, fuse_norm=True)
    return gm.gallery_match_cuda(q, g, k=k, fuse_norm=True)


def run_plain(torch, gm, q, g, scale, k):
    k_eff = min(k, g.shape[0])
    qc = q.to(torch.bfloat16) if g.dtype == torch.bfloat16 else q
    return gm.gallery_match_plain(qc, g, scale, k=k_eff, fuse_norm=True)


def run_library(torch, q, g, k):
    """One PyTorch top-k over the full score matrix (fp32 and bf16)."""
    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.topk(qn.to(g.dtype) @ g.T, k, dim=1)


def compare(torch, gm, dtype, Q, N, k, gen, D=128, misalign=False,
            fault=None):
    """Kernel vs plain on one shape; returns the max abs score error.
    ``misalign`` starts the gallery one element past a 16-byte boundary,
    which sends the kernel down its tiled path's element-wise loads.
    ``fault`` plants a fault in the kernel's (scores, indices) before they
    are checked (``check_faults``: the check must then fail)."""
    q = torch.randn((Q, D), generator=gen, device=DEV) * 3.0
    g, scale = gallery(torch, gm, dtype, N + misalign, D, gen)
    if misalign:
        g = g.reshape(-1)[1:1 + N * D].view(N, D)
        scale = scale[:N] if scale is not None else None
    s, i = run_kernel(gm, q, g, scale, k)
    torch.cuda.synchronize()
    return check_match(torch, gm, dtype, q, g, scale, k, s, i, fault)


def check_match(torch, gm, dtype, q, g, scale, k, s, i, fault=None):
    """The kernel's (scores, indices) ``s``, ``i`` of queries ``q`` over
    gallery ``g`` held against the plain version's; returns the max abs
    score error.  Every query's indices must be distinct rows."""
    Q, N = q.shape[0], g.shape[0]
    if fault is not None:
        s, i = fault(s.clone(), i.clone())
    ps, pi = run_plain(torch, gm, q, g, scale, k)
    k_eff = min(k, N)
    if tuple(s.shape) != (Q, k) or tuple(i.shape) != (Q, k):
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: shape {s.shape}")
    if k_eff < k and not (bool((s[:, k_eff:] == gm.NEG).all())
                          and bool((i[:, k_eff:] == -1).all())):
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: bad sentinels")
    s, i = s[:, :k_eff], i[:, :k_eff]
    err = float((s - ps).abs().max())
    if not err <= TOL:
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: score error {err}")
    srt = i.sort(dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()) or bool((srt < 0).any()):
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: a row repeated "
                             "or missing")
    # an index may differ only for a row the plain version scores within
    # TOL of its own pick (a tie within the tolerance)
    qc = q.to(torch.bfloat16) if dtype == "bf16" else q
    qf = qc.float()
    qf = qf * torch.rsqrt(torch.clamp((qf * qf).sum(-1, keepdim=True),
                                      min=1e-18))
    picked = (qf[:, None, :] * g[i.long()].float()).sum(-1)
    if scale is not None:
        picked = picked * scale[i.long()]
    bad = (i != pi) & ((picked - ps).abs() > TOL)
    if bool(bad.any()):
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: index mismatch")
    return err


# A device-only profiler trace on the H100 can come back without its
# kernels: empty, missing launches at its ends or between them, or holding
# launches of an earlier trace.  So every trace that times kernels or
# counts their launches is bracketed by two marker kernels and counts only
# the launches between them; a trace that lacks a marker is taken again,
# with the host idle around the calls from the second try on; a timing
# takes two whole traces in a row that hold the same launches of every
# kernel, their device times within TRACE_AGREE; none so in TRACE_TRIES
# raises.
MARK = "spin_kernel"        # ``torch.cuda._sleep``'s kernel
MARK_CYCLES = 1000
TRACE_TRIES = 8
TRACE_PAD_S = 0.05
TRACE_AGREE = 1.25


def marked_trace(torch, run, pad):
    """(``run()``'s result, [(kernel name, device ns)] of the launches
    between the two markers around it, or where the trace does not hold
    exactly two markers a note of what it holds), the host idle ``pad``
    seconds before and after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        torch.cuda._sleep(MARK_CYCLES)
        res = run()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(pad)
    events = [(e.name(), e.start_ns(), e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    marks = sorted(t for name, t, _ in events if MARK in name)
    if len(marks) != 2:
        return res, (f"{len(marks)} markers and {len(events) - len(marks)} "
                     "other launches")
    return res, [(name, ns) for name, t, ns in events
                 if marks[0] < t < marks[1] and MARK not in name]


def device_calls(torch, run, n, what):
    """{kernel name: (device us, launches) a call} over ``run()``'s ``n``
    calls, from the later of the last two whole marked traces, once they
    agree (see above)."""
    prev = None
    for attempt in range(TRACE_TRIES):
        _, inside = marked_trace(torch, run, TRACE_PAD_S if attempt else 0.0)
        if isinstance(inside, str):
            print(f"[trace] {what}: try {attempt + 1} holds {inside}")
            continue
        total, count = {}, {}
        for name, ns in inside:
            total[name] = total.get(name, 0.0) + ns / 1e3
            count[name] = count.get(name, 0) + 1
        us = sum(total.values())
        if prev is not None and count and count == prev[1] and \
                max(us, prev[0]) <= TRACE_AGREE * min(us, prev[0]):
            return {k: (total[k] / n, count[k] / n) for k in total}
        if prev is not None:
            print(f"[trace] {what}: try {attempt + 1} holds "
                  f"{sum(count.values())} launches in {us:.1f} us, the one "
                  f"before {sum(prev[1].values())} in {prev[0]:.1f}")
        prev = (us, count)
    raise AssertionError(f"{what}: no two whole profiler traces in a row "
                         f"that agree in {TRACE_TRIES} tries")


def timed(torch, fn, galleries, iters=10, what="timed"):
    """(device ms, call ms) of one call of ``fn(*args)``, ``args`` taken in
    turn from ``galleries``.

    The gallery-match calls rotate over four galleries of one shard's size,
    as the serving path's four shards do, so no call finds its gallery in
    the 50 MB L2 cache.  Device ms is the kernels' own time over the
    calls, summed from the second of two whole marked profiler traces
    that agree (``device_calls``); call ms is CUDA events around back-to-back calls, so it also holds any
    time the card waits on the host."""
    def rounds(n):
        for _ in range(n):
            for args in galleries:
                fn(*args)

    rounds(2)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    rounds(iters)
    e1.record()
    e1.synchronize()
    n = iters * len(galleries)
    call_ms = e0.elapsed_time(e1) / n
    per = device_calls(torch, lambda: rounds(iters), n, what)
    return sum(us for us, _ in per.values()) / 1e3, call_ms


def bound(dtype, Q, N, D, k):
    """The least time the card could take (ms), and what bounds it."""
    item = {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
    q_item = 2 if dtype == "bf16" else 4
    nbytes = Q * D * q_item + N * D * item + Q * k * 8
    if dtype == "int8":
        nbytes += N * 4                          # per-row scales
    return work_bound(dtype, nbytes, 2.0 * Q * N * D)


def phase_build(builds):
    """Build every kernel library at once, one nvcc each (``builds``: the
    wrappers' build functions), and print each build time and ptxas's
    report."""
    def one(build):
        t0 = time.perf_counter()
        lib = build(verbose=True)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(one, builds))
    for lib, secs in built:
        print(f"[build] {lib.relative_to(ROOT)} in {secs:.1f} s")


def sass_counts(build, ops):
    """How many of each instruction of ``ops`` the library that ``build``
    (a wrapper's build function) gives holds, from ``cuobjdump -sass``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build())], check=True,
                          capture_output=True, text=True).stdout
    counts = {op: sum(op in line for line in sass.splitlines())
              for op in ops}
    print(f"[sass] {build().relative_to(ROOT)}: "
          + ", ".join(f"{n} {op}" for op, n in counts.items()))
    return counts


def phase_sass(FA, SSD):
    """The flash library's bf16 path must issue tensor-core (HGMMA) and
    TMA loads (UTMALDG), the SSD library's staged path tensor-core
    instructions (HMMA or HGMMA); the flash backward library's wgmma path
    warpgroup products (HGMMA) and TMA loads (UTMALDG), its general bf16
    path tensor-core instructions (HMMA); the SSD backward library's
    tensor path tensor-core instructions (HMMA or HGMMA)."""
    flash = sass_counts(FA.build, ("HGMMA", "UTMALDG"))
    if not all(flash.values()):
        raise AssertionError(f"the flash library's bf16 path issues no "
                             f"tensor-core or no TMA loads: {flash}")
    ssd = sass_counts(SSD.build, ("HMMA", "HGMMA"))
    if not any(ssd.values()):
        raise AssertionError(f"the SSD library issues no tensor-core "
                             f"instructions: {ssd}")
    flash_bwd = sass_counts(FA.build_backward, ("HGMMA", "UTMALDG", "HMMA"))
    if not all(flash_bwd.values()):
        raise AssertionError(f"the flash backward library issues no "
                             f"warpgroup products, no TMA loads or no "
                             f"mma.sync: {flash_bwd}")
    ssd_bwd = sass_counts(SSD.build_backward, ("HMMA", "HGMMA"))
    if not any(ssd_bwd.values()):
        raise AssertionError(f"the SSD backward library issues no "
                             f"tensor-core instructions: {ssd_bwd}")
    return flash, ssd, flash_bwd, ssd_bwd


def fault_top_score(s, i):
    """A planted fault: each query's top score PLANT times too large."""
    s[:, 0] *= PLANT
    return s, i


def fault_swap(s, i):
    """A planted fault: each query's first two indices swapped."""
    i[:, [0, 1]] = i[:, [1, 0]]
    return s, i


def check_faults(torch, gm, gen):
    """``compare`` must reject the kernel's result with a planted fault, on
    each path and in each dtype."""
    n = 0
    for dtype in DTYPES:
        for Q in (1, gm.SMALL_Q + 1):
            for fault in (fault_top_score, fault_swap):
                try:
                    compare(torch, gm, dtype, Q, 1000, 8, gen, fault=fault)
                except AssertionError:
                    n += 1
                    continue
                raise AssertionError(f"{dtype} Q={Q}: compare passed the "
                                     f"planted fault {fault.__name__}")
    print(f"[kernel] compare rejects both planted faults ({n} of {n}: top "
          f"score x{PLANT}, first two indices swapped) on both paths")


def block_of(gm, dtype, N, row):
    """The block of the last launch's grid that scores ``row``."""
    path, S, _ = gm.last_plan
    if path == "small":
        item = {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
        group = row // (gm._GROUP_BYTES // (gm.SMALL_D * item))
        return group % (S * gm._SMALL_WARPS) // gm._SMALL_WARPS
    return row // -(-N // S)


def check_ties(torch, gm, gen):
    """Equal rows i < j scored by different blocks, j in the ragged last
    range, and queries equal to them: k = 1 must return i, and k = 2 must
    return (i, j) with equal scores."""
    N, D, i, j = N_BIG + 5, 128, 3, N_BIG + 3
    for dtype in DTYPES:
        g, scale = gallery(torch, gm, dtype, N, D, gen)
        g[j] = g[i]
        if scale is not None:
            scale[j] = scale[i]
        row = g[i].float() * (scale[i] if scale is not None else 1.0)
        for Q in (1, gm.SMALL_Q + 1):
            q = row.expand(Q, D).contiguous()
            s1, i1 = run_kernel(gm, q, g, scale, 1)
            s2, i2 = run_kernel(gm, q, g, scale, 2)
            bi, bj = block_of(gm, dtype, N, i), block_of(gm, dtype, N, j)
            if bi == bj:
                raise AssertionError(f"{dtype} Q={Q}: rows {i} and {j} fall "
                                     f"in one block ({gm.last_plan})")
            if not (bool((i1[:, 0] == i).all()) and bool((i2[:, 0] == i).all())
                    and bool((i2[:, 1] == j).all())
                    and torch.equal(s2[:, 0], s2[:, 1])):
                raise AssertionError(f"{dtype} Q={Q}: equal rows {i}, {j} "
                                     f"gave k=1 {i1[:, 0].tolist()}, k=2 "
                                     f"{i2.tolist()} {s2.tolist()}")
            print(f"[kernel] {dtype} Q={Q} ({gm.last_plan[0]}): equal rows "
                  f"{i} (block {bi}) and {j} (block {bj} of "
                  f"{gm.last_plan[1]}, ragged last range) tie: k=1 -> {i}, "
                  f"k=2 -> ({i}, {j})")


def check_repeatable(torch, gm, gen):
    """Two runs bit-identical at the serving shape and the coarse scan's."""
    for dtype in DTYPES:
        for N, k in ((N_BIG, 1), (CELLS, NPROBE)):
            g, scale = gallery(torch, gm, dtype, N, 128, gen)
            q = torch.randn((1, 128), generator=gen, device=DEV)
            a = run_kernel(gm, q, g, scale, k)
            b = run_kernel(gm, q, g, scale, k)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{dtype} N={N} k={k}: two runs differ")
        print(f"[kernel] {dtype}: two runs bit-identical at Q=1 N={N_BIG} "
              f"k=1 and at Q=1 N={CELLS} k={NPROBE} ({gm.last_plan[0]} path)")


def fault_round_edge(s, i):
    """A planted fault: each query's entry MAX_K (the second round's first)
    replaced by the first round's last, a row repeated across the rounds."""
    s[:, 64], i[:, 64] = s[:, 63], i[:, 63]
    return s, i


def event_ms(torch, fn):
    """(result, ms) of one call of ``fn``, from CUDA events around it: the
    device's time from the first launch to the last one's end, the host's
    enqueueing gaps included (a call of many rounds enqueues them from C,
    far faster than the card runs them)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = fn()
    e1.record()
    e1.synchronize()
    return res, e0.elapsed_time(e1)


def check_rounds(torch, gm, gen):
    """k above MAX_K and rows wider than MAX_D at N = N_BIG, in each dtype:
    every ROUND_KS k at Q in {1, 16} and every WIDE_DS width at k in
    {1, 100}, held against the plain version; each k > MAX_K call's first
    MAX_K entries equal to the k = MAX_K call's; a planted fault rejected
    at the round edge and at the top; and each call's rounds (launches)
    and device time (CUDA events around a second call, the first for
    k > N) beside the bound.  Returns {dtype: [reading, ...]}."""
    out = {}
    for dtype in DTYPES:
        rows = []
        for D, ks in ((128, ROUND_KS), *((d, (1, 100)) for d in WIDE_DS)):
            g, scale = gallery(torch, gm, dtype, N_BIG, D, gen)
            for Q in (1, 16):
                q = torch.randn((Q, D), generator=gen, device=DEV) * 3.0
                first = None
                for k in ks:
                    gm.launches = 0
                    (s, i), ms = event_ms(torch, lambda: run_kernel(
                        gm, q, g, scale, k))
                    launches, plan = gm.launches, gm.last_plan
                    err = check_match(torch, gm, dtype, q, g, scale, k, s, i)
                    if k <= N_BIG:
                        _, ms = event_ms(torch, lambda: run_kernel(
                            gm, q, g, scale, k))
                    if k == gm.MAX_K:
                        first = (s, i)
                    elif k > gm.MAX_K and D == 128 and not (
                            torch.equal(s[:, :gm.MAX_K], first[0])
                            and torch.equal(i[:, :gm.MAX_K], first[1])):
                        raise AssertionError(
                            f"{dtype} Q={Q} k={k}: the first {gm.MAX_K} "
                            f"entries differ from the k={gm.MAX_K} call's")
                    if launches != gm.rounds(min(k, N_BIG)):
                        raise AssertionError(f"{dtype} Q={Q} D={D} k={k}: "
                                             f"{launches} launches")
                    if k == 100 and D == 128 and Q == 16:
                        for fault in (fault_top_score, fault_swap,
                                      fault_round_edge):
                            try:
                                check_match(torch, gm, dtype, q, g, scale, k,
                                            s, i, fault)
                            except AssertionError:
                                continue
                            raise AssertionError(
                                f"{dtype} k={k}: the check passed the "
                                f"planted fault {fault.__name__}")
                    bms, by = bound(dtype, Q, N_BIG, D, min(k, N_BIG))
                    rows.append({"Q": Q, "D": D, "k": k, "path": plan[0],
                                 "rounds": launches, "max_abs_err": err,
                                 "ms": ms, "bound_ms": bms, "bound_by": by})
                    print(f"[kernel-rounds] {dtype} Q={Q:2d} N={N_BIG} D={D} "
                          f"k={k}: == plain (max abs err {err:.3g}), "
                          f"{plan[0]} path, {launches} rounds, "
                          f"ms={ms:.4f} (CUDA events) bound_ms={bms:.4f} "
                          f"({by})")
            del g, scale
        out[dtype] = rows
        print(f"[kernel-rounds] {dtype}: the first {gm.MAX_K} entries of "
              f"every k > {gm.MAX_K} call equal the k={gm.MAX_K} call's; "
              "the check rejects the planted faults at k=100 (top score "
              f"x{PLANT}, first two indices swapped, entry {gm.MAX_K} "
              f"repeating entry {gm.MAX_K - 1})")
    return out


def phase_kernel(torch, gm):
    gen = torch.Generator(device=DEV).manual_seed(1234)
    QS = gm.SMALL_Q
    shapes = [(Q, N, k, 128, False) for Q in (1, 16, 256)
              for N in (1000, N_BIG) for k in (1, 5)]
    shapes += [(3, 3, 5, 128, False), (5, 1, 2, 128, False),  # k > N, Q < 8
               # the element-wise load path: long rows, odd rows, unaligned
               (5, 1000, 5, 260, False), (3, 777, 3, 36, False),
               (33, 999, 4, 128, True), (1, 999, 4, 128, True)]
    # the small-Q path's edges, and the tiled path just above it (in Q,
    # and in Q * k: the small-Q path's largest k at Q = 1 and 4)
    shapes += [(Q, N, k, 128, False) for Q in (1, 2, 3, QS, QS + 1)
               for N in (1, 63, 64, 65, 1000, 1024, N_BIG)
               for k in (1, 8, 64) if k < 64 or N >= 64]
    shapes += [(Q, N, gm.SMALL_QK // Q, 128, False) for Q in (1, 4)
               for N in (65, 1000, N_BIG)]
    errs = {}
    for dtype in DTYPES:
        err, paths = 0.0, {"small": 0, "tiled": 0}
        for Q, N, k, D, mis in shapes:
            err = max(err, compare(torch, gm, dtype, Q, N, k, gen, D, mis))
            paths[gm.last_plan[0]] += 1
        errs[dtype] = err
        print(f"[kernel] {dtype}: kernel == plain on {len(shapes)} shapes "
              f"({paths['small']} small-Q path, {paths['tiled']} tiled), max "
              f"abs score error {err:.3g} (tolerance {TOL})")
    check_ties(torch, gm, gen)
    check_repeatable(torch, gm, gen)
    check_faults(torch, gm, gen)
    rounds = check_rounds(torch, gm, gen)
    timings = {}
    D = 128
    for dtype in DTYPES:
        shards = [gallery(torch, gm, dtype, N_BIG, D, gen) for _ in range(4)]
        for Q in (1, QS, 16, 256):
            for k in (1, 5):
                q = torch.randn((Q, D), generator=gen, device=DEV)
                kms, kcall = timed(torch, lambda g, sc: run_kernel(
                    gm, q, g, sc, k), shards)
                path = gm.last_plan
                pms, _ = timed(torch, lambda g, sc: run_plain(
                    torch, gm, q, g, sc, k), shards)
                lms = None
                if dtype != "int8":
                    lms, _ = timed(torch, lambda g, sc: run_library(
                        torch, q, g, k), shards)
                bms, by = bound(dtype, Q, N_BIG, D, k)
                timings[(dtype, Q, k)] = (kms, pms, lms, bms, by, path[0])
                lib = f"{lms:.4f}" if lms is not None else "n/a"
                print(f"[kernel] {dtype} Q={Q:3d} N={N_BIG} D={D} k={k}: "
                      f"kernel_ms={kms:.4f} (per call {kcall:.4f}, "
                      f"{path[0]} path, {path[1]} blocks) plain_ms={pms:.4f} "
                      f"library_ms={lib} bound_ms={bms:.4f} ({by})")
        del shards
    return errs, timings, rounds


def shard_cells(torch, gm, dtype, K, D, gen, mean_len=256, misalign=False,
                lens=None):
    """One shard's packed cells in the storage dtype: (cells, scale or
    None, lens, L).  Lengths are ragged around ``mean_len`` with every 97th
    cell empty, unless ``lens`` gives them; pad rows are poisoned (NaN, or
    int8 rows with a 1e30 scale), so a kernel that scored one would be
    caught.  ``misalign`` starts the array one element past a 16-byte
    boundary."""
    if lens is None:
        lens = (mean_len + 0.15 * mean_len * torch.randn(
            K, generator=gen, device=DEV)).round().clamp(min=0).int()
        lens[::97] = 0
    L = max(8, -(-int(lens.max()) // 8) * 8)
    rows = torch.randn((K * L, D), generator=gen, device=DEV)
    rows = rows / torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    pad = torch.arange(K * L, device=DEV) % L >= lens.repeat_interleave(L)
    scale = None
    if dtype == "int8":
        rows, scale = gm.quantize_gallery(rows)
        rows[pad], scale[pad] = 127, 1e30
    else:
        rows[pad] = float("nan")
        rows = rows.to(torch.bfloat16) if dtype == "bf16" else rows
    if misalign:
        buf = rows.new_empty(K * L * D + 1)
        rows = buf[1:].view(K * L, D).copy_(rows)
    return rows, scale, lens, L


def probe_table(torch, Q, c, K, gen):
    """c distinct random cells per query (-1 past the K-th, as the coarse
    scan pads when c > K)."""
    ids = torch.rand((Q, K), generator=gen, device=DEV).argsort(dim=1)
    ids = ids[:, :c].int()
    if c > K:
        ids = torch.cat([ids, ids.new_full((Q, c - K), -1)], 1)
    return ids.contiguous()


def compare_rescore(torch, A, q, cells, scale, ids, lens, L, k, strict=False,
                    fault=None):
    """Rescore kernel vs plain on one input; returns the max abs score
    error.  Every query's positions must be distinct.  A position may
    differ from the plain version's only where the plain version scores
    the kernel's pick within TOL of its own, and must be a valid row of a
    probed cell; ``strict`` asks for equal positions
    (inputs with exact ties).  ``fault`` plants a fault in the kernel's
    (scores, positions) before they are checked (the check must then
    fail)."""
    Q = q.shape[0]
    s, p = A.cell_rescore_cuda(q, cells, ids, lens, scale, k=k, L=L)
    torch.cuda.synchronize()
    if fault is not None:
        s, p = fault(s.clone(), p.clone())
    qc = q.to(torch.bfloat16) if cells.dtype == torch.bfloat16 else q
    ps, pp = A.cell_rescore_plain(qc, cells, ids, lens, scale, k=k, L=L,
                                  fuse_norm=True)
    what = f"{cells.dtype} Q={Q} c={ids.shape[1]} k={k} L={L}"
    if tuple(s.shape) != (Q, k) or tuple(p.shape) != (Q, k):
        raise AssertionError(f"{what}: shape {tuple(s.shape)}")
    if not torch.equal(p < 0, pp < 0) or not bool((s[p < 0] == A.NEG).all()):
        raise AssertionError(f"{what}: filled slots differ from the plain "
                             "version's")
    err = float((s - ps).abs().max())
    if not err <= TOL:
        raise AssertionError(f"{what}: score error {err}")
    live = p >= 0
    srt = torch.where(live, p, -1 - torch.arange(
        p.shape[1], device=p.device)).sort(dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"{what}: a position repeated")
    cell, row = (p // L).long(), (p % L).long()
    probed = (ids.long()[:, :, None] == cell[:, None, :]).any(dim=1)
    valid = probed & (row < lens.long()[cell.clamp(min=0)])
    if not bool(valid[live].all()):
        raise AssertionError(f"{what}: the kernel picked a pad row or a row "
                             "of a cell it did not probe")
    qf = qc.float()
    qf = qf * torch.rsqrt(torch.clamp((qf * qf).sum(-1, keepdim=True),
                                      min=1e-18))
    pl = p.long().clamp(min=0)
    picked = (qf[:, None, :] * cells[pl].float()).sum(-1)
    if scale is not None:
        picked = picked * scale[pl]
    bad = live & (p != pp) & ((picked - ps).abs() > TOL)
    if bool(bad.any()) or (strict and not torch.equal(p, pp)):
        raise AssertionError(f"{what}: position mismatch")
    return err


def rescore_work(dtype, Q, ids, lens, D, k):
    """(bytes, operations) one rescore needs: the valid rows of the
    distinct probed cells read once (with int8 scales), plus the query,
    the probe table, the probed cells' lengths and the output; and the
    multiply-adds of the dots the probes ask for."""
    item = {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
    ids = ids.long()
    cells = ids[ids >= 0].unique()
    rows = int(lens.long()[cells].sum())
    nbytes = (rows * D * item + (rows * 4 if dtype == "int8" else 0)
              + Q * D * (2 if dtype == "bf16" else 4)
              + int(ids.ge(0).sum()) * 4 + len(cells) * 4 + Q * k * 8)
    scored = int((lens.long()[ids.clamp(min=0)] * ids.ge(0)).sum())
    return nbytes, 2.0 * scored * D


def work_bound(dtype, nbytes, ops):
    """The least time (ms) the card could take for ``nbytes`` and ``ops``
    of ``dtype`` work, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def run_rescore(A, q, cells, scale, ids, lens, L, k):
    return A.cell_rescore_cuda(q, cells, ids, lens, scale, k=k, L=L)


def run_rescore_plain(torch, A, q, cells, scale, ids, lens, L, k):
    qc = q.to(torch.bfloat16) if cells.dtype == torch.bfloat16 else q
    return A.cell_rescore_plain(qc, cells, ids, lens, scale, k=k, L=L,
                                fuse_norm=True)


def tie_cells(torch, gm, dtype, gen, D=128):
    """Cells 9 and 4 both hold the same 5 rows, and cell 4 holds its row 0
    again at row 6: a query equal to one of them ties exactly across two
    probed cells and inside one."""
    cells, scale, lens, L = shard_cells(torch, gm, "fp32", 12, D, gen,
                                        mean_len=10)
    lens[4], lens[9] = 8, 7
    cells[4 * L:4 * L + 8] = torch.nan_to_num(cells[4 * L:4 * L + 8])
    cells[9 * L:9 * L + 7] = torch.nan_to_num(cells[9 * L:9 * L + 7])
    cells[9 * L:9 * L + 5] = cells[4 * L:4 * L + 5]
    cells[4 * L + 6] = cells[4 * L]
    q = torch.stack([cells[4 * L], cells[4 * L + 2], cells[4 * L + 6]]) * 2
    ids = torch.tensor([[9, 4, 0], [4, 9, 1], [0, 9, 4]], dtype=torch.int32,
                       device=DEV)
    if dtype == "int8":
        cells, scale = gm.quantize_gallery(torch.nan_to_num(cells))
    elif dtype == "bf16":
        cells = cells.to(torch.bfloat16)
    return q, cells, scale, ids, lens, L


def kernels_per_call(torch, fn, calls):
    """{kernel name: launches a call} of ``fn(*args)`` over ``calls``, from
    whole marked traces of one round (``device_calls``)."""
    for args in calls:
        fn(*args)

    def run():
        for args in calls:
            fn(*args)
    out = {}
    for key, (_, n) in device_calls(torch, run, len(calls),
                                    "kernels a call").items():
        name = re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "", key)
        out[name] = out.get(name, 0) + n
    return out


def rescore_edges(torch, gm, A, dtype, gen, D=128):
    """The fused path's edges, as (args, keywords) for ``compare_rescore``:
    cells whose valid rows are exact multiples of half a warp's rows (R)
    or of R, padded to L = R, 2 R and 8 R, so ``plan`` gives blocks of 1,
    2 and 4 warps; each probed 16 times a query by Q = 2 (one pass a
    block) and Q = 256 (one-warp blocks making 1, 2 and 8 passes), at
    k = 1 and 5; then 40 probes a query, so the winning slots lie past a
    warp's 32 lanes, at k = 5 and k = MAX_K."""
    R = A.plan(1, 1, 1, D, {"fp32": 4, "bf16": 2, "int8": 1}[dtype], True,
               132, 1)[2]
    K = 64
    out = []
    for L, step in ((R, R // 2), (2 * R, R), (8 * R, R)):
        lens = (torch.arange(K, device=DEV) % (L // step + 1) * step).int()
        cells, scale, lens, L = shard_cells(torch, gm, dtype, K, D, gen,
                                            lens=lens)
        for Q in (2, 256):
            ids = probe_table(torch, Q, 16, K, gen)
            q = torch.randn((Q, D), generator=gen, device=DEV)
            for k in (1, 5):
                out.append(((q, cells, scale, ids, lens, L, k), {}))
    wc, ws, wl, wL = shard_cells(torch, gm, dtype, 48, D, gen, mean_len=8)
    ids = probe_table(torch, 3, 40, 48, gen)
    q = torch.randn((3, D), generator=gen, device=DEV)
    out.append(((q, wc, ws, ids, wl, wL, 5), {}))
    out.append(((q, wc, ws, ids, wl, wL, A.MAX_K), {}))
    return out


def rescore_rounds(torch, gm, A, dtype, cells, scale, lens, L, gen):
    """The rescore above MAX_K and at rows wider than MAX_D, on the
    serving shard's cells (c = NPROBE) and on the same cells at D = 768:
    held against the plain version, a planted fault rejected at k = 100,
    each call's rounds (launches) and device time (CUDA events around a
    second call) beside the bound.  Returns the readings."""
    rows = []
    wide = shard_cells(torch, gm, dtype, CELLS, 768, gen)
    for (xc, xs, xl, xL), D, ks in (((cells, scale, lens, L), 128,
                                     (65, 100)), (wide, 768, (1, 100))):
        for Q in (1, 16):
            q = torch.randn((Q, D), generator=gen, device=DEV) * 3.0
            ids = probe_table(torch, Q, NPROBE, CELLS, gen)
            for k in ks:
                A.launches = 0
                err = compare_rescore(torch, A, q, xc, xs, ids, xl, xL, k)
                launches, plan = A.launches, A.last_plan
                if launches != A.rounds(k):
                    raise AssertionError(f"rescore {dtype} D={D} k={k}: "
                                         f"{launches} launches")
                _, ms = event_ms(torch, lambda: run_rescore(
                    A, q, xc, xs, ids, xl, xL, k))
                if k == 100 and D == 128 and Q == 16:
                    for fault in (fault_top_score, fault_swap,
                                  fault_round_edge):
                        try:
                            compare_rescore(torch, A, q, xc, xs, ids, xl, xL,
                                            k, fault=fault)
                        except AssertionError:
                            continue
                        raise AssertionError(
                            f"rescore {dtype} k={k}: the check passed the "
                            f"planted fault {fault.__name__}")
                bms, by = work_bound(dtype, *rescore_work(dtype, Q, ids, xl,
                                                          D, k))
                rows.append({"Q": Q, "c": NPROBE, "D": D, "k": k,
                             "path": plan[0], "rounds": launches,
                             "max_abs_err": err, "ms": ms, "bound_ms": bms,
                             "bound_by": by})
                print(f"[rescore-rounds] {dtype} Q={Q:2d} c={NPROBE} D={D} "
                      f"k={k}: == plain (max abs err {err:.3g}), {plan[0]} "
                      f"path, {launches} rounds, ms={ms:.4f} (CUDA events) "
                      f"bound_ms={bms:.6f} ({by})")
    print(f"[rescore-rounds] {dtype}: the check rejects the planted faults "
          f"at k=100 (top score x{PLANT}, first two positions swapped, "
          f"entry {A.MAX_K} repeating entry {A.MAX_K - 1})")
    return rows


def phase_rescore(torch, gm, A):
    gen = torch.Generator(device=DEV).manual_seed(4321)
    D = 128
    errs, timings, rounds = {}, {}, {}
    for dtype in DTYPES:
        err, n, paths = 0.0, 0, {}

        def check(*args, **kw):
            nonlocal err, n
            err = max(err, compare_rescore(torch, A, *args, **kw))
            n += 1
            paths[A.last_plan[0]] = paths.get(A.last_plan[0], 0) + 1

        cells, scale, lens, L = shard_cells(torch, gm, dtype, CELLS, D, gen)
        for Q in (1, 16, 256):
            for c in (1, NPROBE, 16):
                ids = probe_table(torch, Q, c, CELLS, gen)
                ids[::3, 0] = 0             # cell 0 is empty: probe it too
                q = torch.randn((Q, D), generator=gen, device=DEV) * 3.0
                for k in (1, 5):
                    check(q, cells, scale, ids, lens, L, k)
        # -1 probes (c > K), k past the probed rows, D = 36 and 260 (the
        # element-wise load path), a misaligned array
        for K, Dx, c, k, mean, mis in ((5, D, 8, 5, 40, False),
                                       (16, D, 2, 40, 2, False),
                                       (40, 36, 4, 5, 30, False),
                                       (40, 260, 4, 5, 30, False),
                                       (40, D, 4, 5, 30, True)):
            xc, xs, xl, xL = shard_cells(torch, gm, dtype, K, Dx, gen,
                                         mean_len=mean, misalign=mis)
            ids = probe_table(torch, 6, c, K, gen)
            ids[-1] = -1                    # a query with no valid probe
            q = torch.randn((6, Dx), generator=gen, device=DEV)
            check(q, xc, xs, ids, xl, xL, k)
        check(*tie_cells(torch, gm, dtype, gen), 6, strict=True)
        # a query whose every probe is -1, on the serving cells
        check(torch.randn((3, D), generator=gen, device=DEV), cells, scale,
              torch.full((3, NPROBE), -1, dtype=torch.int32, device=DEV),
              lens, L, 5)
        # k = MAX_K on the serving cells, at Q = 16 and 256 with c = 16
        for Q in (16, 256):
            check(torch.randn((Q, D), generator=gen, device=DEV), cells,
                  scale, probe_table(torch, Q, 16, CELLS, gen), lens, L,
                  A.MAX_K)
        for args, kw in rescore_edges(torch, gm, A, dtype, gen, D):
            check(*args, **kw)
        errs[dtype] = err
        print(f"[rescore] {dtype}: kernel == plain on {n} inputs ("
              + ", ".join(f"{v} {p} path" for p, v in sorted(paths.items()))
              + f"), max abs score error {err:.3g} (tolerance {TOL})")
        # two runs bit-identical at the serving shape, and the check must
        # reject a planted fault in the kernel's result at k = 5
        q = torch.randn((1, D), generator=gen, device=DEV)
        ids = probe_table(torch, 1, NPROBE, CELLS, gen)
        for k in (1, 5):
            a = run_rescore(A, q, cells, scale, ids, lens, L, k)
            b = run_rescore(A, q, cells, scale, ids, lens, L, k)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"rescore {dtype} k={k}: two runs at "
                                     "the serving shape differ")
        caught = 0
        for Q in (1, 16):
            qf = torch.randn((Q, D), generator=gen, device=DEV)
            idf = probe_table(torch, Q, NPROBE, CELLS, gen)
            for fault in (fault_top_score, fault_swap):
                try:
                    compare_rescore(torch, A, qf, cells, scale, idf, lens, L,
                                    5, fault=fault)
                except AssertionError:
                    caught += 1
                    continue
                raise AssertionError(f"rescore {dtype} Q={Q}: the check "
                                     f"passed the planted fault "
                                     f"{fault.__name__}")
        print(f"[rescore] {dtype}: two runs bit-identical at Q=1 c={NPROBE} "
              f"k=1 and k=5 ({A.last_plan[0]} path); the check rejects both "
              f"planted faults at k=5 ({caught} of {caught}: top score "
              f"x{PLANT}, first two positions swapped)")
        # the serving shape; four shards' cells and 16 probe tables each,
        # so one round reads more distinct rows than the L2 cache holds
        shards = [(cells, scale, lens, L)] + [
            shard_cells(torch, gm, dtype, CELLS, D, gen) for _ in range(3)]
        calls = [(q, sc[0], sc[1], probe_table(torch, 1, NPROBE, CELLS, gen),
                  sc[2], sc[3], 1) for sc in shards for _ in range(16)]
        kms, kcall = timed(torch, lambda *a: run_rescore(A, *a), calls)
        plan = A.last_plan
        per_call = kernels_per_call(torch, lambda *a: run_rescore(A, *a),
                                    calls)
        n_kern = sum(per_call.values())
        if plan[0] != "fused" or n_kern != 1:
            raise AssertionError(f"rescore {dtype}: the serving shape took "
                                 f"the {plan[0]} path with {per_call} "
                                 "kernels a call, not one fused launch")
        pms, pcall = timed(torch, lambda *a: run_rescore_plain(
            torch, A, *a), calls)
        fms, _ = timed(torch, lambda: A.empty_launch(q.device, plan[4],
                                                     plan[1]), [()] * 16)
        work = [rescore_work(dtype, 1, a[3], a[4], D, 1) for a in calls]
        bms, by = work_bound(dtype, sum(w[0] for w in work) / len(work),
                             sum(w[1] for w in work) / len(work))
        timings[dtype] = (kms, pms, bms, by, kcall, fms, plan)
        print(f"[rescore] {dtype} Q=1 c={NPROBE} k=1 L={L} D={D}: "
              f"kernel_ms={kms:.4f} (per call {kcall:.4f}, {plan[0]} path, "
              f"{plan[1]} warps a block, {plan[2]} rows a warp, {plan[3]} "
              f"pass, {plan[4]} blocks; kernels a call {per_call}) "
              f"plain_ms={pms:.4f} (per "
              f"call {pcall:.4f}) library_ms=n/a empty_kernel_ms={fms:.4f} "
              f"(same grid) bound_ms={bms:.6f} ({by})")
        del shards, calls
        rounds[dtype] = rescore_rounds(torch, gm, A, dtype, cells, scale,
                                       lens, L, gen)
    return errs, timings, rounds


class Recorder:
    """Wraps ``WatchlistCartridge.process_batch`` to keep what each frame
    matched: (seq, label, score, query embedding)."""

    def __init__(self, cls):
        self.cls, self.orig = cls, cls.process_batch
        self.rows, self.gallery, self.cart = [], None, None

    def __enter__(self):
        rec = self

        def process_batch(cart, ms):
            rec.gallery, rec.cart = cart.gallery, cart
            out = rec.orig(cart, ms)
            for m_in, m_out in zip(ms, out):
                if m_in.payload is not None:
                    rec.rows.append((m_in.seq, m_out.payload["label"],
                                     m_out.payload["score"],
                                     m_in.payload.detach().clone()))
            return out

        self.cls.process_batch = process_batch
        return self

    def __exit__(self, *exc):
        self.cls.process_batch = self.orig


def plain_labels(torch, gm, gallery, emb, dtype):
    """Top-1 labels of ``emb`` by the plain version over the gallery's
    prepared shard views on the card, merged as ``match`` merges."""
    labels, scores = plain_topk(torch, gm, gallery, emb, dtype, 1)
    return list(labels[:, 0]), torch.from_numpy(scores[:, 0])


def plain_topk(torch, gm, gallery, emb, dtype, k):
    """Top-``k`` (labels (Q, k), scores (Q, k)) of raw embeddings ``emb``
    by the plain version over the gallery's prepared shard views on the
    card, merged as ``match`` merges (score descending, then global id)."""
    import numpy as np
    q = gallery.rotation.protect(emb)
    scores, gids = [], []
    for s in range(gallery.n_shards):
        ids = gallery._shard_ids[s]
        if not len(ids):
            continue
        prep = gallery._prepare(s, dtype)
        if dtype == "int8":
            g, scale = prep["q8"], prep["scale"]
        else:
            g, scale = prep["gn_bf16" if dtype == "bf16" else "gn"], None
        ps, pi = run_plain(torch, gm, q, g, scale, min(k, len(ids)))
        scores.append(ps.cpu().numpy())
        gids.append(ids[pi.cpu().numpy()])
    all_s, all_g = np.concatenate(scores, 1), np.concatenate(gids, 1)
    top = np.lexsort((all_g, -all_s), axis=1)[:, :k]
    labels = np.asarray(gallery._labels, object)[
        np.take_along_axis(all_g, top, axis=1)]
    return labels, np.take_along_axis(all_s, top, axis=1)


def ranked_match(torch, gm, gallery, emb, dtype):
    """One ``match`` at k = RANKED_K (above MAX_K: rounds on every shard)
    of one frame's embedding over the served watchlist, its launches
    counted alone; its labels held against the plain version's.  Returns
    the launches."""
    import numpy as np
    gm.launches = 0
    labels, scores = gallery.match(emb, k=RANKED_K, dtype=dtype)
    launches = gm.launches
    want = sum(1 for ids in gallery._shard_ids if len(ids)) \
        * gm.rounds(RANKED_K)
    plain, plain_s = plain_topk(torch, gm, gallery, emb, dtype, RANKED_K)
    serr = float(np.abs(scores.numpy() - plain_s).max())
    if labels.shape != (1, RANKED_K) or not np.array_equal(labels, plain) \
            or not serr <= TOL or launches != want:
        raise AssertionError(f"{dtype}: the k={RANKED_K} match's labels "
                             f"differ from the plain version's (score error "
                             f"{serr}) or it launched {launches} of {want}")
    print(f"[main] {dtype}: one match at k={RANKED_K} over {len(gallery)} "
          f"templates: labels == plain {RANKED_K}/{RANKED_K} (max abs "
          f"score error {serr:.3g}), {launches} launches ({gm.rounds(RANKED_K)}"
          f" rounds x {gallery.n_shards} shards), first {labels[0, 0]}")
    return launches


def wide_probe_match(torch, gm, A, gallery, emb, dtype):
    """The ANN match at nprobe = WIDE_NPROBE (above MAX_K: the coarse scan
    runs rounds) of ``emb``, its launches counted alone, its labels held
    against the plain versions on the kernels' own probe table.  Returns
    (coarse, rescore) launches."""
    with ProbeRecorder(gallery) as probes:
        gm.launches = A.launches = 0
        labels, scores = gallery.match(emb, k=1, dtype=dtype, mode="ann",
                                       nprobe=WIDE_NPROBE)
        launches = (gm.launches, A.launches)
    q, ids = probes.ids[0]
    plain, plain_s = plain_ann(torch, gm, A, gallery, q, ids, dtype)
    got = list(labels[:, 0])
    serr = float((scores[:, 0] - plain_s).abs().max())
    want = (gm.rounds(WIDE_NPROBE), SHARDS)
    if tuple(ids.shape) != (emb.shape[0], WIDE_NPROBE) or got != plain \
            or not serr <= TOL or launches != want:
        raise AssertionError(f"ann {dtype} nprobe={WIDE_NPROBE}: labels "
                             f"{got} vs plain {plain} (score error {serr}), "
                             f"launches {launches} of {want}")
    print(f"[ann] {dtype}: nprobe={WIDE_NPROBE} over {len(gallery)} "
          f"templates, {emb.shape[0]} queries: labels == plain "
          f"{len(got)}/{len(got)} on the kernels' own probe table (max abs "
          f"score error {serr:.3g}), launches gallery_match={launches[0]} "
          f"({want[0]} rounds) cell_rescore={launches[1]}, scan_fraction="
          f"{gallery.last_match_stats['scan_fraction']:.6f}")
    return launches


class QHistogram:
    """Wraps the gallery-match wrapper's CUDA path to count its calls by
    query count Q and by the path they took."""

    def __init__(self, gm):
        self.gm, self.by_q, self.paths = gm, {}, {}

    def __enter__(self):
        orig = self.orig = self.gm._match_cuda

        def match_cuda(q, *a, **kw):
            out = orig(q, *a, **kw)
            Q, path = q.shape[0], self.gm.last_plan[0]
            self.by_q[Q] = self.by_q.get(Q, 0) + 1
            self.paths[path] = self.paths.get(path, 0) + 1
            return out

        self.gm._match_cuda = match_cuda
        return self

    def __exit__(self, *exc):
        self.gm._match_cuda = self.orig


def phase_main(torch, gm, serve):
    with QHistogram(gm) as hist:
        launches, ranked = run_main(torch, gm, serve)
    print(f"[main] gallery-match calls by Q: "
          + ", ".join(f"Q={q}: {n}" for q, n in sorted(hist.by_q.items()))
          + f"; by path: {hist.paths} (small-Q path for Q <= {gm.SMALL_Q})")
    return launches, ranked


def run_main(torch, gm, serve):
    launches, ranked = {}, {}
    for dtype in DTYPES:
        t0 = time.perf_counter()
        with Recorder(serve.WatchlistCartridge) as rec:
            gm.launches = 0
            rep = serve.run_biometric(
                n_frames=30, hotswap=True, device=DEV, n_shards=SHARDS,
                match_dtype=dtype, distractors=DISTRACTORS)
            launches[dtype] = gm.launches
        wall = time.perf_counter() - t0
        rows = sorted(rec.rows, key=lambda r: r[0])
        if rep.frames_out != 30 or rep.lost != 0:
            raise AssertionError(f"{dtype}: frames_out={rep.frames_out} "
                                 f"lost={rep.lost}")
        if launches[dtype] <= 0:
            raise AssertionError(f"{dtype}: the kernel never launched")
        if [r[0] for r in rows] != list(range(30)):
            raise AssertionError(f"{dtype}: matched seqs {[r[0] for r in rows]}")
        want = [f"subject{seq % 10}" for seq, *_ in rows]
        got = [r[1] for r in rows]
        wrong = sum(a != b for a, b in zip(got, want))
        plain, plain_s = plain_labels(torch, gm, rec.gallery,
                                      torch.stack([r[3] for r in rows]),
                                      dtype)
        serr = float((torch.tensor([r[2] for r in rows]) - plain_s)
                     .abs().max())
        if got != plain or not serr <= TOL:
            raise AssertionError(f"{dtype}: kernel labels {got} differ from "
                                 f"the plain version's {plain} (score "
                                 f"error {serr})")
        if dtype != "int8" and wrong:
            raise AssertionError(f"{dtype}: {wrong} frames matched the wrong "
                                 f"subject: {got}")
        print(f"[main] {dtype}: {len(rec.gallery)} templates in "
              f"{rec.gallery.n_shards} shards, frames_out={rep.frames_out} "
              f"lost={rep.lost} launches={launches[dtype]} "
              f"labels==subject {30 - wrong}/30, labels==plain 30/30, "
              f"wall_s={wall:.1f}")
        ranked[dtype] = ranked_match(torch, gm, rec.gallery,
                                     rows[0][3].reshape(1, -1), dtype)
    gm.launches = 0
    t0 = time.perf_counter()
    rep = serve.run_fleet(duration_s=3.0, device=DEV)
    fleet_launches = gm.launches
    launches["fp32"] += fleet_launches
    if rep.lost != 0 or fleet_launches <= 0:
        raise AssertionError(f"fleet: lost={rep.lost} "
                             f"launches={fleet_launches}")
    for name, row in rep.frontdoor["tenants"].items():
        if row["offered"] != row["admitted"] + row["shed"] + row["queued"]:
            raise AssertionError(f"fleet: conservation broken for {name}: "
                                 f"{row}")
    print(f"[main] fleet: frames_out={rep.frames_out}/{rep.frames_in} "
          f"lost={rep.lost} launches={fleet_launches} conservation holds "
          f"for {len(rep.frontdoor['tenants'])} tenants, "
          f"wall_s={time.perf_counter() - t0:.1f}")
    return launches, ranked


class ProbeRecorder:
    """Keeps the probe table of each ``_coarse_scan`` of one gallery, in
    call order (one call per ``match``)."""

    def __init__(self, gallery):
        self.gallery, self.ids = gallery, []

    def __enter__(self):
        orig = self.gallery._coarse_scan

        def coarse_scan(q, nprobe, dtype):
            out = orig(q, nprobe, dtype)
            self.ids.append((q.clone(), out[1].clone()))
            return out

        self.gallery._coarse_scan = coarse_scan
        return self

    def __exit__(self, *exc):
        del self.gallery._coarse_scan


def plain_ann(torch, gm, A, gallery, q, ids, dtype):
    """Top-1 (labels, scores) of protected queries ``q`` by the rescore's
    plain version over the gallery's packed shard views on the card, on the
    probe table ``ids``, merged as ``match`` merges; and the coarse scan's
    plain probe table check (each kernel pick equal to the plain version's,
    or scored by it within TOL of its own pick)."""
    cb = gallery._ann_dev[dtype]
    cents, cscale = cb[0], (cb[1] if dtype == "int8" else None)
    ps, pi = run_plain(torch, gm, q, cents, cscale, ids.shape[1])
    qc = q.to(torch.bfloat16) if dtype == "bf16" else q
    qf = qc.float()
    qf = qf * torch.rsqrt(torch.clamp((qf * qf).sum(-1, keepdim=True),
                                      min=1e-18))
    picked = (qf[:, None, :] * cents[ids.long()].float()).sum(-1)
    if cscale is not None:
        picked = picked * cscale[ids.long()]
    if bool(((ids != pi) & ((picked - ps).abs() > TOL)).any()):
        raise AssertionError(f"{dtype}: the coarse scan's probe table "
                             "differs from the plain version's")
    best = None
    for s in range(gallery.n_shards):
        if not len(gallery._shard_ids[s]):
            continue
        ann = gallery._prepare_ann(s, dtype)
        layout = ann["layout"]
        if dtype == "int8":
            cells, scale = ann["q8"], ann["scale"]
        else:
            cells = ann["packed_bf16" if dtype == "bf16" else "packed"]
            scale = None
        rs, rp = A.cell_rescore_plain(qc, cells, ids, ann["lens"], scale,
                                      k=1, L=layout.L, fuse_norm=True)
        rows = torch.as_tensor(layout.pos_to_row, device=DEV)[
            rp[:, 0].long().clamp(min=0)]
        gid = torch.as_tensor(gallery._shard_ids[s], device=DEV)[rows]
        gid = torch.where(rp[:, 0] >= 0, gid, torch.full_like(gid, 2**62))
        cand = (rs[:, 0], gid)
        if best is None:
            best = cand
        else:
            take = (cand[0] > best[0]) | ((cand[0] == best[0])
                                          & (cand[1] < best[1]))
            best = (torch.where(take, cand[0], best[0]),
                    torch.where(take, cand[1], best[1]))
    labels = [gallery._labels[int(g)] if int(g) < 2**62 else None
              for g in best[1].cpu()]
    return labels, best[0].cpu()


def phase_ann(torch, gm, A, serve):
    """The ANN main path: one 1,048,586-template watchlist in 4 shards,
    enrolled and indexed by the first run, served once per match dtype."""
    from repro_torch.crypto import SecureGallery
    gallery = SecureGallery(serve.EMB_DIM, seed=7, n_shards=SHARDS,
                            device=DEV)
    build_s = []
    train = gallery.build_ann_index

    def build_ann_index(**kw):
        t0 = time.perf_counter()
        train(**kw)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)

    gallery.build_ann_index = build_ann_index
    launches, fractions, wide = {}, {}, {}
    for dtype in DTYPES:
        gallery.match_dtype = dtype
        t0 = time.perf_counter()
        with Recorder(serve.WatchlistCartridge) as rec, \
                ProbeRecorder(gallery) as probes:
            gm.launches = A.launches = 0
            rep = serve.run_biometric(
                n_frames=30, hotswap=True, device=DEV, n_shards=SHARDS,
                distractors=DISTRACTORS, match_mode="ann", nprobe=NPROBE,
                gallery=gallery)
            launches[dtype] = (gm.launches, A.launches)
        wall = time.perf_counter() - t0
        if dtype == DTYPES[0]:
            print(f"[ann] index: {gallery._ann_n_cells} cells over "
                  f"{len(gallery)} templates, trained in {build_s[0]:.1f} s")
        calls = rec.cart.stats["match_calls"]
        n_gm, n_cr = launches[dtype]
        if rep.frames_out != 30 or rep.lost != 0:
            raise AssertionError(f"ann {dtype}: frames_out={rep.frames_out} "
                                 f"lost={rep.lost}")
        if len(build_s) != 1 or calls != len(probes.ids) or \
                n_gm != calls or n_cr != SHARDS * calls or calls == 0:
            raise AssertionError(
                f"ann {dtype}: {calls} match calls, {len(probes.ids)} coarse "
                f"scans, launches coarse={n_gm} rescore={n_cr}, "
                f"{len(build_s)} index builds")
        # the served labels vs the plain versions on the kernels' own probe
        # tables (rows recorded in the order the calls matched them)
        q = torch.cat([p[0] for p in probes.ids])
        ids = torch.cat([p[1] for p in probes.ids])
        plain, plain_s = plain_ann(torch, gm, A, gallery, q, ids, dtype)
        got = [r[1] for r in rec.rows]
        serr = float((torch.tensor([r[2] for r in rec.rows]) - plain_s)
                     .abs().max())
        if got != plain or not serr <= TOL:
            raise AssertionError(f"ann {dtype}: kernel labels {got} differ "
                                 f"from the plain version's {plain} (score "
                                 f"error {serr})")
        right = sum(lab == f"subject{seq % 10}" for seq, lab, *_ in rec.rows)
        fractions[dtype] = gallery.last_match_stats["scan_fraction"]
        print(f"[ann] {dtype}: {len(gallery)} templates in {SHARDS} shards, "
              f"nprobe={NPROBE}, frames_out={rep.frames_out} lost={rep.lost}"
              f" match_calls={calls} launches gallery_match={n_gm} "
              f"cell_rescore={n_cr}, labels==subject {right}/30, "
              f"labels==plain 30/30, scan_fraction="
              f"{fractions[dtype]:.6f}, wall_s={wall:.1f}")
        wide[dtype] = wide_probe_match(
            torch, gm, A, gallery,
            torch.stack([r[3] for r in rec.rows]).reshape(len(rec.rows), -1),
            dtype)
    return launches, fractions, wide


def phase_reference(torch, serve):
    """The serving stages on the card vs on the CPU (which the tests hold
    against the JAX reference), on 10 frames, with TF32 off."""
    from repro_torch.data import FrameStream
    src = FrameStream(seed=3)
    embs = []
    for dev in ("cuda", "cpu"):
        reg, _ = serve.build_biometric_pipeline(device=dev)
        embs.append(serve._pipeline_embed(reg, src, range(10)).cpu())
    err = float((embs[0] - embs[1]).abs().max())
    if not (torch.isfinite(embs[0]).all() and err <= TOL
            and tuple(embs[0].shape) == (10, serve.EMB_DIM)):
        raise AssertionError(f"embeddings on the card differ from the "
                             f"CPU's by {err}")
    print(f"[check] 10 embeddings on the card vs the CPU: max abs error "
          f"{err:.3g} (tolerance {TOL})")


# (B, H, Kh, Sq, Sk, D, Dv, causal, window): the CPU tests' flash shapes
FLASH_SHAPES = [(1, 2, 2, 128, 128, 64, 64, True, 0),
                (2, 4, 2, 256, 256, 64, 64, True, 0),
                (1, 8, 1, 512, 512, 128, 128, True, 0),
                (2, 2, 2, 256, 256, 64, 64, False, 0),
                (1, 4, 4, 512, 512, 64, 64, True, 128),
                (1, 2, 2, 384, 384, 32, 32, True, 0),
                (1, 2, 2, 256, 256, 192, 128, True, 0),
                (1, 4, 2, 512, 512, 80, 80, True, 0),
                (2, 4, 2, 100, 300, 64, 64, True, 0)]
# the kernel's edges: gemma3's local layer (D = 240, window 1024) at a small
# B*H, MLA's 192 / 128 head dims at S = 1024, and Sq = Sk = 1000 (no
# multiple of any tile), the last as the model's strided views
FLASH_EDGES = [((1, 2, 2, 2048, 2048, 240, 240, True, 1024), False),
               ((1, 4, 2, 1024, 1024, 192, 128, True, 0), False),
               ((2, 4, 2, 1000, 1000, 64, 64, True, 0), True)]
# every (D, Dv) pair the kernel is instantiated for, at a small GQA shape
# whose S is no multiple of any tile
def flash_head_dim_shapes(FA):
    return [((1, 4, 2, 136, 136, D, Dv, True, 0), False)
            for D, Dv in FA.supported_head_dims()]


# the serving shapes: zamba2's shared block (MHA), tinyllama (GQA),
# DeepSeek's MLA (192 / 128, 128 heads), gemma3's local (window 1024)
# and global layers (D = 240, 16 heads over 8), whisper's encoder
# (non-causal, S = 1500: a ragged last key tile) and cross attention
# (non-causal, 416 queries over 1500 keys), codeqwen (MHA, D = 128),
# starcoder2 (48 heads over 4) and internvl2 (48 over 8)
FLASH_SERVE = {"mha": (8, 32, 32, 2048, 2048, 80, 80, True, 0),
               "gqa": (8, 32, 4, 2048, 2048, 64, 64, True, 0),
               "mla": (8, 128, 128, 2048, 2048, 192, 128, True, 0),
               "local": (8, 16, 8, 2048, 2048, 240, 240, True, 1024),
               "global": (8, 16, 8, 2048, 2048, 240, 240, True, 0),
               "enc": (8, 8, 8, 1500, 1500, 64, 64, False, 0),
               "cross": (8, 8, 8, 416, 1500, 64, 64, False, 0),
               "mha128": (8, 32, 32, 2048, 2048, 128, 128, True, 0),
               "gqa12": (8, 48, 4, 2048, 2048, 128, 128, True, 0),
               "vlm": (8, 48, 8, 2048, 2048, 128, 128, True, 0)}
# (Bt, L, H, P, N, chunk): the CPU tests' SSD shapes, then zamba2's
SSD_SHAPES = [(1, 128, 1, 16, 8, 64), (2, 256, 3, 32, 16, 128),
              (1, 512, 2, 64, 32, 256), (2, 64, 4, 8, 8, 64),
              (2, 1024, 2, 16, 8, 256)]
# the kernel's edges, (shape, as the model's strided views): one chunk; a
# chunk of 100 (no multiple of 16); P = 8 with N = 4; the smoke config
# (P = N = 16, L = 32); one sequence of one head
SSD_EDGES = [((2, 256, 4, 64, 64, 256), False),
             ((2, 100, 3, 16, 16, 256), False),
             ((2, 64, 3, 8, 4, 64), False),
             ((2, 32, 8, 16, 16, 256), True),
             ((1, 512, 1, 64, 64, 256), False)]
SSD_SERVE = (8, 2048, 80, 64, 64, 256)
# the staged path's intermediates, in the order its kernels write them
SSD_STAGES = ("chunk_state", "chunk_total", "passed_state")
TORCH_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}


def flash_inputs(torch, shape, dtype, gen, model_layout=False):
    """q, k, v for one shape; ``model_layout`` makes them the transposed
    views of (B, S, H, D) tensors that the model passes."""
    B, H, Kh, Sq, Sk, D, Dv = shape[:7]
    dt = getattr(torch, TORCH_DTYPE[dtype])

    def rn(b, h, s, d, scale):
        if model_layout:
            x = torch.randn((b, s, h, d), generator=gen, device=DEV)
            return (x * scale).to(dt).transpose(1, 2)
        x = torch.randn((b, h, s, d), generator=gen, device=DEV)
        return (x * scale).to(dt)

    return rn(B, H, Sq, D, 0.3), rn(B, Kh, Sk, D, 0.3), rn(B, Kh, Sk, Dv, 1.0)


def kept_pairs(Sq, Sk, causal, window):
    """(query, key) pairs a head's masks keep: every pair, or with the
    causal mask (Sq = Sk = S) S (S + 1) / 2, or with a window W < S too
    W (W + 1) / 2 + (S - W) W."""
    if not causal:
        assert window == 0
        return Sq * Sk
    assert Sq == Sk
    W = window if 0 < window < Sq else Sq
    return W * (W + 1) // 2 + (Sq - W) * W


def flash_work(shape, dtype):
    """(bytes, operations) one attention call needs: q, k, v read once and
    o written once; 2 (D + Dv) flops for each (query, key) pair the masks
    keep (``kept_pairs``)."""
    B, H, Kh, Sq, Sk, D, Dv, causal, window = shape
    item = 4 if dtype == "fp32" else 2
    nbytes = item * (B * H * Sq * (D + Dv) + B * Kh * Sk * (D + Dv))
    return nbytes, 2.0 * B * H * kept_pairs(Sq, Sk, causal, window) * (D + Dv)


def flash_err(torch, o, p, dtype):
    """The flash kernel's output ``o`` against the plain version's ``p``:
    in fp32 the max abs error; in bf16 the largest excess of |o - p| over
    one bf16 ulp of p (2^-7 |p|), in units of p's row (query) RMS."""
    d = (o.float() - p.float()).abs()
    if dtype == "fp32":
        return float(d.max())
    pf = p.float()
    rms = pf.square().mean(-1, keepdim=True).sqrt().clamp(min=1e-30)
    return float(((d - 2.0 ** -7 * pf.abs()) / rms).max())


def planted(o):
    """``o`` (B, H, S, D) with the later half of the positions PLANT times
    too large, in place."""
    o[:, :, o.shape[2] // 2:] *= PLANT
    return o


def phase_flash(torch, FA):
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(2024)
    errs, timings = {}, {}
    for dtype in LM_DTYPES:
        err, abs_err, caught, n, identical = 0.0, 0.0, [], 0, 0
        cases = [(sh, False) for sh in FLASH_SHAPES] + FLASH_EDGES + \
            flash_head_dim_shapes(FA) + \
            [(sh, True) for sh in FLASH_SERVE.values()]
        for shape, model_layout in cases:
            causal, window = shape[7], shape[8]
            q, k, v = flash_inputs(torch, shape, dtype, gen, model_layout)
            o = FA.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
            torch.cuda.synchronize()
            if model_layout and shape in FLASH_SERVE.values():
                # a race in the kernel's pipeline shows as a difference
                o2 = FA.flash_attention_cuda(q, k, v, causal=causal,
                                             window=window)
                torch.cuda.synchronize()
                if not torch.equal(o, o2):
                    raise AssertionError(f"flash {dtype} {shape}: two runs "
                                         "on the same inputs differ")
                identical += 1
                del o2
            p = FA.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            if o.dtype != q.dtype or o.shape != p.shape or \
                    not bool(torch.isfinite(o).all()):
                raise AssertionError(f"flash {dtype} {shape}: {o.dtype} "
                                     f"{tuple(o.shape)} or not finite")
            e = flash_err(torch, o, p, dtype)
            if not e <= FLASH_TOL[dtype]:
                raise AssertionError(f"flash {dtype} {shape}: error {e} "
                                     f"(tolerance {FLASH_TOL[dtype]})")
            # the check must catch a 5 % error on the later positions
            e_bad = flash_err(torch, planted(p.clone()), p, dtype)
            if not e_bad > FLASH_TOL[dtype]:
                raise AssertionError(f"flash {dtype} {shape}: a planted "
                                     f"fault reads {e_bad}, within the "
                                     "tolerance")
            err, n = max(err, e), n + 1
            abs_err = max(abs_err, float((o.float() - p.float()).abs().max()))
            caught.append(e_bad)
            del q, k, v, o, p
        errs[dtype] = abs_err
        what = "max abs error" if dtype == "fp32" else \
            "max excess over 2^-7 |p| per row RMS"
        print(f"[flash] {dtype}: kernel == plain on {n} shapes, {what} "
              f"{err:.3g} (tolerance {FLASH_TOL[dtype]}; max abs error "
              f"{abs_err:.3g}); a planted {PLANT - 1:.0%} error on the later "
              f"positions reads {min(caught):.3g} or more; the {identical} "
              "serving shapes bit-identical over two runs")
        for name, shape in FLASH_SERVE.items():
            args = [flash_inputs(torch, shape, dtype, gen, True)]
            gqa, causal, window = shape[1] != shape[2], shape[7], shape[8]
            # the library: causal, with the window's mask written out, or
            # with no mask
            lib_mask = dict(attn_mask=FA._masks(
                shape[3], shape[4], True, window, DEV)) if window else \
                dict(is_causal=causal)
            kms, kcall = timed(torch, lambda q, k, v: FA.flash_attention_cuda(
                q, k, v, causal=causal, window=window), args, iters=5)
            pms, _ = timed(torch, lambda q, k, v: FA.flash_attention_plain(
                q, k, v, causal=causal, window=window), args, iters=3)
            lms, _ = timed(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=gqa, **lib_mask), args, iters=5)
            bms, by = work_bound(dtype, *flash_work(shape, dtype))
            timings[(dtype, name)] = (kms, pms, lms, bms, by)
            print(f"[flash] {dtype} {name} {shape[:7]} "
                  f"{'causal' if causal else 'non-causal'} window {window}: "
                  f"kernel_ms={kms:.4f} "
                  f"(per call {kcall:.4f}) plain_ms={pms:.4f} "
                  f"library_ms={lms:.4f} bound_ms={bms:.4f} ({by}); the "
                  f"kernel at {bms / kms:.1%} of the bound, the library at "
                  f"{bms / lms:.1%}")
            del args
    return errs, timings


def ssd_inputs(torch, shape, dtype, gen, model_layout=False):
    """x, dt, A, B, C for one shape; ``model_layout`` cuts x, B and C out
    of one (Bt, L, H*P + 2N) buffer, as the model's conv output is cut."""
    Bt, L, H, P, N = shape[:5]
    dt_ = getattr(torch, TORCH_DTYPE[dtype])
    F = torch.nn.functional
    if model_layout:
        buf = torch.randn((Bt, L, H * P + 2 * N), generator=gen, device=DEV)
        buf[..., H * P:] *= 0.3
        buf = buf.to(dt_)
        x = buf[..., :H * P].reshape(Bt, L, H, P)
        Bm, Cm = buf[..., H * P:H * P + N], buf[..., H * P + N:]
    else:
        x = torch.randn((Bt, L, H, P), generator=gen, device=DEV).to(dt_)
        Bm = (torch.randn((Bt, L, N), generator=gen, device=DEV) * 0.3
              ).to(dt_)
        Cm = (torch.randn((Bt, L, N), generator=gen, device=DEV) * 0.3
              ).to(dt_)
    dt = F.softplus(torch.randn((Bt, L, H), generator=gen,
                                device=DEV)) * 0.1
    A = -F.softplus(torch.randn((H,), generator=gen, device=DEV))
    return x, dt, A, Bm, Cm


def ssd_work(shape, dtype):
    """(bytes, operations) one scan needs: x, dt, A, B, C read once, y and
    the state written once (fp32); for each (sequence, chunk) C B^T over
    the c (c + 1) / 2 pairs t >= s (it does not depend on the head), and
    for each head the masked product with x dt over the same pairs, the
    carried state's part of y and the state update (2 c P N flops each)."""
    Bt, L, H, P, N, c = shape
    item = 4 if dtype == "fp32" else 2
    nc = L // c
    nbytes = (item * (Bt * L * H * P + 2 * Bt * L * N) + 4 * Bt * L * H
              + 4 * H + 4 * Bt * L * H * P + 4 * Bt * H * P * N)
    pairs = c * (c + 1) // 2
    ops = 2.0 * Bt * nc * pairs * N + \
        Bt * H * nc * (2.0 * pairs * P + 4.0 * c * P * N)
    return nbytes, ops


def ssd_outputs(y, state, stages):
    """[(name, tensor)] of one SSD call's outputs, the staged path's
    intermediates first."""
    out = [] if stages is None else [(k, stages[k]) for k in SSD_STAGES]
    return out + [("y", y), ("state", state)]


def ssd_close(torch, got, want):
    """An SSD output against the plain version's: finite, the same shape,
    within the reference tests' allclose bounds."""
    return got.shape == want.shape and bool(torch.isfinite(got).all()) \
        and torch.allclose(got, want, atol=SSD_ATOL, rtol=SSD_RTOL)


def planted_ssd(t):
    """``t`` with its later half along dim 1 (positions, chunks or heads)
    PLANT times too large, in place."""
    t[:, t.shape[1] // 2:] *= PLANT
    return t


def kernel_split(torch, fn, n=3):
    """Device ms per call of ``fn()`` by kernel name, without its template
    arguments (whole marked traces of ``n`` calls, ``device_calls``)."""
    fn()

    def run():
        for _ in range(n):
            fn()
    out = {}
    for key, (us, _) in device_calls(torch, run, n, "kernel split").items():
        name = re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "", key)
        out[name] = out.get(name, 0.0) + us / 1e3
    return out


def phase_ssd(torch, SSD):
    gen = torch.Generator(device=DEV).manual_seed(77)
    errs, timings, caught, identical = {}, {}, [], 0
    cases = [(sh, False) for sh in SSD_SHAPES] + SSD_EDGES + \
        [(SSD_SERVE, True)]
    for dtype in LM_DTYPES:
        err, paths = 0.0, {}
        for shape, model_layout in cases:
            x, dt, A, Bm, Cm = ssd_inputs(torch, shape, dtype, gen,
                                          model_layout)
            got = ssd_outputs(*SSD.mamba2_ssd_cuda(x, dt, A, Bm, Cm,
                                                   chunk=shape[5],
                                                   stages=True))
            torch.cuda.synchronize()
            path = SSD.last_plan
            paths[path] = paths.get(path, 0) + 1
            want = dict(ssd_outputs(*SSD.mamba2_ssd_plain(
                x, dt, A, Bm, Cm, chunk=min(shape[5], shape[1]),
                stages=True)))
            if (path == "staged") != (len(got) > 2):
                raise AssertionError(f"ssd {dtype} {shape}: the {path} path "
                                     f"returned {len(got) - 2} stages")
            for name, g in got:
                if not ssd_close(torch, g, want[name]):
                    e = float((g - want[name]).abs().max()) \
                        if g.shape == want[name].shape else math.inf
                    raise AssertionError(
                        f"ssd {dtype} {shape} ({path} path): stage {name} "
                        f"differs from the plain version's (max abs error "
                        f"{e:.3g}; atol {SSD_ATOL}, rtol {SSD_RTOL})")
                err = max(err, float((g - want[name]).abs().max()))
            print(f"[ssd] {dtype} {shape}{' strided' if model_layout else ''}"
                  f": {path} path, "
                  + ", ".join(name for name, _ in got) + " == plain")
            if shape == SSD_SERVE:
                # a race shows as a difference between two runs
                again = ssd_outputs(*SSD.mamba2_ssd_cuda(
                    x, dt, A, Bm, Cm, chunk=shape[5], stages=True))
                torch.cuda.synchronize()
                for (name, a), (_, b) in zip(got, again):
                    if not torch.equal(a, b):
                        raise AssertionError(f"ssd {dtype} {shape}: two runs "
                                             f"on the same inputs differ in "
                                             f"{name}")
                identical += 1
                del again
                # every output's check must catch a 5 % fault
                for name, g in got:
                    if ssd_close(torch, planted_ssd(g.clone()), want[name]):
                        raise AssertionError(f"ssd {dtype} {shape}: a planted "
                                             f"fault in {name} passes the "
                                             "check")
                    caught.append(name)
            del x, dt, Bm, Cm, got, want
        errs[dtype] = err
        print(f"[ssd] {dtype}: kernel == plain on {len(cases)} shapes "
              f"({', '.join(f'{n} {k}' for k, n in paths.items())}), max abs "
              f"error {err:.3g} (atol {SSD_ATOL}, rtol {SSD_RTOL})")
    print(f"[ssd] the serving shape bit-identical over two runs in "
          f"{identical} dtypes; a planted {PLANT - 1:.0%} fault rejected in "
          f"{len(caught)} outputs ({', '.join(sorted(set(caught)))})")
    for dtype in LM_DTYPES:
        args = [ssd_inputs(torch, SSD_SERVE, dtype, gen, True)]
        kms, kcall = timed(torch, lambda *a: SSD.mamba2_ssd_cuda(*a), args,
                           iters=5)
        path = SSD.last_plan
        stages = kernel_split(torch, lambda: SSD.mamba2_ssd_cuda(*args[0]))
        pms, _ = timed(torch, lambda *a: SSD.mamba2_ssd_plain(
            *a, chunk=SSD_SERVE[5]), args, iters=3)
        work = ssd_work(SSD_SERVE, dtype)
        bms, by = work_bound("tf32", *work)
        fms, _ = work_bound("fp32", *work)
        timings[dtype] = (kms, pms, bms, by, fms, path, stages)
        print(f"[ssd] {dtype} {SSD_SERVE}: {path} path kernel_ms={kms:.4f} "
              f"(per call {kcall:.4f}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
              + f") plain_ms={pms:.4f} library_ms=n/a bound_ms={bms:.4f} "
              f"({by}; the products at the TF32 tensor-core peak), "
              f"{bms / kms:.1%} of it; fma_bound_ms={fms:.4f} (the products "
              f"at the fp32 FMA peak), {fms / kms:.1%} of it")
        del args
    return errs, timings


# phases 5 and 6, the backward kernels: each gradient against the plain
# backward's by its relative Frobenius error; each bound sits between the
# readings and a planted 5 % fault's (PERF.md §6)
FLASH_BWD_REL = {"fp32": 1e-4, "bf16": 1e-2}
SSD_BWD_REL = {"fp32": 1e-4, "bf16": 1e-3}
# the forward's lse against the plain logsumexp: max |error| / (1 + |lse|)
LSE_TOL = 1e-5
# the training shapes (one microbatch) the backwards are timed at:
# tinyllama's GQA (16 x 2048 in 2 microbatches), zamba2's shared MHA block
# and its Mamba-2 layers (4 x 2048 in 2)
FLASH_TRAIN = {"gqa": (8, 32, 4, 2048, 2048, 64, 64, True, 0),
               "mha": (2, 32, 32, 2048, 2048, 80, 80, True, 0)}
SSD_TRAIN = (2, 2048, 80, 64, 64, 256)
# SSD shapes on the backward's general path: P or N above 64, and a chunk
# beyond the tensor path's longest (the per-row arrays in global scratch)
SSD_BWD_GENERAL = (1, 256, 2, 128, 96, 128)
SSD_BWD_LONG = (1, 4096, 4, 64, 64, 4096)


def flash_bwd_shapes():
    """(shape, as the model's strided views) of phase 5's backward check:
    the serving shapes' masks and head dims at batch 1 or 2, the smoke
    MLA pair (24, 16), which the wrapper pads to (32, 32), and a window
    with Sq >= Sk + window, so that rows see no key."""
    out = [((2 if name in ("mha", "gqa", "enc", "cross") else 1, *sh[1:]),
            True) for name, sh in FLASH_SERVE.items()]
    return out + [((2, 4, 4, 48, 48, 24, 16, True, 0), False),
                  ((1, 4, 2, 600, 256, 64, 64, True, 100), False)]


def planted_grad(t):
    """A copy of ``t`` with the later half of its elements PLANT times too
    large."""
    f = t.detach().clone().reshape(-1)
    f[f.numel() // 2:] *= PLANT
    return f.reshape(t.shape)


def check_grads(torch, what, got, again, want, names, bound):
    """Each gradient of ``got`` against ``want``'s by its relative
    Frobenius error, within ``bound``; ``again`` (a second call) equal bit
    for bit; a planted fault rejected.  Returns (largest error, smallest
    planted reading, largest max abs error)."""
    err, caught, abs_err = 0.0, math.inf, 0.0
    for name, g, g2, w in zip(names, got, again, want):
        if g.dtype != w.dtype or g.shape != w.shape or \
                not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: {name} is {g.dtype} "
                                 f"{tuple(g.shape)}, the plain version's "
                                 f"{w.dtype} {tuple(w.shape)}, or not finite")
        if not torch.equal(g, g2):
            raise AssertionError(f"{what}: two calls on the same inputs "
                                 f"differ in {name}")
        e = rel_fro(torch, g, w)
        bad = rel_fro(torch, planted_grad(g), w)
        if not e <= bound < bad:
            raise AssertionError(f"{what}: {name} relative error {e:.3g}, "
                                 f"planted fault {bad:.3g}, bound {bound}")
        err, caught = max(err, e), min(caught, bad)
        abs_err = max(abs_err, float((g.float() - w.float()).abs().max()))
    return err, caught, abs_err


def flash_kernel_grads(torch, FA, q, k, v, do, causal, window):
    """(dq, dk, dv) through ``FlashAttention`` on the card: the forward
    instance that writes lse, then the backward kernels."""
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    o = FA.flash_attention_cuda(*ins, causal=causal, window=window)
    return torch.autograd.grad(o, ins, do)


def flash_bwd_work(shape, dtype):
    """(bytes, operations) of one backward call: q, k, v, o, dO and lse
    read once, dq, dk and dv written once; 2.5 times the forward's flops
    (S and dP recomputed, dV, dK and dQ: ``flash_work``)."""
    B, H, Kh, Sq, Sk, D, Dv = shape[:7]
    item = 4 if dtype == "fp32" else 2
    nbytes = item * (2 * B * H * Sq * (D + Dv) + 2 * B * Kh * Sk * (D + Dv)) \
        + 4 * B * H * Sq
    return nbytes, 2.5 * flash_work(shape, dtype)[1]


# fp32 products on the tensor cores as split bf16 operands: three bf16
# products (hi.hi + hi.lo + lo.hi) for each fp32 one
SPLIT_PRODUCTS = 3


def path_bound(dtype, path, nbytes, ops):
    """(bound ms, what bounds it) of the arithmetic a backward path does:
    fp32 on the tensor-core paths (flash "wgmma", SSD "tensor") as
    SPLIT_PRODUCTS bf16 products each at the bf16 peak, fp32 on the other
    paths at the fp32 FMA peak, bf16 at the bf16 peak (each product once:
    the SSD tensor path also splits its fp32 factors, so this is below what
    it issues)."""
    if path in ("wgmma", "tensor"):
        return work_bound("bf16", nbytes,
                          ops * (SPLIT_PRODUCTS if dtype == "fp32" else 1))
    return work_bound(dtype, nbytes, ops)


def flash_general_grads(torch, FA, q, k, v, do, causal, window):
    """(dq, dk, dv) from the backward kernels' general path on the
    forward's output and lse (the path every pair of head dims takes)."""
    o, lse = FA.flash_attention_lse_op(q, k, v, causal, window)
    return FA._cuda_backward(q, k, v, o, lse, do, causal, window,
                             path="general")


def phase_flash_backward(torch, FA):
    """Phase 5's backward: the kernels against ``flash_attention_backward``
    (autograd through the plain version) on ``flash_bwd_shapes()`` in both
    dtypes, on the path ``plan_backward`` gives (wgmma for head dims 64, 80
    and 128, else general) and, where that is wgmma, on the general path
    too; the forward's lse against the plain logsumexp; then timed at the
    training shapes (the wgmma path, which they must take, and the general
    path) beside the plain backward, the library's
    (``scaled_dot_product_attention``'s backward) and the bounds.  Returns
    ({dtype: (max abs error, launches in the check)}, {(dtype, name):
    timings})."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(2026)
    errs, timings = {}, {}
    for dtype in LM_DTYPES:
        err, caught, abs_err, lse_err, n = 0.0, math.inf, 0.0, 0.0, 0
        runs = {"wgmma": 0, "general": 0}
        launched = FA.backward_launches
        for shape, model_layout in flash_bwd_shapes():
            causal, window = shape[7], shape[8]
            q, k, v = flash_inputs(torch, shape, dtype, gen, model_layout)
            B, H, Sq, Dv = shape[0], shape[1], shape[3], shape[6]
            do = torch.randn((B, H, Sq, Dv), generator=gen,
                             device=DEV).to(q.dtype)
            got = flash_kernel_grads(torch, FA, q, k, v, do, causal, window)
            again = flash_kernel_grads(torch, FA, q, k, v, do, causal,
                                       window)
            torch.cuda.synchronize()
            plan = FA.plan_backward(*FA.padded_head_dims(*shape[5:7]),
                                    q.dtype)
            if FA.last_backward_plan != plan:
                raise AssertionError(f"flash backward {dtype} {shape}: the "
                                     f"{FA.last_backward_plan} path ran, "
                                     f"not the planned {plan}")
            want = FA.flash_attention_backward(q, k, v, do, causal=causal,
                                               window=window)
            checks = [(plan, got, again)]
            if plan != "general":
                checks.append(("general", *(flash_general_grads(
                    torch, FA, q, k, v, do, causal, window)
                    for _ in range(2))))
            for path, g1, g2 in checks:
                e, c, a = check_grads(
                    torch, f"flash backward {dtype} {shape} ({path})", g1,
                    g2, want, ("dq", "dk", "dv"), FLASH_BWD_REL[dtype])
                err, caught, abs_err = max(err, e), min(caught, c), \
                    max(abs_err, a)
                runs[path] += 1
            _, lse = FA.flash_attention_lse_op(q, k, v, causal, window)
            plain = FA.flash_lse_plain(q, k, causal=causal, window=window)
            le = float(((lse - plain).abs() / (1 + plain.abs())).max())
            if not le <= LSE_TOL:
                raise AssertionError(f"flash {dtype} {shape}: lse differs "
                                     f"from the plain logsumexp by {le:.3g}")
            lse_err, n = max(lse_err, le), n + 1
            del q, k, v, do, got, again, want, lse, plain, checks
        errs[dtype] = (abs_err, FA.backward_launches - launched)
        print(f"[flash-bwd] {dtype}: backward kernels == plain backward on "
              f"{n} shapes (the serving shapes' masks and head dims at "
              f"batch 1-2, MLA 24/16 padded, rows that see no key), "
              f"{runs['wgmma']} on the wgmma path and {runs['general']} on "
              f"the general path: largest relative error of dq, dk, dv "
              f"{err:.3g} (bound {FLASH_BWD_REL[dtype]}; max abs "
              f"{abs_err:.3g}), a planted {PLANT - 1:.0%} fault reads "
              f"{caught:.3g} or more; two calls bit-identical on each path; "
              f"the forward's lse vs the plain logsumexp {lse_err:.3g} "
              f"(bound {LSE_TOL})")
        for name, shape in FLASH_TRAIN.items():
            B, H, Kh, Sq, Sk, D, Dv, causal, window = shape
            q, k, v = flash_inputs(torch, shape, dtype, gen, True)
            do = torch.randn((B, H, Sq, Dv), generator=gen,
                             device=DEV).to(q.dtype)
            o, lse = FA.flash_attention_lse_op(q, k, v, causal, window)
            kms, kcall = timed(
                torch, lambda *a: FA.flash_attention_backward_op(
                    *a, causal, window), [(q, k, v, o, lse, do)], iters=5,
                what=f"flash backward {dtype} {name}")
            path = FA.last_backward_plan
            if path != "wgmma":
                raise AssertionError(f"flash backward {dtype} {name}: the "
                                     f"{path} path ran at a training shape")
            split = kernel_split(torch, lambda: FA.flash_attention_backward_op(
                q, k, v, o, lse, do, causal, window))
            gms, _ = timed(torch, lambda *a: FA._cuda_backward(
                *a, causal, window, path="general"), [(q, k, v, o, lse, do)],
                iters=3, what=f"flash general backward {dtype} {name}")
            pms, _ = timed(torch, lambda *a: FA.flash_attention_backward(
                *a, causal=causal, window=window), [(q, k, v, do)], iters=2,
                what=f"flash plain backward {dtype} {name}")
            lq, lk, lv = (t.detach().contiguous().requires_grad_()
                          for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                                enable_gqa=H != Kh)
            lms, _ = timed(torch, lambda: torch.autograd.grad(
                lo, (lq, lk, lv), do, retain_graph=True), [()], iters=5,
                what=f"library backward {dtype} {name}")
            fms, _ = timed(torch, lambda *a: FA.flash_attention_lse_op(
                *a, causal, window), [(q, k, v)], iters=5,
                what=f"flash forward {dtype} {name}")
            work = flash_bwd_work(shape, dtype)
            bms, by = path_bound(dtype, path, *work)
            gbms, _ = path_bound(dtype, "general", *work)
            timings[(dtype, name)] = (kms, pms, lms, bms, by, fms, split,
                                      gms, gbms, path)
            print(f"[flash-bwd] {dtype} {name} {shape[:7]} causal: plan "
                  f"{path} kernel_ms={kms:.4f} (per call {kcall:.4f}; "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f"; the forward {fms:.4f}) general_ms={gms:.4f} "
                  f"plain_ms={pms:.4f} library_ms={lms:.4f} "
                  f"bound_ms={bms:.4f} ({by}; the {path} path's "
                  f"arithmetic), {bms / kms:.1%} of it; general path's "
                  f"bound_ms={gbms:.4f}, {gbms / gms:.1%} of it; the "
                  f"library at {bms / lms:.1%} of the kernels' bound")
            del q, k, v, do, o, lse, lq, lk, lv, lo
    return errs, timings


def ssd_grad_inputs(torch, shape, dtype, gen, model_layout=False):
    """``ssd_inputs`` as leaves that require grad, and a dy."""
    ins = [t.detach().requires_grad_() for t in
           ssd_inputs(torch, shape, dtype, gen, model_layout)]
    Bt, L, H, P = shape[:4]
    return ins, torch.randn((Bt, L, H, P), generator=gen, device=DEV)


def ssd_bwd_work(shape, dtype):
    """(bytes, operations) of one SSD backward: x, dt, A, B, C and dy read
    once, dx, ddt, dA, dB and dC written once; three times the forward's
    flops (``ssd_work``)."""
    Bt, L, H, P, N, c = shape
    item = 4 if dtype == "fp32" else 2
    nbytes = 2 * (item * (Bt * L * H * P + 2 * Bt * L * N) + 4 * Bt * L * H
                  + 4 * H) + 4 * Bt * L * H * P
    return nbytes, 3 * ssd_work(shape, dtype)[1]


def phase_ssd_backward(torch, SSD):
    """Phase 6's backward: the kernels against ``mamba2_ssd_backward`` at
    zamba2's training microbatch (the model's strided slices: the tensor
    path) and on the general path's two shapes (P or N above 64; a chunk
    beyond the tensor path's), in both dtypes; then timed at the training
    shape (the tensor path, which it must take) beside the plain backward
    and the bounds.  Returns ({dtype: (max abs error, launches in the
    check)}, {dtype: timings})."""
    gen = torch.Generator(device=DEV).manual_seed(2027)
    errs, timings = {}, {}
    names = ("dx", "ddt", "dA", "dB", "dC")
    for dtype in LM_DTYPES:
        err, caught, abs_err, paths = 0.0, math.inf, 0.0, []
        launched = SSD.backward_launches
        for shape, model_layout, want_path in (
                (SSD_TRAIN, True, "tensor"), (SSD_BWD_GENERAL, False,
                                              "general"),
                (SSD_BWD_LONG, False, "general")):
            ins, dy = ssd_grad_inputs(torch, shape, dtype, gen, model_layout)
            runs = []
            for _ in range(2):
                y, _ = SSD.mamba2_ssd_cuda(*ins, chunk=shape[5])
                runs.append(torch.autograd.grad(y, ins, dy))
            torch.cuda.synchronize()
            if SSD.last_backward_plan != want_path:
                raise AssertionError(f"ssd backward {shape}: the "
                                     f"{SSD.last_backward_plan} path ran, "
                                     f"not the {want_path} path")
            paths.append(SSD.last_backward_plan)
            want = SSD.mamba2_ssd_backward(*(t.detach() for t in ins), dy,
                                           chunk=shape[5])
            e, c, a = check_grads(
                torch, f"ssd backward {dtype} {shape} ({want_path})",
                *runs, want, names, SSD_BWD_REL[dtype])
            err, caught, abs_err = max(err, e), min(caught, c), \
                max(abs_err, a)
            del ins, dy, runs, want, y
        errs[dtype] = (abs_err, SSD.backward_launches - launched)
        print(f"[ssd-bwd] {dtype}: backward kernels == plain backward at "
              f"{SSD_TRAIN} (strided, {paths[0]} path), "
              f"{SSD_BWD_GENERAL} ({paths[1]} path) and {SSD_BWD_LONG} "
              f"({paths[2]} path): largest relative error of dx, ddt, dA, "
              f"dB, dC {err:.3g} (bound {SSD_BWD_REL[dtype]}; max abs "
              f"{abs_err:.3g}), a planted {PLANT - 1:.0%} fault reads "
              f"{caught:.3g} or more; two calls bit-identical on each shape")
        ins, dy = ssd_grad_inputs(torch, SSD_TRAIN, dtype, gen, True)
        args = [(*(t.detach() for t in ins), dy)]
        c = SSD_TRAIN[5]
        kms, kcall = timed(torch, lambda *a: SSD.mamba2_ssd_backward_op(
            *a, c), args, iters=5, what=f"ssd backward {dtype}")
        path = SSD.last_backward_plan
        if path != "tensor":
            raise AssertionError(f"ssd backward {dtype}: the {path} path ran "
                                 "at the training shape")
        split = kernel_split(torch, lambda: SSD.mamba2_ssd_backward_op(
            *args[0], c))
        pms, _ = timed(torch, lambda *a: SSD.mamba2_ssd_backward(
            *a, chunk=c), args, iters=2, what=f"ssd plain backward {dtype}")
        fwd, _ = timed(torch, lambda *a: SSD.mamba2_ssd_cuda(*a[:5], chunk=c),
                       args, iters=5, what=f"ssd forward {dtype}")
        work = ssd_bwd_work(SSD_TRAIN, dtype)
        bms, by = path_bound(dtype, path, *work)
        fms, _ = work_bound("fp32", *work)
        timings[dtype] = (kms, pms, bms, by, fms, path, split, fwd)
        print(f"[ssd-bwd] {dtype} {SSD_TRAIN}: plan {path} "
              f"kernel_ms={kms:.4f} (per call {kcall:.4f}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; the forward {fwd:.4f}) "
              f"plain_ms={pms:.4f} library_ms=n/a bound_ms={bms:.4f} ({by}; "
              f"the tensor path's arithmetic), {bms / kms:.1%} of it; "
              f"fma_bound_ms={fms:.4f} (the products at the fp32 FMA peak), "
              f"{fms / kms:.1%} of it")
        del ins, dy, args
    return errs, timings


class Kernels:
    """Within the block, the model's kernel wrappers ``ops.flash_attention``
    and ``ops.mamba2_ssd`` are ``flash`` and ``ssd``."""

    def __init__(self, ops, flash, ssd):
        self.ops, self.fns = ops, (flash, ssd)

    def __enter__(self):
        self.saved = (self.ops.flash_attention, self.ops.mamba2_ssd)
        self.ops.flash_attention, self.ops.mamba2_ssd = self.fns
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.mamba2_ssd = self.saved


def plain_kernels(ops, FA, SSD):
    """The model runs the kernels' plain versions on the card instead."""
    return Kernels(
        ops, lambda q, k, v, *, causal=True, window=0:
        FA.flash_attention_plain(q, k, v, causal=causal, window=window),
        lambda x, dt, A, B, C: SSD.mamba2_ssd_plain(
            x, dt, A, B, C, chunk=min(256, x.shape[1])))


def planted_kernels(ops):
    """The model runs the kernels with a planted fault: their outputs at
    the later half of the positions PLANT times too large."""
    flash, ssd = ops.flash_attention, ops.mamba2_ssd

    # the outputs are copied first: autograd forbids writing in place into
    # a view that a custom Function returned (the flash output is one)
    def bad_ssd(*a):
        y, state = ssd(*a)
        y = y.clone()
        y[:, y.shape[1] // 2:] *= PLANT
        return y, state

    return Kernels(ops, lambda *a, **kw: planted(flash(*a, **kw).clone()),
                   bad_ssd)


def call_key(name, kw):
    """A call's key: the name, with "[window]" after it for a call with a
    sliding window (gemma3's local layers), "[noncausal]" for one without
    the causal mask (whisper's encoder and cross attention)."""
    if kw.get("window"):
        return f"{name}[window]"
    return f"{name}[noncausal]" if kw.get("causal") is False else name


class FirstCalls:
    """Within the block, keeps the arguments of the first call of each
    ``module.name`` of ``fns`` (a list of (module, name)) and counts the
    calls, by ``call_key``."""

    def __init__(self, fns):
        self.fns, self.calls, self.counts = fns, {}, {}

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.fns]
        for (mod, name), orig in zip(self.fns, self.saved):
            def call(*a, _fn=orig, _mod=mod, _name=name, **kw):
                key = call_key(_name, kw)
                self.calls.setdefault(key, (_mod, _name, a, kw))
                self.counts[key] = self.counts.get(key, 0) + 1
                return _fn(*a, **kw)
            setattr(mod, name, call)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in zip(self.fns, self.saved):
            setattr(mod, name, orig)


def rel_fro(torch, got, want):
    """The Frobenius norm of ``got - want`` relative to ``want``'s."""
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want))


def first_call_tol(key, name, dtype):
    if name == "flash_attention":
        return FLASH_TOL[dtype]
    return SSD_REL if name == "mamba2_ssd" else LAYER_TOL[(key, dtype)]


def _output(got):
    """A layer's output: the first of (y, cache), or y itself."""
    return got[0] if isinstance(got, tuple) else got


def first_call_check(torch, ops, FA, SSD, calls, dtype):
    """Each recorded call rerun on its recorded inputs with the kernels,
    with their plain versions and with a planted fault: {key: (error,
    planted error, tolerance)}.  The flash kernel's output is measured by
    ``flash_err``, the SSD's y and state and a layer's output by their
    relative Frobenius error (``rel_fro``), each against the plain
    versions' run.  A layer with no kernel (``NO_KERNEL``) is held against
    the same call in fp32, its weights and inputs upcast, and the planted
    fault is made in its output."""
    out = {}
    for key, (mod, name, a, kw) in calls.items():
        def run(args=a):
            with torch.inference_mode():
                return getattr(mod, name)(*args, **kw)

        def err(got):
            if name == "flash_attention":
                return flash_err(torch, got, want, dtype)
            if name == "mamba2_ssd":
                return max(rel_fro(torch, g, w) for g, w in zip(got, want))
            return rel_fro(torch, _output(got), _output(want))

        if name in NO_KERNEL:
            p, x, cfg = a
            want = run((dict((n, t.float()) for n, t in
                             p.named_parameters()), x.float(), cfg))
            got = _output(run())
            e = err(got)
            e_bad = err(planted(got.clone()[:, None])[:, 0])
        else:
            with plain_kernels(ops, FA, SSD):
                want = run()
            e = err(run())
            with planted_kernels(ops):
                e_bad = err(run())
        out[key] = (e, e_bad, first_call_tol(key, name, dtype))
        del want
    return out


def lm_config(arch):
    """The config ``phase_lm`` serves: the published one, cut by
    ``LM_CUTS``."""
    from repro_torch.configs import base as cb
    return cb.get(arch).replace(**LM_CUTS.get(arch, {}))


def lm_cuts(arch):
    """``LM_CUTS[arch]`` as text: each field, published -> served."""
    from repro_torch.configs import base as cb
    full = cb.get(arch)
    return ", ".join(f"{k} {getattr(full, k)} -> {v}"
                     for k, v in LM_CUTS.get(arch, {}).items()) or "none"


def lm_model(mdl, cfg, dtype, gen):
    """Weights for ``cfg`` drawn on the card from ``gen``.  int8 experts
    are quantised from bf16 draws (an int8 spec initialises to zeros), a
    layer at a time, each layer's bf16 experts freed as it goes."""
    if cfg.expert_weights_dtype != "int8":
        return mdl.init(cfg, gen, dtype, DEV)
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    specs = mdl.param_specs(cfg.replace(expert_weights_dtype="bf16"))
    tree = {}
    for key, sub in specs.items():           # the draws in the tree's order
        if key != "blocks":
            tree[key] = init_params(sub, gen, dtype, DEV)
            continue
        tree[key] = []
        for block in sub:
            b = init_params(block, gen, dtype, DEV)
            b["moe"] = moe.quantize_expert_weights(b["moe"])
            tree[key].append(b)
    return mdl.LM(cfg, tree)


def param_gib(params):
    return sum(p.numel() * p.element_size()
               for p in params.parameters()) / 2**30


def max_rel(got, want):
    """The largest error of a list of logits against another, relative to
    each step's max |logit|."""
    return max(float((a - b).abs().max() / (b.abs().max() + 1e-6))
               for a, b in zip(got, want))


def device_split(torch, fn):
    """Device ms of one ``fn()`` from a ``torch.profiler`` trace: the total
    and its flash-kernel and SSD-kernel shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"total": 0.0, "flash": 0.0, "ssd": 0.0}
    # the raw device events: ``key_averages()`` would first build a Python
    # event tree, tens of seconds for the xLSTM prefill's many small kernels
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms, name = e.duration_ns() / 1e6, e.name()
        split["total"] += ms
        for key, tags in (("flash", ("flash_bf16_kernel", "flash_f32_kernel")),
                          ("ssd", ("ssd_kernel", "ssd_chunk_state",
                                   "ssd_state_pass", "ssd_chunk_scan"))):
            if any(tag in name for tag in tags):
                split[key] += ms
    return split


def teacher_forced(torch, serve, mdl, params, cfg, tokens, toks, split=None,
                   inputs=None):
    """Prefill logits, then the logits of each decode step fed the served
    tokens ``toks``: a list of (B, V) fp32 tensors.  ``inputs``: the
    family's patches or frames.  ``split``, a dict, gets the prefill's and
    the decode steps' device ms, each split by kernel (profiler traces)."""
    S, box, out = tokens.shape[1], {}, []

    def prefill():
        box["last"], box["cache"] = serve.prefill_cache(
            params, cfg, tokens, S + toks.shape[1], inputs)

    def decode():
        cache = box["cache"]
        for i in range(toks.shape[1] - 1):
            logits, cache = mdl.decode_step(params, cfg, toks[:, i:i + 1],
                                            S + i, cache)
            out.append(logits.float())

    with torch.inference_mode():
        for stage, fn in (("prefill", prefill), ("decode", decode)):
            if split is None:
                fn()
            else:
                split[stage] = device_split(torch, fn)
    return [box["last"].float()] + out


def served(torch, serve, cfg, params, tokens, inputs):
    """``run_lm`` on the card: (tokens, prefill ms, decode ms per step),
    the times read from the line ``run_lm`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        toks = serve.run_lm(cfg=cfg, params=params, tokens=tokens,
                            inputs=inputs, gen=LM_GEN, device=DEV)
    line = buf.getvalue()
    print(line, end="")
    m = re.search(r"prefill in ([0-9.]+) ms \(([0-9.]+) tok/s", line)
    return toks, float(m[1]), LM_BATCH / float(m[2]) * 1e3


class WallTime:
    """Within the block, the wall seconds of every call of ``mod.name``
    (the card synchronised at both ends), summed in ``seconds``."""

    def __init__(self, torch, mod, name):
        self.torch, self.mod, self.name, self.seconds = torch, mod, name, 0.0

    def __enter__(self):
        self.saved = getattr(self.mod, self.name)

        def call(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.saved(*a, **kw)
            self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        setattr(self.mod, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.saved)


def flash_calls(cfg):
    """{call key: count} of the flash calls one prefill of ``cfg`` makes:
    one per attention application (``call_key``)."""
    fam, nsb = cfg.family, cfg.n_superblocks
    if fam == "ssm":
        return {}
    if fam == "hybrid":
        return {"flash_attention": nsb}
    if fam == "gemma3":
        return {"flash_attention": nsb,
                "flash_attention[window]": nsb * (cfg.superblock - 1)}
    if fam == "audio":
        return {"flash_attention": cfg.n_layers,
                "flash_attention[noncausal]": cfg.encoder_layers
                + cfg.n_layers}
    return {"flash_attention": cfg.n_layers}


def first_fns(cfg):
    """The (module, name) pairs whose first call in a prefill is checked:
    each kernel the family runs and each layer that holds one (the xLSTM
    layers, which hold none, against fp32)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention, ssm, xlstm
    if cfg.family == "ssm":
        return [(xlstm, "mlstm_fwd"), (xlstm, "slstm_fwd")]
    fns = [(ops, "flash_attention"),
           (attention, "mla_fwd" if cfg.attn_kind == "mla" else "gqa_fwd")]
    if cfg.family == "audio":
        fns.append((attention, "cross_fwd"))
    if cfg.family == "hybrid":
        fns += [(ops, "mamba2_ssd"), (ssm, "mamba2_fwd")]
    return fns


def lm_batch(sp, cfg, arch, gen):
    """(tokens, modality inputs) of ``arch``'s served batch."""
    b = sp.make_batch(cfg, LM_PROMPTS.get(arch, LM_PROMPT), LM_BATCH, gen,
                      device=DEV, with_labels=False)
    return b.pop("tokens"), b


def phase_lm(torch, serve, FA, SSD):
    launches = {f"{name}[{dtype}]": 0 for dtype in LM_DTYPES
                for name in ("flash_attention", "mamba2_ssd")}
    runs = [(arch, dtype) for dtype in LM_DTYPES for arch in LM_ARCHS] + \
        [(arch, "bf16") for arch in LM_BF16_ARCHS]
    for arch, dtype in runs:
        n_fa, n_ssd = lm_serve_and_check(torch, serve, FA, SSD, arch, dtype)
        launches[f"flash_attention[{dtype}]"] += n_fa
        launches[f"mamba2_ssd[{dtype}]"] += n_ssd
    return launches


def lm_serve_and_check(torch, serve, FA, SSD, arch, dtype):
    """One arch in one dtype through ``run_lm`` and its checks (phase 10),
    and for the archs of ``LM_INT8_KV`` the int8 KV cache's
    (``int8_kv_check``); returns the served runs' (flash, SSD) launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as sp
    from repro_torch.models import attention, moe, xlstm
    from repro_torch.models import model as mdl
    cfg = lm_config(arch)
    t0 = time.perf_counter()
    stages = {}                 # the check's own wall seconds, by stage

    def stage(name):
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0 - sum(stages.values())

    gen = torch.Generator(device=DEV).manual_seed(0)
    params = lm_model(mdl, cfg, getattr(torch, TORCH_DTYPE[dtype]), gen)
    tokens, inputs = lm_batch(sp, cfg, arch, gen)
    stage("weights")
    weights_gib = param_gib(params)
    gc.collect()        # earlier phases' cycles (a gallery) off the card
    torch.cuda.reset_peak_memory_stats()
    with WallTime(torch, xlstm, "_slstm_scan") as scan:
        FA.launches = SSD.launches = 0
        toks, prefill_ms, step_ms = served(torch, serve, cfg, params, tokens,
                                           inputs)
        n_fa, n_ssd = FA.launches, SSD.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_mamba = cfg.n_layers if cfg.family == "hybrid" else 0
    want_calls = flash_calls(cfg)
    if (n_fa, n_ssd) != (sum(want_calls.values()), n_mamba):
        raise AssertionError(f"lm {arch} {dtype}: launches flash={n_fa} "
                             f"ssd={n_ssd}, want "
                             f"{sum(want_calls.values())} and {n_mamba}")
    if tuple(toks.shape) != (LM_BATCH, LM_GEN) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"lm {arch} {dtype}: tokens {tuple(toks.shape)}")
    stage("served")
    # the kernels' teacher-forced run, traced, recording the inputs of the
    # first call of each kernel and of each layer holding one
    split = {}
    int8 = arch in LM_INT8_KV
    with FirstCalls(first_fns(cfg)) as rec, \
            int8_records(attention, moe, cfg, int8) as rec16:
        kern = teacher_forced(torch, serve, mdl, params, cfg, tokens, toks,
                              split, inputs)
    calls = {k: n for k, n in rec.counts.items()
             if k.startswith("flash_attention")}
    if calls != want_calls:
        raise AssertionError(f"lm {arch} {dtype}: flash calls {calls}, "
                             f"want {want_calls}")
    stage("traced")
    if want_calls or n_mamba:
        with plain_kernels(ops, FA, SSD):
            plain = teacher_forced(torch, serve, mdl, params, cfg, tokens,
                                   toks, inputs=inputs)
    else:
        plain = kern            # no kernel runs: the plain run is this one
    stage("plain")
    if int8:
        int8 = int8_kv_check(torch, serve, FA, mdl, params, cfg, tokens,
                             toks, inputs, kern, rec16)
        stage("int8")
    del rec16
    for i, a in enumerate(kern):
        if not (bool(torch.isfinite(a).all()) and a.shape ==
                (LM_BATCH, cfg.vocab_size)):
            raise AssertionError(f"lm {arch} {dtype}: step {i} logits not "
                                 "finite")
    firsts = first_call_check(torch, ops, FA, SSD, rec.calls, dtype)
    del rec
    stage("first calls")
    for key, (e, e_bad, tol) in firsts.items():
        if not e <= tol < e_bad:
            raise AssertionError(
                f"lm {arch} {dtype}: first {key} kernels vs plain {e}, "
                f"planted fault {e_bad} (tolerance {tol})")
    agree = sum(int((b.argmax(-1) == toks[:, i]).sum())
                for i, b in enumerate(plain))
    rel = max_rel(kern, plain)
    memory = ""
    if dtype == "fp32":
        check = f"tolerance {LM_REL}"
        ok = rel <= LM_REL
    else:
        # the two copies never share the card: the bf16 weights go to the
        # host, then come back as fp32 (int8 experts stay int8)
        p32, memory = fp32_copy(torch, params)
        with int8_records(attention, moe, cfg, int8) as rec32:
            truth = teacher_forced(torch, serve, mdl, p32, cfg, tokens, toks,
                                   inputs=inputs)
        memory += (f", fp32 run peak "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if int8:
            int8_kv_fp32(torch, serve, mdl, p32, cfg, tokens, toks, inputs,
                         truth, int8, rec32)
        del rec32
        del p32
        stage("fp32")
        err_k, err_p = max_rel(kern, truth), max_rel(plain, truth)
        check = (f"vs fp32 weights: kernels {err_k:.3g}, plain {err_p:.3g} "
                 f"(at most {LM_BF16_RATIO}x plain)")
        ok = err_k <= LM_BF16_RATIO * err_p
    if not ok:
        raise AssertionError(f"lm {arch} {dtype}: kernel logits vs plain "
                             f"{rel}; {check}")
    first_txt = ", ".join(
        f"{key} {e:.3g} (tolerance {tol}, planted fault {e_bad:.3g})"
        for key, (e, e_bad, tol) in firsts.items())
    windowed = want_calls.get("flash_attention[window]", 0)
    noncausal = want_calls.get("flash_attention[noncausal]", 0)
    print(f"[lm] {arch} {dtype}: batch {LM_BATCH}, prompt "
          f"{tokens.shape[1]}, gen {LM_GEN}, {cfg.n_layers} layers, cuts: "
          f"{lm_cuts(arch)}: launches flash={n_fa} ({windowed} windowed, "
          f"{noncausal} non-causal) ssd={n_ssd}; "
          f"prefill_ms={prefill_ms:.1f} "
          f"decode_tok_s={LM_BATCH / step_ms * 1e3:.1f} "
          f"peak_mem_gib={peak:.2f} (weights {weights_gib:.2f} GiB{memory}); "
          f"first calls in prefill, kernels vs plain: {first_txt}; "
          f"teacher-forced logits, max rel err kernels vs plain {rel:.3g}, "
          f"{check}; plain argmax == served token {agree}/{toks.numel()}; "
          f"weights made in {stages['weights']:.1f} s")
    pre, dec = split["prefill"], split["decode"]
    step_dev = dec["total"] / (LM_GEN - 1)
    scan_txt = "" if cfg.family != "ssm" else (
        f"; the sLSTM scans' wall_ms={scan.seconds * 1e3:.1f} "
        f"({scan.seconds * 1e3 / prefill_ms:.1%} of the served prefill)")
    print(f"[lm-time] {arch} {dtype}: prefill device_ms={pre['total']:.1f} "
          f"(flash {pre['flash']:.1f}, ssd {pre['ssd']:.1f}, other "
          f"{pre['total'] - pre['flash'] - pre['ssd']:.1f}) of wall_ms="
          f"{prefill_ms:.1f}; decode step device_ms={step_dev:.2f} of "
          f"wall_ms={step_ms:.2f} (device idle {1 - step_dev / step_ms:.1%})"
          f"{scan_txt}; this check took {sum(stages.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()) + ")")
    if int8:
        int8_kv_report(arch, cfg, int8)
        n_fa += int8["launches"]
    del params, tokens, toks, kern, plain
    torch.cuda.empty_cache()
    return n_fa, n_ssd


def fp32_copy(torch, params):
    """An fp32 copy of bf16 ``params`` on the card, the bf16 weights moved
    to the host first (int8 experts stay int8): (copy, a note of it)."""
    params.to("cpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p32 = params.to(DEV, torch.float32)
    return p32, (f"; fp32 copy {param_gib(p32):.2f} GiB, the bf16 weights "
                 "on the host meanwhile")


def cache_gib(mdl, cfg, B, T):
    """GiB of a (B, T) cache of ``cfg`` (its specs, nothing allocated)."""
    import torch
    from repro_torch.models.params import spec_map
    total = []
    spec_map(lambda s: total.append(math.prod(s.shape) * (
        s.dtype or torch.bfloat16).itemsize), mdl.cache_specs(cfg, B, T))
    return sum(total) / 2**30


def forward_logits(torch, mdl, params, cfg, tokens, toks, inputs):
    """The full forward over the prompt and the served tokens fed back:
    the logits (B, V) at each position a teacher-forced run predicts from
    (the prompt's last, then each fed token's), fp32."""
    from repro_torch.models import layers
    S = tokens.shape[1]
    with torch.inference_mode():
        h, _, _ = mdl.forward(params, cfg, dict(
            inputs, tokens=torch.cat([tokens, toks[:, :-1]], dim=1)),
            return_hidden=True)
        out = layers.unembed(params["embed"], h[:, S - 1:]).float()
    return [out[:, i] for i in range(out.shape[1])]


class Outputs:
    """Within the block, the outputs of every call of ``mod.name``, in
    ``outs``."""

    def __init__(self, mod, name):
        self.mod, self.name, self.outs = mod, name, []

    def __enter__(self):
        self.saved = getattr(self.mod, self.name)

        def call(*a, **kw):
            out = self.saved(*a, **kw)
            self.outs.append(out)
            return out
        setattr(self.mod, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.saved)


@contextlib.contextmanager
def int8_records(attention, moe, cfg, on):
    """Within the block (where ``on``), the outputs of the attention decode
    step that reads the KV (or latent) cache, and of the MoE routing:
    (steps, picks) ``Outputs``, else None."""
    if not on:
        yield None
        return
    step = "mla_step" if cfg.attn_kind == "mla" else "gqa_step"
    with Outputs(attention, step) as steps, Outputs(moe, "_route") as picks:
        yield steps, picks


def first_step_err(torch, rec, ref):
    """The first attention decode step's output (the first layer at the
    first step: the same input on both runs) of ``rec`` against ``ref``'s,
    relative Frobenius."""
    return rel_fro(torch, rec[0].outs[0][0], ref[0].outs[0][0])


def changed_picks(rec, ref):
    """(token routings whose top-k expert set differs, all) between two
    runs' MoE routings."""
    a, b = rec[1].outs, ref[1].outs
    return (sum(int((x[1].sort(-1)[0] != y[1].sort(-1)[0]).any(-1).sum())
                for x, y in zip(a, b)), sum(x[1].shape[0] for x in a))


def int8_kv_check(torch, serve, FA, mdl, params, cfg, tokens, toks, inputs,
                  kern, rec16):
    """The int8 KV cache on the bf16 weights ``params`` (phase 10): served
    by ``run_lm`` (its flash launches counted), then its decode fed the
    bf16 run's served tokens ``toks`` (``kern``, its decode on the bf16
    cache, ``rec16`` its ``int8_records``) against the bf16 full forward.
    In bf16 a decode leaves the forward by the drift of two roundings of
    the whole model, whatever its cache (PERF.md), so the int8 decode may
    stray at most LM_BF16_RATIO times as far as ``kern``; where tokens
    pick experts the cache is held at its layer instead (``int8_held``).
    Returns the numbers so far (``int8_kv_fp32`` adds the fp32 check)."""
    from repro_torch.models import attention, moe
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    FA.launches = 0
    toks8, prefill_ms, step_ms = served(torch, serve, cfg8, params, tokens,
                                        inputs)
    out = {"launches": FA.launches, "prefill_ms": prefill_ms,
           "step_ms": step_ms}
    if out["launches"] != sum(flash_calls(cfg).values()) or \
            tuple(toks8.shape) != tuple(toks.shape):
        raise AssertionError(f"lm int8 kv {cfg.name}: {out['launches']} "
                             f"flash launches, tokens {tuple(toks8.shape)}")
    with int8_records(attention, moe, cfg, True) as rec8:
        dec8 = teacher_forced(torch, serve, mdl, params, cfg8, tokens, toks,
                              inputs=inputs)
    full = forward_logits(torch, mdl, params, cfg, tokens, toks, inputs)
    out["bf16"] = (max_rel(dec8, full), max_rel(kern, full),
                   first_step_err(torch, rec8, rec16),
                   changed_picks(rec8, rec16))
    T = tokens.shape[1] + LM_GEN
    out["gib"] = (cache_gib(mdl, cfg8, LM_BATCH, T),
                  cache_gib(mdl, cfg, LM_BATCH, T))
    e8, e16, layer, _ = out["bf16"]
    if not int8_held(cfg, layer, e8 <= LM_BF16_RATIO * e16):
        raise AssertionError(f"lm int8 kv {cfg.name}: bf16 {out['bf16']}")
    return out


def int8_held(cfg, layer, logits_ok):
    """The int8 KV cache's gate: the first attention step within
    INT8_KV_REL of the unquantised cache's, and, where tokens pick no
    experts, the logits check ``logits_ok``.  A MoE model's top-k routing
    is discontinuous: a perturbation of any size moves some token's pick
    at some layer and its logits jump (the changed picks are counted), so
    its logits are not held."""
    return layer <= INT8_KV_REL and (bool(cfg.n_experts) or logits_ok)


def int8_kv_fp32(torch, serve, mdl, p32, cfg, tokens, toks, inputs, truth,
                 out, rec32):
    """The int8 KV cache's check on the fp32 weights ``p32``, where only the
    cache is quantised: its decode within INT8_KV_REL of max |logit| of the
    full forward (the reference's check), and its first attention step
    within INT8_KV_REL of the unquantised cache's (``truth``'s run,
    ``rec32`` its ``int8_records``); see ``int8_held``."""
    from repro_torch.models import attention, moe
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    with int8_records(attention, moe, cfg, True) as rec8:
        dec32 = teacher_forced(torch, serve, mdl, p32, cfg8, tokens, toks,
                               inputs=inputs)
    full = forward_logits(torch, mdl, p32, cfg, tokens, toks, inputs)
    out["fp32"] = (max_rel(dec32, full), max_rel(truth, full),
                   max_rel(dec32, truth), first_step_err(torch, rec8, rec32),
                   changed_picks(rec8, rec32))
    if not int8_held(cfg, out["fp32"][3], out["fp32"][0] <= INT8_KV_REL):
        raise AssertionError(f"lm int8 kv {cfg.name}: fp32 {out['fp32']}")


def int8_kv_report(arch, cfg, out):
    (g8, g16) = out["gib"]
    e8, e16, l16, p16 = out["bf16"]
    f8, f16, f8_16, l32, p32 = out["fp32"]
    held = "the first attention step (the logits are not held: top-k " \
        "routing)" if cfg.n_experts else \
        "the first attention step and the fp32 decode vs the forward"
    print(f"[lm-int8kv] {arch}: cuts: {lm_cuts(arch)}; cache {g8:.3f} GiB "
          f"int8 against {g16:.3f} GiB bf16 ({g8 / g16:.3f}x); launches "
          f"flash={out['launches']}; prefill_ms={out['prefill_ms']:.1f} "
          f"decode_tok_s={LM_BATCH / out['step_ms'] * 1e3:.1f}; held: "
          f"{held}, tolerance {INT8_KV_REL}; fp32 weights: first attention "
          f"step int8 vs unquantised cache {l32:.3g}, teacher-forced decode "
          f"max rel err int8 cache vs the forward {f8:.3g}, unquantised "
          f"cache vs the forward {f16:.3g}, int8 vs unquantised {f8_16:.3g}, "
          f"token routings that pick other experts {p32[0]} of {p32[1]}; "
          f"bf16 weights: first attention step {l16:.3g}, vs the forward: "
          f"int8 cache {e8:.3g}, bf16 cache {e16:.3g} (at most "
          f"{LM_BF16_RATIO}x where not routed), routings changed {p16[0]} "
          f"of {p16[1]}")


def phase_lm_default(torch, serve, FA):
    """``run_lm(arch)`` with no other argument, as a user calls it: the
    smoke config, bf16, on the card."""
    from repro_torch.configs import base as cb
    for arch in cb.ARCH_IDS:
        cfg = cb.smoke(arch)
        FA.launches = 0
        toks = serve.run_lm(arch)
        n_fa = FA.launches
        if toks.dim() != 2 or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size or \
                n_fa != sum(flash_calls(cfg).values()):
            raise AssertionError(f"run_lm({arch!r}): tokens "
                                 f"{tuple(toks.shape)}, {n_fa} flash "
                                 "launches")
        heads = None if cfg.family == "ssm" else \
            (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
             cfg.v_head_dim) if cfg.attn_kind == "mla" else (cfg.dh, cfg.dh)
        kernel = "no attention" if heads is None else \
            f"head dims {heads} (the kernel's {FA.padded_head_dims(*heads)})"
        print(f"[lm-default] run_lm({arch!r}): smoke config, {kernel}, "
              f"tokens {tuple(toks.shape)} in range, flash launches {n_fa}")


# phase 12: training.  (global batch, sequence) of each model, trained in
# fp32 at its published widths with AdamW, clipping at 1.0, remat on;
# auto_microbatches must give 2 microbatches for each
TRAIN = {"tinyllama-1.1b": (16, 2048), "zamba2-2.7b": (4, 2048)}
TRAIN_MICRO = 2
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 6, 3, 4
# the clean run's steps (0-based) traced, with the activities each
# records: the device's alone for the idle share, the host's too for the
# device split (which matches kernels to the backwards' ranges)
TRAIN_TRACES = {2: ("CUDA",), 3: ("CPU", "CUDA")}
# the peak learning rate (train.main warms up over 20 steps): at full width
# a fresh model's fp32 AdamW diverged after one update at 3e-4 (PERF.md §6)
TRAIN_LR = 1e-4
# kernels vs plain through one microbatch's loss and gradients: the loss
# relative to the plain run's, each leaf's gradient by the Frobenius norm of
# the difference relative to the plain run's; each bound sits between the
# readings and the planted fault's (PERF.md §6)
TRAIN_LOSS_REL = 1e-6
TRAIN_GRAD_REL = 1e-3
RECOVER_TOL = 1e-3      # the reference's tests/test_system.py bound
# the backwards' record_function ranges (around the backward kernels'
# launches in ``FlashAttention`` / ``MambaSSD``) -> their share's name
BACKWARD_RANGES = {"flash_attention.backward": "flash_backward",
                   "mamba2_ssd.backward": "ssd_backward"}
# the fp32 steady step walls with the plain backwards (measured on one
# H100), printed beside this run's
TRAIN_WALL_PLAIN = {"tinyllama-1.1b": 9182.4, "zamba2-2.7b": 7416.4}


def train_model(torch, arch):
    """(cfg, trainable fp32 model drawn on the card from seed 0, the first
    batch of the stream ``train.main`` reads, as tensors on the card)."""
    from repro_torch.configs import base as cb
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models import model as mdl
    from repro_torch.models.params import trainable
    cfg = cb.get(arch)
    B, S = TRAIN[arch]
    gen = torch.Generator(device=DEV).manual_seed(0)
    lm = trainable(mdl.init(cfg, gen, torch.float32, DEV))
    batch = TokenStream(DataConfig(seed=1, vocab_size=cfg.vocab_size,
                                   seq_len=S, global_batch=B)).batch_at(0)
    return cfg, lm, {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}


def loss_and_grads(torch, mdl, lm, cfg, micro, kernels):
    """One microbatch's loss (a float) and every gradient, with ``kernels``
    (a ``Kernels`` block or a null context) in place."""
    for p in lm.parameters():
        p.grad = None
    with kernels:
        loss, _ = mdl.loss_fn(lm, cfg, micro)
        loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  lm.named_parameters()}


def grad_err(torch, got, want):
    """(largest relative Frobenius error of a leaf, that leaf's name); the
    leaves of ``got`` may lie on the host and come over one at a time."""
    errs = {n: rel_fro(torch, g.to(DEV), want[n]) for n, g in got.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def train_calls(cfg):
    """(flash, SSD) launches of one microbatch's loss and backward with
    remat: each block runs twice, once forward and once in the recompute."""
    n_mamba = cfg.n_layers if cfg.family == "hybrid" else 0
    return 2 * sum(flash_calls(cfg).values()), 2 * n_mamba


def train_backward_calls(cfg):
    """(flash, SSD) backward-kernel launches of one microbatch: one per
    attention application and one per Mamba-2 layer."""
    return tuple(n // 2 for n in train_calls(cfg))


@contextlib.contextmanager
def no_plain_backward(FA, SSD):
    """Within the block the plain backwards raise: a gradient on the card
    must come from the backward kernels."""
    def boom(*a, **kw):
        raise AssertionError("a plain backward ran on the card")
    saved = FA.flash_attention_backward, SSD.mamba2_ssd_backward
    FA.flash_attention_backward = SSD.mamba2_ssd_backward = boom
    try:
        yield
    finally:
        FA.flash_attention_backward, SSD.mamba2_ssd_backward = saved


def backward_split(torch, prof):
    """Device ms of a trace: {"total", "flash", "ssd", "backward",
    "flash_backward", "ssd_backward"}: every kernel; the kernels launched
    inside the backwards (the ``BACKWARD_RANGES`` record_function ranges),
    matched to their launch calls by correlation id, in all and by
    kernel; and, of the rest, the flash and SSD forward kernels (the
    forwards and the recompute's)."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    ranges = sorted((e.start_ns(), e.end_ns(), BACKWARD_RANGES[e.name()])
                    for e in events if e.device_type() != DeviceType.CUDA
                    and e.name() in BACKWARD_RANGES)
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != DeviceType.CUDA
                and "Launch" in e.name()}
    split = dict.fromkeys(("total", "flash", "ssd", "backward",
                           *BACKWARD_RANGES.values()), 0.0)
    starts = [r[0] for r in ranges]
    for e in events:
        # (a record_function range also shows as a device-side annotation
        # spanning its kernels: not a kernel, not counted)
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or e.name() in BACKWARD_RANGES:
            continue
        ms, name = e.duration_ns() / 1e6, e.name()
        split["total"] += ms
        t = launched.get(e.correlation_id())
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= ranges[i][1]:
            split["backward"] += ms
            split[ranges[i][2]] += ms
        elif "flash_bf16_kernel" in name or "flash_f32_kernel" in name:
            split["flash"] += ms
        elif "ssd_" in name:
            split["ssd"] += ms
    if ranges and not split["backward"]:
        raise AssertionError("train: no kernel matched the backwards' "
                             "ranges in the trace")
    return split


def train_check(torch, FA, SSD, arch):
    """Phase 12's check of one model: one microbatch's loss and gradients
    with the kernels, with their plain versions and with a planted fault;
    the launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import model as mdl
    t0 = time.perf_counter()
    cfg, lm, batch = train_model(torch, arch)
    B, S = TRAIN[arch]
    n_micro = steps.auto_microbatches(cfg, B, S)
    if n_micro != TRAIN_MICRO:
        raise AssertionError(f"train {arch}: auto_microbatches gave "
                             f"{n_micro}, want {TRAIN_MICRO}")
    micro = {k: v[:B // n_micro] for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    FA.launches = SSD.launches = 0
    FA.backward_launches = SSD.backward_launches = 0
    with no_plain_backward(FA, SSD):
        loss_k, g = loss_and_grads(torch, mdl, lm, cfg, micro,
                                   contextlib.nullcontext())
    launches = (FA.launches, SSD.launches)
    bwd = (FA.backward_launches, SSD.backward_launches)
    peak_micro = torch.cuda.max_memory_allocated() / 2**30
    if launches != train_calls(cfg) or bwd != train_backward_calls(cfg):
        raise AssertionError(f"train {arch}: a microbatch launched flash "
                             f"{launches[0]}, ssd {launches[1]} times, the "
                             f"backwards {bwd}, want {train_calls(cfg)} and "
                             f"{train_backward_calls(cfg)}")
    # the kernels' gradients wait on the host: two sets of zamba2's fp32
    # gradients and its weights would crowd the card
    g_kernels = {n: t.to("cpu") for n, t in g.items()}
    del g
    loss_p, g_plain = loss_and_grads(torch, mdl, lm, cfg, micro,
                                     plain_kernels(ops, FA, SSD))
    loss_b, g_bad = loss_and_grads(torch, mdl, lm, cfg, micro,
                                   planted_kernels(ops))
    l_err = abs(loss_k - loss_p) / abs(loss_p)
    l_bad = abs(loss_b - loss_p) / abs(loss_p)
    g_err, g_leaf = grad_err(torch, g_kernels, g_plain)
    b_err, b_leaf = grad_err(torch, g_bad, g_plain)
    del g_kernels, g_plain, g_bad
    t_check = time.perf_counter() - t0
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    n_fa, n_ssd = launches
    print(f"[train-check] {arch}: fp32, {cfg.n_layers} layers x d "
          f"{cfg.d_model}, batch {B} x {S} in {n_micro} microbatches; one "
          f"microbatch's loss {loss_k:.6f} and gradients, kernels (forward "
          f"and backward, the plain backwards patched to raise) vs plain: "
          f"loss rel {l_err:.3g} (bound {TRAIN_LOSS_REL}), gradients max "
          f"rel {g_err:.3g} at {g_leaf} (bound {TRAIN_GRAD_REL}); planted "
          f"fault: loss rel {l_bad:.3g}, gradients {b_err:.3g} at {b_leaf}; "
          f"launches a microbatch flash={n_fa} ssd={n_ssd} (with remat's "
          f"recompute), backward kernels flash={bwd[0]} ssd={bwd[1]}; peak "
          f"{peak_micro:.2f} GiB a microbatch; check took {t_check:.1f} s")
    # (raised after the lines above, so that a failure shows every reading)
    if not (math.isfinite(loss_k) and l_err <= TRAIN_LOSS_REL < l_bad
            and g_err <= TRAIN_GRAD_REL < b_err):
        raise AssertionError(
            f"train {arch}: kernels vs plain loss {l_err:.3g}, gradients "
            f"{g_err:.3g} ({g_leaf}); planted fault loss {l_bad:.3g}, "
            f"gradients {b_err:.3g} ({b_leaf}); bounds {TRAIN_LOSS_REL}, "
            f"{TRAIN_GRAD_REL}")


@contextlib.contextmanager
def traced_step(torch, train, into):
    """Within the block, each of ``train.main``'s steps with an index in
    TRAIN_TRACES runs under the profiler with that entry's activities,
    the device synchronised on each side; ``into[index]`` gets the step's
    (wall ms, trace)."""
    from torch.profiler import ProfilerActivity, profile
    make = train.make_train_step

    def make_traced(*a, **kw):
        step_fn = make(*a, **kw)

        def step(params, opt_state, batch, i):
            if i not in TRAIN_TRACES:
                return step_fn(params, opt_state, batch, i)
            torch.cuda.synchronize()
            with profile(activities=[getattr(ProfilerActivity, a)
                                     for a in TRAIN_TRACES[i]]) as prof:
                t = time.perf_counter()
                out = step_fn(params, opt_state, batch, i)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            into[i] = (wall, prof)
            return out
        return step

    train.make_train_step = make_traced
    try:
        yield
    finally:
        train.make_train_step = make


def train_runs(torch, FA, SSD, arch):
    """``train.main`` on the card: for tinyllama a clean run and a run that
    crashes at TRAIN_FAIL_AT and recovers from the step-TRAIN_CKPT_EVERY
    checkpoint, whose final losses must agree within RECOVER_TOL; for
    zamba2 the steps alone.  The loss must fall.  The clean run's step
    steps in TRAIN_TRACES are traced (``traced_step``): one step's idle
    share against its own wall time, the next one's device split.
    Returns the runs' (flash, SSD) launches."""
    import shutil
    from repro_torch.launch import train
    B, S = TRAIN[arch]
    ckpt = ROOT / "build" / "ckpt"
    common = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
              str(B), "--seq", str(S), "--n-micro", str(TRAIN_MICRO),
              "--lr", str(TRAIN_LR),
              "--log-every", "1", "--device", DEV]
    runs = [("clean", ["--ckpt-every", str(TRAIN_STEPS + 1)])]
    if arch == "tinyllama-1.1b":
        runs.append(("recovered", ["--ckpt-every", str(TRAIN_CKPT_EVERY),
                                   "--simulate-failure", str(TRAIN_FAIL_AT)]))
    out = {}
    # steps run: the crashed run's TRAIN_FAIL_AT, then the replay from the
    # checkpoint
    n_steps = TRAIN_STEPS + (TRAIN_FAIL_AT + TRAIN_STEPS - TRAIN_CKPT_EVERY
                             if len(runs) > 1 else 0)
    traced = {}
    FA.launches = SSD.launches = 0
    FA.backward_launches = SSD.backward_launches = 0
    for name, extra in runs:
        shutil.rmtree(ckpt, ignore_errors=True)
        buf = io.StringIO()
        trace = traced_step(torch, train, traced) if name == "clean" else \
            contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with trace, contextlib.redirect_stdout(buf):
                final = train.main(common + extra + ["--ckpt-dir", str(ckpt)])
        finally:
            print(buf.getvalue(), end="")
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        losses = [float(x) for x in
                  re.findall(r"\] step +\d+ loss +([0-9.]+)", text)]
        walls = [float(x) for x in re.findall(r"step wall ms ([0-9.]+)",
                                              text)]
        peak = max((float(x) for x in re.findall(r"peak GiB ([0-9.]+)",
                                                 text)), default=math.nan)
        if not (math.isfinite(final) and losses[-1] < losses[0]):
            raise AssertionError(f"train {arch} {name}: the loss did not "
                                 f"fall: {losses}")
        out[name] = (final, losses, walls, peak, secs)
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    launches = (FA.launches, SSD.launches)
    bwd = (FA.backward_launches, SSD.backward_launches)
    cfg = lm_config(arch)       # no cuts: the published config
    want = tuple(n * n_steps * TRAIN_MICRO for n in train_calls(cfg))
    want_bwd = tuple(n * n_steps * TRAIN_MICRO
                     for n in train_backward_calls(cfg))
    if launches != want or bwd != want_bwd:
        raise AssertionError(f"train {arch}: train.main launched flash "
                             f"{launches[0]}, ssd {launches[1]} times, the "
                             f"backwards {bwd}, in {n_steps} steps, want "
                             f"{want} and {want_bwd}")
    final, losses, walls, peak, secs = out["clean"]
    # the steady steps: neither the first nor a traced one
    steady = [w for i, w in enumerate(walls)
              if i and i not in TRAIN_TRACES]
    ms = sum(steady) / len(steady)
    (i_idle, (w_idle, p_idle)), (i_split, (w_split, p_split)) = \
        sorted(traced.items())
    busy = backward_split(torch, p_idle)["total"]
    split = backward_split(torch, p_split)
    del traced, p_idle, p_split
    txt = ""
    if "recovered" in out:
        diff = abs(out["recovered"][0] - final)
        if not diff < RECOVER_TOL:
            raise AssertionError(f"train {arch}: recovered final loss "
                                 f"{out['recovered'][0]} vs clean {final}")
        txt = (f"; crashed at step {TRAIN_FAIL_AT}, restored step "
               f"{TRAIN_CKPT_EVERY}, final loss {out['recovered'][0]:.6f}, "
               f"|diff| {diff:.3g} (bound {RECOVER_TOL}) in "
               f"{out['recovered'][4]:.1f} s")
    print(f"[train] {arch}: train.main {TRAIN_STEPS} steps, loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; steady step wall_ms={ms:.1f} (plain backwards: "
          f"{TRAIN_WALL_PLAIN[arch]}) tok/s="
          f"{B * S / ms * 1e3:,.0f} peak {peak:.2f} GiB; clean run "
          f"{secs:.1f} s{txt}; launches flash={launches[0]} "
          f"ssd={launches[1]}, backward kernels flash={bwd[0]} "
          f"ssd={bwd[1]} in {n_steps} steps")
    rest = split["total"] - split["flash"] - split["ssd"] - split["backward"]
    print(f"[train-time] {arch}: the clean run's untraced steady steps "
          f"wall_ms={ms:.1f}; step {i_idle + 1} traced (device only) "
          f"wall_ms={w_idle:.1f} device_ms={busy:.1f}, device idle of that "
          f"step {1 - busy / w_idle:.1%}; step {i_split + 1} traced (host "
          f"and device) wall_ms={w_split:.1f} device_ms="
          f"{split['total']:.1f} = flash forward {split['flash']:.1f} + ssd "
          f"forward {split['ssd']:.1f} + backward kernels "
          f"{split['backward']:.1f} (flash {split['flash_backward']:.1f}, "
          f"ssd {split['ssd_backward']:.1f}) + rest {rest:.1f}")
    return launches, bwd


def phase_train(torch, FA, SSD):
    """Phase 12: each model of TRAIN checked and trained; returns the
    training runs' launches by kernel name."""
    names = ("flash_attention[fp32]", "mamba2_ssd[fp32]",
             "flash_attention_backward[fp32]", "mamba2_ssd_backward[fp32]")
    launches = dict.fromkeys(names, 0)
    for arch in TRAIN:
        train_check(torch, FA, SSD, arch)
        fwd, bwd = train_runs(torch, FA, SSD, arch)
        for name, n in zip(names, (*fwd, *bwd)):
            launches[name] += n
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the mesh
# ---------------------------------------------------------------------------
# the production mesh's model axis: (a) runs the kernels at the shapes one
# of its ranks gets, H / 8 query heads and the kv heads they read, as the
# dry run (launch/dryrun.py) records them for those cells
MESH_MODEL = 8
# (b) the sharded steps on a world-1 NCCL group and a (1, 1) mesh, each held
# against the unsharded path on the same weights: (arch, dtype, config
# replacements, prefill rules, decode rules or None); then one train step
MESH_SERVE = [("tinyllama-1.1b", "bf16", {}, "tp", "decode"),
              ("zamba2-2.7b", "bf16", {}, "tp", None),
              ("deepseek-v2-236b", "bf16",
               {"n_layers": 2, "expert_weights_dtype": "int8"},
               "decode_moe", "decode_moe")]
MESH_DECODE = 4                       # decode steps after the prefill
MESH_TRAIN = ("tinyllama-1.1b", 4, 2048, "fsdp")   # fp32, 2 microbatches
FLASH_KERNELS = ("flash_bf16_kernel", "flash_f32_kernel")
SSD_CALL_KERNELS = ("ssd_kernel", "ssd_chunk_scan")   # one of them a call


def local_flash_shape(shape):
    """One model-axis rank's share of a flash call: H / MESH_MODEL query
    heads and the kv heads they read (all of its own where the kv heads
    split too, else the group its query heads fall in)."""
    B, H, Kh, Sq, Sk, D, Dv, causal, window = shape
    Hl = H // MESH_MODEL
    if Kh % MESH_MODEL == 0:
        Khl = Kh // MESH_MODEL
    else:
        G = H // Kh
        Khl = max(1, Hl // G)
    return (B, Hl, Khl, Sq, Sk, D, Dv, causal, window)


def phase_mesh_kernels(torch, FA, SSD):
    """Phase 13 (a): the flash kernel at each serving shape's local share
    and the SSD at zamba2's 80 / 8 = 10 heads, both dtypes, held against
    the plain versions (with a planted fault rejected) and timed."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(13)
    out = {}
    for dtype in LM_DTYPES:
        for name, full in FLASH_SERVE.items():
            shape = local_flash_shape(full)
            causal, window = shape[7], shape[8]
            q, k, v = flash_inputs(torch, shape, dtype, gen, True)
            o = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
            p = FA.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            e = flash_err(torch, o, p, dtype)
            e_bad = flash_err(torch, planted(p.clone()), p, dtype)
            if not e <= FLASH_TOL[dtype] < e_bad:
                raise AssertionError(f"mesh flash {dtype} {name} {shape}: "
                                     f"error {e}, planted {e_bad} (tolerance "
                                     f"{FLASH_TOL[dtype]})")
            abs_err = float((o.float() - p.float()).abs().max())
            args = [(q, k, v)]
            lib_mask = dict(attn_mask=FA._masks(
                shape[3], shape[4], True, window, DEV)) if window else \
                dict(is_causal=causal)
            what = f"local flash {dtype} {name}"
            kms, _ = timed(torch, lambda q, k, v: FA.flash_attention_cuda(
                q, k, v, causal=causal, window=window), args, iters=3,
                what=what)
            pms, _ = timed(torch, lambda q, k, v: FA.flash_attention_plain(
                q, k, v, causal=causal, window=window), args, iters=2,
                what=f"{what} plain")
            lms, _ = timed(torch, lambda q, k, v:
                           F.scaled_dot_product_attention(
                               q, k, v, enable_gqa=shape[1] != shape[2],
                               **lib_mask), args, iters=3,
                           what=f"{what} SDPA")
            bms, by = work_bound(dtype, *flash_work(shape, dtype))
            out[("flash", dtype, name)] = dict(
                shape=shape, err=abs_err, ms=kms, plain_ms=pms,
                library_ms=lms, bound_ms=bms, bound_by=by)
            print(f"[mesh-local] flash {dtype} {name} {shape[:7]}: error "
                  f"{e:.3g} (planted {e_bad:.3g}) kernel_ms={kms:.4f} "
                  f"plain_ms={pms:.4f} library_ms={lms:.4f} "
                  f"bound_ms={bms:.4f} ({by}), {bms / kms:.1%} of it")
            del q, k, v, o, p, args
        Bt, L, H, P, N, c = SSD_SERVE
        shape = (Bt, L, H // MESH_MODEL, P, N, c)
        x, dt, A, Bm, Cm = ssd_inputs(torch, shape, dtype, gen, True)
        got = ssd_outputs(*SSD.mamba2_ssd_cuda(x, dt, A, Bm, Cm, chunk=c,
                                               stages=True))
        want = dict(ssd_outputs(*SSD.mamba2_ssd_plain(x, dt, A, Bm, Cm,
                                                      chunk=c, stages=True)))
        err = 0.0
        for name, g in got:
            if not ssd_close(torch, g, want[name]) or \
                    ssd_close(torch, planted_ssd(g.clone()), want[name]):
                raise AssertionError(f"mesh ssd {dtype} {shape}: {name} "
                                     "differs, or a planted fault passes")
            err = max(err, float((g - want[name]).abs().max()))
        args = [(x, dt, A, Bm, Cm)]
        kms, _ = timed(torch, lambda *a: SSD.mamba2_ssd_cuda(*a), args,
                       iters=3, what=f"local ssd {dtype}")
        pms, _ = timed(torch, lambda *a: SSD.mamba2_ssd_plain(*a, chunk=c),
                       args, iters=2, what=f"local ssd {dtype} plain")
        bms, by = work_bound("tf32", *ssd_work(shape, dtype))
        out[("ssd", dtype)] = dict(shape=shape, err=err, ms=kms,
                                   plain_ms=pms, library_ms=None,
                                   bound_ms=bms, bound_by=by,
                                   path=SSD.last_plan)
        print(f"[mesh-local] ssd {dtype} {shape}: {SSD.last_plan} path, "
              f"max abs error {err:.3g}; kernel_ms={kms:.4f} "
              f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}), "
              f"{bms / kms:.1%} of it")
        del x, dt, A, Bm, Cm, got, want, args
    return out


def kernel_launches(torch, FA, SSD, fn, what, tries=TRACE_TRIES):
    """(``fn()``'s result, {"flash": n, "ssd": n}): the kernels' launches in
    one run of ``fn``, from their wrappers' counts, set to 0 just before it
    and read just after, held equal to the launches a whole marked
    profiler trace of the same run saw (an SSD call is one ``ssd_kernel``
    launch on the general path, one ``ssd_chunk_scan`` on the staged).
    A trace that lacks a marker or disagrees is taken again on ``fn`` run
    again, up to ``tries`` times: only a run that gives the same result
    again (a prefill; a serve step, which writes the same cache slot with
    the same values) may have more than one."""
    for attempt in range(tries):
        FA.launches = SSD.launches = 0
        FA.backward_launches = SSD.backward_launches = 0
        res, inside = marked_trace(torch, fn, TRACE_PAD_S if attempt else 0.0)
        n = {"flash": FA.launches, "ssd": SSD.launches}
        if not isinstance(inside, str):
            seen = {"flash": sum(any(t in name for t in FLASH_KERNELS)
                                 for name, _ in inside),
                    "ssd": sum(any(t in name for t in SSD_CALL_KERNELS)
                               for name, _ in inside)}
            if n == seen:
                return res, n
        print(f"[trace] {what}: try {attempt + 1}: the wrappers counted {n}"
              f", the trace holds {inside if isinstance(inside, str) else seen}")
    raise TraceMissed(f"mesh: {what}: no trace in {tries} tries saw the "
                      "launches the wrappers counted")


class TraceMissed(AssertionError):
    """No marked trace of a run saw the launches its wrappers counted."""


def wall_ms(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t) * 1e3


def held_equal(torch, what, got, want):
    """Bit-identical tensors; the check must also reject ``want`` with a
    planted fault on its later half (PLANT, or + 1 on integers)."""
    if got.shape != want.shape or not torch.equal(got, want):
        d = float((got.float() - want.float()).abs().max()) \
            if got.shape == want.shape else math.inf
        raise AssertionError(f"mesh: {what} differs from the unsharded "
                             f"path's (max abs {d:.3g}); world 1 must be "
                             "bit-identical")
    bad = want.clone()
    flat = bad.view(-1)
    if bad.is_floating_point():
        flat[flat.numel() // 2:] *= PLANT
    else:
        flat[flat.numel() // 2:] += 1
    if torch.equal(got, bad):
        raise AssertionError(f"mesh: a planted fault in {what} passes")


def tensor_leaves(tree, prefix=""):
    """[(path, tensor)] of a tree of dicts, lists and tensors."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tensor_leaves(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tensor_leaves(v, f"{prefix}.{i}")]
    return [(prefix, tree)] if hasattr(tree, "shape") else []


def serve_steps(st, cb, cfg, T):
    """The dry run's prefill and serve steps (``steps.step_fn_for``) at the
    phase's batch, for a prompt of LM_PROMPT and a cache of ``T``."""
    prefill, _, _ = st.step_fn_for(
        cfg, cb.ShapeSpec("mesh_prefill", LM_PROMPT, LM_BATCH, "prefill"),
        None, 1)
    step, _, _ = st.step_fn_for(
        cfg, cb.ShapeSpec("mesh_decode", T, LM_BATCH, "decode"), None, 1)
    return prefill, step


def serve_run(torch, FA, SSD, shd, mdl, serve, sp, cfg, params, tokens,
              tdt, mesh, rules):
    """``tokens`` served through the dry run's steps, unsharded where
    ``mesh`` is None, else under ``rules`` (prefill rules, decode rules or
    None) on ``mesh``: the prefill (its launches counted, then run again
    for its wall time) and MESH_DECODE greedy serve steps (each counted,
    its wall timed inside the traced run).  Returns the prefill's logits,
    each step's token and the cache at the end (full tensors), the
    launches of each counted run and the walls."""
    from repro_torch.configs import base as cb
    from repro_torch.launch import steps as st
    prefill_rules, decode_rules = rules
    T = LM_PROMPT + MESH_DECODE
    prefill, step = serve_steps(st, cb, cfg, T)
    side = "unsharded" if mesh is None else "sharded"

    def under(r):
        return contextlib.nullcontext() if mesh is None else \
            shd.use_rules(r, mesh)

    def put(x, r):
        return x if mesh is None else \
            shd.to_dtensor(x, ("batch", "seq"), mesh, shd.RULE_SETS[r])

    out = {"launches": [], "steps_ms": [], "tokens": []}
    with torch.no_grad():
        with under(prefill_rules):
            batch = {"tokens": put(tokens, prefill_rules)}
            (logits, cache), n = kernel_launches(
                torch, FA, SSD, lambda: prefill(params, batch),
                f"{cfg.name} {side} prefill")
            out["launches"].append(n)
            _, out["prefill_ms"] = wall_ms(torch,
                                           lambda: prefill(params, batch))
        out["logits"] = shd.full_tensor(logits)
        if decode_rules is None:
            return out
        full = serve._tree_map2(serve._put,
                                sp.init_cache(cfg, LM_BATCH, T, dtype=tdt,
                                              device=DEV),
                                shd.full_tree(cache))
        del cache
        tok = torch.argmax(out["logits"], -1).to(torch.int32)[:, None]
        with under(decode_rules):
            cache = full if mesh is None else shd.distribute_tree(
                full, mdl.cache_specs(cfg, LM_BATCH, T), mesh,
                decode_rules)
            del full
            for i in range(MESH_DECODE):
                t = put(tok, decode_rules)
                ((nxt, cache), ms), n = kernel_launches(
                    torch, FA, SSD, lambda: wall_ms(torch, lambda: step(
                        params, t, LM_PROMPT + i, cache)),
                    f"{cfg.name} {side} serve step {i}")
                out["launches"].append(n)
                out["steps_ms"].append(ms)
                tok = shd.full_tensor(nxt)
                out["tokens"].append(tok)
        out["cache"] = shd.full_tree(cache)
    return out


def mesh_serve(torch, FA, SSD, shd, mdl, serve, sp, mesh, arch, dtype, cuts,
               prefill_rules, decode_rules):
    """One model served through the dry run's steps, unsharded and then
    sharded on the same weights: the prefill's logits, every step's token
    and the cache at the end held bit-identical, and each counted run's
    kernel launches equal.  Returns the sharded runs' launches."""
    from repro_torch.configs import base as cb
    cfg = cb.get(arch).replace(**cuts)
    tdt = getattr(torch, TORCH_DTYPE[dtype])
    gen = torch.Generator(device=DEV).manual_seed(1300)
    params = lm_model(mdl, cfg, tdt, gen)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=DEV, dtype=torch.int32)
    rules = (prefill_rules, decode_rules)
    ref = serve_run(torch, FA, SSD, shd, mdl, serve, sp, cfg, params, tokens,
                    tdt, None, rules)
    shd.distribute_params(params, mdl.param_specs(cfg), mesh, prefill_rules)
    got = serve_run(torch, FA, SSD, shd, mdl, serve, sp, cfg, params, tokens,
                    tdt, mesh, rules)
    held_equal(torch, f"{arch} prefill logits", got["logits"],
               ref["logits"])
    for i, (g, w) in enumerate(zip(got["tokens"], ref["tokens"])):
        held_equal(torch, f"{arch} serve step {i} token", g, w)
    if decode_rules:
        want = dict(tensor_leaves(ref["cache"]))
        for path, g in tensor_leaves(got["cache"]):
            held_equal(torch, f"{arch} cache{path} after the serve steps",
                       g, want[path])
    if got["launches"] != ref["launches"]:
        raise AssertionError(f"mesh: {arch} sharded runs launched "
                             f"{got['launches']}, the unsharded "
                             f"{ref['launches']}")
    total = {k: sum(n[k] for n in got["launches"]) for k in ("flash", "ssd")}
    line = (f"[mesh] {arch} {dtype} {lm_cuts_of(cfg, arch)}: prefill "
            f"({prefill_rules}) logits bit-identical, launches "
            f"{got['launches'][0]} both; wall ms unsharded "
            f"{ref['prefill_ms']:.1f}, sharded {got['prefill_ms']:.1f}")
    if decode_rules:
        n = max(MESH_DECODE - 1, 1)
        steps = {k: sum(n[k] for n in got["launches"][1:])
                 for k in ("flash", "ssd")}
        line += (f"; {MESH_DECODE} serve steps ({decode_rules}): tokens and "
                 f"the cache bit-identical, launches {steps} both (each "
                 f"step's equal); wall ms a step (traced, the "
                 f"first left out) unsharded "
                 f"{sum(ref['steps_ms'][1:]) / n:.1f}, sharded "
                 f"{sum(got['steps_ms'][1:]) / n:.1f}")
    print(line)
    del params, ref, got
    torch.cuda.empty_cache()
    return total


def lm_cuts_of(cfg, arch):
    from repro_torch.configs import base as cb
    full = cb.get(arch)
    cut = [f"{k} {getattr(full, k)} -> {getattr(cfg, k)}"
           for k in ("n_layers", "expert_weights_dtype")
           if getattr(full, k) != getattr(cfg, k)]
    return "(" + (", ".join(cut) or "whole") + ")"


def mesh_train(torch, FA, SSD, shd, mdl, mesh):
    """One fp32 train step under fsdp on the (1, 1) mesh against the
    unsharded step on the same weights and batch (``make_train_step``, the
    step ``steps.step_fn_for`` gives a train cell, here at TRAIN_MICRO
    microbatches: at 4 x 2048 its policy would take one), each counted,
    then a second for its wall time: loss, grad norm and every parameter
    after the two bit-identical, the counted steps' kernel launches equal.
    Returns the sharded step's launches."""
    from repro_torch.configs import base as cb
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import trainable
    from repro_torch.optim import adamw, constant
    from repro_torch.optim.optimizers import named_leaves
    arch, B, S, rules = MESH_TRAIN
    cfg = cb.get(arch)
    gen = torch.Generator(device=DEV).manual_seed(1301)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              device=DEV, dtype=torch.int32)
             for k in ("tokens", "labels")}
    out = {}
    for name in ("unsharded", "sharded"):
        # a step changes the weights, so a counted step whose trace missed
        # its launches is taken again from the same seeded weights
        for attempt in range(TRACE_TRIES):
            lm = trainable(mdl.init(cfg, torch.Generator(
                device=DEV).manual_seed(0), torch.float32, DEV))
            opt = adamw(constant(TRAIN_LR), weight_decay=0.01)
            step = make_train_step(cfg, opt, n_micro=TRAIN_MICRO)
            if name == "sharded":
                shd.distribute_params(lm, mdl.param_specs(cfg), mesh, rules)
                b = {k: shd.to_dtensor(v, ("batch", "seq"), mesh,
                                       shd.RULE_SETS[rules])
                     for k, v in batch.items()}
                ctx = shd.use_rules(rules, mesh)
            else:
                b, ctx = batch, contextlib.nullcontext()
            try:
                with ctx:
                    state = opt.init(lm)
                    (_, _, met), n = kernel_launches(
                        torch, FA, SSD, lambda: step(lm, state, b, 0),
                        f"{arch} {name} train step", tries=1)
                    n = {**n, "flash_backward": FA.backward_launches,
                         "ssd_backward": SSD.backward_launches}
                    _, ms = wall_ms(torch, lambda: step(lm, state, b, 1))
                break
            except TraceMissed:
                if attempt == TRACE_TRIES - 1:
                    raise
                del lm, state
                torch.cuda.empty_cache()
        out[name] = (met, {k: shd.full_tensor(p.detach()) for k, p in
                           named_leaves(lm).items()}, n, ms)
        del lm, state
        torch.cuda.empty_cache()
    (m0, p0, n0, ms0), (m1, p1, n1, ms1) = out["unsharded"], out["sharded"]
    for k in ("loss", "ce", "grad_norm"):
        held_equal(torch, f"train {k}", m1[k].reshape(1), m0[k].reshape(1))
    for k in p0:
        held_equal(torch, f"train parameter {k} after two steps", p1[k],
                   p0[k])
    if n1 != n0 or not n1["flash_backward"]:
        raise AssertionError(f"mesh: the sharded train step launched {n1}, "
                             f"the unsharded {n0}")
    print(f"[mesh] {arch} fp32 train ({rules}, {B} x {S} in {TRAIN_MICRO} "
          f"microbatches): loss {float(m0['loss']):.6f}, grad norm and "
          f"every parameter after two steps bit-identical, launches {n1} "
          f"both (the first step); second step wall ms unsharded "
          f"{ms0:.1f}, sharded {ms1:.1f}")
    return n1


def phase_mesh(torch, FA, SSD, serve):
    """Phase 13: (a) the kernels at one model-axis rank's shapes; (b) the
    sharded steps on a world-1 NCCL group, each held bit-identical to the
    unsharded path.  Returns ((a)'s readings, the kernels' launches in
    (b)'s sharded runs that were counted, by kernel name: bf16 the
    serving, fp32 the train step)."""
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as mdl
    t0 = time.perf_counter()
    local = phase_mesh_kernels(torch, FA, SSD)
    t_local = time.perf_counter() - t0
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    bf16 = {"flash": 0, "ssd": 0}
    try:
        mesh = make_host_mesh("cuda")
        for arch, dtype, cuts, pr, dr in MESH_SERVE:
            n = mesh_serve(torch, FA, SSD, shd, mdl, serve, sp, mesh, arch,
                           dtype, cuts, pr, dr)
            for k in bf16:
                bf16[k] += n[k]
        fp32 = mesh_train(torch, FA, SSD, shd, mdl, mesh)
    finally:
        dist.destroy_process_group()
    out = {"flash_attention_backward[fp32]": fp32["flash_backward"],
           "mamba2_ssd_backward[fp32]": fp32["ssd_backward"]}
    for dt, n in (("bf16", bf16), ("fp32", fp32)):
        out[f"flash_attention[{dt}]"] = n["flash"]
        out[f"mamba2_ssd[{dt}]"] = n["ssd"]
    print(f"[time] phase 13 (mesh) took {time.perf_counter() - t0:.1f} s "
          f"((a) {t_local:.1f} s); the script "
          f"{time.perf_counter() - T_START:.1f} s")
    return local, out


def phase_keystream(torch):
    """The cipher's keystream made on the card (as a CUDA gallery makes
    it): bit-identical to the one made on the CPU for 2^20 + 3 words, the
    comparison catching a flipped bit; then the wall time to make the
    keystream of one N_BIG-row fp32 shard (128 wide) on the card and bring
    it to the host, and to encrypt and to decrypt that shard with it (the
    XOR on the host), the decrypted shard equal to the original."""
    import numpy as np
    from repro_torch.crypto import templates as T
    key = T.prng_key(7 ^ 0x5EC2E7)
    n = (1 << 20) + 3
    card, cpu = T._keystream(key, n, DEV), T._keystream(key, n, "cpu")
    if not np.array_equal(card, cpu):
        raise AssertionError("the keystream made on the card differs from "
                             "the CPU's")
    flipped = card.copy()
    flipped[n // 2] ^= np.uint32(1 << 17)
    if np.array_equal(flipped, cpu):
        raise AssertionError("the keystream check passed a flipped bit")
    x = np.random.default_rng(0).standard_normal((N_BIG, 128),
                                                 dtype=np.float32)
    T.encrypt_array(key, x[:8], DEV)               # the first launches

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        return res, (time.perf_counter() - t0) * 1e3

    _, ks_ms = wall(lambda: T._keystream(key, x.size, DEV))
    enc, enc_ms = wall(lambda: T.encrypt_array(key, x, DEV))
    dec, dec_ms = wall(lambda: T.decrypt_array(key, enc, DEV))
    if not np.array_equal(dec, x):
        raise AssertionError("a shard encrypted and decrypted on the card "
                             "is not the shard")
    out = {"words": x.size, "keystream_ms": ks_ms, "encrypt_ms": enc_ms,
           "decrypt_ms": dec_ms}
    print(f"[keystream] made on the card == made on the CPU for {n} words "
          f"(a flipped bit caught); one {N_BIG} x 128 fp32 shard "
          f"({x.size} words): keystream to the host {ks_ms:.1f} ms, "
          f"encrypt {enc_ms:.1f} ms, decrypt {dec_ms:.1f} ms (wall, the "
          "XOR on the host), decrypted == original")
    return out


# phase 14: the port's examples on the card, each a process of its own,
# with the line each must end on
EXAMPLES_ON_CARD = (("quickstart_torch.py", "quickstart OK"),
                    ("serve_biometric_torch.py", "serve_biometric OK"),
                    ("arch_smoke_all_torch.py", "arch_smoke_all OK"),
                    ("elastic_recovery_torch.py", "elastic_recovery_torch OK"))


def phase_examples(torch):
    """Run each of EXAMPLES_ON_CARD as a subprocess on the card (its
    default), all at once (they keep virtual time, so running side by side
    changes none of their checks): each must exit 0 with its OK line, and
    the flash kernel must have launched in ``arch_smoke_all_torch.py`` (its
    last line but one).  Returns {script: seconds}."""
    from concurrent.futures import ThreadPoolExecutor
    torch.cuda.empty_cache()          # the cached blocks go back to the card
    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def run(script):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        return res, time.perf_counter() - t0

    with ThreadPoolExecutor(len(EXAMPLES_ON_CARD)) as pool:
        runs = list(pool.map(run, [s for s, _ in EXAMPLES_ON_CARD]))
    out = {}
    for (script, ok), (res, seconds) in zip(EXAMPLES_ON_CARD, runs):
        out[script] = seconds
        lines = [ln for ln in res.stdout.splitlines() if ok in ln]
        if res.returncode != 0 or not lines:
            raise AssertionError(f"{script}: exit {res.returncode}\n"
                                 f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
        extra = ""
        if script.startswith("arch_smoke_all"):
            m = re.search(r"kernel launches: flash_attention=(\d+) "
                          r"mamba2_ssd=(\d+)", res.stdout)
            if not m or int(m.group(1)) == 0:
                raise AssertionError(f"{script}: the flash kernel never "
                                     f"launched: {res.stdout[-800:]}")
            extra = f"; flash launches {m.group(1)}, SSD {m.group(2)}"
        print(f"[examples] {script}: exit 0 in {out[script]:.1f} s: "
              f"{lines[-1]}{extra}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"the port's sources are not under {SRC}")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ann_match as A
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gallery_match as gm
    from repro_torch.kernels import mamba2_ssd as SSD
    from repro_torch.launch import serve

    card = card_line()
    print(f"[card] {card}")
    phase_build([gm.build, A.build, FA.build, FA.build_lse, FA.build_backward,
                 SSD.build, SSD.build_backward])
    sass, ssd_sass, bwd_sass, ssd_bwd_sass = phase_sass(FA, SSD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, timings, rounds = phase_kernel(torch, gm)
    r_errs, r_timings, r_rounds = phase_rescore(torch, gm, A)
    phase_keystream(torch)
    f_errs, f_timings = phase_flash(torch, FA)
    fb_errs, fb_timings = phase_flash_backward(torch, FA)
    s_errs, s_timings = phase_ssd(torch, SSD)
    sb_errs, sb_timings = phase_ssd_backward(torch, SSD)
    # phase 13 right after the kernel phases: after the serving phases 7-9
    # short profiler traces on the card came back without their markers on
    # most tries, and after the LM phases empty (PERF.md §6, PR 24)
    local, mesh_launches = phase_mesh(torch, FA, SSD, serve)
    phase_reference(torch, serve)
    launches, ranked = phase_main(torch, gm, serve)
    ann_launches, _, wide_probe = phase_ann(torch, gm, A, serve)
    t_lm = time.perf_counter()
    lm_launches = phase_lm(torch, serve, FA, SSD)
    phase_lm_default(torch, serve, FA)
    print(f"[time] phases 10-11 (LM) took {time.perf_counter() - t_lm:.1f} "
          f"s; the script {time.perf_counter() - T_START:.1f} s")
    t_train = time.perf_counter()
    train_launches = phase_train(torch, FA, SSD)
    print(f"[time] phase 12 (training) took "
          f"{time.perf_counter() - t_train:.1f} s; the script "
          f"{time.perf_counter() - T_START:.1f} s")
    t_ex = time.perf_counter()
    phase_examples(torch)
    print(f"[time] phase 14 (examples) took "
          f"{time.perf_counter() - t_ex:.1f} s; the script "
          f"{time.perf_counter() - T_START:.1f} s")

    kernels = []
    for dtype in DTYPES:
        kms, pms, lms, bms, by, path = timings[(dtype, 1, 1)]
        kernels.append({
            "name": f"gallery_match[{dtype}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gallery_match.cu",
            "replaces": "src/repro/kernels/gallery_match.py:136",
            "launches": launches[dtype] + ann_launches[dtype][0],
            "max_abs_err": errs[dtype],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms, "path": path,
            "shape": f"Q=1 N={N_BIG} D=128 k=1",
            "launches_ranked": ranked[dtype],
            "launches_wide_probe": wide_probe[dtype][0],
            "rounds_and_wide": rounds[dtype]})
    for dtype in DTYPES:
        kms, pms, bms, by, kcall, fms, plan = r_timings[dtype]
        kernels.append({
            "name": f"cell_rescore[{dtype}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cell_rescore.cu",
            "replaces": "src/repro/kernels/ann_match.py:200",
            "launches": ann_launches[dtype][1], "max_abs_err": r_errs[dtype],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "call_ms": kcall, "empty_kernel_ms": fms,
            "path": plan[0], "warps": plan[1], "rows_a_warp": plan[2],
            "passes": plan[3], "blocks": plan[4],
            "shape": f"Q=1 c={NPROBE} K={CELLS} D=128 k=1",
            "launches_wide_probe": wide_probe[dtype][1],
            "rounds_and_wide": r_rounds[dtype]})
    for dtype in LM_DTYPES:
        name = f"flash_attention[{dtype}]"
        kms, pms, lms, bms, by = f_timings[(dtype, "mha")]
        more = {}
        for key in FLASH_SERVE:
            if key == "mha":
                continue
            B, H, Kh, Sq, Sk, D, Dv, causal, window = FLASH_SERVE[key]
            t = f_timings[(dtype, key)]
            seq = f"S={Sq}" if Sq == Sk else f"Sq={Sq} Sk={Sk}"
            more[key] = {
                "shape": f"B={B} H={H} Kh={Kh} {seq} D={D} Dv={Dv} "
                         + ("causal" if causal else "non-causal")
                         + (f" window={window}" if window else ""),
                "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                "bound_ms": t[3], "bound_by": t[4]}
        for key in FLASH_SERVE:
            t = local[("flash", dtype, key)]
            B, H, Kh, Sq, Sk, D, Dv, causal, window = t["shape"]
            more[f"local_{key}"] = {
                "shape": f"B={B} H={H} Kh={Kh} Sq={Sq} Sk={Sk} D={D} Dv={Dv}"
                         f" ({'causal' if causal else 'non-causal'}"
                         f"{f' window={window}' if window else ''}; one of "
                         f"{MESH_MODEL} model-axis ranks)",
                "max_abs_err": t["err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "launches": lm_launches[name] + train_launches.get(name, 0)
            + mesh_launches.get(name, 0),
            "launches_train": train_launches.get(name, 0),
            "launches_mesh": mesh_launches.get(name, 0),
            "max_abs_err": f_errs[dtype],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms, "sass": sass,
            "shape": "B=8 H=32 Kh=32 S=2048 D=80 causal", **more})
    for dtype in LM_DTYPES:
        name = f"mamba2_ssd[{dtype}]"
        kms, pms, bms, by, fms, path, stages = s_timings[dtype]
        t = local[("ssd", dtype)]
        loc = {"local": {
            "shape": "Bt={} L={} H={} P={} N={} chunk={} (one of {} "
                     "model-axis ranks)".format(*t["shape"], MESH_MODEL),
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": None, "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "path": t["path"]}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
            "replaces": "src/repro/kernels/mamba2_ssd.py:82",
            "launches": lm_launches[name] + train_launches.get(name, 0)
            + mesh_launches.get(name, 0),
            "launches_train": train_launches.get(name, 0),
            "launches_mesh": mesh_launches.get(name, 0), **loc,
            "max_abs_err": s_errs[dtype],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "fma_bound_ms": fms, "library_ms": None, "path": path,
            "stages_ms": stages, "sass": ssd_sass,
            "shape": f"Bt=8 L=2048 H=80 P=64 N=64 chunk=256 {dtype}"})
    for dtype in LM_DTYPES:
        name = f"flash_attention_backward[{dtype}]"
        kms, pms, lms, bms, by, fms, split, gms, gbms, path = \
            fb_timings[(dtype, "gqa")]
        mha = fb_timings[(dtype, "mha")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "none: the reference differentiates its jnp "
                        "attention (the gradient of "
                        "src/repro/kernels/flash_attention.py:95's function)",
            "launches": train_launches.get(name, 0)
            + mesh_launches.get(name, 0),
            "launches_train": train_launches.get(name, 0),
            "launches_mesh": mesh_launches.get(name, 0),
            "launches_check": fb_errs[dtype][1],
            "max_abs_err": fb_errs[dtype][0],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms, "forward_ms": fms, "kernels_ms": split,
            "path": path, "general_ms": gms, "general_bound_ms": gbms,
            "sass": bwd_sass,
            "shape": "B=8 H=32 Kh=4 S=2048 D=64 causal (tinyllama's "
                     "training microbatch)",
            "mha": {"shape": "B=2 H=32 Kh=32 S=2048 D=80 causal (zamba2's)",
                    "ms": mha[0], "plain_ms": mha[1], "library_ms": mha[2],
                    "bound_ms": mha[3], "bound_by": mha[4],
                    "forward_ms": mha[5], "kernels_ms": mha[6],
                    "general_ms": mha[7], "general_bound_ms": mha[8],
                    "path": mha[9]}})
    for dtype in LM_DTYPES:
        name = f"mamba2_ssd_backward[{dtype}]"
        kms, pms, bms, by, fms, path, split, fwd = sb_timings[dtype]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba2_ssd_bwd.cu",
            "replaces": "none: the reference differentiates its jnp "
                        "ssd_chunked (the gradient of "
                        "src/repro/kernels/mamba2_ssd.py:82's function)",
            "launches": train_launches.get(name, 0)
            + mesh_launches.get(name, 0),
            "launches_train": train_launches.get(name, 0),
            "launches_mesh": mesh_launches.get(name, 0),
            "launches_check": sb_errs[dtype][1],
            "max_abs_err": sb_errs[dtype][0],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "fma_bound_ms": fms, "library_ms": None, "path": path,
            "stages_ms": split, "forward_ms": fwd,
            "sass": ssd_bwd_sass,
            "shape": "Bt=2 L=2048 H=80 P=64 N=64 chunk=256 (zamba2's "
                     "training microbatch)"})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
