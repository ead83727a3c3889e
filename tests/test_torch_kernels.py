"""The port's gallery-match kernel module vs the JAX reference, on the CPU.

Here the kernel wrappers in ``repro_torch.kernels`` take their plain
PyTorch path (the tensors lie on the CPU); the CUDA kernel itself is held
against that plain path on the card by ``chip_smoke.py``.  Inputs are made
from a seed with numpy and handed to both sides.  The oracle is
``repro.kernels.ref`` and, for the contract's edge cases, the reference's
Pallas kernel in interpret mode.

Tolerances (max abs score error):
  * fp32: 1e-5 — both sides are fp32 dots of unit vectors; only the
    summation order differs.
  * bf16: 1e-5 after the same casts — both sides upcast the same bf16
    values and accumulate in fp32.
  * int8: 1e-4 — the kernel scales after the dot, the oracle dequantizes
    before it (ROADMAP hazard R5).
Indices must be equal, except where the port picked another row whose
reference score lies within the tolerance of the reference's pick.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gallery_match as ref_gm
from repro.kernels import ref as R
from repro_torch.kernels import gallery_match as gm
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as PR

TOL = {"fp32": 1e-5, "bf16": 1e-5, "int8": 1e-4}
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (Q, N, D, k): Q < 8 with N not a multiple of any block and k = 1;
# k > N; one query against one row; the largest k over two query tiles
SHAPES = [(3, 1000, 128, 1), (9, 4, 32, 7), (1, 1, 128, 3),
          (40, 300, 128, 64)]


@pytest.fixture
def pallas_reference(monkeypatch):
    """The reference's Pallas match kernel, in interpret mode.  It names
    ``pltpu.TPUCompilerParams``, which the installed JAX calls
    ``CompilerParams`` (ROADMAP hazard R1): alias it for this test only,
    and drop every jit cache traced under the alias on the way out, so no
    later test in this process sees it."""
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)
    yield
    jax.clear_caches()


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x))          # a writable copy


def _assert_topk(s, i, sr, ir, full, atol):
    """Port (s, i) vs reference (sr, ir); ``full`` is the reference's full
    (Q, N) score matrix, used to accept a tie-equivalent pick."""
    s, i = np.asarray(s, np.float64), np.asarray(i)
    sr, ir = np.asarray(sr, np.float64), np.asarray(ir)
    assert s.shape == sr.shape and i.shape == ir.shape
    np.testing.assert_allclose(s, sr, rtol=0, atol=atol)
    assert np.array_equal(i < 0, ir < 0)              # same sentinels
    rows = np.arange(i.shape[0])[:, None].repeat(i.shape[1], 1)
    live = i >= 0
    picked = np.asarray(full, np.float64)[rows[live], i[live]]
    assert np.all((i == ir)[live] | (np.abs(picked - sr[live]) <= atol))


def _full(q, g):
    return np.asarray(q, np.float64) @ np.asarray(g, np.float64).T


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_fp32_vs_reference(shape):
    Q, N, D, k = shape
    rng = np.random.default_rng(Q * 7919 + N)
    q, g = _unit(rng, Q, D), _unit(rng, N, D)
    s, i = gm.gallery_match_cuda(_t(q), _t(g), k=k)
    sr, ir = R.gallery_match_ref(jnp.asarray(q), jnp.asarray(g), k=k)
    _assert_topk(s.numpy(), i.numpy(), sr, ir, _full(q, g), TOL["fp32"])


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_fused_norm_vs_reference(shape):
    Q, N, D, k = shape
    rng = np.random.default_rng(Q * 31 + N)
    q = rng.normal(size=(Q, D)).astype(np.float32) * 3.0      # raw queries
    g = _unit(rng, N, D)
    s, i = K.gallery_match_fused(_t(q), _t(g), k=k)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    sr, ir = R.gallery_match_ref(jnp.asarray(qn), jnp.asarray(g), k=k)
    _assert_topk(s.numpy(), i.numpy(), sr, ir, _full(qn, g), TOL["fp32"])


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_vs_reference(shape):
    Q, N, D, k = shape
    rng = np.random.default_rng(Q * 131 + N)
    q, g = _unit(rng, Q, D), _unit(rng, N, D)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    s, i = gm.gallery_match_cuda(_t(q), _t(g).to(torch.bfloat16), k=k)
    sr, ir = R.gallery_match_ref(qb, gb, k=k)
    full = _full(np.asarray(qb.astype(jnp.float32)),
                 np.asarray(gb.astype(jnp.float32)))
    _assert_topk(s.numpy(), i.numpy(), sr, ir, full, TOL["bf16"])


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_int8_vs_reference(shape):
    Q, N, D, k = shape
    rng = np.random.default_rng(Q * 17 + N)
    q, g = _unit(rng, Q, D), _unit(rng, N, D)
    g8, scale = ref_gm.quantize_gallery(jnp.asarray(g))
    s, i = K.gallery_match_quant(_t(q), _t(np.asarray(g8)),
                                 _t(np.asarray(scale)), k=k)
    sr, ir = R.gallery_match_quant_ref(jnp.asarray(q), g8, scale, k=k)
    deq = np.asarray(g8, np.float64) * np.asarray(scale, np.float64)[:, None]
    _assert_topk(s.numpy(), i.numpy(), sr, ir, _full(q, deq), TOL["int8"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_exact_ties_go_to_lowest_index(dtype):
    """Small integers make every dot exact, so repeated rows tie exactly;
    the lowest gallery index must win, as in the reference."""
    rng = np.random.default_rng(5)
    base = rng.integers(-2, 3, size=(6, 16)).astype(np.float32)
    g = np.concatenate([base, base, base[::-1]])            # 18 rows
    q = rng.integers(-2, 3, size=(4, 16)).astype(np.float32)
    if dtype == "int8":
        g8 = g.astype(np.int8)
        scale = np.ones(len(g), np.float32)
        s, i = gm.gallery_match_quant_cuda(_t(q), _t(g8), _t(scale), k=10)
        sr, ir = R.gallery_match_quant_ref(jnp.asarray(q), jnp.asarray(g8),
                                           jnp.asarray(scale), k=10)
    else:
        tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
        jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
        s, i = gm.gallery_match_cuda(_t(q), _t(g).to(tdt), k=10)
        sr, ir = R.gallery_match_ref(jnp.asarray(q).astype(jdt),
                                     jnp.asarray(g).astype(jdt), k=10)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_plain_vs_pallas_kernel(pallas_reference, dtype):
    """The reference kernel itself (interpret mode), with its own block
    schedule: 8-row gallery blocks over 11 rows (a ragged last block and a
    top-k carried across blocks), k > N sentinels, Q < 8."""
    Q, N, D, k = 3, 11, 128, 16
    rng = np.random.default_rng(N)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    g = _unit(rng, N, D)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    if dtype == "int8":
        g8, scale = ref_gm.quantize_gallery(jnp.asarray(g))
        sr, ir = ref_gm.gallery_match_quant_pallas(
            jnp.asarray(q), g8, scale, k=k, bn=8, fuse_norm=True,
            interpret=True)
        s, i = K.gallery_match_quant(_t(q), _t(np.asarray(g8)),
                                     _t(np.asarray(scale)), k=k)
        deq = np.asarray(g8, np.float64) * np.asarray(scale)[:, None]
        full = _full(qn, deq)
    else:
        jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
        tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
        gj = jnp.asarray(g).astype(jdt)
        sr, ir = ref_gm.gallery_match_pallas(jnp.asarray(q), gj, k=k, bn=8,
                                             fuse_norm=True, interpret=True)
        s, i = K.gallery_match_fused(_t(q), _t(g).to(tdt), k=k)
        full = _full(qn, np.asarray(gj.astype(jnp.float32)))
    _assert_topk(s.numpy(), i.numpy(), sr, ir, full, TOL[dtype])


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_plan_chooses_path_and_splits(sms, itemsize):
    """The small-Q path for Q <= SMALL_Q and Q * k <= SMALL_QK at D =
    SMALL_D on an aligned gallery, the tiled path otherwise; at least one
    split, and never more splits than the gallery has tiles (or, on the
    small-Q path, than fit on the SMs)."""
    tile_small = gm._SMALL_WARPS * gm._GROUP_BYTES // (gm.SMALL_D * itemsize)
    for Q in range(1, gm.SMALL_Q + 3):
        for k in (1, 4, 8, 32, 64):
            for N in (1, 63, 64, 65, 1000, 1024, 262_144):
                for bps in (1, 2, 3):
                    path, S = gm.plan(Q, k, N, gm.SMALL_D, itemsize, True,
                                      sms, bps)
                    small = Q <= gm.SMALL_Q and Q * k <= gm.SMALL_QK
                    assert path == ("small" if small else "tiled")
                    tiles = -(-N // (tile_small if small else 64))
                    assert 1 <= S <= tiles, (Q, k, N, bps, S)
                    if small:
                        assert S <= bps * sms
                    # another width, or a misaligned gallery: tiled
                    for D, aligned in ((36, True), (256, True),
                                       (gm.SMALL_D, False)):
                        path, S = gm.plan(Q, k, N, D, itemsize, aligned, sms,
                                          bps)
                        assert path == "tiled" and 1 <= S <= -(-N // 64)


def _tied_gallery(rng, N, D):
    """Small-integer rows (exact dots), with row 0 repeated at the edges of
    the small-Q path's 8/16/32-row groups, of the tiled path's 64-row
    tiles, and in the last row."""
    g = rng.integers(-2, 3, size=(N, D)).astype(np.float32)
    for r in (7, 8, 15, 16, 31, 32, 63, 64, N - 1):
        if r < N:
            g[r] = g[0]
    return g


@pytest.mark.parametrize("N", [1, 63, 65])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_plain_vs_reference_at_small_q_edges(dtype, N):
    """Q = 1 .. SMALL_Q + 1 (both paths' query counts) at k = 1, 8 and 64,
    with exact ties across the rows where the kernel's blocks and groups
    would split the gallery: scores and indices equal the reference's."""
    rng = np.random.default_rng(N * 3 + len(dtype))
    g = _tied_gallery(rng, N, gm.SMALL_D)
    for Q in range(1, gm.SMALL_Q + 2):
        q = rng.integers(-2, 3, size=(Q, gm.SMALL_D)).astype(np.float32)
        q[0] = g[0]                                # the tied rows win
        for k in (1, 8, 64):
            if dtype == "int8":
                g8, scale = g.astype(np.int8), np.ones(N, np.float32)
                s, i = gm.gallery_match_quant_cuda(_t(q), _t(g8), _t(scale),
                                                   k=k)
                sr, ir = R.gallery_match_quant_ref(
                    jnp.asarray(q), jnp.asarray(g8), jnp.asarray(scale), k=k)
            else:
                tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
                jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
                s, i = gm.gallery_match_cuda(_t(q), _t(g).to(tdt), k=k)
                sr, ir = R.gallery_match_ref(jnp.asarray(q).astype(jdt),
                                             jnp.asarray(g).astype(jdt), k=k)
            np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
            np.testing.assert_array_equal(i.numpy(), np.asarray(ir))


def _c_params(src: str, name: str) -> list:
    """The parameters of ``name(...) {`` in a C source, as written."""
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{", src)
    assert m, name
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


def test_c_interface_matches_the_wrapper():
    """Each C function of csrc/gallery_match.cu takes as many arguments,
    of the same kinds, as the ctypes signature the wrapper sets (a
    mismatch would only show on the card), and the small-Q path's limits
    in the wrapper are the kernel's."""
    import ctypes
    src = (ROOT / "src/repro_torch/kernels/csrc/gallery_match.cu").read_text()
    kind = {ctypes.c_void_p: "pointer", ctypes.c_int: "int"}
    for name, (args, _) in gm._SIGNATURES.items():
        params = _c_params(src, name)
        assert len(params) == len(args), (name, params)
        for p, a in zip(params, args):
            want = "pointer" if "*" in p else "int"
            assert kind.get(a, "pointer") == want, (name, p, a)
    assert re.search(r"constexpr int kSmallQ = (\d+);", src).group(1) == \
        str(gm.SMALL_Q)
    assert re.search(r"constexpr int kSmallD = (\d+);", src).group(1) == \
        str(gm.SMALL_D)
    assert len(gm._SIGNATURES["gm_match"][0]) == 15
    assert len(gm._SIGNATURES["gm_match_small"][0]) == 16


def test_ops_gallery_match_normalizes_both_sides():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(6, 64)).astype(np.float32) * 2
    g = rng.normal(size=(77, 64)).astype(np.float32) * 5
    s, i = K.gallery_match(_t(q), _t(g), k=4)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    gn = g / np.linalg.norm(g, axis=-1, keepdims=True)
    sr, ir = R.gallery_match_ref(jnp.asarray(qn), jnp.asarray(gn), k=4)
    _assert_topk(s.numpy(), i.numpy(), sr, ir, _full(qn, gn), TOL["fp32"])


@pytest.mark.parametrize("shape", SHAPES)
def test_port_oracles_vs_reference_oracles(shape):
    Q, N, D, k = shape
    rng = np.random.default_rng(Q + N)
    q, g = _unit(rng, Q, D), _unit(rng, N, D)
    s, i = PR.gallery_match_ref(_t(q), _t(g), k=k)
    sr, ir = R.gallery_match_ref(jnp.asarray(q), jnp.asarray(g), k=k)
    _assert_topk(s.numpy(), i.numpy(), sr, ir, _full(q, g), TOL["fp32"])
    g8, scale = ref_gm.quantize_gallery(jnp.asarray(g))
    s, i = PR.gallery_match_quant_ref(_t(q), _t(np.asarray(g8)),
                                      _t(np.asarray(scale)), k=k)
    sr, ir = R.gallery_match_quant_ref(jnp.asarray(q), g8, scale, k=k)
    deq = np.asarray(g8, np.float64) * np.asarray(scale)[:, None]
    _assert_topk(s.numpy(), i.numpy(), sr, ir, _full(q, deq), TOL["fp32"])


@pytest.mark.parametrize("spread", [1.0, 1e-3, 40.0])
def test_quantize_bit_exact(spread):
    rng = np.random.default_rng(int(spread * 1000))
    g = (rng.normal(size=(50, 128)) * spread).astype(np.float32)
    g[0] = 0.0                                  # the 1e-12 scale floor
    g[1, :4] = [127 * 0.5, -127 * 0.5, 0.5, -1.5]   # halves: ties to even
    q8, scale = gm.quantize_gallery(_t(g))
    rq8, rscale = ref_gm.quantize_gallery(jnp.asarray(g))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(rq8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    np.testing.assert_array_equal(
        gm.dequantize_gallery(q8, scale).numpy(),
        np.asarray(ref_gm.dequantize_gallery(rq8, rscale)))
    p8, pscale = K.prepare_gallery_quant(_t(g))
    np.testing.assert_array_equal(p8.numpy(), q8.numpy())


def test_wrapper_checks_and_counts():
    q, g = torch.zeros(2, 8), torch.ones(5, 8)
    before = gm.launches
    gm.gallery_match_cuda(q, g, k=2)
    assert gm.launches == before            # the CPU path launches nothing
    with pytest.raises(ValueError):
        gm.gallery_match_cuda(q, torch.ones(5, 4), k=2)      # D mismatch
    with pytest.raises(ValueError):
        gm.gallery_match_cuda(q, torch.ones(0, 8), k=2)      # empty gallery
    with pytest.raises(ValueError):
        gm.gallery_match_quant_cuda(q, g, torch.ones(5), k=2)  # not int8
    with pytest.raises(ValueError):
        gm.gallery_match_quant_cuda(q, g.to(torch.int8), torch.ones(4), k=2)
    # a device with no kernel raises: there is no fallback to the plain path
    with pytest.raises(ValueError):
        gm.gallery_match_cuda(q.to("meta"), g.to("meta"), k=2)


def _port_modules():
    pkg = ROOT / "src" / "repro_torch"
    out = []
    for p in sorted(pkg.rglob("*.py")):
        parts = ("repro_torch",) + p.relative_to(pkg).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_import_guard_no_jax():
    """Every port module imports with ``jax`` made unimportable, and no
    port source (nor ``chip_smoke.py`` or ``kernel_compare.py``) names
    ``jax`` or ``repro`` in an import."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [k for k in sys.modules if sys.modules[k] is not None\n"
            "       and (k == 'jax' or k.startswith(('jax.', 'repro.')))]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "kernel_compare.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (f, n)


# ---------------------------------------------------------------------------
# any k and any row width: rounds of MAX_K, rows in chunks of MAX_D
# ---------------------------------------------------------------------------
# (Q, N, D, k): two rounds; a ragged second round; k = N + 3 over a gallery
# of several rounds; rows wider than MAX_D; both at once
WIDE_SHAPES = [(3, 200, 128, 65), (2, 300, 128, 100), (4, 197, 64, 200),
               (3, 150, 768, 100), (2, 90, 2048, 5), (1, 70, 600, 1)]


@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_plain_vs_reference_at_any_k_and_width(dtype, shape):
    """k above MAX_K (up to k > N, whose tail holds the sentinels) and D
    above MAX_D: the plain version against the reference's oracle; and the
    first MAX_K entries of each row are the k = MAX_K call's."""
    Q, N, D, k = shape
    rng = np.random.default_rng(Q * 7 + N + D)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    g = _unit(rng, N, D)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    if dtype == "int8":
        g8, scale = ref_gm.quantize_gallery(jnp.asarray(g))
        run = lambda kk: K.gallery_match_quant(          # noqa: E731
            _t(q), _t(np.asarray(g8)), _t(np.asarray(scale)), k=kk)
        sr, ir = R.gallery_match_quant_ref(jnp.asarray(qn), g8, scale, k=k)
        full = _full(qn, np.asarray(g8, np.float64)
                     * np.asarray(scale)[:, None])
    else:
        jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
        tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
        gj = jnp.asarray(g).astype(jdt)
        run = lambda kk: K.gallery_match_fused(          # noqa: E731
            _t(q), _t(g).to(tdt), k=kk)
        # the query in the gallery's dtype, then normalized in fp32
        qj = np.asarray(jnp.asarray(q).astype(jdt).astype(jnp.float32))
        qj = qj / np.linalg.norm(qj, axis=-1, keepdims=True)
        gf = gj.astype(jnp.float32)
        sr, ir = R.gallery_match_ref(jnp.asarray(qj), gf, k=k)
        full = _full(qj, np.asarray(gf))
    s, i = run(k)
    assert s.shape == (Q, k) and i.shape == (Q, k)
    _assert_topk(s.numpy(), i.numpy(), sr, ir, full, TOL[dtype])
    if k > gm.MAX_K:
        s64, i64 = run(gm.MAX_K)
        assert torch.equal(s[:, :gm.MAX_K], s64)
        assert torch.equal(i[:, :gm.MAX_K], i64)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_plain_vs_pallas_kernel_at_large_k_and_width(pallas_reference,
                                                     dtype):
    """The reference kernel (interpret mode), which unrolls any k over a
    (k + BN)-wide block and takes rows of any width: k = 65 and 100 over
    12 blocks of 16 rows, at D = 128 and 768."""
    Q, N = 2, 190
    rng = np.random.default_rng(77)
    for D, k in ((128, 65), (768, 100)):
        q = rng.normal(size=(Q, D)).astype(np.float32)
        g = _unit(rng, N, D)
        qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
        if dtype == "int8":
            g8, scale = ref_gm.quantize_gallery(jnp.asarray(g))
            sr, ir = ref_gm.gallery_match_quant_pallas(
                jnp.asarray(q), g8, scale, k=k, bn=16, fuse_norm=True,
                interpret=True)
            s, i = K.gallery_match_quant(_t(q), _t(np.asarray(g8)),
                                         _t(np.asarray(scale)), k=k)
            full = _full(qn, np.asarray(g8, np.float64)
                         * np.asarray(scale)[:, None])
        else:
            jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
            tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
            gj = jnp.asarray(g).astype(jdt)
            sr, ir = ref_gm.gallery_match_pallas(
                jnp.asarray(q), gj, k=k, bn=16, fuse_norm=True,
                interpret=True)
            s, i = K.gallery_match_fused(_t(q), _t(g).to(tdt), k=k)
            full = _full(np.asarray(jnp.asarray(qn).astype(jdt)
                                    .astype(jnp.float32)),
                         np.asarray(gj.astype(jnp.float32)))
        _assert_topk(s.numpy(), i.numpy(), sr, ir, full, TOL[dtype])


def _rounds_model(s, k, max_k):
    """The kernel's rounds in numpy: round r admits only the rows that
    rank strictly after round r - 1's last entry (score descending, index
    ascending) and keeps the best ``max_k`` of them; a query out of rows
    fills its places with (NEG, -1)."""
    Q, N = s.shape
    out_s = np.full((Q, k), gm.NEG, np.float32)
    out_i = np.full((Q, k), -1, np.int64)
    for qi in range(Q):
        cursor = None
        for c0 in range(0, k, max_k):
            kr = min(max_k, k - c0)
            cand = [(float(s[qi, n]), n) for n in range(N)
                    if cursor is None or (cursor[1] >= 0 and (
                        cursor[0] > s[qi, n] or (cursor[0] == s[qi, n]
                                                 and cursor[1] < n)))]
            cand.sort(key=lambda e: (-e[0], e[1]))
            for j, (sc, n) in enumerate(cand[:kr]):
                out_s[qi, c0 + j], out_i[qi, c0 + j] = sc, n
            cursor = (float(out_s[qi, c0 + kr - 1]),
                      int(out_i[qi, c0 + kr - 1]))
    return out_s, out_i


@pytest.mark.parametrize("max_k", [1, 3, 64])
def test_rounds_after_a_cursor_give_the_sorted_list(max_k):
    """Scores with many exact ties (small integers): rounds of ``max_k``
    after a cursor give the stable descending sort, ties to the lower
    index, neither losing nor repeating a row, with sentinels past N."""
    rng = np.random.default_rng(max_k)
    s = rng.integers(-3, 4, size=(4, 150)).astype(np.float32)
    for k in (1, 64, 65, 150, 153):
        got_s, got_i = _rounds_model(s, k, max_k)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        kk = order.shape[1]
        np.testing.assert_array_equal(got_i[:, :kk], order)
        np.testing.assert_array_equal(
            got_s[:, :kk], np.take_along_axis(s, order, axis=1))
        assert (got_i[:, kk:] == -1).all() and (got_s[:, kk:] == gm.NEG).all()


def test_plan_takes_one_path_for_every_round():
    """Above MAX_K (any Q, N, D, alignment) and above MAX_D the plan never
    raises and takes the tiled path, which every round of the call then
    runs; ``rounds`` covers k in rounds of MAX_K; the small-Q path only
    ever takes one round."""
    for k in (1, 32, 64, 65, 100, 128, 129, 1000, 262_147):
        n = gm.rounds(k)
        assert (n - 1) * gm.MAX_K < k <= n * gm.MAX_K
        for Q in (1, 2, gm.SMALL_Q, 16, 256):
            for D in (128, 512, 513, 768, 2048):
                for aligned in (True, False):
                    path, S = gm.plan(Q, k, 262_144, D, 4, aligned, 132, 2)
                    assert S >= 1
                    if k > gm.MAX_K or D != gm.SMALL_D or not aligned:
                        assert path == "tiled"
                    if path == "small":
                        assert n == 1
