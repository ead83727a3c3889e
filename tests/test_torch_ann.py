"""The port's two-level ANN tier vs the JAX reference, on the CPU.

Here ``cell_rescore_cuda`` takes its plain PyTorch path (the tensors lie on
the CPU); the CUDA kernel itself is held against that plain path on the
card by ``chip_smoke.py``.  Inputs are made from a seed with numpy and
handed to both sides.  The oracle is the reference's Pallas rescore kernel
in interpret mode (``pallas_reference``), its jnp oracles
(``repro.kernels.ref``) and its host-side codebook and layout code.

Tolerances (max abs score error): 1e-5 in every dtype.  Both sides are
fp32 dots of unit vectors after the same casts (bf16 cells cast the query
to bf16; int8 scales after the dot on both sides), so only the summation
order differs.  Positions and labels must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bus import SharedBus as RefSharedBus
from repro.bus import calibrated as ref_calibrated
from repro.crypto import SecureGallery as RefGallery
from repro.data import FrameStream as RefFrameStream
from repro.kernels import ann_match as RA
from repro.kernels import ref as R
from repro.launch import serve as ref_serve
from repro.runtime import StreamEngine as RefStreamEngine
from repro_torch import convert
from repro_torch.crypto import SecureGallery
from repro_torch.kernels import ann_match as A
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as PR
from repro_torch.launch import serve

TOL = 1e-5
DTYPES = ("fp32", "bf16", "int8")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_reference(monkeypatch):
    """The reference's Pallas kernels, in interpret mode.  They name
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


def _t(x):
    return torch.from_numpy(np.array(x))          # a writable copy


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _cells(gn, layout, dtype):
    """Packed cells in the storage dtype, for both sides:
    (reference cells, reference scale, port cells, port scale)."""
    if dtype == "int8":
        q8, scale = RA.pack_cells_quant(gn, layout)
        return (jnp.asarray(q8), jnp.asarray(scale), _t(q8), _t(scale))
    packed = A.pack_cells(gn, layout)
    if dtype == "bf16":
        return (jnp.asarray(packed).astype(jnp.bfloat16), None,
                _t(packed).to(torch.bfloat16), None)
    return jnp.asarray(packed), None, _t(packed), None


def _rescore_both(q, gn, layout, ids, dtype, k):
    """(port scores, port positions, reference scores, reference
    positions) of one rescore, the reference's Pallas kernel in interpret
    mode."""
    rc, rs, pc, ps = _cells(gn, layout, dtype)
    sr, pr = RA.cell_rescore_pallas(
        jnp.asarray(q), rc, jnp.asarray(ids), jnp.asarray(layout.cell_lens),
        rs, k=k, L=layout.L, interpret=True)
    if dtype == "int8":
        s, p = K.cell_rescore_quant(_t(q), pc, ps, _t(ids),
                                    _t(layout.cell_lens), k=k, L=layout.L)
    else:
        s, p = K.cell_rescore(_t(q), pc, _t(ids), _t(layout.cell_lens), k=k,
                              L=layout.L)
    return s.numpy(), p.numpy(), np.asarray(sr), np.asarray(pr)


def _assert_same(s, p, sr, pr):
    assert s.shape == sr.shape and p.shape == pr.shape
    np.testing.assert_allclose(s, sr, rtol=0, atol=TOL)
    np.testing.assert_array_equal(p, pr)


# ---------------------------------------------------------------------------
# the rescore's plain version vs the reference's Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_rescore_plain_vs_pallas_kernel(pallas_reference, dtype):
    """Ragged cells from a real codebook, raw (unnormalized) queries
    probing their top-4 of 12 cells, k = 5."""
    rng = np.random.default_rng(5)
    N, D, Q, n_cells, c, k = 300, 32, 7, 12, 4, 5
    gn = _normed(rng, N, D)
    q = 3.0 * (gn[rng.integers(0, N, Q)]
               + 0.05 * rng.normal(size=(Q, D)).astype(np.float32))
    cent = A.kmeans_lite(gn, n_cells, seed=1)
    layout = A.build_cell_layout(A.assign_cells(gn, cent), n_cells)
    ids = np.argsort(-(q @ cent.T), axis=1, kind="stable")[:, :c]
    _assert_same(*_rescore_both(q, gn, layout, ids.astype(np.int32),
                                dtype, k))


def _tie_layout(rng, D=16):
    """Eight ragged cells of unit rows (two empty), where rows 0-2 of cell
    5 and of cell 2 are the same three rows, and cell 2 repeats its row 0
    at row 3.  Equal rows score exactly equal on either side."""
    base = _normed(rng, 4, D)
    lens = np.array([3, 0, 4, 2, 1, 3, 2, 0], np.int32)
    L = 8
    cells = _normed(rng, len(lens) * L, D)
    cells[5 * L:5 * L + 3] = base[:3]
    cells[2 * L:2 * L + 3] = base[:3]
    cells[2 * L + 3] = base[0]
    assign = np.repeat(np.arange(len(lens)), lens)
    layout = A.CellLayout(perm=np.arange(len(assign)),
                          pos_to_row=np.full(len(lens) * L, -1),
                          cell_lens=lens, L=L)
    for cell in range(len(lens)):
        layout.pos_to_row[cell * L:cell * L + lens[cell]] = \
            np.nonzero(assign == cell)[0]
    gn = np.zeros((len(assign), D), np.float32)
    occ = layout.pos_to_row >= 0
    gn[layout.pos_to_row[occ]] = cells[occ]
    return gn, layout, base


@pytest.mark.parametrize("dtype", DTYPES)
def test_rescore_cross_cell_ties_go_to_the_earlier_slot(pallas_reference,
                                                        dtype):
    """Equal scores in two probed cells: the earlier probe slot wins, then
    the lower row in the cell — the reference kernel's order, which is not
    its oracle's lowest-position order."""
    rng = np.random.default_rng(11)
    gn, layout, base = _tie_layout(rng)
    q = np.stack([base[0], base[1], -base[2]])
    ids = np.array([[5, 2, 0], [2, 5, 3], [6, 5, 2]], np.int32)
    s, p, sr, pr = _rescore_both(q, gn, layout, ids, dtype, k=6)
    _assert_same(s, p, sr, pr)
    L = layout.L
    assert p[0, 0] == 5 * L + 0 and p[0, 1] == 2 * L + 0     # slot 0 first
    assert p[0, 2] == 2 * L + 3                              # then its row 3
    assert p[1, 0] == 2 * L + 1 and p[1, 1] == 5 * L + 1
    if dtype == "fp32":          # the oracle ranks by padded position
        _, por = R.cell_rescore_ref(jnp.asarray(q), jnp.asarray(
            A.pack_cells(gn, layout)), jnp.asarray(ids),
            jnp.asarray(layout.cell_lens), k=6, L=L)
        assert np.asarray(por)[0, 0] == 2 * L + 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edge", ["c_exceeds_cells", "k_exceeds_probed",
                                  "empty_cells"])
def test_rescore_edges_vs_pallas_kernel(pallas_reference, edge, dtype):
    """-1 probes (c > K), k beyond the probed rows, probes of empty cells:
    every unfilled slot is (NEG, -1), never a stale position."""
    rng = np.random.default_rng(6)
    gn, layout, _ = _tie_layout(rng)
    q = rng.normal(size=(3, gn.shape[1])).astype(np.float32)
    if edge == "c_exceeds_cells":
        ids = np.array([[3, 0, -1, -1, -1, -1, -1, -1, -1, -1],
                        [5, 2, 6, 4, 3, 0, 7, 1, -1, -1],
                        [-1] * 10], np.int32)
        k = 4
    elif edge == "k_exceeds_probed":
        ids = np.array([[3, 4], [4, 6], [0, 3]], np.int32)
        k = 9
    else:
        ids = np.array([[1, 7], [7, 4], [1, 2]], np.int32)
        k = 3
    s, p, sr, pr = _rescore_both(q, gn, layout, ids, dtype, k)
    _assert_same(s, p, sr, pr)
    assert np.all((p < 0) == (s == A.NEG))
    n_probed = [sum(layout.cell_lens[c] for c in row if c >= 0)
                for row in ids]
    for i, n in enumerate(n_probed):
        assert np.all(p[i, min(n, k):] == -1)
        assert np.all(p[i, :min(n, k)] >= 0)


# ---------------------------------------------------------------------------
# the port's oracles and host-side layout code vs the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Q,N,D,n_cells,c,k", [
    (7, 300, 32, 12, 4, 5), (3, 40, 16, 5, 8, 3), (9, 400, 24, 16, 5, 60)])
def test_port_ann_oracles_vs_reference_oracles(Q, N, D, n_cells, c, k):
    rng = np.random.default_rng(Q * N)
    gn = _normed(rng, N, D)
    q = gn[rng.integers(0, N, Q)] + \
        0.05 * rng.normal(size=(Q, D)).astype(np.float32)
    cent = RA.kmeans_lite(gn, n_cells, seed=2)
    assign = RA.assign_cells(gn, cent)
    layout = RA.build_cell_layout(assign, n_cells)
    packed = RA.pack_cells(gn, layout)
    s, i = PR.centroid_topc_ref(_t(q), _t(cent), c=c)
    sr, ir = R.centroid_topc_ref(jnp.asarray(q), jnp.asarray(cent), c=c)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=0, atol=TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    s, p = PR.cell_rescore_ref(_t(q), _t(packed), i, _t(layout.cell_lens),
                               k=k, L=layout.L)
    sr, pr = R.cell_rescore_ref(jnp.asarray(q), jnp.asarray(packed), ir,
                                jnp.asarray(layout.cell_lens), k=k,
                                L=layout.L)
    _assert_same(s.numpy(), p.numpy(), np.asarray(sr), np.asarray(pr))
    s, r = PR.ann_match_ref(_t(q), _t(gn), _t(cent), _t(assign), nprobe=c,
                            k=k)
    sr, rr = R.ann_match_ref(jnp.asarray(q), jnp.asarray(gn),
                             jnp.asarray(cent), jnp.asarray(assign),
                             nprobe=c, k=k)
    _assert_same(s.numpy(), r.numpy(), np.asarray(sr), np.asarray(rr))


@pytest.mark.parametrize("N,D,n_cells", [(300, 32, 12), (17, 16, 17),
                                         (200, 24, 40), (5, 8, 9)])
def test_host_layout_bit_equal(N, D, n_cells):
    """Codebook, assignments, layouts and packed arrays (fp32 and int8)
    come out bit-identical to the reference's on the same rows."""
    rng = np.random.default_rng(N + n_cells)
    gn = _normed(rng, N, D)
    cent = A.kmeans_lite(gn, n_cells, seed=3)
    np.testing.assert_array_equal(cent, RA.kmeans_lite(gn, n_cells, seed=3))
    raw = rng.normal(size=(N, D)).astype(np.float32) * 4.0
    assign = A.assign_cells(raw, cent)
    np.testing.assert_array_equal(assign, RA.assign_cells(raw, cent))
    layout = A.build_cell_layout(assign, len(cent))
    ref = RA.build_cell_layout(assign, len(cent))
    assert layout.L == ref.L
    for f in ("perm", "pos_to_row", "cell_lens"):
        np.testing.assert_array_equal(getattr(layout, f), getattr(ref, f))
    np.testing.assert_array_equal(A.pack_cells(gn, layout),
                                  RA.pack_cells(gn, ref))
    q8, scale = A.pack_cells_quant(gn, layout)
    rq8, rscale = RA.pack_cells_quant(gn, ref)
    np.testing.assert_array_equal(q8, np.asarray(rq8))
    np.testing.assert_array_equal(scale, np.asarray(rscale))


def test_two_levels_equal_the_flat_ann_oracle():
    """coarse scan -> rescore -> pos_to_row equals the flat-gallery
    two-level oracle (same probes, exact scores, same row ids)."""
    rng = np.random.default_rng(7)
    N, D, Q, n_cells, c, k = 400, 24, 9, 16, 5, 4
    gn = _normed(rng, N, D)
    q = gn[rng.integers(0, N, Q)] + \
        0.03 * rng.normal(size=(Q, D)).astype(np.float32)
    cent = A.kmeans_lite(gn, n_cells, seed=2)
    assign = A.assign_cells(gn, cent)
    layout = A.build_cell_layout(assign, n_cells)
    _, ids = K.centroid_topc(_t(q), _t(cent), c=c)
    s, pos = K.cell_rescore(_t(q), _t(A.pack_cells(gn, layout)), ids,
                            _t(layout.cell_lens), k=k, L=layout.L)
    sr, rowsr = PR.ann_match_ref(_t(q), _t(gn), _t(cent), _t(assign),
                                 nprobe=c, k=k)
    pos = pos.numpy()
    rows = np.where(pos >= 0, layout.pos_to_row[np.clip(pos, 0, None)], -1)
    np.testing.assert_allclose(s.numpy(), sr.numpy(), rtol=0, atol=TOL)
    np.testing.assert_array_equal(rows, rowsr.numpy())


def test_rescore_wrapper_checks_and_counts():
    rng = np.random.default_rng(3)
    cells = _t(_normed(rng, 4 * 8, 16))
    lens = torch.tensor([8, 3, 0, 5], dtype=torch.int32)
    q, ids = torch.ones(2, 16), torch.tensor([[0, 3], [1, -1]])
    before = A.launches
    s, p = A.cell_rescore_cuda(q, cells, ids, lens, k=2, L=8)
    assert A.launches == before             # the CPU path launches nothing
    assert s.dtype == torch.float32 and p.dtype == torch.int32
    with pytest.raises(ValueError):
        A.cell_rescore_cuda(q, cells, ids, lens, k=2, L=7)   # not K*L rows
    with pytest.raises(ValueError):
        A.cell_rescore_cuda(q[:, :8], cells, ids, lens, k=2, L=8)   # D
    with pytest.raises(ValueError):
        A.cell_rescore_cuda(q, cells, ids[:1], lens, k=2, L=8)  # Q mismatch
    with pytest.raises(ValueError):                 # int8 with fp64 scales
        A.cell_rescore_cuda(q, cells.to(torch.int8), ids, lens,
                            torch.ones(32, dtype=torch.float64), k=2, L=8)
    with pytest.raises(ValueError):                 # scales on fp32 cells
        A.cell_rescore_cuda(q, cells, ids, lens, torch.ones(32), k=2, L=8)
    # a device with no kernel raises: there is no fallback to the plain path
    with pytest.raises(ValueError):
        A.cell_rescore_cuda(q.to("meta"), cells.to("meta"), ids.to("meta"),
                            lens.to("meta"), k=2, L=8)


def test_kernel_builds_hash_their_shared_header(tmp_path, monkeypatch):
    """Each kernel's library is keyed by its source and every header it
    includes: an edit to the header both kernels share names a new
    library for both, an edit to one kernel only for that one."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("gallery_match", "cell_rescore")
    for name in names:
        assert [p.name for p in _build._sources(name)] == \
            [f"{name}.cu", "match_common.cuh"]
    before = {n: _build.target(n) for n in names}
    header = csrc / "match_common.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {n: _build.target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "cell_rescore.cu"
    src.write_text(src.read_text() + "// edited\n")
    assert _build.target("cell_rescore") != after["cell_rescore"]
    assert _build.target("gallery_match") == after["gallery_match"]


# ---------------------------------------------------------------------------
# SecureGallery's ANN tier vs the reference's
# ---------------------------------------------------------------------------
class _Tracer:
    def __init__(self):
        self.instants = []

    def clock(self):
        return 1.5

    def instant(self, kind, t, **kw):
        self.instants.append((kind, t, kw))


def _enrollments(rng):
    raw = rng.normal(size=(90, 128)).astype(np.float32)
    return raw, [(raw[:40], [f"pool{i}" for i in range(40)], None),
                 (raw[40:62], [f"a{i}" for i in range(22)], "a"),
                 (raw[62:], [f"b{i}" for i in range(28)], "b")]


def _assert_same_match(ref, port, q, **kw):
    lab, sc = ref.match(jnp.asarray(q), mode="ann", **kw)
    plab, psc = port.match(torch.from_numpy(q), mode="ann", **kw)
    assert np.array_equal(plab, lab), (plab, lab)
    np.testing.assert_allclose(psc.numpy(), np.asarray(sc), rtol=0, atol=TOL)
    assert port.last_match_stats == ref.last_match_stats


@pytest.mark.parametrize("dtype", DTYPES)
def test_secure_gallery_ann_lifecycle_matches_reference(pallas_reference,
                                                        dtype):
    """Build, incremental enroll, rekey, reshard, failover, seal and the
    tenant-scoped ANN match, under the same rotation Q: labels equal,
    scores within 1e-5, and the scan accounting, ANN maintenance counters
    and metrics equal."""
    rng = np.random.default_rng(31)
    raw, enrolls = _enrollments(rng)
    ref = RefGallery(128, n_shards=2, match_dtype=dtype)
    for r, labels, tenant in enrolls[:2]:
        ref.enroll(r, labels, tenant=tenant)
    port = convert.gallery(np.asarray(ref.rotation._q()), enrolls[:2],
                           n_shards=2, match_dtype=dtype, device="cpu")
    ref.tracer, port.tracer = _Tracer(), _Tracer()
    ref.build_ann_index(n_cells=7)
    port.build_ann_index(n_cells=7)
    assert port.ann_indexed and port.tracer.instants == ref.tracer.instants
    np.testing.assert_array_equal(port._ann_assign, ref._ann_assign)
    # noisy re-captures of enrolled rows, plus strangers
    q = np.concatenate([raw[::9] + 0.1 * rng.normal(size=(10, 128)),
                        rng.normal(size=(2, 128))]).astype(np.float32)

    def check(tenant="a"):
        _assert_same_match(ref, port, q, k=3, nprobe=2)
        _assert_same_match(ref, port, q, k=3, nprobe=3, tenant=tenant)

    _assert_same_match(ref, port, q, k=1, nprobe=99)      # every cell
    check()
    r, labels, tenant = enrolls[2]                 # joins existing cells
    ref.enroll(r, labels, tenant=tenant)
    port.enroll(r, labels, tenant=tenant)
    check("b")
    ref.rekey(99)
    port.rekey(99, rotation=np.asarray(ref.rotation._q()))
    check()
    ref.reshard(3), port.reshard(3)
    check()
    assert ref.failover_shard(0) == port.failover_shard(0)
    check()
    ref.seal(), port.seal()
    assert port._ann_codebook is None and not port._ann_dev
    check()
    assert port.ann_stats == ref.ann_stats
    assert port.ann_stats["trainings"] == 1
    assert port.metrics() == ref.metrics()


def test_ann_before_index_raises():
    store = SecureGallery(8, seed=1, device="cpu")
    store.enroll(np.eye(4, 8, dtype=np.float32), list(range(4)))
    assert not store.ann_indexed
    with pytest.raises(ValueError, match="build_ann_index"):
        store.match(np.eye(1, 8, dtype=np.float32), k=1, mode="ann")


def test_ann_scan_fraction_is_small_and_labels_exact():
    """2048 rows in 64 cells, 4 probes: far fewer rows scored than the
    exact scan, and the enrolled rows are found again."""
    rng = np.random.default_rng(22)
    D, n = 32, 2048
    g = rng.normal(size=(n, D)).astype(np.float32)
    store = SecureGallery(D, seed=8, n_shards=2, device="cpu")
    store.enroll(g, list(range(n)))
    store.build_ann_index(n_cells=64)
    pick = rng.integers(0, n, 16)
    lab, _ = store.match(g[pick] + 0.02 * rng.normal(size=(16, D))
                         .astype(np.float32), k=1, mode="ann", nprobe=4)
    st = store.last_match_stats
    assert st["mode"] == "ann" and st["centroid_rows"] == 64
    assert st["rows_scored"] < 0.25 * n
    assert list(lab[:, 0]) == list(pick)


# ---------------------------------------------------------------------------
# run_biometric(match_mode="ann") vs the reference's scenario
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_weights():
    """The reference's seed-0 pipeline weights, converted, and its
    gallery's rotation Q."""
    reg, gallery = ref_serve.build_biometric_pipeline(seed=0)
    det, emb = reg.slots[0].cartridge, reg.slots[2].cartridge
    for c in (det, emb):
        c.load()
    params = convert.pipeline_params(
        np.asarray(det.params),
        {k: np.asarray(v) for k, v in emb.params.items()})
    return params, np.asarray(gallery.rotation._q())


def _reference_ann_scenario(n_frames, nprobe):
    """The reference's recipe for serving the ANN tier
    (``WatchlistCartridge``'s docstring): build the pipeline in ANN mode,
    enroll, build the index, then the same feed as ``run_biometric``."""
    reg, gallery = ref_serve.build_biometric_pipeline(match_mode="ann",
                                                      nprobe=nprobe)
    src = RefFrameStream(seed=3)
    gallery.enroll(ref_serve._pipeline_embed(reg, src, range(10)),
                   [f"subject{i}" for i in range(10)])
    gallery.build_ann_index()
    eng = RefStreamEngine(reg, RefSharedBus(ref_calibrated("ncs2")),
                          execute_payloads=True)
    eng.feed(n_frames, interval_s=0.12,
             payload_fn=lambda i: jnp.asarray(src.frame_at(i % 10)))
    eng.schedule_remove(1.0, slot=1)
    rep = eng.run(until=60)
    return rep, reg.slots[3].cartridge.stats["hits"], gallery


@pytest.mark.parametrize("nprobe", [1, 8])
def test_run_biometric_ann_matches_reference(pallas_reference,
                                             reference_weights, nprobe,
                                             capsys):
    params, q_rot = reference_weights
    ref, ref_hits, ref_gallery = _reference_ann_scenario(12, nprobe)
    port = serve.run_biometric(n_frames=12, hotswap=True, device="cpu",
                               match_mode="ann", nprobe=nprobe,
                               params=params, rotation=q_rot)
    line = capsys.readouterr().out
    assert f"hits={ref_hits} " in line
    assert port.to_json() == ref.to_json()
    assert ref_gallery.last_match_stats["mode"] == "ann"


# ---------------------------------------------------------------------------
# any k, nprobe and row width: rounds of MAX_K, rows in chunks of MAX_D
# ---------------------------------------------------------------------------
def _probed(rng, N, D, Q, n_cells, c):
    """Unit rows in a real codebook's cells, and raw queries probing their
    top-c cells: (queries, rows, layout, probe table, centroids)."""
    gn = _normed(rng, N, D)
    q = 3.0 * (gn[rng.integers(0, N, Q)]
               + 0.05 * rng.normal(size=(Q, D)).astype(np.float32))
    cent = A.kmeans_lite(gn, n_cells, seed=1)
    layout = A.build_cell_layout(A.assign_cells(gn, cent), n_cells)
    ids = np.argsort(-(q @ cent.T), axis=1, kind="stable")[:, :c]
    return q, gn, layout, ids.astype(np.int32), cent


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,D,n_cells,c,k", [
    (400, 32, 12, 4, 65), (400, 32, 12, 6, 100), (600, 16, 80, 70, 20),
    (150, 768, 6, 3, 100)])
def test_rescore_plain_vs_pallas_kernel_at_any_k_nprobe_and_width(
        pallas_reference, dtype, N, D, n_cells, c, k):
    """k above MAX_K, more than MAX_K probes (past a warp's lanes twice)
    and rows wider than MAX_D: the plain version against the reference's
    Pallas kernel, positions equal."""
    rng = np.random.default_rng(N + D + c + k)
    q, gn, layout, ids, _ = _probed(rng, N, D, 2, n_cells, c)
    _assert_same(*_rescore_both(q, gn, layout, ids, dtype, k))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rescore_past_the_probed_rows_and_the_first_rounds(dtype):
    """k = N + 3 (past every probed row: the tail holds the sentinels)
    against the reference's oracle, on tie-free rows: the oracle scores
    the query as the port does (cast to the cells' dtype, normalized in
    fp32) against the cells in fp32 (int8 dequantized first, so within
    1e-4, hazard R5, and a position may differ only between rows scored
    within that); and the first MAX_K entries of a k > MAX_K call are the
    k = MAX_K call's."""
    rng = np.random.default_rng(11)
    N, D = 300, 24
    q, gn, layout, ids, _ = _probed(rng, N, D, 3, 10, 5)
    rc, rs, pc, ps = _cells(gn, layout, dtype)
    lens = _t(layout.cell_lens)
    if dtype == "int8":
        run = lambda kk: K.cell_rescore_quant(         # noqa: E731
            _t(q), pc, ps, _t(ids), lens, k=kk, L=layout.L)
        cells = np.asarray(rc, np.float32) * np.asarray(rs)[:, None]
    else:
        run = lambda kk: K.cell_rescore(               # noqa: E731
            _t(q), pc, _t(ids), lens, k=kk, L=layout.L)
        cells = np.asarray(rc.astype(jnp.float32))
    qc = q if dtype != "bf16" else \
        np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    qn = qc / np.linalg.norm(qc, axis=-1, keepdims=True)
    k = N + 3
    s, p = run(k)
    sr, pr = R.cell_rescore_ref(jnp.asarray(qn), jnp.asarray(cells),
                                jnp.asarray(ids),
                                jnp.asarray(layout.cell_lens), k=k,
                                L=layout.L)
    sr, pr = np.asarray(sr), np.asarray(pr)
    tol = 1e-4 if dtype == "int8" else TOL
    np.testing.assert_allclose(s.numpy(), sr, rtol=0, atol=tol)
    p = p.numpy()
    assert np.array_equal(p < 0, pr < 0) and (p[:, -3:] == -1).all()
    live = p >= 0
    picked = np.einsum("qd,qkd->qk", qn, cells[np.clip(p, 0, None)])
    assert np.all((p == pr)[live] | (np.abs(picked - sr)[live] <= tol))
    s64, p64 = run(A.MAX_K)
    assert torch.equal(s[:, :A.MAX_K], s64)
    assert np.array_equal(p[:, :A.MAX_K], p64.numpy())


def test_coarse_scan_takes_more_than_max_k_probes():
    """``centroid_topc`` at c above MAX_K (and above K: sentinels) equals
    the reference's oracle on the normalized queries."""
    rng = np.random.default_rng(3)
    cent = _normed(rng, 90, 32)
    q = 3.0 * _normed(rng, 4, 32)
    for c in (65, 90, 100):
        s, i = K.centroid_topc(_t(q), _t(cent), c=c)
        sr, ir = R.centroid_topc_ref(jnp.asarray(q / 3.0), jnp.asarray(cent),
                                     c=c)
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ir))


def test_rescore_plan_takes_one_path_for_every_round():
    """Above MAX_K, or at rows other than FUSED_D wide (above MAX_D too),
    the plan never raises and takes the two-pass path, which every round
    of the call then runs; at most MAX_K over aligned 128-wide rows, the
    fused path in one round."""
    for k in (1, 5, 64, 65, 100, 1000, 262_147):
        for Q, c in ((1, 8), (16, 128), (256, 16)):
            for D in (128, 512, 768, 2048):
                for aligned in (True, False):
                    plan = A.plan(Q, c, 376, D, 4, aligned, 132, k)
                    fused = k <= A.MAX_K and D == A.FUSED_D and aligned
                    assert plan[0] == ("fused" if fused else "two_pass")
                    assert plan[4] >= 1
                    assert A.rounds(k) == -(-k // A.MAX_K)
