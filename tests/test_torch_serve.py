"""The port's biometric serving path vs the JAX reference, on the CPU.

Each stage runs on the reference's weights, carried across by
``repro_torch.convert``; the gallery runs under the reference gallery's
rotation Q.  Frames come from the shared numpy ``FrameStream``.

The reference's match wrappers reach its Pallas kernel, which does not
run on the installed JAX (ROADMAP hazard R1).  ``reference_match`` points
them, for one test, at the reference's own jnp oracle
(``repro.kernels.ref``) with the kernel's fused query normalization and
dtype casts.

Tolerances: detector crops equal; quality <= 1e-6 and embeddings <= 1e-5
(fp32 convolutions summed in another order); match scores <= 1e-5 with
equal labels (fp32 dots of unit vectors; the int8 oracle dequantizes
before the dot where the port scales after it, a relative change of a
few ulp); engine reports byte-identical.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import SecureGallery as RefGallery
from repro.data import FrameStream
from repro.kernels import ops as ref_ops
from repro.kernels import ref as R
from repro.launch import serve as ref_serve
from repro_torch import convert
from repro_torch.crypto import SecureGallery
from repro_torch.device import resolve_device
from repro_torch.launch import serve

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_match(monkeypatch):
    def _norm(q):
        q = q.astype(jnp.float32)
        return q * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(q * q, axis=-1, keepdims=True), 1e-18))

    def fused(q, gn, *, k=5, **_):
        if gn.dtype == jnp.bfloat16:
            q = q.astype(jnp.bfloat16)
        return R.gallery_match_ref(_norm(q), gn, k=k)

    def quant(q, g_q, g_scale, *, k=5, **_):
        return R.gallery_match_quant_ref(_norm(q), g_q, g_scale, k=k)

    monkeypatch.setattr(ref_ops, "gallery_match_fused", fused)
    monkeypatch.setattr(ref_ops, "gallery_match_quant", quant)


@pytest.fixture(scope="module")
def reference_pipeline():
    """The reference's seed-0 pipeline and the same weights converted."""
    reg, gallery = ref_serve.build_biometric_pipeline(seed=0)
    det, qual, emb = (reg.slots[i].cartridge for i in range(3))
    for c in (det, qual, emb):
        c.load()
    params = convert.pipeline_params(
        np.asarray(det.params),
        {k: np.asarray(v) for k, v in emb.params.items()})
    return reg, np.asarray(gallery.rotation._q()), params


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        SecureGallery(128)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_biometric_pipeline()


def test_stages_match_reference(reference_pipeline):
    reg, q_rot, params = reference_pipeline
    det, qual, emb = (reg.slots[i].cartridge for i in range(3))
    preg, _ = serve.build_biometric_pipeline(device="cpu", params=params,
                                             rotation=q_rot)
    pdet, pqual, pemb = (preg.slots[i].cartridge for i in range(3))
    src = FrameStream(seed=3)
    for i in range(4):
        frame = src.frame_at(i)
        crop = np.asarray(det._fn(det.params, jnp.asarray(frame)))
        with torch.no_grad():
            pcrop = pdet.fn(pdet.params, torch.from_numpy(frame)).numpy()
            np.testing.assert_array_equal(pcrop, crop)
            good = np.asarray(qual._fn(qual.params, jnp.asarray(crop)))
            pgood = pqual.fn(pqual.params, torch.tensor(crop)).numpy()
            np.testing.assert_allclose(pgood, good, rtol=0, atol=1e-6)
            e = np.asarray(emb._fn(emb.params, jnp.asarray(good)))
            pe = pemb.fn(pemb.params, torch.tensor(good)).numpy()
        np.testing.assert_allclose(pe, e, rtol=0, atol=TOL)
    # the whole offline enrollment path agrees too
    want = ref_serve._pipeline_embed(reg, src, range(10))
    got = serve._pipeline_embed(preg, src, range(10)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_conv_same_padding_matches_reference_odd_and_even():
    """JAX "SAME" at stride 2 pads (0, 1) on an even size, (1, 1) on an
    odd one (ROADMAP hazard R2)."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    for hw in ((10, 12), (9, 7)):
        x = rng.normal(size=(1, *hw, 3)).astype(np.float32)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        got = serve._conv_same_s2(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  convert.conv_weight(w))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=TOL)


def _enrollments(rng):
    raw = rng.normal(size=(60, 128)).astype(np.float32)
    return raw, [(raw[:24], [f"pool{i}" for i in range(24)], None),
                 (raw[24:42], [f"a{i}" for i in range(18)], "a"),
                 (raw[42:], [f"b{i}" for i in range(18)], "b")]


def _assert_same_match(ref, port, q, **kw):
    lab, sc = ref.match(jnp.asarray(q), **kw)
    plab, psc = port.match(torch.from_numpy(q), **kw)
    assert isinstance(psc, torch.Tensor)
    assert np.array_equal(plab, lab), (plab, lab)
    np.testing.assert_allclose(psc.numpy(), np.asarray(sc), rtol=0, atol=TOL)
    assert port.last_match_stats["rows_scored"] == \
        ref.last_match_stats["rows_scored"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_secure_gallery_matches_reference(reference_match, dtype):
    """Exact match under the same Q, across tenants, reshard, rekey,
    failover and seal."""
    rng = np.random.default_rng(21)
    raw, enrolls = _enrollments(rng)
    ref = RefGallery(128, n_shards=3, match_dtype=dtype)
    for r, labels, tenant in enrolls:
        ref.enroll(r, labels, tenant=tenant)
    port = convert.gallery(np.asarray(ref.rotation._q()), enrolls,
                           n_shards=3, match_dtype=dtype, device="cpu")
    assert port.shard_sizes() == ref.shard_sizes()
    assert port.tenant_rows() == ref.tenant_rows()
    # noisy re-captures of enrolled rows, plus strangers
    q = np.concatenate([raw[::5] + 0.1 * rng.normal(size=(12, 128)),
                        rng.normal(size=(3, 128))]).astype(np.float32)

    def check():
        for k in (1, 100):                     # 100 > rows: clamped
            _assert_same_match(ref, port, q, k=k)
        _assert_same_match(ref, port, q, k=3, tenant="a")

    check()
    ref.reshard(2), port.reshard(2)
    check()
    ref.rekey(99)
    port.rekey(99, rotation=np.asarray(ref.rotation._q()))
    check()
    assert ref.failover_shard(0) == port.failover_shard(0)
    assert port.shard_sizes() == ref.shard_sizes()
    ref.seal(), port.seal()
    check()
    assert port.metrics() == ref.metrics()


@pytest.mark.parametrize("factory", ["make_detector", "make_quality",
                                     "make_embedder"])
def test_stage_factories_default_to_the_card(factory):
    """``device=None`` is the card, as for every other entry point: on a
    host without one the factory raises as ``resolve_device`` does, and
    ``device="cpu"`` still builds the stage."""
    make = getattr(serve, factory)
    if torch.cuda.is_available():
        assert make(torch.Generator()).torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError) as want:
            resolve_device(None)
        with pytest.raises(RuntimeError) as got:
            make(torch.Generator())
        assert str(got.value) == str(want.value)
    cart = make(torch.Generator().manual_seed(0), device="cpu")
    assert cart.torch_device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in cart.params.parameters())


def _serve_line(out: str, tag: str) -> str:
    return next(line for line in out.splitlines() if line.startswith(tag))


def test_run_biometric_matches_reference(reference_match, reference_pipeline,
                                         capsys):
    _, q_rot, params = reference_pipeline
    ref = ref_serve.run_biometric(n_frames=12, hotswap=True)
    ref_line = _serve_line(capsys.readouterr().out, "[serve]")
    port = serve.run_biometric(n_frames=12, hotswap=True, device="cpu",
                               params=params, rotation=q_rot)
    line = _serve_line(capsys.readouterr().out, "[serve]")
    # frames, losses, hits, mean latency and downtime, as printed
    assert line == ref_line
    assert re.search(r"hits=12 ", line)
    assert port.to_json() == ref.to_json()


def test_run_fleet_matches_reference(reference_match, reference_pipeline,
                                     capsys):
    _, q_rot, params = reference_pipeline
    ref = ref_serve.run_fleet(duration_s=0.25)
    ref_out = capsys.readouterr().out
    port = serve.run_fleet(duration_s=0.25, device="cpu", params=params,
                           rotation=q_rot)
    out = capsys.readouterr().out
    assert out == ref_out              # hits and the per-tenant ledger
    assert port.frontdoor == ref.frontdoor
    assert port.to_json() == ref.to_json()
    for row in port.frontdoor["tenants"].values():
        assert row["offered"] == row["admitted"] + row["shed"] + row["queued"]
