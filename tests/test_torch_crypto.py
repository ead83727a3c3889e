"""The port's key material against the JAX reference's, on the CPU.

The reference draws its cipher key, its keystream and its rotation's
Gaussian from ``jax.random`` (Threefry-2x32); the port draws the same bits
in torch integer ops (``repro_torch.crypto.templates``).  Held here:

* ``prng_key`` equal to ``jax.random.PRNGKey``;
* ``_keystream`` bit-identical to ``jax.random.bits`` (JAX's partitionable
  counters, which the installed JAX uses: guarded below);
* the normal draws within 1e-6 of ``jax.random.normal`` (the same bits and
  uniform; the erf^-1 is XLA's polynomial, whose log1p and sqrt may round
  otherwise: 7.2e-7 measured) and Q within 2e-6 of the reference's (the QR
  of those, on another LAPACK path: 9.1e-7 measured);
* blobs interoperating both ways, a reference gallery's shards and ANN
  codebook decrypted by the port byte for byte;
* the port's gallery on the reference's seed and rows, with no rotation
  handed across: labels equal to the reference's and scores within 1e-5
  (both fp32 dots of unit rows, Q within 2e-6), before and after
  ``rekey(99)``.  The reference's match runs through ``repro.kernels.ref``
  (its Pallas path is dead on this JAX, hazard R1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import SecureGallery as RefGallery
from repro.crypto import templates as RT
from repro.kernels import ops as ref_ops
from repro.kernels import ref as R
from repro_torch.crypto import SecureGallery
from repro_torch.crypto import templates as T

SEEDS = [7 ^ 0x5EC2E7, 99 ^ 0x5EC2E7, 0, 2**63 - 1]
NORMAL_TOL = 1e-6
Q_TOL = 2e-6
SCORE_TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5, 2**63 - 1])
def test_prng_key_is_jax_prngkey(seed):
    assert T.prng_key(seed) == tuple(
        int(w) for w in np.asarray(jax.random.PRNGKey(seed)))


def test_jax_uses_partitionable_threefry():
    """The counters ``_keystream`` follows are those of
    ``jax_threefry_partitionable`` (the default of the installed JAX)."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("n", [1, 2, 3, 5, 1_000_003])
@pytest.mark.parametrize("seed", SEEDS)
def test_keystream_is_jax_random_bits(seed, n):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (n,),
                                      jnp.uint32))
    got = T._keystream(T.prng_key(seed), n)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [7, 3, 99])
def test_normal_draws_and_rotation_are_the_references(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (128, 128),
                                        jnp.float32))
    got = T._normal(T.prng_key(seed), (128, 128))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_TOL)
    q = T.KeyedRotation(128, seed).q()
    np.testing.assert_allclose(q.numpy(),
                               np.asarray(RT.KeyedRotation(128, seed)._q()),
                               rtol=0, atol=Q_TOL)


def test_erf_inv_edges():
    """XLA's polynomial on both of its branches, and +-1 to +-inf."""
    x = torch.tensor([0.0, 0.5, -0.9, 0.999999, -1.0, 1.0])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = T._erf_inv32(x).numpy()
    assert np.isinf(got[-2:]).all() and np.array_equal(got[-2:], want[-2:])
    np.testing.assert_allclose(got[:-2], want[:-2], rtol=2e-6, atol=0)


def test_blobs_interoperate_both_ways():
    key = 7 ^ 0x5EC2E7
    x = np.random.default_rng(0).normal(size=(33, 7)).astype(np.float32)
    ref_enc = RT.encrypt_array(jax.random.PRNGKey(key), x)
    port_enc = T.encrypt_array(T.prng_key(key), x)
    assert np.array_equal(port_enc["blob"], ref_enc["blob"])
    assert np.array_equal(T.decrypt_array(T.prng_key(key), ref_enc), x)
    assert np.array_equal(RT.decrypt_array(jax.random.PRNGKey(key),
                                           port_enc), x)
    data = b"subject-4711:watchlist-alpha!"
    assert T.decrypt_bytes(T.prng_key(key), RT.encrypt_bytes(
        jax.random.PRNGKey(key), data)) == data


@pytest.fixture
def reference_match(monkeypatch):
    """The reference gallery's match through ``repro.kernels.ref``."""
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


def _enroll_both(rng):
    """A reference gallery and the port's (dim 128, seed 7, two shards),
    each with the same three enrolls: an untagged pool and two tenants."""
    raw = rng.normal(size=(60, 128)).astype(np.float32)
    enrolls = [(raw[:24], [f"pool{i}" for i in range(24)], None),
               (raw[24:42], [f"a{i}" for i in range(18)], "a"),
               (raw[42:], [f"b{i}" for i in range(18)], "b")]
    ref = RefGallery(128, seed=7, n_shards=2)
    port = SecureGallery(128, seed=7, n_shards=2, device="cpu")
    for r, labels, tenant in enrolls:
        ref.enroll(r, labels, tenant=tenant)
        port.enroll(r, labels, tenant=tenant)
    return raw, ref, port


def test_port_decrypts_a_reference_gallery():
    """Every shard blob and the ANN codebook blob of a reference gallery,
    decrypted under the port's key for the same seed: the reference's
    protected rows and codebook, byte for byte."""
    _, ref, port = _enroll_both(np.random.default_rng(5))
    ref.build_ann_index(n_cells=6)
    assert port._cipher_key == tuple(
        int(w) for w in np.asarray(ref._cipher_key))
    for s in range(ref.n_shards):
        want = RT.decrypt_array(ref._cipher_key, ref._shards[s])
        got = port._decrypt(ref._shards[s])
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert len(want) == len(ref._shard_ids[s]) > 0
    got = port._decrypt(ref._ann_blob)
    assert got.tobytes() == np.asarray(ref._ann_codebook).tobytes()


def test_port_gallery_matches_the_reference_on_its_seed(reference_match):
    rng = np.random.default_rng(21)
    raw, ref, port = _enroll_both(rng)
    q = np.concatenate([raw[::5] + 0.1 * rng.normal(size=(12, 128)),
                        rng.normal(size=(3, 128))]).astype(np.float32)

    def check():
        for kw in ({"k": 1}, {"k": 5}, {"k": 3, "tenant": "a"}):
            lab, sc = ref.match(jnp.asarray(q), **kw)
            plab, psc = port.match(torch.from_numpy(q), **kw)
            assert np.array_equal(plab, lab), (kw, plab, lab)
            np.testing.assert_allclose(psc.numpy(), np.asarray(sc), rtol=0,
                                       atol=SCORE_TOL)

    np.testing.assert_allclose(port.rotation.q().numpy(),
                               np.asarray(ref.rotation._q()), rtol=0,
                               atol=Q_TOL)
    check()
    ref.rekey(99)
    port.rekey(99)
    assert port._cipher_key == tuple(
        int(w) for w in np.asarray(ref._cipher_key))
    check()
