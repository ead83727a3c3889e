"""The port's host-side runtime vs the JAX reference, on the CPU.

The engine, bus, front door and the rest of ``runtime/`` are copied into
``repro_torch`` with their imports repointed, so the port runs on a host
without JAX.  They hold no tensor math, and so must replay the reference
exactly: ``EngineReport.to_json()`` is compared byte for byte.  The
message framing, cartridge lifecycle and template crypto are ports, held
to the reference's behaviour (byte counts exact; no tolerances here).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bus import TABLE1 as REF_TABLE1
from repro.core import messages as ref_msg
from repro.data import FrameStream as RefFrameStream
from repro.runtime import replication as ref_rep
from repro.runtime.faults import FaultPlan as RefFaultPlan
from repro_torch.core import cartridge as pc
from repro_torch.core import messages as pmsg
from repro_torch.crypto import (KeyedRotation, cosine_scores, decrypt_array,
                                decrypt_bytes, encrypt_array, encrypt_bytes)
from repro_torch.data import FrameStream
from repro_torch.runtime import replication as port_rep
from repro_torch.runtime.faults import FaultPlan


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- engine replay: byte-identical reports ------------------------------------
TABLE1_CASES = [(dev, n) for dev in sorted(REF_TABLE1)
                for n in (1, len(REF_TABLE1[dev]))]


@pytest.mark.parametrize("device,n", TABLE1_CASES)
def test_table1_broadcast_report_byte_identical(device, n):
    ref = ref_rep.run_replicated(device, n, "broadcast", 120)
    port = port_rep.run_replicated(device, n, "broadcast", 120)
    assert port.to_json() == ref.to_json()


def _storm(plan_cls, rep_mod, seed):
    plan = plan_cls.storm(
        seed=seed, horizon_s=2.0, lanes=rep_mod.chaos_lane_names(),
        hubs=(0, 1), links=((0, 1),), crash_rate=4.0, hang_rate=2.0,
        hub_loss_rate=0.5, link_down_rate=1.0, corrupt_p=0.05)
    return rep_mod.run_chaos(plan, n_bursts=40)


def test_chaos_storm_seed11_report_byte_identical():
    ref = _storm(RefFaultPlan, ref_rep, 11)
    port = _storm(FaultPlan, port_rep, 11)
    assert ref.frames_out == ref.frames_in          # the storm did real work
    assert ref.faults["injected"] > 0
    assert port.to_json() == ref.to_json()


def test_fleet_engine_report_byte_identical():
    ref = ref_rep.run_fleet_sweep(2.0, duration_s=2.0)
    port = port_rep.run_fleet_sweep(2.0, duration_s=2.0)
    assert port.to_json() == ref.to_json()


# -- message framing ------------------------------------------------------------
def _payload_pairs():
    rng = np.random.default_rng(0)
    frame = rng.random((224, 224, 3)).astype(np.float32)
    emb = rng.random(128).astype(np.float32)
    return [
        (jnp.asarray(frame), torch.from_numpy(frame)),
        (jnp.asarray(emb).astype(jnp.bfloat16),
         torch.from_numpy(emb).to(torch.bfloat16)),
        ({"label": "subject3", "score": 0.93},
         {"label": "subject3", "score": 0.93}),
        ({"label": None, "score": np.float32(0.5)},
         {"label": None, "score": np.float32(0.5)}),
        ((jnp.zeros((4, 5), jnp.int32), b"abc", None),
         (torch.zeros((4, 5), dtype=torch.int32), b"abc", None)),
        ([np.zeros((3, 2), np.int8), "xy", 7],
         [np.zeros((3, 2), np.int8), "xy", 7]),
    ]


@pytest.mark.parametrize("case", range(6))
def test_message_nbytes_matches_reference(case):
    ref_payload, port_payload = _payload_pairs()[case]
    want = ref_msg.Message(ref_msg.IMAGE_FRAME, 0, ref_payload).nbytes()
    got = pmsg.Message(pmsg.IMAGE_FRAME, 0, port_payload).nbytes()
    assert got == want
    if case == 0:
        assert got == 602112          # one 224x224x3 fp32 frame


def test_message_spec_accepts_like_reference():
    a = pmsg.MessageSpec(pmsg.FACE_CROPS, (64, 64, 3), np.float32)
    assert a.accepts(pmsg.MessageSpec(pmsg.FACE_CROPS, (None, 64, 3)))
    assert not a.accepts(pmsg.MessageSpec(pmsg.FACE_CROPS, (32, 64, 3)))
    assert not a.accepts(pmsg.MessageSpec(pmsg.EMBEDDING))
    m = pmsg.Message(pmsg.EMBEDDING, 3, torch.zeros(2), meta={"x": 1})
    m2 = m.with_payload({"label": "a"}, pmsg.MATCH_RESULT)
    assert (m2.kind, m2.seq, m2.meta) == (pmsg.MATCH_RESULT, 3, {"x": 1})


# -- cartridges -------------------------------------------------------------------
def _cart(name="infer", **kw):
    spec = pmsg.MessageSpec(pmsg.EMBEDDING, (4,), np.float32)
    return pc.FnCartridge(name, lambda p, x: x * p, spec, spec, params=2.0,
                          capability_id=7,
                          device=pc.DeviceModel(service_s=0.01), **kw)


def test_cartridge_load_process_eager():
    c = _cart()
    assert c.load() >= 0.0
    ex = c.example_input()
    assert isinstance(ex, torch.Tensor) and ex.dtype == torch.float32
    assert tuple(ex.shape) == (4,) and ex.device.type == "cpu"
    out = c.process(pmsg.Message(pmsg.EMBEDDING, 1, torch.ones(4)))
    assert torch.equal(out.payload, torch.full((4,), 2.0))
    assert c.stats["processed"] == 1


def test_clone_shares_params_distinct_identity():
    primary = _cart()
    primary.params = {"w": 1}
    r1, r2 = primary.clone(), primary.clone()
    assert (r1.name, r2.name) == ("infer#r1", "infer#r2")
    assert r1.params is primary.params
    assert r1.device is not primary.device and r1.device == primary.device
    assert r1.stats is not primary.stats
    assert r1.torch_device == primary.torch_device
    coral = pc.DeviceModel(name="coral", service_s=0.02)
    r3 = primary.clone(device=coral)
    assert r3.device == coral and r3.device is not coral


def test_passthrough_bridges_unchanged():
    spec = pmsg.MessageSpec(pmsg.FACE_CROPS)
    p = pc.PassThrough(spec)
    assert p.load() == 0.0
    m = pmsg.Message(pmsg.FACE_CROPS, 0, torch.ones(2))
    assert p.process(m) is m
    assert p.stats["processed"] == 1


def test_frame_stream_matches_reference():
    for i in (0, 7, 29):
        np.testing.assert_array_equal(FrameStream(seed=3).frame_at(i),
                                      RefFrameStream(seed=3).frame_at(i))


# -- template crypto --------------------------------------------------------------
def test_rotation_orthogonal_deterministic_and_explicit():
    rot = KeyedRotation(128, seed=3)
    q = rot.q()
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(128), atol=1e-5)
    assert torch.equal(q, KeyedRotation(128, seed=3).q())
    assert not torch.equal(q, KeyedRotation(128, seed=4).q())
    explicit = KeyedRotation(128, seed=99, q=q.numpy())
    assert torch.equal(explicit.q(), q)
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(7, 128)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(30, 128)).astype(np.float32))
    np.testing.assert_allclose(
        cosine_scores(rot.protect(a), rot.protect(b)).numpy(),
        cosine_scores(a, b).numpy(), atol=2e-5)
    np.testing.assert_allclose(rot.unprotect(rot.protect(a)).numpy(),
                               a.numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        KeyedRotation(64, seed=0, q=np.eye(32))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 1001])
def test_stream_cipher_roundtrip_and_diffusion(n):
    data = (b"subject-4711:watchlist-alpha" * 40)[:n]
    enc = encrypt_bytes(42, data)
    assert decrypt_bytes(42, enc) == data
    if n >= 100:
        overlap = np.mean(enc[:n] == np.frombuffer(data, np.uint8))
        assert overlap < 0.05
        assert decrypt_bytes(43, enc) != data
    # counter mode: a longer message's keystream extends a shorter one's
    zeros = encrypt_bytes(42, bytes(n + 8))
    assert np.array_equal(zeros[:n], encrypt_bytes(42, bytes(n))[:n])


def test_encrypt_array_roundtrip():
    x = np.random.default_rng(0).normal(size=(13, 8)).astype(np.float32)
    enc = encrypt_array(7, x)
    out = decrypt_array(7, enc)
    np.testing.assert_array_equal(out, x)
    assert out.dtype == x.dtype and copy.deepcopy(enc)["shape"] == x.shape
