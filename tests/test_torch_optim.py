"""The port's optimizers, quantized state, gradient compression, schedules,
data stream, checkpoint store and microbatch policy vs the JAX reference,
on the CPU.

Both sides get the same numpy inputs (parameters, gradients, trees).
Tolerances:
  * ``quantize`` / ``dequantize``: bit-identical int8 values and scales
    (the same fp32 arithmetic, rounding half to even, then a clip).
  * optimizers, compression, schedules: params, state and rates within
    1e-6 of the reference leaf's largest magnitude after 5 updates (the
    same fp32 ops in the same order; only transcendental functions and
    means may round another way).  int8 state is held after dequantizing.
  * data: bit-identical batches; checkpoint: exact round trips.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as RStore
from repro.configs import base as cb
from repro.data import DataConfig as RDataConfig
from repro.data import TokenStream as RTokenStream
from repro.launch import steps as RSteps
from repro.optim import adafactor as r_adafactor
from repro.optim import adamw as r_adamw
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import constant as r_constant
from repro.optim import cosine_warmup as r_cosine
from repro.optim import dequantize as r_dequantize
from repro.optim import for_config as r_for_config
from repro.optim import param_count as r_param_count
from repro.optim import quantize as r_quantize
from repro.optim.compress import compress_with_feedback as r_compress
from repro.optim.compress import decompress as r_decompress
from repro.optim.compress import init_residual as r_init_residual
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import base as pcb
from repro_torch.data import DataConfig, Prefetcher, TokenStream
from repro_torch.launch import steps as PSteps
from repro_torch.optim import (QTensor, adafactor, adamw, clip_by_global_norm,
                               constant, cosine_warmup, dequantize,
                               for_config, global_norm, param_count, quantize)
from repro_torch.optim.compress import (compress_with_feedback, decompress,
                                        init_residual)
from repro_torch.optim.quant import BLOCK

REL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=REL):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, \
        float(np.abs(got - want).max()) / scale


# ---------------------------------------------------------------------------
# quantized tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1000,), (3, 130), (BLOCK,), (2, 3, 5)])
def test_quantize_matches_reference_bit_for_bit(shape):
    x = (np.random.default_rng(0).normal(size=shape) * 3).astype(np.float32)
    want, got = r_quantize(jnp.asarray(x)), quantize(torch.from_numpy(x))
    assert got.shape == want.shape == shape and got.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(dequantize(got).numpy(),
                                  np.asarray(r_dequantize(want)))
    # blockwise symmetric int8: error <= blockmax / 127
    err = np.abs(dequantize(got).numpy() - x)
    assert err.max() <= np.abs(x).max() / 127 + 1e-6


def test_compression_with_feedback_matches_reference():
    rng = np.random.default_rng(1)
    gs = [{"g": rng.normal(size=(256,)).astype(np.float32),
           "h": rng.normal(size=(3, 50)).astype(np.float32)}
          for _ in range(5)]
    r_res = r_init_residual({k: jnp.asarray(v) for k, v in gs[0].items()})
    p_res = init_residual({k: torch.from_numpy(v) for k, v in gs[0].items()})
    acc, acc_c = 0.0, 0.0
    for g in gs:
        rq, r_res = r_compress({k: jnp.asarray(v) for k, v in g.items()},
                               r_res)
        pq, p_res = compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, p_res)
        for k in g:
            np.testing.assert_array_equal(pq[k].q.numpy(),
                                          np.asarray(rq[k].q))
            _close(p_res[k], r_res[k])
            assert p_res[k].dtype == torch.bfloat16
        r_dec, p_dec = r_decompress(rq), decompress(pq)
        for k in g:
            _close(p_dec[k], r_dec[k])
        acc, acc_c = acc + g["g"], acc_c + p_dec["g"].numpy()
    # the residual keeps the accumulated error bounded (not O(T))
    assert float(np.abs(acc_c - acc).max()) < 0.2


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda m: m.cosine_warmup(1e-3, warmup=10, total=100),
    lambda m: m.cosine_warmup(3e-3, warmup=20, total=60, floor=0.0),
    lambda m: m.constant(0.05)], ids=["cosine", "cosine-floor0", "constant"])
def test_schedules_match_reference(make):
    import repro.optim as R
    import repro_torch.optim as P
    want, got = make(R), make(P)
    for s in (0, 1, 5, 10, 19, 20, 50, 99, 100, 150):
        _close(got(s), want(jnp.int32(s)))


def test_cosine_warmup_shape():
    lr = cosine_warmup(1e-3, warmup=10, total=100)
    vals = [float(lr(s)) for s in [0, 5, 10, 50, 100]]
    assert vals[0] < vals[1] < vals[2]
    assert vals[2] == pytest.approx(1e-3, rel=0.1)
    assert vals[4] < vals[3] < vals[2]


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
SHAPES = {"w": (8, 16), "b": (16,), "s": ()}
OPTS = {
    "adamw": lambda m: m.adamw(m.constant(1e-2), weight_decay=0.1),
    "adamw-cosine-noclip": lambda m: m.adamw(
        m.cosine_warmup(1e-2, warmup=2, total=5), clip=0.0),
    "adamw8": lambda m: m.adamw(m.constant(1e-2), weight_decay=0.1,
                                int8_state=True),
    "adafactor": lambda m: m.adafactor(m.constant(1e-2), weight_decay=0.01),
}


def _state_leaves(tree, prefix=""):
    """{path: fp32 numpy} of an optimizer state, QTensors dequantized."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_state_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, QTensor):
        return {prefix: dequantize(tree).numpy()}
    if hasattr(tree, "scale") and hasattr(tree, "q"):
        return {prefix: np.asarray(r_dequantize(tree))}
    return {prefix: _np(tree)}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_updates_match_reference(name):
    """5 updates on the same numpy gradients: params and state agree."""
    import repro.optim as R
    import repro_torch.optim as P
    rng = np.random.default_rng(3)
    p0 = {k: np.asarray(rng.normal(size=s), np.float32)
          for k, s in SHAPES.items()}
    gs = [{k: np.asarray(rng.normal(size=s) * 0.5, np.float32)
           for k, s in SHAPES.items()} for _ in range(5)]
    ropt, popt = OPTS[name](R), OPTS[name](P)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rst, pst = ropt.init(rp), popt.init(pp)
    for i, g in enumerate(gs):
        rp, rst, rm = ropt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  rst, rp, jnp.int32(i))
        pp2, pst, pm = popt.update({k: torch.from_numpy(v)
                                    for k, v in g.items()}, pst, pp, i)
        assert pp2 is pp                         # updated in place
        _close(pm["grad_norm"], rm["grad_norm"])
        _close(pm["lr"], rm["lr"])
    for k in SHAPES:
        _close(pp[k], rp[k])
    rs, ps = _state_leaves(rst), _state_leaves(pst)
    assert set(rs) == set(ps)
    for k in rs:
        _close(ps[k], rs[k])


@pytest.mark.parametrize("name", [n for n in OPTS if n != "adamw8"])
def test_per_layer_leaves_match_the_reference_stack(name):
    """The reference takes a leaf of 3 or more dims as a stack of layers
    and updates it a layer at a time (``_layer_mapped``: adafactor's
    factors and RMS clip are per layer); the port holds one leaf a layer.
    The reference's (3, 4, 5) stack and the port's three (4, 5) leaves
    give the same parameters and state.  (int8 state is quantized in
    blocks of the whole leaf on both sides, so a stack's blocks and a
    layer's differ: adamw8 is held on leaves of the same shape above.)"""
    import repro.optim as R
    import repro_torch.optim as P
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(3, 4, 5)).astype(np.float32)
    gs = [rng.normal(size=(3, 4, 5)).astype(np.float32) for _ in range(5)]
    ropt, popt = OPTS[name](R), OPTS[name](P)
    rp = {"e": jnp.asarray(p0)}
    pp = {f"e{i}": torch.from_numpy(p0[i].copy()) for i in range(3)}
    rst, pst = ropt.init(rp), popt.init(pp)
    for i, g in enumerate(gs):
        rp, rst, _ = ropt.update({"e": jnp.asarray(g)}, rst, rp,
                                 jnp.int32(i))
        popt.update({f"e{j}": torch.from_numpy(g[j]) for j in range(3)},
                    pst, pp, i)
    for j in range(3):
        _close(pp[f"e{j}"], np.asarray(rp["e"])[j])
    rs, ps = _state_leaves(rst), _state_leaves(pst)
    for k, v in rs.items():
        for j in range(3):
            _close(ps[k.replace("/e", f"/e{j}")], v[j])


def _quadratic():
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])
    params = {"w": torch.zeros(4), "b": torch.zeros(())}

    def loss(p):
        return torch.sum((p["w"] - target) ** 2) + (p["b"] - 1.0) ** 2
    return params, loss


@pytest.mark.parametrize("make", [
    lambda: adamw(constant(0.05), weight_decay=0.0),
    lambda: adamw(constant(0.05), weight_decay=0.0, int8_state=True),
    lambda: adafactor(constant(0.5)),
], ids=["adamw", "adamw8", "adafactor"])
def test_optimizers_descend(make):
    """The reference's descent case (``tests/test_optim.py``) on the port."""
    params, loss = _quadratic()
    opt = make()
    st = opt.init(params)
    l0 = float(loss(params))
    for i in range(60):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        g = dict(zip(p, torch.autograd.grad(loss(p), list(p.values()))))
        params, st, _ = opt.update(g, st, params, i)
    assert float(loss(params)) < 0.05 * l0


def test_optimizer_takes_a_module_and_skips_frozen_leaves():
    lin = torch.nn.Linear(4, 3)
    lin.bias.requires_grad_(False)
    opt = adamw(constant(0.1))
    st = opt.init(lin)
    assert set(st["m"]) == {"weight"}
    w0, b0 = lin.weight.detach().clone(), lin.bias.detach().clone()
    opt.update({"weight": torch.ones(3, 4)}, st, lin, 0)
    assert not torch.equal(lin.weight, w0) and torch.equal(lin.bias, b0)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(4)
    g = {k: np.asarray(rng.normal(size=s) * 3, np.float32)
         for k, s in SHAPES.items()}
    rg, rn = r_clip({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    pg, pn = clip_by_global_norm({k: torch.from_numpy(v)
                                  for k, v in g.items()}, 1.0)
    _close(pn, rn)
    _close(global_norm(pg), 1.0)
    for k in g:
        _close(pg[k], rg[k])


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_param_count_and_policy_match_reference(arch):
    cfg, pcfg = cb.get(arch), pcb.get(arch)
    assert param_count(pcfg) == r_param_count(cfg)
    assert for_config(pcfg).name == r_for_config(cfg).name
    assert PSteps.grad_accum_dtype(pcfg) == {
        jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
        RSteps.grad_accum_dtype(cfg)]
    for B, S in ((256, 4096), (16, 2048), (4, 2048), (8, 128)):
        assert PSteps.auto_microbatches(pcfg, B, S) == \
            RSteps.auto_microbatches(cfg, B, S, 1)


def test_auto_microbatches_of_the_chip_cells():
    """The two models the card trains: tinyllama at 16 x 2048 and zamba2
    at 4 x 2048 both take 2 microbatches."""
    assert PSteps.auto_microbatches(pcb.get("tinyllama-1.1b"), 16,
                                    2048) == 2
    assert PSteps.auto_microbatches(pcb.get("zamba2-2.7b"), 4, 2048) == 2


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(seed=7, vocab_size=100, seq_len=32, global_batch=8, n_shards=2,
         shard=1),
    dict(seed=1, vocab_size=32000, seq_len=64, global_batch=4)])
def test_token_stream_is_the_reference_bit_for_bit(kw):
    want, got = RTokenStream(RDataConfig(**kw)), TokenStream(DataConfig(**kw))
    for step in (0, 5, 123):
        a, b = want.batch_at(step), got.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert got.batch_at(5)["tokens"].shape == (
        kw["global_batch"] // kw.get("n_shards", 1), kw["seq_len"])


def test_prefetcher_resumes_at_step_and_joins():
    c = DataConfig(seed=1, vocab_size=50, seq_len=16, global_batch=2)
    src = TokenStream(c)
    pf = Prefetcher(src, start_step=100, depth=2)
    for want in (100, 101, 102):
        step, batch = pf.next()
        assert step == want
        np.testing.assert_array_equal(batch["tokens"],
                                      src.batch_at(want)["tokens"])
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() >= 1


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)},
            "l": [torch.zeros(2, dtype=torch.bfloat16)]}
    for step in (10, 20, 30):
        store.save(step, {"a": tree["a"] + step, "b": {"c": tree["b"]["c"]
                                                          + step},
                          "l": [tree["l"][0] + step]}, block=True)
    assert store.steps() == [20, 30] and store.save_count == 3
    step, got = store.restore(tree)
    assert step == 30
    assert torch.equal(got["a"], tree["a"] + 30)
    assert torch.equal(got["b"]["c"], tree["b"]["c"] + 30)
    assert got["l"][0].dtype == torch.bfloat16
    assert torch.equal(got["l"][0], tree["l"][0] + 30)
    assert store.restore(tree, step=20)[1]["a"][0, 0] == 20


def test_checkpoint_snapshots_the_values_at_save(tmp_path):
    """Values are copied under the caller: an in-place update right after
    ``save`` does not reach the checkpoint."""
    store = CheckpointStore(str(tmp_path))
    w = torch.ones(1000)
    store.save(1, {"w": w})
    w.add_(1.0)
    store.wait()
    assert torch.equal(store.restore({"w": w})[1]["w"], torch.ones(1000))


def test_checkpoint_quantized_state_roundtrip(tmp_path):
    q = quantize(torch.from_numpy(
        np.random.default_rng(5).normal(size=(3, 70)).astype(np.float32)))
    store = CheckpointStore(str(tmp_path))
    store.save(4, {"o": {"m": {"w": q}}}, block=True)
    like = {"o": {"m": {"w": quantize(torch.zeros(3, 70))}}}
    step, got = store.restore(like)
    g = got["o"]["m"]["w"]
    assert step == 4 and isinstance(g, QTensor) and g.shape == (3, 70)
    assert torch.equal(g.q, q.q) and torch.equal(g.scale, q.scale)


def test_checkpoint_crash_mid_save_never_corrupts(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.ones(8)}
    store.save(1, tree, block=True)
    # a crash mid-save: a stale temp dir with garbage, never committed
    bad = tmp_path / ".tmp-2-999"
    bad.mkdir()
    (bad / "shards.pt").write_bytes(b"garbage")
    step, got = store.restore(tree)
    assert step == 1 and torch.equal(got["w"], tree["w"])
    with pytest.raises(KeyError, match="missing"):
        store.restore({"w": tree["w"], "v": torch.ones(2)})


def test_checkpoint_save_failure_is_raised(tmp_path, monkeypatch):
    """A write that fails on the background thread raises in ``wait``,
    and nothing is committed."""
    store = CheckpointStore(str(tmp_path))

    def broken(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(torch, "save", broken)
    store.save(2, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="save failed"):
        store.wait()
    assert store.steps() == [] and store.save_count == 0


def test_checkpoint_empty_store_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path)).restore({"w": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        RStore(str(tmp_path / "r")).restore({"w": jnp.ones(1)})
