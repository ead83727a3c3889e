"""The port's LM training path vs the JAX reference, on the CPU.

Here the kernel wrappers take their plain paths (the tensors lie on the
CPU), and ``FlashAttention`` / ``MambaSSD`` differentiate them with the
plain backward they also use on the card; ``chip_smoke.py`` phase 12 holds
the kernels' forwards inside a training step on the card.  Inputs and
batches are made from a seed with numpy; weights are the reference's
(``init_params`` with a fixed key), carried across by ``convert.lm_params``.

Oracles and tolerances (fp32 on both sides; only summation orders and
transcendental functions round differently):
  * the flash and SSD Functions' gradients vs ``jax.grad`` of the
    reference's jnp attention (``flash_attention_jnp``, ``plain_attention``)
    and ``ssd_chunked``: each gradient within 1e-5 of its norm (relative
    Frobenius); vs autograd of the port's own plain versions: equal.
  * every smoke arch: the loss within 1e-5 relative of
    ``jax.value_and_grad(loss_fn)``'s, each parameter's gradient within
    1e-3 of the reference leaf's norm (relative Frobenius; the readings
    are 1e-7 to 2e-5, the largest on a Mamba-2 layer's ``A_log``).
  * the train step at n_micro 1 and 2 vs the reference's: the loss of each
    of 5 steps within 1e-4 relative, and the gradient norm.
  * ``train.main`` with a simulated failure: the final loss within 1e-3 of
    a clean run's (the reference's ``test_train_recovers_from_failure``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import base as cb
from repro.data import DataConfig as RDataConfig
from repro.data import TokenStream as RTokenStream
from repro.launch import steps as RSteps
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as rm
from repro.models import ssm as RS
from repro.optim import adamw as r_adamw
from repro.optim import cosine_warmup as r_cosine
from repro.sharding import init_params
from repro_torch import convert
from repro_torch.configs import base as pcb
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba2_ssd as SSD
from repro_torch.kernels import ops
from repro_torch.launch import steps as PSteps
from repro_torch.launch import train
from repro_torch.models import layers as PL
from repro_torch.models import model as pm
from repro_torch.models import moe as PMoE
from repro_torch.models.params import trainable
from repro_torch.optim import adamw, constant, cosine_warmup

GRAD_REL = 1e-5        # a kernel's gradients vs jax.grad
LOSS_REL = 1e-5        # a model's loss vs the reference's
LEAF_REL = 1e-3        # each parameter's gradient vs the reference's
STEP_REL = 1e-4        # train-step loss trajectories
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def _rel(got, want):
    """|got - want|_F / |want|_F, both as fp32 numpy."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------
FLASH = [  # B, H, Kh, Sq, Sk, D, Dv, causal, window
    (2, 4, 2, 64, 64, 16, 16, True, 0),          # causal GQA
    (1, 4, 4, 96, 96, 16, 16, True, 24),         # sliding window
    (2, 4, 2, 24, 40, 16, 16, False, 0),         # non-causal, Sq != Sk
    (2, 4, 4, 48, 48, 24, 16, True, 0),          # the smoke MLA, 24 / 16
    (1, 2, 1, 2048, 2048, 16, 16, True, 0),      # the reference's flash path
]


def _ref_attention(q, k, v, causal, window):
    """The reference's training attention on (B, S, H, D) inputs: its
    chunked flash at S >= 2048 (as ``gqa_fwd`` takes it), else the plain
    attention with the masks written out."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = D ** -0.5
    if causal and not window and Sq >= 2048:
        return RA.flash_attention_jnp(q, k, v, scale, causal=True)
    qp, kp = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    m = jnp.ones((Sq, Sk), bool)
    if causal:
        m &= qp >= kp
    if window:
        m &= qp - kp < window
    return RA.plain_attention(q, k, v, m[None, None, None], scale)


@pytest.mark.parametrize("shape", FLASH, ids=str)
def test_flash_function_grads_match_jax(shape):
    Bq, H, Kh, Sq, Sk, D, Dv, causal, window = shape
    rng = np.random.default_rng(Sq + D)
    q = (rng.normal(size=(Bq, Sq, H, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(Bq, Sk, Kh, D)) * 0.5).astype(np.float32)
    v = rng.normal(size=(Bq, Sk, Kh, Dv)).astype(np.float32)
    w = rng.normal(size=(Bq, Sq, H, Dv)).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(
        _ref_attention(q, k, v, causal, window) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # the port's layout: (B, H, S, D) views of the model's (B, S, H, D)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = FA.flash_attention_cuda(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2), causal=causal,
                                window=window)
    assert o.grad_fn is not None and "FlashAttention" in o.grad_fn.name()
    got = torch.autograd.grad(torch.sum(o.transpose(1, 2) * _t(w)),
                              (tq, tk, tv))
    for g, r in zip(got, want):
        assert _rel(g, r) <= GRAD_REL


@pytest.mark.parametrize("shape", FLASH[:4], ids=str)
def test_flash_function_is_the_plain_versions_gradient(shape):
    """The Function's backward equals autograd through
    ``flash_attention_plain`` (and, for a head-dim pair the kernel pads,
    through the pad, the plain version at the padded dims and the cut);
    taken a block of queries at a time it agrees to rounding."""
    Bq, H, Kh, Sq, Sk, D, Dv, causal, window = shape
    g = torch.Generator().manual_seed(0)
    q = torch.randn(Bq, H, Sq, D, generator=g, requires_grad=True)
    k = torch.randn(Bq, Kh, Sk, D, generator=g, requires_grad=True)
    v = torch.randn(Bq, Kh, Sk, Dv, generator=g, requires_grad=True)
    do = torch.randn(Bq, H, Sq, Dv, generator=g)
    kw = dict(causal=causal, window=window)
    got = torch.autograd.grad(FA.flash_attention_cuda(q, k, v, **kw),
                              (q, k, v), do)
    want = torch.autograd.grad(FA.flash_attention_plain(q, k, v, **kw),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    P, Pv = FA.padded_head_dims(D, Dv)
    padded = FA.flash_attention_plain(
        F.pad(q, (0, P - D)), F.pad(k, (0, P - D)), F.pad(v, (0, Pv - Dv)),
        scale=D ** -0.5, **kw)[..., :Dv]
    for a, b in zip(got, torch.autograd.grad(padded, (q, k, v), do)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    saved = FA.PLAIN_SCORE_BYTES
    FA.PLAIN_SCORE_BYTES = H * Sk * 4 * 7         # blocks of 7 queries
    try:
        blocks = FA.flash_attention_backward(q, k, v, do, **kw)
    finally:
        FA.PLAIN_SCORE_BYTES = saved
    for a, b in zip(blocks, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_flash_without_grad_skips_the_function():
    q = torch.randn(1, 2, 8, 16)
    o = FA.flash_attention_cuda(q, q, q)
    assert o.grad_fn is None
    with torch.no_grad():
        assert FA.flash_attention_cuda(q.requires_grad_(), q, q).grad_fn \
            is None


SSD_SHAPES = [(2, 64, 3, 8, 4, 16), (1, 512, 2, 16, 16, 256)]  # Bt L H P N c


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_function_grads_match_jax(shape):
    Bt, L, H, P, N, chunk = shape
    rng = np.random.default_rng(L)
    x = rng.normal(size=(Bt, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(Bt, L, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(Bt, L, N)).astype(np.float32)
    Cm = rng.normal(size=(Bt, L, N)).astype(np.float32)
    w = rng.normal(size=(Bt, L, H, P)).astype(np.float32)
    ins = (x, dt, A, Bm, Cm)
    want = jax.grad(lambda *a: jnp.sum(RS.ssd_chunked(*a, chunk=chunk)[0]
                                       * w), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, ins))
    tin = [_t(a, True) for a in ins]
    y, state = SSD.mamba2_ssd_cuda(*tin, chunk=chunk)
    assert "MambaSSD" in y.grad_fn.name() and not state.requires_grad
    got = torch.autograd.grad(torch.sum(y * _t(w)), tin)
    for g, r in zip(got, want):
        assert _rel(g, r) <= GRAD_REL
    # and the plain version's own autograd gives the same
    plain = torch.autograd.grad(torch.sum(SSD.mamba2_ssd_plain(
        *tin, chunk=chunk)[0] * _t(w)), tin)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the cross-entropy losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_softmax_xent_matches_reference(fused, masked):
    """``softmax_xent`` on the logits x @ W.T, and ``softmax_xent_fused``
    (unembed and CE in chunks of 16 over 37 positions, so with a remainder
    chunk), with and without a mask: the loss within LOSS_REL of the
    reference's, the gradients for x and W within GRAD_REL of jax.grad's."""
    rng = np.random.default_rng(5 + 2 * fused + masked)
    Bx, Sx, d, V = 2, 37, 16, 50
    x = rng.normal(size=(Bx, Sx, d)).astype(np.float32)
    W = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (Bx, Sx)).astype(np.int32)
    mask = (rng.random((Bx, Sx)) < 0.7).astype(np.float32) if masked \
        else None

    def loss(xent, x, W, labels, mask):
        if fused:
            return xent({"tok": W}, x, labels, mask, chunk=16)
        return xent(x @ W.T, labels, mask)

    fns = (RL.softmax_xent_fused, PL.softmax_xent_fused) if fused else \
        (RL.softmax_xent, PL.softmax_xent)
    jm = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(
        lambda x, W: loss(fns[0], x, W, jnp.asarray(labels), jm),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(W))
    tx, tW = _t(x, True), _t(W, True)
    got = loss(fns[1], tx, tW, _t(labels), None if mask is None
               else _t(mask))
    got_g = torch.autograd.grad(got, (tx, tW))
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_REL)
    for g, r in zip(got_g, want_g):
        assert _rel(g, r) <= GRAD_REL


# ---------------------------------------------------------------------------
# every smoke arch: loss and gradients vs jax.value_and_grad(loss_fn)
# ---------------------------------------------------------------------------
def _batch(cfg, seed=0, Bb=B, Ss=S):
    """tokens, labels (and the vlm's patches or the audio family's frames)
    from a seed with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (Bb, Ss + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        b["patches"] = rng.normal(
            size=(Bb, cfg.n_patches, cfg.vit_dim)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.normal(
            size=(Bb, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return b


def _models(arch, **replace):
    cfg = cb.smoke(arch).replace(**replace)
    pcfg = pcb.smoke(arch).replace(**replace)
    params = init_params(rm.param_specs(cfg), jax.random.PRNGKey(0),
                         jnp.float32)
    lm = trainable(convert.lm_params(pcfg, jax.tree.map(np.asarray, params)))
    return cfg, pcfg, params, lm


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_loss_and_every_gradient_match_reference(arch):
    cfg, pcfg, params, lm = _models(arch)
    b = _batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, bb: rm.loss_fn(p, cfg, bb), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: _t(v) for k, v in b.items()}
    ploss, pmetrics = pm.loss_fn(lm, pcfg, tb)
    ploss.backward()
    ploss = ploss.detach()
    assert abs(float(ploss) - float(loss)) <= LOSS_REL * abs(float(loss))
    assert set(pmetrics) == set(metrics)
    for k in metrics:
        assert abs(float(pmetrics[k]) - float(metrics[k])) <= \
            LOSS_REL * max(abs(float(metrics[k])), 1.0)
    # the reference's gradients in the port's layout, leaf by leaf
    ref = dict(convert.lm_params(pcfg, jax.tree.map(np.asarray, grads))
               .named_parameters())
    named = dict(lm.named_parameters())
    assert set(named) == set(ref)
    for n, p in named.items():
        assert p.grad is not None, n
        assert _rel(p.grad, ref[n].detach().numpy()) <= LEAF_REL, n
    # one train step lowers the loss on its batch
    step = PSteps.make_train_step(pcfg, adamw(constant(1e-2)))
    _, _, m = step(lm, adamw(constant(1e-2)).init(lm), tb, 0)
    assert float(m["loss"]) == pytest.approx(float(ploss), rel=1e-6)
    with torch.no_grad():
        assert float(pm.loss_fn(lm, pcfg, tb)[0]) < float(ploss)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b",
                                  "deepseek-v3-671b", "whisper-base"])
def test_remat_recomputes_the_kernels_and_changes_nothing(arch, monkeypatch):
    """With ``cfg.remat`` every block (prefix layer, encoder layer) runs
    under ``torch.utils.checkpoint``: the loss and gradients are those
    without it, and backward calls each kernel again (one more flash call
    per attention application in a block, one more SSD call per Mamba-2
    layer; DeepSeek-V3's MTP head is outside the blocks)."""
    calls = {"flash": 0, "ssd": 0}
    fa, ssd = ops.flash_attention, ops.mamba2_ssd

    def count(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(ops, "flash_attention", count("flash", fa))
    monkeypatch.setattr(ops, "mamba2_ssd", count("ssd", ssd))
    out = {}
    for remat in (False, True):
        cfg, pcfg, _, lm = _models(arch, remat=remat)
        tb = {k: _t(v) for k, v in _batch(cfg).items()}
        calls.update(flash=0, ssd=0)
        loss, _ = pm.loss_fn(lm, pcfg, tb)
        fwd = dict(calls)
        loss.backward()
        out[remat] = (float(loss), {n: p.grad.clone() for n, p in
                                    lm.named_parameters()}, fwd, dict(calls))
    assert out[True][0] == out[False][0]
    for n, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][n], g, rtol=0, atol=0)
    fwd, total = out[True][2], out[True][3]
    mtp = 1 if pcfg.mtp else 0
    assert out[False][3] == out[False][2]          # no recompute
    assert total["flash"] == 2 * fwd["flash"] - mtp
    assert total["ssd"] == 2 * fwd["ssd"]
    assert fwd["flash"] > 0


def test_int8_experts_stay_frozen_and_pass_gradients():
    """int8 expert matrices take no gradient; the MoE layer still
    differentiates to its input and the router, and its output with
    gradients on equals the output without."""
    cfg = pcb.smoke("deepseek-v2-236b").replace(expert_weights_dtype="int8")
    g = torch.Generator().manual_seed(0)
    lm = pm.init(cfg, g, torch.float32)
    mp = lm.blocks[0]["moe"]
    trainable(mp)
    assert not mp["w_gate"].requires_grad and mp["router"].requires_grad
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    with torch.no_grad():
        y0, _ = PMoE.moe_fwd(mp, x, cfg)
    xg = x.clone().requires_grad_()
    y, aux = PMoE.moe_fwd(mp, xg, cfg)
    torch.testing.assert_close(y, y0, rtol=0, atol=0)
    (y.square().sum() + aux).backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0
    assert mp["router"].grad is not None and mp["w_gate"].grad is None


# ---------------------------------------------------------------------------
# the train step and the training entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,n_micro", [("tinyllama-1.1b", 1),
                                          ("tinyllama-1.1b", 2),
                                          ("zamba2-2.7b", 2)])
def test_train_step_matches_reference(arch, n_micro):
    """5 steps of ``make_train_step`` on the same stream and weights: the
    loss and gradient norm of each step agree."""
    cfg, pcfg, params, lm = _models(arch)
    dc = dict(seed=1, vocab_size=cfg.vocab_size, seq_len=S, global_batch=4)
    stream = RTokenStream(RDataConfig(**dc))
    ropt = r_adamw(r_cosine(3e-3, warmup=2, total=5), weight_decay=0.01)
    popt = adamw(cosine_warmup(3e-3, warmup=2, total=5), weight_decay=0.01)
    rstep = jax.jit(RSteps.make_train_step(cfg, ropt, n_micro=n_micro))
    pstep = PSteps.make_train_step(pcfg, popt, n_micro=n_micro)
    rst, pst = ropt.init(params), popt.init(lm)
    for i in range(5):
        b = stream.batch_at(i)
        params, rst, rmet = rstep(params, rst, {k: jnp.asarray(v) for k, v
                                                in b.items()}, jnp.int32(i))
        lm, pst, pmet = pstep(lm, pst, {k: _t(v) for k, v in b.items()}, i)
        assert set(pmet) == set(rmet)
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(float(pmet[k]) - float(rmet[k])) <= \
                STEP_REL * abs(float(rmet[k])), (i, k)
    assert all(p.grad is None for p in lm.parameters())


def test_train_step_accumulates_in_a_separate_buffer_for_bf16_weights():
    """bf16 weights accumulate their microbatches' gradients in fp32 (a
    buffer of its own): two microbatches equal the mean of two single
    steps' gradients to bf16 rounding."""
    pcfg = pcb.smoke("tinyllama-1.1b")
    g = torch.Generator().manual_seed(0)
    grads = []

    def capture(grads_in, state, params, step):
        grads.append({k: v.clone() for k, v in grads_in.items()})
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    from repro_torch.optim import Optimizer
    opt = Optimizer("capture", lambda p: {}, capture)
    lm = trainable(pm.init(pcfg, g, torch.bfloat16))
    b = {k: _t(v) for k, v in _batch(pcfg, Bb=4).items()}
    PSteps.make_train_step(pcfg, opt, n_micro=2)(lm, {}, b, 0)
    for half in (slice(0, 2), slice(2, 4)):
        PSteps.make_train_step(pcfg, opt, n_micro=1)(
            lm, {}, {k: v[half] for k, v in b.items()}, 0)
    acc, one, two = grads
    for n, a in acc.items():
        assert a.dtype == torch.float32
        want = (one[n].float() + two[n].float()) / 2
        torch.testing.assert_close(a, want, rtol=1e-2, atol=1e-6)


def test_train_recovers_from_failure(tmp_path, capsys):
    """Simulated node failure -> checkpoint restore -> identical final loss
    (deterministic replay), the reference's check on the port."""
    common = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "60",
              "--batch", "4", "--seq", "32", "--ckpt-every", "20",
              "--lr", "1e-3", "--log-every", "20", "--device", "cpu"]
    clean = train.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    recovered = train.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                     "--simulate-failure", "40"])
    assert abs(clean - recovered) < 1e-3
    out = capsys.readouterr().out
    assert "re-meshed + restored step 20" in out
    assert "step wall ms" in out and "tok/s" in out and "peak GiB" in out
    # the loss fell
    assert clean < 4.0


def test_train_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
