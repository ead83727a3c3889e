"""The port's sharded steps on a real mesh: 4 ranks on gloo, a
(data=2, model=2) ``DeviceMesh``, fp32, against the JAX functions on
weights carried across by ``convert.lm_params``.

One spawn of 4 ranks (``_rank``) runs every case and rank 0 writes the
results: smoke tinyllama prefill and decode under ``tp`` and ``fsdp``,
zamba2 prefill and decode under ``tp``, gemma3 (ring cache, its time axis
split over ``model``) under ``decode``, xLSTM prefill and decode under
``tp``, deepseek-v2 prefill and decode under ``tp`` and ``decode_moe``,
one tinyllama train step under ``fsdp`` (2 microbatches, AdamW), the
elastic controller's events over a fail / join script that ends paused
and resumes, and ``recover`` of a state saved on 2 x 2 onto the 1 x 2 mesh
left after a failure.

The references: the dense, hybrid, gemma3 and xLSTM models are the JAX
functions on one device; deepseek-v2, the train step and the elastic
controller are the reference's under the same (2, 2) mesh, in a
subprocess with 4 host devices and ``AxisType.Auto`` axes (JAX 0.9's
default Explicit axes make the reference's ``shard`` raise, ROADMAP R7).
Under a mesh each MoE rank counts capacity over its own tokens, as the
reference's sharded branches do, so the MoE is held against those.

Tolerances (fp32, as ``tests/test_torch_{lm,moe,train}.py``): logits
``TOL`` = 1e-5 max abs; the train step's loss and gradient norm within
``STEP_REL`` = 1e-4 relative; each updated parameter within
``PARAM_TOL`` = 1 % of the learning rate, max abs: AdamW's first update
is lr g / (|g| + eps) elementwise, so where a gradient is near 0 its
rounding moves the update by a visible part of lr (one element of 10240
moved 3.8e-5 at lr 1e-2).
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as cb
from repro.launch import specs as rsp
from repro.models import model as rm
from repro.sharding import init_params

TOL = 1e-5
STEP_REL = 1e-4
B, S, GEN = 4, 16, 4          # decode writes positions S .. S + GEN - 2
T = S + GEN                   # even: the time axis splits over model = 2
WORLD = 4
LR = 1e-2
PARAM_TOL = 1e-2 * LR

# (arch, rules): prefill, then GEN - 1 teacher-forced decode steps
SERVE = [("tinyllama-1.1b", "tp"), ("tinyllama-1.1b", "fsdp"),
         ("zamba2-2.7b", "tp"), ("gemma3-12b", "decode"),
         ("xlstm-1.3b", "tp"), ("deepseek-v2-236b", "tp"),
         ("deepseek-v2-236b", "decode_moe")]
MESH_REF = {"deepseek-v2-236b"}      # held against the reference's mesh run
ELASTIC = [("fail", 3, 5), ("remesh", None, 5), ("fail", 1, 7),
           ("remesh", None, 7), ("fail", 0, 9), ("fail", 2, 9),
           ("remesh", None, 9), ("join", 0, 11), ("join", 1, 11),
           ("join", 2, 11), ("join", 3, 11), ("remesh", None, 11)]


def _params(arch):
    cfg = cb.smoke(arch)
    return cfg, init_params(rm.param_specs(cfg), jax.random.PRNGKey(0),
                            jnp.float32)


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _put_jax(dst, src):
    if src.ndim == 0 or dst.shape == src.shape:
        return src.astype(dst.dtype)
    ax = [i for i, (a, b) in enumerate(zip(dst.shape, src.shape))
          if a != b][0]
    sl = [slice(None)] * dst.ndim
    sl[ax] = slice(0, src.shape[ax])
    return dst.at[tuple(sl)].set(src.astype(dst.dtype))


def _fp32_cache(cfg):
    """The reference's empty cache with its bf16 leaves in fp32 (the
    weights' dtype, as ``run_lm`` keeps caches)."""
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a,
                        rsp.init_cache(cfg, B, T))


def _reference_serve(params, cfg, toks):
    """The JAX model's prefill logits, then GEN - 1 greedy decode steps:
    (logits [GEN x (B, V)], the tokens fed [GEN - 1 x (B, 1)])."""
    last, cache = jax.jit(lambda p, b: rm.prefill(p, cfg, b))(
        params, {"tokens": jnp.asarray(toks)})
    cache = jax.tree.map(_put_jax, _fp32_cache(cfg), cache)
    step = jax.jit(lambda p, t, i, c: rm.decode_step(p, cfg, t, i, c))
    logits, fed = [np.asarray(last)], []
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    for i in range(GEN - 1):
        fed.append(np.asarray(tok))
        lg, cache = step(params, tok, jnp.int32(S + i), cache)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
    return logits, fed


# ---------------------------------------------------------------------------
# the reference under a (2, 2) JAX mesh, in a subprocess
# ---------------------------------------------------------------------------
MESH_SCRIPT = r"""
import json, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import base as cb
from repro.launch import specs as rsp
from repro.launch.steps import make_train_step
from repro.models import model as rm
from repro.optim import adamw, constant
from repro.runtime.elastic import ElasticController
from repro.sharding import init_params, use_rules
out_path, B, S, GEN, LR = sys.argv[1], *map(int, sys.argv[2:5]), float(sys.argv[5])
T = S + GEN
Auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(Auto, Auto))
res = {}
cfg = cb.smoke("deepseek-v2-236b")
params = init_params(rm.param_specs(cfg), jax.random.PRNGKey(0), jnp.float32)
toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
def put(dst, src):
    if src.ndim == 0 or dst.shape == src.shape:
        return src.astype(dst.dtype)
    ax = [i for i, (a, b) in enumerate(zip(dst.shape, src.shape)) if a != b][0]
    sl = [slice(None)] * dst.ndim
    sl[ax] = slice(0, src.shape[ax])
    return dst.at[tuple(sl)].set(src.astype(dst.dtype))
for rules in ("tp", "decode_moe"):
    with use_rules(rules, mesh):
        last, cache = jax.jit(lambda p, b: rm.prefill(p, cfg, b))(
            params, {"tokens": jnp.asarray(toks)})
        empty = jax.tree.map(lambda a: a.astype(jnp.float32)
                             if a.dtype == jnp.bfloat16 else a,
                             rsp.init_cache(cfg, B, T))
        cache = jax.tree.map(put, empty, cache)
        step = jax.jit(lambda p, t, i, c: rm.decode_step(p, cfg, t, i, c))
        logits, fed = [np.asarray(last)], []
        tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
        for i in range(GEN - 1):
            fed.append(np.asarray(tok))
            lg, cache = step(params, tok, jnp.int32(S + i), cache)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
    res[("deepseek-v2-236b", rules)] = (logits, fed)
# one train step of smoke tinyllama under fsdp, 2 microbatches
cfg = cb.smoke("tinyllama-1.1b")
params = init_params(rm.param_specs(cfg), jax.random.PRNGKey(0), jnp.float32)
rng = np.random.default_rng(9)
batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
         for k in ("tokens", "labels")}
opt = adamw(constant(LR), weight_decay=0.01)
with use_rules("fsdp", mesh):
    new, _, met = jax.jit(make_train_step(cfg, opt, n_micro=2))(
        params, opt.init(params), batch, jnp.int32(0))
res["train"] = ({k: float(v) for k, v in met.items()},
                jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, batch))
# the elastic controller's events
ctl = ElasticController(jax.devices()[:4], model_parallel=2)
for kind, idx, step in json.loads(os.environ["ELASTIC"]):
    if kind == "remesh":
        ctl.remesh(step)
    else:
        getattr(ctl, kind)(idx, step)
res["elastic"] = [(e.t_step, e.kind, e.detail) for e in ctl.events]
with open(out_path, "wb") as f:
    pickle.dump(res, f)
print("MESH_REF_OK")
"""


def _mesh_reference(tmp):
    out = os.path.join(tmp, "mesh_ref.pkl")
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", tmp), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "ELASTIC": json.dumps(ELASTIC)}
    proc = subprocess.Popen(
        [sys.executable, "-c", MESH_SCRIPT, out, str(B), str(S), str(GEN),
         str(LR)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out


# ---------------------------------------------------------------------------
# the port, 4 ranks on gloo
# ---------------------------------------------------------------------------
def _rank(rank, tmp):
    """One rank of the spawn: every case on the (2, 2) mesh; rank 0 writes
    the results."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        out = _rank_cases(rank, tmp, inp)
        if rank == 0:
            with open(os.path.join(tmp, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _rank_cases(rank, tmp, inp):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import convert
    from repro_torch import sharding as shd
    from repro_torch.configs import base as pcb
    from repro_torch.launch import serve
    from repro_torch.launch import specs as psp
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as pm
    from repro_torch.models.params import trainable
    from repro_torch.optim import adamw, constant
    from repro_torch.optim.optimizers import named_leaves

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch, rules in SERVE:
        pcfg = pcb.smoke(arch)
        lm = convert.lm_params(pcfg, inp["params"][arch])
        shd.distribute_params(lm, pm.param_specs(pcfg), mesh, rules)
        toks = torch.from_numpy(inp["tokens"][arch])
        with torch.no_grad(), shd.use_rules(rules, mesh):
            dt = shd.to_dtensor(toks, ("batch", "seq"), mesh,
                                shd.RULE_SETS[rules])
            last, cache = pm.prefill(lm, pcfg, {"tokens": dt})
            logits = [last.full_tensor().numpy()]
            full = serve._tree_map2(
                serve._put, psp.init_cache(pcfg, B, T, dtype=torch.float32),
                shd.full_tree(cache))
            cache = shd.distribute_tree(full, pm.cache_specs(pcfg, B, T),
                                        mesh, rules)
            for i, tok in enumerate(inp["fed"][(arch, rules)]):
                t = shd.to_dtensor(torch.from_numpy(tok), ("batch", "seq"),
                                   mesh, shd.RULE_SETS[rules])
                lg, cache = pm.decode_step(lm, pcfg, t, S + i, cache)
                logits.append(lg.full_tensor().numpy())
        out[(arch, rules)] = logits
    # one train step under fsdp, 2 microbatches
    pcfg = pcb.smoke("tinyllama-1.1b")
    lm = trainable(convert.lm_params(pcfg, inp["params"]["tinyllama-1.1b"]))
    shd.distribute_params(lm, pm.param_specs(pcfg), mesh, "fsdp")
    opt = adamw(constant(LR), weight_decay=0.01)
    with shd.use_rules("fsdp", mesh):
        batch = {k: shd.to_dtensor(torch.from_numpy(v), ("batch", "seq"),
                                   mesh, shd.FSDP_RULES)
                 for k, v in inp["train_batch"].items()}
        lm, _, met = make_train_step(pcfg, opt, n_micro=2)(
            lm, opt.init(lm), batch, 0)
        out["train"] = ({k: float(v) for k, v in met.items()},
                        {k: shd.full_tensor(p.detach()).numpy()
                         for k, p in named_leaves(lm).items()})
    out["elastic"], out["recover"] = _elastic(rank, tmp)
    return out


def _elastic(rank, tmp):
    """The controller over the 4 ranks through ``ELASTIC``; a state saved on
    the first (2 x 2) mesh is recovered onto the 1 x 2 mesh left after
    rank 3 fails.  Returns (events, (saved, recovered) on rank 0)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.runtime.elastic import ElasticController

    store = CheckpointStore(os.path.join(tmp, f"ckpt_rank{rank}"))
    ctl = ElasticController(list(range(WORLD)), model_parallel=2,
                            checkpoint_store=store, device_type="cpu")
    g = torch.Generator().manual_seed(3)
    full = {"w": torch.randn(8, 6, generator=g),
            "b": torch.randn(6, generator=g)}
    place = {"w": (Shard(0), Shard(1)), "b": (Replicate(), Shard(0))}
    saved = {k: distribute_tensor(v, ctl.mesh, place[k])
             for k, v in full.items()}
    store.save(3, saved, block=True)
    recovered = None
    for kind, idx, step in ELASTIC:
        if kind == "remesh":
            ctl.remesh(step)
        else:
            getattr(ctl, kind)(idx, step)
        if recovered is None and kind == "remesh":
            mesh = ctl.mesh
            if mesh.get_coordinate() is not None:
                like = {k: distribute_tensor(torch.zeros_like(v), mesh,
                                             place[k])
                        for k, v in full.items()}
                rstep, state = ctl.recover(like)
                assert rstep == 3
                recovered = (tuple(mesh.mesh.shape),
                             {k: (v.full_tensor().numpy(),
                                  tuple(v.placements))
                              for k, v in state.items()})
            else:
                recovered = ("not in the mesh",)
    events = [(e.t_step, e.kind, e.detail) for e in ctl.events]
    return events, ({k: v.numpy() for k, v in full.items()}, recovered)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the port's results, the JAX references)."""
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("mesh"))
    proc, ref_path = _mesh_reference(tmp)
    inp = {"params": {}, "tokens": {}, "fed": {}}
    refs = {}
    for arch, rules in SERVE:
        cfg, params = _params(arch)
        inp["params"][arch] = jax.tree.map(np.asarray, params)
        inp["tokens"][arch] = _tokens(cfg, 5)
        if arch not in MESH_REF:
            refs[(arch, rules)] = _reference_serve(params, cfg,
                                                   inp["tokens"][arch])
    stdout, stderr = proc.communicate(timeout=600)
    assert "MESH_REF_OK" in stdout, stderr[-3000:]
    with open(ref_path, "rb") as f:
        mesh_ref = pickle.load(f)
    refs.update({k: v for k, v in mesh_ref.items() if isinstance(k, tuple)})
    refs["train"], refs["elastic"] = mesh_ref["train"], mesh_ref["elastic"]
    for key in SERVE:
        inp["fed"][key] = refs[key][1]
    inp["train_batch"] = refs["train"][2]
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, tmp)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    with open(os.path.join(tmp, "out.pkl"), "rb") as f:
        return pickle.load(f), refs


@pytest.mark.parametrize("arch, rules", SERVE)
def test_sharded_prefill_matches_the_reference(run, arch, rules):
    got, refs = run
    np.testing.assert_allclose(got[(arch, rules)][0],
                               refs[(arch, rules)][0][0], atol=TOL, rtol=0)


@pytest.mark.parametrize("arch, rules", SERVE)
def test_sharded_decode_matches_the_reference(run, arch, rules):
    got, refs = run
    want = refs[(arch, rules)][0]
    assert len(got[(arch, rules)]) == len(want) == GEN
    for i in range(1, GEN):
        np.testing.assert_allclose(got[(arch, rules)][i], want[i], atol=TOL,
                                   rtol=0, err_msg=f"step {i}")


def test_sharded_train_step_matches_the_reference(run):
    """One fsdp step (2 microbatches) against the reference's under the
    same mesh: loss, ce, grad norm and every updated parameter."""
    from repro_torch import convert
    from repro_torch.configs import base as pcb
    got, refs = run
    gm, gp = got["train"]
    rm_, rp, _ = refs["train"]
    for k in ("loss", "ce", "grad_norm"):
        assert abs(gm[k] - rm_[k]) <= STEP_REL * abs(rm_[k]), k
    want = convert.lm_params(pcb.smoke("tinyllama-1.1b"), rp)
    for name, p in want.named_parameters():
        np.testing.assert_allclose(gp[name], p.detach().numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)


def test_elastic_events_match_the_reference(run):
    """The fail / join / remesh events are the reference's, the paused one
    included; the port's also record the recovery after the first
    remesh (the reference's run has no checkpoint)."""
    got, refs = run
    restores = [e for e in got["elastic"] if e[1] == "restore"]
    assert restores == [(3, "restore", "step 3")]
    assert [e for e in got["elastic"] if e[1] != "restore"] == \
        refs["elastic"]
    kinds = [k for _, k, _ in refs["elastic"]]
    assert "paused" in kinds and kinds[-1] == "remesh"


def test_recover_moves_a_state_onto_the_smaller_mesh(run):
    """Saved on 2 x 2, recovered onto 1 x 2 (ranks 0 and 1) after rank 3
    failed: each tensor's values are the saved ones, placed on the new
    mesh."""
    from torch.distributed.tensor import Replicate, Shard
    got, _ = run
    full, (shape, state) = got["recover"]
    assert shape == (1, 2)
    assert state["w"][1] == (Shard(0), Shard(1))
    assert state["b"][1] == (Replicate(), Shard(0))
    for k in full:
        np.testing.assert_array_equal(state[k][0], full[k])
