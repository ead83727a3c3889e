"""The port's sharding rules, struct helpers and policies against the
reference's (``repro.sharding``, ``repro.launch.{specs,steps,dryrun,
roofline}``, ``repro.optim.optimizers.state_specs``,
``repro.runtime.elastic.largest_mesh``).

Everything here is exact: rule sets, pspecs, shapes, dtypes, placements,
microbatch counts, rule picks, mesh factorizations and the closed-form flop
counts are equal field for field.  The reference's pspecs are computed on
its test's ``_FakeMesh``; the port's DTensor stand-ins live on
``DeviceMesh``es over a ``"fake"`` process group of 512 ranks, made and
destroyed by one fixture.

By design (ROADMAP Queue 3): the port's parameter leaves are one layer (the
reference stacks layers on leading axes, which every rule set leaves
unsharded), so a port leaf is the reference's with its leading axes
dropped; adafactor factors the port's own leaf shape, so a 1-D leaf (a
layer's norm weights) keeps a full second moment where the reference
factors its (L, d) stack.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import base as cb
from repro.launch import roofline as RR
from repro.launch import specs as rsp
from repro.launch import steps as RSteps
from repro.models import model as rm
from repro.optim import optimizers as RO
from repro.runtime.elastic import largest_mesh as r_largest_mesh
from repro import sharding as RS
from repro_torch import sharding as PS
from repro_torch.configs import base as pcb
from repro_torch.launch import roofline as PR
from repro_torch.launch import specs as psp
from repro_torch.launch import steps as PSteps
from repro_torch.models import model as pm
from repro_torch.optim import optimizers as PO
from repro_torch.runtime.elastic import largest_mesh

VOCAB = sorted(RS.TP_RULES)
MESHES = {(4, 2): ("data", "model"), (32, 8): ("data", "model"),
          (2, 32, 8): ("pod", "data", "model")}


class _FakeMesh:
    """The reference test's stand-in mesh (axis names and sizes)."""

    def __init__(self, shape_map):
        self._m = shape_map

    @property
    def axis_names(self):
        return tuple(self._m)

    @property
    def shape(self):
        return self._m


def _fake(shape):
    return _FakeMesh(dict(zip(MESHES[shape], shape)))


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's ``launch.dryrun``: importing it sets XLA_FLAGS, which
    is put back as it was."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(os.environ, "XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        from repro.launch import dryrun
        yield dryrun


@pytest.fixture(scope="module")
def meshes():
    """{shape: DeviceMesh} over a fake group of 512 ranks, as rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {s: DeviceMesh("cpu", torch.arange(int(np.prod(s))).reshape(s),
                             mesh_dim_names=names)
               for s, names in MESHES.items()}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# rules and pspecs
# ---------------------------------------------------------------------------
def test_rule_sets_are_the_reference():
    assert PS.RULE_SETS == RS.RULE_SETS
    for name in ("TP_RULES", "FSDP_RULES", "LONG_CONTEXT_RULES",
                 "DECODE_RULES", "DECODE_MOE_RULES", "FSDP_SP_RULES"):
        assert getattr(PS, name) == getattr(RS, name)


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_pspec_matches_the_reference(data):
    mshape = data.draw(st.sampled_from(sorted(MESHES)))
    rules = data.draw(st.sampled_from(sorted(RS.RULE_SETS)))
    nd = data.draw(st.integers(1, 5))
    axes = tuple(data.draw(st.lists(st.sampled_from(VOCAB + [None]),
                                    min_size=nd, max_size=nd)))
    dims = st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 96, 128,
                            256, 512])
    shape = tuple(data.draw(st.lists(dims, min_size=nd, max_size=nd)))
    mesh = _fake(mshape)
    want = RS.logical_to_pspec(axes, RS.RULE_SETS[rules], mesh, shape)
    got = PS.logical_to_pspec(axes, PS.RULE_SETS[rules], mesh, shape)
    assert got == tuple(want)
    # and without a shape (no divisibility check)
    assert PS.logical_to_pspec(axes, PS.RULE_SETS[rules], mesh) == \
        tuple(RS.logical_to_pspec(axes, RS.RULE_SETS[rules], mesh))


MESH = _FakeMesh({"data": 4, "model": 2})


@pytest.mark.parametrize("axes, rules, shape, want", [
    # pod missing -> dropped; seq/embed None
    (("batch", "seq", "embed"), "tp", (8, 16, 32), ("data",)),
    # 3 % 2 != 0 -> unsharded
    (("vocab", "embed"), "tp", (3, 32), ()),
    # both vocab and mlp map to "model": the second use drops
    (("vocab", "mlp"), "tp", (4, 4), ("model",)),
    # FSDP shards weights two ways
    (("embed", "mlp"), "fsdp", (8, 8), ("data", "model")),
])
def test_reference_cases(axes, rules, shape, want):
    """The reference test's cases, as ported."""
    assert PS.logical_to_pspec(axes, PS.RULE_SETS[rules], MESH, shape) == \
        want


def test_all_rule_sets_resolve_every_axis():
    axes = ["batch", "seq", "embed", "vocab", "heads", "kv_heads", "mlp",
            "experts", "expert_mlp", "cache_seq", "cache_batch", "layers",
            "embed_table"]
    for name, rules in PS.RULE_SETS.items():
        for ax in axes:
            assert ax in rules, (name, ax)


def test_placements_follow_the_pspec(meshes):
    """One ``Shard(i)`` a mesh dim that splits tensor dim i, pod-major for a
    dim over ("pod", "data"), Replicate elsewhere; and back."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = meshes[(2, 32, 8)]
    pl = PS.logical_to_placements(("batch", "seq", "embed"), "fsdp", mesh,
                                  (128, 16, 4096))
    assert pl == (Shard(0), Shard(0), Replicate())
    pl = PS.logical_to_placements(("embed", "mlp"), "fsdp", mesh, (64, 64))
    assert pl == (Replicate(), Shard(0), Shard(1))
    for axes, shape in ((("batch", "seq", "embed"), (128, 16, 4096)),
                        (("vocab", "embed"), (3, 32)),
                        (("experts", "embed", "expert_mlp"), (64, 32, 64))):
        for rules in PS.RULE_SETS:
            pl = PS.logical_to_placements(axes, rules, mesh, shape)
            assert PS.placements_to_pspec(pl, mesh, len(shape)) == \
                PS.logical_to_pspec(axes, PS.RULE_SETS[rules], mesh, shape)


def test_pod_major_split(meshes):
    """A dim over ("pod", "data") splits pod first: rank (p, d, m) holds
    block p * 32 + d of 64, as P(("pod", "data")) lays it out."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = meshes[(2, 32, 8)]
    pl = PS.logical_to_placements(("batch",), "tp", mesh, (128,))
    shape, offset = compute_local_shape_and_global_offset(
        (128,), mesh, pl)
    assert tuple(shape) == (2,) and tuple(offset) == (0,)


# ---------------------------------------------------------------------------
# optimizer state specs
# ---------------------------------------------------------------------------
def _ref_leaves(tree, path=()):
    """{path: Spec} of the reference's spec tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _unstacked(name: str):
    """A port leaf's dotted name -> (the reference's path, the number of
    leading stacked axes there)."""
    parts = name.split(".")
    return tuple(p for p in parts if not p.isdigit()), \
        sum(p.isdigit() for p in parts)


def _dtype(dt):
    return str(dt).split(".")[-1] if dt is not None else None


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_state_specs_match_the_reference(arch, opt_name):
    cfg, pcfg = cb.get(arch), pcb.get(arch)
    ropt = getattr(RO, opt_name)(lambda s: 1e-3)
    popt = getattr(PO, opt_name)(lambda s: 1e-3)
    rs = RO.state_specs(ropt, rm.param_specs(cfg))
    ps = PO.state_specs(popt, pm.param_specs(pcfg))
    assert set(rs) == set(ps)
    for top in rs:
        ref = _ref_leaves(rs[top])
        seen = set()
        for name, sub in ps[top].items():
            path, lead = _unstacked(name)
            subs = sub if isinstance(sub, dict) else {None: sub}
            for k, s in subs.items():
                assert _dtype(s.dtype) == "float32" and s.init == "zeros"
                if opt_name == "adafactor" and k == "v" and \
                        (path + ("r",)) in ref:
                    # by design: a 1-D port leaf keeps a full moment where
                    # the reference factors the stacked (L, d) leaf
                    r, c = ref[path + ("r",)], ref[path + ("c",)]
                    assert len(s.shape) == 1 and len(r.shape) == lead
                    assert tuple(c.shape[lead - 1:]) == tuple(s.shape)
                    assert tuple(c.axes[lead - 1:]) == tuple(s.axes)
                    seen |= {path + ("r",), path + ("c",)}
                    continue
                rpath = path + ((k,) if k else ())
                want = ref[rpath]
                assert tuple(want.shape[lead:]) == tuple(s.shape), rpath
                assert tuple(want.axes[lead:]) == tuple(s.axes), rpath
                assert set(want.axes[:lead]) <= {"layers"}, rpath
                seen.add(rpath)
        assert seen == set(ref)


# ---------------------------------------------------------------------------
# struct helpers
# ---------------------------------------------------------------------------
def _ref_structs(cfg, shape, rules, mesh):
    """{path: (shape, dtype, pspec)} of the reference's ``input_specs`` (its
    ``_sds`` stood in for, so the pspec is the one it would attach) and of
    its ``param_structs``."""
    def sds(shp, dtype, axes, m, r):
        return (tuple(shp), _dtype(np.dtype(dtype)) if dtype is not None
                else None, tuple(RS.logical_to_pspec(axes, r, m, shp)))

    rules_map = RS.RULE_SETS[rules]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rsp, "_sds", sds)
        mp.setattr(rsp, "cache_structs", lambda *a: None)  # walked below
        ins = rsp.input_specs(cfg, cb.SHAPES[shape], mesh, rules_map)
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, RS.Spec):
            dt = t.dtype or rsp.MODEL_DTYPE
            out[path] = (tuple(t.shape), _dtype(np.dtype(dt)),
                         tuple(RS.logical_to_pspec(t.axes, rules_map, mesh,
                                                   t.shape)))
        elif isinstance(t, tuple) and len(t) == 3:
            out[path] = t
        else:  # pos: a ShapeDtypeStruct
            out[path] = (tuple(t.shape), _dtype(np.dtype(t.dtype)), ())
    if "cache" in ins:
        walk(rm.cache_specs(cfg, cb.SHAPES[shape].global_batch,
                            cb.SHAPES[shape].seq_len), ("cache",))
        ins = {k: v for k, v in ins.items() if k != "cache"}
    walk(ins, ())
    walk(rm.param_specs(cfg), ("params",))
    return out


def _port_structs(pcfg, shape, rules, mesh):
    from torch.distributed.tensor import DTensor
    out = {}
    ins = psp.input_specs(pcfg, pcb.SHAPES[shape], mesh, rules)
    ins["params"] = psp.param_structs(pcfg, mesh, rules)

    def walk(t, path, lead):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,), lead)
        elif isinstance(t, list):
            walk(t[0], path, lead + (len(t),))
            for x in t[1:]:
                assert _leafset(x) == _leafset(t[0])
        else:
            ps = PS.placements_to_pspec(t.placements, mesh, t.dim()) \
                if isinstance(t, DTensor) else ()
            # the reference's leading stacked axes are never sharded
            ps = (None,) * len(lead) + ps if ps else ()
            out[path] = (lead + tuple(t.shape), _dtype(t.dtype), ps)
    walk(ins, (), ())
    return out


def _leafset(t):
    """Shapes, dtypes and placements of a tree, to hold list entries
    alike."""
    if isinstance(t, dict):
        return {k: _leafset(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_leafset(v) for v in t]
    return (tuple(t.shape), str(t.dtype),
            tuple(getattr(t, "placements", ())))


@pytest.mark.parametrize("mesh_shape", [(32, 8), (2, 32, 8)])
@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_struct_helpers_match_the_reference(meshes, ref_dryrun, arch,
                                            mesh_shape):
    """For every shape of the arch: each input, cache and parameter stand-in
    has the reference's shape, dtype and (with the leading stacked axes
    unsharded) pspec, under the rules the policy picks."""
    cfg, pcfg = cb.get(arch), pcb.get(arch)
    for shape in cb.SHAPES:
        rules = ref_dryrun.pick_rules(cfg, cb.SHAPES[shape])
        want = _ref_structs(cfg, shape, rules, _fake(mesh_shape))
        got = _port_structs(pcfg, shape, rules, meshes[mesh_shape])
        assert set(got) == set(want), (shape, set(got) ^ set(want))
        for k in want:
            assert got[k] == want[k], (shape, k)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
def test_microbatches_and_rules_match_the_reference(ref_dryrun, multi_pod):
    from repro_torch.launch import dryrun as pdry
    mesh = _fake((2, 32, 8) if multi_pod else (32, 8))
    shards = 64 if multi_pod else 32
    for arch in cb.ARCH_IDS:
        cfg, pcfg = cb.get(arch), pcb.get(arch)
        for name, shape in cb.SHAPES.items():
            rules = ref_dryrun.pick_rules(cfg, shape)
            assert pdry.pick_rules(pcfg, pcb.SHAPES[name]) == rules
            for seq_shards in (1, 8):
                assert PSteps.auto_microbatches(
                    pcfg, shape.global_batch, shape.seq_len, shards,
                    seq_shards=seq_shards) == RSteps.auto_microbatches(
                    cfg, shape.global_batch, shape.seq_len, shards,
                    seq_shards=seq_shards)
            ropt = RO.for_config(cfg) if shape.kind == "train" else None
            popt = PO.for_config(pcfg) if shape.kind == "train" else None
            seq = 8 if rules == "fsdp_sp" else 1
            r = RSteps.step_fn_for(cfg, shape, ropt, shards, seq)
            p = PSteps.step_fn_for(pcfg, pcb.SHAPES[name], popt, shards, seq)
            assert (p[1], p[2]) == (r[1], r[2]), (arch, name)
    assert ref_dryrun.batch_shard_count(mesh) == shards


def test_batch_shard_count_matches(meshes, ref_dryrun):
    from repro_torch.launch import dryrun as pdry
    assert pdry.batch_shard_count(meshes[(32, 8)]) == \
        ref_dryrun.batch_shard_count(_fake((32, 8))) == 32
    assert pdry.batch_shard_count(meshes[(2, 32, 8)]) == \
        ref_dryrun.batch_shard_count(_fake((2, 32, 8))) == 64


@pytest.mark.parametrize("model", [1, 2, 4, 8, 16])
def test_largest_mesh_matches_the_reference(model):
    for n in range(0, 601):
        assert largest_mesh(n, model) == r_largest_mesh(n, model), n


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_closed_form_flops_match_the_reference(arch):
    cfg, pcfg = cb.get(arch), pcb.get(arch)
    assert PR.active_param_count(pcfg) == RR.active_param_count(cfg)
    for name in cb.SHAPES:
        shape, pshape = cb.SHAPES[name], pcb.SHAPES[name]
        assert PR.attn_flops(pcfg, pshape) == RR.attn_flops(cfg, shape)
        assert PR.model_flops(pcfg, pshape) == RR.model_flops(cfg, shape)


def test_h100_constants():
    """No TPU constant: the roofline divides by the H100's."""
    from repro_torch.launch import mesh as M
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.NVLINK_BW, M.IB_BW) == \
        (989.4e12, 3.35e12, 450e9, 50e9)
    assert M.HBM_BYTES == 79.18 * 2 ** 30
    rl = PR.derive(pcb.get("tinyllama-1.1b"), pcb.SHAPES["train_4k"],
                   dot_flops_dev=989.4e12, traffic_bytes_dev=3.35e12,
                   nvlink_bytes_dev=450e9 * 2, ib_bytes_dev=50e9 * 3,
                   n_chips=256)
    assert (rl.compute_s, rl.memory_s, rl.collective_nvlink_s,
            rl.collective_ib_s) == (1.0, 1.0, 2.0, 3.0)
    assert rl.collective_s == 3.0 and rl.collective_link == "infiniband"
    assert rl.dominant == "collective"
