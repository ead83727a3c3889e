"""Multi-card dry run: trace every (arch x shape x mesh) cell's step.

The port of the reference's ``launch/dryrun.py``.  Where the reference
lowers and compiles each cell for 512 forced host devices, a cell here
starts a ``"fake"`` process group of the mesh's size (256 cards, or 512
with ``--multi-pod``), builds the step's inputs as DTensors of each rule's
placements on ``meta`` tensors (``launch/specs.py``: no memory is held)
and runs the step eagerly, as rank 0, under:

  * ``op_stats.OpCounter``: per-device dot flops, matmul-boundary bytes
    and collective bytes by type and mesh axis, counted on the local
    shards (the roofline's inputs, ``launch/roofline.py``);
  * the same counter's per-device peak of live tensor bytes, parameters,
    optimizer state and inputs included, held against the H100's usable
    79.18 GiB (``fits_hbm``).

The kernels run as their operators' fake implementations
(``kernels.trace.meta_operators``): the trace records
``repro_torch::flash_attention`` / ``repro_torch::mamba2_ssd`` (and their
backwards) and never their plain versions.  The tensors are ``meta``
rather than fake ``cuda`` ones: a CPU-only build of torch cannot index a
fake ``cuda`` tensor, and DTensor's offset arithmetic cannot run under a
``FakeTensorMode``.  Collectives of the fake group move nothing.

A train cell traces one microbatch (its loss and backward, with the
gradient accumulation buffer) and the optimizer update once, and scales
the microbatch's counts by ``n_micro``: the microbatches have one shape,
and the peak is reached in the first.  The record says so
(``traced_micro``).  Each cell destroys its fake group at the end.

These are estimates from the datasheet constants and a trace, not card
measurements.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out cells.jsonl]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch

from repro_torch import sharding as shd
from repro_torch.configs import base as cb
from repro_torch.kernels import trace
from repro_torch.launch import specs as sp
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.op_stats import OpCounter
from repro_torch.launch.roofline import derive
from repro_torch.models import model as mdl
from repro_torch.models.params import trainable
from repro_torch.optim import for_config, param_count
from repro_torch.optim.optimizers import named_leaves, state_specs


def pick_rules(cfg, shape) -> str:
    """Sharding-rule policy per (arch, shape), the reference's."""
    n = param_count(cfg)
    if shape.kind in ("train", "prefill"):
        return "fsdp" if n >= 2e9 else "tp"
    if shape.name == "long_500k":
        return "long"
    # decode_32k: cache time axis shards over "model" (flash-decode);
    # MoE archs additionally spread experts over the batch axes (EP)
    if cfg.family == "moe":
        return "decode_moe"
    return "decode"


def batch_shard_count(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names:
            n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def build_inputs(cfg, shape, mesh, rules, n_micro: int = 1):
    """(model, optimizer or None, the step's other arguments), all stand-ins
    with their rule's placements; a train cell's batch is one microbatch
    (global_batch / n_micro)."""
    rule_map = shd.RULE_SETS[rules]
    lm = mdl.LM(cfg, sp.param_structs(cfg, mesh, rule_map))
    if shape.kind == "train":
        trainable(lm)
        opt = for_config(cfg)
        ostate = sp.spec_structs(state_specs(opt, mdl.param_specs(cfg)),
                                 mesh, rule_map, torch.float32)
        batch = sp.batch_specs(cfg, shape.seq_len,
                               shape.global_batch // n_micro,
                               with_labels=True, mesh=mesh, rules=rule_map)
        return lm, opt, (ostate, batch)
    if shape.kind == "prefill":
        return lm, None, (sp.input_specs(cfg, shape, mesh, rule_map)["batch"],)
    dec = sp.input_specs(cfg, shape, mesh, rule_map)
    return lm, None, (dec["token"], shape.seq_len // 2, dec["cache"])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _trace(cfg, shape, lm, opt, args, n_micro, counter):
    """Run the cell's step under ``counter``.  A train step runs one
    microbatch's loss and backward, then the optimizer update; returns the
    counts after the microbatch (None for the other steps)."""
    if shape.kind != "train":
        step, _, _ = st.step_fn_for(cfg, shape, None, 1)
        with torch.no_grad():
            step(lm, *args)
        return None
    ostate, batch = args
    leaves = named_leaves(lm)
    accum = st.grad_accum_dtype(cfg)
    acc = None
    if n_micro > 1 and any(p.dtype != accum for p in leaves.values()):
        # the accumulation buffer the full step holds
        acc = {k: torch.zeros_like(p, dtype=accum) for k, p in
               leaves.items()}
    loss, _ = mdl.loss_fn(lm, cfg, batch)
    loss.backward()
    grads = {k: p.grad for k, p in leaves.items()}
    if acc is not None:
        for k in leaves:
            acc[k] += grads[k].to(accum)
        grads = acc
    micro = counter.result()
    opt.update(grads, ostate, lm, 0)
    return micro


def _combine(total, micro, n_micro):
    """The step's counts from one microbatch's (``micro``) and the whole
    trace's (``total``: that microbatch and the update): micro x n_micro
    plus the update's."""
    out = micro.scaled(n_micro)
    for k in ("dot_flops", "dot_bytes", "collective_bytes",
              "collective_count"):
        setattr(out, k, getattr(out, k) + getattr(total, k)
                - getattr(micro, k))
    for k in ("collective_by_type", "collective_by_axis", "kernel_calls"):
        d = getattr(out, k)
        for kk, v in getattr(total, k).items():
            d[kk] = d.get(kk, 0) + v - getattr(micro, k).get(kk, 0)
    out.largest = list(total.largest)
    return out


def trace_cell(cfg, shape, mesh, rules: str, n_micro: int = 1):
    """Trace one cell's step on ``mesh`` (a ``DeviceMesh`` over the default
    group) under ``rules``: (its ``OpStats``, a train step's scaled to
    ``n_micro`` microbatches, and the per-device peak bytes)."""
    lm, opt, args = build_inputs(cfg, shape, mesh, rules, n_micro)
    counter = OpCounter(mesh)
    counter.track(*lm.parameters(), *_leaves(args))
    with trace.meta_operators(), shd.use_rules(rules, mesh), counter:
        micro = _trace(cfg, shape, lm, opt, args, n_micro, counter)
    stats = counter.result()
    if micro is not None:
        stats = _combine(stats, micro, n_micro)
    return stats, counter.peak


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True, rules: str | None = None,
             cfg_overrides: dict | None = None, top: int = 0) -> dict:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = cb.get(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = cb.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x32x8" if multi_pod else "32x8"}
    if cfg_overrides:
        rec["cfg_overrides"] = cfg_overrides
    ok, why = cb.supports_shape(cfg, shape_name)
    if not ok:
        rec.update(status="skip", reason=why)
        return rec

    t0 = time.time()
    world = 512 if multi_pod else 256
    rules = rules or pick_rules(cfg, shape)
    rec["rules"] = rules
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        seq_shards = mesh.size(mesh.mesh_dim_names.index("model")) \
            if rules == "fsdp_sp" else 1
        opt0 = for_config(cfg) if shape.kind == "train" else None
        _, _, n_micro = st.step_fn_for(cfg, shape, opt0,
                                       batch_shard_count(mesh),
                                       seq_shards=seq_shards)
        rec["n_micro"] = n_micro
        if shape.kind == "train":
            rec["traced_micro"] = (
                f"one microbatch of {shape.global_batch // n_micro} traced, "
                f"its counts x{n_micro}; the optimizer update once")
        stats, peak = trace_cell(cfg, shape, mesh, rules, n_micro)
        t_trace = time.time() - t0
        by_axis = stats.collective_by_axis
        rl = derive(cfg, shape, dot_flops_dev=stats.dot_flops,
                    traffic_bytes_dev=stats.dot_bytes,
                    nvlink_bytes_dev=by_axis.get("model", 0.0),
                    ib_bytes_dev=sum(v for k, v in by_axis.items()
                                     if k != "model"),
                    n_chips=world)
        rec.update(
            status="ok",
            t_trace_s=round(t_trace, 1),
            memory={"per_device_peak": int(peak),
                    "per_device_peak_gib": peak / 2 ** 30,
                    "hbm_bytes": HBM_BYTES,
                    "fits_hbm": bool(peak <= HBM_BYTES)},
            flops=stats.dot_flops,
            collective_bytes=stats.collective_bytes,
            op_stats=stats.to_dict(top),
            roofline=rl.to_dict(),
        )
        if verbose:
            print(f"[{arch} x {shape_name} @ {rec['mesh']} rules={rules}] "
                  f"trace={t_trace:.0f}s n_micro={n_micro} "
                  f"mem/dev={peak / 2**30:.2f}GiB "
                  f"fits={rec['memory']['fits_hbm']} "
                  f"terms(c/m/k)={rl.compute_s:.3e}/{rl.memory_s:.3e}/"
                  f"{rl.collective_s:.3e} ({rl.collective_link}) "
                  f"dom={rl.dominant} useful={rl.useful_ratio:.2f}",
                  flush=True)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{arch} x {shape_name} @ {rec['mesh']}] FAILED: "
                  f"{rec['error']}", flush=True)
    finally:
        dist.destroy_process_group()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rules", default=None,
                    help="override the sharding-rule policy (perf runs)")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (e.g. kv_cache_dtype=int8)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v

    cells = []
    archs = cb.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(cb.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    out = open(args.out, "a") if args.out else None
    n_ok = n_fail = n_skip = 0
    for a, s, mp in cells:
        rec = run_cell(a, s, multi_pod=mp, rules=args.rules,
                       cfg_overrides=overrides or None)
        n_ok += rec["status"] == "ok"
        n_fail += rec["status"] == "error"
        n_skip += rec["status"] == "skip"
        if out:
            if rec["status"] != "error":
                rec.pop("traceback", None)
            out.write(json.dumps(rec) + "\n")
            out.flush()
    print(f"dry-run: {n_ok} ok / {n_skip} skip / {n_fail} FAILED "
          f"of {len(cells)}")
    if out:
        out.close()
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
