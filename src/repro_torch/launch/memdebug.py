"""Memory autopsy of a dry-run cell: the largest tensors its step makes.

The port of the reference's ``launch/memdebug.py``.  The reference lists
the largest result buffers of the compiled HLO; here the cell's step is
traced as ``launch/dryrun.py`` traces it (meta tensors, one rank's shards
of the production mesh) and ``op_stats.OpCounter`` keeps the largest
results by operator, with the per-device peak of live bytes.

Usage: python -m repro_torch.launch.memdebug --arch X --shape Y [--rules R]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import base as cb
from repro_torch.launch import dryrun as dr
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_production_mesh


def autopsy(arch: str, shape_name: str, rules: str | None = None,
            top: int = 30, min_bytes: float = 100e6):
    """Print and return the ``top`` largest results (at least
    ``min_bytes``) of the cell's step: (GiB, operator, shape, dtype)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = cb.get(arch)
    shape = cb.SHAPES[shape_name]
    rules = rules or dr.pick_rules(cfg, shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        opt = dr.for_config(cfg) if shape.kind == "train" else None
        _, _, n_micro = st.step_fn_for(cfg, shape, opt,
                                       dr.batch_shard_count(mesh))
        stats, peak = dr.trace_cell(cfg, shape, mesh, rules, n_micro)
    finally:
        dist.destroy_process_group()
    rows = [(b / 2**30, op, shp, dt)
            for b, op, shp, dt in sorted(stats.largest, reverse=True)
            if b >= min_bytes][:top]
    print(f"[{arch} x {shape_name} rules={rules}] n_micro={n_micro} "
          f"peak={peak / 2**30:.2f} GiB per device")
    print(f"{'GiB':>6} {'op':36s} shape")
    for gib, op, shp, dt in rows:
        print(f"{gib:6.2f} {op:36s} {dt} {list(shp)}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--rules", default=None)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    autopsy(args.arch, args.shape, args.rules, args.top)


if __name__ == "__main__":
    main()
