"""The mesh dry run on a ``"fake"`` process group (``launch/dryrun.py``,
``launch/op_stats.py``): the port's counterpart of the reference's
``test_mini_dryrun_8_devices``, an exact flop count, the kernels traced as
their operators (never their plain versions), the collectives' mesh axes,
and two full-width cells on the production mesh (32, 8).

Each test makes its own fake group and destroys it: one default group can
live in a process.
"""
from __future__ import annotations

import pytest

from repro.configs import base as cb
from repro_torch.configs import base as pcb
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba2_ssd as SSD
from repro_torch.kernels.flash_attention import kept_pairs
from repro_torch.launch import dryrun as dr


@pytest.fixture
def mesh42():
    """A (data=4, model=2) mesh over a fake group of 8 ranks, as rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_mini_dryrun_8_devices(mesh42):
    """Smoke tinyllama on (4, 2): a train step in 2 microbatches and a
    decode step trace, with flops and a peak."""
    cfg = pcb.smoke("tinyllama-1.1b")
    stats, peak = dr.trace_cell(cfg, pcb.ShapeSpec("t", 64, 8, "train"),
                                mesh42, "tp", n_micro=2)
    assert stats.dot_flops > 0 and peak > 0
    assert stats.kernel_calls["flash_attention"] == 2 * cfg.n_layers
    assert stats.kernel_calls["flash_attention_backward"] == \
        2 * cfg.n_layers
    stats, peak = dr.trace_cell(cfg, pcb.ShapeSpec("d", 128, 8, "decode"),
                                mesh42, "tp")
    assert stats.dot_flops > 0 and peak > 0


def test_prefill_flops_are_the_sum_of_its_products(mesh42):
    """Smoke tinyllama's prefill under tp on (4, 2), counted on rank 0's
    shards, equals its products summed by hand: each rank holds B/4
    sequences, half the heads (H 4, Kh 2), half the MLP and half the
    vocab, and unembeds the last position only."""
    cfg = pcb.smoke("tinyllama-1.1b")
    B, S = 8, 16
    stats, _ = dr.trace_cell(cfg, pcb.ShapeSpec("p", S, B, "prefill"),
                             mesh42, "tp")
    d, dh, ff, V = cfg.d_model, cfg.dh, cfg.d_ff, cfg.vocab_size
    b, h, kh = B // 4, cfg.n_heads // 2, cfg.n_kv_heads // 2
    layer = (2 * b * S * d * h * dh            # wq
             + 2 * 2 * b * S * d * kh * dh     # wk, wv
             + 2 * b * h * kept_pairs(S, S, True, 0) * (dh + dh)  # flash
             + 2 * b * S * h * dh * d          # wo
             + 2 * 2 * b * S * d * (ff // 2)   # w_gate, w_up
             + 2 * b * S * (ff // 2) * d)      # w_down
    want = cfg.n_layers * layer + 2 * b * 1 * d * (V // 2)
    assert stats.dot_flops == want
    # tp: every collective is on "model"
    assert set(stats.collective_by_axis) == {"model"}


def test_fsdp_gathers_weights_over_data(mesh42):
    cfg = pcb.smoke("tinyllama-1.1b")
    stats, _ = dr.trace_cell(cfg, pcb.ShapeSpec("p", 16, 8, "prefill"),
                             mesh42, "fsdp")
    assert stats.collective_by_axis["data"] > 0
    assert stats.collective_by_type["all-gather"] > 0


def test_kernels_are_traced_as_operators_never_plain(mesh42, monkeypatch):
    """zamba2 (both kernels): the trace records the operators and their
    backwards; the plain versions (patched to raise) never run."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran in the dry run")
    for mod, names in ((FA, ("flash_attention_plain", "_plain",
                             "flash_attention_backward")),
                       (SSD, ("mamba2_ssd_plain", "mamba2_ssd_backward"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    cfg = pcb.smoke("zamba2-2.7b")
    stats, _ = dr.trace_cell(cfg, pcb.ShapeSpec("t", 64, 8, "train"),
                             mesh42, "tp")
    n_ssd = cfg.n_layers
    n_attn = cfg.n_layers // cfg.superblock
    assert stats.kernel_calls == {
        "flash_attention": n_attn, "flash_attention_backward": n_attn,
        "mamba2_ssd": n_ssd, "mamba2_ssd_backward": n_ssd}
    assert "repro_torch::flash_attention" in stats.calls
    assert "repro_torch::mamba2_ssd" in stats.calls


def test_skips_are_the_references():
    for arch in cb.ARCH_IDS:
        ok, why = cb.supports_shape(cb.get(arch), "long_500k")
        rec = dr.run_cell(arch, "long_500k", multi_pod=False,
                          verbose=False) if not ok else None
        if rec is not None:
            assert rec["status"] == "skip" and rec["reason"] == why


@pytest.mark.parametrize("arch, shape", [("tinyllama-1.1b", "train_4k"),
                                         ("deepseek-v3-671b", "decode_32k")])
def test_full_width_cells(arch, shape):
    """Two cells at full width on the production mesh (32, 8)."""
    rec = dr.run_cell(arch, shape, multi_pod=False, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    mem = rec["memory"]
    assert 0 < mem["per_device_peak"] and mem["fits_hbm"]
    assert rec["flops"] > 0 and rec["roofline"]["dominant"] in (
        "compute", "memory", "collective")
    if shape == "train_4k":
        assert rec["n_micro"] == 2 and "traced_micro" in rec


def _second_copy(mod):
    """Another copy of a kernel wrapper's module, loaded from its file under
    another name, as ``kernel_compare.py`` loads another checkout's."""
    import importlib.util
    import sys
    name = f"copy_of_{mod.__name__.rsplit('.', 1)[1]}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, mod.__file__)
        copy = importlib.util.module_from_spec(spec)
        sys.modules[name] = copy
        spec.loader.exec_module(copy)
    return sys.modules[name]


@pytest.mark.parametrize("mod", [FA, SSD], ids=["flash", "ssd"])
def test_a_second_copy_of_a_wrapper_has_its_own_operators(mod):
    """A second copy of a kernel wrapper registers its operators under its
    own namespace and goes through them as the package's goes through its
    own: the same fake outputs and flop count on meta tensors inside
    ``meta_operators()``, and a CPU tensor refused by the operator."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import trace
    copy = _second_copy(mod)
    assert mod._NS == "repro_torch" and copy._NS == copy.__name__
    meta = {"device": "meta"}
    if mod is FA:
        args = (torch.empty(2, 4, 8, 16, **meta),
                torch.empty(2, 2, 8, 16, **meta),
                torch.empty(2, 2, 8, 16, **meta), True, 0)
        op = "flash_attention"
    else:
        args = (torch.empty(1, 64, 2, 8, **meta),
                torch.empty(1, 64, 2, **meta), torch.empty(2, **meta),
                torch.empty(1, 64, 4, **meta), torch.empty(1, 64, 4, **meta),
                32, False)
        op = "mamba2_ssd"
    outs, flops = [], []
    for m in (mod, copy):
        with trace.meta_operators(), FlopCounterMode(display=False) as fc:
            out = m._forward(*args)
        outs.append([(o.shape, o.stride(), o.dtype) for o in
                     (out if isinstance(out, tuple) else (out,))])
        counts = fc.get_flop_counts()["Global"]
        assert [str(k) for k in counts] == [f"{m._NS}.{op}"]
        flops.append(fc.get_total_flops())
    assert outs[0] == outs[1] and flops[0] == flops[1] > 0
    cpu = [torch.zeros(a.shape) if isinstance(a, torch.Tensor) else a
           for a in args[:5 if mod is FA else 6]]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        getattr(getattr(torch.ops, copy._NS), op)(*cpu)
