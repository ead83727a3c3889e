"""Deep per-architecture verification on the port: every assigned arch
(reduced config) through loss / prefill / decode, checking
decode-vs-forward consistency — the strongest cheap correctness signal
for the KV-cache, recurrent-state and MoE dispatch paths.

The port of ``examples/arch_smoke_all.py`` onto ``repro_torch``: the
same smoke configs, batch (S = 32, B = 2), bf16 weights and 2e-2 bound on
the decode step's logits against the full forward's, relative to their
largest magnitude, and the same line for each arch.  It runs on the card
unless ``--device cpu`` (there the prefill and the forward launch the
flash and SSD kernels; their launch counts end the output), and exits
non-zero if any arch failed.

Run:  PYTHONPATH=src python examples/arch_smoke_all_torch.py [arch ...]
      [--device cpu]
"""
import argparse
import traceback

import torch

from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba2_ssd as SSD
from repro_torch.launch import serve
from repro_torch.launch import specs as sp
from repro_torch.models import model as mdl

S, B = 32, 2
DECODE_TOL = 2e-2


def smoke_arch(arch, device=None, params=None, batch=None):
    """``arch``'s smoke config through ``loss_fn``, ``prefill``, one
    ``decode_step`` and the full ``forward``: (loss, the decode step's
    logits' largest error against the forward's, relative to the
    forward's largest magnitude).  Weights and batch are drawn from a
    generator seeded with 0 (bf16 weights, as the reference's) unless
    ``params`` (an ``mdl.LM``) and ``batch`` (``sp.make_batch``'s tree)
    are given."""
    dev = resolve_device(device)
    cfg = cb.smoke(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    lm = (params if params is not None
          else mdl.init(cfg, gen, torch.bfloat16, dev)).to(dev)
    if batch is None:
        batch = sp.make_batch(cfg, S, B, gen, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.no_grad():
        loss, _ = mdl.loss_fn(lm, cfg, batch)
        assert torch.isfinite(loss), (arch, loss)
        inputs = {k: v for k, v in batch.items()
                  if k not in ("tokens", "labels")}
        tokens = batch["tokens"]
        last, cache = serve.prefill_cache(lm, cfg, tokens, S + 8, inputs)
        tok = torch.argmax(last, -1).to(torch.int32)[:, None]
        logits, _ = mdl.decode_step(lm, cfg, tok, S, cache)
        assert bool(torch.isfinite(logits.float()).all()), arch
        full, _, _ = mdl.forward(lm, cfg, dict(
            inputs, tokens=torch.cat([tokens, tok], dim=1)))
        ref = full[:, -1].float()
        err = (ref - logits.float()).abs().max() / (ref.abs().max() + 1e-6)
    return float(loss), float(err)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*", help="default: every arch")
    ap.add_argument("--device", default=None,
                    help="where the models run (default: the card)")
    args = ap.parse_args(argv)
    archs = args.archs or cb.ARCH_IDS
    FA.launches = SSD.launches = 0
    failed = []
    for arch in archs:
        try:
            loss, err = smoke_arch(arch, args.device)
            print(f"{arch:22s} loss={loss:8.4f} decode_rel_err={err:.3e}")
            assert err <= DECODE_TOL, f"DECODE MISMATCH {arch}"
        except Exception:
            print(f"{arch:22s} FAILED")
            traceback.print_exc()
            failed.append(arch)
    print(f"kernel launches: flash_attention={FA.launches} "
          f"mamba2_ssd={SSD.launches}")
    if failed:
        raise SystemExit(f"arch_smoke_all: {len(failed)} of {len(archs)} "
                         f"archs failed: {failed}")
    print(f"arch_smoke_all OK — {len(archs)} archs, decode == forward "
          f"within {DECODE_TOL}")


if __name__ == "__main__":
    main()
