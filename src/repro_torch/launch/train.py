"""End-to-end training entry point.

The port of the reference's ``launch/train.py``, with its flags and its
checklist:
  * deterministic step-indexed data pipeline with prefetch
    (``TokenStream``, ``Prefetcher``);
  * the train step with microbatching (``launch/steps.py``), AdamW with
    a cosine warmup;
  * async checkpointing with atomic commit + restart from failure:
    ``--simulate-failure N`` crashes after step N, restores the latest
    committed snapshot and replays the stream from there with no sample
    lost or repeated.

Weights are drawn in fp32 (the reference trains in fp32) from a
``torch.Generator`` seeded with 0 on the device.  ``--device`` defaults to
the card and raises without one; ``--device cpu`` runs on the CPU.  Each
log line gives the loss and, for the steps since the last line, the mean
wall ms a step, tokens/s and the peak device memory; ``main`` returns the
final loss.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import base as cb
from repro_torch.data import DataConfig, Prefetcher, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as mdl
from repro_torch.models.params import trainable
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.optim.optimizers import named_leaves


def _load(params, values):
    """Copy restored values into the model's parameters."""
    with torch.no_grad():
        for name, p in named_leaves(params).items():
            p.copy_(values[name])


class _Clock:
    """Wall ms of each step (the device synchronised after it) and the
    peak device memory since the last read."""

    def __init__(self, dev):
        self.dev, self.ms, self.t = dev, [], time.perf_counter()
        self.sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)

    def start(self):
        self.sync()
        self.t = time.perf_counter()

    def stop(self):
        self.sync()
        self.ms.append((time.perf_counter() - self.t) * 1e3)

    def read(self, tokens_a_step: int) -> str:
        ms = sum(self.ms) / max(len(self.ms), 1)
        self.ms = []
        if self.dev.type == "cuda":
            peak = f"{torch.cuda.max_memory_allocated(self.dev) / 2**30:.2f}"
            torch.cuda.reset_peak_memory_stats(self.dev)
        else:
            peak = "n/a (cpu)"
        return (f"step wall ms {ms:.1f} tok/s "
                f"{tokens_a_step / max(ms, 1e-9) * 1e3:,.0f} peak GiB {peak}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=cb.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="crash+recover at this step (elastic demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    cfg = cb.smoke(args.arch) if args.smoke else cb.get(args.arch)
    opt = adamw(cosine_warmup(args.lr, warmup=20, total=args.steps),
                weight_decay=0.01)
    step_fn = make_train_step(cfg, opt, n_micro=args.n_micro)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = trainable(mdl.init(cfg, gen, torch.float32, dev))
    opt_state = opt.init(params)
    store = CheckpointStore(args.ckpt_dir)
    start = 0
    if args.resume and store.latest_step() is not None:
        start, state = store.restore({"p": named_leaves(params),
                                      "o": opt_state})
        _load(params, state["p"])
        opt_state = state["o"]
        print(f"[train] resumed from step {start}")
    n = sum(p.numel() for p in named_leaves(params).values())
    print(f"[train] {cfg.name}: {n / 1e6:,.1f}M fp32 parameters on "
          f"{dev.type}, batch {args.batch} x seq {args.seq}, n_micro "
          f"{args.n_micro}, remat {cfg.remat}")

    dcfg = DataConfig(seed=1, vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    tokens_a_step = args.batch * args.seq
    clock = _Clock(dev)

    def run(pf, step, recovered=False):
        """Steps from ``step`` to ``args.steps``: (last step, metrics).
        Before a recovery it saves every ``ckpt_every`` steps and crashes
        at ``simulate_failure``; the replay after one does neither, as the
        reference's."""
        nonlocal params, opt_state
        metrics = None
        while step < args.steps:
            i, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            clock.start()
            params, opt_state, metrics = step_fn(params, opt_state, batch, i)
            clock.stop()
            step = i + 1
            if not recovered and args.simulate_failure and \
                    step == args.simulate_failure:
                raise RuntimeError("simulated node failure")
            if step % args.log_every == 0 or step == args.steps:
                print(f"[train] step {step:5d} loss "
                      f"{float(metrics['loss']):7.4f} lr "
                      f"{float(metrics['lr']):.2e} gnorm "
                      f"{float(metrics['grad_norm']):.3f} "
                      f"{clock.read(tokens_a_step)}"
                      + (" (post-recovery)" if recovered else ""))
            if not recovered and step % args.ckpt_every == 0:
                store.save(step, {"p": named_leaves(params), "o": opt_state})
        return step, metrics

    pf = Prefetcher(TokenStream(dcfg), start_step=start)
    try:
        step, metrics = run(pf, start)
    except RuntimeError as e:
        if "simulated" not in str(e):
            raise
        pf.close()
        print(f"[train] {e} at step {args.simulate_failure} — recovering "
              "from checkpoint")
        store.wait()
        rstep, state = store.restore({"p": named_leaves(params),
                                      "o": opt_state})
        _load(params, state["p"])
        opt_state = state["o"]
        del state
        pf = Prefetcher(TokenStream(dcfg), start_step=rstep)
        print(f"[train] re-meshed + restored step {rstep}; replaying stream")
        step, metrics = run(pf, rstep, recovered=True)
    finally:
        pf.close()
        store.wait()

    final = float(metrics["loss"])
    print(f"[train] done at step {step}; final loss {final:.4f}")
    return final


if __name__ == "__main__":
    main()
