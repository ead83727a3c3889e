#!/usr/bin/env python3
"""Time this checkout's gallery-match, cell-rescore, flash-attention or
SSD kernel (forward or backward) against another checkout's, on one GPU,
in one process.

    python3 kernel_compare.py OTHER_CHECKOUT [--shapes Q:k,...] [--qk N]
                              [--exact]
    python3 kernel_compare.py OTHER_CHECKOUT --kernel rescore [--exact]
    python3 kernel_compare.py OTHER_CHECKOUT --kernel flash [--exact]
    python3 kernel_compare.py OTHER_CHECKOUT --kernel ssd [--exact]
    python3 kernel_compare.py OTHER_CHECKOUT --kernel flash-backward
    python3 kernel_compare.py OTHER_CHECKOUT --kernel ssd-backward

OTHER_CHECKOUT is another checkout of this repository, for example the
parent commit unpacked with ``git archive``.  Each kernel is built with
``nvcc`` from its own checkout's sources; both are then held against each
other on one input, and timed in turns (other, this, this, other) with
``chip_smoke.py``'s device timing (profiler kernel time).

``--kernel gallery`` (the default): on the same four 262,144-row
galleries, at D = 128 and each (Q, k) of ``--shapes`` (default: Q in
{1, Q_S, 16, 256} x k in {1, 5}), in each storage dtype.  ``--qk N`` sets
this checkout's small-Q path limit on Q * k for the run
(``gallery_match.SMALL_QK``), to time that path where ``plan`` would not
take it.

``--kernel rescore``: the cell rescore through each checkout's wrapper
(``cell_rescore_cuda``), on phase 4's serving inputs (``chip_smoke``:
four shards of 1024 ragged cells of 262,144 rows, 16 probe tables each,
c = 8) at Q in {1, 16, 256} x k in {1, 5}, in each storage dtype; the
two held to each other on every call of a round (scores within
``chip_smoke.TOL``, the same slots filled), then device ms and call ms
(CUDA events around back-to-back calls, so the host's share too).

``--kernel ssd``: the Mamba-2 SSD scan at zamba2's serving shape
(``chip_smoke.SSD_SERVE``, as the model's strided views) in bf16 and fp32,
y and the final state of the two held to ``chip_smoke``'s SSD bounds.

``--kernel flash``: the flash-attention forward (serving's instance: no
graph, so no lse) at the ten serving shapes (``chip_smoke.FLASH_SERVE``,
as the model's strided views) in bf16 and fp32, the outputs held to
``chip_smoke.FLASH_TOL``.

``--kernel flash-backward`` / ``ssd-backward``: the gradient through each
checkout's autograd Function (``FlashAttention``, ``MambaSSD``) at the
training shapes (``chip_smoke.FLASH_TRAIN``, ``SSD_TRAIN``) in bf16 and
fp32, one graph each, its backward timed alone (``retain_graph``); the
gradients held to ``chip_smoke.FLASH_BWD_REL`` / ``SSD_BWD_REL``.  A
checkout without backward kernels differentiates its plain versions.

``--exact`` (gallery, rescore, flash, ssd and the backwards): the two
must agree bit for bit, as a change that keeps a kernel's arithmetic
must.

Prints the card, one line per shape, and a JSON object with every time.
Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def load_other(other: Path, _build, name: str, sources=None):
    """The other checkout's wrapper module ``name`` (``gallery_match``,
    ``ann_match``, ``flash_attention`` or ``mamba2_ssd``), bound to its own
    kernels ``csrc/{source}.cu`` for each of ``sources`` (default:
    ``name``; a source the other checkout lacks is skipped) built into
    this checkout's build directory.  The module reads its own sources
    (``_build.CSRC``) and binds its own libraries."""
    sources = sources or (name,)
    src = other / "src" / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(f"other_{name}",
                                                  src / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # for its dataclasses
    spec.loader.exec_module(mod)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def compile_one(source):
        so = _build.BUILD_DIR / f"other_{source}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src / "csrc" / f"{source}.cu")], check=True)
        return source, ctypes.CDLL(str(so))

    present = [s for s in sources if (src / "csrc" / f"{s}.cu").exists()]
    with ThreadPoolExecutor(len(present)) as pool:
        libs = dict(pool.map(compile_one, present))
    own = types.SimpleNamespace(**{k: v for k, v in vars(_build).items()
                                   if not k.startswith("__")})
    own.CSRC = src / "csrc"
    own.library = lambda source: libs[source]
    mod._build = own
    mod._library()
    return mod


def build_both(own, other: Path, _build, name: str, sources=None,
               builds=None):
    """This checkout's module ``own`` built (``builds``: its build
    functions, default ``own.build``), and the other checkout's."""
    builds = builds or (own.build,)
    with ThreadPoolExecutor(1 + len(builds)) as pool:
        mine = [pool.submit(b) for b in builds]
        theirs = pool.submit(load_other, other.resolve(), _build, name,
                             sources)
        for m in mine:
            m.result()
        return theirs.result()


def in_turns(cs, torch, fn_of, args):
    """Device ms (``other``, ``this``) and call ms (``other_call``,
    ``this_call``) of ``fn_of(mod)`` timed on ``args`` in turns: other,
    this, this, other."""
    times = {"other": [], "this": [], "other_call": [], "this_call": []}
    for name in ("other", "this", "this", "other"):
        ms, call_ms = cs.timed(torch, fn_of(name), args)
        times[name].append(ms)
        times[f"{name}_call"].append(call_ms)
    return times


def same(torch, a, b) -> bool:
    """Two (scores, indices) results equal bit for bit."""
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def compare_gallery(cs, torch, _build, other, shapes_arg, qk, exact):
    from repro_torch.kernels import gallery_match as gm
    if qk is not None:
        gm.SMALL_QK = qk
    shapes = ([tuple(int(x) for x in p.split(":"))
               for p in shapes_arg.split(",")] if shapes_arg else
              [(Q, k) for Q in (1, gm.SMALL_Q, 16, 256) for k in (1, 5)])
    ogm = build_both(gm, other, _build, "gallery_match")
    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for dtype in cs.DTYPES:
        shards = [cs.gallery(torch, gm, dtype, cs.N_BIG, 128, gen)
                  for _ in range(4)]
        for Q, k in shapes:
            q = torch.randn((Q, 128), generator=gen, device="cuda")
            a = cs.run_kernel(ogm, q, *shards[0], k)
            b = cs.run_kernel(gm, q, *shards[0], k)
            err = float((a[0] - b[0]).abs().max())
            if not err <= cs.TOL or (exact and not same(torch, a, b)):
                raise AssertionError(f"{dtype} Q={Q} k={k}: the two "
                                     f"kernels differ by {err}")
            times = in_turns(cs, torch, lambda name: (
                lambda g, sc, mod=(ogm if name == "other" else gm):
                cs.run_kernel(mod, q, g, sc, k)), shards)
            o, t = (sum(v) / 2 for v in (times["other"], times["this"]))
            rows.append({"dtype": dtype, "Q": Q, "k": k,
                         "path": gm.last_plan[0], **times,
                         "this_over_other": t / o})
            print(f"[compare] {dtype} Q={Q:3d} k={k}: other "
                  f"{times['other'][0]:.4f} {times['other'][1]:.4f} ms, "
                  f"this {times['this'][0]:.4f} {times['this'][1]:.4f} ms "
                  f"({gm.last_plan[0]} path), this/other {t / o:.3f}")
        del shards
    return rows


def compare_rescore(cs, torch, _build, other, exact):
    from repro_torch.kernels import ann_match as A
    from repro_torch.kernels import gallery_match as gm
    oA = build_both(A, other, _build, "ann_match", ("cell_rescore",))
    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for dtype in cs.DTYPES:
        shards = [cs.shard_cells(torch, gm, dtype, cs.CELLS, 128, gen)
                  for _ in range(4)]
        for Q in (1, 16, 256):
            for k in (1, 5):
                q = torch.randn((Q, 128), generator=gen, device="cuda")
                calls = [(q, cells, scale, cs.probe_table(
                    torch, Q, cs.NPROBE, cs.CELLS, gen), lens, L, k)
                    for cells, scale, lens, L in shards for _ in range(16)]
                for args in calls:
                    a = cs.run_rescore(oA, *args)
                    b = cs.run_rescore(A, *args)
                    err = float((a[0] - b[0]).abs().max())
                    if not (err <= cs.TOL and torch.equal(a[1] < 0,
                                                          b[1] < 0)) or (
                            exact and not same(torch, a, b)):
                        raise AssertionError(
                            f"rescore {dtype} Q={Q} k={k}: the two kernels "
                            f"differ (score error {err})")
                times = in_turns(cs, torch, lambda name: (
                    lambda *t, mod=(oA if name == "other" else A):
                    cs.run_rescore(mod, *t)), calls)
                o, t, oc, tc = (sum(times[n]) / 2 for n in (
                    "other", "this", "other_call", "this_call"))
                rows.append({"dtype": dtype, "Q": Q, "c": cs.NPROBE, "k": k,
                             "plan": list(A.last_plan), **times,
                             "this_over_other": t / o,
                             "call_this_over_other": tc / oc})
                print(f"[compare] rescore {dtype} Q={Q:3d} c={cs.NPROBE} "
                      f"k={k}: other {times['other'][0]:.4f} "
                      f"{times['other'][1]:.4f} ms (call {oc:.4f}), this "
                      f"{times['this'][0]:.4f} {times['this'][1]:.4f} ms "
                      f"(call {tc:.4f}; {A.last_plan[0]} path, "
                      f"{A.last_plan[1]} warps a block, {A.last_plan[3]} "
                      f"pass), this/other "
                      f"{t / o:.3f}, calls {tc / oc:.3f}")
        del shards
    return rows


def compare_ssd(cs, torch, _build, other, exact):
    from repro_torch.kernels import mamba2_ssd as SSD
    ossd = build_both(SSD, other, _build, "mamba2_ssd")
    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for dtype in cs.LM_DTYPES:
        args = [cs.ssd_inputs(torch, cs.SSD_SERVE, dtype, gen, True)]
        a = ossd.mamba2_ssd_cuda(*args[0])
        b = SSD.mamba2_ssd_cuda(*args[0])
        for what, got, want in zip(("y", "state"), b, a):
            if not cs.ssd_close(torch, got, want) or (
                    exact and not torch.equal(got, want)):
                raise AssertionError(
                    f"ssd {dtype}: the two kernels' {what} differ by "
                    f"{float((got - want).abs().max()):.3g} (atol "
                    f"{cs.SSD_ATOL}, rtol {cs.SSD_RTOL})")
        times = in_turns(cs, torch, lambda name: (
            lambda *t, mod=(ossd if name == "other" else SSD):
            mod.mamba2_ssd_cuda(*t)), args)
        o, t = (sum(v) / 2 for v in (times["other"], times["this"]))
        rows.append({"dtype": dtype, "shape": list(cs.SSD_SERVE),
                     "path": SSD.last_plan, **times, "this_over_other": t / o})
        print(f"[compare] ssd {dtype} {cs.SSD_SERVE}: other "
              f"{times['other'][0]:.4f} {times['other'][1]:.4f} ms, this "
              f"{times['this'][0]:.4f} {times['this'][1]:.4f} ms "
              f"({SSD.last_plan} path), this/other {t / o:.3f}")
        del args, a, b
    return rows


def compare_flash(cs, torch, _build, other, exact):
    from repro_torch.kernels import flash_attention as FA
    ofa = build_both(FA, other, _build, "flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for dtype in cs.LM_DTYPES:
        for name, shape in cs.FLASH_SERVE.items():
            causal, window = shape[7], shape[8]
            args = [cs.flash_inputs(torch, shape, dtype, gen, True)]
            a = ofa.flash_attention_cuda(*args[0], causal=causal,
                                         window=window)
            b = FA.flash_attention_cuda(*args[0], causal=causal,
                                        window=window)
            err = cs.flash_err(torch, b, a, dtype)
            same = torch.equal(a, b)
            if not err <= cs.FLASH_TOL[dtype] or (exact and not same):
                raise AssertionError(f"flash {dtype} {name}: the two "
                                     f"kernels differ ({err:.3g})")
            times = in_turns(cs, torch, lambda mod: (
                lambda q, k, v, m=(ofa if mod == "other" else FA):
                m.flash_attention_cuda(q, k, v, causal=causal,
                                       window=window)), args)
            o, t = (sum(v) / 2 for v in (times["other"], times["this"]))
            rows.append({"dtype": dtype, "name": name, "shape": list(shape),
                         "bit_identical": same, **times,
                         "this_over_other": t / o})
            print(f"[compare] flash {dtype} {name} {shape[:7]}: "
                  f"bit-identical {same}; other {times['other'][0]:.4f} "
                  f"{times['other'][1]:.4f} ms, this {times['this'][0]:.4f} "
                  f"{times['this'][1]:.4f} ms, this/other {t / o:.3f}")
            del args, a, b
    return rows


def graph_grads(torch, fn, inputs, grad):
    """(the gradients, a function that runs the backward again): one graph
    of ``fn`` on copies of ``inputs`` that require grad, kept
    (``retain_graph``)."""
    ins = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ins)
    out = out[0] if isinstance(out, tuple) else out

    def backward():
        return torch.autograd.grad(out, ins, grad, retain_graph=True)
    return backward(), backward


def compare_backward(cs, torch, _build, other, kernel, exact):
    """--kernel flash-backward / ssd-backward: each checkout's autograd
    Function's backward at the training shapes, held to each other and
    timed in turns."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba2_ssd as SSD
    gen = torch.Generator(device="cuda").manual_seed(99)
    if kernel == "flash-backward":
        mine = FA
        theirs = build_both(FA, other, _build, "flash_attention",
                            ("flash_attention", "flash_attention_lse",
                             "flash_attention_bwd"),
                            (FA.build, FA.build_lse, FA.build_backward))
        bound = cs.FLASH_BWD_REL
        cases = []
        for name, shape in cs.FLASH_TRAIN.items():
            B, H, Kh, Sq, Sk, D, Dv, causal, window = shape
            cases.append((name, shape, lambda dtype, shape=shape: (
                cs.flash_inputs(torch, shape, dtype, gen, True),
                torch.randn((shape[0], shape[1], shape[3], shape[6]),
                            generator=gen, device="cuda")),
                lambda mod, causal=causal, window=window: (
                    lambda q, k, v: mod.flash_attention_cuda(
                        q, k, v, causal=causal, window=window))))
    else:
        mine = SSD
        theirs = build_both(SSD, other, _build, "mamba2_ssd",
                            ("mamba2_ssd", "mamba2_ssd_bwd"),
                            (SSD.build, SSD.build_backward))
        bound = cs.SSD_BWD_REL
        shape = cs.SSD_TRAIN
        cases = [("zamba2", shape, lambda dtype: cs.ssd_grad_inputs(
            torch, shape, dtype, gen, True),
            lambda mod: (lambda *a: mod.mamba2_ssd_cuda(*a,
                                                        chunk=shape[5])))]
    rows = []
    for dtype in cs.LM_DTYPES:
        for name, shape, make, fn_of in cases:
            inputs, grad = make(dtype)
            grad = grad.to(inputs[0].dtype) if kernel == "flash-backward" \
                else grad
            ga, run_a = graph_grads(torch, fn_of(theirs), inputs, grad)
            gb, run_b = graph_grads(torch, fn_of(mine), inputs, grad)
            errs = [cs.rel_fro(torch, b, a) for a, b in zip(ga, gb)]
            same = all(torch.equal(a, b) for a, b in zip(ga, gb))
            if not max(errs) <= bound[dtype] or (exact and not same):
                raise AssertionError(f"{kernel} {dtype} {name}: the two "
                                     f"gradients differ ({errs})")
            times = in_turns(cs, torch, lambda mod: (
                run_a if mod == "other" else run_b), [()])
            o, t = (sum(v) / 2 for v in (times["other"], times["this"]))
            rows.append({"kernel": kernel, "dtype": dtype, "name": name,
                         "shape": list(shape), "rel_errors": errs,
                         "bit_identical": same, **times,
                         "this_over_other": t / o})
            print(f"[compare] {kernel} {dtype} {name} {tuple(shape)}: "
                  f"gradients' relative errors "
                  + ", ".join(f"{e:.3g}" for e in errs)
                  + f" (bit-identical {same}); other "
                  f"{times['other'][0]:.4f} ms, this {times['this'][0]:.4f} "
                  f"ms, this/other {t / o:.3f}")
            del inputs, grad, ga, gb, run_a, run_b
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(usage=__doc__)
    ap.add_argument("other", type=Path)
    ap.add_argument("--kernel", choices=("gallery", "rescore", "flash", "ssd",
                                         "flash-backward", "ssd-backward"),
                    default="gallery")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--qk", type=int, default=None)
    ap.add_argument("--exact", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    card = cs.card_line()
    print(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.kernel == "ssd":
        rows = compare_ssd(cs, torch, _build, args.other, args.exact)
    elif args.kernel == "flash":
        rows = compare_flash(cs, torch, _build, args.other, args.exact)
    elif args.kernel.endswith("-backward"):
        rows = compare_backward(cs, torch, _build, args.other, args.kernel,
                                args.exact)
    elif args.kernel == "rescore":
        rows = compare_rescore(cs, torch, _build, args.other, args.exact)
    else:
        rows = compare_gallery(cs, torch, _build, args.other, args.shapes,
                               args.qk, args.exact)
    print(card)
    print(json.dumps({"compare": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
