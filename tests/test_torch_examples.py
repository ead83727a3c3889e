"""The port's examples (``examples/*_torch.py``) on the CPU, beside the
reference's scripts they mirror.

* The five engine scenarios run in virtual time on the copied engine, so
  each prints exactly what the reference's script prints: both run as
  subprocesses (from a copy of both scripts in one temporary directory,
  where ``trace_chaos`` writes its trace), their standard output compared
  byte for byte.
* ``quickstart_torch.py`` and ``serve_biometric_torch.py`` run with
  ``--device cpu`` and must exit 0 with their OK lines.
* ``arch_smoke_all_torch.py``'s per-arch function runs tinyllama and
  zamba2 on the reference's bf16 weights (``convert.lm_params``) and
  batch.  The loss must agree with the reference's within LOSS_TOL: both
  sides compute it from the same bf16 weights, but round the bf16
  activations at other places and sum in other orders (measured on the
  CPU: 4.6e-5 for tinyllama, 3.9e-5 for zamba2, of a loss of 5.59; the
  bound is about ten times that); the decode step must agree with the full
  forward within the reference's 2e-2.
* ``specs.make_batch``'s labels: in range, drawn after everything serving
  draws.
"""
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as cb
from repro.launch import specs as rsp
from repro.models import model as rm
from repro.sharding import init_params
from repro_torch import convert
from repro_torch.configs import base as pcb
from repro_torch.launch import specs as psp

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SCENARIOS = ["replicated_lanes", "mixed_lanes", "power_budget",
             "trace_chaos", "fabric_scaling"]
LOSS_TOL = 5e-4


def _run(script, *args, cwd=ROOT, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          env=env, capture_output=True, timeout=timeout)


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_scenario_prints_what_the_reference_prints(name, tmp_path):
    for script in (f"{name}.py", f"{name}_torch.py"):
        shutil.copy(EXAMPLES / script, tmp_path / script)
    ref = _run(tmp_path / f"{name}.py", cwd=tmp_path)
    port = _run(tmp_path / f"{name}_torch.py", cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr.decode()[-2000:]
    assert port.returncode == 0, port.stderr.decode()[-2000:]
    assert port.stdout == ref.stdout
    assert len(ref.stdout) > 200


@pytest.mark.parametrize("name,ok", [
    ("quickstart", b"quickstart OK"),
    ("serve_biometric", b"serve_biometric OK")])
def test_main_path_example_runs_on_the_cpu(name, ok):
    res = _run(EXAMPLES / f"{name}_torch.py", "--device", "cpu")
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert ok in res.stdout
    assert b"lost=0" in res.stdout


def _arch_smoke():
    spec = importlib.util.spec_from_file_location(
        "arch_smoke_all_torch", EXAMPLES / "arch_smoke_all_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_arch_smoke_on_the_reference_weights(arch):
    """The example's per-arch check on the reference's bf16 weights and
    batch (``make_batch`` under ``PRNGKey(0)``, as its script draws them):
    the loss as the reference's, and decode == forward within 2e-2."""
    smoke = _arch_smoke()
    cfg = cb.smoke(arch)
    key = jax.random.PRNGKey(0)
    params = init_params(rm.param_specs(cfg), key, jnp.bfloat16)
    batch = rsp.make_batch(cfg, smoke.S, smoke.B, key)
    ref_loss, _ = jax.jit(lambda p, b: rm.loss_fn(p, cfg, b))(params, batch)
    lm = convert.lm_params(pcb.smoke(arch), jax.tree.map(np.asarray, params))
    port_batch = {k: torch.from_numpy(np.array(v)) for k, v in
                  batch.items()}
    loss, err = smoke.smoke_arch(arch, "cpu", params=lm, batch=port_batch)
    assert abs(loss - float(ref_loss)) <= LOSS_TOL, (loss, float(ref_loss))
    assert err <= smoke.DECODE_TOL


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-26b",
                                  "whisper-base"])
def test_make_batch_labels_leave_serving_draws_unchanged(arch):
    """Labels (B, S) in [0, vocab), drawn last: the tokens and modality
    inputs of a batch with labels are those of one without."""
    cfg = pcb.smoke(arch)
    with_labels = psp.make_batch(cfg, 16, 3, torch.Generator().manual_seed(5))
    serving = psp.make_batch(cfg, 16, 3, torch.Generator().manual_seed(5),
                             with_labels=False)
    labels = with_labels.pop("labels")
    assert "labels" not in serving and with_labels.keys() == serving.keys()
    for k in serving:
        assert torch.equal(with_labels[k], serving[k]), k
    assert labels.shape == (3, 16) and labels.dtype == torch.int32
    assert int(labels.min()) >= 0 and int(labels.max()) < cfg.vocab_size
    assert not torch.equal(labels, with_labels["tokens"])


def _elastic():
    spec = importlib.util.spec_from_file_location(
        "elastic_recovery_torch", EXAMPLES / "elastic_recovery_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("device", ["cpu", "meta", None])
def test_elastic_example_passes_its_device_to_train(device, monkeypatch,
                                                     capsys):
    """``elastic_recovery_torch.py`` trains where ``--device`` says, the
    card by default (resolved as ``train.main`` resolves it): both of its
    runs get that device, and nothing else of their arguments changes."""
    mod = _elastic()
    calls = []

    def fake_main(argv):
        calls.append(list(argv))
        return 1.0

    monkeypatch.setattr(mod.train, "main", fake_main)
    argv = [] if device is None else ["--device", device]
    if device is None and not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mod.main(argv)
        assert calls == []
        return
    mod.main(argv)
    assert len(calls) == 2
    for call in calls:
        i = call.index("--device")
        assert call[i + 1] == (device or "cuda")
        assert call.count("--device") == 1
    assert "--simulate-failure" not in calls[0]
    assert calls[1][calls[1].index("--simulate-failure") + 1] == "80"
    assert "elastic_recovery_torch OK" in capsys.readouterr().out


def test_port_examples_import_neither_jax_nor_the_reference():
    """Every ``examples/*_torch.py`` imports the port alone, and sets no
    ``JAX_PLATFORMS``."""
    import ast
    scripts = sorted(EXAMPLES.glob("*_torch.py"))
    assert len(scripts) == 11          # the nine examples, training, elastic
    for f in scripts:
        text = f.read_text()
        assert "JAX_PLATFORMS" not in text, f
        for node in ast.walk(ast.parse(text)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (f, n)
