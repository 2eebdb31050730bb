"""Package rules of the PyTorch port: ``repro_torch``, ``chip_smoke.py``
and the example drivers (``examples_torch/``) import neither JAX nor the
JAX package, the launchers (training and serving), the worker and the
examples refuse to run on the CPU unless asked to, and a CPU run, a round
or a serve, never reaches the kernel builder."""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import worker
from repro_torch.launch import serve, train

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = ("jax", "jaxlib", "repro")

BLOCKED_RUN = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now raises
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke                     # its imports, without running it
examples = sorted(m.name for m in pkgutil.iter_modules(["examples_torch"]))
assert len(examples) == 5, examples
for name in examples:                 # the example drivers, not run
    importlib.import_module("examples_torch." + name)
from repro_torch.kernels import _build


def refuse(*args, **kwargs):
    raise AssertionError("a CPU run reached the kernel builder")


_build.library = _build.launch = refuse

import numpy as np, torch
from repro_torch.core import CompressionConfig, FLConfig, build_fl_round_step
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.optim import get_client_optimizer, get_server_optimizer
cfg = CNNConfig("t", (8, 8, 1), 3, channels=(4, 8), dense=16)
model = CNN(cfg)
params = model.init(torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
batches = {"image": torch.from_numpy(rng.normal(size=(3, 1, 4, 8, 8, 1))
                                     .astype(np.float32)),
           "label": torch.from_numpy(rng.integers(0, 3, (3, 1, 4))
                                     .astype(np.int32))}
for comp in (CompressionConfig(),
             CompressionConfig(quantize_bits=8, topk_frac=0.1),
             CompressionConfig(quantize_bits=8, topk_frac=0.1,
                               stochastic_rounding=False),
             CompressionConfig(quantize_bits=8, dropout_frac=0.1,
                               stochastic_rounding=False)):
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"),
                               FLConfig(num_clients=3, local_steps=1,
                                        compression=comp))
    step(params, (), batches, torch.ones(3), torch.ones(3),
         torch.Generator().manual_seed(0))
import contextlib, io
from repro_torch.launch import serve
with contextlib.redirect_stdout(io.StringIO()):
    res = serve.main(["--device", "cpu", "--arch", "jamba-1.5-large-398b",
                      "--batch", "1", "--gen", "2", "--temperature", "0"])
assert res.ids.shape == (1, 2)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
            and sys.modules[m] is not None]
print("OK", len(mods))
"""


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_and_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        assert train.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--rounds", "1"])


def test_worker_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        assert train.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.main(["--client-id", "0", "--workdir", str(tmp_path),
                     "--once"])


def test_serve_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        assert serve.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "paper-charlm", "--gen", "1"])


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# the function of each example that does its work: main must refuse the
# card before it is reached
EXAMPLE_WORK = {"quickstart": ("run",), "async_hybrid_sim": ("run",),
                "hybrid_hpc_cloud_sim": ("schedule", "train"),
                "federated_llm_finetune": ("run",),
                "train_100m": ("setting", "build")}


def test_examples_are_the_reference_five():
    assert sorted(p.stem for p in EXAMPLES) == sorted(EXAMPLE_WORK)
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) \
        == sorted(EXAMPLE_WORK)


@pytest.mark.parametrize("name", sorted(EXAMPLE_WORK))
def test_example_refuses_cuda_without_a_card(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert f"examples/{name}.py" in mod.__doc__
    if torch.cuda.is_available():
        assert mod.resolve_device("cuda").type == "cuda"
        return

    def refuse(*args, **kwargs):
        raise AssertionError(f"{name}: work began without a device")

    for fn in EXAMPLE_WORK[name]:
        monkeypatch.setattr(mod, fn, refuse)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
