"""The port's serving launcher on the CPU: ``serve.run`` with the
reference's params (copied by ``convert.tree_from_jax``) and a numpy prompt
at temperature 0 gives the same greedy ids as the reference's own
prefill/decode loop, for the VLM (with patches) and the audio family (a
token per codebook) too, and the command line runs with ``--device
cpu``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild
from repro_torch.configs import get_config, reduced
from repro_torch.convert import tree_from_jax
from repro_torch.launch import serve
from repro_torch.models import build_model, token_shape

ROOT = Path(__file__).resolve().parents[1]


def reference_greedy(jm, jp, prompt, gen, patches=None):
    """The reference launcher's loop (repro/launch/serve.py) at
    temperature 0."""
    S0 = prompt.shape[1]
    batch = {} if patches is None else {"patches": jnp.asarray(patches)}
    logits, state = jax.jit(lambda p, x: jm.prefill(
        p, {"tokens": x, **batch}, S0 + gen))(jp, jnp.asarray(prompt,
                                                              jnp.int32))
    decode = jax.jit(jm.decode_step)
    toks = []
    for t in range(gen):
        tok = logits.argmax(-1)
        toks.append(np.asarray(tok))
        logits, state = decode(jp, state, tok.astype(jnp.int32),
                               jnp.int32(S0 + t), batch.get("patches"))
    return np.stack(toks, axis=1)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "paper-charlm",
                                  "llama-3.2-vision-90b", "musicgen-medium"])
def test_greedy_ids_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if arch != "paper-charlm":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    shape = token_shape(cfg, 3, 10)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, shape)
    patches = None
    if cfg.cross_attn_every:
        patches = np.random.default_rng(5).normal(
            size=(3, cfg.n_patches, cfg.d_model)).astype(np.float32)
    gen = 6
    res = serve.run(build_model(cfg), tree_from_jax(jp), prompt, gen, 0.0,
                    torch.Generator().manual_seed(0), patches)
    want = reference_greedy(jm, jp, prompt, gen, patches)
    assert res.ids.shape == want.shape == (3, gen) + shape[2:]
    np.testing.assert_array_equal(res.ids, want)
    assert len(res.logits) == gen + 1
    assert res.prefill_s > 0 and res.decode_s > 0


def test_sampling_draws_from_the_generator():
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    model, params = serve.build(cfg, "cpu", 0)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (2, 8))
    runs = [serve.run(model, params, prompt, 5, 1.0,
                      torch.Generator().manual_seed(s)).ids
            for s in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert runs[0].shape == (2, 5) and (runs[0] < cfg.vocab).all()


def test_sampling_draws_one_token_per_codebook():
    # multinomial over [B, n_cb, V] logits: the leading dims flattened
    # and restored, every id in the vocabulary
    cfg = reduced(get_config("musicgen-medium"))
    model, params = serve.build(cfg, "cpu", 0)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8, 4))
    runs = [serve.run(model, params, prompt, 5, 1.0,
                      torch.Generator().manual_seed(s)).ids for s in (1, 1)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (2, 5, 4) and (runs[0] < cfg.vocab).all()
    assert len(np.unique(runs[0])) > 4


def test_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "jamba-1.5-large-398b", "--temperature", "0", "--batch",
         "2", "--gen", "4"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "arch=jamba-1.5-large-398b-reduced prefill(2x16)" in out.stdout
    assert "generated token ids" in out.stdout


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "musicgen-medium"])
def test_cli_serves_the_vlm_and_audio_families(arch):
    """The VLM draws its patches in ``main``; the audio family's summary
    prints codebook 0's ids, [batch, gen] as for the other families."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--batch", "2", "--gen", "4"], env=env,
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"arch={arch}-reduced prefill(2x16)" in out.stdout
    ids = out.stdout.split("generated token ids:")[1]
    assert ids.count("[") == 3 and len(ids.split()) == 8, ids
