"""The reference's per-group remat in train mode, in the port: ``LM.loss_fn``
runs each layer group through ``transformer._GroupRemat`` (the reference's
``jax.checkpoint(group_fn)``), whose backward runs the group again under
``torch.func.vjp``.  For each family, reduced and in float32 (dense, MoE,
the Jamba hybrid with the scan's two ``autograd.Function``s inside the
recompute, xLSTM with the sLSTM's loop over time, the VLM's cross
attention, the audio LM's codebooks), one round of C=4 clients and 2 local
steps:

* against the reference's ``build_fl_round_step`` (which remats too), to
  1e-5 as ``tests/test_torch_lm_train_*.py`` hold a round;
* against the port's own round without remat, bit for bit
  (``torch.equal``), in the parallel mode for every family and in the
  sequential mode for the hybrid and the VLM: the recompute runs the same
  ops on the same inputs at the same transform level (its cotangents
  leave detached, so nothing but the recorded graph changes), and the
  gradient of a group's leaves enters the stacked leaf's gradient the same
  way;
* the recompute really ran: every group runs twice a local step, once
  forward and once in the backward."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import build_fl_round_step as j_round
from repro.optim import get_client_optimizer as j_client_opt
from repro.optim import get_server_optimizer as j_server_opt
from repro_torch.core import build_fl_round_step
from repro_torch.models import transformer
from repro_torch.optim import get_client_optimizer, get_server_optimizer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_lm_train_rounds import (STEP_TOL,  # noqa: E402
                                        _assert_tree, _round_setup, rel_err)

FAMILIES = ["granite-3-2b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
            "xlstm-125m", "llama-3.2-vision-90b", "musicgen-medium"]
# sequential mode trains each client under grad_and_value without vmap, so
# the Function's own backward runs there instead of its generated vmap
# rule: held for the family with the scan's two Functions inside the
# recompute and for the VLM's patches
SEQUENTIAL = ["jamba-1.5-large-398b", "llama-3.2-vision-90b"]


def port_round(tm, tp, fl, tb, w, m):
    step = build_fl_round_step(tm.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    return step(tp, (), tb, torch.from_numpy(w), torch.from_numpy(m),
                torch.Generator().manual_seed(2))


def assert_equals_round_without(monkeypatch, out, tm, tp, fl, tb, w, m):
    new, _, met = out
    backbone = transformer.LM._backbone
    monkeypatch.setattr(transformer.LM, "_backbone", lambda self, *a, **k:
                        backbone(self, *a, **dict(k, remat=False)))
    plain, _, plain_met = port_round(tm, tp, fl, tb, w, m)
    monkeypatch.undo()
    assert list(new) == list(plain)
    for k in plain:
        assert torch.equal(new[k], plain[k]), k
    for k in ("client_loss", "delta_norm"):
        assert torch.equal(met[k], plain_met[k]), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_round_matches_reference(arch, monkeypatch):
    """The parallel round: the recompute ran (every group twice a local
    step), the reference's round to 1e-5, the port's round without remat
    bit for bit."""
    jm, tm, jp, tp, jfl, fl, jb, tb, w, m = _round_setup(
        "parallel", "none", arch, {})
    calls = []
    group = transformer.LM._group
    monkeypatch.setattr(transformer.LM, "_group", lambda self, *a, **k: (
        calls.append(k["mode"]), group(self, *a, **k))[1])
    out = port_round(tm, tp, fl, tb, w, m)
    monkeypatch.undo()
    assert calls == ["train"] * (2 * tm.n_groups * fl.local_steps)
    new, _, met = out
    jstep = jax.jit(j_round(jm.loss_fn, j_client_opt("sgd"),
                            j_server_opt("fedavg"), jfl))
    jnew, _, jmet = jstep(jp, (), jb, jnp.asarray(w), jnp.asarray(m),
                          jax.random.PRNGKey(2))
    for key in ("client_loss", "delta_norm"):
        assert rel_err(met[key], jmet[key]) <= STEP_TOL, key
    _assert_tree(new, jnew, STEP_TOL, "params")
    assert_equals_round_without(monkeypatch, out, tm, tp, fl, tb, w, m)


@pytest.mark.parametrize("arch", SEQUENTIAL)
def test_remat_sequential_round_equals_round_without(arch, monkeypatch):
    _, tm, _, tp, _, fl, _, tb, w, m = _round_setup("sequential", "none",
                                                    arch, {})
    assert_equals_round_without(monkeypatch, port_round(tm, tp, fl, tb, w, m),
                                tm, tp, fl, tb, w, m)
