"""The port's LM training rounds on the CPU against the JAX package, from
the same params (the reference's init, carried by ``convert.tree_from_jax``
into the flat view the round takes) and the same numpy tokens: one
paper-charlm round in each client mode, one round of the reduced hybrid
(Jamba), MoE, xLSTM, VLM and audio LMs in each of the parallel and
sequential modes, and three launcher rounds on the synthetic Shakespeare
task.  The setup's helpers are ``test_torch_lm_train_loss.py``'s (the two
files were one).

Tolerances (float32, relative to the largest magnitude of the compared
array): 1e-5 for one round (tests/test_fl_round.py's setup), 1e-4 for
three orchestrated rounds; matmuls and reductions are summed in another
order by XLA and by PyTorch."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.configs import get_config as jget_config
from repro.core import CompressionConfig as JComp
from repro.core import FLConfig as JFL
from repro.core import build_fl_round_step as j_round
from repro.launch import train as j_train
from repro.models import build_model as jbuild
from repro.optim import get_client_optimizer as j_client_opt
from repro.optim import get_server_optimizer as j_server_opt
from repro_torch.convert import tree_from_jax
from repro_torch.core import CompressionConfig, FLConfig, build_fl_round_step
from repro_torch.launch import train as t_train
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict
from test_torch_lm_train_loss import (ROUNDS_TOL, SMALL_CHARLM, STEP_TOL,
                                      _both, lm_batch, rel_err)

# ------------------------------------------------------------- one round
C, H, B, S = 4, 2, 2, 16          # tests/test_fl_round.py's setup
ROUND_COMPRESSION = {
    "none": {},
    "q8_topk_deterministic": dict(quantize_bits=8, topk_frac=0.1,
                                  stochastic_rounding=False)}


def _round_setup(client_exec, comp, arch="paper-charlm",
                 changes=SMALL_CHARLM):
    jm, tm, jp, tp = _both(arch, changes)
    nb = lm_batch(tm.cfg, (C, H, B), S, 1)
    kw = dict(num_clients=C, local_steps=H, client_lr=0.1,
              client_exec=client_exec)
    cc = ROUND_COMPRESSION[comp]
    jfl = JFL(compression=JComp(**cc), **kw)
    fl = FLConfig(compression=CompressionConfig(**cc), **kw)
    w = np.random.default_rng(5).uniform(1, 3, C).astype(np.float32)
    m = np.array([1, 1, 0, 1], np.float32)           # one client cut
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    return jm, tm, jp, tp, jfl, fl, jb, tb, w, m


def _assert_tree(got: dict, want_tree, tol, what):
    want = flat_dict(jax.tree.map(np.asarray, want_tree))
    assert list(got) == list(want)
    for k, v in want.items():
        assert rel_err(got[k], v) <= tol, f"{what} {k}"


@pytest.mark.parametrize("client_exec", ["parallel", "sequential"])
def test_charlm_round_matches_reference(client_exec):
    """A whole round without compression, client training through the
    commit and the server step."""
    jm, tm, jp, tp, jfl, fl, jb, tb, w, m = _round_setup(client_exec, "none")
    jstep = jax.jit(j_round(jm.loss_fn, j_client_opt("sgd"),
                            j_server_opt("fedavg"), jfl))
    step = build_fl_round_step(tm.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    jnew, _, jmet = jstep(jp, (), jb, jnp.asarray(w), jnp.asarray(m),
                          jax.random.PRNGKey(2))
    new, _, met = step(tp, (), tb, torch.from_numpy(w), torch.from_numpy(m),
                       torch.Generator().manual_seed(2))
    for key in ("client_loss", "delta_norm"):
        assert rel_err(met[key], jmet[key]) <= STEP_TOL, key
    _assert_tree(new, jnew, STEP_TOL, "params")


@pytest.mark.parametrize("client_exec", ["parallel", "sequential"])
def test_charlm_compressed_round_matches_reference(client_exec):
    """A round under deterministic q8 + top-k, held in its two halves (the
    parity contract's "discontinuous commits" rule): the clients' deltas
    from local training, then the commit (batched ``combine`` in parallel
    mode, the streaming ``contribution``/``accum_add``/``normalise`` in
    sequential mode) and the server step from the reference's deltas on
    both sides.  Top-k and rounding turn a one-ulp difference in a delta
    into another kept entry or grid point, so whole compressed rounds from
    deltas of different arithmetic agree only where no entry sits on such
    an edge (here 1-4 entries a leaf move by one quantization step)."""
    from repro.core.pipeline import build_update_pipeline as j_pipe
    from repro.core.round import build_local_train as j_local
    from repro_torch.core.pipeline import build_update_pipeline
    from repro_torch.core.round import build_local_train
    jm, tm, jp, tp, jfl, fl, jb, tb, w, m = _round_setup(
        client_exec, "q8_topk_deterministic")
    jtrain = jax.jit(jax.vmap(j_local(jm.loss_fn, j_client_opt("sgd"), jfl),
                              in_axes=(None, 0, 0)))
    jdeltas, jlosses = jtrain(jp, jb, jax.random.split(jax.random.PRNGKey(2),
                                                       C))
    train = build_local_train(tm.loss_fn, get_client_optimizer("sgd"), fl,
                              stacked=True)
    deltas, losses = train(tp, tb)
    # the clients' trained params: a delta of a leaf near 1 (the norms)
    # carries that leaf's float32 rounding, so it is held at the params'
    # scale
    _assert_tree({k: tp[k] + d for k, d in deltas.items()},
                 jax.tree.map(lambda p, d: p[None] + d, jp, jdeltas),
                 STEP_TOL, "trained params")
    assert rel_err(losses, jlosses) <= STEP_TOL

    same = tree_from_jax(jax.tree.map(np.asarray, jdeltas), flat=True)
    same_losses = torch.from_numpy(np.array(jlosses))
    jpipe, pipe = j_pipe(jfl), build_update_pipeline(fl)
    jw, jm_, tw, tm_ = (jnp.asarray(w), jnp.asarray(m), torch.from_numpy(w),
                        torch.from_numpy(m))
    gen, key = torch.Generator().manual_seed(2), jax.random.PRNGKey(2)
    if client_exec == "parallel":
        jdelta = jpipe.combine(jdeltas, jw, jm_, jlosses, key)[0]
        delta = pipe.combine(same, tw, tm_, same_losses, gen)[0]
    else:
        jacc, tacc = jpipe.accum_init(jp), pipe.accum_init(tp)
        jwsum, twsum = 0.0, 0.0
        for c in range(C):
            jwt = jpipe.client_weight(jw[c], jm_[c], jlosses[c])
            jacc = jpipe.accum_add(jacc, jpipe.contribution(
                jax.tree.map(lambda d: d[c], jdeltas), jwt, key))
            twt = pipe.client_weight(tw[c], tm_[c], same_losses[c])
            tacc = pipe.accum_add(tacc, pipe.contribution(
                {k: d[c] for k, d in same.items()}, twt, gen))
            jwsum, twsum = jwsum + jwt, twsum + twt
        jdelta = jpipe.normalise(jacc, jwsum)
        delta = pipe.normalise(tacc, twsum)
    jnew, _ = j_server_opt("fedavg").apply(jp, jdelta, ())
    new, _ = get_server_optimizer("fedavg").apply(tp, delta, ())
    _assert_tree(new, jnew, STEP_TOL, "commit")


# the reduced LMs of the families whose layers only these rounds reach
# under the round's transforms: the hybrid (the scan's two
# autograd.Functions under vmap(grad_and_value) in parallel mode, under
# grad_and_value in sequential mode), the MoE (its sort-based dispatch
# under vmap), the xLSTM (the sLSTM's loop over time), the VLM (each
# client's patches [C, H, B, n_patches, D] under vmap) and the audio LM
# (the codebooks' embedding sum under vmap)
FAMILY_ROUNDS = ["jamba-1.5-large-398b", "qwen3-moe-235b-a22b", "xlstm-125m",
                 "llama-3.2-vision-90b", "musicgen-medium"]


@pytest.mark.parametrize("client_exec", ["parallel", "sequential"])
@pytest.mark.parametrize("arch", FAMILY_ROUNDS)
def test_family_round_matches_reference(arch, client_exec):
    """One uncompressed round of C=4 clients, 2 local steps of batch 2 x 16
    tokens: the metrics and the new params against the reference's
    ``build_fl_round_step``."""
    jm, tm, jp, tp, jfl, fl, jb, tb, w, m = _round_setup(
        client_exec, "none", arch, {})
    jstep = jax.jit(j_round(jm.loss_fn, j_client_opt("sgd"),
                            j_server_opt("fedavg"), jfl))
    step = build_fl_round_step(tm.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    jnew, _, jmet = jstep(jp, (), jb, jnp.asarray(w), jnp.asarray(m),
                          jax.random.PRNGKey(2))
    new, _, met = step(tp, (), tb, torch.from_numpy(w), torch.from_numpy(m),
                       torch.Generator().manual_seed(2))
    for key in ("client_loss", "delta_norm"):
        assert rel_err(met[key], jmet[key]) <= STEP_TOL, key
    _assert_tree(new, jnew, STEP_TOL, "params")


# ------------------------------------------------------ three launcher rounds
LAUNCH = ["--dataset", "shakespeare", "--rounds", "3", "--clients-pool", "6",
          "--clients-per-round", "3", "--local-steps", "1", "--batch-size",
          "4", "--checkpoint-every", "1"]


def test_launcher_shakespeare_three_rounds_match_reference(
        tmp_path, monkeypatch, capsys):
    """Both launchers run three rounds of paper-charlm at full width on a
    6-client pool and checkpoint every round; the port's run starts from
    the reference's initial params (its own init draws from a torch
    generator).  The final checkpoints' params agree to 1e-4, the
    simulated clock and bytes exactly."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    monkeypatch.setattr(sys, "argv", ["train", "--checkpoint-dir", str(jdir)]
                        + LAUNCH)
    j_train.main()
    jout = capsys.readouterr().out
    jsum = json.loads(jout[jout.index("{"):])

    jm = jbuild(jget_config("paper-charlm"))
    jp0 = jm.init(jax.random.PRNGKey(0))
    build_task = t_train.build_task

    def reference_init(*a, **kw):
        fed, model, params, eval_fn = build_task(*a, **kw)
        return fed, model, tree_from_jax(jp0, flat=True), eval_fn

    monkeypatch.setattr(t_train, "build_task", reference_init)
    summary = t_train.main(["--device", "cpu", "--checkpoint-dir", str(tdir)]
                           + LAUNCH)
    for key in ("virtual_time_s", "mean_bytes_per_client_round", "rounds"):
        assert summary[key] == jsum[key], key
    assert np.isnan(summary["final_eval"]) and np.isnan(jsum["final_eval"])
    assert all(np.isfinite(summary["client_loss"]))

    like = jax.tree.map(np.asarray, jp0)
    want, _, jmeta = JCkpt(jdir).restore(like)
    got, _, meta = JCkpt(tdir).restore(like)   # the port's files
    assert meta == jmeta
    for k, v in flat_dict(want).items():
        assert rel_err(flat_dict(got)[k], v) <= ROUNDS_TOL, k
