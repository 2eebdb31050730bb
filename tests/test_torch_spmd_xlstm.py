"""The recurrent families' rounds across real processes (four ``gloo``
ranks on the CPU, ``pod`` 2 x ``data`` 2 x ``model`` 1): the reduced
xlstm-125m in parallel (clients over ``pod`` and ``data``; the sLSTM's
heads stay whole, ``model`` being 1) and sequential rounds (each client's
batch over ``data``) against the JAX reference's unsharded round, with
``tests/test_mesh_small.py``'s bounds (``test_torch_spmd_lm.py`` holds the
setup); and the reduced Jamba's sequential round, its selective scan and
the scan's backward run on each rank's share of the batch, its params
held cut over ``data`` (FSDP) and gathered whole after the round, against
the port's round with no mesh (the same call with no mesh: the shares
are then the whole params).  Its MoE layer routes each rank's tokens with
a capacity taken from the local token count and enters its aux loss per
shard, as the reference's sharded MoE does, so the round is not the
unsplit one to float rounding.  Its bounds come from readings of this
round (2 clients x 2 local steps, batch 2 x 16): the sound split 1.27e-4
in the loss and 8.4e-6 in the params; a doubled gradient (a sum over the
``data`` ranks in place of their mean) 0.0198 in the params, and the sum
over all four ranks 20.3 in the loss and 0.059 in the params.  So the loss
is held within 1e-3 and the params within 1e-4.  The params end bit for
bit the same on every rank that holds the same share."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import FLConfig, build_fl_round_step
from repro_torch.launch import spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict
from test_torch_spmd_lm import check_case, rank_rounds, reference_params

CASES = [("xlstm-125m", "parallel", 3e-2), ("xlstm-125m", "sequential", 3e-2)]
JAMBA = "jamba-1.5-large-398b"
C, H, B, S = 2, 2, 2, 16
LOSS_TOL, PARAM_TOL = 1e-3, 1e-4


def jamba_round():
    """One sequential round of the reduced Jamba (2 clients, 2 local steps,
    batch 2 x 16 tokens) from a seeded init: (new params, loss)."""
    cfg = reduced(get_config(JAMBA))
    model = build_model(cfg)
    params = flat_dict(model.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (C, H, B, S + 1)).astype(np.int64))
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.05,
                  client_exec="sequential")
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    w = torch.tensor([1.0, 2.0])
    specs = model.logical_specs
    new, _, met = step(sp.shard_params(params, specs), (),
                       {"tokens": toks[..., :-1], "targets": toks[..., 1:]},
                       w, torch.ones(C), torch.Generator().manual_seed(2))
    return (sp.gather_params(new, specs, model.param_specs()),
            float(met["client_loss"]))


def rank_cases(mesh, params):
    out = rank_rounds(mesh, CASES, params)
    new, loss = jamba_round()
    out["jamba"] = (new, loss, all(len(set(v)) == 1 for v in
                                   sh.replica_checksums(new).values()))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    refs = {"xlstm-125m": reference_params("xlstm-125m")}
    got = spmd.run(rank_cases, ({"xlstm-125m": refs["xlstm-125m"][0]},),
                   sizes=(2, 2, 1), device="cpu",
                   init_method=spmd.init_file(tmp_path_factory.mktemp(
                       "spmd_xlstm")), verbose=False)
    return refs, got


@pytest.mark.parametrize("arch,exec_mode,tol", CASES,
                         ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_sharded_round_matches_unsharded_reference(ranks, arch, exec_mode,
                                                   tol):
    check_case(*ranks, arch, exec_mode, tol)


def test_jamba_sequential_round_matches_no_mesh(ranks):
    want, want_loss = jamba_round()
    got, loss, same = ranks[1]["jamba"]
    assert same, "params differ between ranks"
    assert np.isfinite(loss) and abs(loss - want_loss) < LOSS_TOL
    for k in want:
        assert float((got[k] - want[k]).abs().max()) < PARAM_TOL, k
