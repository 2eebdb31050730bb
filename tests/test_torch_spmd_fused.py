"""Fused against unfused commits under a mesh of processes: four ``gloo``
ranks on the CPU, ``pod`` 2 x ``data`` 2 x ``model`` 1, the reference's
``test_fused_matches_unfused_under_mesh`` cases (``tests/test_mesh_small.py``)
run by the port: a paper-charlm cut to 2 layers of width 64, 4 clients, 2
local steps, batch 2 of 16 tokens, deterministic q8 + top-k 0.1, weights
[1, 2, 3, 4] and client 1 cut.  The sync parallel round (secure, clients
over ``data``, each client's batch over ``pod``), the sequential and
pod_sequential rounds (pods over ``data``) and the secure async buffer
commit (staleness [0, 1, 3, 2], slot 2 cut, exponent 0.5) each run with
the fused kernels and with the plain stages, on every rank; the two agree
within the reference's 5e-5 (it measured 0 to 3.9e-5: a reassociated sum
can flip an int8 rounding step), the fused and unfused stages each equal
the same stages with no mesh (bit for bit where no batch is split), and
the params, held cut over ``data`` at rest (FSDP) and gathered whole after
the round, end bit for bit the same on every rank."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (AsyncConfig, CompressionConfig, FLConfig,
                              build_buffer_commit_step, build_fl_round_step)
from repro_torch.launch import spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict

C, H, B, S = 4, 2, 2, 16
CHARLM = dict(n_layers=2, d_model=64, d_ff=128, n_heads=2, kv_heads=2)
DET = dict(quantize_bits=8, topk_frac=0.1, stochastic_rounding=False)
TOL = 5e-5
# (label, client_exec, client_spmd_axes, secure_agg, batch split)
ROUNDS = [("sync_parallel", "parallel", ("data",), True, True),
          ("sync_sequential", "sequential", None, False, True),
          ("sync_pod_sequential", "pod_sequential", ("data",), False, True)]


def model_and_inputs():
    cfg = get_config("paper-charlm").replace(**CHARLM)
    model = build_model(cfg)
    params = flat_dict(model.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (C, H, B, S + 1)).astype(np.int64))
    batches = {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
    return model, params, batches


def sync_round(label, use_fused):
    _, exec_mode, axes, secure, _ = next(r for r in ROUNDS if r[0] == label)
    model, params, batches = model_and_inputs()
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.1,
                  client_exec=exec_mode, secure_agg=secure,
                  compression=CompressionConfig(use_fused=use_fused, **DET))
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl, n_pods=2,
                               client_spmd_axes=axes)
    specs = model.logical_specs
    new = step(sp.shard_params(params, specs), (), batches,
               torch.tensor([1.0, 2.0, 3.0, 4.0]),
               torch.tensor([1.0, 0.0, 1.0, 1.0]),
               torch.Generator().manual_seed(2))[0]
    return sp.gather_params(new, specs, model.param_specs())


def async_commit(use_fused):
    """The secure buffer commit of C deltas, whole on every process (one
    client each, trained with no mesh: the deltas are data here)."""
    model, params, batches = model_and_inputs()
    fl = FLConfig(mode="async", num_clients=C, local_steps=H, client_lr=0.1,
                  secure_agg=True,
                  compression=CompressionConfig(use_fused=use_fused, **DET))
    rng = np.random.default_rng(3)
    deltas = {k: torch.from_numpy((rng.normal(size=(C,) + tuple(p.shape))
                                   * 1e-2).astype(np.float32))
              for k, p in params.items()}
    commit = build_buffer_commit_step(get_server_optimizer("fedavg"), fl,
                                      AsyncConfig(buffer_size=C))
    return commit(params, (), deltas, torch.tensor([1.0, 2.0, 3.0, 4.0]),
                  torch.tensor([0.0, 1.0, 3.0, 2.0]), torch.zeros(C),
                  torch.tensor([1.0, 1.0, 0.0, 1.0]),
                  torch.arange(C, dtype=torch.int32), 0.5,
                  torch.Generator().manual_seed(4))[0]


def all_cases():
    out = {}
    for fused in (True, False):
        for r in ROUNDS:
            out[(r[0], fused)] = sync_round(r[0], fused)
        out[("async_buffered", fused)] = async_commit(fused)
    return out


def rank_cases(mesh):
    """Every case under the mesh, each with whether the params are the same
    on every rank; rank 0 also runs them with no mesh (one thread, as the
    ranks), for the comparison."""
    out = {key: (new, all(len(set(v)) == 1 for v in
                          sh.replica_checksums(new).values()))
           for key, new in all_cases().items()}
    if mesh.rank == 0:
        with sh.use_mesh(None):
            out["no mesh"] = all_cases()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spmd.run(rank_cases, sizes=(2, 2, 1), device="cpu",
                    init_method=spmd.init_file(tmp_path_factory.mktemp(
                        "spmd_fused")), verbose=False)


LABELS = [r[0] for r in ROUNDS] + ["async_buffered"]


def gap(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("label", LABELS)
def test_fused_matches_unfused_under_mesh(ranks, label):
    (fused, same_f), (plain, same_p) = ranks[(label, True)], \
        ranks[(label, False)]
    assert same_f and same_p, "params differ between ranks"
    assert gap(fused, plain) <= TOL


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused",
                                                          "unfused"])
@pytest.mark.parametrize("label", LABELS)
def test_under_mesh_matches_no_mesh(ranks, label, use_fused):
    """Each stage stack under the mesh against itself with no mesh: bit for
    bit for the async commit (nothing is split but its rows), within the
    gradient mean's reassociation (and the rounding steps it can flip)
    where a batch is split."""
    got, _ = ranks[(label, use_fused)]
    want = ranks["no mesh"][(label, use_fused)]
    if label == "async_buffered":
        for k in want:
            assert torch.equal(got[k], want[k]), k
    else:
        assert gap(got, want) <= TOL


def test_pipeline_keeps_fusion_under_a_mesh():
    """The reference's gate-lift pin: a pipeline built under a mesh keeps
    the fused commit."""
    from repro_torch.core import build_update_pipeline
    from repro_torch.launch.mesh import make_test_mesh
    with sh.use_mesh(make_test_mesh(4, device="cpu")):
        assert build_update_pipeline(FLConfig()).fused
        assert build_update_pipeline(dataclasses.replace(
            FLConfig(), compression=CompressionConfig(use_fused=False))
        ).fused is False
