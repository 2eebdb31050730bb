"""A ``model`` axis of 2 beside ``pod``: four ``gloo`` ranks on the CPU
(``pod`` 2 x ``data`` 1 x ``model`` 2), spawned once for the file.

  * ``tests/test_mesh_small.py``'s granite pod_sequential case (the pods
    over ``pod``, each rank streaming its pod's clients on its shares)
    and its sequential case (the pods repeating every client's work, the
    gradient mean over ``pod`` and, for the leaves held whole, ``model``)
    against the JAX reference's unsharded round at that test's bounds;
    the params bit for bit on the ranks that hold the same share
    (``test_torch_model_axis_rounds.py`` holds the setup).
  * The pod_sequential commit, its pods' sums compressed and combined
    across ``pod``, on the same per-client deltas split over ``model``,
    bit for bit against the same commit of the whole deltas with no mesh,
    uncompressed (``fused_accum``, the shares) and compressed or masked
    (the split leaves gathered whole first); the parallel commit with the
    clients over ``pod`` and the hierarchical pod combine; and the async
    buffer commit, its slots whole on every rank."""
import numpy as np
import pytest
import torch

from repro_torch.core import (AsyncConfig, CompressionConfig, FLConfig,
                              build_buffer_commit_step, build_fl_round_step)
from repro_torch.launch import spmd
from repro_torch.models import sharding as sh
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from test_torch_model_axis_collectives import CUTS, SHAPES, draw, share
from test_torch_model_axis_rounds import run_cases, split_round
from test_torch_spmd_lm import check_case

SIZES = (2, 1, 2)
CASES = [("granite-3-2b", "pod_sequential", 3e-2),
         ("granite-3-2b", "sequential", 3e-2)]
K = 4
DET = dict(quantize_bits=8, topk_frac=0.1, stochastic_rounding=False)
POD_COMMITS = {"fused": ({}, False), "unfused": (dict(use_fused=False), False),
               "q8_topk_deterministic": (DET, False),
               "q8_stochastic": (dict(quantize_bits=8), False),
               "secure_q8": (dict(quantize_bits=8), True)}
PARALLEL = {"hierarchical_q8": dict(hierarchical=True, compression=dict(
    quantize_bits=8)), "fused": {}}
ASYNC = {"fused": ({}, False), "secure_q8_topk_deterministic": (DET, True)}


def inputs(seed=11):
    deltas = [{k: draw(seed + 10 * c + i, *s) * 0.1 for i, (k, s) in
               enumerate(SHAPES.items())} for c in range(K)]
    params = {k: draw(seed + 100 + i, *s) for i, (k, s) in
              enumerate(SHAPES.items())}
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.uniform(1, 3, K).astype(np.float32))
    m = torch.ones(K)
    m[2] = 0.0
    return params, deltas, w, m


def pod_commits():
    """The pod_sequential commit of every POD_COMMITS configuration, each
    client's delta handed in by a replaying ``local_train``, and the
    parallel commits of PARALLEL with the clients over ``pod``: {label:
    new params} on this rank's shares."""
    params, deltas, w, m = inputs()
    loss_fn = lambda p, b: (p["c"].sum(), {})             # noqa: E731
    copt, sopt = get_client_optimizer("sgd"), get_server_optimizer("fedavg")
    mesh = sh.get_mesh() is not None
    out = {}
    for name, (comp, secure) in POD_COMMITS.items():
        fl = FLConfig(num_clients=K, local_steps=1,
                      client_exec="pod_sequential", secure_agg=secure,
                      compression=CompressionConfig(**comp))
        step = build_fl_round_step(loss_fn, copt, sopt, fl, n_pods=2,
                                   client_spmd_axes=("pod",) if mesh
                                   else None, cuts=CUTS)
        it = iter(range(K))
        step.local_train = lambda p, b: (share(deltas[next(it)]),
                                         torch.tensor(1.0))
        if mesh:
            # this rank's pod streams its own clients only
            for _ in range(sh.shard_index(("pod",)) * (K // 2)):
                next(it)
        out["pod_sequential " + name] = step(
            share(params), (), {"x": torch.zeros(K, 1, 1)}, w, m,
            torch.Generator().manual_seed(9))[0]
    stack = {k: torch.stack([d[k] for d in deltas]) for k in SHAPES}
    losses = torch.linspace(0.5, 2.0, K)
    for name, kw in PARALLEL.items():
        kw = dict(kw)
        fl = FLConfig(num_clients=K, local_steps=1, client_exec="parallel",
                      compression=CompressionConfig(
                          **kw.pop("compression", {})), **kw)
        step = build_fl_round_step(loss_fn, copt, sopt, fl, n_pods=2,
                                   client_spmd_axes=("pod",),
                                   cuts=CUTS)
        cut = step.client_share
        out["parallel " + name] = step.commit(
            share(params), (), {k: cut(v) for k, v in
                                share(stack, 1).items()},
            cut(losses), cut(w), cut(m), torch.Generator().manual_seed(9))[0]
    for name, (comp, secure) in ASYNC.items():
        step = build_buffer_commit_step(
            sopt, FLConfig(num_clients=K, secure_agg=secure,
                           compression=CompressionConfig(**comp)),
            AsyncConfig(), cuts=CUTS)
        out["async " + name] = step(
            share(params), (), share(stack, 1), w,
            torch.tensor([0.0, 1.0, 3.0, 0.0]), losses, m,
            torch.arange(K, dtype=torch.int32), 0.5,
            torch.Generator().manual_seed(9))[0]
    return out


def rank_main(mesh, cases, params):
    torch.use_deterministic_algorithms(True)
    out = {"rounds": {(a, mode): split_round(a, mode, params[a])
                      for a, mode, _ in cases},
           "commits": pod_commits()}
    with sh.use_mesh(None):
        whole = pod_commits()
    out["commits unsplit"] = {k: share(v) for k, v in whole.items()}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_cases(CASES, SIZES, tmp_path_factory.mktemp("model_pods"),
                     rank_fn=rank_main, all_ranks=True)


@pytest.mark.parametrize("arch,exec_mode,tol", CASES,
                         ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_pod_and_model_round_matches_unsharded_reference(ranks, arch,
                                                         exec_mode, tol):
    refs, got = ranks
    check_case(refs, got[0]["rounds"], arch, exec_mode, tol)


@pytest.mark.parametrize("name", [f"pod_sequential {n}" for n in POD_COMMITS]
                         + [f"parallel {n}" for n in PARALLEL]
                         + [f"async {n}" for n in ASYNC])
def test_pod_commit_on_split_deltas_bit_for_bit(ranks, name):
    for rank, got in enumerate(ranks[1]):
        new, want = got["commits"][name], got["commits unsplit"][name]
        for k in SHAPES:
            assert torch.equal(new[k], want[k]), (name, rank, k)
