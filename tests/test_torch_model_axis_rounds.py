"""``tests/test_mesh_small.py``'s sharded rounds with a ``model`` axis of
2, on four ``gloo`` ranks on the CPU (``pod`` 1 x ``data`` 2 x ``model``
2, the reference's ``make_test_mesh`` of 4 devices), against the JAX
reference's unsharded round.  The reference can no longer run its own
sharded half here (jax 0.9.0 rejects it).

Each case is the reference test's round (``test_torch_spmd_lm.py`` holds
its setup: ``reduced()`` of the arch, the reference's init, 4 clients, 2
local steps of batch 2 x 16, lr 0.05, FedProx 0.01, stochastic q8), the
params held at rest as ``launch.specs.shard_params`` cuts them by their
sanitised specs, so every layer the axis divides runs split over
``model`` (the MLPs, the embedding and unembedding, the experts, the
xLSTM's heads and channels), its weights cut over ``data`` too and
gathered a layer at a time (FSDP).  The port runs the case's mode: sequential
(each client's batch over ``data``) and parallel (the clients over
``data``).  The bounds are the reference test's: the loss within 5e-3 and
the params, gathered whole, within 3e-2 (2e-1 for the MoE).  The params
end bit for bit the same on the ranks that hold the same share (their
shares gathered whole are the same on every rank).  The
pod_sequential case, which needs ``pod``, is in
``test_torch_model_axis_pods.py``."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import build_fl_round_step
from repro_torch.launch import spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from test_torch_spmd_lm import (C, H, SPMD_AXES, batches, check_case,
                                fl_config)

SIZES = (1, 2, 2)
CASES = [("granite-3-2b", "sequential", 3e-2),
         ("qwen3-moe-235b-a22b", "sequential", 2e-1),
         ("xlstm-125m", "parallel", 3e-2),
         ("xlstm-125m", "sequential", 3e-2)]


def jax_model(arch):
    """The reference's model of ``reduced(arch)`` and its init."""
    import jax
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
    jm = jbuild(jreduced(jget(arch)))
    return jm, jm.init(jax.random.PRNGKey(0))


def flat_numpy(tree):
    import jax
    from repro_torch.convert import tree_from_jax
    return {k: v.numpy() for k, v in tree_from_jax(
        jax.tree.map(np.asarray, tree), flat=True).items()}


def reference_round(arch, jm, jp):
    """The reference's unsharded sequential round: (new params, loss)."""
    import jax
    import jax.numpy as jnp
    from repro.core import CompressionConfig as JComp
    from repro.core import FLConfig as JFL
    from repro.core import build_fl_round_step as j_build
    from repro.optim import get_client_optimizer as j_copt
    from repro.optim import get_server_optimizer as j_sopt
    jfl = JFL(num_clients=C, local_steps=H, client_lr=0.05, fedprox_mu=0.01,
              client_exec="sequential", compression=JComp(quantize_bits=8),
              accum_dtype="float32")
    step = jax.jit(j_build(jm.loss_fn, j_copt("sgd"), j_sopt("fedavg"), jfl))
    new, _, met = step(jp, (), {k: jnp.asarray(v) for k, v in
                                batches(arch).items()},
                       jnp.ones((C,)), jnp.ones((C,)), jax.random.PRNGKey(3))
    return flat_numpy(new), float(met["client_loss"])


def split_round(arch, exec_mode, params_np, n_pods=2):
    """The port's round on this rank's shares: (params gathered whole,
    loss, shares bit for bit on the ranks that hold them)."""
    model = build_model(reduced(get_config(arch)))
    specs = model.logical_specs
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"),
                               fl_config(exec_mode), n_pods=n_pods,
                               client_spmd_axes=SPMD_AXES[exec_mode])
    local = sp.shard_params({k: torch.from_numpy(v) for k, v in
                             params_np.items()}, specs)
    new, _, met = step(local, (), {k: torch.from_numpy(v).long() for k, v in
                                   batches(arch).items()},
                       torch.ones(C), torch.ones(C),
                       torch.Generator().manual_seed(3))
    split = sum(1 for k in new if new[k].shape != params_np[k].shape)
    whole = sp.gather_params(new, specs, model.param_specs())
    # the shares gathered whole are the same on every rank only if every
    # rank's share is the same as the ranks' that hold it too
    same = all(len(set(v)) == 1 for v in sh.replica_checksums(
        whole).values())
    return whole, float(met["client_loss"]), same and split > 0


def rank_rounds(mesh, cases, params):
    return {(arch, mode): split_round(arch, mode, params[arch])
            for arch, mode, _ in cases}


def run_cases(cases, sizes, tmp, rank_fn=rank_rounds, all_ranks=False):
    """The reference's rounds, computed in a thread while the ranks run
    ``rank_fn(mesh, cases, params)`` (the port's): (refs as ``check_case``
    takes them, rank 0's result, or every rank's with ``all_ranks``)."""
    models = {a: jax_model(a) for a in sorted({c[0] for c in cases})}
    params = {a: flat_numpy(jp) for a, (_, jp) in models.items()}
    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(lambda: {a: (params[a],) + reference_round(
            a, *models[a]) for a in models})
        got = spmd.run(rank_fn, (cases, params), sizes=sizes,
                       device="cpu", init_method=spmd.init_file(tmp),
                       all_ranks=all_ranks, verbose=False)
        return refs.result(), got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_cases(CASES, SIZES, tmp_path_factory.mktemp("model_rounds"))


@pytest.mark.parametrize("arch,exec_mode,tol", CASES,
                         ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_model_axis_round_matches_unsharded_reference(ranks, arch, exec_mode,
                                                      tol):
    check_case(*ranks, arch, exec_mode, tol)
