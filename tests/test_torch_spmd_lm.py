"""The reduced LMs' rounds across real processes, against the JAX
reference's unsharded round: ``tests/test_mesh_small.py``'s cases, whose
sharded half the reference can no longer run here (jax 0.9.0 rejects it),
executed by the port's SPMD round on four ``gloo`` ranks (``pod`` 2 x
``data`` 2 x ``model`` 1) on the CPU.

Each case is the reference test's round: ``reduced()`` of the arch, its
params from the reference's init, 4 clients, 2 local steps of batch 2 x 16
tokens, client lr 0.05, FedProx mu 0.01, ``CompressionConfig(
quantize_bits=8)`` (stochastic rounding, whose draws the two packages make
from different generators).  The reference side is its unsharded
sequential round, as in the reference's test; the port runs the case's
mode under the mesh: sequential (each client's batch split over
``data``), pod_sequential (``n_pods=2``, pods over ``pod``, the batch over
``data``) and parallel (clients over ``pod`` and ``data``), the params
held at rest cut over ``data`` (``specs.shard_params``: FSDP) and
gathered whole after the round.  The bounds are the reference test's: the
loss within 5e-3 and the params within 3e-2 (2e-1 for the MoE, whose
per-shard capacity and aux loss depend on the split).  The params end bit
for bit the same on every rank that holds the same share."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import CompressionConfig, FLConfig, build_fl_round_step
from repro_torch.launch import spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model, token_shape
from repro_torch.models import sharding as sh
from repro_torch.optim import get_client_optimizer, get_server_optimizer

C, H, B, S = 4, 2, 2, 16
LOSS_TOL = 5e-3
# (arch, client_exec, param tolerance): tests/test_mesh_small.py's
CASES = [("granite-3-2b", "sequential", 3e-2),
         ("granite-3-2b", "pod_sequential", 3e-2),
         ("qwen3-moe-235b-a22b", "sequential", 2e-1)]
SPMD_AXES = {"parallel": ("pod", "data"), "pod_sequential": ("pod",),
             "sequential": None}


def fl_config(exec_mode):
    return FLConfig(num_clients=C, local_steps=H, client_lr=0.05,
                    fedprox_mu=0.01, client_exec=exec_mode,
                    compression=CompressionConfig(quantize_bits=8))


def batches(arch, seed=1):
    cfg = reduced(get_config(arch))
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, token_shape(cfg, C, H, B, S + 1)).astype(np.int32)
    return {"tokens": toks.take(np.arange(S), axis=3),
            "targets": toks.take(np.arange(1, S + 1), axis=3)}


def reference_params(arch):
    """The reference's init of ``reduced(arch)``, as the port's flat view
    (numpy), and the reference's unsharded sequential round from it: (its
    new params, its loss)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.core import CompressionConfig as JComp
    from repro.core import FLConfig as JFL
    from repro.core import build_fl_round_step as j_build
    from repro.models import build_model as jbuild
    from repro.optim import get_client_optimizer as j_copt
    from repro.optim import get_server_optimizer as j_sopt
    from repro_torch.convert import tree_from_jax
    jm = jbuild(jreduced(jget(arch)))
    jp = jm.init(jax.random.PRNGKey(0))
    jfl = JFL(num_clients=C, local_steps=H, client_lr=0.05, fedprox_mu=0.01,
              client_exec="sequential", compression=JComp(quantize_bits=8),
              accum_dtype="float32")
    step = jax.jit(j_build(jm.loss_fn, j_copt("sgd"), j_sopt("fedavg"), jfl))
    new, _, met = step(jp, (), {k: jnp.asarray(v) for k, v in
                                batches(arch).items()},
                       jnp.ones((C,)), jnp.ones((C,)), jax.random.PRNGKey(3))
    flat = lambda t: {k: v.numpy() for k, v in tree_from_jax(
        jax.tree.map(np.asarray, t), flat=True).items()}
    return flat(jp), flat(new), float(met["client_loss"])


def port_round(arch, exec_mode, params_np):
    """The port's round on this rank's shares of the params (cut over
    ``data``: FSDP): (the new params gathered whole, the loss)."""
    model = build_model(reduced(get_config(arch)))
    specs = model.logical_specs
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"),
                               fl_config(exec_mode), n_pods=2,
                               client_spmd_axes=SPMD_AXES[exec_mode])
    new, _, met = step(sp.shard_params({k: torch.from_numpy(v) for k, v in
                                        params_np.items()}, specs),
                       (), {k: torch.from_numpy(v).long() for k, v in
                            batches(arch).items()},
                       torch.ones(C), torch.ones(C),
                       torch.Generator().manual_seed(3))
    return (sp.gather_params(new, specs, model.param_specs()),
            float(met["client_loss"]))


def rank_rounds(mesh, cases, params):
    out = {}
    for arch, exec_mode, _ in cases:
        new, loss = port_round(arch, exec_mode, params[arch])
        # gathered whole: the same on every rank only if every rank's
        # share is its replicas'
        same = all(len(set(v)) == 1 for v in
                   sh.replica_checksums(new).values())
        out[(arch, exec_mode)] = (new, loss, same)
    return out


def run_cases(cases, tmp):
    refs = {arch: reference_params(arch) for arch in {c[0] for c in cases}}
    got = spmd.run(rank_rounds, (cases, {a: r[0] for a, r in refs.items()}),
                   sizes=(2, 2, 1), device="cpu",
                   init_method=spmd.init_file(tmp), verbose=False)
    return refs, got


def check_case(refs, got, arch, exec_mode, tol):
    _, want, want_loss = refs[arch]
    new, loss, same = got[(arch, exec_mode)]
    assert same, "params differ between ranks"
    assert np.isfinite(loss) and abs(loss - want_loss) < LOSS_TOL, (
        loss, want_loss)
    err = max(float(np.abs(new[k].numpy().astype(np.float32)
                           - want[k].astype(np.float32)).max()) for k in want)
    assert err < tol, err


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("spmd_lm"))


@pytest.mark.parametrize("arch,exec_mode,tol", CASES,
                         ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_sharded_round_matches_unsharded_reference(ranks, arch, exec_mode,
                                                   tol):
    check_case(*ranks, arch, exec_mode, tol)
