"""The reduced LMs' rounds with their params held at rest cut over
``data`` (FSDP) and ``model``: four ``gloo`` ranks on the CPU (``pod`` 1 x
``data`` 2 x ``model`` 2), spawned once for the file, each client's batch
split over ``data`` and each layer's weights gathered over it just before
the layer runs.  The reduced granite, Jamba, Qwen3-MoE and xLSTM in
sequential and pod_sequential mode (2 pods, which the ``pod`` axis of 1
leaves on every rank): 2 clients x 2 local steps of batch 2 x 16 tokens,
float32, uncompressed, from a seeded init; the new params gathered whole
(``gather_params``) against the same round of the port with no mesh.

The bounds are the ``model``-axis files' against no mesh: for the dense
families the loss within 1e-6 and the params within 1e-5; the MoE
families (Qwen3-MoE, and the Jamba's MoE layers) route each rank's tokens
with a capacity from the local count and enter their aux loss per shard,
as the reference's sharded MoE does, so they are held to
``test_torch_spmd_xlstm.py``'s bounds for that split, the loss within
1e-3 and the params within 1e-4.  The params end bit for bit the same on
every rank that holds the same share (their shares gathered whole are
the same on every rank).  Each rank's collective bytes by kind in the
reduced granite's and Jamba's rounds equal the dry run's count of the
same round on its rank (``dryrun.count_collectives`` on a dry mesh of
the same shape)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.core import FLConfig, build_fl_round_step
from repro_torch.launch import dryrun, spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model, token_shape
from repro_torch.models import sharding as sh
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict

ARCHS = ("granite-3-2b", "jamba-1.5-large-398b", "qwen3-moe-235b-a22b",
         "xlstm-125m")
MOE = ("jamba-1.5-large-398b", "qwen3-moe-235b-a22b")
DRY_ARCHS = ("granite-3-2b", "jamba-1.5-large-398b")   # bytes held to the dry run's
TOLS = {"dense": (1e-6, 1e-5), "moe": (1e-3, 1e-4)}   # (loss, params)
AXES = {"parallel": ("pod", "data"), "sequential": None,
        "pod_sequential": ("pod",)}
H, B, S = 2, 2, 16


def fl_config(mode, C):
    return FLConfig(num_clients=C, local_steps=H, client_lr=0.05,
                    client_exec=mode)


def fsdp_round(arch, mode, C):
    """One round of ``mode`` on this rank's shares: (new params gathered
    whole, loss, every rank's gathered params the same, leaves cut over
    data, the round's collective bytes by kind); off a mesh, the round on
    the whole params."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    specs = model.logical_specs
    params = flat_dict(model.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, token_shape(cfg, C, H, B, S + 1)).astype(np.int64))
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"),
                               fl_config(mode, C), n_pods=2,
                               client_spmd_axes=AXES[mode])
    local = sp.shard_params(params, specs)
    with sh.count_collectives() as counts:
        new, _, met = step(local, (), {"tokens": toks[..., :-1],
                                       "targets": toks[..., 1:]},
                           torch.arange(1.0, C + 1), torch.ones(C),
                           torch.Generator().manual_seed(2))
    whole = sp.gather_params(new, specs, model.param_specs())
    same = all(len(set(v)) == 1 for v in sh.replica_checksums(
        whole).values())
    cut = sum(1 for k in params if local[k].shape != params[k].shape)
    return whole, float(met["client_loss"]), same, cut, dict(counts)


def rank_rounds(mesh, modes, C, dry=False):
    """Every arch's round in each of ``modes``; with ``dry``, the dry
    run's count of DRY_ARCHS' rounds on this rank too."""
    torch.use_deterministic_algorithms(True)
    out = {(a, m): fsdp_round(a, m, C) for a in ARCHS for m in modes}
    for a in DRY_ARCHS if dry else ():
        for m in modes:
            out["dry", a, m] = dryrun.count_collectives(
                reduced(get_config(a)), InputShape("tiny", S, C * B,
                                                   "train"), mesh,
                fl=fl_config(m, C), n_pods=2, client_spmd_axes=AXES[m])
    return out


def run_rounds(tmp, sizes, modes, C, dry=False):
    """Rank 0's rounds, or with ``dry`` every rank's and their dry
    counts."""
    return spmd.run(rank_rounds, (modes, C, dry), sizes=sizes, device="cpu",
                    init_method=spmd.init_file(tmp), all_ranks=dry,
                    verbose=False)


def no_mesh_rounds(modes, C):
    """The rounds with no mesh, in one thread as the ranks run (these tiny
    runs take many times longer on many threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with sh.use_mesh(None):
            return {(a, m): fsdp_round(a, m, C)[:2] for a in ARCHS
                    for m in modes}
    finally:
        torch.set_num_threads(threads)


def check_round(got, refs, arch, mode):
    new, loss, same, cut, _ = got[(arch, mode)]
    want, want_loss = refs[(arch, mode)]
    loss_tol, tol = TOLS["moe" if arch in MOE else "dense"]
    assert same, "params differ between ranks that hold the same share"
    assert cut > 0
    assert np.isfinite(loss) and abs(loss - want_loss) <= loss_tol, (
        loss, want_loss)
    for k in want:
        gap = float((new[k] - want[k]).abs().max())
        assert gap <= tol, (k, gap)


MODES = ("sequential", "pod_sequential")


@pytest.fixture(scope="module")
def every_rank(tmp_path_factory):
    return run_rounds(tmp_path_factory.mktemp("fsdp_rounds"), (1, 2, 2),
                      MODES, 2, dry=True)


@pytest.fixture(scope="module")
def ranks(every_rank):
    return every_rank[0], no_mesh_rounds(MODES, 2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_round_matches_no_mesh(ranks, arch, mode):
    check_round(*ranks, arch, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_fsdp_round_bytes_are_the_dry_runs(every_rank, arch, mode):
    for rank, out in enumerate(every_rank):
        live, dry = out[(arch, mode)][4], out["dry", arch, mode]
        assert live and live == dry, (rank, live, dry)
