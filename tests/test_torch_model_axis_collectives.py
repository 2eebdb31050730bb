"""The ``model`` mesh axis's building blocks across real processes: four
``gloo`` ranks on the CPU (``pod`` 1 x ``data`` 2 x ``model`` 2, the
reference's ``make_test_mesh`` of 4 devices), spawned once for the file.

  * The conjugate collectives (``models.sharding``) under
    ``torch.func.grad`` and under ``vmap`` of it: a column-then-row
    parallel MLP (``copy_to_model``/``reduce_from_model``), a table split
    on its columns (``gather_from_model``/``scatter_to_model``) and a
    weight gathered for each rank's own columns
    (``gather_to_model``/its reduce-scatter) against the same functions
    unsplit, within 1e-6; and two wrong pairings, each of which scales a
    gradient by the axis size, so the test would see one.
  * Params at rest: ``shard_params`` then ``gather_params`` bit for bit,
    a FedAdam server step on the shares equal to the whole one's share,
    and the dry run's per-device bytes equal to what a rank holds (the
    params cut over ``data`` as well as ``model``: FSDP).
  * Every commit configuration on deltas split over ``model`` (and, in the
    parallel commit, the clients over ``data``) bit for bit against the
    same commit of the whole deltas with no mesh: the fused and unfused
    sums, deterministic and stochastic q8 and top-k, dropout, the
    integer and float secure commits, the trimmed mean, the hierarchical
    combine, the sequential round's streaming commit, the async buffer
    commit and its chunked form.  A leaf whose last dim is split at a
    width that is no multiple of the block (300 over 2) is among them."""
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.core import (AsyncConfig, CompressionConfig, FLConfig,
                              build_buffer_commit_step,
                              build_chunked_commit_steps, build_fl_round_step)
from repro_torch.launch import dryrun, spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict

SIZES = (1, 2, 2)
M = 2                                     # the model axis
C, D, F = 3, 8, 6                         # clients (vmap), width, hidden
TOL = 1e-6
# the commit's tree: the dim of each leaf split over model ("c" is whole)
CUTS = {"a": {"model": 1}, "b": {"model": 0}, "d": {"model": 2}}
SHAPES = {"a": (6, 300), "b": (8, 64, 40), "c": (17,), "d": (3, 5, 512)}
K = 4                                     # clients of the commit
DET = dict(quantize_bits=8, topk_frac=0.1, stochastic_rounding=False)
COMMITS = {
    "fused": {}, "unfused": dict(compression=dict(use_fused=False)),
    "q8_topk_deterministic": dict(compression=DET),
    "q8_stochastic": dict(compression=dict(quantize_bits=8)),
    "topk_q4": dict(compression=dict(quantize_bits=4, topk_frac=0.2)),
    "dropout_q8": dict(compression=dict(dropout_frac=0.25,
                                        quantize_bits=8)),
    "secure_q8": dict(secure_agg=True, compression=dict(quantize_bits=8)),
    "secure_q8_topk_deterministic": dict(secure_agg=True, compression=DET),
    "secure_float": dict(secure_agg=True),
    "trimmed_mean": dict(aggregation="trimmed_mean"),
    "weighted": dict(aggregation="weighted"),
    "hierarchical_q8": dict(hierarchical=True,
                            compression=dict(quantize_bits=8)),
}
SEQUENTIAL = ("fused", "q8_topk_deterministic", "secure_float")
ASYNC = ("fused", "q8_topk_deterministic", "secure_q8")


def close(got, want, factor=1):
    """``got`` within TOL of ``factor * want``'s largest magnitude."""
    want = factor * want
    gap = float((got - want).abs().max())
    assert gap <= TOL * max(1.0, float(want.abs().max())), gap


def draw(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


# ---------------------------------------------------------------- (a)

def mlp(p, x):
    """Column-parallel ``w1``, row-parallel ``w2``."""
    h = torch.tanh(sh.copy_to_model(x) @ p["w1"])
    return sh.reduce_from_model(h @ p["w2"]).square().sum()


def table(p, x):
    """A table split on its columns, gathered for a computation every rank
    repeats; its output scattered back into each rank's own columns."""
    y = sh.gather_from_model(sh.copy_to_model(x) @ p["w1"], -1)
    z = sh.scatter_to_model(torch.sin(y), -1)
    return sh.reduce_from_model((z * p["w2"][:, 0]).sum())


def gathered(p, x):
    """A weight held split, gathered whole and cut to the rank's own
    columns of a computation of its own (Mamba's ``in_proj``)."""
    w = sh.gather_to_model(p["w1"], -1)
    n, i = w.shape[-1] // M, sh.model_index()
    return sh.reduce_from_model(torch.cos(
        sh.copy_to_model(x) @ w[:, i * n:(i + 1) * n]).sum())


FUNCS = {"mlp": mlp, "table": table, "gathered": gathered}


class _SumForwardSumBackward(torch.autograd.Function):
    """The wrong pair: a row-parallel sum whose backward sums again."""

    @staticmethod
    def forward(x):
        return sh.psum(x, sh.MODEL)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return sh.psum(g, sh.MODEL)


def wrong_reduce(p, x):
    h = torch.tanh(sh.copy_to_model(x) @ p["w1"])
    return _SumForwardSumBackward.apply(h @ p["w2"]).square().sum()


def wrong_gather(p, x):
    """A gather feeding the same computation on every rank, with the
    reduce-scatter backward of a gather for per-rank consumers."""
    return torch.sin(sh.gather_to_model(x @ p["w1"], -1)).sum()


def shares(w1, w2, i):
    n = w1.shape[1] // M
    return {"w1": w1[:, i * n:(i + 1) * n], "w2": w2[i * n:(i + 1) * n]}


def collective_cases():
    w1, w2, x = draw(1, D, F), draw(2, F, D), draw(3, 5, D)
    p = shares(w1, w2, sh.model_index())
    ps = {k: v.expand((C,) + tuple(v.shape)).contiguous()
          for k, v in p.items()}
    xs = x.expand((C,) + tuple(x.shape))
    out = {}
    for name, fn in FUNCS.items():
        out[name] = grad(fn, argnums=(0, 1))(p, x)
        out[name + " vmap"] = vmap(grad(fn, argnums=(0, 1)))(ps, xs)
    out["wrong reduce"] = grad(wrong_reduce, argnums=(0, 1))(p, x)
    out["wrong gather"] = grad(wrong_gather)(p, x)
    return out


def collective_reference():
    """The functions unsplit (no mesh), every rank's share of each
    gradient: {name: (grads of w1, w2 as [M] shares, grad of x)}."""
    w1, w2, x = draw(1, D, F), draw(2, F, D), draw(3, 5, D)
    whole = {"w1": w1, "w2": w2}

    def plain(name, p, x):
        if name == "mlp":
            return (torch.tanh(x @ p["w1"]) @ p["w2"]).square().sum()
        if name == "table":
            return (torch.sin(x @ p["w1"]) * torch.cat(
                [p["w2"][i * (F // M):(i + 1) * (F // M), 0]
                 for i in range(M)])).sum()
        return torch.cos(x @ p["w1"]).sum()

    return {name: grad(lambda p, x: plain(name, p, x), argnums=(0, 1))(
        whole, x) for name in FUNCS}


# ---------------------------------------------------------------- (d)

def rest_cases():
    out = {"archs": {}}
    for arch in ("granite-3-2b", "jamba-1.5-large-398b", "xlstm-125m"):
        model = build_model(reduced(get_config(arch)))
        whole = flat_dict(model.init(torch.Generator().manual_seed(0)))
        local = sp.shard_params(whole, model.logical_specs)
        back = sp.gather_params(local, model.logical_specs,
                                model.param_specs())
        out["archs"][arch] = (all(torch.equal(back[k], whole[k])
                                  for k in whole),
                     sp.param_bytes(local), sum(
                         1 for k in whole if local[k].shape != whole[k].shape))
    # the server state of the shares is sharded like them
    model = build_model(reduced(get_config("granite-3-2b")))
    specs = model.logical_specs
    whole = flat_dict(model.init(torch.Generator().manual_seed(0)))
    delta = {k: torch.full_like(v, 0.01) * (1 + v) for k, v in whole.items()}
    opt = get_server_optimizer("fedadam")
    local = sp.shard_params(whole, specs)
    new, state = opt.apply(local, sp.shard_params(delta, specs),
                           opt.init(local))
    with sh.use_mesh(None):
        new0, state0 = opt.apply(whole, delta, opt.init(whole))
    out["fedadam"] = all(
        torch.equal(a[k], sp.shard_params(b, specs)[k]) for a, b in
        ((new, new0), (state["m"], state0["m"]), (state["v"], state0["v"]))
        for k in a)
    return out


# ---------------------------------------------------------------- (e)

def fl_config(name, mode="parallel", **extra):
    kw = dict(COMMITS[name])
    comp = CompressionConfig(**kw.pop("compression", {}))
    return FLConfig(num_clients=K, local_steps=1, client_exec=mode,
                    compression=comp, **kw, **extra)


def commit_inputs(seed=5):
    deltas = {k: draw(seed + i, K, *s) * 0.1
              for i, (k, s) in enumerate(SHAPES.items())}
    params = {k: draw(seed + 10 + i, *s) for i, (k, s) in
              enumerate(SHAPES.items())}
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.uniform(1, 3, K).astype(np.float32))
    losses = torch.from_numpy(rng.uniform(0.5, 2, K).astype(np.float32))
    m = torch.ones(K)
    m[1] = 0.0
    return params, deltas, w, losses, m


def share(tree, lead=0):
    return {k: v if k not in CUTS else sh.local_share(
        v, sh.MODEL, CUTS[k][sh.MODEL] + lead) for k, v in tree.items()}


def run_commits():
    """Every commit of COMMITS (parallel, the clients over ``data`` where
    a mesh is active), SEQUENTIAL, ASYNC and the chunked async commit on
    this rank's shares: {label: new params}."""
    params, deltas, w, losses, m = commit_inputs()
    axes = ("data",) if sh.get_mesh() is not None else None
    loss_fn = lambda p, b: (p["c"].sum(), {})             # noqa: E731
    copt, sopt = get_client_optimizer("sgd"), get_server_optimizer("fedavg")
    out = {}
    for name in COMMITS:
        step = build_fl_round_step(loss_fn, copt, sopt, fl_config(name),
                                   n_pods=2, client_spmd_axes=axes,
                                   cuts=CUTS)
        cut = step.client_share
        mine = {k: cut(v) for k, v in share(deltas, 1).items()}
        out[name] = step.commit(
            share(params), (), mine, cut(losses), cut(w), cut(m),
            torch.Generator().manual_seed(7))[0]
    for name in SEQUENTIAL:
        step = build_fl_round_step(loss_fn, copt, sopt,
                                   fl_config(name, "sequential"),
                                   cuts=CUTS)
        ups = ((share({k: v[c] for k, v in deltas.items()}), losses[c])
               for c in range(K))
        out["sequential " + name] = step.commit(
            share(params), (), ups, w, m, torch.Generator().manual_seed(7))[0]
    acfg, stale = AsyncConfig(), torch.tensor([0.0, 2.0, 1.0, 5.0])
    ids = torch.arange(K, dtype=torch.int32)
    for name in ASYNC:
        step = build_buffer_commit_step(sopt, fl_config(name), acfg,
                                        cuts=CUTS)
        out["async " + name] = step(
            share(params), (), share(deltas, 1), w, stale, losses, m, ids,
            0.5, torch.Generator().manual_seed(7))[0]
    acc_fn, fin = build_chunked_commit_steps(sopt, fl_config("fused"), acfg,
                                             cuts=CUTS)
    acc = {k: torch.zeros_like(v) for k, v in share(params).items()}
    wsum = torch.zeros(())
    for lo in (0, 2):
        sl = slice(lo, lo + 2)
        acc, wsum = acc_fn(acc, wsum, {k: v[sl] for k, v in
                                       share(deltas, 1).items()}, w[sl],
                           stale[sl], losses[sl], m[sl], ids[:2], 0.5,
                           torch.Generator().manual_seed(7))
    out["async chunked"] = fin(share(params), (), acc, wsum)[0]
    return out


# ---------------------------------------------------------------- ranks

def rank_main(mesh):
    torch.use_deterministic_algorithms(True)
    out = {"collectives": collective_cases(), "rest": rest_cases(),
           "commits": run_commits()}
    with sh.use_mesh(None):
        whole = run_commits()
    out["commits unsplit"] = {name: share(t) for name, t in whole.items()}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spmd.run(rank_main, sizes=SIZES, device="cpu",
                    init_method=spmd.init_file(tmp_path_factory.mktemp(
                        "model_axis")), all_ranks=True, verbose=False)


def model_coord(rank):
    return rank % M


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_collective_pairs_under_grad_and_vmap(ranks, name):
    want = collective_reference()[name]
    for rank, got in enumerate(ranks):
        i = model_coord(rank)
        mine = shares(want[0]["w1"], want[0]["w2"], i)
        for label in (name, name + " vmap"):
            gp, gx = got["collectives"][label]
            if label.endswith("vmap"):
                gp, gx = {k: v[C - 1] for k, v in gp.items()}, gx[C - 1]
            for k in ("w1", "w2"):
                close(gp[k], mine[k])
            close(gx, want[1])


def test_a_wrong_pairing_scales_a_gradient_by_the_axis_size(ranks):
    """The controls: a row-parallel sum that sums again in its backward,
    and a gather for per-rank consumers used for a repeated computation,
    each hand back ``model`` times the gradient."""
    want = collective_reference()["mlp"]
    w1 = draw(1, D, F)
    x = draw(3, 5, D)
    sin_grad = grad(lambda w: torch.sin(x @ w).sum())(w1)
    for rank, got in enumerate(ranks):
        i = model_coord(rank)
        mine = shares(want[0]["w1"], want[0]["w2"], i)
        gp, gx = got["collectives"]["wrong reduce"]
        for k in ("w1", "w2"):
            close(gp[k], mine[k], M)
        close(gx, want[1], M)
        n = F // M
        close(got["collectives"]["wrong gather"]["w1"],
              sin_grad[:, i * n:(i + 1) * n], M)


def test_params_at_rest_round_trip_and_server_state(ranks):
    for rank, got in enumerate(ranks):
        for arch, (same, held, n_split) in got["rest"]["archs"].items():
            assert same, (arch, rank)
            assert n_split > 0, arch
            model = build_model(reduced(get_config(arch)))
            # the dry run on the ranks' own mesh, data 2 x model 2
            mesh = sh.Mesh(("pod", "data", "model"), SIZES,
                           tuple(range(int(np.prod(SIZES)))))
            assert held == dryrun.per_device_bytes(
                model.param_specs(), model.logical_specs, mesh), arch
        assert got["rest"]["fedadam"], rank


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_rank_bytes_equal_the_dry_run_at_full_width(arch):
    """The params a rank holds after ``shard_params`` are the dry run's
    per-device bytes, cut over ``data`` and ``model``, for every assigned
    arch at its published widths (meta tensors, nothing allocated), on
    the first and the last rank of a 2 x 2 and the production 16 x 16
    mesh."""
    model = build_model(get_config(arch))
    specs, whole = model.logical_specs, model.param_specs()
    for sizes, axes in (((2, 2), ("data", "model")),
                        ((16, 16), ("data", "model"))):
        n = int(np.prod(sizes))
        want = dryrun.per_device_bytes(whole, specs, sh.Mesh(
            axes, sizes, tuple(range(n))))
        for rank in (0, n - 1):
            mesh = sh.Mesh(axes, sizes, tuple(range(n)), rank=rank)
            local = sp.shard_params(whole, specs, mesh)
            assert sp.param_bytes(local) == want, (arch, sizes, rank)
    assert sp.param_bytes(whole) > want


@pytest.mark.parametrize("name", list(COMMITS)
                         + [f"sequential {n}" for n in SEQUENTIAL]
                         + [f"async {n}" for n in ASYNC] + ["async chunked"])
def test_commit_on_split_deltas_bit_for_bit(ranks, name):
    for rank, got in enumerate(ranks):
        new, want = got["commits"][name], got["commits unsplit"][name]
        for k in SHAPES:
            assert torch.equal(new[k], want[k]), (name, rank, k)
