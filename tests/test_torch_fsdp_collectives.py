"""FSDP over the ``data`` mesh axis, its building blocks across real
processes: four ``gloo`` ranks on the CPU (``pod`` 1 x ``data`` 2 x
``model`` 2), spawned once for the file.

  * ``sharding.gather_from_data``: its forward is the whole weight bit for
    bit; its backward, the ranks' cotangents summed over ``data`` and cut
    to the rank's share, divided by the ``data`` count, is the rank's
    share of the gradient of the whole batch's mean loss, under
    ``torch.func.grad`` and under ``vmap`` of it, within 1e-6; and
    ``reduce_from_data`` sums partials over ``data`` under both.
  * Params at rest, cut over ``data`` and ``model``: ``gather_params`` of
    ``shard_params`` is the whole tree bit for bit for the reduced
    granite, Jamba, Qwen3-MoE and xLSTM, and a rank's param and FedAdam
    server-state bytes are ``dryrun.per_device_bytes`` on this mesh.
  * Each layer's gathered weights die with the layer
    (``sharding.count_gathers``, the bytes of gathered weights alive):
    in a training step (the remat recompute gathers each layer again),
    in prefill and in a decode step, the most alive at once is at most
    the unembedding's and the largest layer's, nothing is left alive
    after, and the gathers are counted layer by layer (the MoE's experts
    gathered in training and prefill, not in decode).
  * The MoE: ``gather_tokens`` with the expert F cut over ``data`` (each
    rank's output the sum of the ranks' F partials) within 1e-5 of no
    mesh in float32, and each rank's share of the prompt tokens routed to
    the experts no mesh routes them to, in prefill (``gather_weights``)."""
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun, spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model, moe, token_shape
from repro_torch.models import sharding as sh
from repro_torch.optim import get_server_optimizer
from repro_torch.pytree import flat_dict

SIZES = (1, 2, 2)
N_DATA = 2
C, D, F, R = 3, 8, 6, 4                   # lanes (vmap), width, hidden, rows
TOL = 1e-6
MOE_TOL = 1e-5
ARCHS = ("granite-3-2b", "jamba-1.5-large-398b", "qwen3-moe-235b-a22b",
         "xlstm-125m")
B, S, GEN = 4, 12, 3                      # the LM runs' batch and lengths


def draw(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def mesh_record():
    return sh.Mesh(("pod", "data", "model"), SIZES,
                   tuple(range(int(np.prod(SIZES)))))


# ---------------------------------------------------------------- (a)

def layer_loss(w, x):
    """A rank's mean loss over its rows ``x`` of a weight ``w`` held cut
    over ``data`` along dim 0 and gathered for the layer."""
    return torch.tanh(x @ sh.gather_from_data(w, 0)).square().mean()


def partial_sum(w, x):
    """Partial products over the rank's share of the contraction, summed
    over ``data`` for a computation every rank repeats."""
    i, n = sh.data_index(), D // N_DATA
    return torch.sin(sh.reduce_from_data(
        x[:, i * n:(i + 1) * n] @ w)).sum()


def collective_cases():
    w, x = draw(1, D, F), draw(2, N_DATA * R, D)
    i = sh.data_index()
    share = w[i * (D // N_DATA):(i + 1) * (D // N_DATA)]
    rows = x[i * R:(i + 1) * R]
    lanes = lambda t: t.expand((C,) + tuple(t.shape))  # noqa: E731
    return {"forward": torch.equal(sh.gather_from_data(share, 0), w),
            "grad": grad(layer_loss)(share, rows) / N_DATA,
            "grad vmap": vmap(grad(layer_loss))(lanes(share), lanes(rows))
            / N_DATA,
            "partial": grad(partial_sum, argnums=(0, 1))(share, x),
            "partial vmap": vmap(grad(partial_sum, argnums=(0, 1)))(
                lanes(share), lanes(x))}


def collective_reference():
    """No mesh: the gradient of the whole batch's mean loss (each rank's
    rows the same count), and the partial sums' function unsplit."""
    w, x = draw(1, D, F), draw(2, N_DATA * R, D)
    whole = grad(lambda w: torch.tanh(x @ w).square().mean())(w)
    part = grad(lambda w, x: torch.sin(x @ w).sum(), argnums=(0, 1))(w, x)
    return whole, part


# ---------------------------------------------------------------- (b)

def rest_cases():
    out = {}
    for arch in ARCHS:
        model = build_model(reduced(get_config(arch)))
        specs = model.logical_specs
        whole = flat_dict(model.init(torch.Generator().manual_seed(0)))
        local = sp.shard_params(whole, specs)
        back = sp.gather_params(local, specs, model.param_specs())
        opt = get_server_optimizer("fedadam")
        out[arch] = (all(torch.equal(back[k], whole[k]) for k in whole),
                     sp.param_bytes(local), sp.param_bytes(opt.init(local)),
                     sorted(k for k in whole if sh.DATA in sp.leaf_cut(
                         whole[k].shape, sp.flat_logical(specs)[k],
                         sh.get_mesh())))
    return out


def state_bytes(model, mesh):
    """The dry run's bytes of a FedAdam server state (m and v, float32)
    of ``model``'s params on ``mesh``."""
    f32 = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
           for k, v in flat_dict(model.param_specs()).items()}
    logical = sp.flat_logical(model.logical_specs)
    return 2 * dryrun.per_device_bytes(f32, logical, mesh)


# ---------------------------------------------------------------- (c)

def lm_inputs(cfg, seed=3):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, token_shape(cfg, B, S + 1)))
    return {"tokens": toks[:, :S], "targets": toks[:, 1:]}


def lifetimes(arch):
    """The gather counts of one training step on the rank's rows, one
    prefill and one decode step: {phase: (calls, peak bytes, bytes alive
    after)}."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = sp.shard_params(model.init(torch.Generator().manual_seed(0)),
                             model.logical_specs)
    batch = {k: sh.local_share(v, sh.DATA, 0)
             for k, v in lm_inputs(cfg).items()}
    out = {}
    with sh.count_gathers() as st:
        grad_and_value(model.loss_fn, has_aux=True)(params, batch)
    out["train"] = (st["calls"], st["peak"], st["live"])
    with torch.inference_mode():
        with sh.count_gathers() as st:
            _, state = model.prefill(params, {"tokens": batch["tokens"]},
                                     S + GEN)
        out["prefill"] = (st["calls"], st["peak"], st["live"])
        with sh.count_gathers() as st:
            model.decode_step(params, state, batch["targets"][:, -1], S)
        del state
        out["decode"] = (st["calls"], st["peak"], st["live"])
    return out


def expected_gathers(arch, mesh):
    """{phase: (gathers, the most gathered bytes a phase may hold)} from
    the cuts: a layer's gathered weights, the largest layer's and the
    unembedding's."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    shapes = {k: v for k, v in flat_dict(model.param_specs()).items()}
    with sh.use_mesh(mesh):
        cuts = model.data_cuts()
    both = sp.leaf_cuts({k: tuple(v.shape) for k, v in shapes.items()},
                        model.logical_specs, mesh)
    slot_bytes, slot_calls, moe_calls = {}, {}, 0
    for k in cuts:
        v = shapes[k]
        # gathered whole over data, still the rank's share over model
        size = v.numel() * v.element_size() // (
            mesh.shape[sh.MODEL] if sh.MODEL in both[k] else 1)
        if k == "unembed":
            unembed = size
            continue
        slot = k.split("/")[1]
        slot_bytes[slot] = slot_bytes.get(slot, 0) + size // model.n_groups
        slot_calls[slot] = slot_calls.get(slot, 0) + 1
        moe_calls += "/moe/" in k
    per_pass = sum(slot_calls.values()) * model.n_groups
    bound = unembed + max(slot_bytes.values())
    return {"train": (2 * per_pass + 1, bound),
            "prefill": (per_pass + 1, bound),
            "decode": (per_pass - moe_calls * model.n_groups + 1, bound)}


# ---------------------------------------------------------------- (d)

def moe_case():
    """The reduced Qwen3-MoE's first MoE layer in decode (one token a
    sequence, the rank's rows) with its experts as the rank holds them:
    (output, whether F is cut)."""
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    model = build_model(cfg)
    specs = model.logical_specs
    whole = flat_dict(model.init(torch.Generator().manual_seed(0)))
    local = sp.shard_params(whole, specs)
    p = {k.split("/")[-1]: v[0] for k, v in local.items()
         if k.startswith("layers/slot0/moe/")}
    x = draw(7, B, 1, cfg.d_model)
    mine = sh.local_share(x, sh.batch_split_axes(), 0)
    with torch.inference_mode():
        out, _ = moe.moe_apply(p, mine, cfg=cfg.moe, act=cfg.act,
                               mode="gather_tokens")
    return out, p["w1"].shape[-1] < cfg.moe.d_expert


def routing_case():
    """The expert ids of every MoE layer's routing of the prompt in
    prefill, on this process's rows (all of them off a mesh)."""
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    model = build_model(cfg)
    params = sp.shard_params(model.init(torch.Generator().manual_seed(0)),
                             model.logical_specs)
    toks = lm_inputs(cfg)["tokens"]
    mine = sh.local_share(toks, sh.batch_split_axes(), 0)
    ids, route = [], moe._route

    def recording(x2d, router, mcfg):
        eid, gate, aux = route(x2d, router, mcfg)
        ids.append(eid.clone())
        return eid, gate, aux

    moe._route = recording
    try:
        with torch.inference_mode():
            model.prefill(params, {"tokens": mine}, S)
    finally:
        moe._route = route
    return ids


# ---------------------------------------------------------------- ranks

def rank_main(mesh):
    torch.use_deterministic_algorithms(True)
    return {"collectives": collective_cases(), "rest": rest_cases(),
            "lifetimes": {a: lifetimes(a) for a in
                          ("granite-3-2b", "jamba-1.5-large-398b")},
            "moe": moe_case(), "routing": routing_case()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spmd.run(rank_main, sizes=SIZES, device="cpu",
                    init_method=spmd.init_file(tmp_path_factory.mktemp(
                        "fsdp")), all_ranks=True, verbose=False)


def data_coord(rank):
    return (rank // SIZES[2]) % SIZES[1]


def close(got, want, tol=TOL):
    gap = float((got - want).abs().max())
    assert gap <= tol * max(1.0, float(want.abs().max())), gap


def test_gather_from_data_forward_and_backward(ranks):
    whole, _ = collective_reference()
    n = D // N_DATA
    for rank, got in enumerate(ranks):
        got = got["collectives"]
        assert got["forward"], rank
        i = data_coord(rank)
        mine = whole[i * n:(i + 1) * n]
        close(got["grad"], mine)
        for lane in range(C):
            close(got["grad vmap"][lane], mine)


def test_reduce_from_data_under_grad_and_vmap(ranks):
    _, (gw, gx) = collective_reference()
    n = D // N_DATA
    for rank, got in enumerate(ranks):
        got = got["collectives"]
        i = data_coord(rank)
        (w, x), (wv, xv) = got["partial"], got["partial vmap"]
        close(w, gw[i * n:(i + 1) * n])
        close(x[:, i * n:(i + 1) * n], gx[:, i * n:(i + 1) * n])
        for lane in range(C):
            close(wv[lane], gw[i * n:(i + 1) * n])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_at_rest_round_trip_and_bytes(ranks, arch):
    model = build_model(reduced(get_config(arch)))
    mesh = mesh_record()
    want = dryrun.per_device_bytes(model.param_specs(), model.logical_specs,
                                   mesh)
    for rank, got in enumerate(ranks):
        same, held, state, cut = got["rest"][arch]
        assert same, (arch, rank)
        assert held == want, (arch, rank, held, want)
        assert state == state_bytes(model, mesh), (arch, rank)
        assert "unembed" in cut, arch
    whole = sp.param_bytes(model.param_specs())
    assert want < whole


@pytest.mark.parametrize("arch", ("granite-3-2b", "jamba-1.5-large-398b"))
def test_gathered_weights_die_with_their_layer(ranks, arch):
    want = expected_gathers(arch, mesh_record())
    for rank, got in enumerate(ranks):
        for phase, (calls, peak, live) in got["lifetimes"][arch].items():
            n, bound = want[phase]
            assert calls == n, (arch, phase, rank, calls, n)
            assert 0 < peak <= bound, (arch, phase, rank, peak, bound)
            assert live == 0, (arch, phase, rank, live)


def test_moe_decode_sums_f_partials_over_data(ranks):
    with sh.use_mesh(None):
        want, cut = moe_case()
    assert not cut
    n = want.shape[0] // int(np.prod(SIZES[:2]))
    for rank, got in enumerate(ranks):
        out, cut = got["moe"]
        assert cut, rank
        i = data_coord(rank)
        close(out, want[i * n:(i + 1) * n], MOE_TOL)


def test_prompt_routing_share_matches_no_mesh(ranks):
    with sh.use_mesh(None):
        want = routing_case()
    n = B // N_DATA
    for rank, got in enumerate(ranks):
        ids = got["routing"]
        assert len(ids) == len(want) > 0
        i = data_coord(rank)
        for g, w in zip(ids, want):
            rows = w.reshape(B, S, -1)[i * n:(i + 1) * n].reshape(g.shape)
            assert torch.equal(g, rows), rank
