"""Every family's gradient split over a ``model`` axis, across real
processes: four ``gloo`` ranks on the CPU (``pod`` 1 x ``data`` 2 x
``model`` 2), spawned once for the file.  Each rank holds the params as
``launch.specs.shard_params`` cuts them, takes one ``grad_and_value`` of
the model's loss on a seeded batch (the MLPs, the embedding and the
unembedding tensor-parallel, the experts, the Mamba channels and the
xLSTM heads split over ``model``; attention whole where the heads are
fewer than 16; each layer's weights gathered over ``data``), gathers each
leaf's gradient with ``gather_params``, and holds it within 1e-5 of its
largest magnitude against the same loss with no mesh (float32,
deterministic algorithms); the loss within 1e-6.  The zoo: the reduced
granite, a 16-head variant of it (so ``attn_tp`` splits ``wq``/``wo``
over the heads and each rank's heads meet their own KV heads), Qwen3-MoE,
the reduced Jamba, xlstm-125m (and a 3-head variant, whose sLSTM heads the
axis does not divide), MusicGen (codebooks) and the VLM (cross
attention); and the granite under ``vmap`` of the gradient, as the
parallel round runs it."""
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs import get_config, reduced
from repro_torch.launch import spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model, token_shape
from repro_torch.models import sharding as sh
from repro_torch.pytree import flat_dict

SIZES = (1, 2, 2)
B, S = 2, 16
TOL = 1e-5
CASES = {
    "granite": ("granite-3-2b", {}),
    "granite 16 heads": ("granite-3-2b", dict(n_heads=16, kv_heads=4,
                                              head_dim=16)),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "xlstm": ("xlstm-125m", {}),
    # 3 sLSTM heads: the axis divides D but not the heads, so the split
    # weights are gathered and the block runs whole on every rank
    "xlstm 3 heads": ("xlstm-125m", dict(d_model=258, n_heads=3, kv_heads=3,
                                         head_dim=86)),
    "musicgen": ("musicgen-medium", {}),
    "vlm": ("llama-3.2-vision-90b", {}),
}


def config(name):
    arch, kw = CASES[name]
    return reduced(get_config(arch)).replace(**kw)


def batch(cfg, lead=()):
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, token_shape(cfg, *lead, B, S + 1)))
    seq = len(lead) + 1
    out = {"tokens": toks.narrow(seq, 0, S), "targets": toks.narrow(seq, 1, S)}
    if cfg.cross_attn_every:
        out["patches"] = torch.from_numpy(rng.normal(size=(
            *lead, B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return out


def whole_batch_grads(g, model):
    """The gradient of the loss of the batch that every rank holds whole:
    a leaf cut over ``data`` (FSDP) comes back from its gather's backward
    summed over the ``data`` ranks' equal cotangents, so it is divided by
    their count, as the round divides it."""
    n = sh.shard_count(sh.DATA)
    return {k: v / n if k in model.data_cuts() else v for k, v in g.items()}


def grads(name):
    """(gradients gathered whole, loss, leaves split) on this rank, and the
    same with no mesh."""
    cfg = config(name)
    model = build_model(cfg)
    specs = model.logical_specs
    params = flat_dict(model.init(torch.Generator().manual_seed(0)))
    local = sp.shard_params(params, specs)
    step = grad_and_value(model.loss_fn, has_aux=True)
    g, (loss, _) = step(local, batch(cfg))
    whole = sp.gather_params(whole_batch_grads(g, model), specs,
                             model.param_specs())
    # the leaves split over model (those cut over data are cut anyway)
    split = sorted(k for k, c in sp.leaf_cuts(
        {k: tuple(v.shape) for k, v in params.items()}, specs).items()
        if sh.MODEL in c)
    with sh.use_mesh(None):
        g0, (loss0, _) = step(params, batch(cfg))
    return (whole, float(loss), split), (g0, float(loss0))


def stacked_grads():
    """The granite's gradients under ``vmap``, two lanes of the same
    client (the parallel round's form): lane 1 gathered, and no mesh's."""
    cfg = config("granite")
    model = build_model(cfg)
    specs = model.logical_specs
    params = flat_dict(model.init(torch.Generator().manual_seed(0)))
    local = sp.shard_params(params, specs)
    two = lambda t: {k: v.expand((2,) + tuple(v.shape)).contiguous()  # noqa
                     for k, v in t.items()}
    step = vmap(grad_and_value(model.loss_fn, has_aux=True))
    g, (loss, _) = step(two(local), two(batch(cfg)))
    whole = sp.gather_params(whole_batch_grads(
        {k: v[1] for k, v in g.items()}, model), specs, model.param_specs())
    with sh.use_mesh(None):
        g0, (loss0, _) = grad_and_value(model.loss_fn, has_aux=True)(
            params, batch(cfg))
    return (whole, float(loss[1]), []), (g0, float(loss0))


def rank_main(mesh):
    torch.use_deterministic_algorithms(True)
    out = {name: grads(name) for name in CASES}
    out["granite vmap"] = stacked_grads()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spmd.run(rank_main, sizes=SIZES, device="cpu",
                    init_method=spmd.init_file(tmp_path_factory.mktemp(
                        "model_axis_grads")), all_ranks=True, verbose=False)


@pytest.mark.parametrize("name", list(CASES) + ["granite vmap"])
def test_split_gradients_match_no_mesh(ranks, name):
    for rank, got in enumerate(ranks):
        (g, loss, split), (g0, loss0) = got[name]
        assert abs(loss - loss0) <= 1e-6, (rank, loss, loss0)
        for k in g0:
            gap = float((g[k] - g0[k]).abs().max())
            assert gap <= TOL * float(g0[k].abs().max()), (name, rank, k, gap)
        if name != "granite vmap":
            # every family splits something over model
            assert split, name
    split = ranks[0]["granite 16 heads"][0][2]
    assert "layers/slot0/wq" in split and "layers/slot0/wo" in split
    assert "layers/slot0/wk" not in split
    assert "layers/slot0/wq" not in ranks[0]["granite"][0][2]
