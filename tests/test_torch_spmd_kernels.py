"""The commit kernels' row split across real processes: ``gloo`` ranks on
the CPU (``repro_torch.launch.spmd``), each running the plain versions of
the five commit kernels on its own rows of the blocked stack
(``kernels.ops.rows_map`` / ``rows_reduce``), then gathering the rows.

On a ``pod`` 2 x ``data`` 2 x ``model`` 1 mesh of 4 ranks and a ``data`` 3
mesh of 3 ranks (13 rows, which 3 does not divide: zero rows pad them),
every entry point equals the unsharded call in this process bit for bit:
``fused_accum``, ``plain_commit`` and ``secure_commit`` with the slots
whole and with the slots split over the client axes (exchanged to the row
split by one ``all_to_all``), the secure commit from a nonzero ``base``,
with stochastic rounding drawn whole on every rank, and through its plain
version; ``quantize`` and ``topk_sparsify`` as row maps.  The secure
masks cancel from each rank's global base: the results are the unsharded
ones, not only the unmasked sum.  Then the collectives against their
definitions, a rank that raises failing the run within its timeout, and a
``model`` 2 mesh that builds and runs what used to raise there (serving
included); and the MoE's decode layout over a split batch, each rank's
output its share of the unsplit layer's."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import secure_agg as sec
from repro_torch.kernels import ops
from repro_torch.launch import spmd
from repro_torch.models import sharding as sh

K, R, BLOCK = 12, 13, 256
LEAVES = ((3, 2 * BLOCK + 17), (4 * BLOCK,), (BLOCK - 5,))   # 13 rows
MESHES = {"2x2x1": (2, 2, 1), "1x3x1": (1, 3, 1)}
CLIENT_AXES = {"2x2x1": ("pod", "data"), "1x3x1": ("data",)}


def leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(K,) + s) * 0.1).astype(
        np.float32)) for s in LEAVES]


def slot_vectors(seed=1):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, K).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, 5, K).astype(np.float32))
    part = torch.ones(K)
    part[3] = 0.0
    ids = torch.arange(K, dtype=torch.int32)
    return w, s, part, sec.pair_seeds(sec.commit_key(9), ids), \
        sec.pair_coef_int(ids, part)


def commits(slot_axes=()):
    """Every commit entry point on this process's share of the slots
    (``slot_axes``) or on all of them: {label: result}."""
    xs = leaves()
    w, s, part, seeds, coef = slot_vectors()
    mine = [sh.local_share(x, slot_axes, 0) for x in xs]
    w_eff = w * part
    out = {
        "fused_accum": ops.fused_accum_tree(mine, w, s, 0.5,
                                            slot_axes=slot_axes),
        "plain_commit": ops.fused_plain_commit_tree(
            mine, w, s, 0.5, bits=8, k=26, slot_axes=slot_axes),
        "plain_commit 4 bits, no top-k": ops.fused_plain_commit_tree(
            mine, w, s, 0.0, bits=4, k=0, slot_axes=slot_axes),
        "secure_commit": ops.fused_secure_commit_tree(
            mine, w_eff, seeds, coef, bits=8, k=26, slot_axes=slot_axes),
        "secure_commit, its plain version": ops.fused_secure_commit_tree(
            mine, w_eff, seeds, coef, bits=8, k=26, use_kernel=False,
            slot_axes=slot_axes),
        "secure_commit, stochastic rounding": ops.fused_secure_commit_tree(
            mine, w_eff, seeds, coef, bits=8, k=0, slot_axes=slot_axes,
            noise_generator=torch.Generator().manual_seed(4)),
        "weighted_sum": ops.weighted_sum_tree(mine, w, slot_axes=slot_axes),
    }
    return {k: list(v) for k, v in out.items()}


def row_maps():
    x = leaves(2)[0]
    w, _, part, seeds, coef = slot_vectors()
    return {
        "quantize": [ops.quantize_dequant(x, bits=8)],
        "quantize 4 bits": [ops.quantize_dequant(x, bits=4)],
        "topk_sparsify": [ops.topk_sparsify(x, k=26)],
        "secure_commit from base 7 * 256": [ops.fused_secure_commit(
            x, w * part, seeds, coef, 7 * BLOCK, bits=8, k=26)],
    }


def collectives(mesh):
    r = torch.tensor([float(mesh.rank)])
    return {"psum": sh.psum(r, mesh.axis_names),
            "pmean data": sh.pmean(r, "data"),
            "all_gather": sh.all_gather(r, mesh.axis_names),
            "all_gather dim 1": sh.all_gather(r[None], mesh.axis_names, 1),
            "all_to_all": sh.all_to_all(
                torch.arange(2 * mesh.size).reshape(mesh.size, 2)
                + 100 * mesh.rank, mesh.axis_names, 0, 1)}


def moe_layer(seed=6, T=12, D=16):
    """An MoE layer's params and [T, 1, D] decode tokens (one a sequence)."""
    from repro_torch.configs.base import MoEConfig
    # a capacity that drops tokens when all 12 route together
    cfg = MoEConfig(num_experts=4, top_k=2, d_expert=8, capacity_factor=0.5)
    rng = np.random.default_rng(seed)
    draw = lambda *shape: torch.from_numpy(                 # noqa: E731
        rng.normal(size=shape).astype(np.float32) * 0.3)
    p = {"router": draw(D, 4), "w1": draw(4, D, 8), "w3": draw(4, D, 8),
         "w2": draw(4, 8, D)}
    return cfg, p, draw(T, 1, D)


def f_share(p, j, n):
    """The experts' share ``j`` of ``n`` along their F dim, as a ``data``
    rank holds them at rest (FSDP)."""
    cut = lambda v, d: v.narrow(d, j * (v.shape[d] // n),   # noqa: E731
                                v.shape[d] // n)
    return dict(p, w1=cut(p["w1"], 2), w3=cut(p["w3"], 2), w2=cut(p["w2"], 1))


def moe_decode(mode="gather_tokens"):
    """The MoE over this process's share of the tokens (all of them off a
    mesh), its experts' F as the rank holds it at rest (cut over ``data``
    where the axis divides it): gather_tokens routes every process's
    tokens together, as the reference's decode layout does, and sums the
    F shares' partial outputs over ``data``; gather_weights gathers F."""
    from repro_torch.models import moe
    cfg, p, x = moe_layer()
    mine = sh.local_share(x, sh.batch_split_axes(), 0)
    n = sh.data_split(cfg.d_expert)
    return moe.moe_apply(f_share(p, sh.data_index() % n, n), mine, cfg=cfg,
                         act="swiglu", mode=mode)[0]


def moe_partials(n):
    """The decode layout with no mesh, its experts cut into ``n`` F shares
    and the shares' outputs added in order (the sum over ``data`` of a
    mesh whose ``data`` is ``n``): the whole layer where ``n`` is 1."""
    from repro_torch.models import moe
    cfg, p, x = moe_layer()
    if cfg.d_expert % n:
        n = 1
    return sum(moe.moe_apply(f_share(p, j, n), x, cfg=cfg, act="swiglu",
                             mode="gather_tokens")[0] for j in range(n))


def unsharded_cases():
    """The entry points' results with no mesh, and the secure commit with
    every mask coefficient 0 (the unmasked sum)."""
    w, _, part, seeds, coef = slot_vectors()
    return {"commits": commits(), "maps": row_maps(),
            "moe decode": moe_decode(),
            "unmasked": ops.fused_secure_commit_tree(
                leaves(), w * part, seeds, torch.zeros_like(coef), bits=8,
                k=26)}


def rank_cases(mesh, client_axes):
    out = {"fusion_axes": sh.fusion_axes(), "whole": commits(),
           "split": commits(client_axes), "maps": row_maps(),
           "collectives": collectives(mesh), "moe decode": moe_decode(),
           "moe train": moe_decode("gather_weights")}
    if mesh.rank == 0:
        # the references, in a process of one thread as the ranks are
        with sh.use_mesh(None):
            out["unsharded"] = unsharded_cases()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_kernels")
    return {name: spmd.run(rank_cases, (CLIENT_AXES[name],), sizes=sizes,
                           device="cpu", init_method=spmd.init_file(tmp),
                           all_ranks=True, verbose=False)
            for name, sizes in MESHES.items()}


@pytest.fixture(scope="module")
def unsharded(ranks):
    """The entry points' results with no mesh (rank 0's of the 4 ranks)."""
    return ranks["2x2x1"][0]["unsharded"]


@pytest.mark.parametrize("layout", ["whole", "split"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_commit_kernels_row_split_bit_for_bit(ranks, unsharded, mesh,
                                              layout):
    want = unsharded["commits"]
    for rank, got in enumerate(ranks[mesh]):
        assert got["fusion_axes"] == CLIENT_AXES[mesh]
        assert list(got[layout]) == list(want)
        for label, leaves_want in want.items():
            for g, w in zip(got[layout][label], leaves_want):
                assert torch.equal(g, w), (mesh, layout, rank, label)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_row_maps_and_base_bit_for_bit(ranks, unsharded, mesh):
    want = unsharded["maps"]
    for got in ranks[mesh]:
        for label, (w,) in want.items():
            assert torch.equal(got["maps"][label][0], w), (mesh, label)


def test_secure_masks_cancel_from_the_global_base(unsharded):
    """The unsharded secure commit the ranks equal is the unmasked
    quantized sum: what the masks added cancels."""
    for a, b in zip(unsharded["commits"]["secure_commit"],
                    unsharded["unmasked"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_collectives(ranks, mesh):
    n = int(np.prod(MESHES[mesh]))
    sizes = dict(zip(("pod", "data", "model"), MESHES[mesh]))
    for rank, got in enumerate(ranks[mesh]):
        c = got["collectives"]
        assert float(c["psum"]) == sum(range(n))
        data = [r for r in range(n) if r // sizes["data"]
                == rank // sizes["data"]]
        assert float(c["pmean data"]) == sum(data) / len(data)
        assert c["all_gather"].tolist() == list(map(float, range(n)))
        assert c["all_gather dim 1"].tolist() == [list(map(float,
                                                           range(n)))]
        want = torch.cat([torch.arange(2 * n).reshape(n, 2)[rank:rank + 1]
                          + 100 * j for j in range(n)], 1)
        assert torch.equal(c["all_to_all"], want)


def _raises_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails here")
    return sh.psum(torch.ones(1), mesh.axis_names)


def test_a_failing_rank_fails_the_run(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        spmd.run(_raises_on_rank_one, sizes=(1, 2, 1), device="cpu",
                 init_method=spmd.init_file(tmp_path), group_timeout_s=30,
                 timeout_s=60, verbose=False)
    assert "rank one fails here" in str(err.value)
    assert "Traceback" in str(err.value)
    assert time.perf_counter() - t0 < 60


def _model_axis_cases(mesh):
    """Everything a ``model`` 2 mesh runs, on this rank's shares, and the
    same calls with no mesh on whole values: {name: (split, unsplit)},
    serving's prefill logits among them."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import FLConfig, build_fl_round_step
    from repro_torch.models import build_model, moe, xlstm
    from repro_torch.optim import get_client_optimizer, get_server_optimizer
    x = torch.ones(2, 4, 8)
    i = mesh.coords["model"]
    cfg_moe = reduced(get_config("qwen3-moe-235b-a22b")).moe
    rng = np.random.default_rng(3)
    draw = lambda *shape: torch.from_numpy(                 # noqa: E731
        rng.normal(size=shape).astype(np.float32) * 0.3)
    p_moe = {"router": draw(8, 4), "w1": draw(4, 8, 6), "w3": draw(4, 8, 6),
             "w2": draw(4, 6, 8)}
    xm = draw(2, 5, 8)
    p_sl = {**{f"w{g}": draw(8, 8) for g in "ifzo"},
            **{f"r{g}": draw(4, 2, 2) for g in "ifzo"},
            **{f"b{g}": draw(8) for g in "ifzo"}, "down": draw(8, 8)}
    cut = {"w": lambda t: t[:, 4 * i:4 * i + 4], "r": lambda t: t[2 * i:
           2 * i + 2], "b": lambda t: t[4 * i:4 * i + 4]}
    p_sl_mine = {k: cut[k[0]](v) if k != "down" else v[4 * i:4 * i + 4]
                 for k, v in p_sl.items()}
    step = lambda: build_fl_round_step(                     # noqa: E731
        lambda p, b: ((p["w"] * b["x"].mean()).sum(), {}),
        get_client_optimizer("sgd"), get_server_optimizer("fedavg"),
        FLConfig(num_clients=2, client_exec="sequential"))(
            {"w": torch.ones(2)}, (), {"x": torch.ones(2, 2, 2)},
            torch.ones(2), torch.ones(2), torch.Generator())[0]["w"]
    commit = lambda: ops.fused_accum_tree(                  # noqa: E731
        [torch.arange(16.0).reshape(2, 8)], torch.ones(2), torch.zeros(2),
        0.0)[0]
    out = {"coords": mesh.coords,
           "batch spec": sh.shard(x, sh.BATCH, None, None) is x,
           "shard": sh.shard(x, sh.BATCH, None, sh.MODEL) is x,
           "slstm heads": xlstm._head_shard_mesh(4, 8)}
    split = {
        "round": step(), "commit": commit(),
        "moe": moe.moe_apply({**p_moe, **{k: p_moe[k][2 * i:2 * i + 2]
                                         for k in ("w1", "w3", "w2")}},
                             xm, cfg=cfg_moe, act="swiglu")[0],
        "slstm": xlstm.slstm_apply(p_sl_mine, xm, n_heads=4)[0]}
    with sh.use_mesh(None):
        whole = {"round": step(), "commit": commit(),
                 "moe": moe.moe_apply(p_moe, xm, cfg=cfg_moe,
                                      act="swiglu")[0],
                 "slstm": xlstm.slstm_apply(p_sl, xm, n_heads=4)[0]}
    out.update({k: (split[k], whole[k]) for k in split})
    from repro_torch.launch import specs
    model = build_model(reduced(get_config("granite-3-2b")))
    params = model.init(torch.Generator().manual_seed(0))
    prompt = {"tokens": torch.arange(4)[None] % 7}
    out["serving"] = (model.prefill(specs.shard_params(
        params, model.logical_specs), prompt, 8)[0],)
    with sh.use_mesh(None):
        out["serving"] += (model.prefill(params, prompt, 8)[0],)
    return out


def test_a_model_axis_mesh_builds_and_raises(tmp_path):
    """A ``model`` 2 mesh builds, and what used to raise there runs: the
    round, the commit, the MoE on the rank's experts and the sLSTM on its
    heads equal their unsplit results (the round and the commit bit for
    bit); serving, which raised on such a mesh before, runs and equals
    it too."""
    got = spmd.run(_model_axis_cases, sizes=(1, 1, 2), device="cpu",
                   init_method=spmd.init_file(tmp_path), all_ranks=True,
                   verbose=False)
    for rank, out in enumerate(got):
        assert out["coords"] == {"pod": 0, "data": 0, "model": rank}
        assert out["batch spec"] and out["shard"]
        assert out["slstm heads"] == 2
        for name in ("round", "commit"):
            assert torch.equal(*out[name]), name
        for name in ("moe", "slstm", "serving"):
            torch.testing.assert_close(*out[name], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_layouts_over_a_split_batch(ranks, unsharded, mesh):
    """Under a split batch the MoE's decode layout routes all processes'
    tokens at once (the capacity from the whole count): each process's
    output is its share of the unsplit layer's, whose F shares' partial
    outputs are added over ``data`` where the axis cuts F (here data 2).  The train layout routes
    the process's own tokens (the capacity from the local count), as the
    reference's ``gather_weights`` shard_map does; here that drops other
    tokens than the whole batch does."""
    from repro_torch.models import moe
    cfg, p, x = moe_layer()
    data = MESHES[mesh][1]
    want = unsharded["moe decode"] if data == 1 else moe_partials(data)
    n = int(np.prod(MESHES[mesh]))
    m = want.shape[0] // n
    differs = False
    for rank, got in enumerate(ranks[mesh]):
        mine = slice(rank * m, (rank + 1) * m)
        assert torch.equal(got["moe decode"], want[mine])
        local = moe.moe_apply(p, x[mine], cfg=cfg, act="swiglu")[0]
        assert torch.equal(got["moe train"], local)
        differs |= not torch.equal(local, want[mine])
    assert differs
