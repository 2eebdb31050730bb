"""The blockwise commits on each rank's ``data``/``model`` shares
(``core.pipeline.UpdatePipeline.model_commit``), across real processes:
``gloo`` ranks on the CPU, spawned once for each of pod 1 x data 2 x
model 2 and pod 2 x data 2 x model 2.

The deltas are the reduced granite's and the reduced Jamba's trees, their
real leaf names, each rank holding its shares as the params' sanitised
specs cut them (``launch.specs.leaf_cuts`` on the real shapes).  Blocks
run along a leaf's last dim, so each leaf keeps its real last dim and its
cuts, and every other dim is narrowed to two rows a share (``narrow``),
which keeps the commits cheap.  With block 256 the trees are mixed: a
last dim of d_model 256 cut in two straddles a block (granite's
``embed``, ``wo``, ``w2``; the Jamba's ``embed``, ``wo``, ``w2``,
``out_proj``), the wider last dims do not; with block 64 nothing
straddles.

  * Every blockwise configuration (q8 deterministic, top-k, q8 + top-k,
    q8 stochastic, dropout, secure q8 + top-k deterministic, secure q8
    stochastic, secure float-domain), fused and unfused, through every
    commit path (the parallel ``combine``, the sequential
    ``contribution`` a slot at a time, the pod_sequential cross-pod
    ``combine_pods``, the async buffer commit and the chunked commit's
    ``combine_unnormalised``), is bit for bit the gathered composition
    ``cuts_share(fn(cuts_whole(deltas)))`` on the same deltas and the
    same generator state.
  * The commit gathers exactly the leaves whose blocks straddle a shard,
    as this file reckons them from the shapes, the cuts and the block:
    3 of granite's 9 cut leaves and 4 of the Jamba's 21 at block 256, none
    at block 64, on both meshes; each over the axes that cut its last dim
    alone (``w2``, cut over ``model`` on its rows too, one gather).
  * A dim cut over both ``data`` and ``model``, in either order, the same
    on leaves made for it (no arch of the zoo has one).
  * The secure commit's plain version, with upper-triangle coefficients
    (its masks do not cancel, so its output shows each element's mask
    word), run on one share of a cut tree with its row table
    (``kernels.ops.row_table``), equals the matching rows of the whole
    bucket's output: the share keeps the global mask indices."""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.pipeline import (build_update_pipeline, cuts_share,
                                      cuts_whole)
from repro_torch.core.round import FLConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.pytree import flat_dict

MESHES = ((1, 2, 2), (2, 2, 2))
ARCHS = ("granite-3-2b", "jamba-1.5-large-398b")
BLOCKS = (64, 256)
STRADDLING_AT_256 = {"granite-3-2b": 3, "jamba-1.5-large-398b": 4}
K = 2                                  # slots (clients, pods, buffer)
CONFIGS = {
    "q8_deterministic": dict(quantize_bits=8, stochastic_rounding=False),
    "topk": dict(topk_frac=0.1),
    "q8_topk": dict(quantize_bits=8, stochastic_rounding=False,
                    topk_frac=0.1),
    "q8_stochastic": dict(quantize_bits=8),
    "dropout": dict(dropout_frac=0.25),
    "secure_q8_topk_deterministic": dict(quantize_bits=8,
                                         stochastic_rounding=False,
                                         topk_frac=0.1, secure=True),
    "secure_q8_stochastic": dict(quantize_bits=8, secure=True),
    "secure_float": dict(secure=True),
}
PATHS = ("parallel", "sequential", "pod_sequential", "async", "chunked")


def arch_shapes(arch) -> tuple:
    """(the model, ``{leaf: whole shape}``)."""
    lm = build_model(reduced(get_config(arch)))
    return lm, {k: tuple(v.shape) for k, v in
                flat_dict(lm.param_specs()).items()}


def mesh_record(sizes):
    return sh.Mesh(("pod", "data", "model"), sizes,
                   tuple(range(math.prod(sizes))))


def reckoned(shapes, cuts, sizes, block) -> list:
    """The cut leaves whose blocks straddle a shard: a last dim cut into
    shares whose length is not a multiple of ``block``."""
    mesh = mesh_record(sizes)
    out = []
    for k, c in cuts.items():
        last = len(shapes[k]) - 1
        n = math.prod(mesh.shape[a] for a, d in c.items() if d == last)
        if n > 1 and (shapes[k][last] // n) % block:
            out.append(k)
    return sorted(out)


def pipe_for(name, block, fused):
    kw = dict(CONFIGS[name])
    secure = kw.pop("secure", False)
    return build_update_pipeline(FLConfig(
        num_clients=K, secure_agg=secure, compression=CompressionConfig(
            block=block, use_fused=fused, **kw)))


def narrow(shape, cut, sizes) -> tuple:
    """A leaf's shape in this file's deltas: its last dim as it is, every
    other dim at most two rows a share of its cut."""
    mesh = mesh_record(sizes)
    last = len(shape) - 1
    return tuple(s if d == last else min(s, 2 * math.prod(
        mesh.shape[a] for a, dd in cut.items() if dd == d))
        for d, s in enumerate(shape))


def whole_deltas(shapes, cuts, sizes, seed) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.normal(
        size=(K,) + narrow(s, cuts.get(k, {}), sizes)) * 0.01).astype(
        np.float32)) for k, s in shapes.items()}


def gathered(fn, whole, cuts):
    """The composition the commit stands for, ``cuts_share(fn(cuts_whole(
    shares)))``, on the ``whole`` leaves that ``cuts_whole`` gives back
    (``arch_cases`` checks that it does): ``fn`` on the whole leaves, its
    result cut to the rank's shares.  The leaves are whole over ``data``
    and ``model``, so ``fn`` runs with them out of the fusion axes (the
    row kernels are row-local, so their rows' split over the fusion axes
    changes no bit: ``test_torch_spmd_kernels.py``)."""
    with sh.exclude_axes(sh.DATA, sh.MODEL):
        out = fn(whole)
    if isinstance(out, tuple):
        return (cuts_share(out[0], cuts),) + out[1:]
    return cuts_share(out, cuts)


def run_path(path, pipe, deltas, commit):
    """One commit path on the [K, ...] shares ``deltas`` through
    ``commit(fn, tree, lead)``; returns the summed (or normalised)
    tree."""
    gen = torch.Generator().manual_seed(11)
    w = torch.tensor([1.0, 3.0])
    m = torch.ones(K)
    losses = torch.tensor([0.5, 0.25])
    stal = torch.tensor([0.0, 2.0])
    ids = torch.arange(K, dtype=torch.int32)
    pods = sh.get_mesh().live(("pod",))
    share = lambda x: sh.local_share(x, pods, 0)        # noqa: E731
    if path == "parallel":
        return commit(lambda t: pipe.combine(
            t, share(w), share(m), share(losses), gen, slot_axes=pods),
            {k: share(v) for k, v in deltas.items()}, 1)[0]
    if path == "sequential":
        key = pipe.mask_key(gen) if pipe.cfg.secure_agg else None
        acc = None
        for c in range(K):
            wt = pipe.client_weight(w[c], m[c], losses[c])
            got = commit(lambda t: pipe.contribution(
                t, wt, gen, idx=c, ids=ids, participation=m, key=key),
                {k: v[c] for k, v in deltas.items()}, 0)
            acc = got if acc is None else pipe.accum_add(acc, got)
        return acc

    if path == "pod_sequential":
        def cross_pod(t):
            with sh.exclude_axes(*pods):
                sums = pipe.compress_each(t, gen, pods)
            return pipe.combine_pods(sums, w.sum(), gen, compressed=True,
                                     slot_axes=pods)
        return commit(cross_pod, {k: share(v) for k, v in deltas.items()},
                      1)
    stage = pipe.combine if path == "async" else pipe.combine_unnormalised
    return commit(lambda t: stage(t, w, m, losses, gen, ids=ids,
                                  staleness=stal, exponent=0.5), deltas,
                  1)[0]


def commit_cases(shapes, cuts, sizes, logical=None):
    """Every configuration, fused and unfused, through every path, on the
    rank's shares of deltas of ``shapes`` (``narrow``ed) cut by ``cuts``;
    with ``logical``, also whether the shares are ``shard_leaf``'s."""
    whole = whole_deltas(shapes, cuts, sizes, 7)
    deltas = cuts_share(whole, cuts, 1)
    back = cuts_whole(deltas, cuts, 1)
    out = {}
    for block in BLOCKS:
        for name in CONFIGS:
            for fused in (True, False):
                pipe = pipe_for(name, block, fused)
                for path in PATHS:
                    with sh.count_commit_gathers() as names, \
                            sh.timed_collectives() as stats:
                        got = run_path(path, pipe, deltas,
                                       lambda fn, t, lead: pipe.model_commit(
                                           fn, t, cuts, lead))
                    want = run_path(path, pipe, whole,
                                    lambda fn, t, lead: gathered(fn, t,
                                                                 cuts))
                    calls = K if path == "sequential" else 1
                    out[(block, name, fused, path)] = (
                        set(got) == set(want) and all(
                            torch.equal(got[k], want[k]) for k in want),
                        sorted(names), calls, stats["calls"]["all_gather"])
    return {"cuts": cuts, "cases": out, "cuts_whole": all(
        torch.equal(back[k], v) for k, v in whole.items()),
        "shard_leaf": logical is None or all(
            torch.equal(deltas[k][i], sp.shard_leaf(v[i], logical[k]))
            for k, v in whole.items() for i in range(K))}


def arch_cases(arch, sizes):
    lm, shapes = arch_shapes(arch)
    return commit_cases(shapes, lm.leaf_cuts(), sizes)


# leaves whose one dim is cut over both axes, in either order (no arch of
# the zoo has one): the last dim of "dm" makes shares of 256, of "md" of
# 128 (straddling a block of 256), the rows of "rows" are cut
BOTH = {"dm": ((4, 1024), (None, ("data", "model"))),
        "md": ((4, 512), (None, ("model", "data"))),
        "rows": ((8, 384), (("data", "model"), None))}


def both_cases(sizes):
    shapes = {k: s for k, (s, _) in BOTH.items()}
    logical = {k: spec for k, (_, spec) in BOTH.items()}
    return commit_cases(shapes, sp.leaf_cuts(shapes, logical), sizes,
                        logical)


def rank_main(mesh):
    torch.use_deterministic_algorithms(True)
    out = {arch: arch_cases(arch, mesh.sizes) for arch in ARCHS}
    out["both"] = both_cases(mesh.sizes)
    return out


def spawn(tmp_path_factory, sizes):
    return spmd.run(rank_main, sizes=sizes, device="cpu",
                    init_method=spmd.init_file(tmp_path_factory.mktemp(
                        "commit")), all_ranks=True, verbose=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {sizes: spawn(tmp_path_factory, sizes) for sizes in MESHES}


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_share_commit_equals_gathered_composition(ranks, sizes, arch,
                                                  block, config):
    for rank, got in enumerate(ranks[sizes]):
        cases = got[arch]["cases"]
        for fused in (True, False):
            for path in PATHS:
                same = cases[(block, config, fused, path)][0]
                assert same, (rank, fused, path)


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("block", BLOCKS)
def test_commit_gathers_only_straddling_leaves(ranks, sizes, arch, block):
    _, shapes = arch_shapes(arch)
    for rank, got in enumerate(ranks[sizes]):
        cuts = got[arch]["cuts"]
        assert cuts == sp.leaf_cuts(shapes, build_model(reduced(get_config(
            arch))).logical_specs, mesh_record(sizes))
        want = reckoned(shapes, cuts, sizes, block)
        assert len(want) == (STRADDLING_AT_256[arch] if block == 256
                             else 0)
        assert got[arch]["cuts_whole"], rank
        # each straddling leaf gathered over the axes that cut its last
        # dim alone (a leading-dim cut stays a share): on pod 1 the async
        # commit makes no other gather
        last_axes = sum(sum(d == len(shapes[k]) - 1 for d in cuts[k].values())
                        for k in want)
        for (b, _, _, path), (_, names, calls, gathers) in \
                got[arch]["cases"].items():
            if b == block:
                assert names == sorted(want * calls), (rank, names)
                if path == "async" and sizes[0] == 1:
                    assert gathers == last_axes, (rank, gathers)


@pytest.mark.parametrize("sizes", MESHES)
def test_dim_cut_over_both_axes(ranks, sizes):
    """A dim cut over data and model is taken with its combined share, in
    the order ``shard_leaf`` cuts it: the shares are ``shard_leaf``'s,
    ``cuts_whole`` puts them back, every commit is bit for bit the
    gathered composition, and the leaf whose last dim straddles a block is
    gathered over both axes (two gathers on pod 1)."""
    for rank, got in enumerate(ranks[sizes]):
        got = got["both"]
        assert got["cuts"] == {"dm": {"data": 1, "model": 1},
                               "md": {"model": 1, "data": 1},
                               "rows": {"data": 0, "model": 0}}
        assert got["shard_leaf"] and got["cuts_whole"], rank
        for (block, _, _, path), (same, names, calls, gathers) in \
                got["cases"].items():
            assert same, (rank, block, path)
            assert names == (["md"] * calls if block == 256 else []), names
            if path == "async" and sizes[0] == 1:
                assert gathers == (2 if block == 256 else 0), gathers


# ------------------------------------------------------- mask indices

@pytest.mark.parametrize("cut_dim", [0, 1])
def test_secure_row_table_keeps_global_mask_indices(cut_dim):
    """Two leaves, one cut in two along ``cut_dim`` (its last dim, 512 =
    2 blocks of 128, or its first), one whole: the share's bucket with its
    row table gives the whole bucket's output rows, mask words included
    (upper-triangle coefficients, which do not cancel)."""
    block, bits, n = 128, 8, 2
    rng = np.random.default_rng(3)
    whole = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for s in ((3, 6, 512), (3, 5, 200))]
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (3, 3)).astype(
        np.int64))
    coef = torch.triu(torch.ones(3, 3, dtype=torch.int32), 1)
    w = torch.tensor([[1.0], [0.5], [2.0]])
    xb, metas, rows = ops.pack_blocks(whole, block)
    want = ops.unpack_sums(ref.fused_secure_commit_ref(
        xb, w, seeds, coef, 0, bits, k=16), metas, rows)
    assert not torch.equal(
        want[0], ops.unpack_sums(ref.fused_secure_commit_ref(
            xb, w, seeds, torch.zeros_like(coef), 0, bits, k=16), metas,
            rows)[0])                       # the mask words show
    for index in range(n):
        cut = ((cut_dim, index, n),)
        local = [sh.take_share(whole[0], ((cut_dim + 1, index, n),)),
                 whole[1]]
        table, whole_rows = ops.row_table(local, [cut, ()], block)
        assert whole_rows == xb.shape[1]
        lb, lmetas, lrows = ops.pack_blocks(local, block)
        got = ops.unpack_sums(ref.fused_secure_commit_ref(
            lb, w, seeds, coef, 0, bits, k=16, rows=table), lmetas, lrows)
        assert torch.equal(got[0], sh.take_share(want[0], cut))
        assert torch.equal(got[1], want[1])
        # without the table the share's words are another stream's
        plain = ops.unpack_sums(ref.fused_secure_commit_ref(
            lb, w, seeds, coef, 0, bits, k=16), lmetas, lrows)
        assert not torch.equal(plain[1], want[1])


def test_row_table_of_whole_leaves_is_affine():
    leaves = [torch.zeros(2, 4, 300), torch.zeros(2), torch.zeros(2, 3, 256)]
    table, n = ops.row_table(leaves, [(), (), ()], 256)
    assert n == 4 * 2 + 1 + 3 and torch.equal(table, torch.arange(n))
