"""Flash-decoding over a cache whose slots are split over ``model``, without
processes: each shard's partial softmax (``attention.decode_partials``)
joined by ``sharding.combine_partials`` (the merge that
``merge_partials`` runs on the partials it gathers over ``model``) against
the reference's ``decode_attend`` over the whole cache, on the same numpy
inputs, at 2 and 4 shards: a shard with no valid slot (its max at the
mask's finite -1e30, so its weight is 0 and nothing is NaN), ``pos`` on
each side of a shard boundary, a ring that has wrapped and one that has
not.  float32 to 1e-6 of the largest output; in bfloat16 the merge keeps
the numerator in float32 where the whole cache's softmax is cast to bf16
before ``p v``, a difference of about one bf16 rounding (held to 2^-7).

Then the decode state's cut, on mesh records that carry a rank (no
process group: nothing here gathers): ``LM.init_decode_state`` of the
process's batch share against ``launch.specs.shard_state`` of the whole
state, and its bytes against ``launch.dryrun.per_device_bytes``, for every
assigned arch at its full width (on ``meta``), both decode shapes and
both production meshes, and for the reduced zoo on a ``model`` 2 mesh;
prefill's cache write (the ring reckoned whole, then cut) against the
whole cache's slots; and ``serve.build(shard=True)``, which keeps each
leaf's share as it is drawn, against ``specs.shard_params`` of the whole
draw, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 reduced)
from repro_torch.launch import dryrun, serve
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.pytree import flat_dict

TOL, BF16_TOL = 1e-6, 2 ** -7
S = 16


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def merged(q1, kc, vc, pos, shards, window=0, dtype=torch.float32):
    """decode_partials of each of ``shards`` equal slices of the cache,
    stacked and combined, cast to the model dtype once."""
    n = kc.shape[1] // shards
    parts = [tattn.decode_partials(
        q1, kc[:, r * n:(r + 1) * n], vc[:, r * n:(r + 1) * n], pos,
        window=window, offset=r * n, total=kc.shape[1])
        for r in range(shards)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    out = sh.combine_partials(m, l, o)
    return out.reshape(q1.shape).to(dtype)


CASES = [  # (window, pos): which slots are valid where
    (0, 2),     # every shard but the first has no valid slot
    (0, 7),     # the last slot of the first half
    (0, 8),     # the first slot of the second half
    (0, 15),    # every slot
    (S, 5),     # a ring not yet full
    (S, 37),    # a ring that has wrapped: every slot valid
]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("window,pos", CASES)
def test_merged_shards_equal_the_whole_cache(window, pos, shards):
    # GQA: 8 query heads over 2 kv heads
    q1, kc, vc = rand((2, 8, 16), 1), rand((2, S, 2, 16), 2), \
        rand((2, S, 2, 16), 3)
    want = np.asarray(jattn.decode_attend(jnp.asarray(q1), jnp.asarray(kc),
                                          jnp.asarray(vc), pos,
                                          window=window))
    got = merged(*(torch.from_numpy(a) for a in (q1, kc, vc)), pos, shards,
                 window)
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    # the port's whole-cache decode is the reference's too
    whole = tattn.decode_attend(*(torch.from_numpy(a) for a in (q1, kc, vc)),
                                pos, window=window)
    assert np.abs(whole.numpy() - want).max() <= TOL * np.abs(want).max()


def test_a_shard_with_no_valid_slot_weighs_nothing():
    q1, kc, vc = (torch.from_numpy(rand(s, i)) for i, s in
                  enumerate([(1, 4, 8), (1, S, 4, 8), (1, S, 4, 8)]))
    m, l, o = tattn.decode_partials(q1, kc[:, 8:], vc[:, 8:], 3, offset=8,
                                    total=S)
    assert (m == tattn.NEG_INF).all() and torch.isfinite(l).all()
    m0, l0, o0 = tattn.decode_partials(q1, kc[:, :8], vc[:, :8], 3, total=S)
    out = sh.combine_partials(torch.stack([m0, m]), torch.stack([l0, l]),
                              torch.stack([o0, o]))
    alone = o0 / l0[..., None]
    assert torch.equal(out, alone)


@pytest.mark.parametrize("window,pos", [(0, 8), (S, 37)])
def test_bf16_merge_keeps_the_numerator_in_f32(window, pos):
    q1, kc, vc = (torch.from_numpy(rand(s, i + 10)).to(torch.bfloat16)
                  for i, s in enumerate([(2, 8, 16), (2, S, 2, 16),
                                         (2, S, 2, 16)]))
    exact = tattn.decode_attend(q1.float(), kc.float(), vc.float(), pos,
                                window=window)
    whole = tattn.decode_attend(q1, kc, vc, pos, window=window)
    got = merged(q1, kc, vc, pos, 2, window, torch.bfloat16)
    scale = float(exact.abs().max())
    gap = float((got.float() - whole.float()).abs().max()) / scale
    assert gap <= BF16_TOL, gap
    # neither is further from the float32 result than one bf16 rounding
    for out in (got, whole):
        assert float((out.float() - exact).abs().max()) / scale <= BF16_TOL


def test_merge_over_one_shard_is_the_division():
    m, l, o = (torch.from_numpy(rand(s, i)) for i, s in
               enumerate([(2, 3), (2, 3), (2, 3, 4)]))
    l = l.abs() + 1
    assert torch.equal(sh.merge_partials(m, l, o), o / l[..., None])


def rank_mesh(sizes, axes, rank):
    return sh.Mesh(tuple(axes), tuple(sizes), tuple(range(np.prod(sizes))),
                   rank=rank)


def state_bytes(state):
    return sum(v.numel() * v.element_size() for leaves in state.values()
               for v in leaves.values())


def batch_share(B, mesh):
    ext = np.prod([mesh.shape[a] for a in sh.batch_axes(mesh)])
    return B // ext if B % ext == 0 else B


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_state_shares_are_the_dry_runs(arch):
    model = build_model(get_config(arch))
    for shape in (s for s in INPUT_SHAPES.values() if s.kind == "decode"):
        B, s_max = shape.global_batch, shape.seq_len
        whole = model.init_decode_state(B, s_max, device="meta")
        logical = model.state_logical_specs(B, s_max)
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            mesh = rank_mesh(mesh.sizes, mesh.axis_names, mesh.size - 3)
            with sh.use_mesh(mesh):
                mine = model.init_decode_state(batch_share(B, mesh), s_max,
                                               device="meta")
                cut = sp.shard_state(whole, logical)
            for key in whole:
                for name in whole[key]:
                    assert mine[key][name].shape == cut[key][name].shape, (
                        shape.name, key, name)
            assert mine.cache_len == model.cache_len(s_max)
            assert state_bytes(mine) == dryrun.per_device_bytes(
                whole, logical, mesh), (shape.name, multi)


ZOO = ["granite-3-2b", "starcoder2-7b", "jamba-1.5-large-398b", "xlstm-125m",
       "llama-3.2-vision-90b"]


@pytest.mark.parametrize("arch", ZOO)
def test_reduced_state_shares(arch):
    cfg = reduced(get_config(arch)).replace(sliding_window=8) \
        if arch == "starcoder2-7b" else reduced(get_config(arch))
    model = build_model(cfg)
    B, s_max = 4, 16
    whole = model.init_decode_state(B, s_max)
    logical = model.state_logical_specs(B, s_max)
    split = set()
    for r in range(4):
        mesh = rank_mesh((2, 2), ("data", "model"), r)
        with sh.use_mesh(mesh):
            mine = model.init_decode_state(2, s_max)
            cut = sp.shard_state(whole, logical)
        for key in whole:
            for name in whole[key]:
                assert mine[key][name].shape == cut[key][name].shape
                if cut[key][name].shape[2:] != whole[key][name].shape[2:]:
                    split.add(name)
        assert state_bytes(mine) == dryrun.per_device_bytes(whole, logical,
                                                            mesh)
    want = {"granite-3-2b": {"k", "v"}, "starcoder2-7b": {"k", "v"},
            "jamba-1.5-large-398b": {"k", "v", "conv", "h"},
            "xlstm-125m": set(), "llama-3.2-vision-90b": {"k", "v"}}[arch]
    assert split == want, split


@pytest.mark.parametrize("window,S0", [(0, 5), (0, 12), (8, 12), (8, 5)])
def test_prefill_writes_each_ranks_slots(window, S0):
    """``LM._fill_cache`` on each rank of a ``model`` 4 mesh record: the
    shards, put together, are the whole cache's prefill write (the ring
    rolled whole, then cut)."""
    cache_len = window or 16
    k, v = torch.from_numpy(rand((2, S0, 3, 4), 5)), \
        torch.from_numpy(rand((2, S0, 3, 4), 6))

    def fill():
        off, n = sh.model_slice(cache_len)
        cache = {"k": torch.zeros(2, n, 3, 4), "v": torch.zeros(2, n, 3, 4)}
        build_model(reduced(get_config("granite-3-2b")))._fill_cache(
            cache, k, v, window, cache_len)
        return cache

    with sh.use_mesh(None):
        want = fill()
    shards = []
    for r in range(4):
        with sh.use_mesh(rank_mesh((1, 4), ("data", "model"), r)):
            shards.append(fill())
    for name in ("k", "v"):
        assert torch.equal(torch.cat([s[name] for s in shards], 1),
                           want[name])


def test_build_keeps_each_leafs_share():
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    _, whole = serve.build(cfg, "cpu", seed=3)
    for r in range(2):
        with sh.use_mesh(rank_mesh((1, 2), ("data", "model"), r)):
            model, mine = serve.build(cfg, "cpu", seed=3, shard=True)
            want = sp.shard_params(whole, model.logical_specs)
        mine, want = flat_dict(mine), flat_dict(want)
        assert mine.keys() == want.keys()
        assert all(torch.equal(mine[k], want[k]) for k in want)
        # each share owns its storage: no view keeps a whole leaf alive
        # (the experts' cut of a [1, E, D, F] leaf is contiguous as it is)
        assert all(v.is_contiguous() and v.untyped_storage().nbytes()
                   == v.numel() * v.element_size() for v in mine.values())
        assert any(mine[k].shape != flat_dict(whole)[k].shape for k in want)
