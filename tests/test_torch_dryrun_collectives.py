"""The dry run's collective accounting (``launch/dryrun.py``'s
``collective_bytes``), counted from the port's own collectives
(``sharding.count_collectives``) on ``meta`` tensors under a dry mesh
(``launch.mesh.dry_mesh``):

* the cross-pod rule (``sharding.crosses_pods`` of a group's members)
  equals the reference's ``crosses_pods`` of the same group written as
  HLO text, in both of its forms, for every set of axes of both
  production meshes;
* the bytes convention, on a hand-reckoned layer: a weight gathered over
  ``data`` counts the gathered tensor, its backward's reduction the
  tensor it sums, a collective under ``vmap`` the batched tensor, and a
  group over ``pod`` counts again under ``<kind>/cross_pod``;
* every rank of a dry (2, 2, 2) mesh counts what rank 0 counts;
* a count scaled from one and two layer groups equals the count at three;
* every kernel wrapper on ``meta`` gives its plain version's shape and
  dtype, and ``launches.on_cpu`` still raises on any device but the CPU,
  ``meta`` and CUDA; the commit's draws on ``meta`` leave the generator
  as it was; a dry group refuses a tensor that is not on ``meta``;
* live equals dry: four ``gloo`` ranks on the CPU (``pod`` 1 x ``data``
  2 x ``model`` 2), spawned once for the file, each record the bytes of
  the reduced granite's and the reduced Jamba's rounds (the dry run's own
  round: q8, FedProx 0.01, bfloat16 accumulation; parallel with two
  clients a rank, sequential), a prefill and a decode step, and each
  equals the dry count of its own rank, exactly; so does each run's
  memory analysis (``launch.memory.count_memory`` over the live step:
  argument, output, temp and alias bytes) against the dry run's
  ``count_memory`` of its rank.  That holds where no ``models/common.py``
  ``lane_exact`` branch is taken (two clients a rank train as two lanes
  here as on the card): that branch is the CPU's own form, and ``meta``
  follows the card's.  The tokens are int32, the dry run's (the
  reference's) input dtype.

The JAX package is imported inside the reference fixture, not at the
top: the spawned ranks import this module, and need only the port."""
import importlib
import itertools
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.core import build_fl_round_step
from repro_torch.core.compression import quantize_dequant
from repro_torch.kernels import launches
from repro_torch.kernels.fedprox_update import fedprox_update_flat
from repro_torch.kernels.fused_accum import fused_accum_blocks
from repro_torch.kernels.fused_quant_mask import (plain_commit_blocks,
                                                  secure_commit_blocks)
from repro_torch.kernels.quantize import quantize_dequant_blocks
from repro_torch.kernels.selective_scan import (
    selective_scan_chunk_blocks, selective_scan_chunk_bwd_blocks)
from repro_torch.kernels.topk_sparsify import topk_sparsify_blocks
from repro_torch.launch import dryrun, serve, spmd
from repro_torch.launch.memory import count_memory
from repro_torch.launch.mesh import dry_mesh, make_production_mesh
from repro_torch.models import build_model, token_shape
from repro_torch.models import sharding as sh
from repro_torch.models.transformer import block_pattern
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict

AXES = ("pod", "data", "model")
SIZES = (1, 2, 2)
ARCHS = ("granite-3-2b", "jamba-1.5-large-398b")
MODES = ("parallel", "sequential")
C, S, B = 4, 16, 2               # clients (two a data rank), tokens, batch
TRAIN = InputShape("tiny_train", S, C * B, "train")
SERVE = {"prefill": InputShape("tiny_prefill", S, 4, "prefill"),
         "decode": InputShape("tiny_decode", S, 4, "decode")}


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module (its import sets XLA_FLAGS for a
    process whose JAX is not yet initialised; the flag is put back)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def spans(mesh):
    live = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    return [s for n in range(1, len(live) + 1)
            for s in itertools.combinations(live, n)]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cross_pod_rule_matches_reference(jdryrun, multi_pod):
    record = make_production_mesh(multi_pod=multi_pod)
    for span in spans(record):
        ours = set()
        for rank in range(record.size):
            mesh = dry_mesh(record.sizes, record.axis_names, rank)
            members = sh.group_members(mesh, span)
            assert len(members) == math.prod(mesh.shape[a] for a in span)
            ours.add(sh.crosses_pods(members, sh.pod_stride(mesh)))
            if rank == 0:
                listed = (f"%ar = f32[8] all-reduce(%x), replica_groups="
                          f"{{{{{','.join(map(str, members))}}}}}")
                assert sh.crosses_pods(members) == jdryrun.crosses_pods(
                    listed, 256), span
        # the iota form: every group over `span` at once
        rest = [a for a in record.axis_names if a not in span]
        perm = [record.axis_names.index(a) for a in rest + list(span)]
        size = math.prod(record.shape[a] for a in span)
        iota = (f"%ar = f32[8] all-reduce(%x), replica_groups="
                f"[{record.size // size},{size}]<="
                f"[{','.join(map(str, record.sizes))}]"
                f"T({','.join(map(str, perm))})")
        assert ours == {jdryrun.crosses_pods(iota, 256)}, span
        assert ours == {multi_pod and "pod" in span}, span


def test_bytes_convention_on_a_hand_reckoned_layer():
    """A [D, F] weight held [D/2, F/2] over data 2 x model 2: gathered over
    data for [T, D] inputs (D * F/2 * 4 bytes of all-gather), its
    gradient summed over data in the backward (the same bytes of
    all-reduce), the layer's output summed over model (T * F/2 * 4); three
    clients' weights gathered under vmap move three times the tensor."""
    D, F, T = 8, 12, 5
    mesh = dry_mesh((1, 2, 2), AXES, 3)
    w = torch.empty((D // 2, F // 2), device="meta", requires_grad=True)
    x = torch.empty((T, D), device="meta")
    f32 = 4
    with sh.use_mesh(mesh):
        with sh.count_collectives() as fwd:
            y = x @ sh.gather_from_data(w, 0)
            y = sh.reduce_from_model(y)
        assert fwd == {"all-gather": D * F // 2 * f32,
                       "all-reduce": T * F // 2 * f32}
        with sh.count_collectives() as bwd:
            y.sum().backward()
        assert bwd == {"all-reduce": D * F // 2 * f32}
        assert w.grad.shape == w.shape
        with sh.count_collectives() as batched:
            torch.func.vmap(lambda v: sh.gather_from_data(v, 0).sum())(
                torch.empty((3, D // 2, F // 2), device="meta"))
        assert batched == {"all-gather": 3 * D * F // 2 * f32}
    with sh.use_mesh(dry_mesh((2, 2, 2), AXES, 5)), \
            sh.count_collectives() as pods:
        sh.psum(torch.empty(7, device="meta"), "pod")
        sh.psum(torch.empty(7, device="meta"), "data")
        sh.all_gather(torch.empty(3, device="meta"), ("pod", "model"))
        sh.all_to_all(torch.empty(4, 2, device="meta"), "model", 0, 1)
    assert pods == {"all-reduce": 56, "all-reduce/cross_pod": 28,
                    "all-gather": 48, "all-gather/cross_pod": 48,
                    "all-to-all": 32}


def test_every_rank_counts_what_rank_zero_counts():
    cfg = reduced(get_config("granite-3-2b"))
    plan = dict(clients=8, local_steps=1, client_exec="parallel",
                hierarchical=True)
    cases = [(TRAIN, plan), (SERVE["prefill"], None),
             (SERVE["decode"], None)]
    first = [dryrun.count_collectives(cfg, shape, dry_mesh(
        (2, 2, 2), AXES, 0), p) for shape, p in cases]
    assert all(any(k.endswith("/cross_pod") for k in c) for c in first[:1])
    for rank in range(1, 8):
        assert [dryrun.count_collectives(cfg, shape, dry_mesh(
            (2, 2, 2), AXES, rank), p) for shape, p in cases] == first, rank


@pytest.mark.parametrize("arch,mode,sizes,dtype", [
    ("granite-3-2b", "parallel", (2, 2, 2), "bfloat16"),
    ("jamba-1.5-large-398b", "parallel", (1, 2, 2), "float32"),
    ("jamba-1.5-large-398b", "pod_sequential", (2, 2, 2), "float32")])
def test_depth_scaling_is_exact(arch, mode, sizes, dtype):
    """The count at three layer groups, scaled from one and two (the
    clients' training) and counted whole (the commit, whose rows are
    padded to a multiple of the ranks that split them: scaled whole, these
    cases would be off by the padding), equals the count at three."""
    base = reduced(get_config(arch)).replace(dtype=dtype)
    cfg = base.replace(n_layers=3 * len(block_pattern(base)))
    mesh = dry_mesh(sizes, AXES, 0)
    plan = dict(clients=8, local_steps=1, client_exec=mode,
                hierarchical=sizes[0] > 1 and mode == "parallel")
    shape = InputShape("tiny_train", 32, 16, "train")
    assert dryrun.count_collectives(cfg, shape, mesh, plan) == dict(
        dryrun._train_collectives(cfg, shape, mesh, plan))
    for kind in ("prefill", "decode"):
        assert dryrun.count_collectives(cfg, SERVE[kind], mesh) == dict(
            dryrun._serve_collectives(cfg, SERVE[kind], mesh))


def kernel_cases(device):
    """Each kernel wrapper's call on small operands on ``device``."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.rand(shape, generator=g).to(device)
    K, R, blk, N = 3, 4, 16, 24
    seeds = torch.randint(0, 2 ** 32, (K, K), generator=g).to(device)
    coef = torch.randint(-1, 2, (K, K), generator=g,
                         dtype=torch.int32).to(device)
    a, b, h0 = rnd(2, 5, 3, 4), rnd(2, 5, 3, 4), rnd(2, 3, 4)
    return {
        "quantize": lambda: quantize_dequant_blocks(rnd(R, blk), 8),
        "topk_sparsify": lambda: topk_sparsify_blocks(rnd(R, blk), 3),
        "fused_accum": lambda: fused_accum_blocks(rnd(K, R, blk), rnd(K),
                                                  rnd(K), 0.5),
        "plain_commit": lambda: plain_commit_blocks(
            rnd(K, R, blk), rnd(K), rnd(K), 0.5, bits=8, k=3),
        "secure_commit": lambda: secure_commit_blocks(
            rnd(K, R, blk), rnd(K), seeds, coef, 7, bits=8, k=3,
            noise=rnd(K, R, blk),
            rows=torch.arange(R, dtype=torch.int64).to(device)),
        "fedprox_update": lambda: fedprox_update_flat(
            rnd(K, N), rnd(K, N), rnd(N), 0.1, 0.01),
        "selective_scan": lambda: selective_scan_chunk_blocks(a, b, h0),
        "selective_scan_bwd": lambda: selective_scan_chunk_bwd_blocks(
            a, rnd(2, 5, 3, 4), h0, rnd(2, 5, 3, 4), rnd(2, 3, 4)),
    }


def shapes_of(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("name", list(kernel_cases("cpu")))
def test_kernel_wrappers_take_their_plain_version_on_meta(name):
    before = dict(launches.KERNEL_LAUNCHES)
    got = kernel_cases("meta")[name]()
    assert all(t.is_meta for t in (got if isinstance(got, tuple)
                                   else (got,)))
    assert shapes_of(got) == shapes_of(kernel_cases("cpu")[name]())
    assert dict(launches.KERNEL_LAUNCHES) == before


def test_on_cpu_device_rules():
    meta, cpu = torch.empty(2, device="meta"), torch.empty(2)
    assert launches.on_cpu(meta, meta) and launches.on_cpu(cpu)
    assert launches.on_cpu(SimpleNamespace(
        device=torch.device("cuda", 0))) is False
    for operands in ((meta, cpu), (SimpleNamespace(
            device=torch.device("mps")),)):
        with pytest.raises(ValueError):
            launches.on_cpu(*operands)


def test_meta_draws_leave_the_generator_alone():
    g = torch.Generator().manual_seed(4)
    state = g.get_state()
    x = torch.empty((3, 40), dtype=torch.bfloat16, device="meta")
    y = quantize_dequant(x, 8, block=16, generator=g, cut=((0, 1, 2),))
    assert y.is_meta and y.shape == x.shape and y.dtype == x.dtype
    assert torch.equal(g.get_state(), state)


def test_dry_group_refuses_real_tensors():
    with sh.use_mesh(dry_mesh(SIZES, AXES, 1)):
        for op in (lambda t: sh.psum(t, "data"),
                   lambda t: sh.all_gather(t, "model"),
                   lambda t: sh.all_to_all(t, ("data", "model"), 0, 0)):
            with pytest.raises(RuntimeError, match="meta"):
                op(torch.ones(4))
            assert op(torch.empty(4, device="meta")).is_meta


# ---------------------------------------------------------------------------
# live equals dry, on four gloo ranks
# ---------------------------------------------------------------------------

def plan_of(mode):
    return dict(clients=C, local_steps=1, client_exec=mode,
                hierarchical=False)


def tokens(cfg, seed, *lead):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, token_shape(cfg, *lead))).to(torch.int32)


def live_round(cfg, mode, mesh):
    """The dry run's round (``dryrun.fl_config``) on this rank's shares:
    its collective bytes and its memory analysis."""
    model = build_model(cfg)
    _, params = serve.build(cfg, "cpu", seed=0, shard=True)
    toks = tokens(cfg, 5, C, 1, B, S + 1)
    step = build_fl_round_step(
        model.loss_fn, get_client_optimizer("sgd"),
        get_server_optimizer("fedavg"), dryrun.fl_config(plan_of(mode)),
        client_spmd_axes=dryrun.client_axes(mode, mesh))
    args = (flat_dict(params), (), {"tokens": toks[..., :-1],
                                    "targets": toks[..., 1:]},
            torch.ones(C), torch.ones(C))
    with sh.count_collectives() as counts, count_memory("cpu") as mem:
        out = step(*args, torch.Generator().manual_seed(3))
    return dict(counts), mem.analysis(args, out)


def live_serve(cfg, kind):
    """One prefill of the rank's rows (a cache of the prompt's length), or
    one decode step at the cache's last position: its collective bytes
    and its memory analysis."""
    shape = SERVE[kind]
    model, params = serve.build(cfg, "cpu", seed=0, shard=True)
    n = sh.shard_count(sh.batch_split_axes())
    toks = sh.local_share(tokens(cfg, 6, shape.global_batch, S),
                          sh.batch_split_axes())
    with torch.inference_mode():
        if kind == "prefill":
            args = (params, {"tokens": toks})
        else:
            args = (params, model.init_decode_state(
                shape.global_batch // n, S), toks[:, 0])
        with sh.count_collectives() as counts, count_memory("cpu") as mem:
            if kind == "prefill":
                out = model.prefill(*args, S)
            else:
                out = model.decode_step(*args, S - 1)
    return dict(counts), mem.analysis(args, out)


def rank_counts(mesh):
    """Each case's ((live bytes, live memory), (this rank's dry count
    of both, ``dryrun.count_step``))."""
    torch.use_deterministic_algorithms(True)
    out = {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        for mode in MODES:
            out[(arch, mode)] = (live_round(cfg, mode, mesh),
                                 dryrun.count_step(cfg, TRAIN, mesh,
                                                   plan_of(mode)))
        for kind in SERVE:
            out[(arch, kind)] = (live_serve(cfg, kind),
                                 dryrun.count_step(cfg, SERVE[kind], mesh))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spmd.run(rank_counts, sizes=SIZES, device="cpu",
                    init_method=spmd.init_file(
                        tmp_path_factory.mktemp("dry_collectives")),
                    all_ranks=True, verbose=False)


@pytest.mark.parametrize("case", [(a, m) for a in ARCHS
                                  for m in MODES + tuple(SERVE)],
                         ids=lambda c: "-".join(c))
def test_live_bytes_equal_the_dry_count(ranks, case):
    for rank, out in enumerate(ranks):
        (live, _), (dry, _) = out[case]
        assert live and live == dry, (rank, live, dry)


@pytest.mark.parametrize("case", [(a, m) for a in ARCHS
                                  for m in MODES + tuple(SERVE)],
                         ids=lambda c: "-".join(c))
def test_live_memory_equals_the_dry_count(ranks, case):
    for rank, out in enumerate(ranks):
        (_, live), (_, dry) = out[case]
        assert live["peak_size_in_bytes"] > 0
        assert live == dry, (rank, live, dry)
