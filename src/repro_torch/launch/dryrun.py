"""Dry run of every assigned arch and input shape on the production meshes,
mirroring ``repro/launch/dryrun.py``, with nothing allocated: the params,
inputs and decode states are ``meta`` tensors.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

For each tag (``<arch>__<shape>__<single|multi>``) it writes
``<out>/<tag>.json`` and prints one line.  The keys are the reference's
where they have a counterpart:

* ``skipped``: ``should_skip``, the reference's rule;
* ``n_devices``: the production mesh's size (16x16, or 2x16x16 multi-pod);
* ``clients``, ``local_steps``, ``client_exec``, ``hierarchical`` for a
  train shape, chosen as the reference's ``build_train`` chooses them;
* ``bytes_per_device``: the params, the inputs and (decode) the decode
  state on one device under the sanitised specs (``launch/specs.py``),
  each leaf's bytes over the mesh extent of its spec: the counterpart of
  ``memory_analysis``' argument and output sizes;
* ``cost_analysis.flops``: ``torch.utils.flop_counter.FlopCounterMode``
  over one step on ``meta`` tensors: a train shape's client step (loss and
  backward, the remat recompute included) times clients x local steps, a
  prefill, one decode step.  The counter counts matrix products and
  attention, not elementwise work.  Layer groups are identical, so the
  model is counted at one and at two groups and the difference scaled to
  the config's depth (``--groups`` sets the depth, as in the reference).
  The xLSTM family's sLSTM is a Python loop over time, one step per token,
  which is slow on meta tensors: its count is linear in the sequence (no
  attention; the mLSTM is quadratic only within its fixed chunk), so it is
  counted at one and at two mLSTM chunks and the difference scaled to the
  sequence.  A long prefill is counted at one to four PREFILL_UNITs of
  its prompt and extrapolated on their quadratic (the products linear in
  the prompt, attention's chunk pairs quadratic) where the fourth lies on
  it, else at the whole prompt;
* ``collective_bytes``: ``{kind: bytes}``, the bytes one device's
  collectives move in one step, under the reference's kinds
  (``COLLECTIVE_OPS``: ``all-reduce``, ``all-gather``, ``all-to-all``;
  the port runs no other), each the op's output bytes on the device
  (the gathered tensor of a gather), with ``<kind>/cross_pod`` for the
  ops whose group spans the pod boundary (the reference's
  ``crosses_pods``, a pod of 256 devices), as the reference's
  ``collective_bytes`` counts them from the HLO.  Here they are the
  port's own collectives, counted as they run (``sharding.
  count_collectives``): the step of device 0 on its ``meta`` shares of
  the params (``specs.shard_params``), of the batch and of the decode
  state, under a dry mesh of the production mesh's shape
  (``launch.mesh.dry_mesh``), whose groups move nothing.  The train step
  is the round that the reference's ``build_train`` builds (q8
  compression, FedProx 0.01, bfloat16 accumulation, the plan's client
  mode, hierarchical where parallel spans pods) with its commit;
  ``count_collectives`` counts any ``(cfg, shape, mesh, plan)``.  The
  clients' training is counted at one and two layer groups (and the
  xLSTM's mLSTM chunks) and scaled, as the flops are; the commit, whose
  rows are padded to a multiple of the ranks that split them, at the
  whole depth.  ``serve_collectives`` counts ``launch/serve.py::run``
  (prefill, decode steps, the logits' gathers) at the whole depth.  Live
  ranks count the same calls, so a live rank's bytes by kind equal its
  dry count exactly (the tests on ``gloo`` CPU ranks; ``chip_smoke.py``'s
  ``spmd`` (g) and (h) on the card).

* ``memory_analysis``: the reference's ``argument_size_in_bytes``,
  ``output_size_in_bytes``, ``temp_size_in_bytes`` and
  ``alias_size_in_bytes`` of the same step on the same rank, with
  ``peak_size_in_bytes`` (temp plus the outputs the step allocated),
  counted from the port's own allocations on ``meta`` (``launch.memory``:
  each new storage charged at the CUDA caching allocator's rounding while
  it lives; a kernel wrapper charges what its CUDA branch allocates).
  Argument and output bytes are additive; a peak is not, so a prefill or
  decode step is scaled from one and two layer groups only where the count
  at three lies on their line to the byte (else from two and three where
  four does), else counted at the whole depth (the xLSTM's over its
  mLSTM chunks likewise), and a round's local training and commit are
  counted apart: the commit at the whole depth (its packing
  makes an f32 copy of every slot), the training's peak scaled as a
  prefill's is, the round's temp the larger phase's.  ``count_memory``
  and ``serve_memory`` count any configuration, as ``count_collectives``
  and ``serve_collectives`` do;
  live ranks that count the same calls (``launch.memory.count_memory``)
  equal them exactly (the tests on ``gloo`` CPU ranks; ``chip_smoke.py``'s
  ``spmd`` (g) and (h) on the card, which also hold the card allocator's
  peak to ``peak_size_in_bytes``).

The reference also counts its collective ops in the HLO text
(``collective_ops_static``) and writes ``generated_code_size_in_bytes``;
the port's collectives are calls that run and its kernels are libraries
built at first use, with no static step program to count or size, so
both are written as absent, with the reason (``memory_analysis``'
``note``), not as 0.  As the reference's CLI does, a tag that fails
writes ``{"arch", "shape", "mesh", "tag", "error"}`` and the grid goes
on; ``run_one`` and the count functions raise.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.core import CompressionConfig, FLConfig, build_fl_round_step
from repro_torch.core.round import ParallelRound
from repro_torch.launch import serve
from repro_torch.launch import specs as sp
from repro_torch.launch.memory import count_memory as mem_count
from repro_torch.launch.mesh import dry_mesh, make_production_mesh
from repro_torch.models import build_model, sharding as sh, token_shape
from repro_torch.models.transformer import block_pattern
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict

# Archs small enough to host parallel client replicas (true hierarchical
# FL); the rest time-multiplex clients sequentially, as in the reference.
PARALLEL_ARCHS = {"xlstm-125m", "gemma-2b", "granite-3-2b", "musicgen-medium",
                  "starcoder2-7b"}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
NO_STATIC_OPS = ("not counted: the reference counts the collective ops in "
                 "the HLO text; the port runs its collectives, so each call "
                 "is counted as it runs (collective_bytes), and there is no "
                 "static program to count them in")
NO_CODE_SIZE = ("generated_code_size_in_bytes not counted: the port runs "
                "its kernels from .so files built on the card at first use, "
                "and there is no compiled step program to measure")


def should_skip(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return ("full-attention arch without sliding-window/SSM variant; "
                "long_500k requires a sub-quadratic decode path "
                "(DESIGN.md long_500k skips)")
    return None


def train_plan(cfg, multi_pod: bool, clients: int, local_steps: int) -> dict:
    """Clients, local steps and client mode of the train shape, as the
    reference's ``build_train`` picks them."""
    parallel = cfg.name in PARALLEL_ARCHS
    C = clients or ((32 if multi_pod else 16) if parallel else 4)
    mode = ("parallel" if parallel else
            "pod_sequential" if multi_pod else "sequential")
    return {"clients": C, "local_steps": local_steps, "client_exec": mode,
            "hierarchical": parallel and multi_pod}


def fl_config(plan: dict) -> FLConfig:
    """The round's ``FLConfig`` for a train plan, as the reference's
    ``build_train`` builds it: q8 compression, FedProx 0.01, bfloat16
    accumulation."""
    return FLConfig(num_clients=plan["clients"],
                    local_steps=plan["local_steps"], client_lr=0.01,
                    fedprox_mu=0.01, aggregation="fedavg",
                    client_exec=plan["client_exec"],
                    compression=CompressionConfig(quantize_bits=8),
                    hierarchical=plan["hierarchical"],
                    accum_dtype="bfloat16")


def client_axes(mode: str, mesh):
    """The mesh axes a round's client (or pod) dim is split over, as the
    reference's ``build_train`` names them."""
    if mode == "parallel":
        return (sh.POD, sh.DATA) if sh.POD in mesh.axis_names else sh.DATA
    return sh.POD if mode == "pod_sequential" else None


def _extent(spec, mesh) -> int:
    n = 1
    for e in spec:
        if e is not None:
            n *= math.prod(mesh.shape[a] for a in
                           ((e,) if isinstance(e, str) else e))
    return n


def per_device_bytes(tree, logical, mesh) -> int:
    """The bytes of ``tree``'s leaves on one device under the sanitised
    specs of their ``logical`` tuples."""
    spec = sp.sanitize_specs(tree, logical, mesh)

    def walk(t, s):
        if isinstance(t, dict):
            return sum(walk(t[k], s[k]) for k in t)
        return t.numel() * t.element_size() // _extent(s, mesh)
    return walk(tree, spec)


def _inputs(cfg, shape, model, plan):
    """(input tree, its logical tree, decode state or None, its logical)."""
    if shape.kind == "train":
        b, log_par, log_seq = sp.train_client_batch_specs(
            cfg, shape, plan["clients"], plan["local_steps"])
        logical = log_par if plan["client_exec"] == "parallel" else log_seq
        if plan["client_exec"] == "pod_sequential":
            # the client dim over `pod`, each client's batch over `data`
            logical = {k: (sh.POD, None, sh.DATA) + v[3:]
                       for k, v in logical.items()}
        return b, logical, None, None
    if shape.kind == "prefill":
        b, logical = sp.prefill_batch_specs(cfg, shape)
        return b, logical, None, None
    tok, tok_log, state, state_log, patches, patches_log = \
        sp.decode_inputs_specs(cfg, shape, model)
    b, logical = {"token": tok}, {"token": tok_log}
    if patches is not None:
        b["patches"], logical["patches"] = patches, patches_log
    return b, logical, state, state_log


def _step_flops(cfg, shape, C: int, H: int) -> int:
    """FlopCounterMode's count of one step of ``cfg`` on meta tensors."""
    model = build_model(cfg)
    params = model.param_specs()
    counter = FlopCounterMode(display=False)
    if shape.kind == "train":
        batch, _, _ = sp.train_client_batch_specs(cfg, shape, C, H)
        client = {k: v[0, 0] for k, v in batch.items()}     # [b, S, ...]
        leaves = {k: v.requires_grad_() for k, v in flat_dict(params).items()}
        with counter:
            loss, _ = model.loss_fn(leaves, client)
            loss.backward()
        return counter.get_total_flops() * C * H
    with counter, torch.no_grad():
        if shape.kind == "prefill":
            batch, _ = sp.prefill_batch_specs(cfg, shape)
            model.prefill(params, batch, s_max=shape.seq_len)
        else:
            tok, _, state, _, patches, _ = sp.decode_inputs_specs(
                cfg, shape, model)
            model.decode_step(params, state, tok, shape.seq_len - 1,
                              patches)
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def step_flops(cfg, shape, clients: int = 0, local_steps: int = 0) -> int:
    """One step's flops at ``cfg``'s depth and ``shape``'s sequence; a
    train shape's step is ``clients`` x ``local_steps`` client steps.
    Cached: the count does not depend on the mesh.  A long prefill
    (``_prefill_unit``: PREFILL_UNIT) is counted at 1 to 4 units and its
    quadratic in the units (the products linear in the prompt, attention's
    chunk pairs quadratic) extrapolated where the fourth lies on it, else
    counted at its whole length."""
    def at(s):
        return _scaled(lambda c, s: Counter(flops=_step_flops(
            c, s, clients, local_steps)), cfg, s)["flops"]
    U = _prefill_unit(cfg, shape)
    if not U:
        return at(shape)
    f = [at(dataclasses.replace(shape, seq_len=k * U)) for k in (1, 2, 3, 4)]
    if f[3] - 3 * f[2] + 3 * f[1] - f[0]:
        return at(shape)
    n = shape.seq_len // U
    return (f[0] + (n - 1) * (f[1] - f[0])
            + (n - 1) * (n - 2) // 2 * (f[2] - 2 * f[1] + f[0]))


def depth_flops(cfg, shape, clients: int, local_steps: int) -> int:
    """One step's count at ``cfg``'s depth, from the counts at one and at
    two layer groups (the groups are identical)."""
    period = len(block_pattern(cfg))
    f1, f2 = (_step_flops(cfg.replace(n_layers=g * period), shape, clients,
                          local_steps) for g in (1, 2))
    return f1 + (cfg.n_layers // period - 1) * (f2 - f1)


def _dry(mesh):
    """``mesh`` as a dry mesh of its rank (rank 0 of a record)."""
    return dry_mesh(mesh.sizes, mesh.axis_names, mesh.rank or 0)


def _train_pass(cfg, shape, mesh, plan, fl=None, n_pods=None,
                client_spmd_axes=None, commit_only=False,
                memory: bool = False) -> tuple:
    """One round step of ``plan`` on the rank of the dry ``mesh``: its
    shares of the params and the whole batches, on ``meta``.  ``fl``,
    ``n_pods`` and ``client_spmd_axes`` default to the reference's
    ``build_train``'s.  ``commit_only``: the clients' local training
    (with the parallel round's gather of the params over ``data``) is left
    out, its deltas and losses taken as ``meta`` tensors of their shapes.
    Returns (the collective bytes, with ``memory`` the step's memory
    analysis and under ``"train"`` the peak live bytes while a client
    trains, else None)."""
    model = build_model(cfg)
    fl = fl or fl_config(plan)
    n_pods = n_pods or mesh.shape.get(sh.POD, 1)
    if client_spmd_axes is None:
        client_spmd_axes = client_axes(fl.client_exec, mesh)
    C = fl.num_clients
    batches, _, _ = sp.train_client_batch_specs(cfg, shape, C,
                                                fl.local_steps)
    vec = sp.meta((C,), torch.float32)
    with sh.use_mesh(mesh):
        params = flat_dict(sp.shard_params(model.param_specs(),
                                           model.logical_specs))
        step = build_fl_round_step(
            model.loss_fn, get_client_optimizer("sgd"),
            get_server_optimizer("fedavg"), fl, n_pods=n_pods,
            client_spmd_axes=client_spmd_axes)
        if commit_only:
            _untrained(step)
        args = (params, (), batches, vec, vec)
        with sh.count_collectives() as counts, _opened(memory) as mem:
            train = _watch_training(step, mem)
            out = step(*args, torch.Generator())
    if not memory:
        return counts, None
    return counts, dict(mem.analysis(args, out), train=train.peak)


def _train_collectives(cfg, shape, mesh, plan, **round_args) -> Counter:
    """The collective bytes of ``_train_pass``."""
    return _train_pass(cfg, shape, mesh, plan, **round_args)[0]


def _serve_collectives(cfg, shape, mesh) -> Counter:
    """The collective bytes of ``_serve_pass``."""
    return _serve_pass(cfg, shape, mesh)[0]


def _opened(memory: bool):
    """A memory count of ``meta`` allocations, or none."""
    return mem_count("meta") if memory else contextlib.nullcontext()


def _watch_training(step, count):
    """``step``'s local training (the parallel round's ``train_clients``,
    the sequential rounds' ``local_train`` of each client) watched by the
    memory ``count``: returns an object whose ``peak`` is the most bytes
    live at once while any client trains (0 without a count)."""
    watched = SimpleNamespace(peak=0)
    if count is None:
        return watched
    name = "train_clients" if isinstance(step, ParallelRound) else \
        "local_train"
    inner = getattr(step, name)

    def train(*args):
        with count.window() as w:
            out = inner(*args)
        watched.peak = max(watched.peak, w.peak)
        return out
    setattr(step, name, train)
    return watched


def _untrained(step) -> None:
    """``step`` with its local training replaced by ``meta`` deltas and
    losses of the shapes and dtypes the training gives: each client's
    delta is its params' (the parallel round's whole over the ``data``
    its client dim owns), its loss a float32 scalar, each made afresh by
    every call, as the training makes them (a memory count holds them)."""
    if not isinstance(step, ParallelRound):
        step.local_train = lambda params, batches: (
            {k: torch.empty_like(p) for k, p in params.items()},
            torch.empty((), device="meta"))
        return
    data = sh.DATA in step.owned()
    cuts = step.layout()

    def train_clients(params, batches):
        C = next(iter(batches.values())).shape[0]
        n = sh.shard_count(sh.DATA)
        whole = {k: sh.whole_shape(p.shape, ((cuts[k][sh.DATA], 0, n),))
                 if data and sh.DATA in cuts.get(k, {}) else p.shape
                 for k, p in params.items()}
        return ({k: sp.meta((C,) + tuple(whole[k]), p.dtype)
                 for k, p in params.items()},
                sp.meta((C,), torch.float32))
    step.train_clients = train_clients


def _serve_pass(cfg, shape, mesh, memory: bool = False) -> tuple:
    """One prefill (``shape``'s prompt into a cache of its length) or one
    decode step (at the cache's last position) on the rank of the dry
    ``mesh``: its shares of the params, of the batch (whole where the batch
    axes do not divide it, as ``sanitize_specs`` leaves it) and of the
    decode state, as ``launch/serve.py::run`` holds them.  Returns (the
    collective bytes, with ``memory`` the step's memory analysis, else
    None)."""
    model = build_model(cfg)
    inputs = _inputs(cfg, shape, model, {})[0]
    with sh.use_mesh(mesh), torch.inference_mode():
        params = sp.shard_params(model.param_specs(), model.logical_specs)
        n = sh.shard_count(sh.batch_split_axes())
        B = shape.global_batch // n if shape.global_batch % n == 0 \
            else shape.global_batch
        mine = {k: v[:B] for k, v in inputs.items()}
        state = None if shape.kind == "prefill" else \
            model.init_decode_state(B, shape.seq_len, device="meta")
        with sh.count_collectives() as counts, _opened(memory) as mem:
            if shape.kind == "prefill":
                out = model.prefill(params, mine, s_max=shape.seq_len)
            else:
                out = model.decode_step(params, state, mine["token"],
                                        shape.seq_len - 1,
                                        mine.get("patches"))
    return counts, (mem.analysis((params, state, mine), out) if memory
                    else None)


def _chunked(cfg, shape) -> int:
    """The xLSTM family's mLSTM chunk where ``shape``'s sequence is more
    than two of them (counted at one and two, then scaled), else 0."""
    L = cfg.xlstm.chunk if cfg.xlstm is not None else 0
    if not L or shape.kind == "decode" or shape.seq_len <= 2 * L:
        return 0
    if shape.seq_len % L:
        raise ValueError(f"{cfg.name}: a sequence of {shape.seq_len} is "
                         f"not whole mLSTM chunks of {L}")
    return L


def _scaled(count, cfg, shape) -> Counter:
    """``count(cfg, shape)`` (a Counter linear in the layer groups and,
    for the xLSTM family, in the mLSTM chunks) at ``cfg``'s depth and
    ``shape``'s sequence, from the counts at one and at two groups (the
    groups are identical), each at one and at two chunks where the
    sequence is longer, as ``step_flops`` counts; counted as it is where
    it has two groups or fewer and no more than two chunks."""
    L = _chunked(cfg, shape)
    if L:
        return _scale(*(_scaled(count, cfg, dataclasses.replace(
            shape, seq_len=s)) for s in (L, 2 * L)), shape.seq_len // L)
    period = len(block_pattern(cfg))
    if cfg.n_layers <= 2 * period:
        return count(cfg, shape)
    return _scale(*(count(cfg.replace(n_layers=g * period), shape)
                    for g in (1, 2)), cfg.n_layers // period)


def _scale(c1: Counter, c2: Counter, n: int) -> Counter:
    """The count at ``n`` from those at 1 and 2 of a count linear in
    ``n``."""
    out = Counter({k: c1[k] + (n - 1) * (c2[k] - c1[k])
                   for k in set(c1) | set(c2)})
    return +out


# A long prefill's flops are counted at 1 to 4 of these tokens (each past
# attention's full-scores threshold, 2048, so chunked as at the whole
# length) and extrapolated on their quadratic.  Its memory is not: a peak
# is the larger of terms that grow with the prompt at different rates
# (MusicGen-medium's prefill_32k peaks 214 MB above the line through
# 4096-16384 tokens), so it is counted at the whole prompt
PREFILL_UNIT = 4096


def _prefill_unit(cfg, shape) -> int:
    """PREFILL_UNIT for a prefill longer than four of them (the xLSTM's
    aside, which is counted over its mLSTM chunks), else 0."""
    if shape.kind != "prefill" or _chunked(cfg, shape) \
            or shape.seq_len % PREFILL_UNIT:
        return 0
    return PREFILL_UNIT if shape.seq_len > 4 * PREFILL_UNIT else 0


def _checked(count, cfg, shape) -> dict:
    """``count(cfg, shape)`` (a dict of ints, such as a peak, that need
    not be linear) at ``cfg``'s depth and ``shape``'s sequence: scaled
    from the counts at one and at two layer groups only where the count at
    three equals the extrapolation to the byte in every entry, or from two
    and three where four does (``_linear``), else counted at the whole
    depth; counted as it is at three groups or fewer.  The xLSTM family's
    mLSTM chunks the same way (``_chunked``; its sLSTM steps one token at
    a time, too slow on ``meta`` at the whole sequence): the chunks checked
    at one group, then the groups at the two chunk counts the line starts
    from and the result scaled to the sequence, else counted at the whole
    sequence."""
    L = _chunked(cfg, shape)
    if not L or shape.seq_len <= 3 * L:
        return _groups_checked(count, cfg, shape)
    n = shape.seq_len // L
    one = cfg.replace(n_layers=len(block_pattern(cfg)))
    line = _line(lambda k: count(one, dataclasses.replace(
        shape, seq_len=k * L)), n)
    if line is None:
        return _groups_checked(count, cfg, shape)
    k = line[0]
    return _extended((k,) + tuple(_groups_checked(
        count, cfg, dataclasses.replace(shape, seq_len=u * L))
        for u in (k, k + 1)), n)


def _groups_checked(count, cfg, shape) -> dict:
    period = len(block_pattern(cfg))
    return _linear(lambda g: count(cfg.replace(n_layers=g * period), shape),
                   cfg.n_layers // period)


def _line(at, n: int):
    """(g, at(g), at(g + 1)) for g = 1 where ``at(1)``, ``at(2)`` and
    ``at(3)`` lie on a line in every entry; else (the first group's or
    unit's peak may lie elsewhere than the later ones') for g = 2 where
    ``at(2)``, ``at(3)`` and ``at(4)`` do; else None (also where the line
    would reach ``n`` itself)."""
    for g in (1, 2):
        if g + 2 >= n:
            return None
        v = [at(g + i) for i in range(3)]
        if all(v[2][e] - v[1][e] == v[1][e] - v[0][e] for e in v[0]):
            return g, v[0], v[1]
    return None


def _extended(line, n: int) -> dict:
    """The value at ``n`` on ``_line``'s line."""
    g, v0, v1 = line
    return {e: v0[e] + (n - g) * (v1[e] - v0[e]) for e in v0}


def _linear(at, n: int) -> dict:
    """``at(n)``, extrapolated on the line ``_line`` finds, else
    counted."""
    line = _line(at, n)
    return at(n) if line is None else _extended(line, n)


def _round_memory(commit: dict, train_peak: int) -> dict:
    """A round's memory analysis from its commit counted at the whole
    depth (with the training's deltas and losses as ``meta`` tensors of
    their shapes, which are all that the training leaves live) and the
    peak while a client trains: the round's peak is the larger of the
    two, its outputs are the commit's."""
    allocated = commit["peak_size_in_bytes"] - commit["temp_size_in_bytes"]
    peak = max(commit["peak_size_in_bytes"], train_peak)
    return dict(commit, temp_size_in_bytes=peak - allocated,
                peak_size_in_bytes=peak)


def _count(cfg, shape, mesh, plan, round_args, collectives=True,
           memory=True) -> dict:
    """``{"collectives": ..., "memory": ...}`` of one step (the parts
    asked for), both counted from the same passes where they can."""
    mesh = _dry(mesh)
    out = {}
    if shape.kind != "train":
        at = functools.lru_cache(maxsize=None)(
            lambda n, s: _serve_pass(cfg.replace(n_layers=n),
                                     dataclasses.replace(shape, seq_len=s),
                                     mesh, memory))
        if collectives:
            out["collectives"] = _scaled(
                lambda c, s: at(c.n_layers, s.seq_len)[0], cfg, shape)
        if memory:
            out["memory"] = _checked(
                lambda c, s: at(c.n_layers, s.seq_len)[1], cfg, shape)
        return out
    run = functools.lru_cache(maxsize=None)(
        lambda n, s, commit_only: _train_pass(
            cfg.replace(n_layers=n), dataclasses.replace(shape, seq_len=s),
            mesh, plan, commit_only=commit_only, memory=memory,
            **round_args))

    def at(c, s, commit_only=False):
        return run(c.n_layers, s.seq_len, commit_only)

    if not _chunked(cfg, shape) and \
            cfg.n_layers <= 2 * len(block_pattern(cfg)):
        counts, mem = at(cfg, shape)
        out["collectives"], out["memory"] = counts, mem
    else:
        # the clients' training is linear in the depth; the commit is
        # not (its rows are padded to a multiple of the ranks that split
        # them, and its peak need not lie in the same phase at every
        # depth), so it is counted at the whole depth
        commit_counts, commit_mem = at(cfg, shape, True)
        if collectives:
            out["collectives"] = _scaled(
                lambda c, s: at(c, s)[0] - at(c, s, True)[0], cfg,
                shape) + commit_counts
        if memory:
            train = _checked(lambda c, s: {"train": at(c, s)[1]["train"]},
                             cfg, shape)["train"]
            out["memory"] = _round_memory(commit_mem, train)
    if memory:
        out["memory"] = {k: v for k, v in out["memory"].items()
                         if k != "train"}
    return out


def count_collectives(cfg, shape, mesh, plan=None, **round_args) -> dict:
    """``{kind: bytes}``: the collectives one step of ``cfg`` at ``shape``
    moves on one rank of ``mesh`` (rank 0 of a mesh record, or the rank a
    ``dry_mesh`` names), counted from the port's own collectives
    (``sharding.count_collectives``) on the rank's ``meta`` shares under a
    dry mesh of the same shape, with ``<kind>/cross_pod`` where the group
    crosses a pod.  A train shape's step is the round of ``plan``
    (``train_plan``; ``round_args`` may name the round's ``fl``,
    ``n_pods`` and ``client_spmd_axes``, else the reference's
    ``build_train``'s), a prefill shape's one prefill, a decode shape's
    one decode step.  Counted at one and at two layer groups and scaled
    to the depth, and the xLSTM family at one and two mLSTM chunks scaled
    to the sequence, as ``step_flops`` is."""
    return _ints(_count(cfg, shape, mesh, plan, round_args,
                        memory=False)["collectives"])


def count_memory(cfg, shape, mesh, plan=None, **round_args) -> dict:
    """The memory analysis of the step ``count_collectives`` counts, on
    the same rank: the reference's ``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``temp_size_in_bytes`` and
    ``alias_size_in_bytes`` and the step's ``peak_size_in_bytes``
    (``launch.memory``), counted from the port's own allocations on the
    rank's ``meta`` shares.  A prefill or decode step is scaled from one
    and two layer groups (mLSTM chunks) where three lie on their line, else
    counted whole; a round's training and commit are counted apart (the
    commit at the whole depth, the training's peak scaled so) and its
    temp is the larger phase's."""
    return _ints(_count(cfg, shape, mesh, plan, round_args,
                        collectives=False)["memory"])


def count_step(cfg, shape, mesh, plan=None, **round_args) -> tuple:
    """(``count_collectives``, ``count_memory``) of the same step, from the
    same passes."""
    got = _count(cfg, shape, mesh, plan, round_args)
    return _ints(got["collectives"]), _ints(got["memory"])


def _ints(counts) -> dict:
    return {k: int(v) for k, v in sorted(counts.items())}


def serve_collectives(cfg, mesh, batch: int, prompt_len: int, gen: int
                      ) -> dict:
    """``{kind: bytes}`` of ``launch/serve.py::run`` on one rank of
    ``mesh`` (as ``count_collectives``): a prompt of ``batch`` x
    ``prompt_len`` tokens (with the VLM's patches) prefilled, then
    ``gen`` decode steps fed given tokens, each step's logits gathered
    over the batch axes; at ``cfg``'s whole depth."""
    return _serve_run(cfg, mesh, batch, prompt_len, gen, False)[0]


def serve_memory(cfg, mesh, batch: int, prompt_len: int, gen: int) -> dict:
    """The memory analysis (``count_memory``'s keys) of the
    ``serve_collectives`` run on the same rank: its arguments the rank's
    param shares and the whole prompt, given tokens (int64, as
    ``serve.run`` takes them) and patches on the device; its outputs every
    step's logits and the last decode state; at ``cfg``'s whole depth."""
    return _serve_run(cfg, mesh, batch, prompt_len, gen, True)[1]


def _serve_run(cfg, mesh, batch, prompt_len, gen, memory) -> tuple:
    model = build_model(cfg)
    prompt = sp.meta(token_shape(cfg, batch, prompt_len), torch.long)
    forced = sp.meta(token_shape(cfg, batch, gen), torch.long)
    patches = (sp.meta((batch, cfg.n_patches, cfg.d_model), model.dtype)
               if cfg.cross_attn_every else None)
    with sh.use_mesh(_dry(mesh)):
        params = sp.shard_params(model.param_specs(), model.logical_specs)
        with sh.count_collectives() as counts, _opened(memory) as mem:
            res = serve.run(model, params, prompt, gen, 0.0, None, patches,
                            forced=forced)
    return _ints(counts), (_ints(mem.analysis(
        (params, prompt, forced, patches), (res.logits, res.state)))
        if memory else None)


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
            groups: int = 0, clients: int = 0, local_steps: int = 1,
            verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}" + (f"__G{groups}" if groups
                                                   else "")
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "groups_override": groups, "tag": tag}
    skip = should_skip(cfg, shape)
    if skip:
        result["skipped"] = skip
        _write(out_dir, tag, result)
        if verbose:
            print(f"[dryrun] {tag}: skipped")
        return result
    if groups:
        cfg = cfg.replace(n_layers=groups * len(block_pattern(cfg)))
    model = build_model(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod)
    result["n_devices"] = mesh.size
    plan = {}
    if shape.kind == "train":
        plan = train_plan(cfg, multi_pod, clients, local_steps)
        result.update(plan)
    t0 = time.perf_counter()
    inputs, in_log, state, state_log = _inputs(cfg, shape, model, plan)
    nbytes = {"params": per_device_bytes(model.param_specs(),
                                         model.logical_specs, mesh),
              "inputs": per_device_bytes(inputs, in_log, mesh)}
    if state is not None:
        nbytes["decode_state"] = per_device_bytes(state, state_log, mesh)
    result["bytes_per_device"] = nbytes
    result["cost_analysis"] = {
        "flops": float(step_flops(cfg, shape, plan.get("clients", 0),
                                  plan.get("local_steps", 0))),
        "note": "torch.utils.flop_counter.FlopCounterMode on meta tensors: "
                "matrix products and attention only"}
    result["collective_bytes"], memory = count_step(cfg, shape, mesh, plan)
    result["collective_ops_static"] = NO_STATIC_OPS
    result["memory_analysis"] = dict(memory, note=NO_CODE_SIZE)
    result["size_s"] = round(time.perf_counter() - t0, 3)
    _write(out_dir, tag, result)
    if verbose:
        temp = result["memory_analysis"]["temp_size_in_bytes"]
        print(f"[dryrun] {tag}: params {nbytes['params'] / 1e9:.3f} GB/dev "
              f"inputs {nbytes['inputs'] / 1e9:.3f} GB/dev"
              + (f" state {nbytes['decode_state'] / 1e9:.3f} GB/dev"
                 if state is not None else "")
              + f" flops {result['cost_analysis']['flops']:.4g} "
              f"collectives {total_gb(result['collective_bytes']):.2f} GB "
              f"cross-pod {total_gb(result['collective_bytes'], True):.2f} "
              f"GB temp {temp / 1e9:.2f} GB ({result['size_s']} s)")
    return result


def total_gb(counts: dict, cross_pod: bool = False) -> float:
    """The GB of ``collective_bytes``, of every kind or of the cross-pod
    entries."""
    return sum(v for k, v in counts.items()
               if k.endswith("/cross_pod") == cross_pod) / 1e9


def _write(out_dir: Path, tag: str, result: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    choices=list(INPUT_SHAPES) + ["all"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--groups", type=int, default=0,
                    help="override n_layers = groups*period")
    ap.add_argument("--clients", type=int, default=0)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--out", default="dryrun_out")
    args = ap.parse_args(argv)
    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_one(
                        arch, shape, mp, Path(args.out), groups=args.groups,
                        clients=args.clients, local_steps=args.local_steps))
                except Exception as e:
                    # the reference's rule: a failing tag writes its error
                    # and the grid goes on
                    mesh = "multi" if mp else "single"
                    tag = f"{arch}__{shape}__{mesh}"
                    print(f"[dryrun] FAILED {tag}: {type(e).__name__}: {e}")
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": mesh, "tag": tag,
                                    "error": f"{type(e).__name__}: "
                                             f"{str(e)[:2000]}"})
                    _write(Path(args.out), tag, results[-1])
    return results


if __name__ == "__main__":
    main()
