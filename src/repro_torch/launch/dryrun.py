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
  sequence.

The reference lowers and compiles each step over 512 placeholder devices
and parses the HLO's collectives (``split_computations``,
``collective_bytes`` and their kin).  PyTorch has no AOT lowering of a
sharded program over devices that do not exist, so those parsers have no
counterpart: ``collective_bytes`` is written as absent, with the reason,
not as 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, sharding as sh
from repro_torch.models.transformer import block_pattern
from repro_torch.pytree import flat_dict

# Archs small enough to host parallel client replicas (true hierarchical
# FL); the rest time-multiplex clients sequentially, as in the reference.
PARALLEL_ARCHS = {"xlstm-125m", "gemma-2b", "granite-3-2b", "musicgen-medium",
                  "starcoder2-7b"}

NO_COLLECTIVES = ("not counted: the reference parses them from the HLO of "
                  "a program lowered over placeholder devices, which "
                  "PyTorch cannot lower")


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
    Cached: the count does not depend on the mesh."""
    L = cfg.xlstm.chunk if cfg.xlstm is not None else 0
    if L and shape.kind != "decode" and shape.seq_len > 2 * L:
        if shape.seq_len % L:
            raise ValueError(f"{cfg.name}: a sequence of {shape.seq_len} is "
                             f"not whole mLSTM chunks of {L}")
        f1, f2 = (depth_flops(cfg, dataclasses.replace(shape, seq_len=s),
                              clients, local_steps) for s in (L, 2 * L))
        return f1 + (shape.seq_len // L - 1) * (f2 - f1)
    return depth_flops(cfg, shape, clients, local_steps)


def depth_flops(cfg, shape, clients: int, local_steps: int) -> int:
    """One step's count at ``cfg``'s depth, from the counts at one and at
    two layer groups (the groups are identical)."""
    period = len(block_pattern(cfg))
    f1, f2 = (_step_flops(cfg.replace(n_layers=g * period), shape, clients,
                          local_steps) for g in (1, 2))
    return f1 + (cfg.n_layers // period - 1) * (f2 - f1)


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
    result["collective_bytes"] = NO_COLLECTIVES
    result["size_s"] = round(time.perf_counter() - t0, 3)
    _write(out_dir, tag, result)
    if verbose:
        print(f"[dryrun] {tag}: params {nbytes['params'] / 1e9:.3f} GB/dev "
              f"inputs {nbytes['inputs'] / 1e9:.3f} GB/dev"
              + (f" state {nbytes['decode_state'] / 1e9:.3f} GB/dev"
                 if state is not None else "")
              + f" flops {result['cost_analysis']['flops']:.4g} "
              f"({result['size_s']} s)")
    return result


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
    return [run_one(arch, shape, mp, Path(args.out), groups=args.groups,
                    clients=args.clients, local_steps=args.local_steps)
            for arch in archs for shape in shapes for mp in meshes]


if __name__ == "__main__":
    main()
