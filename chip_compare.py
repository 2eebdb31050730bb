#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port's kernels on one NVIDIA GPU, beside
``chip_smoke.py``: two trees' kernels in turns on one card, a profile of
training rounds, and the host's cost of a kernel launch.

    python3 chip_compare.py --parent DIR [--profile] [--host]
    python3 chip_compare.py --paths DIR [DIR ...]
    python3 chip_compare.py --xlstm-gaps SEED [SEED ...]
    python3 chip_compare.py --spmd
    python3 chip_compare.py --model-rounds DIR
    python3 chip_compare.py --spmd-references
    python3 chip_compare.py --gather

``--parent DIR``: DIR is another checkout of the repository (for example a
``git archive`` of the parent commit unpacked into a git-ignored
directory).  Phases 1 and 2 of ``chip_smoke.py`` (``build()`` and
``check_kernels()``) run four times, each in a process of its own, in the
order parent, this tree, this tree, parent, so that the two trees meet the
same card in turns.  Each run also hashes every kernel's output on the
main-path inputs of ``kernel_specs`` (made from one seed, so both trees
see the same inputs), and times topk_sparsify on the seven small leaves
of the main path (this tree's ``chip_smoke.SMALL_LEAVES``) from a
CUDA graph of 20 calls, the launch path left out.  Each run's build,
ptxas and extra-case lines are printed, then a table of every kernel's
times with its output digest in each run, and one JSON line of all four
runs' rows.

``--profile``: this tree's launcher configurations ``default`` and
``secure_q8_topk_deterministic`` (``chip_smoke.CONFIGS``) and the char-LM's
``lm_default`` (``chip_smoke.LM_CONFIGS``, ``--dataset shakespeare``), each
built as ``chip_smoke.py`` phase 4 builds it, run one round to warm up, one
round timed on the host clock, and then one round under
``torch.profiler``: the rounds' wall times, the profiled round's device
time, each kernel's device time and its share of the round's device
time.

``--host``: the host's time per call (the median of three runs of 1000
calls) of each piece of a kernel wrapper's path into CUDA (its checks, the
output's allocation, the stream's handle, the ctypes launch), of the whole
``fused_accum`` wrapper, and of the ``einsum`` that computes the same sum,
on a small stack.

``--gather``: the mesh layer's collectives over gloo between ranks that
share the card, as FSDP's weight gathers use them: a 512 MiB bf16 share a
rank gathered over ``data`` by ``sharding.all_gather`` (a list of
outputs, then a concatenation), by ``all_gather_into_tensor`` and by
staging it through the host, and summed by ``sharding.psum``, on two
ranks (``data`` 2) and on four (two ``data`` groups at once); each the
mean of three calls after one, synchronised, and checked against the
gather.

``--paths DIR [DIR ...]``: the host-bound training paths of this tree and
the other checkouts in turns (this tree, each DIR, the DIRs again in
reverse, this tree), each run a process of its own: the launcher's
default sync round (``chip_smoke.MAIN_ARGS``), the async per-event and
batched engines and the event-window engine (``ASYNC_ARGS``,
``WINDOW_ARGS``: 6 commits each), and the hierarchy in its async/async
and sync/sync forms (``HIER_FLAGS``: 3 epochs).  Each run prints the wall
of every round, commit (the sum of its ``phase_wall`` seconds) or epoch,
then a table of each path's median over the warm ones (the first left
out).  Each run also trains one CIFAR CNN client (5 steps, batch 16) as
lane 0 of stacked calls of 8, 4, 2 and 1 lanes and as the per-event
engine trains it (``build_client_update_step``), and prints the largest
|difference| of its delta against the 8-lane call: 0 where the tree
computes a lane alike whatever the lane count.

``--xlstm-gaps SEED [SEED ...]``: xlstm-125m whole in bfloat16 on the
card, on the port's init drawn on the CPU from each seed (so the CPU sees
the same bits), decoding 16 teacher-forced tokens (numpy's generator of
``seed + 1``) after a 512-token prompt at batch 2: max |decode - prefill|
/ max |prefill| at the first and the last decoded token (the numbers that
``tests/test_torch_xlstm_bf16.py --whole --port-weights`` prints for both
packages on the CPU), and each of the two against the float32 model's
prefill on the same weights; on the card once with PyTorch's default bf16
GEMMs and once with their split reductions kept in float32.

``--spmd``: the round across processes (``chip_smoke.py``'s phase
``spmd``) and two readings behind its bounds.  First the unfused commit's
weighted sum over the CIFAR CNN's stack of 20 slots, computed leaf by leaf
(the form before the sum took the fused commit's blocked layout) and as
``kernels.ops.weighted_sum_tree`` does it: whether the two agree bit for
bit, and each one's median time over 50 calls (CUDA events), in turns.
(The pipeline keeps both: leaf by leaf off a mesh, packed under one.)
Then the reduced Jamba's sequential round of the phase (``SPMD_JAMBA``)
with no mesh here and on four gloo ranks sharing the card: sound, with the
ranks' mean doubled, and with the mean replaced by a sum over the ranks
(two controls that a wrong gradient reduction must fail): each one's loss
and params gap to no mesh.  Then the phase itself, alone.

``--model-rounds DIR``: ``chip_smoke.py``'s ``spmd`` (d) q8 rounds (the
reduced LMs' ``MODEL_CASES``, stochastic q8, on ``MODEL_SIZES`` ranks
sharing the card, under deterministic algorithms) in DIR and in this
tree, each in a process of its own that imports only its own tree's
``repro_torch``, on the same batches: each rank's new params hashed, its
gap to the same tree's round with no mesh, and whether the two trees'
rounds end bit for bit alike, rank by rank.

``--spmd-references``: the phase's (a) ranks against no-mesh references
made under cuDNN's default algorithms, then under the deterministic ones
the ranks compare under: every rank's deltas' gap from no mesh in each
mode (``spmd_reference_algorithms``).

Every run prints the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KEYS = ("ms", "queued_ms", "plain_ms", "library_ms", "library_queued_ms",
        "bound_ms")
PHASES = """
import hashlib, json, sys
sys.path.insert(0, {tree!r})
import chip_smoke
import torch
chip_smoke.build()
rows = chip_smoke.check_kernels()
print("ROWS " + json.dumps(rows))
# each kernel's output on the main-path inputs, hashed
digests = {{}}
for name, spec in chip_smoke.kernel_specs("cuda").items():
    out = spec["kernel"]()
    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    digests[name] = h.hexdigest()[:16]
print("DIGESTS " + json.dumps(digests))
# the top-k of the seven small leaves as the main path blocks them (20
# clients, last dim zero-padded to 256 lanes), device time per call from a
# CUDA graph of 20 calls, so that the host's launch path falls out
from repro_torch.kernels.topk_sparsify import topk_sparsify_blocks
gen = torch.Generator(device="cuda").manual_seed(5)
small = {{}}
for name, R, live in {leaves}:
    x = torch.zeros(R, 256, device="cuda")
    x[:, :live] = torch.randn(R, live, generator=gen, device="cuda") * 0.01
    topk_sparsify_blocks(x, chip_smoke.TOPK_K)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            topk_sparsify_blocks(x, chip_smoke.TOPK_K)
    graph.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    b.synchronize()
    small[name] = a.elapsed_time(b) / 100
print("SMALL " + json.dumps(small))
"""


PATHS = """
import json, os, statistics, sys, time
sys.path.insert(0, {tree!r})
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import chip_smoke as cs
import torch
from repro_torch.core.async_round import build_client_update_step
from repro_torch.core.round import FLConfig, build_local_train
from repro_torch.launch import train
from repro_torch.models.cnn import CIFAR_CNN, CNN
from repro_torch.optim import get_client_optimizer
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cs.build()
# one client's delta as lane 0 of 8, 4, 2 and 1 stacked lanes and as the
# per-event engine trains it, each against the 8-lane call
model, opt = CNN(CIFAR_CNN), get_client_optimizer("sgd")
g = torch.Generator("cuda").manual_seed(0)
params = model.init(g, "cuda")
fl = FLConfig(num_clients=8, local_steps=5, client_lr=0.01)
batches = {{"image": torch.randn(8, 5, 16, 32, 32, 3, generator=g,
                                 device="cuda"),
           "label": torch.randint(0, 10, (8, 5, 16), generator=g,
                                  device="cuda")}}
stacked = build_local_train(model.loss_fn, opt, fl, stacked=True)
lane0 = {{n: stacked(params, {{k: v[:n] for k, v in batches.items()}})[0]
         for n in (8, 4, 2, 1)}}
one = build_client_update_step(model.loss_fn, opt, fl)(
    params, {{k: v[0] for k, v in batches.items()}})[0]
gap = lambda d: max((d[k] - lane0[8][k][0]).abs().max().item() for k in d)
lanes = {{f"{{n}} lanes": gap({{k: v[0] for k, v in lane0[n].items()}})
          for n in (4, 2, 1)}}
lanes["per-event"] = gap(one)
print("LANES " + json.dumps(lanes))
runs = {{
    "sync_default": cs.MAIN_ARGS,
    "async_per_event": cs.ASYNC_ARGS,
    "async_batched": cs.ASYNC_ARGS + ["--engine", "batched"],
    "window_default": cs.WINDOW_ARGS,
    "hier_async_async": cs.ASYNC_ARGS + ["--inter-facility-mode", "async",
                                         "--inter-buffer", "2"]
                        + cs.HIER_FLAGS,
    "hier_sync_sync": cs.MAIN_ARGS + cs.HIER_FLAGS,
}}
for name, argv in runs.items():
    args = train.build_parser().parse_args(argv)
    if args.facilities:
        walls = cs.run_hier(args)[3]
    else:
        orch, _, _ = train.run(args)
        torch.cuda.synchronize()
        s = train.summarize(args, orch)
        walls = s.get("round_wall_s") or [
            sum(v for k, v in pw.items() if k != "host_syncs")
            for pw in s["phase_wall"]]
    print("WALLS " + json.dumps({{name: walls}}))
"""


def run_paths(tree: Path, label: str) -> dict:
    """``PATHS`` in ``tree``, in a process of its own: the lane gaps and
    each path's walls."""
    proc = subprocess.run([sys.executable, "-c", PATHS.format(tree=str(tree))],
                          cwd=tree, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        raise SystemExit(f"{label}: exit {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    out = {"walls": {}}
    for line in proc.stdout.splitlines():
        if line.startswith("LANES "):
            out["lanes"] = json.loads(line[6:])
        elif line.startswith("WALLS "):
            out["walls"].update(json.loads(line[6:]))
    print(f"  [{label}] lane 0 against the 8-lane call, max |diff|: "
          f"{out['lanes']}")
    for name, walls in out["walls"].items():
        print(f"  [{label}] {name}: " + " ".join(f"{w:.6f}" for w in walls))
    return out


def compare_paths(others: list) -> None:
    trees = [(ROOT, "this")] + [(p, p.name) for p in others]
    order = trees + trees[1:][::-1] + [trees[0]]
    runs = []
    for i, (tree, name) in enumerate(order):
        label = f"{i + 1}-{name}"
        print(f"run {label}: {tree}")
        runs.append((label, run_paths(tree, label)))
    print("median wall s over the warm rounds, commits or epochs, runs in "
          "order: " + "  ".join(label for label, _ in runs))
    for name in runs[0][1]["walls"]:
        meds = [statistics.median(r["walls"][name][1:]) for _, r in runs]
        print(f"  {name:18s} " + "  ".join(f"{m:.6f}" for m in meds))
    print("PATHS " + json.dumps({label: r for label, r in runs}))


def xlstm_gaps(seeds, device="cuda") -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-125m").replace(dtype="bfloat16")
    model, f32 = build_model(cfg), build_model(cfg.replace(dtype="float32"))
    batch, s0, at = 2, 512, (0, 15)
    S = s0 + max(at) + 1
    # the card's bf16 GEMMs as PyTorch sets them by default, then with
    # their split reductions kept in float32
    modes = [("default", None)]
    if device == "cuda":
        modes.append(("bf16 reductions in f32", False))
    mm = torch.backends.cuda.matmul

    def rel(got, want):
        got, want = got.float(), want.float()
        return ((got - want).abs().max() / want.abs().max()).item()

    for seed in seeds:
        cpu = model.init(torch.Generator().manual_seed(seed))
        params, wide = _to(cpu, device), _to(cpu, device, torch.float32)
        toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
            0, cfg.vocab, (batch, S)).astype(np.int32)).long().to(device)
        with torch.inference_mode():
            truth = {t: f32.prefill(wide, {"tokens": toks[:, :s0 + t + 1]},
                                    S)[0] for t in at}
            for mode, reduced in modes:
                keep = mm.allow_bf16_reduced_precision_reduction
                if reduced is not None:
                    mm.allow_bf16_reduced_precision_reduction = reduced
                dec, pre = {}, {}
                lg, state = model.prefill(params, {"tokens": toks[:, :s0]}, S)
                for t in range(max(at) + 1):
                    lg, state = model.decode_step(params, state,
                                                  toks[:, s0 + t], s0 + t)
                    if t in at:
                        dec[t] = lg
                        pre[t] = model.prefill(
                            params, {"tokens": toks[:, :s0 + t + 1]}, S)[0]
                mm.allow_bf16_reduced_precision_reduction = keep
                print("XLSTM_GAPS " + json.dumps({
                    "seed": seed, "mode": mode,
                    "port_gaps": [rel(dec[t], pre[t]) for t in at],
                    "decode_vs_f32": [rel(dec[t], truth[t]) for t in at],
                    "prefill_vs_f32": [rel(pre[t], truth[t]) for t in at]}),
                    flush=True)


def _to(tree, device, dtype=None):
    return {k: _to(v, device, dtype) if isinstance(v, dict)
            else v.to(device, dtype) for k, v in tree.items()}


def run_phases(tree: Path, label: str) -> dict:
    """Phases 1-2 of ``tree``'s chip_smoke.py in a process of its own."""
    import chip_smoke
    script = PHASES.format(tree=str(tree),
                           leaves=repr(chip_smoke.SMALL_LEAVES))
    proc = subprocess.run([sys.executable, "-c", script],
                          cwd=tree, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        raise SystemExit(f"{label}: exit {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("build:") or "ptxas" in line or (
                line.startswith("kernel ") and ("(" in line.split(":")[0]
                                                or "slot limit" in line)):
            print(f"  [{label}] {line}")
    found = {}
    for line in proc.stdout.splitlines():
        for key in ("ROWS ", "DIGESTS ", "SMALL "):
            if line.startswith(key):
                found[key] = json.loads(line[len(key):])
    rows = found["ROWS "]
    for name, digest in found["DIGESTS "].items():
        rows.setdefault(name, {})["digest"] = digest
    rows["topk_sparsify"]["small_leaves_ms"] = found["SMALL "]
    return rows


def compare(parent: Path) -> None:
    runs = []
    for i, (tree, name) in enumerate(((parent, "parent"), (ROOT, "this"),
                                      (ROOT, "this"), (parent, "parent"))):
        label = f"{i + 1}-{name}"
        print(f"run {label}: {tree}")
        runs.append((label, run_phases(tree, label)))
    print("per kernel, the four runs in order (parent, this, this, parent):")
    for kname in runs[1][1]:
        print(f"kernel {kname}:")
        for key in KEYS:
            vals = [r.get(kname, {}).get(key) for _, r in runs]
            if any(v is not None for v in vals):
                print(f"  {key:18s} " + "  ".join(
                    "-" if v is None else f"{v:.4f}" for v in vals))
        digests = [r.get(kname, {}).get("digest") for _, r in runs]
        same = len(set(digests)) == 1
        print(f"  {'output digest':18s} " + "  ".join(map(str, digests))
              + ("  (equal in all four runs)" if same else "  (DIFFERENT)"))
    print("topk_sparsify on the small leaves, device ms per call (a CUDA "
          "graph of 20 calls):")
    for leaf in runs[1][1]["topk_sparsify"]["small_leaves_ms"]:
        vals = [r["topk_sparsify"]["small_leaves_ms"][leaf] for _, r in runs]
        print(f"  {leaf:18s} " + "  ".join(f"{v:.4f}" for v in vals))
    print("COMPARE " + json.dumps({label: rows for label, rows in runs}))


def profile_rounds() -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import launches
    from repro_torch.launch import train
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [(c, cs.CONFIGS[c], cs.MAIN_ARGS)
            for c in ("default", "secure_q8_topk_deterministic")]
    runs.append(("lm_default", cs.LM_CONFIGS["lm_default"], cs.LM_ARGS))
    for cname, (flags, expect), base in runs:
        args = train.build_parser().parse_args(base + flags)
        orch, params = train.build_run(args)
        state = orch.init_server_state(params)
        params, state, _ = orch.run_round(0, params, state)      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _ = orch.run_round(1, params, state)
        torch.cuda.synchronize()
        unprofiled = time.perf_counter() - t0
        launches.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, _ = orch.run_round(2, params, state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")]
        total = sum(e.self_device_time_total for e in kernels)
        print(f"profile {cname}: a warm round unprofiled "
              f"{unprofiled * 1e3:.3f} ms; one profiled round, wall "
              f"{wall * 1e3:.3f} ms, "
              f"device time {total / 1e3:.3f} ms in {len(kernels)} kernels "
              f"(busy share {total / 1e6 / wall:.3f}); launches "
              f"{dict(launches.KERNEL_LAUNCHES)} (a round of {expect})")
        if not total:
            continue
        for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                        reverse=True):
            mine = any(n in e.key for n in ("fused_accum", "secure_commit",
                                            "secure_fold", "plain_commit",
                                            "topk_rows"))
            if mine or e.self_device_time_total >= 0.01 * total:
                print(f"  {e.self_device_time_total / 1e3:9.4f} ms "
                      f"{e.self_device_time_total / total:7.2%} "
                      f"x{e.count:<4d} {e.key[:100]}")


def host_costs() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import _build, launches, ref
    from repro_torch.kernels.fused_accum import fused_accum_blocks
    dev = torch.device("cuda", 0)
    x = torch.randn(20, 8, 256, device=dev)
    w = torch.rand(20, device=dev)
    s = torch.zeros(20, device=dev)
    out = torch.empty((8, 256), device=dev)
    w_eff = ref.slot_weights(w, s, 0.0)
    pieces = {
        "launches.check_shapes": lambda: launches.check_shapes(
            "fused_accum", x, 3, w, s),
        "launches.on_cpu": lambda: launches.on_cpu(x, w, s),
        "launches.check_operands": lambda: launches.check_operands(
            "fused_accum", x, w, s),
        "torch.empty": lambda: torch.empty((8, 256), dtype=torch.float32,
                                           device=dev),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.cuda.current_device": torch.cuda.current_device,
        "_build.launch (fused_accum)": lambda: _build.launch(
            "commit_kernels", "fused_accum", x.data_ptr(), w.data_ptr(),
            s.data_ptr(), 0.0, out.data_ptr(), 20, out.numel(), device=dev),
        "fused_accum_blocks": lambda: fused_accum_blocks(x, w, s, 0.0),
        "torch.einsum('k,krb->rb')": lambda: torch.einsum("k,krb->rb", w_eff,
                                                          x),
    }
    for name, fn in pieces.items():
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(1000):
                fn()
            times.append((time.perf_counter() - t0) * 1e3)   # us per call
            torch.cuda.synchronize()
        print(f"host {name}: {statistics.median(times):.2f} us per call")


def spmd_jamba_rank(mesh, path, control):
    """One rank of the reduced Jamba's sharded round; ``control`` replaces
    the gradient mean by twice itself or by the ranks' sum."""
    import torch

    import chip_smoke as cs
    from repro_torch.models import sharding as sh
    cs.spmd_rank_setup()
    if control == "sum":
        sh.pmean = sh.psum
    elif control == "doubled":
        mean = sh.pmean
        sh.pmean = lambda x, axes: mean(x, axes) * 2
    z = torch.load(path, weights_only=False)
    j = cs.SPMD_JAMBA
    lm = cs.build_model(cs.reduced(cs.get_config(cs.JAMBA)))
    new, loss = cs.spmd_jamba_round(
        lm, {k: v.to(mesh.device) for k, v in z["params"].items()},
        z["batches"], j["C"], j["H"], mesh.device)
    return cs.cpu_tree(new), loss


def spmd_readings() -> None:
    import os
    import tempfile

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import spmd
    # chip_smoke.main's settings: the phase's references are made here
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cs.build()
    # the unfused commit's sum, leaf by leaf and packed
    C = cs.SPMD_ROUND["C"]
    p = cs.CNN(cs.CIFAR_CNN).init(torch.Generator().manual_seed(0),
                                  device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    stacked = {k: torch.randn((C,) + tuple(v.shape), device="cuda",
                              generator=g) * 0.01 for k, v in p.items()}
    w = torch.rand(C, device="cuda", generator=g)
    names = sorted(stacked)

    def per_leaf():
        return {k: (d * w.reshape((-1,) + (1,) * (d.ndim - 1))).sum(0)
                for k, d in stacked.items()}

    def packed():
        return dict(zip(names, kops.weighted_sum_tree(
            [stacked[n] for n in names], w)))
    a, b = per_leaf(), packed()
    same = all(torch.equal(a[k], b[k]) for k in a)
    gap = max(float((a[k] - b[k]).abs().max()) for k in a)
    times = {}
    for name, fn in (("per leaf", per_leaf), ("packed", packed),
                     ("per leaf again", per_leaf), ("packed again", packed)):
        for _ in range(5):
            fn()
        ts = []
        for _ in range(50):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        times[name] = round(statistics.median(ts), 4)
    print(f"spmd unfused sum over [{C}, CIFAR leaves]: bit for bit {same} "
          f"(max |diff| {gap:.3g}); median ms {times}", flush=True)
    # the reduced Jamba: sound and the two controls
    j = cs.SPMD_JAMBA
    cfg = cs.reduced(cs.get_config(cs.JAMBA))
    lm = cs.build_model(cfg)
    lp = {k: v.to("cuda") for k, v in cs.flat_dict(lm.init(
        torch.Generator().manual_seed(0))).items()}
    jb = cs.lm_batches(cfg, (j["C"], j["H"], j["B"]), j["S"], 3)
    new, loss = cs.spmd_jamba_round(lm, lp, jb, j["C"], j["H"], "cuda")
    moved = max(float((new[k] - lp[k]).abs().max()) for k in new)
    print(f"spmd jamba: no mesh loss {loss:.6f}, the params' largest move "
          f"{moved:.3g}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "jamba.pt")
        torch.save({"params": cs.cpu_tree(lp), "batches": jb}, path)
        for control in (None, "doubled", "sum"):
            got, got_loss = spmd.run(spmd_jamba_rank, (path, control),
                                     sizes=cs.SPMD_SIZES, device="cuda",
                                     timeout_s=300, threads=None,
                                     verbose=False)
            gap = max(float((got[k] - new[k].cpu()).abs().max())
                      for k in new)
            print(f"spmd jamba {control or 'sound'}: loss gap "
                  f"{abs(got_loss - loss):.3g}, params gap {gap:.3g} "
                  f"(bounds {cs.SPMD_JAMBA_TOL})", flush=True)
    t0 = time.perf_counter()
    try:
        totals = cs.spmd_phase()
        print(f"spmd phase: launches {totals}")
    except cs.SmokeFailure as e:
        print(f"spmd phase: FAILED {e}")
    print(f"phase spmd: {time.perf_counter() - t0:.1f} s")


def spmd_reference_algorithms() -> None:
    """``--spmd-references``: ``chip_smoke.py``'s ``spmd`` (a) ranks held
    against no-mesh references made under cuDNN's default algorithms and
    under the deterministic ones the ranks compare under (``spmd_phase``
    makes them under the latter): every rank's deltas' gap from no mesh in
    each mode, and each client's largest delta."""
    import tempfile

    import torch

    import chip_smoke as cs
    from repro_torch.launch import spmd
    cs.build()
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        torch.backends.cudnn.deterministic = det
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/reference.pt"
            ref = cs.spmd_reference("cuda")
            for mode in ("sequential", "pod_sequential"):
                top = [round(max(float(v.abs().max()) for v in d.values()),
                             4) for d, _ in ref["rounds"][mode]["updates"]]
                print(f"references deterministic {det}: {mode} clients' "
                      f"largest delta {top}", flush=True)
            torch.save(ref, path)
            del ref
            out = spmd.run(cs.spmd_rank_main, (path,), sizes=cs.SPMD_SIZES,
                           device="cuda", all_ranks=True, timeout_s=900,
                           threads=None)
        for rank, (checks, _, _) in enumerate(out):
            for label, ok, detail in checks:
                if "deltas against" in label:
                    print(f"references deterministic {det}, rank {rank}: "
                          f"{label}: {detail}", flush=True)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


MODEL_ROUNDS = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import chip_compare
chip_compare.model_rounds({cases!r}, {shape!r}, {axes!r}, {sizes!r},
                          {path!r}, {device!r})
"""


def _round_setup():
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)


def _model_round(arch, mode, shape, axes, batches, device):
    """(d)'s q8 round of the reduced ``arch`` in ``mode`` from its params
    drawn from seed 0, held at rest as the active mesh cuts them
    (``chip_smoke.model_round``'s config): (the model, new params,
    loss)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import (CompressionConfig, FLConfig,
                                  build_fl_round_step)
    from repro_torch.launch import specs as sp
    from repro_torch.models import build_model
    from repro_torch.optim import get_client_optimizer, get_server_optimizer
    from repro_torch.pytree import flat_dict
    lm = build_model(reduced(get_config(arch)))
    params = sp.shard_params({k: v.to(device) for k, v in flat_dict(
        lm.init(torch.Generator().manual_seed(0))).items()},
        lm.logical_specs)
    C = shape["C"]
    step = build_fl_round_step(
        lm.loss_fn, get_client_optimizer("sgd"),
        get_server_optimizer("fedavg"), FLConfig(
            num_clients=C, local_steps=shape["H"], client_lr=0.05,
            fedprox_mu=0.01, client_exec=mode,
            compression=CompressionConfig(quantize_bits=8)), n_pods=2,
        client_spmd_axes=axes)
    ones = torch.ones(C, device=device)
    new, _, met = step(params, (), {
        k: torch.from_numpy(v).to(device) for k, v in batches.items()},
        ones, ones, torch.Generator().manual_seed(3))
    return lm, new, float(met["client_loss"])


def _digest(tree) -> str:
    import hashlib

    import torch
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(tree[k].detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def model_rounds_rank(mesh, cases, shape, axes, path):
    import torch

    from repro_torch.launch import specs as sp
    _round_setup()
    data = torch.load(path, weights_only=False)
    out = {}
    for arch, mode in cases:
        label = f"{arch} {mode}"
        lm, new, loss = _model_round(arch, mode, shape, axes[mode],
                                     data["batches"][label], mesh.device)
        want = sp.shard_params({k: v.to(mesh.device) for k, v in
                                data["new"][label].items()},
                               lm.logical_specs)
        out[label] = {"digest": _digest(new), "loss": loss, "gap": max(
            float((new[k].float() - want[k].float()).abs().max())
            for k in want)}
    return out


def model_rounds(cases, shape, axes, sizes, path, device="cuda") -> None:
    """The no-mesh rounds, then the ranks', in this process's tree: one
    ``ROUNDS`` line."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import spmd
    if device == "cuda":
        _build.build_all()
    _round_setup()
    data = torch.load(path, weights_only=False)
    data["new"], ref = {}, {}
    for arch, mode in cases:
        label = f"{arch} {mode}"
        _, new, loss = _model_round(arch, mode, shape, None,
                                    data["batches"][label], device)
        data["new"][label] = {k: v.cpu() for k, v in new.items()}
        ref[label] = {"digest": _digest(new), "loss": loss}
    torch.save(data, path)
    ranks = spmd.run(model_rounds_rank, (cases, shape, axes, path),
                     sizes=sizes, device=device, all_ranks=True,
                     verbose=False)
    print("ROUNDS " + json.dumps({"no mesh": ref, "ranks": ranks}))


def compare_model_rounds(other: Path, device: str = "cuda") -> None:
    import os
    import tempfile

    import torch

    import chip_smoke as cs
    cases = [list(c) for c in cs.MODEL_CASES]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tree, label in ((other, "parent"), (ROOT, "this")):
            path = os.path.join(tmp, f"{label}.pt")
            torch.save({"batches": {
                f"{arch} {mode}": cs.lm_batches(
                    cs.reduced(cs.get_config(arch)),
                    tuple(cs.MODEL_SHAPE[k] for k in "CHB"),
                    cs.MODEL_SHAPE["S"], 1) for arch, mode in cases}}, path)
            script = MODEL_ROUNDS.format(
                src=str(tree / "src"), root=str(ROOT), cases=cases,
                shape=cs.MODEL_SHAPE, axes=cs.MODEL_AXES,
                sizes=cs.MODEL_SIZES, path=path, device=device)
            proc = subprocess.run(
                [sys.executable, "-c", script], cwd=ROOT,
                capture_output=True, text=True, timeout=1200,
                env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
            if proc.returncode:
                raise SystemExit(f"{label}: exit {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}"
                                 f"{proc.stderr[-3000:]}")
            line = [x for x in proc.stdout.splitlines()
                    if x.startswith("ROUNDS ")][-1]
            runs[label] = json.loads(line[7:])
    for label in runs["this"]["no mesh"]:
        same_ref = len({r["no mesh"][label]["digest"]
                        for r in runs.values()}) == 1
        ranks = {name: [rank[label] for rank in r["ranks"]]
                 for name, r in runs.items()}
        same = all(a["digest"] == b["digest"] for a, b in
                   zip(ranks["parent"], ranks["this"]))
        gaps = {name: " ".join(f"{r['gap']:.3g}" for r in rs)
                for name, rs in ranks.items()}
        print(f"model round {label}: no mesh bit for bit across the trees "
              f"{same_ref}; every rank's shares bit for bit across the "
              f"trees {same}; the ranks' gaps to no mesh, parent "
              f"[{gaps['parent']}], this [{gaps['this']}]", flush=True)
    print("MODEL_ROUNDS " + json.dumps(runs))


def gather_rank(mesh, n):
    """``--gather`` on one rank: {variant: (seconds a call, equal to the
    port's gather)}."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import sharding as sh
    dev = mesh.device
    x = torch.randn(n, device=dev, dtype=torch.bfloat16)
    group = mesh.group(("data",))

    def into():
        out = torch.empty(group.size() * n, device=dev, dtype=x.dtype)
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    def staged():
        out = torch.empty(group.size() * n, dtype=x.dtype)
        dist.all_gather_into_tensor(out, x.cpu(), group=group)
        return out.to(dev)

    want = sh.all_gather(x, "data", 0)
    out = {}
    for name, fn in (("sharding.all_gather", lambda: sh.all_gather(
            x, "data", 0)), ("all_gather_into_tensor", into),
            ("staged through the host", staged),
            ("sharding.psum", lambda: sh.psum(x, "data"))):
        same = name.endswith("psum") or torch.equal(fn(), want)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize(dev)
        out[name] = ((time.perf_counter() - t0) / 3, same)
    return out


def gather_readings() -> None:
    from repro_torch.launch import spmd
    n = 1 << 28                       # 512 MiB of bf16 a rank
    for sizes in ((1, 2, 1), (2, 2, 1)):
        got = spmd.run(gather_rank, (n,), sizes=sizes, device="cuda",
                       threads=None, verbose=False)
        print(f"gather over data, {sizes} mesh, a 512 MiB bf16 share a "
              f"rank (the gather's output 1 GiB): " + "; ".join(
                  f"{k} {v[0]:.4f} s (equal {v[1]})" for k, v in got.items()),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout to compare")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--paths", type=Path, nargs="+", metavar="DIR",
                    help="other checkouts whose training paths to time")
    ap.add_argument("--xlstm-gaps", type=int, nargs="+", metavar="SEED")
    ap.add_argument("--spmd", action="store_true")
    ap.add_argument("--model-rounds", type=Path, metavar="DIR",
                    help="another checkout whose (d) q8 rounds to compare")
    ap.add_argument("--spmd-references", action="store_true")
    ap.add_argument("--gather", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 2
    print(f"nvidia-smi: {cs.nvidia_smi()}")
    if args.parent:
        compare(args.parent.resolve())
    if args.paths:
        compare_paths([p.resolve() for p in args.paths])
    if args.xlstm_gaps:
        xlstm_gaps(args.xlstm_gaps)
    if args.host:
        host_costs()
    if args.profile:
        profile_rounds()
    if args.spmd:
        spmd_readings()
    if args.model_rounds:
        compare_model_rounds(args.model_rounds.resolve())
    if args.spmd_references:
        spmd_reference_algorithms()
    if args.gather:
        gather_readings()
    print(f"nvidia-smi: {cs.nvidia_smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
