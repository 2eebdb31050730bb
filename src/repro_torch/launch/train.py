"""Federated training launcher, mirroring ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --dataset cifar10 --rounds 100 --clients-pool 60 \
        --clients-per-round 20 --local-steps 5 --quantize-bits 8 \
        --topk-frac 0.1 --checkpoint-dir ckpts/run1 --render-jobs jobs/
    PYTHONPATH=src python -m repro_torch.launch.train --mode async \
        --buffer-k 8 --max-concurrency 16 --rounds 100

Same flags as the reference plus ``--device`` (default ``cuda``; the
launcher raises when CUDA is absent and ``--device cpu`` was not given).
``--dataset shakespeare`` trains the paper's char-LM (``paper-charlm``) on
the synthetic Shakespeare task; ``--checkpoint-dir``/``--checkpoint-every``
snapshot the run and ``--resume`` continues from the latest snapshot, with
the reference's semantics (params, server state, round, clock and backend
state restored; selection, faults and the generators re-seeded from
``--seed``); ``--render-jobs`` writes the scheduler artifacts that run
``python -m repro_torch.worker``.

``--mode async`` runs the buffered-asynchronous regime (FedBuff:
staleness-discounted commits every ``--buffer-k`` arrivals or after
``--commit-timeout`` sim-seconds; ``--rounds`` then counts server commits)
on the per-event engine (``--engine legacy``, which ``auto`` picks below
``AUTO_ENGINE_THRESHOLD`` clients), the batched one (``--engine
batched``) or the event-window one (``--engine window``, which ``auto``
picks from ``AUTO_ENGINE_THRESHOLD`` clients; ``--event-window`` events a
block).  Its ``--checkpoint-dir`` snapshots the whole orchestrator every
``--checkpoint-every`` commits and ``--resume`` continues bit for bit
(event heap, buffer and every RNG stream restored).  ``--facilities N``
federates N facilities, each running ``--mode`` over its share of the
fleet for ``--local-rounds`` an epoch, under a tier-2 server
(``--inter-facility-mode sync|async``, ``--inter-buffer``) over modelled
WAN links; ``--rounds`` then counts tier-2 commits, and ``--resume``
restores both tiers.  Flags that only another regime reads are parsed
and, as in the reference, not used.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointManager, CheckpointManager
from repro_torch.comm import LinkClass, WANTopology
from repro_torch.configs import get_config
from repro_torch.core import (AsyncConfig, CompressionConfig, FLConfig,
                              payload_bytes)
from repro_torch.data import (FederatedDataset, cifar10_like, medmnist_like,
                              partition_by_class, partition_by_group,
                              shakespeare_like)
from repro_torch.exec import BACKEND_NAMES, make_backend
from repro_torch.models import build_model
from repro_torch.models.cnn import CIFAR_CNN, CNN, MEDMNIST_CNN
from repro_torch.orchestrator import (AsyncOrchestrator,
                                      BatchedAsyncOrchestrator, CohortFleet,
                                      EventWindowOrchestrator, FaultConfig,
                                      HierarchicalOrchestrator, Orchestrator,
                                      StragglerPolicy,
                                      equivalent_preempt_rate_per_min,
                                      make_facilities, make_hybrid_fleet,
                                      split_fleet)
from repro_torch.orchestrator.server import to_device
from repro_torch.orchestrator.straggler import expected_attempt_s
from repro_torch.pytree import flat_dict
from repro_torch.sched import HybridAdapter, JobSpec, K8sAdapter, SlurmAdapter

# --engine auto crossover: below this fleet size the per-event engine is
# the reference's pick (its measured crossover)
AUTO_ENGINE_THRESHOLD = 300


def resolve_engine(engine: str, fleet) -> str:
    """Map --engine auto to a concrete engine from the fleet size."""
    if engine != "auto":
        return engine
    if isinstance(fleet, CohortFleet) or len(fleet) >= AUTO_ENGINE_THRESHOLD:
        return "window"
    return "legacy"


def _staleness_exp(v: str):
    if v == "adaptive":
        return v
    try:
        return float(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a float or 'adaptive', got {v!r}")


def resolve_device(name: str) -> torch.device:
    """The device a run uses; CUDA unless the caller asked for the CPU, and
    an error (never a quiet CPU run) when CUDA was asked for and is absent.
    On CUDA, bf16 matrix products then reduce in float32, as the
    reference's do: with PyTorch's default, cuBLAS may split a reduction
    and add the parts in bf16, and a decode step (a few rows) then rounds
    apart from the prefill (many rows): xlstm-125m's decode drifted from
    its prefill by 0.19-0.94 of the logit scale, 0.0-0.12 without."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available; pass --device cpu to "
            f"run on the CPU")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev


def build_task(name: str, n_clients: int, seed: int, device):
    """(federated data, model, initial params on device, eval fn).  The
    params draw from a CPU generator seeded with ``seed``, so every device
    starts from the same values.  The char-LM's params are its flat view
    (``/``-joined leaf paths); it has no accuracy, so its eval fn is None,
    as in the reference."""
    if name == "cifar10":
        ds = cifar10_like(n=20_000, seed=seed)
        parts = partition_by_class(ds.y, n_clients, 2, seed=seed)
        model = CNN(CIFAR_CNN)
    elif name == "medmnist":
        ds = medmnist_like(n=12_000, seed=seed)
        parts = partition_by_class(ds.y, n_clients, 3, seed=seed)
        model = CNN(MEDMNIST_CNN)
    elif name == "shakespeare":
        ds = shakespeare_like(n_seqs=8000, seq_len=64,
                              n_speakers=2 * n_clients, seed=seed)
        parts = partition_by_group(ds.y, n_clients, seed=seed)
        model = build_model(get_config("paper-charlm"))
    else:
        raise ValueError(name)
    fed = FederatedDataset(ds, parts, seed=seed)
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    if not hasattr(model, "accuracy"):
        return fed, model, flat_dict(params), None
    eval_batch = to_device(fed.eval_batch(1024), device)
    eval_fn = lambda p: model.accuracy(p, eval_batch)
    return fed, model, params, eval_fn


def render_jobs(fleet, out_dir: Path) -> int:
    """The sbatch script (HPC clients) or pod manifest (cloud clients) the
    scheduler adapters would submit for each client, one file each; every
    job runs ``python -m repro_torch.worker``."""
    hy = HybridAdapter()
    out_dir.mkdir(parents=True, exist_ok=True)
    for c in fleet:
        spec = JobSpec(
            name=f"fl-client-{c.cid}",
            command=f"python -m repro_torch.worker --client-id {c.cid}",
            gpus_per_node=1 if c.profile.compute_tflops > 4 else 0,
            mem_gb=int(c.profile.memory_gb), site=c.site,
            preemptible=c.profile.spot)
        h = hy.submit(spec)
        ext = "sbatch" if c.site == "hpc" else "json"
        (out_dir / f"client{c.cid:03d}.{ext}").write_text(h.artifact)
    return len(fleet)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu must be "
                         "asked for)")
    ap.add_argument("--dataset", default="cifar10",
                    choices=["cifar10", "medmnist", "shakespeare"])
    ap.add_argument("--algo", default="fedavg", choices=["fedavg", "fedprox"])
    ap.add_argument("--mode", default="sync", choices=["sync", "async"])
    ap.add_argument("--exec-backend", default="closed-form",
                    choices=list(BACKEND_NAMES))
    ap.add_argument("--hpc-nodes", type=int, default=0)
    ap.add_argument("--cloud-nodes", type=int, default=0)
    ap.add_argument("--spot-preempt-per-min", type=float, default=0.0)
    # the async and hierarchical regimes
    ap.add_argument("--buffer-k", type=int, default=8)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "legacy", "batched", "window"])
    ap.add_argument("--train-chunk", type=int, default=32)
    ap.add_argument("--event-window", type=int, default=256)
    ap.add_argument("--commit-chunk", type=int, default=0)
    ap.add_argument("--staleness-exp", type=_staleness_exp, default=0.5)
    ap.add_argument("--secure-agg", action="store_true")
    ap.add_argument("--facilities", type=int, default=0)
    ap.add_argument("--facility-backend", default="",
                    choices=[""] + list(BACKEND_NAMES))
    ap.add_argument("--inter-facility-mode", default="sync",
                    choices=["sync", "async"])
    ap.add_argument("--local-rounds", type=int, default=2)
    ap.add_argument("--inter-buffer", type=int, default=1)
    ap.add_argument("--wan-bw", type=float, default=6.25)
    ap.add_argument("--wan-latency", type=float, default=1e-3)
    ap.add_argument("--wan-jitter", type=float, default=0.0)
    ap.add_argument("--max-staleness", type=int, default=20)
    ap.add_argument("--commit-timeout", type=float, default=0.0)
    ap.add_argument("--max-concurrency", type=int, default=16)
    # the sync regime
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients-pool", type=int, default=60)
    ap.add_argument("--clients-per-round", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--mu", type=float, default=0.02)
    ap.add_argument("--quantize-bits", type=int, default=0)
    ap.add_argument("--topk-frac", type=float, default=0.0)
    ap.add_argument("--fed-dropout", type=float, default=0.0)
    ap.add_argument("--use-fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused CUDA commit path (compress + accumulate in "
                         "one pass); --no-use-fused runs the plain stages")
    ap.add_argument("--stochastic-rounding",
                    action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--fastest-k", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--dropout-prob", type=float, default=0.0)
    ap.add_argument("--spot-preempt-prob", type=float, default=0.0)
    ap.add_argument("--partition-prob", type=float, default=0.0)
    ap.add_argument("--recovery-policy", default="restart",
                    choices=["restart", "resume", "discard", "adaptive"])
    ap.add_argument("--recovery-overhead-s", type=float, default=0.0)
    ap.add_argument("--server-opt", default="fedavg",
                    choices=["fedavg", "fedadam", "fedyogi"])
    ap.add_argument("--selection", default="adaptive",
                    choices=["adaptive", "random"])
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--render-jobs", default="")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def async_config(args) -> AsyncConfig:
    return AsyncConfig(buffer_size=args.buffer_k,
                       staleness_exponent=args.staleness_exp,
                       max_staleness=args.max_staleness,
                       commit_timeout_s=args.commit_timeout,
                       max_concurrency=args.max_concurrency,
                       commit_chunk=args.commit_chunk)


def fl_config(args) -> FLConfig:
    """The round's FLConfig from parsed launcher flags.  Under
    ``--secure-agg`` every round's commit draws its mask key from the
    orchestrator's generator (``UpdatePipeline.mask_key``).  A checkpoint
    stores no generator state, as in the reference: whatever keys the
    resumed run's re-seeded generator draws, the masks cancel in each
    commit's sum; beyond them the generator feeds only the
    stochastic-rounding and dropout draws."""
    return FLConfig(
        mode=args.mode,
        num_clients=args.clients_per_round, local_steps=args.local_steps,
        client_lr=args.lr, fedprox_mu=args.mu if args.algo == "fedprox" else 0.0,
        secure_agg=args.secure_agg,
        compression=CompressionConfig(quantize_bits=args.quantize_bits,
                                      topk_frac=args.topk_frac,
                                      dropout_frac=args.fed_dropout,
                                      stochastic_rounding=args.stochastic_rounding,
                                      use_fused=args.use_fused))


def build_run(args, fl: FLConfig | None = None):
    """(orchestrator, initial params) of a run from parsed launcher flags;
    ``fl`` replaces the FLConfig the flags give (``fl_config(args)``).
    Under ``--facilities`` the orchestrator is the tier-2
    ``HierarchicalOrchestrator``.  ``--render-jobs`` writes the whole
    fleet's scheduler artifacts here, before any regime is built."""
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    device = resolve_device(args.device)

    fed, model, params, eval_fn = build_task(args.dataset, args.clients_pool,
                                             args.seed, device)
    n_hpc = args.clients_pool // 2
    n_cloud = args.clients_pool - n_hpc
    fl = fl_config(args) if fl is None else fl
    fleet = make_hybrid_fleet(n_hpc, n_cloud, seed=args.seed,
                              data_sizes=[fed.client_size(c)
                                          for c in range(fed.num_clients)])
    if args.render_jobs:
        n = render_jobs(fleet, Path(args.render_jobs))
        print(f"rendered {n} scheduler artifacts -> {args.render_jobs}")

    def build_backend():
        if args.exec_backend != "scheduler":
            return make_backend("closed-form")
        spot_rate = args.spot_preempt_per_min
        if args.spot_preempt_prob and not spot_rate:
            # spot preemptions come from the K8s adapter's reclaim events:
            # map the per-attempt probability onto the equivalent rate
            mean_s = expected_attempt_s(
                fleet, 3e12, payload_bytes(params, fl.compression),
                StragglerPolicy())
            spot_rate = equivalent_preempt_rate_per_min(
                args.spot_preempt_prob, mean_s)
            print(f"scheduler backend: mapped --spot-preempt-prob "
                  f"{args.spot_preempt_prob:g}/attempt onto "
                  f"{spot_rate:.4f} reclaims/min "
                  f"(mean attempt {mean_s:.1f}s)")
        elif args.spot_preempt_prob:
            print("warning: --spot-preempt-per-min overrides the "
                  "--spot-preempt-prob mapping under --exec-backend "
                  "scheduler")
        cloud = args.cloud_nodes or n_cloud
        return make_backend(
            "scheduler",
            slurm=SlurmAdapter(total_nodes=args.hpc_nodes or n_hpc,
                               seed=args.seed),
            k8s=K8sAdapter(initial_nodes=max(1, cloud // 2), max_nodes=cloud,
                           preempt_prob_per_min=spot_rate,
                           seed=args.seed + 1))

    faults = FaultConfig(dropout_prob=args.dropout_prob,
                         spot_preempt_prob=args.spot_preempt_prob,
                         partition_prob=args.partition_prob,
                         recovery_policy=args.recovery_policy,
                         recovery_overhead_s=args.recovery_overhead_s)
    if args.facilities:
        return build_hierarchy(args, fleet, fed, model, fl, faults, eval_fn,
                               device), params
    if args.mode == "async":
        if args.deadline_s or args.fastest_k:
            print("warning: --deadline-s/--fastest-k are barrier-round "
                  "mitigations; the async regime ignores them (staleness "
                  "discounting replaces them)")
        engine = resolve_engine(args.engine, fleet)
        if args.engine == "auto":
            print(f"--engine auto: {len(fleet)} clients -> {engine} "
                  f"(crossover {AUTO_ENGINE_THRESHOLD})")
        orch_cls = {"legacy": AsyncOrchestrator,
                    "batched": BatchedAsyncOrchestrator,
                    "window": EventWindowOrchestrator}[engine]
        engine_kw = ({} if engine == "legacy"
                     else {"train_chunk": args.train_chunk})
        if engine == "window":
            engine_kw["window"] = args.event_window
        orch = orch_cls(
            fleet=fleet, fed_data=fed, loss_fn=model.loss_fn, fl=fl,
            async_cfg=async_config(args),
            server_opt_name=args.server_opt, selection_name=args.selection,
            straggler=StragglerPolicy(), faults=faults,
            batch_size=args.batch_size, flops_per_client_round=3e12,
            eval_fn=eval_fn, eval_every=10,
            checkpoint_mgr=(AsyncCheckpointManager(args.checkpoint_dir)
                            if args.checkpoint_dir else None),
            checkpoint_every=args.checkpoint_every, backend=build_backend(),
            seed=args.seed, device=device, **engine_kw)
        return orch, params
    orch = Orchestrator(
        fleet=fleet, fed_data=fed, loss_fn=model.loss_fn, fl=fl,
        server_opt_name=args.server_opt, selection_name=args.selection,
        straggler=StragglerPolicy(deadline_s=args.deadline_s,
                                  fastest_k=args.fastest_k),
        faults=faults,
        batch_size=args.batch_size, flops_per_client_round=3e12,
        eval_fn=eval_fn, eval_every=10,
        checkpoint_mgr=(CheckpointManager(args.checkpoint_dir)
                        if args.checkpoint_dir else None),
        checkpoint_every=args.checkpoint_every, backend=build_backend(),
        seed=args.seed, device=device)
    return orch, params


def build_hierarchy(args, fleet, fed, model, fl, faults, eval_fn, device):
    """The two-tier run of ``--facilities N``: N facilities over a
    contiguous split of the fleet, each running ``--mode`` for
    ``--local-rounds`` rounds or commits an epoch on its own backend, under
    a tier-2 server over WAN links of ``--wan-bw`` GB/s and
    ``--wan-latency`` s (plus exponential ``--wan-jitter``)."""
    fac_backend = args.facility_backend or args.exec_backend
    subs, _ = split_fleet(fleet, args.facilities)

    def backend_factory(f):
        if fac_backend != "scheduler":
            return make_backend("closed-form")
        n_h = sum(c.site == "hpc" for c in subs[f])
        n_c = max(1, sum(c.site == "cloud" for c in subs[f]))
        return make_backend(
            "scheduler",
            slurm=SlurmAdapter(total_nodes=max(1, args.hpc_nodes or n_h),
                               seed=args.seed + 10 * f),
            k8s=K8sAdapter(initial_nodes=max(1, n_c // 2), max_nodes=n_c,
                           preempt_prob_per_min=args.spot_preempt_per_min,
                           seed=args.seed + 10 * f + 1))

    facs = make_facilities(
        args.facilities, fleet, fed, model.loss_fn, fl,
        local_mode=args.mode, async_cfg=async_config(args),
        local_rounds=args.local_rounds, backend_factory=backend_factory,
        seed=args.seed,
        orch_kw=dict(selection_name=args.selection,
                     straggler=StragglerPolicy(), faults=faults,
                     batch_size=args.batch_size,
                     flops_per_client_round=3e12),
        device=device)
    wan = WANTopology(default=LinkClass("dcn", args.wan_bw, args.wan_latency),
                      jitter_s=args.wan_jitter)
    return HierarchicalOrchestrator(
        facs, fl, inter_mode=args.inter_facility_mode,
        async_cfg=AsyncConfig(buffer_size=args.inter_buffer,
                              staleness_exponent=args.staleness_exp
                              if args.staleness_exp != "adaptive" else 0.5,
                              max_staleness=args.max_staleness),
        wan=wan, server_opt_name=args.server_opt, eval_fn=eval_fn,
        eval_every=1,
        checkpoint_mgr=(AsyncCheckpointManager(args.checkpoint_dir)
                        if args.checkpoint_dir else None),
        checkpoint_every=args.checkpoint_every, seed=args.seed,
        device=device)


def restore(args, orch, params):
    """(params, server state, first round) of the run: under ``--resume``
    with a checkpoint, the latest one's params, server state, round, clock
    and backend state (on the run's device); else the initial params from
    round 0.  A checkpoint written under another ``--exec-backend`` ends
    the run.  An async or hierarchical run restores its whole orchestrator
    (the first round is then unused: it continues from the restored
    commit)."""
    mgr = orch.checkpoint_mgr
    if not (args.resume and mgr.latest_round() is not None):
        return params, None, 0
    if args.facilities:
        params, server_state = mgr.restore_hier(orch, params)
        print(f"resumed hierarchical run at commit {orch.version} "
              f"(sim t={orch.clock:.1f}s, {len(orch._events)} facility "
              f"deltas in flight, {len(orch._buffer)} buffered)")
        return params, server_state, orch.version
    if args.mode == "async":
        params, server_state = mgr.restore_async(orch, params)
        print(f"resumed async run at commit {orch.version} "
              f"(sim t={orch.clock:.1f}s, {len(orch._inflight)} clients "
              f"in flight, {len(orch._buffer)} updates buffered)")
        return params, server_state, orch.version
    server_state = orch.init_server_state(params)
    params, server_state, meta = mgr.restore(params, server_state)
    start_round = meta["round"] + 1
    orch.virtual_clock = meta.get("clock", 0.0)
    if meta.get("exec_backend", "closed-form") != args.exec_backend:
        raise SystemExit(
            f"checkpoint was written under --exec-backend "
            f"{meta.get('exec_backend', 'closed-form')}; resume "
            f"with the same backend")
    if meta.get("backend_state"):
        orch.backend.set_state(meta["backend_state"])
    print(f"resumed sync run at round {start_round} "
          f"(sim t={orch.virtual_clock:.1f}s)")
    return params, server_state, start_round


def summarize(args, orch) -> dict:
    """The run's JSON summary: the reference's keys, plus the device, each
    round's or commit's client loss, and the host seconds of each round
    (sync) or each commit's ``phase_wall`` (async)."""
    logs = orch.logs
    if args.facilities:
        return {
            "dataset": args.dataset, "algo": args.algo, "mode": "hier",
            "device": str(orch.device),
            "local_mode": args.mode,
            "inter_facility_mode": args.inter_facility_mode,
            "facilities": args.facilities,
            "local_rounds": args.local_rounds,
            "exec_backend": args.facility_backend or args.exec_backend,
            "secure_agg": args.secure_agg,
            "commits": orch.version,
            "dropped_stale": orch.dropped_stale,
            "final_eval": logs[-1].eval_metric if logs else None,
            "virtual_time_s": orch.clock,
            "inter_facility_bytes": orch.inter_facility_bytes,
            "total_bytes": orch.total_bytes(),
            "facility_clocks": [f.clock for f in orch.facilities],
            "client_loss": [l.client_loss for l in logs],
        }
    if args.mode == "async":
        return {
            "dataset": args.dataset, "algo": args.algo, "mode": "async",
            "device": str(orch.device),
            "exec_backend": args.exec_backend,
            "engine": resolve_engine(args.engine, orch.fleet),
            "secure_agg": args.secure_agg,
            "mask_overhead_bytes": sum(l.mask_overhead_bytes for l in logs),
            "commits": orch.version,
            "updates_applied": orch.updates_applied,
            "dropped_stale": orch.dropped_stale,
            "recovered_updates": orch.recovered_updates,
            "lost_to_faults": orch.lost_to_faults,
            "final_eval": logs[-1].eval_metric if logs else None,
            "virtual_time_s": orch.clock,
            "updates_per_sim_s": orch.updates_per_sim_second,
            "mean_queue_wait_s": (float(np.mean([l.queue_wait_s
                                                 for l in logs]))
                                  if logs else 0.0),
            "overflow_updates": sum(l.n_overflow for l in logs),
            "recovery_actions": sum(len(l.recovery_actions) for l in logs),
            "timeout_commits": sum(l.timeout_commit for l in logs),
            "client_loss": [l.client_loss for l in logs],
            "phase_wall": [l.phase_wall for l in logs],
        }
    return {
        "dataset": args.dataset, "algo": args.algo, "mode": "sync",
        "device": str(orch.device),
        "exec_backend": args.exec_backend,
        "secure_agg": args.secure_agg,
        "rounds": args.rounds,
        "final_eval": logs[-1].eval_metric if logs else None,
        "virtual_time_s": orch.virtual_clock,
        "mean_bytes_per_client_round":
            orch.comm.mean_bytes_per_client_round(),
        "mean_queue_wait_s": (float(np.mean([l.mean_queue_wait_s
                                             for l in logs]))
                              if logs else 0.0),
        "overflow_clients": sum(l.n_overflow for l in logs),
        "preempted_clients": sum(l.n_preempted for l in logs),
        "client_loss": [l.client_loss for l in logs],
        "round_wall_s": [l.wall_s for l in logs],
    }


def run(args, fl: FLConfig | None = None):
    """Build, render the job artifacts if asked, restore if asked, and run
    ``args.rounds`` rounds.  Returns (orchestrator, final params, server
    state)."""
    orch, params = build_run(args, fl)
    params, server_state, start_round = restore(args, orch, params)
    start = ({} if args.mode == "async" or args.facilities
             else {"start_round": start_round})
    params, server_state = orch.run(params, args.rounds,
                                    server_state=server_state, verbose=True,
                                    **start)
    return orch, params, server_state


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    orch, _, _ = run(args)
    summary = summarize(args, orch)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
