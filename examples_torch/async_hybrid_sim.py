"""Asynchronous hybrid HPC+cloud scenario (the PyTorch/CUDA port of
``examples/async_hybrid_sim.py``): FedBuff-style buffered commits on a
fleet where fast Infiniband GPU nodes coexist with slow, flaky cloud spot
VMs.

    PYTHONPATH=src python examples_torch/async_hybrid_sim.py         # cuda
    PYTHONPATH=src python examples_torch/async_hybrid_sim.py --device cpu

What it shows:
  * the event-driven AsyncOrchestrator keeping every node busy — no round
    barrier, commits every K=4 arrivals with a 60 sim-second timeout so a
    quiet buffer still flushes,
  * staleness-discounted aggregation (slow nodes land many commits late;
    their updates are down-weighted 1/(1+s)^0.5, never discarded unless
    staler than 30 commits),
  * spot preemptions + dropouts folding into the same buffer semantics —
    preempted clients recover per FaultConfig.recovery_policy ("resume"
    here: they re-enqueue from their last completed local step instead of
    losing the attempt),
  * a head-to-head against the synchronous barrier loop on the SAME fleet
    and simulated-time budget.

Killing and resuming an async run
---------------------------------
The async regime is crash-safe end to end: with a checkpoint dir the
orchestrator snapshots its FULL state (global params, server opt state,
pending-update buffer, in-flight event heap, commit log, every RNG stream)
each --checkpoint-every commits and at exit, and --resume replays the exact
trajectory the uninterrupted run would have taken (bit-identical params and
commit log — pinned by tests/test_torch_async_resume.py).  Try it:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --mode async --dataset medmnist --rounds 40 \
        --buffer-k 4 --commit-timeout 60 --max-concurrency 12 \
        --dropout-prob 0.1 --spot-preempt-prob 0.2 --recovery-policy resume \
        --checkpoint-dir ckpts/async_run --checkpoint-every 5
    # kill it at any point (Ctrl-C), then:
    PYTHONPATH=src python -m repro_torch.launch.train \
        --mode async --dataset medmnist --rounds 40 \
        --buffer-k 4 --commit-timeout 60 --max-concurrency 12 \
        --dropout-prob 0.1 --spot-preempt-prob 0.2 --recovery-policy resume \
        --checkpoint-dir ckpts/async_run --checkpoint-every 5 --resume
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import AsyncConfig, CompressionConfig, FLConfig
from repro_torch.data import FederatedDataset, medmnist_like, partition_dirichlet
from repro_torch.launch.train import resolve_device
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.orchestrator import (AsyncOrchestrator, FaultConfig, Orchestrator,
                                      StragglerPolicy, make_hybrid_fleet)
from repro_torch.orchestrator.server import to_device

SEED, N = 0, 16


def run(device="cuda", commits: int = 40, stochastic_rounding: bool = True,
        params=None) -> dict:
    """The example's two runs: the async orchestrator for ``commits``
    commits, then the sync one on the same fleet until its clock passes
    the async run's.  Returns {"anc", "sync", "rounds", "p_async",
    "p_sync", "acc"}; ``params`` replaces the seeded initial params."""
    data = medmnist_like(n=3000, seed=SEED)
    parts = partition_dirichlet(data.y, N, alpha=0.3, seed=SEED)
    model = CNN(CNNConfig("med-cnn", (28, 28, 1), 9, channels=(8, 16),
                          dense=64))
    if params is None:
        params = model.init(torch.Generator().manual_seed(SEED),
                            device=device)
    eval_batch = to_device(FederatedDataset(data, parts).eval_batch(512),
                           device)

    @torch.no_grad()
    def acc(p):
        return model.accuracy(p, eval_batch)

    comp = CompressionConfig(quantize_bits=8,
                             stochastic_rounding=stochastic_rounding)
    fl = FLConfig(mode="async", num_clients=8, local_steps=2, client_lr=0.08,
                  fedprox_mu=0.02, compression=comp)
    straggler = StragglerPolicy(contention_sigma=0.6)
    faults = FaultConfig(dropout_prob=0.1, spot_preempt_prob=0.2,
                         recovery_policy="resume")

    def fresh_fleet():
        return make_hybrid_fleet(N // 2, N - N // 2, seed=SEED,
                                 data_sizes=[len(p) for p in parts])

    # -------------------------------------------------------- async run
    print("== async buffered training (K=4, T=60s, staleness^-0.5) ==")
    anc = AsyncOrchestrator(
        fleet=fresh_fleet(), fed_data=FederatedDataset(data, parts, seed=SEED),
        loss_fn=model.loss_fn, fl=fl,
        async_cfg=AsyncConfig(buffer_size=4, staleness_exponent=0.5,
                              max_staleness=30, commit_timeout_s=60.0,
                              max_concurrency=12),
        straggler=straggler, faults=faults,
        batch_size=16, flops_per_client_round=2e12,
        eval_fn=acc, eval_every=8, seed=SEED, device=device)
    p_async, _ = anc.run(params, num_commits=commits, verbose=True)

    timeouts = sum(l.timeout_commit for l in anc.logs)
    print(f"\n{anc.version} commits ({timeouts} by timeout), "
          f"{anc.updates_applied} updates applied, "
          f"{anc.dropped_stale} dropped as too stale, "
          f"mean staleness {np.mean([l.mean_staleness for l in anc.logs]):.2f}, "
          f"in {anc.clock:.0f} simulated seconds")
    print(f"fault recovery (policy={faults.recovery_policy}): "
          f"{anc.recovered_updates} preempted attempts recovered "
          f"(+{anc.recovery_time_total / max(anc.recovered_updates, 1):.1f}s "
          f"mean delay), {anc.lost_to_faults} lost")

    # --------------------------------------- sync baseline, same sim budget
    print("\n== sync barrier baseline on the same fleet & time budget ==")
    sync = Orchestrator(
        fleet=fresh_fleet(), fed_data=FederatedDataset(data, parts, seed=SEED),
        loss_fn=model.loss_fn,
        fl=FLConfig(num_clients=8, local_steps=2, client_lr=0.08,
                    fedprox_mu=0.02, compression=comp),
        straggler=straggler, faults=faults,
        batch_size=16, flops_per_client_round=2e12,
        eval_fn=acc, eval_every=4, seed=SEED, device=device)
    rounds = 0
    server_state = sync.init_server_state(params)
    p_sync = params
    while sync.virtual_clock < anc.clock:
        p_sync, server_state, log = sync.run_round(rounds, p_sync,
                                                   server_state)
        rounds += 1
    return dict(anc=anc, sync=sync, rounds=rounds, p_async=p_async,
                p_sync=p_sync, acc=acc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out = run(device)
    anc, sync, acc = out["anc"], out["sync"], out["acc"]
    sync_updates = sum(l.participated for l in sync.logs)
    print(f"{out['rounds']} barrier rounds, {sync_updates} updates in "
          f"{sync.virtual_clock:.0f} simulated seconds")
    print(f"\nupdate throughput: async {anc.updates_per_sim_second:.3f}/s vs "
          f"sync {sync_updates / sync.virtual_clock:.3f}/s "
          f"({anc.updates_per_sim_second / (sync_updates / sync.virtual_clock):.1f}x)")
    print(f"accuracy at equal sim time: async "
          f"{float(acc(out['p_async'])):.3f} vs sync "
          f"{float(acc(out['p_sync'])):.3f}")
    return out


if __name__ == "__main__":
    main()
