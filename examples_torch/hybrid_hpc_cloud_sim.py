"""Hybrid HPC+cloud deployment simulation: the full systems story (the
PyTorch/CUDA port of ``examples/hybrid_hpc_cloud_sim.py``).

    PYTHONPATH=src python examples_torch/hybrid_hpc_cloud_sim.py     # cuda
    PYTHONPATH=src python examples_torch/hybrid_hpc_cloud_sim.py --device cpu

Demonstrates every §3/§4 component working together:
  * scheduler adapters render + "execute" real sbatch scripts and K8s pod
    manifests against simulated SLURM/K8s backends (queueing, autoscaling,
    spot preemption),
  * adaptive selection reacts to client history,
  * deadline-based cutoff + 20% client dropouts,
  * a cloud-site network partition mid-training,
  * per-link byte/time accounting (Infiniband vs cloud uplink).

Each job's command runs the port's worker, ``python -m repro_torch.worker
--client-id N``: the worker's own flag (the reference's script names
``--cid``, a flag neither worker has).

Execution backends
------------------
Client round times come from a pluggable ``ExecutionBackend``
(``repro_torch.exec``).  The default ``closed-form`` backend prices compute
+ transfer + lognormal contention analytically.  Pass ``--exec-backend
scheduler`` to ``repro_torch.launch.train`` (or hand the orchestrator a
``SchedulerBackend``, as the last section below does) and every client
attempt is instead dispatched as a real ``JobSpec`` through the
``HybridAdapter``: round durations then include SLURM queue waits, elastic
HPC->cloud overflow, K8s autoscaling, and spot preemptions that originate
from the K8s adapter's reclaim events.  Queue-wait and placement accounting
lands in ``RoundLog``/``CommitLog``, e.g.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --mode async --exec-backend scheduler --hpc-nodes 8 \\
        --spot-preempt-per-min 2 --recovery-policy adaptive \\
        --checkpoint-dir ckpts/sched --resume

resumes bit-identically: the pool (queues, in-flight jobs, autoscale
level, adapter RNG) is checkpointed with the orchestrator.
"""
from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch

from repro_torch.core import CompressionConfig, FLConfig
from repro_torch.data import FederatedDataset, medmnist_like, partition_dirichlet
from repro_torch.exec import SchedulerBackend
from repro_torch.launch.train import resolve_device
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.orchestrator import (FaultConfig, Orchestrator, StragglerPolicy,
                                      make_hybrid_fleet)
from repro_torch.orchestrator.server import to_device
from repro_torch.sched import HybridAdapter, JobSpec, K8sAdapter, SlurmAdapter


def schedule() -> dict:
    """One job per fleet node through the hybrid adapter, advanced 120
    sim-seconds: {"handles", "states"}."""
    print("== scheduler adapter: submitting one job per fleet node ==")
    hy = HybridAdapter(slurm=SlurmAdapter(total_nodes=8),
                       k8s=K8sAdapter(initial_nodes=4, max_nodes=16,
                                      preempt_prob_per_min=2.0))
    fleet = make_hybrid_fleet(8, 8, seed=1)
    handles = []
    for c in fleet:
        h = hy.submit(JobSpec(
            name=f"fl-client-{c.cid}",
            command=f"python -m repro_torch.worker --client-id {c.cid}",
            gpus_per_node=1 if c.profile.compute_tflops > 4 else 0,
            site=c.site, preemptible=c.profile.spot))
        hy.set_workload(h.job_id, np.random.default_rng(c.cid).uniform(20, 90))
        handles.append(h)
    print("sample sbatch script:\n" + handles[0].artifact[:260] + "...\n")
    for _ in range(12):
        hy.advance(10.0)
    states = [hy.poll(h.job_id).value for h in handles]
    print("job states after 120 sim-seconds:", dict(Counter(states)))
    return dict(handles=handles, states=states)


def train(device="cuda", rounds: int = 12, sched_rounds: int = 4,
          stochastic_rounding: bool = True, params=None) -> dict:
    """The training run with faults and a deadline cutoff, then the
    scheduler-backed one: {"orch", "fleet", "params", "sched_orch",
    "sched_params"}; ``params`` replaces the seeded initial params of
    both runs."""
    print("\n== federated training with faults + deadline cutoff ==")
    data = medmnist_like(n=3000)
    parts = partition_dirichlet(data.y, 16, alpha=0.3)
    fed = FederatedDataset(data, parts)
    model = CNN(CNNConfig("med-cnn", (28, 28, 1), 9, channels=(8, 16),
                          dense=64))
    init = params
    if params is None:
        params = model.init(torch.Generator().manual_seed(0), device=device)
    fleet = make_hybrid_fleet(8, 8, data_sizes=[len(p) for p in parts])
    eval_batch = to_device(fed.eval_batch(512), device)

    @torch.no_grad()
    def acc(p):
        return model.accuracy(p, eval_batch)

    comp = CompressionConfig(quantize_bits=8,
                             stochastic_rounding=stochastic_rounding)
    orch = Orchestrator(
        fleet=fleet, fed_data=fed, loss_fn=model.loss_fn,
        fl=FLConfig(num_clients=6, local_steps=2, client_lr=0.08,
                    fedprox_mu=0.02, compression=comp),
        straggler=StragglerPolicy(deadline_s=30.0, contention_sigma=0.4),
        faults=FaultConfig(dropout_prob=0.2, spot_preempt_prob=0.2,
                           partition_prob=0.1, partition_len=2),
        batch_size=16, flops_per_client_round=2e12,
        eval_fn=acc, eval_every=4, device=device)
    params, _ = orch.run(params, rounds, verbose=True)

    print("\nper-site communication:")
    for site in ("hpc", "cloud"):
        cids = {c.cid for c in fleet if c.site == site}
        recs = [r for r in orch.comm.records
                if r.cid in cids and r.direction == "up"]
        if recs:
            print(f"  {site:6s}: {sum(r.nbytes for r in recs)/1e6:8.1f} MB "
                  f"up, mean link time "
                  f"{np.mean([r.seconds for r in recs])*1e3:6.1f} ms")
    print(f"\nfinal accuracy {orch.logs[-1].eval_metric:.3f} "
          f"after {orch.virtual_clock:.0f} simulated seconds")

    # --------------------------------------------- scheduler-backed timing
    print("\n== same rounds, scheduler-backed execution (queue wait counts) ==")
    sched_orch = Orchestrator(
        fleet=make_hybrid_fleet(8, 8, data_sizes=[len(p) for p in parts]),
        fed_data=fed, loss_fn=model.loss_fn,
        fl=FLConfig(num_clients=6, local_steps=2, client_lr=0.08,
                    compression=comp),
        straggler=StragglerPolicy(contention_sigma=0.4),
        batch_size=16, flops_per_client_round=2e12,
        backend=SchedulerBackend(HybridAdapter(
            slurm=SlurmAdapter(total_nodes=2),
            k8s=K8sAdapter(initial_nodes=2, max_nodes=3,
                           preempt_prob_per_min=2.0))),
        device=device)
    sched_params = init if init is not None else model.init(
        torch.Generator().manual_seed(0), device=device)
    sched_params, _ = sched_orch.run(sched_params, sched_rounds, verbose=True)
    for lg in sched_orch.logs:
        print(f"  round {lg.rnd}: dur={lg.duration_s:6.1f}s "
              f"queue_wait={lg.mean_queue_wait_s:5.1f}s "
              f"overflowed={lg.n_overflow} preempted={lg.n_preempted}")
    return dict(orch=orch, fleet=fleet, params=params, sched_orch=sched_orch,
                sched_params=sched_params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return dict(schedule(), **train(device))


if __name__ == "__main__":
    main()
