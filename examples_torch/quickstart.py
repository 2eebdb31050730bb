"""Quickstart: federated learning on non-IID synthetic CIFAR-10 (the
PyTorch/CUDA port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples_torch/quickstart.py               # cuda
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Builds a 20-client hybrid HPC+cloud fleet, partitions data pathologically
(2 classes per client), and runs FedProx with 8-bit quantized updates +
fastest-k straggler mitigation — the paper's §5.1 configuration, scaled
down.  The run is on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import CompressionConfig, FLConfig
from repro_torch.data import FederatedDataset, cifar10_like, partition_by_class
from repro_torch.launch.train import resolve_device
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.orchestrator import Orchestrator, StragglerPolicy, make_hybrid_fleet
from repro_torch.orchestrator.server import to_device


def run(device="cuda", rounds: int = 12, stochastic_rounding: bool = True,
        params=None):
    """The example's run: (orchestrator, final params).  ``params``
    replaces the seeded initial params (a dict on ``device``)."""
    # 1. non-IID federated data (each client sees only 2 of 10 classes)
    data = cifar10_like(n=4000)
    parts = partition_by_class(data.y, n_clients=20, classes_per_client=2)
    fed = FederatedDataset(data, parts)

    # 2. model + fleet (10 HPC nodes + 10 cloud VMs, calibrated profiles)
    model = CNN(CNNConfig("quickstart-cnn", (32, 32, 3), 10, channels=(8, 16),
                          dense=64))
    if params is None:
        params = model.init(torch.Generator().manual_seed(0), device=device)
    fleet = make_hybrid_fleet(10, 10, data_sizes=[len(p) for p in parts])

    # 3. FedProx + compressed updates + fastest-k partial aggregation
    fl = FLConfig(num_clients=8, local_steps=3, client_lr=0.08,
                  fedprox_mu=0.02,
                  compression=CompressionConfig(
                      quantize_bits=8, topk_frac=0.25,
                      stochastic_rounding=stochastic_rounding))
    eval_batch = to_device(fed.eval_batch(512), device)

    @torch.no_grad()
    def acc(p):
        return model.accuracy(p, eval_batch)

    orch = Orchestrator(
        fleet=fleet, fed_data=fed, loss_fn=model.loss_fn, fl=fl,
        straggler=StragglerPolicy(fastest_k=6),
        batch_size=16, flops_per_client_round=1e12,
        eval_fn=acc, eval_every=3, device=device)
    params, _ = orch.run(params, num_rounds=rounds, verbose=True)
    return orch, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    orch, params = run(device)
    print(f"\nfinal accuracy: {orch.logs[-1].eval_metric:.3f}")
    print(f"simulated wall time: {orch.virtual_clock:.1f}s; "
          f"mean update payload: "
          f"{orch.comm.mean_bytes_per_client_round()/1e6:.2f} MB/client/round")
    return orch, params


if __name__ == "__main__":
    main()
