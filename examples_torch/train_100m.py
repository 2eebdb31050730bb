"""End-to-end driver (deliverable b): federated training of a dense
transformer LM for a few hundred rounds (the PyTorch/CUDA port of
``examples/train_100m.py``).

    PYTHONPATH=src python examples_torch/train_100m.py                # full
    PYTHONPATH=src python examples_torch/train_100m.py --ci           # small
    PYTHONPATH=src python examples_torch/train_100m.py --ci --device cpu

The full model is 12 layers, d_model 768, 12/4 heads, d_ff 3072 and a
50,304-token vocabulary (padded to 50,432 in the unembedding): 181,193,472
parameters, not the "~100M" its name says — the paper's §6 "integration
with foundation models" scenario: federated next-token training over
non-IID text shards through the sync Orchestrator with FedProx + quantized
updates.  --ci shrinks the model and steps (4 layers, d_model 256, vocab
512); the full setting is the deployable configuration.  The run is on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core import CompressionConfig, FLConfig
from repro_torch.data import FederatedDataset, partition_by_group, shakespeare_like
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model, param_count
from repro_torch.orchestrator import Orchestrator, StragglerPolicy, make_hybrid_fleet
from repro_torch.pytree import flat_dict


def setting(ci: bool) -> dict:
    """The model config, rounds, sequence length, corpus size and batch of
    the --ci or the full setting."""
    if ci:
        cfg = ModelConfig(name="lm-ci", family="dense", n_layers=4,
                          d_model=256, n_heads=4, kv_heads=2, d_ff=1024,
                          vocab=512, dtype="float32")
        return dict(cfg=cfg, rounds=40, seq=64, n_seqs=4000, batch=8)
    # 12L x d768 x ff3072, 50k vocab
    cfg = ModelConfig(name="lm-100m", family="dense", n_layers=12,
                      d_model=768, n_heads=12, kv_heads=4, d_ff=3072,
                      vocab=50304, dtype="float32")
    return dict(cfg=cfg, rounds=300, seq=128, n_seqs=20000, batch=16)


def build(cfg, seq: int, n_seqs: int, batch: int, device="cuda",
          checkpoint_dir: str = "", checkpoint_every: int = 25,
          stochastic_rounding: bool = True, params=None):
    """(model, orchestrator, initial params in the flat view) of the
    example; ``params`` replaces the seeded initial params."""
    m = build_model(cfg)
    if params is None:
        params = flat_dict(m.init(torch.Generator().manual_seed(0),
                                  device=device))
    n_params = param_count(params)
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params")

    ds = shakespeare_like(n_seqs=n_seqs, seq_len=seq,
                          vocab=min(cfg.vocab, 128), n_speakers=40)
    parts = partition_by_group(ds.y, 20)
    fed = FederatedDataset(ds, parts)
    fleet = make_hybrid_fleet(10, 10, data_sizes=[len(p) for p in parts])

    fl = FLConfig(num_clients=8, local_steps=4, client_lr=0.25,
                  fedprox_mu=0.01,
                  compression=CompressionConfig(
                      quantize_bits=8,
                      stochastic_rounding=stochastic_rounding))
    orch = Orchestrator(
        fleet=fleet, fed_data=fed, loss_fn=m.loss_fn, fl=fl,
        straggler=StragglerPolicy(fastest_k=6),
        batch_size=batch,
        flops_per_client_round=6 * n_params * batch * seq * 4,
        checkpoint_mgr=CheckpointManager(checkpoint_dir)
        if checkpoint_dir else None,
        checkpoint_every=checkpoint_every, device=device)
    return m, orch, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--ci", action="store_true",
                    help="small: ~4.2M params, 40 rounds")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    s = setting(args.ci)
    rounds = args.rounds or s["rounds"]
    _, orch, params = build(s["cfg"], s["seq"], s["n_seqs"], s["batch"],
                            device, args.checkpoint_dir)

    t0 = time.time()
    params, _ = orch.run(params, rounds, verbose=False)
    losses = [l.client_loss for l in orch.logs]
    k = max(len(losses) // 10, 1)
    trace = [round(float(np.mean(losses[i:i + k])), 3)
             for i in range(0, len(losses), k)]
    print(f"loss trace (x{k}-round means): {trace}")
    print(f"{rounds} rounds in {time.time()-t0:.0f}s wall; "
          f"virtual cluster time {orch.virtual_clock:.0f}s; "
          f"payload {orch.comm.mean_bytes_per_client_round()/1e6:.1f} "
          f"MB/client/round")
    assert losses[-1] < losses[0], "loss must decrease"
    print("OK")
    return orch, params


if __name__ == "__main__":
    main()
