"""Federated client worker, mirroring ``repro/worker.py``: the process a
scheduler job launches (``python -m repro_torch.worker``, as rendered into
the sbatch scripts and pod manifests by ``launch/train.py --render-jobs``).

File-based transport: the orchestrator drops ``global_round_NNNN.bin`` into
``--workdir``; the worker trains locally on its private shard and writes
``update_NNNN_client_CCC.bin`` (the delta, in the checkpoint format of
``comm/payload.py``) and its ``.json`` metadata back.  ``--once`` runs a
single round and exits (spot-instance friendly).  It trains on ``--device``
(default ``cuda``; the CPU must be asked for), one client at a time
(``build_local_train(..., stacked=False)``), on the CIFAR CNN as the
reference does, so the files it reads and writes are the reference's.

    PYTHONPATH=src python -m repro_torch.worker --client-id 3 \\
        --workdir artifacts/worker --once
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.core import FLConfig
from repro_torch.core.round import build_local_train
from repro_torch.data import FederatedDataset, cifar10_like, partition_by_class
from repro_torch.launch.train import resolve_device
from repro_torch.models.cnn import CIFAR_CNN, CNN
from repro_torch.optim import get_client_optimizer
from repro_torch.orchestrator.server import to_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the local training (default cuda; "
                         "cpu must be asked for)")
    ap.add_argument("--client-id", type=int, required=True)
    ap.add_argument("--workdir", default="artifacts/worker")
    ap.add_argument("--n-clients", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--mu", type=float, default=0.0)
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--poll-s", type=float, default=1.0)
    ap.add_argument("--timeout-s", type=float, default=30.0)
    return ap


def main(argv=None) -> list:
    """Serve rounds until ``--timeout-s`` passes (or one, with ``--once``).
    Returns the update files written."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)

    # this client's private shard (never leaves the process)
    ds = cifar10_like(n=4000)
    parts = partition_by_class(ds.y, args.n_clients, 2)
    fed = FederatedDataset(ds, parts)
    model = CNN(CIFAR_CNN)
    params_like = model.init(torch.Generator().manual_seed(0), device=device)

    fl = FLConfig(num_clients=1, local_steps=args.local_steps,
                  client_lr=args.lr, fedprox_mu=args.mu)
    local_train = build_local_train(model.loss_fn,
                                    get_client_optimizer("sgd"), fl)

    done, written = set(), []
    deadline = time.time() + args.timeout_s
    while time.time() < deadline:
        rounds = sorted(wd.glob("global_round_*.bin"))
        todo = [p for p in rounds if p.name not in done]
        if not todo:
            time.sleep(args.poll_s)
            continue
        gpath = todo[-1]
        rnd = int(gpath.stem.split("_")[-1])
        params = load_pytree(gpath, params_like)
        batch = fed.sample_round([args.client_id], args.local_steps,
                                 args.batch_size)
        batch = to_device({k: v[0] for k, v in batch.items()}, device)
        delta, loss = local_train(params, batch)
        stem = f"update_{rnd:04d}_client_{args.client_id:03d}"
        out = wd / f"{stem}.bin"
        save_pytree(out, delta)
        (wd / f"{stem}.json").write_text(
            json.dumps({"loss": float(loss),
                        "data_size": fed.client_size(args.client_id)}))
        print(f"worker {args.client_id}: round {rnd} loss {float(loss):.4f} "
              f"-> {out.name}")
        written.append(out)
        done.add(gpath.name)
        if args.once:
            break
    return written


if __name__ == "__main__":
    main()
