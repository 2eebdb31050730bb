"""Federated fine-tuning of an assigned LLM architecture (paper §6:
"Integration with foundation models"); the PyTorch/CUDA port of
``examples/federated_llm_finetune.py``.

    PYTHONPATH=src python examples_torch/federated_llm_finetune.py --arch gemma-2b
    PYTHONPATH=src python examples_torch/federated_llm_finetune.py --device cpu

Runs the FL round step directly (no orchestrator) on a REDUCED variant of an
assigned arch, with sequential client execution.  Shows: FedProx local
training of a transformer, per-round compressed-delta aggregation, and
serve-after-train (prefill+decode with the trained params).  Tokens,
patches and the prompt are drawn from CPU ``torch.Generator``s seeded as
the reference seeds its keys, so the card and the CPU see the same inputs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import CompressionConfig, FLConfig, build_fl_round_step
from repro_torch.core.compression import payload_bytes
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model, token_shape
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict, nest


def client_batches(cfg, r: int, C: int, H: int, b: int = 4,
                   S: int = 32) -> dict:
    """Round ``r``'s non-IID client corpora on the CPU: each client's
    tokens drawn from its own range; the VLM's patches and the audio
    family's codebook tokens as the reference routes them."""
    g = torch.Generator().manual_seed(r)
    toks = []
    for c in range(C):
        lo = (c * cfg.vocab) // (2 * C)
        hi = lo + cfg.vocab // 2
        toks.append(torch.randint(lo, hi, (H, b, S + 1), generator=g,
                                  dtype=torch.int32))
    t = torch.stack(toks)
    leaves = {"tokens": t[..., :-1], "targets": t[..., 1:]}
    if cfg.cross_attn_every:
        leaves["patches"] = torch.randn((C, H, b, cfg.n_patches, cfg.d_model),
                                        generator=g)
    if cfg.n_codebooks:
        t4 = torch.randint(0, cfg.vocab, (C, H, b, S + 1, cfg.n_codebooks),
                           generator=g, dtype=torch.int32)
        leaves = {"tokens": t4[..., :-1, :], "targets": t4[..., 1:, :]}
    return leaves


def serve_inputs(cfg, seed: int = 0) -> tuple:
    """(prompt [2, 8] ([2, 8, n_cb]) token ids, the VLM's patches [2,
    n_patches, D] or None) on the CPU."""
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, token_shape(cfg, 2, 8), generator=g,
                           dtype=torch.int32)
    patches = (torch.randn((2, cfg.n_patches, cfg.d_model), generator=g)
               if cfg.cross_attn_every else None)
    return prompt, patches


def run(arch: str = "gemma-2b", rounds: int = 6, clients: int = 4,
        local_steps: int = 2, device="cuda",
        stochastic_rounding: bool = True, params=None, batches=None,
        serve=None) -> dict:
    """The example's rounds, then one prefill and one decode step with
    the trained params.  ``params`` (the flat view), ``batches(r)`` and
    ``serve`` ((prompt, patches)) replace the seeded draws.  Returns
    {"cfg", "params" (flat), "metrics" (per round), "prefill_logits",
    "decode_logits"}."""
    cfg = reduced(get_config(arch))
    m = build_model(cfg)
    if params is None:
        params = flat_dict(m.init(torch.Generator().manual_seed(0),
                                  device=device))

    C, H, b, S = clients, local_steps, 4, 32
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.1,
                  fedprox_mu=0.01, client_exec="sequential",
                  compression=CompressionConfig(
                      quantize_bits=8, topk_frac=0.25,
                      stochastic_rounding=stochastic_rounding))
    step = build_fl_round_step(m.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    print(f"arch={cfg.name}; uncompressed update "
          f"{payload_bytes(params, None)/1e6:.1f} MB -> compressed "
          f"{payload_bytes(params, fl.compression)/1e6:.1f} MB/client/round")
    batches = batches or (lambda r: client_batches(cfg, r, C, H, b, S))

    weights = torch.ones(C, device=device)
    state = ()
    logs = []
    for r in range(rounds):
        mask = torch.tensor(np.random.default_rng(r).random(C) > 0.2,
                            dtype=torch.float32, device=device)  # 20% dropouts
        batch = {k: v.to(device) for k, v in batches(r).items()}
        params, state, metrics = step(params, state, batch, weights, mask,
                                      torch.Generator().manual_seed(r))
        logs.append({k: float(v) for k, v in metrics.items()})
        print(f"round {r}: loss {logs[-1]['client_loss']:.4f} "
              f"delta {logs[-1]['delta_norm']:.3f} "
              f"participation {logs[-1]['participation']:.2f}")

    # serve with the fine-tuned weights
    prompt, patches = serve or serve_inputs(cfg)
    batch = {"tokens": prompt.to(device)}
    if patches is not None:
        patches = patches.to(device)
        batch["patches"] = patches
    nested = nest(params)
    with torch.no_grad():
        prefill_logits, st = m.prefill(nested, batch, s_max=16)
        tok = prefill_logits.argmax(-1).to(torch.int32)
        logits, st = m.decode_step(nested, st, tok, 8, patches)
    print("served logits:", tuple(logits.shape), "finite:",
          bool(torch.isfinite(logits).all()))
    return dict(cfg=cfg, params=params, metrics=logs,
                prefill_logits=prefill_logits, decode_logits=logits)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return run(args.arch, args.rounds, args.clients, args.local_steps, device)


if __name__ == "__main__":
    main()
