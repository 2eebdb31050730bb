"""Federated inference launcher, mirroring ``repro/launch/serve.py``: serve a
model with batched autoregressive decoding (prefill, then one decode step
per generated token).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --batch 4 --prompt-len 16 --gen 8

Same flags as the reference plus ``--device`` (default ``cuda``; the
launcher raises when CUDA is absent and ``--device cpu`` was not given).
As in the reference, ``--reduced`` is ``store_true`` with ``default=True``,
so the command line always serves the reduced config; a full-width run
calls ``build`` and ``run`` itself.  Every family serves: for the audio
family (``--arch musicgen-medium``) the prompt is ``(B, S0, n_cb)`` tokens,
each step samples one token per codebook and the summary prints codebook
0's ids, as the reference does; for the VLM (``--arch
llama-3.2-vision-90b``) ``main`` draws ``patches`` ``(B, n_patches, D)``
in the model dtype from the seeded generator, which prefill projects into
the cross-attention caches.

Under a mesh of processes (``launch.spmd.run``, no launcher flag, as in
the reference) each rank calls ``build(..., shard=True)`` (or holds its
params' shares over ``data`` and ``model``, ``specs.shard_params``) and
``run`` with the whole prompt: the rank serves its process's share of the
batch, each layer's weights gathered over ``data`` as it runs (the MoE's
experts left cut in decode), its decode state cut as its specs say, and
the logits are gathered whole each step, so every rank samples the same
tokens from its own generator of the same seed::

    def serve_rank(mesh, cfg):
        model, params = serve.build(cfg, mesh.device, seed=0, shard=True)
        g = torch.Generator(mesh.device).manual_seed(0)
        prompt, patches = serve.draw_inputs(cfg, 4, 16, g, model.dtype)
        return serve.run(model, params, prompt, 8, 0.0, g, patches).ids

    spmd.run(serve_rank, (cfg,), sizes=(1, 2, 2), device="cpu")
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import specs
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model, token_shape
from repro_torch.models import sharding as sh


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def build(cfg, device, seed: int, shard: bool = False):
    """(model, params): random params drawn on ``device`` from a generator
    seeded with ``seed``.  With ``shard``, under a mesh, each leaf is drawn
    whole and only this rank's share over ``data`` and ``model`` kept
    (``specs.shard_leaf``), leaf by leaf: the no-mesh model's bits, cut as
    ``specs.shard_params`` cuts them."""
    device = torch.device(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(seed), device,
                        keep=specs.shard_leaf if shard else None)
    return model, params


@dataclass
class ServeResult:
    ids: np.ndarray          # [B, gen] ([B, gen, n_cb]) generated ids (a
    #                          meta tensor of their shape on meta params)
    logits: list             # [B(, n_cb), vocab] logits: the prefill's and
    #                          every decode step (gen + 1 entries)
    prefill_s: float         # wall time of the prefill, synchronised
    decode_s: float          # wall time of the gen decode steps
    state: dict              # the decode state after the last step (under
    #                          a mesh, this rank's share)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(logits, temperature: float, generator):
    """One token per row of ``logits`` [..., V] (``[B, V]``, or ``[B, n_cb,
    V]`` with codebooks): ``torch.multinomial`` takes 1-D or 2-D input, so
    the leading dims are flattened and restored."""
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator)[:, 0].reshape(
            probs.shape[:-1])
    return logits.argmax(-1)


def run(model, params, prompt, gen: int, temperature: float,
        generator, patches=None, forced=None) -> ServeResult:
    """Prefill ``prompt`` [B, S0] (token ids; [B, S0, n_cb] with codebooks)
    and, for the VLM, ``patches`` [B, n_patches, D], then ``gen`` decode
    steps, each sampling one token (one per codebook) from the last logits
    (``temperature`` 0 is argmax; else ``torch.multinomial`` on
    ``softmax(logits / T)`` with ``generator``) and feeding it back at the
    next position; ``forced`` ([B, gen] ids), where given, is fed in their
    place (teacher forcing: one run held against another on the same
    tokens).

    Under a mesh ``params`` are this rank's shares, and ``prompt``,
    ``patches`` and ``forced`` are whole: the rank serves its process's
    rows (``sharding.local_share`` over the axes that split the batch),
    and the logits are gathered whole over those axes each step, so the
    result's ids and logits are the whole batch's on every rank."""
    device = params["embed"].device
    axes = sh.batch_split_axes()

    def mine(t):
        return sh.local_share(t, axes, 0, "the served batch")

    prompt = torch.as_tensor(prompt).to(device=device, dtype=torch.long)
    S0 = prompt.shape[1]
    s_max = S0 + gen
    batch = {"tokens": mine(prompt)}
    if patches is not None:
        patches = mine(torch.as_tensor(patches).to(device))
        batch["patches"] = patches
    if forced is not None:
        forced = torch.as_tensor(forced).to(device=device, dtype=torch.long)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, state = model.prefill(params, batch, s_max)
        logits = sh.all_gather(logits, axes, 0)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        out, toks = [logits], []
        t0 = time.perf_counter()
        for t in range(gen):
            tok = (forced[:, t] if forced is not None
                   else _sample(logits, temperature, generator))
            toks.append(tok)
            logits, state = model.decode_step(params, state, mine(tok),
                                              S0 + t, patches)
            logits = sh.all_gather(logits, axes, 0)
            out.append(logits)
        _sync(device)
        t_decode = time.perf_counter() - t0
    ids = torch.stack(toks, dim=1)
    if not ids.is_meta:                     # the dry run's shapes stay
        ids = ids.cpu().numpy()
    return ServeResult(ids, out, t_prefill, t_decode, state)


def draw_inputs(cfg, B: int, S0: int, generator, dtype):
    """A random prompt ``token_shape(cfg, B, S0)`` and, for the VLM,
    ``patches`` [B, n_patches, D] in ``dtype`` (else None), both drawn from
    ``generator`` on its device."""
    dev = generator.device
    prompt = torch.randint(0, cfg.vocab, token_shape(cfg, B, S0),
                           generator=generator, device=dev)
    patches = None
    if cfg.cross_attn_every:
        patches = torch.randn((B, cfg.n_patches, cfg.d_model),
                              generator=generator, device=dev, dtype=dtype)
    return prompt, patches


def main(argv=None) -> ServeResult:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model, params = build(cfg, device, args.seed)
    B, S0, T = args.batch, args.prompt_len, args.gen
    generator = torch.Generator(device).manual_seed(args.seed)
    prompt, patches = draw_inputs(cfg, B, S0, generator, model.dtype)
    res = run(model, params, prompt, T, args.temperature, generator, patches)
    print(f"arch={cfg.name} prefill({B}x{S0})={res.prefill_s*1e3:.1f}ms "
          f"decode {T} steps={res.decode_s*1e3:.1f}ms "
          f"({res.decode_s/max(T, 1)*1e3:.1f} ms/tok)")
    print("generated token ids:\n",
          res.ids[..., 0] if res.ids.ndim == 3 else res.ids)
    return res


if __name__ == "__main__":
    main()
