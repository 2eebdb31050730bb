"""The xLSTM family's bfloat16 decode against teacher-forced prefill, in both
packages with the same weights: ``tests/test_decode_consistency.py``'s
check, run in bfloat16 at the whole model's 12 blocks ([mlstm, slstm] x 6)
and reduced width (``reduced(xlstm-125m, n_layers=12)``, d_model 256), on
the weights and tokens of several seeds.

bfloat16 keeps 8 bits of mantissa, and decode and prefill round in
different places (one recurrent step against a chunkwise scan), so the gap
grows through 12 recurrent blocks in the reference as in the port.  The
port's largest gap over the decoded steps is held to ``FACTOR`` times the
reference's, seed by seed.

Run as a script, the same comparison prints both packages' gaps per seed,
at this size or (``--whole``) at xlstm-125m's whole width (d_model 768) and
the serving shape of ``chip_smoke.py``'s xLSTM phase (batch 2, a 512-token
prompt, 16 decoded tokens, compared at the first and the last).
``--port-weights`` gives both packages the port's own init instead (drawn
on the CPU from the seed, as ``chip_compare.py --xlstm-gaps`` draws them
for the card)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_xlstm_bf16.py \\
        [--whole] [--port-weights] [--seeds 0 1 2]
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild
from repro_torch.configs import get_config, reduced
from repro_torch.convert import tree_from_jax, tree_to_numpy
from repro_torch.models import build_model

ARCH, BLOCKS = "xlstm-125m", 12
B, S0, T = 1, 8, 8
FACTOR = 2.0
SEEDS = (0, 1, 2)


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def reference_gaps(jm, jp, toks, s0, at):
    """Decode steps ``at`` (indices after the ``s0``-token prompt) against
    the teacher-forced prefill of the same tokens."""
    s_max = toks.shape[1]

    def pf(k):
        return jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :k])},
                          s_max=s_max)

    lg, state = pf(s0)
    gaps = []
    for t in range(max(at) + 1):
        lg, state = jm.decode_step(jp, state, jnp.asarray(toks[:, s0 + t]),
                                   jnp.int32(s0 + t), None)
        if t in at:
            gaps.append(rel_gap(lg, pf(s0 + t + 1)[0]))
    return gaps


def port_gaps(tm, tp, toks, s0, at):
    s_max = toks.shape[1]
    toks = torch.from_numpy(toks).long()
    gaps = []
    with torch.inference_mode():
        lg, state = tm.prefill(tp, {"tokens": toks[:, :s0]}, s_max)
        for t in range(max(at) + 1):
            lg, state = tm.decode_step(tp, state, toks[:, s0 + t], s0 + t)
            if t in at:
                want, _ = tm.prefill(tp, {"tokens": toks[:, :s0 + t + 1]},
                                     s_max)
                gaps.append(rel_gap(lg.float(), want.float()))
    return gaps


def both_gaps(seed, whole=False, batch=B, s0=S0, gen=T, at=None,
              port_weights=False):
    """(reference gaps, port gaps) on the bf16 weights of ``seed`` (the
    reference's init, or with ``port_weights`` the port's, drawn on the
    CPU) and the tokens of ``seed + 1``, at the decode steps ``at``
    (default: all)."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if not whole:
        jcfg = jreduced(jcfg, n_layers=BLOCKS)
        cfg = reduced(cfg, n_layers=BLOCKS)
    jcfg, cfg = jcfg.replace(dtype="bfloat16"), cfg.replace(dtype="bfloat16")
    jm, tm = jbuild(jcfg), build_model(cfg)
    if port_weights:
        tp = tm.init(torch.Generator().manual_seed(seed))
        want = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
        jp = jax.tree.map(lambda a, w: jnp.asarray(a, w.dtype),
                          tree_to_numpy(tp), want)
    else:
        jp = jm.init(jax.random.PRNGKey(seed))
        tp = tree_from_jax(jp)
    assert all(v.dtype == torch.bfloat16 for v in tp["layers"]["slot0"][
        "mlstm"].values())
    toks = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (batch, s0 + gen)).astype(np.int32)
    at = set(range(gen)) if at is None else set(at)
    return reference_gaps(jm, jp, toks, s0, at), port_gaps(tm, tp, toks, s0,
                                                           at)


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_decode_gap_within_reference(seed):
    ref, port = both_gaps(seed)
    assert all(np.isfinite(ref + port))
    assert max(port) <= FACTOR * max(ref), (port, ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--whole", action="store_true",
                    help="xlstm-125m at whole width, the serving shape")
    ap.add_argument("--port-weights", action="store_true",
                    help="the port's init, drawn on the CPU, in both")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    args = ap.parse_args(argv)
    shape = (dict(whole=True, batch=2, s0=512, gen=16, at=(0, 15))
             if args.whole else {})
    for seed in args.seeds:
        t0 = time.perf_counter()
        ref, port = both_gaps(seed, port_weights=args.port_weights, **shape)
        print(json.dumps({"seed": seed, "whole": args.whole,
                          "port_weights": args.port_weights,
                          "reference_gaps": ref, "port_gaps": port,
                          "reference_max": max(ref), "port_max": max(port),
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
