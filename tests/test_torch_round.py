"""One parallel round of the port (``repro_torch.core.round``) against the
JAX package's jitted round step, from the same params, batches, weights
and mask (one client masked out).  The configs use no randomness
(deterministic rounding, no federated dropout), so the new params must
agree to 1e-5 relative: float32 sums taken in another order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CompressionConfig as JComp
from repro.core import FLConfig as JFL
from repro.core import build_fl_round_step as j_build
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import CNNConfig as JConfig
from repro.optim import get_client_optimizer as j_copt
from repro.optim import get_server_optimizer as j_sopt
from repro_torch import convert
from repro_torch.core import CompressionConfig, FLConfig, build_fl_round_step
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.optim import get_client_optimizer, get_server_optimizer

NARROW = dict(name="t", in_shape=(8, 8, 1), num_classes=3, channels=(4, 8),
              dense=16)
C, H, B = 4, 2, 5
COMPRESSION = {
    "none": {},
    "q8_topk": dict(quantize_bits=8, topk_frac=0.1,
                    stochastic_rounding=False),
}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    batches = {
        "image": rng.normal(size=(C, H, B) + NARROW["in_shape"]
                            ).astype(np.float32),
        "label": rng.integers(0, NARROW["num_classes"], (C, H, B)
                              ).astype(np.int32)}
    weights = rng.uniform(10, 50, C).astype(np.float32)
    mask = np.array([1, 1, 0, 1], np.float32)
    return batches, weights, mask


def run_both(comp, aggregation="fedavg", server="fedavg", use_fused=True,
             mu=0.0, rounds=1):
    jm, tm = JCNN(JConfig(**NARROW)), CNN(CNNConfig(**NARROW))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    fl_kw = dict(num_clients=C, local_steps=H, client_lr=0.1,
                 fedprox_mu=mu, aggregation=aggregation)
    jfl = JFL(compression=JComp(use_fused=use_fused, **COMPRESSION[comp]),
              **fl_kw)
    tfl = FLConfig(compression=CompressionConfig(use_fused=use_fused,
                                                 **COMPRESSION[comp]), **fl_kw)
    jserver, tserver = j_sopt(server), get_server_optimizer(server)
    jstep = jax.jit(j_build(jm.loss_fn, j_copt("sgd"), jserver, jfl))
    tstep = build_fl_round_step(tm.loss_fn, get_client_optimizer("sgd"),
                                tserver, tfl)
    js = jserver.init(jp)
    ts = convert.server_state_from_jax(
        jax.tree.map(np.asarray, js) if js else js)
    gen = torch.Generator().manual_seed(0)
    for r in range(rounds):
        b, w, m = inputs(seed=r)
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, b),
                             jnp.asarray(w), jnp.asarray(m),
                             jax.random.PRNGKey(r))
        tp, ts, tmet = tstep(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in b.items()},
                             torch.from_numpy(w), torch.from_numpy(m), gen)
    return (jp, js, jmet), (tp, ts, tmet)


def assert_params_close(jp, tp, rtol=1e-5):
    got = convert.params_to_numpy(tp)
    for k in jp:
        want = np.asarray(jp[k])
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got[k], want, rtol=rtol, atol=rtol * scale,
                                   err_msg=k)


@pytest.mark.parametrize("server", ["fedavg", "fedadam"])
@pytest.mark.parametrize("aggregation", ["fedavg", "weighted"])
@pytest.mark.parametrize("comp", ["none", "q8_topk"])
def test_parallel_round_matches_jax(comp, aggregation, server):
    (jp, js, jmet), (tp, ts, tmet) = run_both(comp, aggregation, server)
    assert_params_close(jp, tp)
    if server == "fedadam":
        for part in ("m", "v"):
            assert_params_close(js[part], ts[part])
    for key in ("client_loss", "delta_norm", "participation"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)


@pytest.mark.parametrize("comp", ["none", "q8_topk"])
def test_unfused_round_matches_jax(comp):
    (jp, _, _), (tp, _, _) = run_both(comp, use_fused=False)
    assert_params_close(jp, tp)


def test_fedprox_two_rounds_match_jax():
    (jp, _, _), (tp, _, _) = run_both("q8_topk", mu=0.1, rounds=2)
    assert_params_close(jp, tp)


@pytest.mark.parametrize("change", [dict(mode="async")])
def test_unported_config_values_raise(change):
    """mode='async' builds a round step, as in the reference: the round
    reads no mode (the async regime's commit is core.async_round's)."""
    tm = CNN(CNNConfig(**NARROW))
    cfg = dataclasses.replace(FLConfig(), **change)
    step = build_fl_round_step(tm.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), cfg)
    assert callable(step)
