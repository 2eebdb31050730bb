"""The port's sequential and pod_sequential round modes, the hierarchical
pod combine, the trimmed mean and the fused FedProx update, each one round
against the JAX package's jitted round step from the same params, batches,
weights and mask (one client masked out).  The configs use no randomness
(deterministic rounding, no federated dropout), so the new params must
agree to 1e-5 relative (float32 sums taken in another order), and the
fused-update round to 1e-6."""
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
from repro_torch.core.pipeline import build_update_pipeline
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.optim import get_client_optimizer, get_server_optimizer

NARROW = dict(name="t", in_shape=(8, 8, 1), num_classes=3, channels=(4, 8),
              dense=16)
H, B = 2, 5
COMPRESSION = {
    "none": {},
    "q8_topk": dict(quantize_bits=8, topk_frac=0.1,
                    stochastic_rounding=False),
}


def inputs(C, seed=0):
    rng = np.random.default_rng(seed)
    batches = {
        "image": rng.normal(size=(C, H, B) + NARROW["in_shape"]
                            ).astype(np.float32),
        "label": rng.integers(0, NARROW["num_classes"], (C, H, B)
                              ).astype(np.int32)}
    weights = rng.uniform(10, 50, C).astype(np.float32)
    mask = np.ones(C, np.float32)
    mask[2] = 0.0
    return batches, weights, mask


def run_both(comp="none", n_pods=1, C=4, **fl_kw):
    """One round of each package from the same start.  Returns the new
    params and metrics of both."""
    jm, tm = JCNN(JConfig(**NARROW)), CNN(CNNConfig(**NARROW))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    kw = dict(num_clients=C, local_steps=H, client_lr=0.1, **fl_kw)
    jfl = JFL(compression=JComp(**COMPRESSION[comp]), **kw)
    tfl = FLConfig(compression=CompressionConfig(**COMPRESSION[comp]), **kw)
    jstep = jax.jit(j_build(jm.loss_fn, j_copt("sgd"), j_sopt("fedavg"), jfl,
                            n_pods=n_pods))
    tstep = build_fl_round_step(tm.loss_fn, get_client_optimizer("sgd"),
                                get_server_optimizer("fedavg"), tfl,
                                n_pods=n_pods)
    b, w, m = inputs(C)
    jp, _, jmet = jstep(jp, (), jax.tree.map(jnp.asarray, b), jnp.asarray(w),
                        jnp.asarray(m), jax.random.PRNGKey(0))
    tp, _, tmet = tstep(tp, (), {k: torch.from_numpy(v) for k, v in b.items()},
                        torch.from_numpy(w), torch.from_numpy(m),
                        torch.Generator().manual_seed(0))
    return (jp, jmet), (tp, tmet)


def assert_round_close(j, t, rtol=1e-5):
    (jp, jmet), (tp, tmet) = j, t
    got = convert.params_to_numpy(tp)
    for k in jp:
        want = np.asarray(jp[k])
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got[k], want, rtol=rtol, atol=rtol * scale,
                                   err_msg=k)
    for key in ("client_loss", "delta_norm", "participation"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)


@pytest.mark.parametrize("aggregation", ["fedavg", "weighted"])
@pytest.mark.parametrize("comp", ["none", "q8_topk"])
@pytest.mark.parametrize("hierarchical", [False, True])
@pytest.mark.parametrize("mode,n_pods", [("sequential", 1),
                                         ("pod_sequential", 1),
                                         ("pod_sequential", 2)])
def test_streaming_round_matches_jax(mode, n_pods, hierarchical, comp,
                                     aggregation):
    j, t = run_both(comp, n_pods=n_pods, client_exec=mode,
                    hierarchical=hierarchical, aggregation=aggregation)
    assert_round_close(j, t)


@pytest.mark.parametrize("aggregation", ["fedavg", "weighted"])
@pytest.mark.parametrize("comp", ["none", "q8_topk"])
def test_hierarchical_parallel_round_matches_jax(comp, aggregation):
    j, t = run_both(comp, n_pods=2, hierarchical=True,
                    aggregation=aggregation)
    assert_round_close(j, t)


@pytest.mark.parametrize("C", [4, 10])
def test_trimmed_mean_round_matches_jax(C):
    """C=10 trims one client at each end of every coordinate; C=4 trims
    none (int(0.1 * 4) = 0)."""
    j, t = run_both(C=C, aggregation="trimmed_mean")
    assert_round_close(j, t)


@pytest.mark.parametrize("mu", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_fused_update_round_matches_jax(mode, mu):
    j, t = run_both(client_exec=mode, fedprox_mu=mu, use_fused_update=True)
    assert_round_close(j, t, rtol=1e-6)


@pytest.mark.parametrize("change", [
    dict(client_exec="sequential"), dict(client_exec="pod_sequential"),
    dict(hierarchical=True), dict(aggregation="trimmed_mean"),
    dict(secure_agg=True), dict(use_fused_update=True)])
def test_config_values_build(change):
    """Every sync FLConfig value builds a round step."""
    tm = CNN(CNNConfig(**NARROW))
    cfg = dataclasses.replace(FLConfig(), **change)
    step = build_fl_round_step(tm.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), cfg, n_pods=2)
    assert callable(step)


def test_secure_trimmed_mean_is_refused_at_build():
    cfg = FLConfig(secure_agg=True, aggregation="trimmed_mean")
    with pytest.raises(ValueError, match="trimmed_mean"):
        build_update_pipeline(cfg)
