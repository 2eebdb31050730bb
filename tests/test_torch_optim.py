"""The port's client and server optimizers and aggregation helpers against
the JAX package's, on the same numpy params, grads and deltas.  Tolerance
1e-6 relative: elementwise float32 arithmetic in the same order.  Adam
takes 1e-5: its float32 bias corrections ``1 - b^t`` come from another pow
implementation, and each of its steps moves a param by about lr."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.optim import get_client_optimizer as j_copt
from repro.optim import get_server_optimizer as j_sopt
from repro_torch import convert
from repro_torch.core import aggregation as tagg
from repro_torch.optim import get_client_optimizer, get_server_optimizer

SHAPES = {"a_w": (3, 5), "b_b": (5,), "c_w": (2, 2, 3)}


def trees(seed, n=3, scale=0.1):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


def close(got: dict, want: dict, rtol=1e-6):
    got = convert.params_to_numpy(got)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=rtol / 10, err_msg=k)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_client_optimizer_three_steps_match_jax(name):
    params, *grads = trees(0, n=4)
    jo, to = j_copt(name), get_client_optimizer(name)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = convert.params_from_jax(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                           0.05)
        tp, ts = to.update(convert.params_from_jax(g), ts, tp, 0.05)
    close(tp, jp, rtol=1e-5 if name == "adam" else 1e-6)


@pytest.mark.parametrize("name", ["fedavg", "fedadam", "fedyogi"])
def test_server_optimizer_three_rounds_match_jax(name):
    params, *deltas = trees(1, n=4)
    jo, to = j_sopt(name), get_server_optimizer(name)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = convert.params_from_jax(params)
    js = jo.init(jp)
    ts = convert.server_state_from_jax(jax.tree.map(np.asarray, js))
    for d in deltas:
        jp, js = jo.apply(jp, {k: jnp.asarray(v) for k, v in d.items()}, js)
        tp, ts = to.apply(tp, convert.params_from_jax(d), ts)
    close(tp, jp)
    if js:
        back = convert.server_state_to_numpy(ts)
        for part in ("m", "v"):
            close(convert.params_from_jax(back[part]), js[part])


@pytest.mark.parametrize("mode", ["fedavg", "weighted"])
def test_aggregation_matches_jax(mode):
    rng = np.random.default_rng(2)
    C = 4
    stacked = {k: rng.normal(size=(C,) + s).astype(np.float32)
               for k, s in SHAPES.items()}
    weights = rng.uniform(10, 50, C).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    losses = rng.uniform(0, 3, C).astype(np.float32)
    jw = jagg.effective_weights(jnp.asarray(weights), jnp.asarray(mask),
                                jnp.asarray(losses), mode)
    tw = tagg.effective_weights(torch.from_numpy(weights),
                                torch.from_numpy(mask),
                                torch.from_numpy(losses), mode)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    close(tagg.weighted_mean(convert.params_from_jax(stacked), tw),
          jagg.weighted_mean({k: jnp.asarray(v) for k, v in stacked.items()},
                             jw))
