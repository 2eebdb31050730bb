"""The port's async buffer commit (``repro_torch.core.async_round``)
against the JAX package's, on the same deltas, weights, staleness (0-20),
mask, ids and exponent, in the tiny CNN's leaf shapes.  The reference's fused
commits run their Pallas kernels in interpret mode, as its own tests run
them on the CPU.

Contracts: the uncompressed commit agrees to 1e-6 of the largest entry of
the committed step (float32 sums in another order); the deterministic
q8 + top-k commit to one weighted quantization step (the quantize contract
of tests/test_kernels.py: a sum in another order may cross a half-way
rounding point); the secure q8 commit equals the unmasked quantized sum
(the integer masks cancel exactly, whatever key each package draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdaptiveStalenessController as JCtrl
from repro.core import AsyncConfig as JAsync
from repro.core import CompressionConfig as JComp
from repro.core import FLConfig as JFL
from repro.core import build_buffer_commit_step as j_commit_step
from repro.core import build_chunked_commit_steps as j_chunk_steps
from repro.core import staleness_weights as j_staleness_weights
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import CNNConfig as JConfig
from repro.optim import get_server_optimizer as j_sopt
from repro_torch import convert
from repro_torch.core import (AdaptiveStalenessController, AsyncConfig,
                              CompressionConfig, FLConfig,
                              build_buffer_commit_step,
                              build_chunked_commit_steps, staleness_weights)
from repro_torch.core import secure_agg as sec
from repro_torch.core.round import ParallelRound
from repro_torch.kernels import ops as kops
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import ordered

TINY = dict(name="tiny-cnn", in_shape=(28, 28, 1), num_classes=9,
            channels=(4, 8), dense=32)
K = 8
STALENESS = np.array([0, 1, 2, 3, 0, 5, 1, 20], np.float32)
COMPRESSION = {
    "none": {},
    "q8_topk": dict(quantize_bits=8, topk_frac=0.1,
                    stochastic_rounding=False),
    "secure_q8": dict(quantize_bits=8, topk_frac=0.1,
                      stochastic_rounding=False),
}


def first_adaptive_alpha():
    """The controller's alpha after one commit of STALENESS."""
    return AdaptiveStalenessController().update(STALENESS.tolist(), 1.0)


EXPONENTS = {"a0": 0.0, "a0.5": 0.5, "adaptive": first_adaptive_alpha()}


@pytest.fixture(scope="module")
def params():
    """Zeros in the tiny CNN's leaf shapes: the fedavg server step adds the
    committed delta to them exactly, so the new params ARE the commit's
    output, with no rounding of the add in the way."""
    jp = JCNN(JConfig(**TINY)).init(jax.random.PRNGKey(0))
    return {k: np.zeros_like(np.asarray(v)) for k, v in jp.items()}


def slot_inputs(params, k=K, seed=0, live=None):
    """Deltas [k, ...] made from a seed, weights, losses, and a mask with
    the slots past ``live`` (padding) and slot 3 (a dropped update) out."""
    rng = np.random.default_rng(seed)
    deltas = {n: (rng.normal(size=(k,) + p.shape) * 0.01).astype(np.float32)
              for n, p in params.items()}
    weights = rng.uniform(50, 200, k).astype(np.float32)
    losses = rng.uniform(0.5, 2.5, k).astype(np.float32)
    mask = np.ones(k, np.float32)
    mask[3 % k] = 0.0
    if live is not None:
        mask[live:] = 0.0
        weights[live:] = 0.0
    return deltas, weights, losses, mask


def configs(comp, use_fused=True, aggregation="fedavg"):
    kw = dict(mode="async", aggregation=aggregation,
              secure_agg=comp.startswith("secure"))
    return (JFL(compression=JComp(use_fused=use_fused, **COMPRESSION[comp]),
                **kw),
            FLConfig(compression=CompressionConfig(use_fused=use_fused,
                                                   **COMPRESSION[comp]),
                     **kw))


def j_commit(jfl, params, deltas, weights, staleness, losses, mask, a):
    step = jax.jit(j_commit_step(j_sopt("fedavg"), jfl, JAsync(buffer_size=K)))
    k = len(weights)
    new, _, met = step({n: jnp.asarray(v) for n, v in params.items()}, (),
                       {n: jnp.asarray(v) for n, v in deltas.items()},
                       jnp.asarray(weights), jnp.asarray(staleness),
                       jnp.asarray(losses), jnp.asarray(mask),
                       jnp.arange(k, dtype=jnp.int32), jnp.float32(a),
                       jax.random.PRNGKey(0))
    return ({n: np.asarray(v) for n, v in new.items()},
            {n: float(v) for n, v in met.items()})


def t_commit(tfl, params, deltas, weights, staleness, losses, mask, a,
             seed=0):
    step = build_buffer_commit_step(get_server_optimizer("fedavg"), tfl,
                                    AsyncConfig(buffer_size=K))
    k = len(weights)
    new, _, met = step(convert.params_from_jax(params), (),
                       convert.params_from_jax(deltas),
                       torch.from_numpy(weights), torch.from_numpy(staleness),
                       torch.from_numpy(losses), torch.from_numpy(mask),
                       torch.arange(k, dtype=torch.int32), a,
                       torch.Generator().manual_seed(seed))
    return convert.params_to_numpy(new), {n: float(v) for n, v in met.items()}


def max_gap(a, b):
    return max(np.abs(a[n].astype(np.float64) - b[n]).max() for n in a)


def largest(tree):
    return max(np.abs(v).max() for v in tree.values())


# ------------------------------------------------------- staleness math
@pytest.mark.parametrize("a", [0.0, 0.5, 1.0, 2.0, EXPONENTS["adaptive"]])
def test_staleness_weights_match_jax(a):
    s = np.arange(0, 21, dtype=np.float32)
    want = np.asarray(j_staleness_weights(jnp.asarray(s), jnp.float32(a)))
    got = staleness_weights(torch.from_numpy(s), a).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ----------------------------------------------------- commit vs the JAX
@pytest.mark.parametrize("exponent", sorted(EXPONENTS))
@pytest.mark.parametrize("use_fused", [True, False])
def test_uncompressed_commit_matches_jax(params, exponent, use_fused):
    a = EXPONENTS[exponent]
    d, w, l, m = slot_inputs(params)
    jfl, tfl = configs("none", use_fused)
    jnew, jmet = j_commit(jfl, params, d, w, STALENESS, l, m, a)
    tnew, tmet = t_commit(tfl, params, d, w, STALENESS, l, m, a)
    assert max_gap(tnew, jnew) <= 1e-6 * largest(jnew)
    for key in ("delta_norm", "n_updates", "mean_staleness",
                "effective_weight"):
        np.testing.assert_allclose(tmet[key], jmet[key], rtol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("exponent", sorted(EXPONENTS))
def test_q8_topk_commit_matches_jax_to_one_step(params, exponent):
    a = EXPONENTS[exponent]
    d, w, l, m = slot_inputs(params, seed=1)
    jfl, tfl = configs("q8_topk")
    jnew, _ = j_commit(jfl, params, d, w, STALENESS, l, m, a)
    tnew, _ = t_commit(tfl, params, d, w, STALENESS, l, m, a)
    w_eff = w * m * (1.0 + STALENESS) ** (-a)
    norm = (w * m).sum()
    for n in params:
        step = w_eff.max() * np.abs(d[n]).max() / 127 / norm
        diff = np.abs(tnew[n].astype(np.float64) - jnew[n])
        close = diff <= 1e-5 * np.abs(jnew[n]) + 1e-7
        assert (close | (diff <= step * 1.001)).all(), n
        assert close.mean() >= 0.99, n


@pytest.mark.parametrize("exponent", ["a0.5", "adaptive"])
def test_secure_q8_commit_equals_unmasked_quantized_sum(params, exponent):
    """The masks cancel exactly: the port's secure commit equals the same
    integer-domain commit with every pair coefficient 0, and the
    reference's secure commit to float32 rounding."""
    a = EXPONENTS[exponent]
    d, w, l, m = slot_inputs(params, seed=2)
    jfl, tfl = configs("secure_q8")
    tnew, _ = t_commit(tfl, params, d, w, STALENESS, l, m, a, seed=5)
    w_eff = torch.from_numpy(w * m) * staleness_weights(
        torch.from_numpy(STALENESS), a)
    names = ordered(params)
    ids = torch.arange(K, dtype=torch.int32)
    sums = kops.fused_secure_commit_tree(
        [torch.from_numpy(d[n]) for n in names], w_eff,
        sec.pair_seeds(sec.commit_key(1), ids),
        torch.zeros(K, K, dtype=torch.int32), bits=8,
        k=CompressionConfig(**COMPRESSION["secure_q8"]).topk_k)
    norm = torch.from_numpy(w * m).sum()
    for n, s in zip(names, sums):
        want = (torch.from_numpy(params[n]) + s / norm).numpy()
        np.testing.assert_array_equal(tnew[n], want, err_msg=n)
    jnew, _ = j_commit(jfl, params, d, w, STALENESS, l, m, a)
    assert max_gap(tnew, jnew) <= 1e-6 * largest(jnew)


# --------------------------------------------------------- commit rules
@pytest.mark.parametrize("comp", ["none", "q8_topk", "secure_q8"])
def test_padding_slots_never_contribute(params, comp):
    """Mask-0 padding (a timeout commit's empty slots) is invisible: poison
    in the padded deltas leaves the commit as it was."""
    d, w, l, m = slot_inputs(params, seed=3, live=5)
    poison = {n: v.copy() for n, v in d.items()}
    zero = {n: v.copy() for n, v in d.items()}
    for n in params:
        poison[n][5:] = 1e6
        zero[n][5:] = 0.0
    _, tfl = configs(comp)
    got, _ = t_commit(tfl, params, poison, w, STALENESS, l, m, 0.5)
    want, _ = t_commit(tfl, params, zero, w, STALENESS, l, m, 0.5)
    for n in params:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_zero_staleness_commit_equals_sync_commit(params):
    """With staleness 0 the async commit is the sync ParallelRound.commit
    on the same deltas, bit for bit (the discount is exactly 1)."""
    d, w, l, m = slot_inputs(params, seed=4)
    _, tfl = configs("none")
    tm = CNN(CNNConfig(**TINY))
    sync = ParallelRound(tm.loss_fn, get_client_optimizer("sgd"),
                         get_server_optimizer("fedavg"), tfl)
    want, _, _ = sync.commit(convert.params_from_jax(params), (),
                             convert.params_from_jax(d), torch.from_numpy(l),
                             torch.from_numpy(w), torch.from_numpy(m),
                             torch.Generator().manual_seed(0))
    got, _ = t_commit(tfl, params, d, w, np.zeros(K, np.float32), l, m, 0.5)
    for n in params:
        np.testing.assert_array_equal(got[n], want[n].numpy(), err_msg=n)


def test_uniformly_stale_buffer_takes_shrunken_step():
    """The discount shrinks the ABSOLUTE step: every update s commits stale
    moves the params 1/(1+s)^a as far as a fresh buffer (normalised by
    w_raw, not w_eff)."""
    k, a, s = 3, 1.0, 4.0
    params = {"x": np.zeros(4, np.float32)}
    d = {"x": np.ones((k, 4), np.float32)}
    _, tfl = configs("none")
    ones = np.ones(k, np.float32)
    fresh, _ = t_commit(tfl, params, d, ones, 0 * ones, 0 * ones, ones, a)
    stale, _ = t_commit(tfl, params, d, ones, s * ones, 0 * ones, ones, a)
    np.testing.assert_allclose(fresh["x"], 1.0, rtol=1e-6)
    np.testing.assert_allclose(stale["x"], 1.0 / (1.0 + s), rtol=1e-6)


def test_trimmed_mean_refused_at_build():
    cfg = FLConfig(mode="async", aggregation="trimmed_mean")
    for build in (build_buffer_commit_step, build_chunked_commit_steps):
        with pytest.raises(ValueError, match="trimmed_mean"):
            build(get_server_optimizer("fedavg"), cfg, AsyncConfig())


# --------------------------------------------------------- chunked commit
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_commit_matches_jax(params, seed):
    """K=4 accumulated C=2 slots at a time, with one padded slot, against
    the reference's chunked steps on the same chunks."""
    k, c, a = 4, 2, 0.5
    d, w, l, m = slot_inputs(params, k=k, seed=10 + seed, live=3)
    s = STALENESS[seed:seed + k]
    jfl, tfl = configs("none")
    jacc, jfin = (jax.jit(f) for f in j_chunk_steps(
        j_sopt("fedavg"), jfl, JAsync(buffer_size=k, commit_chunk=c)))
    tacc, tfin = build_chunked_commit_steps(
        get_server_optimizer("fedavg"), tfl,
        AsyncConfig(buffer_size=k, commit_chunk=c))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = convert.params_from_jax(params)
    ja = {n: jnp.zeros(v.shape, jnp.float32) for n, v in params.items()}
    ta = {n: torch.zeros(v.shape) for n, v in params.items()}
    jw, tw = jnp.float32(0.0), torch.zeros(())
    gen = torch.Generator().manual_seed(seed)
    for i, lo in enumerate(range(0, k, c)):
        part = lambda v: v[lo:lo + c]                      # noqa: E731
        dc = {n: part(v) for n, v in d.items()}
        ja, jw = jacc(ja, jw, {n: jnp.asarray(v) for n, v in dc.items()},
                      jnp.asarray(part(w)), jnp.asarray(part(s)),
                      jnp.asarray(part(l)), jnp.asarray(part(m)),
                      jnp.arange(c, dtype=jnp.int32), jnp.float32(a),
                      jax.random.fold_in(jax.random.PRNGKey(seed), i))
        ta, tw = tacc(ta, tw, convert.params_from_jax(dc),
                      torch.from_numpy(part(w)), torch.from_numpy(part(s)),
                      torch.from_numpy(part(l)), torch.from_numpy(part(m)),
                      torch.arange(c, dtype=torch.int32), a, gen)
    jnew, _, jmet = jfin(jp, (), ja, jw)
    tnew, _, tmet = tfin(tp, (), ta, tw)
    got = convert.params_to_numpy(tnew)
    for n in params:
        np.testing.assert_allclose(got[n], np.asarray(jnew[n]), rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    np.testing.assert_allclose(float(tmet["delta_norm"]),
                               float(jmet["delta_norm"]), rtol=1e-5)


# ----------------------------------------------- adaptive staleness alpha
def test_adaptive_controller_matches_jax():
    """The same observations give the same alphas, and a state round-trip
    through either package continues identically."""
    rng = np.random.default_rng(0)
    jc, tc = JCtrl(), AdaptiveStalenessController()
    for i in range(12):
        stal = rng.integers(0, 21, rng.integers(1, 9)).tolist()
        norm = float("nan") if i == 4 else float(rng.uniform(0.5, 3.0))
        assert tc.update(stal, norm) == jc.update(stal, norm)
        assert tc.state() == jc.state()
    back = AdaptiveStalenessController()
    back.set_state(jc.state())
    assert back.update([3, 9], 1.5) == jc.update([3, 9], 1.5)


def test_async_config_validation():
    assert AsyncConfig(staleness_exponent="adaptive").adaptive_staleness
    assert AsyncConfig().initial_exponent() == JAsync().initial_exponent()
    assert AsyncConfig(staleness_exponent="adaptive").initial_exponent() \
        == JAsync(staleness_exponent="adaptive").initial_exponent()
    for bad in (dict(staleness_exponent="bogus"),
                dict(staleness_exponent=-0.1), dict(buffer_size=0),
                dict(max_concurrency=0), dict(commit_chunk=-1),
                dict(max_staleness=-1)):
        with pytest.raises(ValueError):
            AsyncConfig(**bad)
