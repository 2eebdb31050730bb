"""The port's xLSTM family on the CPU against the JAX package, at
``reduced(xlstm-125m)`` (pattern [mlstm, slstm], d_model 256, 4 heads,
mLSTM chunk 8): ``mlstm_apply`` and ``slstm_apply`` in train, prefill and
decode with their gradients, ``LM.loss_fn`` and every gradient, and, within
the port, decoding against teacher-forced prefill.  Params come from the
reference's init, carried by ``convert.tree_from_jax``; inputs from numpy.

Tolerances (float32, relative to the largest magnitude): 1e-5 for a mixer's
output, a state and the loss; 2e-5 for gradients, where each package's
float32 gradient lies up to 8.7e-6 from a float64 evaluation of the port
(the stabilised exponential gates carry the log-gate sums' rounding), so
the two differ by up to the sum; 1e-4 for a whole model's logits;
decoding against prefill to tests/test_decode_consistency.py's 2e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import tree_from_jax
from repro_torch.models import build_model
from repro_torch.models import xlstm as txlstm
from repro_torch.pytree import flat_dict

TOL, GRAD_TOL, MODEL_TOL = 1e-5, 2e-5, 1e-4
ARCH = "xlstm-125m"


def configs():
    return jreduced(jget_config(ARCH)), reduced(get_config(ARCH))


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def assert_rel(got, want, tol, what=""):
    if torch.is_tensor(got):
        got = got.detach().to(torch.float32).numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def _mixer(kind, seed=40):
    """One mixer's reference params and the port's copy of them."""
    jcfg, cfg = configs()
    pb = jcommon.ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    if kind == "mlstm":
        jxlstm.init_mlstm(pb, ["m"], cfg.d_model, cfg.n_heads, jcfg.xlstm, 0)
    else:
        jxlstm.init_slstm(pb, ["m"], cfg.d_model, cfg.n_heads, 0)
    return jcfg, cfg, pb.params["m"], tree_from_jax(pb.params["m"])


def _apply(kind, pkg, p, x, cfg, mode, state=None):
    if kind == "mlstm":
        return pkg.mlstm_apply(p, x, n_heads=cfg.n_heads, cfg=cfg.xlstm,
                               mode=mode, state=state)
    return pkg.slstm_apply(p, x, n_heads=cfg.n_heads, mode=mode, state=state)


def _zero_state(kind, cfg, B):
    """The decode state ``init_decode_state`` gives the slot, one group."""
    H = cfg.n_heads
    if kind == "mlstm":
        hd = int(cfg.xlstm.proj_factor * cfg.d_model) // H
        return {"C": np.zeros((B, H, hd, hd), np.float32),
                "n": np.zeros((B, H, hd), np.float32),
                "m": np.zeros((B, H), np.float32)}
    return {k: np.zeros((B, H, cfg.d_model // H), np.float32) for k in "cnhm"}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_train_matches_reference(kind):
    """Train mode over 21 positions (mLSTM: two chunks of 8 and a
    remainder of 5): the output, and the gradients of every parameter and
    of the input under the loss sum(out * w)."""
    jcfg, cfg, jp, tp, = _mixer(kind)
    x, w = rand((2, 21, cfg.d_model), 1), rand((2, 21, cfg.d_model), 2)

    def jloss(p, x):
        out, st = _apply(kind, jxlstm, p, x, jcfg, "train")
        return jnp.sum(out * w), (out, st)

    (_, (jout, jst)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    assert jst is None
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, st = _apply(kind, txlstm, tp, tx, cfg, "train")
    assert st is None
    (out * torch.from_numpy(w)).sum().backward()
    assert_rel(out, jout, TOL, "out")
    assert_rel(tx.grad, jgx, GRAD_TOL, "x")
    assert tp.keys() == jgp.keys()
    for k in tp:
        assert_rel(tp[k].grad, jgp[k], GRAD_TOL, k)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_prefill_and_decode_match_reference(kind):
    """Prefill of 20 positions from the zeroed decode state (the sLSTM
    starts its carry there, n = 0, where train starts it at 1e-6), then
    three decode steps, each output and state leaf."""
    jcfg, cfg, jp, tp = _mixer(kind, 41)
    x = rand((2, 23, cfg.d_model), 3)
    zero = _zero_state(kind, cfg, 2)
    jout, jst = _apply(kind, jxlstm, jp, jnp.asarray(x[:, :20]), jcfg,
                       "prefill", {k: jnp.asarray(v) for k, v in zero.items()})
    with torch.inference_mode():
        out, st = _apply(kind, txlstm, tp, torch.from_numpy(x[:, :20]), cfg,
                         "prefill", {k: torch.from_numpy(v)
                                     for k, v in zero.items()})
    assert_rel(out, jout, TOL, "prefill out")
    assert st.keys() == jst.keys()
    for k in jst:
        assert_rel(st[k], jst[k], TOL, f"prefill state {k}")
    for i in range(20, 23):
        jout, jst = _apply(kind, jxlstm, jp, jnp.asarray(x[:, i:i + 1]), jcfg,
                           "decode", jst)
        with torch.inference_mode():
            out, st = _apply(kind, txlstm, tp, torch.from_numpy(
                x[:, i:i + 1]), cfg, "decode", st)
        assert_rel(out, jout, TOL, f"decode {i} out")
        for k in jst:
            assert_rel(st[k], jst[k], TOL, f"decode {i} state {k}")


def test_mlstm_chunk_matches_reference():
    rng = np.random.default_rng(4)
    B, H, L, hd = 2, 3, 6, 8
    q, k, v = (rng.normal(size=(B, H, L, hd)).astype(np.float32)
               for _ in range(3))
    li = rng.normal(size=(B, H, L)).astype(np.float32)
    lf = np.log(rng.uniform(0.5, 0.99, (B, H, L))).astype(np.float32)
    C0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    n0 = rng.normal(size=(B, H, hd)).astype(np.float32)
    m0 = rng.normal(size=(B, H)).astype(np.float32)
    args = (q, k, v, li, lf, C0, n0, m0)
    want = jxlstm._mlstm_chunk(*map(jnp.asarray, args))
    got = txlstm._mlstm_chunk(*map(torch.from_numpy, args))
    for g, w, name in zip(got, want, ("y", "C", "n", "m")):
        assert_rel(g, w, TOL, name)


def _models():
    jcfg, cfg = configs()
    jm, tm = jbuild(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp


def test_init_matches_reference_layout():
    jm, tm, jp = _models()
    tp = flat_dict(tm.init(torch.Generator().manual_seed(0)))
    want = flat_dict(jax.tree.map(np.asarray, jp))
    assert list(tp) == list(want)
    for k, v in want.items():
        assert tuple(tp[k].shape) == v.shape and tp[k].dtype == torch.float32
    # the forget-gate biases start at 3, the other biases at 0
    for k in tp:
        if k.rsplit("/", 1)[-1] in ("bf", "bi", "bz", "bo"):
            fill = 3.0 if k.endswith("bf") else 0.0
            assert torch.equal(tp[k], torch.full_like(tp[k], fill)), k


def test_loss_and_grads_match_reference():
    jm, tm, jp = _models()
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, (2, 21))
    toks = toks.astype(np.int32)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, {"tokens": jnp.asarray(toks[:, :-1]),
                                        "targets": jnp.asarray(toks[:, 1:])})
    params = {k: v.requires_grad_(True)
              for k, v in tree_from_jax(jp, flat=True).items()}
    loss, aux = tm.loss_fn(params, {"tokens": torch.from_numpy(toks[:, :-1]),
                                    "targets": torch.from_numpy(toks[:, 1:])})
    loss.backward()
    assert_rel(loss, jloss, TOL, "loss")
    assert_rel(aux["ce"], jaux["ce"], TOL, "ce")
    want = flat_dict(jax.tree.map(np.asarray, jgrads))
    assert list(params) == list(want)
    for k, w in want.items():
        assert_rel(params[k].grad, w, GRAD_TOL, k)


def test_decode_matches_prefill():
    _, cfg = configs()
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    S, gen = 19, 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, S + gen)))
    with torch.inference_mode():
        lg, state = tm.prefill(tp, {"tokens": toks[:, :S]}, S + gen)
        for i in range(gen):
            lg, state = tm.decode_step(tp, state, toks[:, S + i], S + i)
            want, _ = tm.prefill(tp, {"tokens": toks[:, :S + i + 1]},
                                 S + gen)
            np.testing.assert_allclose(lg.numpy(), want.numpy(), rtol=2e-3,
                                       atol=2e-3, err_msg=f"step {i}")
