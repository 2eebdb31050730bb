"""The port's LM training steps on the CPU against the JAX package, from
the same params (the reference's init, carried by ``convert.tree_from_jax``
into the flat view the round takes) and the same numpy tokens: the
cross-entropy (the codebooks' too), ``LM.loss_fn``'s value and every
gradient, and the chunked cross-entropy fused with the unembedding.  The
rounds are in ``test_torch_lm_train_rounds.py``, which takes its helpers
from here (the two files were one; apart, pytest-xdist's ``--dist
loadfile`` runs them on two workers).

Tolerances (float32, relative to the largest magnitude of the compared
array): 1e-5 for the loss and a gradient (tests/test_fl_round.py's setup);
matmuls and reductions are summed in another order by XLA and by PyTorch.
The xLSTM's gradients are held to 2e-5: each package's float32 gradient
lies up to 8.7e-6 from a float64 evaluation of the port
(tests/test_torch_xlstm.py), so the two differ by up to the sum."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro_torch.configs import get_config, reduced
from repro_torch.convert import tree_from_jax
from repro_torch.models import build_model, token_shape
from repro_torch.models import common as tcommon
from repro_torch.pytree import flat_dict

STEP_TOL, ROUNDS_TOL, XLSTM_GRAD_TOL = 1e-5, 1e-4, 2e-5
SMALL_CHARLM = dict(n_layers=2, d_model=64, d_ff=128, n_heads=2, kv_heads=2)


def rel_err(got, want) -> float:
    got = got.detach().to(torch.float32).numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(arch, **changes):
    j, p = jget_config(arch), get_config(arch)
    if arch != "paper-charlm":
        j, p = jreduced(j), reduced(p)
    return j.replace(**changes), p.replace(**changes)


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def lm_batch(cfg, lead, S, seed):
    """numpy tokens and targets [*lead, S] ([*lead, S, n_cb] with
    codebooks), the targets one position on, from ``S + 1`` drawn tokens;
    for the VLM also patches [*lead, n_patches, D] (float32)."""
    toks = tokens(token_shape(cfg, *lead, S + 1), cfg.vocab, seed)
    seq = len(lead)
    batch = {"tokens": toks.take(np.arange(S), axis=seq),
             "targets": toks.take(np.arange(1, S + 1), axis=seq)}
    if cfg.cross_attn_every:
        batch["patches"] = np.random.default_rng(seed + 1000).normal(
            size=(*lead, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


# ------------------------------------------------------------ cross entropy
@pytest.mark.parametrize("vp,chunk", [(128, 0), (160, 0), (160, 4),
                                      (160, 5)])
def test_cross_entropy_logits(vp, chunk):
    """Padded columns (vp > vocab) masked; chunks that divide S (4) and
    leave a remainder (5)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 12, vp)).astype(np.float32) * 3
    targets = tokens((2, 12), 128, 1)
    want = jcommon.cross_entropy_logits(jnp.asarray(logits),
                                        jnp.asarray(targets), 128, chunk)
    got = tcommon.cross_entropy_logits(torch.from_numpy(logits),
                                       torch.from_numpy(targets), 128, chunk)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= STEP_TOL


def test_codebook_cross_entropy():
    """The audio family's CE: logits [B, S, n_cb, Vp] (vocab 200 padded to
    256) against targets [B, S, n_cb], the plain mean over every codebook
    position.  (The reference's chunked form of this function takes
    [B, S, Vp] logits only; the model chunks in ``_ce_from_hidden``,
    held below.)"""
    logits = np.random.default_rng(6).normal(
        size=(2, 12, 4, 256)).astype(np.float32) * 3
    targets = tokens((2, 12, 4), 200, 7)
    want = jcommon.cross_entropy_logits(jnp.asarray(logits),
                                        jnp.asarray(targets), 200)
    got = tcommon.cross_entropy_logits(torch.from_numpy(logits),
                                       torch.from_numpy(targets), 200)
    assert got.dtype == torch.float32 and got.shape == ()
    assert rel_err(got, want) <= STEP_TOL


# ------------------------------------------------------------ loss and grad
# the reduced char-LM (dense, tanh GELU, vocab padded 128 -> 256), a
# sliding window shorter than the sequence, the MoE family with its
# load-balance term, the hybrid family (Mamba's train mode through the
# scan's backward, attention and the MoE), the xLSTM family, the VLM
# (cross attention to the batch's patches) and the audio family (the
# codebooks' embeddings, heads and CE)
LOSS_MODELS = [("paper-charlm", SMALL_CHARLM),
               ("starcoder2-7b", {"sliding_window": 5}),
               ("qwen3-moe-235b-a22b", {}),
               ("jamba-1.5-large-398b", {}),
               ("xlstm-125m", {}),
               ("llama-3.2-vision-90b", {}),
               ("musicgen-medium", {})]


def grad_tol(arch):
    return XLSTM_GRAD_TOL if arch == "xlstm-125m" else STEP_TOL


def _both(arch, changes):
    jcfg, cfg = configs(arch, **changes)
    jm, tm = jbuild(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, tree_from_jax(jp, flat=True)


@pytest.mark.parametrize("arch,changes", LOSS_MODELS,
                         ids=[m[0] for m in LOSS_MODELS])
def test_loss_and_grads_match_reference(arch, changes):
    jm, tm, jp, tp = _both(arch, changes)
    nb = lm_batch(tm.cfg, (2,), 16, 2)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, jbatch)
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, aux = tm.loss_fn(params, batch)
    loss.backward()
    assert rel_err(loss, jloss) <= STEP_TOL
    assert rel_err(aux["ce"], jaux["ce"]) <= STEP_TOL
    if tm.cfg.moe is not None:
        assert float(jaux["aux"]) > 0
        assert rel_err(aux["aux"], jaux["aux"]) <= STEP_TOL
    want = flat_dict(jax.tree.map(np.asarray, jgrads))
    assert list(params) == list(want)
    for k, w in want.items():
        assert rel_err(params[k].grad, w) <= grad_tol(arch), k


def test_chunked_ce_from_hidden_matches_reference():
    """The chunked CE fused with the unembedding (taken where S * vocab
    exceeds 2^24), forced here at chunk 5 over 12 positions."""
    jm, tm, jp, tp = _both("paper-charlm", SMALL_CHARLM)
    x = np.random.default_rng(3).normal(size=(2, 12, 64)).astype(np.float32)
    targets = tokens((2, 12), 128, 4)
    want = jm._ce_from_hidden(jp, jnp.asarray(x), jnp.asarray(targets), 5)
    got = tm._ce_from_hidden(tp, torch.from_numpy(x),
                             torch.from_numpy(targets), 5)
    assert rel_err(got, want) <= STEP_TOL


def test_chunked_codebook_ce_from_hidden_matches_reference():
    """The same for the reduced audio LM's four codebook heads: chunks of
    5 positions of [B, chunk, n_cb, Vp] logits and [B, chunk, n_cb]
    targets, and the remainder."""
    jm, tm, jp, tp = _both("musicgen-medium", {})
    x = np.random.default_rng(8).normal(size=(2, 12, 256)).astype(np.float32)
    targets = tokens((2, 12, 4), tm.cfg.vocab, 9)
    want = jm._ce_from_hidden(jp, jnp.asarray(x), jnp.asarray(targets), 5)
    got = tm._ce_from_hidden(tp, torch.from_numpy(x),
                             torch.from_numpy(targets), 5)
    assert rel_err(got, want) <= STEP_TOL
