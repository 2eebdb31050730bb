"""The port's LM zoo (serving half) on the CPU against the JAX package, on
the same params (the reference's init, copied by ``convert.tree_from_jax``)
and the same numpy inputs: the modules one by one, then whole prefill and
decode on the reduced Jamba (pattern [mamba+mlp, attn+moe]), the paper's
char-LM, a sliding-window ring buffer, an MoE family, the xLSTM family,
the VLM (cross attention to image patches) and the audio family (codebook
embeddings and heads); the full-width xLSTM's, Llama-3.2-Vision's and
MusicGen-medium's layouts; the reduced Jamba's training loss and
gradients.

Tolerances (all float32): 1e-5 relative for a module, 1e-4 for a whole
model, where matmuls and reductions are summed in another order by XLA
and by PyTorch.  Within the port, decoding must match teacher-forced
prefill to tests/test_decode_consistency.py's 2e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.convert import tree_from_jax, tree_to_numpy
from repro_torch.kernels import launches
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, param_count, token_shape
from repro_torch.models import common as tcommon
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.pytree import flat_dict

MODULE_TOL, MODEL_TOL = 1e-5, 1e-4


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_rel(got, want, tol, what=""):
    if torch.is_tensor(got):
        got = got.to(torch.float32)
    if torch.is_tensor(want):
        want = want.to(torch.float32)
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def configs(arch, **changes):
    """The reduced config in both packages (``paper-charlm`` as it is: it
    is CPU-sized already)."""
    j, p = jget_config(arch), get_config(arch)
    if arch != "paper-charlm":
        j, p = jreduced(j), reduced(p)
    return j.replace(**changes), p.replace(**changes)


# ------------------------------------------------------------------ modules
def test_rms_norm():
    x, w = rand((2, 5, 64), 0), rand((64,), 1)
    assert_rel(tcommon.rms_norm(t(x), t(w), 1e-5),
               jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
               MODULE_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope(batched):
    x = rand((2, 7, 4, 16), 2)
    pos = np.arange(7) + 3
    if batched:
        pos = np.stack([pos, pos + 5])
    assert_rel(tcommon.apply_rope(t(x), t(pos), 10_000.0),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
               MODULE_TOL)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_activations(act):
    x = rand((3, 50), 3, 3.0)
    assert_rel(tcommon.act_fn(act)(t(x)),
               jcommon.act_fn(act)(jnp.asarray(x)), MODULE_TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_attend_full_and_chunked(window):
    # GQA: 4 query heads over 2 kv heads
    q, k, v = rand((2, 16, 4, 8), 4), rand((2, 16, 2, 8), 5), \
        rand((2, 16, 2, 8), 6)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    assert_rel(tattn.attend_full(t(q), t(k), t(v), window=window),
               jattn.attend_full(jq, jk, jv, window=window), MODULE_TOL)
    assert_rel(tattn.attend_chunked(t(q), t(k), t(v), window=window,
                                    q_chunk=4, kv_chunk=8),
               jattn.attend_chunked(jq, jk, jv, window=window, q_chunk=4,
                                    kv_chunk=8), MODULE_TOL)
    # attend switches to the chunked path above its threshold
    assert_rel(tattn.attend(t(q), t(k), t(v), window=window,
                            chunk_threshold=8, q_chunk=8, kv_chunk=8),
               jattn.attend(jq, jk, jv, window=window, chunk_threshold=8,
                            q_chunk=8, kv_chunk=8), MODULE_TOL)


@pytest.mark.parametrize("window,pos", [(0, 9), (12, 5), (12, 20)])
def test_decode_attend(window, pos):
    q1, kc, vc = rand((2, 4, 8), 7), rand((2, 12, 2, 8), 8), \
        rand((2, 12, 2, 8), 9)
    assert_rel(tattn.decode_attend(t(q1), t(kc), t(vc), pos, window=window),
               jattn.decode_attend(jnp.asarray(q1), jnp.asarray(kc),
                                   jnp.asarray(vc), pos, window=window),
               MODULE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attend(dtype):
    # GQA: 8 query heads over 2 kv heads, 5 queries against 11 patches
    q, k, v = rand((2, 5, 8, 16), 30), rand((2, 11, 2, 16), 31), \
        rand((2, 11, 2, 16), 32)
    want = jattn.cross_attend(*(jnp.asarray(a).astype(dtype)
                                for a in (q, k, v)))
    got = tattn.cross_attend(*(t(a).to(tcommon.DTYPES[dtype])
                               for a in (q, k, v)))
    assert got.dtype == tcommon.DTYPES[dtype] and got.shape == want.shape
    if dtype == "float32":
        assert_rel(got, want, MODULE_TOL)
    else:
        # both take the scores in bf16, the softmax in float32 and cast it
        # to bf16 before the second product (equal here); held to one bf16
        # ulp, since each package may sum the products in its own order
        np.testing.assert_allclose(
            got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)), rtol=2 ** -7, atol=2 ** -9)


def test_cache_write_refuses_to_clamp():
    cache = torch.zeros(1, 4, 2, 8)
    tattn.cache_write(cache, torch.ones(1, 1, 2, 8), 3)
    assert cache[:, 3].eq(1).all() and cache[:, :3].eq(0).all()
    with pytest.raises(IndexError):
        tattn.cache_write(cache, torch.ones(1, 1, 2, 8), 4)


def _moe_params(cfg, seed):
    E, D, Fd = cfg.num_experts, 32, cfg.d_expert
    return {"router": rand((D, E), seed), "w1": rand((E, D, Fd), seed + 1,
                                                     0.2),
            "w3": rand((E, D, Fd), seed + 2, 0.2),
            "w2": rand((E, Fd, D), seed + 3, 0.2)}


@pytest.mark.parametrize("capacity_factor", [0.5, 2.0])
def test_moe_local(capacity_factor):
    jcfg, cfg = (dataclasses.replace(c.moe, d_expert=48,
                                     capacity_factor=capacity_factor)
                 for c in configs("jamba-1.5-large-398b"))
    p = _moe_params(cfg, 10)
    x = rand((2, 16, 32), 11)
    out, aux = tmoe._moe_local(t(x), *(t(p[k]) for k in
                                       ("router", "w1", "w3", "w2")),
                               cfg=cfg, act="swiglu")
    jout, jaux = jmoe._moe_local(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                          ("router", "w1", "w3", "w2")),
        cfg=jcfg, act="swiglu", model_axis=None, f_axes=(), token_axes=(),
        mode="gather_weights")
    assert_rel(out, jout, MODULE_TOL)
    assert abs(float(aux) - float(jaux)) <= MODULE_TOL * abs(float(jaux))
    # the small capacity drops assignments; the large one keeps them all
    eid, gate, _ = tmoe._route(t(x).reshape(-1, 32), t(p["router"]), cfg)
    cap = max(int(32 * cfg.top_k * capacity_factor / cfg.num_experts), 4)
    _, gates = tmoe._dispatch_indices(eid, gate, 0, cfg.num_experts, cap)
    kept = int((gates != 0).sum())
    assert (kept < 32 * cfg.top_k) == (capacity_factor < 1), kept


def _mamba_setup(seed=20):
    jcfg, cfg = configs("jamba-1.5-large-398b")
    D = cfg.d_model
    pb = jcommon.ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jmamba.init_mamba(pb, ["m"], D, jcfg.mamba, 0)
    jp = pb.params["m"]
    # 37 positions: the prefill of the first 36 scans chunks of 16, 16 and
    # a remainder of 4, and the 37th is decoded
    x = rand((2, 37, D), seed + 1)
    return jcfg, cfg, jp, tree_from_jax(jp), x


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mamba_prefill_and_decode(use_kernel):
    jcfg, cfg, jp, tp, x = _mamba_setup()
    jout, jstate = jmamba.mamba_apply(jp, jnp.asarray(x[:, :36]),
                                      cfg=jcfg.mamba, mode="prefill",
                                      use_kernel=use_kernel)
    with torch.inference_mode():
        out, state = tmamba.mamba_apply(tp, t(x[:, :36]), cfg=cfg.mamba,
                                        mode="prefill")
    assert_rel(out, jout, MODULE_TOL, "prefill out")
    for k in ("conv", "h"):
        assert_rel(state[k], jstate[k], MODULE_TOL, f"prefill state {k}")
    jout, jstate = jmamba.mamba_apply(jp, jnp.asarray(x[:, 36:]),
                                      cfg=jcfg.mamba, mode="decode",
                                      state=jstate)
    with torch.inference_mode():
        out, state = tmamba.mamba_apply(tp, t(x[:, 36:]), cfg=cfg.mamba,
                                        mode="decode", state=state)
    assert_rel(out, jout, MODULE_TOL, "decode out")
    for k in ("conv", "h"):
        assert_rel(state[k], jstate[k], MODULE_TOL, f"decode state {k}")


def test_mamba_scans_every_chunk():
    # 37 positions at chunk 16: three scan calls, the remainder included;
    # on the CPU none of them is a kernel launch
    _, cfg, _, tp, x = _mamba_setup()
    calls = []
    orig = tmamba.kops.selective_scan_chunk
    try:
        tmamba.kops.selective_scan_chunk = lambda a, b, h: (
            calls.append(a.shape[1]) or orig(a, b, h))
        launches.reset()
        with torch.inference_mode():
            tmamba.mamba_apply(tp, t(x), cfg=cfg.mamba, mode="prefill")
    finally:
        tmamba.kops.selective_scan_chunk = orig
    assert calls == [16, 16, 5]
    assert not launches.KERNEL_LAUNCHES


# ------------------------------------------------------------- whole model
# jamba: the hybrid family (mamba + attention, MLP + MoE); paper-charlm:
# dense with the tanh GELU; starcoder2 at window 8: the sliding-window ring
# buffer wraps during prefill and decode; qwen3-moe: the MoE family;
# xlstm: the ssm family (mLSTM + sLSTM, with their recurrent states);
# llama-3.2-vision: the VLM ([attn + mlp, cross + mlp], the cross K/V
# cache); musicgen: the audio family (4 codebooks, MHA)
MODELS = [("jamba-1.5-large-398b", {}), ("paper-charlm", {}),
          ("starcoder2-7b", {"sliding_window": 8}),
          ("qwen3-moe-235b-a22b", {}), ("xlstm-125m", {}),
          ("llama-3.2-vision-90b", {}), ("musicgen-medium", {})]
B, S0, T = 2, 12, 4


def lm_tokens(cfg, shape, seed):
    """Token ids of ``shape`` [B, S], or [B, S, n_cb] with codebooks."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, token_shape(cfg, *shape))


def lm_patches(cfg, seed):
    """The VLM's patches [B, n_patches, D] (float32), else None."""
    if not cfg.cross_attn_every:
        return None
    return rand((B, cfg.n_patches, cfg.d_model), seed)


def _both(arch, changes):
    jcfg, cfg = configs(arch, **changes)
    jm, tm = jbuild(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = lm_tokens(cfg, (B, S0 + T), 1)
    return jm, tm, jp, tree_from_jax(jp), toks


def _assert_state(state, jstate, tol, what):
    got, want = tree_to_numpy(state), jax.tree.map(np.asarray, jstate)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].keys() == want[key].keys()
        for leaf in want[key]:
            assert_rel(got[key][leaf], want[key][leaf], tol,
                       f"{what} {key}/{leaf}")


@pytest.mark.parametrize("arch,changes", MODELS, ids=[m[0] for m in MODELS])
def test_prefill_and_decode_match_reference(arch, changes):
    jm, tm, jp, tp, toks = _both(arch, changes)
    assert param_count(tp) == sum(x.size for x in jax.tree.leaves(jp))
    s_max = S0 + T
    patches = lm_patches(tm.cfg, 6)
    jbatch, batch = {}, {}
    if patches is not None:
        jbatch["patches"], batch["patches"] = jnp.asarray(patches), \
            t(patches)
    jlg, jstate = jax.jit(lambda p, x: jm.prefill(
        p, {"tokens": x, **jbatch}, s_max))(
        jp, jnp.asarray(toks[:, :S0], jnp.int32))
    with torch.inference_mode():
        lg, state = tm.prefill(tp, {"tokens": t(toks[:, :S0]), **batch},
                               s_max)
    assert_rel(lg, jlg, MODEL_TOL, "prefill logits")
    _assert_state(state, jstate, MODEL_TOL, "prefill")
    jdec = jax.jit(jm.decode_step)
    for i in range(T):
        tok = toks[:, S0 + i]
        jlg, jstate = jdec(jp, jstate, jnp.asarray(tok, jnp.int32),
                           jnp.int32(S0 + i), jbatch.get("patches"))
        with torch.inference_mode():
            lg, state = tm.decode_step(tp, state, t(tok), S0 + i,
                                       batch.get("patches"))
        assert_rel(lg, jlg, MODEL_TOL, f"decode {i} logits")
        _assert_state(state, jstate, MODEL_TOL, f"decode {i}")


@pytest.mark.parametrize("arch,changes", MODELS, ids=[m[0] for m in MODELS])
def test_decode_matches_prefill(arch, changes):
    # tests/test_decode_consistency.py within the port, from the port's own
    # init
    _, cfg = configs(arch, **changes)
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = t(lm_tokens(cfg, (B, S0 + T), 2))
    patches = lm_patches(cfg, 7)
    extra = {} if patches is None else {"patches": t(patches)}
    s_max = S0 + T
    with torch.inference_mode():
        lg, state = tm.prefill(tp, {"tokens": toks[:, :S0], **extra}, s_max)
        for i in range(T - 1):
            lg, state = tm.decode_step(tp, state, toks[:, S0 + i], S0 + i)
            want, _ = tm.prefill(tp, {"tokens": toks[:, :S0 + i + 1],
                                      **extra}, s_max)
            np.testing.assert_allclose(lg.numpy(), want.numpy(), rtol=2e-3,
                                       atol=2e-3, err_msg=f"{arch} step {i}")


# the bound chip_smoke.py holds the full-width Jamba's bf16 decode to
BF16_DECODE_TOL = 5e-2


@pytest.mark.parametrize("dtype,tol", [("float32", MODEL_TOL),
                                       ("bfloat16", BF16_DECODE_TOL)])
def test_decode_matches_prefill_by_dtype(dtype, tol):
    # the reduced Jamba (capacity = token count: no MoE assignment is
    # dropped) over 40 prompt tokens, two whole scan chunks and a
    # remainder; max |diff| over the largest |logit| at the first and the
    # last decoded positions, as chip_smoke.py measures it on the card
    _, cfg = configs("jamba-1.5-large-398b", dtype=dtype)
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    S, gen = 40, 4
    toks = t(np.random.default_rng(3).integers(0, cfg.vocab, (1, S + gen)))
    with torch.inference_mode():
        _, state = tm.prefill(tp, {"tokens": toks[:, :S]}, S + gen)
        for i in range(gen):
            lg, state = tm.decode_step(tp, state, toks[:, S + i], S + i)
            if i in (0, gen - 1):
                want, _ = tm.prefill(tp, {"tokens": toks[:, :S + i + 1]},
                                     S + gen)
                assert lg.dtype == tm.dtype
                assert_rel(lg, want, tol, f"{dtype} step {i}")


# the full-width families once refused here: their params' layouts and
# counts, and the VLM's cross cache in the decode state
FULL_WIDTH = {"xlstm-125m": 162_402_096,
              "llama-3.2-vision-90b": 87_666_794_496,
              "musicgen-medium": 1_384_269_312}


@pytest.mark.parametrize("arch", list(FULL_WIDTH))
def test_full_width_layouts_match_reference(arch):
    """Each family builds at full width: every leaf's name, shape and dtype
    in the reference's order against its abstract params, the parameter
    count, and the decode-state layout against the reference's
    ``decode_state_specs``.
    The xLSTM's params are drawn (162M); the VLM's and the audio LM's
    come from ``param_specs()`` on the meta device, nothing allocated."""
    jm, tm = jbuild(jget_config(arch)), build_model(get_config(arch))
    want = jax.tree.leaves_with_path(jm.param_specs())
    if arch == "xlstm-125m":
        got = flat_dict(tm.init(torch.Generator().manual_seed(0)))
    else:
        got = flat_dict(tm.param_specs())
        assert all(v.is_meta for v in got.values())
    assert param_count(got) == FULL_WIDTH[arch]
    assert len(got) == len(want)
    for (path, spec), (name, leaf) in zip(want, got.items()):
        assert name == "/".join(k.key for k in path)
        assert tuple(leaf.shape) == spec.shape and leaf.dtype == \
            torch.bfloat16 == tm.dtype, name
    jspecs = jm.decode_state_specs(2, 16)
    specs = tm.decode_state_specs(2, 16)
    assert specs.keys() == jspecs.keys()
    for key in specs:
        assert {n: (tuple(s), str(d).split(".")[-1])
                for n, (s, d) in specs[key].items()} == {
            n: (v.shape, str(v.dtype)) for n, v in jspecs[key].items()}
    if arch == "llama-3.2-vision-90b":
        # [attn x 4, cross]: the cross slot's cache holds 1601 patches
        assert specs["slot4"]["k"][0] == (20, 2, 1601, 8, 128)


def test_training_is_not_ported():
    """Named for the refusal it replaced: the hybrid family trains.  The
    reduced Jamba's ``loss_fn`` (Mamba's train mode through the scan's
    backward, attention, the MoE) and every gradient against the
    reference's, from the same params and tokens; the gradients to
    tests/test_torch_lm_train_loss.py's 1e-5."""
    jcfg, cfg = configs("jamba-1.5-large-398b")
    jm, model = jbuild(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 38))
    toks = toks.astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "targets": jnp.asarray(toks[:, 1:])}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, jbatch)
    params = {k: v.requires_grad_(True)
              for k, v in tree_from_jax(jp, flat=True).items()}
    loss, aux = model.loss_fn(params, {"tokens": t(toks[:, :-1]),
                                       "targets": t(toks[:, 1:])})
    loss.backward()
    assert_rel(loss.detach(), jloss, MODULE_TOL, "loss")
    assert_rel(aux["aux"].detach(), jaux["aux"], MODULE_TOL, "aux")
    want = flat_dict(jax.tree.map(np.asarray, jgrads))
    assert list(params) == list(want)
    for k, w in want.items():
        assert_rel(params[k].grad, w, MODULE_TOL, k)
