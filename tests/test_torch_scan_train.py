"""The selective scan's backward in the port on the CPU against the JAX
package: the plain backward (``ref.selective_scan_chunk_bwd_ref``, the
kernel ``selective_scan_bwd``'s plain version) against ``jax.vjp`` of the
reference's ``kops.selective_scan_chunk`` (its custom VJP ``_ss_bwd``, an
associative scan, over the Pallas forward in interpret mode); the
autograd pair in ``kernels/ops.py`` under ``torch.func.grad`` and ``vmap``;
and Mamba's train mode, its output and every gradient, against the
reference's ``mamba_apply(mode="train")``.

Tolerances: 1e-5 relative against the reference, whose associative scan
sums in another order than the sequential plain version; bit for bit
against a numpy loop and, under ``vmap``, against per-client calls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro_torch.configs import get_config, reduced
from repro_torch.convert import tree_from_jax
from repro_torch.kernels import launches
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.selective_scan import selective_scan_chunk_bwd_blocks
from repro_torch.models import mamba as tmamba
from test_torch_kernels import Elsewhere

# the forward's shapes (tests/test_torch_scan.py)
PALLAS_SHAPES = [(1, 8, 128, 4), (2, 16, 256, 8), (3, 32, 384, 16),
                 (2, 16, 96, 8)]
TOL = 1e-5


def inputs(B, L, D, N, seed):
    """a, b, h0 as the forward's tests make them, and the cotangents of
    hs and h_last."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 1.0, (B, L, D, N)).astype(np.float32)
    b = rng.normal(0, 0.1, (B, L, D, N)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, D, N)).astype(np.float32)
    g_hs = rng.normal(0, 1, (B, L, D, N)).astype(np.float32)
    g_hl = rng.normal(0, 1, (B, D, N)).astype(np.float32)
    return a, b, h0, g_hs, g_hl


def assert_rel(got, want, tol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def reference_vjp(a, b, h0, g_hs, g_hl):
    _, vjp = jax.vjp(jops.selective_scan_chunk, *(jnp.asarray(x)
                                                   for x in (a, b, h0)))
    return vjp((jnp.asarray(g_hs), jnp.asarray(g_hl)))


@pytest.mark.parametrize("last", ["g_hl", "no g_hl"])
@pytest.mark.parametrize("B,L,D,N", PALLAS_SHAPES)
def test_plain_backward_matches_reference_vjp(B, L, D, N, last):
    a, b, h0, g_hs, g_hl = inputs(B, L, D, N, L * D + 1)
    if last == "no g_hl":
        g_hl = np.zeros_like(g_hl)
    hs, _ = tref.selective_scan_chunk_ref(*(torch.from_numpy(x)
                                            for x in (a, b, h0)))
    got = tref.selective_scan_chunk_bwd_ref(
        torch.from_numpy(a), hs, torch.from_numpy(h0),
        torch.from_numpy(g_hs),
        torch.from_numpy(g_hl) if last == "g_hl" else None)
    want = reference_vjp(a, b, h0, g_hs, g_hl)
    for x, y, name in zip(got, want, ("ga", "gb", "gh0")):
        assert_rel(x, y, TOL, name)


def test_plain_backward_is_the_sequential_recurrence():
    # a numpy loop, one rounding per multiply and per add, held bit for bit
    a, b, h0, g_hs, g_hl = inputs(2, 7, 16, 4, 3)
    hs, _ = tref.selective_scan_chunk_ref(*(torch.from_numpy(x)
                                            for x in (a, b, h0)))
    ga, gb, gh0 = tref.selective_scan_chunk_bwd_ref(
        torch.from_numpy(a), hs, torch.from_numpy(h0),
        torch.from_numpy(g_hs), torch.from_numpy(g_hl))
    hs = hs.numpy()
    G = g_hs[:, -1] + g_hl
    for t in range(6, -1, -1):
        if t < 6:
            G = g_hs[:, t] + a[:, t + 1] * G
        np.testing.assert_array_equal(gb[:, t].numpy(), G)
        h_prev = hs[:, t - 1] if t else h0
        np.testing.assert_array_equal(ga[:, t].numpy(), G * h_prev)
    np.testing.assert_array_equal(gh0.numpy(), a[:, 0] * G)


def test_autograd_matches_reference_vjp():
    """``ops.selective_scan_chunk`` under ``torch.func.grad`` and under
    ``Tensor.backward``: its backward is the wrapper's plain version on the
    CPU, with no launch."""
    a, b, h0, g_hs, g_hl = inputs(2, 16, 96, 8, 4)
    wh, wl = torch.from_numpy(g_hs), torch.from_numpy(g_hl)

    def loss(a, b, h0):
        hs, hl = tops.selective_scan_chunk(a, b, h0)
        return (hs * wh).sum() + (hl * wl).sum()

    launches.reset()
    got = grad(loss, argnums=(0, 1, 2))(*(torch.from_numpy(x)
                                          for x in (a, b, h0)))
    want = reference_vjp(a, b, h0, g_hs, g_hl)
    for x, y, name in zip(got, want, ("ga", "gb", "gh0")):
        assert_rel(x, y, TOL, name)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (a, b, h0)]
    loss(*leaves).backward()
    for leaf, x in zip(leaves, got):
        assert torch.equal(leaf.grad, x)
    assert not launches.KERNEL_LAUNCHES


@pytest.mark.parametrize("h0_batched", [True, False])
def test_vmap_grad_matches_per_client_grads(h0_batched):
    """The round's transform: ``vmap(grad)`` over C clients folds the
    clients into the scan's batch dim (the vmap rules of both
    autograd.Functions), bit for bit against C separate ``grad`` calls;
    an unbatched h0 is expanded.  Only the chunk's states reach the loss,
    so the backward sees no gradient of h_last."""
    C, B, L, D, N = 3, 2, 12, 20, 4
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.3, 1, (C, B, L, D, N)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, (C, B, L, D, N)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.normal(size=(C, B, D, N)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(B, L, D, N)).astype(np.float32))

    def loss(a, b, h0):
        # two chunks: the second starts from the first's last state
        hs1, h1 = tops.selective_scan_chunk(a[:, :5], b[:, :5], h0)
        hs2, _ = tops.selective_scan_chunk(a[:, 5:], b[:, 5:], h1)
        return (torch.cat([hs1, hs2], 1) * w).sum()

    g = grad(loss, argnums=(0, 1, 2))
    if h0_batched:
        got = vmap(g)(a, b, h0)
        want = [g(a[c], b[c], h0[c]) for c in range(C)]
    else:
        got = vmap(g, in_dims=(0, 0, None))(a, b, h0[0])
        want = [g(a[c], b[c], h0[0]) for c in range(C)]
    for i, name in enumerate(("ga", "gb", "gh0")):
        assert torch.equal(got[i], torch.stack([x[i] for x in want])), name


def test_double_backward_raises():
    a, b, h0, _, _ = (torch.from_numpy(x) for x in inputs(1, 4, 8, 2, 6))
    a.requires_grad_(True)
    hs, _ = tops.selective_scan_chunk(a, b, h0)
    (ga,) = torch.autograd.grad(hs.square().sum(), a, create_graph=True)
    with pytest.raises(NotImplementedError, match="no backward of its own"):
        ga.sum().backward()


def test_wrapper_checks_and_never_launches_on_the_cpu():
    a, b, h0, g_hs, g_hl = (torch.from_numpy(x)
                            for x in inputs(2, 6, 8, 2, 7))
    hs, _ = tref.selective_scan_chunk_ref(a, b, h0)
    launches.reset()
    got = selective_scan_chunk_bwd_blocks(a, hs, h0, g_hs, g_hl)
    want = tref.selective_scan_chunk_bwd_ref(a, hs, h0, g_hs, g_hl)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert launches.KERNEL_LAUNCHES["selective_scan_bwd"] == 0
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        selective_scan_chunk_bwd_blocks(*(x.as_subclass(Elsewhere) for x in
                                          (a, hs, h0, g_hs, g_hl)))
    with pytest.raises(ValueError, match="expected a, hs, g_hs"):
        selective_scan_chunk_bwd_blocks(a, hs[:, :3], h0, g_hs)
    with pytest.raises(ValueError, match="expected a, hs, g_hs"):
        selective_scan_chunk_bwd_blocks(a, hs, h0, g_hs, g_hl[:1])


# ---------------------------------------------------------------- Mamba
def _mamba_setup(seed=30):
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    pb = jcommon.ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jmamba.init_mamba(pb, ["m"], cfg.d_model, cfg.mamba, 0)
    jp = pb.params["m"]
    # 37 positions at chunk 16: two whole chunks and a remainder of 5
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    return cfg, jp, x, w


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mamba_train_mode_matches_reference(use_kernel):
    """Mamba's train mode: the output and the gradient of every parameter
    and of the input, under the loss sum(out * w), against the reference's
    train mode through its custom VJP (``use_kernel=True``) and through its
    default associative scan."""
    cfg, jp, x, w = _mamba_setup()

    def jloss(p, x):
        out, _ = jmamba.mamba_apply(p, x, cfg=cfg.mamba, mode="train",
                                    use_kernel=use_kernel)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tree_from_jax(jp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, state = tmamba.mamba_apply(tp, tx, cfg=cfg.mamba, mode="train")
    assert state is None
    (out * torch.from_numpy(w)).sum().backward()
    assert_rel(out, jout, TOL, "out")
    assert_rel(tx.grad, jgx, TOL, "x")
    assert tp.keys() == jgp.keys()
    for k in tp:
        assert_rel(tp[k].grad, jgp[k], TOL, k)


def test_mamba_train_equals_prefill_output():
    # the same conv, coefficients and scan, out of place in train mode
    cfg, jp, x, _ = _mamba_setup()
    tp = tree_from_jax(jp)
    out, _ = tmamba.mamba_apply(tp, torch.from_numpy(x), cfg=cfg.mamba,
                                mode="train")
    with torch.inference_mode():
        want, _ = tmamba.mamba_apply(tp, torch.from_numpy(x), cfg=cfg.mamba,
                                     mode="prefill")
    assert torch.equal(out.detach(), want)
