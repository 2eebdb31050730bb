"""The port's selective scan on the CPU (its plain version, a sequential
loop in float32) against the JAX package: its entry point
(``repro.kernels.ops.selective_scan_chunk``, the Pallas kernel in interpret
mode on the CPU) and its oracle (``repro.kernels.ref.selective_scan_chunk_ref``,
an associative scan).

Tolerances: 1e-5 relative against the associative scan, whose summation
order differs; 1e-6 relative against the Pallas kernel, which runs the
same sequential loop under XLA (which may contract the step into a fused
multiply-add); bit for bit against a numpy loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import launches
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.selective_scan import selective_scan_chunk_blocks
from test_torch_kernels import Elsewhere

# tests/test_kernels.py's shapes, plus a D that is not a multiple of 128
# (the Pallas kernel takes it as one tile of D)
PALLAS_SHAPES = [(1, 8, 128, 4), (2, 16, 256, 8), (3, 32, 384, 16),
                 (2, 16, 96, 8)]


def inputs(B, L, D, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 1.0, (B, L, D, N)).astype(np.float32)
    b = rng.normal(0, 0.1, (B, L, D, N)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, D, N)).astype(np.float32)
    return a, b, h0


def scan(a, b, h0):
    hs, hl = tops.selective_scan_chunk(*(torch.from_numpy(x)
                                         for x in (a, b, h0)))
    return hs.numpy(), hl.numpy()


def assert_rel(got, want, tol):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("B,L,D,N", PALLAS_SHAPES)
def test_matches_pallas_and_oracle(B, L, D, N):
    a, b, h0 = inputs(B, L, D, N, L * D)
    hs, hl = scan(a, b, h0)
    args = tuple(jnp.asarray(x) for x in (a, b, h0))
    for (want_hs, want_hl), tol in ((jops.selective_scan_chunk(*args), 1e-6),
                                    (jref.selective_scan_chunk_ref(*args),
                                     1e-5)):
        assert_rel(hs, np.asarray(want_hs), tol)
        assert_rel(hl, np.asarray(want_hl), tol)
    np.testing.assert_array_equal(hl, hs[:, -1])


def test_d_beyond_pallas_tiling():
    # D = 200 is neither a multiple of 128 nor one tile: the Pallas kernel
    # refuses it, the port takes any D
    a, b, h0 = inputs(2, 12, 200, 4, 1)
    hs, hl = scan(a, b, h0)
    want_hs, want_hl = jref.selective_scan_chunk_ref(
        *(jnp.asarray(x) for x in (a, b, h0)))
    assert_rel(hs, np.asarray(want_hs), 1e-5)
    assert_rel(hl, np.asarray(want_hl), 1e-5)


def test_strided_chunk_view():
    # the Mamba block hands the scan chunk views a[:, s0:s1] of a whole
    # [B, S, D, N] tensor: contiguous within a batch row, not across rows
    a, b, h0 = inputs(3, 40, 64, 8, 2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    va, vb = ta[:, 16:32], tb[:, 16:32]
    assert not va.is_contiguous()
    hs, hl = selective_scan_chunk_blocks(va, vb, torch.from_numpy(h0))
    hs_c, hl_c = selective_scan_chunk_blocks(va.contiguous(),
                                             vb.contiguous(),
                                             torch.from_numpy(h0))
    assert torch.equal(hs, hs_c) and torch.equal(hl, hl_c)
    want_hs, want_hl = jops.selective_scan_chunk(
        jnp.asarray(a[:, 16:32]), jnp.asarray(b[:, 16:32]), jnp.asarray(h0))
    assert_rel(hs.numpy(), np.asarray(want_hs), 1e-6)
    assert_rel(hl.numpy(), np.asarray(want_hl), 1e-6)


def test_sequential_semantics():
    # tests/test_kernels.py's hand-rolled loop, held bit for bit: the plain
    # version rounds once per multiply and once per add, as numpy does
    B, L, D, N = 1, 5, 128, 2
    rng = np.random.default_rng(5)
    a = rng.uniform(0.2, 0.9, (B, L, D, N)).astype(np.float32)
    b = rng.normal(0, 1, (B, L, D, N)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, D, N)).astype(np.float32)
    hs, hl = scan(a, b, h0)
    h = h0.copy()
    for t in range(L):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_array_equal(hs[:, t], h)
    np.testing.assert_array_equal(hl, h)


def test_backward_is_not_ported():
    """Named for the refusal it replaced: the scan's backward runs.  Its
    gradients through ``Tensor.backward`` against ``jax.vjp`` of the
    reference's custom VJP under the same cotangents (1 for every hs and
    h_last), to the associative scan's 1e-5 (tests/test_torch_scan_train.py
    holds it at every shape)."""
    a, b, h0 = inputs(1, 4, 8, 2, 3)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (a, b, h0)]
    hs, hl = tops.selective_scan_chunk(*leaves)
    (hs.sum() + hl.sum()).backward()
    (want_hs, want_hl), vjp = jax.vjp(jops.selective_scan_chunk,
                                      *(jnp.asarray(x) for x in (a, b, h0)))
    want = vjp((jnp.ones_like(want_hs), jnp.ones_like(want_hl)))
    for leaf, w in zip(leaves, want):
        assert_rel(leaf.grad.numpy(), np.asarray(w), 1e-5)


def test_cpu_never_launches_and_other_devices_raise():
    launches.reset()
    a, b, h0 = (torch.from_numpy(x) for x in inputs(2, 4, 8, 2, 4))
    tref_hs, tref_hl = tref.selective_scan_chunk_ref(a, b, h0)
    hs, hl = tops.selective_scan_chunk(a, b, h0)
    assert torch.equal(hs, tref_hs) and torch.equal(hl, tref_hl)
    assert launches.KERNEL_LAUNCHES["selective_scan"] == 0
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        selective_scan_chunk_blocks(*(x.as_subclass(Elsewhere)
                                      for x in (a, b, h0)))
    with pytest.raises(ValueError, match="expected a, b"):
        selective_scan_chunk_blocks(a, b[:, :2], h0)
