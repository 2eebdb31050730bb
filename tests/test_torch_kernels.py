"""The port's commit kernels on the CPU (their plain PyTorch versions)
against the JAX package: its oracles (``repro.kernels.ref``) and its entry
points (``repro.kernels.ops``, Pallas in interpret mode on the CPU).

Tolerances: 1e-6 for the accumulate and top-k; the quantize contract of
tests/test_kernels.py for anything that quantizes (equal up to ulp noise,
or at most one quantization step on rare half-way rounding flips)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.compression import CompressionConfig
from repro_torch.kernels import launches
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_accum import fused_accum_blocks
from repro_torch.kernels.fused_quant_mask import plain_commit_blocks

SHAPES = [(64,), (8, 32), (3, 1000), (2, 7, 129), (4096,)]   # test_kernels
ODD_SHAPES = [(17,), (2, 5, 9), (3, 300), (1,), (2049,)]     # test_fused_kernels
K = 4


def rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


def slots(shape, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(K,) + shape) * scale).astype(np.float32)
    w = rng.uniform(0.5, 2.0, K).astype(np.float32)
    s = rng.integers(0, 5, K).astype(np.float32)
    return x, w, s


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_quantize_contract(got, want, step):
    """test_kernels.py:27-35: 1e-5 relative, or within one quantization
    step on rare .5 boundary flips."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    close = np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6
    boundary = np.abs(got - want) <= step * 1.001
    assert (close | boundary).all()
    assert close.mean() >= 0.99


@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_jax(shape, bits, against):
    x = rand(shape, seed=hash((shape, bits)) % 2**31)
    got = tops.quantize_dequant(t(x), bits=bits, block=128).numpy()
    jfn = jref.quantize_dequant_ref if against == "oracle" else \
        (lambda a, bits, block: jops.quantize_dequant(a, bits=bits,
                                                      block=block))
    want = np.asarray(jfn(jnp.asarray(x), bits=bits, block=128))
    assert got.shape == shape and got.dtype == np.float32
    assert_quantize_contract(got, want,
                             np.abs(x).max() / (2 ** (bits - 1) - 1))


@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_topk_matches_jax(shape, k, against):
    x = rand(shape, seed=hash((shape, k)) % 2**31)
    got = tops.topk_sparsify(t(x), k=k, block=128).numpy()
    if against == "oracle":
        want = jref.topk_sparsify_ref(jnp.asarray(x), k=k, block=128)
    else:
        want = jops.topk_sparsify(jnp.asarray(x), k=k, block=128)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_topk_keeps_ties_and_padding_lanes():
    """Sort threshold, ties kept; zero padding lanes belong to the block (a
    7-wide leaf in a 128 block keeps everything when k exceeds its 7
    nonzeros, as the reference's blocking does)."""
    x = np.array([[1.0, -2.0, 2.0, 0.5, -2.0, 0.1, 3.0]], np.float32)
    got = tops.topk_sparsify(t(x), k=3, block=128).numpy()
    np.testing.assert_array_equal(got, [[0, -2, 2, 0, -2, 0, 3]])
    got = tops.topk_sparsify(t(x), k=64, block=128).numpy()
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_fused_accum_matches_jax(shape):
    x, w, s = slots(shape, seed=len(shape) + shape[-1])
    got = tops.fused_accum(t(x), t(w), t(s), 0.5).numpy()
    want = jops.fused_accum(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                            0.5)
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits,k", [(0, 1), (0, 26), (4, 0), (4, 1),
                                    (4, 26), (8, 0), (8, 1), (8, 26)])
@pytest.mark.parametrize("shape", ODD_SHAPES + [(515,)])
def test_fused_plain_commit_matches_jax(shape, bits, k):
    x, w, s = slots(shape, seed=bits + k)
    got = tops.fused_plain_commit(t(x), t(w), t(s), 0.5, bits=bits,
                                  k=k).numpy()
    want = np.asarray(jops.fused_plain_commit(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), 0.5, bits=bits, k=k))
    if bits:
        w_eff = w * (1 + s) ** -0.5
        step = w_eff.max() * np.abs(x).max() / (2 ** (bits - 1) - 1)
        assert_quantize_contract(got, want, step)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_plain_commit_blocks_matches_oracle():
    """The blocked plain version against the JAX oracle on a [K, R, 256]
    stack at the launcher's compression (8 bits, top-k of 10%)."""
    x, w, s = slots((6, 256), seed=3)
    k = CompressionConfig(quantize_bits=8, topk_frac=0.1).topk_k
    got = tref.fused_plain_commit_ref(t(x), t(w)[:, None], t(s)[:, None],
                                      0.0, 8, k=k).numpy()
    want = np.asarray(jref.fused_plain_commit_ref(
        jnp.asarray(x), jnp.asarray(w)[:, None], jnp.asarray(s)[:, None],
        0.0, 8, k=k))
    assert_quantize_contract(got, want,
                             w.max() * np.abs(x).max() / 127)


@pytest.mark.parametrize("which", ["accum", "plain"])
def test_bucketed_tree_matches_jax(which):
    rng = np.random.default_rng(11)
    shapes = [(7,), (33, 9), (256,), (2, 5, 3), (515,)]
    leaves = [(rng.normal(size=(K,) + s) * 0.01).astype(np.float32)
              for s in shapes]
    w = rng.uniform(0.5, 2.0, K).astype(np.float32)
    s = rng.integers(0, 5, K).astype(np.float32)
    if which == "accum":
        got = tops.fused_accum_tree([t(l) for l in leaves], t(w), t(s), 0.5)
        want = jops.fused_accum_tree([jnp.asarray(l) for l in leaves],
                                     jnp.asarray(w), jnp.asarray(s), 0.5)
    else:
        got = tops.fused_plain_commit_tree([t(l) for l in leaves], t(w),
                                           t(s), 0.5, bits=8, k=26)
        want = jops.fused_plain_commit_tree([jnp.asarray(l) for l in leaves],
                                            jnp.asarray(w), jnp.asarray(s),
                                            0.5, bits=8, k=26)
    for g, wt, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=1e-5,
                                   atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    launches.reset()
    x, w, s = slots((3, 300), seed=1)
    tops.fused_accum_tree([t(x)], t(w), t(s), 0.0)
    tops.fused_plain_commit_tree([t(x)], t(w), t(s), 0.0, bits=8, k=26)
    tops.quantize_dequant(t(x), bits=8)
    tops.topk_sparsify(t(x), k=26)
    assert sum(launches.KERNEL_LAUNCHES.values()) == 0


class Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel and no plain
    version (not the CPU, ``meta`` or CUDA)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_other_devices_raise_instead_of_falling_back():
    x = torch.zeros((2, 256)).as_subclass(Elsewhere)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        tops.quantize_dequant(x, bits=8)
    with pytest.raises(ValueError, match="several devices"):
        tops.fused_accum(torch.zeros(2, 256), torch.ones(2, device="meta"),
                         torch.zeros(2), 0.0)


def test_wrappers_refuse_mismatched_shapes():
    from repro_torch.kernels.fused_accum import fused_accum_blocks
    from repro_torch.kernels.quantize import quantize_dequant_blocks
    with pytest.raises(ValueError, match="slot vector"):
        fused_accum_blocks(torch.zeros(3, 2, 128), torch.ones(2),
                           torch.zeros(3), 0.0)
    with pytest.raises(ValueError, match="2-d blocks"):
        quantize_dequant_blocks(torch.zeros(3, 2, 128), 8)


@pytest.mark.parametrize("bits,k", [(0, 0), (8, 13)])
def test_commit_wrappers_take_more_slots_than_staged_weights(bits, k):
    """K = 12289, past the 12288 slot weights the CUDA fused accumulate
    stages in shared memory: the wrappers take it, and on the CPU their
    plain versions agree with the reference's oracles."""
    n = 12289
    rng = np.random.default_rng(22)
    x = (rng.normal(size=(n, 1, 128)) * 0.01).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    s = rng.integers(0, 5, n).astype(np.float32)
    want = np.asarray(jref.fused_plain_commit_ref(
        jnp.asarray(x), jnp.asarray(w)[:, None], jnp.asarray(s)[:, None],
        0.5, bits, k=k))
    got = plain_commit_blocks(t(x), t(w), t(s), 0.5, bits=bits, k=k).numpy()
    if bits:
        w_eff = w * (1 + s) ** -0.5
        assert_quantize_contract(got, want, w_eff.max() * np.abs(x).max()
                                 / 127)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        acc = fused_accum_blocks(t(x), t(w), t(s), 0.5).numpy()
        np.testing.assert_allclose(acc, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
