"""The port's secure-aggregation pieces and the two kernels of the secure
and FedProx paths, on the CPU (their plain PyTorch versions), against the
JAX package: its PRF (``repro.kernels.fused_quant_mask``), its oracles
(``repro.kernels.ref``), its entry points (``repro.kernels.ops``, Pallas in
interpret mode on the CPU) and ``repro.core.secure_agg``.

The reference's pair seeds and coefficients are passed in as data, with
coefficients that cancel and with coefficients that do not (so the mask
stream itself is held), and with stochastic rounding the same numpy noise
goes to both.  The port's secure commit and FedProx update equal the
reference's oracles bit for bit.  The reference's jitted paths (the Pallas
kernels in interpret mode, the jitted entry points) are not bit-equal to
those oracles themselves: XLA turns the division ``max|y| / qmax`` by a
constant into a multiply by its rounded reciprocal, and contracts the
FedProx update into two fused multiply-adds.  Against them the tolerance
is that rounding: one ulp of the scale (3e-7 relative, no absolute
slack), or two ulps of the update's largest term.  With masks that do not cancel, every output is a huge random
multiple of the scale, so even that tolerance holds the mask stream word
for word."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import secure_agg as jsec
from repro.core.compression import CompressionConfig as JComp
from repro.kernels import fused_quant_mask as jfqm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import CompressionConfig
from repro_torch.core import masked_payload_bytes
from repro_torch.core import secure_agg as sec
from repro_torch.kernels import launches
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fedprox_update import fedprox_update_flat
from repro_torch.kernels.fused_quant_mask import (fold_mask_words,
                                                  secure_commit_blocks)
from repro_torch.models.cnn import CIFAR_CNN, CNN
from test_torch_kernels import Elsewhere

K = 5
PARTICIPATION = np.array([1, 1, 0, 1, 1], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """torch on one intra-op thread for this module, restored after it.  The
    plain secure commit hashes [K, rows, block] grids of int64 words a slot
    at a time; split over OpenMP threads those grids ran ~130x slower than
    on one thread on an 8-core x86 host (mask sums over 257 peers, 3.46 s
    against 0.026 s for 20 slots), and the 1025-slot case took minutes.
    The module's checks hold on either thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def u32(a):
    """A JAX uint32 array as the port's int64-held uint32 tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def stack(seed, R=6, block=256, scale=0.01):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(K, R, block)) * scale).astype(np.float32)
    w = rng.uniform(0.5, 2.0, K).astype(np.float32) * PARTICIPATION
    return x, w


def coefficients(kind):
    """[K, K] int32 pair coefficients: the reference's cancelling ones
    (slot 2 out), the upper triangle only (symmetric seeds, masks that do
    not cancel), or a random {-1, 0, 1} matrix."""
    if kind == "cancelling":
        return np.asarray(jsec.pair_coef_int(jnp.arange(K, dtype=jnp.int32),
                                             jnp.asarray(PARTICIPATION)))
    if kind == "upper":
        return np.triu(np.ones((K, K), np.int32), 1)
    return np.random.default_rng(7).integers(-1, 2, (K, K)).astype(np.int32)


def assert_commit_equal(got, want, exact):
    """Bit for bit against an oracle; within one ulp of the scale (3e-7
    relative, no absolute slack) against a jitted path."""
    if exact:
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=3e-7, atol=0)


def seeds_for(seed):
    return jsec.pair_seeds(jax.random.PRNGKey(seed),
                           jnp.arange(K, dtype=jnp.int32))


def test_hash_u32_matches_jax_bit_for_bit():
    x = np.random.default_rng(0).integers(0, 2 ** 32, 4096,
                                          dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    want = np.asarray(jfqm.hash_u32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(tref.hash_u32(u32(x)).numpy(), want)


def test_mask_total_u32_matches_jax_bit_for_bit():
    seeds = seeds_for(1)
    coef = coefficients("random")
    idx = (np.uint32(2 ** 32 - 700)
           + np.arange(6 * 256, dtype=np.uint32).reshape(6, 256))
    for i in range(K):
        want = jfqm.mask_total_u32(seeds[i], jnp.asarray(coef[i]),
                                   jnp.asarray(idx))
        got = tref.mask_total_u32(u32(seeds[i]), t(coef[i]), u32(idx))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))


def fold_case(kind):
    """[K, K] pair seeds (uint32 values) and int32 coefficients for the
    fold: the reference's symmetric seeds with its cancelling, upper or
    random coefficients; random coefficients under asymmetric seeds; and
    the upper triangle where two pairs share one seed."""
    if kind == "random, asymmetric seeds":
        rng = np.random.default_rng(3)
        return (rng.integers(0, 2 ** 32, (K, K), dtype=np.uint64)
                .astype(np.uint32), coefficients("random"))
    seeds = np.array(seeds_for(4))
    if kind == "upper, two pairs share a seed":
        seeds[0, 1] = seeds[1, 0] = seeds[2, 3] = seeds[3, 2] = 12345
        return seeds, coefficients("upper")
    return seeds, coefficients(kind)


@pytest.mark.parametrize("kind", ["cancelling", "upper", "random",
                                  "random, asymmetric seeds",
                                  "upper, two pairs share a seed"])
def test_folded_mask_words_total_matches_jax_bit_for_bit(kind):
    """The folded words' mask total equals the sum over slots of the JAX
    reference's ``mask_total_u32``, bit for bit under wraparound."""
    seeds, coef = fold_case(kind)
    idx = (np.uint32(2 ** 32 - 700)
           + np.arange(6 * 256, dtype=np.uint32).reshape(6, 256))
    want = np.zeros(idx.shape, np.uint32)
    for i in range(K):
        want += np.asarray(jfqm.mask_total_u32(
            jnp.asarray(seeds[i]), jnp.asarray(coef[i]), jnp.asarray(idx)))
    fs, fc = fold_mask_words(u32(seeds), t(coef))
    got = tref.mask_total_u32(fs, fc, u32(idx))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert len(fs) <= K * K


@pytest.mark.parametrize("n_slots", [5, 20])
def test_fold_counts_the_words_that_do_not_cancel(n_slots):
    """The main path's coefficients (antisymmetric under symmetric seeds,
    a straggler out) fold to no word; the upper triangle alone to one word
    per pair; a diagonal entry stands alone."""
    ids = torch.arange(n_slots, dtype=torch.int32)
    part = torch.ones(n_slots)
    part[3] = 0.0
    seeds = sec.pair_seeds(sec.commit_key(9), ids)
    fs, _ = fold_mask_words(seeds, sec.pair_coef_int(ids, part))
    assert len(fs) == 0
    upper = torch.triu(torch.ones(n_slots, n_slots, dtype=torch.int32), 1)
    fs, fc = fold_mask_words(seeds, upper)
    assert len(fs) == n_slots * (n_slots - 1) // 2
    assert bool((fc == 1).all())
    diag = torch.eye(n_slots, dtype=torch.int32) * -1
    fs, fc = fold_mask_words(seeds, diag)
    assert torch.equal(fs, tref.to_u32(seeds.diagonal()))
    assert bool((fc == 2 ** 32 - 1).all())


@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("bits,k", [(8, 0), (8, 26), (4, 3), (2, 256)])
@pytest.mark.parametrize("coef_kind", ["cancelling", "upper", "random"])
def test_secure_commit_matches_jax(coef_kind, bits, k, against):
    x, w = stack(seed=bits + k)
    seeds, coef, base = seeds_for(k), coefficients(coef_kind), 3 * 2 ** 30
    got = secure_commit_blocks(t(x), t(w), u32(seeds), t(coef), base,
                               bits=bits, k=k).numpy()
    if against == "oracle":
        want = jref.fused_secure_commit_ref(
            jnp.asarray(x), jnp.asarray(w)[:, None], seeds,
            jnp.asarray(coef), jnp.uint32(base), bits, k=k)
    else:
        want = jfqm.secure_commit_blocks(
            jnp.asarray(x), jnp.asarray(w)[:, None], seeds, jnp.asarray(coef),
            jnp.full((1, 1), base, jnp.uint32), bits=bits, k=k,
            interpret=True)
    assert_commit_equal(got, want, exact=against == "oracle")


@pytest.mark.parametrize("bits,k", [(8, 0), (8, 26)])
@pytest.mark.parametrize("coef_kind", ["cancelling", "upper"])
def test_stochastic_secure_commit_matches_jax_bit_for_bit(coef_kind, bits, k):
    x, w = stack(seed=11)
    noise = np.random.default_rng(12).uniform(size=x.shape).astype(np.float32)
    seeds, coef = seeds_for(2), coefficients(coef_kind)
    got = secure_commit_blocks(t(x), t(w), u32(seeds), t(coef), 0, bits=bits,
                               k=k, noise=t(noise)).numpy()
    want = jref.fused_secure_commit_ref(
        jnp.asarray(x), jnp.asarray(w)[:, None], seeds, jnp.asarray(coef),
        jnp.uint32(0), bits, k=k, noise=jnp.asarray(noise))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_cancelling_masks_leave_the_common_grid_sum():
    """With cancelling coefficients the commit equals the unmasked sum on
    the commit-common grid (all-zero coefficients), bit for bit."""
    x, w = stack(seed=5)
    seeds = u32(seeds_for(3))
    masked = secure_commit_blocks(t(x), t(w), seeds,
                                  t(coefficients("cancelling")), 0, bits=8,
                                  k=26)
    plain = secure_commit_blocks(t(x), t(w), seeds,
                                 torch.zeros(K, K, dtype=torch.int32), 0,
                                 bits=8, k=26)
    torch.testing.assert_close(masked, plain, rtol=0, atol=0)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_bucketed_secure_tree_matches_jax(use_kernel):
    rng = np.random.default_rng(11)
    shapes = [(7,), (33, 9), (256,), (2, 5, 3), (515,)]
    leaves = [(rng.normal(size=(K,) + s) * 0.01).astype(np.float32)
              for s in shapes]
    w = rng.uniform(0.5, 2.0, K).astype(np.float32)
    seeds, coef = seeds_for(4), coefficients("cancelling")
    got = tops.fused_secure_commit_tree([t(l) for l in leaves], t(w),
                                        u32(seeds), t(coef), bits=8, k=26,
                                        use_kernel=use_kernel)
    want = jops.fused_secure_commit_tree([jnp.asarray(l) for l in leaves],
                                         jnp.asarray(w), seeds,
                                         jnp.asarray(coef), bits=8, k=26,
                                         use_pallas=use_kernel)
    for g, wt, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        assert_commit_equal(g.numpy(), wt, exact=False)


def test_per_leaf_secure_commit_with_base_matches_jax():
    rng = np.random.default_rng(13)
    x = (rng.normal(size=(K, 3, 300)) * 0.01).astype(np.float32)
    w = rng.uniform(0.5, 2.0, K).astype(np.float32)
    seeds, coef = seeds_for(6), coefficients("upper")
    got = tops.fused_secure_commit(t(x), t(w), u32(seeds), t(coef), 1000,
                                   bits=8, k=5)
    want = jops.fused_secure_commit(jnp.asarray(x), jnp.asarray(w), seeds,
                                    jnp.asarray(coef), 1000, bits=8, k=5)
    assert_commit_equal(got.numpy(), want, exact=False)


@pytest.mark.parametrize("bits", [0, 4, 8])
def test_masked_payload_bytes_equals_jax(bits):
    shapes = CNN(CIFAR_CNN).shapes()
    comp = dict(quantize_bits=bits, topk_frac=0.1)
    got = masked_payload_bytes({k: torch.zeros(s) for k, s in shapes.items()},
                               CompressionConfig(**comp), n_slots=20)
    want = jsec.masked_payload_bytes({k: jnp.zeros(s)
                                      for k, s in shapes.items()},
                                     JComp(**comp), n_slots=20)
    assert got == want


def test_pair_coefficients_match_jax():
    ids = np.array([3, 0, 7, 5, 1], np.int32)
    p = PARTICIPATION
    np.testing.assert_array_equal(
        sec.pair_coef_int(t(ids), t(p)).numpy(),
        np.asarray(jsec.pair_coef_int(jnp.asarray(ids), jnp.asarray(p))))
    np.testing.assert_array_equal(
        sec._pair_coef(t(ids), t(p)).numpy(),
        np.asarray(jsec._pair_coef(jnp.asarray(ids), jnp.asarray(p))))


def test_pair_seeds_are_symmetric_keyed_and_distinct():
    ids = torch.arange(6, dtype=torch.int32)
    s = sec.pair_seeds(sec.commit_key(1), ids)
    assert s.dtype == torch.int64 and int(s.min()) >= 0
    assert int(s.max()) < 2 ** 32
    torch.testing.assert_close(s, s.T, rtol=0, atol=0)
    off = s[torch.triu_indices(6, 6, 1).unbind()]
    assert len(set(off.tolist())) == off.numel()
    assert not torch.equal(s, sec.pair_seeds(sec.commit_key(2), ids))
    assert int(s[4, 1]) == sec.pair_seed(sec.commit_key(1), 1, 4)


def test_mask_batch_cancels_and_matches_mask_slot():
    rng = np.random.default_rng(8)
    tree = {"a": t(rng.normal(size=(K, 3, 7)).astype(np.float32)),
            "b": t(rng.normal(size=(K, 11)).astype(np.float32))}
    ids, p, key = torch.arange(K, dtype=torch.int32), t(PARTICIPATION), 99
    masked = sec.mask_batch(tree, key, ids, p)
    total = sec.aggregate_masked(masked, p)
    for name, leaf in tree.items():
        assert not torch.allclose(masked[name][0], leaf[0])
        want = (leaf * p.reshape((-1,) + (1,) * (leaf.ndim - 1))).sum(0)
        torch.testing.assert_close(total[name], want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(masked[name][2], leaf[2], rtol=0, atol=0)
    for i in range(K):
        one = sec.mask_slot(key, ids, p, i, {k: v[i] for k, v in tree.items()})
        for name in tree:
            torch.testing.assert_close(one[name], masked[name][i], rtol=0,
                                       atol=0)


def test_secure_weighted_mean_matches_jax():
    rng = np.random.default_rng(9)
    ups = {"a": rng.normal(size=(K, 4, 6)).astype(np.float32)}
    w = rng.uniform(1, 5, K).astype(np.float32)
    got = sec.secure_weighted_mean({"a": t(ups["a"])}, t(w), t(PARTICIPATION),
                                   sec.commit_key(0))
    want = jsec.secure_weighted_mean({"a": jnp.asarray(ups["a"])},
                                     jnp.asarray(w), jnp.asarray(PARTICIPATION),
                                     jsec.commit_key(0))
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("shape", [(7,), (33, 9), (8193,), (3, 3, 4, 8)])
def test_fedprox_update_matches_jax(shape, against):
    rng = np.random.default_rng(len(shape))
    w, g, w0 = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    got = tops.fedprox_update(t(w), t(g), t(w0), lr=0.05, mu=0.1)
    jw, jg, jw0 = (jnp.asarray(a) for a in (w, g, w0))
    assert tuple(got.shape) == shape
    if against == "oracle":
        want = jref.fedprox_update_ref(jw, jg, jw0, 0.05, 0.1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        # two fused multiply-adds: within two ulps of the largest of w,
        # the step and the result
        want = np.asarray(jops.fedprox_update(jw, jg, jw0, lr=0.05, mu=0.1))
        step = np.abs(np.float32(0.05) * (g + np.float32(0.1) * (w - w0)))
        ulp = np.spacing(np.maximum(np.maximum(np.abs(w), step),
                                    np.abs(want)))
        assert (np.abs(got.numpy() - want) <= 2 * ulp).all()


def test_stacked_fedprox_update_reads_one_global_copy():
    """[C, ...] clients against one [...] global leaf equals C calls of the
    reference oracle, one per client."""
    rng = np.random.default_rng(3)
    w, g = (rng.normal(size=(4, 9, 5)).astype(np.float32) for _ in range(2))
    w0 = rng.normal(size=(9, 5)).astype(np.float32)
    got = tops.fedprox_update(t(w), t(g), t(w0), lr=0.08, mu=0.02).numpy()
    for c in range(4):
        want = jref.fedprox_update_ref(jnp.asarray(w[c]), jnp.asarray(g[c]),
                                       jnp.asarray(w0), 0.08, 0.02)
        np.testing.assert_array_equal(got[c], np.asarray(want))


def test_new_wrappers_take_the_plain_version_on_cpu_and_refuse_bad_shapes():
    launches.reset()
    x, w = stack(seed=1)
    seeds, coef = u32(seeds_for(1)), t(coefficients("cancelling"))
    secure_commit_blocks(t(x), t(w), seeds, coef, 0, bits=8, k=26)
    fedprox_update_flat(torch.ones(2, 8), torch.ones(2, 8), torch.zeros(8),
                        0.1, 0.0)
    assert sum(launches.KERNEL_LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="pair matrix"):
        secure_commit_blocks(t(x), t(w), seeds[:2], coef, 0, bits=8, k=0)
    with pytest.raises(ValueError, match="noise"):
        secure_commit_blocks(t(x), t(w), seeds, coef, 0, bits=8, k=0,
                             noise=torch.zeros(1))
    with pytest.raises(ValueError, match="w0"):
        fedprox_update_flat(torch.ones(2, 8), torch.ones(2, 8),
                            torch.zeros(7), 0.1, 0.0)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        fedprox_update_flat(*(torch.zeros(s).as_subclass(Elsewhere)
                              for s in ((2, 8), (2, 8), (8,))), 0.1, 0.0)


def test_secure_commit_takes_more_than_1024_slots():
    """K = 1025, past the 1024 slots the CUDA kernel once took: the wrapper
    takes it, and on the CPU its plain version equals the reference's
    oracle bit for bit,
    with the upper-triangle coefficients (K(K-1)/2 mask words that do not
    cancel)."""
    n = 1025
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(n, 1, 128)) * 0.01).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    seeds = jsec.pair_seeds(jax.random.PRNGKey(3),
                            jnp.arange(n, dtype=jnp.int32))
    coef = np.triu(np.ones((n, n), np.int32), 1)
    got = secure_commit_blocks(t(x), t(w), u32(seeds), t(coef), 0, bits=8,
                               k=13).numpy()
    want = jref.fused_secure_commit_ref(
        jnp.asarray(x), jnp.asarray(w)[:, None], seeds, jnp.asarray(coef),
        jnp.uint32(0), 8, k=13)
    np.testing.assert_array_equal(got, np.asarray(want))
