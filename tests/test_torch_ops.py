"""The port's blocking and leaf bucketing (``repro_torch.kernels.ops``)
against the JAX package's: same row counts, same bucket layout, and
buckets that round-trip."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.models.cnn import CIFAR_CNN, CNN

SHAPES = [(7,), (33, 9), (256,), (2, 5, 3), (515,), (3, 3, 4, 8)]


def leaves(K, shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(K,) + s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("block", [128, 256])
def test_pack_blocks_layout_equals_jax(block):
    ls = leaves(3, SHAPES)
    tb, _, trows = tops.pack_blocks([torch.from_numpy(l) for l in ls], block)
    jb, _, jrows = jops.pack_blocks([jnp.asarray(l) for l in ls], block)
    assert trows == jrows
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_cifar_cnn_bucket_rows():
    """The full-width CIFAR CNN packs into one bucket of 4671 rows of 256,
    leaf by leaf in sorted-key order (the jax.tree order)."""
    shapes = CNN(CIFAR_CNN).shapes()
    names = sorted(shapes)
    assert names == ["conv0_b", "conv0_w", "conv1_b", "conv1_w", "dense1_b",
                     "dense1_w", "dense2_b", "dense2_w"]
    assert sum(int(np.prod(s)) for s in shapes.values()) == 1_070_794
    stack = [torch.zeros((1,) + shapes[n]) for n in names]
    bucket, _, rows = tops.pack_blocks(stack, 256)
    assert rows == [1, 27, 1, 288, 1, 4096, 1, 256]
    assert tuple(bucket.shape) == (1, 4671, 256)


def test_bucket_round_trips():
    ls = [torch.from_numpy(l) for l in leaves(1, SHAPES, seed=1)]
    bucket, metas, rows = tops.pack_blocks(ls, 256)
    back = tops.unpack_sums(bucket[0], metas, rows)
    for got, want in zip(back, ls):
        torch.testing.assert_close(got, want[0], rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(5,), (3, 300), (2, 7, 129), ()])
def test_as_blocks_round_trips(shape):
    x = torch.from_numpy(np.random.default_rng(2).normal(size=shape)
                         .astype(np.float32))
    xb, meta = tops._as_blocks(x, 128)
    assert xb.shape[-1] == 128 and xb.is_contiguous()
    torch.testing.assert_close(tops._from_blocks(xb, meta, x.shape, x.dtype),
                               x, rtol=0, atol=0)
