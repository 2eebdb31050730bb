"""The kernel entry points' row split (``kernels.ops.shard_rows_map`` and
``shard_rows_reduce``, the reference's ``_shard_rows_map`` /
``_shard_rows_reduce``), driven shard by shard on the CPU with the
kernels' plain versions: 2 and 4 simulated shards, with row counts that
need padding, equal the unsharded call bit for bit.  The secure commit's
shards start their mask streams at their global element offsets (``base``
plus the shard's first row times the block), so the masks of coefficients
that do not cancel still cancel against the unsharded stream: its result
is the unsharded one, not only the unmasked sum.  On one device
(``fusion_axes()`` empty) the entry points run one shard; a mesh with a
``model`` axis larger than 1 raises, naming the ``model`` item, and a
mesh record of several devices without processes cannot run the split
(``tests/test_torch_spmd_kernels.py`` runs it across processes)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import sharding as sh

K, R, BLOCK = 4, 13, 256          # 13 rows: padded for 2 and 4 shards


def stack(seed=0):
    x = np.random.default_rng(seed).normal(size=(K, R, BLOCK)) * 0.1
    return torch.from_numpy(x.astype(np.float32))


def pair_data(seed=1):
    rng = np.random.default_rng(seed)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (K, K)).astype(
        np.int64))
    coef = torch.from_numpy(rng.integers(-1, 2, (K, K)).astype(np.int32))
    return seeds, coef


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("base", [0, 7 * BLOCK])
def test_secure_commit_shard_by_shard(n, base):
    xb = stack()
    w = torch.tensor([[1.0], [2.0], [0.5], [1.5]])
    seeds, coef = pair_data()
    want = ref.fused_secure_commit_ref(xb, w, seeds, coef, base, 8, k=32)
    calls = []

    def shard(xl, b):
        calls.append((xl.shape[1], b))
        return ref.fused_secure_commit_ref(xl, w, seeds, coef, b, 8, k=32)

    got = ops.shard_rows_reduce(shard, xb, n, base)
    rows = -(-R // n)
    assert calls == [(rows, base + i * rows * BLOCK) for i in range(n)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_slot_reducing_commits_shard_by_shard(n):
    xb = stack(2)
    w, s = torch.tensor([1.0, 2.0, 0.5, 1.5]), torch.tensor([0., 1, 3, 2])
    for fn in (lambda x: ref.fused_accum_ref(x, w[:, None], s[:, None], 0.5),
               lambda x: ref.fused_plain_commit_ref(x, w[:, None], s[:, None],
                                                    0.5, 8, k=32)):
        got = ops.shard_rows_reduce(lambda xl, _: fn(xl), xb, n)
        assert torch.equal(got, fn(xb))


@pytest.mark.parametrize("n", [2, 4])
def test_row_maps_shard_by_shard(n):
    xb = stack(3)[0]
    for fn in (lambda b: ref.quantize_blocks(b, 8),
               lambda b: ref.topk_blocks(b, 32)):
        assert torch.equal(ops.shard_rows_map(fn, xb, n), fn(xb))


def test_entry_points_run_one_shard_on_one_device():
    """Under the 1x1 mesh the entry points equal the no-mesh call; on a
    record of devices with no process group, one whose ``model`` axis is
    larger than 1 included (``model`` is a fusion axis like the others),
    the row split raises for the want of one
    (``tests/test_torch_spmd_kernels.py`` runs them on ranks)."""
    x = stack(4)
    w, s = torch.tensor([1.0, 2.0, 0.5, 1.5]), torch.zeros(K)
    plain, kept = ops.fused_accum(x, w, s, 0.0), ops.topk_sparsify(x[0], k=32)
    with sh.use_mesh(make_test_mesh(device="cpu")):
        assert torch.equal(ops.fused_accum(x, w, s, 0.0), plain)
        assert torch.equal(ops.topk_sparsify(x[0], k=32), kept)
    with sh.use_mesh(make_production_mesh()):
        assert sh.fusion_axes() == ("data", "model")
        with pytest.raises(RuntimeError, match="mesh of processes"):
            ops.fused_accum(x, w, s, 0.0)
    with sh.use_mesh(sh.Mesh(("pod", "data", "model"), (2, 2, 1),
                             tuple(range(4)))):
        with pytest.raises(RuntimeError, match="mesh of processes"):
            ops.fused_accum(x, w, s, 0.0)
