"""The port's mesh layer (``repro_torch.models.sharding``,
``repro_torch.launch.mesh``) against the reference's pure functions, on
mesh stand-ins of 16x16 ("data", "model"), 2x16x16 ("pod", "data",
"model") and 2x2x2 that carry only axis names and sizes: the reference's
``resolve``, ``batch_axes``, ``pspec``, ``fusion_axes`` and ``axis_size``
read only ``axis_names`` and ``shape``.  Each is compared under every
``exclude_axes`` set the rounds use.  Then ``shard``: the identity without
a mesh, on a 1x1 mesh and, under the SPMD convention (a tensor already is
its rank's share), on every spec, a ``model`` axis larger than 1 included,
where ``model_split`` splits what the axis divides and ``model_slice``
keeps whole what it does not; the mesh seen from another thread;
``flat_shard_index`` row-major; the production and test meshes' shapes;
and the round's guard: parallel mode under a mesh without
``client_spmd_axes`` raises as the reference does."""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.models import sharding as jsh
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import sharding as sh

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
ENTRIES = [None, sh.BATCH, sh.DATA, sh.MODEL, sh.POD, ("pod", "data"),
           ("data", "model"), ("model",), "absent", ("absent", "model")]
EXCLUDED = [(), ("data",), ("pod",), ("model",), ("pod", "data")]


def meshes(name):
    names, sizes = MESHES[name]
    port = sh.Mesh(names, sizes, tuple(range(int(np.prod(sizes)))))
    ref = SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))
    return port, ref


@pytest.mark.parametrize("excluded", EXCLUDED, ids=str)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_pure_functions_match_reference(name, excluded):
    port, ref = meshes(name)
    with sh.use_mesh(port), jsh.use_mesh(ref), sh.exclude_axes(*excluded), \
            jsh.exclude_axes(*excluded):
        assert sh.batch_axes() == jsh.batch_axes()
        assert sh.fusion_axes() == jsh.fusion_axes()
        for ax in ("pod", "data", "model", "absent"):
            assert sh.axis_size(ax) == jsh.axis_size(ax)
        for e in ENTRIES:
            assert sh.resolve(e, port) == jsh.resolve(e, ref), e
        for spec in itertools.product(ENTRIES[:6], repeat=2):
            got, want = sh.pspec(*spec), jsh.pspec(*spec)
            assert got == want and tuple(got) == tuple(want), spec


def test_no_mesh_matches_reference():
    assert sh.get_mesh() is None and jsh.get_mesh() is None
    assert sh.pspec(sh.BATCH, sh.MODEL) == jsh.pspec(sh.BATCH, sh.MODEL)
    assert sh.batch_axes() == jsh.batch_axes() == ()
    assert sh.fusion_axes() == jsh.fusion_axes() == ()
    assert sh.axis_size("model") == jsh.axis_size("model") == 1


def test_shard_is_the_identity_on_one_device():
    x = torch.arange(6.0).reshape(2, 3)
    assert sh.shard(x, sh.BATCH, None) is x
    with sh.use_mesh(make_test_mesh(device="cpu")) as mesh:
        assert mesh.shape == {"data": 1, "model": 1}
        assert sh.shard(x, sh.BATCH, sh.MODEL) is x
        assert sh.fusion_axes() == ()
    for name in MESHES:
        with sh.use_mesh(meshes(name)[0]):
            assert sh.shard(x, sh.BATCH, None) is x
            assert sh.shard(x, sh.DATA, (sh.POD, sh.DATA)) is x
            assert sh.shard(x, sh.BATCH, sh.MODEL) is x
            m = sh.axis_size("model")
            assert sh.model_split(m * 3) == m and sh.model_split(m + 1) == 1
            # a dim the axis does not divide stays whole
            assert sh.model_slice(m + 1) == (0, m + 1)
            with sh.exclude_axes(sh.MODEL):
                assert sh.shard(x, sh.BATCH, sh.MODEL) is x
                assert sh.model_split(m * 3) == 1
                assert sh.model_slice(m * 3) == (0, m * 3)
    with sh.use_mesh(sh.Mesh(("pod", "data", "model"), (2, 2, 1),
                             tuple(range(4)))):
        assert sh.shard(x, sh.BATCH, sh.MODEL) is x


def test_flat_shard_index_is_row_major():
    mesh, _ = meshes("2x16x16")
    axes = ("pod", "data", "model")
    for coords in [(0, 0, 0), (1, 3, 7), (1, 15, 15), (0, 2, 9)]:
        want = np.ravel_multi_index(coords, (2, 16, 16))
        assert sh.flat_shard_index(axes, dict(zip(axes, coords)),
                                   mesh) == want
    assert sh.flat_shard_index(("model", "pod"), {"model": 3, "pod": 1},
                               mesh) == 3 * 2 + 1


def test_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert len(multi.devices) == 512
    for n, shape in ((8, {"pod": 2, "data": 2, "model": 2}),
                     (4, {"data": 2, "model": 2}), (1, {"data": 1,
                                                        "model": 1})):
        assert make_test_mesh(n, device="cpu").shape == shape
    with pytest.raises(ValueError):
        sh.Mesh(("data",), (2,), (0,))
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh(device="cpu").device_mesh()


def test_parallel_round_under_a_mesh_needs_client_axes():
    from repro_torch.core import FLConfig, build_fl_round_step
    from repro_torch.optim import get_client_optimizer, get_server_optimizer
    args = (lambda p, b: (p["w"].sum(), {}), get_client_optimizer("sgd"),
            get_server_optimizer("fedavg"), FLConfig(num_clients=2))
    with sh.use_mesh(make_test_mesh(device="cpu")):
        with pytest.raises(ValueError, match="client_spmd_axes"):
            build_fl_round_step(*args)
        build_fl_round_step(*args, client_spmd_axes="data")
        build_fl_round_step(*args[:3], FLConfig(client_exec="sequential"))
    build_fl_round_step(*args)


def test_the_mesh_is_seen_from_another_thread():
    """The autograd engine runs a CUDA tensor's backward on a device thread
    of its own; a collective's backward and a layer group's recompute read
    the mesh there, so the mesh and the excluded axes are the process's,
    not the thread's."""
    import threading
    seen = {}
    mesh = make_production_mesh()

    def look():
        seen["mesh"], seen["excluded"] = sh.get_mesh(), sh.excluded_axes()
        seen["split"] = sh.model_split(32)

    with sh.use_mesh(mesh), sh.exclude_axes(sh.POD):
        t = threading.Thread(target=look)
        t.start()
        t.join()
    assert seen["mesh"] is mesh and seen["excluded"] == {sh.POD}
    assert seen["split"] == 16
    assert sh.get_mesh() is None
