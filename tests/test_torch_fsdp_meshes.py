"""Params at rest cut over ``data`` (FSDP) on the meshes besides the
collectives file's ``pod`` 1 x ``data`` 2 x ``model`` 2: real ``gloo``
ranks on the CPU, spawned once for each of ``pod`` 1 x ``data`` 2 x
``model`` 1 and ``pod`` 2 x ``data`` 2 x ``model`` 2.  On every rank, for
the reduced granite, Jamba, Qwen3-MoE and xLSTM: ``gather_params`` of
``shard_params`` is the whole tree bit for bit, and the rank's param and
FedAdam server-state bytes are ``dryrun.per_device_bytes`` of the params
and of the state on that mesh, to the byte."""
import numpy as np
import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun, spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from test_torch_fsdp_collectives import ARCHS, rest_cases, state_bytes

MESHES = {"1x2x1": (1, 2, 1), "2x2x2": (2, 2, 2)}


def rank_main(mesh):
    return rest_cases()


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, tmp_path_factory):
    name = request.param
    return name, spmd.run(rank_main, sizes=MESHES[name], device="cpu",
                          init_method=spmd.init_file(
                              tmp_path_factory.mktemp(f"fsdp_{name}")),
                          all_ranks=True, verbose=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_at_rest_round_trip_and_bytes(ranks, arch):
    name, got = ranks
    sizes = MESHES[name]
    model = build_model(reduced(get_config(arch)))
    mesh = sh.Mesh(("pod", "data", "model"), sizes,
                   tuple(range(int(np.prod(sizes)))))
    want = dryrun.per_device_bytes(model.param_specs(), model.logical_specs,
                                   mesh)
    assert want < sp.param_bytes(model.param_specs())
    for rank, out in enumerate(got):
        same, held, state, cut = out[arch]
        assert same, (name, arch, rank)
        assert held == want, (name, arch, rank, held, want)
        assert state == state_bytes(model, mesh), (name, arch, rank)
        assert "unembed" in cut, (name, arch)
