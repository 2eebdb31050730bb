"""The parallel round with the params held at rest cut over ``data``
(FSDP): four ``gloo`` ranks on the CPU (``pod`` 2 x ``data`` 2 x ``model``
1), the clients over ``pod`` and ``data`` (the reference's
``exclude_axes``), so the round gathers the params whole over ``data``
once, trains its clients on them and cuts the server step back to the
shares.  The reduced granite, Jamba, Qwen3-MoE and xLSTM, 4 clients x 2
local steps of batch 2 x 16 tokens, against the port's round with no
mesh, at ``test_torch_fsdp_rounds.py``'s bounds (``check_round``)."""
import pytest

from test_torch_fsdp_rounds import (ARCHS, check_round, no_mesh_rounds,
                                    run_rounds)

MODES = ("parallel",)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return (run_rounds(tmp_path_factory.mktemp("fsdp_parallel"), (2, 2, 1),
                       MODES, 4), no_mesh_rounds(MODES, 4))


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_parallel_round_matches_no_mesh(ranks, arch):
    check_round(*ranks, arch, "parallel")
