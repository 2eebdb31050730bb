"""Three sync rounds of the port's Orchestrator and launcher against the
JAX package's, with deterministic rounding and client dropouts
(``dropout_prob`` 0.2).  Selection, participation, simulated durations,
uplink bytes and the virtual clock are host-side numpy draws from the same
seeds and must be identical; the params, from the same start, agree to
1e-4 (params are O(0.1)): float32 sums in another order over three rounds
can move a value across a half-way rounding point of the 8-bit quantize,
which shifts that one entry by one weighted quantization step (~3e-5
here), as the quantize contract of tests/test_kernels.py allows."""
import json
import re
import sys

import jax
import numpy as np
import pytest

from repro.core import CompressionConfig as JComp
from repro.core import FLConfig as JFL
from repro.data import FederatedDataset as JFed
from repro.data import medmnist_like as j_medmnist
from repro.data import partition_by_class as j_partition
from repro.launch import train as j_train
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import CNNConfig as JConfig
from repro.orchestrator import FaultConfig as JFaults
from repro.orchestrator import Orchestrator as JOrch
from repro.orchestrator import make_hybrid_fleet as j_fleet
from repro_torch import convert
from repro_torch.core import CompressionConfig, FLConfig
from repro_torch.data import FederatedDataset, medmnist_like, partition_by_class
from repro_torch.launch import train as t_train
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.orchestrator import FaultConfig, Orchestrator, make_hybrid_fleet

NARROW = dict(name="t", in_shape=(28, 28, 1), num_classes=9, channels=(4, 8),
              dense=16)
POOL, PER_ROUND, ROUNDS = 8, 4, 3
COMP = dict(quantize_bits=8, topk_frac=0.1, stochastic_rounding=False)


def build(pkg_fed, pkg_medmnist, pkg_partition, pkg_fleet):
    ds = pkg_medmnist(n=600, seed=0)
    fed = pkg_fed(ds, pkg_partition(ds.y, POOL, 3, seed=0), seed=0)
    fleet = pkg_fleet(POOL // 2, POOL - POOL // 2, seed=0,
                      data_sizes=[fed.client_size(c) for c in range(POOL)])
    return fed, fleet


@pytest.mark.parametrize("server", ["fedavg", "fedadam"])
def test_orchestrator_three_rounds_match_jax(server):
    fl_kw = dict(num_clients=PER_ROUND, local_steps=2, client_lr=0.08)
    jfed, jfleet = build(JFed, j_medmnist, j_partition, j_fleet)
    tfed, tfleet = build(FederatedDataset, medmnist_like, partition_by_class,
                         make_hybrid_fleet)
    jm, tm = JCNN(JConfig(**NARROW)), CNN(CNNConfig(**NARROW))
    jorch = JOrch(fleet=jfleet, fed_data=jfed, loss_fn=jm.loss_fn,
                  fl=JFL(compression=JComp(**COMP), **fl_kw),
                  server_opt_name=server, faults=JFaults(dropout_prob=0.2),
                  batch_size=8, flops_per_client_round=3e12, seed=0)
    torch_orch = Orchestrator(
        fleet=tfleet, fed_data=tfed, loss_fn=tm.loss_fn,
        fl=FLConfig(compression=CompressionConfig(**COMP), **fl_kw),
        server_opt_name=server, faults=FaultConfig(dropout_prob=0.2),
        batch_size=8, flops_per_client_round=3e12, seed=0, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    jp, _ = jorch.run(jp, ROUNDS)
    tp, _ = torch_orch.run(tp, ROUNDS)

    assert len(torch_orch.logs) == len(jorch.logs) == ROUNDS
    assert sum(l.participated for l in jorch.logs) < ROUNDS * PER_ROUND
    for jl, tl in zip(jorch.logs, torch_orch.logs):
        assert tl.selected == jl.selected
        assert tl.participated == jl.participated
        assert tl.duration_s == jl.duration_s
        assert tl.bytes_up == jl.bytes_up
        np.testing.assert_allclose(tl.client_loss, jl.client_loss, rtol=1e-4)
    assert torch_orch.virtual_clock == jorch.virtual_clock
    got = convert.params_to_numpy(tp)
    for k in jp:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


ROUND_LINE = re.compile(r"round\s+(\d+) loss=\S+ dur=(\S+)s part=(\d+)")


def test_launcher_three_rounds_match_jax(monkeypatch, capsys):
    argv = ["--dataset", "medmnist", "--rounds", str(ROUNDS),
            "--clients-pool", str(POOL), "--clients-per-round",
            str(PER_ROUND), "--local-steps", "1", "--batch-size", "8",
            "--quantize-bits", "8", "--no-stochastic-rounding",
            "--dropout-prob", "0.2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()
    jout = capsys.readouterr().out
    summary = t_train.main(["--device", "cpu"] + argv)
    tout = capsys.readouterr().out

    jsum = json.loads(jout[jout.index("{"):])
    for key in ("virtual_time_s", "mean_bytes_per_client_round",
                "mean_queue_wait_s", "overflow_clients", "preempted_clients",
                "rounds", "mode", "dataset"):
        assert summary[key] == jsum[key], key
    assert summary["device"] == "cpu"
    # per round: the same simulated duration and participation
    assert ROUND_LINE.findall(tout) == ROUND_LINE.findall(jout)
    assert len(ROUND_LINE.findall(tout)) == ROUNDS


COMMIT_LINE = re.compile(r"(commit|t2-epoch|t2-commit)\s+(\d+) t=\s*(\S+)s "
                         r"loss=\S+ (stale=\S+|wan_B=\d+)")
LAUNCH = ["--dataset", "medmnist", "--rounds", "2", "--clients-pool",
          str(POOL), "--clients-per-round", str(PER_ROUND), "--local-steps",
          "1", "--batch-size", "4", "--buffer-k", "2", "--max-concurrency",
          "3"]


@pytest.mark.parametrize("flag", [
    ["--mode", "async", "--engine", "window", "--event-window", "5"],
    ["--facilities", "2", "--local-rounds", "1"],
    ["--clients-pool", "300", "--mode", "async", "--engine", "auto",
     "--buffer-k", "8", "--max-concurrency", "16"],
    ["--facilities", "2", "--local-rounds", "1", "--mode", "async",
     "--inter-facility-mode", "async", "--inter-buffer", "2"]])
def test_launcher_unported_flags_raise(flag, monkeypatch, capsys):
    """The launcher branches the port had last (the event-window engine,
    ``--engine auto`` from 300 clients, the facility hierarchy under either
    inter-facility mode) run and agree with the reference launcher on the
    same flags: its summary keys (plus ``device``), their host values, and
    each commit's or tier-2 epoch's line but the loss."""
    argv = LAUNCH + flag
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()
    jout = capsys.readouterr().out
    tsum = t_train.main(["--device", "cpu"] + argv)
    tout = capsys.readouterr().out
    jsum = json.loads(jout[jout.index("\n{") + 1:])
    assert set(jsum) | {"device"} <= set(tsum)
    assert tsum["device"] == "cpu"
    floats = {"final_eval", "client_loss"}
    for key in set(jsum) - floats:
        assert tsum[key] == jsum[key], key
    lines = COMMIT_LINE.findall(tout)
    assert lines == COMMIT_LINE.findall(jout) and len(lines) == 2
    if "auto" in flag:
        assert "--engine auto: 300 clients -> window" in tout
        assert tsum["engine"] == "window"
