"""Secure aggregation end to end in the port against the JAX package: one
round in every execution mode, three Orchestrator rounds, and the
launcher's ``--secure-agg``.

The two packages draw different masks (their pair keys come from
different PRFs), but masks cancel: the integer-domain commit (8-bit
quantization) exactly, the float-domain masks to float32 cancellation
error.  So from the same params, batches, weights and mask (one client
masked out) the new params agree to 1e-5 relative, as the unmasked rounds
do, and the masked uplink bytes are equal."""
import json
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
from test_torch_modes import assert_round_close, run_both


@pytest.mark.parametrize("aggregation", ["fedavg", "weighted"])
@pytest.mark.parametrize("comp", ["none", "q8_topk"])
def test_secure_parallel_round_matches_jax(comp, aggregation):
    j, t = run_both(comp, secure_agg=True, aggregation=aggregation)
    assert_round_close(j, t)


@pytest.mark.parametrize("comp", ["none", "q8_topk"])
@pytest.mark.parametrize("mode,n_pods,hierarchical", [
    ("sequential", 1, False), ("pod_sequential", 2, False),
    ("parallel", 2, True)])
def test_secure_streaming_and_pod_rounds_match_jax(mode, n_pods,
                                                   hierarchical, comp):
    """Float-domain masks per streamed slot (sequential) and between pods
    (pod_sequential, the hierarchical combine)."""
    j, t = run_both(comp, n_pods=n_pods, client_exec=mode,
                    hierarchical=hierarchical, secure_agg=True)
    assert_round_close(j, t)


NARROW = dict(name="t", in_shape=(28, 28, 1), num_classes=9, channels=(4, 8),
              dense=16)
POOL, PER_ROUND, ROUNDS = 8, 4, 3


def build(pkg_fed, pkg_medmnist, pkg_partition, pkg_fleet):
    ds = pkg_medmnist(n=600, seed=0)
    fed = pkg_fed(ds, pkg_partition(ds.y, POOL, 3, seed=0), seed=0)
    fleet = pkg_fleet(POOL // 2, POOL - POOL // 2, seed=0,
                      data_sizes=[fed.client_size(c) for c in range(POOL)])
    return fed, fleet


@pytest.mark.parametrize("bits", [0, 8])
def test_secure_orchestrator_three_rounds_match_jax(bits):
    comp = dict(quantize_bits=bits, topk_frac=0.1, stochastic_rounding=False)
    fl_kw = dict(num_clients=PER_ROUND, local_steps=2, client_lr=0.08,
                 secure_agg=True)
    jfed, jfleet = build(JFed, j_medmnist, j_partition, j_fleet)
    tfed, tfleet = build(FederatedDataset, medmnist_like, partition_by_class,
                         make_hybrid_fleet)
    jm, tm = JCNN(JConfig(**NARROW)), CNN(CNNConfig(**NARROW))
    jorch = JOrch(fleet=jfleet, fed_data=jfed, loss_fn=jm.loss_fn,
                  fl=JFL(compression=JComp(**comp), **fl_kw),
                  faults=JFaults(dropout_prob=0.2), batch_size=8,
                  flops_per_client_round=3e12, seed=0)
    torch_orch = Orchestrator(
        fleet=tfleet, fed_data=tfed, loss_fn=tm.loss_fn,
        fl=FLConfig(compression=CompressionConfig(**comp), **fl_kw),
        faults=FaultConfig(dropout_prob=0.2), batch_size=8,
        flops_per_client_round=3e12, seed=0, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    jp, _ = jorch.run(jp, ROUNDS)
    tp, _ = torch_orch.run(tp, ROUNDS)

    assert sum(l.participated for l in jorch.logs) < ROUNDS * PER_ROUND
    for jl, tl in zip(jorch.logs, torch_orch.logs):
        assert tl.selected == jl.selected
        assert tl.participated == jl.participated
        assert tl.duration_s == jl.duration_s
        assert tl.bytes_up == jl.bytes_up > 0
    assert torch_orch.virtual_clock == jorch.virtual_clock
    got = convert.params_to_numpy(tp)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_secure_launcher_matches_jax(monkeypatch, capsys):
    argv = ["--dataset", "medmnist", "--rounds", "2", "--clients-pool",
            str(POOL), "--clients-per-round", str(PER_ROUND),
            "--local-steps", "1", "--batch-size", "8", "--secure-agg",
            "--quantize-bits", "8", "--no-stochastic-rounding"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()
    jout = capsys.readouterr().out
    summary = t_train.main(["--device", "cpu"] + argv)
    jsum = json.loads(jout[jout.index("{"):])
    assert summary["secure_agg"] is jsum["secure_agg"] is True
    for key in ("virtual_time_s", "mean_bytes_per_client_round", "rounds"):
        assert summary[key] == jsum[key], key
    assert all(np.isfinite(summary["client_loss"]))
