"""Six commits of the port's ``AsyncOrchestrator`` against the JAX
package's, on the same seeds, fleet, data and (carried) params, across the
regime's paths: the default, timeout commits, partition and preemption
faults under the resume and adaptive recovery policies, the adaptive
staleness exponent, the chunked commit, and the scheduler backend.

Every host-side draw (selection, contention noise, fault dice, batch
sampling, the scheduler's pools) comes from the same numpy streams, so the
processed-event trace, the comm ledger and every host field of each
CommitLog are exactly equal.  The client losses, delta norms and (under the
adaptive exponent, fed by the delta norm) alphas agree to 1e-5 relative,
and the final params to 1e-4: float32 sums in another order over six
commits.  Then the port's batched engine against its per-event engine:
equal events, logs and params, bit for bit (both train a client as one
lane of a stacked call, whose result does not depend on the lane count)."""
import math
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from repro.core import AsyncConfig as JAsync
from repro.core import FLConfig as JFL
from repro.data import FederatedDataset as JFed
from repro.data import medmnist_like as j_medmnist
from repro.data import partition_dirichlet as j_partition
from repro.exec import make_backend as j_backend
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import CNNConfig as JConfig
from repro.orchestrator import AsyncOrchestrator as JOrch
from repro.orchestrator import FaultConfig as JFaults
from repro.orchestrator import StragglerPolicy as JStraggler
from repro.orchestrator import make_hybrid_fleet as j_fleet
from repro.sched import K8sAdapter as JK8s
from repro.sched import SlurmAdapter as JSlurm
from repro_torch import convert
from repro_torch.core import AsyncConfig, FLConfig
from repro_torch.data import (FederatedDataset, medmnist_like,
                              partition_dirichlet)
from repro_torch.exec import make_backend
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.orchestrator import (AsyncOrchestrator,
                                      BatchedAsyncOrchestrator, FaultConfig,
                                      StragglerPolicy, make_hybrid_fleet)
from repro_torch.sched import K8sAdapter, SlurmAdapter

TINY = dict(name="tiny-cnn", in_shape=(28, 28, 1), num_classes=9,
            channels=(4, 8), dense=32)
SEED, N_CLIENTS, N_COMMITS = 11, 6, 6
PARTITION_FAULTS = dict(partition_prob=0.9, partition_len=3,
                        spot_preempt_prob=0.3)
# case -> (AsyncConfig changes, FaultConfig kwargs, scheduler backend)
CASES = {
    "default": ({}, {}, False),
    "timeout": (dict(buffer_size=64, commit_timeout_s=1.0), {}, False),
    "partition_resume": ({}, dict(PARTITION_FAULTS,
                                  recovery_policy="resume"), False),
    "partition_adaptive": ({}, dict(PARTITION_FAULTS,
                                    recovery_policy="adaptive"), False),
    "adaptive_exponent": (dict(staleness_exponent="adaptive"), {}, False),
    "commit_chunk": (dict(buffer_size=4, commit_chunk=2), {}, False),
    "scheduler": ({}, dict(dropout_prob=0.1, spot_preempt_prob=0.2,
                           recovery_policy="adaptive"), True),
}
# the reference's jitted steps depend only on the FLConfig (the exponent is
# a runtime scalar): share them across its orchestrators
_JSTEPS: dict = {}


def async_kw(changes):
    return dict(dict(buffer_size=3, max_concurrency=4), **changes)


def setup(pkg):
    """(fleet, federated data) of one package, from the same seeds."""
    medmnist, partition, fed_cls, fleet_fn = pkg
    data = medmnist(n=400, seed=SEED)
    parts = partition(data.y, N_CLIENTS, alpha=0.5, seed=SEED)
    fleet = fleet_fn(N_CLIENTS // 2, N_CLIENTS - N_CLIENTS // 2, seed=SEED,
                     data_sizes=[len(p) for p in parts])
    return fleet, fed_cls(data, parts, seed=SEED)


def j_orch(case):
    changes, faults, scheduler = CASES[case]
    fleet, fed = setup((j_medmnist, j_partition, JFed, j_fleet))
    backend = j_backend("scheduler", slurm=JSlurm(total_nodes=2, seed=3),
                        k8s=JK8s(initial_nodes=1, max_nodes=3,
                                 preempt_prob_per_min=2.0, seed=4)) \
        if scheduler else None
    orch = JOrch(
        fleet=fleet, fed_data=fed, loss_fn=JCNN(JConfig(**TINY)).loss_fn,
        fl=JFL(mode="async", num_clients=N_CLIENTS, local_steps=1,
               client_lr=0.05),
        async_cfg=JAsync(**async_kw(changes)),
        straggler=JStraggler(contention_sigma=0.5),
        faults=JFaults(**faults), backend=backend, batch_size=8,
        flops_per_client_round=2e12, seed=SEED)
    if "steps" in _JSTEPS:
        orch._client_update, orch._commit_step = _JSTEPS["steps"]
    else:
        _JSTEPS["steps"] = (orch._client_update, orch._commit_step)
    return orch


def t_orch(case, cls=AsyncOrchestrator, **engine_kw):
    changes, faults, scheduler = CASES[case]
    fleet, fed = setup((medmnist_like, partition_dirichlet, FederatedDataset,
                        make_hybrid_fleet))
    backend = make_backend("scheduler", slurm=SlurmAdapter(total_nodes=2,
                                                            seed=3),
                           k8s=K8sAdapter(initial_nodes=1, max_nodes=3,
                                          preempt_prob_per_min=2.0, seed=4)) \
        if scheduler else None
    return cls(
        fleet=fleet, fed_data=fed, loss_fn=CNN(CNNConfig(**TINY)).loss_fn,
        fl=FLConfig(mode="async", num_clients=N_CLIENTS, local_steps=1,
                    client_lr=0.05),
        async_cfg=AsyncConfig(**async_kw(changes)),
        straggler=StragglerPolicy(contention_sigma=0.5),
        faults=FaultConfig(**faults), backend=backend, batch_size=8,
        flops_per_client_round=2e12, seed=SEED, device="cpu", **engine_kw)


@pytest.fixture(scope="module")
def params():
    jp = JCNN(JConfig(**TINY)).init(jax.random.PRNGKey(SEED))
    return {k: np.asarray(v) for k, v in jp.items()}


FLOAT_FIELDS = ("client_loss", "delta_norm", "staleness_alpha")


def host_fields(log) -> dict:
    """A CommitLog's host fields: everything but the float results of the
    device math and the wall-clock profile; NaN made comparable."""
    d = asdict(log)
    for k in FLOAT_FIELDS + ("phase_wall",):
        d.pop(k)
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in d.items()}


def counters(o):
    return (o.version, o.updates_applied, o.dropped_stale,
            o.recovered_updates, o.lost_to_faults, o.clock)


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_orchestrator_matches_jax(params, case):
    jo, to = j_orch(case), t_orch(case)
    jp, _ = jo.run(params, N_COMMITS)
    tp, _ = to.run(convert.params_from_jax(params), N_COMMITS)

    assert to.events_processed == jo.events_processed
    assert [asdict(r) for r in to.comm.records] \
        == [asdict(r) for r in jo.comm.records]
    assert counters(to) == counters(jo)
    assert len(to.logs) == len(jo.logs) == N_COMMITS
    for jl, tl in zip(jo.logs, to.logs):
        assert host_fields(tl) == host_fields(jl)
        for k in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(tl, k), getattr(jl, k),
                                       rtol=1e-5, err_msg=k)
        assert tl.phase_wall["host_syncs"] > 0
    got = convert.params_to_numpy(tp)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # each case reaches the path it names
    if case == "timeout":
        assert any(l.timeout_commit for l in to.logs)
    if case.startswith("partition") or case == "scheduler":
        assert any(e[3] for e in to.events_processed)
    if case == "partition_adaptive":
        assert any(l.recovery_actions for l in to.logs)
    if case == "adaptive_exponent":
        assert len({l.staleness_alpha for l in to.logs}) > 1


def test_sync_orchestrator_refuses_async_mode():
    """The port's sync Orchestrator names AsyncOrchestrator for
    mode='async', as the reference's does."""
    from repro_torch.orchestrator import Orchestrator
    fleet, fed = setup((medmnist_like, partition_dirichlet, FederatedDataset,
                        make_hybrid_fleet))
    with pytest.raises(ValueError, match="AsyncOrchestrator"):
        Orchestrator(fleet=fleet, fed_data=fed,
                     loss_fn=CNN(CNNConfig(**TINY)).loss_fn,
                     fl=FLConfig(mode="async"), device="cpu")
    with pytest.raises(ValueError, match="mode='async'"):
        AsyncOrchestrator(fleet=fleet, fed_data=fed,
                          loss_fn=CNN(CNNConfig(**TINY)).loss_fn,
                          fl=FLConfig(), device="cpu")


# ------------------------------------------------- batched engine
@pytest.mark.parametrize("case,train_chunk", [
    ("default", 3), ("partition_resume", 32), ("scheduler", 2),
    ("timeout", 1)])
def test_batched_engine_matches_per_event(params, case, train_chunk):
    """The batched engine draws every host stream in the per-event order
    (the batches at dispatch), so events, logs and the comm ledger are
    equal; its bucketed training, padded to a power of two, is bit for bit
    the per-event engine's."""
    tp = convert.params_from_jax(params)
    one, batched = t_orch(case), t_orch(case, BatchedAsyncOrchestrator,
                                        train_chunk=train_chunk)
    p1, _ = one.run(tp, N_COMMITS)
    p2, _ = batched.run(tp, N_COMMITS)
    assert batched.events_processed == one.events_processed
    assert batched.comm.records == one.comm.records
    assert counters(batched) == counters(one)
    for a, b in zip(one.logs, batched.logs):
        assert host_fields(a) == host_fields(b)
        for k in FLOAT_FIELDS:
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=k)
    for k in p1:
        assert torch.equal(p2[k], p1[k]), k
    # one host sync per bucket, not one per update: fewer reads in all
    # once a bucket can hold more than one client
    syncs = [sum(l.phase_wall["host_syncs"] for l in o.logs)
             for o in (batched, one)]
    assert syncs[0] < syncs[1] if train_chunk > 1 else syncs[0] == syncs[1]


def test_batched_engine_refuses_bad_sizes():
    for bad in (dict(train_chunk=0), dict(cohort_share_draws=0)):
        with pytest.raises(ValueError):
            t_orch("default", BatchedAsyncOrchestrator, **bad)

