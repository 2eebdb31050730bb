"""The port's two-tier federation (``repro_torch.orchestrator.hierarchy``)
against the JAX package's, on the same seeds, fleet, data and (carried)
params, following ``tests/test_hierarchy.py``:

* two facilities under (sync, sync) and (async, async): the tier-2 commit
  logs' host fields, the WAN ledger (every record ``inter_facility`` on the
  ``dcn`` link) and each facility's logs, ledger and clock exactly equal;
  the float results to 1e-5 relative and the params to 1e-4;
* a 1-facility hierarchy equals the port's flat ``Orchestrator`` (1e-6);
* kill/resume bit for bit for all four (local, inter) mode pairs;
* the snapshot's file names and ``hier_state.json``'s keys are the
  reference's, the jax keys ``jrng`` giving way to ``generator``;
* facilities on the scheduler backend, against the reference's;
* a mismatched restore is refused.
"""
import json
import math
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import AsyncCheckpointManager as JManager
from repro.core import AsyncConfig as JAsync
from repro.core import FLConfig as JFL
from repro.data import FederatedDataset as JFed
from repro.data import medmnist_like as j_medmnist
from repro.data import partition_dirichlet as j_partition
from repro.exec import SchedulerBackend as JScheduler
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import CNNConfig as JConfig
from repro.orchestrator import HierarchicalOrchestrator as JHier
from repro.orchestrator import make_facilities as j_facilities
from repro.orchestrator import make_hybrid_fleet as j_fleet
from repro.sched import HybridAdapter as JHybrid
from repro.sched import K8sAdapter as JK8s
from repro.sched import SlurmAdapter as JSlurm
from repro_torch import convert
from repro_torch.checkpoint import AsyncCheckpointManager
from repro_torch.core import AsyncConfig, FLConfig
from repro_torch.data import (FederatedDataset, medmnist_like,
                              partition_dirichlet)
from repro_torch.exec import SchedulerBackend
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.orchestrator import (HierarchicalOrchestrator, Orchestrator,
                                      make_facilities, make_hybrid_fleet)
from repro_torch.sched import HybridAdapter, K8sAdapter, SlurmAdapter

TINY = dict(name="tiny-cnn", in_shape=(28, 28, 1), num_classes=9,
            channels=(4, 8), dense=32)
SEED, N = 11, 8
FL_KW = dict(mode="sync", num_clients=4, local_steps=1, client_lr=0.05)
T_MODEL = CNN(CNNConfig(**TINY))
J_MODEL = JCNN(JConfig(**TINY))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs torch on one thread: these runs are thousands of
    small ops, which many intra-op threads slow down when several test
    processes share the machine's cores.  The previous count is restored
    after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the reference's jitted steps depend only on (model, FLConfig, buffer
# size), all fixed here: compile each once
_JSTEPS: dict = {}


def _share_jax_steps(hier):
    for fac in hier.facilities:
        key = ("t1", fac.mode)
        names = (("_round_step",) if fac.mode == "sync"
                 else ("_client_update", "_commit_step"))
        if key in _JSTEPS:
            for n, f in zip(names, _JSTEPS[key]):
                setattr(fac.orch, n, f)
        else:
            _JSTEPS[key] = tuple(getattr(fac.orch, n) for n in names)
    key = ("t2", hier.async_cfg.buffer_size)
    hier._commit_step = _JSTEPS.setdefault(key, hier._commit_step)
    return hier


def build(pkg, n_fac=2, local_mode="sync", inter_mode="sync",
          local_rounds=2, mgr=None, every=0, backend_factory=None):
    """One package's hierarchy over the same seeds: 8 clients split into
    ``n_fac`` facilities, 4 clients a round, async facilities buffering 2
    of 3 in flight, an async tier 2 committing every arrival."""
    if pkg == "jax":
        medmnist, partition, fed_cls, fleet_fn = (j_medmnist, j_partition,
                                                  JFed, j_fleet)
        fl, acfg, mk, hier_cls = JFL(**FL_KW), JAsync, j_facilities, JHier
        model, dev = J_MODEL, {}
    else:
        medmnist, partition, fed_cls, fleet_fn = (
            medmnist_like, partition_dirichlet, FederatedDataset,
            make_hybrid_fleet)
        fl, acfg, mk = FLConfig(**FL_KW), AsyncConfig, make_facilities
        hier_cls, model, dev = HierarchicalOrchestrator, T_MODEL, {
            "device": "cpu"}
    data = medmnist(n=400, seed=SEED)
    parts = partition(data.y, N, alpha=0.5, seed=SEED)
    fleet = fleet_fn(N // 2, N - N // 2, seed=SEED,
                     data_sizes=[len(p) for p in parts])
    facs = mk(n_fac, fleet, fed_cls(data, parts, seed=SEED), model.loss_fn,
              fl, local_mode=local_mode,
              async_cfg=acfg(buffer_size=2, max_concurrency=3),
              local_rounds=local_rounds, backend_factory=backend_factory,
              seed=SEED, orch_kw=dict(batch_size=8,
                                      flops_per_client_round=2e12), **dev)
    hier = hier_cls(facs, fl, inter_mode=inter_mode,
                    async_cfg=acfg(buffer_size=1)
                    if inter_mode == "async" else None,
                    checkpoint_mgr=mgr, checkpoint_every=every, seed=SEED,
                    **dev)
    return _share_jax_steps(hier) if pkg == "jax" else hier


@pytest.fixture(scope="module")
def params():
    jp = J_MODEL.init(jax.random.PRNGKey(SEED))
    return {k: np.asarray(v) for k, v in jp.items()}


FLOATS = ("client_loss", "delta_norm", "staleness_alpha", "eval_metric")


def split(log) -> tuple[dict, dict]:
    """(host fields, float results) of a CommitLog or RoundLog; the
    port-only wall-clock fields are dropped, NaN made comparable."""
    d = asdict(log)
    for k in ("phase_wall", "wall_s"):
        d.pop(k, None)
    d = {k: ("nan" if isinstance(v, float) and math.isnan(v) else
             [int(x) for x in v] if k == "selected" else v)
         for k, v in d.items()}
    return ({k: v for k, v in d.items() if k not in FLOATS},
            {k: v for k, v in d.items() if k in FLOATS})


def assert_logs(got, want, tol=1e-5):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        (ha, fa), (hb, fb) = split(a), split(b)
        assert ha == hb
        for k in fa:
            if fa[k] != "nan" or fb[k] != "nan":
                np.testing.assert_allclose(fa[k], fb[k], rtol=tol,
                                           err_msg=k)


def assert_same_tiers(th, jh):
    assert_logs(th.logs, jh.logs)
    assert [asdict(r) for r in th.comm.records] \
        == [asdict(r) for r in jh.comm.records]
    assert {(r.direction, r.link) for r in th.comm.records} \
        == {("inter_facility", "dcn")}
    assert (th.version, th.clock, th.dropped_stale) \
        == (jh.version, jh.clock, jh.dropped_stale)
    for tf, jf in zip(th.facilities, jh.facilities):
        assert tf.clock == jf.clock
        assert_logs(tf.orch.logs, jf.orch.logs)
        assert [asdict(r) for r in tf.orch.comm.records] \
            == [asdict(r) for r in jf.orch.comm.records]


@pytest.mark.parametrize("local_mode,inter_mode", [("sync", "sync"),
                                                   ("async", "async")])
def test_two_facilities_match_jax(params, local_mode, inter_mode):
    jh = build("jax", local_mode=local_mode, inter_mode=inter_mode)
    th = build("torch", local_mode=local_mode, inter_mode=inter_mode)
    jp, _ = jh.run(params, 3)
    tp, _ = th.run(convert.params_from_jax(params), 3)
    assert th.version == 3
    assert_same_tiers(th, jh)
    assert th.inter_facility_bytes == jh.inter_facility_bytes
    assert th.total_bytes() == jh.total_bytes()
    got = convert.params_to_numpy(tp)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_one_facility_hierarchy_is_flat(params):
    tp = convert.params_from_jax(params)
    hier = build("torch", n_fac=1, local_rounds=3)
    ph, _ = hier.run(tp, 1)
    data = medmnist_like(n=400, seed=SEED)
    parts = partition_dirichlet(data.y, N, alpha=0.5, seed=SEED)
    flat = Orchestrator(
        fleet=make_hybrid_fleet(N // 2, N - N // 2, seed=SEED,
                                data_sizes=[len(p) for p in parts]),
        fed_data=FederatedDataset(data, parts, seed=SEED),
        loss_fn=T_MODEL.loss_fn, fl=FLConfig(**FL_KW), batch_size=8,
        flops_per_client_round=2e12, seed=SEED, device="cpu")
    pf, _ = flat.run(tp, 3)
    assert max((ph[k] - pf[k]).abs().max().item() for k in pf) < 1e-6
    flog = hier.facilities[0].orch.logs
    assert len(flog) == len(flat.logs) == 3
    for a, b in zip(flog, flat.logs):
        assert a.selected == b.selected
        assert a.participated == b.participated
        assert abs(a.client_loss - b.client_loss) < 1e-6


def _norm(logs):
    return [split(l) for l in logs]


@pytest.mark.parametrize("local_mode,inter_mode", [
    ("sync", "sync"), ("async", "async"), ("async", "sync"),
    ("sync", "async")])
def test_hier_resume_bit_identical(tmp_path, params, local_mode, inter_mode):
    tp = convert.params_from_jax(params)
    ck = tmp_path / "ck"
    straight = build("torch", local_mode=local_mode, inter_mode=inter_mode)
    ps, _ = straight.run(tp, 4)
    killed = build("torch", local_mode=local_mode, inter_mode=inter_mode,
                   mgr=AsyncCheckpointManager(ck), every=1)
    killed.run(tp, 2)
    resumed = build("torch", local_mode=local_mode, inter_mode=inter_mode,
                    mgr=AsyncCheckpointManager(ck), every=1)
    p0, st0 = resumed.checkpoint_mgr.restore_hier(resumed, tp)
    assert resumed.version == 2
    pr, _ = resumed.run(p0, 4, server_state=st0)
    assert all(torch.equal(ps[k], pr[k]) for k in ps)
    assert _norm(straight.logs) == _norm(resumed.logs)
    assert straight.comm.records == resumed.comm.records
    for sf, rf in zip(straight.facilities, resumed.facilities):
        assert _norm(sf.orch.logs) == _norm(rf.orch.logs)
        assert sf.orch.comm.records == rf.orch.comm.records
        assert sf.clock == rf.clock


def test_snapshot_files_and_keys_are_the_references(tmp_path, params):
    """Both packages snapshot the same two-tier run (sync facilities, an
    async tier 2) into the same file names and ``hier_state.json`` keys,
    with equal host state; ``jrng`` gives way to ``generator`` at both
    tiers."""
    jh = build("jax", inter_mode="async", mgr=JManager(tmp_path / "jax"))
    th = build("torch", inter_mode="async",
               mgr=AsyncCheckpointManager(tmp_path / "torch"))
    jh.run(params, 2)
    th.run(convert.params_from_jax(params), 2)
    jdir, tdir = jh.checkpoint_mgr.step_dir(2), th.checkpoint_mgr.step_dir(2)
    assert sorted(p.name for p in tdir.iterdir()) \
        == sorted(p.name for p in jdir.iterdir())
    assert any(p.name.startswith("t2delta_") for p in tdir.iterdir())
    js = json.loads((jdir / "hier_state.json").read_text())
    ts = json.loads((tdir / "hier_state.json").read_text())
    assert set(ts) == set(js) - {"jrng"} | {"generator"}
    for key in ("config", "clock", "version", "seq", "dropped_stale",
                "buffer_bytes", "rng", "comm"):
        assert ts[key] == js[key], key
    for tf, jf in zip(ts["facilities"], js["facilities"]):
        assert {k: v for k, v in tf.items() if k != "state"} \
            == {k: v for k, v in jf.items() if k != "state"}
        assert set(tf["state"]) == set(jf["state"]) - {"jrng"} \
            | {"generator"}
        for key in ("config", "clock", "rng", "selection_rng", "fault",
                    "fleet", "data_rngs", "comm"):
            assert tf["state"][key] == jf["state"][key], key
    assert json.loads((tdir / "meta.json").read_text()) \
        == json.loads((jdir / "meta.json").read_text())


def test_facilities_on_scheduler_backend(params):
    def factory(cls, hybrid, slurm, k8s):
        return lambda f: cls(hybrid(
            slurm=slurm(total_nodes=8, seed=f),
            k8s=k8s(initial_nodes=8, max_nodes=8, seed=f + 1)))

    jh = build("jax", inter_mode="async", backend_factory=factory(
        JScheduler, JHybrid, JSlurm, JK8s))
    th = build("torch", inter_mode="async", backend_factory=factory(
        SchedulerBackend, HybridAdapter, SlurmAdapter, K8sAdapter))
    jh.run(params, 3)
    th.run(convert.params_from_jax(params), 3)
    assert th.version == 3
    assert all(f.orch.backend.name == "scheduler" for f in th.facilities)
    assert_same_tiers(th, jh)


def test_restore_refuses_mismatched_config(tmp_path, params):
    tp = convert.params_from_jax(params)
    mgr = AsyncCheckpointManager(tmp_path)
    build("torch", mgr=mgr).run(tp, 1)
    for other in (build("torch", n_fac=4), build("torch", local_rounds=1),
                  build("torch", inter_mode="async"),
                  build("torch", local_mode="async")):
        with pytest.raises(ValueError, match="config"):
            mgr.restore_hier(other, tp)
