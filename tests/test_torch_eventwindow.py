"""The port's event-window engine (``repro_torch.orchestrator.eventwindow``)
against the JAX package's, and against the port's other two engines.

* ``BlockedGenerator``: a block draw of n equals n sequential scalar draws
  and leaves the same bit-generator state; a partly used block re-syncs to
  the exact sequential state; mixed kinds and state-dependent draws match
  a plain ``numpy.random.Generator``.  Each case is held against a plain
  generator AND the reference's ``BlockedGenerator`` on the same seed.
* ``PendingStore``: ordering with ties, the tuple round trip, growth and
  compaction, each against the reference's store.
* Six commits of the port's window engine against the reference's over
  ``test_torch_async_orchestrator.py``'s CASES: the processed events, the
  comm ledger and every host field of each CommitLog exactly equal; the
  float results to 1e-5 relative and the params to 1e-4.
* Within the port: the window engine against the batched and per-event
  engines bit for bit (its buckets hold other clients, and a stacked lane
  does not depend on the bucket's lane count), one host read per commit, no generator draw at a dispatch,
  kill/resume within and across engines, and the cohort fleet model
  (``make_mega_fleet`` over a ``VirtualFederatedDataset``), whose batched
  run is also held against the reference's.
"""
import heapq
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_async_orchestrator import (CASES, FLOAT_FIELDS,  # noqa: E402
                                           N_CLIENTS, N_COMMITS, SEED, TINY,
                                           async_kw, counters, host_fields,
                                           setup, t_orch)

from repro.core import AsyncConfig as JAsync  # noqa: E402
from repro.core import FLConfig as JFL  # noqa: E402
from repro.data import FederatedDataset as JFed  # noqa: E402
from repro.data import VirtualFederatedDataset as JVirtual  # noqa: E402
from repro.data import medmnist_like as j_medmnist  # noqa: E402
from repro.data import partition_dirichlet as j_partition  # noqa: E402
from repro.exec import make_backend as j_backend  # noqa: E402
from repro.models.cnn import CNN as JCNN  # noqa: E402
from repro.models.cnn import CNNConfig as JConfig  # noqa: E402
from repro.orchestrator import BatchedAsyncOrchestrator as JBatched  # noqa: E402
from repro.orchestrator import EventWindowOrchestrator as JWindow  # noqa: E402
from repro.orchestrator import FaultConfig as JFaults  # noqa: E402
from repro.orchestrator import StragglerPolicy as JStraggler  # noqa: E402
from repro.orchestrator import make_hybrid_fleet as j_fleet  # noqa: E402
from repro.orchestrator import make_mega_fleet as j_mega  # noqa: E402
from repro.orchestrator.eventwindow import BlockedGenerator as JBlocked  # noqa: E402
from repro.orchestrator.eventwindow import PendingStore as JStore  # noqa: E402
from repro.sched import K8sAdapter as JK8s  # noqa: E402
from repro.sched import SlurmAdapter as JSlurm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import AsyncCheckpointManager  # noqa: E402
from repro_torch.core import AsyncConfig, CompressionConfig, FLConfig  # noqa: E402
from repro_torch.data import (FederatedDataset,  # noqa: E402
                              VirtualFederatedDataset, medmnist_like,
                              partition_dirichlet)
from repro_torch.models.cnn import CNN, CNNConfig  # noqa: E402
from repro_torch.orchestrator import (AsyncOrchestrator,  # noqa: E402
                                      BatchedAsyncOrchestrator,
                                      BlockedGenerator,
                                      EventWindowOrchestrator, FaultConfig,
                                      PendingStore, StragglerPolicy,
                                      make_hybrid_fleet, make_mega_fleet)



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

def _state(g):
    return g.bit_generator.state


def three(seed, window):
    """A plain generator, the reference's wrapper and the port's, all on
    ``seed``."""
    return (np.random.default_rng(seed),
            JBlocked(np.random.default_rng(seed), window=window),
            BlockedGenerator(np.random.default_rng(seed), window=window))


# ------------------------------------------------------ BlockedGenerator
@pytest.mark.parametrize("kind,args", [
    ("random", ()), ("uniform", (0.05, 0.95)), ("lognormal", (0.0, 0.5))])
@pytest.mark.parametrize("consumed", [0, 1, 5, 8])
def test_block_equals_sequential_and_state_syncs(kind, args, consumed):
    gens = three(42, 8)
    for _ in range(consumed):
        a, b, c = (float(getattr(g, kind)(*args)) for g in gens)
        assert a == b == c
    assert _state(gens[0]) == _state(gens[1]) == _state(gens[2])
    a, b, c = (float(getattr(g, kind)(*args)) for g in gens)
    assert a == b == c


def test_mixed_kind_interleave_matches_raw_generator():
    gens = three(7, 4)
    args = {"random": (), "lognormal": (0.0, 0.3), "uniform": (0.1, 0.9)}
    for kind in ["random", "lognormal", "lognormal", "uniform", "random",
                 "uniform", "uniform", "lognormal", "random", "random"]:
        a, b, c = (float(getattr(g, kind)(*args[kind])) for g in gens)
        assert a == b == c
    assert _state(gens[0]) == _state(gens[1]) == _state(gens[2])


def test_state_dependent_draws_sync_first():
    gens = three(3, 16)
    for _ in range(5):                  # leaves an 11-deep live block
        assert len({g.random() for g in gens}) == 1
    assert len({int(g.integers(1000)) for g in gens}) == 1
    assert len({int(g.choice(50)) for g in gens}) == 1
    assert len({float(g.exponential(2.0)) for g in gens}) == 1
    assert len({g.lognormal(0.0, 0.5) for g in gens}) == 1
    assert _state(gens[0]) == _state(gens[1]) == _state(gens[2])


def test_array_requests_and_reserve():
    seq, jblk, blk = three(9, 4)
    for g in (jblk, blk):
        g.reserve(12)                   # the next refill covers 12
    want = seq.random(size=10)
    assert np.array_equal(blk.random(size=10), want)
    assert np.array_equal(jblk.random(size=10), want)
    for _ in range(3):                  # two left in the block, then refill
        assert seq.random() == jblk.random() == blk.random()
    assert _state(seq) == _state(jblk) == _state(blk)


def test_checkpoint_state_set_through_wrapper():
    donor = np.random.default_rng(123)
    donor.random(size=17)
    snap = donor.bit_generator.state
    ref = np.random.default_rng(123)
    ref.random(size=17)
    want = [ref.random() for _ in range(5)]
    for cls in (JBlocked, BlockedGenerator):
        blk = cls(np.random.default_rng(0), window=8)
        blk.random()                    # leave a live block behind
        blk.bit_generator.state = snap
        assert [blk.random() for _ in range(5)] == want


# ---------------------------------------------------------- PendingStore
class _Upd:
    def __init__(self, seq, cid=0, version=0, fault=""):
        self.seq, self.cid = seq, cid
        self.dispatch_version, self.fault = version, fault


def test_pending_store_orders_like_the_heap():
    rng = np.random.default_rng(0)
    store, jstore, legacy = PendingStore(), JStore(), []
    for seq in range(300):
        t = float(rng.choice([1.0, 2.5, 2.5, 7.0]))      # (t) ties
        upd = _Upd(seq, cid=seq % 9, version=seq % 4)
        for s in (store, jstore):
            s.push(t, seq, upd)
        heapq.heappush(legacy, (t, seq, upd))
        if seq % 3 == 2:
            want = heapq.heappop(legacy)
            assert store.pop() == jstore.pop() == want
    while legacy:
        want = heapq.heappop(legacy)
        assert store.pop() == jstore.pop() == want
    assert len(store) == 0


def test_pending_store_iteration_round_trips():
    store = PendingStore()
    for seq, t in enumerate([3.0, 1.0, 2.0, 1.0]):
        store.push(t, seq, _Upd(seq, cid=10 + seq))
    rebuilt = PendingStore(list(store))
    assert list(rebuilt) == list(store) == list(JStore(list(store)))
    a = [store.pop() for _ in range(4)]
    b = [rebuilt.pop() for _ in range(4)]
    assert a == b and [u.cid for _, _, u in a] == [11, 13, 12, 10]


def test_pending_store_rows_and_compaction():
    store, jstore = PendingStore(), JStore()
    for seq in range(1000):
        upd = _Upd(seq, cid=seq, version=seq // 10,
                   fault="preempt" if seq % 7 else "")
        for s in (store, jstore):
            s.push(float(seq), seq, upd)
            if seq >= 20:
                s.pop()
    assert len(store) == 20
    rows = store.live
    assert rows.tobytes() == jstore.live.tobytes()
    assert sorted(rows["seq"].tolist()) == list(range(980, 1000))
    assert np.array_equal(store.staleness(200), jstore.staleness(200))
    assert store.min_time() == jstore.min_time() == 980.0


# ------------------------------------------- the engine against the JAX one
_JSHARED: dict = {}


def j_window(case, window=7, train_chunk=3):
    changes, faults, scheduler = CASES[case]
    fleet, fed = setup((j_medmnist, j_partition, JFed, j_fleet))
    backend = j_backend("scheduler", slurm=JSlurm(total_nodes=2, seed=3),
                        k8s=JK8s(initial_nodes=1, max_nodes=3,
                                 preempt_prob_per_min=2.0, seed=4)) \
        if scheduler else None
    orch = JWindow(
        fleet=fleet, fed_data=fed, loss_fn=JCNN(JConfig(**TINY)).loss_fn,
        fl=JFL(mode="async", num_clients=N_CLIENTS, local_steps=1,
               client_lr=0.05),
        async_cfg=JAsync(**async_kw(changes)),
        straggler=JStraggler(contention_sigma=0.5),
        faults=JFaults(**faults), backend=backend, batch_size=8,
        flops_per_client_round=2e12, seed=SEED, train_chunk=train_chunk,
        window=window)
    # the jitted steps depend only on the FLConfig: share them
    if "steps" in _JSHARED:
        orch._commit_step, orch._update_fn = _JSHARED["steps"]
        orch._vstep_cache = _JSHARED["vstep"]
    else:
        _JSHARED["steps"] = (orch._commit_step, orch._update_fn)
        _JSHARED["vstep"] = orch._vstep_cache
    return orch


@pytest.fixture(scope="module")
def params():
    jp = JCNN(JConfig(**TINY)).init(jax.random.PRNGKey(SEED))
    return {k: np.asarray(v) for k, v in jp.items()}


def assert_same_host_run(a, b, p_a=None, p_b=None, tol=1e-5):
    """Events, comm ledger, counters and every CommitLog host field equal;
    the float results and the params to ``tol`` (0: equal)."""
    assert a.events_processed == b.events_processed
    assert [asdict(r) for r in a.comm.records] \
        == [asdict(r) for r in b.comm.records]
    assert counters(a) == counters(b)
    assert len(a.logs) == len(b.logs)
    for la, lb in zip(a.logs, b.logs):
        assert host_fields(la) == host_fields(lb)
        for k in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(la, k), getattr(lb, k),
                                       rtol=tol, err_msg=k)
    if p_a is not None:
        for k in p_a:
            np.testing.assert_allclose(p_a[k].numpy(), np.asarray(p_b[k]),
                                       rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_engine_matches_jax(params, case):
    jo = j_window(case)
    to = t_orch(case, EventWindowOrchestrator, train_chunk=3, window=7)
    jp, _ = jo.run(params, N_COMMITS)
    tp, _ = to.run(convert.params_from_jax(params), N_COMMITS)
    assert to.events_processed == jo.events_processed
    assert len(to.logs) == N_COMMITS
    assert_same_host_run(to, jo)
    got = convert.params_to_numpy(tp)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # one bundled host read per commit: there is no eval fn
    assert [l.phase_wall["host_syncs"] for l in to.logs] == [1] * N_COMMITS


# ------------------------------------------------- within the port
@pytest.mark.parametrize("window,case,kw", [
    (1, "default", {}), (256, "partition_resume", {}),
    (7, "scheduler", {"train_chunk": 2}),
    (7, "secure_chunked", {})])
def test_window_matches_batched_and_per_event(params, window, case, kw):
    """Window 1 makes every block one draw, 256 serves a whole run from
    one block (every sync replays a partial prefix); the secure chunked
    commit (commit_chunk 2) draws its masks from the generator."""
    tp = convert.params_from_jax(params)
    if case == "secure_chunked":
        orchs = [secure_chunked(cls, **k) for cls, k in (
            (AsyncOrchestrator, {}), (BatchedAsyncOrchestrator, kw),
            (EventWindowOrchestrator, dict(kw, window=window)))]
    else:
        orchs = [t_orch(case), t_orch(case, BatchedAsyncOrchestrator, **kw),
                 t_orch(case, EventWindowOrchestrator, window=window, **kw)]
    runs = [o.run(tp, N_COMMITS)[0] for o in orchs]
    for o, p in zip(orchs[:2], runs[:2]):
        assert_same_host_run(orchs[2], o, runs[2], p, tol=0)
    assert all(l.phase_wall["host_syncs"] == 1 for l in orchs[2].logs)
    # the commits drew the same masks and noise from the generator
    assert torch.equal(orchs[2].generator.get_state(),
                       orchs[1].generator.get_state())


def secure_chunked(cls, mgr=None, every=0, **kw):
    fleet, fed = setup((medmnist_like, partition_dirichlet, FederatedDataset,
                        make_hybrid_fleet))
    return cls(
        fleet=fleet, fed_data=fed, loss_fn=CNN(CNNConfig(**TINY)).loss_fn,
        fl=FLConfig(mode="async", num_clients=N_CLIENTS, local_steps=1,
                    client_lr=0.05, secure_agg=True,
                    compression=CompressionConfig(quantize_bits=8,
                                                  topk_frac=0.1)),
        async_cfg=AsyncConfig(buffer_size=4, commit_chunk=2,
                              max_concurrency=4),
        straggler=StragglerPolicy(contention_sigma=0.5), batch_size=8,
        flops_per_client_round=2e12, seed=SEED, device="cpu",
        checkpoint_mgr=mgr, checkpoint_every=every, **kw)


def test_window_draws_nothing_from_the_generator_at_dispatch(params):
    """Between two commits (dispatches, arrivals, training) the commit
    generator's state does not move: only the commit draws from it."""
    orch = secure_chunked(EventWindowOrchestrator, window=5)
    states, commit = [], orch._do_commit

    def watched(*a, **k):
        states.append(("in", orch.generator.get_state().clone()))
        out = commit(*a, **k)
        states.append(("out", orch.generator.get_state().clone()))
        return out

    orch._do_commit = watched
    orch.run(convert.params_from_jax(params), 4)
    fresh = torch.Generator().manual_seed(SEED).get_state()
    assert torch.equal(states[0][1], fresh)
    for (_, out), (_, nxt) in zip(states[1::2], states[2::2]):
        assert torch.equal(out, nxt)
    assert not torch.equal(states[-1][1], fresh)


def _window_kw(cls):
    return {AsyncOrchestrator: {},
            BatchedAsyncOrchestrator: {"train_chunk": 3},
            EventWindowOrchestrator: {"train_chunk": 3, "window": 5}}[cls]


@pytest.mark.parametrize("writer,reader", [
    (EventWindowOrchestrator, EventWindowOrchestrator),
    (EventWindowOrchestrator, AsyncOrchestrator),
    (AsyncOrchestrator, EventWindowOrchestrator),
    (EventWindowOrchestrator, BatchedAsyncOrchestrator),
    (BatchedAsyncOrchestrator, EventWindowOrchestrator)])
def test_kill_resume_across_engines(tmp_path, params, writer, reader):
    """A snapshot of either engine continues in the other (or the same)
    engine as the reader's uninterrupted run, bit for bit: the same events,
    ledger, logs, generator state and params.  The snapshot trains every
    deferred job before the save, so the resumed run's buckets hold other
    clients than the uninterrupted run's; a stacked lane's result does not
    depend on the bucket's lane count (``core.round.MIN_LANES``)."""
    tp = convert.params_from_jax(params)
    straight = secure_chunked(reader, **_window_kw(reader))
    p_straight, _ = straight.run(tp, N_COMMITS)
    mgr = AsyncCheckpointManager(tmp_path, keep=20)
    killed = secure_chunked(writer, mgr=mgr, every=1, **_window_kw(writer))
    killed.run(tp, 3)
    resumed = secure_chunked(reader, **_window_kw(reader))
    p0, st0 = mgr.restore_async(resumed, tp)
    assert resumed.version == 3
    p_resumed, _ = resumed.run(p0, N_COMMITS, server_state=st0)
    assert_same_host_run(resumed, straight, p_resumed,
                         {k: v.numpy() for k, v in p_straight.items()},
                         tol=0)
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())


def test_window_refuses_bad_size():
    with pytest.raises(ValueError, match="window"):
        t_orch("default", EventWindowOrchestrator, window=0)


# ------------------------------------------------------- the cohort mode
N_MEGA, SHARDS = 64, 8


def cohort_orch(pkg, cls, mgr=None, every=0, **kw):
    """A 64-client ``make_mega_fleet`` over a ``VirtualFederatedDataset``
    of 8 shards, in either package."""
    if pkg == "jax":
        data = j_medmnist(n=400, seed=SEED)
        parts = j_partition(data.y, SHARDS, alpha=0.5, seed=SEED)
        model = JCNN(JConfig(**TINY))
        mod = dict(fleet=j_mega(N_MEGA, seed=3),
                   fed_data=JVirtual(data, parts, seed=SEED,
                                     n_virtual=N_MEGA),
                   fl=JFL(mode="async", num_clients=N_MEGA, local_steps=1,
                          client_lr=0.05),
                   async_cfg=JAsync(buffer_size=4, max_concurrency=12,
                                    max_staleness=50),
                   faults=JFaults(dropout_prob=0.1,
                                  recovery_policy="discard"),
                   straggler=JStraggler(contention_sigma=0.5))
    else:
        data = medmnist_like(n=400, seed=SEED)
        parts = partition_dirichlet(data.y, SHARDS, alpha=0.5, seed=SEED)
        model = CNN(CNNConfig(**TINY))
        mod = dict(fleet=make_mega_fleet(N_MEGA, seed=3),
                   fed_data=VirtualFederatedDataset(data, parts, seed=SEED,
                                                    n_virtual=N_MEGA),
                   fl=FLConfig(mode="async", num_clients=N_MEGA,
                               local_steps=1, client_lr=0.05),
                   async_cfg=AsyncConfig(buffer_size=4, max_concurrency=12,
                                         max_staleness=50),
                   faults=FaultConfig(dropout_prob=0.1,
                                      recovery_policy="discard"),
                   straggler=StragglerPolicy(contention_sigma=0.5),
                   device="cpu", checkpoint_mgr=mgr, checkpoint_every=every)
    return cls(loss_fn=model.loss_fn, batch_size=8,
               flops_per_client_round=2e12, seed=SEED, train_chunk=3,
               **mod, **kw)


def test_cohort_batched_matches_jax(params):
    """The port's batched cohort run (lazy fleet, cohort dispatch, shared
    duration and fault draws) against the reference's."""
    jo = cohort_orch("jax", JBatched)
    to = cohort_orch("torch", BatchedAsyncOrchestrator)
    jp, _ = jo.run(params, N_COMMITS)
    tp, _ = to.run(convert.params_from_jax(params), N_COMMITS)
    assert_same_host_run(to, jo)
    assert sorted(to.fleet.live) == sorted(jo.fleet.live)
    assert to.engine_state() == jo.engine_state()
    got = convert.params_to_numpy(tp)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_cohort_window_matches_batched(params):
    tp = convert.params_from_jax(params)
    batched = cohort_orch("torch", BatchedAsyncOrchestrator)
    window = cohort_orch("torch", EventWindowOrchestrator, window=7)
    p1, _ = batched.run(tp, N_COMMITS)
    p2, _ = window.run(tp, N_COMMITS)
    assert_same_host_run(window, batched, p2,
                         {k: v.numpy() for k, v in p1.items()}, tol=0)
    assert all(l.phase_wall["host_syncs"] == 1 for l in window.logs)


@pytest.mark.parametrize("cls", [BatchedAsyncOrchestrator,
                                 EventWindowOrchestrator])
def test_cohort_kill_resume(tmp_path, params, cls):
    """A cohort run's snapshot (the touched clients, the in-flight set and
    its per-cohort counts, the cohort draw blocks, the lazy data
    generators) resumes the uninterrupted run bit for bit, though the
    buckets differ (as above)."""
    tp = convert.params_from_jax(params)
    kw = {"window": 7} if cls is EventWindowOrchestrator else {}
    straight = cohort_orch("torch", cls, **kw)
    p_straight, _ = straight.run(tp, N_COMMITS)
    mgr = AsyncCheckpointManager(tmp_path, keep=20)
    cohort_orch("torch", cls, mgr=mgr, every=1, **kw).run(tp, 3)
    resumed = cohort_orch("torch", cls, **kw)
    p0, st0 = mgr.restore_async(resumed, tp)
    assert resumed._inflight and resumed._inflight.by_cohort.sum() \
        == len(resumed._inflight)
    p_resumed, _ = resumed.run(p0, N_COMMITS, server_state=st0)
    assert_same_host_run(resumed, straight, p_resumed,
                         {k: v.numpy() for k, v in p_straight.items()},
                         tol=0)
