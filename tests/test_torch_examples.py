"""The port's five example drivers (``examples_torch/``) against the JAX
package's objects built as ``examples/*.py`` builds them, on the CPU, at
each example's own widths with the rounds cut to 2 (``train_100m`` at 2
layers, d_model 64).  The reference's example files run at import, so the
reference side is rebuilt here.  Both sides start from the reference's
init (``convert.params_from_jax``, ``tree_from_jax``) with deterministic
rounding (ROADMAP's RNG contract); the finetune's tokens are the same numpy
draws on both sides.

Held: every host-side log field exactly equal (selected clients,
participation, simulated durations and clocks, comm records, commits,
timeouts and updates, job states, the sbatch artifact with the worker
command's two substitutions); params after 2 rounds to 1e-4 (float32 sums
in another order over two compressed rounds, as
tests/test_torch_orchestrator.py); the finetune's prefill and decode
logits to 1e-4 of their scale.  Each example's two runs are shared by its
cases through module-scoped fixtures."""
import dataclasses
import importlib.util
import math
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import AsyncConfig as JAsyncConfig
from repro.core import CompressionConfig as JComp
from repro.core import FLConfig as JFL
from repro.core import build_fl_round_step as j_round
from repro.data import FederatedDataset as JFed
from repro.data import cifar10_like as j_cifar
from repro.data import medmnist_like as j_medmnist
from repro.data import partition_by_class as j_by_class
from repro.data import partition_by_group as j_by_group
from repro.data import partition_dirichlet as j_dirichlet
from repro.data import shakespeare_like as j_shakespeare
from repro.exec import SchedulerBackend as JSchedBackend
from repro.models import build_model as jbuild
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import CNNConfig as JCNNConfig
from repro.optim import get_client_optimizer as j_client_opt
from repro.optim import get_server_optimizer as j_server_opt
from repro.orchestrator import AsyncOrchestrator as JAsync
from repro.orchestrator import FaultConfig as JFaults
from repro.orchestrator import Orchestrator as JOrch
from repro.orchestrator import StragglerPolicy as JStraggler
from repro.orchestrator import make_hybrid_fleet as j_fleet
from repro.sched import HybridAdapter as JHybrid
from repro.sched import JobSpec as JJobSpec
from repro.sched import K8sAdapter as JK8s
from repro.sched import SlurmAdapter as JSlurm
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.pytree import flat_dict, nest

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 2
TOL = 1e-4
HOST_ROUND = ("rnd", "selected", "participated", "duration_s", "bytes_up",
              "mean_queue_wait_s", "n_overflow", "n_preempted")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """torch on one intra-op thread for this module, restored after it:
    the examples' small CPU runs are mostly ops below a millisecond, which
    OpenMP threads slow beside other busy cores (on an 8-core host with
    six of them busy the file took 158 s at 8 threads and 51 s at one;
    484 s in a 6-worker run of the suite).  The module's checks hold on
    either thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def example(name):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def round_fields(log) -> tuple:
    return tuple(getattr(log, k) for k in HOST_ROUND)


def commit_fields(log) -> dict:
    """A CommitLog's host fields: all but the device math's float results
    and the wall-clock profile; NaN made comparable."""
    d = dataclasses.asdict(log)
    for k in ("client_loss", "delta_norm", "staleness_alpha", "eval_metric",
              "phase_wall"):
        d.pop(k)
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in d.items()}


def records(orch) -> list:
    return [dataclasses.asdict(r) for r in orch.comm.records]


def assert_same_rounds(jorch, torch_orch):
    assert [round_fields(l) for l in torch_orch.logs] \
        == [round_fields(l) for l in jorch.logs]
    assert len(torch_orch.logs) == ROUNDS
    assert torch_orch.virtual_clock == jorch.virtual_clock
    assert records(torch_orch) == records(jorch)
    assert torch_orch.comm.mean_bytes_per_client_round() \
        == jorch.comm.mean_bytes_per_client_round()
    for jl, tl in zip(jorch.logs, torch_orch.logs):
        np.testing.assert_allclose(tl.client_loss, jl.client_loss, rtol=TOL)


def assert_params(got: dict, want: dict, what=""):
    """``got``: the port's params (flat view); ``want``: numpy leaves by
    the same names."""
    got = convert.params_to_numpy(got)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {k}")


# ----------------------------------------------------------- quickstart
@pytest.fixture(scope="module")
def quickstart():
    data = j_cifar(n=4000)
    parts = j_by_class(data.y, n_clients=20, classes_per_client=2)
    fed = JFed(data, parts)
    model = JCNN(JCNNConfig("quickstart-cnn", (32, 32, 3), 10,
                            channels=(8, 16), dense=64))
    params = np_tree(model.init(jax.random.PRNGKey(0)))
    fl = JFL(num_clients=8, local_steps=3, client_lr=0.08, fedprox_mu=0.02,
             compression=JComp(quantize_bits=8, topk_frac=0.25,
                               stochastic_rounding=False))
    jorch = JOrch(fleet=j_fleet(10, 10, data_sizes=[len(p) for p in parts]),
                  fed_data=fed, loss_fn=model.loss_fn, fl=fl,
                  straggler=JStraggler(fastest_k=6), batch_size=16,
                  flops_per_client_round=1e12)
    jp, _ = jorch.run(params, num_rounds=ROUNDS)
    torch_orch, tp = example("quickstart").run(
        "cpu", rounds=ROUNDS, stochastic_rounding=False,
        params=convert.params_from_jax(params))
    return jorch, np_tree(jp), torch_orch, tp


def test_quickstart_host_logs(quickstart):
    jorch, _, torch_orch, _ = quickstart
    assert_same_rounds(jorch, torch_orch)
    # fastest-k 6 of 8 cut two clients a round
    assert [l.participated for l in torch_orch.logs] == [6] * ROUNDS


def test_quickstart_params(quickstart):
    _, jp, _, tp = quickstart
    assert_params(tp, jp, "quickstart")


# ----------------------------------------------------------- async hybrid
@pytest.fixture(scope="module")
def async_hybrid():
    ex = example("async_hybrid_sim")
    seed, n = ex.SEED, ex.N
    data = j_medmnist(n=3000, seed=seed)
    parts = j_dirichlet(data.y, n, alpha=0.3, seed=seed)
    model = JCNN(JCNNConfig("med-cnn", (28, 28, 1), 9, channels=(8, 16),
                            dense=64))
    params = np_tree(model.init(jax.random.PRNGKey(seed)))
    comp = JComp(quantize_bits=8, stochastic_rounding=False)
    straggler = JStraggler(contention_sigma=0.6)
    faults = JFaults(dropout_prob=0.1, spot_preempt_prob=0.2,
                     recovery_policy="resume")

    def fleet():
        return j_fleet(n // 2, n - n // 2, seed=seed,
                       data_sizes=[len(p) for p in parts])

    anc = JAsync(
        fleet=fleet(), fed_data=JFed(data, parts, seed=seed),
        loss_fn=model.loss_fn,
        fl=JFL(mode="async", num_clients=8, local_steps=2, client_lr=0.08,
               fedprox_mu=0.02, compression=comp),
        async_cfg=JAsyncConfig(buffer_size=4, staleness_exponent=0.5,
                               max_staleness=30, commit_timeout_s=60.0,
                               max_concurrency=12),
        straggler=straggler, faults=faults, batch_size=16,
        flops_per_client_round=2e12, seed=seed)
    p_async, _ = anc.run(params, num_commits=ROUNDS)
    sync = JOrch(
        fleet=fleet(), fed_data=JFed(data, parts, seed=seed),
        loss_fn=model.loss_fn,
        fl=JFL(num_clients=8, local_steps=2, client_lr=0.08,
               fedprox_mu=0.02, compression=comp),
        straggler=straggler, faults=faults, batch_size=16,
        flops_per_client_round=2e12, seed=seed)
    rounds, p_sync = 0, params
    server_state = sync.init_server_state(params)
    while sync.virtual_clock < anc.clock:
        p_sync, server_state, _ = sync.run_round(rounds, p_sync, server_state)
        rounds += 1
    out = ex.run("cpu", commits=ROUNDS, stochastic_rounding=False,
                 params=convert.params_from_jax(params))
    return dict(anc=anc, sync=sync, rounds=rounds, p_async=np_tree(p_async),
                p_sync=np_tree(p_sync)), out


def test_async_hybrid_host_logs(async_hybrid):
    want, got = async_hybrid
    ja, ta = want["anc"], got["anc"]
    assert ta.events_processed == ja.events_processed
    assert records(ta) == records(ja)
    assert [commit_fields(l) for l in ta.logs] \
        == [commit_fields(l) for l in ja.logs]
    for name in ("version", "updates_applied", "dropped_stale",
                 "recovered_updates", "lost_to_faults", "recovery_time_total",
                 "clock", "updates_per_sim_second"):
        assert getattr(ta, name) == getattr(ja, name), name
    assert ta.version == ROUNDS
    # the sync baseline on the same fleet and simulated-time budget
    assert got["rounds"] == want["rounds"] >= 1
    js, ts = want["sync"], got["sync"]
    assert [round_fields(l) for l in ts.logs] \
        == [round_fields(l) for l in js.logs]
    assert ts.virtual_clock == js.virtual_clock
    assert records(ts) == records(js)


def test_async_hybrid_params(async_hybrid):
    want, got = async_hybrid
    assert_params(got["p_async"], want["p_async"], "async")
    assert_params(got["p_sync"], want["p_sync"], "sync")


# ------------------------------------------------------- hybrid HPC/cloud
# The one intended difference: the jobs run the port's worker, by its own
# flag (the reference's example names ``--cid``, which no worker takes)
WORKER_REF = "python -m repro.worker --cid"
WORKER_PORT = "python -m repro_torch.worker --client-id"


def j_schedule():
    hy = JHybrid(slurm=JSlurm(total_nodes=8),
                 k8s=JK8s(initial_nodes=4, max_nodes=16,
                          preempt_prob_per_min=2.0))
    handles = []
    for c in j_fleet(8, 8, seed=1):
        h = hy.submit(JJobSpec(
            name=f"fl-client-{c.cid}",
            command=f"{WORKER_REF} {c.cid}",
            gpus_per_node=1 if c.profile.compute_tflops > 4 else 0,
            site=c.site, preemptible=c.profile.spot))
        hy.set_workload(h.job_id, np.random.default_rng(c.cid).uniform(20, 90))
        handles.append(h)
    for _ in range(12):
        hy.advance(10.0)
    return handles, [hy.poll(h.job_id).value for h in handles]


def test_hybrid_schedule_matches_reference(capsys):
    handles, states = j_schedule()
    got = example("hybrid_hpc_cloud_sim").schedule()
    out = capsys.readouterr().out
    assert got["states"] == states
    assert dict(Counter(got["states"])) == dict(Counter(states))
    assert len(got["handles"]) == len(handles) == 16
    for jh, th in zip(handles, got["handles"]):
        assert th.job_id == jh.job_id
        assert WORKER_PORT in th.artifact
        assert th.artifact == jh.artifact.replace("repro.worker",
                                                  "repro_torch.worker") \
            .replace("--cid", "--client-id")
    assert handles[0].artifact.lstrip().startswith("#!/bin/bash")
    assert got["handles"][0].artifact[:260] in out


@pytest.fixture(scope="module")
def hybrid_training():
    data = j_medmnist(n=3000)
    parts = j_dirichlet(data.y, 16, alpha=0.3)
    fed = JFed(data, parts)
    model = JCNN(JCNNConfig("med-cnn", (28, 28, 1), 9, channels=(8, 16),
                            dense=64))
    params = np_tree(model.init(jax.random.PRNGKey(0)))
    comp = JComp(quantize_bits=8, stochastic_rounding=False)
    fleet = j_fleet(8, 8, data_sizes=[len(p) for p in parts])
    orch = JOrch(
        fleet=fleet, fed_data=fed, loss_fn=model.loss_fn,
        fl=JFL(num_clients=6, local_steps=2, client_lr=0.08,
               fedprox_mu=0.02, compression=comp),
        straggler=JStraggler(deadline_s=30.0, contention_sigma=0.4),
        faults=JFaults(dropout_prob=0.2, spot_preempt_prob=0.2,
                       partition_prob=0.1, partition_len=2),
        batch_size=16, flops_per_client_round=2e12)
    jp, _ = orch.run(params, ROUNDS)
    sched = JOrch(
        fleet=j_fleet(8, 8, data_sizes=[len(p) for p in parts]),
        fed_data=fed, loss_fn=model.loss_fn,
        fl=JFL(num_clients=6, local_steps=2, client_lr=0.08,
               compression=comp),
        straggler=JStraggler(contention_sigma=0.4), batch_size=16,
        flops_per_client_round=2e12,
        backend=JSchedBackend(JHybrid(
            slurm=JSlurm(total_nodes=2),
            k8s=JK8s(initial_nodes=2, max_nodes=3,
                     preempt_prob_per_min=2.0))))
    jsp, _ = sched.run(params, ROUNDS)
    got = example("hybrid_hpc_cloud_sim").train(
        "cpu", rounds=ROUNDS, sched_rounds=ROUNDS, stochastic_rounding=False,
        params=convert.params_from_jax(params))
    return dict(orch=orch, fleet=fleet, params=np_tree(jp), sched_orch=sched,
                sched_params=np_tree(jsp)), got


def site_bytes(orch, fleet) -> dict:
    """Uplink bytes and link seconds by site, as the example prints them."""
    out = {}
    for site in ("hpc", "cloud"):
        cids = {c.cid for c in fleet if c.site == site}
        recs = [r for r in orch.comm.records
                if r.cid in cids and r.direction == "up"]
        out[site] = (sum(r.nbytes for r in recs), [r.seconds for r in recs])
    return out


def test_hybrid_training_host_logs(hybrid_training):
    want, got = hybrid_training
    assert_same_rounds(want["orch"], got["orch"])
    assert site_bytes(got["orch"], got["fleet"]) \
        == site_bytes(want["orch"], want["fleet"])
    assert sum(l.participated for l in got["orch"].logs) < ROUNDS * 6


def test_hybrid_scheduler_backed_host_logs(hybrid_training):
    want, got = hybrid_training
    assert_same_rounds(want["sched_orch"], got["sched_orch"])


def test_hybrid_params(hybrid_training):
    want, got = hybrid_training
    assert_params(got["params"], want["params"], "faults")
    assert_params(got["sched_params"], want["sched_params"], "scheduler")


# ---------------------------------------------------- federated finetune
FT_ARCH, FT_C, FT_H, FT_B, FT_S = "gemma-2b", 4, 2, 4, 32
FLIP_SHARE = 1e-3


def ft_batches(cfg, r):
    """Round r's client tokens as numpy, non-IID ranges as the example
    draws them."""
    rng = np.random.default_rng(100 + r)
    toks = np.stack([rng.integers((c * cfg.vocab) // (2 * FT_C),
                                  (c * cfg.vocab) // (2 * FT_C)
                                  + cfg.vocab // 2, (FT_H, FT_B, FT_S + 1))
                     for c in range(FT_C)]).astype(np.int32)
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}


@pytest.fixture(scope="module")
def finetune():
    cfg = jreduced(jget_config(FT_ARCH))
    m = jbuild(cfg)
    params = m.init(jax.random.PRNGKey(0))
    fl = JFL(num_clients=FT_C, local_steps=FT_H, client_lr=0.1,
             fedprox_mu=0.01, client_exec="sequential",
             compression=JComp(quantize_bits=8, topk_frac=0.25,
                               stochastic_rounding=False))
    step = jax.jit(j_round(m.loss_fn, j_client_opt("sgd"),
                           j_server_opt("fedavg"), fl))
    tp = convert.tree_from_jax(params, flat=True)
    jp, state, losses = params, (), []
    for r in range(ROUNDS):
        mask = jnp.asarray(np.random.default_rng(r).random(FT_C) > 0.2,
                           jnp.float32)
        batch = {k: jnp.asarray(v) for k, v in ft_batches(cfg, r).items()}
        jp, state, met = step(jp, state, batch, jnp.ones((FT_C,)), mask,
                              jax.random.PRNGKey(r))
        losses.append(float(met["client_loss"]))
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (2, 8)) \
        .astype(np.int32)
    got = example("federated_llm_finetune").run(
        FT_ARCH, rounds=ROUNDS, clients=FT_C, local_steps=FT_H,
        device="cpu", stochastic_rounding=False, params=tp,
        batches=lambda r: {k: torch.from_numpy(v)
                           for k, v in ft_batches(cfg, r).items()},
        serve=(torch.from_numpy(prompt), None))
    # the reference serves the port's trained params: serving held apart
    # from the rounds' top-k flips
    served = jax.tree.map(jnp.asarray, nest(convert.params_to_numpy(
        got["params"])))
    logits, st = m.prefill(served, {"tokens": jnp.asarray(prompt)},
                           s_max=16)
    tok = logits.argmax(-1).astype(jnp.int32)
    dlogits, _ = m.decode_step(served, st, tok, jnp.int32(8), None)
    want = dict(params=flat_dict(jax.tree.map(np.asarray, jp)),
                init=flat_dict(jax.tree.map(np.asarray, params)),
                losses=losses, prefill_logits=np.asarray(logits),
                decode_logits=np.asarray(dlogits))
    return want, got


def rel(got, want) -> float:
    got = got.detach().to(torch.float32).numpy()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_finetune_rounds(finetune):
    want, got = finetune
    assert [m["client_loss"] for m in got["metrics"]] == pytest.approx(
        want["losses"], rel=TOL)
    # 20% dropouts from default_rng(r), as the example masks
    assert [m["participation"] for m in got["metrics"]] == [
        float(np.mean(np.random.default_rng(r).random(FT_C) > 0.2))
        for r in range(ROUNDS)]


def test_finetune_params(finetune):
    """Every entry within 1e-4 but the top-k flips: each client's top 25%
    of a block is chosen from deltas that the two packages compute in
    another float order, so of two entries at a block's threshold one side
    keeps the first and the other the second (ROADMAP's discontinuous
    commits; reduced gemma-2b: embed row 168 keeps entry 52 in the
    reference and entry 147 in the port, both moved 4.75e-4), and round 1
    trains from params that differ there.  A flip moves an entry by one
    client's share of its kept delta, no more than the leaf's largest move
    over the run; at most FLIP_SHARE of a leaf's entries differ (29 of
    w1's 262,144, 1.1e-4, is the most seen)."""
    want, got = finetune
    tp = convert.params_to_numpy(got["params"])
    assert list(tp) == list(want["params"])
    flips = 0
    for k, v in want["params"].items():
        diff = np.abs(tp[k] - v)
        off = diff > TOL + TOL * np.abs(v)
        flips += int(off.sum())
        assert off.mean() <= FLIP_SHARE, (k, int(off.sum()))
        moved = np.abs(v - want["init"][k]).max()
        assert diff.max() <= moved, (k, diff.max(), moved)
    print(f"finetune: {flips} top-k flips beyond {TOL}")


def test_finetune_served_logits(finetune):
    want, got = finetune
    assert rel(got["prefill_logits"], want["prefill_logits"]) <= TOL
    assert rel(got["decode_logits"], want["decode_logits"]) <= TOL
    assert tuple(got["decode_logits"].shape) == want["decode_logits"].shape
    assert bool(torch.isfinite(got["decode_logits"]).all())


def test_finetune_draws_route_family_inputs():
    """The VLM's patches and the audio family's codebook tokens, shaped as
    the reference's client batches and prompt."""
    ex = example("federated_llm_finetune")
    for arch in ("llama-3.2-vision-90b", "musicgen-medium"):
        cfg = jreduced(jget_config(arch))
        b = ex.client_batches(cfg, 0, FT_C, FT_H)
        prompt, patches = ex.serve_inputs(cfg)
        if cfg.cross_attn_every:
            assert b["patches"].shape == (FT_C, FT_H, FT_B, cfg.n_patches,
                                          cfg.d_model)
            assert patches.shape == (2, cfg.n_patches, cfg.d_model)
        if cfg.n_codebooks:
            assert b["tokens"].shape == (FT_C, FT_H, FT_B, FT_S,
                                         cfg.n_codebooks)
            assert prompt.shape == (2, 8, cfg.n_codebooks)
            assert patches is None
        assert b["targets"].shape == b["tokens"].shape


# ------------------------------------------------------------ train_100m
NARROW = dict(name="lm-narrow", family="dense", n_layers=2, d_model=64,
              n_heads=4, kv_heads=2, d_ff=256, vocab=512, dtype="float32")
LM_SEQ, LM_SEQS, LM_BATCH = 64, 4000, 8          # the --ci corpus


@pytest.fixture(scope="module")
def train_100m(tmp_path_factory):
    cfg = JModelConfig(**NARROW)
    m = jbuild(cfg)
    params = m.init(jax.random.PRNGKey(0))
    n_params = sum(np.asarray(v).size for v in jax.tree.leaves(params))
    ds = j_shakespeare(n_seqs=LM_SEQS, seq_len=LM_SEQ,
                       vocab=min(cfg.vocab, 128), n_speakers=40)
    parts = j_by_group(ds.y, 20)
    jdir = tmp_path_factory.mktemp("jax_ckpt")
    tdir = tmp_path_factory.mktemp("torch_ckpt")
    orch = JOrch(
        fleet=j_fleet(10, 10, data_sizes=[len(p) for p in parts]),
        fed_data=JFed(ds, parts), loss_fn=m.loss_fn,
        fl=JFL(num_clients=8, local_steps=4, client_lr=0.25,
               fedprox_mu=0.01,
               compression=JComp(quantize_bits=8, stochastic_rounding=False)),
        straggler=JStraggler(fastest_k=6), batch_size=LM_BATCH,
        flops_per_client_round=6 * n_params * LM_BATCH * LM_SEQ * 4,
        checkpoint_mgr=JCkpt(jdir), checkpoint_every=1)
    jp, _ = orch.run(params, ROUNDS)
    _, torch_orch, tp = example("train_100m").build(
        ModelConfig(**NARROW), LM_SEQ, LM_SEQS, LM_BATCH, "cpu",
        checkpoint_dir=str(tdir), checkpoint_every=1,
        stochastic_rounding=False,
        params=convert.tree_from_jax(params, flat=True))
    tp, _ = torch_orch.run(tp, ROUNDS)
    return (orch, flat_dict(jax.tree.map(np.asarray, jp)), jdir,
            torch_orch, tp, tdir)


def test_train_100m_host_logs(train_100m):
    jorch, _, _, torch_orch, _, _ = train_100m
    assert_same_rounds(jorch, torch_orch)


def test_train_100m_params(train_100m):
    _, jp, _, _, tp, _ = train_100m
    assert_params(tp, jp, "train_100m")


def test_train_100m_snapshot_loads_into_the_port(train_100m):
    _, jp, jdir, torch_orch, tp, tdir = train_100m
    like = {k: torch.zeros_like(v) for k, v in tp.items()}
    got, _, meta = CheckpointManager(tdir).restore(like)
    assert meta["round"] == ROUNDS - 1
    assert meta["clock"] == torch_orch.virtual_clock
    assert all(torch.equal(got[k], tp[k]) for k in tp)
    # the reference's snapshot of the same run loads too
    jgot, _, jmeta = CheckpointManager(jdir).restore(like)
    assert jmeta["round"] == meta["round"]
    assert_params(jgot, jp, "the reference's snapshot")
