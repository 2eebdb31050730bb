"""Crash-safe async checkpoints in the port: killing an
``AsyncOrchestrator`` and restoring a fresh one from its snapshot
reproduces the uninterrupted run bit for bit on the CPU (final params,
every CommitLog field but the wall-clock profile, the processed-event
trace, the comm ledger), including the commit generator's draws under
secure aggregation with stochastic rounding.  Kill points: the first
commit, mid-buffer (a sim-time budget with updates buffered), mid-partition
(an active whole-site partition with recovery in flight), and between two
timeout deadlines.  A snapshot restores across engines; a mismatched
config is refused; the snapshot's files and keys are the reference's; and
the launcher's ``--mode async --checkpoint-dir ... --resume`` against
``repro.launch.train`` on the same flags."""
import json
import math
import sys
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
from repro.launch import train as j_train
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import CNNConfig as JConfig
from repro.orchestrator import AsyncOrchestrator as JOrch
from repro.orchestrator import StragglerPolicy as JStraggler
from repro.orchestrator import make_hybrid_fleet as j_fleet
from repro_torch.checkpoint import AsyncCheckpointManager
from repro_torch.checkpoint.async_state import _load_generator
from repro_torch.core import AsyncConfig, CompressionConfig, FLConfig
from repro_torch.data import (FederatedDataset, medmnist_like,
                              partition_dirichlet)
from repro_torch.launch import train as t_train
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.orchestrator import (AsyncOrchestrator,
                                      BatchedAsyncOrchestrator, FaultConfig,
                                      StragglerPolicy, make_hybrid_fleet)

TINY = dict(name="tiny-cnn", in_shape=(28, 28, 1), num_classes=9,
            channels=(4, 8), dense=32)
SEED, N_CLIENTS, N_COMMITS = 11, 6, 6
PARTITION_FAULTS = dict(partition_prob=0.9, partition_len=3,
                        spot_preempt_prob=0.3, recovery_policy="resume")
SECURE_STOCHASTIC = CompressionConfig(quantize_bits=8, topk_frac=0.1)
MODEL = CNN(CNNConfig(**TINY))


def make_orch(cls=AsyncOrchestrator, buffer_size=3, commit_timeout=0.0,
              faults=None, mgr=None, checkpoint_every=0, secure=False,
              **engine_kw):
    data = medmnist_like(n=400, seed=SEED)
    parts = partition_dirichlet(data.y, N_CLIENTS, alpha=0.5, seed=SEED)
    fleet = make_hybrid_fleet(N_CLIENTS // 2, N_CLIENTS - N_CLIENTS // 2,
                              seed=SEED, data_sizes=[len(p) for p in parts])
    fl = FLConfig(mode="async", num_clients=N_CLIENTS, local_steps=1,
                  client_lr=0.05, secure_agg=secure,
                  compression=SECURE_STOCHASTIC if secure
                  else CompressionConfig())
    orch = cls(fleet=fleet, fed_data=FederatedDataset(data, parts, seed=SEED),
               loss_fn=MODEL.loss_fn, fl=fl,
               async_cfg=AsyncConfig(buffer_size=buffer_size,
                                     commit_timeout_s=commit_timeout,
                                     max_concurrency=4),
               straggler=StragglerPolicy(contention_sigma=0.5),
               faults=faults or FaultConfig(), batch_size=8,
               flops_per_client_round=2e12, checkpoint_mgr=mgr,
               checkpoint_every=checkpoint_every, seed=SEED, device="cpu",
               **engine_kw)
    params = MODEL.init(torch.Generator().manual_seed(SEED))
    return orch, params


def _logs(orch):
    return [{k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
             for k, v in asdict(l).items() if k != "phase_wall"}
            for l in orch.logs]


def assert_same_run(resumed, straight, p_resumed, p_straight):
    assert _logs(resumed) == _logs(straight)
    assert resumed.events_processed == straight.events_processed
    assert resumed.comm.records == straight.comm.records
    for k in p_straight:
        assert torch.equal(p_resumed[k], p_straight[k]), k


@pytest.mark.parametrize("kill", ["first_commit", "mid_buffer",
                                  "mid_partition", "secure_stochastic"])
def test_kill_and_resume_reproduces_uninterrupted_run(tmp_path, kill):
    kw = {"mid_partition": dict(faults=FaultConfig(**PARTITION_FAULTS)),
          "secure_stochastic": dict(secure=True)}.get(kill, {})
    straight, params = make_orch(**kw)
    p_straight, _ = straight.run(params, N_COMMITS)

    mgr = AsyncCheckpointManager(tmp_path, keep=20)
    killed, params2 = make_orch(mgr=mgr, checkpoint_every=1, **kw)
    if kill == "mid_buffer":
        # cut just before the 3rd commit's triggering arrival: the snapshot
        # carries a non-empty buffer
        budget = float(np.nextafter(straight.logs[2].sim_time, 0.0))
        killed.run(params2, N_COMMITS, max_sim_time=budget)
        assert killed._buffer, "kill point failed to land mid-buffer"
    else:
        k = 2 if kill == "mid_partition" else 1
        killed.run(params2, k)
        assert killed.version == k
    if kill == "mid_partition":
        assert killed.fault_injector._partition_left > 0
        assert any(e[4] == "partition" for e in straight.events_processed)
    if kill == "secure_stochastic":
        # the commit drew from the generator: its state must be restored
        fresh = torch.Generator().manual_seed(SEED)
        assert not torch.equal(killed.generator.get_state(),
                               fresh.get_state())

    resumed, params3 = make_orch(mgr=mgr, **kw)
    p0, st0 = mgr.restore_async(resumed, params3)
    assert resumed.version == killed.version
    p_resumed, _ = resumed.run(p0, N_COMMITS, server_state=st0)
    assert_same_run(resumed, straight, p_resumed, p_straight)


def test_resume_between_timeout_deadlines(tmp_path):
    mk = lambda **kw: make_orch(buffer_size=64, commit_timeout=1.0, **kw)  # noqa: E731
    straight, params = mk()
    p_straight, _ = straight.run(params, 5)
    assert any(l.timeout_commit for l in straight.logs)
    mgr = AsyncCheckpointManager(tmp_path, keep=20)
    killed, params2 = mk(mgr=mgr)
    killed.run(params2, 5, max_sim_time=(straight.logs[1].sim_time
                                         + straight.logs[2].sim_time) / 2)
    assert 0 < killed.version < 5
    resumed, params3 = mk(mgr=mgr)
    p0, st0 = mgr.restore_async(resumed, params3)
    p_resumed, _ = resumed.run(p0, 5, server_state=st0)
    assert_same_run(resumed, straight, p_resumed, p_straight)


@pytest.mark.parametrize("writer,reader", [
    (BatchedAsyncOrchestrator, AsyncOrchestrator),
    (AsyncOrchestrator, BatchedAsyncOrchestrator)])
def test_resume_across_engines(tmp_path, writer, reader):
    """A snapshot from either engine continues in the other bit for bit:
    the same events, logs and params as the reader's uninterrupted run
    (every engine trains a client as one lane of a stacked call)."""
    kw = lambda cls: {"train_chunk": 3} if cls is BatchedAsyncOrchestrator \
        else {}                                            # noqa: E731
    straight, params = make_orch(reader, **kw(reader))
    p_straight, _ = straight.run(params, N_COMMITS)
    mgr = AsyncCheckpointManager(tmp_path, keep=20)
    killed, params2 = make_orch(writer, mgr=mgr, **kw(writer))
    killed.run(params2, 2)
    resumed, params3 = make_orch(reader, mgr=mgr, **kw(reader))
    p0, st0 = mgr.restore_async(resumed, params3)
    p_resumed, _ = resumed.run(p0, N_COMMITS, server_state=st0)
    assert_same_run(resumed, straight, p_resumed, p_straight)
    host = lambda o: [{k: v for k, v in l.items()                 # noqa: E731
                       if k not in ("client_loss", "delta_norm")}
                      for l in _logs(o)]
    assert host(resumed) == host(straight)


def test_restore_refuses_mismatched_config(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path)
    orch, params = make_orch(mgr=mgr)
    orch.run(params, 2)
    other, params2 = make_orch(buffer_size=5)
    with pytest.raises(ValueError, match="config"):
        mgr.restore_async(other, params2)


def test_generator_state_continues_only_on_its_device_type():
    """A drawn generator's state is refused on another device type; an
    undrawn one is the freshly seeded generator anywhere."""
    gen = torch.Generator().manual_seed(3)
    saved = {"device": "cuda", "initial_seed": 7, "state": [0] * 16,
             "drawn": True}
    with pytest.raises(ValueError, match="resume on a cuda device"):
        _load_generator(gen, saved)
    _load_generator(gen, dict(saved, drawn=False))
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(7).get_state())


def test_snapshot_files_and_keys_are_the_references(tmp_path):
    """Both packages snapshot the same run into the same file names and
    async_state.json keys (the jax key chain ``jrng`` gives way to the
    commit ``generator``), with equal host state."""
    data = j_medmnist(n=400, seed=SEED)
    parts = j_partition(data.y, N_CLIENTS, alpha=0.5, seed=SEED)
    fleet = j_fleet(N_CLIENTS // 2, N_CLIENTS - N_CLIENTS // 2, seed=SEED,
                    data_sizes=[len(p) for p in parts])
    jmgr = JManager(tmp_path / "jax")
    jmodel = JCNN(JConfig(**TINY))
    jorch = JOrch(fleet=fleet, fed_data=JFed(data, parts, seed=SEED),
                  loss_fn=jmodel.loss_fn,
                  fl=JFL(mode="async", num_clients=N_CLIENTS, local_steps=1,
                         client_lr=0.05),
                  async_cfg=JAsync(buffer_size=3, max_concurrency=4),
                  straggler=JStraggler(contention_sigma=0.5), batch_size=8,
                  flops_per_client_round=2e12, checkpoint_mgr=jmgr,
                  seed=SEED)
    jorch.run(jmodel.init(jax.random.PRNGKey(SEED)), 2)
    tmgr = AsyncCheckpointManager(tmp_path / "torch")
    torch_orch, params = make_orch(mgr=tmgr)
    torch_orch.run(params, 2)
    jdir, tdir = jmgr.step_dir(2), tmgr.step_dir(2)
    assert sorted(p.name for p in tdir.iterdir()) \
        == sorted(p.name for p in jdir.iterdir())
    jstate = json.loads((jdir / "async_state.json").read_text())
    tstate = json.loads((tdir / "async_state.json").read_text())
    assert set(tstate) == set(jstate) - {"jrng"} | {"generator"}
    for key in ("config", "events_processed", "comm", "inflight", "seq",
                "rng", "selection_rng", "fault", "data_rngs", "fleet"):
        assert tstate[key] == jstate[key], key
    assert json.loads((tdir / "meta.json").read_text()) \
        == json.loads((jdir / "meta.json").read_text())


LAUNCH = ["--mode", "async", "--dataset", "medmnist", "--clients-pool", "6",
          "--local-steps", "1", "--batch-size", "4", "--buffer-k", "2",
          "--max-concurrency", "3", "--checkpoint-every", "1"]


def test_launcher_checkpoint_and_resume_match_jax(tmp_path, monkeypatch,
                                                  capsys):
    """``--mode async --checkpoint-dir``, then ``--resume`` to more commits,
    on both launchers: the reference's summary keys (plus ``device``), and
    the same commits, updates, dropped-stale count and virtual time."""
    summaries = {}
    for name in ("jax", "torch"):
        argv = LAUNCH + ["--checkpoint-dir", str(tmp_path / name)]
        for extra in (["--rounds", "2"], ["--rounds", "4", "--resume"]):
            if name == "jax":
                monkeypatch.setattr(sys, "argv", ["train"] + argv + extra)
                j_train.main()
                out = capsys.readouterr().out
                summary = json.loads(out[out.index("\n{") + 1:])
            else:
                summary = t_train.main(["--device", "cpu"] + argv + extra)
                out = capsys.readouterr().out
        assert "resumed async run at commit 2" in out
        summaries[name] = summary
    jsum, tsum = summaries["jax"], summaries["torch"]
    assert set(jsum) | {"device"} <= set(tsum)
    assert tsum["device"] == "cpu" and tsum["commits"] == 4
    for key in ("commits", "updates_applied", "dropped_stale",
                "virtual_time_s", "engine", "mode", "mask_overhead_bytes",
                "recovered_updates", "lost_to_faults", "overflow_updates",
                "recovery_actions", "mean_queue_wait_s", "updates_per_sim_s"):
        assert tsum[key] == jsum[key], key


@pytest.mark.parametrize("flags", [["--engine", "batched"],
                                   ["--secure-agg", "--quantize-bits", "8"]])
def test_launcher_async_flags_match_jax(flags, monkeypatch, capsys):
    argv = LAUNCH[:-2] + ["--rounds", "3"] + flags
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()
    out = capsys.readouterr().out
    jsum = json.loads(out[out.index("\n{") + 1:])
    tsum = t_train.main(["--device", "cpu"] + argv)
    for key in ("commits", "updates_applied", "dropped_stale",
                "virtual_time_s", "engine", "mask_overhead_bytes"):
        assert tsum[key] == jsum[key], key
