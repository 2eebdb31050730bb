"""The port's checkpoint format, manager and resume path against the JAX
package's, on the CPU.

The format (``comm/payload.py``) is held byte for byte: for the same numpy
tree the port writes the reference's bytes (the CIFAR params, every server
optimizer's state, int and bool leaves, leaf-less trees, paths that sort
differently joined than level by level, and the char-LM's nested tree
against the port's flat view), and a file written by either package loads
in the other.  ``CheckpointManager`` mirrors tests/test_comm_checkpoint.py.
A resumed launcher run (2 rounds, then ``--resume`` to 4) is held against
the reference's resumed run to 1e-4 relative, the resume semantics being
the reference's (generators, selection and faults re-seeded from
``--seed``); host-side meta (clock, backend state) exactly."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.checkpoint import load_pytree as j_load
from repro.checkpoint import save_pytree as j_save
from repro.comm import deserialize_tree as j_deserialize
from repro.comm import serialize_tree as j_serialize
from repro.comm import tree_bytes as j_tree_bytes
from repro.configs import get_config as jget_config
from repro.launch import train as j_train
from repro.models import build_model as jbuild
from repro.models.cnn import CIFAR_CNN as J_CIFAR
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import MEDMNIST_CNN as J_MEDMNIST
from repro.optim import get_server_optimizer as j_server_opt
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.comm import deserialize_tree, serialize_tree, tree_bytes
from repro_torch.configs import get_config
from repro_torch.core import FLConfig
from repro_torch.exec import make_backend
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.models.cnn import CNN
from repro_torch.optim import get_server_optimizer
from repro_torch.orchestrator import Orchestrator
from repro_torch.pytree import flat_dict
from repro_torch.sched import K8sAdapter, SlurmAdapter

RESUME_TOL = 1e-4


def cifar_params():
    jp = JCNN(J_CIFAR).init(jax.random.PRNGKey(0))
    return jp, convert.params_from_jax({k: np.asarray(v)
                                        for k, v in jp.items()})


def assert_same_leaves(got, want):
    got_l, want_l = flat_dict(got), flat_dict(want)
    assert list(got_l) == list(want_l)
    for k, w in want_l.items():
        g = got_l[k]
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


# ------------------------------------------------------- bytes on the wire
def test_cifar_params_bytes_equal_reference():
    jp, tp = cifar_params()
    assert serialize_tree(tp) == j_serialize(jp)
    assert tree_bytes(tp) == j_tree_bytes(jp) == 4 * 1_070_794


@pytest.mark.parametrize("server", ["fedavg", "fedadam", "fedyogi"])
def test_server_state_bytes_equal_reference(server):
    """Each server optimizer's initial state from its own package's init:
    fedavg's leaf-less (), the adaptive ones' {"m", "v"} of float32."""
    jp, tp = cifar_params()
    js = j_server_opt(server).init(jp)
    ts = get_server_optimizer(server).init(tp)
    assert serialize_tree(ts) == j_serialize(js)
    back = deserialize_tree(j_serialize(js), like=ts)
    if server == "fedavg":
        assert back == ()
    else:
        assert_same_leaves(back, jax.tree.map(np.asarray, js))


def int_bool_trees():
    rng = np.random.default_rng(0)
    jt = {"step": np.int64(7) * np.ones((), np.int64),
          "epoch": np.arange(5, dtype=np.int32),
          "warm": np.array([True, False, True]),
          "bits": np.arange(4, dtype=np.uint8),
          "m": rng.normal(size=(2, 3)).astype(np.float32),
          "t": 3}
    tt = {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
              else v) for k, v in jt.items()}
    return jt, tt


def test_int_bool_leaves_bytes_equal_reference():
    jt, tt = int_bool_trees()
    assert serialize_tree(tt) == j_serialize(jt)
    back = deserialize_tree(serialize_tree(tt), like=tt)
    for k, v in tt.items():
        if torch.is_tensor(v):
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
        else:
            assert np.asarray(back[k]) == v


@pytest.mark.parametrize("tree", [(), {}, {"a": {}, "b": ()}, [(), None]],
                         ids=["tuple", "dict", "nested", "list"])
def test_leafless_trees_bytes_equal_reference(tree):
    assert serialize_tree(tree) == j_serialize(tree)
    assert deserialize_tree(serialize_tree(tree), like=tree) == tree


def test_paths_sort_level_by_level():
    """``a.b`` sorts after ``a`` at the top level, though the joined ``a/x``
    sorts after ``a.b`` as a string; sequence indices sort as numbers.  The
    nested tree and its flat view write the reference's bytes."""
    one = np.ones(2, np.float32)
    jt = {"a.b": one * 2, "a": {"x": one, "y": [one * i for i in range(12)]}}
    flat = {"a.b": one * 2, "a/x": one,
            **{f"a/y/[{i}]": one * i for i in range(12)}}
    flat = {k: torch.from_numpy(v) for k, v in flat.items()}
    nested = {"a.b": flat["a.b"], "a": {"x": flat["a/x"], "y": [
        flat[f"a/y/[{i}]"] for i in range(12)]}}
    want = j_serialize(jt)
    assert serialize_tree(nested) == want
    assert serialize_tree(flat) == want
    keys = list(j_deserialize(want))
    assert keys[0] == "a/x" and keys[-1] == "a.b" and keys[-2] == "a/y/[11]"


def test_charlm_flat_view_bytes_equal_reference_nested_tree():
    jm = jbuild(jget_config("paper-charlm"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.tree_from_jax(jp, flat=True)
    assert len(tp) == 11
    assert sum(v.numel() for v in tp.values()) == 3_246_336
    data = j_serialize(jp)
    assert serialize_tree(tp) == data
    assert list(j_deserialize(data)) == list(tp)
    # the port's own init, flattened, has the same paths and shapes
    own = flat_dict(build_model(get_config("paper-charlm")).init(
        torch.Generator().manual_seed(0)))
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in tp.items()}


# -------------------------------------------- files across the two packages
def test_files_load_in_either_package(tmp_path):
    jp, tp = cifar_params()
    jm = jbuild(jget_config("paper-charlm"))
    jlm = jm.init(jax.random.PRNGKey(1))
    tlm = convert.tree_from_jax(jlm, flat=True)
    jt, tt = int_bool_trees()
    for name, jtree, ttree in (("cifar", jp, tp), ("charlm", jlm, tlm),
                               ("ints", jt, tt)):
        save_pytree(tmp_path / f"{name}.torch.bin", ttree)
        j_save(tmp_path / f"{name}.jax.bin", jtree)
        assert (tmp_path / f"{name}.torch.bin").read_bytes() == (
            tmp_path / f"{name}.jax.bin").read_bytes()
        want = jax.tree.map(np.asarray, jtree)
        assert_same_leaves(j_load(tmp_path / f"{name}.torch.bin", jtree),
                           want)
        got = load_pytree(tmp_path / f"{name}.jax.bin", ttree)
        assert list(got) == list(ttree)
        assert_same_leaves({k: v for k, v in got.items()}, flat_dict(want)
                           if name == "charlm" else want)


# ------------------------------------------------------- CheckpointManager
def small_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.full((), 3.5)}}


def test_serialize_roundtrip_and_tree_bytes():
    t = small_tree()
    back = deserialize_tree(serialize_tree(t), like=t)
    assert_same_leaves(back, t)
    assert back["b"]["c"].dtype == torch.int32
    assert tree_bytes(t) == 12 * 4 + 5 * 4 + 4


def test_checkpoint_manager_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = small_tree()
    for rnd in (0, 5, 10):
        mgr.save(rnd, t, meta={"clock": rnd * 1.5})
    assert mgr.latest_round() == 10
    assert (tmp_path / "LATEST").read_bytes() == b"round_000010"
    params, state, meta = mgr.restore(t)
    assert state is None
    assert meta["round"] == 10 and meta["clock"] == 15.0
    dirs = sorted(d.name for d in tmp_path.iterdir() if d.is_dir())
    assert dirs == ["round_000005", "round_000010"]   # keep=2 gc'd round 0
    assert not [f for f in tmp_path.rglob(".tmp-*")]
    # the same directory through the reference's manager
    jp, js, jmeta = JCkpt(tmp_path).restore(jax.tree.map(
        lambda x: np.asarray(x), {"a": np.zeros((3, 4), np.float32),
                                  "b": {"c": np.zeros(5, np.int32),
                                        "d": np.zeros((), np.float32)}}))
    assert jmeta == meta
    assert_same_leaves(params, jax.tree.map(np.asarray, jp))


def test_checkpoint_resume_cycle_and_leafless_state(tmp_path):
    mgr = CheckpointManager(tmp_path)
    params = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 4)).astype(np.float32))}
    sstate = {"m": {"w": torch.ones(4, 4)}}
    mgr.save(7, params, sstate)
    p2, s2, meta = mgr.restore(params, sstate)
    assert torch.equal(p2["w"], params["w"])
    assert torch.equal(s2["m"]["w"], sstate["m"]["w"])
    mgr.save(8, params, server_state=(), meta={"clock": 2.5})
    assert (tmp_path / "round_000008" / "server_state.bin").exists()
    _, s3, meta = mgr.restore(params, server_state_like=())
    assert s3 == () and meta == {"round": 8, "clock": 2.5}
    assert mgr.restore(params)[1] is None


# ------------------------------------------------------------ Orchestrator
def test_orchestrator_run_saves_every_n_rounds_with_meta(tmp_path):
    """``run`` saves at every round with ``rnd % checkpoint_every == 0``,
    with the reference's meta; the manager keeps the last three."""
    from repro_torch.data import FederatedDataset, medmnist_like, \
        partition_by_class
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.orchestrator import make_hybrid_fleet
    ds = medmnist_like(n=300, seed=0)
    fed = FederatedDataset(ds, partition_by_class(ds.y, 4, 3, seed=0),
                           seed=0)
    model = CNN(CNNConfig("t", (28, 28, 1), 9, channels=(4, 8), dense=16))
    backend = make_backend(
        "scheduler", slurm=SlurmAdapter(total_nodes=2, seed=0),
        k8s=K8sAdapter(initial_nodes=1, max_nodes=2, seed=1))
    orch = Orchestrator(
        fleet=make_hybrid_fleet(2, 2, seed=0), fed_data=fed,
        loss_fn=model.loss_fn, fl=FLConfig(num_clients=2, local_steps=1),
        batch_size=4, server_opt_name="fedadam", backend=backend,
        checkpoint_mgr=CheckpointManager(tmp_path), checkpoint_every=2,
        seed=0, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params, state = orch.run(params, 7)
    dirs = sorted(d.name for d in tmp_path.iterdir() if d.is_dir())
    assert dirs == ["round_000002", "round_000004", "round_000006"]
    p6, s6, meta = orch.checkpoint_mgr.restore(params, state)
    assert meta["round"] == 6 and meta["exec_backend"] == "scheduler"
    assert meta["clock"] == sum(l.duration_s for l in orch.logs[:7])
    assert meta["backend_state"] and json.dumps(meta["backend_state"])
    assert set(s6) == {"m", "v"}


# ---------------------------------------------------------- resumed launcher
LAUNCH = ["--dataset", "medmnist", "--clients-pool", "8",
          "--clients-per-round", "4", "--local-steps", "1", "--batch-size",
          "8", "--checkpoint-every", "1", "--server-opt", "fedadam"]


def run_reference(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()
    out = capsys.readouterr().out
    return out, json.loads(out[out.index("{\n"):])


@pytest.mark.parametrize("backend", ["closed-form", "scheduler"])
def test_resumed_launcher_run_matches_reference(backend, tmp_path,
                                                monkeypatch, capsys):
    """2 rounds, then ``--resume`` to 4, in both packages.  The port starts
    from the reference's initial params; its resumed run restores the
    params, the fedadam state, the round, the clock and (under the
    scheduler backend) the adapters' state from its own checkpoint, and
    ends where the reference's resumed run ends."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    argv = LAUNCH + ["--exec-backend", backend]
    for rounds, extra in (("2", []), ("4", ["--resume"])):
        out, jsum = run_reference(argv + ["--rounds", rounds,
                                          "--checkpoint-dir", str(jdir)]
                                  + extra, monkeypatch, capsys)
    assert "resumed sync run at round 2" in out

    jm = JCNN(J_MEDMNIST)
    jp0 = jm.init(jax.random.PRNGKey(0))
    build_task = t_train.build_task

    def reference_init(*a, **kw):
        fed, model, _, eval_fn = build_task(*a, **kw)
        return fed, model, convert.params_from_jax(
            {k: np.asarray(v) for k, v in jp0.items()}), eval_fn

    monkeypatch.setattr(t_train, "build_task", reference_init)
    for rounds, extra in (("2", []), ("4", ["--resume"])):
        summary = t_train.main(["--device", "cpu", "--rounds", rounds,
                                "--checkpoint-dir", str(tdir)]
                               + argv + extra)
    out = capsys.readouterr().out
    assert "resumed sync run at round 2" in out
    assert len(summary["client_loss"]) == 2           # rounds 2 and 3
    for key in ("virtual_time_s", "mean_bytes_per_client_round",
                "mean_queue_wait_s", "overflow_clients",
                "preempted_clients"):
        assert summary[key] == jsum[key], key

    like = jax.tree.map(np.asarray, jp0)
    slike = jax.tree.map(np.asarray, j_server_opt("fedadam").init(jp0))
    want, wstate, wmeta = JCkpt(jdir).restore(like, slike)
    got, gstate, gmeta = JCkpt(tdir).restore(like, slike)
    # the scheduler's job specs name each package's worker module
    assert json.loads(json.dumps(gmeta).replace(
        "repro_torch.worker", "repro.worker")) == wmeta
    assert gmeta["round"] == 3
    for tree, ref in ((got, want), (gstate["m"], wstate["m"]),
                      (gstate["v"], wstate["v"])):
        for k, v in ref.items():
            err = np.abs(tree[k] - v).max() / max(np.abs(v).max(), 1e-30)
            assert err <= RESUME_TOL, k


def test_resume_under_another_backend_exits(tmp_path):
    argv = ["--device", "cpu", "--checkpoint-dir", str(tmp_path)] + LAUNCH
    t_train.main(argv + ["--rounds", "1", "--exec-backend", "scheduler"])
    with pytest.raises(SystemExit, match="--exec-backend scheduler"):
        t_train.main(argv + ["--rounds", "2", "--resume"])


def test_resume_without_checkpoint_dir_exits():
    with pytest.raises(SystemExit, match="--resume requires "
                                         "--checkpoint-dir"):
        t_train.main(["--device", "cpu", "--rounds", "1", "--resume"])


def test_resume_with_no_checkpoint_starts_at_round_0(tmp_path, capsys):
    summary = t_train.main(["--device", "cpu", "--rounds", "1",
                            "--checkpoint-dir", str(tmp_path), "--resume"]
                           + LAUNCH)
    assert "resumed" not in capsys.readouterr().out
    assert len(summary["client_loss"]) == 1


def test_scheduler_backend_state_round_trip():
    """The scheduler backend's state survives the checkpoint's JSON meta:
    a fresh backend given it reports the same state."""
    def backend():
        return make_backend(
            "scheduler", slurm=SlurmAdapter(total_nodes=2, seed=0),
            k8s=K8sAdapter(initial_nodes=1, max_nodes=2,
                           preempt_prob_per_min=0.5, seed=1))
    from repro_torch.orchestrator import make_hybrid_fleet
    from repro_torch.orchestrator.straggler import StragglerPolicy
    b = backend()
    b.bind(np.random.default_rng(0), StragglerPolicy())
    fleet = make_hybrid_fleet(2, 2, seed=0)
    for r in range(3):
        b.execute_round(fleet, 3e12, 1_000_000, 100.0 * r)
        b.end_round(100.0 * r + 50.0)
    state = json.loads(json.dumps(b.state()))
    fresh = backend()
    fresh.bind(np.random.default_rng(0), StragglerPolicy())
    fresh.set_state(state)
    assert fresh.state() == state
    with pytest.raises(ValueError, match="carries no state"):
        make_backend("closed-form").set_state(state)
