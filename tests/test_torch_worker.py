"""The port's file-based client worker (``python -m repro_torch.worker``)
and the launcher's ``--render-jobs`` against the JAX package's, on the CPU.

Both workers read one ``global_round_0000.bin`` written by the reference
and train client 3 on its private CIFAR shard; their update files agree to
1e-5 relative (float32 sums in another order over 5 SGD steps) and their
metadata to the same loss within 1e-5 and the same data size.  The
rendered sbatch scripts and pod manifests are the reference's, the worker
module's name apart."""
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.checkpoint import load_pytree as j_load
from repro.checkpoint import save_pytree as j_save
from repro.launch import train as j_train
from repro.models.cnn import CIFAR_CNN as J_CIFAR
from repro.models.cnn import CNN as JCNN
from repro.orchestrator import make_hybrid_fleet as j_fleet
from repro import worker as j_worker
from repro_torch import worker
from repro_torch.launch import train as t_train
from repro_torch.orchestrator import make_hybrid_fleet

TOL = 1e-5
CLIENT = 3


def test_worker_update_matches_reference(tmp_path, monkeypatch, capsys):
    jp = JCNN(J_CIFAR).init(jax.random.PRNGKey(7))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    j_save(jdir / "global_round_0000.bin", jp)
    shutil.copytree(jdir, tdir)
    common = ["--client-id", str(CLIENT), "--once", "--timeout-s", "300"]
    monkeypatch.setattr(sys, "argv", ["worker", "--workdir", str(jdir)]
                        + common)
    j_worker.main()
    written = worker.main(["--device", "cpu", "--workdir", str(tdir)]
                          + common)
    out = capsys.readouterr().out
    stem = f"update_0000_client_{CLIENT:03d}"
    assert written == [tdir / f"{stem}.bin"]
    assert f"worker {CLIENT}: round 0" in out

    like = jax.tree.map(np.asarray, jp)
    want = j_load(jdir / f"{stem}.bin", like)
    got = j_load(tdir / f"{stem}.bin", like)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        err = np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-30)
        assert err <= TOL, k
    jmeta = json.loads((jdir / f"{stem}.json").read_text())
    meta = json.loads((tdir / f"{stem}.json").read_text())
    assert meta.keys() == jmeta.keys()
    assert meta["data_size"] == jmeta["data_size"]
    assert abs(meta["loss"] - jmeta["loss"]) <= TOL * abs(jmeta["loss"])


def test_worker_without_a_round_file_times_out_empty(tmp_path):
    assert worker.main(["--device", "cpu", "--client-id", "0", "--workdir",
                        str(tmp_path), "--timeout-s", "0.2",
                        "--poll-s", "0.05"]) == []


def test_render_jobs_match_reference(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    n = j_train.render_jobs(j_fleet(5, 5, seed=0), jdir)
    assert t_train.render_jobs(make_hybrid_fleet(5, 5, seed=0), tdir) == n
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    assert {Path(x).suffix for x in names} == {".sbatch", ".json"}
    for name in names:
        got = (tdir / name).read_text()
        assert "python -m repro_torch.worker --client-id" in got
        assert got.replace("repro_torch.worker", "repro.worker") == (
            jdir / name).read_text(), name


def test_launcher_renders_jobs_and_runs(tmp_path, capsys):
    out_dir = tmp_path / "jobs"
    t_train.main(["--device", "cpu", "--dataset", "medmnist", "--rounds",
                  "1", "--clients-pool", "4", "--clients-per-round", "2",
                  "--local-steps", "1", "--batch-size", "4",
                  "--render-jobs", str(out_dir)])
    assert f"rendered 4 scheduler artifacts -> {out_dir}" in \
        capsys.readouterr().out
    assert len(list(out_dir.iterdir())) == 4


def test_worker_requires_a_client_id():
    with pytest.raises(SystemExit):
        worker.main(["--workdir", "x"])          # --client-id is required
