"""Checkpointing: atomic pytree save/restore and the sync round state,
mirroring ``repro/checkpoint/io.py``.

Fault tolerance at the orchestrator level (paper §3.1): if the central
orchestrator dies, training resumes from (global model, server optimizer
state, round counter, clock, execution-backend state).  The files are the
reference's format (``comm/payload.py``), so a checkpoint written by either
package loads in the other.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from repro_torch.comm.payload import deserialize_tree, serialize_tree


def _atomic_write(path: Path, data: bytes):
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_pytree(path, tree):
    _atomic_write(Path(path), serialize_tree(tree))


def load_pytree(path, like):
    with open(path, "rb") as f:
        return deserialize_tree(f.read(), like=like)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)

    def step_dir(self, rnd: int) -> Path:
        return self.dir / f"round_{rnd:06d}"

    def _finalize(self, step_dir: Path):
        _atomic_write(self.dir / "LATEST", step_dir.name.encode())
        self._gc()

    def save(self, rnd: int, params, server_state=None,
             meta: dict | None = None):
        step_dir = self.step_dir(rnd)
        save_pytree(step_dir / "params.bin", params)
        # save whenever a server state was handed in, even a leaf-less one
        # like fedavg's (): "empty state" and "no state" restore differently
        if server_state is not None:
            save_pytree(step_dir / "server_state.bin", server_state)
        _atomic_write(step_dir / "meta.json",
                      json.dumps({"round": rnd, **(meta or {})}).encode())
        self._finalize(step_dir)

    def _gc(self):
        steps = sorted(d for d in self.dir.iterdir()
                       if d.is_dir() and d.name.startswith("round_"))
        for d in steps[:-self.keep]:
            for f in d.iterdir():
                f.unlink()
            d.rmdir()

    def latest_round(self) -> int | None:
        latest = self.dir / "LATEST"
        if not latest.exists():
            return None
        name = latest.read_bytes().decode().strip()
        return int(name.split("_")[1])

    def restore(self, params_like, server_state_like=None,
                rnd: int | None = None):
        rnd = rnd if rnd is not None else self.latest_round()
        if rnd is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        step_dir = self.step_dir(rnd)
        params = load_pytree(step_dir / "params.bin", params_like)
        server_state = None
        ss_path = step_dir / "server_state.bin"
        if server_state_like is not None and ss_path.exists():
            server_state = load_pytree(ss_path, server_state_like)
        meta = json.loads((step_dir / "meta.json").read_text())
        return params, server_state, meta
