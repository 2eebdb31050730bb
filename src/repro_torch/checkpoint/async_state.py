"""Crash-safe checkpoint/resume for the event-driven async regime and the
two-tier hierarchy, mirroring ``repro/checkpoint/async_state.py``.

The sync Orchestrator restarts from (params, server state, round counter)
alone; ``AsyncOrchestrator`` does not: between two commits it carries a
pending-update buffer, an event heap of in-flight clients (each holding a
trained delta against an old params snapshot), the numpy streams
(dispatch/simulation, selection, fault injection), the commit generator,
per-client data-sampler generators, fleet histories, the commit log and the
comm ledger, and under ``--exec-backend scheduler`` the simulated SLURM/K8s
pool itself.  Dropping any of it on restore forks the trajectory.

``AsyncCheckpointManager`` serialises ALL of it:

  round_%06d/
    params.bin            global params            (save_pytree)
    server_state.bin      server optimizer state   (save_pytree)
    delta_%06d.bin        one file per pending update carrying a delta,
                          keyed by its dispatch seq (in flight or buffered)
    async_state.json      every host-side scalar, RNG, heap and log field
    meta.json             {round: commit counter, mode: "async", clock}

The files are the reference's format; ``async_state.json`` has the
reference's keys, except that the jax key chain ``jrng`` gives way to
``generator``: the commit generator's device type, initial seed,
``get_state()`` as a list of ints, and whether anything was drawn from it.
A generator state continues only on its own device type, so a restore on
another device type is refused once the generator was drawn from; an
undrawn one (no stochastic rounding, dropout or secure aggregation yet) is
the freshly seeded generator on any device.

A hierarchy's snapshot (``save_hier``/``restore_hier``) adds the tier-2
state beside every facility's own: ``hier_state.json``, one
``t2delta_%06d.bin`` per facility delta in flight or buffered, one
``fac%02d_delta_%06d.bin`` per async facility's pending update, and
``meta.json`` with ``mode: "hier"``.  A sync facility is snapshotted in
full (``sync_state_dict``), unlike a flat sync run.

Restore targets a FRESHLY CONSTRUCTED orchestrator built with the same
configuration (fleet layout, FLConfig/AsyncConfig, dataset seed); every
stochastic stream is overwritten with the saved state, so

    run(N)  ==  run-to-k -> kill -> restore -> run(N)

bit for bit on one device (``tests/test_torch_async_resume.py``,
``tests/test_torch_hierarchy.py``).
"""
from __future__ import annotations

import heapq
import json
from dataclasses import asdict

import torch

from repro_torch.checkpoint.io import (CheckpointManager, _atomic_write,
                                       load_pytree, save_pytree)

_UPD_FIELDS = ("seq", "cid", "client_idx", "dispatch_version",
               "dispatch_time", "duration_s", "loss", "weight", "failed",
               "fault", "steps_done", "retries", "recovery_s",
               "work_s", "queue_wait_s", "site", "job_id")


def _upd_meta(upd) -> dict:
    d = {f: getattr(upd, f) for f in _UPD_FIELDS}
    d["has_delta"] = upd.delta is not None
    return d


def _generator_state(gen: torch.Generator) -> dict:
    fresh = torch.Generator(device=gen.device)
    fresh.manual_seed(gen.initial_seed())
    state = gen.get_state()
    return {"device": gen.device.type, "initial_seed": gen.initial_seed(),
            "state": state.tolist(),
            "drawn": not torch.equal(state, fresh.get_state())}


def _load_generator(gen: torch.Generator, saved: dict):
    if saved["device"] == gen.device.type:
        gen.set_state(torch.tensor(saved["state"], dtype=torch.uint8))
    elif saved["drawn"]:
        raise ValueError(
            f"checkpoint's commit generator was drawn from on "
            f"{saved['device']}; its state continues only there, so resume "
            f"on a {saved['device']} device, not {gen.device.type}")
    else:
        gen.manual_seed(saved["initial_seed"])


def async_state_dict(orch) -> tuple[dict, dict]:
    """(json-serialisable host state, {seq: delta dict} for pending work)."""
    # deferred-training engines hold pending updates as un-run jobs: run
    # them, so the snapshot is self-contained and any engine can read it
    orch._materialize()
    deltas = {}
    events = []
    for t, seq, upd in orch._events:
        events.append({"time": t, **_upd_meta(upd)})
        if upd.delta is not None:
            deltas[upd.seq] = upd.delta
    buffer = []
    for upd, arrival in orch._buffer:
        buffer.append({"arrival": arrival, **_upd_meta(upd)})
        if upd.delta is not None:
            deltas[upd.seq] = upd.delta
    state = {
        "config": {"buffer_size": orch.async_cfg.buffer_size,
                   "local_steps": orch.fl.local_steps,
                   "n_fleet": len(orch.fleet),
                   "secure_agg": orch.fl.secure_agg,
                   "staleness_exponent":
                       str(orch.async_cfg.staleness_exponent),
                   "commit_chunk": orch.async_cfg.commit_chunk,
                   "exec_backend": orch.backend.name},
        # scheduler state: node pools, queued/in-flight jobs, adapter RNG;
        # empty for the closed-form backend (its randomness is orch.rng)
        "backend": orch.backend.state(),
        "recovery_actions": list(orch._recovery_actions),
        "clock": orch.clock,
        # the alpha the NEXT commit will use, plus the adaptive controller's
        # EMAs (None when the exponent is constant)
        "alpha": orch._alpha,
        "staleness_ctrl": (orch._staleness_ctrl.state()
                           if orch._staleness_ctrl is not None else None),
        "version": orch.version,
        "updates_applied": orch.updates_applied,
        "dropped_stale": orch.dropped_stale,
        "recovered_updates": orch.recovered_updates,
        "lost_to_faults": orch.lost_to_faults,
        "recovery_time_total": orch.recovery_time_total,
        "seq": orch._seq,
        "rng": orch.rng.bit_generator.state,
        "generator": _generator_state(orch.generator),
        "selection_rng": orch.selection.rng.bit_generator.state,
        "fault": orch.fault_injector.state(),
        "inflight": sorted(orch._inflight),
        "buffer_bytes": orch._buffer_bytes,
        "events": events,
        "buffer": buffer,
        "logs": [asdict(l) for l in orch.logs],
        "comm": [asdict(r) for r in orch.comm.records],
        "fleet": _fleet_histories(orch.fleet),
        "events_processed": [list(e) for e in orch.events_processed],
    }
    # per-client data-sampler generators: lazy datasets serialise only the
    # touched ones
    if hasattr(orch.fed_data, "rng_states"):
        state["data_rngs_lazy"] = orch.fed_data.rng_states()
    else:
        state["data_rngs"] = [g.bit_generator.state
                              for g in orch.fed_data._rngs]
    eng = orch.engine_state()
    if eng:
        state["engine"] = eng
    return state, deltas


def _fleet_histories(fleet) -> list[dict]:
    # lazy fleets (CohortFleet) serialise only the clients that ever
    # dispatched; the rest are reconstructable from the cohort specs
    return [{"cid": c.cid, "completions": c.completions,
             "failures": c.failures, "ema_round_time": c.ema_round_time,
             "last_selected_round": c.last_selected_round}
            for c in (fleet.live.values() if hasattr(fleet, "live")
                      else fleet)]


def _restore_fleet_histories(fleet, histories: list[dict]):
    """Snapshots carry histories only for touched clients; a fresh fleet's
    untouched clients already hold the default history.  Lazy fleets index
    by cid; list fleets go through a cid map, so sub-fleets with relabelled
    cids restore too."""
    if hasattr(fleet, "live"):
        lookup = lambda cid: fleet[cid]               # noqa: E731
    else:
        by_cid = {c.cid: c for c in fleet}
        lookup = lambda cid: by_cid[cid]              # noqa: E731
    for h in histories:
        c = lookup(int(h["cid"]))
        c.completions = int(h["completions"])
        c.failures = int(h["failures"])
        c.ema_round_time = float(h["ema_round_time"])
        c.last_selected_round = int(h["last_selected_round"])


def load_async_state(orch, state: dict, deltas: dict):
    """Overwrite a freshly constructed orchestrator's mutable state."""
    from repro_torch.comm.transport import TransferRecord
    from repro_torch.orchestrator.async_server import CommitLog, PendingUpdate

    cfg = state["config"]
    if cfg["buffer_size"] != orch.async_cfg.buffer_size \
            or cfg["local_steps"] != orch.fl.local_steps \
            or cfg["n_fleet"] != len(orch.fleet) \
            or cfg["secure_agg"] != orch.fl.secure_agg \
            or cfg["exec_backend"] != orch.backend.name \
            or cfg["commit_chunk"] != orch.async_cfg.commit_chunk \
            or cfg["staleness_exponent"] \
            != str(orch.async_cfg.staleness_exponent):
        raise ValueError(
            f"checkpoint was written by an orchestrator with config {cfg}; "
            f"restore requires an identically configured one")
    _load_generator(orch.generator, state["generator"])
    if state["backend"]:
        orch.backend.set_state(state["backend"])
    orch._recovery_actions = list(state["recovery_actions"])
    orch.clock = float(state["clock"])
    orch._alpha = float(state["alpha"])
    if orch._staleness_ctrl is not None and state["staleness_ctrl"]:
        orch._staleness_ctrl.set_state(state["staleness_ctrl"])
    orch.version = int(state["version"])
    orch.updates_applied = int(state["updates_applied"])
    orch.dropped_stale = int(state["dropped_stale"])
    orch.recovered_updates = int(state["recovered_updates"])
    orch.lost_to_faults = int(state["lost_to_faults"])
    orch.recovery_time_total = float(state["recovery_time_total"])
    orch._seq = int(state["seq"])
    orch.rng.bit_generator.state = state["rng"]
    orch.selection.rng.bit_generator.state = state["selection_rng"]
    orch.fault_injector.set_state(state["fault"])
    if "data_rngs_lazy" in state:
        if not hasattr(orch.fed_data, "load_rng_states"):
            raise ValueError(
                "checkpoint carries lazy per-client rng state but the "
                "restore dataset is not a VirtualFederatedDataset")
        orch.fed_data.load_rng_states(state["data_rngs_lazy"])
    else:
        for g, s in zip(orch.fed_data._rngs, state["data_rngs"]):
            g.bit_generator.state = s

    def mk_upd(meta):
        upd = PendingUpdate(**{f: meta[f] for f in _UPD_FIELDS})
        if meta["has_delta"]:
            upd.delta = deltas[upd.seq]
        return upd

    orch._events = [(e["time"], e["seq"], mk_upd(e)) for e in state["events"]]
    heapq.heapify(orch._events)
    orch._buffer = [(mk_upd(b), b["arrival"]) for b in state["buffer"]]
    orch._inflight = set(state["inflight"])
    orch._buffer_bytes = int(state["buffer_bytes"])
    orch.logs = [CommitLog(**l) for l in state["logs"]]
    orch.comm.records = [TransferRecord(**r) for r in state["comm"]]
    orch.events_processed = [tuple(e) for e in state["events_processed"]]
    _restore_fleet_histories(orch.fleet, state["fleet"])
    if state.get("engine"):
        if not hasattr(orch, "load_engine_state"):
            raise ValueError(
                "checkpoint carries engine-private state (cohort draw "
                "blocks) but the restore orchestrator is not a "
                "BatchedAsyncOrchestrator")
        orch.load_engine_state(state["engine"])
    orch._after_restore()


# ------------------------------------------------------------------ sync
def sync_state_dict(orch) -> dict:
    """Full mutable state of a synchronous ``Orchestrator``.

    The flat sync path restarts statelessly from (params, round counter),
    accepting a re-seeded RNG trajectory; a hierarchy's facilities cannot:
    a tier-1 facility's RNG streams, clock, logs and fleet histories feed
    later tier-2 epochs, so a bit-identical resume needs all of it.  The
    reference's jax key ``jrng`` gives way to the commit ``generator``."""
    return {
        "config": {"mode": "sync", "n_fleet": len(orch.fleet),
                   "num_clients": orch.fl.num_clients,
                   "local_steps": orch.fl.local_steps,
                   "secure_agg": orch.fl.secure_agg,
                   "exec_backend": orch.backend.name},
        "backend": orch.backend.state(),
        "clock": orch.virtual_clock,
        "rng": orch.rng.bit_generator.state,
        "generator": _generator_state(orch.generator),
        "selection_rng": orch.selection.rng.bit_generator.state,
        "fault": orch.fault_injector.state(),
        # selection returns numpy ints: made ints for the json encoder
        "logs": [{**asdict(l), "selected": [int(s) for s in l.selected]}
                 for l in orch.logs],
        "comm": [asdict(r) for r in orch.comm.records],
        "fleet": _fleet_histories(orch.fleet),
        "data_rngs": [g.bit_generator.state for g in orch.fed_data._rngs],
    }


def load_sync_state(orch, state: dict):
    """Overwrite a freshly constructed sync ``Orchestrator``'s state."""
    from repro_torch.comm.transport import TransferRecord
    from repro_torch.orchestrator.server import RoundLog

    cfg = state["config"]
    if cfg["n_fleet"] != len(orch.fleet) \
            or cfg["num_clients"] != orch.fl.num_clients \
            or cfg["local_steps"] != orch.fl.local_steps \
            or cfg["secure_agg"] != orch.fl.secure_agg \
            or cfg["exec_backend"] != orch.backend.name:
        raise ValueError(
            f"checkpoint was written by an orchestrator with config {cfg}; "
            f"restore requires an identically configured one")
    _load_generator(orch.generator, state["generator"])
    if state["backend"]:
        orch.backend.set_state(state["backend"])
    orch.virtual_clock = float(state["clock"])
    orch.rng.bit_generator.state = state["rng"]
    orch.selection.rng.bit_generator.state = state["selection_rng"]
    orch.fault_injector.set_state(state["fault"])
    orch.logs = [RoundLog(**l) for l in state["logs"]]
    orch.comm.records = [TransferRecord(**r) for r in state["comm"]]
    _restore_fleet_histories(orch.fleet, state["fleet"])
    for g, s in zip(orch.fed_data._rngs, state["data_rngs"]):
        g.bit_generator.state = s


# ------------------------------------------------------------- hierarchy
_FAC_UPD_FIELDS = ("seq", "fac", "dispatch_version", "dispatch_time",
                   "wall_s", "up_seconds", "weight", "loss")


def _fac_upd_meta(upd) -> dict:
    d = {f: getattr(upd, f) for f in _FAC_UPD_FIELDS}
    d["has_delta"] = upd.delta is not None
    return d


def hier_state_dict(hier):
    """(json state, {seq: tier-2 delta}, [per-facility {seq: delta}]).

    The tier-2 state mirrors the async serializer (heap, buffer, RNGs,
    logs, the WAN comm ledger); each facility contributes its own
    sub-orchestrator snapshot through the serializer of its regime."""
    t2_deltas = {}
    events = []
    for t, seq, upd in hier._events:
        events.append({"time": t, **_fac_upd_meta(upd)})
        if upd.delta is not None:
            t2_deltas[upd.seq] = upd.delta
    buffer = []
    for upd, arrival in hier._buffer:
        buffer.append({"arrival": arrival, **_fac_upd_meta(upd)})
        if upd.delta is not None:
            t2_deltas[upd.seq] = upd.delta
    fac_states, fac_deltas = [], []
    for fac in hier.facilities:
        if fac.mode == "async":
            st, fd = async_state_dict(fac.orch)
        else:
            st, fd = sync_state_dict(fac.orch), {}
        fac_states.append({"mode": fac.mode, "name": fac.name,
                           "local_rounds": fac.local_rounds, "state": st})
        fac_deltas.append(fd)
    state = {
        "config": {"n_facilities": len(hier.facilities),
                   "inter_mode": hier.inter_mode,
                   "buffer_size": hier.async_cfg.buffer_size,
                   "secure_agg": hier.fl.secure_agg,
                   "modes": [f.mode for f in hier.facilities],
                   "local_rounds": [f.local_rounds for f in hier.facilities]},
        "clock": hier.clock,
        "version": hier.version,
        "seq": hier._seq,
        "alpha": hier._alpha,
        "dropped_stale": hier.dropped_stale,
        "buffer_bytes": hier._buffer_bytes,
        "rng": hier.rng.bit_generator.state,
        "generator": _generator_state(hier.generator),
        "events": events,
        "buffer": buffer,
        "logs": [asdict(l) for l in hier.logs],
        "comm": [asdict(r) for r in hier.comm.records],
        "facilities": fac_states,
    }
    return state, t2_deltas, fac_deltas


def load_hier_state(hier, state: dict, t2_deltas: dict,
                    fac_deltas: list[dict]):
    """Overwrite a freshly constructed ``HierarchicalOrchestrator``."""
    from repro_torch.comm.transport import TransferRecord
    from repro_torch.orchestrator.async_server import CommitLog
    from repro_torch.orchestrator.hierarchy import FacilityUpdate

    cfg = state["config"]
    if cfg["n_facilities"] != len(hier.facilities) \
            or cfg["inter_mode"] != hier.inter_mode \
            or cfg["buffer_size"] != hier.async_cfg.buffer_size \
            or cfg["secure_agg"] != hier.fl.secure_agg \
            or cfg["modes"] != [f.mode for f in hier.facilities] \
            or cfg["local_rounds"] != [f.local_rounds
                                       for f in hier.facilities]:
        raise ValueError(
            f"checkpoint was written by a hierarchy with config {cfg}; "
            f"restore requires an identically configured one")
    _load_generator(hier.generator, state["generator"])
    hier.clock = float(state["clock"])
    hier.version = int(state["version"])
    hier._seq = int(state["seq"])
    hier._alpha = float(state["alpha"])
    hier.dropped_stale = int(state["dropped_stale"])
    hier._buffer_bytes = int(state["buffer_bytes"])
    hier.rng.bit_generator.state = state["rng"]

    def mk_upd(meta):
        upd = FacilityUpdate(**{f: meta[f] for f in _FAC_UPD_FIELDS})
        if meta["has_delta"]:
            upd.delta = t2_deltas[upd.seq]
        return upd

    hier._events = [(e["time"], e["seq"], mk_upd(e))
                    for e in state["events"]]
    heapq.heapify(hier._events)
    hier._buffer = [(mk_upd(b), b["arrival"]) for b in state["buffer"]]
    hier.logs = [CommitLog(**l) for l in state["logs"]]
    hier.comm.records = [TransferRecord(**r) for r in state["comm"]]
    for fac, meta, fd in zip(hier.facilities, state["facilities"],
                             fac_deltas):
        if meta["mode"] != fac.mode:
            raise ValueError(
                f"facility {meta['name']} was checkpointed in "
                f"{meta['mode']} mode; restore facility runs {fac.mode}")
        if fac.mode == "async":
            load_async_state(fac.orch, meta["state"], fd)
        else:
            load_sync_state(fac.orch, meta["state"])


class AsyncCheckpointManager(CheckpointManager):
    """CheckpointManager grown to cover the async orchestrator's full state.

    ``save``/``restore`` (params + server state + meta) keep working for the
    sync path; ``save_async``/``restore_async`` additionally round-trip the
    event heap, the pending-update buffer and every RNG stream."""

    def save_async(self, orch, params, server_state):
        step_dir = self.step_dir(orch.version)
        save_pytree(step_dir / "params.bin", params)
        if server_state is not None:
            save_pytree(step_dir / "server_state.bin", server_state)
        state, deltas = async_state_dict(orch)
        for seq, delta in deltas.items():
            save_pytree(step_dir / f"delta_{seq:06d}.bin", delta)
        _atomic_write(step_dir / "async_state.json",
                      json.dumps(state).encode())
        _atomic_write(step_dir / "meta.json",
                      json.dumps({"round": orch.version, "mode": "async",
                                  "clock": orch.clock}).encode())
        self._finalize(step_dir)

    def restore_async(self, orch, params_like, rnd: int | None = None):
        """Load the latest (or ``rnd``-th) snapshot INTO ``orch``, which
        must be freshly constructed with the writer's configuration.
        Returns ``(params, server_state)`` on ``params_like``'s device,
        ready for ``orch.run(params, N, server_state=server_state)``."""
        rnd = rnd if rnd is not None else self.latest_round()
        if rnd is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        step_dir = self.step_dir(rnd)
        params = load_pytree(step_dir / "params.bin", params_like)
        server_state = orch.init_server_state(params)
        ss_path = step_dir / "server_state.bin"
        if ss_path.exists():
            server_state = load_pytree(ss_path, server_state)
        state = json.loads((step_dir / "async_state.json").read_text())
        seqs = [e["seq"] for e in state["events"] + state["buffer"]
                if e["has_delta"]]
        deltas = {seq: load_pytree(step_dir / f"delta_{seq:06d}.bin",
                                   params_like)
                  for seq in seqs}
        load_async_state(orch, state, deltas)
        return params, server_state

    # ------------------------------------------------------- hierarchy
    def save_hier(self, hier, params, server_state):
        """Snapshot a two-tier run: the tier-2 params, heap, buffer and
        RNGs plus every facility's full sub-orchestrator state, one
        self-contained directory per tier-2 commit."""
        step_dir = self.step_dir(hier.version)
        save_pytree(step_dir / "params.bin", params)
        if server_state is not None:
            save_pytree(step_dir / "server_state.bin", server_state)
        state, t2_deltas, fac_deltas = hier_state_dict(hier)
        for seq, delta in t2_deltas.items():
            save_pytree(step_dir / f"t2delta_{seq:06d}.bin", delta)
        for f, fd in enumerate(fac_deltas):
            for seq, delta in fd.items():
                save_pytree(step_dir / f"fac{f:02d}_delta_{seq:06d}.bin",
                            delta)
        _atomic_write(step_dir / "hier_state.json",
                      json.dumps(state).encode())
        _atomic_write(step_dir / "meta.json",
                      json.dumps({"round": hier.version, "mode": "hier",
                                  "clock": hier.clock}).encode())
        self._finalize(step_dir)

    def restore_hier(self, hier, params_like, rnd: int | None = None):
        """Load the latest (or ``rnd``-th) hierarchy snapshot INTO ``hier``
        (freshly constructed, with the writer's facility layout and
        configs).  Returns ``(params, server_state)`` on ``params_like``'s
        device."""
        rnd = rnd if rnd is not None else self.latest_round()
        if rnd is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        step_dir = self.step_dir(rnd)
        params = load_pytree(step_dir / "params.bin", params_like)
        server_state = hier.init_server_state(params)
        ss_path = step_dir / "server_state.bin"
        if ss_path.exists():
            server_state = load_pytree(ss_path, server_state)
        state = json.loads((step_dir / "hier_state.json").read_text())
        t2_seqs = [e["seq"] for e in state["events"] + state["buffer"]
                   if e["has_delta"]]
        t2_deltas = {seq: load_pytree(step_dir / f"t2delta_{seq:06d}.bin",
                                      params_like)
                     for seq in t2_seqs}
        fac_deltas = []
        for f, meta in enumerate(state["facilities"]):
            fd = {}
            if meta["mode"] == "async":
                st = meta["state"]
                for e in st["events"] + st["buffer"]:
                    if e["has_delta"]:
                        fd[e["seq"]] = load_pytree(
                            step_dir / f"fac{f:02d}_delta_{e['seq']:06d}.bin",
                            params_like)
            fac_deltas.append(fd)
        load_hier_state(hier, state, t2_deltas, fac_deltas)
        return params, server_state
