"""The Central Orchestrator (paper §3.2): the sync round loop of Algorithm 1
with adaptive selection, straggler mitigation, fault injection and comm
accounting and checkpointing, mirroring ``repro/orchestrator/server.py``.

Host-side only: the heavy math is the round step from
``repro_torch.core.round`` on ``device``; the orchestrator decides who
participates, charges simulated wall-clock and bytes, and carries state
across rounds.  Selection, the straggler model and faults are numpy draws
from the same seeds as the reference, so they replay identically.  With a
``checkpoint_mgr``, ``run`` saves the params, the server state and the meta
``clock``, ``exec_backend`` and ``backend_state`` every
``checkpoint_every`` rounds, as the reference does; like the reference it
stores no generator state, so a resumed run re-seeds them from ``seed``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.comm.transport import CommAccountant, link_for_site
from repro_torch.core.compression import payload_bytes
from repro_torch.core.convergence import ConvergenceMonitor
from repro_torch.core.round import FLConfig, build_fl_round_step
from repro_torch.core.secure_agg import masked_payload_bytes
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.orchestrator.fault import FaultConfig, FaultInjector
from repro_torch.orchestrator.selection import get_selection
from repro_torch.orchestrator.straggler import StragglerPolicy, apply_mitigation


@dataclass
class RoundLog:
    rnd: int
    selected: list
    participated: int
    duration_s: float
    client_loss: float
    delta_norm: float
    bytes_up: int
    eval_metric: float = float("nan")
    mean_queue_wait_s: float = 0.0     # scheduler backend: PENDING time
    n_overflow: int = 0                # clients placed off their home site
    n_preempted: int = 0               # adapter-origin spot reclaims
    wall_s: float = 0.0                # host seconds of the round, through
    #                                    the metrics' read-back (a sync)


def to_device(batch: dict, device) -> dict:
    """numpy round batches -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@dataclass
class Orchestrator:
    fleet: list                       # list[ClientInfo]
    fed_data: object                  # FederatedDataset
    loss_fn: Callable                 # (params, batch) -> (loss, aux)
    fl: FLConfig
    client_opt_name: str = "sgd"
    server_opt_name: str = "fedavg"
    server_opt_kw: dict = field(default_factory=dict)
    selection_name: str = "adaptive"
    straggler: StragglerPolicy = field(default_factory=StragglerPolicy)
    faults: FaultConfig = field(default_factory=FaultConfig)
    batch_size: int = 16
    flops_per_client_round: float = 1e12
    eval_fn: Optional[Callable] = None     # (params) -> float metric
    eval_every: int = 10
    checkpoint_mgr: object = None     # checkpoint.CheckpointManager
    checkpoint_every: int = 0
    backend: object = None            # ExecutionBackend (None -> closed form)
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.fl.mode != "sync":
            raise ValueError(
                f"Orchestrator runs the synchronous barrier loop but got "
                f"FLConfig(mode={self.fl.mode!r}); use AsyncOrchestrator "
                f"for mode='async'")
        self.rng = np.random.default_rng(self.seed)
        # commit randomness (stochastic rounding, federated dropout, the
        # secure-aggregation commit keys)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        if self.backend is None:
            # local import: repro_torch.exec consumes the straggler model
            # from this package, so a module-level import would be circular
            from repro_torch.exec.backend import ClosedFormBackend
            self.backend = ClosedFormBackend()
        self.backend.bind(self.rng, self.straggler)
        self.selection = get_selection(self.selection_name, seed=self.seed)
        self.fault_injector = FaultInjector(self.faults, seed=self.seed + 1)
        self.comm = CommAccountant()
        self.logs: list[RoundLog] = []
        self.virtual_clock = 0.0
        client_opt = get_client_optimizer(self.client_opt_name)
        server_opt = get_server_optimizer(self.server_opt_name,
                                          **self.server_opt_kw)
        self._server_opt = server_opt
        self._round_step = build_fl_round_step(self.loss_fn, client_opt,
                                               server_opt, self.fl)

    # ------------------------------------------------------------------
    def init_server_state(self, params):
        return self._server_opt.init(params)

    def run_round(self, rnd: int, params, server_state):
        t0 = time.perf_counter()
        C = self.fl.num_clients
        selected = self.selection.select(self.fleet, C, rnd)
        clients = [self.fleet[c] for c in selected]

        # --- simulate system behaviour (host-side) ---
        down_bytes, up_bytes = self._payload_bytes_cache(params)
        execs = self.backend.execute_round(
            clients, self.flops_per_client_round, up_bytes,
            self.virtual_clock)
        times = np.asarray([e.duration_s for e in execs])
        mask, duration = apply_mitigation(times, self.straggler)
        self.fault_injector.step_round()
        mask = mask * self.fault_injector.survive_mask(
            clients, include_preempt=not self.backend.handles_preemption)
        if self.backend.handles_preemption:
            # spot reclaims originate from the scheduler's own event stream
            mask = mask * np.asarray([0.0 if e.preempted else 1.0
                                      for e in execs])

        # --- data + weights ---
        batches = to_device(self.fed_data.sample_round(
            selected, self.fl.local_steps, self.batch_size), self.device)
        weights = torch.tensor([max(self.fed_data.client_size(c), 1)
                                for c in selected], dtype=torch.float32,
                               device=self.device)
        tmask = torch.tensor(mask, dtype=torch.float32, device=self.device)

        # --- the Algorithm-1 round ---
        params, server_state, metrics = self._round_step(
            params, server_state, batches, weights, tmask, self.generator)
        client_loss = float(metrics["client_loss"])
        delta_norm = float(metrics["delta_norm"])

        # --- accounting (links charged by PLACEMENT site, not home site) ---
        bytes_up = 0
        for ci, c in enumerate(clients):
            link = link_for_site(execs[ci].site or c.site)
            self.comm.log(rnd, c.cid, "down", down_bytes, link)
            if mask[ci] > 0:
                self.comm.log(rnd, c.cid, "up", up_bytes, link)
                bytes_up += up_bytes
            c.record(mask[ci] > 0, float(times[ci]), rnd)
        self.virtual_clock += duration
        # barrier closed: straggler jobs cut by the mitigation are abandoned
        self.backend.end_round(self.virtual_clock)

        log = RoundLog(
            rnd=rnd, selected=selected, participated=int(mask.sum()),
            duration_s=duration, client_loss=client_loss,
            delta_norm=delta_norm, bytes_up=bytes_up,
            mean_queue_wait_s=float(np.mean([e.queue_wait_s for e in execs]))
            if execs else 0.0,
            n_overflow=sum(e.overflowed for e in execs),
            n_preempted=sum(e.preempted for e in execs),
            wall_s=time.perf_counter() - t0)
        self.logs.append(log)
        return params, server_state, log

    def _payload_bytes_cache(self, params):
        """(down_bytes, up_bytes): under secure_agg the uplink is the
        MASKED update — dense f32 without quantization, finite-ring words
        of quantize_bits + ceil(log2(cohort)) bits with it (integer-domain
        masking, core.pipeline) — while the params downlink stays plain."""
        if not hasattr(self, "_pb"):
            down = payload_bytes(params, self.fl.compression)
            up = (masked_payload_bytes(params, self.fl.compression,
                                       n_slots=self.fl.num_clients)
                  if self.fl.secure_agg else down)
            self._pb = (down, up)
        return self._pb

    def run(self, params, num_rounds: int, server_state=None,
            convergence_eps: float = 0.0, verbose: bool = False,
            start_round: int = 0):
        if server_state is None:
            server_state = self.init_server_state(params)
        monitor = ConvergenceMonitor(convergence_eps) if convergence_eps else None
        for rnd in range(start_round, num_rounds):
            params, server_state, log = self.run_round(rnd, params, server_state)
            if self.eval_fn and (rnd % self.eval_every == 0
                                 or rnd == num_rounds - 1):
                log.eval_metric = float(self.eval_fn(params))
            if verbose:
                print(f"round {rnd:4d} loss={log.client_loss:.4f} "
                      f"dur={log.duration_s:.1f}s part={log.participated} "
                      f"eval={log.eval_metric:.4f} wall={log.wall_s:.3f}s")
            if self.checkpoint_mgr and self.checkpoint_every and \
                    rnd % self.checkpoint_every == 0:
                self.checkpoint_mgr.save(
                    rnd, params, server_state,
                    {"clock": self.virtual_clock,
                     "exec_backend": self.backend.name,
                     "backend_state": self.backend.state()})
            if monitor and monitor.update(log.delta_norm):
                break
        return params, server_state
