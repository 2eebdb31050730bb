"""Event-window engine: one host read per commit window, mirroring
``repro/orchestrator/eventwindow.py``.

``BatchedAsyncOrchestrator`` trains a commit window's clients in stacked
buckets, but still reads each bucket's losses back at once, draws every
work-time and fault die as one scalar numpy call, and keeps the pending
arrivals in a heap of ``PendingUpdate`` objects.  This engine removes
those costs without changing a single draw or event:

  * ``BlockedGenerator`` wraps the orchestrator's and the fault injector's
    ``numpy.random.Generator`` so scalar draws are served from pre-drawn
    homogeneous blocks (one vectorized call per window instead of one per
    event).  numpy draws a block of n with the same values AND the same end
    state as n sequential scalar calls, and a partly used block is
    re-synced by rewinding the bit generator and replaying exactly the
    consumed prefix, so every consumer (the checkpoint's state capture
    included) sees the sequential stream bit for bit.
  * ``PendingStore`` keeps the pending arrivals in a numpy structured
    array (arrival time, seq, client id, params version at dispatch, fault
    kind) with a (t, seq) index heap; the ``PendingUpdate`` payloads are
    reached through a seq-keyed table only when an event pops.  Iteration
    yields (t, seq, upd) tuples, so the checkpoint serializer and the
    loader work unchanged.
  * Deferred loss reads: a bucket's losses stay ON THE DEVICE (stacking
    device scalars into the commit step reads nothing back), and the
    commit bundles its delta norm and every deferred bucket into ONE
    ``_host_fetch``.  A commit trains only the buffered seqs; off-buffer
    jobs stay queued.
  * ``ExecutionBackend.begin_window`` reserves a window-sized RNG block for
    the work-time draws and lets the scheduler backend amortise its
    terminal-job GC over the window.

The reference also blocks its jax key chain (``_KeyBlock``: a scanned
chain of splits, one device call per window).  The port has no key chain
to block: local training draws no randomness, and the commit draws from
the ``torch.Generator`` the orchestrator owns, at the commit, never at a
dispatch.  So there is no ``_KeyBlock`` here; the window engine blocks
only the numpy streams.

On flat fleets its events, comm ledger and every host field of its commit
logs equal the per-event engine's; params agree to float32 rounding (its
buckets hold other clients than the batched engine's).  On cohort fleets
it replays the batched engine's trajectory
(``tests/test_torch_eventwindow.py``).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.orchestrator.megafleet import BatchedAsyncOrchestrator


# ------------------------------------------------------------- rng blocks
class BlockedGenerator:
    """Serve scalar draws from pre-drawn homogeneous blocks, bit-identical
    to the sequential ``numpy.random.Generator`` stream.

    Exactness contract (``tests/test_torch_eventwindow.py``):

    * for ``random``/``uniform``/``lognormal``, numpy's block draw of n
      values equals n sequential scalar calls elementwise AND leaves the
      bit generator in the same end state;
    * a partly consumed block is ``_sync``'d by rewinding to the pre-block
      state and replaying exactly the consumed prefix, which recovers the
      sequential state bit for bit;
    * any other method (``choice``, ``integers``, ...) and any
      ``bit_generator`` access syncs first, so state-dependent draws and
      checkpoint save/restore see the exact sequential generator.
    """

    def __init__(self, gen: np.random.Generator, window: int = 256):
        self._gen = gen
        self._window = int(window)
        self._pending = 0            # reserve() hint for the next refill
        self._kind = None            # (name, *args) of the live block
        self._block = None
        self._i = 0
        self._state0 = None          # bit generator state before the block

    def reserve(self, n: int):
        """Size hint: at least ``n`` same-kind draws are coming; make the
        next refill big enough to serve them from one vectorized call."""
        self._pending = max(self._pending, int(n))

    def _raw(self, kind, size):
        name, args = kind[0], kind[1:]
        return getattr(self._gen, name)(*args, size=size)

    def _sync(self):
        """Return the wrapped generator to the exact sequential state."""
        if self._kind is None:
            return
        if self._i < len(self._block):
            self._gen.bit_generator.state = self._state0
            if self._i:
                self._raw(self._kind, self._i)
        self._kind = self._block = self._state0 = None
        self._i = 0

    def _refill(self, kind, n: int):
        self._sync()
        self._kind = kind
        self._state0 = self._gen.bit_generator.state
        size = max(self._window, self._pending, n)
        self._pending = 0
        self._block = self._raw(kind, size)
        self._i = 0

    def _serve(self, kind, size):
        if size is None:
            if self._kind != kind or self._i >= len(self._block):
                self._refill(kind, 1)
            v = self._block[self._i]
            self._i += 1
            return float(v)
        n = int(size)
        if self._kind != kind or self._i + n > len(self._block):
            self._refill(kind, n)
        out = self._block[self._i:self._i + n].copy()
        self._i += n
        return out

    def random(self, size=None):
        return self._serve(("random",), size)

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._serve(("uniform", float(low), float(high)), size)

    def lognormal(self, mean=0.0, sigma=1.0, size=None):
        return self._serve(("lognormal", float(mean), float(sigma)), size)

    @property
    def bit_generator(self):
        # the checkpoint's capture and restore: hand out the REAL bit
        # generator, sequential-exact (assignment through it lands on it)
        self._sync()
        return self._gen.bit_generator

    def __getattr__(self, name):
        # non-blocked draws (choice, integers, exponential, ...) go to the
        # real generator after an exact sync; only called for names the
        # wrapper itself lacks
        gen = object.__getattribute__(self, "_gen")
        self._sync()
        return getattr(gen, name)


# ----------------------------------------------------------- event store
_FAULT_CODES = {"": 0, "dropout": 1, "preempt": 2, "partition": 3}


class PendingStore:
    """Array-backed pending-arrival store, in place of the per-event
    engine's heap of (arrival_time, seq, PendingUpdate) tuples.

    The hot metadata (arrival time, seq, client id, params version at
    dispatch, fault kind) lives in a numpy structured array; ordering is a
    (t, seq) index heap (floats and ints only, no object comparisons); the
    ``PendingUpdate`` payloads live in a seq-keyed dict touched only when
    an event pops.  Iteration yields (t, seq, upd) tuples, so the
    checkpoint serializer, and the loader, which heapifies a plain tuple
    list that ``_after_restore`` converts back, work unchanged."""

    DTYPE = np.dtype([("t", np.float64), ("seq", np.int64),
                      ("cid", np.int64), ("version", np.int64),
                      ("fault", np.int8)])

    def __init__(self, events=()):
        self._heap: list[tuple] = []
        self._rows = np.zeros(64, self.DTYPE)
        self._n = 0                          # rows used (dead rows included)
        self._upd: dict[int, object] = {}    # seq -> PendingUpdate
        self._row: dict[int, int] = {}       # seq -> row index
        for t, seq, upd in events:
            self.push(t, seq, upd)

    def __len__(self) -> int:
        return len(self._heap)

    def __iter__(self):
        for t, seq in self._heap:
            yield t, seq, self._upd[seq]

    def push(self, t: float, seq: int, upd):
        if self._n == len(self._rows):
            self._compact_or_grow()
        self._rows[self._n] = (t, seq, upd.cid, upd.dispatch_version,
                               _FAULT_CODES.get(upd.fault, 0))
        self._row[seq] = self._n
        self._n += 1
        self._upd[seq] = upd
        heapq.heappush(self._heap, (t, seq))

    def pop(self):
        t, seq = heapq.heappop(self._heap)
        del self._row[seq]                   # the row goes dead; compacted
        return t, seq, self._upd.pop(seq)    # lazily

    def min_time(self):
        return self._heap[0][0] if self._heap else None

    @property
    def live(self) -> np.ndarray:
        """Structured rows of the live pending arrivals, in push order."""
        idx = np.sort(np.fromiter(self._row.values(), np.int64,
                                  len(self._row)))
        return self._rows[idx]

    def staleness(self, version: int) -> np.ndarray:
        """Commits elapsed since each pending arrival's dispatch: one
        vectorized subtract over the structured rows."""
        return np.int64(version) - self.live["version"]

    def _compact_or_grow(self):
        if len(self._row) <= len(self._rows) // 2:
            # at least half the rows are dead (popped): compact in place
            idx = np.sort(np.fromiter(self._row.values(), np.int64,
                                      len(self._row)))
            rows = self._rows[idx]
            self._rows[:len(rows)] = rows
            self._n = len(rows)
            self._row = {int(r["seq"]): i for i, r in enumerate(rows)}
        else:
            self._rows = np.concatenate(
                [self._rows, np.zeros(len(self._rows), self.DTYPE)])


# ----------------------------------------------------------------- engine
@dataclass
class EventWindowOrchestrator(BatchedAsyncOrchestrator):
    """``BatchedAsyncOrchestrator`` that processes events against
    window-blocked numpy streams and an array-backed pending store, with
    ONE bundled host read per commit window."""

    window: int = 256              # events per RNG/backend block

    def __post_init__(self):
        super().__post_init__()
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        # wrap the two scalar-draw streams the event loop consumes; the
        # backend holds a reference to the orchestrator's rng: re-bind it
        self.rng = BlockedGenerator(self.rng, self.window)
        self.backend.bind(self.rng, self.straggler)
        self.fault_injector.rng = BlockedGenerator(
            self.fault_injector.rng, self.window)
        self._deferred = []        # [(device losses [lanes], bucket jobs)]
        self._events = PendingStore()
        self.backend.begin_window(self.window)

    # ------------------------------------------------------- engine seams
    def _push_event(self, t, seq, upd):
        self._events.push(t, seq, upd)

    def _pop_event(self):
        return self._events.pop()

    # -------------------------------------------------- deferred reads
    def _finish_chunk(self, jobs, deltas, losses):
        # keep the bucket's losses ON THE DEVICE: the commit stacks device
        # scalars without a read, so the only reader of host floats is the
        # CommitLog, served by the commit's bundled read (or by
        # _flush_deferred for a full materialise)
        for i, job in enumerate(jobs):
            job.upd.delta = {k: d[i] for k, d in deltas.items()}
            job.upd.loss = losses[i]
        self._deferred.append((losses, list(jobs)))

    def _assign_losses(self, host):
        """Split one host vector of every deferred bucket's losses back
        into their updates, as host floats."""
        lo = 0
        for losses, jobs in self._deferred:
            lv = host[lo:lo + losses.numel()]
            for i, job in enumerate(jobs):
                job.upd.loss = float(lv[i])
            lo += losses.numel()
        self._deferred = []

    def _flush_deferred(self):
        if self._deferred:
            self._assign_losses(self._host_fetch(torch.cat(
                [b for b, _ in self._deferred])).numpy())

    def _materialize(self, seqs=None):
        super()._materialize(seqs)
        if seqs is None:
            # a full materialise (the checkpoint serializer): the snapshot
            # needs host floats
            self._flush_deferred()

    def _materialize_for_commit(self):
        # train only what this commit reads; off-buffer jobs stay queued
        self._materialize({u.seq for u, _ in self._buffer})

    def _commit_host_fetch(self, metrics, ups):
        # THE one host read of the commit window: the delta norm and every
        # deferred loss bucket in one tensor
        dn = metrics["delta_norm"].reshape(1).float()
        host = self._host_fetch(torch.cat(
            [dn] + [b.float() for b, _ in self._deferred])).numpy()
        self._assign_losses(host[1:])
        return float(host[0]), [float(u.loss) for u in ups]

    def _do_commit(self, params, server_state, at_time, timeout=False):
        out = super()._do_commit(params, server_state, at_time, timeout)
        # a fresh window begins: reserve the next RNG and GC blocks
        self.backend.begin_window(self.window)
        return out

    # ------------------------------------------------ checkpointable state
    def _after_restore(self):
        # the loader assigned a plain heapified tuple list to _events; the
        # deferred buckets were flushed by the pre-save materialise
        super()._after_restore()
        self._events = PendingStore(self._events)
        self._deferred = []
        self.backend.begin_window(self.window)
