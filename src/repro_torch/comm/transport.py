"""Communication layer (paper §3.2): protocol abstraction + byte/time
accounting.

The paper's deployment uses gRPC (cloud) and MPI (HPC).  In this package
every client update lives on one device and the "transfer" is a local
reduction, so this layer's runtime job is *accounting and policy*: which
link class a transfer crosses, what it costs, and what the compression
config saves.  The link classes (the same table as repro/comm/transport.py,
kept so byte and clock accounting match the reference) are:

  grpc_cloud : cloud VM uplink    (~1 Gb/s, 10s of ms)
  mpi_hpc    : Infiniband         (~100 Gb/s, ~us)
  ici        : accelerator fabric (~50 GB/s/link, modelled link class)
  dcn        : cross-pod / WAN    (~6.25 GB/s, ms) — where hierarchical
               compressed aggregation applies.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class LinkClass:
    name: str
    bandwidth_GBps: float
    latency_s: float

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes / (self.bandwidth_GBps * 1e9)


GRPC_CLOUD = LinkClass("grpc_cloud", 0.125, 0.020)
MPI_HPC = LinkClass("mpi_hpc", 12.5, 5e-6)
ICI = LinkClass("ici", 50.0, 1e-6)
DCN = LinkClass("dcn", 6.25, 1e-3)

LINKS = {l.name: l for l in (GRPC_CLOUD, MPI_HPC, ICI, DCN)}


# Explicit site→link table.  An unknown site is a configuration error and
# must fail loudly: the old fallback silently billed any typo'd site string
# at cloud latency, which skews every byte/time table it feeds.
SITE_LINKS = {
    "hpc": MPI_HPC,
    "cloud": GRPC_CLOUD,
}


def link_for_site(site: str) -> LinkClass:
    try:
        return SITE_LINKS[site]
    except KeyError:
        raise KeyError(
            f"unknown site {site!r}: no entry in SITE_LINKS "
            f"(known: {sorted(SITE_LINKS)})") from None


@dataclass
class WANTopology:
    """Per-facility-pair WAN link model for inter-facility transfers.

    Every pair defaults to the DCN class; `set_pair` overrides bandwidth /
    latency for a specific (symmetric) pair.  Jitter is an exponential tail
    added on top of the deterministic transfer time — the draw comes from
    the *caller's* RNG so hierarchical runs stay checkpoint-replayable.
    Link objects keep the name "dcn" regardless of per-pair overrides so
    accounting groups all WAN traffic under one link class.
    """
    default: LinkClass = DCN
    jitter_s: float = 0.0
    _pairs: dict = field(default_factory=dict)

    @staticmethod
    def _key(a: str, b: str) -> tuple[str, str]:
        return (a, b) if a <= b else (b, a)

    def set_pair(self, a: str, b: str, bandwidth_GBps: float | None = None,
                 latency_s: float | None = None) -> None:
        self._pairs[self._key(a, b)] = LinkClass(
            self.default.name,
            bandwidth_GBps if bandwidth_GBps is not None
            else self.default.bandwidth_GBps,
            latency_s if latency_s is not None else self.default.latency_s)

    def link(self, a: str, b: str) -> LinkClass:
        return self._pairs.get(self._key(a, b), self.default)

    def transfer_time(self, a: str, b: str, nbytes: float,
                      rng=None) -> float:
        t = self.link(a, b).transfer_time(nbytes)
        if self.jitter_s > 0.0 and rng is not None:
            t += float(rng.exponential(self.jitter_s))
        return t


@dataclass
class TransferRecord:
    rnd: int
    cid: int
    direction: str      # up | down | inter_facility
    nbytes: int
    link: str
    seconds: float


@dataclass
class CommAccountant:
    """Collects every logical transfer of a training run."""
    records: list = field(default_factory=list)

    def log(self, rnd: int, cid: int, direction: str, nbytes: int,
            link: LinkClass, seconds: float | None = None) -> float:
        """`seconds` overrides the link's deterministic transfer time —
        used by WANTopology callers that add jitter on their own RNG."""
        t = link.transfer_time(nbytes) if seconds is None else seconds
        self.records.append(TransferRecord(rnd, cid, direction, nbytes,
                                           link.name, t))
        return t

    def bytes_per_round(self, direction: str | None = None) -> dict[int, int]:
        out: dict[int, int] = {}
        for r in self.records:
            if direction and r.direction != direction:
                continue
            out[r.rnd] = out.get(r.rnd, 0) + r.nbytes
        return out

    def participants_per_round(self, direction: str = "up") -> dict[int, int]:
        out: dict[int, int] = {}
        for r in self.records:
            if r.direction == direction:
                out[r.rnd] = out.get(r.rnd, 0) + 1
        return out

    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self.records)

    def mean_bytes_per_client_round(self) -> float:
        ups = [r for r in self.records if r.direction == "up"]
        if not ups:
            return 0.0
        rounds = len({r.rnd for r in ups})
        clients = max(len({r.cid for r in ups}), 1)
        return sum(r.nbytes for r in ups) / max(rounds, 1) / clients
