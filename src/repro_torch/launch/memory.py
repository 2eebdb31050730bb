"""Live bytes of a step, counted from its own allocations: the port's
counterpart of the reference's ``compiled.memory_analysis()``.

``count_memory(device)`` is a context manager over a
``TorchDispatchMode``: every op dispatched inside the block that returns a
tensor on ``device``'s type whose storage did not exist before is charged
the storage's bytes rounded as the CUDA caching allocator rounds a block
(at least 512, then a multiple of 512), and the charge lasts until the
storage is freed (a ``weakref.finalize`` on it).  Views and in-place
results share their input's storage and are charged once.  It reads
shapes only, so it counts a step on ``meta`` tensors (the dry run), on the
CPU and on the card alike, and inside ``torch.func.vmap`` and ``grad``
(the mode sees the batched ops' plain tensors) and autograd's backward
(saved tensors stay charged while the graph holds them).

What the count yields (``MemoryCount``): ``peak`` and ``live`` bytes since
the block opened, ``window()`` for the peak within a part of it, and
``analysis(arguments, outputs)``: a step's four numbers as XLA's
``memory_analysis`` defines them, per device:

* ``argument_size_in_bytes``: the raw bytes of the step's tensor
  arguments;
* ``output_size_in_bytes``: the raw bytes of its returned tensors, aliased
  ones included;
* ``alias_size_in_bytes``: the bytes of the outputs whose storage is an
  argument's (the decode state, which the port updates in place; the
  reference donates no buffer, so its alias is 0);
* ``temp_size_in_bytes``: the peak of the live bytes the step allocated,
  less the rounded bytes of the outputs it allocated;

and ``peak_size_in_bytes``, the step's peak above its arguments (temp plus
the outputs it allocated), which the card's allocator peak over the step
(``torch.cuda.max_memory_allocated`` less what was allocated before) is
held to.  What no dispatched op returns is not seen: a library's
workspace (cuBLAS), a collective backend's staging (gloo), a kernel's own
temporaries inside one op, and a constant made by ``torch.tensor`` (on
``meta`` no op makes it; on the CPU and the card it comes lifted from a
tensor made outside the dispatcher, and is left out there too, so that
the three devices count alike).

Where the CPU stands in for the card, two things are charged as the card
charges them: draws made on a CPU generator are the host's, not the
step's device's, until they are moved to it (``drawn``), and a kernel
wrapper's plain version is charged the allocations of the wrapper's CUDA
branch (``kernels.launches.plain``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections.abc import Mapping

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

BLOCK = 512          # the CUDA caching allocator's smallest block and step


def rounded(nbytes: int) -> int:
    """``nbytes`` as the CUDA caching allocator rounds a block."""
    return 0 if nbytes <= 0 else max(BLOCK, -(-nbytes // BLOCK) * BLOCK)


def _raw_bytes(tree) -> int:
    """The raw bytes of the tensors in ``tree``."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _tensors(tree) -> list:
    """The tensors in ``tree``: nested mappings (a ``DecodeState``
    included), lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _key(t) -> int:
    return t.untyped_storage()._cdata


def _flat(xs) -> list:
    """The tensors in an op's arguments or results: a tensor, or tuples
    and lists of them and of other values."""
    if isinstance(xs, torch.Tensor):
        return [xs]
    out = []
    for x in xs if isinstance(xs, (tuple, list)) else ():
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            out.extend(_flat(x))
    return out


class _Window:
    def __init__(self, live: int):
        self.peak = live


class MemoryCount(TorchDispatchMode):
    """The live bytes of the storages allocated on ``device``'s type while
    the mode is on."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.live = 0
        self.peak = 0
        self.hidden = 0
        self._held: dict = {}          # storage key -> bytes charged
        self._windows: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.hidden:
            known = None
            for t in _flat(out):
                if t.device.type != self.device_type:
                    continue
                storage = t.untyped_storage()
                if storage._cdata in self._held:
                    continue
                if known is None:
                    known = {_key(a) for a in _flat(args)}
                    if kwargs:
                        known.update(_key(a) for a in _flat(
                            tuple(kwargs.values())))
                if storage._cdata not in known:
                    self._charge(storage)
        return out

    def _charge(self, storage) -> None:
        key = storage._cdata
        size = rounded(storage.nbytes())
        self._held[key] = size
        weakref.finalize(storage, self._free, key)
        self.live += size
        self.peak = max(self.peak, self.live)
        for w in self._windows:
            w.peak = max(w.peak, self.live)

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def charged(self, t) -> int:
        """The bytes charged for ``t``'s storage (0 if not charged here)."""
        return self._held.get(_key(t), 0)

    @contextlib.contextmanager
    def window(self):
        """Yields an object whose ``peak`` is the most bytes live at once
        while the block runs (counted from the same start as ``live``)."""
        w = _Window(self.live)
        self._windows.append(w)
        try:
            yield w
        finally:
            self._windows.remove(w)

    def analysis(self, arguments, outputs) -> dict:
        """The four numbers of a step counted from this count's opening,
        its tensor ``arguments`` and ``outputs`` (pytrees), and its peak
        (module docstring)."""
        args = {_key(t) for t in _tensors(arguments)}
        outs = _tensors(outputs)
        mine = {}
        for t in outs:
            if _key(t) not in args:
                mine[_key(t)] = self.charged(t)
        allocated = sum(mine.values())
        return {"argument_size_in_bytes": _raw_bytes(arguments),
                "output_size_in_bytes": _raw_bytes(outs),
                "temp_size_in_bytes": self.peak - allocated,
                "alias_size_in_bytes": _raw_bytes(
                    [t for t in outs if _key(t) in args]),
                "peak_size_in_bytes": self.peak}


@contextlib.contextmanager
def count_memory(device):
    """Count the live bytes of what the block allocates on ``device``'s
    type: yields the ``MemoryCount``."""
    with MemoryCount(device) as mode:
        yield mode


def _open() -> list:
    """The counts open on this thread (the dispatch modes' stack, which
    autograd carries to its device threads)."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, MemoryCount)]


def counting() -> bool:
    """Whether a count is open."""
    return bool(_open())


@contextlib.contextmanager
def uncharged(when: bool = True):
    """What the block allocates is charged to no open count (``when``
    False: the block is counted as usual)."""
    modes = _open() if when else []
    for m in modes:
        m.hidden += 1
    try:
        yield
    finally:
        for m in modes:
            m.hidden -= 1


def drawn(make, generator, device):
    """``make()``'s draws, made on ``generator``'s device, on ``device``.
    A CPU generator's draws are the host's: no open count is charged for
    them, only for their copy on ``device`` (where ``device`` is the CPU
    too and a count is open, a copy is made, as the card makes one)."""
    host = generator.device.type == "cpu"
    with uncharged(host):
        t = make()
    if host and counting() and t.device == torch.device(device):
        return t.clone(memory_format=torch.contiguous_format)
    return t.to(device)
