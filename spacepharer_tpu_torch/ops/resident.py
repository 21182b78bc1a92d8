"""One device copy of each catalog per process.

A process that serves many searches against one catalog (a SetDB) sends
the catalog's arrays to the device once and reads them there on every
later search. The store maps a key to a tuple of device tensors, builds an
entry on first use and returns the same tensors on every later use.

The key is the catalog's SetDB object, held by a strong reference so that
its id is never reused while the entry lives, the parameters that shape
the arrays, and the device. Nothing in the key reads the catalog's bytes:
the same SetDB object is the same catalog.

Entries are evicted least recently used under a byte budget per device (a
quarter of a card's memory, CPU_BUDGET_BYTES on the CPU); an entry larger
than its budget is returned but not kept. release() frees every entry.
A build runs in the span resident_build and adds one to resident_builds;
a hit adds one to resident_hits; resident_bytes adds each kept entry's
bytes and takes off each evicted or released one's, so its total is what
the store holds. Nothing here imports torch at import time.
"""
import threading
from collections import OrderedDict

from ..logging import count, span

CPU_BUDGET_BYTES = 2 << 30


def _nbytes(value) -> int:
    return sum(t.numel() * t.element_size() for t in value
               if hasattr(t, "element_size"))


class Store:
    """{(id(owner), params, device): (owner, tensors, bytes)}, oldest use
    first. budget_bytes: one budget for every device, or None for the
    default of each device (budget())."""

    def __init__(self, budget_bytes=None):
        self.budget_bytes = budget_bytes
        self._entries = OrderedDict()
        self._lock = threading.Lock()

    def budget(self, device) -> int:
        """The byte budget of the entries on `device`, a torch.device
        (None: no tensor, the CPU's)."""
        if self.budget_bytes is not None:
            return self.budget_bytes
        if device is not None and device.type == "cuda":
            import torch
            return torch.cuda.get_device_properties(device).total_memory // 4
        return CPU_BUDGET_BYTES

    def get(self, owner, params: tuple, device, build):
        """The tensors of (owner, params) on `device`: the kept entry, or
        build() (a tuple of tensors on the device), kept for later."""
        key = (id(owner), params, str(device))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                count("resident_hits")
                return entry[1]
            with span("resident_build"):
                value = build()
            count("resident_builds")
            nbytes = _nbytes(value)
            budget = self.budget(next(
                (t.device for t in value if hasattr(t, "device")), None))
            if nbytes > budget:
                return value
            held = nbytes + sum(e[2] for k, e in self._entries.items()
                                if k[2] == key[2])
            for k in list(self._entries):
                if held <= budget:
                    break
                if k[2] == key[2]:
                    held -= self._drop(k)
            self._entries[key] = (owner, value, nbytes)
            count("resident_bytes", nbytes)
            return value

    def _drop(self, key) -> int:
        nbytes = self._entries.pop(key)[2]
        count("resident_bytes", -nbytes)
        return nbytes

    def held_bytes(self) -> int:
        with self._lock:
            return sum(e[2] for e in self._entries.values())

    def __len__(self):
        return len(self._entries)

    def release(self):
        """Free every entry."""
        with self._lock:
            for k in list(self._entries):
                self._drop(k)


_store = Store()


def get(owner, params: tuple, device, build):
    """The process's store: Store.get."""
    return _store.get(owner, params, device, build)


def release():
    """Free every entry of the process's store."""
    _store.release()
