"""Versioned snapshot read handles — the ingest/query synchronisation.

The publisher maintains a copy-on-write device mirror
(``DeviceMirror(donate=False)``): every publish yields a fresh dict
whose changed tensors are new tensors (unchanged ones are shared), so a
handle pinned by an in-flight query keeps a complete, immutable view of
its version no matter how many deltas land afterwards.  A publish never
writes into a tensor that a handle holds.

Ingest and queries run on two threads but one CUDA stream (each
thread's current stream is the device's default stream), so the
mirror's copy and scatter work and the queries' kernels are ordered by
the order the host enqueued them.

Swap protocol: ``publish`` builds the :class:`SnapshotHandle` off to
the side and installs it with a single reference assignment (atomic
under the GIL).  Readers call :meth:`HandlePublisher.current` once at
batch admission and use only that handle.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Dict, Optional

from repro_torch.core.sampling import DeviceMirror
from repro_torch.core.snapshot import GraphSnapshot


@dataclasses.dataclass(frozen=True)
class SnapshotHandle:
    """One immutable (snapshot version, device tensors, params) triple.

    ``dev`` is the copy-on-write mirror dict for ``version`` — safe to
    sample against from any thread for as long as the handle is held.
    ``params`` are the model parameters the publisher most recently
    associated with this version (never written in place)."""
    version: int
    dev: Dict[str, Any]
    params: Any
    t_max: float = 0.0        # newest event timestamp in the snapshot
    n_events: int = 0         # events ingested up to this version
    scan_pages: int = 16


class HandlePublisher:
    """Single-writer publisher of :class:`SnapshotHandle`\\ s.

    ``publish``/``set_params`` are called from the ingest/train thread;
    ``current``/``get`` from any number of query threads.  A small
    version-keyed history is retained so offline parity checks can
    recompute a forward on the exact handle a response was served from.
    """

    def __init__(self, *, scan_pages: int = 16, history: int = 8,
                 device=None):
        # donate=False: copy-on-write tensors so pinned handles stay
        # valid; quantize=True: pow2-bucketed device shapes
        self._mirror = DeviceMirror(scan_pages=scan_pages, donate=False,
                                    quantize=True, device=device)
        self.device = self._mirror.device
        self.scan_pages = int(scan_pages)
        self._current: Optional[SnapshotHandle] = None
        self._history: "collections.OrderedDict[int, SnapshotHandle]" = \
            collections.OrderedDict()
        self._hist_cap = int(history)
        self._lock = threading.Lock()   # serializes writers only
        self.publishes = 0

    def publish(self, snap: GraphSnapshot, *, params: Any = None,
                t_max: float = 0.0, n_events: int = 0) -> SnapshotHandle:
        """Sync the copy-on-write mirror to ``snap`` and install a new
        handle.  The old handle (and every handle in history) remains
        fully readable."""
        with self._lock:
            dev = self._mirror.sync(snap)
            prev = self._current
            if params is None and prev is not None:
                params = prev.params
            h = SnapshotHandle(
                version=int(snap.version), dev=dev, params=params,
                t_max=float(t_max), n_events=int(n_events),
                scan_pages=self.scan_pages)
            self._install(h)
            self.publishes += 1
            return h

    def set_params(self, params: Any) -> Optional[SnapshotHandle]:
        """Swap in fresh model params without a snapshot change."""
        with self._lock:
            cur = self._current
            if cur is None:
                return None
            h = dataclasses.replace(cur, params=params)
            self._install(h)
            return h

    def _install(self, h: SnapshotHandle) -> None:
        self._history[h.version] = h          # newest wins per version
        self._history.move_to_end(h.version)
        while len(self._history) > self._hist_cap:
            self._history.popitem(last=False)
        self._current = h                     # atomic swap (GIL)

    def current(self) -> Optional[SnapshotHandle]:
        """The newest handle — ONE read per query batch at admission."""
        return self._current

    def get(self, version: int) -> Optional[SnapshotHandle]:
        """A retained historical handle (parity checks), else None."""
        return self._history.get(int(version))

    def versions(self) -> list:
        """Retained versions, oldest first."""
        return list(self._history.keys())
