"""EdgeBank: non-parametric link predictor from a recency table.

EdgeBank (Poursafaei et al., "Towards Better Evaluation for Dynamic
Link Prediction", NeurIPS 2022; openDG ships the reference
implementation) predicts an edge positive iff it has been seen before —
optionally only within a trailing time window.  Despite having no
parameters it is a strong dynamic-link-prediction baseline, and here it
serves a second purpose: an ALWAYS-FRESH fallback tier.  The table is
updated synchronously in the ingest thread (``on_publish``), so when
the GNN admission queue saturates, link queries still get an answer in
microseconds that reflects every event ingested so far — graceful
degradation instead of unbounded queueing.

Thread safety: one mutex around the dict.  Updates touch O(batch)
keys; predictions are O(pairs) lookups — both far off the device hot
path.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np


class EdgeBank:
    """(src, dst) -> (last seen ts, occurrence count) recency table.

    ``window <= 0`` is "unlimited": seen once, positive forever
    (EdgeBank-inf).  ``window > 0`` is the time-window variant
    (EdgeBank-tw): positive only if last seen within ``window`` of the
    query time.
    """

    def __init__(self, *, window: float = 0.0, undirected: bool = True):
        self.window = float(window)
        self.undirected = undirected
        self._tab: Dict[Tuple[int, int], Tuple[float, int]] = {}
        self._lock = threading.Lock()
        self.version = 0         # bumps once per update() batch
        self.t_max = -np.inf

    def _key(self, u: int, v: int) -> Tuple[int, int]:
        if self.undirected and v < u:
            return (v, u)
        return (u, v)

    def update(self, src, dst, ts) -> None:
        """Fold one ingested event batch into the table."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        ts = np.asarray(ts, np.float64)
        with self._lock:
            tab = self._tab
            for u, v, t in zip(src, dst, ts):
                k = self._key(int(u), int(v))
                old = tab.get(k)
                if old is None:
                    tab[k] = (float(t), 1)
                else:
                    tab[k] = (max(old[0], float(t)), old[1] + 1)
            if len(ts):
                self.t_max = max(self.t_max, float(ts.max()))
            self.version += 1

    def predict(self, src, dst, ts=None) -> np.ndarray:
        """Score each (src[i], dst[i]) pair at query time ts[i]:
        1.0 if the edge is in the bank (and within the window), else
        0.0.  ``ts=None`` evaluates the window against the bank's
        newest timestamp."""
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        if ts is None:
            ts_arr = np.full(len(src), self.t_max, np.float64)
        else:
            ts_arr = np.asarray(ts, np.float64).ravel()
        out = np.zeros(len(src), np.float32)
        with self._lock:
            tab = self._tab
            for i, (u, v, t) in enumerate(zip(src, dst, ts_arr)):
                hit = tab.get(self._key(int(u), int(v)))
                if hit is None:
                    continue
                if self.window > 0 and hit[0] < t - self.window:
                    continue
                out[i] = 1.0
        return out

    def counts(self, src, dst) -> np.ndarray:
        """Occurrence count per pair (frequency signal, used by tests
        and as a tie-break feature)."""
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        out = np.zeros(len(src), np.int64)
        with self._lock:
            for i, (u, v) in enumerate(zip(src, dst)):
                hit = self._tab.get(self._key(int(u), int(v)))
                if hit is not None:
                    out[i] = hit[1]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._tab)
