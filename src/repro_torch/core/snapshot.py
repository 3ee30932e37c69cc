"""Device-facing paged snapshot of the dynamic graph (DESIGN.md §2).

The paper places graph *metadata* (node table + block descriptors) on the
GPU and leaves bulky edge data in host memory. The TPU/JAX analog: export
the block structure as fixed-width *page tables* — for each node, the ids
of its blocks (pages), newest first — plus the block descriptor arrays and
the flat arena. All arrays are dense and static-shaped, so both the
vectorized-jnp sampler and the Pallas kernel consume them directly.

The snapshot is incremental: pages are immutable once full, so a snapshot
refresh only appends/overwrites descriptor rows and the arena suffix that
changed since the last refresh (mirroring the paper's "update without
rebuild" property; see bench_graph_update.py).

Each refresh additionally records a ``SnapshotDelta`` — the exact set of
page rows / page-table rows that changed plus a monotonically increasing
version — so device-side consumers (``TemporalSampler``) can mirror the
refresh with in-place scatter updates instead of re-uploading the whole
snapshot (the delta-upload protocol; README "Sampling pipeline").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.dgraph import NULL, DynamicGraph

_EMPTY = np.empty(0, np.int64)


@dataclasses.dataclass
class SnapshotDelta:
    """What changed between snapshot ``base_version`` and ``version``.

    Row indices are into the snapshot's *capacity* arrays (valid whether
    or not the arrays were reallocated; consumers compare shapes to
    detect reallocation and fall back to a full upload per array).
    ``full`` marks refreshes where the whole snapshot was rebuilt (e.g.
    the tau-change fallback) and the row lists are meaningless.
    """
    base_version: int
    version: int
    full: bool = False
    page_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY)   # pages whose fill/desc changed
    table_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY)   # nodes whose page chain changed
    valid_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY)   # pages whose validity changed
    # appended arena cells: pages are append-only, so the minimal edge-
    # data delta is the (page, lane) pairs filled since the last refresh
    cell_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY)
    cell_lanes: np.ndarray = dataclasses.field(
        default_factory=lambda: _EMPTY)


@dataclasses.dataclass
class GraphSnapshot:
    """Struct-of-arrays paged view. All int32/float32 (device-friendly)."""
    # per node: page ids, NEWEST FIRST, padded with -1
    page_table: np.ndarray        # (N, max_pages) int32
    node_npages: np.ndarray       # (N,) int32
    node_degree: np.ndarray       # (N,) int32
    # per page (block): descriptors
    page_size: np.ndarray         # (P,) int32  — filled entries
    page_tmin: np.ndarray         # (P,) float32
    page_tmax: np.ndarray         # (P,) float32
    page_start: np.ndarray        # (P,) int32  — arena offset
    page_cap: int                 # uniform padded page width for kernels
    # arena (padded per page to page_cap for the kernel path); arrays may
    # hold spare capacity rows beyond n_pages (never referenced by the
    # page table, so harmless to samplers); the node dimension grows
    # geometrically too, so node rows in [n_live, capacity) are empty
    nbr: np.ndarray               # (P, page_cap) int32
    eid: np.ndarray               # (P, page_cap) int32
    ts: np.ndarray                # (P, page_cap) float32  (+inf padding)
    valid: np.ndarray             # (P, page_cap) bool
    n_pages: int = 0
    n_live: int = 0               # live node rows (<= page_table.shape[0])
    version: int = 0              # bumped by every refresh_snapshot
    delta: Optional[SnapshotDelta] = None   # of the most recent refresh

    @property
    def num_nodes(self) -> int:
        return self.n_live

    @property
    def num_pages(self) -> int:
        return self.n_pages

    def metadata_bytes(self) -> int:
        return (self.page_table.nbytes + self.node_npages.nbytes
                + self.node_degree.nbytes + self.page_size.nbytes
                + self.page_tmin.nbytes + self.page_tmax.nbytes
                + self.page_start.nbytes)

    def edge_data_bytes(self) -> int:
        return (self.nbr.nbytes + self.eid.nbytes + self.ts.nbytes
                + self.valid.nbytes)


def build_snapshot(g: DynamicGraph, *, page_cap: Optional[int] = None
                   ) -> GraphSnapshot:
    # always at least one (empty) node/page row: samplers gather rows by
    # clipped index, which requires non-zero extents
    n = max(g.n_nodes, 1)
    nb = g.n_blocks
    if page_cap is None:
        page_cap = int(g.blk_cap[:nb].max()) if nb else 1
        # round up to a TPU-lane-friendly width
        page_cap = max(8, int(2 ** np.ceil(np.log2(max(page_cap, 1)))))

    max_pages = int(g.nblocks[:n].max()) if n else 1
    max_pages = max(max_pages, 1)

    # --- page tables, fully vectorized ---
    # blocks are allocated in chronological order per node, so sorting by
    # (node, block id) yields each node's chain oldest->newest
    page_table = np.full((n, max_pages), NULL, np.int32)
    node_npages = g.nblocks[:n].astype(np.int32)
    if nb:
        bids = np.arange(nb, dtype=np.int64)
        nodes = g.blk_node[:nb]
        order = np.lexsort((bids, nodes))
        sorted_nodes = nodes[order]
        first_occ = np.searchsorted(sorted_nodes, np.arange(n))
        pos_within = np.arange(nb) - first_occ[sorted_nodes]
        col = node_npages[sorted_nodes] - 1 - pos_within  # newest first
        page_table[sorted_nodes, col] = order.astype(np.int32)

    nb_rows = max(nb, 1)   # keep one (empty) page row for clipped gathers
    sizes = np.zeros(nb_rows, np.int32)
    sizes[:nb] = g.blk_size[:nb]
    starts = np.zeros(nb_rows, np.int64)
    starts[:nb] = g.blk_start[:nb]
    offl = np.zeros(nb_rows, bool)
    offl[:nb] = g.blk_offloaded[:nb]

    # --- padded per-page arena views, vectorized gather ---
    lane = np.arange(page_cap)
    idx = starts[:, None] + lane[None, :]
    fill = (lane[None, :] < np.minimum(sizes, page_cap)[:, None]) \
        & ~offl[:, None]
    idx_c = np.clip(idx, 0, max(g.arena_used - 1, 0))
    arena_nbr = g.nbr if g.arena_used else np.zeros(1, np.int64)
    arena_eid = g.eid if g.arena_used else np.zeros(1, np.int64)
    arena_ts = g.ts if g.arena_used else np.zeros(1, np.float64)
    arena_val = g.valid if g.arena_used else np.zeros(1, bool)
    nbr = np.where(fill, arena_nbr[idx_c], NULL).astype(np.int32)
    eid = np.where(fill, arena_eid[idx_c], NULL).astype(np.int32)
    ts = np.where(fill, arena_ts[idx_c], np.inf).astype(np.float32)
    valid = fill & arena_val[idx_c]

    tmin = np.full(nb_rows, np.inf, np.float32)
    tmin[:nb] = g.blk_tmin[:nb]
    tmax = np.full(nb_rows, -np.inf, np.float32)
    tmax[:nb] = g.blk_tmax[:nb]
    degree = np.zeros(n, np.int32)
    degree[:g.n_nodes] = g.degree[:g.n_nodes]
    return GraphSnapshot(
        page_table=page_table,
        node_npages=node_npages,
        node_degree=degree,
        page_size=sizes,
        page_tmin=tmin,
        page_tmax=tmax,
        page_start=starts.astype(np.int32),
        page_cap=int(page_cap),
        nbr=nbr, eid=eid, ts=ts, valid=valid, n_pages=nb, n_live=n,
    )


def _rebuild_page_table(g: DynamicGraph, n: int, nb: int):
    max_pages = max(int(g.nblocks[:n].max()) if n else 1, 1)
    page_table = np.full((n, max_pages), NULL, np.int32)
    npages = g.nblocks[:n].astype(np.int32)
    if nb:
        bids = np.arange(nb, dtype=np.int64)
        nodes = g.blk_node[:nb]
        order = np.lexsort((bids, nodes))
        sorted_nodes = nodes[order]
        first_occ = np.searchsorted(sorted_nodes, np.arange(n))
        pos_within = np.arange(nb) - first_occ[sorted_nodes]
        col = npages[sorted_nodes] - 1 - pos_within
        page_table[sorted_nodes, col] = order.astype(np.int32)
    return page_table, npages


def refresh_snapshot(g: DynamicGraph, snap: GraphSnapshot
                     ) -> GraphSnapshot:
    """Incremental refresh: gather only NEW pages and re-copy pages whose
    fill changed; the (small) page table / descriptor arrays are rebuilt
    vectorized. Edge data of untouched pages is never re-read — the
    paper's 'update without rebuild' property.

    Sets ``snap.delta`` to the SnapshotDelta of this refresh and bumps
    ``snap.version`` so device mirrors can apply the same delta."""
    n, nb = g.n_nodes, g.n_blocks
    base_version = snap.version
    if nb and int(g.blk_cap[:nb].max()) > snap.page_cap:
        new = build_snapshot(g, page_cap=None)   # rare: tau changed
        new.version = base_version + 1
        new.delta = SnapshotDelta(base_version, new.version, full=True)
        return new

    old_nb = snap.num_pages
    # changed old pages (tail blocks that gained edges)
    changed = np.nonzero(g.blk_size[:old_nb].astype(np.int32)
                         != snap.page_size[:old_nb])[0]
    # grow page-row capacity before any write (pad = empty-page values,
    # so untouched lanes of future pages are already correct)
    if nb > len(snap.page_size):
        cap_rows = len(snap.page_size)
        grow = max(int(cap_rows * 1.5), nb) - cap_rows
        pad2 = lambda a, fill: np.concatenate(
            [a, np.full((grow,) + a.shape[1:], fill, a.dtype)])
        snap.nbr = pad2(snap.nbr, NULL)
        snap.eid = pad2(snap.eid, NULL)
        snap.ts = pad2(snap.ts, np.inf)
        snap.valid = pad2(snap.valid, False)
        snap.page_size = pad2(snap.page_size, 0)
        snap.page_tmin = pad2(snap.page_tmin, np.inf)
        snap.page_tmax = pad2(snap.page_tmax, -np.inf)
        snap.page_start = pad2(snap.page_start, 0)
    page_rows = (np.concatenate([changed, np.arange(old_nb, nb)])
                 if nb > old_nb else changed)
    # pages are append-only: the minimal edge-data update is the lanes
    # appended since the last refresh — (page, lane) cells, not rows
    cell_rows = cell_lanes = _EMPTY
    if len(page_rows):
        lane_lo = np.where(page_rows < old_nb,
                           snap.page_size[page_rows], 0).astype(np.int64)
        lane_hi = np.minimum(g.blk_size[page_rows],
                             snap.page_cap).astype(np.int64)
        counts = np.maximum(lane_hi - lane_lo, 0)
        cell_rows = np.repeat(page_rows, counts)
        seg0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
        cell_lanes = (np.arange(counts.sum())
                      - np.repeat(seg0 - lane_lo, counts))
        pos = g.blk_start[cell_rows] + cell_lanes
        snap.nbr[cell_rows, cell_lanes] = g.nbr[pos]
        snap.eid[cell_rows, cell_lanes] = g.eid[pos]
        snap.ts[cell_rows, cell_lanes] = g.ts[pos]
        snap.valid[cell_rows, cell_lanes] = g.valid[pos]
        snap.page_size[page_rows] = lane_hi
        snap.page_tmin[page_rows] = g.blk_tmin[page_rows]
        snap.page_tmax[page_rows] = g.blk_tmax[page_rows]
        if nb > old_nb:
            new_ids = np.arange(old_nb, nb)
            snap.page_start[new_ids] = g.blk_start[new_ids]
    snap.n_pages = nb
    # node-level tables: delta update (only nodes whose chains changed)
    old_n = snap.n_live
    width = snap.page_table.shape[1]
    need_width = max(int(g.nblocks[:n].max()) if n else 1, 1)
    if need_width > width:
        snap.page_table = np.concatenate(
            [snap.page_table,
             np.full((snap.page_table.shape[0],
                      max(need_width, int(width * 1.5)) - width),
                     NULL, np.int32)], axis=1)
        width = snap.page_table.shape[1]
    cap_n = snap.page_table.shape[0]
    if n > cap_n:
        grow_n = max(int(cap_n * 1.5), n) - cap_n
        snap.page_table = np.concatenate(
            [snap.page_table,
             np.full((grow_n, width), NULL, np.int32)])
        snap.node_npages = np.concatenate(
            [snap.node_npages, np.zeros(grow_n, np.int32)])
        snap.node_degree = np.concatenate(
            [snap.node_degree, np.zeros(grow_n, np.int32)])
    dirty = np.nonzero(g.nblocks[:old_n].astype(np.int32)
                       != snap.node_npages[:old_n])[0]
    if n > old_n:
        dirty = np.concatenate([dirty, np.arange(old_n, n)])
    if len(dirty):
        dset = np.zeros(n, bool)
        dset[dirty] = True
        blk_sel = np.nonzero(dset[g.blk_node[:nb]])[0]
        nodes = g.blk_node[blk_sel]
        order = np.lexsort((blk_sel, nodes))
        sorted_nodes = nodes[order]
        uniq, first = np.unique(sorted_nodes, return_index=True)
        pos_within = np.arange(len(blk_sel)) - first[
            np.searchsorted(uniq, sorted_nodes)]
        npg = g.nblocks[sorted_nodes]
        col = (npg - 1 - pos_within).astype(np.int64)
        snap.page_table[dirty] = NULL
        snap.page_table[sorted_nodes, col] = blk_sel[order].astype(
            np.int32)
        snap.node_npages[:n] = g.nblocks[:n].astype(np.int32)
    snap.node_degree[:n] = g.degree[:n].astype(np.int32)
    snap.n_live = n
    # deletions flip validity without resizing: recopy validity lanes for
    # all live pages — only when a deletion actually happened since the
    # last snapshot (a full-arena pass would otherwise dominate refresh)
    valid_rows = _EMPTY
    if getattr(g, "_deleted_since_snapshot", False):
        lane = np.arange(snap.page_cap)
        starts = g.blk_start[:nb][:, None] + lane[None, :]
        fill = (lane[None, :] < np.minimum(g.blk_size[:nb],
                                           snap.page_cap)[:, None]) \
            & ~g.blk_offloaded[:nb, None]
        idx_c = np.clip(starts, 0, max(g.arena_used - 1, 0))
        new_valid = fill & g.valid[idx_c]
        valid_rows = np.nonzero(
            (new_valid != snap.valid[:nb]).any(axis=1))[0]
        snap.valid[:nb] = new_valid
        g._deleted_since_snapshot = False
    snap.version = base_version + 1
    snap.delta = SnapshotDelta(
        base_version, snap.version, full=False, page_rows=page_rows,
        table_rows=dirty, valid_rows=valid_rows,
        cell_rows=cell_rows, cell_lanes=cell_lanes)
    return snap
