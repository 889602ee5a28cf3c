"""IVF: the k-means coarse quantizer, the plain IVF engine and the
inverted lists of the IVF-PQ engine (port of ``repro.core.ivf``).

``kmeans`` and ``assign_clusters`` score rows against centroids in row
chunks: the reference builds the whole (N, C) score matrix, which at
8.8M rows and 2973 clusters would be 105 GB. ``build_buckets`` and the
layout construction are vectorized where the reference loops per row in
Python. Everything runs on the device of its inputs.

``IVFIndex`` (the paper's first HNSW adaptation) probes the nprobe
nearest centroids and scores their buckets' rows exactly. Its bucket
table and row positions are device tensors, and its writes are batched
device operations with the reference's slot order. ``ivf_search`` does
not gather the (Q, nprobe x cap) padded candidates the reference does:
it drops pad and tombstone slots first (in order, so ties still go to
the lower position) and gathers a chunk of queries at a time under
``GATHER_BYTES``.

Sums in k-means go through ``index_add_``, which on the card adds with
atomics in no fixed order, so trained centroids can differ in the last
bits from run to run. Training is held to recall, not to bits.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch

from repro_torch import trace
from repro_torch.core import distances as D
from repro_torch.core.mutable import (GrowableRows, MutationMixin, as_ids,
                                      row_capacity)
from repro_torch.device import resolve_device, strict_fp32

SCORE_BUDGET = 1 << 28  # score-matrix entries a chunk may hold (1 GiB f32)
GATHER_BYTES = 1 << 30  # float32 candidate rows a query chunk may gather


def row_chunk(n_cols: int) -> int:
    """Rows a chunk takes so that its (rows, n_cols) scores fit
    SCORE_BUDGET."""
    return max(1, SCORE_BUDGET // max(1, n_cols))


@strict_fp32()
def assign_clusters(x, centroids):
    """x: (N, d) rows (a tensor, or ``pq.ResidualRows``) -> (N,) int64
    index of the nearest centroid (L2). argmax over
    2 x.c - |c|^2, |x|^2 being constant per row; ties to the lower index."""
    N = x.shape[0]
    chunk = row_chunk(centroids.shape[0])
    c_sq = torch.sum(torch.square(centroids), dim=-1)
    out = torch.empty(N, dtype=torch.int64, device=centroids.device)
    for a in range(0, N, chunk):
        xc = x[a:a + chunk]
        out[a:a + chunk] = torch.argmax(2.0 * (xc @ centroids.T) - c_sq, dim=-1)
    return out


@strict_fp32()
def kmeans(x, *, n_clusters: int, iters: int = 10, generator=None):
    """Lloyd k-means (L2). x: (N, d) rows -> centroids (n_clusters, d).
    Initial centroids are distinct rows drawn with ``generator``; an empty
    cluster keeps its old centroid."""
    N = x.shape[0]
    gen_dev = generator.device if generator is not None else x.device
    init = torch.randperm(N, generator=generator, device=gen_dev)[:n_clusters]
    cent = x[init.to(x.device)].float()
    chunk = row_chunk(n_clusters)
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        cnts = torch.zeros(n_clusters, dtype=torch.float32, device=cent.device)
        c_sq = torch.sum(torch.square(cent), dim=-1)
        for a in range(0, N, chunk):
            xc = x[a:a + chunk]
            assign = torch.argmax(2.0 * (xc @ cent.T) - c_sq, dim=-1)
            sums.index_add_(0, assign, xc)
            cnts.index_add_(0, assign, torch.ones_like(assign, dtype=torch.float32))
        new = sums / torch.clamp(cnts, min=1.0)[:, None]
        cent = torch.where((cnts > 0)[:, None], new, cent)
    return cent


def build_buckets(assign, n_clusters: int, ids=None):
    """Inverted lists: assign (N,) -> (buckets (C, cap) int32, cap), rows
    of a cluster in id order, pad slots -1. ``ids`` names the row id each
    assignment entry stands for (defaults to position)."""
    assign = torch.as_tensor(assign).long()
    dev = assign.device
    N = assign.shape[0]
    ids = (torch.arange(N, device=dev) if ids is None
           else torch.as_tensor(ids, device=dev).long())
    counts = torch.bincount(assign, minlength=n_clusters)
    cap = max(1, int(counts.max())) if N else 1
    order = torch.sort(assign, stable=True).indices
    first = torch.cumsum(counts, 0) - counts
    a_sorted = assign[order]
    rank = torch.arange(N, device=dev) - first[a_sorted]
    buckets = torch.full((n_clusters, cap), -1, dtype=torch.int32, device=dev)
    buckets[a_sorted, rank] = ids[order].to(torch.int32)
    return buckets, cap


def assign_from_buckets(buckets, n_rows: int):
    """(C, cap) bucket table -> (n_rows,) cluster assignment; rows absent
    from the table (tombstoned ids) read 0."""
    b = torch.as_tensor(buckets)
    assign = torch.zeros(n_rows, dtype=torch.int32, device=b.device)
    rows = torch.arange(b.shape[0], dtype=torch.int32,
                        device=b.device)[:, None].expand(b.shape)
    sel = b >= 0
    assign[b[sel].long()] = rows[sel]
    return assign


def _block_ranges(counts, blk: int):
    """Per cluster: blocks owned (ceil(count / blk)) and the first of them
    when clusters take contiguous rows in cluster order."""
    bcnt = -torch.div(-counts, blk, rounding_mode="floor")
    bstart = torch.cumsum(bcnt, 0) - bcnt
    return bstart, bcnt


def build_block_lists(assign, n_clusters: int, blk: int = 32):
    """Block-aligned inverted lists for the bucket-resident kernel.

    assign (N,) -> (slot_rows (B+1, blk) int32, bstart (C,) int32,
    bcnt (C,) int32, steps_per_probe int). Cluster c owns the
    ``bcnt[c] = ceil(count_c / blk)`` contiguous rows starting at
    ``bstart[c]``; its last row is padded with -1 ids, and row B is a
    shared all-pad block. ``steps_per_probe`` = the most rows any cluster
    owns (>= 1).
    """
    if blk % 8:
        raise ValueError(f"block size {blk} is not a multiple of 8")
    assign = torch.as_tensor(assign).long()
    dev = assign.device
    N = assign.shape[0]
    counts = torch.bincount(assign, minlength=n_clusters)
    bstart, bcnt = _block_ranges(counts, blk)
    spp = max(1, int(bcnt.max())) if n_clusters else 1
    B = int(bcnt.sum())
    order = torch.sort(assign, stable=True).indices
    a_sorted = assign[order]
    rank = torch.arange(N, device=dev) - (torch.cumsum(counts, 0) - counts)[a_sorted]
    slots = torch.full(((B + 1) * blk,), -1, dtype=torch.int32, device=dev)
    slots[bstart[a_sorted] * blk + rank] = order.to(torch.int32)
    return (slots.reshape(B + 1, blk), bstart.to(torch.int32),
            bcnt.to(torch.int32), spp)


def visit_sharing(visit, *, pad_block=None) -> dict:
    """Cheap sharing probe: ``{pairs, blocks, sharing}`` of a visit table
    without building the segmented schedule, one ``torch.unique`` over the
    (Q*T,) block ids on the table's device. ``ops.ivf_adc_topk``'s auto
    dispatch reads this where the grouped grids' board fits, and builds
    the schedule only when a grouped grid will use it. The mask and the
    ``unique`` are a host sync each
    (``kernels.visit_sharing.visit_sharing_device`` counts with none)."""
    v = torch.as_tensor(visit).reshape(-1)
    if trace.ON:
        trace.count("host_syncs", 1 + (pad_block is not None))
    if pad_block is not None:
        v = v[v != pad_block]
    pairs = int(v.numel())
    blocks = int(torch.unique(v).numel())
    return {"pairs": pairs, "blocks": blocks,
            "sharing": float(pairs) / max(1, blocks)}


def _quarter_octave(n: int) -> int:
    """Next multiple of 2^e with 2^e about n / 8 (8 at least): a pad ladder
    with O(log n) rungs that wastes at most about 25 %."""
    if n <= 8:
        return 8
    e = (n - 1).bit_length() - 3
    return -(-n >> e) << e


def build_block_schedule(visit, *, qblk: int = 8, pad_block=None):
    """Segmented schedule for the grouped IVF-ADC grids, built on the visit
    table's device.

    The (query, step) pairs of the (Q, T) visit table are sorted by block
    id (stably, so a block's pairs stay in visit order) and each block's
    run is cut into groups of ``qblk`` pairs, so that one program can read
    the block once for up to qblk queries. Partial groups pad with the
    sentinel query -1. Pairs that visit ``pad_block`` (the shared all-pad
    block) are dropped: every slot there is -1. The group count G and the
    run count R pad up the quarter-octave ladder, with sentinel groups and
    empty runs pointing at ``pad_block`` (or 0).

    Returns ``(sched_block (G,), sched_q (G, qblk), sched_t (G, qblk),
    stats)`` int32 tensors, the reference's arrays exactly
    (``repro/core/ivf.py`` ``build_block_schedule``); ``stats`` holds
    ``pairs``, ``blocks``, ``sharing``, ``groups`` (before the pad),
    ``runs`` = (run_block (R,), run_start (R,), run_len (R,)) with
    run r covering groups [run_start[r], run_start[r] + run_len[r]),
    ``grun`` (G,) group -> run (sentinel groups -> the first pad run), and
    ``n_runs``. The pair, group and run counts, which fix G and R, are the
    one host sync.
    """
    if qblk < 1:
        raise ValueError(f"qblk must be >= 1, got {qblk}")
    visit = torch.as_tensor(visit)
    dev = visit.device
    Q, T = visit.shape
    fill = 0 if pad_block is None else int(pad_block)
    key = visit.reshape(-1).long()
    last = torch.iinfo(torch.int64).max
    if pad_block is not None:  # pad pairs sort after every real one
        key = torch.where(key == pad_block, last, key)
    key, order = torch.sort(key, stable=True)
    n = key.numel()
    real = key != last
    pos = torch.arange(n, device=dev)
    new_run = real.clone()
    new_run[1:] &= key[1:] != key[:-1]
    run_of = (torch.cumsum(new_run, 0) - 1).clamp(min=0)
    rank = pos - torch.cummax(torch.where(new_run, pos, 0), 0).values
    run_len = torch.zeros(n, dtype=torch.int64, device=dev).scatter_add_(
        0, run_of, real.long())
    groups_per_run = -torch.div(-run_len, qblk, rounding_mode="floor")
    gbase = torch.cumsum(groups_per_run, 0) - groups_per_run
    gid = gbase[run_of] + torch.div(rank, qblk, rounding_mode="floor")
    if trace.ON:
        trace.count("host_syncs")
    P, n_groups, n_runs = (int(x) for x in torch.stack(
        [real.sum(), groups_per_run.sum(), new_run.sum()]).tolist())

    G = _quarter_octave(max(1, n_groups))
    i32 = dict(dtype=torch.int32, device=dev)
    sched_block = torch.full((G,), fill, **i32)
    sched_q = torch.full((G, qblk), -1, **i32)
    sched_t = torch.zeros((G, qblk), **i32)
    R = _quarter_octave(n_runs + 1)   # at least one empty pad run
    run_block = torch.full((R,), fill, **i32)
    run_start = torch.full((R,), n_groups, **i32)
    run_lens = torch.zeros((R,), **i32)
    grun = torch.full((G,), n_runs, **i32)
    if P:
        g, s = gid[:P], rank[:P] % qblk
        b = key[:P].to(torch.int32)
        sched_block[g] = b
        sched_q[g, s] = torch.div(order[:P], T, rounding_mode="floor").to(torch.int32)
        sched_t[g, s] = (order[:P] % T).to(torch.int32)
        run_block[run_of[:P]] = b
        run_start[:n_runs] = gbase[:n_runs].to(torch.int32)
        run_lens[:n_runs] = groups_per_run[:n_runs].to(torch.int32)
        grun[g] = run_of[:P].to(torch.int32)
    stats = {"pairs": P, "blocks": n_runs,
             "sharing": float(P) / max(1, n_runs), "groups": n_groups,
             "runs": (run_block, run_start, run_lens), "grun": grun,
             "n_runs": n_runs}
    return sched_block, sched_q, sched_t, stats


class ScheduleCache:
    """Content-checked LRU of built block schedules (port of the
    reference's ``ScheduleCache``).

    The plan ledger (``core.db._PlanLedger``) owns one, keyed by
    ``(plan bucket, plan generation, nprobe)`` plus the dispatcher's
    ``(qblk, pad_block, Q, T)``. A hit also checks that the visit table
    equals the cached one (``torch.equal`` on the device, a host sync), so
    a changed batch or a mutated index misses and rebuilds instead of
    reading a stale schedule. Entries hold the device tensors.
    """

    def __init__(self, cap: int = 8):
        self.cap = int(cap)
        self._entries = OrderedDict()
        self.stats = {"hits": 0, "misses": 0}

    def get(self, key, visit):
        ent = self._entries.get(key)
        if (ent is not None and ent[0].shape == visit.shape
                and ent[0].device == visit.device):
            if trace.ON:
                trace.count("host_syncs")
            if torch.equal(ent[0], visit):
                self._entries.move_to_end(key)
                self.stats["hits"] += 1
                return ent[1]
        self.stats["misses"] += 1
        return None

    def put(self, key, visit, built) -> None:
        self._entries[key] = (visit, built)
        self._entries.move_to_end(key)
        while len(self._entries) > self.cap:
            self._entries.popitem(last=False)


class BlockListLayout:
    """Block-aligned inverted lists on the device, appendable and
    tombstone-aware (port of the reference's ``BlockListLayout``).

    Storage is a (capacity, blk) slot table with a co-located
    (capacity, blk, m) uint8 code payload. Row ``capacity - 1`` is the
    shared all-pad block; ``block_table[c]`` lists the storage rows cluster
    c owns, in visit order, padded with -1 to the static ``steps_per_probe``
    width, which is a power of two. Capacities are power-of-two buckets
    (``mutable.row_capacity``), as in the reference, so that a layout built
    or mutated here and one there have the same arrays.

    Invariants, the reference's: appends fill the cluster's last block
    (``tail_fill`` slots of it used) before a new block is taken; a delete
    writes -1 into the slot, exactly the pad sentinel every ADC grid knocks
    out, and leaves its codes; ``compact`` repacks the live slots into
    fresh dense blocks and keeps the capacities.

    ``pos`` maps a row id to its flat slot (row * blk + slot), -1 for an
    id the layout does not hold; the reference keeps a dict for that. It
    grows with the id space, explicit ids beyond it included.

    Free rows: the reference keeps a set and takes its lowest row for each
    new block. In a single-host layout that set is always the one range
    [next_free, capacity - 2]: load takes rows 0..B-1, a new block takes
    the lowest free row, growth frees the old pad row (next in line), and
    only compact frees blocks, all of them. So one integer stands for the
    set, and a batch's new blocks are rows next_free + arange(R): clusters
    in ascending order, each cluster's new blocks consecutive once its tail
    block is full. That makes every write a few batched device operations.

    The mesh front (``core.db.DistributedIVFPQ``) sets ``row_multiple`` to
    its shard count, so that capacities are
    ``row_multiple * row_capacity(ceil(n / row_multiple), 4)`` and storage
    rows slice into equal per-shard slabs. The reference's mesh front also
    steers each new block to the shard of its cluster's last block when
    that shard has a free row, else to the lowest free row. Under the
    invariant above (every used row lies below ``next_free``) that shard
    has a free row only if it holds ``next_free``, so its pick is always
    the lowest free row, the fast path's.
    """

    def __init__(self, n_clusters: int, blk: int = 32, m: int = 0,
                 device=None, row_multiple: int = 1):
        if blk % 8:
            raise ValueError(f"block size {blk} is not a multiple of 8")
        self.C = int(n_clusters)
        self.blk = int(blk)
        self.m = int(m)
        self.row_multiple = int(row_multiple)
        self.spp_cap = 1
        cap = self._round_rows(2)
        i32 = dict(dtype=torch.int32, device=device)
        self.slots = torch.full((cap, blk), -1, **i32)
        self.codes = (torch.zeros((cap, blk, m), dtype=torch.uint8, device=device)
                      if m else None)
        self.block_cluster = torch.full((cap,), -1, **i32)
        self.block_table = torch.full((self.C, 1), -1, **i32)
        self.bcnt = torch.zeros(self.C, **i32)
        self.tail_fill = torch.zeros(self.C, **i32)
        self.pos = torch.full((0,), -1, dtype=torch.int64, device=device)
        self.next_free = 0  # free storage rows: [next_free, capacity - 2]
        self.live = 0
        self.tombstones = 0

    # ------------------------------------------------------------ build
    @classmethod
    def from_assign(cls, assign, n_clusters: int, *, blk: int = 32,
                    payload=None, ids=None, live=None, device=None,
                    row_multiple: int = 1) -> "BlockListLayout":
        """Build from a (N,) assignment (+ optional (N, m) payload codes).

        ``ids`` defaults to row numbers; ``live`` masks tombstoned ids out.
        Rows pack per cluster in stable id order, clusters take contiguous
        storage rows in cluster order: the layout ``build_block_lists``
        gives, and the one the reference's ``from_assign`` builds.
        """
        assign = torch.as_tensor(assign, device=device).long()
        dev = assign.device
        N = assign.shape[0]
        ids = (torch.arange(N, device=dev) if ids is None
               else torch.as_tensor(ids, device=dev).long())
        if live is not None:
            keep = torch.as_tensor(live, device=dev).bool()
            assign, ids = assign[keep], ids[keep]
            payload = None if payload is None else payload[keep]
        m = 0 if payload is None else payload.shape[1]
        lay = cls(n_clusters, blk=blk, m=m, device=dev,
                  row_multiple=row_multiple)
        lay.pos = torch.full((N,), -1, dtype=torch.int64, device=dev)
        counts = torch.bincount(assign, minlength=n_clusters)
        lay._reserve_rows(int(_block_ranges(counts, blk)[1].sum()) + 2)
        lay._bulk_append(assign, ids, payload)
        return lay

    @classmethod
    def from_arrays(cls, arrays, *, device=None,
                    row_multiple: int = 1) -> "BlockListLayout":
        """A layout from its arrays, as they stand (no repacking): ``slots``,
        ``codes`` (optional), ``block_cluster``, ``block_table``, ``bcnt``,
        ``tail_fill``, ``pos`` (the flat slot of each id, -1 for none),
        ``free`` (the free storage rows, ascending) and ``tombstones``;
        ``core.convert`` gives them for a reference layout. The arrays are
        copied. The free rows must be the one range [n_blocks, capacity -
        1) the fast path keeps."""
        def t(key, dtype):  # a copy: the layout writes in place
            return torch.as_tensor(arrays[key]).to(device=device, dtype=dtype,
                                                   copy=True)

        slots = t("slots", torch.int32)
        blk = slots.shape[1]
        codes = arrays.get("codes")
        m = 0 if codes is None else int(codes.shape[2])
        table = t("block_table", torch.int32)
        lay = cls(table.shape[0], blk=blk, m=m, device=slots.device,
                  row_multiple=row_multiple)
        lay.slots = slots
        lay.codes = None if codes is None else t("codes", torch.uint8)
        lay.block_cluster = t("block_cluster", torch.int32)
        lay.block_table = table
        lay.spp_cap = table.shape[1]
        lay.bcnt = t("bcnt", torch.int32)
        lay.tail_fill = t("tail_fill", torch.int32)
        lay.pos = t("pos", torch.int64)
        free = torch.as_tensor(arrays["free"]).long().reshape(-1).cpu()
        n_blocks = lay.capacity - 1 - free.numel()
        if not torch.equal(free, torch.arange(n_blocks, lay.capacity - 1)):
            raise ValueError("free rows are not the one range [n_blocks, "
                             "capacity - 1)")
        lay.next_free = n_blocks
        lay.live = int((lay.pos >= 0).sum())
        lay.tombstones = int(arrays["tombstones"])
        return lay

    # -------------------------------------------------------- capacities
    @property
    def capacity(self) -> int:
        return self.slots.shape[0]

    @property
    def pad_row(self) -> int:
        return self.capacity - 1

    @property
    def steps_per_probe(self) -> int:
        return self.spp_cap

    @property
    def shape_key(self) -> tuple:
        return (self.capacity, self.spp_cap)

    @property
    def n_blocks(self) -> int:
        """Allocated blocks, the pad row not counted."""
        return self.next_free

    def _round_rows(self, n: int) -> int:
        per = -(-n // self.row_multiple)
        return self.row_multiple * row_capacity(per, minimum=4)

    def _reserve_rows(self, n: int) -> bool:
        """Grow storage to >= n rows (pad row included); True on growth.
        The old pad row becomes the first of the new free rows."""
        cap = self.capacity
        if n <= cap:
            return False
        new_cap = self._round_rows(n)
        dev = self.slots.device
        grown = torch.full((new_cap, self.blk), -1, dtype=torch.int32, device=dev)
        grown[: cap - 1] = self.slots[: cap - 1]
        self.slots = grown
        if self.codes is not None:
            gc = torch.zeros((new_cap, self.blk, self.m), dtype=torch.uint8,
                             device=dev)
            gc[: cap - 1] = self.codes[: cap - 1]
            self.codes = gc
        bc = torch.full((new_cap,), -1, dtype=torch.int32, device=dev)
        bc[: cap - 1] = self.block_cluster[: cap - 1]
        self.block_cluster = bc
        return True

    def _grow_spp(self, most: int) -> None:
        """Double ``steps_per_probe`` until it holds ``most`` blocks."""
        cap = self.spp_cap
        while cap < max(1, most):
            cap *= 2
        if cap != self.spp_cap:
            table = torch.full((self.C, cap), -1, dtype=torch.int32,
                               device=self.block_table.device)
            table[:, : self.spp_cap] = self.block_table
            self.block_table = table
            self.spp_cap = cap

    def _ensure_pos(self, n_ids: int) -> None:
        """Grow the id -> slot map to hold ids < n_ids."""
        have = self.pos.numel()
        if n_ids > have:
            grown = torch.full((max(n_ids, have + have // 8),), -1,
                               dtype=torch.int64, device=self.pos.device)
            grown[:have] = self.pos
            self.pos = grown

    def reserve(self, extra_rows: int, extra_blocks_per_cluster: int = 0):
        """Pre-size the capacity buckets for a planned ingest volume so that
        the insert stream stays inside one shape bucket."""
        blocks = -(-int(extra_rows) // self.blk) + self.C
        self._reserve_rows(self.n_blocks + blocks + 2)
        most = int(self.bcnt.max()) if self.C else 0
        self._grow_spp(most + int(extra_blocks_per_cluster))

    # --------------------------------------------------------- mutation
    def _bulk_append(self, clusters, ids, payload=None) -> None:
        """Append rows to an empty layout (load and compact): each cluster's
        rows, in the given order, fill fresh contiguous blocks from row 0,
        clusters in cluster order, the last block of each padded with -1.
        The capacity must already hold them."""
        clusters = clusters.long()
        dev = self.slots.device
        n = clusters.shape[0]
        counts = torch.bincount(clusters, minlength=self.C)
        bstart, bcnt = _block_ranges(counts, self.blk)
        total = int(bcnt.sum())
        order = torch.sort(clusters, stable=True).indices
        c_sorted = clusters[order]
        rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[c_sorted]
        flat = (bstart[c_sorted] + torch.div(rank, self.blk, rounding_mode="floor")) \
            * self.blk + rank % self.blk
        self.slots.view(-1)[flat] = ids[order].to(torch.int32)
        if payload is not None:
            self.codes.view(-1, self.m)[flat] = payload[order].to(torch.uint8)
        self.pos[ids[order]] = flat
        owner = torch.repeat_interleave(
            torch.arange(self.C, dtype=torch.int32, device=dev), bcnt,
            output_size=total)
        self.block_cluster[:total] = owner
        self._grow_spp(int(bcnt.max()) if self.C else 0)
        r = torch.arange(self.spp_cap, device=dev)[None, :]
        self.block_table = torch.where(r < bcnt[:, None], bstart[:, None] + r,
                                       -1).to(torch.int32)
        self.bcnt = bcnt.to(torch.int32)
        self.tail_fill = (counts - (bcnt - 1).clamp(min=0) * self.blk).to(torch.int32)
        self.next_free = total
        self.live += n

    def insert_rows(self, ids, clusters, payload=None) -> None:
        """Append rows, all at once: each fills its cluster's last block,
        then the cluster's fresh blocks (rows from ``next_free`` on, in
        cluster order), exactly where the reference's row-by-row appends
        put them. Capacity doubles while the new blocks do not fit, and
        ``steps_per_probe`` while a cluster owns more blocks than it."""
        ids = as_ids(ids, self.slots.device)
        n = ids.numel()
        if not n:
            return
        dev = ids.device
        blk = self.blk
        clusters = as_ids(clusters, dev)
        counts = torch.bincount(clusters, minlength=self.C)
        bcnt, fill = self.bcnt.long(), self.tail_fill.long()
        take = torch.minimum(torch.where(bcnt > 0, blk - fill, 0), counts)
        rest = counts - take
        nb = -torch.div(-rest, blk, rounding_mode="floor")
        R, most, top_id = torch.stack(
            [nb.sum(), (bcnt + nb).max(), ids.max()]).tolist()
        self._reserve_rows(self.next_free + R + 1)
        self._grow_spp(most)
        self._ensure_pos(top_id + 1)
        first_new = torch.cumsum(nb, 0) - nb       # (C,) offset among new rows
        order = torch.sort(clusters, stable=True).indices
        c_s = clusters[order]
        rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[c_s]
        tail_row = self.block_table[torch.arange(self.C, device=dev),
                                    (bcnt - 1).clamp(min=0)].long()
        in_tail = rank < take[c_s]
        extra = rank - take[c_s]
        row = torch.where(in_tail, tail_row[c_s],
                          self.next_free + first_new[c_s]
                          + torch.div(extra, blk, rounding_mode="floor"))
        flat = row * blk + torch.where(in_tail, fill[c_s] + rank, extra % blk)
        self.slots.view(-1)[flat] = ids[order].to(torch.int32)
        if payload is not None:
            self.codes.view(-1, self.m)[flat] = payload[order].to(torch.uint8)
        self.pos[ids[order]] = flat
        if R:
            new_c = torch.repeat_interleave(torch.arange(self.C, device=dev),
                                            nb, output_size=R)
            new_row = self.next_free + torch.arange(R, device=dev)
            step = bcnt[new_c] + (new_row - self.next_free - first_new[new_c])
            self.block_table[new_c, step] = new_row.to(torch.int32)
            self.block_cluster[new_row] = new_c.to(torch.int32)
        self.tail_fill = torch.where(nb > 0, rest - (nb - 1) * blk,
                                     fill + take).to(torch.int32)
        self.bcnt = (bcnt + nb).to(torch.int32)
        self.next_free += R
        self.live += n

    def delete_rows(self, ids) -> int:
        """Tombstone rows: each slot's id becomes the pad sentinel -1, so
        every grid scores it exactly like a pad slot. Returns the distinct
        live ids among ``ids`` (unknown and dead ids are ignored)."""
        ids = as_ids(ids, self.pos.device)
        ids = ids[(ids >= 0) & (ids < self.pos.numel())]
        ids = torch.unique(ids[self.pos[ids] >= 0])
        self.slots.view(-1)[self.pos[ids]] = -1
        self.pos[ids] = -1
        n = ids.numel()
        self.live -= n
        self.tombstones += n
        return n

    def contains(self, i: int) -> bool:
        i = int(i)
        return 0 <= i < self.pos.numel() and bool(self.pos[i] >= 0)

    @property
    def tombstone_fraction(self) -> float:
        return self.tombstones / max(self.live + self.tombstones, 1)

    def compact(self) -> dict:
        """Repack the live slots into dense blocks, dropping tombstones and
        restoring the <= blk - 1 tail slack, in one pass: the live slots in
        (cluster, visit position, slot) order, then the load path's bulk
        append. Capacities are kept, as in the reference."""
        dev = self.slots.device
        before, dropped = self.next_free, self.tombstones
        owned = (torch.arange(self.spp_cap, device=dev)[None, :]
                 < self.bcnt[:, None])
        rows = self.block_table[owned].long()              # cluster-major
        owner = torch.repeat_interleave(
            torch.arange(self.C, device=dev), self.bcnt.long(),
            output_size=before)
        sl = self.slots[rows].reshape(-1)
        keep = sl >= 0
        ids = sl[keep].long()
        clusters = torch.repeat_interleave(owner, self.blk)[keep]
        payload = (self.codes[rows].reshape(-1, self.m)[keep]
                   if self.codes is not None else None)
        self.slots.fill_(-1)
        if self.codes is not None:
            self.codes.zero_()
        self.block_cluster.fill_(-1)
        self.pos.fill_(-1)
        self.live = self.tombstones = 0
        self._bulk_append(clusters, ids, payload)
        return {"dropped_tombstones": int(dropped),
                "blocks_before": int(before), "blocks_after": self.n_blocks}

    # ------------------------------------------------------------ views
    def assign_of(self, n_rows: int):
        """(n_rows,) assignment over the id space (dead ids read 0)."""
        pos = self.pos[:n_rows]
        live = pos >= 0
        assign = torch.zeros(n_rows, dtype=torch.int32, device=pos.device)
        assign[live] = self.block_cluster[torch.div(pos[live], self.blk,
                                                    rounding_mode="floor")]
        return assign

    def live_mask(self, n_rows: int):
        return self.pos[:n_rows] >= 0

    def gather_payload(self, n_rows: int):
        """Row-major (n_rows, m) codes recovered from the slots (dead ids
        read 0), the reference's snapshot format."""
        pos = self.pos[:n_rows]
        live = pos >= 0
        out = torch.zeros((n_rows, self.m), dtype=torch.uint8, device=pos.device)
        out[live] = self.codes.view(-1, self.m)[pos[live]]
        return out

    def memory_bytes(self) -> int:
        total = self.slots.numel() * 4 + self.block_table.numel() * 4
        if self.codes is not None:
            total += self.codes.numel()
        return int(total)


# ------------------------------------------------------------ IVF engine
@strict_fp32()
def ivf_search(corpus, centroids, buckets, q, *, metric: str, k: int,
               nprobe: int, corpus_sq=None):
    """corpus: (N, d); centroids: (C, d); buckets: (C, cap) int32 ids (-1 =
    pad or tombstone); q: (Q, d) -> (scores (Q, k), ids (Q, k)), unfilled
    slots (-inf, -1).

    Probes the nprobe closest centroids and scores only their buckets'
    rows, in float32 (bf16 rows: products of the bf16 values summed in
    float32). Each query's live slots are packed to the front in probe and
    slot order before the gather, so ids and ties are the reference's,
    which scores every slot of the probed rows and knocks the pads out.
    Queries go in chunks whose gathered rows fit ``GATHER_BYTES``, taken
    in order of their live slot count.
    """
    Q = q.shape[0]
    C, cap = buckets.shape
    if metric == "cosine":
        q = D.l2_normalize(q)
        metric = "dot"
    c_scores = D.pairwise_scores(q, centroids,
                                 metric if metric == "dot" else "l2")
    probe = D.topk_scores(c_scores, nprobe)[1]                  # (Q, nprobe)
    width = nprobe * cap
    dev = q.device
    out_s = torch.full((Q, k), -torch.inf, dtype=torch.float32, device=dev)
    out_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    # queries in order of their live candidate count, so that a chunk pads
    # its rows to a count near its own (one host sync for the counts)
    per_q = (buckets >= 0).sum(1)[probe].sum(1)
    order = torch.sort(per_q, stable=True).indices
    counts = per_q[order].tolist()
    row_bytes = corpus.shape[1] * 4
    a = 0
    while a < Q:
        b = a + 1
        while b < Q and (b + 1 - a) * counts[b] * row_bytes <= GATHER_BYTES:
            b += 1
        L, sel, a = counts[b - 1], order[a:b], b
        if L == 0:
            continue
        qc = q[sel]
        n = qc.shape[0]
        cand = buckets[probe[sel]].reshape(n, width)
        ok = cand >= 0
        # live slots to the front, in order; the rest into a dropped column
        dest = torch.where(ok, torch.cumsum(ok, 1) - 1, L)
        rows = torch.full((n, L + 1), -1, dtype=torch.int32, device=dev)
        rows.scatter_(1, dest, cand)
        out_s[sel], out_i[sel] = D.rerank_topk(
            corpus, corpus_sq, rows[:, :L], qc, metric=metric, k=k)
    return out_s, out_i


class IVFIndex(MutationMixin):
    """k-means coarse quantizer + probed exact scoring (the paper's HNSW
    adaptation (a)).

    Writes follow the reference: inserts assign against the frozen
    centroids and append to the cluster's bucket row in batch order (the
    bucket capacity doubles while a fill would pass it); deletes tombstone
    the slot to the -1 pad sentinel; upserts tombstone the old slot and
    append; ``compact`` repacks each bucket row's live slots to the front
    and keeps the capacity. The corpus is id-indexed and grows by an
    eighth (``core.mutable``); ``_pos`` maps an id to its flat slot
    (cluster * cap + slot), -1 for an id not held.
    """

    def __init__(self, metric: str = "cosine", n_clusters: int = 0,
                 nprobe: int = 8, kmeans_iters: int = 10, seed: int = 0,
                 dtype=torch.float32, device=None):
        from repro_torch.core.flat import corpus_dtype  # flat -> ops -> ivf
        if metric not in D.METRICS:
            raise ValueError(f"metric {metric!r} not in {D.METRICS}")
        self.metric = metric
        self.n_clusters = n_clusters  # 0 => sqrt(N) at load time
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.dtype = corpus_dtype(dtype)
        self.device = resolve_device(device)
        self.corpus = self.centroids = self.buckets = self.corpus_sq = None
        self.cap = 0
        self._corpus = self._sq = None
        self._buckets = self._pos = None
        self._fill = None  # (C,) slots used in each bucket row, tombstones too
        self._mut_init(0)

    @property
    def size(self) -> int:
        return 0 if self._pos is None else int((self._pos >= 0).sum())

    @property
    def shape_key(self) -> tuple:
        return (0 if self._corpus is None else self._corpus.capacity,
                self.cap)

    def load(self, vectors):
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        N = x.shape[0]
        C = min(self.n_clusters or max(1, int(math.sqrt(N))), N)
        corpus, sq = D.preprocess_corpus(x, self.metric)
        del x
        # cluster in the search geometry: cosine clusters unit vectors
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        cent = kmeans(corpus, n_clusters=C, iters=self.kmeans_iters,
                      generator=gen)
        if self.metric == "cosine":
            cent = D.l2_normalize(cent)
        assign = assign_clusters(corpus, cent)
        buckets, cap = build_buckets(assign, C)
        table = torch.full((C, row_capacity(cap, minimum=1)), -1,
                           dtype=torch.int32, device=self.device)
        table[:, :cap] = buckets
        self.centroids = cent.to(self.dtype)
        self._init_storage(corpus.to(self.dtype), sq, table,
                           torch.bincount(assign, minlength=C), N)
        return self

    def _init_storage(self, corpus, sq, table, fill, n_ids: int) -> None:
        """Adopt the corpus, |c|^2, the bucket table and its fills; the
        positions come from the table."""
        self._corpus = GrowableRows.from_array(corpus)
        self._sq = None if sq is None else GrowableRows.from_array(sq)
        self._buckets = table
        self.cap = table.shape[1]
        self._fill = fill.long()
        self._pos = torch.full((n_ids,), -1, dtype=torch.int64,
                               device=self.device)
        flat = table.reshape(-1)
        held = torch.nonzero(flat >= 0)[:, 0]
        self._pos[flat[held].long()] = held
        self._mut_init(n_ids)
        self._sync()

    def load_state(self, state) -> "IVFIndex":
        """Serve a trained state: centroids, the (C, cap) bucket table, its
        fills, the corpus rows over the id space (normalized for cosine;
        cast to the engine's dtype) and corpus_sq for l2; ``generation``
        where given. The reference's engine has no ``state_dict``: a caller
        builds the dict from its attributes and passes it through
        ``core.convert.from_reference_state``."""
        from repro_torch.core.flat import _check_snapshot
        _check_snapshot(state, "ivf", self.metric)
        dev = self.device
        self.centroids = torch.as_tensor(state["centroids"],
                                         device=dev).to(self.dtype)
        corpus = torch.as_tensor(state["corpus"], device=dev).to(self.dtype)
        sq = state.get("corpus_sq")
        self._init_storage(
            corpus,
            None if sq is None else torch.as_tensor(sq, dtype=torch.float32,
                                                    device=dev),
            torch.as_tensor(state["buckets"], device=dev).to(torch.int32),
            torch.as_tensor(state["fill"], device=dev),
            corpus.shape[0])
        self.generation = int(state.get("generation", 0))
        return self

    # ---------------------------------------------------------- mutation
    def _encode_batch(self, vectors):
        x = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32,
                                             device=self.device))
        rows, sq = D.preprocess_corpus(x, self.metric)
        return rows, sq, assign_clusters(rows, self.centroids.float())

    def _append(self, ids, clusters) -> None:
        """Put each id into the next slot of its cluster's bucket row, in
        batch order, doubling the capacity while a fill would pass it
        (the reference doubles at the put that finds its row full)."""
        n = ids.numel()
        if not n:
            return
        dev = ids.device
        C = self._buckets.shape[0]
        counts = torch.bincount(clusters, minlength=C)
        new_fill = self._fill + counts
        most, top_id = torch.stack([new_fill.max(), ids.max()]).tolist()
        cap = self.cap
        while cap < most:
            cap *= 2
        if cap != self.cap:
            grown = torch.full((C, cap), -1, dtype=torch.int32, device=dev)
            grown[:, :self.cap] = self._buckets
            held = self._pos >= 0
            p = self._pos[held]
            self._pos[held] = (torch.div(p, self.cap, rounding_mode="floor")
                               * cap + p % self.cap)
            self._buckets, self.cap = grown, cap
        if top_id >= self._pos.numel():
            have = self._pos.numel()
            grown = torch.full((max(top_id + 1, have + have // 8),), -1,
                               dtype=torch.int64, device=dev)
            grown[:have] = self._pos
            self._pos = grown
        order = torch.sort(clusters, stable=True).indices
        c_s = clusters[order]
        rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0)
                                              - counts)[c_s]
        flat = c_s * cap + self._fill[c_s] + rank
        self._buckets.view(-1)[flat] = ids[order].to(torch.int32)
        self._pos[ids[order]] = flat
        self._fill = new_fill

    def insert(self, vectors, ids=None) -> torch.Tensor:
        rows, sq, assign = self._encode_batch(vectors)
        ids = self._take_ids(rows.shape[0], ids)
        self._write_mirrors(ids, ((self._corpus, rows), (self._sq, sq)))
        self._append(ids, assign)
        self._record("inserts", ids.numel())
        return ids

    def delete(self, ids) -> int:
        """Tombstone rows; returns the distinct live ids among ``ids`` (an
        id given twice counts once, as in the reference)."""
        ids = as_ids(ids, self.device)
        ids = torch.unique(ids[(ids >= 0) & (ids < self._pos.numel())])
        pos = self._pos[ids]
        held = pos >= 0
        ids, pos = ids[held], pos[held]
        self._buckets.view(-1)[pos] = -1
        self._pos[ids] = -1
        n = ids.numel()
        if n:
            self._record("deletes", n)
        return n

    def upsert(self, vectors, ids) -> torch.Tensor:
        rows, sq, assign = self._encode_batch(vectors)
        ids = self._check_upsert_ids(rows.shape[0], ids)
        self._write_mirrors(ids, ((self._corpus, rows), (self._sq, sq)))
        old = self._pos[ids]
        self._buckets.view(-1)[old[old >= 0]] = -1
        self._append(ids, assign)
        self._record("upserts", ids.numel())
        return ids

    def compact(self) -> dict:
        """Repack each bucket row's live slots to the front, in order
        (tombstone holes stop occupying probe positions); the capacity is
        kept."""
        C, cap = self._buckets.shape
        live = self._buckets >= 0
        kept = live.sum(1)
        dropped = int((self._fill - kept).sum())
        slot = torch.cumsum(live, 1) - 1
        cl = torch.arange(C, device=self.device)[:, None].expand(C, cap)
        ids = self._buckets[live].long()
        flat = cl[live] * cap + slot[live]
        self._buckets.fill_(-1)
        self._buckets.view(-1)[flat] = ids.to(torch.int32)
        self._pos[ids] = flat
        self._fill = kept
        self._record("compactions", 1)
        return {"dropped_tombstones": dropped}

    # ------------------------------------------------------------- query
    def _sync(self) -> None:
        if not self._dirty:
            return
        self.corpus = self._corpus.data
        self.corpus_sq = None if self._sq is None else self._sq.data
        self.buckets = self._buckets
        self._dirty = False

    def query(self, q, k: int = 10, *, allowed=None, nprobe_boost: int = 1):
        """``allowed`` (the predicate bitmap) rewrites the slots it rejects
        to the pad sentinel; ``nprobe_boost`` multiplies nprobe (capped at
        the cluster count). Queries are cast to the corpus's dtype before
        they are normalized, as the reference casts them."""
        from repro_torch.kernels import ops as kops  # ops imports this module
        self._sync()
        q = torch.atleast_2d(torch.as_tensor(q, dtype=torch.float32,
                                             device=self.device))
        nprobe = min(self.nprobe * max(1, int(nprobe_boost)),
                     self.centroids.shape[0])
        buckets = self.buckets
        if allowed is not None:
            buckets = kops.mask_allowed_ids(buckets, allowed)
        return ivf_search(self.corpus, self.centroids, buckets,
                          q.to(self.dtype), metric=self.metric, k=k,
                          nprobe=nprobe, corpus_sq=self.corpus_sq)

    def memory_bytes(self) -> int:
        """The engine's device bytes: corpus buffer, |c|^2 for l2,
        centroids, bucket table and positions."""
        parts = [self._corpus.data, self.centroids, self._buckets, self._pos,
                 None if self._sq is None else self._sq.data]
        return int(sum(t.numel() * t.element_size() for t in parts
                       if t is not None))
