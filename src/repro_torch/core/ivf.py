"""IVF coarse quantizer, the block-aligned inverted lists and the grouped
grids' block schedule (port of ``repro.core.ivf``, the parts the IVF-PQ
load and query paths use).

``kmeans`` and ``assign_clusters`` score rows against centroids in row
chunks: the reference builds the whole (N, C) score matrix, which at
8.8M rows and 2973 clusters would be 105 GB. ``build_buckets`` and the
layout construction are vectorized where the reference loops per row in
Python. Everything runs on the device of its inputs.

Sums in k-means go through ``index_add_``, which on the card adds with
atomics in no fixed order, so trained centroids can differ in the last
bits from run to run. Training is held to recall, not to bits.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.core.mutable import row_capacity
from repro_torch.device import strict_fp32

SCORE_BUDGET = 1 << 28  # score-matrix entries a chunk may hold (1 GiB f32)


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
    dispatch reads this first and builds the schedule only when a grouped
    grid will use it. Reading the counts is a host sync."""
    v = torch.as_tensor(visit).reshape(-1)
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
                and ent[0].device == visit.device
                and torch.equal(ent[0], visit)):
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
    """Block-aligned inverted lists on the device, the read side.

    Storage is a (capacity, blk) slot table with a co-located
    (capacity, blk, m) uint8 code payload. Row ``capacity - 1`` is the
    shared all-pad block; ``block_table[c]`` lists the storage rows cluster
    c owns, in visit order, padded with -1 to the static ``steps_per_probe``
    width, which is a power of two. Capacities are power-of-two buckets
    (``mutable.row_capacity``), as in the reference, so that a layout built
    here and one built there have the same shapes.

    ``pos`` maps a row id to its flat slot (row * blk + slot), -1 for an
    id the layout does not hold; the reference keeps a dict for that.
    Appends into partly filled tail blocks, deletes and compaction come
    with ROADMAP.md Queue 1, item 5.
    """

    def __init__(self, n_clusters: int, blk: int = 32, m: int = 0,
                 device=None):
        if blk % 8:
            raise ValueError(f"block size {blk} is not a multiple of 8")
        self.C = int(n_clusters)
        self.blk = int(blk)
        self.m = int(m)
        self.spp_cap = 1
        cap = self._round_rows(2)
        self.slots = torch.full((cap, blk), -1, dtype=torch.int32, device=device)
        self.codes = (torch.zeros((cap, blk, m), dtype=torch.uint8, device=device)
                      if m else None)
        self.block_cluster = torch.full((cap,), -1, dtype=torch.int32,
                                        device=device)
        self.block_table = torch.full((self.C, 1), -1, dtype=torch.int32,
                                      device=device)
        self.bcnt = torch.zeros(self.C, dtype=torch.int32, device=device)
        self.pos = torch.full((0,), -1, dtype=torch.int64, device=device)
        self.live = 0

    # ------------------------------------------------------------ build
    @classmethod
    def from_assign(cls, assign, n_clusters: int, *, blk: int = 32,
                    payload=None, ids=None, live=None,
                    device=None) -> "BlockListLayout":
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
        lay = cls(n_clusters, blk=blk, m=m, device=dev)
        lay.pos = torch.full((N,), -1, dtype=torch.int64, device=dev)
        lay._bulk_append(assign, ids, payload)
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

    def _round_rows(self, n: int) -> int:
        return row_capacity(n, minimum=4)

    def _reserve_rows(self, n: int) -> bool:
        """Grow storage to >= n rows (pad row included); True on growth."""
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

    def _bulk_append(self, clusters, ids, payload=None) -> None:
        """Append rows to an empty layout (the load path): each cluster's
        rows, in the given order, fill fresh contiguous blocks, clusters in
        cluster order, and the last block of each is padded with -1.
        Capacity grows to hold the blocks plus the pad row and one spare,
        as the reference reserves."""
        clusters = clusters.long()
        dev = self.slots.device
        n = clusters.shape[0]
        counts = torch.bincount(clusters, minlength=self.C)
        bstart, bcnt = _block_ranges(counts, self.blk)
        total = int(bcnt.sum())
        self._reserve_rows(total + 2)
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
            torch.arange(self.C, dtype=torch.int32, device=dev), bcnt)
        self.block_cluster[:total] = owner
        most = max(1, int(bcnt.max())) if self.C else 1
        while self.spp_cap < most:
            self.spp_cap *= 2
        r = torch.arange(self.spp_cap, device=dev)[None, :]
        self.block_table = torch.where(r < bcnt[:, None], bstart[:, None] + r,
                                       -1).to(torch.int32)
        self.bcnt = bcnt.to(torch.int32)
        self.live += n

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
