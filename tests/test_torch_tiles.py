"""The grouped IVF-ADC kernel's launch plan and pair index, on the CPU.

The kernel (``csrc/ivf_adc.cu`` ``ivf_adc_tiles``) runs only on the card;
``tests/test_torch_gpu.py`` holds it against its plain versions there.
What it is handed is computed here in Python and checked here: the tile
width and shared-memory budget of ``grouped_plan`` for each table type,
and the scheduled pairs bucketed by tile (``tile_index``) against a numpy
oracle on schedules from ``build_block_schedule``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ivf_adc as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CARD = _build.H100
DTYPES = ("float32", "bfloat16", "int8")

# The widest tile (table rows a block) at ksub = 256, blk = 32, k = 32 on
# an H100: the tables beside a 34,816-byte code ring, the warps' candidate
# lists and the boards.
WIDTHS = {("float32", 7): 16, ("float32", 8): 16, ("float32", 64): 2,
          ("bfloat16", 7): 16, ("bfloat16", 8): 16, ("bfloat16", 64): 5,
          ("int8", 7): 16, ("int8", 8): 16, ("int8", 64): 11}


@pytest.mark.parametrize("k", [1, 32, 256])
@pytest.mark.parametrize("m", [7, 8, 64])
@pytest.mark.parametrize("lut_dtype", DTYPES)
def test_tile_width_fills_the_shared_memory(lut_dtype, m, k):
    """The widest tile fits the card's opt-in shared memory and one more
    row would not (below MAX_QT); k = 256's boards cost a float32 row."""
    qt = K.fit_tile(m, 256, 32, k, lut_dtype, CARD)
    if k == 32:
        assert qt == WIDTHS[(lut_dtype, m)]
    assert K.tile_smem_bytes(lut_dtype, qt, m, 256, 32, k) \
        <= CARD["smem_block"]
    if qt < K.MAX_QT:
        assert K.tile_smem_bytes(lut_dtype, qt + 1, m, 256, 32, k) \
            > CARD["smem_block"]
    if (lut_dtype, m, k) == ("float32", 64, 256):
        assert qt == 2


def test_tile_bytes_count_tables_ring_and_boards():
    """One float32 m = 64 table is 64 KB; the ring two stages of 2 KB of
    codes and 128 B of ids for each of 8 warps, and their candidate lists
    256 bytes each; a k = 32 row's threshold, board and lock 268 bytes,
    and 4 bytes a coarse term (8 for a shared table at nprobe = 8); int8
    adds its m scales a row."""
    ring = 8 * 2 * (2048 + 128) + 8 * 256
    assert K.tile_smem_bytes("float32", 1, 64, 256, 32, 32) \
        == 65536 + ring + 268 + 4
    assert K.tile_smem_bytes("float32", 1, 64, 256, 32, 32, cw=8) \
        == 65536 + ring + 268 + 32
    assert K.tile_smem_bytes("int8", 2, 64, 256, 32, 32) \
        == 2 * 16384 + ring + 2 * (268 + 4 + 256)
    # a 7-byte code row: 224 bytes a block, ids 128
    assert K.tile_smem_bytes("bfloat16", 1, 7, 256, 32, 1) \
        == 7 * 256 * 2 + 8 * 2 * (224 + 128) + 8 * 256 + 268 + 4


@pytest.mark.parametrize("m", [7, 8, 64])
@pytest.mark.parametrize("lut_dtype", DTYPES)
def test_plan_width_keeps_two_blocks_an_sm(lut_dtype, m):
    """The plan's widest tile lets two blocks share an SM (at m = 64: one
    float32, two bf16, four int8 tables), within the widest that fits."""
    for k in (1, 32, 256):
        qt = K.plan_width(m, 256, 32, k, lut_dtype, CARD)
        assert 1 <= qt <= K.fit_tile(m, 256, 32, k, lut_dtype, CARD)
        two = CARD["smem_sm"] // 2 - 1024
        assert K.tile_smem_bytes(lut_dtype, qt, m, 256, 32, k) <= two
        if qt < K.MAX_QT:
            assert K.tile_smem_bytes(lut_dtype, qt + 1, m, 256, 32, k) > two
    if m == 64:
        assert K.plan_width(m, 256, 32, 32, lut_dtype, CARD) == \
            {"float32": 1, "bfloat16": 2, "int8": 4}[lut_dtype]


@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("lut_dtype", DTYPES)
@pytest.mark.parametrize("Q", [1, 3, 32, 33, 512])
def test_grouped_plan_covers_the_rows_and_fills_the_card(Q, lut_dtype,
                                                         per_probe):
    T, spp = 4096, 512
    p = K.grouped_plan(Q, T, spp, per_probe, 64, 256, 32, 32, lut_dtype,
                       CARD)
    assert set(p) == set(K.GROUPED_PLAN_KEYS)
    rows = Q * (T // spp) if per_probe else Q
    cw = 1 if per_probe else T // spp
    top = K.plan_width(64, 256, 32, 32, lut_dtype, CARD, cw)
    assert p["qt"] <= top and p["tiles"] == -(-rows // p["qt"])
    assert p["tiles"] == -(-rows // top)  # as few tiles as the width allows
    assert (p["tiles"] - 1) * p["qt"] < rows <= p["tiles"] * p["qt"]
    assert p["smem"] == K.tile_smem_bytes(lut_dtype, p["qt"], 64, 256, 32,
                                          32, cw) <= CARD["smem_block"]
    assert p["blocks_per_sm"] == 2
    assert p["slots"] == CARD["sms"] * p["blocks_per_sm"]


def test_grouped_plan_forced_width_and_limits():
    p = K.grouped_plan(32, 64, 8, False, 64, 256, 32, 32, "float32", CARD,
                       qt=2)
    assert p["qt"] == 2 and p["tiles"] == 16 and p["blocks_per_sm"] == 1
    assert p["slots"] == 132
    with pytest.raises(ValueError, match="tile width 3"):
        K.grouped_plan(32, 64, 8, False, 64, 256, 32, 32, "float32", CARD,
                       qt=3)
    # a table that does not fit one block: m = 256 float32 tables are 256 KB
    with pytest.raises(ValueError, match="256 KB|bytes of shared memory"):
        K.grouped_plan(4, 64, 8, False, 256, 256, 32, 32, "float32", CARD)


# ------------------------------------------------------------ pair index
def _schedule(rng, Q, T, B, qblk, pad):
    visit = rng.integers(0, B - 1, (Q, T)).astype(np.int32)
    visit[rng.random((Q, T)) < 0.3] = B - 1
    return visit, ops.build_schedule(torch.from_numpy(visit), qblk=qblk,
                                     pad_block=B - 1 if pad else None)


def _oracle(sched, *, rows, qt, nprobe, spp, per_probe, runs):
    """Per tile, in the order the schedule lists them: (block, q, t, unit)
    of each real pair."""
    sb, sq, st = (sched[k].numpy() for k in ("sb", "sq", "st"))
    grun = sched["grun"].numpy()
    qblk = sq.shape[1]
    tiles = [[] for _ in range(-(-rows // qt))]
    for gp in range(sq.size):
        g, i = divmod(gp, qblk)
        q, t = int(sq[g, i]), int(st[g, i])
        if q < 0:
            continue
        row = q * nprobe + t // spp if per_probe else q
        tiles[row // qt].append((int(sb[g]), q, t,
                                 int(grun[g]) if runs else g))
    return tiles


@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("Q", [1, 3, 33])
def test_tile_index_matches_a_numpy_oracle(rng, Q, pad, per_probe, runs):
    """Every real scheduled pair once, sentinels dropped, block order kept
    within a tile, heads where the tile or the fetch unit changes and
    every SEG_MAX pairs of one unit, and the pair's probe."""
    T, spp, qblk, qt = 48, 6, 4, 3
    visit, sched = _schedule(rng, Q, T, 23, qblk, pad)
    nprobe = T // spp
    rows = Q * nprobe if per_probe else Q
    kw = dict(rows=rows, qt=qt, nprobe=nprobe, spp=spp, per_probe=per_probe,
              runs=runs)
    want = _oracle(sched, **kw)
    kw["steps_per_probe"] = kw.pop("spp")
    idx = K.tile_index(sched, **kw)
    meta, tp = idx["meta"].numpy(), idx["tile_pairs"].numpy()
    assert idx["meta"].dtype == torch.int32 and meta.shape == (
        sched["pairs"], 4)
    assert tp[0] == 0 and tp[-1] == sched["pairs"]
    assert sum(len(w) for w in want) == sched["pairs"]
    for tile, pairs in enumerate(want):
        got = meta[tp[tile]:tp[tile + 1]]
        np.testing.assert_array_equal(got[:, :3].reshape(-1, 3),
                                      np.array([p[:3] for p in pairs],
                                               dtype=np.int32).reshape(-1, 3))
        heads, run = [], 0
        for j, p in enumerate(pairs):
            run = 0 if j == 0 or p[3] != pairs[j - 1][3] else run + 1
            heads.append(run % K.SEG_MAX == 0)
        np.testing.assert_array_equal(got[:, 3] & 1, np.array(heads,
                                                              dtype=int))
        # the visit table agrees with each record, which carries its probe
        for b, q, t, w in got:
            assert visit[q, t] == b and w >> 1 == t // spp


@pytest.mark.parametrize("Q", [1, 3, 33])
def test_tile_index_blocked_and_runs_give_the_same_pairs(rng, Q):
    """Both grids see the same pairs in the same order; the run-resident
    grid fetches a block once a run (cut every SEG_MAX pairs), so it has
    fewer segments than the blocked grid, which fetches once a group."""
    _, sched = _schedule(rng, Q, 64, 9, 2, True)  # heavy sharing
    kw = dict(rows=Q, qt=2, nprobe=8, steps_per_probe=8, per_probe=False)
    a = K.tile_index(sched, runs=False, **kw)
    b = K.tile_index(sched, runs=True, **kw)
    assert torch.equal(a["meta"][:, :3], b["meta"][:, :3])
    assert torch.equal(a["tile_pairs"], b["tile_pairs"])
    ha, hb = (int((x["meta"][:, 3] & 1).sum()) for x in (a, b))
    assert hb < ha if Q > 1 else hb <= ha


def test_tile_index_segments_fit_the_kernels_window(rng):
    """What the kernel's 32-record window needs: a tile's first pair
    opens a segment, heads at most SEG_MAX apart, one block a segment."""
    visit = np.full((40, 64), 3, dtype=np.int32)  # one block, 40 x 64 visits
    visit[::2, 5:] = 7
    sched = ops.build_schedule(torch.from_numpy(visit), qblk=8)
    for runs in (False, True):
        idx = K.tile_index(sched, rows=40, qt=16, nprobe=8,
                           steps_per_probe=8, per_probe=False, runs=runs)
        meta, tp = idx["meta"].numpy(), idx["tile_pairs"].numpy()
        for a, b in zip(tp[:-1], tp[1:]):
            heads = np.flatnonzero(meta[a:b, 3] & 1) + a
            assert heads[0] == a
            assert np.diff(np.append(heads, b)).max() <= K.SEG_MAX
            for s, e in zip(heads, np.append(heads[1:], b)):
                assert len(set(meta[s:e, 0])) == 1


@pytest.mark.parametrize("slots", [1, 8, 264])
def test_tile_index_chunks_balance_the_pairs(rng, slots):
    """Chunks of chunk_pairs pairs (about two waves of ``slots`` blocks over
    the batch, at least MIN_CHUNK_PAIRS) cover every tile, its largest
    with n_chunks of them, however unevenly the pairs fall on the tiles."""
    visit = rng.integers(0, 60, (9, 64)).astype(np.int32)
    visit[1:, 8:] = 60  # query 0 has most of the pairs
    sched = ops.build_schedule(torch.from_numpy(visit), qblk=4, pad_block=60)
    idx = K.tile_index(sched, rows=9, qt=2, nprobe=8, steps_per_probe=8,
                       per_probe=False, runs=False, slots=slots)
    P, chunk = sched["pairs"], idx["chunk_pairs"]
    assert chunk == max(K.MIN_CHUNK_PAIRS,
                        -(-P // (K.CHUNK_WAVES * slots)))
    counts = np.diff(idx["tile_pairs"].numpy())
    assert idx["n_chunks"] == max(1, -(-counts.max() // chunk))
    used = sum(-(-c // chunk) for c in counts)
    assert used <= max(len(counts), -(-P // chunk) + len(counts))


def test_tile_index_is_cached_with_the_schedule(rng):
    _, sched = _schedule(rng, 5, 16, 11, 4, True)
    kw = dict(rows=5, qt=2, nprobe=4, steps_per_probe=4, per_probe=False)
    a = K.tile_index(sched, runs=False, **kw)
    assert K.tile_index(sched, runs=False, **kw) is a
    assert K.tile_index(sched, runs=True, **kw) is not a
    assert len(sched["tile_index"]) == 2


def test_tile_index_of_an_empty_schedule():
    visit = torch.full((4, 8), 6, dtype=torch.int32)  # pad visits only
    sched = ops.build_schedule(visit, qblk=8, pad_block=6)
    idx = K.tile_index(sched, rows=4, qt=3, nprobe=2, steps_per_probe=4,
                       per_probe=False, runs=True)
    assert idx["meta"].shape == (0, 4)
    assert idx["tile_pairs"].tolist() == [0, 0, 0]
