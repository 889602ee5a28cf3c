"""The per-query IVF-ADC grid, on the CPU: its function against the JAX
package, and what its kernel is handed.

The kernel (``csrc/ivf_adc.cu`` ``ivf_adc_rows``) runs only on the card;
``tests/test_torch_gpu.py`` holds it against its plain version there. Here
``ops.ivf_adc_topk(mode="per_query")`` runs the plain version on visit
tables shaped like the engine's (real steps at the front of each probe's
range, at least 60 % of every probe's steps on the all-pad block), with
and without ``pad_block``, against the reference's Pallas kernel in
interpret mode and its jnp twin: ids exact, float32 scores within
atol = rtol = 1e-5 of the reference at the same table precision, and
within the ROADMAP's per-dtype bounds of the float32 oracle (bf16
m * 2^-8 * max|lut|, int8 m * max|lut| / 254). Then the launch plan
(``query_plan``), the deal of visit steps to blocks and warps
(``step_owners``, and the kernel's walk written out in Python) and the
shared-memory byte counts of both variants.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ivf_adc_topk as jax_ivf_adc_topk  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.ivf_adc import ivf_adc as jax_ivf_adc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ivf_adc as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

NEG_INF = -1e30
TOL = dict(atol=1e-5, rtol=1e-5)
CARD = _build.H100
DTYPES = ("float32", "bfloat16", "int8")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(rng, *, Q=5, B=41, blk=8, m=4, ksub=16, nprobe=4, spp=10,
             per_probe=False, real_share=0.4):
    """Engine-shaped inputs: B - 1 real blocks (a tenth of their slots -1,
    as tombstones) and the all-pad block B - 1; each probe's first
    r <= real_share * spp steps visit real blocks and the rest the pad
    block; probe 1 of query 0 knocked out, and every probe of query Q - 1."""
    codes = rng.integers(0, ksub, (B, blk, m)).astype(np.uint8)
    ids = np.arange(B * blk, dtype=np.int32).reshape(B, blk)
    ids[rng.random((B, blk)) < 0.1] = -1
    ids[-1] = -1
    real = rng.integers(0, int(real_share * spp) + 1, (Q, nprobe))
    real[0, 0] = max(real[0, 0], 1)
    j = np.arange(spp)[None, None, :]
    visit = np.where(j < real[:, :, None],
                     rng.integers(0, B - 1, (Q, nprobe, spp)), B - 1)
    visit = visit.reshape(Q, nprobe * spp).astype(np.int32)
    shape = (Q, nprobe, m, ksub) if per_probe else (Q, m, ksub)
    luts = rng.normal(size=shape).astype(np.float32)
    coarse = rng.normal(size=(Q, nprobe)).astype(np.float32)
    coarse[0, 1] = NEG_INF
    coarse[Q - 1] = NEG_INF
    return codes, ids, visit, luts, coarse, spp


def _normalized(s, i):
    s, i = np.asarray(s), np.asarray(i)
    bad = s <= 0.5 * NEG_INF
    return np.where(bad, -np.inf, s), np.where(bad, -1, i)


def _bound(luts, lut_dtype, m):
    amax = float(np.abs(luts).max())
    return {"float32": 1e-5, "bfloat16": m * 2.0 ** -8 * amax,
            "int8": m * amax / 254}[lut_dtype]


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("lut_dtype", DTYPES)
def test_per_query_matches_reference(rng, lut_dtype, per_probe, pad):
    """ops.ivf_adc_topk(mode="per_query") with and without pad_block on
    visit tables that are at least 60 % pad, knocked-out probes and a
    query with none left, shared and per-probe tables, each table type:
    ids equal to the reference's Pallas kernel (interpret mode) and its
    jnp twin, scores within 1e-5 of them and within the dtype's bound of
    the float32 oracle."""
    codes, ids, visit, luts, coarse, spp = _problem(rng, per_probe=per_probe)
    Q, T = visit.shape
    B, blk, m = codes.shape
    assert (visit.reshape(Q, -1, spp)[:, :, int(0.4 * spp):] == B - 1).all()
    k = 17
    pad_block = B - 1 if pad else None
    ps, pi = ops.ivf_adc_topk(_t(codes), _t(ids), _t(visit), _t(luts), k=k,
                              coarse=_t(coarse), steps_per_probe=spp,
                              lut_dtype=lut_dtype, mode="per_query",
                              pad_block=pad_block)
    ps, pi = ps.numpy(), pi.numpy()
    jargs = (jnp.asarray(codes.astype(np.int32)), jnp.asarray(ids),
             jnp.asarray(visit), jnp.asarray(luts))
    ks, ki = _normalized(*jax_ivf_adc(*jargs, jnp.asarray(coarse), k=k,
                                      steps_per_probe=spp, interpret=True,
                                      lut_dtype=lut_dtype))
    js, ji = jax_ivf_adc_topk(*jargs, k=k, coarse=jnp.asarray(coarse),
                              steps_per_probe=spp, use_kernel=False,
                              lut_dtype=lut_dtype, mode="per_query",
                              pad_block=pad_block)
    for ws, wi in ((ks, ki), (np.asarray(js), np.asarray(ji))):
        np.testing.assert_array_equal(pi, wi)
        np.testing.assert_allclose(ps, ws, **TOL)
    assert np.isneginf(ps[Q - 1]).all() and (pi[Q - 1] == -1).all()
    rs, _ = R.ivf_adc_ref(*jargs, jnp.asarray(coarse), k=k,
                          steps_per_probe=spp)
    rs = np.asarray(rs)
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(rs))
    live = np.isfinite(rs)
    assert np.all(np.abs(ps[live] - rs[live])
                  <= _bound(luts, lut_dtype, m) + 1e-5 * np.abs(rs[live]))


def test_per_query_pad_block_is_checked():
    codes = torch.zeros((3, 8, 4), dtype=torch.uint8)
    ids = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="pad_block 3"):
        K._per_query_cuda(codes, ids, torch.zeros((1, 2), dtype=torch.int32),
                          torch.zeros((1, 4, 16)), torch.zeros((1, 2)), k=4,
                          steps_per_probe=1, lut_dtype="float32",
                          pad_block=3)


# ------------------------------------------------------------ the deal

def _kernel_walk(steps, spp, n, chunk, warp):
    """The steps warp ``warp`` of block ``chunk`` walks, in its order, as
    csrc/ivf_adc.cu ivf_adc_rows writes it: cell (pl, i) of a P x w grid,
    w = ceil(spp / V), is step jf + V i of probe pl, jf = (u - pl V / P)
    mod V, where that is below spp."""
    V = n * K.WARPS
    P = steps // spp
    u = warp * n + chunk
    w = -(-spp // V)
    out = []
    for g in range(P * w):
        pl, i = divmod(g, w)
        j = (u - pl * V // P) % V + V * i
        if j < spp:
            out.append(pl * spp + j)
    return out


@pytest.mark.parametrize("steps,spp,n", [(4096, 512, 128), (4096, 512, 8),
                                         (4096, 512, 1), (512, 512, 16),
                                         (40, 10, 3), (66, 6, 7)])
def test_every_step_falls_to_one_block_and_warp(steps, spp, n):
    """step_owners gives each of a row's steps one (chunk, warp), and the
    kernel's walk visits exactly the steps step_owners deals to it, each
    once, in increasing order."""
    chunk, warp = K.step_owners(steps, spp, n)
    assert chunk.shape == warp.shape == (steps,)
    assert int(chunk.min()) >= 0 and int(chunk.max()) < n
    assert int(warp.min()) >= 0 and int(warp.max()) < K.WARPS
    seen = np.zeros(steps, dtype=int)
    for c in range(n):
        for w in range(K.WARPS):
            walk = _kernel_walk(steps, spp, n, c, w)
            assert walk == sorted(walk)
            want = np.flatnonzero((chunk.numpy() == c) & (warp.numpy() == w))
            np.testing.assert_array_equal(walk, want)
            seen[walk] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n", [1, 3, 8, 16, 128])
def test_front_loaded_real_steps_spread_within_one_of_even(rng, n):
    """The real steps at the front of a probe's range (the rest visit the
    pad block) spread over the chunks within one step of even, and over
    all (chunk, warp) pairs too, for every real count; over the probes of
    a row, no chunk is more than the probe count from even."""
    steps, spp = 4096, 512
    chunk, warp = (x.numpy() for x in K.step_owners(steps, spp, n))
    V = n * K.WARPS
    for r in [0, 1, 5, 31, 100, 211, 400, 512]:
        for p in range(steps // spp):
            sl = slice(p * spp, p * spp + r)
            per_chunk = np.bincount(chunk[sl], minlength=n)
            assert per_chunk.max() - per_chunk.min() <= 1
            per_pair = np.bincount(chunk[sl] * K.WARPS + warp[sl],
                                   minlength=V)
            assert per_pair.max() - per_pair.min() <= 1
    real = rng.integers(0, spp + 1, steps // spp)
    j = np.arange(steps) % spp
    mask = j < real[np.arange(steps) // spp]
    per_chunk = np.bincount(chunk[mask], minlength=n)
    assert per_chunk.max() - per_chunk.min() <= steps // spp


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("lut_dtype", DTYPES)
@pytest.mark.parametrize("Q", [1, 2, 3, 32, 33, 100, 512, 4096])
def test_query_plan_fills_the_card_without_a_look_at_the_data(Q, lut_dtype,
                                                              per_probe):
    """The main path's shapes (T = 4,096, steps_per_probe 512, m = 64,
    k = 32): rows and chunks a row from the shapes alone, at least
    MIN_CHUNK_STEPS steps a chunk, at most one wave of blocks unless every
    row has one chunk, and grid dimensions under 65,535 chunks a row."""
    T, spp = 4096, 512
    p = K.query_plan(Q, T, spp, per_probe, 64, 256, 32, 32, lut_dtype, CARD)
    assert set(p) == set(K.QUERY_PLAN_KEYS)
    rows = Q * 8 if per_probe else Q
    steps = spp if per_probe else T
    assert p["rows"] == rows and p["ring"] is True
    assert p["blocks_per_sm"] == 2
    assert 1 <= p["n_chunks"] <= 65535
    assert p["n_chunks"] == 1 or steps // p["n_chunks"] >= K.MIN_CHUNK_STEPS
    slots = CARD["sms"] * p["blocks_per_sm"]
    assert p["n_chunks"] == 1 or rows * p["n_chunks"] <= slots
    if p["n_chunks"] < steps // K.MIN_CHUNK_STEPS:
        assert rows * (p["n_chunks"] + 1) > slots  # as many as fill a wave
    n_parts = (8 if per_probe else 1) * p["n_chunks"]
    assert p["groups"] == _build.merge_groups(n_parts, Q, CARD["sms"])


def test_query_plan_at_the_main_paths_batch_sizes():
    """About one block an SM at Q = 1 (one block a query chunk), fewer
    chunks a query as Q grows, one at Q = 512."""
    n = {Q: K.query_plan(Q, 4096, 512, False, 64, 256, 32, 32, "float32",
                         CARD)["n_chunks"] for Q in (1, 32, 512)}
    assert n == {1: 128, 32: 8, 512: 1}
    assert 0.9 * CARD["sms"] <= n[1] <= CARD["sms"]


def test_query_smem_bytes_count_table_ring_and_board():
    """The ring variant: one float32 m = 64 table (64 KB), two stages of
    2 KB of codes and 128 B of ids for each of 8 warps and their candidate
    lists (256 bytes each), a k = 32 row's threshold, board and lock (268
    bytes), int8 its m scales; no coarse terms. The direct-read variant:
    the table and the row's threshold, board and lock only (no lists; int8
    scales stay in device memory)."""
    ring = 8 * 2 * (2048 + 128) + 8 * 256
    assert K.query_smem_bytes("float32", 64, 256, 32, 32, True) \
        == 65536 + ring + 268
    assert K.query_smem_bytes("int8", 64, 256, 32, 32, True) \
        == 16384 + ring + 268 + 256
    assert K.query_smem_bytes("float32", 64, 256, 32, 32, True) == \
        K.tile_smem_bytes("float32", 1, 64, 256, 32, 32, cw=0)
    assert K.query_smem_bytes("float32", 210, 256, 32, 256, False) \
        == 210 * 1024 + 8 + 8 * 256 + 4
    assert K.query_smem_bytes("int8", 7, 16, 32, 1, False) \
        == 112 + 8 + 8 * 32 + 4
    # a table whose bytes are not a multiple of 16 is padded to one
    assert K.query_smem_bytes("bfloat16", 3, 5, 8, 4, False) \
        == 32 + 8 + 8 * 32 + 4


def test_query_plan_picks_the_ring_or_the_direct_read_variant():
    p = K.query_plan(32, 4096, 512, False, 210, 256, 32, 256, "float32",
                     CARD)
    assert p["ring"] is False and p["blocks_per_sm"] == 1
    assert p["smem"] == K.query_smem_bytes("float32", 210, 256, 32, 256,
                                           False)
    forced = K.query_plan(32, 4096, 512, False, 64, 256, 32, 32, "float32",
                          CARD, ring=False)
    assert forced["ring"] is False
    with pytest.raises(ValueError, match="the card allows 232448"):
        K.query_plan(32, 4096, 512, False, 210, 256, 32, 256, "float32",
                     CARD, ring=True)
    with pytest.raises(ValueError, match="m=240, ksub=256 float32 table"):
        K.query_plan(1, 64, 8, True, 240, 256, 32, 32, "float32", CARD)


@pytest.mark.parametrize("lut_dtype", DTYPES)
def test_query_plan_takes_every_size_the_warp_board_kernel_took(lut_dtype):
    """The grid before this design staged one table beside eight warp
    boards and m scales: 64 k + 4 m + the table's bytes a block. Every
    (m, k) at ksub = 256 that fit then fits now (the largest m for each k
    checked; the byte counts grow with m)."""
    esize = {"float32": 4, "bfloat16": 2, "int8": 1}[lut_dtype]
    for k in (1, 2, 4, 5, 16, 31, 32, 33, 64, 100, 128, 200, 256):
        m = max(mm for mm in range(1, 2000)
                if 64 * k + 4 * mm + esize * mm * 256 <= CARD["smem_block"])
        K.query_plan(1, 4096, 512, False, m, 256, 32, k, lut_dtype, CARD)
    m210 = K.query_plan(1, 4096, 512, False, 210, 256, 32, 256, "float32",
                        CARD)
    assert m210["ring"] is False
