"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip on a machine without a CUDA card and run on the
GPU with ``pytest -m gpu tests/test_torch_gpu.py``. Whether a card is
there is decided inside each test, never at import time.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import VectorDB  # noqa: E402
from repro_torch.core import distances as D  # noqa: E402
from repro_torch.core.pq import _ivf_probe_stage  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


def _topk_near_ties(corpus, q, ks, ki, ps, pi, metric, tol):
    """Scores rank by rank within tol; an id may differ from the plain
    version's only where the kernel's row scores, exactly (float64 of the
    stored values), within twice tol of the plain score at that rank."""
    assert bool(((ks - ps).abs() <= tol).all()), float((ks - ps).abs().max())
    rows, cols = torch.nonzero(ki != pi, as_tuple=True)
    c64, q64 = corpus[ki[rows, cols].long()].double(), q[rows].double()
    exact = ((c64 * q64).sum(1) if metric == "dot"
             else -((q64 - c64) ** 2).sum(1))
    gap = (exact - ps[rows, cols].double()).abs()
    assert bool((gap <= 2 * tol[rows, 0].double() + 1e-6).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("Q,k,d,bq", [(1, 10, 128, 16), (5, 1, 128, 16),
                                      (16, 64, 128, 16), (32, 10, 128, 32),
                                      (48, 10, 128, 64), (33, 256, 128, 64),
                                      (128, 10, 128, 128),
                                      (512, 10, 128, 128), (1, 10, 96, 16),
                                      (33, 200, 96, 64), (70, 256, 96, 64)])
def test_topk_distance_kernel_matches_plain(Q, k, d, bq, metric, dtype):
    """Every query-tile template (16, 32, 64 and 128 rows), a ragged Q, a
    ragged N, a ragged last k-slab (d = 96), duplicated rows,
    a knocked-out tenth, in both corpus dtypes, against the plain version:
    scores within the float32 bound of two summation orders (2 d 2^-24
    |q| max|c|, doubled for l2, plus the float32 rounding of the products
    for bf16), ids equal but for near-ties."""
    from repro_torch.kernels.topk_distance import plan
    dev = _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(Q * 7 + k)
    corpus = torch.randn(30_011, d, generator=g, device=dev).to(dt)
    corpus = torch.cat([corpus, corpus[:64]])
    q = torch.randn(Q, d, generator=g, device=dev).to(dt)
    valid = torch.rand(corpus.shape[0], generator=g, device=dev) >= 0.1
    assert plan(corpus.shape[0], Q, d, k, dt)["bq"] == bq
    ops.reset_launch_counts()
    ks, ki = ops.topk_distance(corpus, q, k=k, metric=metric, valid=valid)
    assert ops.launch_counts()["topk_distance"] == 1
    ps, pi = ops.topk_distance(corpus, q, k=k, metric=metric, valid=valid,
                               use_kernel=False)
    torch.cuda.synchronize()
    assert bool(valid[ki.long()].all())
    cf, qf = corpus.float(), q.float()
    scale = (torch.linalg.vector_norm(qf, dim=1)[:, None]
             * torch.linalg.vector_norm(cf, dim=1).max())
    f = 2 if metric == "l2" else 1
    tol = f * (2 * d + (dtype == "bfloat16")) * 2.0 ** -24 * scale
    tol = tol + 1e-6 * ps.abs()
    _topk_near_ties(cf, qf, ks, ki, ps, pi, metric, tol)


def test_flat_bf16_engine_on_the_card():
    """VectorDB("flat", dtype=bfloat16) keeps a bf16 corpus on the card,
    ranks through the kernel, and answers as its plain path does."""
    dev = _card()
    rng = np.random.default_rng(8)
    corpus = rng.normal(size=(20_000, 64)).astype(np.float32)
    q = torch.as_tensor(corpus[:40] + 0.05, device=dev)
    db = VectorDB("flat", metric="cosine", dtype=torch.bfloat16,
                  device=dev).load(corpus)
    assert db.index.corpus.dtype == torch.bfloat16
    ops.reset_launch_counts()
    s, i = db.query(q, k=10)
    assert ops.launch_counts()["topk_distance"] == 1
    qn = D.l2_normalize(q.to(torch.bfloat16))
    ps, pi = ops.topk_distance(db.index.corpus, qn, k=10, use_kernel=False)
    torch.cuda.synchronize()
    tol = (2 * 64 + 1) * 2.0 ** -24 * torch.ones_like(ps[:, :1]) + 1e-6
    _topk_near_ties(db.index.corpus.float(), qn.float(), s[:40], i[:40], ps,
                    pi, "dot", tol)


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
def test_ivf_adc_kernel_matches_plain(metric, lut_dtype):
    dev = _card()
    rng = np.random.default_rng(1)
    centres = rng.normal(size=(40, 64)).astype(np.float32)
    corpus = centres[rng.integers(0, 40, 30_000)] + rng.normal(
        size=(30_000, 64)).astype(np.float32)
    db = VectorDB("ivf_pq", metric=metric, m=16, lut_dtype=lut_dtype,
                  refine=0, adc_mode="per_query", device=dev).load(corpus)
    q = torch.as_tensor(corpus[:37], device=dev)
    ops.reset_launch_counts()
    db.query(q, k=50)
    assert ops.launch_counts()["ivf_adc"] == 1
    # the kernel and its plain version on the inputs the engine builds
    idx = db.index
    probe_metric = "dot" if metric == "cosine" else metric
    if metric == "cosine":
        q = D.l2_normalize(q)
    visit, luts, coarse, _ = _ivf_probe_stage(
        idx.codebooks, idx.centroids, q, idx.block_table, metric=probe_metric,
        nprobe=idx.nprobe, steps_per_probe=idx.spp,
        pad_block=idx.bucket_ids.shape[0] - 1)
    args = (idx.codes_bm, idx.bucket_ids, visit, luts)
    kw = dict(k=50, coarse=coarse, steps_per_probe=idx.spp,
              lut_dtype=lut_dtype)
    ks, ki = ops.ivf_adc_topk(*args, use_kernel=True, **kw)
    ps, pi = ops.ivf_adc_topk(*args, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi.to(ki.dtype))
    assert torch.equal(ks, ps)


def _same(a, b):
    (ks, ki), (ps, pi) = a, b
    torch.cuda.synchronize()
    assert torch.equal(ki, pi.to(ki.dtype))
    assert torch.equal(ks, ps)


def _front_loaded(rng, dev, *, Q, m, per_probe=False, B=300, blk=32,
                  nprobe=8, spp=64, ksub=256, real_share=0.4):
    """Per-query inputs shaped like the engine's: each probe's first steps
    (at most real_share of them) visit real blocks, a tenth of whose slots
    are -1, and the rest the all-pad block B - 1; random tables and coarse
    terms."""
    codes = rng.integers(0, ksub, (B, blk, m)).astype(np.uint8)
    ids = np.arange(B * blk, dtype=np.int32).reshape(B, blk)
    ids[rng.random((B, blk)) < 0.1] = -1
    ids[-1] = -1
    real = rng.integers(0, int(real_share * spp) + 1, (Q, nprobe))
    j = np.arange(spp)[None, None, :]
    visit = np.where(j < real[:, :, None],
                     rng.integers(0, B - 1, (Q, nprobe, spp)), B - 1)
    shape = (Q, nprobe, m, ksub) if per_probe else (Q, m, ksub)
    luts = rng.normal(size=shape).astype(np.float32)
    coarse = rng.normal(size=(Q, nprobe)).astype(np.float32)
    t = [torch.as_tensor(x, device=dev) for x in
         (codes, ids, visit.reshape(Q, -1).astype(np.int32), luts)]
    return t, dict(coarse=torch.as_tensor(coarse, device=dev),
                   steps_per_probe=spp, pad_block=B - 1)


def _per_query_same(args, kw, rings=(None, False)):
    """The per-query kernel against its plain version, bit for bit: through
    ops with and without pad_block, and at each of ``rings`` (None: the
    plan's variant; False: the direct-read one)."""
    from repro_torch.kernels import ivf_adc as K
    want = ops.ivf_adc_topk(*args, mode="per_query", use_kernel=False, **kw)
    got = ops.ivf_adc_topk(*args, mode="per_query", use_kernel=True, **kw)
    _same(got, want)
    _same(ops.ivf_adc_topk(*args, mode="per_query", use_kernel=True,
                           **dict(kw, pad_block=None)), want)
    call = {key: kw[key] for key in ("k", "steps_per_probe", "lut_dtype",
                                     "pad_block")}
    for ring in rings:
        _same(ops.normalize_knockouts(*K._per_query_cuda(
            *args, kw["coarse"], ring=ring, **call)), want)
    return want


def test_per_query_one_real_step_among_pad():
    """Q = 1 over T = 4,096 steps (8 probes of 512), one of them real: its
    block's live slots are the answer, on either variant."""
    dev = _card()
    rng = np.random.default_rng(21)
    args, kw = _front_loaded(rng, dev, Q=1, m=64, spp=512)
    codes, ids, visit, luts = args
    visit[:] = kw["pad_block"]
    visit[0, 3 * 512 + 5] = 17
    for k in (1, 32):
        kw.update(k=k, lut_dtype="float32")
        s, i = _per_query_same(args, kw)
        live = ids[17][ids[17] >= 0]
        assert set(i[0][i[0] >= 0].tolist()) <= set(live.tolist())
        assert int((i[0] >= 0).sum()) == min(k, live.numel())


def test_per_query_all_pad_and_knocked_out_queries():
    """A query that visits only the pad block and one whose every probe is
    knocked out come back all (-inf, -1); the others as the plain version
    gives them."""
    dev = _card()
    rng = np.random.default_rng(22)
    for per_probe in (False, True):
        args, kw = _front_loaded(rng, dev, Q=5, m=64, per_probe=per_probe)
        args[2][1] = kw["pad_block"]
        kw["coarse"][3] = -1e30
        kw.update(k=32, lut_dtype="float32")
        s, i = _per_query_same(args, kw)
        assert bool(torch.isneginf(s[[1, 3]]).all())
        assert bool((i[[1, 3]] == -1).all())


@pytest.mark.parametrize("k", [1, 256])
@pytest.mark.parametrize("Q", [1, 37, 600])
def test_per_query_k_edges(Q, k):
    """k = 1 and k = 256 (the largest board) at one query (128 chunks), a
    few (several chunks a query) and more queries than a wave of blocks
    (one chunk a query)."""
    dev = _card()
    rng = np.random.default_rng(23)
    args, kw = _front_loaded(rng, dev, Q=Q, m=64)
    kw["coarse"][0, 2] = -1e30
    kw.update(k=k, lut_dtype="float32")
    _per_query_same(args, kw)


def test_per_query_widest_table_reads_codes_directly():
    """m = 210 float32 tables at k = 256, the widest the grid took before
    this design: the code ring does not fit beside the table, so the plan
    takes the direct-read variant, which still equals the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ivf_adc as K
    dev = _card()
    rng = np.random.default_rng(24)
    assert not K.query_plan(3, 512, 64, False, 210, 256, 32, 256, "float32",
                            _build.card(dev))["ring"]
    for per_probe in (False, True):
        args, kw = _front_loaded(rng, dev, Q=3, m=210, per_probe=per_probe)
        kw.update(k=256, lut_dtype="float32")
        _per_query_same(args, kw, rings=(None,))


@pytest.mark.parametrize("blk,m", [(32, 7), (8, 7), (6, 8), (12, 5)])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
def test_per_query_byte_path(lut_dtype, blk, m):
    """Code rows read by bytes (m = 7, 5) from a 16-byte-copied ring
    (blk * m % 16 == 0) or from a byte-copied one, and words from a
    byte-copied ring (blk = 6)."""
    dev = _card()
    rng = np.random.default_rng(25)
    for per_probe in (False, True):
        args, kw = _front_loaded(rng, dev, Q=9, m=m, blk=blk,
                                 per_probe=per_probe)
        kw.update(k=32, lut_dtype=lut_dtype)
        _per_query_same(args, kw)


@pytest.mark.parametrize("m", [64, 16, 8])
@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
def test_per_query_table_types(lut_dtype, per_probe, m):
    """Shared and per-probe (l2) tables in float32, bf16 and int8, swizzled
    16-byte code reads (m = 64, 16) and words (m = 8), on both variants."""
    dev = _card()
    rng = np.random.default_rng(26)
    args, kw = _front_loaded(rng, dev, Q=33, m=m, per_probe=per_probe)
    kw["coarse"][4, 0] = -1e30
    kw.update(k=40, lut_dtype=lut_dtype)
    _per_query_same(args, kw)


def test_per_query_counts_one_launch_a_call():
    """The ivf_adc counter counts each per-query call once, whatever its
    chunks and merge levels, and nothing else moves it."""
    from repro_torch.kernels import ivf_adc as K
    dev = _card()
    rng = np.random.default_rng(27)
    args, kw = _front_loaded(rng, dev, Q=2, m=16)
    kw.update(k=10, lut_dtype="float32")
    ops.reset_launch_counts()
    ops.ivf_adc_topk(*args, mode="per_query", **kw)
    assert ops.launch_counts()["ivf_adc"] == 1
    call = {key: kw[key] for key in ("k", "steps_per_probe", "lut_dtype")}
    K.ivf_adc_cuda(*args, kw["coarse"], **call)
    K.ivf_adc_cuda(*args, kw["coarse"], **call)
    assert ops.launch_counts()["ivf_adc"] == 3
    ops.ivf_adc_topk(*args, mode="per_query", use_kernel=False, **kw)
    ops.ivf_adc_topk(*args, mode="blocked", qblk=8, **kw)
    counts = ops.launch_counts()
    assert counts["ivf_adc"] == 3 and counts["ivf_adc_blocked"] == 1


def test_per_query_walks_only_the_real_steps():
    """With pad_block the kernel scores, a query, exactly the steps that are
    neither on the pad block nor in a knocked-out probe; without it, every
    step of the live probes."""
    from repro_torch.kernels import ivf_adc as K
    dev = _card()
    rng = np.random.default_rng(28)
    for per_probe in (False, True):
        args, kw = _front_loaded(rng, dev, Q=40, m=64, spp=512,
                                 per_probe=per_probe)
        kw["coarse"][2] = -1e30
        kw["coarse"][5, 3] = -1e30
        visit, coarse, spp = args[2], kw["coarse"], kw["steps_per_probe"]
        live = torch.repeat_interleave(coarse > -5e29, spp, dim=1)
        call = dict(k=32, steps_per_probe=spp, lut_dtype="float32")
        for pad, want in ((kw["pad_block"],
                           (live & (visit != kw["pad_block"])).sum(1)),
                          (None, live.sum(1))):
            walked = torch.zeros(40, dtype=torch.int32, device=dev)
            K._per_query_cuda(*args, coarse, pad_block=pad, walked=walked,
                              **call)
            torch.cuda.synchronize()
            assert torch.equal(walked.long(), want)


def test_per_query_shared_memory_matches_the_kernel():
    """query_smem_bytes (Python) equals the kernel's own count (C), which
    carves the block, for the ring and the direct-read variants."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ivf_adc as K
    _card()
    lib = _build.load("ivf_adc", K._SIGNATURES)
    for dt_i, dt in enumerate(K.LUT_DTYPES):
        for m, ksub, blk in ((64, 256, 32), (7, 32, 8), (210, 256, 32),
                             (3, 5, 6)):
            for k in (1, 32, 33, 256):
                for ring in (True, False):
                    assert lib.ivf_adc_query_smem(dt_i, m, ksub, blk, k,
                                                  int(ring)) == \
                        K.query_smem_bytes(dt, m, ksub, blk, k, ring)


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("Q,k", [(1, 10), (7, 200), (40, 32)])
def test_pq_adc_kernel_matches_plain(lut_dtype, Q, k):
    """Random codes, a tenth of the rows knocked out, duplicated rows (their
    scores tie and go to the lower id): the kernel equals its plain
    version bit for bit, through ops.adc_topk."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(Q * 1000 + k)
    codes = torch.randint(0, 256, (50_003, 64), generator=g, device=dev,
                          dtype=torch.uint8)
    codes[-300:] = codes[:300]
    luts = torch.randn(Q, 64, 256, generator=g, device=dev)
    valid = torch.rand(codes.shape[0], generator=g, device=dev) >= 0.1
    kw = dict(k=k, valid=valid, lut_dtype=lut_dtype)
    ops.reset_launch_counts()
    got = ops.adc_topk(codes, luts, **kw)
    assert ops.launch_counts()["pq_adc"] == 1
    _same(got, ops.adc_topk(codes, luts, use_kernel=False, **kw))
    assert bool(valid[got[1][got[1] >= 0].long()].all())


@pytest.mark.parametrize("lut_dtype", ["float32", "int8"])
def test_pq_adc_wide_extra_row_matches_plain(lut_dtype):
    """scan_all's shape: m = 16 uint8 subspaces padded to W = 3001 > 256,
    and an int32 extra column whose table row the kernel reads from device
    memory."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    N, m, W, Q = 20_000, 16, 3001, 9
    codes = torch.randint(0, 256, (N, m), generator=g, device=dev,
                          dtype=torch.uint8)
    extra = torch.randint(0, W, (N,), generator=g, device=dev,
                          dtype=torch.int32)
    luts = torch.randn(Q, m + 1, W, generator=g, device=dev)
    kw = dict(k=50, extra_codes=extra, lut_dtype=lut_dtype)
    _same(ops.adc_topk(codes, luts, **kw),
          ops.adc_topk(codes, luts, use_kernel=False, **kw))


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m", [8, 64, 7])
def test_pq_adc_every_query_tile_matches_plain(lut_dtype, m):
    """At Q in {1, 2, 3, 9, 33, 512} and k in {1, 32, 256}, on a ragged N
    with duplicated rows and a tenth knocked out, the kernel at the plan's
    query tile and at every other tile that fits equals its plain version
    bit for bit (m = 7 stages its codes byte by byte, m = 8 one partial
    slab, m = 64 two full ones)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc import (QTS, fit_qt, plan, pq_adc_cuda,
                                            pq_adc_plain)
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(m * 31 + len(lut_dtype))
    N = 20_011
    codes = torch.randint(0, 256, (N, m), generator=g, device=dev,
                          dtype=torch.uint8)
    codes[-200:] = codes[:200]
    bias = torch.where(torch.rand(N, generator=g, device=dev) >= 0.1, 0.0,
                       -1e30).float()
    card = _build.card(dev)
    for Q in (1, 2, 3, 9, 33, 512):
        luts = torch.randn(Q, m, 256, generator=g, device=dev)
        for k in (1, 32, 256):
            want = pq_adc_plain(codes, luts, bias, k=k, lut_dtype=lut_dtype)
            top = fit_qt(m, 256, k, lut_dtype, 0, card)
            chosen = plan(N, Q, m, 256, k, lut_dtype, 0, card)["qt"]
            for qt in [t for t in QTS if t <= top and t <= Q] + [None]:
                ops.reset_launch_counts()
                got = pq_adc_cuda(codes, luts, bias, k=k, lut_dtype=lut_dtype,
                                  qt=qt)
                assert ops.launch_counts()["pq_adc"] == 1
                torch.cuda.synchronize()
                assert torch.equal(got[1], want[1]), (Q, k, qt, chosen)
                assert torch.equal(got[0], want[0]), (Q, k, qt, chosen)


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
def test_pq_adc_wide_extra_every_query_tile(lut_dtype):
    """scan_all's shape at m = 64 (W = 2973 > 256, an int32 extra column
    read from device memory) at every query tile that fits, Q = 33."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc import (QTS, fit_qt, pq_adc_cuda,
                                            pq_adc_plain)
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    N, m, W, Q = 30_001, 64, 2973, 33
    codes = torch.randint(0, 256, (N, m), generator=g, device=dev,
                          dtype=torch.uint8)
    extra = torch.randint(0, W, (N,), generator=g, device=dev,
                          dtype=torch.int32)
    luts = torch.randn(Q, m + 1, W, generator=g, device=dev)
    valid = torch.rand(N, generator=g, device=dev) >= 0.1
    bias = torch.where(valid, 0.0, -1e30).float()
    want = pq_adc_plain(codes, luts, bias, k=32, extra=extra,
                        lut_dtype=lut_dtype)
    top = fit_qt(m, W, 32, lut_dtype, 1, _build.card(dev))
    for qt in [t for t in QTS if t <= top] + [None]:
        got = pq_adc_cuda(codes, luts, bias, k=32, extra=extra,
                          lut_dtype=lut_dtype, qt=qt)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), qt
        assert torch.equal(got[0], want[0]), qt


def test_plan_shared_memory_matches_the_kernels():
    """The plans' shared-memory formulas (Python) equal the kernels' own
    (C), which carve the blocks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import hamming as H
    from repro_torch.kernels import pq_adc as P
    _card()
    lib = _build.load("pq_adc", P._SIGNATURES)
    for dt_i, dt in enumerate(P.LUT_DTYPES):
        for qt in P.QTS:
            for m, W, extra in ((64, 256, 0), (7, 16, 0), (64, 2973, 1)):
                for k, stages in ((1, 2), (32, 3), (256, 2)):
                    assert lib.pq_adc_smem(dt_i, qt, m, extra, W, k, stages) \
                        == P.smem_bytes(dt, qt, m, extra, W, k, stages)
    hl = _build.load("hamming", H._SIGNATURES)
    for qt in (1, 9, 32):
        for L in (1, 64, 256):
            for tw in (1, 16, 32):
                assert hl.hamming_shortlist_smem(qt, L, tw) == \
                    H.shortlist_smem(qt, L, tw)


def _probe_inputs(db, q):
    idx = db.index
    metric = "dot" if idx.metric == "cosine" else idx.metric
    if idx.metric == "cosine":
        q = D.l2_normalize(q)
    visit, luts, coarse, _ = _ivf_probe_stage(
        idx.codebooks, idx.centroids, q, idx.block_table, metric=metric,
        nprobe=idx.nprobe, steps_per_probe=idx.spp,
        pad_block=idx.bucket_ids.shape[0] - 1)
    return (idx.codes_bm, idx.bucket_ids, visit, luts), dict(
        coarse=coarse, steps_per_probe=idx.spp,
        pad_block=idx.bucket_ids.shape[0] - 1)


@pytest.mark.parametrize("mode,qblk", [("blocked", 8), ("blocked", 4),
                                       ("run_resident", 8),
                                       ("run_resident", 16)])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_grouped_kernels_match_plain_and_per_query(metric, lut_dtype, mode,
                                                  qblk):
    """Each grouped kernel equals its plain version and the per-query
    kernel bit for bit, on the inputs the engine builds (shared tables for
    dot, per-probe tables for l2, a knocked-out probe)."""
    dev = _card()
    rng = np.random.default_rng(2)
    centres = rng.normal(size=(30, 64)).astype(np.float32)
    corpus = centres[rng.integers(0, 30, 20_000)] + rng.normal(
        size=(20_000, 64)).astype(np.float32)
    db = VectorDB("ivf_pq", metric=metric, m=16, refine=0, nprobe=6,
                  device=dev).load(corpus)
    args, kw = _probe_inputs(db, torch.as_tensor(corpus[:45], device=dev))
    kw["coarse"][3, 1] = -1e30
    kw.update(k=40, lut_dtype=lut_dtype)
    ops.reset_launch_counts()
    got = ops.ivf_adc_topk(*args, mode=mode, qblk=qblk, use_kernel=True, **kw)
    assert ops.launch_counts()[f"ivf_adc_{mode}"] == 1
    _same(got, ops.ivf_adc_topk(*args, mode=mode, qblk=qblk,
                                use_kernel=False, **kw))
    _same(got, ops.ivf_adc_topk(*args, mode="per_query", use_kernel=True,
                                **kw))


def _grouped_problem(rng, dev, *, Q, m, per_probe, B=400, blk=32, nprobe=4,
                     spp=16, ksub=256, pad_share=0.3):
    """Synthetic grouped-grid inputs: random codes (a tenth of the slots
    -1), a (Q, nprobe * spp) visit table over B - 1 blocks with a share of
    pad visits (block B - 1, all -1), random tables and coarse terms."""
    codes = rng.integers(0, ksub, (B, blk, m)).astype(np.uint8)
    ids = np.arange(B * blk, dtype=np.int32).reshape(B, blk)
    ids[rng.random((B, blk)) < 0.1] = -1
    ids[-1] = -1
    T = nprobe * spp
    visit = rng.integers(0, B - 1, (Q, T)).astype(np.int32)
    visit[rng.random((Q, T)) < pad_share] = B - 1
    shape = (Q, nprobe, m, ksub) if per_probe else (Q, m, ksub)
    luts = rng.normal(size=shape).astype(np.float32)
    coarse = rng.normal(size=(Q, nprobe)).astype(np.float32)
    t = [torch.as_tensor(x, device=dev) for x in (codes, ids, visit, luts)]
    return t, dict(coarse=torch.as_tensor(coarse, device=dev),
                   steps_per_probe=spp, pad_block=B - 1)


def _grouped_same(args, kw, mode, qblk):
    """A grouped kernel against its plain version and the per-query
    kernel, bit for bit."""
    got = ops.ivf_adc_topk(*args, mode=mode, qblk=qblk, use_kernel=True, **kw)
    _same(got, ops.ivf_adc_topk(*args, mode=mode, qblk=qblk,
                                use_kernel=False, **kw))
    _same(got, ops.ivf_adc_topk(*args, mode="per_query", use_kernel=True,
                                **kw))


@pytest.mark.parametrize("k", [1, 32, 256])
@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("m", [64, 8, 7])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
def test_grouped_kernels_at_the_tile_edges(lut_dtype, m, per_probe, k):
    """Q one below, at and one above the plan's tile width (table rows a
    block) and the widest that fits, at the plan's width and forced to the
    widest (a ragged last tile), qblk 4, 8, 16, both grids, against the
    plain versions and the per-query kernel: m = 64 streams swizzled
    16-byte chunks, m = 8 reads words, m = 7 bytes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ivf_adc as K
    dev = _card()
    rng = np.random.default_rng(5)
    nprobe, spp = 4, 16
    card = _build.card(dev)
    cw = 1 if per_probe else nprobe
    top = K.fit_tile(m, 256, 32, k, lut_dtype, card, cw)
    width = K.plan_width(m, 256, 32, k, lut_dtype, card, cw)
    grids = ((False, K.ivf_adc_blocked_plain),
             (True, K.ivf_adc_run_resident_plain))
    for Q in sorted({max(1, w + d) for w in (width, top) for d in (-1, 0, 1)}):
        args, kw = _grouped_problem(rng, dev, Q=Q, m=m, per_probe=per_probe,
                                    nprobe=nprobe, spp=spp)
        kw["coarse"][0, 1] = -1e30
        codes, ids, visit, luts = args
        call = dict(k=k, steps_per_probe=spp, lut_dtype=lut_dtype)
        want = ops.ivf_adc_topk(*args, mode="per_query", use_kernel=True,
                                **kw, k=k, lut_dtype=lut_dtype)
        for qblk in (4, 8, 16):
            sched = ops.build_schedule(visit, qblk=qblk,
                                       pad_block=kw["pad_block"])
            for runs, plain in grids:
                ref = ops.normalize_knockouts(*plain(
                    codes, ids, visit, sched, luts, kw["coarse"], **call))
                _same(ref, want)
                for qt in (None, top):
                    got = ops.normalize_knockouts(*K._grouped_cuda(
                        codes, ids, visit, sched, luts, kw["coarse"],
                        runs=runs, qt=qt, **call))
                    _same(got, ref)


@pytest.mark.parametrize("blk,m", [(8, 7), (6, 8), (12, 5)])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
def test_grouped_kernels_byte_staged_blocks(lut_dtype, blk, m):
    """Blocks whose codes are not a whole number of 16-byte chunks, or
    whose slot ids are not (blk % 4), are staged byte by byte."""
    dev = _card()
    rng = np.random.default_rng(9)
    for per_probe in (False, True):
        args, kw = _grouped_problem(rng, dev, Q=10, m=m, blk=blk,
                                    per_probe=per_probe)
        kw.update(k=32, lut_dtype=lut_dtype)
        for mode in ("blocked", "run_resident"):
            _grouped_same(args, kw, mode, 8)


@pytest.mark.parametrize("mode", ["blocked", "run_resident"])
def test_grouped_kernels_empty_tiles_and_knocked_out_queries(mode):
    """A tile with no scheduled pair (its queries visit only the pad
    block), a query whose every probe is knocked out, and an adaptive
    probe mask (steps of dropped probes to the pad block, their coarse
    term NEG_INF; probe 0 kept)."""
    dev = _card()
    rng = np.random.default_rng(6)
    for per_probe in (False, True):
        args, kw = _grouped_problem(rng, dev, Q=24, m=64,
                                    per_probe=per_probe)
        codes, ids, visit, luts = args
        visit[:6] = ids.shape[0] - 1          # tiles 0 (and 1): no pair
        kw["coarse"][9] = -1e30               # every probe knocked out
        drop = torch.as_tensor(rng.random((24, 4)) < 0.5, device=dev)
        drop[:, 0] = False
        visit[torch.repeat_interleave(drop, 16, dim=1)] = ids.shape[0] - 1
        kw["coarse"][drop] = -1e30
        kw.update(k=32, lut_dtype="float32")
        _grouped_same((codes, ids, visit, luts), kw, mode, 8)
        s, i = ops.ivf_adc_topk(codes, ids, visit, luts, mode=mode, qblk=8,
                                use_kernel=True, **kw)
        assert bool(torch.isneginf(s[:6]).all()) and bool((i[9] == -1).all())


def test_grouped_engine_adaptive_nprobe_on_the_card():
    """ivf_pq with adaptive probing answers the same under every grid."""
    dev = _card()
    rng = np.random.default_rng(7)
    centres = rng.normal(size=(30, 64)).astype(np.float32)
    corpus = centres[rng.integers(0, 30, 20_000)] + rng.normal(
        size=(20_000, 64)).astype(np.float32)
    q = torch.as_tensor(corpus[:33], device=dev)
    db = VectorDB("ivf_pq", metric="l2", m=16, refine=0, nprobe=6,
                  adaptive_nprobe=2.0, adc_mode="per_query",
                  device=dev).load(corpus)
    want = db.query(q, k=20)
    assert db.adc_stats["eff_nprobe_sum"] < 6
    for mode in ("blocked", "run_resident"):
        db.index.adc_mode = mode
        _same(db.query(q, k=20), want)


def test_grouped_plan_shared_memory_matches_the_kernel():
    """grouped_plan's byte count (Python) equals the kernel's tile_layout
    (C), which carves the block."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ivf_adc as K
    _card()
    lib = _build.load("ivf_adc", K._SIGNATURES)
    for dt_i, dt in enumerate(K.LUT_DTYPES):
        for qt in (1, 3, 16):
            for m, ksub, blk in ((64, 256, 32), (7, 32, 8), (8, 256, 128)):
                for k, cw in ((1, 1), (32, 8), (256, 3)):
                    assert lib.ivf_adc_grouped_smem(dt_i, qt, m, ksub, blk,
                                                    k, cw) == \
                        K.tile_smem_bytes(dt, qt, m, ksub, blk, k, cw)


def test_grouped_cuda_allocates_no_pair_buffers():
    """Once the pair index is cached with the schedule, a grouped call
    allocates only its chunk boards and result: less than the (Q, T) pair
    map or the (G, qblk, blk) pair scores of a design that writes every
    pair's scores out."""
    from repro_torch.kernels import ivf_adc as K
    dev = _card()
    rng = np.random.default_rng(8)
    args, kw = _grouped_problem(rng, dev, Q=64, m=16, per_probe=False,
                                B=3000, nprobe=8, spp=256)
    codes, ids, visit, luts = args
    sched = ops.build_schedule(visit, qblk=8, pad_block=kw["pad_block"])
    G, qblk = sched["sq"].shape
    call = dict(k=4, steps_per_probe=kw["steps_per_probe"])
    for fn in (K.ivf_adc_blocked_cuda, K.ivf_adc_run_resident_cuda):
        fn(codes, ids, visit, sched, luts, kw["coarse"], **call)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(codes, ids, visit, sched, luts, kw["coarse"], **call)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert extra < min(visit.numel() * 4, G * qblk * ids.shape[1] * 4), \
            extra


def test_engines_launch_their_kernels_on_the_card():
    """VectorDB("pq") runs pq_adc; ivf_pq under each forced grid runs that
    grid's kernel and answers the same."""
    dev = _card()
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(8_000, 32)).astype(np.float32)
    q = torch.as_tensor(corpus[:20], device=dev)
    ops.reset_launch_counts()
    VectorDB("pq", m=8, device=dev).load(corpus).query(q, k=10)
    assert ops.launch_counts()["pq_adc"] == 1
    db = VectorDB("ivf_pq", m=8, adc_mode="per_query", device=dev).load(corpus)
    want = db.query(q, k=10)
    for mode in ("blocked", "run_resident"):
        db.index.adc_mode = mode
        ops.reset_launch_counts()
        _same(db.query(q, k=10), want)
        assert ops.launch_counts()[f"ivf_adc_{mode}"] == 1


def _words(gen, shape, dev):
    """int32 bit patterns over the full 2^32 range."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("Q", [1, 32, 512])
@pytest.mark.parametrize("T,W", [(4, 4), (8, 2), (1, 8)])
def test_hamming_kernels_match_plain(T, W, Q):
    """Both hamming entries equal their plain versions bit for bit, at
    L in {10, 64, 256}, with N not a multiple of the 256-row tile."""
    from repro_torch.kernels.hamming import (hamming_cuda, hamming_plain,
                                             hamming_shortlist_cuda,
                                             hamming_shortlist_plain)
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(T * 1000 + W * 10 + Q)
    N = 3000 + 77
    cc, qc = _words(gen, (T, N, W), dev), _words(gen, (T, Q, W), dev)
    assert torch.equal(hamming_cuda(qc, cc), hamming_plain(qc, cc))
    for L in (10, 64, 256):
        d, i = hamming_shortlist_cuda(qc, cc, L)
        pd, pi = hamming_shortlist_plain(qc, cc, L)
        assert torch.equal(d, pd) and torch.equal(i, pi), L


def test_hamming_shortlist_kernel_heavy_ties():
    """Codes of four distinct values: hundreds of rows share each distance,
    and the kernel's boards keep the plain version's lower row ids."""
    from repro_torch.kernels.hamming import (hamming_shortlist_cuda,
                                             hamming_shortlist_plain)
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    distinct = _words(gen, (4, 4, 4), dev)
    pick = torch.randint(0, 4, (5000,), generator=gen, device=dev)
    cc = distinct[:, pick].contiguous()
    qc = torch.cat([distinct[:, :2], _words(gen, (4, 40, 4), dev)], dim=1)
    for L in (10, 64, 256):
        d, i = hamming_shortlist_cuda(qc, cc, L)
        pd, pi = hamming_shortlist_plain(qc, cc, L)
        assert torch.equal(d, pd) and torch.equal(i, pi), L


@pytest.mark.parametrize("L", [1, 64, 256])
def test_hamming_shortlist_ties_straddle_the_threshold(L):
    """Codes of six distinct values over 150,011 rows: thousands of rows
    share each distance, so ties straddle every query's threshold across
    tiles and chunks; at Q in {1, 8, 9, 32, 33, 512} the kernel, at the
    plan's query tile and at tiles of up to 32, keeps the plain version's
    lower row ids, bit for bit."""
    from repro_torch.kernels.hamming import (hamming_shortlist_cuda,
                                             hamming_shortlist_plain)
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7 + L)
    distinct = _words(gen, (4, 6, 4), dev)
    N = 150_011
    pick = torch.randint(0, 6, (N,), generator=gen, device=dev)
    cc = distinct[:, pick].contiguous()
    for Q in (1, 8, 9, 32, 33, 512):
        qc = torch.cat([distinct, _words(gen, (4, Q, 4), dev)], dim=1)[:, :Q]
        qc = qc.contiguous()
        pd, pi = hamming_shortlist_plain(qc, cc, L)
        for qt in (None, 32):
            d, i = hamming_shortlist_cuda(qc, cc, L, qt)
            torch.cuda.synchronize()
            assert torch.equal(d, pd) and torch.equal(i, pi), (Q, L, qt)


def test_lsh_engine_launches_hamming_on_the_card():
    """VectorDB("lsh") ranks through the shortlist kernel, and its answer
    equals the plain path's."""
    from repro_torch.core.lsh import lsh_search
    dev = _card()
    rng = np.random.default_rng(6)
    corpus = rng.normal(size=(9_000, 48)).astype(np.float32)
    q = torch.as_tensor(corpus[:33] + 0.01, device=dev)
    db = VectorDB("lsh", device=dev).load(corpus)
    ops.reset_launch_counts()
    got = db.query(q, k=10, bucketize=False)
    assert ops.launch_counts()["hamming"] == 1
    idx = db.index
    _same(got, lsh_search(idx.corpus, idx.codes, idx.planes, q,
                          metric="cosine", k=10, shortlist=idx.shortlist,
                          use_kernel=False))


FLASH_GPU_CASES = [
    # (B, Sq, Sk, H, KV, dh, causal, masked)
    (2, 128, 128, 1, 1, 64, True, False),
    (3, 128, 128, 1, 1, 32, False, False),
    (2, 192, 192, 1, 1, 64, True, False),
    (1, 64, 64, 1, 1, 80, False, False),
    (6, 64, 64, 12, 12, 64, False, True),
    (3, 512, 512, 12, 12, 64, False, True),
    (3, 128, 128, 8, 2, 64, True, True),
    (2, 200, 200, 4, 4, 80, True, True),
    (2, 200, 200, 4, 4, 80, False, True),
    (2, 70, 130, 2, 1, 256, False, True),
    (2, 33, 17, 2, 2, 16, True, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh,causal,masked", FLASH_GPU_CASES)
def test_flash_attention_kernel_matches_plain(B, Sq, Sk, H, KV, dh, causal,
                                              masked, dtype):
    """The kernel against its plain version at the reference's tolerances
    (2e-5 float32, 2e-2 bfloat16): ragged lengths, a fully masked row
    (the mean of v), GQA, partial tiles and dh from 16 to 256."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(B * Sq + dh + H)
    q = torch.randn(B, Sq, H, dh, generator=gen, device=dev).to(dt)
    k = torch.randn(B, Sk, KV, dh, generator=gen, device=dev).to(dt)
    v = torch.randn(B, Sk, KV, dh, generator=gen, device=dev).to(dt)
    mask = None
    if masked:
        lengths = torch.randint(1, Sk + 1, (B,), generator=gen, device=dev)
        lengths[-1] = 0
        mask = torch.arange(Sk, device=dev)[None, :] < lengths[:, None]
    kw = dict(causal=causal, scale=dh ** -0.5, kv_mask=mask)
    ops.reset_launch_counts()
    got = flash_attention_cuda(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, **kw)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


FLASH_WINDOW_CASES = [
    # (B, S, H, KV, dh, causal, window, mask): mask "ragged" (lengths
    # 1..S, the last row empty) or "hole" (keys S/3..2S/3 padded: the rows
    # whose window lies inside the hole are fully masked there)
    (2, 200, 4, 2, 64, True, 1, "ragged"),
    (2, 200, 4, 2, 64, False, 1, None),
    (2, 333, 4, 4, 64, True, 17, "hole"),
    (2, 333, 4, 4, 64, False, 17, "hole"),
    (3, 257, 2, 1, 32, True, 64, "ragged"),
    (3, 257, 2, 1, 32, False, 64, None),
    (2, 130, 2, 2, 16, True, 129, "hole"),
    (2, 130, 2, 2, 16, False, 129, "ragged"),
    (1, 300, 32, 8, 80, True, 64, "hole"),
    (1, 520, 16, 16, 192, True, 100, "ragged"),
    (1, 520, 16, 16, 192, False, None, "hole"),
    (1, 96, 16, 16, 192, True, None, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,causal,window,mask",
                         FLASH_WINDOW_CASES)
def test_flash_attention_window_matches_plain(B, S, H, KV, dh, causal,
                                              window, mask, dtype):
    """The sliding window (W in {1, 17, 64, S - 1, 100}) on ragged S,
    causal and not, with key-padding masks that leave rows fully masked
    inside their window (they average v over all S keys, the skipped
    tiles included), danube's heads (32/8, dh 80) and MLA's (16, dh
    192), against the plain version at 2e-5 / 2e-2."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(B * S + dh + (window or 0))
    q = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, KV, dh, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, KV, dh, generator=gen, device=dev).to(dt)
    kv_mask = None
    if mask == "ragged":
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lengths[-1] = 0
        kv_mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    elif mask == "hole":
        pos = torch.arange(S, device=dev)
        kv_mask = ((pos < S // 3) | (pos >= 2 * S // 3))[None].repeat(B, 1)
    kw = dict(causal=causal, scale=dh ** -0.5, kv_mask=kv_mask, window=window)
    ops.reset_launch_counts()
    got = flash_attention_cuda(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, **kw)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_limits_on_the_card():
    """dh outside the kernel's range and a window below one key raise on
    CUDA tensors; nothing falls back to the plain version. A window of
    one or more keys launches."""
    dev = _card()
    x = torch.zeros((1, 8, 2, 72), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="256"):
        ops.flash_attention(x, x, x, causal=False)
    y = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(y, y, y, causal=True, window=0)
    ops.reset_launch_counts()
    ops.flash_attention(y, y, y, causal=True, window=4)
    assert ops.launch_counts()["flash_attention"] == 1


def test_encode_ignores_the_callers_bf16_reduction_flag():
    """encode turns cuBLAS's reduced-precision bf16 reductions off itself:
    under PyTorch's default (on) it equals encode with the flag off, and
    the caller's setting is back afterwards."""
    import dataclasses

    from repro_torch.configs import thistle_sbert
    from repro_torch.models import encoder
    dev = _card()
    cfg = dataclasses.replace(thistle_sbert.SMOKE, n_layers=2)
    model = encoder.init(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(2, cfg.vocab_size, (16, 64), generator=gen,
                           device=dev)
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    try:
        mm.allow_bf16_reduced_precision_reduction = False
        want = encoder.encode(model, cfg, tokens, tokens != 0)
        mm.allow_bf16_reduced_precision_reduction = True
        got = encoder.encode(model, cfg, tokens, tokens != 0)
        assert mm.allow_bf16_reduced_precision_reduction is True
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev
    assert torch.equal(got, want)


def test_encoder_launches_flash_attention_on_the_card():
    """encode on the card runs the kernel once a layer and agrees row by
    row with the same forward through the plain attention."""
    import dataclasses

    from repro_torch.configs import thistle_sbert
    from repro_torch.models import encoder
    dev = _card()
    cfg = dataclasses.replace(thistle_sbert.SMOKE, n_layers=3)
    model = encoder.init(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(2, cfg.vocab_size, (9, 48), generator=gen, device=dev)
    lengths = torch.tensor([48, 1, 2, 30, 47, 5, 16, 33, 0], device=dev)
    mask = torch.arange(48, device=dev)[None, :] < lengths[:, None]
    tokens = torch.where(mask, tokens, 0)
    ops.reset_launch_counts()
    got = encoder.encode(model, cfg, tokens, mask)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want = encoder.encode(model, cfg, tokens, mask, use_kernel=False)
    cos = (got * want).sum(-1)
    assert bool((cos[:-1] >= 0.999).all()), cos
    assert bool((got[-1] == 0).all()) and bool((want[-1] == 0).all())


# ------------------------------------------------------ mutated layouts
def _mutated_ivf(dev, stage, metric="dot"):
    """An ivf_pq engine on the card after writes: ``tombstoned`` (a third
    of the rows deleted, slots in the middle of blocks), ``spilled``
    (inserts that fill tail blocks and open new ones, upserts that move
    rows), ``grown`` (inserts past the storage capacity: the pad block
    moves, and past steps_per_probe), ``compacted`` (then compact)."""
    rng = np.random.default_rng(6)
    centres = rng.normal(size=(24, 64)).astype(np.float32)

    def rows(n):
        return centres[rng.integers(0, 24, n)] + rng.normal(
            size=(n, 64)).astype(np.float32)

    db = VectorDB("ivf_pq", metric=metric, m=16, refine=0, nprobe=6,
                  compact_threshold=None, device=dev).load(rows(20_000))
    lay = db.index.layout
    cap, spp = lay.capacity, lay.steps_per_probe
    db.delete(torch.arange(0, 20_000, 3, device=dev))
    if stage in ("spilled", "grown", "compacted"):
        db.insert(rows(3_000))
        db.upsert(rows(500), torch.arange(1, 1_000, 2, device=dev))
    if stage in ("grown", "compacted"):
        while lay.capacity == cap or lay.steps_per_probe == spp:
            db.insert(rows(20_000))
            lay = db.index.layout
    if stage == "compacted":
        db.compact()
    return db, rows


@pytest.mark.parametrize("stage", ["tombstoned", "spilled", "grown",
                                   "compacted"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_every_grid_on_a_mutated_layout(stage, metric):
    """On tombstoned, spilled, grown and compacted layouts each ivf_adc
    grid equals its plain version bit for bit, the grouped ones also the
    per-query kernel, no deleted id comes back, and the per-query kernel
    scores exactly the real (non-pad) steps."""
    from repro_torch.kernels import ivf_adc as K
    dev = _card()
    db, rows = _mutated_ivf(dev, stage, metric)
    q = torch.as_tensor(rows(37), device=dev)
    args, kw = _probe_inputs(db, q)
    kw.update(k=50, lut_dtype="float32")
    dead = ~db.index.layout.live_mask(db.index.n)
    for mode in ("per_query", "blocked", "run_resident"):
        got = ops.ivf_adc_topk(*args, mode=mode, use_kernel=True, **kw)
        _same(got, ops.ivf_adc_topk(*args, mode=mode, use_kernel=False, **kw))
        if mode != "per_query":
            _same(got, ops.ivf_adc_topk(*args, mode="per_query",
                                        use_kernel=True, **kw))
        ids = got[1][got[1] >= 0].long()
        assert not bool(dead[ids].any()), mode
    codes, slots, visit, luts = args
    walked = torch.zeros(visit.shape[0], dtype=torch.int32, device=dev)
    K._per_query_cuda(codes, slots, visit, luts, kw["coarse"], k=50,
                      steps_per_probe=kw["steps_per_probe"],
                      lut_dtype="float32", pad_block=kw["pad_block"],
                      walked=walked)
    real = (visit != kw["pad_block"]).sum(1)
    assert torch.equal(walked.long(), real)


def test_mutated_flat_and_pq_kernels_match_plain():
    """flat (float32 and bf16) and pq after inserts, deletes and upserts:
    the kernel path equals the plain path on the engines' own buffers."""
    dev = _card()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(9_000, 64)).astype(np.float32)
    q = torch.as_tensor(x[:33] + 0.01, device=dev)
    for engine, kw in (("flat", {}), ("flat", {"dtype": torch.bfloat16}),
                       ("pq", {"m": 16})):
        db = VectorDB(engine, metric="l2", device=dev, **kw).load(x[:8_000])
        db.insert(x[8_000:])
        db.delete(torch.arange(0, 9_000, 4, device=dev))
        db.upsert(x[:100] * 0.5, torch.arange(100, 200, device=dev))
        idx = db.index
        idx._sync()
        if engine == "flat":
            kk = dict(k=20, metric="l2", corpus_sq=idx.corpus_sq,
                      valid=idx.valid)
            got = ops.topk_distance(idx.corpus, q.to(idx.corpus.dtype),
                                    use_kernel=True, **kk)
            want = ops.topk_distance(idx.corpus, q.to(idx.corpus.dtype),
                                     use_kernel=False, **kk)
            torch.cuda.synchronize()
            assert bool(idx.valid[got[1].long()].all())
            assert (got[1] == want[1]).float().mean() > 0.99
        else:
            from repro_torch.core.pq import adc_tables
            luts = adc_tables(idx.codebooks, q, metric="l2")
            got = ops.adc_topk(idx.codes, luts, k=20, valid=idx.valid,
                               use_kernel=True)
            _same(got, ops.adc_topk(idx.codes, luts, k=20, valid=idx.valid,
                                    use_kernel=False))
            assert bool(idx.valid[got[1].long()].all())


def test_async_front_completes_through_the_copy_event(monkeypatch):
    """On the card the batcher issues each batch's copy into pinned host
    memory on its own stream; the completer waits on that copy's event
    and never synchronizes the device. Results equal the pump's."""
    import threading
    from repro_torch.serve import AsyncQueryEngine, QueryEngine
    dev = _card()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(30_000, 64)).astype(np.float32)
    db = VectorDB("ivf_pq", m=16, device=dev).load(x)
    qs = x[:200] + 0.01 * rng.normal(size=(200, 64)).astype(np.float32)
    pump = QueryEngine(db, max_batch=16)
    rids = [pump.submit(q, 10) for q in qs]
    pump.drain()
    synced = []
    real_sync = torch.cuda.synchronize

    def sync(*a, **k):
        synced.append(threading.current_thread().name)
        return real_sync(*a, **k)

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    with AsyncQueryEngine(db, max_batch=16, max_inflight=2) as eng:
        futs = [eng.submit(q, 10) for q in qs]
        for f, rid in zip(futs, rids):
            s, i = f.result(timeout=60)
            assert i.device.type == "cpu" and s.device.type == "cpu"
            np.testing.assert_array_equal(i.numpy(), pump.result(rid)[1].numpy())
        assert eng._copy_stream is not None
    assert "serve-completer" not in synced


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_every_kernel_on_filtered_inputs(metric):
    """A predicate bitmap reaches each kernel as inputs it already takes:
    ``topk_distance`` and ``pq_adc`` through the live mask AND the bitmap,
    the three ivf_adc grids through bucket ids the bitmap rewrote to -1.
    Each kernel equals its plain version on those inputs (the ADC grids
    and pq_adc bit for bit, topk_distance within 2 d 2^-24 of the scale),
    and no id outside the bitmap comes back."""
    from repro_torch.core.pq import adc_tables
    dev = _card()
    db, rows = _mutated_ivf(dev, "spilled", metric)
    n = db.index.next_id
    g = torch.Generator(device=dev).manual_seed(3)
    allowed = torch.rand(n, generator=g, device=dev) < 0.1
    q = torch.as_tensor(rows(33), device=dev)
    args, kw = _probe_inputs(db, q)
    kw.update(k=32, lut_dtype="float32")
    for mode in ("per_query", "blocked", "run_resident"):
        got = ops.ivf_adc_topk(*args, mode=mode, use_kernel=True,
                               allowed=allowed, **kw)
        _same(got, ops.ivf_adc_topk(*args, mode=mode, use_kernel=False,
                                    allowed=allowed, **kw))
        ids = got[1][got[1] >= 0].long()
        assert bool(allowed[ids].all()), mode
    corpus = torch.as_tensor(rows(20_000), device=dev)
    fa = torch.rand(20_000, generator=g, device=dev) < 0.05
    live = torch.rand(20_000, generator=g, device=dev) >= 0.1
    kk = dict(k=20, metric=metric)
    got = ops.topk_distance(corpus, q, valid=ops.and_allowed(live, fa, 20_000),
                            use_kernel=True, **kk)
    want = ops.topk_distance(corpus, q, valid=ops.and_allowed(live, fa, 20_000),
                             use_kernel=False, **kk)
    torch.cuda.synchronize()
    assert bool((fa & live)[got[1].long()].all())
    scale = (torch.linalg.vector_norm(q, dim=1)[:, None]
             * torch.linalg.vector_norm(corpus, dim=1).max())
    assert bool(((got[0] - want[0]).abs()
                 <= 2 * 2 * 64 * 2.0 ** -24 * scale + 1e-6).all())
    assert (got[1] == want[1]).float().mean() > 0.99
    codes = torch.randint(0, 256, (20_000, 16), generator=g, device=dev,
                          dtype=torch.uint8)
    cb = torch.randn(16, 256, 4, generator=g, device=dev)
    luts = adc_tables(cb, q, metric=metric)
    got = ops.adc_topk(codes, luts, k=20, valid=live, allowed=fa,
                       use_kernel=True)
    _same(got, ops.adc_topk(codes, luts, k=20, valid=live, allowed=fa,
                            use_kernel=False))
    assert bool((fa & live)[got[1][got[1] >= 0].long()].all())


def test_restored_engines_serve_on_the_card(tmp_path):
    """A snapshot written on the card restores onto the card leaf by leaf
    (flat float32 and bf16, pq, ivf_pq with its metadata, lsh) and serves
    the saved engine's answers bit for bit, through the kernels; a durable
    ivf_pq replays its log's tail."""
    from repro_torch.search import Eq
    dev = _card()
    rng = np.random.default_rng(12)
    x = rng.normal(size=(20_000, 64)).astype(np.float32)
    q = torch.as_tensor(x[:17] + 0.01, device=dev)
    meta = {"tag": (np.arange(20_000) % 10)}
    for i, (engine, kw) in enumerate((
            ("flat", {}), ("flat", {"dtype": torch.bfloat16}),
            ("pq", {"m": 16}), ("ivf_pq", {"m": 16}), ("lsh", {}))):
        d = str(tmp_path / f"e{i}")
        db = VectorDB(engine, device=dev, **kw).load(x, meta=meta)
        durable = engine == "ivf_pq"
        db.save_index(d, 0, durable=durable)
        if durable:
            db.insert(x[:50] * 0.5, meta={"tag": [3] * 50})
            db.delete(torch.arange(0, 400, 7, device=dev))
        back = VectorDB(engine, device=dev, **kw).restore_index(
            d, durable=durable)
        ops.reset_launch_counts()
        s0, i0 = db.query(q, k=10)
        s1, i1 = back.query(q, k=10)
        assert sum(ops.launch_counts().values()) >= 2
        assert torch.equal(i0, i1) and torch.equal(s0, s1), engine
        if engine != "lsh":
            f0 = db.query(q, k=10, where=Eq("tag", 3))
            f1 = back.query(q, k=10, where=Eq("tag", 3))
            assert torch.equal(f0[1], f1[1]), engine
        if durable:
            db.wal.close()
            back.wal.close()


# ------------------------------------------------- the remaining engines
@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_int8_scan_kernel_matches_plain(metric, monkeypatch):
    """The int8 scan launches topk_distance once a chunk (a scratch budget
    of 4,097 rows: 5 chunks) and answers as its plain path, under a
    bitmap too; on the card ids equal but for near-ties."""
    from repro_torch.core import quant
    dev = _card()
    rng = np.random.default_rng(12)
    corpus = rng.normal(size=(20_000, 64)).astype(np.float32)
    q = torch.as_tensor(corpus[:33] + 0.05, device=dev)
    db = VectorDB("int8", metric=metric, device=dev).load(corpus)
    monkeypatch.setattr(quant, "SCAN_BYTES", 4097 * 4 * 64)
    allowed = torch.as_tensor(rng.random(20_000) < 0.3, device=dev)
    for a in (None, allowed):
        ops.reset_launch_counts()
        ks, ki = db.index.query(q, k=10, allowed=a)
        assert ops.launch_counts()["topk_distance"] == 5
        ps, pi = db.index.query(q, k=10, allowed=a, use_kernel=False)
        torch.cuda.synchronize()
        if a is not None:
            assert bool(a[ki.long()].all())
        qf = (D.l2_normalize(q) if metric == "cosine" else q).float()
        rows = quant.dequantize_rows(db.index.codes, db.index.scales)
        scale = (torch.linalg.vector_norm(qf, dim=1)[:, None]
                 * torch.linalg.vector_norm(rows, dim=1).max())
        f = 2 if metric == "l2" else 1
        tol = f * 2 * 64 * 2.0 ** -24 * scale + 1e-6 * ps.abs()
        assert bool(((ks - ps).abs() <= tol).all())
        # an id may differ only where its float64 score (the exact |c|^2
        # for l2, as the engine keeps it) is within 2 tol of the plain one
        r, c = torch.nonzero(ki != pi, as_tuple=True)
        i = ki[r, c].long()
        exact = (rows[i].double() * qf[r].double()).sum(1)
        if metric == "l2":
            exact = (2 * exact - db.index.corpus_sq[i].double()
                     - (qf[r].double() ** 2).sum(1))
        assert bool(((exact - ps[r, c].double()).abs()
                     <= 2 * tol[r, c].double() + 1e-6).all())


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_graph_build_and_entry_scan_kernel_match_plain(metric):
    """The graph build through the kernel gives the plain build's table
    (a sampled build: 6,000 rows, 1,024-row samples) but where a
    neighbor is a near-tie; the engine's beam search through the kernel
    gives the plain path's answers."""
    from repro_torch.core.graph import build_knn_graph
    dev = _card()
    rng = np.random.default_rng(13)
    corpus = torch.as_tensor(rng.normal(size=(6_000, 64)).astype(np.float32),
                             device=dev)
    kw = dict(degree=16, metric=metric, max_candidates=1024, seed=5)
    ops.reset_launch_counts()
    got = build_knn_graph(corpus, use_kernel=True, **kw)
    assert ops.launch_counts()["topk_distance"] == 6
    want = build_knn_graph(corpus, use_kernel=False, **kw)
    same = float((got == want).float().mean())
    assert same >= 0.999, same
    db = VectorDB("graph", metric=metric, max_build_candidates=1024,
                  device=dev).load(corpus)
    q = corpus[:64] + 0.05
    ops.reset_launch_counts()
    ks, ki = db.query(q, k=10)
    assert ops.launch_counts()["topk_distance"] == 1
    ps, pi = db.index.query(q, k=10, use_kernel=False)
    torch.cuda.synchronize()
    assert float((ki == pi).float().mean()) >= 0.99
    assert torch.allclose(ks[ki == pi], ps[ki == pi], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_flat_mesh_front_at_width_11_launches_the_kernel(metric):
    """``DistributedVectorDB`` at d = 11 on a (2,) mesh of the card: its
    slabs and queries padded to 16 columns, each shard launches
    ``topk_distance`` (which refuses d off the multiple of 8) once a
    batch, and the answers equal the shards' plain versions within the
    float32 bound of two summation orders."""
    from repro_torch.core import DistributedVectorDB
    from repro_torch.core import distributed as dist
    dev = _card()
    mesh = dist.make_mesh((2,), ("data",), devices=[dev] * 2)
    rng = np.random.default_rng(11)
    corpus = rng.normal(size=(5_003, 11)).astype(np.float32)
    q = corpus[:9] + 0.01
    db = DistributedVectorDB(mesh, metric=metric).load(corpus)
    assert all(c.shape[1] == 16 for c in db.corpus.shards)
    ops.reset_launch_counts()
    ks, ki = db.query(q, k=10)
    assert ops.launch_counts()["topk_distance"] == 2
    qq = D.pad_width(torch.as_tensor(q, device=dev))
    if metric == "cosine":
        qq = D.l2_normalize(qq)
    ps, pi = dist.sharded_flat_search(
        db.corpus, qq, mesh=mesh, k=10,
        metric="dot" if metric == "cosine" else metric, valid=db.valid,
        corpus_sq=db.corpus_sq, use_kernel=False)
    torch.cuda.synchronize()
    tol = 2 * 16 * 2.0 ** -24 * max(1.0, float(ps.abs().max())) + 1e-6
    assert bool(((ks - ps).abs() <= tol).all())


@pytest.mark.parametrize("shape", [(1,), (4,), (2, 2)])
def test_mesh_fronts_launch_each_shards_kernels(shape):
    """The three mesh fronts on a mesh that repeats the card: every shard
    launches its kernel once a batch (``topk_distance``, ``pq_adc``, an
    ``ivf_adc`` grid; ``auto``'s measured probe may add its candidates'
    launches), and each front's answers equal its shards' plain versions:
    ``pq_adc`` and the ``ivf_adc`` grids bit for bit, ``topk_distance``
    within the float32 bound of two summation orders, rank by rank."""
    from repro_torch.core import (DistributedIVFPQ, DistributedPQ,
                                  DistributedVectorDB)
    from repro_torch.core import distributed as dist
    from repro_torch.core.pq import _ivf_probe_stage, adc_tables
    dev = _card()
    S = int(np.prod(shape))
    mesh = dist.make_mesh(shape, ("data", "model")[:len(shape)],
                          devices=[dev] * S)
    rng = np.random.default_rng(21)
    corpus = rng.normal(size=(9_001, 32)).astype(np.float32)
    q = torch.as_tensor(corpus[:20] + 0.01, device=dev)
    qn = D.l2_normalize(q)
    flat = DistributedVectorDB(mesh).load(corpus)
    ops.reset_launch_counts()
    ks, ki = flat.query(q, k=10)
    assert ops.launch_counts()["topk_distance"] == S
    ps, pi = dist.sharded_flat_search(flat.corpus, qn, mesh=mesh, k=10,
                                      metric="dot", valid=flat.valid,
                                      use_kernel=False)
    torch.cuda.synchronize()
    tol = 2 * 32 * 2.0 ** -24 + 1e-6
    assert bool(((ks - ps).abs() <= tol).all())
    pq = DistributedPQ(mesh, m=8).load(corpus)
    ops.reset_launch_counts()
    got = pq.query(q, k=10)
    assert ops.launch_counts()["pq_adc"] == S
    _same(got, dist.sharded_pq_search(
        pq.codes, adc_tables(pq.codebooks, qn, metric="dot"), mesh=mesh,
        k=10, valid=pq.valid, use_kernel=False))
    ivf = DistributedIVFPQ(mesh, m=8).load(corpus)
    ivf.insert(corpus[:300] + 0.02)
    ivf.delete(np.arange(0, 600, 3))
    ops.reset_launch_counts()
    got = ivf.query(q, k=10)
    counts = ops.launch_counts()
    assert sum(counts[g] for g in ("ivf_adc", "ivf_adc_blocked",
                                   "ivf_adc_run_resident")) >= S
    visit, luts, coarse, _ = _ivf_probe_stage(
        ivf.codebooks, ivf.centroids, qn, ivf.block_table, metric="dot",
        nprobe=8, steps_per_probe=ivf.spp, pad_block=-1)
    _same(got, dist.sharded_ivf_pq_search(
        ivf.codes_bm, ivf.bucket_ids, visit, luts, coarse, mesh=mesh, k=10,
        steps_per_probe=ivf.spp, blocks_per_shard=ivf.blocks_per_shard,
        use_kernel=False))


# ------------------------------------------------------ training
def _train_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "p"):
        tok = rng.integers(2, cfg.vocab_size, size=(B, S))
        mask = np.arange(S)[None, :] < rng.integers(1, S + 1, size=B)[:, None]
        out[f"{side}_tokens"] = torch.tensor(np.where(mask, tok, 0))
        out[f"{side}_mask"] = torch.tensor(mask)
    return out


def test_flash_attention_refuses_grad_inputs_on_the_card():
    """The forward-only kernel raises on inputs that need a gradient under
    grad mode, and launches under no_grad."""
    dev = _card()
    q = torch.randn(2, 16, 4, 64, device=dev, requires_grad=True)
    k, v = torch.randn(2, 16, 4, 64, device=dev), torch.randn(2, 16, 4, 64, device=dev)
    with pytest.raises(ValueError, match="forward only"):
        ops.flash_attention(q, k, v, causal=False)
    ops.reset_launch_counts()
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=False)
    assert ops.launch_counts()["flash_attention"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contrastive_grads_on_the_card_match_cpu(dtype):
    """One contrastive step from one seeded state on the card and on the
    CPU: float32 within 1e-5 (loss, relative) and 1e-4 x max|g| a leaf;
    bf16 within 2e-2 and cosine >= 0.99; lm_head zero; training never
    launches the attention kernel, serving the trained tower does."""
    import dataclasses

    from repro_torch.configs import thistle_sbert
    from repro_torch.models import encoder
    from repro_torch.train.accum import value_and_grad
    dev = _card()
    cfg = dataclasses.replace(thistle_sbert.SMOKE, dtype=dtype)
    batch = _train_batch(cfg, 8, 64, seed=0)
    out = []
    ops.reset_launch_counts()
    for d in (dev, torch.device("cpu")):
        model = encoder.init(cfg, torch.Generator().manual_seed(0), device=d,
                             trainable=True)
        (loss, _), grads = value_and_grad(
            lambda m, b: encoder.contrastive_loss(m, cfg, b), model,
            {k: v.to(d) for k, v in batch.items()})
        out.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    assert ops.launch_counts()["flash_attention"] == 0
    (lg, gg), (lc, gc) = out
    assert lg == pytest.approx(lc, rel=1e-5 if dtype == "float32" else 2e-2)
    for name, c in gc.items():
        g, scale = gg[name], float(c.abs().max())
        if name.startswith("lm_head"):
            assert scale == 0 and not torch.any(g)
        elif dtype == "float32":
            assert float((g - c).abs().max()) <= 1e-4 * scale, name
        elif scale:
            cos = float((g.double() * c.double()).sum()
                        / g.double().norm() / c.double().norm())
            assert cos >= 0.99, (name, cos)
    model = encoder.init(cfg, torch.Generator().manual_seed(0), device=dev,
                         trainable=True)
    encoder.encode(model, cfg, batch["q_tokens"].to(dev), batch["q_mask"].to(dev))
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers


@pytest.mark.parametrize("int8", [False, True])
def test_restart_replays_bit_for_bit_on_the_card(int8, tmp_path, monkeypatch):
    """Failures at steps 5 and 9, checkpoints every 4: the restored run's
    parameters and moments equal an uninterrupted run's, bit for bit, with
    deterministic algorithms on (the embedding's backward sums with
    atomics otherwise)."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import thistle_sbert
    from repro_torch.data.marco import MarcoLike
    from repro_torch.ft import FailureInjector, Supervisor
    from repro_torch.train.optim import tree_get, tree_paths
    from repro_torch.train.sbert import SbertJob
    dev = _card()
    cfg = thistle_sbert.SMOKE
    data = MarcoLike(n_passages=200, vocab_size=cfg.vocab_size, noise=0.25,
                     passage_len=24, seed=0)
    kw = dict(lr=3e-3, total_steps=12, device=dev, log_every=0, int8_state=int8)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        plain = SbertJob(cfg, data, 16, **kw)
        for s in range(12):
            plain.run_step(s)
        job = SbertJob(cfg, data, 16, injector=FailureInjector(fail_at=[5, 9]),
                       **kw)
        store = CheckpointStore(str(tmp_path), keep=2)
        out = Supervisor(job, store, total_steps=12, checkpoint_every=4).run()
        store.wait()
    finally:
        torch.use_deterministic_algorithms(False)
    assert out["final_step"] == 12 and out["n_retries"] == 2
    for path, x in tree_paths(job.state):
        assert torch.equal(x, tree_get(plain.state, path)), path


def test_int8_adam_on_the_card_matches_cpu():
    """AdamW with int8 state, fed the same grads on the card and the CPU:
    codes equal in 99.99 % of entries and within 1, scales within 1e-6."""
    from repro_torch.train.optim import adamw_init, adamw_update, tree_paths
    dev = _card()
    gen = torch.Generator().manual_seed(0)
    shapes = {"flat": (37, 5), "rows": (6, 512), "stack": (2, 64, 4, 16)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen) * 1e-2 for k, s in shapes.items()}
             for _ in range(3)]
    states = {}
    for d in (dev, torch.device("cpu")):
        p = {k: v.to(d) for k, v in params.items()}
        st = adamw_init(p, int8_state=True)
        for g in grads:
            p, st = adamw_update({k: v.to(d) for k, v in g.items()}, st, p,
                                 lr=1e-2, int8_state=True)
        states[d.type] = st
    n = same = 0
    for (path, a), (_, b) in zip(tree_paths(states["cuda"]["mu"]),
                                 tree_paths(states["cpu"]["mu"])):
        a = a.cpu()
        if path[-1].endswith("_q"):
            diff = (a.int() - b.int()).abs()
            assert int(diff.max()) <= 1, path
            n, same = n + diff.numel(), same + int((diff == 0).sum())
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert same >= 0.9999 * n


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "stablelm-1.6b"])
def test_lm_prefill_launches_flash_attention_on_the_card(arch):
    """An LM prefill on the card (danube's window at S past it) runs the
    kernel once a layer and agrees with the same prefill through the
    plain attention: float32 copy of the SMOKE config, logits and every
    cache array; the greedy DecodeLoop equals the CPU's."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import DecodeLoop
    dev = _card()
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = transformer.init(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen,
                           device=dev)
    ops.reset_launch_counts()
    got, cache = transformer.prefill(model, cfg, tokens)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want, want_cache = transformer.prefill(model, cfg, tokens,
                                           use_kernel=False)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for name in cache:
        torch.testing.assert_close(cache[name], want_cache[name], atol=1e-4,
                                   rtol=1e-4)
    cpu = transformer.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    on_card = DecodeLoop(model, cfg, max_len=64).generate(tokens[:, :20],
                                                          n_new=6)
    on_cpu = DecodeLoop(cpu, cfg, max_len=64, device="cpu").generate(
        tokens[:, :20].cpu(), n_new=6)
    assert torch.equal(on_card.cpu(), on_cpu)


# ----------------------------------------------------------- LM training,
# recsys and GNN on the card


def _card_against_cpu(model, loss, batch, dev):
    """(card loss, CPU loss, worst leaf cosine) of one batch, the model
    moved to the host and back between the two."""
    from repro_torch.train.accum import value_and_grad
    from repro_torch.train.job import to_device
    (lg, _), gg = value_and_grad(loss, model, to_device(batch, dev))
    gg = {k: v.cpu().double() for k, v in gg.items()}
    model.to("cpu")
    (lc, _), gc = value_and_grad(loss, model, to_device(batch, "cpu"))
    model.to(dev)
    worst = 1.0
    for k, w in gc.items():
        w = w.double()
        den = float(gg[k].norm() * w.norm())
        if den:
            worst = min(worst, float((gg[k] * w).sum()) / den)
        else:
            assert not gg[k].any() and not w.any(), k
    return float(lg), float(lc), worst


@pytest.mark.parametrize("K", [64, 512])
def test_tf32_products_of_bf16_values_within_the_float32_sum_bound(K):
    """bf16_exact_tf32's claim: on bf16-valued float32 operands TF32 loses
    nothing in the products, so a product under it and one under
    strict_fp32 each lie within the float32 summation bound of its K terms
    (K 2^-23 sum |a b|) of the float64 product. K = 64 is the scores'
    head width, 512 the p v product's chunk."""
    from repro_torch.device import bf16_exact_tf32, strict_fp32
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(K)
    a = torch.randn(8, 512, K, generator=g, device=dev).bfloat16().float()
    b = torch.randn(8, K, 256, generator=g, device=dev).bfloat16().float()
    if K == 512:  # probabilities, as the p v product sees them
        a = torch.rand(8, 512, K, generator=g, device=dev).bfloat16().float()
    exact = a.double() @ b.double()
    bound = K * 2.0 ** -23 * (a.abs().double() @ b.abs().double())
    for ctx in (bf16_exact_tf32, strict_fp32):
        with ctx():
            got = (a @ b).double()
        assert bool(((got - exact).abs() <= bound).all()), (
            ctx.__name__, float(((got - exact).abs() / bound).max()))


@pytest.mark.parametrize("window", [None, 1024])
def test_chunked_attention_bf16_fast_path_matches_strict(window, monkeypatch):
    """bf16 _chunked_attention as the card runs it in training (hidden
    chunk pairs skipped, the bf16-valued products as TF32) against the
    same call with nothing skipped (an all-true padding mask turns the
    skip off) and every product in strict float32. The two differ only in
    the float32 sums' order and rounding, so the bf16 outputs and the
    gradients of q, k and v lie within half a bf16 rounding of each other
    (normwise 2^-8) and the gradients' cosine is >= 0.99999. At S = 2,048,
    chunk 512, the window skips pairs both before a row's first live chunk
    and after its last."""
    from repro_torch.device import strict_fp32
    from repro_torch.models import attention as pattn
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    B, S, KV, rep, dh = 2, 2048, 2, 4, 64
    q = torch.randn(B, S, KV, rep, dh, generator=g, device=dev)
    k = torch.randn(B, S, KV, dh, generator=g, device=dev)
    v = torch.randn(B, S, KV, dh, generator=g, device=dev)
    do = torch.randn(B, S, KV, rep, dh, generator=g, device=dev).bfloat16()
    q, k, v = (x.bfloat16().requires_grad_() for x in (q, k, v))
    kw = dict(scale=dh ** -0.5, causal=True, window=window, q_offset=0,
              q_chunk=512, k_chunk=512)

    def run(kv_mask):
        with strict_fp32():
            o = pattn._chunked_attention(q, k, v, kv_mask=kv_mask, **kw)
            return [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))

    fast = run(None)
    monkeypatch.setattr(pattn, "bf16_exact_tf32", strict_fp32)
    strict = run(torch.ones(B, S, dtype=torch.bool, device=dev))
    for name, f, s in zip(("out", "dq", "dk", "dv"), fast, strict):
        f, s = f.double(), s.double()
        rel = float((f - s).norm() / s.norm())
        cos = float((f * s).sum() / (f.norm() * s.norm()))
        assert rel <= 2.0 ** -8 and cos >= 0.99999, (name, rel, cos)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v3-671b"])
def test_lm_loss_on_the_card_matches_cpu(arch):
    """transformer.loss_fn's value and gradients on the card against the
    CPU, float32 copies of the SMOKE configs (v3 with its MTP head), at
    S = 64 (the chunked attention) with remat: loss within 1e-5, every
    leaf's cosine >= 0.99999."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import transformer
    dev = _card()
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    model = transformer.init(cfg, torch.Generator().manual_seed(0), dev,
                             trainable=True)
    batch = lm_batches(TokenStream(vocab_size=cfg.vocab_size), 2, 64,
                       cfg.vocab_size)(3)
    lg, lc, cos = _card_against_cpu(
        model, lambda m, b: transformer.loss_fn(m, cfg, b, remat=True), batch,
        dev)
    assert abs(lg - lc) <= 1e-5 * abs(lc) and cos >= 0.99999, (lg, lc, cos)


@pytest.mark.parametrize("kind", ["fm", "deepfm", "autoint", "sasrec"])
def test_recsys_loss_on_the_card_matches_cpu(kind):
    from repro_torch.configs import get_arch
    from repro_torch.data import ClickLogs
    from repro_torch.models import recsys
    dev = _card()
    cfg = get_arch(kind).smoke
    model = recsys.init(cfg, torch.Generator().manual_seed(0), dev,
                        trainable=True)
    logs = ClickLogs(cfg)
    batch = logs.sequence_batch(64, 2) if kind == "sasrec" else \
        logs.batch(64, 2)
    lg, lc, cos = _card_against_cpu(
        model, lambda m, b: recsys.loss_fn(m, cfg, b), batch, dev)
    assert abs(lg - lc) <= 1e-5 * abs(lc) and cos >= 0.99999, (lg, lc, cos)


@pytest.mark.parametrize("agg", ["mean", "max", "sum"])
def test_gnn_losses_on_the_card_match_cpu(agg):
    """node_loss (edge mask), block_loss (sampled, padded) and graph_loss
    on the card against the CPU: loss within 1e-5, cosine >= 0.99999."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data import molecule_batch, sbm_graph
    from repro_torch.models import gnn
    dev = _card()
    g = sbm_graph(300, 4, 8, seed=0)
    g["edge_mask"] = np.random.default_rng(1).random(g["edges"].shape[1]) < .8
    cfg = dataclasses.replace(get_arch("graphsage-reddit").smoke, d_in=8,
                              n_classes=4, aggregator=agg)
    fan = list(cfg.sample_sizes)
    nodes, blocks = gnn.NeighborSampler(g["edges"], 300, fan, seed=2).sample(
        np.arange(32))
    nodes, blocks = gnn.pad_sample(nodes, blocks, 32, fan)
    mol = molecule_batch(16, seed=3)
    cases = [(cfg, gnn.node_loss, g),
             (cfg, gnn.block_loss, {"feats": g["feats"][nodes],
                                    "blocks": blocks,
                                    "labels": g["labels"][:32]}),
             (dataclasses.replace(cfg, d_in=16, n_classes=2), gnn.graph_loss,
              mol)]
    for c, fn, batch in cases:
        model = gnn.init(c, torch.Generator().manual_seed(0), dev,
                         trainable=True)
        lg, lc, cos = _card_against_cpu(
            model, lambda m, b, c=c, fn=fn: fn(m, c, b), batch, dev)
        assert abs(lg - lc) <= 1e-5 * abs(lc) and cos >= 0.99999, (
            fn.__name__, lg, lc, cos)


@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
@pytest.mark.parametrize("d", [11, 50])
def test_flat_at_a_width_off_the_kernel_multiple_on_the_card(d, metric):
    """VectorDB("flat") at d = 11 and 50 serves through topk_distance (its
    buffer padded to the kernel's width) within the f32 bound of its plain
    version, ids equal but for near-ties; the kernel is launched."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(40_000, d, generator=g, device=dev)
    q = torch.randn(33, d, generator=g, device=dev)
    db = VectorDB("flat", metric=metric, device=dev).load(x)
    ops.reset_launch_counts()
    ks, ki = db.query(q, k=10)
    assert ops.launch_counts()["topk_distance"] == 1
    scan = db.index._scan
    qp = D.pad_width(D.l2_normalize(q) if metric == "cosine" else q)
    m = "l2" if metric == "l2" else "dot"
    ps, pi = ops.topk_distance(scan, qp, k=10, metric=m,
                               corpus_sq=db.index.corpus_sq, use_kernel=False)
    cf, qf = scan.float(), qp.float()
    scale = (torch.linalg.vector_norm(qf, dim=1)[:, None]
             * torch.linalg.vector_norm(cf, dim=1).max())
    tol = (2 if m == "l2" else 1) * 2 * scan.shape[1] * 2.0 ** -24 * scale
    _topk_near_ties(cf, qf, ks, ki, ps, pi.to(ki.dtype), m,
                    tol + 1e-6 * ps.abs())


def test_lm_cli_restart_replays_bit_for_bit_on_the_card(tmp_path,
                                                        monkeypatch):
    """The trainer CLI's lm job (deepseek-v2-lite SMOKE: MLA and the MoE)
    with failures at steps 3 and 6, checkpoints every 2, deterministic
    algorithms on: the restored run ends bit-equal to an uninterrupted
    one."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.ft import Supervisor
    from repro_torch.launch.train import ArchJob
    from repro_torch.train.optim import tree_get, tree_paths
    dev = _card()
    kw = dict(full=False, batch=2, seq_len=16, lr=1e-3, total_steps=8,
              device=dev)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        plain = ArchJob("deepseek-v2-lite-16b", **kw)
        for s in range(8):
            plain.run_step(s)
        job = ArchJob("deepseek-v2-lite-16b", fail_at=[3, 6], **kw)
        store = CheckpointStore(str(tmp_path), keep=2)
        out = Supervisor(job, store, total_steps=8, checkpoint_every=2).run()
        store.wait()
    finally:
        torch.use_deterministic_algorithms(False)
    assert out["final_step"] == 8 and out["n_retries"] == 2
    for path, x in tree_paths(job.state):
        assert torch.equal(x, tree_get(plain.state, path)), path


# ------------------------------------------------- launch/ on one NCCL rank


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world of one rank over NCCL and its (1, 1) ("data", "model")
    mesh, destroyed after the module's tests."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    _card()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _lm_smoke(dev, trainable=False, dtype=None):
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.models import transformer
    cfg = get_arch("stablelm-1.6b").smoke
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = transformer.init(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, trainable=trainable)
    return cfg, model, convert.bind_reference_layout(model, cfg)


def test_sharded_prefill_on_one_rank_launches_flash(nccl_mesh):
    """make_lm_prefill on the (1, 1) mesh: one flash_attention launch a
    layer on the local heads, logits equal to the unsharded prefill."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.shapes import Spec
    from repro_torch.models import transformer
    dev = _card()
    cfg, model, tree = _lm_smoke(dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device=dev)
    built = S.make_lm_prefill(cfg, nccl_mesh, "stablelm-1.6b",
                              {"tokens": Spec((2, 64), torch.int32)})
    ops.reset_launch_counts()
    logits, cache = built.run(tree, tok)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = transformer.prefill(model, cfg, tok)
    assert torch.equal(logits.full_tensor(), want)


def test_sharded_serve_on_one_rank_launches_topk(nccl_mesh):
    """sasrec's serve step: the two-level search runs topk_distance on the
    local item shard; ids equal flat_search's over the whole table."""
    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.core.flat import flat_search
    from repro_torch.launch import steps as S
    from repro_torch.launch.shapes import Spec
    from repro_torch.models import recsys
    dev = _card()
    cfg = get_arch("sasrec").smoke
    model = recsys.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tree = convert.stack_layers(dict(model.named_parameters()), cfg)
    seq = torch.randint(1, cfg.n_items + 1, (16, cfg.seq_len), device=dev,
                        dtype=torch.int32)
    built = S.make_recsys_serve(cfg, nccl_mesh, "sasrec",
                                {"seq": Spec((16, cfg.seq_len), torch.int32)})
    ops.reset_launch_counts()
    s, i = built.run(tree, {"seq": seq})
    torch.cuda.synchronize()
    assert ops.launch_counts()["topk_distance"] == 1
    u = recsys.sasrec_user_vector(model, cfg, seq)
    items = model.item_embed.float()
    valid = torch.arange(items.shape[0], device=dev) < cfg.n_items + 1
    fs, fi = flat_search(D.pad_width(items), D.pad_width(u), metric="dot",
                         k=S.SERVE_K, valid=valid)
    assert torch.equal(i.full_tensor(), fi.long())
    assert torch.equal(s.full_tensor(), fs)


def test_sharded_train_on_one_rank_matches_single_process(nccl_mesh):
    """One float32 make_lm_train step on the (1, 1) mesh against the
    single-process step from the same state: every leaf within 1e-6."""
    from repro_torch.core import convert
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as S
    from repro_torch.launch.shapes import Spec
    from repro_torch.models import transformer
    from repro_torch.train import (adamw_init, adamw_update,
                                   clip_by_global_norm, cosine_schedule,
                                   gradient_accumulation)
    dev = _card()
    cfg, model, tree = _lm_smoke(dev, trainable=True, dtype="float32")
    tok = torch.randint(0, cfg.vocab_size, (4, 64), device=dev)
    batch = {"tokens": tok, "labels": tok}
    opt = adamw_init(tree)
    opt["step"] = torch.tensor(1000, dtype=torch.int32)
    grads, loss, _ = gradient_accumulation(
        lambda p, b: transformer.loss_fn(p, cfg, b, remat=True), model,
        batch, 2)
    grads, _ = clip_by_global_norm(convert.stack_layers(grads, cfg), 1.0)
    lr = cosine_schedule(opt["step"], base_lr=3e-4, warmup=2000,
                         total=100_000)
    p_ref, o_ref = adamw_update(grads, opt, tree, lr=lr)
    want = dict(sh.leaves({"params": p_ref, "opt": o_ref}))
    inputs = {k: Spec((4, 64), torch.int32) for k in ("tokens", "labels")}
    built = S.make_lm_train(cfg, nccl_mesh, "stablelm-1.6b", inputs,
                            opts={"n_micro": 2, "int8_opt": False,
                                  "remat": True})
    new, metrics = built.run({"params": tree, "opt": opt}, batch)
    assert abs(float(metrics["loss"].full_tensor()) - float(loss)) <= 1e-6
    for name, leaf in sh.leaves(sh.gather(new)):
        w = want[name].float()
        assert float((leaf.float() - w).abs().max()) <= 1e-6 * max(
            float(w.abs().max()), 1.0), name


def test_a_cuda_dtensor_never_takes_the_plain_version(nccl_mesh):
    """A DTensor on the card reaching a kernel wrapper raises: the kernels
    run on local shards and nothing falls back."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    dev = _card()
    x = distribute_tensor(torch.randn(64, 16, device=dev), nccl_mesh,
                          [Replicate(), Replicate()])
    with pytest.raises(ValueError, match="local shard"):
        ops.topk_distance(x, x[:2], k=4)
    q = distribute_tensor(torch.randn(1, 32, 2, 16, device=dev), nccl_mesh,
                          [Replicate(), Replicate()])
    with pytest.raises(ValueError, match="local shard"):
        ops.flash_attention(q, q, q, causal=True)


@pytest.mark.parametrize("engine", ["ivf_pq", "flat"])
def test_host_syncs_match_the_sync_debug_mode(engine, monkeypatch):
    """The recorder's ``host_syncs`` over one ``VectorDB.query`` equals the
    synchronizing operations the card reports under
    ``set_sync_debug_mode("warn")``: none on ``ivf_pq`` under ``auto``
    where the grouped grids' board cannot fit, as on the MS MARCO layout
    (the sharing is counted on the card), none on ``flat``."""
    dev = _card()
    monkeypatch.setattr(ops, "BLOCKED_MAX_BOARD_SLOTS", 0)
    g = torch.Generator(device=dev).manual_seed(31)
    corpus = torch.randn(40_000, 64, generator=g, device=dev)
    args = (dict(n_clusters=200, m=8, nprobe=8, refine=32)
            if engine == "ivf_pq" else {})
    db = VectorDB(engine, device=dev, **args)
    db.load(corpus)
    q = torch.randn(512 if engine == "ivf_pq" else 16, 64, generator=g,
                    device=dev)
    counted, syncs = _syncs_of_one_call(db, q)
    assert counted == len(syncs), syncs
    assert counted == 0
    if engine == "ivf_pq":
        st = db.adc_stats
        assert st["sharing_deferred"] == st["batches"] == 2
        assert type(st["sharing_sum"]) is float and st["sharing_sum"] > 0


def _syncs_of_one_call(db, q):
    """(``host_syncs`` counted, the sync debug mode's warnings) over the
    second of two ``db.query(q)`` calls: the first settles plans, launch
    configurations and the tuner."""
    import warnings
    from repro_torch import trace
    db.query(q, k=10)
    torch.cuda.synchronize()
    trace.enable()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                db.query(q, k=10)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        trace.disable()
        got = trace.drain()
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    return got["counters"].get("host_syncs", 0), syncs


def test_host_syncs_match_the_sync_debug_mode_where_the_board_fits(
        monkeypatch):
    """Where the board fits, ``auto`` on ``ivf_pq`` reads the sharing
    probe's mask and ``unique`` on the host to weigh the grouped grids:
    two syncs, counted and reported alike (a settled tuner keeps the
    per-query grid)."""
    from repro_torch.kernels.autotune import AutoTuner

    class Settled(AutoTuner):
        def lookup(self, key):
            return {"grouped_mode": "blocked", "qblk": 8,
                    "crossover": float("inf")}

    dev = _card()
    monkeypatch.setattr(ops, "LEDGER", Settled())
    g = torch.Generator(device=dev).manual_seed(31)
    db = VectorDB("ivf_pq", device=dev, n_clusters=200, m=8, nprobe=8,
                  refine=32)
    db.load(torch.randn(40_000, 64, generator=g, device=dev))
    counted, syncs = _syncs_of_one_call(
        db, torch.randn(32, 64, generator=g, device=dev))
    assert counted == len(syncs) == 2, syncs
    assert db.adc_stats["sharing_deferred"] == 0


@pytest.mark.parametrize("pad_share,pad", [(0.3, True), (0.3, False),
                                           (1.0, True), (0.0, True)])
@pytest.mark.parametrize("Q,T,B", [(512, 96, 4_001), (3, 5, 70),
                                   (0, 8, 33), (512, 4_096, 300_001)])
def test_visit_sharing_kernel_matches_the_host_probe(Q, T, B, pad_share, pad):
    """On the card the sharing count's kernel gives ``visit_sharing``'s
    numbers, as its plain version does there, in one launch that
    synchronizes nothing: many repeats, no pad block, all pad, none, an
    empty table, and the MS MARCO layout's shape at Q = 512 (2.1 M ids,
    more than the grid's 1,056 x 256 threads cover in one pass, so the
    grid-stride loop and the last block's finish run)."""
    import warnings
    from repro_torch.core.ivf import visit_sharing
    from repro_torch.kernels import visit_sharing as vs
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    visit = torch.randint(0, B - 1, (Q, T), generator=g, device=dev,
                          dtype=torch.int32)
    visit[torch.rand(visit.shape, generator=g, device=dev) < pad_share] = B - 1
    pad_block = B - 1 if pad else None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = vs.visit_sharing_device(visit, B, pad_block=pad_block)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchronizing" in str(w.message)]
    assert ops.launch_counts()["visit_sharing"] == 1
    assert [(v.is_cuda, v.dim(), v.dtype) for v in got.values()] == [
        (True, 0, torch.int64), (True, 0, torch.int64),
        (True, 0, torch.float64)]
    plain = vs.visit_sharing_device(visit, B, pad_block=pad_block,
                                    use_kernel=False)
    want = visit_sharing(visit, pad_block=pad_block)
    assert {k: v.item() for k, v in got.items()} == want
    assert {k: v.item() for k, v in plain.items()} == want
