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


def test_flash_attention_limits_on_the_card():
    """dh outside the kernel's range and a sliding window raise on CUDA
    tensors; nothing falls back to the plain version."""
    dev = _card()
    x = torch.zeros((1, 8, 2, 72), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="256"):
        ops.flash_attention(x, x, x, causal=False)
    y = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(y, y, y, causal=True, window=4)


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
