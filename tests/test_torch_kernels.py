"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version;
here those are held against the reference's jnp twins and its
``kernels/ref.py`` oracles on the same numpy inputs. Tolerances: float32
scores atol = rtol = 1e-5; ids exact. A bf16 or int8 table is held to the
same tolerance against the reference using the same table precision, and
to the documented quantization bounds (``repro/kernels/pq_adc.py``)
against the float32 oracle: bf16 |d| <= m * 2^-8 * max|lut|, int8
|d| <= m * max|lut| / 254.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import build_block_lists as jax_build_block_lists  # noqa: E402
from repro.kernels import ivf_adc_topk as jax_ivf_adc_topk  # noqa: E402
from repro.kernels import quantize_lut_int8 as jax_quantize  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.ops import _round_lut_bf16 as jax_round_bf16  # noqa: E402
from repro_torch.core.ivf import build_block_lists  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels.ivf_adc import quantize_lut_int8, round_lut_bf16  # noqa: E402
from repro_torch.kernels.topk_distance import topk_distance_plain  # noqa: E402

NEG_INF = -1e30
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layout(rng, N, C, blk, m, ksub, *, empty=(), tombstones=0.0):
    """Block lists of a random assignment (ragged clusters, the given
    clusters left empty), random uint8 codes, a share of slots retargeted
    to the -1 tombstone sentinel."""
    assign = rng.integers(0, C, N)
    for c in empty:
        assign[assign == c] = (c + 1) % C
    slots, bstart, bcnt, spp = jax_build_block_lists(assign, C, blk=blk)
    slots = np.array(slots)
    dead = (rng.random(slots.shape) < tombstones) & (slots >= 0)
    slots[dead] = -1
    codes = rng.integers(0, ksub, (slots.shape[0], blk, m)).astype(np.uint8)
    return slots, np.asarray(bstart), np.asarray(bcnt), spp, codes


def _visit(rng, bstart, bcnt, spp, n_rows, Q, nprobe, C):
    probe = np.stack([rng.choice(C, nprobe, replace=False) for _ in range(Q)])
    base, cnt = bstart[probe], bcnt[probe]
    r = np.arange(spp)[None, None, :]
    v = np.where(r < cnt[:, :, None], base[:, :, None] + r, n_rows - 1)
    return v.reshape(Q, -1).astype(np.int32)


def _case(rng, *, per_probe, N=700, C=23, blk=8, m=4, ksub=32, Q=5,
          nprobe=6, knock=True, tombstones=0.1):
    slots, bstart, bcnt, spp, codes = _layout(rng, N, C, blk, m, ksub,
                                              empty=(3, 11),
                                              tombstones=tombstones)
    visit = _visit(rng, bstart, bcnt, spp, slots.shape[0], Q, nprobe, C)
    lshape = (Q, nprobe, m, ksub) if per_probe else (Q, m, ksub)
    luts = rng.normal(size=lshape).astype(np.float32)
    coarse = rng.normal(size=(Q, nprobe)).astype(np.float32)
    if knock:  # a knocked-out probe, as sharded serving and adaptive probing use
        coarse[0, 1] = NEG_INF
    return codes, slots, visit, luts, coarse, spp


def _port(codes, slots, visit, luts, coarse, k, spp, lut_dtype):
    s, i = ops.ivf_adc_topk(_t(codes), _t(slots), _t(visit), _t(luts), k=k,
                            coarse=_t(coarse), steps_per_probe=spp,
                            lut_dtype=lut_dtype)
    return s.numpy(), i.numpy()


def _jax(codes, slots, visit, luts, coarse, k, spp, lut_dtype):
    s, i = jax_ivf_adc_topk(jnp.asarray(codes.astype(np.int32)),
                            jnp.asarray(slots), jnp.asarray(visit),
                            jnp.asarray(luts), k=k, coarse=jnp.asarray(coarse),
                            steps_per_probe=spp, use_kernel=False,
                            lut_dtype=lut_dtype, mode="per_query")
    return np.asarray(s), np.asarray(i)


def _quant_bound(luts, lut_dtype, m):
    amax = float(np.abs(luts).max())
    return {"float32": 1e-5, "bfloat16": m * 2.0 ** -8 * amax,
            "int8": m * amax / 254}[lut_dtype]


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("shape", [
    dict(N=700, C=23, blk=8, m=4, ksub=32, Q=5, nprobe=6, k=12),
    dict(N=1500, C=9, blk=16, m=8, ksub=64, Q=3, nprobe=3, k=40),
    dict(N=150, C=30, blk=8, m=4, ksub=16, Q=4, nprobe=10, k=7),
])
def test_ivf_adc_plain_matches_reference(rng, lut_dtype, per_probe, shape):
    """Shared and per-probe tables, all three table dtypes, pad blocks
    (short clusters), -1 slots, a NEG_INF coarse knockout, empty and ragged
    clusters: ids equal to the reference's twin, scores within 1e-5; and
    against the float32 oracle within the table dtype's bound."""
    shape = dict(shape)
    k = shape.pop("k")
    codes, slots, visit, luts, coarse, spp = _case(rng, per_probe=per_probe,
                                                   **shape)
    ps, pi = _port(codes, slots, visit, luts, coarse, k, spp, lut_dtype)
    js, ji = _jax(codes, slots, visit, luts, coarse, k, spp, lut_dtype)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, **TOL)
    # against the float32 oracle, rank by rank (the i-th best moves by at
    # most the largest per-score error)
    rs, _ = R.ivf_adc_ref(jnp.asarray(codes), jnp.asarray(slots),
                          jnp.asarray(visit), jnp.asarray(luts),
                          jnp.asarray(coarse), k=k, steps_per_probe=spp)
    rs = np.asarray(rs)
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(rs))
    live = np.isfinite(rs)
    assert np.all(np.abs(ps[live] - rs[live])
                  <= _quant_bound(luts, lut_dtype, shape["m"]) + 1e-5 * np.abs(rs[live]))


@pytest.mark.parametrize("per_probe", [False, True])
def test_ivf_adc_oracles_agree(rng, per_probe):
    """The port's materialize-everything oracle equals the reference's."""
    codes, slots, visit, luts, coarse, spp = _case(rng, per_probe=per_probe)
    ts, ti = TR.ivf_adc_ref(_t(codes), _t(slots), _t(visit), _t(luts),
                            _t(coarse), k=15, steps_per_probe=spp)
    rs, ri = R.ivf_adc_ref(jnp.asarray(codes), jnp.asarray(slots),
                           jnp.asarray(visit), jnp.asarray(luts),
                           jnp.asarray(coarse), k=15, steps_per_probe=spp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), **TOL)
    ps, pi = _port(codes, slots, visit, luts, coarse, 15, spp, "float32")
    np.testing.assert_array_equal(pi, ti.numpy())


def test_ivf_adc_all_knocked_out_and_k_above_candidates(rng):
    """Every probe knocked out, or k above the probed slot count: the
    missing entries are (-inf, -1) on both sides."""
    codes, slots, visit, luts, coarse, spp = _case(rng, per_probe=False,
                                                   N=120, C=6, nprobe=2)
    coarse[1, :] = NEG_INF
    k = visit.shape[1] * 8 + 5
    ps, pi = _port(codes, slots, visit, luts, coarse, k, spp, "float32")
    js, ji = _jax(codes, slots, visit, luts, coarse, k, spp, "float32")
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, **TOL)
    assert np.isneginf(ps[1]).all() and (pi[1] == -1).all()
    assert (pi[np.isneginf(ps)] == -1).all()


def test_ivf_adc_duplicate_codes_tie_to_visit_order(rng):
    """Slots with equal codes score equally; the lower visit position wins,
    as the reference's top-k over the visit order keeps it."""
    codes, slots, visit, luts, coarse, spp = _case(rng, per_probe=False,
                                                   tombstones=0.0)
    codes[:] = codes[0, 0]  # every slot the same code: all scores tie per probe
    coarse[:] = 0.0
    ps, pi = _port(codes, slots, visit, luts, coarse, 20, spp, "float32")
    js, ji = _jax(codes, slots, visit, luts, coarse, 20, spp, "float32")
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, **TOL)


def test_quantize_lut_int8_bit_equal(rng):
    luts = rng.normal(size=(3, 5, 4, 64)).astype(np.float32)
    luts[0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves: round to even
    luts[1, 1, 1, :] = 0.0                     # all-zero row: the 1e-30 floor
    q8, sc = quantize_lut_int8(_t(luts))
    jq8, jsc = jax_quantize(jnp.asarray(luts))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sc.numpy().view(np.uint32),
                                  np.asarray(jsc).view(np.uint32))


def test_round_lut_bf16_bit_equal(rng):
    luts = rng.normal(size=(4, 8, 32)).astype(np.float32) * 37.0
    got = round_lut_bf16(_t(luts)).numpy()
    want = np.asarray(jax_round_bf16(jnp.asarray(luts)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_build_block_lists_matches_reference(rng):
    assign = rng.integers(0, 17, 900)
    assign[assign == 4] = 5  # an empty cluster
    got = build_block_lists(_t(assign), 17, blk=16)
    want = jax_build_block_lists(assign, 17, blk=16)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == want[3]


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_topk_distance_plain_matches_reference(rng, metric, k):
    corpus = rng.normal(size=(777, 24)).astype(np.float32)
    q = rng.normal(size=(6, 24)).astype(np.float32)
    s, i = ops.topk_distance(_t(corpus), _t(q), k=k, metric=metric)
    rs, ri = R.topk_distance_ref(jnp.asarray(corpus), jnp.asarray(q), k=k,
                                 metric=metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    ts, ti = TR.topk_distance_ref(_t(corpus), _t(q), k=k, metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), **TOL)


@pytest.mark.parametrize("tile", [64, 1 << 20])
def test_topk_distance_duplicate_rows_tie_to_lower_id(rng, tile):
    """Duplicated corpus rows score equally; the lower row id comes first,
    as lax.top_k orders them, both when a tile splits the duplicates apart
    and when one tile holds them all."""
    base = rng.normal(size=(40, 16)).astype(np.float32)
    corpus = np.concatenate([base, base, base[:7]])
    q = rng.normal(size=(4, 16)).astype(np.float32)
    bias = torch.zeros(corpus.shape[0])
    s, i = topk_distance_plain(_t(corpus), _t(q), bias, k=30, l2=False,
                               tile=tile)
    rs, ri = R.topk_distance_ref(jnp.asarray(corpus), jnp.asarray(q), k=30)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    for row_s, row_i in zip(s.numpy(), i.numpy()):
        for a in range(len(row_s) - 1):
            if row_s[a] == row_s[a + 1]:
                assert row_i[a] < row_i[a + 1]


def test_topk_distance_valid_mask_knocks_rows_out(rng):
    """Rows where ``valid`` is False score the -1e30 knockout, as the
    reference's wrapper builds its bias."""
    corpus = rng.normal(size=(300, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    valid = rng.random(300) < 0.5
    s, i = ops.topk_distance(_t(corpus), _t(q), k=20, metric="l2",
                             valid=_t(valid))
    assert valid[i.numpy()].all()
    rs, ri = R.topk_distance_ref(jnp.asarray(corpus[valid]), jnp.asarray(q),
                                 k=20, metric="l2")
    np.testing.assert_array_equal(i.numpy(), np.flatnonzero(valid)[np.asarray(ri)])
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)


@pytest.mark.parametrize("probe_chunk", [1, 2, 4])
def test_ivf_adc_probe_chunks_fold_the_same(rng, probe_chunk):
    """The plain version folds chunks of probes into a running board; any
    chunk width gives the one-chunk answer bit for bit."""
    from repro_torch.kernels.ivf_adc import ivf_adc_plain
    codes, slots, visit, luts, coarse, spp = _case(rng, per_probe=True)
    args = (_t(codes), _t(slots), _t(visit), _t(luts), _t(coarse))
    s0, i0 = ivf_adc_plain(*args, k=25, steps_per_probe=spp,
                           probe_chunk=visit.shape[1] // spp)
    s1, i1 = ivf_adc_plain(*args, k=25, steps_per_probe=spp,
                           probe_chunk=probe_chunk)
    assert torch.equal(i0, i1) and torch.equal(s0, s1)
