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


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("Q,k", [(1, 10), (33, 200), (70, 256)])
def test_topk_distance_kernel_matches_plain(metric, Q, k):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(Q + k)
    corpus = torch.randn(20_011, 96, generator=g, device=dev)
    corpus = torch.cat([corpus, corpus[:50]])  # duplicates tie to the lower id
    q = torch.randn(Q, 96, generator=g, device=dev)
    valid = torch.rand(corpus.shape[0], generator=g, device=dev) < 0.9
    ks, ki = ops.topk_distance(corpus, q, k=k, metric=metric, valid=valid)
    ps, pi = ops.topk_distance(corpus, q, k=k, metric=metric, valid=valid,
                               use_kernel=False)
    torch.cuda.synchronize()
    scale = (torch.linalg.vector_norm(q, dim=1)[:, None]
             * torch.linalg.vector_norm(corpus, dim=1).max())
    tol = (2 if metric == "l2" else 1) * 2 * 96 * 2.0 ** -24 * scale
    assert bool(((ks - ps).abs() <= tol + 1e-6 * ps.abs()).all())
    assert bool(valid[ki.long()].all())
    # ids equal but for near-ties: where they differ, the kernel's row
    # scores, exactly, within the tolerance of the plain score at that rank
    rows, cols = torch.nonzero(ki != pi, as_tuple=True)
    c64, q64 = corpus[ki[rows, cols].long()].double(), q[rows].double()
    exact = ((c64 * q64).sum(1) if metric == "dot"
             else -((q64 - c64) ** 2).sum(1))
    gap = (exact - ps[rows, cols].double()).abs()
    assert bool((gap <= 2 * tol[rows, 0].double() + 1e-6).all())


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
def test_ivf_adc_kernel_matches_plain(metric, lut_dtype):
    dev = _card()
    rng = np.random.default_rng(1)
    centres = rng.normal(size=(40, 64)).astype(np.float32)
    corpus = centres[rng.integers(0, 40, 30_000)] + rng.normal(
        size=(30_000, 64)).astype(np.float32)
    db = VectorDB("ivf_pq", metric=metric, m=16, lut_dtype=lut_dtype,
                  refine=0, device=dev).load(corpus)
    q = torch.as_tensor(corpus[:37], device=dev)
    ops.reset_launch_counts()
    db.query(q, k=50)
    assert ops.launch_counts()["ivf_adc"] == 1
    # the kernel and its plain version on the inputs the engine builds
    idx = db.index
    probe_metric = "dot" if metric == "cosine" else metric
    if metric == "cosine":
        q = D.l2_normalize(q)
    visit, luts, coarse = _ivf_probe_stage(
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
