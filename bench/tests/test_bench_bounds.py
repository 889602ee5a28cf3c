"""The least-time formulas against numbers worked by hand at the cells'
shapes."""
import pytest
import torch

from harness import peaks

N, D = 8_841_823, 768


def test_topk_distance_bound_flat_cell():
    # bytes: N d 4 + N 4 + Q d 4 + Q k 8 = 27,197,548,412 at Q = 32, k = 10
    # -> 8.11867 ms at 3.35 TB/s; 2 Q N d = 4.3462e11 products: 3xTF32
    # 2.634 ms, float32 FMAs 6.487 ms: bytes bind
    t = peaks.topk_distance_bound(N, D, 32, 10, False)
    assert t == pytest.approx(27_197_548_412 / 3.35e12, rel=1e-12)
    assert t * 1e3 == pytest.approx(8.11867, abs=1e-5)
    # at Q = 512 the products bind: 3 x 2 Q N d / 495e12 = 42.142 ms
    t512 = peaks.topk_distance_bound(N, D, 512, 10, False)
    assert t512 * 1e3 == pytest.approx(3 * 2 * 512 * N * D / 495e12 * 1e3,
                                       rel=1e-12)
    assert t512 * 1e3 == pytest.approx(42.142, abs=1e-3)


def test_lookup_rate_is_derived_from_the_card():
    # 32 words a clock an SM x 132 SMs x 1,980 MHz
    assert peaks.lookup_rate(132, 1980.0) == pytest.approx(8.36352e12)


def test_ivf_adc_work_counts_each_probed_list_once():
    list_rows = torch.tensor([100, 200, 300, 400])
    probes = torch.tensor([[0, 1], [1, 2], [1, 3]])   # Q = 3, nprobe = 2
    n_bytes, lookups = peaks.ivf_adc_work(probes, list_rows, m=64, ksub=256,
                                          R=32)
    # lists 0-3 read once: 1,000 rows x (64 code bytes + 4 id bytes);
    # tables 3 x 64 x 256 x 4; coarse 3 x 2 x 8; result 3 x 32 x 8
    assert n_bytes == 1000 * 68 + 3 * 64 * 256 * 4 + 3 * 2 * 8 + 3 * 32 * 8
    # scored rows: 300 + 500 + 600 = 1,400, 64 lookups each
    assert lookups == 1400 * 64


def test_adc_bound_takes_the_larger_term():
    assert peaks.adc_bound(3.35e12, 1.0, 1e12) == pytest.approx(1.0)
    assert peaks.adc_bound(1.0, 2e12, 1e12) == pytest.approx(2.0)
