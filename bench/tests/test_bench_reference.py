"""The plain references against brute force in NumPy at a tiny size."""
import numpy as np
import torch

from reference import flat, ivf_pq

rng = np.random.default_rng(7)


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_flat_topk_is_brute_force():
    corpus = unit(rng.standard_normal((300, 16))).astype(np.float32)
    q = unit(rng.standard_normal((5, 16))).astype(np.float32)
    s, i = flat.topk(torch.from_numpy(corpus), torch.from_numpy(q), 7)
    c64, q64 = unit(corpus.astype(np.float64)), unit(q.astype(np.float64))
    want = np.argsort(-(q64 @ c64.T), axis=1, kind="stable")[:, :7]
    assert np.array_equal(i.numpy(), want)
    assert np.allclose(s.numpy(), np.take_along_axis(q64 @ c64.T, want, 1),
                       atol=1e-15)


def small_state(n=400, d=8, C=6, m=2, ksub=4):
    """A corpus and an IVF-PQ state encoded exactly from it."""
    x = unit(rng.standard_normal((n, d)))
    cent = unit(rng.standard_normal((C, d)))
    assign = np.argmax(2 * x @ cent.T - (cent ** 2).sum(1), axis=1)
    cb = rng.standard_normal((m, ksub, d // m)) * 0.3
    r = (x - cent[assign]).reshape(n, m, -1)
    t = 2 * np.einsum("nmd,mkd->nmk", r, cb) - (cb ** 2).sum(2)
    codes = np.argmax(t, axis=2)
    width = np.bincount(assign, minlength=C).max()
    buckets = -np.ones((C, width), np.int64)
    for c in range(C):
        rows = np.nonzero(assign == c)[0]
        buckets[c, :rows.size] = rows
    state = {"centroids": torch.tensor(cent, dtype=torch.float32),
             "codebooks": torch.tensor(cb, dtype=torch.float32),
             "codes": torch.tensor(codes, dtype=torch.uint8),
             "buckets": torch.tensor(buckets)}
    return torch.tensor(x, dtype=torch.float32), state


def brute_ivf_pq(x, state, q, nprobe, refine, k):
    """The engine's semantics in NumPy float64, one query at a time."""
    cent = state["centroids"].double().numpy()
    cb = state["codebooks"].double().numpy()
    codes = state["codes"].numpy().astype(np.int64)
    buckets = state["buckets"].numpy()
    x64 = unit(x.double().numpy())
    m = cb.shape[0]
    out = []
    for qq in unit(q.double().numpy()):
        coarse = cent @ qq
        lists = np.argsort(-coarse, kind="stable")[:nprobe]
        rows = np.concatenate([buckets[c][buckets[c] >= 0] for c in lists])
        owner = np.concatenate([[c] * int((buckets[c] >= 0).sum())
                                for c in lists])
        lut = np.einsum("md,mkd->mk", qq.reshape(m, -1), cb)
        adc = coarse[owner] + lut[np.arange(m), codes[rows]].sum(1)
        cand = rows[np.argsort(-adc, kind="stable")[:refine]]
        ex = x64[cand] @ qq
        out.append(cand[np.argsort(-ex, kind="stable")[:k]])
    return np.stack(out)


CFG = {"engine_args": {"nprobe": 2, "refine": 12}}


def test_ivf_pq_judge_passes_the_brute_force_answer_and_refuses_others():
    x, state = small_state()
    q = torch.tensor(unit(rng.standard_normal((20, 8))), dtype=torch.float32)
    ids = torch.tensor(brute_ivf_pq(x, state, q, 2, 12, 5))
    x64, q64 = unit(x.double().numpy()), unit(q.double().numpy())
    scores = torch.tensor(np.einsum("sd,skd->sk", q64, x64[ids.numpy()]),
                          dtype=torch.float32)
    missing = torch.zeros(20, dtype=torch.bool)
    lists, _ = ivf_pq.row_lists(state["buckets"], 400)
    own = {"centroids": state["centroids"], "codebooks": state["codebooks"],
           "coarse_err": ivf_pq.coarse_err(x, state["centroids"], lists)}
    got = ivf_pq.judge(x, q, scores, ids, missing, CFG, state, own)
    assert got["centroid_gap"] == got["codeword_gap_median"] == 0
    assert got["coarse_err_gap"] == 0
    assert got["assign_gap"] < 1e-12 and got["code_gap"] < 1e-12
    assert got["bad_rows"] == 0 and got["bad_answers"] == 0
    assert got["answer_gap"] < 1e-12 and got["score_err"] < 1e-6
    wrong = ids.clone()
    wrong[3, 4] = int(torch.tensor([r for r in range(400)
                                    if r not in ids[3]])[0])
    bad = ivf_pq.judge(x, q, scores, wrong, missing, CFG, state, own)
    assert bad["answer_gap"] > 1e-3 and bad["score_err"] > 1e-3
    dup = ids.clone()
    dup[0, 1] = dup[0, 0]
    assert ivf_pq.judge(x, q, scores, dup, missing, CFG, state, own)[
        "bad_answers"] == 1


def test_ivf_pq_stage_numbers_see_a_misfiled_row_and_a_wrong_code():
    x, state = small_state()
    codes = state["codes"].clone()
    codes[5, 0] = (int(codes[5, 0]) + 1) % 4
    assert ivf_pq.stage_numbers(x, dict(state, codes=codes))["code_gap"] > 1e-6
    buckets = state["buckets"].clone()
    row = int(buckets[0, 0])
    buckets[0, 0] = -1 if buckets[0, 1] < 0 else int(buckets[0, 1])
    got = ivf_pq.stage_numbers(x, dict(state, buckets=buckets))
    assert got["bad_rows"] >= 1
    # misfiled: the row sits once, but in list 1 instead of its own
    b2 = state["buckets"].clone()
    b2 = torch.nn.functional.pad(b2, (0, 1), value=-1)
    b2[0][b2[0] == row] = -1
    b2[1, -1] = row
    got = ivf_pq.stage_numbers(x, dict(state, buckets=b2))
    assert got["bad_rows"] == 0 and got["assign_gap"] > 1e-6


TRAIN = {"engine_args": {"n_clusters": 5, "m": 2, "ksub": 4,
                         "kmeans_iters": 3, "seed": 0}}


def numpy_train(x, args):
    """The engine's training in NumPy float64, a centroid and a codeword
    at a time, from the same draws of the same generator."""
    n = x.shape[0]
    C, m, ksub = args["n_clusters"], args["m"], args["ksub"]
    gen = torch.Generator().manual_seed(args["seed"])
    x64 = unit(x.astype(np.float64))

    def lloyd(rows, cent):
        for _ in range(args["kmeans_iters"]):
            a = np.argmax(2 * rows @ cent.T - (cent ** 2).sum(1), axis=1)
            for c in range(cent.shape[0]):
                if (a == c).any():
                    cent[c] = rows[a == c].mean(axis=0)
        return cent

    cent = unit(lloyd(x64, x64[torch.randperm(n, generator=gen)[:C]
                                .numpy()].copy()))
    assign = np.argmax(2 * x64 @ cent.T - (cent ** 2).sum(1), axis=1)
    r = (x64 - cent[assign]).reshape(n, m, -1)
    starts = [torch.randperm(n, generator=gen)[:ksub].numpy()
              for _ in range(m)]
    cb = np.stack([lloyd(r[:, j], r[starts[j], j].copy())
                   for j in range(m)])
    return cent, cb, assign


def test_train_is_the_engines_training_in_numpy():
    x = rng.standard_normal((400, 8)).astype(np.float32)
    own = ivf_pq.train(torch.from_numpy(x), TRAIN)
    cent, cb, assign = numpy_train(x, TRAIN["engine_args"])
    assert np.allclose(own["centroids"].numpy(), cent, atol=1e-12)
    assert np.allclose(own["codebooks"].numpy(), cb, atol=1e-12)
    assert np.array_equal(own["assign"].numpy(), assign)
    e_c = ((unit(x.astype(np.float64)) - cent[assign]) ** 2).sum(1).mean()
    assert np.isclose(own["coarse_err"], e_c, rtol=1e-12)


def test_train_numbers_see_an_under_trained_and_a_bf16_state():
    x = torch.from_numpy(unit(rng.standard_normal((2000, 16))).astype(
        np.float32))
    cfg = {"engine_args": dict(TRAIN["engine_args"], n_clusters=20,
                               ksub=16)}
    own = ivf_pq.train(x, cfg)
    assert set(ivf_pq.train_numbers(own, own).values()) == {0.0}
    short = {"engine_args": dict(cfg["engine_args"], kmeans_iters=2)}
    got = ivf_pq.train_numbers(ivf_pq.train(x, short), own)
    assert got["codeword_gap_median"] > 1e-3
    assert got["coarse_err_gap"] > 1e-4
    got = ivf_pq.train_numbers(ivf_pq.train(x, cfg, torch.bfloat16), own)
    assert got["centroid_gap"] > 1e-3
