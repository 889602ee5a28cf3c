"""The collection and the query pools are a function of the seed."""
import torch

from cells import SEED, small
from harness import data


def made(cell, seed):
    gen, corpus, held = data.collection(cell.config["data"],
                                        data.held_rows(cell.traffic), seed,
                                        torch.device("cpu"))
    pool, which = data.query_pool(cell.traffic, held, gen)
    return corpus, pool, which


def hot(rows=5000):
    """The uniform cell with its queries drawn from 256 intents, Zipf 0.8:
    a traffic file of popular intents is data only."""
    cell = small("marco-ivfpq.uniform512", rows=rows)
    cell.traffic.update(intents=256, zipf=0.8)
    return cell


def test_same_seed_same_inputs():
    for cell in (small("marco-ivfpq.uniform512", rows=5000), hot()):
        a, b = made(cell, SEED), made(cell, SEED)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        c = made(cell, SEED + 1)
        assert not torch.equal(a[0], c[0])


def test_regenerate_gives_the_corpus_again():
    cell = small("marco-flat.clients32", rows=5000)
    corpus, _, _ = made(cell, SEED)
    again = data.regenerate(cell.config["data"], cell.traffic, SEED,
                            torch.device("cpu"))
    assert torch.equal(corpus, again)
    assert torch.equal(data.fingerprint(corpus), data.fingerprint(again))


def test_rows_are_unit_and_pools_take_their_intents():
    corpus, pool, which = made(hot(), SEED)
    assert torch.allclose(corpus.norm(dim=1), torch.ones(5000), atol=1e-5)
    assert torch.allclose(pool.norm(dim=1), torch.ones(2048), atol=1e-5)
    counts = torch.bincount(which, minlength=256)
    # Zipf 0.8 over 256 intents: rank 1 draws about 1/H = 6.5 % of 2,048
    assert counts[0] > 4 * counts[128:].float().mean()
    uni = small("marco-ivfpq.uniform512", rows=5000)
    _, _, which = made(uni, SEED)
    assert torch.equal(which, torch.arange(2048))
