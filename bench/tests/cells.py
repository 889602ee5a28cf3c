"""Cells of the manifest cut to a size a test run holds: the widths and
the traffic's shape stay, the counts shrink."""
import copy

SEED = 2_147_483_659   # past 32 signed bits, as the benchmark's seeds may be


def small(name: str, rows: int = 20_000, dim: int = 64):
    """The manifest's cell ``name`` at ``rows`` rows of width ``dim``, a
    pool of 2,048 queries and blocks of 128; ivf_pq at floor(sqrt(rows))
    lists and 8 subspaces."""
    from harness import manifest
    c = manifest.cell(name)
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    c.workload = dict(c.workload, sample=96)
    c.config["data"].update(rows=rows, dim=dim)
    if c.config["engine"] == "ivf_pq":
        c.config["engine_args"].update(n_clusters=int(rows ** 0.5), m=8)
    c.traffic["pool"] = 2048
    if c.traffic["driver"] == "blocks":
        c.traffic.update(block=128, warmup_blocks=12)
    else:
        c.traffic.update(warmup_s=0.3)
    return c
