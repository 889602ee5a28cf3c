"""Trainer CLI (port of ``repro.launch.train``): an arch id through the
registry, its data, the train step, AdamW, the checkpoint store and the
fault-tolerant supervisor, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch thistle-sbert --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch fm --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-reddit --steps 20
    ... --full            # the full config (real-cluster scale)
    ... --device cpu      # the plain PyTorch versions on the host
    ... --fail-at 10 20   # inject node failures; the supervisor restarts
    ... --remat           # lm: checkpoint each block (recomputed backward)

Every family trains as the reference's CLI trains it: clip 1.0, cosine
warmup 10, AdamW, one step (``train.job.ModelJob``) over the family's loss
and data. ``lm``: ``TokenStream`` batches (tokens and labels mod the
vocabulary) through ``transformer.loss_fn`` (``--remat`` passes
``remat=True``, which the reference's ``loss_fn`` takes and its CLI does
not set). ``encoder``: the same batches, the passage the query's tokens
rolled by one, through ``contrastive_loss``. ``gnn``: full-graph
``node_loss`` on ``sbm_graph(400, 4, 16)`` (d_in 16 and 4 classes replace
the config's). ``recsys``: ``ClickLogs`` batches (``sequence_batch`` for
SASRec) through ``recsys.loss_fn``. Parameters are drawn from
``torch.Generator().manual_seed(0)`` on the host. On the card the run is
made deterministic (``torch.use_deterministic_algorithms``, with
``CUBLAS_WORKSPACE_CONFIG`` set to ``:4096:8`` unless the environment sets
it), so that a restart replays the lost steps bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.registry import get_arch
from repro_torch.data import ClickLogs, TokenStream, sbm_graph
from repro_torch.device import resolve_device
from repro_torch.ft.faults import FailureInjector
from repro_torch.ft.supervisor import Supervisor
from repro_torch.models import encoder as enc_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer
from repro_torch.train.job import ModelJob


def token_stream_batches(stream: TokenStream, batch: int, seq_len: int,
                         vocab_size: int):
    """The reference CLI's encoder batch: a TokenStream batch as the
    queries, each rolled by one token as its passage; no masks."""
    def batch_fn(step: int) -> dict:
        t = stream.batch(batch, seq_len, step)["tokens"] % vocab_size
        return {"q_tokens": t, "p_tokens": np.roll(t, 1, axis=1)}
    return batch_fn


def lm_batches(stream: TokenStream, batch: int, seq_len: int,
               vocab_size: int):
    """The reference CLI's LM batch: a TokenStream batch, tokens and labels
    taken mod the vocabulary."""
    def batch_fn(step: int) -> dict:
        return {k: v % vocab_size
                for k, v in stream.batch(batch, seq_len, step).items()}
    return batch_fn


def family_job(family: str, cfg, *, batch: int, seq_len: int,
               remat: bool = False):
    """(cfg, init, loss(model, batch), batch_fn) of a family, as the
    reference's ``ArchJob`` makes its data and loss (the GNN's config takes
    the graph's d_in and class count)."""
    if family == "lm":
        return (cfg, transformer.init,
                lambda m, b: transformer.loss_fn(m, cfg, b, remat=remat),
                lm_batches(TokenStream(vocab_size=cfg.vocab_size), batch,
                           seq_len, cfg.vocab_size))
    if family == "encoder":
        return (cfg, enc_lib.init,
                lambda m, b: enc_lib.contrastive_loss(m, cfg, b),
                token_stream_batches(TokenStream(vocab_size=cfg.vocab_size),
                                     batch, seq_len, cfg.vocab_size))
    if family == "gnn":
        graph = sbm_graph(400, 4, 16, seed=0)
        cfg = dataclasses.replace(cfg, d_in=16, n_classes=4)
        return (cfg, gnn_lib.init,
                lambda m, b: gnn_lib.node_loss(m, cfg, b),
                lambda step: graph)
    logs = ClickLogs(cfg)
    sample = logs.sequence_batch if cfg.kind == "sasrec" else logs.batch
    return (cfg, rec_lib.init, lambda m, b: rec_lib.loss_fn(m, cfg, b),
            lambda step: sample(batch, step))


class ArchJob(ModelJob):
    """The reference's ``ArchJob``: any arch id of the registry."""

    def __init__(self, arch_id: str, *, full: bool, batch: int, seq_len: int,
                 lr: float, total_steps: int, fail_at=(), device=None,
                 remat: bool = False):
        e = get_arch(arch_id)
        self.arch_id, self.family = arch_id, e.family
        cfg, init, loss, batch_fn = family_job(
            e.family, e.full if full else e.smoke, batch=batch,
            seq_len=seq_len, remat=remat)
        model = init(cfg, torch.Generator().manual_seed(0),
                     device=resolve_device(device), trainable=True)
        super().__init__(cfg, model, loss, batch_fn, lr=lr, warmup=10,
                         total_steps=total_steps,
                         injector=FailureInjector(fail_at=fail_at),
                         log_every=10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--remat", action="store_true",
                    help="lm: checkpoint each block (recompute it in the "
                         "backward pass)")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch versions; the card by "
                         "default")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    # read when the first cuBLAS handle is made: before the job touches the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    job = ArchJob(args.arch, full=args.full, batch=args.batch,
                  seq_len=args.seq_len, lr=args.lr, total_steps=args.steps,
                  fail_at=args.fail_at, device=args.device, remat=args.remat)
    if job.device.type == "cuda":
        torch.use_deterministic_algorithms(True)
    store = CheckpointStore(os.path.join(args.ckpt_dir, args.arch), keep=2)
    sup = Supervisor(job, store, total_steps=args.steps,
                     checkpoint_every=args.checkpoint_every,
                     on_event=lambda k, i: print(f"  [supervisor] {k}: {i}"))
    out = sup.run()
    store.wait()
    losses = [h["loss"] for h in out["history"]]
    print(f"done: {out['final_step']} steps, {out['n_retries']} restarts; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
