"""Trainer CLI (port of ``repro.launch.train``): an arch id through the
registry, its data, the train step, AdamW, the checkpoint store and the
fault-tolerant supervisor, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch thistle-sbert --steps 30
    ... --full            # the full config (12 layers, d_model 768)
    ... --device cpu      # the plain PyTorch versions on the host
    ... --fail-at 10 20   # inject node failures; the supervisor restarts

The encoder family trains as the reference's CLI trains it: TokenStream
batches, the passage the query's tokens rolled by one, the contrastive
loss, clip 1.0, cosine warmup 10, AdamW. The ``lm``, ``gnn`` and
``recsys`` families raise ``NotImplementedError`` naming their ROADMAP
item (the LM's serving is ported; its training, ``loss_fn`` and the MTP
head's loss, is not). On the card the run is made deterministic
(``torch.use_deterministic_algorithms``, with ``CUBLAS_WORKSPACE_CONFIG``
set to ``:4096:8`` unless the environment sets it), so that a restart
replays the lost steps bit for bit.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.registry import PENDING, family, get_arch
from repro_torch.data.lm import TokenStream
from repro_torch.ft.faults import FailureInjector
from repro_torch.ft.supervisor import Supervisor
from repro_torch.train.sbert import EncoderJob


# what each family's training still needs (ROADMAP.md Queue 1)
TRAIN_PENDING = {
    "lm": "loss_fn and the MTP head's loss: ROADMAP.md Queue 1, item 9 "
          "(LM training)",
    **{fam: f"its models: {where}" for fam, where in PENDING.items()}}


def token_stream_batches(stream: TokenStream, batch: int, seq_len: int,
                         vocab_size: int):
    """The reference CLI's encoder batch: a TokenStream batch as the
    queries, each rolled by one token as its passage; no masks."""
    def batch_fn(step: int) -> dict:
        t = stream.batch(batch, seq_len, step)["tokens"] % vocab_size
        return {"q_tokens": t, "p_tokens": np.roll(t, 1, axis=1)}
    return batch_fn


class ArchJob(EncoderJob):
    """The reference's ``ArchJob`` for the families the port has."""

    def __init__(self, arch_id: str, *, full: bool, batch: int, seq_len: int,
                 lr: float, total_steps: int, fail_at=(), device=None):
        fam = family(arch_id)
        if fam != "encoder":
            raise NotImplementedError(
                f"training the {fam} family ({arch_id!r}) needs "
                f"{TRAIN_PENDING[fam]}")
        e = get_arch(arch_id)
        self.arch_id, self.family = arch_id, e.family
        cfg = e.full if full else e.smoke
        batches = token_stream_batches(TokenStream(vocab_size=cfg.vocab_size),
                                       batch, seq_len, cfg.vocab_size)
        super().__init__(cfg, batches, lr=lr, warmup=10,
                         total_steps=total_steps,
                         injector=FailureInjector(fail_at=fail_at),
                         device=device, log_every=10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true")
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
                  fail_at=args.fail_at, device=args.device)
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
