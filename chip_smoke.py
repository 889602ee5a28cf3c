#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n ROWS] [--seed S] [--rank R] [--min-recall X]
                          [--snapshot-dir DIR] [--phases LIST]

``--phases 4,12-13`` runs phases 1 and 2 and those (each makes its own
data from ``--seed``; 7 runs inside 6); every phase by default.

Phases, in order; any failure raises and the script exits non-zero:
  1. header: the card's name, power limit and top SM clock (nvidia-smi),
     torch and CUDA;
  2. build: the six CUDA sources (topk_distance, pq_adc, ivf_adc with its
     three grids, hamming with its matrix and shortlist entries,
     flash_attention, visit_sharing), one nvcc each, in parallel; the
     ptxas lines (registers, shared memory, spills);
  3. kernel against plain version at mid size (262,144 rows, d = 768,
     m = 64): ``topk_distance`` with float32 and bf16 corpora for {dot, l2}
     x k in {1, 10, 256} x Q in {1, 5, 16, 32, 33, 128, 512} (every
     query-tile template and a ragged Q) on a ragged N with duplicated rows
     (ties) and a tenth of the rows knocked out; ``pq_adc`` for {dot, l2} x {float32, bfloat16, int8} x
     Q in {1, 32, 512} x k in {10, 200} and a scan_all-shaped case (an
     extra subspace as wide as the cluster count), then at every query
     tile that fits (and the plan's) for each table type x m in {8, 64, 7}
     x Q in {1, 2, 3, 9, 33, 512} x k in {1, 32, 256} on a ragged N with
     duplicated rows and a tenth knocked out, and with the wide extra
     column at every tile; ``ivf_adc``,
     ``ivf_adc_blocked`` and ``ivf_adc_run_resident`` for {dot, l2,
     cosine} x {float32, bfloat16, int8} x Q in {1, 32, 512} (the grouped
     grids at qblk 8, and 4 and 16 for float32 dot), each grouped result
     also against the per-query kernel's, bit for bit; the per-query
     kernel (the plan's variant and the direct-read one, with and without
     the pad block) on synthetic inputs with 0, 30, 60 and 100 % of the
     steps on the pad block for each table type and shared and per-probe
     tables, one real step among 4,095, a query on the pad block alone and
     one with every probe knocked out at k in {1, 256}, m = 7 and m = 210
     float32 at k = 256, against its plain version and both grouped
     kernels (but at m = 210, which no tile fits), bit for bit; the
     grouped grids on synthetic inputs at Q one below, at and one above
     the plan's tile
     width and the widest that fits (at the plan's width and forced to the
     widest: a ragged last tile)
     for each table type, shared and per-probe tables, m in {64, 8, 7}
     (16-byte, word and byte code reads), k in {1, 32, 256}, qblk in
     {4, 8, 16}, and with tiles that have no scheduled pair, a query
     whose every probe is knocked out and an adaptive probe mask, each
     against its plain version and the per-query kernel; ``hamming`` and
     ``hamming_shortlist`` for (T, W) in {(4, 4), (8, 2), (1, 8)} x Q in
     {1, 32, 512} (the shortlist at L in {10, 64, 256}) on words over the
     full 2^32 range, a ragged N and codes of five distinct values (ties
     everywhere), and the shortlist on six distinct codes over 150,011
     rows (ties straddling every threshold) at L in {1, 64, 256} x Q in
     {1, 8, 9, 32, 33, 512}, bit for bit; ``flash_attention`` in bf16 and
     float32 on the reference's FLASH_CASES, the encoder's shapes (B = 32, H = 12,
     dh = 64, S in {64, 128, 512}) with ragged key-padding masks and one
     fully masked row, GQA (H = 8, KV = 2) and dh = 80 at a ragged S = 200,
     causal and not, and the sliding window (W in {1, 17, 64, S - 1, 100,
     4,096} on ragged S, causal and not, with ragged masks and a padded
     hole that leaves rows fully masked inside their window; danube's
     heads 32/8 at dh 80, MLA's 16 at dh 192), within the reference's
     2e-5 / 2e-2;
  4. main path at full size on the MS MARCO v1 passage count (8,841,823
     rows) of d = 768 cosine embeddings, clustered synthetic data made on
     the card from ``--seed``: ``VectorDB("flat")``, then
     ``VectorDB("flat", dtype=torch.bfloat16)`` (the float32 one dropped;
     its recall@10 against the float32 truth), ``VectorDB("pq")``,
     then ``VectorDB("ivf_pq")`` served under adc_mode auto (the default),
     per_query, blocked and run_resident from one trained state (every
     grid's ids and scores equal per_query's bit for bit), and scan_all at
     Q = 32, the sharing count's kernel (``visit_sharing``, which auto
     launches where no grouped grid's board fits, as at Q = 512) and its
     plain version on the engine's visit tables at Q = 1, 32, 512, each
     equal to the host probe's count, and timed; the three ivf_adc
     kernels at Q = 1, 32, 512 beside their
     times before this design, each kernel's device time by the profiler
     (scan and merges) and the visit steps the per-query kernel scored,
     counted by the kernel, against the real ones and Q x T, and on the
     hot set (32 corpus rows x 16 noisy copies, shuffled: its sharing
     factor, all three grids at Q = 32 and 512, the grouped ones bit-equal
     to their plain versions and the per-query kernel, the per-query one
     to its plain version at Q = 32), then ``VectorDB("lsh")`` at the reference
     defaults (128 bits, 4 tables, shortlist 64) with the earlier engines
     dropped, its kernel
     path's ids and scores equal to the plain path's at Q = 1 and 32, and
     its stage times; load seconds, p50/p99 latency and QPS at Q = 1, 32, 512,
     recall@10 against flat, each kernel's time beside its bound, the plain
     version's and a library call's time (``pq_adc`` and
     ``hamming_shortlist`` at Q = 1, 32, 512 with their launch plans and
     their times before this design, at every query tile, by k and by L),
     launches on each engine's path, full-size batches of each kernel
     against its plain version, peak device memory and each phase's
     seconds. Filtered search on the same engines: flat, pq and ivf_pq load
     seeded metadata on every row (``year``, an integer column of 128
     values; ``cat``, 8 categories; ``flag``, a boolean), and five
     predicates (one in each of the reference's selectivity buckets, <= 1,
     <= 10, <= 50 and > 50 %, and one that allows every row) run at Q = 1,
     32, 512, k = 10, on flat, pq, ivf_pq under each adc_mode and scan_all:
     each bitmap's host build and upload timed apart from the query, p50 /
     p99 of the filtered query, filter_stats with the nprobe boosts;
     checks: no id outside its bitmap, the all-true predicate's answer
     bit-equal to the unfiltered one, every grid equal to per_query on
     filtered batches, each kernel on each bitmap's inputs against its
     plain version (topk_distance within its bound, pq_adc and the three
     ivf_adc grids at the boosted nprobe bit for bit), filtered flat against
     a brute-force filtered top 10 (float64); filtered recall@10 against
     filtered flat by bucket, gated at ``--min-recall`` above 10 % for
     ivf_pq and scan_all;
  5. the text path at full width, after the engines of phase 4 are
     dropped: thistle-sbert FULL (12 layers, d_model 768, bf16, seeded
     random weights) encodes 131,072 MarcoLike passages (seq_len 64)
     through ``VectorDB("flat").load_texts`` and serves ``query_texts`` at
     Q = 1, 32, 512; load split (tokenize, encode, index), p50/p99 and QPS,
     stage times, ``flash_attention``'s time beside its bound, its plain
     version's and ``F.scaled_dot_product_attention``'s, one encoder
     block's stage times, one encode at max_seq_len 512; hybrid search:
     ``enable_lexical`` over the passages (its build time), ``query(...,
     hybrid=alpha, hybrid_texts=...)`` at Q = 1, 32, 512 (alpha = 1 equal to
     the dense ids, alpha = 0 to BM25's ranking, p50 at alpha = 0.5 with
     BM25's share); and three gates: the encoder through the kernel
     against the same forward through the plain attention (cosine >=
     0.999 at (32, 64) and (32, 512)), 512 passages sent back as queries
     finding themselves in their top 10 (>= 99 %), and the kernel
     launched on the path;
  6. mutation and serving, after phase 5, on the phase-4 data made again
     from ``--seed``: ``VectorDB("ivf_pq")`` at the reference defaults but
     m = 64, with phase 4's metadata columns (its copy of the data dropped
     after load), takes the reference's mutation mix (BENCH_mutation.json's
     paths): 88,418 new rows of the same distribution inserted in batches of
     1,024, 884,182 random live ids deleted in batches of 8,192, 88,418
     other live ids upserted with fresh vectors in batches of 1,024 (inserts
     and upserts with metadata), then ``compact``;
     rows/s of each, compact seconds, the layout's capacity, blocks and
     steps_per_probe and plan_generation before and after, p50/p99 under
     every adc_mode at Q = 1, 32, 512 before the writes, at 10 %
     tombstones and after compact, each ivf_adc kernel's time and the
     visit steps the per-query kernel scored (equal to the real ones);
     checks: no deleted id in any result, every grid equal to per_query
     bit for bit and the kernels to their plain versions on the mutated
     and the compacted layout, 512 inserted and 512 upserted rows found in
     their own top 10 (>= 99 %), results after compact equal to those
     before it (ties aside), the re-rank rows of the written ids equal to
     ``preprocess_corpus`` of the vectors written, the size the writes
     imply, recall@10 against the exact top 10 over the live rows
     (``topk_distance`` on the engine's corpus under the live mask, the
     kernel against its plain version) >= ``--min-recall``; then
     ``QueryEngine`` and ``AsyncQueryEngine`` (max_batch 64) on the
     mutated index: 2,048 single reads with a 64-row insert or delete
     after every 8 (interleaved_1to8; a read behind an insert finds the
     row, no read sees an id deleted before it) and 2,048 reads alone
     (ids equal ``db.query(bucketize=False)``), p50/p99, QPS,
     queue_depth_max, plan hits and misses; then phase 7 on that index;
     then ``flat`` (float32, bf16) and ``pq`` at 262,144 rows under the
     same mix, scaled: each kernel path against its plain path on the
     mutated buffers and the float32 flat against brute force over the
     live rows; peak device memory;
  7. durability on phase 6's index (N = 8,841,823 plus its writes): the
     snapshot directory's free bytes, filesystem type and the host's
     MemTotal (below 1.2 x the snapshot's bytes free, the phase runs on a
     262,144-row ivf_pq and says so); ``save_index(step=1, durable=True)``
     (seconds, bytes, GB/s); a logged write mix with an fsync a record (16
     insert batches of 1,024 with metadata, 2 delete batches of 8,192, 4
     upsert batches of 1,024, compact), rows/s beside phase 6's, the log's
     bytes and fsyncs; the answers at Q = 1, 32, 512 under per_query and
     auto, a filtered batch, size, generation, the writes since the
     snapshot, the live ids with their clusters and codes copied to the
     host; a crash (the db dropped without a save); ``restore_index(durable
     =True)`` into a fresh db (read, upload, rebuild and replay seconds,
     records replayed), and everything copied must come back equal, answers
     bit for bit (ids may swap only between exactly tied scores); the
     interleaved_1to8 stream through ``AsyncQueryEngine(fsync_interval_ms
     =2)`` on the restored index (QPS, p50/p99, wal_records, wal_fsyncs),
     read-your-writes, and each write resolved only once the log's
     synced_lsn reached its record, then a burst of 64 inserts queued at
     once through the same front (records against fsyncs); flat
     (float32, bf16), pq and lsh at
     262,144 rows saved and restored, serving the saved answers bit for bit
     (the restored lsh through ``hamming``); ``--snapshot-dir`` (the
     system's temporary directory by default) holds a directory of its
     own, removed at the end;
  8. the remaining engines at full size, one at a time, on the phase-4
     data made again, against the float32 ``flat`` truth at Q = 1, 32,
     512 (ids kept, the engine dropped): ``VectorDB("ivf")`` (C = 2973,
     nprobe 8; the data's copy dropped after load) with its bucket facts,
     p50/p99 and QPS, recall@10 (gated at ``--min-recall`` at Q = 512), 8
     queries against a float64 brute force over the probed buckets, the
     five predicates at Q = 32 (ids inside the bitmap, all-true equal to
     no filter), then 8 insert batches of 1,024 rows, a delete batch of
     8,192 and an upsert batch of 1,024 (rows/s), ``compact``, every
     written id in its assigned cluster's bucket row, written rows found
     in their own top 10 at the loaded rows' rate less 0.02, no deleted
     id in an answer; ``VectorDB("int8")`` (recall gated; the kernel path
     against its plain path at Q = 32 within ``topk_tolerance``; 8 queries
     against a float64 ``(q . c_q) * scale``; the scan's times and split;
     the five predicates at Q = 32); ``VectorDB("graph")``: the build at
     262,144 rows through the kernel against the plain build (forward
     slots equal but for near-ties, the table at 99.9 % or more), the full
     build's split (host draws, chunk loop, symmetrize) and launches,
     p50/p99, recall (printed), the entry scan kernel against plain and
     beam search through the kernel against ``use_kernel=False`` (rows
     with equal seeds bit-equal); load seconds, GB held and peak memory
     of each; ``topk_distance``'s launches on the phase's path;
  9. the mesh fronts at full size, on the phase-4 data made again, against
     the float32 ``flat`` truth (kept, the engine dropped), on meshes
     (1,), (4,) ``data`` and (2, 2) ``data`` x ``model`` that repeat the
     card (S logical shards on one card; with two cards or more, also a
     mesh over all of them): ``DistributedVectorDB`` float32 at each mesh
     (ids and scores bit-equal to ``flat`` at (1,), near-ties aside at
     the others; each shard's ``topk_distance`` against its plain version
     at Q = 32, its time and the merge's), bf16 at (4,) against the
     single-host bf16 ``flat``; ``DistributedPQ`` (m = 64, float32
     tables) at (4,) and, from its state, (2, 2): answers equal to the
     same tables through the single-host ``adc_topk`` over the unsharded
     codes, recall@10, ``per_device_bytes``, each shard's ``pq_adc``
     against plain; ``DistributedIVFPQ`` (C = 2973, nprobe 8, m = 64, blk
     32, ``auto``) trained at (4,) and served at every mesh from its state
     (answers equal to the single-host per-query grid on the unsharded
     layout with the same probes and tables) and on the hot set; then at
     (4,) the mutation cell's batches (8 inserts of 1,024, a delete of
     8,192, an upsert of 1,024, compact): written rows' slots and codes
     exact, no deleted id back, written rows found in their own top 10 at
     the loaded rows' rate less 0.02, each spilled block on its owner
     shard wherever that shard has room; ``QueryEngine`` and
     ``AsyncQueryEngine`` on a 256-read interleaved_1to8 stream (every
     read equal to a twin's ``db.query(bucketize=False)`` with the writes
     applied in order); each shard's three ``ivf_adc`` grids against their
     plain versions at Q = 32, the per-query kernel's time a shard, the
     merge's and the sharing probe's host ms; load seconds, peak GB and
     p50/p99 at Q = 1, 32, 512 for each engine and mesh;
 10. training at full width (examples/train_sbert.py --preset full's
     settings: MarcoLike 2,000 passages at seq 24, batch 64, lr 3e-4 with
     warmup 20 and cosine decay, clip 1.0, weight decay 0.01, 80 steps
     (the example's 300 cut to keep the script inside its time limit),
     a checkpoint every 20 in ``--snapshot-dir``): one contrastive_loss
     step's gradients at B = 8 on the card against the CPU from one seeded
     state, in bf16 and in a float32 copy of the config (the CPU tests'
     bounds); the run through the port's ``Supervisor`` and
     ``CheckpointStore`` with failures injected at steps 30 and 70,
     against an uninterrupted run (parameters and Adam moments bit-equal;
     ``torch.use_deterministic_algorithms`` on for the phase's training,
     with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set at the start of the
     script): loss and in-batch accuracy every 20 steps, step p50 / p99,
     tokens/s, peak device memory, each checkpoint's copy and write
     seconds; retrieval top-1 before and after (the example's
     ``retrieval_accuracy``: ``encode`` through ``flash_attention`` and
     ``VectorDB("flat", metric="cosine")`` through ``topk_distance``, their
     launches; after must beat before), the trained tower's kernel encode
     against ``use_kernel=False`` (row cosine >= 0.999); 80 steps with
     int8 Adam state (its loss curve beside float32's, the moments' bytes
     against ``adam_state_bytes``); the loss's last-20-step mean below its
     first-20 in both; ``gradient_accumulation`` on a batch of 64 at
     n_micro = 4 against n_micro = 1 (a per-pair loss, float32 copy) and
     against the four quarters' mean (the contrastive loss), rtol 1e-4 /
     atol 1e-5;
 11. LM serving at full width with seeded weights on the card:
     h2o-danube-1.8b FULL (GQA 32/8, dh 80, window 4,096, float32
     parameters): prefill at B = 2, S = 8,192 (the kernel's window and
     tile skip; the cache rolled into a ring of 4,096), a 4,000-token
     prompt at B = 2 greedily decoded for 100 steps (the ring wraps), and
     ``embed_pooled`` on a padded batch (lengths 5,120 to 1); then
     deepseek-v2-lite-16b FULL with bf16 parameters (MLA through the
     kernel at dh 192, 64 experts top-6 + 2 shared): prefill at B = 4,
     S = 1,024 and 16 greedy steps. Each: prefill seconds and tokens/s,
     decode step p50 / p99 and tokens/s, the cache's bytes, peak GB, the
     MoE's dropped_frac, ``flash_attention``'s launches and its time at
     the prefill's shape beside its bound, its plain version's and
     ``F.scaled_dot_product_attention``'s (a boolean mask, k and v
     repeated for GQA), one prefill's and one decode step's device time
     by the profiler. Gates: the last-token logits through the kernel
     against the plain attention (row cosine >= 0.999; danube's
     ``embed_pooled`` too), decode at S after prefill(S) against
     prefill(S + 1) (>= 0.99), two greedy runs equal, and the kernel at
     the phase's shapes against its plain version (2e-2). The seeded
     v2-lite routes its tokens alike and drops most assignments at its
     capacity factor, where one changed choice moves every later token's
     slot: its two comparisons are printed there and at the dropless
     capacity (C = t) in bf16, with the tokens that change expert between
     kernel and plain attention counted; its gates hold the dropless
     capacity, the kernel one with float32 activations;
 12. LM training at full width (``transformer.loss_fn`` through the
     trainer's step: clip 1.0, cosine warmup 10, AdamW float32, lr 1e-3,
     TokenStream batches): h2o-danube-1.8b FULL at B = 2, S = 4,096 with
     remat, 20 steps; deepseek-v2-lite-16b FULL cut to its first (dense)
     layer and 2 MoE layers at full width, B = 4, S = 1,024, 10 steps;
     deepseek-v3 SMOKE with its MTP head. Gates: danube's step-0 loss and
     every leaf's gradient with bf16 activations against float32 on the
     card (1e-2 relative, cosine >= 0.99), card against CPU in float32 at
     B = 1, S = 32 (1e-5, cosine >= 0.9999); v2-lite's load_balance and
     router_z finite and positive, card against CPU float32 dropless at
     B = 1, S = 64 (1e-4, cosine >= 0.99); v3's loss with ``mtp_ce`` card
     against CPU (1e-5, cosine >= 0.99999); each loss falls (the mean of
     the first 5 steps above the last 5's). Step p50 / p99, tokens/s,
     6 N tokens over the step time against 989 TFLOP/s, one step's
     device-busy ms (profiler), peak GB, the parameters' and moments' GB,
     v2-lite's dropped_frac;
 13. recsys and GNN: fm, deepfm, autoint (39 sparse + 13 dense fields,
     33,001,472 table rows) and sasrec (1,000,001 items, seq 50) FULL, 30
     steps each of 65,536 rows (``ClickLogs``), each card against CPU in
     float32 on 1,024 rows at the full tables (1e-5, cosine >= 0.99999),
     its loss falling, step p50 and examples/s; retrieval through
     ``VectorDB("flat", metric="dot")``: the trained fm's item field 0
     (9,016,073 items, d = 11), sasrec's item table (1,000,448 x 50),
     autoint's (d = 64), each at Q = 1 and 512 (p50, ``topk_distance``
     against its plain version on the engine's padded buffer, kernel,
     plain and ``torch.matmul`` + ``torch.topk`` ms beside the bound,
     launches), fm's MIPS top item for 8 users against ``fm_forward``
     re-scored over every item; GraphSAGE-reddit FULL on
     ``sbm_graph`` at reddit's 232,965 nodes (avg_degree ``GNN_DEGREE``),
     50 ``block_loss`` steps of 1,024 sampled seeds (fanouts 25, 10)
     with features on the card, card against CPU on one batch (1e-5,
     cosine >= 0.99999), held-out accuracy > 0.5, the sampler's host ms
     beside the step's device ms; ``node_loss`` at cora's shape and
     ``graph_loss`` on ``molecule_batch(128)``, 20 steps each;
 14. ``launch/`` on ``torch.distributed``: a world of one rank over NCCL,
     a (1, 1) ("data", "model") ``DeviceMesh``, each cell's program from
     ``launch.steps`` on DTensors: h2o-danube-1.8b FULL ``prefill_32k``
     cut to B = 2, S = 8,192 (phase 11's shape; the last-token logits
     against the unsharded ``transformer.prefill``, row cosine >= 0.999,
     with ``flash_attention`` on each rank's local heads), 16
     ``make_lm_decode`` steps after it against ``decode_step`` (>= 0.99),
     ``train_4k`` cut to global batch 2, S = 4,096, 2 micro-batches,
     remat, float32 AdamW, 2 steps (after step 1 the loss within rel 1e-6
     and every leaf within rel 1e-6 and cosine >= 0.99999 of the
     single-process ``gradient_accumulation`` + clip + ``adamw_update``
     from the same state), sasrec FULL ``serve_p99`` (B = 512, the
     two-level search with ``topk_distance`` on the local shard; ids
     against ``flat_search`` over the item table, ties aside), fm FULL
     ``retrieval_cand`` (ids and scores against the matmul and top-k on
     one card), graphsage FULL ``full_graph_sm`` (one ``make_gnn_train``
     step, and ``make_partitioned_loss`` against ``node_loss``), and
     ``gspmd_flat_search`` over 1,000,000 x 768 rows at Q = 32 against
     ``flat_search``; each step's p50, the collectives DTensor ran
     (``CommDebugMode``), peak GB; then ``flash_attention`` and
     ``topk_distance`` at the phase's shapes against their plain versions;
 15. a JSON line of the kernels (phases 8-11, 13 and 14's launches
     added), then the result line.

It needs one CUDA card and the repository's ``src/`` beside it, and it
imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

MARCO_PASSAGES = 8_841_823   # MS MARCO v1 passage collection
DIM = 768                    # SBERT embedding width (configs/thistle_sbert.py)
M_SUBSPACES = 64             # 12 dimensions a subspace
MID_ROWS = 262_144
BATCHES = (1, 32, 512)
REPS = {1: 30, 32: 12, 512: 4}
GROUPED = ("blocked", "run_resident")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM dense TF32 on the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 on the tensor cores
TOPK_QS = (1, 5, 16, 32, 33, 128, 512)  # every query-tile template, a ragged Q
TOPK_KS = (1, 10, 256)
# 32-bit population counts a clock per SM at compute capability 9.0 (CUDA
# C++ Programming Guide, arithmetic instruction throughput table); times the
# SM count and the top SM clock nvidia-smi reports, it bounds hamming (three
# popcounts for each four-word table of a (query, row) pair, main_lsh)
POPC_PER_CLOCK_PER_SM = 16
# 32-bit shared-memory words served a clock per SM (32 banks): an ADC table
# term is one lookup; times the SM count and the top SM clock, it bounds
# pq_adc and the ivf_adc grids together with their adds, which run at half
# FP32_OPS_PER_S (an add is one operation, an FMA two)
LOOKUPS_PER_CLOCK_PER_SM = 32
# The redesigned kernels' times before this design (PERF.md section 6:
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; pq_adc float32 table,
# k = 32; hamming_shortlist L = 64; the ivf_adc grids float32 tables,
# k = 32, the grouped ones at qblk = 8), printed beside this run's
EARLIER_MS = {"pq_adc": {1: 1.675, 32: 42.960, 512: 757.685},
              "hamming_shortlist": {1: 0.715, 32: 8.822, 512: 46.098},
              "ivf_adc": {1: 0.127, 32: 0.286, 512: 2.043},
              "ivf_adc_blocked": {1: 0.254, 32: 0.747, 512: 4.357},
              "ivf_adc_run_resident": {1: 0.277, 32: 0.774, 512: 4.515}}
PQ_TILE_MS = (8, 64, 7)        # phase 3's pq_adc sweep: m = 7 is byte-staged
PQ_TILE_QS = (1, 2, 3, 9, 33, 512)
PQ_TILE_KS = (1, 32, 256)
GROUPED_TILE_MS = (64, 8, 7)   # phase 3's grouped sweep: 16-byte, word, byte reads
GROUPED_QBLKS = (4, 8, 16)
PAD_SHARES = (0.0, 0.3, 0.6, 1.0)  # phase 3's per-query sweep: pad steps
HOT_ROWS, HOT_COPIES = 32, 16  # phase 4's hot set (hot_queries)
TIE_ROWS = 150_011             # phase 3's hamming tie case
HAMMING_SHAPES = ((4, 4), (8, 2), (1, 8))   # (tables, words): 128, 16, 256 bits
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's (tests/test_kernels.py)
FLASH_MID_CASES = (
    # (B, Sq, Sk, H, KV, dh, causal, masked)
    # the reference's FLASH_CASES, (BH, S, dh) as B = BH, H = 1
    (2, 128, 128, 1, 1, 64, True, False),
    (1, 256, 256, 1, 1, 128, True, False),
    (3, 128, 128, 1, 1, 32, False, False),
    (2, 192, 192, 1, 1, 64, True, False),
    (1, 64, 64, 1, 1, 80, False, False),
    # the encoder's shapes, ragged lengths and one empty row
    (32, 64, 64, 12, 12, 64, False, True),
    (32, 128, 128, 12, 12, 64, False, True),
    (32, 512, 512, 12, 12, 64, False, True),
    # GQA
    (4, 256, 256, 8, 2, 64, False, True),
    (4, 256, 256, 8, 2, 64, True, True),
    # dh = 80 at a ragged S
    (4, 200, 200, 4, 4, 80, False, True),
    (4, 200, 200, 4, 4, 80, True, True),
)
FLASH_WINDOW_CASES = (
    # (B, S, H, KV, dh, causal, window, mask): "ragged" lengths 1..S with
    # the last row empty, or a "hole" (keys S/3..2S/3 padded in every row:
    # a causal row whose window lies in it is fully masked there)
    (2, 200, 4, 2, 64, True, 1, "ragged"),
    (2, 200, 4, 2, 64, False, 1, "ragged"),
    (2, 333, 4, 4, 64, True, 17, "hole"),
    (2, 333, 4, 4, 64, False, 17, "hole"),
    (3, 257, 2, 1, 32, True, 64, "ragged"),
    (3, 257, 2, 1, 32, False, 64, "hole"),
    (2, 130, 2, 2, 16, True, 129, "hole"),
    (2, 130, 2, 2, 16, False, 129, "ragged"),
    # h2o-danube's heads (GQA 32/8, dh 80), its window at a ragged S past it
    (2, 520, 32, 8, 80, True, 64, "hole"),
    (1, 4500, 32, 8, 80, True, 4096, "ragged"),
    # MLA's heads (16, dh 192: qk_nope 128 + qk_rope 64, v padded)
    (2, 520, 16, 16, 192, True, None, "ragged"),
    (2, 520, 16, 16, 192, True, 100, "hole"),
    (2, 333, 16, 16, 192, False, None, "hole"),
)
TEXT_PASSAGES = 131_072      # MarcoLike passages of the text phase
TEXT_SEQ = 64                # tokens a text
TEXT_BATCH = 512             # load_texts batch
TEXT_FLASH_SHAPES = ((512, 64), (32, 64), (1, 64), (32, 512))  # (B, S) encoded


def log(*args) -> None:
    print(*args, flush=True)


# ----------------------------------------------------------------- data
def cluster_frame(d: int, gen, device, *, n_centres: int, rank: int):
    """(centres, basis): ``n_centres`` random unit centres and a
    ``rank``-dimensional subspace they share, the first draws of ``gen``."""
    import torch
    centres = torch.randn(n_centres, d, generator=gen, device=device)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    basis = torch.randn(rank, d, generator=gen, device=device) / math.sqrt(d)
    return centres, basis


def clustered_rows(n: int, d: int, gen, device, *, n_centres: int,
                   rank: int = 8, spread: float = 0.35, noise: float = 0.01,
                   chunk: int = 1 << 18, frame=None):
    """Unit rows around ``n_centres`` random unit centres: each row is its
    centre plus a draw from a ``rank``-dimensional subspace shared by all
    centres (scale ``spread``) plus isotropic noise, normalized. Made on
    ``device`` from ``gen``, a chunk of rows at a time; ``frame`` (from
    ``cluster_frame``) gives the centres and subspace, else ``gen`` draws
    them first."""
    import torch
    centres, basis = frame or cluster_frame(d, gen, device,
                                            n_centres=n_centres, rank=rank)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        which = torch.randint(centres.shape[0], (b - a,), generator=gen,
                              device=device)
        z = torch.randn(b - a, rank, generator=gen, device=device) * spread
        x = centres[which] + z @ basis
        x += noise * torch.randn(b - a, d, generator=gen, device=device)
        out[a:b] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return out


def make_dataset(n: int, n_queries: int, seed: int, device, rank: int = 8):
    """(corpus (n, d), queries (n_queries, d)): floor(sqrt(n)) centres, as
    many as the coarse lists ivf_pq trains by default; queries are noisy
    copies of held-out rows of the same distribution. ``rank`` 0 leaves
    out the shared subspace: unit centres plus isotropic noise."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = clustered_rows(n + n_queries, DIM, gen, device,
                          n_centres=max(1, math.isqrt(n)), rank=rank)
    corpus = rows[:n]
    held = rows[n:].clone()
    del rows
    q = held + 0.01 * torch.randn(held.shape, generator=gen, device=device)
    return corpus, q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def new_rows(n_new: int, n: int, seed: int, salt: int, device, rank: int = 8):
    """``n_new`` more rows of ``make_dataset(n, ..., seed)``'s distribution:
    the same centres and shared subspace (re-drawn from ``seed``), the rows
    themselves from a generator of their own (``seed + salt``)."""
    import torch
    frame = cluster_frame(DIM, torch.Generator(device=device).manual_seed(seed),
                          device, n_centres=max(1, math.isqrt(n)), rank=rank)
    gen = torch.Generator(device=device).manual_seed(seed + salt)
    return clustered_rows(n_new, DIM, gen, device, n_centres=len(frame[0]),
                          rank=rank, frame=frame)


# ------------------------------------------------------------ measuring
def gpu_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps, after one warm-up call,
    between CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(fn, reps: int = 5) -> dict:
    """Device microseconds a call of fn() spends in each kernel, by
    torch.profiler's CUDA activity over reps calls after a warm-up:
    {kernel name (its template name, cut at '('): us a call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_times(prof, reps)


def device_times(prof, reps: int) -> dict:
    """{kernel name: device us a call} from a profile over ``reps`` calls."""
    out = {}
    for e in prof.key_averages():
        # a kernel's own device time; a host op's kernels are its children
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and not e.key.startswith(("aten::", "Activity")):
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").replace("at::native::", "")
            name = name.split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + us / reps
    return out


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def adc_bound(n_bytes: float, terms: float, lookups_per_s: float) -> tuple:
    """Least time of an ADC scan: its bytes over the memory rate against
    its table terms, each one shared-memory lookup (``lookups_per_s``) and
    one float32 add (half of FP32_OPS_PER_S); the largest binds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(terms / lookups_per_s, terms / (FP32_OPS_PER_S / 2)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentile(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(p / 100 * len(xs))) - 1)]


def serve_batches(db, queries, label: str, stats=None) -> dict:
    """Run the query batches through the front, one batch of Q queries
    served again and again (so ivf_pq's schedule cache hits after the
    first); host clock around work that ends in a synchronize. Returns
    {Q: (scores, ids)} of the last rep; ``stats`` (a dict) gains {Q: (p50
    ms, p99 ms)}."""
    import torch
    last = {}
    for Q in BATCHES:
        q = queries[:Q]
        db.query(q, k=10)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS[Q]):
            t0 = time.perf_counter()
            s, i = db.query(q, k=10)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        last[Q] = (s, i)
        p50, p99 = percentile(times, 50), percentile(times, 99)
        if stats is not None:
            stats[Q] = (p50 * 1e3, p99 * 1e3)
        log(f"  {label} Q={Q}: p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms "
            f"(n={len(times)}, one batch repeated), QPS "
            f"{Q * len(times) / sum(times):.1f}")
        if not (torch.isfinite(s[:, 0]).all() and s.shape == (Q, 10)):
            raise AssertionError(f"{label} Q={Q}: bad result {tuple(s.shape)}")
    return last


# --------------------------------------------------------- comparisons
def topk_tolerance(corpus, q, l2: bool):
    """Bound on |kernel - plain| for one score: both sum d products in
    float32 in different orders, each within d * 2^-24 * |q| * |c| of the
    exact dot (x2 for l2), plus a few roundings of the score itself. A bf16
    corpus adds the float32 rounding of its products (2^-24 |q| |c|, x2 for
    l2): the norms are those of the stored bf16 values."""
    import torch
    c_max = float(torch.linalg.vector_norm(corpus.float(), dim=1).max())
    q_norm = torch.linalg.vector_norm(q.float(), dim=1)
    d = corpus.shape[1]
    terms = 2 * d + (1 if corpus.dtype == torch.bfloat16 else 0)
    return (2.0 if l2 else 1.0) * terms * 2.0 ** -24 * q_norm * c_max


def compare_topk(corpus, q, metric: str, k: int, label: str,
                 valid=None) -> float:
    """ops.topk_distance on the kernel and on the plain version (the same
    corpus dtype, float32 or bf16). Scores agree rank by rank within the
    tolerance; an id may differ only where the kernel's row scores,
    exactly in float64, within twice the tolerance of the plain version's
    score at that rank (a near-tie); every id is a live row."""
    import torch
    from repro_torch.kernels import ops
    sq = (torch.sum(corpus.float() * corpus.float(), dim=1)
          if metric == "l2" else None)
    kw = dict(k=k, metric=metric, corpus_sq=sq, valid=valid)
    ks, ki = ops.topk_distance(corpus, q, use_kernel=True, **kw)
    ps, pi = ops.topk_distance(corpus, q, use_kernel=False, **kw)
    torch.cuda.synchronize()
    tol = topk_tolerance(corpus, q, metric == "l2")[:, None]
    err = (ks - ps).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{label}: score error {float(err.max())} above "
                             f"bound {float(tol.max())}")
    if valid is not None and not bool(valid[ki.long()].all()):
        raise AssertionError(f"{label}: a knocked-out row in the top k")
    same = ki == pi.to(ki.dtype)
    if not bool(same.all()):
        rows, cols = torch.nonzero(~same, as_tuple=True)
        c64 = corpus[ki[rows, cols].long()].double()
        q64 = q[rows].double()
        exact = (c64 * q64).sum(1)
        if metric == "l2":
            exact = -((q64 - c64) ** 2).sum(1)
        gap = (exact - ps[rows, cols].double()).abs()
        if not bool((gap <= 2 * tol[rows, 0].double() + 1e-12).all()):
            raise AssertionError(f"{label}: ids differ beyond near-ties")
    log(f"  {label}: ids agree {float(same.float().mean()):.4f} (bound: all but "
        f"near-ties), max |dscore| {float(err.max()):.3e} (bound "
        f"{float(tol.max()):.3e})")
    return float(err.max())


def topk_bound(N: int, d: int, Q: int, k: int, bf16: bool) -> tuple:
    """Least time for one topk_distance call: the corpus, the row bias and
    q read once, the (Q, k) result written once, against 2 Q N d products:
    bf16 on the tensor cores (989 TFLOP/s); float32 at the lesser of
    3xTF32 on the tensor cores (3 x 2 Q N d at 495 TFLOP/s, the cheapest
    float32-accurate route, the kernel's) and float32 FMAs (67 TFLOP/s)."""
    esize = 2 if bf16 else 4
    n_bytes = N * d * esize + N * 4 + Q * d * esize + Q * k * 8
    ops = 2.0 * Q * N * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / BF16_OPS_PER_S if bf16 else
             min(3 * ops / TF32_OPS_PER_S, ops / FP32_OPS_PER_S)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_result(a, b) -> bool:
    """Bit equality of two (scores, ids) results, -inf matching -inf."""
    import torch
    (ks, ki), (ps, pi) = a, b
    same_s = (ks == ps) | (torch.isneginf(ks) & torch.isneginf(ps))
    return bool(same_s.all()) and bool((ki == pi.to(ki.dtype)).all())


def bit_equal(kern, plain, label: str) -> float:
    """Check a kernel's result against its plain version's: the same
    float32 operations in the same order, so the bound is bit equality.
    Returns the largest |dscore| over finite entries (0 when equal)."""
    import torch
    torch.cuda.synchronize()
    (ks, ki), (ps, pi) = kern, plain
    finite = torch.isfinite(ks) & torch.isfinite(ps)
    err = float((ks - ps)[finite].abs().max()) if bool(finite.any()) else 0.0
    agree = float((ki == pi.to(ki.dtype)).float().mean())
    log(f"  {label}: ids agree {agree:.4f} (bound 1), max |dscore| "
        f"{err:.3e} (bound 0, bit equality)")
    if not same_result(kern, plain):
        raise AssertionError(f"{label}: kernel and plain version differ")
    return err


def compare_ivf(bucket_codes, bucket_ids, visit, luts, coarse, *, k, spp,
                lut_dtype, label) -> float:
    """ops.ivf_adc_topk's per-query grid on the kernel and on the plain
    version, the last block the all-pad one, as the engine passes it."""
    from repro_torch.kernels import ops
    args = (bucket_codes, bucket_ids, visit, luts)
    kw = dict(k=k, coarse=coarse, steps_per_probe=spp, lut_dtype=lut_dtype,
              mode="per_query", pad_block=bucket_ids.shape[0] - 1)
    return bit_equal(ops.ivf_adc_topk(*args, use_kernel=True, **kw),
                     ops.ivf_adc_topk(*args, use_kernel=False, **kw), label)


def compare_grouped(bucket_codes, bucket_ids, visit, luts, coarse, *, k, spp,
                    lut_dtype, mode, qblk, label) -> float:
    """A grouped grid on the kernel against its plain version, and against
    the per-query kernel: all three bit for bit."""
    from repro_torch.kernels import ops
    args = (bucket_codes, bucket_ids, visit, luts)
    kw = dict(k=k, coarse=coarse, steps_per_probe=spp, lut_dtype=lut_dtype,
              pad_block=bucket_ids.shape[0] - 1)
    kern = ops.ivf_adc_topk(*args, use_kernel=True, mode=mode, qblk=qblk,
                            **kw)
    err = bit_equal(kern, ops.ivf_adc_topk(*args, use_kernel=False, mode=mode,
                                           qblk=qblk, **kw), label)
    if not same_result(kern, ops.ivf_adc_topk(*args, use_kernel=True,
                                              mode="per_query", **kw)):
        raise AssertionError(f"{label}: differs from the per-query kernel")
    return err


def compare_pq(codes, luts, *, k, lut_dtype, label, valid=None,
               extra=None) -> float:
    """ops.adc_topk (the pq_adc kernel) against its plain version."""
    from repro_torch.kernels import ops
    kw = dict(k=k, valid=valid, extra_codes=extra, lut_dtype=lut_dtype)
    return bit_equal(ops.adc_topk(codes, luts, use_kernel=True, **kw),
                     ops.adc_topk(codes, luts, use_kernel=False, **kw), label)


def probe_inputs(index, q, nprobe=None):
    """The ivf_adc kernels' inputs for queries q, as the engine builds them
    (at ``nprobe``, the engine's by default): (bucket codes, bucket ids,
    visit, luts, coarse, steps_per_probe)."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import _ivf_probe_stage
    index._sync()
    metric = index.metric
    q = q.float()
    if metric == "cosine":
        q, metric = D.l2_normalize(q), "dot"
    visit, luts, coarse, _ = _ivf_probe_stage(
        index.codebooks, index.centroids, q, index.block_table, metric=metric,
        nprobe=nprobe or index.nprobe, steps_per_probe=index.spp,
        pad_block=index.bucket_ids.shape[0] - 1)
    return index.codes_bm, index.bucket_ids, visit, luts, coarse, index.spp


def pq_inputs(index, q):
    """pq_adc's inputs for queries q on a PQ engine: (codes, luts, valid)."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import adc_tables
    index._sync()
    metric = index.metric
    q = q.float()
    if metric == "cosine":
        q, metric = D.l2_normalize(q), "dot"
    return index.codes, adc_tables(index.codebooks, q, metric=metric), \
        index.valid


def scan_all_inputs(index, q):
    """pq_adc's inputs on IVF-PQ's all-codes path (cosine or dot index):
    (row-major codes, (Q, m + 1, W) tables, cluster ids, live mask)."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import scan_all_tables
    index._sync()
    q = q.float()
    if index.metric == "cosine":
        q = D.l2_normalize(q)
    n = index.n
    return (index.layout.gather_payload(n),
            scan_all_tables(index.codebooks, index.centroids, q),
            index.layout.assign_of(n), index.layout.live_mask(n))


# -------------------------------------------------------------- phases
def nvidia_smi(query: str) -> str:
    """First card's line of ``nvidia-smi --query-gpu=<query>``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def phase_header() -> tuple:
    """Log the card; returns (name and power limit, rates a second: the
    popcounts', POPC_PER_CLOCK_PER_SM x SMs x top SM clock, and the
    shared-memory lookups', LOOKUPS_PER_CLOCK_PER_SM x SMs x top clock)."""
    import torch
    smi = nvidia_smi("name,power.limit")
    log(smi)
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"popc": POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6,
             "lookups": LOOKUPS_PER_CLOCK_PER_SM * sms * mhz * 1e6}
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, SMs {sms}, top SM clock "
        f"{mhz:.0f} MHz, popcount rate {rates['popc']:.4e}/s, shared-memory "
        f"lookup rate {rates['lookups']:.4e}/s")
    return smi, rates


def phase_build() -> None:
    from repro_torch.kernels import _build
    secs = _build.build_all(["topk_distance", "pq_adc", "ivf_adc", "hamming",
                             "flash_attention", "visit_sharing"])
    for name, s in secs.items():
        log(f"build {name}: {s:.1f} s")
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "bytes stack")):
                log(f"  {line.strip()}")


def phase_mid(seed: int, device, rank: int) -> None:
    import torch
    from repro_torch import VectorDB
    log(f"phase 3: kernel against plain version, N={MID_ROWS}, d={DIM}, "
        f"m={M_SUBSPACES}")
    corpus, queries = make_dataset(MID_ROWS, 512, seed + 1, device, rank)
    topk_mid(corpus, queries, seed)
    for metric in ("dot", "l2"):
        db = VectorDB("pq", metric=metric, m=M_SUBSPACES,
                      device=device).load(corpus)
        for Q in BATCHES:
            codes, luts, valid = pq_inputs(db.index, queries[:Q])
            for lut_dtype in ("float32", "bfloat16", "int8"):
                for k in (10, 200):
                    compare_pq(codes, luts, k=k, lut_dtype=lut_dtype,
                               valid=valid,
                               label=f"pq_adc {metric} {lut_dtype} k={k} Q={Q}")
        del db
    for metric in ("dot", "l2", "cosine"):
        db = VectorDB("ivf_pq", metric=metric, m=M_SUBSPACES,
                      device=device).load(corpus)
        for Q in BATCHES:
            args = probe_inputs(db.index, queries[:Q])
            kw = dict(k=32, spp=args[5])
            for lut_dtype in ("float32", "bfloat16", "int8"):
                compare_ivf(*args[:5], lut_dtype=lut_dtype, **kw,
                            label=f"ivf_adc {metric} {lut_dtype} Q={Q}")
                for mode in GROUPED:
                    compare_grouped(*args[:5], lut_dtype=lut_dtype, mode=mode,
                                    qblk=8, **kw,
                                    label=f"ivf_adc_{mode} {metric} "
                                          f"{lut_dtype} qblk=8 Q={Q}")
            if metric == "dot":
                for qblk in (4, 16):
                    for mode in GROUPED:
                        compare_grouped(*args[:5], lut_dtype="float32",
                                        mode=mode, qblk=qblk, **kw,
                                        label=f"ivf_adc_{mode} dot float32 "
                                              f"qblk={qblk} Q={Q}")
        if metric == "cosine":
            codes, luts, assign, live = scan_all_inputs(db.index, queries[:32])
            compare_pq(codes, luts, k=32, lut_dtype="float32", valid=live,
                       extra=assign,
                       label=f"pq_adc scan_all float32 W={luts.shape[2]} "
                             f"(ksub {db.index.codebooks.shape[1]}) Q=32")
        del db
    del corpus, queries
    torch.cuda.empty_cache()
    pq_tiles_mid(seed, device)
    per_query_mid(seed, device)
    grouped_tiles_mid(seed, device)
    hamming_mid(seed, device)
    flash_mid(seed, device)


def topk_mid(corpus, queries, seed: int) -> None:
    """topk_distance against its plain version on a ragged corpus (MID_ROWS
    - 77 rows plus 64 duplicated rows, whose scores tie and go to the lower
    id) with a tenth of the rows knocked out, in float32 and bf16, at every
    Q of TOPK_QS (each query-tile template and a ragged Q) and k of
    TOPK_KS, for the dot and l2 metrics; each plan is printed once."""
    import torch
    from repro_torch.kernels.topk_distance import plan
    gen = torch.Generator(device=corpus.device).manual_seed(seed + 5)
    c32 = torch.cat([corpus[:MID_ROWS - 77], corpus[:64]])
    valid = torch.rand(c32.shape[0], generator=gen,
                       device=corpus.device) >= 0.1
    for dtype in (torch.float32, torch.bfloat16):
        c, qs = c32.to(dtype), queries.to(dtype)
        name = str(dtype).split(".")[-1]
        for Q in TOPK_QS:
            for k in TOPK_KS:
                p = plan(c.shape[0], Q, DIM, k, dtype)
                log(f"  topk_distance {name} plan Q={Q} k={k}: {p}")
                for metric in ("dot", "l2"):
                    compare_topk(c, qs[:Q], metric, k,
                                 f"topk_distance {name} {metric} k={k} Q={Q} "
                                 f"N={c.shape[0]}", valid=valid)
        del c, qs
    torch.cuda.empty_cache()


def pq_tiles_mid(seed: int, device) -> None:
    """pq_adc against its plain version, bit for bit, at every query tile
    up to Q that fits and at the plan's, for each table type, m in PQ_TILE_MS, Q in
    PQ_TILE_QS and k in PQ_TILE_KS, on a ragged N with duplicated rows and
    a tenth knocked out; then scan_all's wide extra column (W = 2973) at
    every query tile that fits, Q = 33."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc import (QTS, fit_qt, plan, pq_adc_cuda,
                                            pq_adc_plain)
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    card = _build.card(device)
    N = MID_ROWS - 77
    bias = torch.where(torch.rand(N, generator=gen, device=device) >= 0.1,
                       0.0, -1e30).float()
    for m in PQ_TILE_MS:
        codes = torch.randint(0, 256, (N, m), generator=gen, device=device,
                              dtype=torch.uint8)
        codes[-300:] = codes[:300]
        for Q in PQ_TILE_QS:
            luts = torch.randn(Q, m, 256, generator=gen, device=device)
            for lut_dtype in ("float32", "bfloat16", "int8"):
                for k in PQ_TILE_KS:
                    want = pq_adc_plain(codes, luts, bias, k=k,
                                        lut_dtype=lut_dtype)
                    top = fit_qt(m, 256, k, lut_dtype, 0, card)
                    p = plan(N, Q, m, 256, k, lut_dtype, 0, card)
                    tiles = {t for t in QTS if t <= min(top, Q)}
                    for qt in sorted(tiles | {p["qt"]}):
                        mark = " (plan)" if qt == p["qt"] else ""
                        bit_equal(pq_adc_cuda(codes, luts, bias, k=k,
                                              lut_dtype=lut_dtype, qt=qt),
                                  want, f"pq_adc {lut_dtype} m={m} Q={Q} "
                                        f"k={k} N={N} query tile {qt}{mark}")
        del codes
    m, W, Q = M_SUBSPACES, 2973, 33
    codes = torch.randint(0, 256, (N, m), generator=gen, device=device,
                          dtype=torch.uint8)
    extra = torch.randint(0, W, (N,), generator=gen, device=device,
                          dtype=torch.int32)
    luts = torch.randn(Q, m + 1, W, generator=gen, device=device)
    for lut_dtype in ("float32", "bfloat16", "int8"):
        want = pq_adc_plain(codes, luts, bias, k=32, extra=extra,
                            lut_dtype=lut_dtype)
        top = fit_qt(m, W, 32, lut_dtype, 1, card)
        for qt in [t for t in QTS if t <= top]:
            bit_equal(pq_adc_cuda(codes, luts, bias, k=32, extra=extra,
                                  lut_dtype=lut_dtype, qt=qt), want,
                      f"pq_adc {lut_dtype} extra W={W} Q={Q} k=32 query "
                      f"tile {qt}")
    del codes, extra, luts
    torch.cuda.empty_cache()


def grouped_inputs(gen, device, *, Q, m, per_probe, B=4000, blk=32,
                   nprobe=8, spp=32, ksub=256, pad_share=0.3):
    """Synthetic grouped-grid inputs made on the card: random codes with a
    tenth of the slots -1, a (Q, nprobe * spp) visit table over B - 1
    blocks with a share of visits to the pad block (B - 1, all -1), random
    tables (per (query, probe) with ``per_probe``) and coarse terms."""
    import torch
    codes = torch.randint(0, ksub, (B, blk, m), generator=gen, device=device,
                          dtype=torch.uint8)
    ids = torch.arange(B * blk, device=device,
                       dtype=torch.int32).reshape(B, blk)
    ids[torch.rand((B, blk), generator=gen, device=device) < 0.1] = -1
    ids[-1] = -1
    T = nprobe * spp
    visit = torch.randint(0, B - 1, (Q, T), generator=gen, device=device,
                          dtype=torch.int32)
    visit[torch.rand((Q, T), generator=gen, device=device) < pad_share] = B - 1
    shape = (Q, nprobe, m, ksub) if per_probe else (Q, m, ksub)
    luts = torch.randn(shape, generator=gen, device=device)
    coarse = torch.randn((Q, nprobe), generator=gen, device=device)
    return codes, ids, visit, luts, coarse, spp


def grouped_case(codes, ids, visit, luts, coarse, spp, *, k, lut_dtype, qblk,
                 tiles, label) -> int:
    """Both grouped kernels, at the plan's tile width and at each of
    ``tiles``, against their plain versions and the per-query kernel, bit
    for bit; raises on the first difference. Returns the cases checked."""
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    kw = dict(k=k, steps_per_probe=spp, lut_dtype=lut_dtype)
    per_query = ops.normalize_knockouts(*K.ivf_adc_cuda(
        codes, ids, visit, luts, coarse, pad_block=ids.shape[0] - 1, **kw))
    sched = ops.build_schedule(visit, qblk=qblk, pad_block=ids.shape[0] - 1)
    n = 0
    for runs, plain, name in (
            (False, K.ivf_adc_blocked_plain, "blocked"),
            (True, K.ivf_adc_run_resident_plain, "run_resident")):
        want = ops.normalize_knockouts(*plain(codes, ids, visit, sched, luts,
                                              coarse, **kw))
        if not same_result(want, per_query):
            raise AssertionError(f"{label} {name}: plain version differs "
                                 "from the per-query kernel")
        for qt in (None,) + tuple(tiles):
            got = ops.normalize_knockouts(*K._grouped_cuda(
                codes, ids, visit, sched, luts, coarse, runs=runs, qt=qt,
                **kw))
            if not same_result(got, want):
                raise AssertionError(f"ivf_adc_{name} {label} qt={qt}: "
                                     "kernel and plain version differ")
            n += 1
    return n


def per_query_case(codes, ids, visit, luts, coarse, spp, *, k, lut_dtype,
                   label, grouped=True) -> int:
    """The per-query kernel (the plan's variant, and the direct-read one
    forced, each with the pad block and with none given) against its plain
    version and, where a tile fits, both grouped kernels at qblk 8, bit for
    bit; raises on the first difference. Returns the results checked."""
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    kw = dict(k=k, steps_per_probe=spp, lut_dtype=lut_dtype)
    pad = ids.shape[0] - 1
    want = ops.normalize_knockouts(*K.ivf_adc_plain(codes, ids, visit, luts,
                                                    coarse, **kw))
    n = 0
    for ring in (None, False):
        for pad_block in (pad, None):
            got = ops.normalize_knockouts(*K._per_query_cuda(
                codes, ids, visit, luts, coarse, ring=ring,
                pad_block=pad_block, **kw))
            if not same_result(got, want):
                raise AssertionError(f"ivf_adc {label} ring={ring} pad_block="
                                     f"{pad_block}: kernel and plain version "
                                     "differ")
            n += 1
    if grouped:
        sched = ops.build_schedule(visit, qblk=8, pad_block=pad)
        for name, fn in (("blocked", K.ivf_adc_blocked_cuda),
                         ("run_resident", K.ivf_adc_run_resident_cuda)):
            got = ops.normalize_knockouts(*fn(codes, ids, visit, sched, luts,
                                              coarse, **kw))
            if not same_result(got, want):
                raise AssertionError(f"ivf_adc_{name} {label}: differs from "
                                     "the per-query grid")
            n += 1
    return n


def per_query_mid(seed: int, device) -> None:
    """The per-query kernel on synthetic inputs (4,000 blocks of 32 slots),
    bit for bit against its plain version and both grouped kernels: a share
    of the steps on the pad block in PAD_SHARES, for each table type,
    shared and per-probe tables; then one real step among 4,095 pad steps,
    a query that visits only the pad block and one whose every probe is
    knocked out, k = 1 and 256, m = 7 (byte reads) and m = 210 float32 at
    k = 256 (the direct-read variant; no grouped tile fits it)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    t0 = time.perf_counter()
    total = 0
    for pad_share in PAD_SHARES:
        for lut_dtype in ("float32", "bfloat16", "int8"):
            for per_probe in (False, True):
                *args, spp = grouped_inputs(gen, device, Q=40, m=M_SUBSPACES,
                                            per_probe=per_probe,
                                            pad_share=pad_share)
                args[4][3, 2] = -1e30  # a knocked-out probe
                total += per_query_case(
                    *args, spp, k=32, lut_dtype=lut_dtype,
                    label=f"pad share {pad_share} {lut_dtype} "
                          f"per_probe={per_probe}")
    log(f"  ivf_adc per-query kernel at pad shares {PAD_SHARES}, each table "
        "type, shared and per-probe tables: equal to its plain version and "
        "both grouped kernels bit for bit")
    for per_probe in (False, True):
        *args, spp = grouped_inputs(gen, device, Q=1, m=M_SUBSPACES, spp=512,
                                    per_probe=per_probe)
        codes, ids, visit = args[:3]
        visit[:] = ids.shape[0] - 1
        visit[0, 3 * 512 + 5] = 17    # one real step among 4,095
        for k in (1, 32):
            total += per_query_case(*args, spp, k=k, lut_dtype="float32",
                                    label=f"one real step per_probe="
                                          f"{per_probe} k={k}")
        *args, spp = grouped_inputs(gen, device, Q=12, m=M_SUBSPACES,
                                    per_probe=per_probe)
        args[2][4] = args[1].shape[0] - 1   # a query on the pad block alone
        args[4][7] = -1e30                  # every probe knocked out
        for lut_dtype in ("float32", "bfloat16", "int8"):
            for k in (1, 256):
                total += per_query_case(
                    *args, spp, k=k, lut_dtype=lut_dtype,
                    label=f"all-pad and knocked-out queries {lut_dtype} "
                          f"per_probe={per_probe} k={k}")
        for lut_dtype in ("float32", "bfloat16", "int8"):
            *args, spp = grouped_inputs(gen, device, Q=9, m=7,
                                        per_probe=per_probe)
            total += per_query_case(*args, spp, k=32, lut_dtype=lut_dtype,
                                    label=f"m=7 {lut_dtype} "
                                          f"per_probe={per_probe}")
        *args, spp = grouped_inputs(gen, device, Q=5, m=210,
                                    per_probe=per_probe)
        total += per_query_case(*args, spp, k=256, lut_dtype="float32",
                                label=f"m=210 float32 k=256 "
                                      f"per_probe={per_probe}",
                                grouped=False)
    log(f"  ivf_adc per-query kernel: one real step among 4,095, all-pad and "
        f"knocked-out queries, k in (1, 256), m = 7 and m = 210 float32 at "
        f"k = 256 (direct reads) equal too; {total} results in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def grouped_tiles_mid(seed: int, device) -> None:
    """The grouped kernels on synthetic inputs (4,000 blocks of 32 slots,
    nprobe 8 x 32 steps), bit for bit against their plain versions and the
    per-query kernel: Q one below, at and one above the plan's tile width
    and the widest that fits, at the plan's width and forced to the widest
    (a ragged last tile), for each table type, shared and per-probe
    tables, m in GROUPED_TILE_MS, k in (1, 32, 256), qblk in
    GROUPED_QBLKS; then tiles with no scheduled pair, a query whose every
    probe is knocked out, an adaptive probe mask, and blocks of 8 x 7 and
    6 x 8 code bytes (staged byte by byte)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_adc import fit_tile, plan_width
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    card = _build.card(device)
    t0 = time.perf_counter()
    total = 0
    for m in GROUPED_TILE_MS:
        for lut_dtype in ("float32", "bfloat16", "int8"):
            for per_probe in (False, True):
                n = 0
                cw = 1 if per_probe else 8  # coarse terms a table row
                for k in PQ_TILE_KS:
                    top = fit_tile(m, 256, 32, k, lut_dtype, card, cw)
                    width = plan_width(m, 256, 32, k, lut_dtype, card, cw)
                    for Q in sorted({max(1, w + d) for w in (width, top)
                                     for d in (-1, 0, 1)}):
                        *args, spp = grouped_inputs(gen, device, Q=Q, m=m,
                                                    per_probe=per_probe)
                        args[4][0, 1] = -1e30  # a knocked-out probe
                        for qblk in GROUPED_QBLKS:
                            n += grouped_case(
                                *args, spp, k=k, lut_dtype=lut_dtype,
                                qblk=qblk, tiles=(top,),
                                label=f"{lut_dtype} m={m} per_probe="
                                      f"{per_probe} k={k} Q={Q} qblk={qblk}")
                log(f"  ivf_adc grouped kernels {lut_dtype} m={m} "
                    f"{'per-probe' if per_probe else 'shared'} tables: {n} "
                    f"cases (Q one below, at and one above the plan's and "
                    f"the widest tile at k in {PQ_TILE_KS}, qblk in "
                    f"{GROUPED_QBLKS}) equal their plain versions and the "
                    f"per-query kernel bit for bit")
                total += n
    for lut_dtype in ("float32", "bfloat16", "int8"):
        for per_probe in (False, True):
            codes, ids, visit, luts, coarse, spp = grouped_inputs(
                gen, device, Q=40, m=M_SUBSPACES, per_probe=per_probe)
            pad = ids.shape[0] - 1
            visit[:12] = pad                  # the first tiles: no pair
            coarse[20] = -1e30                # every probe knocked out
            drop = torch.rand((40, 8), generator=gen, device=device) < 0.5
            drop[:, 0] = False                # adaptive: probe 0 stays
            visit[torch.repeat_interleave(drop, spp, dim=1)] = pad
            coarse[drop] = -1e30
            for qblk in GROUPED_QBLKS:
                total += grouped_case(
                    codes, ids, visit, luts, coarse, spp, k=32,
                    lut_dtype=lut_dtype, qblk=qblk, tiles=(1,),
                    label=f"{lut_dtype} per_probe={per_probe} empty tiles, "
                          f"knocked-out query, adaptive mask qblk={qblk}")
    for blk, m in ((8, 7), (6, 8)):  # blocks staged byte by byte
        for lut_dtype in ("float32", "bfloat16", "int8"):
            for per_probe in (False, True):
                *args, spp = grouped_inputs(gen, device, Q=10, m=m, blk=blk,
                                            per_probe=per_probe)
                total += grouped_case(
                    *args, spp, k=32, lut_dtype=lut_dtype, qblk=8,
                    tiles=(1,), label=f"{lut_dtype} blk={blk} m={m} "
                                      f"per_probe={per_probe}")
    log(f"  ivf_adc grouped kernels: empty tiles, a query with every probe "
        f"knocked out, an adaptive probe mask and blocks staged byte by "
        f"byte (blk, m in (8, 7), (6, 8)) equal too; {total} cases in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def random_words(gen, shape, device):
    """int32 bit patterns over the full 2^32 range."""
    import torch
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)


def compare_hamming(qc, cc, L: int, label: str, full: bool) -> float:
    """hamming_shortlist (and with ``full`` the matrix entry) on the kernel
    against the plain version: integer results, so bit equality. Returns
    the largest |ddist| (0 when equal)."""
    import torch
    from repro_torch.kernels import ops
    kern = ops.hamming_shortlist(qc, cc, L, use_kernel=True)
    plain = ops.hamming_shortlist(qc, cc, L, use_kernel=False)
    err = bit_equal((kern[0].float(), kern[1]), (plain[0].float(), plain[1]),
                    f"hamming_shortlist {label} L={L}")
    if full:
        same = torch.equal(ops.hamming(qc, cc, use_kernel=True),
                           ops.hamming(qc, cc, use_kernel=False))
        log(f"  hamming {label}: (Q, N) matrix equal {same} (bound: equal)")
        if not same:
            raise AssertionError(f"hamming {label}: kernel and plain differ")
    return err


def hamming_mid(seed: int, device) -> None:
    """Both hamming entries against their plain versions at MID_ROWS rows:
    random words at each (T, W) and Q, a ragged N, and heavy ties."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    for T, W in HAMMING_SHAPES:
        cc = random_words(gen, (T, MID_ROWS, W), device)
        for Q in BATCHES:
            qc = random_words(gen, (T, Q, W), device)
            for L in (10, 64, 256):
                compare_hamming(qc, cc, L, f"T={T} W={W} Q={Q}",
                                full=L == 10)
        del cc
    cc = random_words(gen, (4, MID_ROWS - 77, 4), device)
    compare_hamming(random_words(gen, (4, 32, 4), device), cc, 64,
                    f"T=4 W=4 Q=32 N={MID_ROWS - 77} (ragged)", full=True)
    distinct = random_words(gen, (4, 5, 4), device)
    pick = torch.randint(0, 5, (MID_ROWS,), generator=gen, device=device)
    cc = distinct[:, pick].contiguous()
    qc = torch.cat([distinct, random_words(gen, (4, 27, 4), device)], dim=1)
    for L in (64, 256):
        compare_hamming(qc, cc, L, "T=4 W=4 Q=32, five distinct codes (ties)",
                        full=L == 64)
    # six distinct codes over TIE_ROWS rows: ties straddle every query's
    # threshold across tiles and chunks
    distinct = random_words(gen, (4, 6, 4), device)
    pick = torch.randint(0, 6, (TIE_ROWS,), generator=gen, device=device)
    cc = distinct[:, pick].contiguous()
    for Q in (1, 8, 9, 32, 33, 512):
        qc = torch.cat([distinct, random_words(gen, (4, Q, 4), device)],
                       dim=1)[:, :Q].contiguous()
        for L in (1, 64, 256):
            compare_hamming(qc, cc, L, f"T=4 W=4 Q={Q} N={TIE_ROWS}, six "
                                       f"distinct codes (ties)", full=False)
    del cc, qc
    torch.cuda.empty_cache()


def ragged_mask(gen, B: int, S: int, device, empty_row: bool = True):
    """(B, S) key-padding mask of lengths drawn from 1..S; the first row is
    full and, with ``empty_row``, the last one fully masked."""
    import torch
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=device)
    lengths[0] = S
    if empty_row and B > 1:
        lengths[-1] = 0
    return torch.arange(S, device=device)[None, :] < lengths[:, None]


def hole_mask(B: int, S: int, device):
    """(B, S) key-padding mask with keys S/3..2S/3 padded in every row."""
    import torch
    pos = torch.arange(S, device=device)
    return ((pos < S // 3) | (pos >= 2 * S // 3))[None].repeat(B, 1)


def compare_flash(q, k, v, mask, causal: bool, label: str,
                  window=None) -> float:
    """flash_attention's kernel against its plain version: |kernel - plain|
    <= tol + tol * |plain| elementwise at the reference's tolerance for the
    dtype. Returns the largest |difference|."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    kw = dict(causal=causal, scale=q.shape[-1] ** -0.5, kv_mask=mask,
              window=window)
    got = flash_attention_cuda(q, k, v, **kw).float()
    want = flash_attention_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    log(f"  {label}: max |do| {float(err.max()):.3e} (bound {tol} + {tol} "
        f"|o|)")
    if not ok:
        raise AssertionError(f"{label}: kernel and plain version differ")
    return float(err.max())


def flash_mid(seed: int, device) -> None:
    """flash_attention against its plain version on FLASH_MID_CASES and
    FLASH_WINDOW_CASES, in bf16 and float32."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    for B, Sq, Sk, H, KV, dh, causal, masked in FLASH_MID_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, Sq, H, dh, generator=gen, device=device).to(dtype)
            k = torch.randn(B, Sk, KV, dh, generator=gen, device=device).to(dtype)
            v = torch.randn(B, Sk, KV, dh, generator=gen, device=device).to(dtype)
            mask = ragged_mask(gen, B, Sk, device) if masked else None
            compare_flash(q, k, v, mask, causal,
                          f"flash_attention {str(dtype)[6:]} B={B} Sq={Sq} "
                          f"Sk={Sk} H={H} KV={KV} dh={dh} causal={causal} "
                          f"mask={'ragged+empty' if masked else 'none'}")
    for B, S, H, KV, dh, causal, window, kind in FLASH_WINDOW_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, S, H, dh, generator=gen, device=device).to(dtype)
            k = torch.randn(B, S, KV, dh, generator=gen, device=device).to(dtype)
            v = torch.randn(B, S, KV, dh, generator=gen, device=device).to(dtype)
            mask = (ragged_mask(gen, B, S, device) if kind == "ragged"
                    else hole_mask(B, S, device))
            compare_flash(q, k, v, mask, causal,
                          f"flash_attention {str(dtype)[6:]} B={B} S={S} H={H} "
                          f"KV={KV} dh={dh} causal={causal} window={window} "
                          f"mask={kind}", window=window)
    torch.cuda.empty_cache()


def serve_and_count(db, queries, label: str):
    """Serve the batches with every launch count set to 0 just before;
    returns (last results per Q, launch counts just after)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    res = serve_batches(db, queries, label)
    counts = ops.launch_counts()
    log(f"  launches on the {label} path: {counts}")
    return res, counts


def recall_at_10(got, truth) -> float:
    return float(sum(len(set(got[r].tolist()) & set(truth[r].tolist()))
                     for r in range(got.shape[0])) / (10 * got.shape[0]))


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bound,
                 library_ms, shape) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms, "shape": shape}


def phase_main(n: int, seed: int, device, rank: int, min_recall: float,
               rates: dict) -> tuple:
    import torch
    log(f"phase 4: main path, N={n} rows (MS MARCO v1 passages: "
        f"{MARCO_PASSAGES}), d={DIM}, cosine, shared subspace rank {rank}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus, queries = make_dataset(n, max(BATCHES), seed, device, rank)
    torch.cuda.synchronize()
    log(f"  data made on the card: {time.perf_counter() - t0:.2f} s")
    kernels, launches, recalls = [], {}, {}
    t0 = time.perf_counter()
    meta = seeded_meta(n, seed)
    log(f"  metadata made on the host (numpy, from --seed): "
        f"{time.perf_counter() - t0:.2f} s; columns year (int, 0..127), cat "
        f"(8 categories), flag (bool, 70 % true)")
    t0 = time.perf_counter()
    truth, ftruth = main_flat(corpus, queries, device, kernels, launches, meta)
    log(f"  [flat: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    recalls["pq"] = main_pq(corpus, queries, truth, device, kernels, launches,
                            rates["lookups"], meta, ftruth)
    log(f"  [pq: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    recalls["ivf_pq"] = main_ivf(corpus, queries, truth, device, kernels,
                                 launches, rates["lookups"], seed, meta,
                                 ftruth, min_recall)
    log(f"  [ivf_pq: {time.perf_counter() - t0:.1f} s]")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory through ivf_pq: {peak / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recalls["lsh"] = main_lsh(corpus, queries, truth, device, kernels,
                              launches, rates["popc"])
    log(f"  [lsh: {time.perf_counter() - t0:.1f} s]")
    lsh_peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in lsh (earlier engines dropped): "
        f"{lsh_peak / 1e9:.2f} GB; whole phase "
        f"{max(peak, lsh_peak) / 1e9:.2f} GB")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    for engine in ("ivf_pq", "lsh"):
        if recalls[engine] < min_recall:
            raise AssertionError(f"{engine} recall@10 {recalls[engine]:.4f} "
                                 f"below {min_recall}")
    return kernels, recalls


def library_topk(corpus, q, k: int, chunk: int = 128):
    """torch.matmul + torch.topk over the corpus (the yardstick, used
    nowhere in the port), queries in chunks of ``chunk`` rows so that the
    (Q, N) score matrix stays within memory (Q = 512 at N = 8,841,823 is
    18 GB in float32)."""
    import torch
    for a in range(0, q.shape[0], chunk):
        torch.topk(q[a:a + chunk] @ corpus.T, k)


def time_topk(corpus, queries, label: str) -> dict:
    """The kernel, its plain version and torch.matmul + torch.topk at each
    Q of BATCHES on the engine's corpus (k = 10, dot), beside the bound;
    at Q <= 32 also the kernel with the query tile's other placement
    (resident in shared memory or riding in the ring), which the launch
    plan did not pick. Returns {Q: (ms, plain_ms, library_ms, bound)}."""
    import torch
    from repro_torch.kernels.topk_distance import (plan, topk_distance_cuda,
                                                   topk_distance_plain)
    N = corpus.shape[0]
    bf16 = corpus.dtype == torch.bfloat16
    bias = torch.zeros(N, dtype=torch.float32, device=corpus.device)
    out = {}
    for Q in BATCHES:
        q = queries[:Q].to(corpus.dtype)
        ms = gpu_ms(lambda: topk_distance_cuda(corpus, q, bias, k=10,
                                               l2=False), 5)
        plain_ms = gpu_ms(lambda: topk_distance_plain(corpus, q, bias, k=10,
                                                      l2=False), 1)
        lib_ms = gpu_ms(lambda: library_topk(corpus, q, 10), 2)
        b = topk_bound(N, DIM, Q, 10, bf16)
        out[Q] = (ms, plain_ms, lib_ms, b)
        p = plan(N, Q, DIM, 10, corpus.dtype)
        log(f"  topk_distance {label} Q={Q}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, torch.matmul+torch.topk {lib_ms:.3f} ms"
            f"{' (4 chunks of 128 queries)' if Q > 128 else ''}, bound "
            f"{b[0]:.3f} ms ({b[1]}); plan {p}")
        if Q <= 32:
            other = 1 - p["resident"]
            o_ms = gpu_ms(lambda: topk_distance_cuda(corpus, q, bias, k=10,
                                                     l2=False,
                                                     resident=other), 5)
            log(f"    the other placement (resident={other}, plan "
                f"{plan(N, Q, DIM, 10, corpus.dtype, other)}): {o_ms:.3f} ms")
    return out


def by_q(times) -> dict:
    """time_topk's numbers keyed by batch size, for the kernels line."""
    return {str(Q): {"ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                     "bound_ms": t[3][0], "bound_by": t[3][1]}
            for Q, t in times.items()}


def main_flat(corpus, queries, device, kernels, launches, meta):
    """flat, the exact ground truth: serve, filtered queries (the kernel on
    each bitmap against its plain version and brute force), time
    topk_distance; then the same engine with a bf16 corpus (the f32 one
    dropped first): serve, recall against the f32 truth, time. Returns
    (the f32 truth, the filtered truths by predicate), at Q = 512."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import distances as D
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    flat = VectorDB("flat", metric="cosine", device=device).load(corpus,
                                                                meta=meta)
    torch.cuda.synchronize()
    log(f"  flat load: {time.perf_counter() - t0:.2f} s (with the metadata "
        f"columns {sorted(meta)})")
    res, counts = serve_and_count(flat, queries, "flat")
    truth = res[max(BATCHES)][1]
    maps = bitmaps(flat, device)
    f_launch = {}
    fres = counted(f_launch, serve_filtered, flat, queries, "flat", maps, res)
    ftruth = {name: r[max(BATCHES)][1] for name, r in fres.items()}
    launches["topk_distance"] = counts["topk_distance"] + f_launch.get(
        "topk_distance", 0)
    fc = flat.index.corpus
    qn = D.l2_normalize(queries[:32])
    f_err = 0.0
    for name, (pred, allowed) in maps.items():
        valid = ops.and_allowed(flat.index.valid, allowed, fc.shape[0])
        f_err = max(f_err, compare_topk(
            fc, qn, "dot", 10, f"topk_distance filtered {name} Q=32",
            valid=valid))
        brute_filtered(fc, qn, valid, fres[name][32],
                       f"flat filtered {name} Q=32")
    times = time_topk(fc, queries, "float32")
    ms, lib_ms = times[32][0], times[32][2]
    log(f"  topk_distance float32 Q=32: kernel {ms:.3f} ms against "
        f"torch.matmul+torch.topk {lib_ms:.3f} ms: "
        f"{'below' if ms < lib_ms else 'NOT below'} the library call")
    err = max(compare_topk(fc, queries[:Q], "dot", 10,
                           f"topk_distance float32 full size Q={Q}")
              for Q in BATCHES)
    entry = kernel_entry(
        "topk_distance", "src/repro_torch/csrc/topk_distance.cu",
        "src/repro/kernels/topk_distance.py:77", launches["topk_distance"],
        err, *times[32][:2], times[32][3], lib_ms,
        f"Q=32 N={fc.shape[0]} d={DIM} k=10 float32 corpus (3xTF32); by_q: "
        f"Q = 1, 32, 512; bf16: the same kernel on the bf16 flat corpus; "
        f"library_ms: torch.matmul + torch.topk (Q = 512 in 4 chunks of "
        f"128 queries)")
    entry["by_q"] = by_q(times)
    entry["filtered"] = {"launches": f_launch.get("topk_distance", 0),
                         "max_abs_err": f_err}
    del flat, fc, res, fres, maps
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flat = VectorDB("flat", metric="cosine", dtype=torch.bfloat16,
                    device=device).load(corpus)
    torch.cuda.synchronize()
    fc = flat.index.corpus
    log(f"  flat bf16 load: {time.perf_counter() - t0:.2f} s (corpus "
        f"{fc.dtype}, {fc.numel() * fc.element_size() / 1e9:.2f} GB on the "
        f"card)")
    res, counts = serve_and_count(flat, queries, "flat bf16")
    if counts["topk_distance"] <= 0:
        raise AssertionError("topk_distance never launched on the bf16 flat "
                             "path")
    recall = recall_at_10(res[max(BATCHES)][1], truth)
    log(f"  recall@10 of flat bf16 against flat float32: {recall:.4f} "
        f"({truth.shape[0]} queries; printed, not gated)")
    times = time_topk(fc, queries, "bfloat16")
    err16 = max(compare_topk(fc, queries[:Q].to(torch.bfloat16), "dot", 10,
                             f"topk_distance bfloat16 full size Q={Q}")
                for Q in BATCHES)
    ms, plain_ms, lib_ms, b = times[32]
    entry["bf16"] = {"launches": counts["topk_distance"], "max_abs_err": err16,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "library_ms": lib_ms,
                     "by_q": by_q(times), "recall_at_10_vs_float32": recall}
    kernels.append(entry)
    log(f"  peak device memory through flat: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del flat, fc, res
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return truth, ftruth


def pq_bound(codes, luts, valid, k: int, lookups_per_s: float) -> tuple:
    """Least time for one pq_adc call on these inputs: the codes, the row
    bias and the tables read once, the (Q, k) result written once, against
    m table terms for each (query, live row) pair, each a shared-memory
    lookup and a float32 add (``adc_bound``)."""
    N, m = codes.shape
    Q = luts.shape[0]
    live = int(valid.sum())
    return adc_bound(N * m + N * 4 + luts.numel() * 4 + Q * k * 8,
                     float(Q) * live * m, lookups_per_s)


def main_pq(corpus, queries, truth, device, kernels, launches,
            lookups_per_s: float, meta, ftruth) -> float:
    """pq, the flat PQ engine: serve, recall, filtered queries (pq_adc on
    each bitmap against its plain version), time pq_adc."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.kernels import ops
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc import (QTS, fit_qt, plan, pq_adc_cuda,
                                            pq_adc_plain)
    t0 = time.perf_counter()
    db = VectorDB("pq", metric="cosine", m=M_SUBSPACES,
                  device=device).load(corpus, meta=meta)
    torch.cuda.synchronize()
    log(f"  pq load: {time.perf_counter() - t0:.2f} s (codes "
        f"{db.index.memory_bytes() / 1e9:.3f} GB with the live mask and "
        f"codebooks)")
    res, counts = serve_and_count(db, queries, "pq")
    recall = recall_at_10(res[max(BATCHES)][1], truth)
    log(f"  recall@10 of pq against flat: {recall:.4f} "
        f"({truth.shape[0]} queries)")
    k = db.index.refine
    maps = bitmaps(db, device)
    f_launch = {}
    fres = counted(f_launch, serve_filtered, db, queries, "pq", maps, res)
    filtered_recalls(fres, ftruth, "pq")
    launches["pq_adc"] = counts["pq_adc"] + f_launch.get("pq_adc", 0)
    f_err = 0.0
    for name, (pred, allowed) in maps.items():
        codes, luts, valid = pq_inputs(db.index, queries[:32])
        f_err = max(f_err, compare_pq(
            codes, luts, k=k, lut_dtype="float32",
            valid=ops.and_allowed(valid, allowed, codes.shape[0]),
            label=f"pq_adc filtered {name} Q=32"))
    by_q = {}
    for Q in BATCHES:
        codes, luts, valid = pq_inputs(db.index, queries[:Q])
        bias = torch.where(valid, 0.0, -1e30).float()
        ms = gpu_ms(lambda: pq_adc_cuda(codes, luts, bias, k=k), 3)
        b = pq_bound(codes, luts, valid, k, lookups_per_s)
        by_q[str(Q)] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1]}
        p = plan(codes.shape[0], Q, codes.shape[1], luts.shape[2], k,
                 "float32", 0, _build.card(codes.device))
        log(f"  pq_adc kernel Q={Q}: {ms:.3f} ms (bound {b[0]:.3f} ms, "
            f"{b[1]}; before this design {EARLIER_MS['pq_adc'][Q]:.3f} ms); "
            f"plan {p}")
    codes, luts, valid = pq_inputs(db.index, queries[:1])
    bias = torch.where(valid, 0.0, -1e30).float()
    by_k = {kk: gpu_ms(lambda: pq_adc_cuda(codes, luts, bias, k=kk), 5)
            for kk in (1, k)}
    log(f"  pq_adc Q=1 by k: k=1 {by_k[1]:.3f} ms, k={k} {by_k[k]:.3f} ms "
        f"(the same lookups; the boards' work grows with k)")
    codes, luts, valid = pq_inputs(db.index, queries[:32])
    bias = torch.where(valid, 0.0, -1e30).float()
    ms = by_q["32"]["ms"]
    plain_ms = gpu_ms(lambda: pq_adc_plain(codes, luts, bias, k=k), 1)
    bound = pq_bound(codes, luts, valid, k, lookups_per_s)
    for qt in QTS:
        if qt <= fit_qt(codes.shape[1], luts.shape[2], k, "float32", 0,
                        _build.card(codes.device)):
            t = gpu_ms(lambda: pq_adc_cuda(codes, luts, bias, k=k, qt=qt), 3)
            log(f"    pq_adc Q=32 at query tile {qt}: {t:.3f} ms")
    err = 0.0
    for Q in BATCHES:
        c, lt, v = pq_inputs(db.index, queries[:Q])
        err = max(err, compare_pq(c, lt, k=k, lut_dtype="float32", valid=v,
                                  label=f"pq_adc full size Q={Q}"))
    entry = kernel_entry(
        "pq_adc", "src/repro_torch/csrc/pq_adc.cu",
        "src/repro/kernels/pq_adc.py:122", launches["pq_adc"], err, ms,
        plain_ms, bound, None,
        f"Q=32 N={codes.shape[0]} m={codes.shape[1]} k={k}; library_ms "
        f"null: no single PyTorch call gathers and sums table entries")
    entry["by_q"] = by_q
    entry["filtered"] = {"launches": f_launch.get("pq_adc", 0),
                         "max_abs_err": f_err}
    kernels.append(entry)
    log(f"  pq_adc Q=32: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound[0]:.3f} ms ({bound[1]}), no single library call")
    del db, codes, luts, valid, bias, res, fres, maps
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return recall


def hot_queries(corpus, seed: int, device):
    """The hot set: HOT_ROWS corpus rows, each repeated HOT_COPIES times
    with noise of 0.01 a dimension, normalized, in an order shuffled by
    seed. Popular queries recur across users (Xie and O'Hallaron, "Locality
    in Search Engine Queries and Its Implications for Caching", INFOCOM
    2002: query popularity is Zipf-like); the 32 x 16 split stands in for
    the head of that distribution and is not taken from the study."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    rows = torch.randperm(corpus.shape[0], generator=gen,
                          device=device)[:HOT_ROWS]
    q = corpus[rows].repeat_interleave(HOT_COPIES, dim=0)
    q = q + 0.01 * torch.randn(q.shape, generator=gen, device=device)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return q[torch.randperm(q.shape[0], generator=gen, device=device)]


def main_ivf(corpus, queries, truth, device, kernels, launches,
             lookups_per_s: float, seed: int, meta, ftruth,
             min_recall: float) -> float:
    """ivf_pq, trained once, served under every grid, unfiltered and
    filtered (each grid on each bitmap against its plain version, at the
    boosted nprobe); scan_all at Q = 32, and filtered; the three ivf_adc
    kernels timed on the phase's queries and on the hot set."""
    import numpy as np
    import torch
    from repro_torch import VectorDB
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import LEDGER
    t0 = time.perf_counter()
    db = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES,
                  device=device).load(corpus, meta=meta)
    torch.cuda.synchronize()
    idx = db.index
    log(f"  ivf_pq load: {time.perf_counter() - t0:.2f} s "
        f"(clusters {idx.centroids.shape[0]}, steps_per_probe "
        f"{idx.spp}, storage rows {idx.layout.capacity}, layout "
        f"{idx.layout.memory_bytes() / 1e9:.3f} GB, adc_mode {idx.adc_mode})")
    ops.reset_launch_counts()
    results = {}
    for mode in ("auto", "per_query") + GROUPED:
        idx.adc_mode = mode
        results[mode] = serve_batches(db, queries, f"ivf_pq {mode}")
    counts = ops.launch_counts()
    log(f"  launches on the ivf_pq path (all four modes): {counts}")
    for name in ("ivf_adc", "visit_sharing") + tuple(f"ivf_adc_{m}"
                                                     for m in GROUPED):
        launches[name] = counts[name]
    for mode in ("auto",) + GROUPED:
        for Q in BATCHES:
            if not same_result(results[mode][Q], results["per_query"][Q]):
                raise AssertionError(f"ivf_pq {mode} Q={Q} differs from "
                                     "per_query")
    log("  ivf_pq auto, blocked and run_resident equal per_query bit for bit "
        f"at Q = {BATCHES}")
    log(f"  adc_stats: {db.adc_stats}")
    log(f"  autotuner decisions: {LEDGER.decisions()}")
    recall = recall_at_10(results["per_query"][max(BATCHES)][1], truth)
    log(f"  recall@10 of ivf_pq against flat: {recall:.4f} "
        f"({truth.shape[0]} queries)")
    maps = bitmaps(db, device)
    f_launch, fres = {}, {}
    for mode in ("auto", "per_query") + GROUPED:
        idx.adc_mode = mode
        fres[mode] = counted(f_launch, serve_filtered, db, queries,
                             f"ivf_pq {mode}", maps, results[mode])
        filtered_recalls(fres[mode], ftruth, f"ivf_pq {mode}", min_recall)
    for mode in ("auto",) + GROUPED:
        for name in maps:
            for Q in BATCHES:
                if not same_result(fres[mode][name][Q],
                                   fres["per_query"][name][Q]):
                    raise AssertionError(f"ivf_pq {mode} where {name} Q={Q} "
                                         "differs from per_query")
    log("  ivf_pq filtered: auto, blocked and run_resident equal per_query "
        f"bit for bit for every predicate at Q = {BATCHES}; launches "
        f"{f_launch}")
    for name in ("ivf_adc", "visit_sharing") + tuple(f"ivf_adc_{m}"
                                                     for m in GROUPED):
        launches[name] += f_launch.get(name, 0)
    idx.adc_mode = "per_query"
    ivf_breakdown(idx, queries)

    k, blk, m = idx.refine, idx.block_size, idx.codebooks.shape[0]
    grids = {"ivf_adc": (K.ivf_adc_cuda, K.ivf_adc_plain, None),
             "ivf_adc_blocked": (K.ivf_adc_blocked_cuda,
                                 K.ivf_adc_blocked_plain, "blocked"),
             "ivf_adc_run_resident": (K.ivf_adc_run_resident_cuda,
                                      K.ivf_adc_run_resident_plain,
                                      "run_resident")}
    timed, by_q, vs_by_q = {}, {name: {} for name in grids}, {}
    for Q in BATCHES:
        codes, ids, visit, luts, coarse, spp = probe_inputs(idx, queries[:Q])
        vs_by_q[Q] = check_visit_sharing(visit, codes.shape[0],
                                         ids.shape[0] - 1, Q)
        t_s = time.perf_counter()
        sched = ops.build_schedule(visit, qblk=8, pad_block=ids.shape[0] - 1)
        torch.cuda.synchronize()
        t_s = (time.perf_counter() - t_s) * 1e3
        t_v = time.perf_counter()
        share = ops.visit_sharing(visit, pad_block=ids.shape[0] - 1)
        t_v = (time.perf_counter() - t_v) * 1e3
        log(f"  Q={Q}: visit_sharing {t_v:.3f} ms (host clock, one "
            f"torch.unique and a sync; {share}), build_schedule qblk=8 "
            f"{t_s:.3f} ms (host clock, device sort and one sync; groups "
            f"{sched['groups']}, runs {sched['n_runs']})")
        for name, (cuda, plain, mode) in grids.items():
            if mode is None:
                def fn():
                    return cuda(codes, ids, visit, luts, coarse, k=k,
                                steps_per_probe=spp,
                                pad_block=ids.shape[0] - 1)
            else:
                def fn():
                    return cuda(codes, ids, visit, sched, luts, coarse, k=k,
                                steps_per_probe=spp)
            ms = gpu_ms(fn, 5)
            b = ivf_bound(ids, visit, luts, coarse, blk, m, lookups_per_s, k,
                          sched if mode else None)
            by_q[name][Q] = (ms, b)
            before = (f"; before this design {EARLIER_MS[name][Q]:.3f} ms"
                      if name in EARLIER_MS else "")
            dev_us = device_us(fn)
            log(f"  {name} kernel Q={Q}: {ms:.3f} ms (bound {b[0]:.3f} ms, "
                f"{b[1]}{before}); device us a call by kernel (profiler): "
                + ", ".join(f"{n} {u:.1f}" for n, u in dev_us.items()))
            if mode is None:
                walked_steps(codes, ids, visit, luts, coarse, spp, k, Q)
            if Q == 32:
                args = ((codes, ids, visit, luts, coarse) if mode is None
                        else (codes, ids, visit, sched, luts, coarse))
                plain_ms = gpu_ms(lambda: plain(*args, k=k,
                                                steps_per_probe=spp), 2)
                timed[name] = (ms, plain_ms, b, f"Q=32 T={visit.shape[1]} "
                               f"blk={blk} m={m} k={k}"
                               + (f" qblk=8 groups={sched['groups']}"
                                  if mode else ""))
    errs = dict.fromkeys(grids, 0.0)
    for Q in BATCHES:
        args = probe_inputs(idx, queries[:Q])
        kw = dict(k=k, spp=args[5], lut_dtype="float32")
        if Q < max(BATCHES):
            errs["ivf_adc"] = max(errs["ivf_adc"], compare_ivf(
                *args[:5], **kw, label=f"ivf_adc full size Q={Q}"))
        for mode in GROUPED:
            errs[f"ivf_adc_{mode}"] = max(errs[f"ivf_adc_{mode}"],
                                          compare_grouped(
                *args[:5], mode=mode, qblk=8, **kw,
                label=f"ivf_adc_{mode} full size Q={Q}"))
    f_errs = dict.fromkeys(grids, 0.0)
    for name, (pred, allowed) in maps.items():
        sel = float(allowed.float().mean())
        boost = int(np.clip(np.round(1.0 / max(sel, 1e-9)), 1, 4))
        nprobe = min(idx.nprobe * boost, idx.centroids.shape[0])
        codes, ids, visit, luts, coarse, spp = probe_inputs(
            idx, queries[:32], nprobe=nprobe)
        masked = ops.mask_allowed_ids(ids, allowed)
        kw = dict(k=k, spp=spp, lut_dtype="float32")
        f_errs["ivf_adc"] = max(f_errs["ivf_adc"], compare_ivf(
            codes, masked, visit, luts, coarse, **kw,
            label=f"ivf_adc filtered {name} Q=32 nprobe={nprobe}"))
        for mode in GROUPED:
            f_errs[f"ivf_adc_{mode}"] = max(
                f_errs[f"ivf_adc_{mode}"], compare_grouped(
                    codes, masked, visit, luts, coarse, mode=mode, qblk=8,
                    **kw, label=f"ivf_adc_{mode} filtered {name} Q=32 "
                                f"nprobe={nprobe}"))
    hot_set(idx, corpus, seed, device, grids, lookups_per_s)
    for name, (ms, plain_ms, b, shape) in timed.items():
        kernels.append(kernel_entry(
            name, "src/repro_torch/csrc/ivf_adc.cu",
            {"ivf_adc": "src/repro/kernels/ivf_adc.py:150",
             "ivf_adc_blocked": "src/repro/kernels/ivf_adc.py:284",
             "ivf_adc_run_resident": "src/repro/kernels/ivf_adc.py:469"}[name],
            launches[name], errs[name], ms, plain_ms, b, None,
            shape + "; library_ms null: no single PyTorch call gathers and "
            "sums table entries"))
        kernels[-1]["by_q"] = {str(Q): {"ms": t[0], "bound_ms": t[1][0],
                                        "bound_by": t[1][1]}
                               for Q, t in by_q[name].items()}
        kernels[-1]["filtered"] = {"launches": f_launch.get(name, 0),
                                   "max_abs_err": f_errs[name]}
        log(f"  {name} Q=32: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b[0]:.3f} ms ({b[1]}), no single library call")
    ms, plain_ms, b, shape = vs_by_q[max(BATCHES)]
    kernels.append(kernel_entry(
        "visit_sharing", "src/repro_torch/csrc/visit_sharing.cu",
        "src/repro/core/ivf.py:141 (a host count, no TPU kernel)",
        launches["visit_sharing"], 0, ms, plain_ms, b, None,
        shape + "; max_abs_err 0: pairs, blocks and sharing equal "
        "visit_sharing's exactly at every Q; library_ms null: the plain "
        "version is the PyTorch count"))
    kernels[-1]["by_q"] = {str(Q): {"ms": t[0], "plain_ms": t[1],
                                    "bound_ms": t[2][0], "bound_by": t[2][1]}
                           for Q, t in vs_by_q.items()}

    # scan_all from the same trained state (the corpus tensor is shared)
    t0 = time.perf_counter()
    sdb = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES, scan_all=True,
                   device=device).load_state(
        dict(idx.state_dict(), **db.metastore.state_leaves()))
    torch.cuda.synchronize()
    log(f"  ivf_pq scan_all load_state: {time.perf_counter() - t0:.2f} s")
    q32 = queries[:32]
    sdb.query(q32, k=10)
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS[32]):
        t0 = time.perf_counter()
        s, i = sdb.query(q32, k=10)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s_recall = recall_at_10(i, truth[:32])
    log(f"  ivf_pq scan_all Q=32: p50 {percentile(times, 50) * 1e3:.3f} ms, "
        f"p99 {percentile(times, 99) * 1e3:.3f} ms (n={len(times)}), "
        f"recall@10 against flat {s_recall:.4f}")
    codes, luts, assign, live = scan_all_inputs(idx, q32)
    compare_pq(codes, luts, k=k, lut_dtype="float32", valid=live,
               extra=assign, label=f"pq_adc scan_all full size W="
                                   f"{luts.shape[2]} Q=32")
    sres = {Q: sdb.query(queries[:Q], k=10) for Q in BATCHES}
    s_launch = {}
    sfres = counted(s_launch, serve_filtered, sdb, queries, "ivf_pq scan_all",
                    maps, sres)
    filtered_recalls(sfres, ftruth, "ivf_pq scan_all", min_recall)
    s_err = 0.0
    for name, (pred, allowed) in maps.items():
        s_err = max(s_err, compare_pq(
            codes, luts, k=k, lut_dtype="float32",
            valid=ops.and_allowed(live, allowed, codes.shape[0]),
            extra=assign, label=f"pq_adc scan_all filtered {name} Q=32"))
    pq_entry = next(e for e in kernels if e["name"] == "pq_adc")
    pq_entry["launches"] += s_launch.get("pq_adc", 0)
    pq_entry["filtered"]["launches"] += s_launch.get("pq_adc", 0)
    pq_entry["filtered"]["max_abs_err"] = max(
        pq_entry["filtered"]["max_abs_err"], s_err)
    del sdb, db, idx, codes, luts, assign, live, fres, sfres, maps
    torch.cuda.empty_cache()
    return recall


def check_visit_sharing(visit, n_blocks: int, pad_block: int,
                        Q: int) -> tuple:
    """The sharing count's kernel and its plain version on the card, each
    against ``visit_sharing`` (the host probe: a mask and a unique) on the
    engine's own visit table, exactly; then timed. At Q = 512 the table's
    n = Q x T ids are more than the kernel's grid holds in one pass, so its
    grid-stride loop and last-block finish run. Returns (kernel ms, plain
    ms, bound, shape)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import visit_sharing as vs
    want = ops.visit_sharing(visit, pad_block=pad_block)
    for use_kernel in (True, False):
        got = vs.visit_sharing_device(visit, n_blocks, pad_block=pad_block,
                                      use_kernel=use_kernel)
        got = {key: v.item() for key, v in got.items()}
        if got != want:
            raise AssertionError(f"visit_sharing_device use_kernel="
                                 f"{use_kernel} Q={Q}: {got} != {want}")
    kw = dict(pad_block=pad_block)
    ms = gpu_ms(lambda: vs.visit_sharing_cuda(visit, n_blocks, **kw), 20)
    plain_ms = gpu_ms(lambda: vs.visit_sharing_plain(visit, n_blocks, **kw),
                      5)
    dev_us = device_us(lambda: vs.visit_sharing_cuda(visit, n_blocks, **kw))
    n = visit.numel()
    b = bound_ms(4 * n + 2 * 8 * ((n_blocks + 63) // 64), n)
    shape = f"Q={Q} T={visit.shape[1]} n={n} n_blocks={n_blocks}"
    log(f"  visit_sharing {shape}: kernel and plain version equal the host "
        f"probe ({want}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(events, back to back), bound {b[0]:.4f} ms ({b[1]}); device us a "
        "call by kernel (profiler): "
        + ", ".join(f"{k} {u:.1f}" for k, u in dev_us.items()))
    return ms, plain_ms, b, shape


def hot_set(idx, corpus, seed: int, device, grids: dict,
            lookups_per_s: float) -> None:
    """The three ivf_adc kernels on the hot set at Q = 32 and 512: the
    sharing factor, each grid's time beside the bound, and both grouped
    grids against their plain versions and the per-query kernel, bit for
    bit."""
    import torch
    from repro_torch.kernels import ops
    hot = hot_queries(corpus, seed, device)
    k, blk, m = idx.refine, idx.block_size, idx.codebooks.shape[0]
    for Q in (32, 512):
        codes, ids, visit, luts, coarse, spp = probe_inputs(idx, hot[:Q])
        pad = ids.shape[0] - 1
        share = ops.visit_sharing(visit, pad_block=pad)
        sched = ops.build_schedule(visit, qblk=8, pad_block=pad)
        times = {}
        for name, (cuda, _, mode) in grids.items():
            if mode is None:
                times[name] = gpu_ms(lambda: cuda(codes, ids, visit, luts,
                                                  coarse, k=k,
                                                  steps_per_probe=spp,
                                                  pad_block=pad), 5)
            else:
                times[name] = gpu_ms(lambda: cuda(codes, ids, visit, sched,
                                                  luts, coarse, k=k,
                                                  steps_per_probe=spp), 5)
        b = ivf_bound(ids, visit, luts, coarse, blk, m, lookups_per_s, k)
        log(f"  hot set Q={Q} ({HOT_ROWS} rows x {HOT_COPIES} noisy copies, "
            f"shuffled): sharing {share['sharing']:.3f} (pairs "
            f"{share['pairs']}, blocks {share['blocks']}; groups "
            f"{sched['groups']}, runs {sched['n_runs']}); "
            + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
            + f" (bound {b[0]:.3f} ms, {b[1]})")
        if Q < max(BATCHES):
            compare_ivf(codes, ids, visit, luts, coarse, k=k, spp=spp,
                        lut_dtype="float32", label=f"ivf_adc hot set Q={Q}")
        for mode in GROUPED:
            compare_grouped(codes, ids, visit, luts, coarse, k=k, spp=spp,
                            lut_dtype="float32", mode=mode, qblk=8,
                            label=f"ivf_adc_{mode} hot set Q={Q}")
    del hot
    torch.cuda.empty_cache()


def ivf_breakdown(idx, queries) -> None:
    """Device ms of each ivf_pq query stage at each batch size (CUDA
    events, stage by stage): probe stage (centroid scores, top-nprobe,
    visit table, tables), the ivf_adc scan, the exact re-rank."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import _ivf_probe_stage
    from repro_torch.kernels import ops
    for Q in BATCHES:
        q = D.l2_normalize(queries[:Q].float())
        args = (idx.codebooks, idx.centroids, q, idx.block_table)
        kw = dict(metric="dot", nprobe=idx.nprobe, steps_per_probe=idx.spp,
                  pad_block=idx.bucket_ids.shape[0] - 1)
        probe = gpu_ms(lambda: _ivf_probe_stage(*args, **kw), 5)
        visit, luts, coarse, _ = _ivf_probe_stage(*args, **kw)
        scan = gpu_ms(lambda: ops.ivf_adc_topk(
            idx.codes_bm, idx.bucket_ids, visit, luts, k=idx.refine,
            coarse=coarse, steps_per_probe=idx.spp, mode="per_query",
            pad_block=kw["pad_block"]), 5)
        _, cand = ops.ivf_adc_topk(idx.codes_bm, idx.bucket_ids, visit, luts,
                                   k=idx.refine, coarse=coarse,
                                   steps_per_probe=idx.spp, mode="per_query",
                                   pad_block=kw["pad_block"])
        rerank = gpu_ms(lambda: D.rerank_topk(idx.corpus, idx.corpus_sq, cand,
                                              q, metric="dot", k=10), 5)
        log(f"  ivf_pq stages Q={Q}: probe stage {probe:.3f} ms, ivf_adc "
            f"{scan:.3f} ms, re-rank {rerank:.3f} ms (device ms, CUDA events)")


def main_lsh(corpus, queries, truth, device, kernels, launches,
             popc_per_s: float) -> float:
    """lsh at the reference defaults: serve, recall, kernel path against
    the plain path, stage times, the hamming kernels timed."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import distances as D
    from repro_torch.core.lsh import lsh_search, sign_codes
    from repro_torch.kernels import ops
    from repro_torch.kernels import _build
    from repro_torch.kernels.hamming import (hamming_cuda,
                                             hamming_shortlist_cuda,
                                             hamming_shortlist_plain,
                                             shortlist_plan)
    t0 = time.perf_counter()
    db = VectorDB("lsh", metric="cosine", device=device).load(corpus)
    torch.cuda.synchronize()
    idx = db.index
    T, N, W = idx.codes.shape
    L = min(idx.shortlist, N)
    log(f"  lsh load: {time.perf_counter() - t0:.2f} s (n_bits "
        f"{idx.n_bits}, tables {idx.n_tables}, shortlist {idx.shortlist}; "
        f"codes and planes {idx.memory_bytes() / 1e9:.3f} GB)")
    res, counts = serve_and_count(db, queries, "lsh")
    launches["hamming"] = counts["hamming"]
    recall = recall_at_10(res[max(BATCHES)][1], truth)
    log(f"  recall@10 of lsh against flat: {recall:.4f} "
        f"({truth.shape[0]} queries)")
    for Q in (1, 32):
        q = queries[:Q]
        plain = lsh_search(idx.corpus, idx.codes, idx.planes, q,
                           metric="cosine", k=10, shortlist=idx.shortlist,
                           use_kernel=False)
        if not same_result(db.query(q, k=10), plain):
            raise AssertionError(f"lsh Q={Q}: kernel path differs from the "
                                 "plain path")
    log("  lsh kernel path equals the plain path (ids and scores, bit for "
        "bit) at Q = 1 and 32")
    lsh_breakdown(idx, queries)

    def q_codes(Q):
        return sign_codes(D.l2_normalize(queries[:Q].float()), idx.planes)

    # popcounts a (query, row) pair needs at fewest: a four-word table
    # takes three (one carry-save step counts three of its words with two),
    # any other width one a word
    popc_per_pair = T * (3 if W == 4 else W)

    def bound(Q, out_bytes):
        return bound_ms(idx.codes.numel() * 4 + T * Q * W * 4 + out_bytes,
                        float(Q) * N * popc_per_pair, popc_per_s)

    timed = {}
    for Q in BATCHES:
        qc = q_codes(Q)
        ms = gpu_ms(lambda: hamming_shortlist_cuda(qc, idx.codes, L), 5)
        b = bound(Q, Q * L * 8)
        timed[Q] = (ms, b)
        p = shortlist_plan(N, Q, T, W, L, _build.card(qc.device))
        log(f"  hamming_shortlist kernel Q={Q} L={L}: {ms:.3f} ms (bound "
            f"{b[0]:.3f} ms, {b[1]}; before this design "
            f"{EARLIER_MS['hamming_shortlist'][Q]:.3f} ms); plan {p}")
    for Q in (1, 32):
        qc = q_codes(Q)
        ms = gpu_ms(lambda: hamming_cuda(qc, idx.codes), 3)
        b = bound(Q, Q * N * 4)
        log(f"  hamming (Q, N) matrix kernel Q={Q}: {ms:.3f} ms (bound "
            f"{b[0]:.3f} ms, {b[1]})")
    for Q in (32, 512):
        qc = q_codes(Q)
        caps = {cap: gpu_ms(lambda: hamming_shortlist_cuda(qc, idx.codes, L,
                                                           cap), 3)
                for cap in (8, 16, 32)}
        log(f"  hamming_shortlist Q={Q} L={L} by query tile cap: " + ", ".join(
            f"{cap}: {ms:.3f} ms" for cap, ms in caps.items()))
    for Q in (1, 32):
        qc = q_codes(Q)
        by_l = {n: gpu_ms(lambda: hamming_shortlist_cuda(qc, idx.codes, n), 3)
                for n in (1, 256)}
        log(f"  hamming_shortlist kernel Q={Q} by shortlist length: L=1 "
            f"{by_l[1]:.3f} ms, L={L} {timed[Q][0]:.3f} ms, L=256 "
            f"{by_l[256]:.3f} ms (the same distances; the boards' work "
            f"grows with L)")
    qc = q_codes(32)
    plain_ms = gpu_ms(lambda: hamming_shortlist_plain(qc, idx.codes, L), 1)
    err = max(compare_hamming(q_codes(Q), idx.codes, L,
                              f"full size Q={Q}", full=False)
              for Q in BATCHES)
    ms, b = timed[32]
    entry = kernel_entry(
        "hamming", "src/repro_torch/csrc/hamming.cu",
        "src/repro/kernels/hamming.py:37", launches["hamming"], err, ms,
        plain_ms, b, None,
        f"hamming_shortlist Q=32 T={T} N={N} W={W} L={L}; library_ms null: "
        f"no single PyTorch call computes XOR popcounts")
    entry["by_q"] = {str(Q): {"ms": t[0], "bound_ms": t[1][0],
                              "bound_by": t[1][1]} for Q, t in timed.items()}
    kernels.append(entry)
    log(f"  hamming_shortlist Q=32: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms, bound {b[0]:.3f} ms ({b[1]}), no single library call")
    del db, idx, res
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return recall


def lsh_breakdown(idx, queries) -> None:
    """Device ms of each lsh query stage at each batch size (CUDA events,
    stage by stage): query signatures, the hamming shortlist, the exact
    re-rank."""
    from repro_torch.core import distances as D
    from repro_torch.core.lsh import sign_codes
    from repro_torch.kernels import ops
    L = min(idx.shortlist, idx.codes.shape[1])
    for Q in BATCHES:
        q = D.l2_normalize(queries[:Q].float())
        sig = gpu_ms(lambda: sign_codes(q, idx.planes), 5)
        qc = sign_codes(q, idx.planes)
        short = gpu_ms(lambda: ops.hamming_shortlist(qc, idx.codes, L), 5)
        _, cand = ops.hamming_shortlist(qc, idx.codes, L)
        rr = gpu_ms(lambda: D.rerank_topk(idx.corpus, None, cand, q,
                                          metric="dot", k=10), 5)
        log(f"  lsh stages Q={Q}: signatures {sig:.3f} ms, hamming_shortlist "
            f"{short:.3f} ms, re-rank {rr:.3f} ms (device ms, CUDA events)")


def walked_steps(codes, ids, visit, luts, coarse, spp: int, k: int,
                 Q: int) -> None:
    """The visit steps the per-query kernel scored, counted by the kernel
    itself, against the real steps of the visit table (neither on the pad
    block nor in a knocked-out probe) and against Q x T; fails unless the
    kernel scored exactly the real ones."""
    import torch
    from repro_torch.kernels import ivf_adc as K
    pad = ids.shape[0] - 1
    walked = torch.zeros(visit.shape[0], dtype=torch.int32,
                         device=visit.device)
    K._per_query_cuda(codes, ids, visit, luts, coarse, k=k,
                      steps_per_probe=spp, lut_dtype="float32",
                      pad_block=pad, walked=walked)
    live = torch.repeat_interleave(coarse > 0.5 * -1e30, spp, dim=1)
    real = (live & (visit != pad)).sum(1)
    got, want = int(walked.sum()), int(real.sum())
    log(f"  ivf_adc Q={Q}: the kernel scored {got} visit steps of "
        f"{visit.numel()} (Q x T; {got / visit.numel():.1%}), "
        f"{float(walked.float().mean()):.1f} a query (least "
        f"{int(walked.min())}, most {int(walked.max())}); real steps "
        f"{want}")
    if not torch.equal(walked.long(), real):
        raise AssertionError(f"ivf_adc Q={Q}: the kernel scored other steps "
                             "than the real ones")


def ivf_bound(ids, visit, luts, coarse, blk: int, m: int,
              lookups_per_s: float, k: int = 32, sched=None) -> tuple:
    """Least time for one IVF-ADC call on these inputs: every distinct real
    block it visits read once (codes and slot ids), the tables and the
    (Q, nprobe) coarse terms read once, the (Q, k) result written once,
    and the grid's index input read once (the (Q, T) visit table; a grouped
    grid also reads its schedule), against m table terms a scored slot,
    each a shared-memory lookup and a float32 add (``adc_bound``)."""
    import torch
    pad = ids.shape[0] - 1
    real = int((torch.unique(visit) != pad).sum())
    slots = int((ids[visit.long()] >= 0).sum())
    Q, T = visit.shape
    n_bytes = (real * blk * (m + 4) + luts.numel() * 4 + Q * T * 4
               + coarse.numel() * 4 + Q * k * 8)
    if sched is not None:
        n_bytes += sum(sched[key].numel() * 4
                       for key in ("sb", "sq", "st", "rb", "rs", "rl"))
    return adc_bound(n_bytes, float(slots) * m, lookups_per_s)


class TextEncoder:
    """The encoder callable that ``load_texts`` and ``query_texts`` take,
    built as examples/train_sbert.py builds its ``embed``: the hash
    tokenizer at a fixed seq_len, mask = tokens != 0, then ``encode`` on the
    card. Sums host seconds of tokenizing and, with ``sync``, of encoding
    (each encode then ends in a synchronize)."""

    def __init__(self, model, cfg, seq_len: int, device):
        self.model, self.cfg, self.seq_len, self.device = model, cfg, seq_len, device
        self.sync = False
        self.tokenize_s = self.encode_s = 0.0

    def tokens(self, texts):
        import numpy as np
        from repro_torch.data.marco import simple_tokenizer
        return np.stack([simple_tokenizer(t, self.cfg.vocab_size, self.seq_len)
                         for t in texts])

    def __call__(self, texts):
        import torch
        from repro_torch.models.encoder import encode
        t0 = time.perf_counter()
        tok = torch.from_numpy(self.tokens(texts)).to(self.device)
        t1 = time.perf_counter()
        self.tokenize_s += t1 - t0
        out = encode(self.model, self.cfg, tok, tok != 0)
        if self.sync:
            torch.cuda.synchronize()
            self.encode_s += time.perf_counter() - t1
        return out


def encoder_cosine(model, cfg, tokens, mask, label: str) -> float:
    """Gate: the encoder through the kernel against the same forward
    through the plain attention, row by row; an empty text is the zero
    vector on both sides."""
    import torch
    from repro_torch.models.encoder import encode
    got = encode(model, cfg, tokens, mask)
    want = encode(model, cfg, tokens, mask, use_kernel=False)
    live = mask.any(dim=1)
    cos = (got * want).sum(dim=1)
    worst = float(cos[live].min())
    zero = bool((got[~live] == 0).all()) and bool((want[~live] == 0).all())
    log(f"  {label}: encoder through the kernel against the plain attention: "
        f"min row cosine {worst:.6f} (bound >= 0.999), empty rows zero {zero}")
    if worst < 0.999 or not zero:
        raise AssertionError(f"{label}: kernel forward differs from plain")
    return worst


def encoder_breakdown(model, cfg, tok, mask) -> None:
    """Device ms of one encoder block's stages at a load batch's shape
    (CUDA events, stage by stage, on the first block's inputs), times the
    layer count, beside one whole encode."""
    import torch
    from repro_torch.models.attention import multihead_attention
    from repro_torch.models.encoder import encode
    from repro_torch.models.layers import (apply_embed, apply_mlp,
                                           apply_norm, apply_rope)
    dtype = getattr(torch, cfg.dtype)
    blk, L = model.dense_blocks[0], cfg.n_layers
    x = apply_embed(model.embed, tok, dtype)
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    pos = torch.arange(S, device=x.device)[None]
    xn = apply_norm(blk.attn_norm, x)

    def qkv():
        return [(xn @ w.to(dtype).reshape(D, -1)).view(B, S, -1, dh)
                for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv)]

    q, k, v = qkv()
    o = multihead_attention(q, k, v, cfg, causal=False, window=None,
                            kv_mask=mask)
    stages = {
        "two norms": lambda: (apply_norm(blk.attn_norm, x),
                              apply_norm(blk.mlp_norm, x)),
        "q, k, v projections (with the weight casts)": qkv,
        "rotary on q and k": lambda: [apply_rope(t, pos, cfg.rope_theta,
                                                 cfg.rope_pct) for t in (q, k)],
        "flash_attention": lambda: multihead_attention(
            q, k, v, cfg, causal=False, window=None, kv_mask=mask),
        "output projection": lambda: (o.reshape(B, S, H * dh)
                                      @ blk.attn.wo.to(dtype).reshape(H * dh, D)),
        "MLP (up, gelu, down)": lambda: apply_mlp(blk.mlp, xn, cfg.act),
        "two residual adds": lambda: (x + x, x + x),
    }
    total = gpu_ms(lambda: encode(model, cfg, tok, mask), 3)
    log(f"  encode B={B} S={S}: {total:.3f} ms; one block's stages (device ms, "
        f"CUDA events) x {L} layers:")
    for name, fn in stages.items():
        ms = gpu_ms(fn, 5)
        log(f"    {name}: {ms:.4f} ms, x{L} = {ms * L:.3f} ms "
            f"({100 * ms * L / total:.1f} % of encode)")


def flash_bound(B: int, S: int, H: int, dh: int) -> tuple:
    """Least time for one non-causal bf16 call: q, k, v read and o written
    once (2 bytes an element) and the (B, S) mask read once, against
    4 B H S^2 dh operations on the tensor cores."""
    return bound_ms(4 * B * S * H * dh * 2 + B * S,
                    4.0 * B * H * S * S * dh, BF16_OPS_PER_S)


def time_flash(gen, B: int, S: int, mask, device) -> dict:
    """The kernel, its plain version and F.scaled_dot_product_attention on
    the same bf16 inputs of the encoder's attention shape (H = 12, dh = 64),
    and the kernel against the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    H, dh = 12, 64
    q, k, v = (torch.randn(B, S, H, dh, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    kw = dict(causal=False, scale=dh ** -0.5, kv_mask=mask)
    reps = 20 if B * S <= 4096 else 5
    ms = gpu_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps)
    plain_ms = gpu_ms(lambda: flash_attention_plain(q, k, v, **kw), 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    am = mask[:, None, None, :]
    lib_ms = gpu_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=am), reps)
    err = compare_flash(q, k, v, mask, False,
                        f"flash_attention at the text path's B={B} S={S}")
    b = flash_bound(B, S, H, dh)
    log(f"  flash_attention kernel B={B} S={S} H={H} dh={dh} bf16: {ms:.4f} ms "
        f"(bound {b[0]:.4f} ms, {b[1]}), plain {plain_ms:.4f} ms, "
        f"F.scaled_dot_product_attention {lib_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms, "bound": b,
            "err": err}


def phase_text(seed: int, device) -> dict:
    """Phase 5: the text path at full width; returns the flash_attention
    kernel entry."""
    import numpy as np
    import torch
    from repro_torch import VectorDB
    from repro_torch.configs import thistle_sbert
    from repro_torch.data.marco import MarcoLike
    from repro_torch.kernels import ops
    from repro_torch.models import encoder

    cfg = thistle_sbert.FULL
    log(f"phase 5: text path, {cfg.name} (layers {cfg.n_layers}, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype} activations, {cfg.param_dtype} "
        f"parameters, seeded random weights), {TEXT_PASSAGES} MarcoLike "
        f"passages at seq_len {TEXT_SEQ}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = MarcoLike(n_passages=TEXT_PASSAGES, vocab_size=cfg.vocab_size,
                     seed=seed)
    passages = data.passage_texts()
    queries = data.query_texts(n=max(BATCHES))
    log(f"  MarcoLike passages and {len(queries)} queries: "
        f"{time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    model = encoder.init(cfg, torch.Generator().manual_seed(seed),
                         device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  encoder init: {time.perf_counter() - t0:.2f} s, {n_params} "
        f"parameters")
    enc = TextEncoder(model, cfg, TEXT_SEQ, device)

    ops.reset_launch_counts()
    enc.sync = True
    t0 = time.perf_counter()
    db = VectorDB("flat", metric="cosine", device=device).load_texts(
        passages, enc, batch_size=TEXT_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"  load_texts: {wall:.2f} s = tokenize {enc.tokenize_s:.2f} s (host) "
        f"+ encode {enc.encode_s:.2f} s ({TEXT_PASSAGES // TEXT_BATCH} batches "
        f"of {TEXT_BATCH}, each ending in a synchronize) + index and the rest "
        f"{wall - enc.tokenize_s - enc.encode_s:.2f} s; "
        f"{TEXT_PASSAGES / wall:.1f} passages/s")
    enc.sync = False
    results = {}
    for Q in BATCHES:
        texts = queries[:Q]
        db.query_texts(texts, enc, k=10)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS[Q]):
            t1 = time.perf_counter()
            s, i, hits = db.query_texts(texts, enc, k=10)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        results[Q] = (s, i)
        log(f"  query_texts Q={Q}: p50 {percentile(times, 50) * 1e3:.3f} ms, "
            f"p99 {percentile(times, 99) * 1e3:.3f} ms (n={len(times)}), QPS "
            f"{Q * len(times) / sum(times):.1f}")
        if not (s.shape == (Q, 10) and torch.isfinite(s).all()
                and len(hits) == Q and len(hits[0]) == 10):
            raise AssertionError(f"query_texts Q={Q}: bad result")
    counts = ops.launch_counts()
    log(f"  launches on the text path (load_texts and every query_texts "
        f"batch): {counts}")
    top1 = float((results[max(BATCHES)][1][:, 0].cpu()
                  == torch.arange(max(BATCHES))).float().mean())
    log(f"  MarcoLike query -> its passage, top-1 over {max(BATCHES)} queries: "
        f"{top1:.4f} (random weights; printed, not gated)")
    hybrid = phase_hybrid(db, enc, queries)

    # stage split at each Q (CUDA events, stage by stage)
    for Q in BATCHES:
        t1 = time.perf_counter()
        tok = enc.tokens(queries[:Q])
        tok_ms = (time.perf_counter() - t1) * 1e3
        tok = torch.from_numpy(tok).to(device)
        emb = encoder.encode(model, cfg, tok, tok != 0)
        enc_ms = gpu_ms(lambda: encoder.encode(model, cfg, tok, tok != 0), 5)
        search_ms = gpu_ms(lambda: db.query(emb, k=10), 5)
        log(f"  text stages Q={Q}: tokenize {tok_ms:.3f} ms (host), encode "
            f"{enc_ms:.3f} ms, search {search_ms:.3f} ms (device ms, CUDA "
            f"events)")

    tok = torch.from_numpy(enc.tokens(passages[:TEXT_BATCH])).to(device)
    encoder_breakdown(model, cfg, tok, tok != 0)

    # gate 2: passages sent back as queries find themselves
    n_self = max(BATCHES)
    _, ids, _ = db.query_texts(passages[:n_self], enc, k=10)
    found = float((ids.cpu() == torch.arange(n_self)[:, None]).any(dim=1)
                  .float().mean())
    log(f"  {n_self} passages sent back through query_texts: in their own "
        f"top 10 {found:.4f} (bound >= 0.99)")
    if found < 0.99:
        raise AssertionError(f"self-retrieval {found:.4f} below 0.99")

    # gate 1: the encoder through the kernel against the plain attention,
    # at the load's seq_len and at max_seq_len with lengths 1..512
    tok = torch.from_numpy(enc.tokens(passages[:32])).to(device)
    encoder_cosine(model, cfg, tok, tok != 0, "B=32 S=64")
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    S = cfg.max_seq_len
    long_mask = ragged_mask(gen, 32, S, device, empty_row=False)
    long_mask[1] = torch.arange(S, device=device) < 1
    long_tok = torch.randint(2, cfg.vocab_size, (32, S), generator=gen,
                             device=device)
    long_tok = torch.where(long_mask, long_tok, 0)
    long_ms = gpu_ms(lambda: encoder.encode(model, cfg, long_tok, long_mask), 3)
    log(f"  encode B=32 S={S} (lengths 1..{S}): {long_ms:.3f} ms (device ms, "
        f"CUDA events)")
    encoder_cosine(model, cfg, long_tok, long_mask, f"B=32 S={S}")

    # the kernel at each shape the path gives it
    timed = {}
    for B, S in TEXT_FLASH_SHAPES:
        if S == TEXT_SEQ:
            t = torch.from_numpy(enc.tokens(passages[:B])).to(device)
            mask = t != 0
        else:
            mask = long_mask[:B]
        timed[(B, S)] = time_flash(gen, B, S, mask, device)

    # gate 3
    if counts["flash_attention"] <= 0:
        raise AssertionError("flash_attention never launched on the text path")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in the text phase: {peak / 1e9:.2f} GB")
    main = timed[(TEXT_BATCH, TEXT_SEQ)]
    del db, model, enc
    torch.cuda.empty_cache()
    return dict(hybrid_launches=hybrid.get("flash_attention", 0),
                **kernel_entry(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:70", counts["flash_attention"],
        max(t["err"] for t in timed.values()), main["ms"], main["plain_ms"],
        main["bound"], main["lib_ms"],
        f"B={TEXT_BATCH} S={TEXT_SEQ} H=12 dh=64 bf16 non-causal with the "
        f"passages' key-padding mask (a load_texts batch); library_ms: "
        f"F.scaled_dot_product_attention with the same boolean mask"))


HYBRID_REPS = {1: 10, 32: 6, 512: 2}


def bm25_ranked(ids, lex_s, lex_i) -> bool:
    """Whether a hybrid answer at alpha = 0 ranks as BM25 does: down to
    BM25's lowest score (which normalizes to 0 and ties the dense-only
    rows), each rank holds an id whose BM25 score is BM25's at that rank
    (ids may swap between equal BM25 scores)."""
    ok = lex_i >= 0
    if not ok.any():
        return True
    top = int((lex_s[ok] > lex_s[ok].min()).sum())
    score = dict(zip(lex_i[ok].tolist(), lex_s[ok].tolist()))
    return all(score.get(int(i)) == float(lex_s[j])
               for j, i in enumerate(ids[:top]))


def phase_hybrid(db, enc, queries) -> dict:
    """Phase 5's hybrid search: ``enable_lexical`` over the loaded passages
    (its build time), then ``query(emb, hybrid=alpha, hybrid_texts=...)``
    at Q = 1, 32, 512 on the encoder's embeddings of the query texts. At
    alpha = 1 the ids equal the dense-only ids; at alpha = 0 BM25's ranking
    (``BM25Index.score``) comes first, down to its lowest score, which
    normalizes to 0 and ties the dense-only rows (the merge keeps those
    first); p50 at alpha = 0.5, encode included, with BM25's share
    (tokenize and score, host). Returns the launches of the timed path."""
    import torch
    t0 = time.perf_counter()
    lex = db.enable_lexical()
    log(f"  enable_lexical over {lex.n_docs} passages: "
        f"{time.perf_counter() - t0:.2f} s (host: tokenize, the postings of "
        f"{len(lex.postings)} tokens)")
    path = {}
    for Q in BATCHES:
        texts = queries[:Q]
        emb = enc(texts)
        dense = db.query(emb, k=10)[1]
        if not torch.equal(db.query(emb, k=10, hybrid=1.0,
                                    hybrid_texts=texts)[1], dense):
            raise AssertionError(f"hybrid alpha=1 Q={Q}: ids differ from the "
                                 "dense-only ids")
        lex_s, lex_i = lex.score(lex.tokenize(texts), k=10)
        h0 = db.query(emb, k=10, hybrid=0.0,
                      hybrid_texts=texts)[1].cpu().numpy()
        for r in range(Q):
            if not bm25_ranked(h0[r], lex_s[r], lex_i[r]):
                raise AssertionError(f"hybrid alpha=0 Q={Q} row {r}: ids "
                                     "differ from BM25's")

        def one():
            return db.query(enc(texts), k=10, hybrid=0.5, hybrid_texts=texts)

        counted(path, one)
        torch.cuda.synchronize()
        times, bm25 = [], []
        for _ in range(HYBRID_REPS[Q]):
            t1 = time.perf_counter()
            counted(path, one)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            lex.score(lex.tokenize(texts), k=10)
            bm25.append(time.perf_counter() - t2)
            times.append(t2 - t1)
        p50, b50 = percentile(times, 50), percentile(bm25, 50)
        log(f"  hybrid alpha=0.5 Q={Q}: p50 {p50 * 1e3:.3f} ms, p99 "
            f"{percentile(times, 99) * 1e3:.3f} ms (n={len(times)}, encode "
            f"included); BM25 tokenize and score (host) p50 {b50 * 1e3:.3f} "
            f"ms, {b50 / p50:.1%} of it; alpha=1 ids equal the dense ids, "
            f"alpha=0 ids BM25's")
    log(f"  filter_stats after the hybrid queries: {db.filter_stats}")
    return path


# ------------------------------------------------ phase 6: writes, serving
MUT_INSERT = 88_418      # 1 % of the passages: new rows
MUT_DELETE = 884_182     # 10 %: random live ids tombstoned
MUT_UPSERT = 88_418      # 1 %: existing ids re-encoded with fresh vectors
MUT_BATCH = {"insert": 1024, "delete": 8192, "upsert": 1024}
SELF_QUERIES = 4096      # rows sent back as queries, of each kind
SELF_MARGIN = 0.02       # written rows found at least as often as loaded ones
                         # less this (5 standard deviations of the difference
                         # of two rates near 0.93 over 4,096 rows each)
SERVE_READS = 2048       # single-query reads a stream
SERVE_EVERY = 8          # one write after every 8 reads (interleaved_1to8)
SERVE_ROWS = 64          # rows a write
SERVE_BATCH = 64         # the fronts' max_batch


def counted(acc: dict, fn, *args, **kw):
    """fn(*args, **kw), adding the kernel launches it made to ``acc``: the
    phase counts the launches of its path, not of its comparisons."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = fn(*args, **kw)
    for name, c in ops.launch_counts().items():
        acc[name] = acc.get(name, 0) + c - before[name]
    return out


def apply_writes(db, kind: str, total: int, batch: int, vectors=None,
                 ids=None, label: str = "", meta=None, rates=None) -> list:
    """Apply ``total`` rows of one write kind in batches (inserts and
    upserts with their slices of the ``meta`` columns, when given); logs
    rows/s (host clock around the batches, ending in a synchronize), also
    into ``rates`` by kind. Returns the writes' results."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for a in range(0, total, batch):
        b = min(total, a + batch)
        if kind == "insert":
            outs.append(db.insert(vectors[a:b], meta=meta_slice(meta, a, b)))
        elif kind == "delete":
            outs.append(db.delete(ids[a:b]))
        else:
            outs.append(db.upsert(vectors[a:b], ids[a:b],
                                  meta=meta_slice(meta, a, b)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rates is not None:
        rates[kind] = total / secs
    log(f"  {label}{kind} {total} rows in batches of {batch}: {secs:.3f} s, "
        f"{total / secs:.1f} rows/s (host clock, synced)")
    return outs


def write_mix(db, n: int, seed: int, device, rank: int, label: str = "",
              meta: bool = False, rates=None):
    """The reference's mutation mix (BENCH_mutation.json's paths) scaled to
    n rows: inserts of 1 % new rows, deletes of 10 % random loaded ids,
    upserts of 1 % other loaded ids with fresh vectors (so the inserted
    rows stay as written); with ``meta``, inserts and upserts carry
    ``seeded_meta`` columns. Returns (inserted ids, their vectors, upserted
    ids, their vectors, deleted ids)."""
    import torch
    n_ins, n_del, n_ups = n // 100, n // 10, n // 100
    ins_vecs = new_rows(n_ins, n, seed, 1, device, rank)
    ins_ids = torch.cat(apply_writes(
        db, "insert", n_ins, MUT_BATCH["insert"], vectors=ins_vecs,
        label=label, meta=seeded_meta(n_ins, seed, 1) if meta else None,
        rates=rates))
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    perm = torch.randperm(n, generator=gen, device=device)  # loaded rows
    dead, ups_ids = perm[:n_del], perm[n_del:n_del + n_ups]
    deleted = sum(apply_writes(db, "delete", n_del, MUT_BATCH["delete"],
                               ids=dead, label=label, rates=rates))
    if deleted != n_del:
        raise AssertionError(f"{label}deleted {deleted} of {n_del} live ids")
    ups_vecs = new_rows(n_ups, n, seed, 2, device, rank)
    apply_writes(db, "upsert", n_ups, MUT_BATCH["upsert"], vectors=ups_vecs,
                 ids=ups_ids, label=label, rates=rates,
                 meta=seeded_meta(n_ups, seed, 2) if meta else None)
    want = n + n_ins - n_del
    if db.index.size != want or db.n != want:
        raise AssertionError(f"{label}size {db.index.size} after the writes, "
                             f"expected {want}")
    return ins_ids, ins_vecs, ups_ids, ups_vecs, dead


def no_dead_ids(ids, dead_mask, label: str) -> None:
    got = ids[ids >= 0].long()
    if bool(dead_mask[got].any()):
        raise AssertionError(f"{label}: a deleted id in the results")


def equal_up_to_ties(a, b, label: str) -> None:
    """Scores bit-equal rank by rank; ids equal but where the score at
    that rank ties with a neighbour's."""
    import torch
    (s0, i0), (s1, i1) = a, b
    same_s = (s0 == s1) | (torch.isneginf(s0) & torch.isneginf(s1))
    if not bool(same_s.all()):
        raise AssertionError(f"{label}: scores differ")
    tie = torch.zeros_like(s0, dtype=torch.bool)
    tie[:, 1:] |= s0[:, 1:] == s0[:, :-1]
    tie[:, :-1] |= s0[:, :-1] == s0[:, 1:]
    diff = i0 != i1
    if bool((diff & ~tie).any()):
        raise AssertionError(f"{label}: ids differ outside ties")
    log(f"  {label}: scores bit-equal, ids equal at "
        f"{float((~diff).float().mean()):.4f} of ranks (the rest ties)")


def self_found(db, vecs, ids, label: str) -> float:
    """Share of rows, sent back as queries (batches of 512), found in their
    own top 10."""
    import torch
    got = torch.cat([db.query(vecs[a:a + 512], k=10)[1]
                     for a in range(0, vecs.shape[0], 512)])
    rate = float((got.long() == ids.long()[:, None]).any(1).float().mean())
    log(f"  {label}: {rate:.4f} of {vecs.shape[0]} found in their own top 10")
    return rate


def rows_in_layout(idx, ids, vecs, what: str) -> None:
    """Every written id sits in one slot of the layout, in the block list
    of the cluster its row is assigned to, with the codes its row encodes
    to (the engine's encode, in the batches it was written in)."""
    import torch
    lay = idx.layout
    pos = lay.pos[ids]
    if not bool((pos >= 0).all()):
        raise AssertionError(f"a {what} id is missing from the layout")
    enc = [idx._encode_batch(vecs[a:a + MUT_BATCH["insert"]])
           for a in range(0, vecs.shape[0], MUT_BATCH["insert"])]
    codes = torch.cat([e[0] for e in enc])
    assign = torch.cat([e[1] for e in enc])
    if not (torch.equal(lay.slots.view(-1)[pos].long(), ids.long())
            and torch.equal(lay.block_cluster[pos // lay.blk].long(),
                            assign.long())
            and torch.equal(lay.codes.view(-1, lay.m)[pos], codes)):
        raise AssertionError(f"a {what} row's slot, cluster or codes differ "
                             "from its encode")
    log(f"  all {ids.numel()} {what} ids sit in their cluster's block list "
        "with the codes their rows encode to")


def layout_facts(idx) -> str:
    lay = idx.layout
    return (f"storage rows {lay.capacity}, blocks {lay.n_blocks}, "
            f"steps_per_probe {lay.steps_per_probe}, re-rank corpus rows "
            f"{idx._corpus.capacity}, live {lay.live}, tombstones "
            f"{lay.tombstones} ({lay.tombstone_fraction:.4f})")


def grid_times(idx, queries, lookups_per_s: float, label: str) -> dict:
    """The three ivf_adc kernels at each Q of BATCHES on the engine's
    current layout: ms (CUDA events) beside the bound, and the visit steps
    the per-query kernel scored against the real ones (``walked_steps``
    fails unless equal). Returns {name: {Q: (ms, bound)}}."""
    from repro_torch.kernels import ivf_adc as K
    from repro_torch.kernels import ops
    k, blk, m = idx.refine, idx.block_size, idx.codebooks.shape[0]
    out = {n: {} for n in ("ivf_adc", "ivf_adc_blocked",
                           "ivf_adc_run_resident")}
    for Q in BATCHES:
        codes, ids, visit, luts, coarse, spp = probe_inputs(idx, queries[:Q])
        pad = ids.shape[0] - 1
        sched = ops.build_schedule(visit, qblk=8, pad_block=pad)
        calls = {
            "ivf_adc": lambda: K.ivf_adc_cuda(codes, ids, visit, luts, coarse,
                                              k=k, steps_per_probe=spp,
                                              pad_block=pad),
            "ivf_adc_blocked": lambda: K.ivf_adc_blocked_cuda(
                codes, ids, visit, sched, luts, coarse, k=k,
                steps_per_probe=spp),
            "ivf_adc_run_resident": lambda: K.ivf_adc_run_resident_cuda(
                codes, ids, visit, sched, luts, coarse, k=k,
                steps_per_probe=spp)}
        parts = []
        for name, fn in calls.items():
            ms = gpu_ms(fn, 5)
            b = ivf_bound(ids, visit, luts, coarse, blk, m, lookups_per_s, k,
                          None if name == "ivf_adc" else sched)
            out[name][Q] = (ms, b)
            parts.append(f"{name} {ms:.3f} ms (bound {b[0]:.3f}, {b[1]})")
        log(f"  {label} Q={Q} (T={visit.shape[1]}): " + ", ".join(parts))
        walked_steps(codes, ids, visit, luts, coarse, spp, k, Q)
    return out


def serve_modes(db, queries, dead, label: str) -> dict:
    """Every adc_mode over the batches; no deleted id anywhere; auto,
    blocked and run_resident equal per_query bit for bit."""
    idx = db.index
    res = {}
    for mode in ("auto", "per_query") + GROUPED:
        idx.adc_mode = mode
        res[mode] = serve_batches(db, queries, f"ivf_pq {mode} {label}")
        for Q in BATCHES:
            no_dead_ids(res[mode][Q][1], dead, f"{mode} {label} Q={Q}")
    for mode in ("auto",) + GROUPED:
        for Q in BATCHES:
            if not same_result(res[mode][Q], res["per_query"][Q]):
                raise AssertionError(f"ivf_pq {mode} {label} Q={Q} differs "
                                     "from per_query")
    log(f"  {label}: no deleted id at Q = {BATCHES} under any adc_mode; "
        "auto, blocked and run_resident equal per_query bit for bit")
    idx.adc_mode = "auto"
    return res


def kernel_against_plain(idx, queries, label: str) -> None:
    """The three grids on the mutated layout against their plain versions
    (the grouped ones also against the per-query kernel), bit for bit."""
    for Q in (1, 32):
        args = probe_inputs(idx, queries[:Q])
        kw = dict(k=idx.refine, spp=args[5], lut_dtype="float32")
        compare_ivf(*args[:5], **kw, label=f"ivf_adc {label} Q={Q}")
        for mode in GROUPED:
            compare_grouped(*args[:5], mode=mode, qblk=8, **kw,
                            label=f"ivf_adc_{mode} {label} Q={Q}")


def live_truth(idx, queries, label: str, acc: dict):
    """Exact top 10 over the live rows (flat_search through topk_distance
    on the engine's re-rank corpus under the layout's live mask, its
    launches counted in ``acc``), and that kernel held against its plain
    version at Q = 32."""
    import torch
    from repro_torch.core.flat import flat_search
    valid = torch.zeros(idx._corpus.capacity, dtype=torch.bool,
                        device=queries.device)
    valid[: idx.n] = idx.layout.live_mask(idx.n)
    _, truth = counted(acc, flat_search, idx._corpus.data, queries,
                       metric="cosine", k=10, valid=valid)
    compare_topk(idx._corpus.data,
                 queries[:32] / torch.linalg.vector_norm(
                     queries[:32], dim=1, keepdim=True),
                 "dot", 10, f"topk_distance live rows {label} Q=32",
                 valid=valid)
    return truth


def stream_script(db, queries, n: int, seed: int, salt: int, device,
                  rank: int, reads: int = SERVE_READS):
    """The interleaved_1to8 stream: ``reads`` single-query reads (k = 10)
    and after every SERVE_EVERY of them one write of SERVE_ROWS rows,
    inserts and deletes in turn. An insert's first row is an isotropic
    random unit vector, far from every cluster, and the read after it
    queries that row: it finds the row whenever the insert came first (a
    clustered row is found in its own top 10 only as often as the ADC cut
    keeps it, about 93 %). A delete takes the 64 best ids of the read
    after it (found before the stream). Returns the ops, in order."""
    import torch
    n_writes = reads // SERVE_EVERY
    fresh = new_rows(n_writes * SERVE_ROWS, n, seed, salt, device, rank)
    gen = torch.Generator(device=device).manual_seed(seed + salt)
    probe = torch.randn(n_writes, DIM, generator=gen, device=device)
    fresh[::SERVE_ROWS] = probe / torch.linalg.vector_norm(probe, dim=1,
                                                            keepdim=True)
    fresh = fresh.cpu()
    host_q = queries.cpu()
    after_delete = [host_q[(w * SERVE_EVERY + SERVE_EVERY) % host_q.shape[0]]
                    for w in range(n_writes)]
    victims = db.query(torch.stack(after_delete).to(device), k=SERVE_ROWS,
                       bucketize=False)[1].cpu()
    ops_, last = [], None
    for i in range(reads):
        if i and i % SERVE_EVERY == 0:
            w = i // SERVE_EVERY - 1
            if w % 2 == 0:
                last = ("insert", fresh[w * SERVE_ROWS:(w + 1) * SERVE_ROWS])
                ops_.append(("write", "insert", last[1], None))
            else:
                last = ("delete", victims[w])
                ops_.append(("write", "delete", None, victims[w]))
        if last is not None and last[0] == "insert":
            ops_.append(("read", last[1][0], "new"))
        elif last is not None:
            ops_.append(("read", after_delete[i // SERVE_EVERY - 1], None))
        else:
            ops_.append(("read", host_q[i % host_q.shape[0]], None))
        last = None
    return ops_


def check_stream(ops_, results, label: str) -> None:
    """Read-your-writes on a stream's results: the read after an insert
    finds the id of the row it queries; no read returns an id deleted
    before it."""
    deleted, new_id, found, n_new = set(), None, 0, 0
    for op, res in zip(ops_, results):
        if op[0] == "write":
            kind, out = res
            if kind == "insert":
                new_id = int(out[0])
            else:
                deleted.update(int(i) for i in op[3].tolist() if i >= 0)
            continue
        ids = set(res[1].tolist())
        if ids & deleted:
            raise AssertionError(f"{label}: a read returned an id deleted "
                                 "before it")
        if op[2] == "new":
            n_new += 1
            found += new_id in ids
    if found != n_new:
        raise AssertionError(f"{label}: {n_new - found} of {n_new} reads "
                             "behind an insert missed the inserted row")
    log(f"  {label}: {n_new} reads behind an insert found the new row; no "
        f"read saw any of the {len(deleted)} ids deleted before it")


def run_pump(db, ops_) -> tuple:
    """The stream through QueryEngine: everything queued, then drained.
    Returns (results in op order, latency_stats, seconds from the first
    submit to the last result, read batches)."""
    from repro_torch.serve import QueryEngine
    plans = sum(db.plan_stats.values())
    eng = QueryEngine(db, max_batch=SERVE_BATCH, max_wait_ms=2.0)
    t0 = time.perf_counter()
    rids = [eng.submit(op[1], 10) if op[0] == "read"
            else eng.submit_write(op[1], op[2], op[3]) for op in ops_]
    eng.drain()
    secs = time.perf_counter() - t0
    return ([eng.result(r) for r in rids], eng.latency_stats(), secs,
            sum(db.plan_stats.values()) - plans)


def run_async(db, ops_, queued: bool) -> tuple:
    """The stream through AsyncQueryEngine from one submitting thread:
    ``queued`` submits it all before the engine starts (the pump's
    setting), else the engine serves while the thread submits. Returns
    as ``run_pump``."""
    from repro_torch.serve import AsyncQueryEngine
    plans = sum(db.plan_stats.values())
    eng = AsyncQueryEngine(db, max_batch=SERVE_BATCH, max_wait_ms=2.0,
                           max_queue=4096, start=not queued)
    with eng:
        t0 = time.perf_counter()
        futs = [eng.submit(op[1], 10) if op[0] == "read"
                else eng.submit_write(op[1], op[2], op[3]) for op in ops_]
        eng.start()
        results = [f.result(timeout=600) for f in futs]
        secs = time.perf_counter() - t0
    return (results, eng.latency_stats(), secs,
            sum(db.plan_stats.values()) - plans)


FRONTS = (("QueryEngine", run_pump),
          ("AsyncQueryEngine queued", lambda db, o: run_async(db, o, True)),
          ("AsyncQueryEngine live", lambda db, o: run_async(db, o, False)))


def log_front(name: str, stats: dict, secs: float, batches: int,
              n_reads: int) -> None:
    log(f"  {name}: {n_reads} reads in {secs:.3f} s, QPS {n_reads / secs:.1f}, "
        f"{batches} read batches, p50 {stats['p50_ms']:.3f} ms, p99 "
        f"{stats['p99_ms']:.3f} ms (enqueue to result), queue_depth_max "
        f"{stats.get('queue_depth_max', '-')}, plan hits "
        f"{stats['plan_hits']} misses {stats['plan_misses']}, writes "
        + str({k: v for k, v in stats.items() if k.startswith('write_')}))


def ids_match_oracle(results, oracle, label: str) -> None:
    """A front's read ids against the oracle's rows: equal, but where two
    ids' scores agree within 1e-6 (two launches may round the re-rank's
    float32 sums differently)."""
    import torch
    s_o, i_o = oracle
    swaps = 0
    for r, (s, i) in enumerate(results):
        diff = torch.nonzero(i != i_o[r])[:, 0]
        for j in diff.tolist():
            where = torch.nonzero(i_o[r] == i[j])[:, 0]
            other = s_o[r, where[0]] if where.numel() else s_o[r, -1]
            if abs(float(other) - float(s[j])) > 1e-6:
                raise AssertionError(f"{label}: read {r} differs from "
                                     "db.query(bucketize=False)")
            swaps += 1
    log(f"  {label}: ids equal db.query(bucketize=False) row by row "
        f"({swaps} swaps within 1e-6)")


def phase_serving(db, queries, n: int, seed: int, device, rank: int) -> None:
    """Both serving fronts on the mutated full-size index (the async one
    with the stream queued before it starts, as the pump drains it, and
    live, serving while one thread submits): the mixed stream
    (read-your-writes) under auto, then a read-only stream under auto and
    per_query against db.query(bucketize=False)."""
    import torch
    for salt, (name, run) in zip((5, 6, 7), FRONTS):
        ops_ = stream_script(db, queries, n, seed, salt, device, rank)
        results, stats, secs, batches = run(db, ops_)
        log_front(f"{name} interleaved_1to8", stats, secs, batches,
                  SERVE_READS)
        check_stream(ops_, results, f"{name} interleaved_1to8")
    host_q = queries.cpu()
    reads = [host_q[i % host_q.shape[0]] for i in range(SERVE_READS)]
    oracle = tuple(x.cpu() for x in db.query(torch.stack(reads).to(device),
                                            k=10, bucketize=False))
    # auto syncs the host inside every batch (its sharing probe), so a
    # batcher cannot run ahead of the card; per_query's path has no sync
    for mode in ("auto", "per_query"):
        db.index.adc_mode = mode
        for name, run in FRONTS:
            results, stats, secs, batches = run(db, [("read", q, None)
                                                     for q in reads])
            log_front(f"{name} read-only {mode}", stats, secs, batches,
                      SERVE_READS)
            ids_match_oracle(results, oracle, f"{name} read-only {mode}")
    db.index.adc_mode = "auto"


def phase_mutation(n: int, seed: int, device, rank: int, rates: dict,
                   min_recall: float, p4_recall: float,
                   snap_root: str) -> tuple:
    """Phase 6: writes on ivf_pq at full size (with metadata), both
    serving fronts on the mutated index, then phase 7 (durability) on that
    index, then writes on flat (float32, bf16) and pq at mid size. Returns
    ({kernel name: {launches, ...}} of phase 6, {kernel name: launches} of
    phase 7) for the kernels line."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import distances as D
    log(f"phase 6: mutation and serving, ivf_pq N={n}, d={DIM}, cosine, m="
        f"{M_SUBSPACES}: insert {n // 100} new rows (batches of "
        f"{MUT_BATCH['insert']}), delete {n // 10} live ids (batches of "
        f"{MUT_BATCH['delete']}), upsert {n // 100} ids (batches of "
        f"{MUT_BATCH['upsert']}), compact")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus, queries = make_dataset(n, max(BATCHES), seed, device, rank)
    db = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES,
                  device=device).load(corpus, meta=seeded_meta(n, seed))
    torch.cuda.synchronize()
    del corpus  # the engine keeps its own normalized copy
    torch.cuda.empty_cache()
    idx = db.index
    log(f"  load {time.perf_counter() - t0:.2f} s (data made on the card and "
        f"ivf_pq trained); the data's copy dropped, device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; {layout_facts(idx)}; "
        f"plan_generation {db.plan_generation}")
    path = {}  # launches of the phase's path: its writes, queries, serving
    counted(path, serve_batches, db, queries, "ivf_pq auto before the writes")
    grid_times(idx, queries, rates["lookups"], "before the writes")
    orig = torch.arange(SELF_QUERIES, device=device)
    baseline = self_found(db, idx._corpus.data[orig], orig,
                          "loaded rows (the baseline)")

    p6_rates = {}
    ins_ids, ins_vecs, ups_ids, ups_vecs, _ = counted(
        path, write_mix, db, n, seed, device, rank, meta=True,
        rates=p6_rates)
    dead = ~idx.layout.live_mask(idx.n)
    log(f"  after the writes: {layout_facts(idx)}; plan_generation "
        f"{db.plan_generation}; device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    for ids, vecs, what in ((ins_ids, ins_vecs, "inserted"),
                            (ups_ids, ups_vecs, "upserted")):
        want = torch.cat([D.preprocess_corpus(vecs[a:a + 1024], "cosine")[0]
                          for a in range(0, vecs.shape[0], 1024)])
        if not torch.equal(idx._corpus.data[ids], want):
            raise AssertionError(f"re-rank rows of the {what} ids differ from "
                                 "preprocess_corpus of the vectors written")
    log("  re-rank rows of the inserted and upserted ids equal "
        "preprocess_corpus of the vectors written, bit for bit")
    for ids, vecs, what in ((ins_ids, ins_vecs, "inserted"),
                            (ups_ids, ups_vecs, "upserted")):
        rows_in_layout(idx, ids, vecs, what)
        rate = self_found(db, vecs[:SELF_QUERIES], ids[:SELF_QUERIES],
                          f"{what} rows")
        if rate < baseline - SELF_MARGIN:
            raise AssertionError(f"{what} rows found in their own top 10 "
                                 f"{rate:.4f}, loaded rows {baseline:.4f}")
    before = counted(path, serve_modes, db, queries, dead, "after the writes")
    kernel_against_plain(idx, queries, "mutated")
    times = grid_times(idx, queries, rates["lookups"], "after the writes")
    truth = live_truth(idx, queries, "after the writes", path)
    recall = recall_at_10(before["per_query"][max(BATCHES)][1], truth)
    log(f"  recall@10 of ivf_pq against the exact top 10 over the live rows: "
        f"{recall:.4f} (phase 4, before any write: {p4_recall:.4f})")
    if recall < min_recall:
        raise AssertionError(f"recall@10 after the writes {recall:.4f} "
                             f"below {min_recall}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = counted(path, db.compact)
    torch.cuda.synchronize()
    log(f"  compact: {time.perf_counter() - t0:.3f} s, {stats}; "
        f"{layout_facts(idx)}; plan_generation {db.plan_generation}")
    after = counted(path, serve_modes, db, queries, dead, "after compact")
    for Q in BATCHES:
        equal_up_to_ties(before["per_query"][Q], after["per_query"][Q],
                         f"per_query Q={Q} after compact against before")
    kernel_against_plain(idx, queries, "compacted")
    grid_times(idx, queries, rates["lookups"], "after compact")
    counted(path, phase_serving, db, queries, n, seed, device, rank)
    counts = path
    log(f"  launches on the phase's path (writes, queries, serving; not the "
        f"comparisons and timings): {counts}")
    out = {}
    for name in ("ivf_adc", "ivf_adc_blocked", "ivf_adc_run_resident",
                 "topk_distance"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the mutated index")
        out[name] = {"launches": counts[name]}
        if name in times:
            out[name].update({f"ms_q{Q}": t[0] for Q, t in times[name].items()})
            out[name].update({f"bound_ms_q{Q}": t[1][0]
                              for Q, t in times[name].items()})
    log(f"  peak device memory in the phase: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (PR 20's run D: "
        f"60.44 GB); in use after the writes and serving "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    holder = [db]  # phase 7 takes the only reference: its crash frees it
    del db, idx, truth, before, after, ins_vecs, ups_vecs, dead
    torch.cuda.empty_cache()
    dur = phase_durability(holder, queries, n, seed, device, rank, snap_root,
                           p6_rates)
    del queries
    torch.cuda.empty_cache()
    mid = mutation_mid(seed, device, rank)
    for name, c in mid.items():
        out.setdefault(name, {"launches": 0})
        out[name]["mid_launches"] = c
    return out, dur


def mutation_mid(seed: int, device, rank: int) -> dict:
    """flat (float32, bf16) and pq at MID_ROWS under the same write mix,
    scaled: kernel path against plain path on the mutated buffers, and the
    float32 flat against brute force over the live rows. Returns the
    kernels' launches."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import distances as D
    corpus, queries = make_dataset(MID_ROWS, 512, seed + 1, device, rank)
    q32 = queries[:32]
    launches = {}
    for engine, kw in (("flat", {}), ("flat", {"dtype": torch.bfloat16}),
                       ("pq", {"m": M_SUBSPACES})):
        label = f"{engine}{' bf16' if kw.get('dtype') else ''} N={MID_ROWS} "
        db = VectorDB(engine, metric="cosine", device=device, **kw).load(corpus)
        ins_ids, ins_vecs, ups_ids, ups_vecs, dead_ids = counted(
            launches, write_mix, db, MID_ROWS, seed + 1, device, rank, label)
        counted(launches, db.compact)
        s, i = counted(launches, db.query, queries, k=10)
        idx = db.index
        idx._sync()
        no_dead_ids(i, ~idx.valid, f"{label}after the writes")
        if engine == "flat":
            qd = D.l2_normalize(q32.to(idx.corpus.dtype))
            compare_topk(idx.corpus, qd, "dot", 10, f"{label}mutated kernel "
                         "against plain Q=32", valid=idx.valid)
            if not kw:
                brute_force(corpus, queries, ins_vecs, ups_ids, ups_vecs,
                            dead_ids, (s, i), label)
        else:
            codes, luts, valid = pq_inputs(idx, q32)
            compare_pq(codes, luts, k=32, lut_dtype="float32", valid=valid,
                       label=f"{label}mutated pq_adc Q=32")
        del db, idx
        torch.cuda.empty_cache()
    for name in ("topk_distance", "pq_adc"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched at mid size")
    del corpus, queries
    torch.cuda.empty_cache()
    return {name: launches[name] for name in ("topk_distance", "pq_adc")}


def brute_force(corpus, queries, ins_vecs, ups_ids, ups_vecs, dead_ids,
                got, label: str) -> None:
    """The float32 flat engine's answer against brute force over the live
    rows, built apart from the engine: the loaded rows, the inserted ones
    appended, the upserted ones replaced, the deleted ones masked."""
    import torch
    from repro_torch.core import distances as D
    rows = D.l2_normalize(torch.cat([corpus, ins_vecs]))
    rows[ups_ids] = D.l2_normalize(ups_vecs)
    live = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    live[dead_ids] = False
    live[ups_ids] = True
    q = D.l2_normalize(queries)
    exact = (q.double() @ rows.double().T).masked_fill(~live[None], -math.inf)
    order = torch.sort(exact, dim=1, descending=True, stable=True)
    ref_s, ref_i = order.values[:, :10], order.indices[:, :10]
    s, i = got
    tol = topk_tolerance(rows, q, False)[:, None]
    if not bool(((s.double() - ref_s).abs() <= tol).all()):
        raise AssertionError(f"{label}scores differ from brute force beyond "
                             "compare_topk's bound")
    diff = i.long() != ref_i
    rows_, cols = torch.nonzero(diff, as_tuple=True)
    gap = (exact[rows_, i[rows_, cols].long()] - ref_s[rows_, cols]).abs()
    if not bool((gap <= 2 * tol[rows_, 0]).all()):
        raise AssertionError(f"{label}ids differ from brute force beyond "
                             "near-ties")
    log(f"  {label}against brute force over the live rows (float64): ids "
        f"agree {float((~diff).float().mean()):.4f} (bound: all but "
        f"near-ties), max |dscore| {float((s.double() - ref_s).abs().max()):.3e}")


# ------------------------------------- phase 4: filtered and hybrid search
FILTER_REPS = {1: 5, 32: 4, 512: 2}
CATS8 = tuple(f"c{i}" for i in range(8))
GATED_BUCKETS = ("<=50%", ">50%", "all")  # recall gated above 10 %


def seeded_meta(n: int, seed: int, salt: int = 0) -> dict:
    """Metadata of n rows, made from ``seed`` with numpy: a categorical
    column of 8 values (``cat``), an integer column for ranges (``year``,
    uniform over 0..127) and a boolean one (``flag``, true 70 % of the
    time)."""
    import numpy as np
    rng = np.random.default_rng(seed * 1000 + 21 + salt)
    return {"year": rng.integers(0, 128, n),
            "cat": np.asarray(CATS8)[rng.integers(0, 8, n)],
            "flag": rng.random(n) < 0.7}


def meta_slice(meta, a: int, b: int):
    return None if meta is None else {k: v[a:b] for k, v in meta.items()}


def predicates() -> list:
    """One predicate in each of the reference's selectivity buckets (by
    the columns' distributions: 0.8 %, 9.4 %, 37.5 % and 61.3 % of the
    rows), and one that allows every row."""
    from repro_torch.search import And, Eq, In, Not, Range
    return [("<=1%", Eq("year", 5)), ("<=10%", Range("year", hi=11)),
            ("<=50%", In("cat", ["c0", "c1", "c2"])),
            (">50%", And(Eq("flag", True), Not(Eq("cat", "c7")))),
            ("all", Range("year", lo=0))]


def bitmaps(db, device) -> dict:
    """Each predicate's bitmap as a filtered query builds it (host numpy
    over the id space, ``metastore.mask``) and its upload to the card,
    timed apart from any query (host clock; the upload ends in a
    synchronize): {label: (predicate, bitmap on the card)}."""
    import torch
    out = {}
    n_ids = int(getattr(db.index, "next_id", db.n) or db.n)
    for label, pred in predicates():
        t0 = time.perf_counter()
        host = db.metastore.mask(pred, n_ids)
        t1 = time.perf_counter()
        dev = torch.as_tensor(host, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[label] = (pred, dev)
        log(f"  bitmap {label} {pred!r}: selectivity {float(host.mean()):.4f},"
            f" host build {(t1 - t0) * 1e3:.3f} ms, upload "
            f"{(t2 - t1) * 1e3:.3f} ms ({host.nbytes / 1e6:.1f} MB)")
    return out


def serve_filtered(db, queries, label: str, maps: dict, unfiltered: dict,
                   batches=BATCHES):
    """Every predicate at each Q of ``batches`` (k = 10), one batch repeated
    FILTER_REPS times: p50/p99 of ``db.query(where=...)`` on the host clock
    ending in a synchronize (the query builds its bitmap on the host and
    uploads it each call). Fails on an id outside the bitmap, and unless
    the all-true predicate's answer equals ``unfiltered`` ({Q: result})
    bit for bit. Returns {label: {Q: (scores, ids)}}."""
    import torch
    out = {}
    for name, (pred, allowed) in maps.items():
        out[name], parts = {}, []
        for Q in batches:
            q = queries[:Q]
            db.query(q, k=10, where=pred)
            torch.cuda.synchronize()
            times = []
            for _ in range(FILTER_REPS[Q]):
                t0 = time.perf_counter()
                s, i = db.query(q, k=10, where=pred)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[name][Q] = (s, i)
            if s.shape != (Q, 10) or not bool(torch.isfinite(s[:, 0]).all()):
                raise AssertionError(f"{label} {name} Q={Q}: bad result")
            got = i[i >= 0].long()
            if not bool(allowed[got].all()):
                raise AssertionError(f"{label} {name} Q={Q}: an id outside "
                                     "the bitmap")
            if name == "all" and not same_result((s, i), unfiltered[Q]):
                raise AssertionError(f"{label} all-true Q={Q}: differs from "
                                     "the unfiltered answer")
            parts.append(f"Q={Q} p50 {percentile(times, 50) * 1e3:.3f} / p99 "
                         f"{percentile(times, 99) * 1e3:.3f} ms")
        log(f"  {label} where {name}: " + ", ".join(parts)
            + f" (n={FILTER_REPS}); ids inside the bitmap")
    log(f"  {label}: the all-true predicate equals the unfiltered answer bit "
        f"for bit at Q = {batches}; filter_stats {db.filter_stats}")
    return out


def filtered_recalls(res: dict, truth: dict, label: str,
                     gate=None) -> dict:
    """recall@10 at Q = 512 of each predicate's answer against the
    filtered flat's; with ``gate``, fails below it in GATED_BUCKETS."""
    out = {name: recall_at_10(res[name][max(BATCHES)][1], truth[name])
           for name in res}
    log(f"  {label} filtered recall@10 against filtered flat: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
        + (f" (gated at {gate} in {GATED_BUCKETS})" if gate is not None
           else " (printed, not gated)"))
    if gate is not None:
        for name in GATED_BUCKETS:
            if out[name] < gate:
                raise AssertionError(f"{label} filtered recall@10 {name} "
                                     f"{out[name]:.4f} below {gate}")
    return out


def brute_filtered(corpus, q, allowed, got, label: str,
                   chunk: int = 1 << 19) -> None:
    """A filtered flat answer against brute force: float64 scores of every
    allowed row, a chunk of rows at a time, the exact top 10 (equal scores
    to the lower id); scores within compare_topk's bound, ids equal but
    for near-ties."""
    import torch
    rows = torch.nonzero(allowed)[:, 0]
    qd = q.double()
    best_s = best_i = None
    for a in range(0, rows.numel(), chunk):
        r = rows[a:a + chunk]
        sc = qd @ corpus[r].double().T
        if best_s is not None:
            sc = torch.cat([best_s, sc], dim=1)
            r_all = torch.cat([best_i, r[None].expand(q.shape[0], -1)], dim=1)
        else:
            r_all = r[None].expand(q.shape[0], -1)
        s, pos = torch.sort(sc, dim=1, descending=True, stable=True)
        best_s, best_i = s[:, :10], torch.gather(r_all, 1, pos[:, :10])
    s, i = got
    tol = topk_tolerance(corpus, q, False)[:, None]
    if not bool(((s.double() - best_s).abs() <= tol).all()):
        raise AssertionError(f"{label}: scores differ from brute force beyond "
                             "compare_topk's bound")
    diff = i.long() != best_i
    rr, cc = torch.nonzero(diff, as_tuple=True)
    exact = (qd[rr] * corpus[i[rr, cc].long()].double()).sum(1)
    if not bool(((exact - best_s[rr, cc]).abs() <= 2 * tol[rr, 0]).all()):
        raise AssertionError(f"{label}: ids differ from brute force beyond "
                             "near-ties")
    log(f"  {label}: against brute force over the allowed rows (float64): "
        f"ids agree {float((~diff).float().mean()):.4f}, max |dscore| "
        f"{float((s.double() - best_s).abs().max()):.3e}")


# ------------------------------------------ phase 7: durability at full size
SNAP_FACTOR = 1.2        # free space needed over the snapshot's bytes
DUR_BATCHES = {"insert": (16, 1024), "delete": (2, 8192), "upsert": (4, 1024)}


def fs_facts(path: str) -> tuple:
    """(free bytes, filesystem type, mount point) of ``path``; the type from
    /proc/mounts, the longest mount point that holds the path."""
    import os
    st = os.statvfs(path)
    real = os.path.realpath(path)
    best = ("?", "")
    try:
        with open("/proc/mounts") as fh:
            lines = fh.readlines()
    except OSError:  # no mount table: the type stays unknown
        lines = []
    for line in lines:
        parts = line.split()
        if len(parts) < 3:
            continue
        mnt = parts[1]
        inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
        if inside and len(mnt) >= len(best[1]):
            best = (parts[2], mnt)
    return st.f_bavail * st.f_frsize, best[0], best[1]


def mem_total_bytes() -> int:
    """The host's MemTotal (0 where /proc/meminfo cannot be read)."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def snapshot_bytes(db) -> int:
    """Bytes the snapshot of ``db`` holds: its state's tensors and the
    metadata leaves."""
    import torch
    total = sum(v.numel() * v.element_size()
                for v in db.index.state_dict().values()
                if isinstance(v, torch.Tensor))
    return total + sum(a.nbytes for a in db.metastore.state_leaves().values())


def dir_bytes(path: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def same_answers(got, want, label: str) -> int:
    """A restored engine's answer against the pre-crash one (on the host):
    bit for bit, but that ids may swap where the scores at those ranks tie
    exactly (a near tie); any other difference is a real one and fails.
    Returns the near-tie swaps."""
    import torch
    (s0, i0), (s1, i1) = (x.cpu() for x in want), (x.cpu() for x in got)
    same_s = (s0 == s1) | (torch.isneginf(s0) & torch.isneginf(s1))
    diff = i0 != i1
    if not bool(same_s.all()):
        raise AssertionError(f"{label}: real difference (scores differ at "
                             f"{int((~same_s).sum())} ranks)")
    tie = torch.zeros_like(diff)
    tie[:, 1:] |= s0[:, 1:] == s0[:, :-1]
    tie[:, :-1] |= s0[:, :-1] == s0[:, 1:]
    if bool((diff & ~tie).any()):
        raise AssertionError(f"{label}: real difference (ids differ outside "
                             "ties)")
    return int(diff.sum())


def phase_durability(holder: list, queries, n: int, seed: int, device,
                     rank: int, snap_root: str, p6_rates: dict) -> dict:
    """Phase 7: durability on phase 6's index (``holder`` hands over the
    only reference to it): snapshot, a logged write mix, a simulated crash
    and a durable restore that must serve the pre-crash answers, group
    commit through the async front, and snapshots of flat, pq and lsh at
    MID_ROWS. Returns the launches of its path."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch import VectorDB
    t_phase = time.perf_counter()
    db = holder.pop()
    torch.cuda.reset_peak_memory_stats()
    free, fstype, mnt = fs_facts(snap_root)
    need = snapshot_bytes(db)
    log(f"phase 7: durability, ivf_pq N={db.n} live rows ({db.index.n} ids), "
        f"snapshot directory {snap_root} on {mnt} ({fstype}), free "
        f"{free / 1e9:.2f} GB, the snapshot {need / 1e9:.2f} GB, host "
        f"MemTotal {mem_total_bytes() / 1e9:.2f} GB")
    if fstype in ("tmpfs", "ramfs"):
        log("  the snapshot directory is in memory: its fsync numbers are "
            "not a disk's")
    if free < SNAP_FACTOR * need:
        log(f"  CUT: free space below {SNAP_FACTOR} x the snapshot: phase 7 "
            f"runs on an ivf_pq of {MID_ROWS} rows")
        del db
        gc.collect()
        torch.cuda.empty_cache()
        n = MID_ROWS
        corpus, queries = make_dataset(n, max(BATCHES), seed, device, rank)
        db = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES,
                      device=device).load(corpus, meta=seeded_meta(n, seed))
        del corpus
    path = {}
    work = tempfile.mkdtemp(prefix="thistle_snapshot_", dir=snap_root)
    box = [db]  # dur_core takes the only reference: its crash frees it
    del db
    try:
        dur_core(box, queries, n, seed, device, rank, work, p6_rates, path)
        dur_mid(seed, device, rank, work, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  launches on the phase's path (restored queries, serving, "
        f"restored mid-size engines): {path}")
    for name in ("ivf_adc", "topk_distance", "pq_adc", "hamming"):
        if path.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched in phase 7")
    log(f"  peak device memory in phase 7: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (PR 20's phase "
        f"6: 60.44 GB)")
    log(f"[phase 7: {time.perf_counter() - t_phase:.1f} s]")
    return path


def dur_core(box, queries, n, seed, device, rank, work, p6_rates, path):
    """Phase 7, steps 2-6, on the full-size (or cut) ivf_pq, handed over
    as the only element of ``box``."""
    import gc
    import os
    import torch
    from repro_torch import VectorDB
    from repro_torch.serve import AsyncQueryEngine
    db = box.pop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.save_index(work, step=1, durable=True)
    secs = time.perf_counter() - t0
    nbytes = dir_bytes(os.path.join(work, "step_00000001"))
    log(f"  save_index(step=1, durable=True): {secs:.2f} s, {nbytes / 1e9:.3f} "
        f"GB, {nbytes / secs / 1e9:.3f} GB/s (device to host a chunk at a "
        f"time, each file fsync'd)")
    at_snap = dict(db.mutation_stats)

    idx = db.index
    n_ins = DUR_BATCHES["insert"][0] * DUR_BATCHES["insert"][1]
    n_del = DUR_BATCHES["delete"][0] * DUR_BATCHES["delete"][1]
    n_ups = DUR_BATCHES["upsert"][0] * DUR_BATCHES["upsert"][1]
    ins = new_rows(n_ins, n, seed, 11, device, rank)
    ups = new_rows(n_ups, n, seed, 12, device, rank)
    live = torch.nonzero(idx.layout.live_mask(idx.n))[:, 0]
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    pick = live[torch.randperm(live.numel(), generator=gen,
                               device=device)[:n_del + n_ups]]
    rates = {}
    apply_writes(db, "insert", n_ins, DUR_BATCHES["insert"][1], vectors=ins,
                 meta=seeded_meta(n_ins, seed, 11), label="logged ",
                 rates=rates)
    apply_writes(db, "delete", n_del, DUR_BATCHES["delete"][1],
                 ids=pick[:n_del], label="logged ", rates=rates)
    apply_writes(db, "upsert", n_ups, DUR_BATCHES["upsert"][1], vectors=ups,
                 ids=pick[n_del:], meta=seeded_meta(n_ups, seed, 12),
                 label="logged ", rates=rates)
    t0 = time.perf_counter()
    db.compact()
    torch.cuda.synchronize()
    ws = db.wal_stats
    log(f"  logged compact {time.perf_counter() - t0:.3f} s; rows/s with "
        f"an fsync a record against phase 6 without a log: "
        + ", ".join(f"{k} {rates[k]:.1f} against {p6_rates.get(k, 0):.1f}"
                    for k in rates)
        + f"; WAL {ws['records']} records, {ws['bytes']} bytes, "
        f"{ws['fsyncs']} fsyncs")

    want = {}
    for mode in ("per_query", "auto"):
        idx.adc_mode = mode
        for Q in BATCHES:
            s, i = db.query(queries[:Q], k=10)
            want[(mode, Q)] = (s.cpu(), i.cpu())
    idx.adc_mode = "auto"
    fpred = predicates()[1][1]
    want["filtered"] = tuple(x.cpu() for x in db.query(queries[:32], k=10,
                                                       where=fpred))
    lay = idx.layout
    live = lay.live_mask(idx.n)
    facts = {"size": idx.size, "generation": db.generation,
             "stats": {k: v - at_snap[k] for k, v in db.mutation_stats.items()},
             "ids": torch.nonzero(live)[:, 0].cpu(),
             "clusters": lay.assign_of(idx.n)[live].cpu(),
             "codes": lay.gather_payload(idx.n)[live].cpu()}
    log(f"  copied to the host: answers at Q = {BATCHES} under per_query and "
        f"auto, a filtered batch, size {facts['size']}, generation "
        f"{facts['generation']}, writes since the snapshot {facts['stats']}, "
        f"{facts['ids'].numel()} live ids with their clusters and codes")
    import weakref
    engine_ref = weakref.ref(idx)
    db.wal._f.close()  # the crash: no sync, no save, no close
    del db, idx, lay, live
    gc.collect()
    torch.cuda.empty_cache()
    if engine_ref() is not None:
        raise AssertionError("the engine outlived the crash: a reference to "
                             "it is still held")
    log(f"  crash: the db dropped without a save; device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = VectorDB("ivf_pq", metric="cosine", m=M_SUBSPACES,
                    device=device).restore_index(work, durable=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rs = back.restore_stats
    log(f"  restore_index(durable=True): {secs:.2f} s = read {rs['read_s']:.2f}"
        f" s + upload {rs['upload_s']:.2f} s + engine rebuild "
        f"{rs['load_s'] - rs['read_s'] - rs['upload_s']:.2f} s + replay "
        f"{rs['replay_s']:.2f} s of {rs['replayed']} records; "
        f"{rs['bytes'] / 1e9:.3f} GB read, "
        f"{rs['bytes'] / max(rs['read_s'], 1e-9) / 1e9:.3f} GB/s")
    idx = back.index
    lay = idx.layout
    live = lay.live_mask(idx.n)
    got = {"size": idx.size, "generation": back.generation,
           "stats": dict(back.mutation_stats),
           "ids": torch.nonzero(live)[:, 0].cpu(),
           "clusters": lay.assign_of(idx.n)[live].cpu(),
           "codes": lay.gather_payload(idx.n)[live].cpu()}
    for key in ("size", "generation", "stats"):
        if got[key] != facts[key]:
            raise AssertionError(f"restored {key} {got[key]}, before the "
                                 f"crash {facts[key]}")
    for key in ("ids", "clusters", "codes"):
        if not torch.equal(got[key], facts[key]):
            raise AssertionError(f"restored live {key} differ from the "
                                 "pre-crash ones")
    log("  restored size, generation, writes since the snapshot, live ids "
        "and each live id's cluster and codes equal the pre-crash ones")
    swaps = 0
    for mode in ("per_query", "auto"):
        idx.adc_mode = mode
        for Q in BATCHES:
            swaps += same_answers(counted(path, back.query, queries[:Q],
                                          k=10),
                                  want[(mode, Q)], f"restored {mode} Q={Q}")
    idx.adc_mode = "auto"
    swaps += same_answers(counted(path, back.query, queries[:32], k=10,
                                  where=fpred),
                          want["filtered"], "restored filtered Q=32")
    log(f"  restored answers at Q = {BATCHES} under per_query and auto, and "
        f"the filtered batch: equal to the pre-crash ones bit for bit "
        f"({swaps} id swaps between exactly tied scores; no real "
        "difference)")

    ops_ = stream_script(back, queries, n, seed, 8, device, rank)
    base = back.wal.last_lsn
    acks = []

    def serve():
        """The stream queued through the async front with group commit;
        each write's future records, as it resolves, its record's lsn and
        the log's synced_lsn."""
        eng = AsyncQueryEngine(back, max_batch=SERVE_BATCH, max_wait_ms=2.0,
                               max_queue=4096, start=False,
                               fsync_interval_ms=2.0)
        with eng:
            t0 = time.perf_counter()
            futs, j = [], 0
            for op in ops_:
                if op[0] == "read":
                    futs.append(eng.submit(op[1], 10))
                    continue
                j += 1
                f = eng.submit_write(op[1], op[2], op[3])
                f.add_done_callback(lambda _f, lsn=base + j: acks.append(
                    (lsn, back.wal.synced_lsn)))
                futs.append(f)
            eng.start()
            results = [f.result(timeout=600) for f in futs]
            secs = time.perf_counter() - t0
        return results, eng.latency_stats(), secs, j

    plans = sum(back.plan_stats.values())
    results, stats, secs, j = counted(path, serve)
    if len(acks) != j or any(synced < lsn for lsn, synced in acks):
        raise AssertionError("a write resolved before the fsync that covers "
                             "its record")
    log_front("AsyncQueryEngine fsync_interval_ms=2 on the restored index "
              "interleaved_1to8", stats, secs,
              sum(back.plan_stats.values()) - plans, SERVE_READS)
    log(f"  group commit: wal_records {stats['wal_records']}, wal_fsyncs "
        f"{stats['wal_fsyncs']}, durable_pending {stats['durable_pending']}; "
        f"every one of the {j} writes resolved after synced_lsn reached its "
        f"record")
    check_stream(ops_, results, "restored interleaved_1to8 (group commit)")
    write_burst(back, n, seed, device, rank, path)
    back.wal.close()


BURST_WRITES, BURST_ROWS = 64, 64


def write_burst(db, n, seed, device, rank, path) -> None:
    """Group commit where writes come closer than its window: BURST_WRITES
    inserts of BURST_ROWS rows queued at once through the async front at
    ``fsync_interval_ms = 2``; each resolves only once synced_lsn reached
    its record. Prints the records against the fsyncs."""
    from repro_torch.serve import AsyncQueryEngine
    rows = new_rows(BURST_WRITES * BURST_ROWS, n, seed, 9, device, rank).cpu()
    base, acks = db.wal.last_lsn, []
    before = dict(db.wal_stats)

    def burst():
        eng = AsyncQueryEngine(db, max_queue=4096, start=False,
                               fsync_interval_ms=2.0)
        with eng:
            t0 = time.perf_counter()
            for j in range(BURST_WRITES):
                f = eng.submit_write("insert",
                                     rows[j * BURST_ROWS:(j + 1) * BURST_ROWS])
                f.add_done_callback(lambda _f, lsn=base + j + 1: acks.append(
                    (lsn, db.wal.synced_lsn)))
            eng.start()
            eng.drain(timeout=600)
            return time.perf_counter() - t0

    secs = counted(path, burst)
    after = db.wal_stats
    if len(acks) != BURST_WRITES or any(s < lsn for lsn, s in acks):
        raise AssertionError("a burst write resolved before the fsync that "
                             "covers its record")
    log(f"  write burst ({BURST_WRITES} inserts of {BURST_ROWS} rows queued "
        f"at once, fsync_interval_ms=2): {secs:.3f} s, "
        f"{after['records'] - before['records']} records, "
        f"{after['fsyncs'] - before['fsyncs']} fsyncs; every ack after its "
        f"record's fsync")


def dur_mid(seed: int, device, rank: int, work: str, path: dict) -> None:
    """Phase 7, step 7: flat (float32, bf16), pq and lsh at MID_ROWS save
    and restore, and the restored engines serve the saved ones' answers
    bit for bit (and filtered ones, but lsh, which refuses filters)."""
    import os
    import torch
    from repro_torch import VectorDB
    corpus, queries = make_dataset(MID_ROWS, 512, seed + 2, device, rank)
    meta = seeded_meta(MID_ROWS, seed, 3)
    q = queries[:32]
    fpred = predicates()[2][1]
    for engine, kw in (("flat", {}), ("flat", {"dtype": torch.bfloat16}),
                       ("pq", {"m": M_SUBSPACES}), ("lsh", {})):
        label = f"{engine}{' bf16' if kw.get('dtype') else ''} N={MID_ROWS}"
        db = VectorDB(engine, metric="cosine", device=device, **kw).load(
            corpus, meta=meta)
        d = os.path.join(work, label.replace(" ", "_").replace("=", ""))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db.save_index(d, 0)
        t1 = time.perf_counter()
        back = VectorDB(engine, metric="cosine", device=device,
                        **kw).restore_index(d)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want = db.query(q, k=10)
        got = counted(path, back.query, q, k=10)
        if not same_result(got, want):
            raise AssertionError(f"{label}: the restored engine's answer "
                                 "differs")
        if engine != "lsh":
            if not same_result(counted(path, back.query, q, k=10,
                                       where=fpred),
                               db.query(q, k=10, where=fpred)):
                raise AssertionError(f"{label}: the restored filtered answer "
                                     "differs")
        log(f"  {label}: save {t1 - t0:.3f} s, restore {t2 - t1:.3f} s "
            f"({dir_bytes(d) / 1e9:.3f} GB); restored answers equal bit for "
            f"bit{'' if engine == 'lsh' else ', filtered ones too'}")
        del db, back
        torch.cuda.empty_cache()
    del corpus, queries
    torch.cuda.empty_cache()


# ------------------------------------ phase 8: the remaining engines
P8_WRITES = {"insert": (8, 1024), "delete": (1, 8192), "upsert": (1, 1024)}
P8_SELF = 4096           # loaded and inserted rows sent back as queries (all
                         # 1,024 upserted rows go back too)
P8_SELF_FLOOR = 0.99     # ivf scores exactly and probes each row's own
                         # cluster first: loaded rows find themselves at
                         # this rate or above, and the margin rests on it
P8_SELF_MARGIN = 0.02    # written rows found at least as often as loaded
                         # ones less this: at a rate of 0.99, 5 standard
                         # deviations of the difference of two rates over
                         # 4,096 and 1,024 rows (the upserted rows) are
                         # 5 * sqrt(0.99 * 0.01 * (1/4096 + 1/1024)) = 0.0174,
                         # and over 4,096 a side 0.0110
P8_BRUTE = 8             # queries held against a float64 brute force
P8_FILTER_Q = (32,)      # the filtered batches' size
GRAPH_MID = 262_144      # rows of the graph build's kernel-against-plain


def p8_engine_facts(db, label: str, t_load: float, before: int) -> None:
    import torch
    torch.cuda.synchronize()
    log(f"  {label} load {t_load:.2f} s; the engine holds "
        f"{db.index.memory_bytes() / 1e9:.3f} GB on the card "
        f"(memory_bytes); in use {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB ({(torch.cuda.memory_allocated() - before) / 1e9:.2f} GB more "
        f"than before the load), peak so far "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def p8_recalls(res: dict, truth: dict, label: str, gate=None) -> dict:
    """recall@10 at each Q against the float32 flat truth; with ``gate``,
    fails below it at Q = 512 (the smaller batches are its first rows:
    one query is no estimate)."""
    out = {Q: recall_at_10(res[Q][1], truth[Q]) for Q in BATCHES}
    top = max(BATCHES)
    log(f"  {label} recall@10 against float32 flat: "
        + ", ".join(f"Q={Q} {r:.4f}" for Q, r in out.items())
        + (f" (gated at {gate} at Q={top})" if gate is not None else
           " (printed, not gated)"))
    if gate is not None and out[top] < gate:
        raise AssertionError(f"{label} recall@10 {out[top]:.4f} below {gate}")
    return out


def near_ties_only(exact, want, tol, label: str) -> None:
    """Where an engine's id differs from a reference answer's at a rank,
    the engine's row must score (exactly, float64) within 2 tol of the
    reference's score at that rank."""
    if not bool(((exact - want).abs() <= 2 * tol + 1e-12).all()):
        raise AssertionError(f"{label}: ids differ beyond near-ties")


def ivf_brute(idx, q, got, label: str) -> None:
    """ivf's answers against a float64 brute force over the buckets the
    engine probes (the probe recomputed as the engine computes it): scores
    within compare_topk's bound, ids equal but for near-ties."""
    import torch
    from repro_torch.core import distances as D
    qn = D.l2_normalize(q.float())
    probe = D.topk_scores(D.pairwise_scores(qn, idx.centroids, "dot"),
                          idx.nprobe)[1]
    s_got, i_got = got
    tol = topk_tolerance(idx.corpus, qn, False)
    agree = 0
    for r in range(q.shape[0]):
        ids = idx.buckets[probe[r]].reshape(-1)
        ids = ids[ids >= 0].long()
        sc = idx.corpus[ids].double() @ qn[r].double()
        s, pos = torch.sort(sc, descending=True, stable=True)
        s, want = s[:10], ids[pos[:10]]
        if not bool(((s_got[r].double() - s).abs() <= tol[r]).all()):
            raise AssertionError(f"{label} row {r}: scores differ from the "
                                 "float64 brute force beyond the bound")
        diff = i_got[r].long() != want
        exact = idx.corpus[i_got[r][diff].long()].double() @ qn[r].double()
        near_ties_only(exact, s[diff], float(tol[r]), f"{label} row {r}")
        agree += int((~diff).sum())
    log(f"  {label}: {q.shape[0]} queries against a float64 brute force over "
        f"the probed buckets: ids agree {agree / (10 * q.shape[0]):.4f} (the "
        f"rest near-ties), scores within {float(tol.max()):.3e}")


def ivf_rows_in_buckets(idx, ids, vecs, what: str) -> None:
    """Every written id sits in one slot of the bucket row of the cluster
    its row is assigned to (the engine's encode, in its write batches)."""
    import torch
    pos = idx._pos[ids.long()]
    if not bool((pos >= 0).all()):
        raise AssertionError(f"a {what} id is missing from the buckets")
    assign = torch.cat([idx._encode_batch(vecs[a:a + 1024])[2]
                        for a in range(0, vecs.shape[0], 1024)])
    if not (torch.equal(idx.buckets.view(-1)[pos].long(), ids.long())
            and torch.equal(torch.div(pos, idx.cap, rounding_mode="floor"),
                            assign)):
        raise AssertionError(f"a {what} id sits outside its cluster's "
                             "bucket row")
    log(f"  all {ids.numel()} {what} ids sit in their assigned cluster's "
        "bucket row")


def p8_ivf(box, queries, truth, meta, n, seed, device, rank, min_recall,
           launches) -> dict:
    """ivf: load (the data's copy dropped after), serve, recall (gated),
    the float64 brute force over probed buckets, filtered batches, then
    the writes (rows/s; ids in their clusters' buckets; no deleted id
    back; written rows found as often as loaded ones), then compact."""
    import torch
    from repro_torch import VectorDB
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    db = VectorDB("ivf", metric="cosine", device=device).load(box.pop(),
                                                            meta=meta)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    torch.cuda.empty_cache()  # the data's copy went with the box
    idx = db.index
    fill = idx._fill
    log(f"  ivf: C = {idx.centroids.shape[0]}, nprobe {idx.nprobe}, bucket "
        f"capacity {idx.cap} (fills: max {int(fill.max())}, mean "
        f"{float(fill.float().mean()):.1f}, min {int(fill.min())}; the "
        f"table {idx.buckets.numel() * 4 / 1e6:.1f} MB)")
    p8_engine_facts(db, "ivf", t_load, before)
    res, counts = serve_and_count(db, queries, "ivf")
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c
    out = {"load_s": t_load, "recall": p8_recalls(res, truth, "ivf",
                                                  min_recall)}
    ivf_brute(idx, queries[:P8_BRUTE], tuple(x[:P8_BRUTE] for x in res[32]),
              "ivf")
    maps = bitmaps(db, device)
    serve_filtered(db, queries, "ivf", maps, res, batches=P8_FILTER_Q)

    rates = {}
    n_ins = P8_WRITES["insert"][0] * P8_WRITES["insert"][1]
    ins_vecs = new_rows(n_ins, n, seed, 11, device, rank)
    ins_ids = torch.cat(apply_writes(db, "insert", n_ins,
                                     P8_WRITES["insert"][1], vectors=ins_vecs,
                                     label="ivf ", rates=rates))
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    perm = torch.randperm(n, generator=gen, device=device)
    n_del, n_ups = P8_WRITES["delete"][1], P8_WRITES["upsert"][1]
    dead, ups_ids = perm[:n_del], perm[n_del:n_del + n_ups]
    kept = perm[n_del + n_ups:n_del + n_ups + P8_SELF]
    deleted = sum(apply_writes(db, "delete", n_del, n_del, ids=dead,
                               label="ivf ", rates=rates))
    if deleted != n_del:
        raise AssertionError(f"ivf deleted {deleted} of {n_del} live ids")
    ups_vecs = new_rows(n_ups, n, seed, 12, device, rank)
    apply_writes(db, "upsert", n_ups, n_ups, vectors=ups_vecs, ids=ups_ids,
                 label="ivf ", rates=rates)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = db.compact()
    torch.cuda.synchronize()
    log(f"  ivf compact: {time.perf_counter() - t0:.3f} s, {stats}; bucket "
        f"capacity {idx.cap}, corpus rows {idx._corpus.capacity}")
    if db.n != n + n_ins - n_del or idx.size != db.n:
        raise AssertionError(f"ivf size {idx.size} after the writes, "
                             f"expected {n + n_ins - n_del}")
    for ids, vecs, what in ((ins_ids, ins_vecs, "inserted"),
                            (ups_ids, ups_vecs, "upserted")):
        ivf_rows_in_buckets(idx, ids, vecs, what)
    dead_mask = torch.zeros(idx.next_id, dtype=torch.bool, device=device)
    dead_mask[dead] = True
    base = self_found(db, idx.corpus[kept], kept, "ivf loaded rows (the "
                      "baseline)")
    if base < P8_SELF_FLOOR:
        raise AssertionError(f"ivf loaded rows found in their own top 10 "
                             f"{base:.4f} < {P8_SELF_FLOOR}")
    for ids, vecs, what in ((ins_ids, ins_vecs, "inserted"),
                            (ups_ids, ups_vecs, "upserted")):
        rate = self_found(db, vecs[:P8_SELF], ids[:P8_SELF],
                          f"ivf {what} rows")
        if rate < base - P8_SELF_MARGIN:
            raise AssertionError(f"ivf {what} rows found in their own top 10 "
                                 f"{rate:.4f}, loaded rows {base:.4f}")
    after = serve_batches(db, queries, "ivf after the writes and compact")
    for Q in BATCHES:
        no_dead_ids(after[Q][1], dead_mask, f"ivf after the writes Q={Q}")
    log("  ivf: no deleted id in any answer after the writes")
    out.update(rates=rates, self_found=base)
    log(f"  peak device memory in ivf: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


def int8_norm_max(codes, scales, chunk: int = 1 << 20) -> float:
    """The largest norm of the dequantized rows, a chunk at a time."""
    import torch
    from repro_torch.core.quant import dequantize_rows
    return max(float(torch.linalg.vector_norm(
        dequantize_rows(codes[a:a + chunk], scales[a:a + chunk]), dim=1).max())
        for a in range(0, codes.shape[0], chunk))


def int8_checks(idx, queries, got) -> dict:
    """int8's kernel path against its plain path at full size, Q = 32
    (scores within topk_tolerance, ids but for near-ties), its answers
    for P8_BRUTE queries against a float64 brute force of (q . c_q) *
    scale (within twice the bound: the port scales the rows before the
    product), and the two paths' times with the scan's split."""
    import torch
    from repro_torch.core import distances as D
    from repro_torch.core.quant import dequantize_rows, scan_rows
    from repro_torch.kernels import ops
    q = queries[:32]
    qn = D.l2_normalize(q.float())
    c_max = int8_norm_max(idx.codes, idx.scales)
    tol = (2 * DIM * 2.0 ** -24 * torch.linalg.vector_norm(qn, dim=1)
           * c_max)[:, None]
    ks, ki = idx.query(q, k=10, use_kernel=True)
    ps, pi = idx.query(q, k=10, use_kernel=False)
    torch.cuda.synchronize()
    err = (ks - ps).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"int8 kernel path: score error "
                             f"{float(err.max())} above {float(tol.max())}")
    diff = ki != pi
    r, c = torch.nonzero(diff, as_tuple=True)
    i = ki[r, c].long()
    rows = dequantize_rows(idx.codes[i], idx.scales[i]).double()
    near_ties_only((rows * qn[r].double()).sum(1), ps[r, c].double(),
                   tol[r, 0].double(), "int8 kernel path against plain")
    log(f"  int8 kernel path against its plain path, full size Q=32: ids "
        f"agree {float((~diff).float().mean()):.4f} (the rest near-ties), "
        f"max |dscore| {float(err.max()):.3e} (bound {float(tol.max()):.3e})")
    # float64 brute force of (q . c_q) * scale
    qb = qn[:P8_BRUTE].double()
    best_s = best_i = None
    N = idx.codes.shape[0]
    for a in range(0, N, 1 << 18):
        b = min(N, a + (1 << 18))
        sc = (qb @ idx.codes[a:b].double().T) * idx.scales[a:b].double()
        ids = torch.arange(a, b, device=sc.device)[None].expand_as(sc)
        if best_s is not None:
            sc, ids = torch.cat([best_s, sc], 1), torch.cat([best_i, ids], 1)
        s, pos = torch.sort(sc, dim=1, descending=True, stable=True)
        best_s, best_i = s[:, :10], torch.gather(ids, 1, pos[:, :10])
    s_got, i_got = (x[:P8_BRUTE] for x in got)
    t2 = 2 * tol[:P8_BRUTE]
    if not bool(((s_got.double() - best_s).abs() <= t2).all()):
        raise AssertionError("int8 scores differ from the float64 (q . c_q) "
                             "* scale beyond twice the bound")
    diff = i_got.long() != best_i
    r, c = torch.nonzero(diff, as_tuple=True)
    i = i_got[r, c].long()
    exact = (idx.codes[i].double() * qb[r]).sum(1) * idx.scales[i].double()
    near_ties_only(exact, best_s[r, c], t2[r, 0].double(),
                   "int8 against the float64 brute force")
    log(f"  int8 against a float64 brute force of (q . c_q) * scale, "
        f"{P8_BRUTE} queries: ids agree {float((~diff).float().mean()):.4f} "
        f"(the rest near-ties), max |dscore| "
        f"{float((s_got.double() - best_s).abs().max()):.3e} (bound "
        f"{float(t2.max()):.3e})")
    # times: the whole scan on each path, and one chunk's two steps
    ms = {Q: gpu_ms(lambda: idx.query(queries[:Q], k=10), 3)
          for Q in BATCHES}
    plain_ms = gpu_ms(lambda: idx.query(q, k=10, use_kernel=False), 1)
    rows_c = scan_rows(DIM)
    chunk = dequantize_rows(idx.codes[:rows_c], idx.scales[:rows_c])
    deq_ms = gpu_ms(lambda: dequantize_rows(idx.codes[:rows_c],
                                            idx.scales[:rows_c]), 5)
    top_ms = gpu_ms(lambda: ops.topk_distance(chunk, qn, k=10), 5)
    n_chunks = -(-N // rows_c)
    log(f"  int8 scan times (CUDA events): the kernel path "
        + ", ".join(f"Q={Q} {t:.3f} ms" for Q, t in ms.items())
        + f"; the plain path Q=32 {plain_ms:.3f} ms; one chunk of {rows_c} "
        f"rows ({n_chunks} a batch): dequantize {deq_ms:.3f} ms, "
        f"topk_distance Q=32 {top_ms:.3f} ms")
    del chunk
    return {"ms": ms, "plain_ms_q32": plain_ms, "chunk_rows": rows_c,
            "chunks": n_chunks, "dequantize_ms": deq_ms,
            "chunk_topk_ms_q32": top_ms}


def p8_int8(corpus, queries, truth, meta, min_recall, launches) -> dict:
    """int8: load, serve (topk_distance must launch), recall (gated), the
    kernel path against plain and a float64 brute force, filtered
    batches."""
    import torch
    from repro_torch import VectorDB
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    db = VectorDB("int8", metric="cosine", device=corpus.device).load(
        corpus, meta=meta)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    p8_engine_facts(db, "int8", t_load, before)
    res, counts = serve_and_count(db, queries, "int8")
    if counts["topk_distance"] <= 0:
        raise AssertionError("topk_distance never launched on the int8 path")
    f_launch = dict(counts)
    out = {"load_s": t_load, "recall": p8_recalls(res, truth, "int8",
                                                  min_recall)}
    out.update(int8_checks(db.index, queries, res[32]))
    maps = bitmaps(db, corpus.device)
    counted(f_launch, serve_filtered, db, queries, "int8", maps, res,
            batches=P8_FILTER_Q)
    for name, c in f_launch.items():
        launches[name] = launches.get(name, 0) + c
    out["launches"] = f_launch["topk_distance"]
    log(f"  int8: topk_distance launches on its path (batches and filtered "
        f"batches): {f_launch['topk_distance']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


def graph_mid(corpus, seed: int) -> dict:
    """The graph build at GRAPH_MID rows through the kernel and through
    the plain version, both from the same numpy draws: the forward slots
    (those symmetrize never rewrites) equal but for near-ties, and the
    tables equal at 99.9 % of entries or more; each build's split."""
    import torch
    from repro_torch.core import distances as D
    from repro_torch.core.graph import build_knn_graph
    sub = D.l2_normalize(corpus[:GRAPH_MID])
    kw = dict(degree=16, metric="dot", max_candidates=16384, seed=seed)
    splits = {}
    tables = {}
    for name, use in (("kernel", True), ("plain", False)):
        st = {}
        t0 = time.perf_counter()
        tables[name] = build_knn_graph(sub, use_kernel=use, stats=st, **kw)
        torch.cuda.synchronize()
        st["wall_s"] = time.perf_counter() - t0
        splits[name] = st
        log(f"  graph build at {GRAPH_MID} rows, {name}: {st['wall_s']:.2f} s "
            f"(host draws {st['draw_s']:.2f} s, chunk loop {st['scan_s']:.2f}"
            f" s, of it {st['device_s']:.2f} s device spans, symmetrize "
            f"{st['symmetrize_s']:.3f} s, {st['chunks']} chunks)")
    got, want = tables["kernel"], tables["plain"]
    fwd = 16 - 16 // 4
    diff = got[:, :fwd] != want[:, :fwd]
    r, c = torch.nonzero(diff, as_tuple=True)
    # the two builds drew the same samples: a forward slot that differs
    # holds a row the plain build scored within the bound of its own pick
    s_got = (sub[got[r, c].long()].double() * sub[r].double()).sum(1)
    s_want = (sub[want[r, c].long()].double() * sub[r].double()).sum(1)
    tol = 2 * DIM * 2.0 ** -24 * 1.0  # unit rows
    near_ties_only(s_got, s_want, tol, "graph build kernel against plain")
    same = float((got == want).float().mean())
    log(f"  graph build kernel against plain at {GRAPH_MID} rows: forward "
        f"slots equal at {float((~diff).float().mean()):.6f} (the rest "
        f"near-ties within {2 * tol:.2e}), whole table {same:.6f}")
    if same < 0.999:
        raise AssertionError(f"graph tables agree at {same:.6f} < 0.999")
    return {"mid_tables_equal": same, "mid_splits": splits}


def p8_graph(box, queries, truth, seed, launches) -> dict:
    """graph: the build at GRAPH_MID rows kernel against plain, the full
    build (its split and launches), serve, recall (printed), and beam
    search through the kernel against use_kernel=False on the same
    table."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import distances as D
    from repro_torch.kernels import ops
    out = graph_mid(box[0], seed)
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    db = VectorDB("graph", metric="cosine", device=box[0].device).load(
        box.pop())
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    build = ops.launch_counts()["topk_distance"]
    torch.cuda.empty_cache()
    idx = db.index
    st = idx.build_stats
    if build <= 0:
        raise AssertionError("topk_distance never launched in the graph build")
    log(f"  graph build at full size: {t_load:.2f} s (host draws "
        f"{st['draw_s']:.2f} s, chunk loop {st['scan_s']:.2f} s, of it "
        f"{st['device_s']:.2f} s the chunks' device spans by CUDA events, "
        f"symmetrize {st['symmetrize_s']:.3f} s, {st['chunks']} chunks of "
        f"1024 rows against 16384 sampled rows each); topk_distance "
        f"launches {build}; entry rows {idx.entry[0].shape[0]} "
        f"({idx.entry[0].numel() * 4 / 1e6:.1f} MB)")
    p8_engine_facts(db, "graph", t_load, before)
    res, counts = serve_and_count(db, queries, "graph")
    if counts["topk_distance"] <= 0:
        raise AssertionError("topk_distance never launched in the graph's "
                             "entry scan")
    launches["topk_distance"] = (launches.get("topk_distance", 0) + build
                                 + counts["topk_distance"])
    out.update(load_s=t_load, build=dict(st), build_launches=build,
               launches=build + counts["topk_distance"],
               recall=p8_recalls(res, truth, "graph"))
    # beam search: the kernel's entry scan against the plain one
    for Q in (32, 512):
        q = queries[:Q]
        qn = D.l2_normalize(q.float())
        rows, _ = idx.entry
        compare_topk(rows, qn, "dot", idx.n_entry,
                     f"graph entry scan Q={Q}")
        ke = ops.topk_distance(rows, qn, k=idx.n_entry, use_kernel=True)[1]
        pe = ops.topk_distance(rows, qn, k=idx.n_entry, use_kernel=False)[1]
        kern = idx.query(q, k=10, use_kernel=True)
        plain = idx.query(q, k=10, use_kernel=False)
        torch.cuda.synchronize()
        seeds = (ke == pe).all(1)
        same = ((kern[0] == plain[0]).all(1) & (kern[1] == plain[1]).all(1))
        if bool((seeds & ~same).any()):
            raise AssertionError(f"graph Q={Q}: equal seeds, different beams")
        log(f"  graph beam search Q={Q} through the kernel against "
            f"use_kernel=False: {int(same.sum())} of {Q} rows bit-equal; "
            f"{int((~seeds).sum())} rows seeded differently (near-ties of "
            f"the entry scan)")
        ent_ms = gpu_ms(lambda: ops.topk_distance(rows, qn, k=idx.n_entry),
                        5)
        ent_plain = gpu_ms(lambda: ops.topk_distance(
            rows, qn, k=idx.n_entry, use_kernel=False), 2)
        log(f"  graph entry scan Q={Q}: kernel {ent_ms:.3f} ms, plain "
            f"{ent_plain:.3f} ms ({rows.shape[0]} rows)")
        out[f"entry_ms_q{Q}"], out[f"entry_plain_ms_q{Q}"] = ent_ms, ent_plain
    log(f"  peak device memory in graph: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


def phase_engines(n: int, seed: int, device, rank: int,
                  min_recall: float) -> dict:
    """Phase 8: ivf, int8 and graph at full size, one engine at a time, on
    the phase-4 data made again, against the float32 flat truth (ids
    only). Returns {"launches": topk_distance launches on the phase's
    path, engine: its numbers}."""
    import torch
    from repro_torch import VectorDB
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"phase 8: the remaining engines (ivf, int8, graph), N={n}, d={DIM},"
        f" cosine; device memory in use at the start "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus, queries = make_dataset(n, max(BATCHES), seed, device, rank)
    flat = VectorDB("flat", metric="cosine", device=device).load(corpus)
    truth = {Q: flat.query(queries[:Q], k=10)[1] for Q in BATCHES}
    torch.cuda.synchronize()
    del flat
    torch.cuda.empty_cache()
    meta = seeded_meta(n, seed)
    log(f"  the phase-4 data made again, the float32 flat truth at Q = "
        f"{BATCHES} (ids kept, the engine dropped) and the metadata: "
        f"{time.perf_counter() - t0:.2f} s")
    launches, out = {}, {}
    t0 = time.perf_counter()
    box = [corpus]
    del corpus
    out["ivf"] = p8_ivf(box, queries, truth, meta, n, seed, device, rank,
                        min_recall, launches)
    torch.cuda.empty_cache()
    log(f"  [ivf: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    corpus, _ = make_dataset(n, max(BATCHES), seed, device, rank)
    out["int8"] = p8_int8(corpus, queries, truth, meta, min_recall, launches)
    torch.cuda.empty_cache()
    log(f"  [int8: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    box = [corpus]
    del corpus
    out["graph"] = p8_graph(box, queries, truth, seed, launches)
    torch.cuda.empty_cache()
    log(f"  [graph: {time.perf_counter() - t0:.1f} s]")
    out["launches"] = launches.get("topk_distance", 0)
    log(f"  launches on phase 8's path (int8 batches and filtered batches, "
        f"the graph build and entry scans; not the comparisons): {launches}")
    if out["launches"] <= 0:
        raise AssertionError("topk_distance never launched in phase 8")
    log(f"[phase 8: {time.perf_counter() - t_phase:.1f} s]")
    return out


# ------------------------------------------------------------ phase 9
P9_MESHES = (((1,), ("data",)), ((4,), ("data",)),
             ((2, 2), ("data", "model")))
P9_INSERTS = 8           # insert batches of 1,024: the mutation cell's batches
P9_SELF = 4096           # loaded and inserted rows sent back as queries
P9_STREAM = 256          # reads of phase 9's interleaved_1to8 stream
P9_KERNELS = ("topk_distance", "pq_adc", "ivf_adc", "ivf_adc_blocked",
              "ivf_adc_run_resident")


def p9_mesh(shape, names, device):
    """A mesh of ``shape`` that repeats ``device``: S logical shards on
    one card."""
    from repro_torch.core import distributed as dist
    return dist.make_mesh(shape, names, devices=[device] * math.prod(shape))


def p9_serve(db, queries, label: str, launches: dict) -> tuple:
    """serve_batches with every launch count set to 0 just before and read
    just after (added into ``launches``). Returns (results, {Q: (p50,
    p99)})."""
    from repro_torch.kernels import ops
    stats = {}
    ops.reset_launch_counts()
    res = serve_batches(db, queries, label, stats)
    counts = ops.launch_counts()
    for name in P9_KERNELS:
        launches[name] = launches.get(name, 0) + counts[name]
    log(f"  launches on the {label} path: "
        + str({k: v for k, v in counts.items() if v}))
    return res, stats


def p9_load(make, label: str) -> tuple:
    """make() timed on the host clock (synchronized) with its peak device
    memory. Returns (engine, load seconds, peak GB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    db = make()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {label} load {secs:.2f} s, peak {peak:.2f} GB, in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return db, secs, peak


def p9_near_truth(db, got, want, qn, label: str) -> None:
    """A mesh's exact answers against single-host ones: scores within
    compare_topk's bound rank by rank; where an id differs, the mesh's row
    scores (float64 of the stored row) within twice the bound of the
    single-host score at that rank."""
    import torch
    slabs = db.corpus
    tol = topk_tolerance(slabs.shards[0], qn, False)[:, None]
    (s, i), (ws, wi) = got, want
    if not bool(((s - ws).abs() <= tol).all()):
        raise AssertionError(f"{label}: scores beyond the bound")
    diff = i != wi.long()
    r, c = torch.nonzero(diff, as_tuple=True)
    ids = i[r, c]
    rows = torch.stack([slabs.shards[int(x) // slabs.local_n][
        int(x) % slabs.local_n] for x in ids.tolist()]) if ids.numel() \
        else qn[:0]
    exact = (rows.double() * qn[r].double()).sum(1)
    near_ties_only(exact, ws[r, c].double(), tol[r, 0].double(), label)
    log(f"  {label}: ids equal the single-host answer at "
        f"{float((~diff).float().mean()):.4f} of ranks (the rest near-ties "
        f"within {float(tol.max()):.3e})")


def p9_merge_ms(parts, mesh, k: int = 10) -> float:
    """Device ms of the merge tail alone on these per-shard candidates."""
    from repro_torch.core import distributed as dist
    sizes = list(mesh.shape.values())
    return gpu_ms(lambda: dist._merge_local_topk(
        parts, k=k, sizes=sizes, hierarchical=True,
        device=mesh.merge_device), REPS[32])


def p9_flat_shards(db, q32, label: str) -> dict:
    """Each shard's topk_distance against its plain version at Q = 32,
    its kernel time, and the merge's on their candidates."""
    from repro_torch.kernels import ops
    parts, shard_ms, err = [], [], 0.0
    for idx, (slab, valid) in enumerate(zip(db.corpus.shards,
                                            db.valid.shards)):
        err = max(err, compare_topk(slab, q32, "dot", 10,
                                    f"{label} shard {idx} topk_distance Q=32",
                                    valid=valid))
        shard_ms.append(gpu_ms(lambda: ops.topk_distance(
            slab, q32, k=10, metric="dot", valid=valid), REPS[32]))
        s, i = ops.normalize_knockouts(*ops.topk_distance(
            slab, q32, k=10, metric="dot", valid=valid))
        parts.append((s, i.long() + idx * db.corpus.local_n))
    merge = p9_merge_ms(parts, db.mesh)
    b = topk_bound(db.corpus.local_n, DIM, 32, 10, False)
    log(f"  {label} Q=32: shard kernel ms {shard_ms} (bound {b[0]:.3f} ms, "
        f"{b[1]}, each), merge {merge:.4f} ms")
    return {"shard_ms": shard_ms, "merge_ms": merge, "max_abs_err": err}


def p9_flat(corpus, queries, truth, device, launches, out) -> None:
    """DistributedVectorDB float32 at each mesh (ids bit-equal to the truth
    at (1,), near-ties aside at the others), each shard's kernel against
    plain at Q = 32 with its time and the merge's; one bf16 mesh against
    the single-host bf16 flat; a mesh over every card where there are
    two or more."""
    import torch
    from repro_torch import VectorDB
    from repro_torch.core import DistributedVectorDB
    from repro_torch.core import distances as D
    qn = D.l2_normalize(queries)
    for shape, names in P9_MESHES:
        label = f"dist_flat {shape}"
        mesh = p9_mesh(shape, names, device)
        db, secs, peak = p9_load(
            lambda: DistributedVectorDB(mesh).load(corpus), label)
        log(f"  {label}: {db.n_shards} slabs of {db.corpus.local_n} rows "
            f"({db.corpus.shape[0] - db.n} pad rows in the last), "
            f"{db.corpus.numel() * 4 / 1e9:.2f} GB")
        res, lat = p9_serve(db, queries, label, launches)
        for Q in BATCHES:
            if shape == (1,):
                if not same_result(res[Q], truth[Q]):
                    raise AssertionError(f"{label} Q={Q}: not bit-equal to "
                                         "the single-host flat")
            else:
                p9_near_truth(db, res[Q], truth[Q], qn[:Q], f"{label} Q={Q}")
        if shape == (1,):
            log(f"  {label}: ids and scores bit-equal to the single-host "
                f"flat at Q = {BATCHES}")
        entry = {"load_s": secs, "peak_gb": peak, "p50_p99_ms": lat}
        if db.n_shards > 1:
            entry.update(p9_flat_shards(db, qn[:32], label))
        out[label] = entry
        del db
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    single = VectorDB("flat", dtype=torch.bfloat16, device=device).load(corpus)
    want = {Q: single.query(queries[:Q], k=10) for Q in BATCHES}
    del single
    torch.cuda.empty_cache()
    log(f"  the single-host bf16 flat's answers: "
        f"{time.perf_counter() - t0:.2f} s")
    label = "dist_flat bf16 (4,)"
    mesh = p9_mesh((4,), ("data",), device)
    db, secs, peak = p9_load(lambda: DistributedVectorDB(
        mesh, dtype=torch.bfloat16).load(corpus), label)
    res, lat = p9_serve(db, queries, label, launches)
    qb = D.l2_normalize(queries.to(torch.bfloat16))
    for Q in BATCHES:
        p9_near_truth(db, res[Q], want[Q], qb[:Q], f"{label} Q={Q}")
    out[label] = {"load_s": secs, "peak_gb": peak, "p50_p99_ms": lat,
                  "recall_at_10_vs_float32": recall_at_10(
                      res[512][1], truth[512][1])}
    del db
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 2:
        from repro_torch.core import distributed as dist
        count = torch.cuda.device_count()
        mesh = dist.make_mesh((count,), ("data",))
        label = f"dist_flat over {count} cards"
        db, secs, peak = p9_load(lambda: DistributedVectorDB(mesh).load(
            corpus), label)
        res, lat = p9_serve(db, queries, label, launches)
        for Q in BATCHES:
            p9_near_truth(db, res[Q], truth[Q], qn[:Q], f"{label} Q={Q}")
        out[label] = {"load_s": secs, "p50_p99_ms": lat}
        del db
        torch.cuda.empty_cache()
    else:
        log("  one card: every mesh of this phase repeats cuda:0, so the "
            "shards run one after another and the gather is a copy on one "
            "device (no interconnect is measured)")


def p9_pq(corpus, queries, truth, device, launches, out,
          lookups_per_s: float) -> None:
    """DistributedPQ (m = 64, float32 tables) trained at (4,), served at
    (4,) and from the same state at (2, 2): answers equal to the same
    tables through the single-host adc_topk over the unsharded codes,
    recall@10 against the truth, per_device_bytes; each shard's kernel
    against plain at Q = 32 with its time and the merge's."""
    import torch
    from repro_torch.core import DistributedPQ
    from repro_torch.core import distances as D
    from repro_torch.core.pq import adc_tables
    from repro_torch.kernels import ops
    mesh4 = p9_mesh((4,), ("data",), device)
    db4, secs, peak = p9_load(lambda: DistributedPQ(
        mesh4, m=M_SUBSPACES).load(corpus), "dist_pq (4,)")
    codes = db4.codes.gather()
    state = {"engine": "dist_pq", "metric": "cosine",
             "codebooks": db4.codebooks, "codes": codes, "n": db4.n,
             "d": db4.d}
    codes = codes[:db4.n]
    qn = D.l2_normalize(queries)
    for shape, names in P9_MESHES[1:]:
        label = f"dist_pq {shape}"
        if shape == (4,):
            db, s_load, s_peak = db4, secs, peak
        else:
            db, s_load, s_peak = p9_load(lambda: DistributedPQ(
                p9_mesh(shape, names, device), m=M_SUBSPACES).load_state(
                    state), label + " from the (4,) state")
        res, lat = p9_serve(db, queries, label, launches)
        for Q in BATCHES:  # the batch normalized as the engine does
            luts = adc_tables(db.codebooks, D.l2_normalize(queries[:Q]),
                              metric="dot")
            equal_up_to_ties(res[Q], ops.adc_topk(codes, luts, k=10),
                             f"{label} Q={Q} against adc_topk over the "
                             "unsharded codes")
        recall = recall_at_10(res[512][1], truth[512][1])
        pdb = db.per_device_bytes()
        cap = -(-db.n // db.n_shards) * db.m + db.codebooks.numel() * 4
        log(f"  {label}: recall@10 against float32 flat {recall:.4f} "
            f"(printed, not gated); per_device_bytes {pdb} (a quarter of "
            f"the padded codes plus the codebooks: {cap}); memory_bytes "
            f"{db.memory_bytes()}")
        if pdb > cap:
            raise AssertionError(f"{label}: per_device_bytes {pdb} > {cap}")
        out[label] = {"load_s": s_load, "peak_gb": s_peak, "p50_p99_ms": lat,
                      "recall_at_10": recall, "per_device_bytes": pdb}
    luts = adc_tables(db4.codebooks, qn[:32], metric="dot")
    parts, shard_ms, err = [], [], 0.0
    for idx, (c, v) in enumerate(zip(db4.codes.shards, db4.valid.shards)):
        err = max(err, compare_pq(c, luts, k=10, lut_dtype="float32",
                                  valid=v, label=f"dist_pq (4,) shard {idx} "
                                                 "pq_adc Q=32"))
        shard_ms.append(gpu_ms(lambda: ops.adc_topk(c, luts, k=10, valid=v),
                               REPS[32]))
        s, i = ops.adc_topk(c, luts, k=10, valid=v)
        parts.append((s, i.long() + idx * db4.codes.local_n))
    merge = p9_merge_ms(parts, mesh4)
    b = pq_bound(db4.codes.shards[0], luts, db4.valid.shards[0], 10,
                 lookups_per_s)
    log(f"  dist_pq (4,) Q=32: shard kernel ms {shard_ms} (bound {b[0]:.3f}"
        f" ms, {b[1]}, each), merge {merge:.4f} ms")
    out["dist_pq (4,)"].update(shard_ms=shard_ms, merge_ms=merge,
                               max_abs_err=err)
    del db4, db, codes, state
    torch.cuda.empty_cache()


def p9_state(db) -> dict:
    """A DistributedIVFPQ's state in ``load_state``'s form (the leaves
    ``core.convert.mesh_leaves`` reads off a reference engine), copied."""
    import torch
    lay = db.layout
    state = {"engine": db.engine_name, "metric": db.metric,
             "codebooks": db.codebooks.clone(),
             "centroids": db.centroids.clone(), "d": db.d,
             "next_id": db.next_id, "generation": db.generation,
             "layout_pos": lay.pos.clone(),
             "layout_free": torch.arange(lay.n_blocks, lay.capacity - 1),
             "layout_tombstones": lay.tombstones}
    for key in ("slots", "codes", "block_cluster", "block_table", "bcnt",
                "tail_fill"):
        state[f"layout_{key}"] = getattr(lay, key).clone()
    for kind, v in db.mutation_stats.items():
        state[f"writes_{kind}"] = v
    return state


def p9_single(db, q):
    """The single-host answer for a DistributedIVFPQ: the same probes and
    tables (q normalized as the engine normalizes its batch) through
    ops.ivf_adc_topk over its unsharded layout (the last storage row the
    all-pad block)."""
    from repro_torch.core import distances as D
    from repro_torch.core.pq import _ivf_probe_stage
    from repro_torch.kernels import ops
    qn = D.l2_normalize(q.float())
    lay = db.layout
    visit, luts, coarse, _ = _ivf_probe_stage(
        db.codebooks, db.centroids, qn, lay.block_table, metric="dot",
        nprobe=db.nprobe, steps_per_probe=lay.steps_per_probe,
        pad_block=lay.pad_row)
    return ops.ivf_adc_topk(lay.codes, lay.slots, visit, luts, k=10,
                            coarse=coarse, steps_per_probe=lay.steps_per_probe,
                            pad_block=lay.pad_row)


def p9_spills(db, before: dict) -> tuple:
    """Where one insert batch's new blocks went: (blocks placed on the
    shard of their cluster's previous block, blocks placed elsewhere while
    that shard had no free row). Fails on a block placed off its owner
    shard while the owner had room. Needs the capacity unchanged. The free
    rows are [n_blocks, capacity - 1), so an owner has room only when it
    holds the lowest free row: the layout meets the reference's rule by
    construction, and this holds it to that."""
    import torch
    lay = db.layout
    bloc = lay.capacity // db.n_shards
    bcnt0, bcnt1 = before["bcnt"].long(), lay.bcnt.long()
    grew = torch.nonzero(bcnt1 > bcnt0)[:, 0]
    own = other = 0
    full = {shard for shard in range(db.n_shards)
            if max(lay.n_blocks, shard * bloc)
            >= min(lay.capacity - 1, (shard + 1) * bloc)}
    for c, a, b in zip(grew.tolist(), bcnt0[grew].tolist(),
                       bcnt1[grew].tolist()):
        rows = lay.block_table[c, max(a - 1, 0):b].tolist()
        if a == 0:
            rows = rows[1:]  # a cluster's first block: the lowest free row
        for prev, row in zip(rows, rows[1:]):
            if row // bloc == prev // bloc:
                own += 1
            elif prev // bloc in full:
                other += 1
            else:
                raise AssertionError(f"cluster {c}: block {row} off shard "
                                     f"{prev // bloc}, which has room")
    return own, other


def p9_writes(db, queries, n, seed, device, rank, sample, launches,
              out) -> None:
    """The mutation cell's batches at (4,): 8 inserts of 1,024, a delete
    of 8,192, an upsert of 1,024, compact; then every written row's slot
    and codes, no deleted id back, written rows found in their own top 10
    at the loaded rows' rate less 0.02, each spilled block on its owner
    shard wherever that shard had room."""
    import torch
    rates = {}
    ins_vecs = new_rows(P9_INSERTS * MUT_BATCH["insert"], n, seed, 9, device,
                        rank)
    ins_ids, own, other = [], 0, 0
    t0 = time.perf_counter()
    for a in range(0, ins_vecs.shape[0], MUT_BATCH["insert"]):
        before = {"bcnt": db.layout.bcnt.clone(),
                  "capacity": db.layout.capacity}
        ins_ids.append(db.insert(ins_vecs[a:a + MUT_BATCH["insert"]]))
        if db.layout.capacity == before["capacity"]:
            o, f = p9_spills(db, before)
            own, other = own + o, other + f
        else:
            log(f"  the capacity grew to {db.layout.capacity}: the shard "
                "boundaries moved, this batch's spills are not checked")
    torch.cuda.synchronize()
    rates["insert"] = ins_vecs.shape[0] / (time.perf_counter() - t0)
    ins_ids = torch.cat(ins_ids)
    log(f"  inserted {ins_ids.numel()} rows: {rates['insert']:.1f} rows/s; "
        f"{own} spilled blocks on their cluster's owner shard, {other} "
        f"elsewhere (their owner shard full)")
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    perm = torch.randperm(n, generator=gen, device=device)
    n_del, n_ups = MUT_BATCH["delete"], MUT_BATCH["upsert"]
    dead, ups_ids = perm[:n_del], perm[n_del:n_del + n_ups]
    t0 = time.perf_counter()
    deleted = db.delete(dead)
    torch.cuda.synchronize()
    rates["delete"] = n_del / (time.perf_counter() - t0)
    if deleted != n_del:
        raise AssertionError(f"deleted {deleted} of {n_del} live ids")
    ups_vecs = new_rows(n_ups, n, seed, 10, device, rank)
    t0 = time.perf_counter()
    db.upsert(ups_vecs, ups_ids)
    torch.cuda.synchronize()
    rates["upsert"] = n_ups / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    stats = db.compact()
    torch.cuda.synchronize()
    log(f"  delete {rates['delete']:.1f} rows/s, upsert {rates['upsert']:.1f}"
        f" rows/s, compact {time.perf_counter() - t0:.3f} s {stats}; size "
        f"{db.size}, capacity {db.layout.capacity}, blocks a shard "
        f"{db.blocks_per_shard}")
    if db.size != n + ins_ids.numel() - n_del:
        raise AssertionError(f"size {db.size} after the writes")
    rows_in_layout(db, ins_ids, ins_vecs, "inserted")
    rows_in_layout(db, ups_ids, ups_vecs, "upserted")
    dead_mask = torch.zeros(db.next_id, dtype=torch.bool, device=device)
    dead_mask[dead] = True
    res, lat = p9_serve(db, queries, "dist_ivf_pq (4,) after the writes",
                        launches)
    for Q in BATCHES:
        no_dead_ids(res[Q][1], dead_mask, f"dist_ivf_pq (4,) Q={Q}")
    loaded = self_found(db, sample[1][:P9_SELF], sample[0][:P9_SELF],
                        "loaded rows (none written)")
    ins = self_found(db, ins_vecs[:P9_SELF], ins_ids[:P9_SELF],
                     "inserted rows")
    ups = self_found(db, ups_vecs, ups_ids, "upserted rows")
    log(f"  dist_ivf_pq has no re-rank: the loaded rows' own rate "
        f"{loaded:.4f} is the bar (less {SELF_MARGIN})")
    if min(ins, ups) < loaded - SELF_MARGIN:
        raise AssertionError(f"written rows found at {min(ins, ups):.4f}, "
                             f"below the loaded rows' {loaded:.4f} less "
                             f"{SELF_MARGIN}")
    out["dist_ivf_pq (4,) writes"] = {
        "rows_per_s": rates, "spills_on_owner": own, "spills_elsewhere":
        other, "self_found": {"loaded": loaded, "inserted": ins,
                              "upserted": ups}, "p50_p99_ms": lat}


def p9_fronts(db, queries, n, seed, device, rank, out) -> None:
    """QueryEngine and AsyncQueryEngine over the written (4,) index, each
    on a copy of it from one state, on a short interleaved_1to8 stream:
    every read's ids equal a twin's db.query(bucketize=False) with the
    stream's writes applied in queue order; no read sees an id deleted
    before it."""
    import torch
    from repro_torch.core import DistributedIVFPQ
    state = p9_state(db)
    ops_ = stream_script(db, queries, n, seed, 12, device, rank,
                         reads=P9_STREAM)

    def fresh():
        return DistributedIVFPQ(db.mesh, m=M_SUBSPACES).load_state(state)

    twin = fresh()
    oracle_s, oracle_i = [], []
    for op in ops_:
        if op[0] == "write":
            twin.apply_write(op[1], vectors=op[2], ids=op[3])
        else:
            s, i = twin.query(op[1].to(device), k=10, bucketize=False)
            oracle_s.append(s[0].cpu())
            oracle_i.append(i[0].cpu())
    del twin
    oracle = (torch.stack(oracle_s), torch.stack(oracle_i))
    for name, run in FRONTS[:2]:
        copy = fresh()
        results, stats, secs, batches = run(copy, ops_)
        label = f"{name} over dist_ivf_pq (4,) interleaved_1to8"
        log_front(label, stats, secs, batches, P9_STREAM)
        reads = [res for op, res in zip(ops_, results) if op[0] == "read"]
        ids_match_oracle(reads, oracle, label)
        deleted = set()
        for op, res in zip(ops_, results):
            if op[0] == "write":
                if op[1] == "delete":
                    deleted.update(int(i) for i in op[3].tolist() if i >= 0)
            elif set(res[1].tolist()) & deleted:
                raise AssertionError(f"{label}: a read saw a deleted id")
        out[label] = {"p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                      "qps": P9_STREAM / secs}
        del copy
        torch.cuda.empty_cache()


def p9_shards(db, queries, out, lookups_per_s: float, label: str) -> None:
    """Each shard's ivf_adc grids against their plain versions at Q = 32
    (the per-query grid, and both grouped ones also against it), the
    per-query kernel's time a shard, the merge's, and the sharing probe's
    host ms a shard (what auto pays before it picks a grid). A shard that
    owns no block compares pad output only, and is logged as such."""
    import torch
    from repro_torch.core import distances as D
    from repro_torch.core import distributed as dist
    from repro_torch.core.ivf import visit_sharing
    from repro_torch.core.pq import _ivf_probe_stage
    from repro_torch.kernels import ops
    qn = D.l2_normalize(queries[:32])
    visit, luts, coarse, _ = _ivf_probe_stage(
        db.codebooks, db.centroids, qn, db.block_table, metric="dot",
        nprobe=db.nprobe, steps_per_probe=db.spp, pad_block=-1)
    bps = db.blocks_per_shard
    kw = dict(k=10, spp=db.spp, lut_dtype="float32")
    parts, shard_ms, probe_ms, err = [], [], [], 0.0
    for idx, (c, ids) in enumerate(zip(db.codes_bm.shards,
                                       db.bucket_ids.shards)):
        v = dist.local_visit(visit, idx, bps)
        err = max(err, compare_ivf(c, ids, v, luts, coarse, **kw,
                                   label=f"{label} shard {idx} ivf_adc "
                                         "Q=32"))
        for mode in GROUPED:
            err = max(err, compare_grouped(
                c, ids, v, luts, coarse, mode=mode, qblk=8, **kw,
                label=f"{label} shard {idx} ivf_adc_{mode} Q=32"))
        call = dict(k=10, coarse=coarse, steps_per_probe=db.spp,
                    pad_block=bps, mode="per_query")
        shard_ms.append(gpu_ms(lambda: ops.ivf_adc_topk(c, ids, v, luts,
                                                        **call), REPS[32]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS[32]):
            visit_sharing(v, pad_block=bps)
        probe_ms.append((time.perf_counter() - t0) * 1e3 / REPS[32])
        s, i = ops.ivf_adc_topk(c, ids, v, luts, **call)
        parts.append((s, i.long()))
        b = ivf_bound(ids, v, luts, coarse, db.layout.blk, db.m,
                      lookups_per_s, k=10)
        owned = int((db.layout.block_cluster[idx * bps:(idx + 1) * bps]
                     >= 0).sum())
        log(f"  {label} shard {idx}: {owned} blocks, {int((v != bps).sum())}"
            f" of {v.numel()} visit steps on them"
            f"{'' if owned else ' (pad output compared only)'}; per-query "
            f"kernel {shard_ms[-1]:.4f} ms (bound {b[0]:.4f} ms, {b[1]}), "
            f"sharing probe {probe_ms[-1]:.3f} ms (host)")
    merge = p9_merge_ms(parts, db.mesh)
    log(f"  {label} Q=32: merge {merge:.4f} ms; auto pays "
        f"{sum(probe_ms):.3f} ms of sharing probes a batch")
    out[f"{label} shards"] = {"shard_ms": shard_ms, "merge_ms": merge,
                              "probe_ms": probe_ms, "max_abs_err": err}


def p9_ivf(box, queries, truth, n, seed, device, rank, launches, out,
           lookups_per_s: float) -> None:
    """DistributedIVFPQ (C = 2973, nprobe 8, m = 64, blk 32, auto) trained
    at (4,) (the data dropped after), served at every mesh from that state
    (answers equal to the single-host per-query answer on the unsharded
    layout with the same probes and tables), the hot set at (4,), then
    the writes, the fronts and the shards' kernels at (4,)."""
    import torch
    from repro_torch.core import DistributedIVFPQ
    corpus = box.pop()
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    perm = torch.randperm(n, generator=gen, device=device)
    kept = perm[MUT_BATCH["delete"] + MUT_BATCH["upsert"]:][:P9_SELF]
    sample = (kept, corpus[kept].clone())  # loaded rows the writes spare
    hot = hot_queries(corpus, seed, device)
    mesh4 = p9_mesh((4,), ("data",), device)
    db4, secs, peak = p9_load(lambda: DistributedIVFPQ(
        mesh4, m=M_SUBSPACES).load(corpus), "dist_ivf_pq (4,)")
    del corpus
    torch.cuda.empty_cache()
    lay = db4.layout
    log(f"  dist_ivf_pq (4,): C={db4.centroids.shape[0]}, storage rows "
        f"{lay.capacity} ({db4.blocks_per_shard} a shard, plus its pad "
        f"block), blocks {lay.n_blocks}, steps_per_probe {lay.steps_per_probe},"
        f" per_device_bytes "
        f"{db4.per_device_bytes()}")
    state = p9_state(db4)
    for shape, names in P9_MESHES:
        label = f"dist_ivf_pq {shape}"
        if shape == (4,):
            db, s_load, s_peak = db4, secs, peak
        else:
            db, s_load, s_peak = p9_load(lambda: DistributedIVFPQ(
                p9_mesh(shape, names, device), m=M_SUBSPACES).load_state(
                    state), label + " from the (4,) state")
        res, lat = p9_serve(db, queries, label, launches)
        for Q in BATCHES:
            equal_up_to_ties(res[Q], p9_single(db, queries[:Q]),
                             f"{label} Q={Q} against the single-host grid "
                             "on the unsharded layout")
        recall = recall_at_10(res[512][1], truth[512][1])
        log(f"  {label}: recall@10 against float32 flat {recall:.4f} "
            "(printed: no re-rank)")
        out[label] = {"load_s": s_load, "peak_gb": s_peak,
                      "p50_p99_ms": lat, "recall_at_10": recall}
        if db is not db4:
            del db
            torch.cuda.empty_cache()
    hot_res, hot_lat = p9_serve(db4, hot, "dist_ivf_pq (4,) hot set",
                                launches)
    equal_up_to_ties(hot_res[512], p9_single(db4, hot),
                     "dist_ivf_pq (4,) hot set Q=512 against the single-host "
                     "grid")
    out["dist_ivf_pq (4,) hot set"] = {"p50_p99_ms": hot_lat}
    # at (4,) the last shard owns no block (the capacity is a power of two
    # over about half as many blocks): at (2,) both shards own blocks, so
    # every shard there holds real work against plain
    db2 = DistributedIVFPQ(p9_mesh((2,), ("data",), device),
                           m=M_SUBSPACES).load_state(state)
    p9_shards(db2, queries, out, lookups_per_s, "dist_ivf_pq (2,)")
    del db2, state
    p9_writes(db4, queries, n, seed, device, rank, sample, launches, out)
    p9_fronts(db4, queries, n, seed, device, rank, out)
    p9_shards(db4, queries, out, lookups_per_s, "dist_ivf_pq (4,)")
    del db4
    torch.cuda.empty_cache()


def phase_mesh(n: int, seed: int, device, rank: int, rates: dict) -> dict:
    """Phase 9: the mesh fronts at full size on the phase-4 data made
    again, against the float32 flat truth, on meshes (1,), (4,) and (2, 2)
    that repeat the card. Returns {"launches": {kernel: launches on the
    phase's path}, label: its numbers}."""
    import torch
    from repro_torch import VectorDB
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"phase 9: the mesh fronts, N={n}, d={DIM}, cosine, meshes "
        f"{[m[0] for m in P9_MESHES]} repeating {device} "
        f"({torch.cuda.device_count()} card(s) visible); device memory in "
        f"use at the start {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    corpus, queries = make_dataset(n, max(BATCHES), seed, device, rank)
    flat = VectorDB("flat", metric="cosine", device=device).load(corpus)
    truth = {Q: flat.query(queries[:Q], k=10) for Q in BATCHES}
    torch.cuda.synchronize()
    del flat
    torch.cuda.empty_cache()
    log(f"  the phase-4 data made again and the float32 flat truth at Q = "
        f"{BATCHES}: {time.perf_counter() - t0:.2f} s")
    launches, out = {}, {}
    for name, part in (("flat", lambda: p9_flat(corpus, queries, truth,
                                                device, launches, out)),
                       ("pq", lambda: p9_pq(corpus, queries, truth, device,
                                            launches, out, rates["lookups"]))):
        t0 = time.perf_counter()
        part()
        log(f"  [dist_{name}: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    box = [corpus]
    del corpus
    p9_ivf(box, queries, truth, n, seed, device, rank, launches, out,
           rates["lookups"])
    log(f"  [dist_ivf_pq: {time.perf_counter() - t0:.1f} s]")
    log(f"  launches on phase 9's path (served batches; not the "
        f"comparisons): {launches}")
    for name in ("topk_distance", "pq_adc"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on phase 9's path")
    if sum(launches.get(g, 0) for g in P9_KERNELS[2:]) <= 0:
        raise AssertionError("no ivf_adc grid launched on phase 9's path")
    out["launches"] = launches
    log(f"[phase 9: {time.perf_counter() - t_phase:.1f} s]")
    return out


# --------------------------------------------------------- phase 10: training
TRAIN_PASSAGES = 2000        # examples/train_sbert.py --preset full's data
TRAIN_BATCH = 64
TRAIN_SEQ = 24
TRAIN_STEPS = 80             # the example runs 300; cut to keep the whole
                             # script inside its time limit (PERF.md section 4)
TRAIN_CKPT_EVERY = 20
TRAIN_FAILS = (30, 70)
TRAIN_INT8_STEPS = 80        # the loss rises through the warmup (steps
                             # 20-50) in either state, then falls
TRAIN_GRAD_B = 8             # the card-against-CPU gradient check's batch
TRAIN_WINDOW = 20            # steps averaged at each end of a loss curve
CUBLAS_DETERMINISTIC = ":4096:8"  # 8 x 4 MiB: PyTorch's default size on Hopper


def deterministic_cublas() -> str:
    """The cuBLAS workspace setting that ``torch.use_deterministic_algorithms``
    asks for, set unless the environment sets it; read when the first cuBLAS
    handle is made, so ``main`` sets it before any phase. 32 MiB is what
    PyTorch gives a Hopper card by default, so earlier phases' matmuls keep
    their workspace."""
    import os
    return os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                                 CUBLAS_DETERMINISTIC)


def grads_card_vs_cpu(cfg, batch, seed: int, device, label: str) -> None:
    """One contrastive_loss step's loss and gradients from one seeded
    state, on the card and on the CPU (the port's plain path there), held
    to the CPU-parity bounds: float32 loss within 1e-5 relative and each
    leaf within 1e-4 x its max |g|; bf16 loss within 2e-2 and each nonzero
    leaf at cosine >= 0.99; lm_head's gradient zero on both."""
    import torch
    from repro_torch.models import encoder
    from repro_torch.train.accum import value_and_grad
    out = []
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        model = encoder.init(cfg, torch.Generator().manual_seed(seed),
                             device=dev, trainable=True)
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        (loss, _), grads = value_and_grad(
            lambda m, b: encoder.contrastive_loss(m, cfg, b), model, tb)
        out.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
        log(f"  {label} on {dev}: loss {float(loss):.6f}, "
            f"{time.perf_counter() - t0:.2f} s")
        del model, grads
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    f32 = cfg.dtype == "float32"
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst_err = 0.0
    worst_cos = 1.0
    for name, gc in g_cpu.items():
        gg = g_gpu[name]
        scale = float(gc.abs().max())
        if name.startswith("lm_head"):
            if scale or float(gg.abs().max()):
                raise AssertionError(f"{label}: lm_head has a gradient")
            continue
        if f32:
            worst_err = max(worst_err, float((gg - gc).abs().max()) / scale)
        elif scale:
            cos = float((gg.double() * gc.double()).sum()
                        / gg.double().norm() / gc.double().norm())
            worst_cos = min(worst_cos, cos)
    log(f"  {label}: loss card {l_gpu:.6f} vs CPU {l_cpu:.6f} (rel "
        f"{rel:.3e}, bound {1e-5 if f32 else 2e-2}); "
        + (f"worst leaf |g - g_cpu| / max|g_cpu| {worst_err:.3e} (bound 1e-4)"
           if f32 else f"worst leaf cosine {worst_cos:.6f} (bound 0.99)")
        + "; lm_head's gradient zero on both")
    if rel > (1e-5 if f32 else 2e-2) or worst_err > 1e-4 or worst_cos < 0.99:
        raise AssertionError(f"{label}: card gradients differ from the CPU's")


def loss_drop(metrics, label: str) -> tuple:
    """(first, last) TRAIN_WINDOW-step mean losses; the last must be lower."""
    losses = [m["loss"] for m in metrics]
    first = sum(losses[:TRAIN_WINDOW]) / TRAIN_WINDOW
    last = sum(losses[-TRAIN_WINDOW:]) / TRAIN_WINDOW
    log(f"  {label}: loss mean of the first {TRAIN_WINDOW} steps {first:.4f}, "
        f"of the last {TRAIN_WINDOW} {last:.4f}")
    if not last < first:
        raise AssertionError(f"{label}: the loss did not fall")
    return first, last


def step_times(job, label: str) -> dict:
    """p50 / p99 of the job's step seconds (the first step apart), tokens
    a second at the p50 (both towers' tokens), and the first step."""
    secs = job.step_seconds
    p50, p99 = percentile(secs[1:], 50), percentile(secs[1:], 99)
    tokens = 2 * TRAIN_BATCH * TRAIN_SEQ
    log(f"  {label}: step p50 {p50 * 1e3:.2f} ms, p99 {p99 * 1e3:.2f} ms "
        f"over {len(secs) - 1} steps (the first {secs[0] * 1e3:.1f} ms), "
        f"{tokens / p50:.0f} tokens/s at the p50 (forward, backward, clip, "
        f"AdamW and the batch's upload; host clock ending in a synchronize)")
    return {"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
            "first_ms": secs[0] * 1e3, "tokens_per_s": tokens / p50}


def same_state(a, b, label: str) -> None:
    """Every leaf of two jobs' train states equal, bit for bit."""
    from repro_torch.train.optim import tree_get, tree_paths
    for path, x in tree_paths(a.state):
        if not torch_equal(x, tree_get(b.state, path)):
            raise AssertionError(f"{label}: {'/'.join(path)} differs")


def torch_equal(x, y) -> bool:
    import torch
    return bool(torch.equal(x.cpu(), y.cpu()))


def accumulation_checks(job, batch_fn, device) -> None:
    """gradient_accumulation on one batch of 64 at full width: n_micro = 4
    against n_micro = 1, within rtol 1e-4 / atol 1e-5, with a loss that is
    a mean over pairs (each row's 1 - cos(q_i, p_i)) on a float32 copy of
    the config; with the contrastive loss (shipped bf16), n_micro = 4
    against the mean of n_micro = 1 over the four quarters, within the
    same bounds. In-batch negatives make the contrastive loss of 4 x 16
    rows another function than that of 64 rows: their difference is
    printed, not held."""
    import dataclasses
    import torch
    from repro_torch.models import encoder
    from repro_torch.train.accum import gradient_accumulation, value_and_grad
    cfg = job.cfg
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch_fn(0).items()}

    def close(a, b, label):
        worst = 0.0
        for name in a:
            d = (a[name] - b[name]).abs() - 1e-4 * b[name].abs()
            worst = max(worst, float(d.max()))
        log(f"  {label}: max(|a - b| - 1e-4 |b|) {worst:.3e} (bound 1e-5)")
        if worst > 1e-5:
            raise AssertionError(f"{label}: gradients differ")

    def contrastive(m, b):
        return encoder.contrastive_loss(m, cfg, b)

    g4, _, _ = gradient_accumulation(contrastive, job.model, batch, 4)
    q = TRAIN_BATCH // 4
    quarters = [value_and_grad(contrastive, job.model,
                               {k: v[i * q:(i + 1) * q]
                                for k, v in batch.items()})[1]
                for i in range(4)]
    mean_q = {k: (((quarters[0][k] + quarters[1][k]) + quarters[2][k])
                  + quarters[3][k]) * 0.25 for k in g4}
    close(g4, mean_q, "contrastive, n_micro=4 against the quarters' mean")
    g1, _, _ = gradient_accumulation(contrastive, job.model, batch, 1)
    num = sum(float((g4[k] - g1[k]).norm() ** 2) for k in g1) ** 0.5
    den = sum(float(g1[k].norm() ** 2) for k in g1) ** 0.5
    log(f"  contrastive, n_micro=4 against n_micro=1 ({TRAIN_BATCH}-way "
        f"against {q}-way softmax, another loss): |g4 - g1| / |g1| "
        f"{num / den:.4f} (printed)")

    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def align(m, b):
        q = encoder.encode(m, cfg32, b["q_tokens"], b["q_mask"], train=True)
        p = encoder.encode(m, cfg32, b["p_tokens"], b["p_mask"], train=True)
        loss = (1.0 - (q * p).sum(dim=-1)).mean()
        return loss, {"loss": loss}

    a4, l4, _ = gradient_accumulation(align, job.model, batch, 4)
    a1, l1, _ = gradient_accumulation(align, job.model, batch, 1)
    log(f"  per-pair loss (float32 copy): n_micro=4 {float(l4):.7f}, "
        f"n_micro=1 {float(l1):.7f}")
    close(a4, a1, "per-pair loss, n_micro=4 against n_micro=1")


def phase_train(seed: int, device, snap_root: str) -> dict:
    """Phase 10: examples/train_sbert.py --preset full on the card:
    thistle-sbert FULL trained TRAIN_STEPS steps under the supervisor with two
    injected failures, against an uninterrupted run; retrieval before and
    after through the kernels; int8 Adam state; accumulation. Returns
    {kernel: launches on the retrieval path} and the phase's numbers."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import thistle_sbert
    from repro_torch.data.marco import MarcoLike
    from repro_torch.ft import FailureInjector, Supervisor
    from repro_torch.kernels import ops
    from repro_torch.train.optim import adam_state_bytes, state_bytes
    from repro_torch.models.encoder import encode
    from repro_torch.train.sbert import (SbertJob, retrieval_accuracy,
                                         sbert_batches)

    cfg = thistle_sbert.FULL
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"phase 10: training {cfg.name} at full width (layers {cfg.n_layers}, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.param_dtype} "
        f"parameters, {cfg.dtype} activations), examples/train_sbert.py "
        f"--preset full: MarcoLike({TRAIN_PASSAGES} passages, noise 0.25, "
        f"passage_len {TRAIN_SEQ}), batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, lr "
        f"3e-4 (warmup 20, cosine), clip 1.0, wd 0.01, {TRAIN_STEPS} steps; "
        f"CUBLAS_WORKSPACE_CONFIG={deterministic_cublas()}; device memory in "
        f"use at the start {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    data = MarcoLike(n_passages=TRAIN_PASSAGES, vocab_size=cfg.vocab_size,
                     noise=0.25, passage_len=TRAIN_SEQ, seed=0)
    out = {}

    t0 = time.perf_counter()
    small = sbert_batches(data, TRAIN_GRAD_B, cfg.vocab_size)(0)
    for c, label in ((cfg, "gradients, bf16 config"),
                     (dataclasses.replace(cfg, dtype="float32"),
                      "gradients, float32 copy")):
        grads_card_vs_cpu(c, small, seed, device, label)
    log(f"  [card against CPU: {time.perf_counter() - t0:.1f} s]")

    torch.cuda.reset_peak_memory_stats()
    job = SbertJob(cfg, data, TRAIN_BATCH, total_steps=TRAIN_STEPS,
                   injector=FailureInjector(fail_at=list(TRAIN_FAILS)),
                   device=device, seed=seed, log_every=TRAIN_CKPT_EVERY,
                   log=log)
    n_params = sum(p.numel() for p in job.model.parameters())
    ops.reset_launch_counts()
    before = retrieval_accuracy(job.model, cfg, data)  # the seeded tower
    launches = ops.launch_counts()
    work = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=snap_root)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    try:
        torch.use_deterministic_algorithms(True)
        # filling every new tensor (a debugging aid of deterministic mode)
        # adds 2,000 launches to the step's 6,000 and changes no result
        torch.utils.deterministic.fill_uninitialized_memory = False
        t0 = time.perf_counter()
        store = CheckpointStore(work, keep=2)
        sup = Supervisor(job, store, total_steps=TRAIN_STEPS,
                         checkpoint_every=TRAIN_CKPT_EVERY,
                         on_event=lambda k, i: log(f"  [supervisor] {k}: {i}"))
        res = sup.run()
        store.wait()
        sup_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  supervised run: {res['final_step']} steps, {res['n_retries']} "
            f"restarts, {len(job.step_seconds)} steps run, {sup_s:.1f} s; "
            f"{n_params} parameters; peak device memory {peak:.2f} GB")
        for h in job.saves:
            log(f"  checkpoint step {h.step}: host copy {h.copy_s:.2f} s, "
                f"write {h.write_s:.2f} s ({h.path})")
        if res["final_step"] != TRAIN_STEPS or res["n_retries"] != len(TRAIN_FAILS):
            raise AssertionError("the supervised run did not end as planned")
        sup_times = step_times(job, "supervised run")

        t0 = time.perf_counter()
        plain = SbertJob(cfg, data, TRAIN_BATCH, total_steps=TRAIN_STEPS,
                         device=device, seed=seed, log_every=0)
        for step in range(TRAIN_STEPS):
            plain.run_step(step)
        log(f"  uninterrupted run: {TRAIN_STEPS} steps, "
            f"{time.perf_counter() - t0:.1f} s")
        times = step_times(plain, "uninterrupted run")
        same_state(job, plain, "restarted against uninterrupted")
        log("  the restarted run's parameters and Adam moments equal the "
            "uninterrupted run's, bit for bit")
        for s in range(0, TRAIN_STEPS, TRAIN_CKPT_EVERY):
            m = plain.metrics[s]
            log(f"    step {s:3d}: loss {m['loss']:.4f}, in-batch acc "
                f"{m['in_batch_acc']:.3f}")
        f32_drop = loss_drop(plain.metrics, "float32 Adam state")

        int8 = SbertJob(cfg, data, TRAIN_BATCH, total_steps=TRAIN_STEPS,
                        device=device, seed=seed, log_every=0,
                        int8_state=True)
        for step in range(TRAIN_INT8_STEPS):
            int8.run_step(step)
        for s in range(0, TRAIN_INT8_STEPS, 10):
            log(f"    step {s:3d}: int8 state loss "
                f"{int8.metrics[s]['loss']:.4f}, float32 state "
                f"{plain.metrics[s]['loss']:.4f}")
        int8_drop = loss_drop(int8.metrics, "int8 Adam state")
        moments = {"int8": state_bytes(int8.opt), "float32": state_bytes(plain.opt)}
        log(f"  Adam moments: int8 {moments['int8'] / 1e9:.4f} GB (plan "
            f"adam_state_bytes {adam_state_bytes(n_params, True) / 1e9:.4f} "
            f"GB), float32 {moments['float32'] / 1e9:.4f} GB (plan "
            f"{adam_state_bytes(n_params, False) / 1e9:.4f} GB)")
        del int8
        accumulation_checks(plain, plain.batch_fn, device)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        shutil.rmtree(work, ignore_errors=True)

    ops.reset_launch_counts()
    stats = {}
    after = retrieval_accuracy(job.model, cfg, data, stats=stats)
    launches = {k: v + launches[k] for k, v in ops.launch_counts().items()}
    log(f"  retrieval top-1 (300 queries, VectorDB('flat', metric='cosine')): "
        f"before training {before:.3f}, after {after:.3f} (encode "
        f"{stats['encode_s']:.2f} s, search {stats['search_s']:.3f} s); "
        f"launches on the two retrievals' path: flash_attention "
        f"{launches['flash_attention']}, topk_distance "
        f"{launches['topk_distance']}")
    if not after > before:
        raise AssertionError("training did not lift retrieval")
    for name in ("flash_attention", "topk_distance"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on phase 10's path")
    tok = torch.as_tensor(data.passages[:128] % cfg.vocab_size).to(device)
    got = encode(job.model, cfg, tok, tok != 0)
    want = encode(job.model, cfg, tok, tok != 0, use_kernel=False)
    worst = float((got * want).sum(dim=1).min())
    log(f"  trained tower, 128 passages: encode through the kernel against "
        f"use_kernel=False: min row cosine {worst:.6f} (bound >= 0.999)")
    if worst < 0.999:
        raise AssertionError("the trained tower's kernel encode differs")
    out.update(launches={k: launches[k] for k in ("flash_attention",
                                                  "topk_distance")},
               retrieval={"before": before, "after": after},
               step=times, supervised_step=sup_times, peak_gb=peak,
               saves=[{"step": h.step, "copy_s": h.copy_s,
                       "write_s": h.write_s} for h in job.saves],
               loss={"float32": f32_drop, "int8": int8_drop},
               moments_bytes=moments, n_params=n_params)
    log(f"[phase 10: {time.perf_counter() - t_phase:.1f} s]")
    return out


# ------------------------------------------------------------- phase 11
LM_COS_KERNEL = 0.999       # kernel against plain attention, as phase 5
LM_COS_DECODE = 0.99        # decode at S against prefill(S + 1)
DANUBE_PREFILL = (2, 8192)  # (B, S): twice the window
DANUBE_PROMPT = (2, 4000)   # decoded past the window: the ring wraps
DANUBE_NEW = 100            # 4,000 + 100 tokens: the ring of 4,096 wraps
DANUBE_EMBED = (5120, 4300, 700, 1)  # embed_pooled's lengths, S past the window
V2_PREFILL = (4, 1024)
V2_NEW = 16


def attention_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs a head scores at S under causal and the window."""
    import numpy as np
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    hi = i + 1 if causal else np.full(S, S)
    return int((hi - lo).sum())


def lm_flash_bound(B, S, H, KV, dh, causal, window) -> tuple:
    """Least time of one bf16 call: q, k, v read and o written once, against
    4 dh operations a live (query, key) pair and head on the tensor cores."""
    return bound_ms(2 * (2 * B * S * H * dh + 2 * B * S * KV * dh),
                    4.0 * dh * attention_pairs(S, causal, window) * H * B,
                    BF16_OPS_PER_S)


def lm_flash(gen, B, S, H, KV, dh, window, device, label: str) -> dict:
    """flash_attention at one of phase 11's shapes (bf16, causal, the
    model's window): the kernel against its plain version, the plain
    version run a (sequence, KV head) at a time so that its (S, S) scores
    fit beside the card's other tensors, its time over those pieces, the
    kernel's, the bound, and F.scaled_dot_product_attention's with a
    boolean causal/window mask and k, v repeated for GQA (a yardstick)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    q = torch.randn(B, S, H, dh, generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn(B, S, KV, dh, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(B, S, KV, dh, generator=gen, device=device).to(torch.bfloat16)
    kw = dict(causal=True, scale=dh ** -0.5, window=window)
    rep = H // KV
    pieces = [(b, g) for b in range(B) for g in range(KV)]

    def plain():
        out = torch.empty_like(q)
        for b, g in pieces:
            out[b:b + 1, :, g * rep:(g + 1) * rep] = flash_attention_plain(
                q[b:b + 1, :, g * rep:(g + 1) * rep], k[b:b + 1, :, g:g + 1],
                v[b:b + 1, :, g:g + 1], **kw)
        return out

    got = flash_attention_cuda(q, k, v, **kw).float()
    want = plain().float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = FLASH_TOL["bfloat16"]
    if not (bool((err <= tol + tol * want.abs()).all())
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{label}: kernel and plain version differ")
    del got, want
    ms = gpu_ms(lambda: flash_attention_cuda(q, k, v, **kw), 10)
    plain_ms = gpu_ms(plain, 1)
    i = torch.arange(S, device=device)
    keep = i[:, None] >= i[None, :]
    if window:
        keep &= i[:, None] - i[None, :] < window
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    lib_ms = gpu_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, scale=dh ** -0.5), 10)
    b = lm_flash_bound(B, S, H, KV, dh, True, window)
    log(f"  flash_attention at {label} B={B} S={S} H={H} KV={KV} dh={dh} "
        f"causal window={window}: max |do| {float(err.max()):.3e} (bound "
        f"{tol} + {tol} |o|); kernel {ms:.4f} ms (bound {b[0]:.4f} ms, "
        f"{b[1]}; {attention_pairs(S, True, window)} live pairs a head), "
        f"plain {plain_ms:.4f} ms ({len(pieces)} pieces), "
        f"F.scaled_dot_product_attention {lib_ms:.4f} ms")
    return {"shape": f"{label}: B={B} S={S} H={H} KV={KV} dh={dh} bf16 causal "
                     f"window={window}",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms, "max_abs_err": float(err.max())}


def row_cosine(a, b):
    """min over rows of the cosine of two (..., n) tensors, in float64."""
    a = a.double().reshape(-1, a.shape[-1])
    b = b.double().reshape(-1, b.shape[-1])
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


def lm_gate(name: str, value: float, bound: float) -> None:
    log(f"  {name}: min row cosine {value:.6f} (bound >= {bound})")
    if not value >= bound:
        raise AssertionError(f"{name}: {value:.6f} below {bound}")


def lm_model(cfg, seed: int, device):
    """The model with seeded weights, drawn on the card leaf by leaf."""
    import torch
    from repro_torch.models import transformer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init(cfg, torch.Generator(device=device)
                             .manual_seed(seed), device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  init: {time.perf_counter() - t0:.2f} s, {n} parameters "
        f"({cfg.param_dtype}, {nbytes / 1e9:.2f} GB)")
    return model


def lm_prefill_timed(model, cfg, tokens, label: str):
    """prefill twice (the first warms up); returns (logits, cache,
    seconds of the second), host clock ending in a synchronize."""
    import torch
    from repro_torch.models import transformer
    transformer.prefill(model, cfg, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(model, cfg, tokens)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    B, S = tokens.shape
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    log(f"  prefill {label} B={B} S={S}: {secs:.4f} s, {B * S / secs:.1f} "
        f"tokens/s; cache {cache_bytes / 1e9:.3f} GB "
        f"({', '.join(f'{n} {tuple(c.shape)}' for n, c in cache.items())})")
    if not (logits.shape == (B, 1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill {label}: bad logits")
    return logits, cache, secs


def lm_generate(model, cfg, tokens, n_new: int, max_len: int, device,
                label: str) -> dict:
    """Two greedy DecodeLoop runs (gate: the same tokens). The first times
    each decode step (host clock around ``transformer.decode_step`` ending
    in a synchronize): p50 / p99 ms and tokens/s at the batch; the cache's
    bytes are read from the step's cache."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve import DecodeLoop
    loop = DecodeLoop(model, cfg, max_len=max_len, device=device)
    real = transformer.decode_step
    times, seen = [], {}

    def timed(params, cfg_, token, cache, pos):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(params, cfg_, token, cache, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        seen["gb"] = sum(c.numel() * c.element_size()
                         for c in cache.values()) / 1e9
        seen["slots"] = next(iter(cache.values())).shape[2]
        return out

    transformer.decode_step = timed
    try:
        a = loop.generate(tokens, n_new=n_new)
    finally:
        transformer.decode_step = real
    t0 = time.perf_counter()
    b = loop.generate(tokens, n_new=n_new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    B, S = tokens.shape
    p50, p99 = percentile(times, 50), percentile(times, 99)
    same = bool(torch.equal(a, b))
    log(f"  DecodeLoop {label} B={B} from S={S}: {n_new} greedy tokens in "
        f"{secs:.3f} s (prefill included); decode step p50 {p50 * 1e3:.3f} "
        f"ms, p99 {p99 * 1e3:.3f} ms over {len(times)} steps, {B / p50:.1f} "
        f"tokens/s at the p50; cache {seen['gb']:.3f} GB of {seen['slots']} "
        f"slots; two runs equal: {same}; first row {a[0, :8].tolist()}...")
    if not same or a.shape != (B, n_new):
        raise AssertionError(f"DecodeLoop {label}: greedy runs differ")
    if int(a.min()) < 0 or int(a.max()) >= cfg.vocab_size:
        raise AssertionError(f"DecodeLoop {label}: token out of range")
    return {"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
            "tokens_per_s": B / p50, "cache_gb": seen["gb"]}


def lm_prefill_breakdown(model, cfg, tokens, label: str) -> dict:
    """One prefill's device time by torch.profiler: every kernel's own
    device us, summed, the kernel's share, and the top kernels."""
    import torch
    from repro_torch.models import transformer
    us = device_us(lambda: transformer.prefill(model, cfg, tokens), reps=1)
    busy = sum(us.values()) / 1e3
    fa = sum(v for n, v in us.items() if "flash_attention" in n) / 1e3
    top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
    log(f"  one prefill {label}: device busy {busy:.3f} ms, flash_attention "
        f"{fa:.3f} ms ({100 * fa / max(busy, 1e-9):.1f} %); top: "
        + ", ".join(f"{n} {v / 1e3:.3f} ms" for n, v in top))
    return {"prefill_device_ms": busy, "prefill_flash_ms": fa}


def lm_decode_breakdown(model, cfg, tokens, label: str) -> dict:
    """One decode step's device time by torch.profiler (every kernel's
    own device us, summed) against its host time, after a prefill of
    ``tokens`` with the cache grown by 8 slots."""
    import torch
    from repro_torch.models import transformer
    B, S = tokens.shape
    logits, cache = transformer.prefill(model, cfg, tokens)
    cache = {n: transformer.pad_slots(c, S + 8) if cfg.window is None else c
             for n, c in cache.items()}
    tok = torch.argmax(logits[:, -1].float(), dim=-1)[:, None]
    us = device_us(lambda: transformer.decode_step(model, cfg, tok, cache, S),
                   reps=3)
    host = gpu_ms(lambda: transformer.decode_step(model, cfg, tok, cache, S), 3)
    busy = sum(us.values()) / 1e3
    top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
    log(f"  one decode step {label}: device busy {busy:.3f} ms of "
        f"{host:.3f} ms (CUDA events around the call; the rest is the host "
        f"queueing about {len(us)} distinct kernels); top: "
        + ", ".join(f"{n} {v:.1f} us" for n, v in top))
    return {"device_busy_ms": busy, "step_ms": host}


def lm_decode_gate(model, cfg, tokens, label: str, gate: bool = True,
                   **note) -> float:
    """Gate: decode_step at position S after prefill(S) against
    prefill(S + 1)'s last logits (the reference's own check; printed only
    with gate=False)."""
    from repro_torch.models import transformer
    S = tokens.shape[1] - 1
    full, _ = transformer.prefill(model, cfg, tokens)
    _, cache = transformer.prefill(model, cfg, tokens[:, :S])
    if cfg.window is None:  # grown, as DecodeLoop grows it
        cache = {n: transformer.pad_slots(c, S + 8) for n, c in cache.items()}
    dec, _ = transformer.decode_step(model, cfg, tokens[:, S:], cache, S)
    cos = row_cosine(dec, full)
    name = (f"{label}: decode at {S} after prefill({S}) against prefill("
            f"{S + 1})" + "".join(f", {k} {v}" for k, v in note.items()))
    if gate:
        lm_gate(name, cos, LM_COS_DECODE)
    else:
        log(f"  {name}: min row cosine {cos:.6f} (printed, not gated)")
    return cos


def lm_kernel_gate(model, cfg, tokens, label: str, gate: bool = True,
                   flips: bool = False) -> tuple:
    """Gate: the last-token logits through the kernel against the same
    prefill through the plain attention (printed only with gate=False).
    With ``flips``, also the tokens whose set of k experts differs between
    the two prefills, over all MoE layers (the router's choices recorded
    by wrapping ``models.moe._routing``). Returns (cosine, flips)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    real = moe_lib._routing
    runs = []

    def spy(logits, m, score):
        gates, idx = real(logits, m, score)
        runs[-1].append(idx.sort(dim=-1).values)
        return gates, idx

    if flips:
        moe_lib._routing = spy
    try:
        runs.append([])
        got, _ = transformer.prefill(model, cfg, tokens)
        runs.append([])
        want, _ = transformer.prefill(model, cfg, tokens, use_kernel=False)
    finally:
        moe_lib._routing = real
    cos = row_cosine(got, want)
    name = (f"{label}: last-token logits through the kernel against the "
            f"plain attention")
    if gate:
        lm_gate(name, cos, LM_COS_KERNEL)
    else:
        log(f"  {name}: min row cosine {cos:.6f} (printed, not gated)")
    n = None
    if flips:
        per_layer = [int((a != b).any(dim=-1).sum())
                     for a, b in zip(runs[0], runs[1])]
        n = sum(per_layer)
        log(f"  {label}: tokens routed to another expert set through the "
            f"kernel than through the plain attention: {n} of "
            f"{tokens.numel()} x {len(per_layer)} MoE layers (by layer: "
            f"{per_layer})")
    return cos, n


def phase_lm(seed: int, device) -> dict:
    """Phase 11: LM serving at full width. Returns {"launches":
    flash_attention's launches on the phase's path, "models": per model,
    its numbers and the kernel's at its shapes}."""
    import dataclasses

    import torch
    from repro_torch.configs import deepseek_v2_lite_16b, h2o_danube_1_8b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.moe import group_shape
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    out = {"launches": 0, "models": {}}

    def tokens_of(cfg, B, S):
        return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=device)

    # ---- h2o-danube-1.8b FULL: GQA 32/8, dh 80, window 4,096
    cfg = h2o_danube_1_8b.FULL
    log(f"phase 11: LM serving, {cfg.name} FULL (layers {cfg.n_layers}, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim}, window {cfg.window}, {cfg.param_dtype} parameters, "
        f"{cfg.dtype} activations, seeded random weights)")
    t_model = time.perf_counter()
    model = lm_model(cfg, seed, device)
    pre = tokens_of(cfg, *DANUBE_PREFILL)
    prompt = tokens_of(cfg, *DANUBE_PROMPT)
    B, S = DANUBE_PREFILL
    lengths = torch.tensor(DANUBE_EMBED, device=device)
    emb_mask = (torch.arange(max(DANUBE_EMBED), device=device)[None, :]
                < lengths[:, None])
    emb_tok = torch.where(emb_mask, tokens_of(cfg, len(DANUBE_EMBED),
                                              max(DANUBE_EMBED)), 0)
    ops.reset_launch_counts()
    _, cache, secs = lm_prefill_timed(model, cfg, pre, "(twice the window)")
    ring = all(c.shape[2] == cfg.window for c in cache.values())
    del cache
    dec = lm_generate(model, cfg, prompt, DANUBE_NEW, 2 * cfg.window, device,
                      "(the ring wraps)")
    pooled = transformer.embed_pooled(model, cfg, emb_tok, emb_mask)
    n_fa = ops.launch_counts()["flash_attention"]
    log(f"  launches on the danube path (prefill twice, the decode loop "
        f"twice, embed_pooled): {ops.launch_counts()}; ring of "
        f"{cfg.window} slots after the prefill: {ring}")
    if n_fa <= 0 or not ring:
        raise AssertionError("danube: flash_attention never launched, or the "
                             "prefill's cache is no ring")
    want = transformer.embed_pooled(model, cfg, emb_tok, emb_mask,
                                    use_kernel=False)
    lm_gate(f"danube embed_pooled B={len(DANUBE_EMBED)} S={max(DANUBE_EMBED)} "
            f"lengths {DANUBE_EMBED} through the kernel against the plain "
            f"attention", row_cosine(pooled, want), LM_COS_KERNEL)
    kcos, _ = lm_kernel_gate(model, cfg, pre, f"danube B={B} S={S}")
    dcos = lm_decode_gate(model, cfg, tokens_of(cfg, B, S + 1),
                          f"danube B={B}")
    dec.update(lm_decode_breakdown(model, cfg, prompt, "danube B=2 S=4000"))
    dec.update(lm_prefill_breakdown(model, cfg, pre, "danube B=2 S=8192"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    flash = lm_flash(gen, B, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     cfg.window, device, "danube prefill")
    log(f"  peak device memory {peak:.2f} GB; danube "
        f"{time.perf_counter() - t_model:.1f} s")
    out["launches"] += n_fa
    out["models"]["h2o-danube-1.8b"] = {
        "prefill_s": secs, "prefill_tokens_per_s": B * S / secs, **dec,
        "peak_gb": peak, "launches": n_fa, "kernel_cos": kcos,
        "decode_cos": dcos, "flash": flash}

    # ---- deepseek-v2-lite-16b FULL, bf16 parameters: MLA, 64 experts top-6
    cfg = dataclasses.replace(deepseek_v2_lite_16b.FULL,
                              param_dtype="bfloat16")
    log(f"phase 11: {cfg.name} FULL with bf16 parameters (layers "
        f"{cfg.n_layers}, d_model {cfg.d_model}, MLA heads {cfg.n_heads}, "
        f"kv_lora {cfg.mla.kv_lora_rank}, {cfg.moe.n_routed} experts top-"
        f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared, first "
        f"{cfg.first_k_dense} dense; {cfg.n_params()} parameters)")
    t_model = time.perf_counter()
    model = lm_model(cfg, seed, device)
    B, S = V2_PREFILL
    pre = tokens_of(cfg, B, S)
    ops.reset_launch_counts()
    _, cache, secs = lm_prefill_timed(model, cfg, pre, "")
    del cache
    dec = lm_generate(model, cfg, pre, V2_NEW, S + V2_NEW, device, "")
    n_fa = ops.launch_counts()["flash_attention"]
    log(f"  launches on the deepseek-v2-lite path (prefill twice, the "
        f"decode loop twice): {ops.launch_counts()}")
    if n_fa <= 0:
        raise AssertionError("v2-lite: flash_attention never launched")
    _, aux = transformer.forward(model, cfg, pre)
    dropped = float(aux["dropped_frac"])
    G, t, C = group_shape(B * S, cfg.moe)
    log(f"  MoE at the prefill: {G} groups of {t} tokens, C = {C}, "
        f"dropped_frac {dropped:.6f} (mean over {cfg.n_moe_layers} MoE "
        f"layers)")
    # At the config's capacity factor (1.25) the seeded model drops most
    # assignments: its tokens' hidden states are alike, so they choose
    # alike and saturate the experts they choose. At saturation one token
    # that changes expert moves every later token's queue slot, so a
    # bf16 ulp anywhere (kernel against plain attention; prefill(S + 1)'s
    # last token, which sits at the end of a full group, against a
    # dropless decode step) changes which assignments are dropped. Even
    # dropless, a bf16 ulp sends tokens at a near-tie of their 6th and 7th
    # router scores to another expert (counted below). These comparisons
    # are printed; the gates hold the same weights served at the capacity
    # factor that drops nothing (C = t, cf = E / k), the regime in which
    # the reference's own decode check holds (its SMOKE configs set cf 8
    # to stay dropless), and hold the kernel against the plain attention
    # with float32 activations, where the two agree to float32 rounding
    # and no token changes expert.
    longer = tokens_of(cfg, B, S + 1)
    _, aux1 = transformer.forward(model, cfg, longer)
    lm_kernel_gate(model, cfg, pre, f"v2-lite B={B} S={S} at cf "
                   f"{cfg.moe.capacity_factor}", gate=False)
    lm_decode_gate(model, cfg, longer, f"v2-lite B={B} at cf "
                   f"{cfg.moe.capacity_factor}", gate=False,
                   dropped_frac_of_the_longer_prefill=round(
                       float(aux1["dropped_frac"]), 6))
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    _, aux0 = transformer.forward(model, dropless, pre)
    log(f"  dropless serving (cf {dropless.moe.capacity_factor:.4f}, C = "
        f"{group_shape(B * S, dropless.moe)[2]}): dropped_frac "
        f"{float(aux0['dropped_frac']):.6f}")
    lm_kernel_gate(model, dropless, pre, f"v2-lite B={B} S={S} dropless",
                   gate=False, flips=True)
    kcos, flips32 = lm_kernel_gate(
        model, dataclasses.replace(dropless, dtype="float32"), pre,
        f"v2-lite B={B} S={S} dropless, float32 activations", flips=True)
    dcos = lm_decode_gate(model, dropless, longer, f"v2-lite B={B} dropless")
    dec.update(lm_decode_breakdown(model, cfg, pre, "v2-lite B=4 S=1024"))
    dec.update(lm_prefill_breakdown(model, cfg, pre, "v2-lite B=4 S=1024"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    m = cfg.mla
    flash = lm_flash(gen, B, S, cfg.n_heads, cfg.n_heads,
                     m.qk_nope_dim + m.qk_rope_dim, None, device,
                     "v2-lite prefill (MLA)")
    log(f"  peak device memory {peak:.2f} GB; v2-lite "
        f"{time.perf_counter() - t_model:.1f} s")
    out["launches"] += n_fa
    out["models"]["deepseek-v2-lite-16b"] = {
        "prefill_s": secs, "prefill_tokens_per_s": B * S / secs, **dec,
        "peak_gb": peak, "launches": n_fa, "kernel_cos": kcos,
        "decode_cos": dcos, "dropped_frac": dropped,
        "dropped_frac_dropless": float(aux0["dropped_frac"]),
        "routing_flips_float32": flips32, "flash": flash}
    return out


# ------------------------------------------------------------- phase 12
LM_TRAIN_SHAPE = (2, 4096)   # danube's step: past the chunk threshold, at the window
LM_TRAIN_STEPS = 20
LM_TRAIN_LR = 1e-3           # the trainer CLI's default; warmup 10, cosine
LM_CPU_SHAPE = (1, 32)       # card against CPU, float32 (the dense path)
V2_TRAIN_LAYERS = 3          # the first (dense) layer and 2 MoE layers
V2_TRAIN_SHAPE = (4, 1024)
V2_TRAIN_STEPS = 10
V2_CPU_SHAPE = (1, 64)
LM_WINDOW = 5                # steps averaged at each end of a loss curve


def leaf_cosines(got: dict, want: dict) -> tuple:
    """(worst cosine, its leaf) over the leaves both hold, in float64 on
    the first one's device; a leaf zero on both sides counts 1."""
    import torch
    worst, where = 1.0, None
    for name, w in want.items():
        g = got[name].double()
        w = w.to(g.device).double()
        den = float(g.norm() * w.norm())
        cos = 1.0 if den == 0 and not g.any() and not w.any() else (
            float((g * w).sum()) / den if den else 0.0)
        if cos < worst:
            worst, where = cos, name
    return worst, where


def grads_on(model, loss, batch, device):
    """((loss, metrics), {name: grad}) of ``loss(model, batch)`` with the
    batch's arrays moved to ``device``."""
    from repro_torch.train.accum import value_and_grad
    from repro_torch.train.job import to_device
    return value_and_grad(loss, model, to_device(batch, device))


def card_against_cpu(model, loss, batch, device, label: str, *, rel: float,
                     cos_min: float) -> dict:
    """The loss and gradients of one batch on the card, then with the
    model moved to the host (the same weights), then back: the loss within
    ``rel`` relative, every leaf's gradient cosine >= ``cos_min``."""
    import torch
    t0 = time.perf_counter()
    (l_gpu, m_gpu), g_gpu = grads_on(model, loss, batch, device)
    l_gpu = float(l_gpu)
    model.to("cpu")
    (l_cpu, _), g_cpu = grads_on(model, loss, batch, torch.device("cpu"))
    model.to(device)
    l_cpu = float(l_cpu)
    err = abs(l_gpu - l_cpu) / max(abs(l_cpu), 1e-30)
    cos, where = leaf_cosines(g_gpu, g_cpu)  # on the card, a leaf at a time
    n_leaves = len(g_cpu)
    del g_gpu, g_cpu
    log(f"  {label}: loss card {l_gpu:.7f} vs CPU {l_cpu:.7f} (rel "
        f"{err:.3e}, bound {rel:g}); worst leaf cosine {cos:.7f} ({where}; "
        f"bound {cos_min}); {n_leaves} leaves; "
        f"{time.perf_counter() - t0:.1f} s")
    if not err <= rel or not cos >= cos_min:
        raise AssertionError(f"{label}: card and CPU differ")
    return {"rel": err, "cos": cos,
            "metrics": {k: float(v) for k, v in m_gpu.items()}}


def curve_falls(metrics, label: str, window: int = LM_WINDOW) -> tuple:
    """(first, last) ``window``-step mean losses; the last must be lower."""
    losses = [m["loss"] for m in metrics]
    first = sum(losses[:window]) / window
    last = sum(losses[-window:]) / window
    log(f"  {label}: loss {', '.join(f'{x:.4f}' for x in losses)}; mean of "
        f"the first {window} {first:.4f}, of the last {window} {last:.4f}")
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"{label}: the loss did not fall")
    return first, last


def busy_ms(fn) -> tuple:
    """(device-busy ms of one fn() call by the profiler, its top kernels);
    the call is not repeated: fn must be warm."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity alone: host op tracing would cost tens of seconds
    # over a training step's 100,000 launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = device_times(prof, 1)
    top = sorted(us.items(), key=lambda kv: -kv[1])[:4]
    return sum(us.values()) / 1e3, ", ".join(f"{k} {v / 1e3:.2f} ms"
                                             for k, v in top)


def lm_train_model(cfg, seed: int, device, label: str):
    import torch
    from repro_torch.models import transformer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init(cfg, torch.Generator(device=device)
                             .manual_seed(seed), device=device, trainable=True)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"  {label} init on the card: {time.perf_counter() - t0:.2f} s, {n} "
        f"parameters ({cfg.param_dtype}, {n * 4 / 1e9:.2f} GB)")
    return model, n


def lm_train_run(model, cfg, n_params: int, batch_fn, steps: int,
                 label: str, remat: bool) -> dict:
    """``steps`` trainer-CLI steps (clip 1.0, cosine warmup 10, AdamW over
    the reference layout); step p50 / p99, tokens/s, the 6 N tokens rate
    against 989 TFLOP/s, one step's device-busy ms, peak and state GB."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.train.job import ModelJob
    from repro_torch.train.optim import state_bytes
    job = ModelJob(cfg, model,
                   lambda m, b: transformer.loss_fn(m, cfg, b, remat=remat),
                   batch_fn, lr=LM_TRAIN_LR, warmup=10, total_steps=steps,
                   log_every=0)
    t0 = time.perf_counter()
    for s in range(steps - 1):
        job.run_step(s)
    # the last step under the profiler (not in the p50 / p99)
    busy, top = busy_ms(lambda: job.run_step(steps - 1))
    secs = time.perf_counter() - t0
    B, S = batch_fn(0)["tokens"].shape
    st = job.step_seconds[1:steps - 1]
    p50, p99 = percentile(st, 50), percentile(st, 99)
    flops = 6.0 * n_params * B * S
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = (sum(p.numel() * p.element_size() for p in model.parameters())
             + state_bytes(job.opt)) / 1e9
    log(f"  {label}: {steps} steps in {secs:.1f} s; step p50 {p50 * 1e3:.1f} "
        f"ms, p99 {p99 * 1e3:.1f} ms (the first {job.step_seconds[0]:.2f} s), "
        f"{B * S / p50:.0f} tokens/s at the p50; 6 N tokens / step "
        f"{flops / p50 / 1e12:.1f} TFLOP/s = {flops / p50 / BF16_OPS_PER_S:.3f} "
        f"of 989; one step's device busy {busy:.1f} ms of {p50 * 1e3:.1f} "
        f"(profiler; top: {top}); peak {peak:.2f} GB, parameters and "
        f"moments {state:.2f} GB")
    return {"job": job, "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
            "tokens_per_s": B * S / p50, "mfu": flops / p50 / BF16_OPS_PER_S,
            "busy_ms": busy, "peak_gb": peak, "state_gb": state,
            "losses": [m["loss"] for m in job.metrics[:steps]]}


def phase_lm_train(seed: int, device) -> dict:
    """Phase 12: LM training at full width. Returns the phase's numbers."""
    import copy
    import dataclasses

    import torch
    from repro_torch.configs import (deepseek_v2_lite_16b, deepseek_v3_671b,
                                     h2o_danube_1_8b)
    from repro_torch.data.lm import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import transformer
    out = {}
    ops.reset_launch_counts()

    def lm_loss(cfg, remat=False):
        return lambda m, b: transformer.loss_fn(m, cfg, b, remat=remat)

    # ---- h2o-danube-1.8b FULL, remat, B = 2, S = 4,096
    cfg = h2o_danube_1_8b.FULL
    B, S = LM_TRAIN_SHAPE
    log(f"phase 12: LM training, {cfg.name} FULL (layers {cfg.n_layers}, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, window "
        f"{cfg.window}, {cfg.param_dtype} parameters, {cfg.dtype} "
        f"activations, seeded random weights): B={B}, S={S} (chunk "
        f"threshold {cfg.attn_chunk_threshold}), remat, TokenStream batches, "
        f"lr {LM_TRAIN_LR} (warmup 10, cosine), clip 1.0, AdamW float32, "
        f"{LM_TRAIN_STEPS} steps")
    t_model = time.perf_counter()
    model, n = lm_train_model(cfg, seed, device, "danube")
    batches = lm_batches(TokenStream(vocab_size=cfg.vocab_size), B, S,
                         cfg.vocab_size)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    small = lm_batches(TokenStream(vocab_size=cfg.vocab_size, seed=1),
                       *LM_CPU_SHAPE, cfg.vocab_size)(0)
    out["danube_cpu"] = card_against_cpu(
        model, lm_loss(cfg32), small, device,
        f"danube float32 B={LM_CPU_SHAPE[0]} S={LM_CPU_SHAPE[1]}, card "
        f"against CPU", rel=1e-5, cos_min=0.9999)
    (l16, m16), g16 = grads_on(model, lm_loss(cfg, True), batches(0), device)
    (l32, _), g32 = grads_on(model, lm_loss(cfg32, True), batches(0), device)
    rel = abs(float(l16) - float(l32)) / abs(float(l32))
    cos, where = leaf_cosines(g16, g32)
    del g16, g32
    log(f"  danube step 0 at B={B} S={S}, bf16 activations against float32 "
        f"on the card (same weights, remat): loss {float(l16):.6f} vs "
        f"{float(l32):.6f} (rel {rel:.3e}, bound 1e-2); worst leaf cosine "
        f"{cos:.6f} ({where}; bound 0.99)")
    if not (rel <= 1e-2 and cos >= 0.99):
        raise AssertionError("danube: bf16 gradients differ from float32's")
    torch.cuda.empty_cache()
    run = lm_train_run(model, cfg, n, batches, LM_TRAIN_STEPS, "danube",
                       remat=True)
    out["danube"] = {k: v for k, v in run.items() if k != "job"}
    out["danube"]["loss_first_last"] = curve_falls(
        run["job"].metrics[:LM_TRAIN_STEPS], "danube")
    out["danube"].update(bf16_rel=rel, bf16_cos=cos)
    del run, model
    torch.cuda.empty_cache()
    log(f"  [danube: {time.perf_counter() - t_model:.1f} s]")

    # ---- deepseek-v2-lite-16b FULL cut to 3 layers: MLA, 64 experts top-6
    cfg = dataclasses.replace(deepseek_v2_lite_16b.FULL,
                              n_layers=V2_TRAIN_LAYERS)
    B, S = V2_TRAIN_SHAPE
    log(f"phase 12: {cfg.name} FULL cut to {cfg.n_layers} layers ("
        f"{cfg.n_dense_layers} dense, {cfg.n_moe_layers} MoE; full width: "
        f"d_model {cfg.d_model}, MLA kv_lora {cfg.mla.kv_lora_rank}, "
        f"{cfg.moe.n_routed} experts top-{cfg.moe.top_k} + "
        f"{cfg.moe.n_shared} shared, capacity factor "
        f"{cfg.moe.capacity_factor}): B={B}, S={S}, {V2_TRAIN_STEPS} steps")
    t_model = time.perf_counter()
    model, n = lm_train_model(cfg, seed, device, "v2-lite cut")
    batches = lm_batches(TokenStream(vocab_size=cfg.vocab_size), B, S,
                         cfg.vocab_size)
    dropless = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    small = lm_batches(TokenStream(vocab_size=cfg.vocab_size, seed=1),
                       *V2_CPU_SHAPE, cfg.vocab_size)(0)
    out["v2_cpu"] = card_against_cpu(
        model, lm_loss(dropless), small, device,
        f"v2-lite cut float32 dropless B={V2_CPU_SHAPE[0]} "
        f"S={V2_CPU_SHAPE[1]}, card against CPU", rel=1e-4, cos_min=0.99)
    with torch.no_grad():
        tok = torch.as_tensor(batches(0)["tokens"]).to(device)
        _, aux = transformer.forward(model, cfg, tok)
    aux = {k: float(v) for k, v in aux.items()}
    log(f"  v2-lite cut at B={B} S={S}: load_balance {aux['load_balance']:.6e}, "
        f"router_z {aux['router_z']:.6e}, dropped_frac "
        f"{aux['dropped_frac']:.6f} (capacity factor "
        f"{cfg.moe.capacity_factor})")
    if not all(math.isfinite(aux[k]) and aux[k] > 0
               for k in ("load_balance", "router_z")):
        raise AssertionError("v2-lite: aux losses not finite and positive")
    run = lm_train_run(model, cfg, n, batches, V2_TRAIN_STEPS, "v2-lite cut",
                       remat=False)
    out["v2_lite"] = {k: v for k, v in run.items() if k != "job"}
    out["v2_lite"]["loss_first_last"] = curve_falls(
        run["job"].metrics[:V2_TRAIN_STEPS], "v2-lite cut")
    out["v2_lite"].update(aux)
    out["v2_lite"]["dropped_frac_steps"] = [
        m["dropped_frac"] for m in run["job"].metrics[:V2_TRAIN_STEPS]]
    del run, model
    torch.cuda.empty_cache()
    log(f"  [v2-lite cut: {time.perf_counter() - t_model:.1f} s]")

    # ---- deepseek-v3 SMOKE with its MTP head: card against CPU
    cfg = dataclasses.replace(deepseek_v3_671b.SMOKE, dtype="float32")
    model = transformer.init(cfg, torch.Generator().manual_seed(seed),
                             device=device, trainable=True)
    tb = lm_batches(TokenStream(vocab_size=cfg.vocab_size), 2, 16,
                    cfg.vocab_size)(0)
    out["v3_mtp"] = card_against_cpu(
        copy.deepcopy(model), lm_loss(cfg), tb, device,
        "deepseek-v3 SMOKE with its MTP head, float32, card against CPU",
        rel=1e-5, cos_min=0.99999)
    if "mtp_ce" not in out["v3_mtp"]["metrics"]:
        raise AssertionError("v3: no mtp_ce in the metrics")
    counts = ops.launch_counts()
    log(f"  launches on phase 12's path: {counts} (training differentiates "
        f"the attention's plain rule, as the reference does: no TPU kernel "
        f"on this path)")
    return out


# ------------------------------------------------------------- phase 13
RECSYS_BATCH = 65_536        # the reference's RECSYS_SHAPES["train_batch"]
RECSYS_STEPS = 30
RECSYS_LR = 3e-3             # examples/recsys_retrieval.py's rate
RECSYS_CPU_BATCH = 1024
RECSYS_KINDS = ("fm", "deepfm", "autoint", "sasrec")
RETRIEVAL_QS = (1, 512)
RETRIEVAL_USERS = 8
RETRIEVAL_REPS = {1: 20, 512: 5}
GNN_NODES = 232_965          # reddit
GNN_EDGES = 114_615_892      # reddit's directed edges: avg_degree 492
GNN_DEGREE = 232             # the largest avg_degree whose graph and CSR
                             # the host builds in 40 s (PERF.md section 4)
GNN_SEEDS = 1024
GNN_STEPS = 50
GNN_LR = 3e-3
GNN_EVAL = 4096              # held-out nodes scored after training


def host_batches(fn, steps: int) -> list:
    """fn(step) for each step, made on host threads (numpy releases the
    GIL in its draws); each step's batch is a function of the step alone."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(fn, range(steps)))


def retrieval_topk(db, q, label: str, launches: dict) -> dict:
    """The engine's answers at each Q of RETRIEVAL_QS (p50 of ``db.query``,
    one batch repeated), its kernel against the plain version on the
    engine's own padded buffer, the kernel's, the plain version's and
    torch.matmul + torch.topk's times beside the bound."""
    import torch
    from repro_torch.core import distances as D
    from repro_torch.kernels import ops
    from repro_torch.kernels.topk_distance import (topk_distance_cuda,
                                                   topk_distance_plain)
    scan = db.index._scan
    N, dp = scan.shape
    bias = torch.zeros(N, dtype=torch.float32, device=scan.device)
    out = {}
    for Q in RETRIEVAL_QS:
        qq = q[:Q]
        ops.reset_launch_counts()
        db.query(qq, k=10)
        torch.cuda.synchronize()
        times = []
        for _ in range(RETRIEVAL_REPS[Q]):
            t0 = time.perf_counter()
            s, i = db.query(qq, k=10)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        n = ops.launch_counts()["topk_distance"]
        launches["topk_distance"] = launches.get("topk_distance", 0) + n
        if n != len(times) + 1:
            raise AssertionError(f"{label} Q={Q}: {n} topk_distance launches "
                                 f"for {len(times) + 1} queries")
        qp = D.pad_width(qq)
        err = compare_topk(scan, qp, "dot", 10, f"{label} Q={Q} kernel "
                           f"against plain on the engine's buffer")
        ms = gpu_ms(lambda: topk_distance_cuda(scan, qp, bias, k=10,
                                               l2=False), 5)
        plain_ms = gpu_ms(lambda: topk_distance_plain(scan, qp, bias, k=10,
                                                      l2=False), 1)
        lib_ms = gpu_ms(lambda: library_topk(scan, qp, 10), 2)
        # the bound is the function's, at its own width d; the zero
        # columns up to dp are the engine's padding, no work the answer needs
        b = topk_bound(N, db.index.d, Q, 10, False)
        b_pad = topk_bound(N, dp, Q, 10, False)
        p50 = percentile(times, 50)
        log(f"  {label} Q={Q}: p50 {p50 * 1e3:.3f} ms (n={len(times)}); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul+"
            f"torch.topk {lib_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) at "
            f"d={db.index.d}; N={N}, padded to {dp}, which costs the bound "
            f"{b_pad[0] - b[0]:.3f} ms ({b_pad[0]:.3f} ms, {b_pad[1]})")
        out[Q] = {"p50_ms": p50 * 1e3, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1],
                  "padded_bound_ms": b_pad[0],
                  "max_abs_err": err, "N": N, "d": db.index.d, "d_scan": dp,
                  "ids": i}
    return out


def recsys_model(cfg, seed: int, device):
    import torch
    from repro_torch.models import recsys
    t0 = time.perf_counter()
    model = recsys.init(cfg, torch.Generator(device=device).manual_seed(seed),
                        device=device, trainable=True)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name} init on the card: {time.perf_counter() - t0:.2f} s, "
        f"{n} parameters ({n * 4 / 1e9:.2f} GB)")
    return model


def phase_recsys_gnn(seed: int, device) -> dict:
    """Phase 13: the recsys family trained at full size, retrieval through
    ``flat``, then GraphSAGE at reddit's size. Returns {"launches":
    topk_distance's on the retrieval path, ...}."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import ClickLogs, molecule_batch, sbm_graph
    from repro_torch.models import gnn, recsys
    from repro_torch.train import recsys as rtrain
    from repro_torch.train.job import ModelJob, to_device
    out = {"launches": {}, "recsys": {}, "retrieval": {}}
    torch.cuda.empty_cache()

    # ---- recsys: four kinds at FULL, 30 steps of 65,536 rows
    criteo = ClickLogs(get_arch("fm").full)
    t0 = time.perf_counter()
    rows = host_batches(lambda s: criteo.batch(RECSYS_BATCH, s), RECSYS_STEPS)
    log(f"phase 13: recsys at FULL, {RECSYS_STEPS} steps of {RECSYS_BATCH} "
        f"rows (ClickLogs: {criteo.cfg.n_sparse} sparse + "
        f"{criteo.cfg.n_dense} dense fields, "
        f"{sum(criteo.cfg.field_vocab_sizes())} table rows; batches made "
        f"once on 8 host threads in {time.perf_counter() - t0:.1f} s, shared "
        f"by fm, deepfm and autoint, whose field sizes are equal), lr "
        f"{RECSYS_LR} (warmup 10, cosine), clip 1.0, AdamW")
    trained = {}
    for kind in RECSYS_KINDS:
        t_kind = time.perf_counter()
        cfg = get_arch(kind).full
        logs = ClickLogs(cfg)
        if kind == "sasrec":
            t0 = time.perf_counter()
            data = host_batches(lambda s: logs.sequence_batch(RECSYS_BATCH, s),
                                RECSYS_STEPS)
            log(f"  sasrec sequence batches ({cfg.n_items} items, seq "
                f"{cfg.seq_len}): {time.perf_counter() - t0:.1f} s")
            small = logs.sequence_batch(RECSYS_CPU_BATCH, 1000)
        else:
            data = rows
            small = logs.batch(RECSYS_CPU_BATCH, 1000)
        model = recsys_model(cfg, seed, device)

        def loss(m, b, cfg=cfg):
            return recsys.loss_fn(m, cfg, b)

        cpu = card_against_cpu(model, loss, small, device,
                               f"{kind} float32 {RECSYS_CPU_BATCH} rows at "
                               f"the full tables, card against CPU",
                               rel=1e-5, cos_min=0.99999)
        job = ModelJob(cfg, model, loss, lambda s: data[s], lr=RECSYS_LR,
                       warmup=10, total_steps=RECSYS_STEPS, log_every=0)
        for s in range(RECSYS_STEPS - 1):
            job.run_step(s)
        busy, top = busy_ms(lambda: job.run_step(RECSYS_STEPS - 1))
        st = job.step_seconds[1:RECSYS_STEPS - 1]
        p50 = percentile(st, 50)
        first, last = curve_falls(job.metrics, kind)
        log(f"  {kind}: step p50 {p50 * 1e3:.2f} ms, p99 "
            f"{percentile(st, 99) * 1e3:.2f} ms, "
            f"{RECSYS_BATCH / p50:.0f} examples/s at the p50 (the first step "
            f"{job.step_seconds[0]:.2f} s); the last step's device busy "
            f"{busy:.2f} ms (profiler; top: {top}); "
            f"{time.perf_counter() - t_kind:.1f} s")
        out["recsys"][kind] = {"p50_ms": p50 * 1e3, "busy_ms": busy,
                               "examples_per_s": RECSYS_BATCH / p50,
                               "loss_first_last": (first, last),
                               "cpu_rel": cpu["rel"], "cpu_cos": cpu["cos"]}
        if kind in ("fm", "sasrec", "autoint"):
            trained[kind] = (cfg, model)
        del job, data
        torch.cuda.empty_cache()
    del rows

    # ---- retrieval through VectorDB("flat", metric="dot")
    for kind in ("fm", "sasrec", "autoint"):
        cfg, model = trained.pop(kind)
        t0 = time.perf_counter()
        db = rtrain.retrieval_db(model, cfg)
        torch.cuda.synchronize()
        logs = ClickLogs(cfg)
        users = (logs.sequence_batch(max(RETRIEVAL_QS), 10_000)
                 if kind == "sasrec" else
                 logs.batch(max(RETRIEVAL_QS), 10_000))
        users = to_device(users, device)
        q = rtrain.user_vectors(model, cfg, users)
        log(f"  {kind} retrieval: item tower ({db.index.corpus.shape[0]} x "
            f"{db.index.d}) into "
            f"VectorDB('flat', metric='dot') in {time.perf_counter() - t0:.2f} "
            f"s")
        res = retrieval_topk(db, q, f"{kind} retrieval", out["launches"])
        if kind == "fm":
            u = RETRIEVAL_USERS
            few = {k: v[:u] for k, v in users.items()}
            t0 = time.perf_counter()
            full = rtrain.fm_rescore(model, cfg, few)
            mips = res[max(RETRIEVAL_QS)]["ids"][:u, 0].long()
            best = full.max(dim=1)
            got = full[torch.arange(u, device=full.device), mips]
            tol = 1e-5 * float(full.abs().max()) + 1e-6
            exact = int((mips == best.indices).sum())
            log(f"  fm: the MIPS top item of {u} users against fm_forward "
                f"re-scored over all {full.shape[1]} items "
                f"({time.perf_counter() - t0:.2f} s): {exact} of {u} the "
                f"argmax itself, max score gap "
                f"{float((best.values - got).max()):.3e} (bound {tol:.3e}: "
                f"ties aside)")
            if not bool((best.values - got <= tol).all()):
                raise AssertionError("fm: the MIPS top item is not the full "
                                     "model's argmax")
        out["retrieval"][kind] = {Q: {k: v for k, v in r.items() if k != "ids"}
                                  for Q, r in res.items()}
        del db, model, q
        torch.cuda.empty_cache()

    # ---- GraphSAGE at reddit's size
    cfg = get_arch("graphsage-reddit").full
    t0 = time.perf_counter()
    g = sbm_graph(GNN_NODES, cfg.n_classes, cfg.d_in, avg_degree=GNN_DEGREE,
                  seed=seed)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = gnn.NeighborSampler(g["edges"], GNN_NODES, cfg.sample_sizes,
                                  seed=seed)
    t_csr = time.perf_counter() - t0
    log(f"phase 13: {cfg.name} FULL (d_in {cfg.d_in}, hidden {cfg.d_hidden}, "
        f"{cfg.n_classes} classes, {cfg.aggregator}, fanouts "
        f"{cfg.sample_sizes}) on sbm_graph({GNN_NODES} nodes, avg_degree "
        f"{GNN_DEGREE}: {g['edges'].shape[1]} directed edges; reddit has "
        f"{GNN_EDGES}): graph {t_graph:.1f} s, CSR {t_csr:.1f} s on the host")
    feats = torch.as_tensor(g["feats"]).to(device)
    labels = torch.as_tensor(g["labels"]).to(device)
    train_nodes = np.nonzero(g["label_mask"])[0]
    held = np.nonzero(~g["label_mask"])[0]
    fan = list(cfg.sample_sizes)
    sample_s = []

    def block_batch(seeds):
        t0 = time.perf_counter()
        nodes, blocks = sampler.sample(seeds)
        nodes, blocks = gnn.pad_sample(nodes, blocks, len(seeds), fan)
        sample_s.append(time.perf_counter() - t0)
        return {"feats": feats[torch.as_tensor(nodes).to(device)],
                "blocks": to_device(blocks, device),
                "labels": labels[torch.as_tensor(seeds).to(device)]}

    def seeds_of(step):
        return np.random.default_rng((seed, step)).choice(
            train_nodes, GNN_SEEDS, replace=False)

    model = gnn.init(cfg, torch.Generator(device=device).manual_seed(seed),
                     device=device, trainable=True)

    def bloss(m, b):
        return gnn.block_loss(m, cfg, b)

    cpu = card_against_cpu(model, bloss, block_batch(seeds_of(10_000)),
                           device, f"graphsage float32 one sampled batch of "
                           f"{GNN_SEEDS} seeds, card against CPU", rel=1e-5,
                           cos_min=0.99999)
    sample_s.clear()
    job = ModelJob(cfg, model, bloss, lambda s: block_batch(seeds_of(s)),
                   lr=GNN_LR, warmup=10, total_steps=GNN_STEPS, log_every=0)
    for s in range(GNN_STEPS - 1):
        job.run_step(s)
    b = block_batch(seeds_of(GNN_STEPS - 1))
    job.batch_fn = lambda s: b  # the last step's batch sampled before it
    busy, top = busy_ms(lambda: job.run_step(GNN_STEPS - 1))
    first, last = curve_falls(job.metrics, "graphsage block_loss")
    with torch.no_grad():
        correct = 0
        for a in range(0, GNN_EVAL, GNN_SEEDS):
            ev = held[a:a + GNN_SEEDS]
            eb = block_batch(ev)
            logits = gnn.forward_blocks(model, cfg, eb["feats"], eb["blocks"])
            correct += int((logits.argmax(-1) == eb["labels"]).sum())
    acc = correct / GNN_EVAL
    st = job.step_seconds[1:GNN_STEPS - 1]
    log(f"  graphsage: step p50 {percentile(st, 50) * 1e3:.2f} ms, p99 "
        f"{percentile(st, 99) * 1e3:.2f} ms (host clock, the sampler "
        f"included); the sampler's host ms a step p50 "
        f"{percentile(sample_s, 50) * 1e3:.2f}; the last step's device "
        f"busy {busy:.2f} ms (profiler, its batch sampled before it; top: "
        f"{top}); "
        f"held-out accuracy {acc:.4f} over {GNN_EVAL} nodes (bound > 0.5; "
        f"chance {1 / cfg.n_classes:.3f})")
    if not acc > 0.5:
        raise AssertionError("graphsage: held-out accuracy at or below 0.5")
    out["gnn"] = {"graph_s": t_graph, "csr_s": t_csr, "edges":
                  int(g["edges"].shape[1]), "avg_degree": GNN_DEGREE,
                  "step_p50_ms": percentile(st, 50) * 1e3,
                  "sampler_ms": percentile(sample_s, 50) * 1e3,
                  "busy_ms": busy, "held_out_acc": acc,
                  "loss_first_last": (first, last), "cpu_rel": cpu["rel"],
                  "cpu_cos": cpu["cos"]}
    del job, model, feats, g, sampler
    torch.cuda.empty_cache()

    # ---- node_loss at cora's shape, graph_loss on molecule_batch(128)
    for label, gcfg, data, lossfn in (
            ("node_loss at cora's shape (2,708 nodes, 1,433 features, 7 "
             "classes)", dataclasses.replace(cfg, d_in=1433, n_classes=7),
             sbm_graph(2708, 7, 1433, seed=seed), gnn.node_loss),
            ("graph_loss on molecule_batch(128)",
             dataclasses.replace(cfg, d_in=16, n_classes=2),
             molecule_batch(128, seed=seed), gnn.graph_loss)):
        m = gnn.init(gcfg, torch.Generator(device=device).manual_seed(seed),
                     device=device, trainable=True)
        dev_data = to_device(data, device)
        job = ModelJob(gcfg, m, lambda mm, bb, c=gcfg, f=lossfn: f(mm, c, bb),
                       lambda s: dev_data, lr=GNN_LR, warmup=10,
                       total_steps=20, log_every=0)
        for s in range(20):
            job.run_step(s)
        out["gnn"][label.split()[0]] = curve_falls(job.metrics, label)
    return out


P14_PREFILL = (2, 8192)      # prefill_32k's 32 x 32,768 cut to phase 11's shape
P14_DECODE = 16              # make_lm_decode steps after the prefill
P14_TRAIN = (2, 4096)        # train_4k cut to global batch 2
P14_TRAIN_STEPS = 2
P14_SERVE_B = 512            # sasrec serve_p99's batch
P14_GSPMD = (1_000_000, 768, 32, 10)   # (rows, d, Q, k)
P14_REPS = 3
P14_COS_PREFILL = 0.999
P14_COS_DECODE = 0.99
P14_TRAIN_REL = 1e-6
P14_TRAIN_COS = 0.99999


def p14_world(backend: str = "nccl"):
    """A world of one rank (NCCL on the card) and the (1, 1) ("data",
    "model") mesh over it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", (1, 1),
                            mesh_dim_names=("data", "model"))


def p14_counted(out: dict, fn):
    """fn() on the phase's main path: the launch counts set to 0 before it
    and read after it, added to ``out["launches"]``; CommDebugMode's
    collectives added to ``out["collectives"]``."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    with CommDebugMode() as comm:
        result = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for name, n in ops.launch_counts().items():
        out["launches"][name] = out["launches"].get(name, 0) + n
    for op, n in comm.get_comm_counts().items():
        key = str(op)
        out["collectives"][key] = out["collectives"].get(key, 0) + n
    return result


def p14_timed(out: dict, label: str, fn, reps: int = P14_REPS):
    """fn() ``reps`` times on the main path (counted); its p50 wall ms
    (each run ends in a synchronize), logged; returns the last result."""
    times, result = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        result = p14_counted(out, fn)
        times.append(time.perf_counter() - t0)
    out["p50_ms"][label] = percentile(times, 50) * 1e3
    log(f"  {label}: p50 {out['p50_ms'][label]:.2f} ms over {reps} runs")
    return result


def p14_leaves_close(got: dict, want: dict, label: str) -> tuple:
    """Every leaf of a sharded step's new state against the single-process
    step's (``want`` on the host): max |d| / max |want| <= P14_TRAIN_REL
    and cosine >= P14_TRAIN_COS. Returns (worst rel, least cosine)."""
    import torch
    worst_rel, least_cos = 0.0, 1.0
    for name, g in got.items():
        g = (g.full_tensor() if hasattr(g, "full_tensor") else g).double()
        w = want[name].to(g.device).double()
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        den = float(g.norm() * w.norm())
        cos = float((g * w).sum()) / den if den else 1.0
        worst_rel, least_cos = max(worst_rel, rel), min(least_cos, cos)
        if not (rel <= P14_TRAIN_REL and cos >= P14_TRAIN_COS):
            raise AssertionError(f"{label} {name}: rel {rel:.3e}, cosine "
                                 f"{cos:.7f}")
    return worst_rel, least_cos


def p14_lm(out: dict, seed: int, device, mesh) -> None:
    """danube FULL: prefill, decode and two train steps on the mesh."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as S
    from repro_torch.launch.shapes import Spec
    from repro_torch.models import transformer
    from repro_torch.train import (adamw_init, adamw_update,
                                   clip_by_global_norm, cosine_schedule,
                                   gradient_accumulation)
    arch = "h2o-danube-1.8b"
    cfg = get_arch(arch).full
    gen = torch.Generator(device=device).manual_seed(seed + 14)
    model, _ = lm_train_model(cfg, seed, device, f"{arch} FULL")
    tree = convert.bind_reference_layout(model, cfg)

    # ---- prefill_32k, cut
    B, S_ = P14_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (B, S_), generator=gen,
                           device=device)
    built = S.make_lm_prefill(cfg, mesh, arch, {"tokens": Spec((B, S_),
                                                               torch.int32)})
    args = built.distribute(tree, tokens)
    logits, cache = p14_timed(out, f"prefill B={B} S={S_}",
                              lambda: built.fn(*args))
    logits = logits.full_tensor()
    want, cache_ref = transformer.prefill(model, cfg, tokens)
    cos = row_cosine(logits[:, -1], want[:, -1])
    diff = float((logits.float() - want.float()).abs().max())
    lm_gate(f"sharded prefill against prefill (max |d| {diff:.3e}, "
            f"bit-equal {bool(torch.equal(logits, want))})", cos,
            P14_COS_PREFILL)
    out["prefill"] = {"cosine": cos, "max_abs_diff": diff,
                      "bit_equal": bool(torch.equal(logits, want))}

    # ---- decode: P14_DECODE steps after the prefill
    cache_d = {n: c.full_tensor() for n, c in cache.items()}
    specs = {n: Spec(tuple(c.shape), c.dtype) for n, c in cache_d.items()}
    built_d = S.make_lm_decode(cfg, mesh, arch, {"token": Spec((B, 1),
                                                               torch.int32),
                                                 "cache": specs})
    tok = want[:, -1].argmax(-1)[:, None].int()
    params_d, _, cache_dd, _ = built_d.distribute(tree, tok, cache_d, 0)
    t_spec = sh.batch_pspecs(tok, mesh)
    times, least = [], 1.0
    for step in range(P14_DECODE):
        from torch.distributed.tensor import distribute_tensor
        tok_d = distribute_tensor(tok, mesh, sh.placements(t_spec, mesh),
                                  src_data_rank=None)
        t0 = time.perf_counter()
        got, _ = p14_counted(out, lambda: built_d.fn(params_d, tok_d,
                                                     cache_dd, S_ + step))
        times.append(time.perf_counter() - t0)
        got = got.full_tensor()
        ref, _ = transformer.decode_step(model, cfg, tok, cache_ref, S_ + step)
        least = min(least, row_cosine(got[:, -1], ref[:, -1]))
        tok = got[:, -1].argmax(-1)[:, None].int()
    out["p50_ms"]["decode step"] = percentile(times, 50) * 1e3
    log(f"  decode: {P14_DECODE} steps, p50 {out['p50_ms']['decode step']:.2f}"
        f" ms a step")
    lm_gate("sharded decode against decode_step", least, P14_COS_DECODE)
    out["decode_cosine"] = least
    del logits, cache, cache_d, cache_dd, cache_ref, args, params_d, want

    # ---- train_4k, cut: the sharded step against the single-process one
    Bt, St = P14_TRAIN
    batches = [{"tokens": t, "labels": t} for t in (
        torch.randint(0, cfg.vocab_size, (Bt, St), generator=gen,
                      device=device) for _ in range(P14_TRAIN_STEPS))]
    opt = adamw_init(tree)
    opt["step"] = torch.tensor(1000, dtype=torch.int32)  # past lr = 0
    opts = {"n_micro": 2, "int8_opt": False, "remat": True}
    grads, loss_ref, _ = gradient_accumulation(
        lambda p, b: transformer.loss_fn(p, cfg, b, remat=True), model,
        batches[0], opts["n_micro"])
    grads, _ = clip_by_global_norm(convert.stack_layers(grads, cfg), 1.0)
    lr = cosine_schedule(opt["step"], base_lr=3e-4, warmup=2000,
                         total=100_000)
    p_ref, o_ref = adamw_update(grads, opt, tree, lr=lr)
    want = {n: t.detach().cpu() for n, t in
            sh.leaves({"params": p_ref, "opt": o_ref}) if n != "opt.step"}
    loss_ref = float(loss_ref)
    del grads, p_ref, o_ref
    torch.cuda.empty_cache()
    inputs = {k: Spec((Bt, St), torch.int32) for k in ("tokens", "labels")}
    # the step donates its state: the single-process result is on the host
    # already, so the card holds one state, written in place
    built_t = S.make_lm_train(cfg, mesh, arch, inputs, opts=opts)
    state, batch = built_t.distribute({"params": tree, "opt": opt}, batches[0])
    ptrs = {n: t.to_local().data_ptr() for n, t in sh.leaves(state)
            if hasattr(t, "to_local")}
    # the phase's peak so far (the single-process step's two states), then
    # the donated step's own
    out["peak_before_train"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    t0 = time.perf_counter()
    new, metrics = p14_counted(out, lambda: built_t.fn(state, batch))
    times.append(time.perf_counter() - t0)
    moved = [n for n, t in sh.leaves(new)
             if n in ptrs and t.to_local().data_ptr() != ptrs[n]]
    if moved or new["params"] is not state["params"]:
        raise AssertionError(f"donated train step left its state: {moved}")
    loss = float(metrics["loss"].full_tensor())
    rel = abs(loss - loss_ref) / abs(loss_ref)
    got = {n: t for n, t in sh.leaves(new) if n != "opt.step"}
    worst, least = p14_leaves_close(got, want, "train step 1")
    step_peak = torch.cuda.max_memory_allocated()
    log(f"  train step 1 (donated: {len(ptrs)} leaves written in place): "
        f"loss {loss:.6f} against {loss_ref:.6f} (rel "
        f"{rel:.3e}, bound {P14_TRAIN_REL}); {len(got)} leaves, worst rel "
        f"{worst:.3e}, least cosine {least:.8f}; the step's peak "
        f"{step_peak / 1e9:.2f} GB")
    if not rel <= P14_TRAIN_REL:
        raise AssertionError(f"train step 1 loss rel {rel}")
    out["train"] = {"loss": loss, "loss_ref": loss_ref, "loss_rel": rel,
                    "leaves": len(got), "worst_rel": worst,
                    "least_cosine": least, "step_peak_gb": step_peak / 1e9}
    del want, got, state, tree, opt, model
    torch.cuda.empty_cache()
    state = new
    for step in range(1, P14_TRAIN_STEPS):
        batch = built_t.distribute(state, batches[step])[1]
        t0 = time.perf_counter()
        state, metrics = p14_counted(out, lambda: built_t.fn(state, batch))
        times.append(time.perf_counter() - t0)
        log(f"  train step {step + 1}: loss "
            f"{float(metrics['loss'].full_tensor()):.6f}")
    out["p50_ms"][f"train step B={Bt} S={St}"] = percentile(times, 50) * 1e3
    log(f"  train: step p50 {percentile(times, 50) * 1e3:.1f} ms over "
        f"{len(times)} steps")
    del state, new
    torch.cuda.empty_cache()


def p14_recsys_gnn(out: dict, seed: int, device, mesh) -> None:
    """sasrec serve_p99, fm retrieval_cand, graphsage full_graph_sm and
    gspmd_flat_search on the mesh."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import convert
    from repro_torch.core import distances as D
    from repro_torch.core.distributed import gspmd_flat_search
    from repro_torch.core.flat import flat_search
    from repro_torch.data import sbm_graph
    from repro_torch.launch import steps as S
    from repro_torch.launch.shapes import Spec, get_cell
    from repro_torch.models import gnn, recsys
    from repro_torch.models.gnn_partitioned import (make_partitioned_loss,
                                                    partition_edges)
    from repro_torch.train import adamw_init
    gen = torch.Generator(device=device).manual_seed(seed + 114)

    def tree_of(model, cfg):
        return convert.stack_layers(
            {n: p.detach() for n, p in model.named_parameters()}, cfg)

    # ---- sasrec serve_p99: the two-level search, topk_distance on the shard
    cfg = get_arch("sasrec").full
    model = recsys_model(cfg, seed, device)
    seq = torch.randint(1, cfg.n_items + 1, (P14_SERVE_B, cfg.seq_len),
                        generator=gen, device=device, dtype=torch.int32)
    built = S.make_recsys_serve(cfg, mesh, "sasrec",
                                {"seq": Spec(tuple(seq.shape), torch.int32)})
    args = built.distribute(tree_of(model, cfg), {"seq": seq})
    s_d, i_d = p14_timed(out, f"sasrec serve B={P14_SERVE_B}",
                         lambda: built.fn(*args))
    ids = i_d.full_tensor()
    with torch.no_grad():
        u = recsys.sasrec_user_vector(model, cfg, seq)
    items = model.item_embed.detach().float()
    N = items.shape[0]
    valid = torch.arange(N, device=device) < cfg.n_items + 1
    fs, fi = flat_search(D.pad_width(items), D.pad_width(u), metric="dot",
                         k=S.SERVE_K, valid=valid)
    tol = topk_tolerance(items, u, False)[:, None]
    got_s = s_d.full_tensor()
    err = float((got_s - fs).abs().max())
    same = ids == fi.long()
    if not (err <= float(tol.max()) and bool(
            (same | ((got_s - fs).abs() <= 2 * tol)).all())):
        raise AssertionError(f"sasrec serve: ids or scores off flat_search "
                             f"(max |ds| {err})")
    log(f"  sasrec serve against flat_search over {N} items: ids agree "
        f"{float(same.float().mean()):.4f} (ties aside), max |ds| {err:.3e}")
    out["serve_topk"] = {"N": N, "d": cfg.embed_dim, "Q": P14_SERVE_B,
                         "k": S.SERVE_K, "items": items, "u": u,
                         "valid": valid, "ids_agree": float(same.float().mean())}
    del args, model

    # ---- fm retrieval_cand
    cfg = get_arch("fm").full
    cell = get_cell("fm", "retrieval_cand")
    model = recsys_model(cfg, seed, device)
    batch = {"sparse_idx": torch.randint(0, cfg.total_vocab, (1, cfg.n_sparse),
                                         generator=gen, device=device,
                                         dtype=torch.int32),
             "dense": torch.randn(1, cfg.n_dense, generator=gen,
                                  device=device),
             "candidates": torch.randn(cell.inputs["candidates"].shape,
                                       generator=gen, device=device)}
    built = S.make_recsys_retrieval(cfg, mesh, "fm", cell.inputs)
    args = built.distribute(tree_of(model, cfg), batch)
    s_d, i_d = p14_timed(out, "fm retrieval 1 x "
                         f"{batch['candidates'].shape[0]}",
                         lambda: built.fn(*args))
    with torch.no_grad():
        q = recsys.fm_user_vector(model, cfg, batch, 0)
        rs, ri = D.topk_scores(q.float() @ batch["candidates"].T, S.SERVE_K)
    if not (torch.equal(i_d.full_tensor(), ri)
            and float((s_d.full_tensor() - rs).abs().max()) <= 1e-4):
        raise AssertionError("fm retrieval: off the single-card top-k")
    log("  fm retrieval: ids equal to the single-card matmul and top-k")
    del args, model, batch

    # ---- graphsage full_graph_sm: one train step, the partitioned loss
    cell = get_cell("graphsage-reddit", "full_graph_sm")
    cfg = cell.cfg
    N, E = cell.inputs["feats"].shape[0], cell.inputs["edges"].shape[1]
    g = sbm_graph(N, cfg.n_classes, cfg.d_in, avg_degree=max(E // N, 1),
                  seed=seed)
    edges = np.zeros((2, E), np.int32)
    edges[:] = N - 1  # pad edges: a self loop on an unlabelled pad node
    n_e = min(E, g["edges"].shape[1])
    edges[:, :n_e] = g["edges"][:, :n_e]
    mask = g["label_mask"].copy()
    mask[-1] = False
    batch = {"feats": torch.tensor(g["feats"], device=device),
             "edges": torch.tensor(edges, device=device),
             "labels": torch.tensor(g["labels"], device=device),
             "label_mask": torch.tensor(mask, device=device)}
    model = gnn.init(cfg, torch.Generator(device=device).manual_seed(seed),
                     device=device, trainable=True)
    tree = tree_of(model, cfg)
    # the losses at the initial parameters first: the train step donates
    # its state, and the model's parameters are that state's storages
    loss0, m0 = gnn.node_loss(model, cfg, batch)
    edges_p, ev, _ = partition_edges(edges, N, 1)
    loss_fn = make_partitioned_loss(cfg, mesh, ("data",), N)
    loss1, m1 = p14_counted(out, lambda: loss_fn(model, dict(
        batch, edges=torch.tensor(edges_p, device=device),
        edge_valid=torch.tensor(ev, device=device))))
    built = S.make_gnn_train(cfg, mesh, "graphsage-reddit", cell)
    args = built.distribute({"params": tree, "opt": adamw_init(tree)}, batch)
    new, metrics = p14_timed(out, f"graphsage train N={N} E={E}",
                             lambda: built.fn(*args), reps=1)
    loss_s = float(metrics["loss"].full_tensor())
    d_loss = abs(float(loss1.detach()) - float(loss0.detach()))
    d_acc = abs(float(m1["acc"].detach()) - float(m0["acc"].detach()))
    log(f"  graphsage: make_gnn_train loss {loss_s:.6f}, node_loss "
        f"{float(loss0):.6f}, partitioned {float(loss1):.6f} (|d| "
        f"{d_loss:.2e}, bound 1e-4), acc |d| {d_acc:.2e} (bound 1e-6)")
    if not (d_loss <= 1e-4 and d_acc <= 1e-6
            and abs(loss_s - float(loss0)) <= 1e-4):
        raise AssertionError("graphsage: partitioned loss off node_loss")
    out["gnn"] = {"loss_step": loss_s, "node_loss": float(loss0),
                  "partitioned": float(loss1), "acc_diff": d_acc}
    del args, new, model

    # ---- gspmd_flat_search over 1,000,000 x 768 at Q = 32
    n, d, Q, k = P14_GSPMD
    corpus = torch.randn(n, d, generator=gen, device=device)
    q = torch.randn(Q, d, generator=gen, device=device)
    s_d, i_d = p14_timed(out, f"gspmd_flat_search N={n} d={d} Q={Q}",
                         lambda: gspmd_flat_search(corpus, q, mesh=mesh,
                                                   k=k, metric="dot"))
    fs, fi = flat_search(corpus, q, metric="dot", k=k)
    got_s, ids = s_d.full_tensor(), i_d.full_tensor()
    tol = topk_tolerance(corpus, q, False)[:, None]
    same = ids == fi.long()
    if not bool(((got_s - fs).abs() <= tol).all() and
                (same | ((got_s - fs).abs() <= 2 * tol)).all()):
        raise AssertionError("gspmd_flat_search off flat_search")
    log(f"  gspmd_flat_search against flat_search: ids agree "
        f"{float(same.float().mean()):.4f}, max |ds| "
        f"{float((got_s - fs).abs().max()):.3e}")
    del corpus


def phase_launch(seed: int, device, backend: str = "nccl") -> dict:
    """Phase 14: the launch layer's programs on a one-rank world. Returns
    {"launches": the main path's, "collectives", "p50_ms", and the
    kernels' entries at the phase's shapes}."""
    import torch
    import torch.distributed as dist
    log(f"phase 14: launch/ on torch.distributed, one rank over {backend}, "
        "a (1, 1) (data, model) mesh; each cell's program from "
        "launch.steps on DTensors")
    out = {"launches": {}, "collectives": {}, "p50_ms": {}}
    torch.cuda.reset_peak_memory_stats()
    mesh = p14_world(backend)
    try:
        p14_lm(out, seed, device, mesh)
        p14_recsys_gnn(out, seed, device, mesh)
    finally:
        dist.destroy_process_group()
    n = out["launches"]
    peak = max(torch.cuda.max_memory_allocated(),
               out.get("peak_before_train", 0))
    log(f"  launches on the phase's path: flash_attention "
        f"{n.get('flash_attention', 0)}, topk_distance "
        f"{n.get('topk_distance', 0)}; collectives {out['collectives']}; "
        f"peak {peak / 1e9:.2f} GB")
    for name in ("flash_attention", "topk_distance"):
        if not n.get(name):
            raise AssertionError(f"phase 14: {name} never launched")
    # the kernels at the phase's shapes, against their plain versions
    from repro_torch.configs import get_arch
    from repro_torch.kernels.topk_distance import (topk_distance_cuda,
                                                   topk_distance_plain)
    from repro_torch.core import distances as D
    cfg = get_arch("h2o-danube-1.8b").full
    gen = torch.Generator(device=device).manual_seed(seed + 140)
    B, S_ = P14_PREFILL
    out["flash"] = lm_flash(gen, B, S_, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.window, device,
                            "phase 14 prefill")
    st = out.pop("serve_topk")
    items, u, valid = D.pad_width(st["items"]), D.pad_width(st["u"]), st["valid"]
    err = compare_topk(items, u, "dot", st["k"], "phase 14 sasrec serve "
                       "topk_distance against plain", valid=valid)
    bias = torch.where(valid, 0.0, -1e30).float()
    ms = gpu_ms(lambda: topk_distance_cuda(items, u, bias, k=st["k"],
                                           l2=False), 5)
    plain_ms = gpu_ms(lambda: topk_distance_plain(items, u, bias, k=st["k"],
                                                  l2=False), 1)
    lib_ms = gpu_ms(lambda: library_topk(items, u, st["k"]), 2)
    b = topk_bound(st["N"], st["d"], st["Q"], st["k"], False)
    log(f"  topk_distance at sasrec serve N={st['N']} d={st['d']} (padded "
        f"{items.shape[1]}) Q={st['Q']} k={st['k']}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, torch.matmul+torch.topk {lib_ms:.3f} ms, "
        f"bound {b[0]:.3f} ms ({b[1]})")
    out["topk"] = {"shape": f"sasrec serve N={st['N']} d={st['d']} "
                            f"Q={st['Q']} k={st['k']}",
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b[0], "bound_by": b[1], "max_abs_err": err}
    out["peak_gb"] = max(torch.cuda.max_memory_allocated(),
                         out.get("peak_before_train", 0)) / 1e9
    return out


ALL_PHASES = tuple(range(3, 15))


def parse_phases(text) -> tuple:
    """"4,12-13" -> (4, 12, 13): the phases after the header and the build
    (1 and 2 always run); None -> every phase. Phase 7 runs inside phase
    6, so either selects both."""
    if text is None:
        return ALL_PHASES
    chosen = set()
    for part in text.split(","):
        a, _, b = part.strip().partition("-")
        lo, hi = int(a), int(b or a)
        chosen.update(range(lo, hi + 1))
    chosen -= {1, 2}
    if chosen & {6, 7}:
        chosen |= {6, 7}
    bad = chosen - set(ALL_PHASES)
    if bad:
        raise SystemExit(f"chip_smoke: no phase {sorted(bad)}; phases are "
                         f"1-14")
    return tuple(sorted(chosen))


def timed_phase(label: str, fn):
    t0 = time.perf_counter()
    result = fn()
    log(f"[{label}: {time.perf_counter() - t0:.1f} s]")
    return result


def add_launches(kernels, name: str, n: int, key: str, extra=None) -> None:
    """Add a later phase's launches of ``name`` to its kernels-line entry."""
    for entry in kernels:
        if entry["name"] == name:
            entry["launches"] += n
            entry[key] = dict(extra or {}, launches=n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Phases 1 (header) and 2 (build) always run. Each selected "
               "phase makes its own data from --seed, so any subset runs "
               "alone; phase 7 runs inside phase 6 (selecting either runs "
               "both), and the kernels line holds the entries of the "
               "phases that ran (phases 4 and 5 make rows 1-7; phase 13 "
               "alone makes topk_distance's from its own shapes).")
    ap.add_argument("--n", type=int, default=MARCO_PASSAGES,
                    help="corpus rows of the main phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=8,
                    help="rank of the subspace the centres share; 0 gives "
                         "unit centres plus isotropic noise")
    ap.add_argument("--min-recall", type=float, default=0.5,
                    help="fail below this recall@10 of ivf_pq, lsh, ivf or "
                         "int8 against flat (pq's and graph's are printed, "
                         "not gated), and of ivf_pq filtered in the buckets "
                         "above 10 %%")
    ap.add_argument("--snapshot-dir", default=None,
                    help="where phases 7 and 10 write their snapshots and "
                         "checkpoints (a directory of their own inside, "
                         "removed after); the system's temporary directory "
                         "by default")
    ap.add_argument("--phases", default=None,
                    help="the phases to run after 1 and 2, as a list such "
                         "as 4,12-13; every phase (3-14) by default")
    args = ap.parse_args(argv)
    phases = parse_phases(args.phases)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    deterministic_cublas()  # before the first cuBLAS handle (phase 10)
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tempfile
    snap_root = args.snapshot_dir or tempfile.gettempdir()

    t_start = time.perf_counter()
    smi, rates = phase_header()
    log(f"phases: 1, 2, {', '.join(str(p) for p in phases)}")
    timed_phase("phase 2", phase_build)
    kernels, recalls = [], {"ivf_pq": float("nan")}
    if 3 in phases:
        timed_phase("phase 3", lambda: phase_mid(args.seed, device,
                                                 args.rank))
    if 4 in phases:
        kernels, recalls = timed_phase("phase 4", lambda: phase_main(
            args.n, args.seed, device, args.rank, args.min_recall, rates))
    if 5 in phases:
        kernels.append(timed_phase("phase 5", lambda: phase_text(
            args.seed, device)))
    if 6 in phases:
        mutated, durable = timed_phase("phases 6 and 7", lambda: phase_mutation(
            args.n, args.seed, device, args.rank, rates, args.min_recall,
            recalls["ivf_pq"], snap_root))
        for entry in kernels:
            if entry["name"] in mutated:
                entry["mutation_phase"] = mutated[entry["name"]]
            entry["durability_phase"] = {"launches": durable.get(
                entry["name"], 0)}
    if 8 in phases:
        engines = phase_engines(args.n, args.seed, device, args.rank,
                                args.min_recall)
        add_launches(kernels, "topk_distance", engines["launches"],
                     "engines_phase", engines)
    if 9 in phases:
        mesh = phase_mesh(args.n, args.seed, device, args.rank, rates)
        for name in P9_KERNELS:
            add_launches(kernels, name, mesh["launches"].get(name, 0),
                         "mesh_phase")
        log("phase 9 summary: " + json.dumps(
            {k: v for k, v in mesh.items() if k != "launches"}, default=str))
    if 10 in phases:
        train = phase_train(args.seed, device, snap_root)
        for name, n_p10 in train["launches"].items():
            add_launches(kernels, name, n_p10, "train_phase")
        log("phase 10 summary: " + json.dumps(
            {k: v for k, v in train.items() if k != "launches"}, default=str))
    if 11 in phases:
        lm = timed_phase("phase 11", lambda: phase_lm(args.seed, device))
        for entry in kernels:
            if entry["name"] == "flash_attention":
                entry["launches"] += lm["launches"]
                shapes = [m["flash"] for m in lm["models"].values()]
                entry["max_abs_err"] = max([entry["max_abs_err"]]
                                           + [f["max_abs_err"] for f in shapes])
                entry["lm_phase"] = {"launches": lm["launches"],
                                     "shapes": shapes}
        log("phase 11 summary: " + json.dumps(lm["models"], default=str))
    if 12 in phases:
        lm_train = timed_phase("phase 12", lambda: phase_lm_train(
            args.seed, device))
        log("phase 12 summary: " + json.dumps(lm_train, default=str))
    if 13 in phases:
        rec = timed_phase("phase 13", lambda: phase_recsys_gnn(args.seed,
                                                               device))
        n13 = rec["launches"].get("topk_distance", 0)
        shapes = {f"{kind} Q={Q}": r for kind, by_q in rec["retrieval"].items()
                  for Q, r in by_q.items()}
        if not any(e["name"] == "topk_distance" for e in kernels):
            r = shapes[f"fm Q={max(RETRIEVAL_QS)}"]
            kernels.append(kernel_entry(
                "topk_distance", "src/repro_torch/csrc/topk_distance.cu",
                "src/repro/kernels/topk_distance.py:77", 0, r["max_abs_err"],
                r["ms"], r["plain_ms"], (r["bound_ms"], r["bound_by"]),
                r["library_ms"], f"fm retrieval N={r['N']} d={r['d']} (scan width "
                f"{r['d_scan']}) Q={max(RETRIEVAL_QS)}"))
        add_launches(kernels, "topk_distance", n13, "recsys_phase",
                     {"shapes": shapes})
        log("phase 13 summary: " + json.dumps(
            {k: v for k, v in rec.items() if k != "launches"}, default=str))
    if 14 in phases:
        launch = timed_phase("phase 14", lambda: phase_launch(args.seed,
                                                             device))
        for name, key in (("flash_attention", "flash"),
                          ("topk_distance", "topk")):
            r = launch[key]
            if not any(e["name"] == name for e in kernels):
                src = {"flash_attention": ("flash_attention.cu",
                                           "flash_attention.py:70"),
                       "topk_distance": ("topk_distance.cu",
                                         "topk_distance.py:77")}[name]
                kernels.append(kernel_entry(
                    name, f"src/repro_torch/csrc/{src[0]}",
                    f"src/repro/kernels/{src[1]}", 0, r["max_abs_err"],
                    r["ms"], r["plain_ms"], (r["bound_ms"], r["bound_by"]),
                    r["library_ms"], r["shape"]))
            add_launches(kernels, name, launch["launches"].get(name, 0),
                         "launch_phase", {"shape": r["shape"]})
        log("phase 14 summary: " + json.dumps(
            {k: v for k, v in launch.items() if k not in ("flash", "topk")},
            default=str))
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    if leaked:
        raise AssertionError(f"imported the JAX side: {leaked[:5]}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
