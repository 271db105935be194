#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's four query paths — one index over one table
(``Index.lookup(table, queries, backend="kernel")``, and the interval
backends ``"xla"`` and ``"bbs"``), one spec over a tier of tables
(``tune.build_many(...)`` then ``BatchedIndexes.lookup(queries,
backend="kernel")``, one batched launch for every table), and a sharded
tier of one table (``dist.ShardedIndex.build(...)`` then
``dist.sharded_lookup(sidx, queries, backend="kernel")``: route, one
batched launch for every shard, rebase), and the same tier one shard a
rank (``sharded_lookup(sidx, queries, ctx, mode="a2a"/"allgather")`` on
``torch.distributed``: one single-table launch a rank) — and holds every CUDA search
kernel on them against its plain PyTorch twin and against
``torch.searchsorted``, bit for bit (predecessor ranks are integers: the
tolerance is zero).  It drives the updatable GAPPED kind's write path
(``Index.insert_batch``/``compact``, ``insert_into_shard``/``compact_shard``)
on the same tables, tensor ops with no kernel, and the device fits
(``build_many(fit="vmap"/"fast"/"auto")``, ``build_grid``,
``tune.device_refresh``) on the hand-written ``corridor_scan`` kernels, the
tuner, and the serving layer's hot-key cache (in front of an SY-RMI tier
on the batched kernel) and paged KV pool.  Then it serves qwen2-0.5b and
the MoE moonshot-v1-16b-a3b at full width through ``DecodeEngine`` (the
LM serving path, whose attention is the hand-written ``decode_attention``
kernel; moonshot's ticks drive the hot-key cache's tier), runs the
remaining serving cells of ``launch.steps`` (qwen2-0.5b's prefill; DIN,
wide & deep and SASRec scoring and retrieval) and the learned-keyed
embedding (raw ids to rows through ``rmi_search`` and
``batched_rmi_search``), and drives ``ops.embedding_bag``, holding both
float kernels against their twins within the tolerances stated below.
Last it trains: qwen2-0.5b and three recsys models at published widths
through ``launch.steps``' ``train`` cells and ``train.loop`` (no kernel
of the port lies on the training path), a checkpoint round trip, and the
token pipeline's learned lookup; then trains over gloo ranks on the card
(data-parallel, the recsys exchanges under autograd, the edge-sharded
DimeNet, the elastic restore) and holds the dry run against the card.

Phases (any failure ends the run with a non-zero exit):

1. device    — name, count, ``nvidia-smi`` name and power limit;
2. build     — ``nvcc`` builds ``libkernels.so`` from ``src/repro_torch/csrc``
               (one process per source, in parallel) and prints each
               kernel's ``-Xptxas -v`` registers, shared memory and spills;
3. parity    — the five test table shapes and the pinned clustered table
               at n = 65,536 with the edge query mix, all 10 kinds:
               kernel == twin on the card == ``"xla"`` == ``"bbs"`` ==
               ``"ref"``; then the batched path for every kind on two
               same-length batches of 3 of those tables and on a ragged
               batch (65,536 / 30,000 / 50,000 keys): batched kernel ==
               batched twin == ``"xla"`` == ``"bbs"`` == ``"ref"`` ==
               per-row numpy ``searchsorted``; GAPPED on every table and
               batch: ``"xla"`` == ``"bbs"`` == ``"ref"`` == numpy, and
               ``"kernel"`` refused;
4. full size — ``amzn64`` and ``osm`` at the L4 tier (2^24 keys, larger
               than the 50 MB L2) with 2^22 queries sampled from the table;
               all 10 kinds built with the registry defaults on amzn64,
               SY-RMI and RS on osm (``REPEAT_KINDS``); launch counts
               of the single-table path, bit-exactness, kernel / lookup /
               twin / ``torch.searchsorted`` times (CUDA events), the bound
               and probes a query; for the model-free kinds the trips from
               the shared-memory tree (T), the global trips and the sweep
               (W), for PGM/PGM_M the levels, their segments and the trip
               cap, for RS the knot and table trips a query (mean, max);
               then the interval backends on the same builds:
               ``"xla"`` and ``"bbs"`` == the kernel's ranks == ``"ref"``
               == numpy, every window of ``Index.intervals`` holds its
               rank, the reduction factor, and ``lookup_ms`` of each
               backend (CUDA events);
5. tier      — the same two tables, each split into 4 contiguous shards of
               2^22 keys (the tier layout), 2^20 queries sampled from each
               shard: all 10 kinds through ``build_many`` and one batched
               lookup each; launch counts of the batched path (one per
               tier and kind), bit-exactness against the batched twin and
               batched ``torch.searchsorted``, ``unstack()`` against
               a fresh build of the first shard, times, bounds
               and the phase-4 plan lines;
               and a locality probe:
               the single-table model-free kernel over the whole table
               with the tier's queries in shard order and shuffled;
5b. sharded  — ``ShardedIndex`` / ``sharded_lookup``: parity of all 10
               kinds on a 4-shard tier (65,536 keys) and a 160-shard tier
               (16,384 keys: the router's k-ary branch), with the edge
               query mix and every fence key ± 1, every backend ==
               ``Index.lookup`` on the whole table == numpy (GAPPED on its
               three backends); then at
               phase 5's scale (4 shards of 2^22 keys) with phase 4's
               2^22 queries over the whole table, SY-RMI, PGM_M, RS and
               KO on amzn64 (osm's repeat is cut), ``backend="kernel"``: one batched
               launch a call (counted), exact against
               ``torch.searchsorted``; the batched kernel on the tier's own
               ``(4, 2^22)`` operands (every query to every shard, three in
               four outside it) == batched twin == each padded shard's
               ``searchsorted``, before the clamp and the owner select; the
               stacked leaves equal to phase 5's ``build_many`` on the same
               shards; ``lookup_ms`` beside ``BatchedIndexes.lookup`` on
               those shards and the router alone (CUDA events); and the
               router's k-ary branch (160 fences) on the 2^22 queries,
               against ``searchsorted`` and timed;
5c. collective — phase 5b's scale tiers saved (``ShardedIndex.save``), then
               4 ranks spawned on the one card in one gloo group (one rank
               a card over NCCL where there are 4 cards), each loading its
               own shard: ``sharded_lookup(ctx, mode="a2a",
               cap_factor=4.0)`` and ``mode="allgather"`` on phase 4's 2^22
               queries, ``backend="kernel"`` (the single-table kernels'
               launches counted per mode) == phase 5b's ``mode="ref"`` ==
               numpy; each rank's single-table kernel == twin == the
               padded shard's ``searchsorted`` on the exact requests it
               received, fill rows included; per rank and tier the a2a
               stages (route, bucket, both exchanges, local answer,
               unbucket, gather) and both whole calls, by CUDA events
               between barriers; a skewed batch (2^22 - 1 queries on the
               last shard, ``cap_factor=2.0``) whose ``DROPPED`` set equals
               the host model of the exchange; every kind and backend on
               2 and 4 ranks at the parity size (GAPPED mutated first:
               routed inserts in every shard, shard 0's delta populated);
               ``refresh_shard`` then ``rebalance_shards``, each followed
               by an a2a lookup == numpy;
5d. mutation — GAPPED at the registry's default spec on every second key of
               phase 4's tables (2^23 keys, 128 MiB of leaves), insert
               batches of 2^10, 2^12, 2^14 and 2^16 of the held-back keys
               (an eighth of each duplicates), one batch packed into one
               leaf (more keys than its gaps: all to the delta), then
               ``compact``: after every step ``"xla"`` == ``"bbs"`` ==
               ``"ref"`` == numpy over the live keys on phase 4's queries
               plus the inserted keys, each ``InsertReport`` against the host
               model, ``"kernel"`` refused, no kernel launched; insert,
               compact and lookup ms by CUDA events.  Then a GAPPED tier of
               each table (4 shards of 2^22 keys): 2^16 fresh keys routed by
               ``route_owners`` into ``insert_into_shard``, ``compact_shard``
               on every shard, ``sharded_lookup(mode="ref", backend="xla")``
               == numpy, and the counts, offsets, fences and last keys equal
               to a tier built on the live keys;
5e. fits     — the device fits on phase 5's amzn64 tier (4 shards of
               2^22 keys; osm's repeat is cut): ``build_many(fit="vmap")``
               of RMI, SY-RMI, PGM, PGM_M and RS (PGM, PGM_M, RS leaves == phase 5's
               ``fit="host"`` leaves bit for bit, one ``corridor_scan``
               launch a batch; RMI/SY-RMI ``leaf_r`` == host, every key in
               its window), ``fit="fast"`` of PGM, PGM_M and RS (segments and
               knots beside the host's, the ``ok`` flags, the members that
               fell back), ``fit="auto"`` of L and PGM on amzn64's tier
               (== host, == vmap), each result's batched kernel ==
               ``torch.searchsorted``; ``build_grid`` on amzn64's shard 0
               (RMI/SY-RMI at SY-RMI's b x every root, PGM eps 16-128, RS eps
               16/32: spec order, one corridor launch a scan kind, PGM/RS
               leaves == host, ranks exact on each entry's kernel);
               ``device_refresh`` of a PGM tier of amzn64 and an RS tier of
               osm (shard 1 built without 2^16 of its keys, then refreshed
               with them), ``fit="fast"`` and ``"scan"``, under
               ``torch.cuda.set_sync_debug_mode("error")`` after the merged
               row's copy (no host sync), ``"scan"`` == the host refresh bit
               for bit, ``sharded_lookup(backend="kernel")`` == numpy, and a
               row crossing the next fence refused with the tier
               bit-identical; build seconds by fit (host: phase 5's),
               refresh ms, and the corridor kernels' ms (CUDA events) against
               their twins at eps 64: the blocked form at the fast fit's
               shape, the exact form (chunks of ``EXACT_CHUNK``) over the
               whole rows, also == the one-thread oracle (``corridor_scan``
               with ``chunk = length``, timed once);
5f. tuner    — the paper's tuning procedure on the search kernels (the
               reference's ``tune.pareto``, ``tune.mining``, ``tune.rebuild``):
               ``tune.sweep`` of ``candidate_grid`` on every other key of
               phase 4's amzn64 table (2^23 keys: cut from 2^24 for the
               run's time; 2^22 queries, ``fit="auto"``, ``kernel``; 24
               candidates, every one exact), each candidate's space and ns a
               query beside ``torch.searchsorted``'s, the strictly monotone
               frontier, the picks at 0.05/0.7/2/10% within budget and the
               report's round trip; ``mine_sy_rmi`` over amzn64 (UB,
               vote, winner; osm's repeat is cut) and the mined 2% SY-RMI
               exact on amzn64 on ``kernel`` and ``xla`` (osm's check is cut
               for phase 10's time; a cubic winner's kernel misses are logged: ROADMAP
               queue 3); a ``TunedTier`` lifecycle on amzn64 in 4 shards
               (every 64th key held out): a PGM refresh through the device
               arm, an SY-RMI refresh through the host arm, what telemetry
               costs (``sharded_lookup`` on and off, ``timed_lookup``'s
               phases, search launches equal), a retune over SY-RMI
               within 2%, a rebalance under 90% skew, GAPPED inserts, a
               cluster into the delta and a compaction; after every step
               the ranks == numpy and ``metrics()`` == a host model; the
               registry written to ``build/obs_5f.jsonl`` and dumped with
               ``python -m repro_torch.obs dump``;
5g. hotcache — ``HotKeyCache(tier, capacity=4096)`` on the card: a 4-shard
               SY-RMI ``TunedTier`` (registry default, ``kernel``) of phase
               4's amzn64 table with every 64th key held out; the
               concentrated-Zipf traffic of ``benchmarks/serve_slo.py``'s cache
               A/B leg (a 1.15, a 2,048-rank hot span, 3 phases that shift
               it) at 3 batches a phase of 2^16 queries, the same batches
               cache-off (the bare tier) and cache-on (primed per phase as
               ``serve_slo.py`` does), every batch == ``torch.searchsorted``;
               hits, misses, rebuilds, ms a batch (host clock, CUDA
               events); then 2^16 held-out keys of shard 1 inserted (a shard
               refresh): ``hotcache_stale`` counts, the rebuild follows, the
               answers stay exact;
5h. paged    — ``PagedPool`` with its store on the card: 8 sequences of
               32,768 positions in pages of 16, grown in turns;
               ``position_lookup`` of every position (the PGM over the page
               starts) == ``pos // 16`` arithmetic, before and after a
               release and a re-allocation; ``MemoryError`` when exhausted;
6. float parity — ``decode_attention`` in f32 and bf16 over (Hq, Hkv, D) in
               (4,4,16), (8,2,32), (16,1,64), (14,2,64), (32,8,128),
               (16,16,128), (4,4,256), (8,8,8), ragged ``kv_len`` with 0, 1 and S, S not
               a tile multiple, and the split's edges (shares cut at a
               tile - 1, + 0, + 1, rows shorter than ``n_split`` tiles,
               lengths past S, at the planned split and at 1, 2, 5 and 16
               shares, forced through ``split_plan``); and
               ``embedding_bag`` at D 3 to 256 (the float4 and the scalar
               path), sorted and unsorted bags, ids and bags out of range,
               ``weights=None`` and a table at a one-float offset (not
               16-byte aligned): kernel against twin on the card
               (tolerances in ``ATT_TOL``/``BAG_TOL``);
7. serve     — qwen2-0.5b at full width (24 layers, d 896, 14/2 heads, random
               weights from a seeded generator, bf16 compute) in a
               ``DecodeEngine`` of 8 slots and a 32,768-position cache: 16
               requests of 3-10 prompt tokens, and one of 700 queued first
               (the first ticks attend over ~716 positions), 16 new tokens
               each.  Every request must finish with 16 tokens and finite
               logits; ``decode_attention`` must launch n_layers x (prefill
               steps + ticks) times; the first 4 decode ticks are re-run
               from the same cache with ``backend="ref"``
               (``SERVE_ATOL``/``SERVE_RTOL``); ms a tick, tokens/s, and
               the kernel's share of a step at the last and the first
               ticks' positions (CUDA events);
7b. moe      — moonshot-v1-16b-a3b at its published widths and all 48
               layers (64 experts top 6 + 2 shared, 16/16 heads of 128),
               bf16 weights drawn on the card a layer at a time, in a
               ``DecodeEngine`` of 8 slots x 2,048 positions whose ``tier``
               is phase 5g's hot-key cache: 8 requests of 3-10 prompt
               tokens, 16 new tokens each; every request finishes, logits
               finite, ``decode_attention`` launched n_layers x steps at
               group 1; the first 4 ticks re-run in place with
               ``backend="ref"`` on the experts the kernel pass routed to
               (``SERVE_ATOL``/``SERVE_RTOL``), and once more routing on
               their own (swaps and error logged as a diagnostic); ms a
               tick, tokens/s, a step's ms beside its byte bound for the
               experts it routed to (and for all 64, what the capacity
               dispatch reads), attention's and one layer's
               ``moe_ffn`` share of a step, the kernel at the path's shape;
7c. prefill  — qwen2-0.5b's ``prefill_32k`` cell at its published widths
               (bf16), 1 sequence (cut from 32) of 32,768 tokens from
               ``make_inputs``: ``build_step``'s ``forward`` and the last
               position's logits (finite), ms by CUDA events and tokens/s;
               first, at 256 tokens, those logits against a ``decode_step``
               chain over the same tokens (the ``decode_attention`` kernel)
               within ``SERVE_ATOL``/``SERVE_RTOL``; one layer's plain
               ``causal_attention`` at the cell's shape beside
               ``scaled_dot_product_attention(is_causal=True)`` (library
               figure, unused);
7d. recsys   — DIN, wide & deep and SASRec at published widths (f32, seeded
               weights) on ``serve_p99``, ``serve_bulk`` and
               ``retrieval_cand`` (``make_inputs``, seed 0): finite; the
               card == the CPU on the same weights (all of ``serve_p99``, the
               first 4,096 rows or candidates of the others; ``RECSYS_TOL``);
               retrieval's first 1,024 candidates == ``score_fn`` on the same
               pairs for SASRec and wide & deep (DIN's gap logged: ROADMAP
               queue 3); ms a batch, rows/s (CUDA events), peak memory;
               DLRM-MLPerf's 96.1 GB table waits for four cards;
7e. lke      — ``LearnedKeyedEmbedding`` over DIN's 10,000,000-item
               vocabulary as seeded raw 64-bit ids, dim 18, 2^22 ids a batch
               (three quarters present): ``lookup(backend="kernel")`` on one
               index (one ``rmi_search`` launch) and a 4-shard tier (one
               ``batched_rmi_search`` launch), counted as the ``lke`` path;
               ranks == ``"ref"`` == numpy ``searchsorted``, each vector its
               row (OOV where absent), the kernel == its twin on the path's
               operands; build s, ``translate``/``lookup`` ms (CUDA events);
               then wide & deep's mega-table over 4 gloo ranks on the card
               (``flat_dp``, a row shard a rank): ``sharded_lookup`` of
               ``serve_p99``'s ids in ``"a2a"`` at 4.0 and ``"allreduce"`` ==
               the one-rank gather, at 2.0 (and on a skewed batch) zeros
               exactly on the host model's drop set, ``score_fn`` on the
               shards == one rank (drops zeroed for ``"a2a"``);
8. kernel times — ``decode_attention`` at qwen2's ``decode_32k`` cell and at
               ``benchmarks/kernel_roofline.py``'s shape, ``ops.embedding_bag``
               (its path) at that benchmark's shape and on a 2 GiB table:
               kernel / twin / library call times (the kernel's and the
               library's also replayed from a CUDA graph, without the
               host's enqueue, and the host's microseconds to enqueue a
               call), bounds, and the twin check;
               ``decode_attention``'s split plan (kernel, tile, n_split,
               stages, threads) and its time at other splits (forced
               through ``split_plan``); ``return_lse=True`` at
               ``decode_32k`` (row 0 at ``kv_len = 0``): ``(out, lse)`` ==
               the twin within ``ATT_TOL[f32]`` on the whole cache and on
               2 and 4 sequence blocks, the blocks combined on the card ==
               the one call within ``ATT_TOL[bf16]``, its time with and
               without the lse beside its bound (PERF.md row 10c); and the
               ``-Xptxas -v`` registers of ``decode_attention``,
               ``rmi_search``, ``pgm_search``, ``kary_search``,
               ``rs_search`` and ``embedding_bag``;
9. train     — 9a: qwen2-0.5b's ``train_4k`` cell at published widths (24
               layers, d 896, vocab 151,936, f32 master weights, bf16
               compute, remat, ``xent_chunk`` 512) through
               ``launch.steps.build_step`` and ``train.loop.run``: 8
               sequences of 4,096 tokens a step (cut from 256) from
               ``TokenBatcher`` over a seeded ``synth_corpus``, 2
               microbatches, AdamW, ``warmup_cosine(warmup=2)``, clip 1.0,
               2 steps; every loss finite, the last below the first; ms a
               step, tokens/s, peak GB, each step's loss and ``grad_norm``,
               6·N·tokens over 989 TFLOP/s beside the step; first, at 2
               layers and 256 tokens in f32, one step on the card == the
               CPU (``TRAIN_RTOL``, ``TRAIN_GRAD_RTOL``); 9b: DIN, wide &
               deep and SASRec's ``train_batch`` (65,536 rows) at published
               widths, 3 AdamW steps on one batch (losses finite and
               falling), one more under int8 gradient compression, card ==
               CPU on the reduced configs; ms a step, rows/s, peak GB; 9c:
               SASRec's train state saved (async), restored onto the card
               bit-equal, the next step's loss == the uninterrupted one's;
               9d: ``synth_corpus`` of 200,000 documents, ``doc_of`` of
               2^22 offsets on the card == ``torch.searchsorted``; 9e:
               DimeNet's ``graph_train`` cells ``full_graph_sm``,
               ``minibatch_lg`` and ``molecule`` at published widths (6
               blocks, d 128, padded triplets), ``ogb_products`` reduced
               (one card cannot hold it), 3 AdamW steps each on a seeded
               batch through ``build_step`` and ``loop.run``, losses finite
               and falling; ms a step, edges/s, peak GB; first, card == CPU
               on the reduced config in both layouts;
10. ranks    — training over gloo ranks on the one card: 10a qwen2-0.5b's
               ``train_4k`` at published widths, data parallel alone over
               2 ranks (whole replicas; 9a's first
               batch, 4 sequences and one microbatch a rank): the ranks'
               states bit-equal, == 9a's one-rank step (deterministic
               algorithms; ``TRAIN_RTOL``/``TRAIN_GRAD_RTOL``), ms a step,
               the gradient all-reduce's ms, tokens/s, peak GB a rank; 10b
               wide & deep's ``train_batch`` over 4 ranks in ``"a2a"``
               (``cap_factor`` 4.0) and ``"allreduce"``: every table shard
               and replicated leaf == one rank, and SASRec's 9c state saved
               over (1, 4) and restored over (4, 1) (``restore(shardings=)``)
               bit-equal; 10c DimeNet's ``minibatch_lg`` at published widths
               with its edges over 2 ranks == one rank (9e's tolerances), ms
               a step, one message all-gather's ms, peak GB a rank; 10d the
               dry runs (``launch.dryrun``, fake tensors) of the 9a cell,
               10a and 9e's ``minibatch_lg``: FLOPs == ``FlopCounterMode`` on
               the card's steps, DimeNet's within 3% of
               ``dimenet_step_flops``; predicted peaks beside the measured;
               10e the LM family placed over a (data 2, model 2) ``tp_fsdp``
               mesh of 4 ranks in one spawn (each rank its blocks, bf16
               compute): 10e-i 10a's qwen2-0.5b and batch, held against
               9a's one-rank step; 10e-ii moonshot-v1-16b-a3b at published
               widths, depth cut to 2 of 48 layers (with AdamW the whole
               depth is 115 GB), 2 x 4,096 tokens, held against a one-rank
               step in one microbatch a dp shard (the same capacity):
               loss, global norm, first moment and (10e-i) parameters
               within ``PLACED_RTOL``/``PLACED_GRAD_RTOL``, ms a step,
               tokens/s, one forward's FSDP gathers and one tp all-reduce
               timed, state bytes and peak GB a rank; 10f decode under the
               same mesh and spawn (each rank its parameter and cache
               blocks, caches filled from seeds a (layer, 1,024-position
               run) at a time, 3 steps at the cache's last positions):
               10f-i qwen2-0.5b's ``decode_32k`` with ``seqm`` on model
               (batch cut from 128 to 32), 10f-ii ``long_500k`` (524,288
               positions) with ``sp`` on the whole mesh, 10f-iii 10e-ii's
               moonshot from its seed-0 parameters, 8 slots x 2,048
               positions, the cache on ``dp`` alone (the kernel on each
               rank's heads), 10f-iv ``DecodeEngine(ctx=...)`` (8 slots x
               512 positions, 8 requests of 8 new tokens, under ``tp`` and
               ``dp`` with the weights held, no ``fsdp``): the ranks'
               logits equal and within ``SERVE_ATOL``/``SERVE_RTOL`` of the
               one-rank steps, their cache blocks against the one-rank
               cache's (``_decode_cache_errors``: later layers within
               ``CACHE_ULPS``, a stale-row control beyond it), the engine's
               tokens equal on every rank, ``decode_attention`` launched
               n_layers x steps on each rank; ms a step, the combine's ms
               a layer, one layer's FSDP gathers, cache and peak GB a rank,
               each part's seconds; in the parent, the kernel on rank 0's
               block beside the one-card call on the whole cache.

The ``corridor_scan`` entry of the kernels line times the fast fit's
blocked launch (its launches count both forms), ``corridor_scan_exact``
the exact form's; their f64 bound takes the H100's 34 TFLOP/s f64 rate,
beside the latency of one chunk's walk.
The last two stdout lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``.  Run with no arguments on a machine
with one CUDA card.  ``--cpu-rehearsal`` runs phases 3 to 10 on the CPU
twins at a tiny size, phases 7-7e, 9 and 10 on the reduced configs (no
device result is printed).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the non-tensor
#: f32 rate, used as the rate of the kernels' scalar integer/float work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SECTOR_BYTES = 32

KINDS = ("L", "Q", "C", "KO", "RMI", "SY-RMI", "PGM", "PGM_M", "RS", "BTREE")
#: the kinds phases 4 and 5 repeat on the tables after the first: SY-RMI
#: (the paper's headline) and RS, the kinds whose osm rows PERF.md's kernel
#: table keeps.  L, Q, C, BTREE and KO search with the model-free kernel at
#: the same probes a query and table sectors on every table; the others
#: are cut for the run's time limit
REPEAT_KINDS = ("SY-RMI", "RS")


def kinds_of_table(i: int) -> tuple:
    """The kinds phases 4 and 5 build on their ``i``-th table."""
    return KINDS if i == 0 else REPEAT_KINDS
#: the updatable kind: no kernel (the reference has no Pallas path for it),
#: so ``backend="kernel"`` raises; it answers on these three backends
GAPPED_BACKENDS = ("xla", "bbs", "ref")
KERNELS = {
    "kary_search": {
        "source": "src/repro_torch/csrc/kary_search.cu",
        "replaces": "src/repro/kernels/kary_search.py:105",
        "kinds": ("L", "Q", "C", "KO", "BTREE"),
        "headline": "KO",
    },
    "rmi_search": {
        "source": "src/repro_torch/csrc/rmi_search.cu",
        "replaces": "src/repro/kernels/rmi_search.py:130",
        "kinds": ("RMI", "SY-RMI"),
        "headline": "SY-RMI",
    },
    "pgm_search": {
        "source": "src/repro_torch/csrc/pgm_search.cu",
        "replaces": "src/repro/kernels/pgm_search.py:175",
        "kinds": ("PGM", "PGM_M"),
        "headline": "PGM_M",
    },
    "rs_search": {
        "source": "src/repro_torch/csrc/rs_search.cu",
        "replaces": "src/repro/kernels/rs_search.py:135",
        "kinds": ("RS",),
        "headline": "RS",
    },
    "batched_kary_search": {
        "source": "src/repro_torch/csrc/kary_search.cu",
        "replaces": "src/repro/kernels/kary_search.py:140",
        "kinds": ("L", "Q", "C", "KO", "BTREE"),
        "headline": "KO",
    },
    "batched_rmi_search": {
        "source": "src/repro_torch/csrc/rmi_search.cu",
        "replaces": "src/repro/kernels/rmi_search.py:233",
        "kinds": ("RMI", "SY-RMI"),
        "headline": "SY-RMI",
    },
    "batched_pgm_search": {
        "source": "src/repro_torch/csrc/pgm_search.cu",
        "replaces": "src/repro/kernels/pgm_search.py:303",
        "kinds": ("PGM", "PGM_M"),
        "headline": "PGM_M",
    },
    "batched_rs_search": {
        "source": "src/repro_torch/csrc/rs_search.cu",
        "replaces": "src/repro/kernels/rs_search.py:263",
        "kinds": ("RS",),
        "headline": "RS",
    },
}
#: the LM serving path's kernels (phases 6-8), each with its main path
SERVE_KERNELS = {
    "decode_attention": {
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:85",
        "path": "DecodeEngine -> decode_step (phase 7: qwen2-0.5b; phase 7b: moonshot MoE); "
                "the placed decode_step and DecodeEngine(ctx=...) on 4 ranks (phase 10f)",
    },
    "embedding_bag": {
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:56",
        "path": "ops.embedding_bag (phase 8)",
    },
}
#: kernel against twin, as (atol, rtol).  f32 attention: sums in another
#: order (2e-5); bf16: both round one f32 result to bf16, so at most one
#: bf16 ulp, 2^-7 of the value (rtol 8e-3), plus f32 noise near 0 (atol
#: 1e-4); the bag's atomics add in a run-dependent order (3e-5, the
#: reference test's tolerance).  ``assert_allclose`` semantics:
#: |a-b| <= atol + rtol|b|.
ATT_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 8e-3)}
BAG_TOL = 3e-5
#: serve logits, kernel path against the reference math (``backend="ref"``,
#: which rounds the attention logits and weights to bf16): a few bf16 ulps
#: at |logit| ~ 4, accumulated over 24 layers
SERVE_ATOL, SERVE_RTOL = 0.25, 0.05
#: the kinds of the sharded tier at phase 5's scale (phase 5b): the
#: headline kind of each batched kernel
SHARDED_KINDS = ("SY-RMI", "PGM_M", "RS", "KO")
SINGLE = tuple(k for k in KERNELS if not k.startswith("batched_"))
BATCHED = tuple(k for k in KERNELS if k.startswith("batched_"))
KERNEL_OF = {k: name for name in SINGLE for k in KERNELS[name]["kinds"]}
BATCHED_KERNEL_OF = {k: name for name in BATCHED for k in KERNELS[name]["kinds"]}


def fail(msg: str):
    raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- inputs ------------------------------------------------------------------


def as_table(keys) -> np.ndarray:
    return np.unique(np.asarray(keys, dtype=np.uint64))


def make_table(rng, kind: str, n: int) -> np.ndarray:
    """The table shapes of ``tests/conftest.py:make_table``."""
    if kind == "uniform":
        return as_table(rng.integers(0, 2**63, size=n, dtype=np.uint64))
    if kind == "lognormal":
        return as_table(np.exp(rng.normal(20, 2, size=n)).astype(np.uint64))
    if kind == "clustered":
        c = rng.integers(0, 2**60, size=max(4, n // 500), dtype=np.uint64)
        return as_table(c[rng.integers(0, len(c), n)] + rng.integers(0, 2**30, n).astype(np.uint64))
    if kind == "bursty":
        g = rng.exponential(100, size=n) * (1 + 50 * (rng.random(n) < 0.01))
        return as_table(np.cumsum(g).astype(np.uint64) + 10**15)
    if kind == "sequential":
        return as_table(np.arange(n, dtype=np.uint64) * 7 + 3)
    raise ValueError(kind)


def clamp_table():
    """The pinned clustered table of ``test_pallas_window_center_clamp_regression``."""
    rng = np.random.default_rng(42)
    centers = rng.integers(0, 2**63, size=8, dtype=np.uint64)
    parts = [c + rng.integers(0, 2**20, size=256, dtype=np.uint64) for c in centers]
    return np.unique(np.concatenate(parts))


def edge_queries(rng, table, n_keys=4096, n_random=4096):
    """Keys, keys ± 1, random u64, 0, min − 1, max + 1, 2^64 − 1."""
    keys = rng.choice(table, n_keys).astype(np.uint64)
    with np.errstate(over="ignore"):
        extremes = np.array(
            [0, table.min() - np.uint64(1), table.min(), table.max(),
             table.max() + np.uint64(1), 2**64 - 1],
            dtype=np.uint64,
        )
    return np.concatenate([
        keys, keys - np.uint64(1), keys + np.uint64(1),
        rng.integers(0, 2**64 - 1, n_random, dtype=np.uint64), extremes,
    ])


# -- measurement -------------------------------------------------------------


def device_ms(fn, dev, reps: int = 20, warmup: int = 3):
    """Mean ms per call over ``reps`` calls, timed with CUDA events after
    ``warmup`` calls; None off the card (a CPU time is no device metric)."""
    if dev.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, dev, reps: int = 200):
    """Mean host microseconds to enqueue one call of ``fn`` (host clock,
    no synchronise inside the timed loop): what a call costs the CPU
    before the card runs it.  None off the card."""
    if dev.type != "cuda":
        return None
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def graph_ms(fn, dev, reps: int = 20):
    """Mean device ms per call of ``fn``, replayed from one CUDA graph of
    ``reps`` calls: the host's enqueue cost (Python, ctypes) drops out,
    which ``device_ms`` includes when a call is shorter than its enqueue.
    None off the card."""
    if dev.type != "cuda":
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def bound(args, table, probes, nq: int) -> dict:
    """Least time the card could take for one kernel call: the larger of
    (bytes it must move) / HBM rate and (scalar operations) / f32 rate.
    Bytes: every non-table operand read once (queries, ``u``, leaves),
    ranks written once (int32), and each distinct 32-byte table sector
    that this run's searches touch (from the twin's probe indices: the
    trips a search takes, and for the k-ary sweep the positions a binary
    search of its window reads, not the sweep's other keys)."""
    operand_bytes = sum(int(a.nbytes) for a in args
                        if torch.is_tensor(a) and a.data_ptr() != table.data_ptr())
    keys_per_sector = SECTOR_BYTES // table.element_size()
    touched = torch.zeros((table.numel() + keys_per_sector - 1) // keys_per_sector, dtype=torch.bool,
                          device=table.device)
    for p in probes:
        touched[(p // keys_per_sector).long()] = True
    sectors = int(touched.sum())
    total_bytes = operand_bytes + nq * 4 + sectors * SECTOR_BYTES
    # per probe: gather, compare, two selects, shift, subtract (~6 ops)
    n_probes = sum(int(p.numel()) for p in probes)
    ops = 6 * n_probes
    t_bytes, t_ops = total_bytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": total_bytes,
        "table_sectors": sectors,
        "probes_per_query": n_probes / max(nq, 1),
    }


# -- phases --------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py needs one GPU")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"[device] {name} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    return {"name": name, "count": count, "nvidia_smi": smi.stdout.strip()}


def phase_build() -> None:
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.library()
    log(f"[build] libkernels.so from {len(cuda_lib.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s ({' '.join(cuda_lib.NVCC_FLAGS)})")
    for src, lines in cuda_lib.ptxas_report().items():
        for ln in lines:
            log(f"[build] {src}: {ln}")


def check_equal(what: str, got: np.ndarray, others) -> None:
    """Fail unless ``got`` equals every ``(name, ranks)`` of ``others``."""
    for other, ranks in others:
        if not np.array_equal(got, ranks):
            bad = np.argwhere(got != ranks)[0]
            fail(f"parity: {what} kernel != {other} at {tuple(bad)}: "
                 f"{got[tuple(bad)]} vs {ranks[tuple(bad)]}")


def batched_answer(bm, queries):
    """Batched twin ranks, the operands and the queries of one batched
    lookup, clamped to the counts as ``BatchedIndexes.lookup`` clamps."""
    from repro_torch import index as tix

    impl = tix.impls.query_impl(bm.kind)
    q = bm.queries_for(queries)
    args, kwargs = impl.batched_operands(bm.index, bm.tables, q)
    return impl, q, args, kwargs


def expect_no_kernel(index, table, queries, what: str) -> None:
    """GAPPED refuses ``backend="kernel"`` (the port's default) with the
    reference's message; ``index`` is an ``Index`` (``table`` given) or a
    ``BatchedIndexes`` (``table`` None)."""
    try:
        if table is None:
            index.lookup(queries, backend="kernel")
        else:
            index.lookup(table, queries)
    except ValueError as e:
        if "supports backends" in str(e):
            return
        raise
    fail(f"{what}: backend='kernel' answered instead of raising")


def phase_parity(dev, n: int) -> None:
    from repro_torch import index as tix
    from repro_torch import tune
    from repro_torch.core import keys

    rng = np.random.default_rng(2024)
    cases = [(k, make_table(rng, k, n)) for k in
             ("uniform", "lognormal", "clustered", "bursty", "sequential")]
    cases.append(("pinned-clamp", clamp_table()))
    for name, table in cases:
        qs_np = edge_queries(rng, table, n_keys=min(4096, len(table)))
        want = np.searchsorted(table, qs_np, side="right").astype(np.int64) - 1
        t, q = keys.encode(table, dev), keys.encode(qs_np, dev)
        for kind in KINDS:
            idx = tix.build(kind, table, device=dev)
            got = idx.lookup(t, q, backend="kernel")
            ref = idx.lookup(t, q, backend="ref")
            impl = tix.impls.query_impl(kind)
            args, kwargs = impl.operands(idx, t, q)
            twin = impl.plain(*args, **kwargs).long()
            interval = [(b, idx.lookup(t, q, backend=b).cpu().numpy()) for b in tix.INTERVAL_BACKENDS]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            check_equal(f"{name}/{kind}", got.cpu().numpy(),
                        (("twin", twin.cpu().numpy()), *interval, ("ref", ref.cpu().numpy()),
                         ("numpy", want)))
        gapped = tix.build("GAPPED", table, device=dev)
        expect_no_kernel(gapped, t, q, f"{name}/GAPPED")
        check_equal(f"{name}/GAPPED xla", gapped.lookup(t, q, backend="xla").cpu().numpy(),
                    [(b, gapped.lookup(t, q, backend=b).cpu().numpy()) for b in GAPPED_BACKENDS[1:]]
                    + [("numpy", want)])
        log(f"[parity] {name} n={len(table)} nq={len(qs_np)}: all {len(KINDS)} kinds "
            f"kernel == twin == xla == bbs == ref; GAPPED xla == bbs == ref, kernel refused")

    # -- the batched path: two same-length batches of the six tables, one ragged --
    tables = [t for _, t in cases]
    same = [min(len(t) for t in tables[:3]), min(len(t) for t in tables[3:])]
    batches = [
        ("same-length " + "/".join(nm for nm, _ in cases[:3]), [t[: same[0]] for t in tables[:3]]),
        ("same-length " + "/".join(nm for nm, _ in cases[3:]), [t[: same[1]] for t in tables[3:]]),
        ("ragged", [make_table(rng, k, m) for k, m in
                    (("uniform", n), ("clustered", n * 30000 // 65536),
                     ("bursty", n * 50000 // 65536))]),
    ]
    for label, batch in batches:
        qs_np = edge_queries(rng, np.concatenate(batch), n_keys=4096)
        want = np.stack([np.searchsorted(t, qs_np, side="right").astype(np.int64) - 1
                         for t in batch])
        for kind in KINDS:
            bm = tune.build_many(kind, batch, device=dev)
            got = bm.lookup(qs_np, backend="kernel")
            ref = bm.lookup(qs_np, backend="ref")
            impl, _, args, kwargs = batched_answer(bm, qs_np)
            twin = torch.minimum(impl.batched_plain(*args, **kwargs).long(), bm.counts[:, None] - 1)
            interval = [(b, bm.lookup(qs_np, backend=b).cpu().numpy()) for b in tix.INTERVAL_BACKENDS]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            check_equal(f"batched {label}/{kind}", got.cpu().numpy(),
                        (("batched twin", twin.cpu().numpy()), *interval,
                         ("ref", ref.cpu().numpy()), ("numpy", want)))
        bm = tune.build_many("GAPPED", batch, device=dev)
        expect_no_kernel(bm, None, qs_np, f"batched {label}/GAPPED")
        check_equal(f"batched {label}/GAPPED xla", bm.lookup(qs_np, backend="xla").cpu().numpy(),
                    [(b, bm.lookup(qs_np, backend=b).cpu().numpy()) for b in GAPPED_BACKENDS[1:]]
                    + [("numpy", want)])
        log(f"[parity] batched {label} ({'/'.join(str(len(t)) for t in batch)} keys, "
            f"nq={len(qs_np)}): all {len(KINDS)} kinds batched kernel == batched twin == xla == "
            f"bbs == ref; GAPPED xla == bbs == ref, kernel refused")


def measure(dev, impl_search, impl_plain, args, kwargs, table, nq, lookup, library) -> dict:
    """Kernel / lookup / twin / library times (CUDA events) and the bound
    of one kernel call on ``args``."""
    probes = []
    impl_plain(*args, **kwargs, probes=probes)
    row = {
        "ms": device_ms(lambda: impl_search(*args, **kwargs), dev),
        "lookup_ms": device_ms(lookup, dev),
        "plain_ms": device_ms(lambda: impl_plain(*args, **kwargs), dev, reps=5, warmup=1),
        "library_ms": device_ms(library, dev),
    }
    row.update(bound(args, table, probes, nq))
    if row["ms"] is not None:
        row["mlookups_per_s"] = nq / (row["ms"] * 1e-3) / 1e6
    return row


def search_plan(kind: str, index, n: int, args=None, kwargs=None) -> dict:
    """How the redesigned kernels split one lookup's work: for the
    model-free kinds the trips served by the staged tree (T), the global
    trips, and the window the sweep reads (at most W keys); for PGM/PGM_M
    the levels, the segments of each (a list a table of a stack) and the
    trip cap; for RS the trips a query makes in its knot search and its
    table search (:func:`rs_trips`)."""
    from repro_torch.kernels import kary_search as kary

    if kind in ("PGM", "PGM_M"):
        sizes = index.arrays["sizes"].reshape(-1, index.s("levels")).cpu().numpy()
        return {"levels": index.s("levels"), "segments": sizes.tolist(), "steps": index.s("pksteps")}
    if kind == "RS":
        return rs_trips(args, kwargs)
    if KERNEL_OF[kind] != "kary_search":
        return {}
    tree, trips, length = kary.search_plan(n)
    return {"tree_levels": tree, "global_trips": trips, "sweep": length, "sweep_width": kary.SWEEP}


def rs_trips(args, kwargs) -> dict:
    """The trips an RS query makes, mean and max over this run's queries,
    in the knot search over its radix bucket and in the table search over
    its window (the twin's arithmetic, whose searches stop at a one-key
    window as the kernel's do), beside the caps ``ksteps`` and
    ``rk_epi``.  ``args`` are single-table or batched operands."""
    from repro_torch.kernels.pgm_search import _bounded_ub_early
    from repro_torch.kernels.rs_search import radix_prefix, rs_search_plain

    batched = args[1].dim() == 2
    rows = ([tuple(a[t] if a.dim() == 2 else a[t:t + 1] for a in args)
             for t in range(args[1].shape[0])] if batched else [args])
    knot, table, nq = [], [], 0
    for row in rows:
        q, _, kmin, shift, _, _, knots, *_, radix, _, _ = row
        p = torch.clamp(radix_prefix(q, kmin, shift, kwargs["r_bits"]), 0, radix.numel() - 2)
        lo = torch.clamp(radix[p] - 1, min=0)
        kp, tp = [], []
        _bounded_ub_early(knots, q, lo, torch.clamp(radix[p + 1] - lo, min=1),
                          steps=kwargs["ksteps"], probes=kp)
        rs_search_plain(*row, **kwargs, probes=tp)
        knot.append(kp[:-1])  # the last entry is every query's final compare
        table.append(tp[:-1])
        nq += q.numel()

    def trips(per_row):
        return {"mean": sum(int(p.numel()) for r in per_row for p in r) / max(nq, 1),
                "max": max(sum(1 for p in r if p.numel()) for r in per_row)}

    return {"knot_trips": trips(knot), "table_trips": trips(table),
            "ksteps": kwargs["ksteps"], "steps": kwargs["steps"]}


def log_row(prefix: str, row: dict) -> None:
    ms = ("not measured" if row["ms"] is None
          else f"{row['ms']:.4f} ms ({row['mlookups_per_s']:.1f} Mlookups/s)")
    log(f"{prefix}: build {row['build_s']:.1f} s, space {row['space_bytes']} B "
        f"({row['space_pct_of_table']:.4f}% of table), exact vs searchsorted, twin equal, "
        f"kernel {ms}, lookup {row['lookup_ms']}, plain {row['plain_ms']}, "
        f"searchsorted {row['library_ms']}, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}; {row['table_sectors']} table sectors, "
        f"{row['probes_per_query']:g} probes/query)")
    plan = row.get("plan") or {}
    if "segments" in plan:
        log(f"{prefix}: {plan['levels']} levels of {plan['segments']} segments, trips capped "
            f"at {plan['steps']}; no level staged in shared memory (PERF.md)")
    elif "knot_trips" in plan:
        k, t = plan["knot_trips"], plan["table_trips"]
        log(f"{prefix}: knot search {k['mean']:.3f} trips a query (max {k['max']}, cap "
            f"{plan['ksteps']}), table search {t['mean']:.3f} (max {t['max']}, cap {plan['steps']})")
    elif plan:
        log(f"{prefix}: T = {plan['tree_levels']} trips from the shared-memory tree, "
            f"{plan['global_trips']} global trips, a sweep of {plan['sweep']} keys "
            f"(W = {plan['sweep_width']})")


def check_launches(launches: dict, kernels_of: dict, kinds_per_table, path: str) -> None:
    """Each kind of the path launched its kernel once a table it was
    built on (``kinds_per_table``: the kinds of each table), and no other
    kernel launched."""
    for name in KERNELS:
        want = sum(1 for kinds in kinds_per_table for k in kinds if kernels_of.get(k) == name)
        if launches[name] != want:
            fail(f"{name} launched {launches[name]} times on the {path} path, expected {want}")


def phase_full(dev, n: int, nq: int, datasets) -> tuple:
    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch.core import keys
    from repro_torch.data import generate, make_queries

    tables = {}
    for ds in datasets:
        t0 = time.perf_counter()
        table = generate(ds, n)
        qs = make_queries(table, nq, seed=1)
        tables[ds] = (table, qs)
        log(f"[full] {ds}: {len(table)} keys ({table.nbytes / 2**20:.0f} MiB), {nq} queries, "
            f"generated in {time.perf_counter() - t0:.1f} s")

    # -- the single-table path: build every kind, answer the queries (counted) --
    kernels.reset_launches()
    built, answers = {}, {}
    for i, (ds, (table, qs)) in enumerate(tables.items()):
        t_dev, q_dev = keys.encode(table, dev), keys.encode(qs, dev)
        # RS first: its greedy spline restarts a chunk at every knot, so its
        # host build time is the one to watch
        for kind in ("RS",) + tuple(k for k in kinds_of_table(i) if k != "RS"):
            t0 = time.perf_counter()
            idx = tix.build(kind, table, device=dev)
            build_s = time.perf_counter() - t0
            if kind == "RS":
                log(f"[full] {ds}/RS host build {build_s:.1f} s ({idx.info['m']} knots)")
            built[(ds, kind)] = (idx, t_dev, q_dev, build_s)
            answers[(ds, kind)] = idx.lookup(t_dev, q_dev, backend="kernel")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"[full] single-table path launches: {json.dumps(launches)}")
    if dev.type == "cuda":
        check_launches(launches, KERNEL_OF, [kinds_of_table(i) for i in range(len(tables))],
                       "single-table")

    # -- check and measure each (table, kind) --
    rows, numpy_ranks = [], {}
    for (ds, kind), (idx, t_dev, q_dev, build_s) in built.items():
        impl = tix.impls.query_impl(kind)
        got = answers[(ds, kind)]
        args, kwargs = impl.operands(idx, t_dev, q_dev)
        twin = impl.plain(*args, **kwargs).long()
        ref = torch.searchsorted(t_dev, q_dev, right=True) - 1
        err = int((got - twin).abs().max())
        exact = bool(torch.equal(got, ref))
        if err != 0 or not exact:
            fail(f"full: {ds}/{kind} kernel vs twin max |err| {err}, equal to ref: {exact}")
        row = {
            "table": ds, "kind": kind, "kernel": KERNEL_OF[kind], "n": len(tables[ds][0]), "nq": nq,
            "build_s": build_s, "space_bytes": idx.space_bytes(),
            "space_pct_of_table": 100.0 * idx.space_bytes() / (8 * len(tables[ds][0])),
            "nbytes": idx.nbytes(), "statics": dict(idx.static),
            "bit_exact_vs_ref": exact, "twin_equal": err == 0, "max_abs_err": err,
        }
        row.update(measure(
            dev, impl.search, impl.plain, args, kwargs, t_dev, nq,
            lambda: idx.lookup(t_dev, q_dev, backend="kernel"),
            lambda: torch.searchsorted(t_dev, q_dev, right=True),
        ))
        row["plan"] = search_plan(kind, idx, len(tables[ds][0]), args, kwargs)
        if ds not in numpy_ranks:
            numpy_ranks[ds] = np.searchsorted(tables[ds][0], tables[ds][1], side="right") - 1
        row.update(interval_backends(dev, f"{ds}/{kind}", idx, t_dev, q_dev, got, ref,
                                     numpy_ranks[ds]))
        rows.append(row)
        log_row(f"[full] {ds}/{kind}", row)
        log_intervals(f"[full] {ds}/{kind}", row)
    return rows, launches, tables


def windows_hold(lo, hi, ranks) -> bool:
    """Every window holds its rank: the bounded search finds the upper
    bound ``rank + 1`` in ``[lo, hi + 1]`` (a window may start one past
    the rank, as RMI's does in a gap between clusters)."""
    return bool(((lo - 1 <= ranks) & (ranks <= hi)).all())


def interval_backends(dev, what: str, idx, t_dev, q_dev, got, ref, want_np) -> dict:
    """``"xla"`` and ``"bbs"`` on one built index: their ranks equal the
    kernel's, ``"ref"``'s and numpy's, every window holds its rank; the
    reduction factor (paper §2) and ``lookup_ms`` of each backend and of
    ``intervals`` alone (CUDA events)."""
    from repro_torch import index as tix
    from repro_torch.core.cdf import reduction_factor

    check_equal(what, got.cpu().numpy(), (("numpy", want_np),))
    lo, hi = idx.intervals(t_dev, q_dev)
    if not windows_hold(lo, hi, ref):
        fail(f"intervals: a window of {what} misses its rank")
    out = {"reduction_factor": reduction_factor(lo, hi, t_dev.numel()),
           "mean_window": float((hi - lo + 1).double().mean()),
           "intervals_ms": device_ms(lambda: idx.intervals(t_dev, q_dev), dev, reps=5, warmup=1)}
    for backend in tix.INTERVAL_BACKENDS:
        if not torch.equal(idx.lookup(t_dev, q_dev, backend=backend), got):
            fail(f"{backend}: {what} ranks differ from the kernel's")
        out[f"{backend}_lookup_ms"] = device_ms(
            lambda b=backend: idx.lookup(t_dev, q_dev, backend=b), dev, reps=5, warmup=1)
    return out


def log_intervals(prefix: str, row: dict) -> None:
    log(f"{prefix}: xla == bbs == kernel == ref == numpy, every window holds its rank; "
        f"reduction factor {row['reduction_factor']:.6f}% (mean window "
        f"{row['mean_window']:.1f} keys); lookup_ms xla {row['xla_lookup_ms']}, bbs "
        f"{row['bbs_lookup_ms']}, kernel {row['lookup_ms']}; intervals {row['intervals_ms']}")


#: the shards whose unstacked index phase 5 holds against a fresh build
#: of the shard (the others repeat the same stacking at the same shapes;
#: the last shard's repeat is cut for the run's time limit, which phase 10
#: shares)
UNSTACK_CHECKED = (0,)


def phase_tier(dev, tables: dict, n_shards: int, nq_shard: int) -> tuple:
    """The batched path on a tier: each table split into ``n_shards``
    contiguous shards, ``nq_shard`` queries sampled from each shard."""
    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch import tune
    from repro_torch.core import keys
    from repro_torch.data import make_queries

    tiers = {}
    for ds, (table, _) in tables.items():
        shards = np.split(table, n_shards)
        qs = np.stack([make_queries(s, nq_shard, seed=1) for s in shards])
        tiers[ds] = (shards, keys.encode(qs, dev))
        log(f"[tier] {ds}: {n_shards} shards of {len(shards[0])} keys, {nq_shard} queries a shard")

    # -- the batched path: build every kind over the tier, one lookup each (counted) --
    kernels.reset_launches()
    built, answers = {}, {}
    for i, (ds, (shards, q_dev)) in enumerate(tiers.items()):
        for kind in kinds_of_table(i):
            t0 = time.perf_counter()
            bm = tune.build_many(kind, shards, device=dev)
            built[(ds, kind)] = (bm, time.perf_counter() - t0)
            answers[(ds, kind)] = bm.lookup(q_dev, backend="kernel")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"[tier] batched path launches: {json.dumps(launches)}")
    if dev.type == "cuda":
        check_launches(launches, BATCHED_KERNEL_OF, [kinds_of_table(i) for i in range(len(tiers))],
                       "batched")

    rows = []
    for (ds, kind), (bm, build_s) in built.items():
        shards, q_dev = tiers[ds]
        got = answers[(ds, kind)]
        impl, q, args, kwargs = batched_answer(bm, q_dev)
        twin = torch.minimum(impl.batched_plain(*args, **kwargs).long(), bm.counts[:, None] - 1)
        ref = torch.searchsorted(bm.tables, q, right=True) - 1
        err = int((got - twin).abs().max())
        exact = bool(torch.equal(got, ref))
        if err != 0 or not exact:
            fail(f"tier: {ds}/{kind} batched kernel vs twin max |err| {err}, equal to ref: {exact}")
        t0 = time.perf_counter()
        parts = bm.unstack()
        for i in UNSTACK_CHECKED:  # a fresh build of each checked shard
            part = parts[i]
            fresh = tix.build(kind, shards[i], device=dev)
            want, have = fresh.to_numpy(), part.to_numpy()
            same = part.static == fresh.static and set(want) == set(have) and all(
                want[k].dtype == have[k].dtype and want[k].tobytes() == have[k].tobytes()
                for k in want)
            if not same:
                fail(f"tier: {ds}/{kind} unstack()[{i}] differs from the per-shard build")
        unstack_s = time.perf_counter() - t0
        n_keys = sum(len(s) for s in shards)
        row = {
            "table": ds, "kind": kind, "kernel": BATCHED_KERNEL_OF[kind], "n_shards": len(shards),
            "n": n_keys, "nq": int(q.numel()), "build_s": build_s,
            "space_bytes": bm.space_bytes(), "space_pct_of_table": 100.0 * bm.space_bytes() / (8 * n_keys),
            "nbytes": bm.index.nbytes(), "statics": dict(bm.index.static),
            "bit_exact_vs_ref": exact, "twin_equal": err == 0, "max_abs_err": err,
            "unstack_equal": True, "unstack_check_s": unstack_s,
        }
        row.update(measure(
            dev, impl.batched_search, impl.batched_plain, args, kwargs, bm.tables, int(q.numel()),
            lambda: bm.lookup(q_dev, backend="kernel"),
            lambda: torch.searchsorted(bm.tables, q, right=True),
        ))
        row["plan"] = search_plan(kind, bm.index, bm.tables.shape[1], args, kwargs)
        rows.append(row)
        log_row(f"[tier] {ds}/{kind}", row)
        log(f"[tier] {ds}/{kind}: unstack() == per-shard build for shards "
            f"{[i % len(shards) for i in UNSTACK_CHECKED]} of {len(shards)} "
            f"(checked in {unstack_s:.1f} s)")
    return rows, launches, locality_probe(dev, tables, tiers), built


def locality_probe(dev, tables: dict, tiers: dict) -> dict:
    """Whether the tier's speed comes from query order: the single-table
    model-free kernel over the whole table, with the tier's queries in
    shard order (each block's queries in one shard) and shuffled."""
    from repro_torch.core import keys
    from repro_torch.kernels.kary_search import kary_search

    out = {}
    for ds, (table, _) in tables.items():
        t_dev = keys.encode(table, dev)
        ordered = tiers[ds][1].reshape(-1)
        gen = torch.Generator(device=dev).manual_seed(0)
        shuffled = ordered[torch.randperm(ordered.numel(), device=dev, generator=gen)]
        want = torch.searchsorted(t_dev, ordered, right=True) - 1
        if not torch.equal(kary_search(t_dev, ordered).long(), want):
            fail(f"locality probe: {ds} kary_search != searchsorted")
        out[ds] = {
            "shard_ordered_ms": device_ms(lambda: kary_search(t_dev, ordered), dev),
            "shuffled_ms": device_ms(lambda: kary_search(t_dev, shuffled), dev),
            "searchsorted_shard_ordered_ms": device_ms(
                lambda: torch.searchsorted(t_dev, ordered, right=True), dev),
            "searchsorted_shuffled_ms": device_ms(
                lambda: torch.searchsorted(t_dev, shuffled, right=True), dev),
        }
        log(f"[tier] {ds} locality probe, kary_search over all {len(table)} keys: "
            f"{json.dumps(out[ds])}")
    return out


def phase_sharded(dev, tables: dict, tier_built: dict, parity_n: int) -> tuple:
    """The sharded tier (``ShardedIndex.build`` -> ``sharded_lookup``):
    parity on small tiers, every backend; then the kernel path at phase
    5's scale on phase 4's tables and queries (counted, timed).  Returns
    the rows, the launches, and the scale tiers with their answers (for
    phase 5c)."""
    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch.core import keys
    from repro_torch.dist import sharded_index as tsi

    rng = np.random.default_rng(2025)
    for label, table_kind, n, n_shards in (("4 shards", "lognormal", parity_n, 4),
                                            ("160 shards", "bursty", parity_n // 4, 160)):
        table = make_table(rng, table_kind, n)
        for kind in KINDS + ("GAPPED",):
            sidx = tsi.ShardedIndex.build(kind, table, n_shards, device=dev)
            fences = keys.decode(sidx.fences)
            with np.errstate(over="ignore"):
                qs_np = np.concatenate([edge_queries(rng, table, n_keys=min(4096, len(table))),
                                        fences, fences - np.uint64(1), fences + np.uint64(1)])
            want = np.searchsorted(table, qs_np, side="right").astype(np.int64) - 1
            t, q = keys.encode(table, dev), keys.encode(qs_np, dev)
            backends = tix.impls.query_impl(kind).backends
            whole = tix.build(kind, table, device=dev).lookup(t, q, backend=backends[0] if
                                                              kind == "GAPPED" else "kernel")
            got = [(b, tsi.sharded_lookup(sidx, q, backend=b).cpu().numpy()) for b in backends]
            check_equal(f"sharded {label}/{kind}", whole.cpu().numpy(), got + [("numpy", want)])
        log(f"[sharded] {label} of a {table_kind} table of {len(table)} keys, nq={len(qs_np)} "
            f"(fence keys +- 1 included): all {len(KINDS)} kinds, sharded_lookup on "
            f"{'/'.join(tsi.TIER_BACKENDS)} == Index.lookup == numpy; GAPPED on "
            f"{'/'.join(GAPPED_BACKENDS)}")

    # -- the kernel path at scale: build, then one lookup each (counted) --
    n_shards = 4
    built = {}
    for ds, (table, qs) in tables.items():
        for kind in SHARDED_KINDS:
            t0 = time.perf_counter()
            built[(ds, kind)] = (tsi.ShardedIndex.build(kind, table, n_shards, device=dev),
                                 time.perf_counter() - t0)
    queries = {ds: keys.encode(qs, dev) for ds, (_, qs) in tables.items()}
    kernels.reset_launches()
    answers = {key: tsi.sharded_lookup(sidx, queries[key[0]], backend="kernel")
               for key, (sidx, _) in built.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"[sharded] sharded path launches: {json.dumps(launches)}")
    if dev.type == "cuda":
        check_launches(launches, {k: BATCHED_KERNEL_OF[k] for k in SHARDED_KINDS},
                       [SHARDED_KINDS] * len(tables), "sharded")

    rows = []
    for (ds, kind), (sidx, build_s) in built.items():
        table, q = tables[ds][0], queries[ds]
        t_dev = keys.encode(table, dev)
        want = torch.searchsorted(t_dev, q, right=True) - 1
        if not torch.equal(answers[(ds, kind)], want):
            fail(f"sharded: {ds}/{kind} kernel path != torch.searchsorted")
        # the batched kernel on the operands the tier gives it: every query
        # to every shard, most outside it, held raw (before the clamp and the
        # owner select) against its twin and each padded shard's searchsorted
        impl = tix.impls.query_impl(kind)
        bq = q[None, :].expand(n_shards, q.numel())
        args, kwargs = impl.batched_operands(sidx.index, sidx.tables, bq)
        raw = impl.batched_search(*args, **kwargs).long()
        twin = impl.batched_plain(*args, **kwargs).long()
        local = torch.searchsorted(sidx.tables, bq.contiguous(), right=True) - 1
        err = int((raw - twin).abs().max())
        if err != 0 or not torch.equal(raw, local):
            fail(f"sharded: {ds}/{kind} batched kernel vs twin max |err| {err} on the tier's "
                 f"operands, equal to the shards' searchsorted: {bool(torch.equal(raw, local))}")
        owners = tsi.route_owners(sidx.fences, q).long()
        outside = float((owners[None, :] != torch.arange(n_shards, device=dev)[:, None])
                        .double().mean())
        del raw, twin, local
        bm = tier_built[(ds, kind)][0]
        have, same = sidx.index.to_numpy(), bm.index.to_numpy()
        if sidx.index.static != bm.index.static or any(
                have[k].tobytes() != same[k].tobytes() for k in same) or set(have) != set(same):
            fail(f"sharded: {ds}/{kind} stacked leaves differ from build_many's on the same shards")
        row = {
            "table": ds, "kind": kind, "kernel": BATCHED_KERNEL_OF[kind], "n_shards": n_shards,
            "n": len(table), "nq": int(q.numel()), "build_s": build_s, "exact": True,
            "max_abs_err": err, "outside_share": outside,
            "lookup_ms": device_ms(lambda: tsi.sharded_lookup(sidx, q, backend="kernel"), dev),
            "batched_lookup_ms": device_ms(lambda: bm.lookup(q, backend="kernel"), dev),
            "route_ms": device_ms(lambda: tsi.route_owners(sidx.fences, q), dev),
        }
        rows.append(row)
        log(f"[sharded] {ds}/{kind}: {n_shards} shards of {sidx.tables.shape[1]} keys, "
            f"{row['nq']} queries over the whole table, build {build_s:.1f} s; exact vs "
            f"searchsorted, leaves == build_many's; batched kernel on the tier's "
            f"({n_shards}, {row['nq']}) operands == twin (max |err| {err}) == each shard's "
            f"searchsorted, {outside:.4f} of them outside their shard; "
            f"sharded_lookup {row['lookup_ms']} ms, "
            f"BatchedIndexes.lookup (all queries to every shard) {row['batched_lookup_ms']} ms, "
            f"route_owners {row['route_ms']} ms")

    # -- the router's k-ary branch (more than 128 fences) at the same query count --
    for ds, (table, _) in tables.items():
        q = queries[ds]
        fences = keys.encode(table[:: len(table) // 160][:160], dev)
        owners = tsi.route_owners(fences, q)
        if not torch.equal(owners.long(), torch.searchsorted(fences[1:], q, right=True)):
            fail(f"sharded: {ds} route_owners over 160 fences != torch.searchsorted")
        ms = device_ms(lambda: tsi.route_owners(fences, q), dev, reps=5, warmup=1)
        log(f"[sharded] {ds} route_owners over 160 fences (k-ary branch), {q.numel()} queries: "
            f"== searchsorted, {ms} ms")
    return rows, launches, {key: (sidx, answers[key]) for key, (sidx, _) in built.items()}


# -- phase 5c: the tier's collective modes, one shard a rank --------------------------

#: ranks of phase 5c, spawned on the one card, joined in a gloo group
RANKS = 4
#: a2a stages timed on each rank, in the order the path runs them
A2A_STAGES = ("route", "bucket", "exchange_requests", "answer", "exchange_replies", "unbucket",
              "gather")


def host_drop_model(owners: np.ndarray, n_shards: int, cap: int) -> np.ndarray:
    """Which queries of a padded batch the a2a exchange drops, on the host:
    each source rank's slice sorted stably by owner, the first ``cap`` of
    each (source, owner) pair kept, the rest dropped (pad rows count)."""
    b_loc = len(owners) // n_shards
    dropped = np.zeros(len(owners), dtype=bool)
    for src in range(n_shards):
        o = owners[src * b_loc:(src + 1) * b_loc]
        order = np.argsort(o, kind="stable")
        so = o[order]
        pos = np.arange(b_loc) - np.searchsorted(so, so, side="left")
        dropped[src * b_loc + order[pos >= cap]] = True
    return dropped


def phase_collective(dev, tables: dict, scale: dict, parity_n: int) -> tuple:
    """Phase 5c: phase 5b's scale tiers saved, then ``RANKS`` spawned ranks
    on the card in one gloo group, each holding one shard: the a2a and
    allgather modes on phase 4's queries (counted), the kernel against its
    twin on each rank's received requests, per-stage times, a skewed
    batch's drops against the host model, parity of every kind and backend
    on 2 and 4 ranks, and refresh and rebalance followed by a lookup."""
    import shutil

    import torch.multiprocessing as mp

    from repro_torch import index as tix
    from repro_torch.core import keys
    from repro_torch.dist import collectives
    from repro_torch.dist import sharded_index as tsi

    work = ROOT / "build" / "collective"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(2027)
    main = []
    for (ds, kind), (sidx, ref) in scale.items():
        name = f"{ds}_{kind}"
        sidx.save(work / f"{name}.npz")
        np.save(work / f"ref_{name}.npy", ref.cpu().numpy())
        main.append({"name": name, "ds": ds, "kind": kind})
    for ds, (table, qs) in tables.items():
        np.save(work / f"q_{ds}.npy", qs)
        np.save(work / f"np_{ds}.npy", np.searchsorted(table, qs, side="right").astype(np.int64) - 1)
        # the skewed batch: every query from the last shard's keys, B not a
        # multiple of RANKS; its drop set from the host model of the exchange
        sidx = scale[(ds, SHARDED_KINDS[0])][0]
        last = int(sidx.offsets[-1])
        skew = rng.choice(table[last:], len(qs) - 1).astype(np.uint64)
        padded = np.concatenate([skew, np.zeros((-len(skew)) % RANKS, np.uint64)])
        owners = np.searchsorted(keys.decode(sidx.fences)[1:], padded, side="right")
        cap = collectives.exchange_capacity(len(padded) // RANKS, RANKS, 2.0)
        np.save(work / f"skew_{ds}.npy", skew)
        np.save(work / f"skew_np_{ds}.npy",
                np.searchsorted(table, skew, side="right").astype(np.int64) - 1)
        np.save(work / f"skew_drop_{ds}.npy", host_drop_model(owners, RANKS, cap)[:len(skew)])
    # parity tiers: every kind at parity_n on 2 and 4 shards, every fence key +- 1
    parity = []
    table = make_table(rng, "lognormal", parity_n)
    np.save(work / "parity_table.npy", table)
    for n_shards in (2, RANKS):
        for kind in KINDS + ("GAPPED",):
            sidx = tsi.ShardedIndex.build(kind, table, n_shards, device="cpu")
            live = table
            if kind == "GAPPED":  # mutated: inserts in every shard, shard 0's delta populated
                live = mutate_tier(rng, sidx, table, len(table) // 32)
            fences = keys.decode(sidx.fences)
            with np.errstate(over="ignore"):
                qs = np.concatenate([edge_queries(rng, live, n_keys=min(4096, len(live))),
                                     fences, fences - np.uint64(1), fences + np.uint64(1)])
            name = f"parity{n_shards}_{kind}"
            sidx.save(work / f"{name}.npz")
            np.save(work / f"q_{name}.npy", qs[:-1])  # an odd batch: the a2a path pads it
            np.save(work / f"np_{name}.npy",
                    np.searchsorted(live, qs[:-1], side="right").astype(np.int64) - 1)
            parity.append({"name": name, "kind": kind, "n_shards": n_shards})
    # refresh and rebalance: a SY-RMI tier with room in each shard's padded table
    maint = make_table(rng, "lognormal", parity_n * 3 // 4)
    sidx = tsi.ShardedIndex.build("SY-RMI", maint, RANKS, device="cpu")
    sidx.save(work / "maint.npz")
    m = int(sidx.tables.shape[1])
    new_keys = keys.decode(sidx.tables[1])[:int(sidx.counts[1]) - 5]
    tix.build("SY-RMI", tsi._pad_sorted_table(new_keys, m), device="cpu").save(
        work / "maint_shard1.npz")
    np.save(work / "maint_shard1.npy", new_keys)
    merged = np.concatenate([keys.decode(sidx.tables[s])[:int(sidx.counts[s])] if s != 1 else
                             new_keys for s in range(RANKS)])
    np.save(work / "maint_merged.npy", merged)
    np.save(work / "maint_bounds.npy", tsi.weighted_quantile_bounds(
        merged, keys.decode(sidx.fences), [2.0, 1.0, 1.0, 1.0]))
    mq = edge_queries(rng, merged, n_keys=4096)
    np.save(work / "maint_q.npy", mq)
    np.save(work / "maint_np.npy", np.searchsorted(merged, mq, side="right").astype(np.int64) - 1)
    # one rank a card over NCCL where there are enough cards (unverified on a
    # one-card machine); else every rank on the one device over gloo, which
    # stages the CUDA tensors of its collectives through the host (NCCL
    # refuses two ranks on one card)
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= RANKS
    (work / "job.json").write_text(json.dumps({"device": dev.type, "main": main,
                                               "parity": parity, "datasets": list(tables),
                                               "backend": "nccl" if nccl else "gloo"}))
    prep_s = time.perf_counter() - t0
    log(f"[collective] saved {len(main)} scale tiers, {len(parity)} parity tiers and the "
        f"maintenance tier in {prep_s:.1f} s; spawning {RANKS} ranks "
        + ("one a card, NCCL" if nccl else f"on one {dev.type} device, one gloo group"))

    t0 = time.perf_counter()
    procs = mp.start_processes(collective_rank, args=(RANKS, str(work)), nprocs=RANKS,
                               join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    try:
        while not procs.join(timeout=1.0):  # a rank's failure raises here
            if time.monotonic() > deadline:
                fail(f"phase 5c: the {RANKS} ranks ran past 600 s")
    finally:
        for proc in procs.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(5)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(RANKS)]
    ranks_s = time.perf_counter() - t0

    launches = {path: {k: sum(r["launches"][path][k] for r in ranks) for k in KERNELS}
                for path in ("a2a", "allgather")}
    for path, counts in launches.items():
        log(f"[collective] {path} path launches over {RANKS} ranks: {json.dumps(counts)}")
    for r in ranks:
        for name, st in r["stages"].items():
            log(f"[collective] rank {r['rank']} {name}: a2a ms " + ", ".join(
                f"{k} {st[k]:.4f}" for k in A2A_STAGES + ("whole",) if st.get(k) is not None)
                + f"; allgather {st['allgather']}; host ms a2a {st['host_whole']:.3f}, allgather "
                f"{st['host_allgather']:.3f}; {st['requests']} requests received")
    if any(r["checks"] != ranks[0]["checks"] for r in ranks):
        fail("phase 5c: the ranks ran different checks")
    for line in ranks[0]["checks"]:
        log(f"[collective] every rank: {line}")
    log(f"[collective] done: {RANKS} ranks in {ranks_s:.1f} s (prep {prep_s:.1f} s)")
    return launches, ranks


def collective_rank(rank: int, world: int, work_dir: str) -> None:
    """One rank of phase 5c (spawned; joins the gloo group, runs, leaves).
    Any failure raises, which fails the parent's join."""
    import torch.distributed as dist

    work = Path(work_dir)
    job = json.loads((work / "job.json").read_text())
    if job["device"] == "cuda":
        job["device"] = f"cuda:{rank if job['backend'] == 'nccl' else 0}"
        torch.cuda.set_device(torch.device(job["device"]))
    else:  # the CPU rehearsal: the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(job["backend"], init_method=f"file://{work / 'pg_init'}", rank=rank,
                            world_size=world)
    try:
        result = collective_rank_body(rank, world, work, job)
    finally:
        dist.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(result))


def _rank_ms(fn, dev, group, reps: int = 3):
    """``fn()``'s result and its mean ms over ``reps`` calls after one warm
    call, each between a barrier of every rank and a synchronise: CUDA
    events on the card (None on the CPU) and the host clock."""
    import torch.distributed as dist

    dev_ms, host_ms = [], []
    for _ in range(reps + 1):
        dist.barrier(group=group)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            end.record()
            torch.cuda.synchronize()
            dev_ms.append(start.elapsed_time(end))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return out, (float(np.mean(dev_ms[1:])) if dev_ms else None), float(np.mean(host_ms[1:]))


def collective_rank_body(rank: int, world: int, work: Path, job: dict) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch.core import keys
    from repro_torch.dist import ShardingCtx, collectives, rebalance_shards, refresh_shard
    from repro_torch.dist import sharded_index as tsi
    from repro_torch.index import registry

    dev = torch.device(job["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    grid = torch.arange(world)
    ctx = ShardingCtx(mesh=DeviceMesh(dev.type, grid.reshape(1, world),
                                      mesh_dim_names=("data", "model")))  # tp -> model
    group, me = ctx.group("tp"), ctx.index("tp")
    tiers = {c["name"]: tsi.ShardedIndex.load(work / f"{c['name']}.npz", device=dev, shard=me)
             for c in job["main"]}
    queries = {ds: keys.encode(np.load(work / f"q_{ds}.npy"), dev) for ds in job["datasets"]}
    checks = []

    # -- the main path, each mode counted from 0 --
    answers, launches = {}, {}
    for mode, cap_factor in (("a2a", 4.0), ("allgather", 2.0)):
        kernels.reset_launches()
        for c in job["main"]:
            answers[(mode, c["name"])] = tsi.sharded_lookup(
                tiers[c["name"]], queries[c["ds"]], ctx, mode=mode, backend="kernel",
                cap_factor=cap_factor)
        sync()
        launches[mode] = kernels.launches()
        for c in job["main"]:
            want = [("phase 5b mode='ref'", np.load(work / f"ref_{c['name']}.npy")),
                    ("numpy", np.load(work / f"np_{c['ds']}.npy"))]
            check_equal(f"rank {rank} {mode} {c['name']}", answers[(mode, c["name"])].cpu().numpy(),
                        want)
    for name in KERNELS if dev.type == "cuda" else ():  # the CPU twins launch nothing
        want = sum(1 for c in job["main"] if KERNEL_OF[c["kind"]] == name)
        for mode in launches:
            if launches[mode][name] != want:
                fail(f"rank {rank}: {name} launched {launches[mode][name]} times on the {mode} "
                     f"path, expected {want}")
    checks.append(f"a2a (cap_factor 4.0) and allgather == phase 5b's mode='ref' == numpy on "
                  f"{len(job['main'])} tiers, one single-table launch a tier and mode")

    # -- the kernel on the requests this rank received; the a2a stages, timed --
    stages, errs = {}, []
    for c in job["main"]:
        sidx, q = tiers[c["name"]], queries[c["ds"]]
        n = sidx.n_shards
        b_loc = -(-q.numel() // n)
        qp = torch.cat([q, q.new_full((b_loc * n - q.numel(),), tsi.PAD_KEY)])
        q_loc = qp[me * b_loc:(me + 1) * b_loc]
        cap = collectives.exchange_capacity(b_loc, n, 4.0)
        impl = tix.impls.query_impl(c["kind"])
        st = {}
        owner, st["route"], _ = _rank_ms(lambda: tsi.route_owners(sidx.fences, q_loc), dev, group)
        (req, slots, valid, order), st["bucket"], _ = _rank_ms(
            lambda: collectives.bucket_by_owner(owner, q_loc, n, cap, tsi.PAD_KEY), dev, group)
        received, st["exchange_requests"], st["host_exchange_requests"] = _rank_ms(
            lambda: collectives.all_to_all(req, group), dev, group)
        received = received.reshape(-1)
        g, st["answer"], _ = _rank_ms(lambda: tsi._answer_shard(sidx, me, received, "kernel"),
                                      dev, group)
        back, st["exchange_replies"], st["host_exchange_replies"] = _rank_ms(
            lambda: collectives.all_to_all(g.reshape(n, cap), group), dev, group)
        part, st["unbucket"], _ = _rank_ms(lambda: collectives.unbucket_inverse(
            back, slots, valid, order, b_loc, tsi.DROPPED), dev, group)
        whole_stages, st["gather"], st["host_gather"] = _rank_ms(
            lambda: tsi._gather_slices(part, group, n)[:q.numel()], dev, group)
        got, st["whole"], st["host_whole"] = _rank_ms(lambda: tsi.sharded_lookup(
            sidx, q, ctx, mode="a2a", backend="kernel", cap_factor=4.0), dev, group)
        _, st["allgather"], st["host_allgather"] = _rank_ms(lambda: tsi.sharded_lookup(
            sidx, q, ctx, mode="allgather", backend="kernel"), dev, group)
        if not (torch.equal(whole_stages, got) and torch.equal(got, answers[("a2a", c["name"])])):
            fail(f"rank {rank}: {c['name']} the staged a2a != sharded_lookup's")
        # the single-table kernel on exactly these requests, before the clamp
        args, kwargs = impl.operands(sidx.shard(me), sidx.tables[0], received)
        raw = impl.search(*args, **kwargs).long()
        twin = impl.plain(*args, **kwargs).long()
        local = torch.searchsorted(sidx.tables[0], received, right=True) - 1
        err = int((raw - twin).abs().max())
        if err != 0 or not torch.equal(raw, local):
            fail(f"rank {rank}: {c['name']} {KERNEL_OF[c['kind']]} vs twin max |err| {err} on its "
                 f"{received.numel()} received requests; == the shard's searchsorted: "
                 f"{bool(torch.equal(raw, local))}")
        errs.append(err)
        st.update(requests=received.numel(), request_bytes=int(req.nbytes), max_abs_err=err)
        stages[c["name"]] = st
    checks.append("each tier's single-table kernel == twin == the padded shard's searchsorted on "
                  "the requests this rank received (fill rows included)")

    # -- a skewed batch at the default cap_factor 2.0: drops as the host model --
    for c in job["main"]:
        skew = np.load(work / f"skew_{c['ds']}.npy")
        got = tsi.sharded_lookup(tiers[c["name"]], skew, ctx, mode="a2a").cpu().numpy()
        model = np.load(work / f"skew_drop_{c['ds']}.npy")
        exact = np.load(work / f"skew_np_{c['ds']}.npy")
        if not np.array_equal(got == tsi.DROPPED, model):
            fail(f"rank {rank}: {c['name']} skewed batch drops {int((got == tsi.DROPPED).sum())} "
                 f"queries, the host model {int(model.sum())}")
        check_equal(f"rank {rank} skewed {c['name']}", got[~model], (("numpy", exact[~model]),))
    checks.append(f"skewed batches (B = {len(skew)}, all on the last shard, cap_factor 2.0): "
                  f"DROPPED == the host model ({int(model.sum())} dropped), the rest == numpy")

    # -- parity: every kind and backend, 2 ranks ((2, 2) mesh, tp = model) and 4 ((1, 4) mesh,
    #    tp over the flattened (data, model) dims) --
    layouts = {2: ShardingCtx(mesh=DeviceMesh(dev.type, grid.reshape(2, world // 2),
                                              mesh_dim_names=("data", "model"))),
               world: ShardingCtx(mesh=DeviceMesh(dev.type, grid.reshape(1, world),
                                                  mesh_dim_names=("data", "model")),
                                  rules={"tp": ("data", "model")})}
    for c in job["parity"]:
        pctx = layouts[c["n_shards"]]
        sidx = tsi.ShardedIndex.load(work / f"{c['name']}.npz", device=dev,
                                     shard=pctx.index("tp"))
        qs = np.load(work / f"q_{c['name']}.npy")
        want = np.load(work / f"np_{c['name']}.npy")
        for mode in ("a2a", "allgather"):
            for backend in tix.impls.query_impl(c["kind"]).backends:
                got = tsi.sharded_lookup(sidx, qs, pctx, mode=mode, backend=backend,
                                         cap_factor=float(c["n_shards"]))
                check_equal(f"rank {rank} parity {c['name']} {mode}/{backend}",
                            got.cpu().numpy(), (("numpy", want),))
    checks.append(f"parity: {len(job['parity'])} tiers (every kind, 2 and {world} shards), a2a "
                  f"and allgather on {'/'.join(tsi.TIER_BACKENDS)} == numpy; GAPPED mutated "
                  f"(delta populated) on {'/'.join(GAPPED_BACKENDS)}")

    # -- refresh_shard, then rebalance_shards, each followed by an a2a lookup --
    sidx = tsi.ShardedIndex.load(work / "maint.npz", device=dev, shard=me)
    mq = np.load(work / "maint_q.npy")
    refresh_shard(sidx, 1, tix.Index.load(work / "maint_shard1.npz", device=dev),
                  np.load(work / "maint_shard1.npy"))
    check_equal(f"rank {rank} after refresh_shard", tsi.sharded_lookup(
        sidx, mq, ctx, mode="a2a", cap_factor=4.0).cpu().numpy(),
        (("numpy", np.load(work / "maint_np.npy")),))
    spec = registry.spec_for("SY-RMI")
    bounds = np.load(work / "maint_bounds.npy")
    rebalance_shards(sidx, np.load(work / "maint_merged.npy"), bounds,
                     lambda part: tix.build(spec, part, device=dev))
    if not np.array_equal(sidx.counts.cpu().numpy(), np.diff(bounds)):
        fail(f"rank {rank}: rebalance_shards left counts {sidx.counts.tolist()}")
    check_equal(f"rank {rank} after rebalance_shards", tsi.sharded_lookup(
        sidx, mq, ctx, mode="a2a", cap_factor=4.0).cpu().numpy(),
        (("numpy", np.load(work / "maint_np.npy")),))
    checks.append(f"refresh_shard (shard 1, 5 keys retired) then rebalance_shards (counts "
                  f"{np.diff(bounds).tolist()}): a2a == numpy on the new table")
    return {"rank": rank, "launches": launches, "stages": stages, "checks": checks,
            "max_abs_err": max(errs)}


# -- phase 5d: the updatable GAPPED kind and its mutation surface ---------------------


def fresh_keys(rng, table: np.ndarray, n: int) -> np.ndarray:
    """Up to ``n`` keys absent from the sorted ``table``: midpoints of
    random gaps of two or more."""
    i = rng.choice(len(table) - 1, min(n, len(table) - 1), replace=False)
    gap = table[i + 1] - table[i]
    i, gap = i[gap >= 2], gap[gap >= 2]
    return np.unique(table[i] + gap // np.uint64(2))


def not_in(keys, table: np.ndarray) -> np.ndarray:
    """The sorted distinct ``keys`` that the sorted ``table`` does not hold:
    ``np.setdiff1d`` without its ``np.unique`` of the whole table (see
    ``repro_torch.core.cdf.sorted_unique``)."""
    from repro_torch.core.cdf import sorted_unique

    k = sorted_unique(keys)
    i = np.minimum(np.searchsorted(table, k), len(table) - 1)
    return k[table[i] != k]


def packed_batch(index, live: np.ndarray, extra: int) -> np.ndarray:
    """Fresh keys packed into the widest key range of one leaf of a GAPPED
    index (not its last), ``extra`` more than the leaf's free slots: the
    leaf absorbs all or nothing, so the whole batch overflows into the
    delta."""
    from repro_torch.core import keys

    a = index.arrays
    counts = a["counts"].cpu().numpy()
    lo, hi = keys.decode(a["fences"]), keys.decode(a["route"])
    ok = (counts > 0) & (hi != np.uint64(2**64 - 1))
    width = np.where(ok, hi - lo, 0)
    leaf = int(np.argmax(width))
    k = int(a["keys"].shape[1]) - int(counts[leaf]) + extra
    step = (hi[leaf] - lo[leaf] - np.uint64(1)) // np.uint64(k + 1)
    if step < 1:
        fail(f"mutation: no leaf range wide enough for {k} keys")
    batch = not_in(lo[leaf] + np.uint64(1) + np.arange(k, dtype=np.uint64) * step, live)
    if len(batch) <= k - extra:
        fail("mutation: the packed batch fits the leaf's gaps")
    return batch


def mutate_tier(rng, sidx, table: np.ndarray, n_fresh: int) -> np.ndarray:
    """Insert ``n_fresh`` fresh keys into a GAPPED tier (in place), routed
    by ``route_owners``, then a batch packed into one leaf of shard 0 that
    overflows into its delta; returns the live keys."""
    from repro_torch.core import keys
    from repro_torch.dist import sharded_index as tsi

    fresh = fresh_keys(rng, table, n_fresh)
    owners = tsi.route_owners(sidx.fences, keys.encode(fresh, sidx.device)).cpu().numpy()
    for s in range(sidx.n_shards):
        tsi.insert_into_shard(sidx, s, fresh[owners == s])
    live = add_keys(table, fresh)[0]
    packed = packed_batch(sidx.shard(0), live, 32)
    _, report = tsi.insert_into_shard(sidx, 0, packed)
    if report.overflowed != len(packed):
        fail(f"mutation: the packed batch overflowed {report.overflowed} of {len(packed)} keys")
    return add_keys(live, packed)[0]


def add_keys(live: np.ndarray, batch: np.ndarray) -> tuple:
    """The sorted ``live`` keys with the batch's new ones inserted (the
    ``np.union1d``, without re-sorting the live keys), and how many were
    new."""
    u = np.unique(batch)
    i = np.searchsorted(live, u)
    new = u[(i == len(live)) | (live[np.minimum(i, len(live) - 1)] != u)]
    return np.insert(live, np.searchsorted(live, new), new), len(new)


def host_ranks(live: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """numpy ``searchsorted(right) - 1``, the queries visited in sorted
    order (a binary search per query misses the host's caches)."""
    order = np.argsort(queries)
    out = np.empty(len(queries), dtype=np.int64)
    out[order] = np.searchsorted(live, queries[order], side="right") - 1
    return out


def check_report(what: str, report, batch: np.ndarray, live: np.ndarray) -> np.ndarray:
    """The report against the host model (fresh = the batch's keys not yet
    live, duplicates = the rest); returns the new live keys."""
    live, n_fresh = add_keys(live, batch)
    got = (report.requested, report.absorbed + report.overflowed, report.duplicates)
    want = (len(batch), n_fresh, len(batch) - n_fresh)
    if got != want:
        fail(f"mutation: {what} report (requested, absorbed + overflowed, duplicates) {got}, "
             f"host model {want}")
    return live


def gapped_ranks(dev, what: str, idx, t_dev, queries, live: np.ndarray) -> None:
    """xla == bbs == ref == numpy over the live keys; kernel refused."""
    from repro_torch.core import keys

    q = keys.encode(queries, dev)
    want = host_ranks(live, queries)
    got = [(b, idx.lookup(t_dev, q, backend=b).cpu().numpy()) for b in GAPPED_BACKENDS]
    check_equal(f"mutation {what} {got[0][0]}", got[0][1], got[1:] + [("numpy", want)])
    expect_no_kernel(idx, t_dev, q, what)


def phase_mutation(dev, tables: dict, batches, tier_fresh: int) -> list:
    """Phase 5d: GAPPED on phase 4's tables (built on every second key,
    the other half held back), insert batches of ``batches`` sizes (an
    eighth of each batch duplicates of live keys) and one batch packed
    into one leaf that overflows into the delta, then ``compact``: after
    every step ``xla`` == ``bbs`` == ``ref`` == numpy on phase 4's queries
    plus the inserted keys, each report against the host model, no
    kernel launched; insert, compact and lookup times by CUDA events.
    Then the tier: a GAPPED ``ShardedIndex`` of each table (4 shards),
    ``tier_fresh`` fresh keys routed into ``insert_into_shard``, then
    ``compact_shard``, ``sharded_lookup(mode="ref", backend="xla")`` ==
    numpy and the tier's vectors equal to a tier built on the live keys."""
    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch.core import keys
    from repro_torch.dist import sharded_index as tsi
    from repro_torch.index.updatable import live_keys

    rows = []
    kernels.reset_launches()
    for ds, (table, qs) in tables.items():
        t_table = time.perf_counter()
        rng = np.random.default_rng(2029)
        base, held = table[::2], rng.permutation(table[1::2])
        t0 = time.perf_counter()
        idx = tix.build("GAPPED", base, device=dev)
        row = {"table": ds, "n": len(base), "nq": len(qs), "build_s": time.perf_counter() - t0,
               "n_leaves": idx.info["n_leaves"], "leaf_bytes": int(idx.arrays["keys"].nbytes),
               "insert_ms": {}, "reports": []}
        t_dev = keys.encode(base, dev)  # the build table: GAPPED ignores it
        live, inserted, start = base, [], 0
        gapped_ranks(dev, f"{ds} build", idx, t_dev, qs, live)
        for size in batches:
            label, n_new = f"batch {size}", size - size // 8
            batch = rng.permutation(np.concatenate([held[start:start + n_new],
                                                    rng.choice(base, size // 8)]))
            start += n_new
            new, report = idx.insert_batch(batch)
            row["insert_ms"][len(batch)] = device_ms(lambda b=batch: idx.insert_batch(b), dev,
                                                     reps=5, warmup=1)
            live = check_report(f"{ds} {label}", report, batch, live)
            idx = new
            inserted.append(batch)
            gapped_ranks(dev, f"{ds} {label}", idx, t_dev, np.concatenate([qs, *inserted]), live)
            row["reports"].append(dict(report.__dict__))
        packed = packed_batch(idx, live, 64)
        new, report = idx.insert_batch(packed)
        live = check_report(f"{ds} packed leaf", report, packed, live)
        if report.overflowed != len(packed) or report.delta_count != len(packed):
            fail(f"mutation: {ds} packed batch overflowed {report.overflowed} of {len(packed)}")
        row["reports"].append(dict(report.__dict__))
        row["packed_insert_ms"] = device_ms(lambda: idx.insert_batch(packed), dev, reps=5, warmup=1)
        idx = new
        inserted.append(packed)
        queries = keys.encode(np.concatenate([qs, *inserted]), dev)
        gapped_ranks(dev, f"{ds} packed leaf", idx, t_dev, keys.decode(queries), live)
        for b in GAPPED_BACKENDS:
            row[f"{b}_lookup_ms_delta"] = device_ms(
                lambda b=b: idx.lookup(t_dev, queries, backend=b), dev, reps=5, warmup=1)
        row["compact_ms"] = device_ms(lambda: idx.compact(), dev, reps=5, warmup=1)
        idx = idx.compact()
        if int(idx.arrays["delta_count"]) != 0:
            fail(f"mutation: {ds} compact left {int(idx.arrays['delta_count'])} delta keys")
        gapped_ranks(dev, f"{ds} compacted", idx, t_dev, keys.decode(queries), live)
        if not np.array_equal(live_keys(idx), live):
            fail(f"mutation: {ds} live_keys after compact != the host's live set")
        for b in GAPPED_BACKENDS:
            row[f"{b}_lookup_ms"] = device_ms(
                lambda b=b: idx.lookup(t_dev, queries, backend=b), dev, reps=5, warmup=1)
        row.update(nq_final=int(queries.numel()), n_live=len(live),
                   root_eps=int(idx.arrays["root_eps"]))
        log(f"[mutation] {ds}: GAPPED on {len(base)} keys ({row['n_leaves']} leaves, "
            f"{row['leaf_bytes'] / 2**20:.0f} MiB of leaves, build {row['build_s']:.1f} s); "
            f"inserts {json.dumps(row['insert_ms'])} ms by batch size, packed leaf "
            f"({len(packed)} keys, all to the delta) {row['packed_insert_ms']} ms, compact "
            f"{row['compact_ms']} ms; lookup ms with the delta populated xla "
            f"{row['xla_lookup_ms_delta']}, bbs {row['bbs_lookup_ms_delta']}, ref "
            f"{row['ref_lookup_ms_delta']}; compacted xla {row['xla_lookup_ms']}, bbs "
            f"{row['bbs_lookup_ms']}, ref {row['ref_lookup_ms']} ({row['nq_final']} queries); "
            f"every step xla == bbs == ref == numpy, reports == host model, kernel refused "
            f"({time.perf_counter() - t_table:.1f} s)")
        rows.append(row)

        # -- the tier: fresh keys routed into insert_into_shard, then compact_shard --
        t_table = t0 = time.perf_counter()
        sidx = tsi.ShardedIndex.build("GAPPED", table, 4, device=dev)
        tier = {"table": ds, "n": len(table), "build_s": time.perf_counter() - t0}
        fresh = fresh_keys(rng, table, tier_fresh)
        owners = tsi.route_owners(sidx.fences, keys.encode(fresh, dev)).cpu().numpy()
        t0 = time.perf_counter()
        for s in range(sidx.n_shards):
            _, report = tsi.insert_into_shard(sidx, s, fresh[owners == s])
            if report.absorbed + report.overflowed != int((owners == s).sum()):
                fail(f"mutation: {ds} tier shard {s} report {report}")
        tier["insert_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for s in range(sidx.n_shards):
            tsi.compact_shard(sidx, s)
        tier["compact_s"] = time.perf_counter() - t0
        live = add_keys(table, fresh)[0]
        tq = np.concatenate([qs, fresh])
        got = tsi.sharded_lookup(sidx, tq, mode="ref", backend="xla").cpu().numpy()
        check_equal(f"mutation {ds} tier", got, (("numpy", host_ranks(live, tq)),))
        counts = sidx.counts.cpu().numpy()
        fresh_tier = tsi.ShardedIndex.build("GAPPED", live, 4, device="cpu",
                                            bounds=np.concatenate([[0], np.cumsum(counts)]))
        for k in ("counts", "offsets", "fences", "lasts"):
            if not np.array_equal(getattr(sidx, k).cpu().numpy(), getattr(fresh_tier, k).numpy()):
                fail(f"mutation: {ds} tier {k} != a tier built on the live keys")
        q_dev = keys.encode(tq, dev)
        tier["xla_lookup_ms"] = device_ms(
            lambda: tsi.sharded_lookup(sidx, q_dev, mode="ref", backend="xla"), dev, reps=3,
            warmup=1)
        tier["nq"] = len(tq)
        log(f"[mutation] {ds} tier: 4 GAPPED shards of {len(table) // 4} keys (build "
            f"{tier['build_s']:.1f} s), {len(fresh)} fresh keys routed into insert_into_shard "
            f"({tier['insert_s']:.2f} s host), compact_shard ({tier['compact_s']:.2f} s host); "
            f"sharded_lookup(mode='ref', backend='xla') == numpy on {len(tq)} queries "
            f"({tier['xla_lookup_ms']} ms); counts, offsets, fences and lasts == a tier built "
            f"on the live keys ({time.perf_counter() - t_table:.1f} s)")
        rows.append({"tier": tier})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"[mutation] GAPPED path launches: {json.dumps(launches)}")
    check_launches(launches, {}, [], "GAPPED")
    return rows


# -- the LM serving path's kernels (phases 6-8) ----------------------------------------


# -- phase 5e: the device fits ------------------------------------------------------------

#: f64 peak of one H100 SXM outside the tensor cores (NVIDIA data sheet):
#: the rate of the corridor scan's f64 work
F64_OPS_PER_S = 34e12
#: f64 operations of one corridor step: two subtractions, the ε add and
#: subtract, two divisions, a max, a min, a compare and four selects
CORRIDOR_STEP_OPS = 13
#: SM clock the latency bound assumes: the H100 SXM's highest boost clock
#: (NVIDIA data sheet), so no run is faster
SM_CLOCK_HZ = 1.98e9
#: cycles of one step's dependent chain, the carry of one step to the
#: next's, at 8 cycles a dependent f64 add, multiply, fma or compare and
#: 4 a select (the dependent-issue latencies Jia et al. 2018, "Dissecting
#: the NVIDIA Volta GPU Architecture via Microbenchmarking", measured on
#: Volta's full-rate FP64 pipe; none are published for the H100); an IEEE
#: f64 division is the compiler's reciprocal estimate and 8 dependent
#: fma/multiply steps, 72 cycles with the estimate counted at 8 (its least).
#:   PGM: x - x0 (8), the division (72), max (compare 8, select 4), the
#:        cone test (compare 8), the anchor selects (4): 104
#:   RS:  xi - x0 (8), the slope division (72), the cone test (compare 8,
#:        or 4), the anchor select (4), xi - x0' (8), the bound division
#:        (72), max (compare 8, select 4), the select on the test (4): 192
CORRIDOR_CHAIN_CYCLES = {"pgm": 104, "rs": 192}
CORRIDOR_KERNEL = {
    "name": "corridor_scan", "route": "cuda", "source": "src/repro_torch/csrc/corridor_scan.cu",
    "replaces": "src/repro/core/cdf.py:121",
    "also_replaces": "src/repro/core/cdf.py:170 (lax.scan of the corridor step; no Pallas kernel)",
}
#: the exact form's kernel (corridor_exact_kernel, one cooperative launch)
CORRIDOR_EXACT_KERNEL = {
    "name": "corridor_scan_exact", "route": "cuda",
    "source": "src/repro_torch/csrc/corridor_scan.cu",
    "replaces": "src/repro/core/cdf.py:170 (lax.scan of the corridor step; no Pallas kernel)",
}
FIT_KINDS = ("RMI", "SY-RMI", "PGM", "PGM_M", "RS")
#: fit="fast" on the lead tier (osm's repeat is cut): PGM_M's fast
#: bisection runs nowhere else on the card (the sweep's fit="auto" takes
#: the vmap fit)
FAST_FIT_KINDS = ("PGM", "PGM_M", "RS")
#: fit="auto" on the lead tier: one kind it leaves to the host build and
#: one it sends down the vmap path (the other host kinds would repeat
#: phase 5's host builds; the CPU tests hold auto == host for each)
AUTO_KINDS = ("L", "PGM")
#: device_refresh cases: (table, kind, the tier's shard cuts as quarters
#: of the table, fits, whether fit="fast" must install).  Shard 1 lacks
#: 2^16 of its keys and is refreshed with them.  On equal shards the fast
#: fit's extra segments (amzn64 PGM) and knots (osm RS) outgrow the leaf
#: rows; amzn64's RS fast fit has fewer knots than the greedy, and a PGM
#: tier whose shard 0 holds 1.5 quarters has rows with room for it
REFRESH_CASES = (
    ("amzn64", "PGM", (0, 1, 2, 3, 4), ("fast", "scan"), False),
    ("osm", "RS", (0, 1, 2, 3, 4), ("fast", "scan"), False),
    ("amzn64", "RS", (0, 1, 2, 3, 4), ("fast",), True),
    ("amzn64", "PGM", (0, 1.5, 2.5, 3.25, 4), ("fast",), True),
)


def same_leaves(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes()
        for k in a)


def corridor_bound(recurrence: str, n_tables: int, length: int, steps: int) -> dict:
    """The least time of one corridor launch over ``n_tables`` rows of
    ``length`` elements with no live count: each f64 key read once (RS
    reads one past the last element), one flag byte written an element,
    ε once a table; the f64 operations of every step at the f64 peak.
    Beside it, the latency bound of a thread that walks ``steps``
    dependent steps (``CORRIDOR_CHAIN_CYCLES``)."""
    reach = length + (1 if recurrence == "rs" else 0)
    n_bytes = n_tables * (reach * 8 + length + 8)
    ops = n_tables * length * CORRIDOR_STEP_OPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F64_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops,
            "latency_bound_ms": steps * CORRIDOR_CHAIN_CYCLES[recurrence] / SM_CLOCK_HZ * 1e3}


def timed(dev, fn):
    """``fn()`` and its host seconds around a synchronise."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tier_state(sidx) -> dict:
    out = {f"leaf:{k}": v.clone() for k, v in sidx.index.arrays.items()}
    out.update({k: getattr(sidx, k).clone() for k in ("tables", "fences", "counts", "offsets",
                                                      "lasts")})
    return out


def restore_tier(sidx, state: dict) -> None:
    for k, v in sidx.index.arrays.items():
        v.copy_(state[f"leaf:{k}"])
    for k in ("tables", "fences", "counts", "offsets", "lasts"):
        getattr(sidx, k).copy_(state[k])


def same_state(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def same_model(kind: str, a: dict, b: dict, row: int) -> bool:
    """Two tier states hold the same model in shard ``row``: every leaf's
    live prefix (the pad past it differs: the device program fills the
    host build's sentinels, ``refresh_shard`` repeats the last entry) and
    every other tensor of the tier, bit for bit."""
    def live(state):
        leaf = {k[5:]: v[row] for k, v in state.items() if k.startswith("leaf:")}
        if kind == "PGM":
            kv = int(leaf["sizes"].sum())
            cut = {k: kv for k in ("keys", "slope", "pk_u0", "pk_slope")}
            cut["rank0"] = kv + leaf["sizes"].numel()
        else:
            cut = {k: int(leaf["m_valid"]) for k in ("knot_keys", "knot_ranks", "rk_u0", "rk_slope")}
        return {k: v[:cut[k]] if k in cut else v for k, v in leaf.items()}

    rest = [k for k in a if not k.startswith("leaf:")]
    others = [k for k in a if k.startswith("leaf:")]
    return (same_state(live(a), live(b)) and all(torch.equal(a[k], b[k]) for k in rest)
            and all(torch.equal(torch.cat([a[k][:row], a[k][row + 1:]]),
                                torch.cat([b[k][:row], b[k][row + 1:]])) for k in others))


def events_around(dev, fn, syncless: bool = True):
    """``fn()`` (under ``no_host_sync`` unless ``syncless`` is False), and
    its device ms between two CUDA events recorded around it (None off the
    card)."""
    if dev.type != "cuda":
        return fn(), None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with no_host_sync(dev) if syncless else contextlib.nullcontext():
        start.record()
        out = fn()
        end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def no_host_sync(dev):
    """Raise on any host sync inside (``torch.cuda.set_sync_debug_mode``)."""
    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def check_batched(what, bm, q_dev) -> None:
    got = bm.lookup(q_dev, backend="kernel")
    want = torch.searchsorted(bm.tables, q_dev, right=True) - 1
    if not torch.equal(got, torch.minimum(want, bm.counts[:, None] - 1)):
        fail(f"fits: {what} ranks differ from torch.searchsorted")


def rmi_windows_hold(what, bm) -> None:
    """Every key of every table lies in its own window (a window may start
    one past the rank, as RMI's does in a gap)."""
    for i, part in enumerate(bm.unstack()):
        t = bm.tables[i]
        lo, hi = part.intervals(t, t)
        if not windows_hold(lo, hi, torch.arange(t.numel(), device=t.device)):
            fail(f"fits: a window of {what} table {i} misses its key's rank")


def phase_device_fits(dev, tables: dict, host: dict, nq_shard: int, lead: str) -> tuple:
    """Phase 5e: ``build_many(fit="vmap"/"fast"/"auto")``, ``build_grid``
    and ``device_refresh`` on phase 5's tiers (each table in 4 shards),
    against phase 5's ``fit="host"`` leaves (``host``: (table, kind) ->
    (statics, leaves, build seconds, each table's info)),
    ``torch.searchsorted`` and the host builds; ``fit="auto"`` and
    ``build_grid`` on the ``lead`` table's tier; then the corridor
    kernel's times and its twin check."""
    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch import tune
    from repro_torch.core import keys
    from repro_torch.core.pgm import FAST_CHUNK, pgm_fit_fast
    from repro_torch.core.radix_spline import rs_knots_fast
    from repro_torch.data import make_queries
    from repro_torch.dist import sharded_index as tsi
    from repro_torch.kernels.corridor_scan import (
        EXACT_CHUNK, corridor_scan, corridor_scan_exact, corridor_scan_exact_twin,
        corridor_scan_twin)

    rows, builds, refresh_rows, grid_rows = [], {}, [], []
    host_info = {k: v[3] for k, v in host.items()}
    tiers = {}
    for ds, (table, _) in tables.items():
        shards = np.split(table, 4)
        qs = np.stack([make_queries(s, nq_shard, seed=1) for s in shards])
        tiers[ds] = (shards, keys.encode(qs, dev))

    t_phase = time.perf_counter()
    kernels.reset_launches()
    # -- build_many on the lead tier: vmap, fast, auto (the other tier's
    # repeat of the same fits is cut; its RS tier is refreshed below) --
    for ds, (shards, q_dev) in tiers.items():
        if ds != lead:
            continue
        for fit, kinds in (("vmap", FIT_KINDS), ("fast", FAST_FIT_KINDS), ("auto", AUTO_KINDS)):
            for kind in kinds:
                before = kernels.launches()["corridor_scan"]
                bm, build_s = timed(dev, lambda: tune.build_many(kind, shards, fit=fit, device=dev))
                corridor = kernels.launches()["corridor_scan"] - before
                static, want, host_s = host[(ds, kind)][:3]
                have = bm.index.to_numpy()
                if kind in ("RMI", "SY-RMI"):
                    if not np.array_equal(have["leaf_r"], want["leaf_r"]) or \
                            bm.index.static != static:
                        fail(f"fits: {ds}/{kind} fit={fit} leaf_r or statics differ from host")
                    rmi_windows_hold(f"{ds}/{kind}", bm)
                    note = f"leaf_r == host, every key in its window, bit-equal to host: " \
                           f"{same_leaves(have, want)}"
                elif fit in ("vmap", "auto"):
                    if not same_leaves(have, want) or bm.index.static != static:
                        fail(f"fits: {ds}/{kind} fit={fit} leaves differ from fit='host'")
                    note = "leaves == host, bit for bit"
                else:  # fast: a valid fit, not the greedy's boundaries
                    seg_key = "m" if kind == "RS" else "n_segments_l0"
                    note = (f"{seg_key} {[m['info'][seg_key] for m in bm.meta]} (host "
                            f"{[i[seg_key] for i in host_info[(ds, kind)]]})")
                    if kind == "PGM_M":
                        note += (f", eps {[m['info']['eps'] for m in bm.meta]} (host "
                                 f"{[i['eps'] for i in host_info[(ds, kind)]]})")
                    else:
                        fast = pgm_fit_fast if kind == "PGM" else rs_knots_fast
                        eps_t = torch.full((4,), float(tix.spec_for(kind).eps),
                                           dtype=torch.float64, device=dev)
                        _, ok = fast(keys.to_f64(bm.tables), eps_t)
                        note += f", ok {ok.tolist()}, {int((~ok).sum())} fell back to the scan"
                if dev.type == "cuda" and fit in ("vmap", "fast") and kind in ("PGM", "RS") \
                        and corridor != 1:
                    fail(f"fits: {ds}/{kind} fit={fit} took {corridor} corridor launches, not 1")
                check_batched(f"{ds}/{kind} fit={fit}", bm, q_dev)
                builds[(ds, kind, fit)] = build_s
                builds.setdefault((ds, kind, "host"), host_s)
                rows.append({"table": ds, "kind": kind, "fit": fit, "build_s": build_s,
                             "host_build_s": host_s, "corridor_launches": corridor, "note": note})
                log(f"[fits] {ds}/{kind} fit={fit}: build {build_s:.2f} s (host {host_s:.2f} s), "
                    f"{corridor} corridor launches, exact vs searchsorted; {note}")

    log(f"[fits] build_many done at {time.perf_counter() - t_phase:.1f} s")

    # -- build_grid on one shard: RMI/SY-RMI at one b x every root, PGM and RS eps grids --
    shard = tiers[lead][0][0]
    n = len(shard)
    b = max(2, int(2.0 / 100.0 * n * 8 * 0.05))  # SY-RMI's default b at n keys
    roots = ("linear", "cubic", "spline")
    specs = [tix.RMISpec(b=b, root_type=r) for r in roots]
    specs += [tix.SYRMISpec(winner_root=r) for r in roots]
    specs += [tix.PGMSpec(eps=e) for e in (16, 32, 64, 128)]
    specs += [tix.RSSpec(eps=e) for e in (16, 32)]
    before = kernels.launches()["corridor_scan"]
    built, grid_s = timed(dev, lambda: tune.build_grid(specs, shard, device=dev))
    grid_corridor = kernels.launches()["corridor_scan"] - before
    if dev.type == "cuda" and grid_corridor != 2:
        fail(f"fits: build_grid took {grid_corridor} corridor launches, not one per scan kind")
    t_dev = keys.encode(shard, dev)
    q_dev = tiers[lead][1][0]
    want_r = torch.searchsorted(t_dev, q_dev, right=True) - 1
    for spec, idx in zip(specs, built):
        if idx.kind != spec.kind:
            fail(f"fits: build_grid lost the spec order at {spec}")
        host_idx = tix.build(spec, shard, device=dev)
        got = idx.lookup(t_dev, q_dev, backend="kernel")
        misses = int((got != want_r).sum())
        if spec.kind in ("PGM", "RS"):
            if not same_leaves(idx.to_numpy(), host_idx.to_numpy()) or misses:
                fail(f"fits: build_grid entry {spec}: leaves differ from its host build or "
                     f"{misses} kernel ranks are wrong")
        else:
            # the kernel path of a cubic RMI at this b misses ranks on the
            # host build too (ROADMAP queue 3): hold the entry to its host
            # build's kernel ranks, and the xla backend to searchsorted
            lo, hi = idx.intervals(t_dev, t_dev)
            if not windows_hold(lo, hi, torch.arange(n, device=dev)) or \
                    not np.array_equal(idx.to_numpy()["leaf_r"], host_idx.to_numpy()["leaf_r"]) or \
                    not torch.equal(got, host_idx.lookup(t_dev, q_dev, backend="kernel")) or \
                    not torch.equal(idx.lookup(t_dev, q_dev, backend="xla"), want_r):
                fail(f"fits: build_grid entry {spec} differs from its host build")
        grid_rows.append({"spec": spec.display_name(), "space_bytes": idx.space_bytes(),
                          "kernel_misses": misses})
        if misses:
            log(f"[fits] build_grid {spec.display_name()}: the kernel misses {misses} of "
                f"{q_dev.numel()} ranks, as its host build's kernel does (xla exact)")
    log(f"[fits] build_grid of {len(specs)} specs on {lead} shard 0 ({n} keys): "
        f"{grid_s:.2f} s, {grid_corridor} corridor launches (PGM, RS), RMI/SY-RMI at b = {b} in "
        f"one leaf fit; spec order kept, every entry == its host build (PGM/RS leaves bit for "
        f"bit, kernel ranks exact; RMI/SY-RMI leaf_r, windows, kernel ranks, xla exact)")

    log(f"[fits] build_grid done at {time.perf_counter() - t_phase:.1f} s")

    # -- device_refresh (REFRESH_CASES): shard 1 built without 2^16 of its keys,
    # refreshed with them --
    for ds, kind, quarters, fits, must in REFRESH_CASES:
        table, qs = tables[ds]
        cuts = [int(c * len(table) // 4) for c in quarters]
        rng = np.random.default_rng(2030)
        held = np.sort(rng.choice(np.arange(cuts[1] + 8, cuts[2] - 8), len(table) >> 8,
                                  replace=False))
        base = np.delete(table, held)
        bounds = [c - (len(held) if i >= 2 else 0) for i, c in enumerate(cuts)]
        merged = table[cuts[1]:cuts[2]]
        q_dev = keys.encode(qs, dev)
        eps = tix.spec_for(kind).eps
        sidx = tsi.ShardedIndex.build(kind, base, 4, bounds=bounds, device=dev)
        m = int(sidx.tables.shape[1])
        old = tier_state(sidx)
        host_state = None
        if "scan" in fits:
            host_idx = tix.build(kind, tsi.shard_build_table(kind, merged, m), device=dev)
            tsi.refresh_shard(sidx, 1, host_idx, merged)
            host_state = tier_state(sidx)
        what = f"{ds}/{kind} (shards {'equal' if quarters[1] == 1 else quarters})"
        for fit in fits:
            restore_tier(sidx, old)
            row_dev = keys.encode(merged, dev)  # the merged row's copy
            checks = {}
            (ok, refresh_ms), refresh_s = timed(dev, lambda: events_around(dev, lambda: (
                tune.device_refresh(sidx, 1, row_dev, eps, fit=fit, checks=checks)[1])))
            ok = bool(ok)
            failed = sorted(k for k, v in checks.items() if not bool(v))
            if ok != (not failed):
                fail(f"fits: {what} fit={fit}: ok {ok} disagrees with its checks {failed}")
            if (fit == "scan" or must) and not ok:
                fail(f"fits: {what} device_refresh(fit={fit!r}) refused the merged shard: "
                     f"{failed} failed")
            if fit == "scan" and not same_model(kind, tier_state(sidx), host_state, 1):
                fail(f"fits: {what} device_refresh(fit='scan') differs from the host refresh "
                     "of the merged shard")
            live = keys.encode(table if ok else base, dev)
            want = torch.searchsorted(live, q_dev, right=True) - 1
            if not torch.equal(tsi.sharded_lookup(sidx, q_dev, backend="kernel"), want):
                fail(f"fits: {what} fit={fit} lookups after the refresh are not exact")
            del live, want
            restore_tier(sidx, old)
            crossing = torch.cat([row_dev[1:], sidx.fences[2:3]])
            bad_checks = {}
            bad_ok, _ = events_around(dev, lambda: tune.device_refresh(
                sidx, 1, crossing, eps, fit=fit, checks=bad_checks)[1])
            if bool(bad_ok) or bool(bad_checks["fences"]) or \
                    not same_state(tier_state(sidx), old):
                fail(f"fits: {what} fit={fit}: a crossing row was not refused on its fence, or "
                     "the refusal changed the tier")
            refresh_rows.append({"table": ds, "kind": kind, "shard_quarters": list(quarters),
                                 "fit": fit, "ok": ok, "failed_checks": failed,
                                 "refresh_s": refresh_s, "refresh_ms": refresh_ms})
            log(f"[fits] {what} device_refresh fit={fit}: ok {ok}"
                f"{f' ({failed} failed)' if failed else ''}, no host sync, {refresh_ms} ms "
                f"(events; {refresh_s:.3f} s host clock); lookups exact on the "
                f"{'merged' if ok else 'old'} keys{'; scan == host refresh' if fit == 'scan' else ''}"
                "; a crossing row refused on its fence, tier bit-identical")
        del sidx, old, host_state
    log(f"[fits] device_refresh done at {time.perf_counter() - t_phase:.1f} s")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"[fits] device-fit path launches: {json.dumps(launches)}")

    # -- the corridor kernels: forms, times, twin and oracle checks (not counted) --
    shards = tiers[lead][0]
    keys_f = keys.to_f64(keys.encode(np.stack(shards), dev))
    n = keys_f.shape[1]
    eps = torch.full((4,), 64.0, dtype=torch.float64, device=dev)
    cases = []
    for rec, length, form in (("pgm", n, "blocked"), ("rs", n - 1, "blocked"),
                              ("pgm", n, "exact"), ("rs", n - 2, "exact")):
        if form == "blocked":
            chunk = FAST_CHUNK

            def call(rec=rec, length=length):
                return corridor_scan(keys_f, eps, recurrence=rec, length=length, chunk=FAST_CHUNK)

            def plain(rec=rec, length=length):
                return corridor_scan_twin(keys_f, eps, recurrence=rec, length=length,
                                          chunk=FAST_CHUNK)
        else:
            chunk = min(EXACT_CHUNK, length)

            def call(rec=rec, length=length):
                return corridor_scan_exact(keys_f, eps, recurrence=rec, length=length)

            def plain(rec=rec, length=length):
                return corridor_scan_exact_twin(keys_f, eps, recurrence=rec, length=length)
        got, _ = events_around(dev, call)  # no host sync
        ms = device_ms(call, dev, reps=20 if form == "blocked" else 5, warmup=1)
        want, plain_ms = events_around(dev, plain, syncless=False)
        checked = "the twin"
        err = int((got != want).sum())
        oracle_ms = None
        if form == "exact":  # the one-thread walk of each whole row, timed once
            oracle, oracle_ms = events_around(dev, lambda rec=rec, length=length: corridor_scan(
                keys_f, eps, recurrence=rec, length=length, chunk=length))
            err += int((got != oracle).sum())
            checked = "the twin and the one-thread oracle over the whole rows"
        if err:
            fail(f"fits: corridor_scan {rec}/{form} differs from {checked} at {err} flags")
        rows_n = 4 * -(-length // chunk)
        case = {"case": f"{rec}-{form}", "rows": rows_n, "length": length, "chunk": chunk,
                "ms": ms, "plain_ms": plain_ms, "oracle_ms": oracle_ms, "max_abs_err": err,
                "checked": checked, "flags": int(got.sum()),
                **corridor_bound(rec, 4, length, min(length, chunk))}
        cases.append(case)
        log(f"[fits] corridor_scan {rec} {form} over 4 x {length} ({rows_n} chunks of {chunk}): "
            f"{ms} ms, twin {plain_ms} ms"
            f"{f', one-thread oracle {oracle_ms} ms' if form == 'exact' else ''}, bound "
            f"{case['bound_ms']:.4f} ms ({case['bound_by']}), one chunk's latency bound "
            f"{case['latency_bound_ms']:.4f} ms, {case['flags']} flags; == {checked}")
    head, exact = cases[0], cases[2]
    entry = {**CORRIDOR_KERNEL, "launches": launches["corridor_scan"],
             "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": head["ms"],
             "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
             "bound_by": head["bound_by"], "library_ms": None,
             "path": "build_many(fit=vmap/fast/auto), build_grid, device_refresh (phase 5e)",
             "headline_case": f"{lead} tier, {head['case']} (the fast fit's launch); the "
                              "launches count both forms",
             "cases": cases}
    exact_entry = {**CORRIDOR_EXACT_KERNEL, "launches": launches["corridor_scan_exact"],
                   "max_abs_err": max(c["max_abs_err"] for c in cases[2:]), "ms": exact["ms"],
                   "plain_ms": exact["plain_ms"], "bound_ms": exact["bound_ms"],
                   "bound_by": exact["bound_by"], "library_ms": None,
                   "path": "build_many(fit=vmap/auto), build_grid, device_refresh(fit=scan) "
                           "(phase 5e)",
                   "headline_case": f"{lead} tier, {exact['case']} (eps 64)",
                   "cases": cases[2:]}
    summary = {f"{ds}/{kind}": {fit: builds.get((ds, kind, fit)) for fit in FITS_ORDER}
               for ds in tiers for kind in KINDS if (ds, kind, "host") in builds}
    log(f"[fits] build seconds by fit: {json.dumps(summary)}")
    return {"rows": rows, "grid": grid_rows, "refresh": refresh_rows, "launches": launches,
            "corridor": entry, "corridor_exact": exact_entry}


# -- phase 5f: the tuner ---------------------------------------------------------------------

#: the kernels phase 5f's main path must launch (sweep, mining, the tiers'
#: lookups, build_grid's and device_refresh's corridor scans)
TUNER_KERNELS = ("rmi_search", "pgm_search", "rs_search", "kary_search", "batched_rmi_search",
                 "batched_pgm_search", "corridor_scan", "corridor_scan_exact")
#: the space budgets (% of the table) of the frontier's picks
BUDGET_PCTS = (0.05, 0.7, 2.0, 10.0)
#: the kinds of the retune's grid (PGM_M's bisection is swept in 5f-a
#: already; PGM's and RS's candidates are cut for the run's time limit,
#: which phase 10 shares: 5f-a sweeps RS's grid)
RETUNE_KINDS = ("SY-RMI",)


class SearchSorted:
    """``torch.searchsorted`` behind the ``lookup`` of an index, so the
    sweep's timing (best of ``reps`` wall times, a sync after each call)
    times the paper's yardstick the same way."""

    def lookup(self, table, queries, backend=None):
        return torch.searchsorted(table, queries, right=True) - 1


def tier_queries(rng, shards, n: int, hot: float = 0.0) -> np.ndarray:
    """``n`` queries a shard sampled from the shards' keys; with ``hot`` > 0
    that share of all of them from shard 0 instead."""
    total = n * len(shards)
    if hot <= 0:
        qs = np.concatenate([rng.choice(s, n) for s in shards])
    else:
        n_hot = int(hot * total)
        qs = np.concatenate([rng.choice(shards[0], n_hot),
                             rng.choice(np.concatenate(shards), total - n_hot)])
    return np.sort(qs).astype(np.uint64)  # sorted: numpy's check walks the table once


class TierModel:
    """The host model of a ``TunedTier``'s counters: what ``metrics()``
    must equal after every step."""

    FIELDS = ("lookups", "ingested", "absorbed", "overflowed", "duplicates", "shard_compactions",
              "shard_refreshes", "retunes", "forced_restacks", "pending")

    def __init__(self, n_shards: int):
        self.c = {f: 0 for f in self.FIELDS}
        self.c.update(rebalances=0, rebalance_moved_keys=0)
        self.routing = {"lookups": 0, "queries": 0, "dropped": 0, "routed_max": 0,
                        "routed_even": 0.0, "imbalance_last": 0.0, "imbalance_peak": 0.0}
        self.n_shards = n_shards

    def lookup(self, fences: np.ndarray, queries: np.ndarray) -> None:
        hist = np.bincount(np.searchsorted(fences[1:], queries, side="right"),
                           minlength=self.n_shards)
        even = len(queries) / self.n_shards
        r = self.routing
        r["lookups"] += 1
        r["queries"] += len(queries)
        r["routed_max"] += int(hist.max())
        r["routed_even"] += even
        r["imbalance_last"] = float(hist.max() / even)
        r["imbalance_peak"] = max(r["imbalance_peak"], r["imbalance_last"])
        self.c["lookups"] += 1

    def check(self, what: str, tier) -> dict:
        m = tier.metrics()
        got = {k: m[k] for k in self.c}
        routing = {k: m["routing"][k] for k in self.routing}
        if got != self.c or routing != self.routing:
            fail(f"tuner: {what}: metrics {got} {routing} != host model {self.c} {self.routing}")
        return m


def check_tier_ranks(what: str, tier, queries: np.ndarray, served: np.ndarray) -> None:
    got = tier.lookup(queries).cpu().numpy()
    want = np.searchsorted(served, queries, side="right") - 1
    if not np.array_equal(got, want):
        fail(f"tuner: {what}: {int((got != want).sum())} of {len(queries)} ranks differ "
             "from numpy on the live keys")


def served_keys(tier) -> np.ndarray:
    """The keys a tier answers from: its shards' live keys."""
    return np.concatenate([tier._shard_keys(s) for s in range(tier.sidx.n_shards)])


def restore_launches(saved: dict) -> None:
    """Set every kernel's launch count back to ``saved`` (probes that
    measure a path do not count as its launches)."""
    from repro_torch import kernels

    for mod in kernels.KERNEL_MODULES:
        name = mod.__name__.rsplit(".", 1)[-1]
        mod.LAUNCHES = saved[name]
        if hasattr(mod, "BATCHED_LAUNCHES"):
            mod.BATCHED_LAUNCHES = saved[f"batched_{name}"]
        if hasattr(mod, "EXACT_LAUNCHES"):
            mod.EXACT_LAUNCHES = saved[f"{name}_exact"]


def telemetry_cost(dev, tier, model, qs: np.ndarray, reps: int = 20) -> dict:
    """5f-d: ``sharded_lookup`` on the tier with telemetry off and on (ms a
    call, CUDA events; launches of each), and ``timed_lookup``'s host and
    device phases over ``reps`` calls of ``tier.lookup`` (a private
    registry; ``model`` follows the tier's counters).  The probes' launches
    are not the path's: the counts are restored after them."""
    from repro_torch import kernels, obs
    from repro_torch.core import keys
    from repro_torch.dist import sharded_index as tsi

    saved = kernels.launches()
    sidx, q_dev = tier.sidx, keys.encode(qs, dev)
    counts = {}
    for flag in (False, True):
        kernels.reset_launches()
        tsi.sharded_lookup(sidx, q_dev, backend="kernel", telemetry=flag)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts[flag] = kernels.launches()
    if counts[True] != counts[False] or (dev.type == "cuda" and sum(counts[False].values()) != 1):
        fail(f"tuner: telemetry changed the launches: off {counts[False]}, on {counts[True]}")
    off_ms = device_ms(lambda: tsi.sharded_lookup(sidx, q_dev, backend="kernel"), dev)
    on_ms = device_ms(lambda: tsi.sharded_lookup(sidx, q_dev, backend="kernel", telemetry=True),
                      dev)
    reg = obs.Registry()
    fences = keys.decode(sidx.fences)
    for _ in range(reps):
        obs.timed_lookup(tier, q_dev, tier="5f", registry=reg)
        model.lookup(fences, qs)
    snap = reg.snapshot()
    lab = dict(kind=tier.spec.kind, backend=tier.policy.backend, tier="5f")
    host = obs.find_sample(snap, "lookup_latency_us", **lab, phase="host")
    devp = obs.find_sample(snap, "lookup_latency_us", **lab, phase="device")
    restore_launches(saved)
    row = {"off_ms": off_ms, "on_ms": on_ms,
           "added_ms": None if off_ms is None else on_ms - off_ms,
           "launches_off": counts[False], "launches_on": counts[True],
           "timed_lookup_host_us": host["sum"] / host["count"],
           "timed_lookup_device_us": devp["sum"] / devp["count"],
           "timed_lookup_device_p50_us": obs.hist_quantile(devp, 0.5), "reps": reps}
    log(f"[tuner] telemetry on {tier.spec.display_name()}, {len(qs)} queries: off {off_ms} ms, "
        f"on {on_ms} ms (CUDA events, 20 calls); search launches off == on "
        f"({sum(counts[False].values())}); timed_lookup over {reps} calls: host "
        f"{row['timed_lookup_host_us']:.1f} us, device {row['timed_lookup_device_us']:.1f} us "
        f"(mean; device p50 ~{row['timed_lookup_device_p50_us']:.1f} us)")
    return row


def phase_tuner(dev, tables: dict, nq: int, nq_shard: int, lead: str, stride: int = 1) -> dict:
    """Phase 5f: the paper's tuning procedure on the search kernels, at
    phase 4's size.  5f-a the frontier (``sweep`` over ``candidate_grid``
    on ``kernel`` on every ``stride``-th key of ``lead``, every candidate
    exact, budget picks, the report's round trip), 5f-b SY-RMI mining on ``lead`` and the mined SY-RMI at 2% on
    it,
    5f-c a ``TunedTier``'s lifecycle on ``lead`` split in 4 shards (the
    device and the host refresh, GAPPED absorb/overflow/compact, a retune,
    a rebalance; ranks == numpy and ``metrics()`` == a host model after
    every step), 5f-d what telemetry costs."""
    from repro_torch import index as tix
    from repro_torch import kernels, obs
    from repro_torch import tune
    from repro_torch.core import keys
    from repro_torch.tune.pareto import _time_lookup

    out = {"seconds": {}}
    t_phase = time.perf_counter()
    kernels.reset_launches()

    # -- 5f-a: the frontier ------------------------------------------------------------------
    t0 = time.perf_counter()
    table = tables[lead][0]
    n = len(table)
    # on the card swept on every other key (2^23 of the 2^24): the sweep's
    # host builds were the run's largest cost, and the run's time limit is
    # shared with phase 10 (a cut of scale, not of width or checks; PERF.md §4)
    swept = table[::stride]
    m = len(swept)
    cands = tune.sweep(swept, n_queries=nq, reps=3, fit="auto", check_exact=True, device=dev)
    want_specs = [s for s in tune.candidate_grid(m) if "kernel" in tix.impls.query_impl(
        s.kind).backends]
    if [c.spec for c in cands] != want_specs:
        fail("tuner: the sweep's candidates are not candidate_grid's kernel kinds")
    bad = [c.spec.display_name() for c in cands if not c.exact]
    if bad:
        fail(f"tuner: sweep candidates not exact on kernel: {bad}")
    q_np = np.random.default_rng(0).choice(swept, size=min(nq, max(16, m)))
    t_dev, q_dev = keys.encode(swept, dev), keys.encode(q_np, dev)
    ss_ns = _time_lookup(SearchSorted(), t_dev, q_dev, "kernel", 3) / len(q_np) * 1e9
    rows = []
    for c in cands:
        row = {"kind": c.kind, "spec": c.spec.display_name(), "space_bytes": c.space_bytes,
               "space_pct": c.space_pct_of(m), "ns_per_query": c.ns_per_query,
               "build_s": c.build_s, "exact": c.exact}
        rows.append(row)
        log(f"[tuner] {row['spec']}: space {row['space_pct']:.5f}% ({c.space_bytes} B), "
            f"{c.ns_per_query:.4f} ns a query, build {c.build_s:.3f} s, exact")
    log(f"[tuner] torch.searchsorted on the same {len(q_np)} queries: {ss_ns:.4f} ns a query")
    front = tune.pareto_frontier(cands)
    spaces, times = [c.space_bytes for c in front], [c.ns_per_query for c in front]
    if spaces != sorted(set(spaces)) or any(a <= b for a, b in zip(times, times[1:])):
        fail(f"tuner: the frontier is not strictly monotone: {spaces} {times}")
    log(f"[tuner] frontier: {[c.spec.display_name() for c in front]}")
    picks = {}
    for pct in BUDGET_PCTS:
        best = tune.best_candidate_for_budget(cands, m, pct)
        if best is None or best.space_bytes > pct / 100.0 * m * 8:
            fail(f"tuner: budget {pct}%: pick {best} does not fit")
        picks[pct] = best.spec.display_name()
        log(f"[tuner] budget {pct}%: {best.spec.display_name()} ({best.space_pct_of(m):.5f}%, "
            f"{best.ns_per_query:.4f} ns a query)")
    report = json.loads(json.dumps(tune.frontier_report(swept, cands, front)))
    if tune.report_specs(report) != [c.spec for c in front] or \
            tune.report_specs(report, "candidates") != [c.spec for c in cands]:
        fail("tuner: frontier_report does not round-trip through report_specs")
    out.update(frontier=rows, frontier_specs=[c.spec.display_name() for c in front],
               picks=picks, searchsorted_ns=ss_ns, swept_keys=m)
    del cands, front, swept, t_dev, q_dev
    out["seconds"]["5f-a"] = time.perf_counter() - t0
    log(f"[tuner] 5f-a frontier done in {out['seconds']['5f-a']:.1f} s")

    # -- 5f-b: SY-RMI mining -----------------------------------------------------------------
    t0 = time.perf_counter()
    # mined on the lead table alone (the second table's mining is cut for
    # the run's time limit); the mined spec is checked on both
    mined = tune.mine_sy_rmi([tables[lead][0]], device=dev)
    grid = tune.cdfshop_grid(n)
    votes = {lead: grid[int(np.argmin(mined.sweep_times[0]))].root_type}
    log(f"[tuner] mining: UB {mined.ub!r}, votes {votes}, winner "
        f"{mined.winner_root}, {mined.mining_time:.1f} s")
    mining = {"ub": mined.ub, "votes": votes, "winner": mined.winner_root,
              "mining_s": mined.mining_time, "tables": {}}
    spec = tix.SYRMISpec(space_pct=2.0, ub=mined.ub, winner_root=mined.winner_root)
    # checked on the lead table (the second table's repeat is cut for the
    # run's time limit)
    for ds, (tab, qs) in ((lead, tables[lead]),):
        idx = tix.build(spec, tab, device=dev)
        td, qd = keys.encode(tab, dev), keys.encode(qs, dev)
        want = torch.searchsorted(td, qd, right=True) - 1
        miss = {be: int((idx.lookup(td, qd, backend=be) != want).sum()) for be in ("kernel",
                                                                                  "xla")}
        pct = 100.0 * idx.space_bytes() / (8 * len(tab))
        log(f"[tuner] mined {spec.display_name()} on {ds}: b {idx.info['b']}, space {pct:.4f}%, "
            f"misses kernel {miss['kernel']} xla {miss['xla']} of {len(qs)}")
        if miss["xla"] or (miss["kernel"] and spec.winner_root != "cubic"):
            fail(f"tuner: the mined SY-RMI on {ds} misses ranks: {miss}")
        if miss["kernel"]:
            log(f"[tuner] {ds}: the cubic root's kernel misses (ROADMAP queue 3), xla exact")
        mining["tables"][ds] = {"b": idx.info["b"], "space_pct": pct, "misses": miss}
        del idx
    out["mining"] = mining
    out["seconds"]["5f-b"] = time.perf_counter() - t0
    log(f"[tuner] 5f-b mining done in {out['seconds']['5f-b']:.1f} s")

    # -- 5f-c: a TunedTier's lifecycle on lead's 4 x n/4 tier ------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    held = np.arange(1, n, 64)  # every 64th key out: room in every shard's padded row
    base = np.delete(table, held)
    lifecycle = []

    def step(what, tier, model, queries=None, seconds=None):
        served = served_keys(tier)
        if queries is None:
            queries = tier_queries(rng, np.array_split(served, 4), nq_shard)
        model.lookup(keys.decode(tier.sidx.fences), queries)
        check_tier_ranks(what, tier, queries, served)
        m = model.check(what, tier)
        lifecycle.append({"step": what, "spec": m["spec"], "n_keys": m["n_keys"],
                          "seconds": seconds, **{k: m[k] for k in model.c}})
        log(f"[tuner] {what}: {m['spec']}, {m['n_keys']} keys, "
            f"{json.dumps({k: m[k] for k in model.c})}, ranks == numpy"
            + ("" if seconds is None else f", {seconds:.2f} s")
            + f" (at {time.perf_counter() - t0:.1f} s)")
        return m

    # PGM with the device refresh (scan): shard 1's held keys back in
    policy = tune.RebuildPolicy(shard_refresh_frac=0.01, retune_frac=10.0, device_refresh=True,
                                device_fit="scan")
    tier = tune.TunedTier(base, 4, policy, spec=tix.PGMSpec(eps=64), name="5f_pgm", device=dev)
    model = TierModel(4)
    step("PGM tier built", tier, model)
    fresh = table[held]
    owners = tier._owners(fresh)
    back = fresh[owners == 1]
    ok0 = obs.metric("device_refreshes").value(kind="PGM", outcome="ok")
    fb0 = obs.metric("device_refreshes").value(kind="PGM", outcome="fallback")
    _, secs = timed(dev, lambda: tier.insert_batch(back))
    ok = obs.metric("device_refreshes").value(kind="PGM", outcome="ok") - ok0
    fb = obs.metric("device_refreshes").value(kind="PGM", outcome="fallback") - fb0
    model.c["ingested"] += len(back)
    model.c["shard_refreshes"] += 1
    if ok + fb != 1:
        fail(f"tuner: PGM refresh counted {ok} ok and {fb} fallback device outcomes, not one")
    log(f"[tuner] PGM refresh of {len(back)} keys into shard 1: device_refreshes ok {ok:.0f} "
        f"fallback {fb:.0f}")
    step("PGM refresh (device arm)", tier, model, seconds=secs)
    out["device_refresh_outcome"] = "ok" if ok else "fallback"
    del tier

    # SY-RMI at 2% through the host refresh
    policy = tune.RebuildPolicy(shard_refresh_frac=0.01, retune_frac=10.0)
    tier = tune.TunedTier(base, 4, policy, spec=tix.SYRMISpec(space_pct=2.0), name="5f_syrmi",
                          device=dev)
    model = TierModel(4)
    step("SY-RMI tier built", tier, model)
    _, secs = timed(dev, lambda: tier.insert_batch(back))
    model.c["ingested"] += len(back)
    model.c["shard_refreshes"] += 1  # a forced restack instead fails the model's check
    step("SY-RMI refresh (host arm)", tier, model, seconds=secs)

    # 5f-d: what telemetry costs, on the SY-RMI tier
    t_d = time.perf_counter()
    out["telemetry"] = telemetry_cost(dev, tier, model, tier_queries(rng, np.array_split(
        served_keys(tier), 4), nq_shard))
    out["seconds"]["5f-d"] = time.perf_counter() - t_d
    model.check("after the telemetry probes", tier)

    # a retune: 2% of the table in fresh keys, over SY-RMI (RETUNE_KINDS)
    tier.policy = tune.RebuildPolicy(retune_frac=0.02, kinds=RETUNE_KINDS)
    extra = not_in(rng.integers(int(table[0]), int(table[-1]), int(0.03 * n), dtype=np.uint64),
                   table)
    news = np.concatenate([fresh[owners != 1], extra])
    _, secs = timed(dev, lambda: tier.insert_batch(news))
    model.c["ingested"] += len(news)
    model.c["retunes"] += 1
    m = step("retune", tier, model, seconds=secs)
    merged = served_keys(tier)
    rebuilt = tix.build(tier.spec, merged, device="cpu")
    if rebuilt.space_bytes() > 0.02 * 8 * len(merged) or m["retunes"] != 1:
        fail(f"tuner: the retune picked {tier.spec.display_name()} with "
             f"{rebuilt.space_bytes()} B > 2% of {len(merged)} keys")
    out["retune"] = {"spec": tier.spec.display_name(), "seconds": secs,
                     "space_pct": 100.0 * rebuilt.space_bytes() / (8 * len(merged))}
    log(f"[tuner] retune picked {out['retune']['spec']} ({out['retune']['space_pct']:.4f}% of "
        f"{len(merged)} keys) in {secs:.1f} s")
    del rebuilt

    # a rebalance: 90% of the queries in shard 0's key range
    tier.policy = tune.RebuildPolicy(retune_frac=10.0, kinds=RETUNE_KINDS, rebalance_imbalance=1.5)
    shards = [merged[int(c0):int(c0 + c)] for c0, c in zip(
        tier.sidx.offsets.cpu().numpy(), tier.sidx.counts.cpu().numpy())]
    imb_before, secs = None, 0.0
    width = int(tier.sidx.tables.shape[1])  # the stacked row's capacity before the rebalance
    for i in range(9):
        qs = tier_queries(rng, shards, nq_shard, hot=0.9)
        fences = keys.decode(tier.sidx.fences)
        model.lookup(fences, qs)
        before = tier.metrics()
        got, dt = timed(dev, lambda: tier.lookup(qs))
        if tier.metrics()["rebalances"] != before["rebalances"]:
            secs = dt
            new_counts = tier.sidx.counts.cpu().numpy()
            # a new shard wider than the stacked row cannot be refreshed in
            # place: the tier must restack at the new bounds, and only then
            if new_counts.max() > width:
                model.c["forced_restacks"] += 1
            log(f"[tuner] rebalance: new shard counts {new_counts.tolist()} against rows of "
                f"{width} keys: {'a forced restack' if new_counts.max() > width else 'in place'}")
            old_own = np.clip(np.searchsorted(fences, merged, side="right") - 1, 0, 3)
            new_own = np.repeat(np.arange(4), new_counts)
            model.c["rebalances"] += 1
            model.c["rebalance_moved_keys"] += int((old_own != new_own).sum())
            imb_before = model.routing["imbalance_last"]
        want = torch.searchsorted(keys.encode(merged, dev), keys.encode(qs, dev), right=True) - 1
        if not torch.equal(got, want):
            fail(f"tuner: rebalance lookup {i} differs from torch.searchsorted")
    # the same skew against the new fences
    m = step("rebalance", tier, model, queries=tier_queries(rng, shards, nq_shard, hot=0.9),
             seconds=secs)
    if m["rebalances"] != 1 or m["rebalance_moved_keys"] <= 0 or imb_before is None:
        fail(f"tuner: expected one rebalance moving keys, got {m['rebalances']} / "
             f"{m['rebalance_moved_keys']}")
    imb_after = m["routing"]["imbalance_last"]
    if not imb_after < imb_before:
        fail(f"tuner: imbalance {imb_before} did not fall after the rebalance ({imb_after})")
    log(f"[tuner] rebalance moved {m['rebalance_moved_keys']} keys; imbalance "
        f"{imb_before:.4f} -> {imb_after:.4f}; counts {tier.sidx.counts.tolist()}")
    out["rebalance"] = {"moved": m["rebalance_moved_keys"], "imbalance_before": imb_before,
                        "imbalance_after": imb_after, "seconds": secs,
                        "counts": tier.sidx.counts.tolist()}
    del tier

    # GAPPED on xla: inserts absorbed, a cluster into the delta, a compaction
    policy = tune.RebuildPolicy(retune_frac=10.0, backend="xla")
    tier = tune.TunedTier(base, 4, policy, spec=tix.GappedSpec(), name="5f_gapped", device=dev)
    model = TierModel(4)
    step("GAPPED tier built", tier, model)
    snap0 = obs.snapshot(prefix="mutation_")
    lo = int(np.searchsorted(base, table[held[100]]))
    cluster = not_in(rng.integers(int(base[lo]) + 1, int(base[lo + 64]), 700, dtype=np.uint64),
                     table)
    for what, batch in (("GAPPED insert (spread)", fresh[: 1 << 16]),
                        ("GAPPED insert (a cluster in one leaf)", cluster)):
        _, secs = timed(dev, lambda: tier.insert_batch(batch))
        d = obs.diff(snap0, obs.snapshot(prefix="mutation_"))
        snap0 = obs.snapshot(prefix="mutation_")
        model.c["ingested"] += len(batch)
        for f in ("absorbed", "overflowed", "duplicates"):
            model.c[f] += int(obs.sample_value(d, f"mutation_{f}", kind="GAPPED"))
        model.c["shard_compactions"] += int(obs.sample_value(d, "mutation_compactions",
                                                             kind="GAPPED"))
        step(what, tier, model, seconds=secs)
    m = tier.metrics()
    if not (m["absorbed"] > 0 and m["overflowed"] > 0 and m["shard_compactions"] >= 1):
        fail(f"tuner: GAPPED lifecycle did not absorb, overflow and compact: {m}")
    out["gapped"] = {k: m[k] for k in ("absorbed", "overflowed", "shard_compactions",
                                       "forced_restacks")}
    del tier
    out["lifecycle"] = lifecycle
    out["seconds"]["5f-c"] = time.perf_counter() - t0 - out["seconds"]["5f-d"]
    log(f"[tuner] 5f-c lifecycle done in {out['seconds']['5f-c']:.1f} s")

    # the main path's launches (the telemetry probes restored theirs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = kernels.launches()
    log(f"[tuner] phase 5f path launches: {json.dumps(out['launches'])}")
    if dev.type == "cuda" and any(out["launches"][k] == 0 for k in TUNER_KERNELS):
        fail(f"tuner: a kernel of the tuner's path never launched: {out['launches']}")
    # the registry, written and dumped through the CLI
    path = ROOT / "build" / "obs_5f.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obs.to_jsonl(obs.snapshot()))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dump = subprocess.run([sys.executable, "-m", "repro_torch.obs", "dump", str(path)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    if dump.returncode != 0 or "route_queries" not in dump.stdout:
        fail(f"tuner: python -m repro_torch.obs dump failed: {dump.stderr[-2000:]}")
    lines = dump.stdout.splitlines()
    log(f"[tuner] python -m repro_torch.obs dump {path.relative_to(ROOT)}: {len(lines)} lines")
    for line in lines:
        if line.startswith(("tier_", "device_refreshes", "rebalance_", "fit_", "mutation_",
                            "route_imbalance", "lookup_latency")):
            log(f"[tuner]   {line}")
    out["seconds"]["5f"] = time.perf_counter() - t_phase
    log(f"[tuner] phase 5f done in {out['seconds']['5f']:.1f} s: "
        f"{json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})}")
    return out


#: the concentrated-Zipf traffic of ``benchmarks/serve_slo.py``'s cache A/B
#: leg: Zipf a, the hot window of ranks (inside the cache), the phases that
#: shift it, and the cache's capacity
ZIPF_A = 1.15
HOT_SPAN = 2048
SLO_PHASES = 3
CACHE_CAP = 4096


def hot_queries(rng, table: np.ndarray, phase: int, n: int) -> np.ndarray:
    """``n`` queries inside the phase's ``HOT_SPAN``-rank hot window, Zipf
    over its ranks (``serve_slo.py:_hot_queries``)."""
    t = len(table)
    return table[(phase * t // SLO_PHASES + (rng.zipf(ZIPF_A, size=n) - 1) % HOT_SPAN) % t]


def hot_span(table: np.ndarray, phase: int) -> np.ndarray:
    t = len(table)
    return table[(phase * t // SLO_PHASES + np.arange(HOT_SPAN)) % t]


def timed_call(dev, fn) -> tuple:
    """``fn()`` with its host ms (around a synchronise) and its ms between
    two CUDA events (None off the card)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        return fn(), 1e3 * (time.perf_counter() - t0), None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), start.elapsed_time(end)


def phase_hotcache(dev, table: np.ndarray, *, batch: int, batches: int, n_insert: int) -> tuple:
    """Phase 5g: the learned hot-key cache on the card.  A 4-shard SY-RMI
    ``TunedTier`` (registry default spec, ``kernel``) of ``table`` with every
    64th key held out; the same concentrated-Zipf batches (3 phases of
    ``batches``) through the bare tier and through ``HotKeyCache(tier,
    capacity=CACHE_CAP)``, primed per phase as ``serve_slo.py`` primes it;
    every batch == ``torch.searchsorted``.  Then ``n_insert`` held-out keys
    of shard 1 inserted (a shard refresh): the cache counts the stale epoch,
    rebuilds, and stays exact.  Returns the rows and the cache, which
    phase 7b's engine takes as its tier."""
    from repro_torch import index as tix
    from repro_torch import kernels, tune
    from repro_torch.core import keys
    from repro_torch.serve import HotKeyCache

    t_phase = time.perf_counter()
    n = len(table)
    held = np.arange(1, n, 64)
    base = np.delete(table, held)
    policy = tune.RebuildPolicy(shard_refresh_frac=0.01, retune_frac=10.0)
    tier, build_s = timed(dev, lambda: tune.TunedTier(base, 4, policy, spec=tix.SYRMISpec(),
                                                       name="5g", device=dev))
    cache = HotKeyCache(tier, capacity=CACHE_CAP)
    rng = np.random.default_rng(7)
    warm = hot_queries(rng, base, 0, batch)
    traffic = [[hot_queries(rng, base, p, batch) for _ in range(batches)]
               for p in range(SLO_PHASES)]
    prime_batches = [hot_queries(rng, base, p, batch) for p in range(SLO_PHASES)]
    t_dev = keys.encode(base, dev)

    def check(what, served, qs, got) -> None:
        q_dev = keys.encode(qs, dev)
        want = torch.searchsorted(served, q_dev, right=True) - 1
        if not torch.equal(got.to(want.device), want):
            fail(f"hotcache: {what}: {int((got != want).sum())} of {len(qs)} ranks differ "
                 "from torch.searchsorted")

    def counters() -> dict:
        return cache.metrics()["hotcache"]

    if dev.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    legs = {}
    for label, target in (("off", tier), ("on", cache)):
        check(f"{label} warm-up", t_dev, warm, target.lookup(warm))  # untimed
        host, events, c0 = [], [], None
        for phase in range(SLO_PHASES):
            if target is cache:
                # the sketch follows the shifting hot set: the phase's span at
                # serve_slo.py's weight (4 x its batches of 1,024 queries) scaled
                # to this batch, so the once-decayed prime still outweighs the
                # earlier phases' counts; one batch; a rebuild
                cache.sketch.update(hot_span(base, phase), weight=4.0 * batches * batch / 1024)
                cache.sketch.update(prime_batches[phase])
                cache.rebuild()
            if c0 is None:
                c0 = counters()
            for i, qs in enumerate(traffic[phase]):
                got, h_ms, e_ms = timed_call(dev, lambda q=qs: target.lookup(q))
                check(f"cache-{label} phase {phase} batch {i}", t_dev, qs, got)
                host.append(h_ms)
                events.append(e_ms)
        c1 = counters()
        legs[label] = {
            "batches": len(host), "batch": batch,
            "host_ms_mean": float(np.mean(host)), "host_ms_median": float(np.median(host)),
            "events_ms_mean": None if events[0] is None else float(np.mean(events)),
            "events_ms_median": None if events[0] is None else float(np.median(events)),
            "hits": c1["hits"] - c0["hits"], "misses": c1["misses"] - c0["misses"],
            "rebuilds": c1["rebuilds"]}
        row = legs[label]
        log(f"[hotcache] cache-{label}: {row['batches']} batches of {batch} concentrated-Zipf "
            f"queries (a {ZIPF_A}, {HOT_SPAN}-rank hot span, {SLO_PHASES} phases), all == "
            f"searchsorted; ms a batch host {row['host_ms_mean']:.4f} mean / "
            f"{row['host_ms_median']:.4f} median, CUDA events {row['events_ms_mean']} mean / "
            f"{row['events_ms_median']} median"
            + (f"; hits {row['hits']}, misses {row['misses']}, rebuilds {row['rebuilds']}"
               if label == "on" else ""))
    served = legs["on"]["hits"] + legs["on"]["misses"]
    if served != SLO_PHASES * batches * batch or legs["on"]["hits"] == 0:
        fail(f"hotcache: the timed batches counted {legs['on']['hits']} hits and "
             f"{legs['on']['misses']} misses, not {SLO_PHASES * batches * batch} lookups")

    # the mutation leg: held-out keys of shard 1 back in (a shard refresh)
    fresh = table[held]
    back = fresh[tier._owners(fresh) == 1][:n_insert]
    c0, epoch0 = counters(), tier.epoch
    _, insert_s = timed(dev, lambda: cache.insert_batch(back))
    m = tier.metrics()
    if m["shard_refreshes"] + m["forced_restacks"] != 1 or m["pending"] != 0:
        fail(f"hotcache: inserting {len(back)} keys into shard 1 did not refresh it once: {m}")
    if not cache.stale():
        fail("hotcache: the insert left the cache fresh")
    merged = keys.encode(np.union1d(base, back), dev)
    for i, qs in enumerate(traffic[-1][:2] + [np.sort(back), rng.choice(back, batch)]):
        got, h_ms, e_ms = timed_call(dev, lambda q=qs: cache.lookup(q))
        check(f"after the insert, batch {i}", merged, qs, got)
        if i == 0:
            stale_ms = (h_ms, e_ms)
    c1 = counters()
    if c1["stale_detected"] - c0["stale_detected"] != 1 or c1["rebuilds"] - c0["rebuilds"] != 1:
        fail(f"hotcache: after the insert the cache counted {c1['stale_detected']} stale epochs "
             f"and {c1['rebuilds']} rebuilds (before: {c0['stale_detected']}, {c0['rebuilds']})")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launches()
    out = {"n_keys": int(len(base)), "build_s": build_s, "spec": tier.spec.display_name(),
           "legs": legs, "insert": {"keys": int(len(back)), "seconds": insert_s,
                                    "epochs": tier.epoch - epoch0, "stale_lookup_host_ms":
                                    stale_ms[0], "stale_lookup_events_ms": stale_ms[1]},
           "hotcache": c1, "space_bytes": cache.space_bytes(), "launches": launches}
    log(f"[hotcache] mutation: {len(back)} held-out keys into shard 1 in {insert_s:.2f} s "
        f"(epoch +{tier.epoch - epoch0}, {m['shard_refreshes']} refresh, "
        f"{m['forced_restacks']} forced restack); the next lookup counted hotcache_stale, "
        f"rebuilt ({stale_ms[0]:.2f} ms host, {stale_ms[1]} ms events) and 4 batches stayed == "
        f"searchsorted on the merged keys; counters {json.dumps(c1)}; residency "
        f"{cache.space_bytes()} B")
    log(f"[hotcache] {tier.spec.display_name()} tier of {len(base)} keys built in {build_s:.1f} s; "
        f"phase 5g path launches {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"done in {time.perf_counter() - t_phase:.1f} s")
    if dev.type == "cuda" and launches["batched_rmi_search"] == 0:
        fail("hotcache: the SY-RMI tier never launched batched_rmi_search")
    return out, cache


def phase_paged_pool(dev, *, seqs: int, positions: int, page: int) -> dict:
    """Phase 5h: ``PagedPool`` with its store on the device: ``seqs``
    sequences of ``positions`` positions in pages of ``page``, grown in
    turns (a sequence's page ids are not contiguous); ``position_lookup``
    of every position (the PGM over the page starts, eps 4) == ``pos //
    page`` arithmetic; a release and a re-allocation that takes the freed
    pages; ``MemoryError`` on an exhausted pool."""
    from repro_torch.serve import PagedPool

    t_phase = time.perf_counter()
    per = positions // page
    pool = PagedPool(n_pages=seqs * per, n_layers=1, page_size=page, n_kv=2, head_dim=64,
                     device=dev)
    for s in range(seqs):
        pool.add_sequence(s)
    for part in (1, 2, 4):  # in turns: the sequences' pages interleave
        for s in range(seqs):
            pool.ensure_capacity(s, positions * part // 4)
    pos = np.arange(positions)
    pos_dev = torch.from_numpy(pos).to(dev)

    def check(s: int) -> tuple:
        (pages, offsets), first_ms, _ = timed_call(dev, lambda: pool.position_lookup(s, pos))
        _, again_ms, events_ms = timed_call(dev, lambda: pool.position_lookup(s, pos))
        want = torch.as_tensor(np.asarray(pool.seq_pages[s]), device=dev)[pos_dev // page]
        if not (torch.equal(pages, want) and torch.equal(offsets, pos_dev % page)):
            fail(f"paged pool: sequence {s}: position_lookup != pos // {page} arithmetic")
        return first_ms, again_ms, events_ms

    times = [check(s) for s in range(seqs)]
    old = list(pool.seq_pages[3])
    pool.release(3)
    pool.add_sequence(seqs)
    pool.ensure_capacity(seqs, positions)
    if sorted(pool.seq_pages[seqs]) != sorted(old):
        fail("paged pool: the re-allocated sequence did not take the released pages")
    times.append(check(seqs))
    try:
        pool.ensure_capacity(seqs, positions + 1)
        fail("paged pool: an exhausted pool allocated a page")
    except MemoryError:
        pass
    out = {"seqs": seqs, "positions": positions, "page": page, "pages": seqs * per,
           "utilization": pool.utilization(),
           "store_bytes": 2 * pool.k.numel() * pool.k.element_size(),
           "first_lookup_host_ms": float(np.mean([t[0] for t in times])),
           "lookup_host_ms": float(np.mean([t[1] for t in times])),
           "lookup_events_ms": None if times[0][2] is None else float(np.mean([t[2] for t in times])),
           "seconds": time.perf_counter() - t_phase}
    log(f"[paged] {seqs} sequences x {positions} positions in pages of {page} ({per} pages a "
        f"sequence, store {out['store_bytes'] / 2**20:.0f} MiB on {dev.type}): position_lookup of "
        f"every position == pos // {page} before and after a release and a re-allocation; "
        f"MemoryError when exhausted; {positions} positions: {out['first_lookup_host_ms']:.3f} ms "
        f"host with the PGM build, {out['lookup_host_ms']:.3f} ms host / "
        f"{out['lookup_events_ms']} ms CUDA events cached (means); done in {out['seconds']:.1f} s")
    return out


FITS_ORDER = ("host", "vmap", "fast", "auto")


def float_bound(n_bytes: int, n_ops: int) -> dict:
    """Least time for a float kernel call: bytes over the HBM rate against
    f32 operations over the non-tensor f32 rate (both kernels use the f32
    units, not the tensor cores)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def attention_bound(q, k, kv_len) -> dict:
    """q read and out written once; the K and V rows of each row's first
    ``kv_len`` positions read once; 2 multiply-adds (4 ops) a query head,
    position and dimension (logits and PV)."""
    b, s, hkv, d = k.shape
    n = int(torch.clamp(kv_len.long(), 0, s).sum())
    n_bytes = 2 * q.numel() * q.element_size() + 2 * n * hkv * d * k.element_size()
    return float_bound(n_bytes, 4 * n * q.shape[1] * d)


def bag_bound(table, ids, num_bags: int) -> dict:
    """The distinct in-range table rows read once, 12 bytes an item (id,
    bag, weight), the output written once; one multiply-add (2 ops) a
    value gathered."""
    v, d = table.shape
    ok = ids[(ids >= 0) & (ids < v)]
    rows = int(torch.unique(ok).numel())
    n_bytes = rows * d * 4 + 12 * ids.numel() + num_bags * d * 4
    return float_bound(n_bytes, 2 * int(ok.numel()) * d)


def max_err(got, want, atol, rtol, what: str) -> float:
    """Max |got - want|; fails unless |got - want| <= atol + rtol |want|
    everywhere (and both are finite where want is)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or bool((diff > atol + rtol * w.abs()).any()):
        fail(f"{what}: kernel vs twin max |err| {float(diff.max())} beyond atol {atol} rtol {rtol}")
    return float(diff.max()) if diff.numel() else 0.0


def attention_inputs(dev, b, hq, hkv, d, s, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


@contextlib.contextmanager
def forced_split(n_split):
    """Within the block, ``decode_attention`` cuts each row into ``n_split``
    shares (``split_plan``'s tile kept); None keeps the plan's split."""
    from repro_torch.kernels import decode_attention as att

    plan = att.split_plan
    if n_split is not None:
        att.split_plan = lambda *a: (plan(*a)[0], n_split)
    try:
        yield
    finally:
        att.split_plan = plan


def phase_float_parity(dev, s: int) -> dict:
    """Phase 6: each float kernel against its twin on the card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        MAX_SPLIT,
        _decode_body,
        decode_attention,
        split_plan,
    )
    from repro_torch.kernels.embedding_bag import _bag_body, embedding_bag

    errs = {"decode_attention": 0.0, "embedding_bag": 0.0}
    splits = (None, 1, 2, 5, MAX_SPLIT)
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv, d in ((4, 4, 16), (8, 2, 32), (16, 1, 64), (14, 2, 64), (32, 8, 128),
                           (16, 16, 128), (4, 4, 256), (8, 8, 8)):
            q, k, v = attention_inputs(dev, 6, hq, hkv, d, s, dtype, seed=hq * d)
            kv_len = torch.tensor([0, 1, 256, 257, s, s // 2 + 3], dtype=torch.int32, device=dev)
            got = decode_attention(q, k, v, kv_len)
            want = _decode_body(q, k, v, kv_len)
            err = max_err(got, want, *ATT_TOL[dtype],
                          f"decode_attention {dtype} ({hq},{hkv},{d}) S={s}")
            if bool((got[0] != 0).any()):
                fail("decode_attention: a row with kv_len 0 is not 0")
            errs["decode_attention"] = max(errs["decode_attention"], err)
            # the split's edges: shares cut at tile - 1, + 0, + 1, rows
            # shorter than n_split tiles (empty shares), lengths past S
            tile = split_plan(9, hkv, d, s, q.element_size(), 132)[0]
            q, k, v = attention_inputs(dev, 9, hq, hkv, d, s, dtype, seed=hq * d + 1)
            kv_len = torch.tensor([0, 1, tile - 1, tile, tile + 1, s, s + 5, 3 * tile - 1, 2],
                                  dtype=torch.int32, device=dev)
            want = _decode_body(q, k, v, kv_len)
            for n_split in splits:
                with forced_split(n_split):
                    got = decode_attention(q, k, v, kv_len)
                err = max_err(got, want, *ATT_TOL[dtype],
                              f"decode_attention {dtype} ({hq},{hkv},{d}) S={s} split {n_split}")
                if bool((got[0] != 0).any()):
                    fail(f"decode_attention: a row with kv_len 0 is not 0 (split {n_split})")
                errs["decode_attention"] = max(errs["decode_attention"], err)
    log(f"[float] decode_attention f32 and bf16, 7 head shapes, S={s}, kv_len 0/1/256/257/S, "
        f"and the split's edges (kv_len 0/1/tile-1/tile/tile+1/S/S+5/3 tile-1/2, n_split "
        f"{'/'.join(str(n or 'planned') for n in splits)}): kernel == twin within (atol, rtol) "
        f"{ATT_TOL[torch.float32]} / "
        f"{ATT_TOL[torch.bfloat16]} "
        f"(max |err| {errs['decode_attention']:.3g})")

    rng = np.random.default_rng(2024)
    n_cases = 0
    for v_, d, n_items, bags, sort in ((100, 8, 50, 4, False), (1000, 64, 300, 16, False),
                                       (513, 32, 128, 8, False), (513, 32, 128, 8, True),
                                       (300, 3, 200, 8, True), (257, 130, 400, 16, True),
                                       (64, 256, 500, 8, True)):
        table = torch.from_numpy(rng.normal(size=(v_, d)).astype(np.float32)).to(dev)
        # the same table at a storage offset of one float: not 16-byte aligned
        shifted = torch.empty(v_ * d + 1, device=dev)[1:].view(v_, d)
        shifted.copy_(table)
        ids = rng.integers(0, v_, n_items).astype(np.int32)
        ids[:4] = [-1, v_, v_ + 7, -(2**31)]
        seg = rng.integers(-1, bags + 1, n_items).astype(np.int32)  # some out of range
        if sort:
            seg = np.sort(seg)
        w = rng.normal(size=n_items).astype(np.float32)
        ids_t, seg_t, w_t = (torch.from_numpy(x).to(dev) for x in (ids, seg, w))
        for tab, weights in ((table, w_t), (table, None), (shifted, w_t)):
            got = (embedding_bag(tab, ids_t, seg_t, weights, num_bags=bags)
                   if weights is not None else ops.embedding_bag(tab, ids_t, seg_t, num_bags=bags))
            ww = w_t if weights is not None else torch.ones_like(w_t)
            want = _bag_body(table, ids_t, seg_t, ww, num_bags=bags)
            err = max_err(got, want, BAG_TOL, BAG_TOL, f"embedding_bag V={v_} D={d} N={n_items}")
            errs["embedding_bag"] = max(errs["embedding_bag"], err)
            n_cases += 1
    log(f"[float] embedding_bag, {n_cases} cases: D 3/8/32/64/130/256, sorted and unsorted bags, "
        f"ids and bags out of range, weights given and None, a table at a one-float offset: "
        f"kernel == twin within {BAG_TOL} (max |err| {errs['embedding_bag']:.3g})")
    return errs


def phase_serve(dev, arch, *, reduced: bool, slots: int, max_seq: int, n_requests: int,
                long_prompt: int, max_new: int, ref_ticks: int) -> dict:
    """Phase 7: the LM serving path at full width (the main path of
    ``decode_attention``).  One more request, with a ``long_prompt``-token
    prompt, is queued first: the engine decodes every slot at the largest
    slot position, so the first ticks (those re-run on the reference math)
    attend over many tiles, split over blocks."""
    from repro_torch import configs, kernels
    from repro_torch.kernels.decode_attention import _decode_body, decode_attention
    from repro_torch.models import transformer
    from repro_torch.serve import DecodeEngine, Request

    cfg = configs.get(arch, reduced=reduced).config
    t0 = time.perf_counter()
    params = transformer.init(torch.Generator(device=dev).manual_seed(0), cfg)
    eng = DecodeEngine(params, cfg, batch_slots=slots, max_seq=max_seq)
    del params  # the engine holds its bf16 compute copy
    cache_bytes = sum(c.numel() * c.element_size() for c in eng.cache.values())
    log(f"[serve] {arch}{' (reduced)' if reduced else ''}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.params_count} params ({cfg.param_dtype} init, {cfg.dtype} compute); "
        f"{slots} slots x {max_seq} positions, cache {cache_bytes / 2**30:.2f} GiB; "
        f"set up in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(3, 10)).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n_requests)]
    reqs.insert(0, Request(rid=n_requests, max_new_tokens=max_new,
                           prompt=rng.integers(0, cfg.vocab, long_prompt).astype(np.int32)))
    finite = torch.ones((), dtype=torch.bool, device=dev)
    saved = []  # (cache copy, tokens, pos, kernel logits) before the first decode ticks
    decode, prefill = eng._decode, eng._prefill_tok

    def on_decode(params, cache, tokens, pos_per_slot):
        nonlocal finite
        before = ({kv: c.clone() for kv, c in cache.items()} if len(saved) < ref_ticks else None)
        logits, cache = decode(params, cache, tokens, pos_per_slot)
        finite = finite & torch.isfinite(logits).all()
        if before is not None:
            saved.append((before, tokens.clone(), int(np.max(pos_per_slot)), logits.clone()))
        return logits, cache

    def on_prefill(params, cache, tokens, pos):
        nonlocal finite
        logits, cache = prefill(params, cache, tokens, pos)
        finite = finite & torch.isfinite(logits).all()
        return logits, cache

    eng._decode, eng._prefill_tok = on_decode, on_prefill
    for r in reqs:
        eng.submit(r)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    tick_s, admit_tick_s = [], []
    t_run = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        queued = len(eng.queue)
        t0 = time.perf_counter()
        eng.tick()
        (admit_tick_s if len(eng.queue) < queued else tick_s).append(time.perf_counter() - t0)
    run_s = time.perf_counter() - t_run
    launches = kernels.launches()["decode_attention"]

    steps = sum(len(r.prompt) for r in reqs) + eng.ticks
    tokens = sum(len(r.out_tokens) for r in reqs)
    if not all(r.done and len(r.out_tokens) == max_new for r in reqs):
        fail(f"serve: not every request finished with {max_new} tokens: "
             f"{[len(r.out_tokens) for r in reqs]}")
    if not bool(finite):
        fail("serve: a logit was not finite")
    if dev.type == "cuda" and launches != cfg.n_layers * steps:
        fail(f"serve: decode_attention launched {launches} times, expected "
             f"{cfg.n_layers} x {steps} (prefill steps + ticks)")
    out = {
        "arch": arch, "reduced": reduced, "n_layers": cfg.n_layers, "slots": slots,
        "max_seq": max_seq, "requests": len(reqs), "long_prompt": long_prompt, "new_tokens": tokens,
        "prefill_steps": steps - eng.ticks, "ticks": eng.ticks, "decode_attention_launches": launches,
        "run_s": run_s, "tokens_per_s": tokens / run_s,
        "decode_tick_ms": 1e3 * float(np.mean(tick_s)) if tick_s else None,
        "admit_tick_ms": 1e3 * float(np.mean(admit_tick_s)) if admit_tick_s else None,
        "metrics": eng.metrics(),
    }
    log(f"[serve] {len(reqs)} requests (one of {long_prompt} prompt tokens), {tokens} tokens "
        f"({steps - eng.ticks} prefill steps, "
        f"{eng.ticks} ticks) in {run_s:.2f} s: {out['tokens_per_s']:.1f} tokens/s (host clock); "
        f"decode-only tick {out['decode_tick_ms']} ms, tick with admissions "
        f"{out['admit_tick_ms']} ms; decode_attention launches {launches} = {cfg.n_layers} x {steps}")

    # the first decode ticks again, from the same cache, on the reference math
    worst, agree = 0.0, 0
    long_pos = saved[0][2]
    for cache, toks, pos, got in saved:
        want, _ = transformer.decode_step(eng.params, cache, toks, pos, cfg, backend="ref")
        diff = (got - want).abs()
        if bool((diff > SERVE_ATOL + SERVE_RTOL * want.abs()).any()):
            fail(f"serve: tick at pos {pos}: kernel logits vs ref max |err| {float(diff.max())}")
        worst = max(worst, float(diff.max()))
        agree += int((got.argmax(1) == want.argmax(1)).sum())
    del saved
    out.update(ref_ticks=ref_ticks, ref_max_abs_err=worst,
               ref_argmax_agree=f"{agree}/{ref_ticks * slots}")
    log(f"[serve] first {ref_ticks} decode ticks (from pos {long_pos}) re-run with backend='ref': "
        f"logits max |err| "
        f"{worst:.4g} (atol {SERVE_ATOL}, rtol {SERVE_RTOL}); argmax agrees on {agree}/"
        f"{ref_ticks * slots} rows")

    # the kernel at the path's own shapes against its twin, and its share of a
    # step, at the last position served and at the first ticks' (long) one
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((slots, cfg.n_heads, cfg.head_dim), generator=gen, device=dev).to(
        eng.cache["k"].dtype)
    k0, v0 = eng.cache["k"][0], eng.cache["v"][0]
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    out["max_abs_err"], out["at_pos"] = 0.0, []
    for pos in (int(np.max(eng.slot_pos)), long_pos):
        kv_len = torch.full((slots,), pos + 1, dtype=torch.int32, device=dev)
        err = max_err(decode_attention(q, k0, v0, kv_len), _decode_body(q, k0, v0, kv_len),
                      *ATT_TOL[q.dtype], f"serve-shape decode_attention at pos {pos}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        row = {"pos": pos, "step_ms": device_ms(
            lambda p=pos: transformer.decode_step(eng.params, eng.cache, toks, p, cfg), dev,
            reps=10, warmup=2),
            "kernel_ms": device_ms(lambda n=kv_len: decode_attention(q, k0, v0, n), dev),
            "kernel_graph_ms": graph_ms(lambda n=kv_len: decode_attention(q, k0, v0, n), dev)}
        if row["step_ms"] is not None:
            row["kernel_share_of_step"] = cfg.n_layers * row["kernel_ms"] / row["step_ms"]
        out["at_pos"].append(row)
        log(f"[serve] at pos {pos}: decode_step {row['step_ms']} ms, decode_attention "
            f"{row['kernel_ms']} ms ({row['kernel_graph_ms']} ms replayed from a CUDA graph, "
            f"without the host's enqueue) x {cfg.n_layers} layers = share "
            f"{row.get('kernel_share_of_step')} of a step (CUDA events); kernel == twin at the "
            f"path's shapes (max |err| {err:.3g})")
    return out


def free_device(dev) -> None:
    """Collect what a finished phase dropped (an engine whose step a spy
    wrapped sits in a reference cycle) and hand the cached blocks back to
    the card."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def moe_step_bytes(cfg, slots: int, kv_len: int, experts: int | None = None) -> int:
    """Bytes a decode step must read at least, in bf16: every layer's
    attention, router, norm and shared-expert weights, the weights of
    ``experts`` routed (layer, expert) pairs, the embedding rows and the
    K/V rows up to ``kv_len``.  ``experts=None`` counts all
    ``n_layers x n_experts``: what the capacity dispatch reads, since it
    multiplies every expert's slots, routed or empty."""
    d, hd, n = cfg.d_model, cfg.head_dim, cfg.n_layers
    if experts is None:
        experts = n * cfg.n_experts
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    layer = attn + d * cfg.n_experts + cfg.n_shared * 3 * d * cfg.d_ff_expert + 2 * d
    weights = n * layer + experts * 3 * d * cfg.d_ff_expert + cfg.vocab * d + d + slots * d
    cache = n * slots * kv_len * cfg.n_kv_heads * hd * 2
    return 2 * (weights + cache)


def phase_moe_serve(dev, arch, *, reduced: bool, slots: int, max_seq: int, n_requests: int,
                    max_new: int, ref_ticks: int, tier) -> dict:
    """Phase 7b: MoE serving at full width.  ``arch`` with bf16 weights drawn
    on the card a layer at a time, served by ``DecodeEngine`` with ``tier``
    (phase 5g's hot-key cache) driven by the ticks: every request finishes,
    logits finite, ``decode_attention`` launched n_layers x steps at group 1;
    the first ``ref_ticks`` ticks re-run on the reference math in place (the
    kernel's K/V rows put back after) twice: on the experts the kernel pass
    routed to, within ``SERVE_ATOL``/``SERVE_RTOL``, and routing on its own,
    with the swaps and the error logged; ms a tick, tokens/s, attention's
    share of a step, one layer's ``moe_ffn``, and the step's byte bound for
    the experts it routed to and for all of them."""
    from dataclasses import replace

    from repro_torch import configs, kernels, tree
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import moe, transformer
    from repro_torch.serve import DecodeEngine, Request

    cfg = replace(configs.get(arch, reduced=reduced).config, param_dtype="bfloat16")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(dev, lambda: transformer.init(
        torch.Generator(device=dev).manual_seed(0), cfg))
    eng = DecodeEngine(params, cfg, batch_slots=slots, max_seq=max_seq, tier=tier)
    del params  # bf16 already: the engine's compute copy is the same tensors
    weight_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(eng.params))
    cache_bytes = sum(c.numel() * c.element_size() for c in eng.cache.values())
    log(f"[moe] {arch}{' (reduced)' if reduced else ''}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, {cfg.n_experts} experts top "
        f"{cfg.top_k} + {cfg.n_shared} shared of {cfg.d_ff_expert}, vocab {cfg.vocab}, "
        f"{cfg.params_count} params drawn as bf16 in {init_s:.1f} s ({weight_bytes / 1e9:.2f} GB); "
        f"{slots} slots x {max_seq} positions, cache {cache_bytes / 1e9:.2f} GB; capacity "
        f"{moe.capacity_of(slots, cfg)} a expert at {slots} tokens")

    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(3, 11)).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n_requests)]
    finite = torch.ones((), dtype=torch.bool, device=dev)
    checked, ref_s = [], 0.0
    routes = []  # the top-k experts of every moe_ffn call, in call order
    replay = []  # the kernel pass's experts, handed back in call order
    top_k = moe._top_k

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        routes.append(idx)
        return vals, idx

    def replaying(probs, k):
        idx = replay.pop(0)
        return probs.gather(-1, idx), idx

    def routed(hook, fn):
        moe._top_k = hook
        out = fn()
        moe._top_k = top_k
        return out

    decode = eng._decode

    def on_decode(params, cache, tokens, pos_per_slot):
        nonlocal finite, ref_s
        check = len(checked) < ref_ticks
        routes.clear()
        logits, cache = routed(recording if check else top_k,
                               lambda: decode(params, cache, tokens, pos_per_slot))
        finite = finite & torch.isfinite(logits).all()
        if not check:
            return logits, cache
        t0 = time.perf_counter()
        pos = int(np.max(pos_per_slot))
        at = min(pos, max_seq - 1)
        mine = {kv: c[:, :, at].clone() for kv, c in cache.items()}
        kernel_routes = list(routes)
        # the reference math on the kernel pass's experts: the same pairs
        # drop, so what differs is the attention's arithmetic alone
        replay[:] = kernel_routes
        want, _ = routed(replaying, lambda: transformer.decode_step(
            params, cache, tokens, pos, cfg, backend="ref"))
        if replay or len(kernel_routes) != cfg.n_layers:
            fail(f"moe: the kernel pass routed {len(kernel_routes)} layers and the reference "
                 f"re-run took {len(kernel_routes) - len(replay)}, not {cfg.n_layers}")
        # a diagnostic: the reference math routing on its own
        routes.clear()
        free, _ = routed(recording, lambda: transformer.decode_step(
            params, cache, tokens, pos, cfg, backend="ref"))
        for kv, rows in mine.items():  # the kernel's K/V rows back for the next ticks
            cache[kv][:, :, at] = rows
        swapped = [int((a.sort(dim=1).values != b.sort(dim=1).values).any(dim=1).sum())
                   for a, b in zip(kernel_routes, routes)]
        diff, free_diff = (logits - want).abs(), (logits - free).abs()
        if bool((diff > SERVE_ATOL + SERVE_RTOL * want.abs()).any()):
            fail(f"moe: tick at pos {pos}: kernel logits vs ref on the same experts, max |err| "
                 f"{float(diff.max())}")
        checked.append({"pos": pos, "max_abs_err": float(diff.max()),
                        "mean_abs_err": float(diff.mean()),
                        "argmax_agree": int((logits.argmax(1) == want.argmax(1)).sum()),
                        "unforced_max_abs_err": float(free_diff.max()),
                        "unforced_mean_abs_err": float(free_diff.mean()),
                        "unforced_argmax_agree": int((logits.argmax(1) == free.argmax(1)).sum()),
                        "routing_swaps": sum(swapped), "routed_tokens": len(routes) * slots,
                        "first_swap_layer": next((i for i, n in enumerate(swapped) if n), None)})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ref_s += time.perf_counter() - t0
        return logits, cache

    eng._decode = on_decode
    for r in reqs:
        eng.submit(r)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    tick_s = []
    t_run = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        queued, ref_before = len(eng.queue), ref_s
        t0 = time.perf_counter()
        eng.tick()
        if len(eng.queue) == queued:  # a tick without admissions (prefill steps)
            tick_s.append(time.perf_counter() - t0 - (ref_s - ref_before))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run - ref_s
    launches = kernels.launches()["decode_attention"]
    del eng._decode, decode  # the engine's own method again
    steps = sum(len(r.prompt) for r in reqs) + eng.ticks
    tokens = sum(len(r.out_tokens) for r in reqs)
    if not all(r.done and len(r.out_tokens) == max_new for r in reqs):
        fail(f"moe: not every request finished with {max_new} tokens: "
             f"{[len(r.out_tokens) for r in reqs]}")
    if not bool(finite):
        fail("moe: a logit was not finite")
    if dev.type == "cuda" and launches != cfg.n_layers * steps:
        fail(f"moe: decode_attention launched {launches} times, expected {cfg.n_layers} x {steps}")
    m = eng.metrics()
    if m["requests_finished"] != len(reqs) or "hotcache" not in m["tier"]:
        fail(f"moe: the engine's metrics are off: {json.dumps({k: m[k] for k in m if k != 'tier'})}")
    out = {"arch": arch, "reduced": reduced, "n_layers": cfg.n_layers, "slots": slots,
           "max_seq": max_seq, "requests": len(reqs), "new_tokens": tokens,
           "prefill_steps": steps - eng.ticks, "ticks": eng.ticks,
           "decode_attention_launches": launches, "run_s": run_s, "tokens_per_s": tokens / run_s,
           "tick_ms": 1e3 * float(np.mean(tick_s)), "init_s": init_s,
           "weight_bytes": weight_bytes, "cache_bytes": cache_bytes, "ref_checks": checked,
           "serve_metrics": {k: m[k] for k in ("ticks", "tokens_decoded", "requests_finished")}}
    log(f"[moe] {len(reqs)} requests, {tokens} tokens ({steps - eng.ticks} prefill steps, "
        f"{eng.ticks} ticks) in {run_s:.2f} s without the re-checks: {out['tokens_per_s']:.2f} "
        f"tokens/s (host clock), {out['tick_ms']:.2f} ms a tick without admissions; "
        f"decode_attention launches {launches} = {cfg.n_layers} x {steps}; the tier's ticks: "
        f"{json.dumps(m['tier']['hotcache'])}")
    for c in checked:
        log(f"[moe] tick at pos {c['pos']} re-run with backend='ref' on the kernel pass's "
            f"experts: logits max |err| {c['max_abs_err']:.4g}, mean {c['mean_abs_err']:.4g} "
            f"(atol {SERVE_ATOL}, rtol {SERVE_RTOL}); argmax agrees on {c['argmax_agree']}/{slots} "
            f"rows. Routing on its own (diagnostic): max |err| {c['unforced_max_abs_err']:.4g}, "
            f"mean {c['unforced_mean_abs_err']:.4g}, argmax agrees on "
            f"{c['unforced_argmax_agree']}/{slots}; {c['routing_swaps']} of {c['routed_tokens']} "
            f"(layer, token) routings differ, the first in layer {c['first_swap_layer']}")

    # times at the path's shapes: a step, the attention at group 1, one layer's MoE
    pos = int(np.max(eng.slot_pos))
    kv_len = torch.full((slots,), pos + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    # a token a slot drawn at random, so the step routes as served traffic does
    toks = torch.randint(0, cfg.vocab, (slots, 1), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randn((slots, cfg.n_heads, cfg.head_dim), generator=gen, device=dev).to(
        eng.cache["k"].dtype)
    k0, v0 = eng.cache["k"][0], eng.cache["v"][0]
    x = torch.randn((slots, cfg.d_model), generator=gen, device=dev).to(eng.cache["k"].dtype)
    lp = {k: w[0] for k, w in eng.params["layers"]["moe"].items()}
    step_ms = device_ms(lambda: transformer.decode_step(eng.params, eng.cache, toks, pos, cfg),
                        dev, reps=5, warmup=1)
    att_ms = device_ms(lambda: decode_attention(q, k0, v0, kv_len), dev)
    moe_ms = device_ms(lambda: moe.moe_ffn(x, lp, cfg), dev)
    # the timed step's routing: the (layer, expert) pairs it needs weights of
    routes.clear()
    routed(recording, lambda: transformer.decode_step(eng.params, eng.cache, toks, pos, cfg))
    experts = sum(int(torch.unique(idx).numel()) for idx in routes)
    step_bytes = moe_step_bytes(cfg, slots, pos + 1, experts)
    all_bytes = moe_step_bytes(cfg, slots, pos + 1)
    out.update(pos=pos, step_ms=step_ms, attention_ms=att_ms, moe_ffn_ms=moe_ms,
               routed_experts=experts, routed_experts_per_layer=experts / cfg.n_layers,
               step_bound_bytes=step_bytes, step_bound_ms=1e3 * step_bytes / HBM_BYTES_PER_S,
               all_experts_bound_bytes=all_bytes,
               all_experts_bound_ms=1e3 * all_bytes / HBM_BYTES_PER_S,
               attention_share=None if step_ms is None else cfg.n_layers * att_ms / step_ms,
               moe_share=None if step_ms is None else cfg.n_layers * moe_ms / step_ms)
    row = time_attention(dev, f"moe 7b B{slots} {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} "
                              f"S{max_seq} {str(q.dtype)[6:]}, kv_len {pos + 1} (group 1)",
                         q, k0, v0, kv_len)
    out["attention_row"] = row
    out["max_abs_err"] = row["max_abs_err"]
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[moe] at pos {pos}: decode_step {step_ms} ms (byte bound {out['step_bound_ms']:.2f} ms: "
        f"{step_bytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12} TB/s for the "
        f"{out['routed_experts_per_layer']:.2f} experts a layer it routed to; "
        f"{out['all_experts_bound_ms']:.2f} ms for all {cfg.n_experts}, what the capacity dispatch "
        f"reads); decode_attention {att_ms} ms "
        f"x {cfg.n_layers} = share {out['attention_share']}; moe_ffn of one layer {moe_ms} ms x "
        f"{cfg.n_layers} = share {out['moe_share']} (CUDA events); peak memory "
        f"{out.get('peak_gb')} GB")
    return out


# -- phases 7c-7e: the prefill cell, the recsys scorers, the learned-keyed embedding -----

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the rate of
#: the prefill attention's bound
BF16_OPS_PER_S = 989e12
#: the recsys scorers, card against CPU: the CPU tests' f32 tolerance
RECSYS_TOL = 2e-5
#: the recsys archs phase 7d serves at published widths; DLRM-MLPerf's
#: 96.1 GB mega-table needs four cards (ROADMAP queue 1, item 4)
RECSYS_ARCHS = ("din", "wide-deep", "sasrec")
#: rows of ``serve_bulk`` (and candidates of ``retrieval_cand``) held
#: against the CPU; retrieval's candidates held against ``score_fn``
RECSYS_CHECK_ROWS, RETRIEVAL_PAIRS = 4096, 1024


def peak_gb(dev):
    return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def phase_prefill(dev, arch, *, reduced: bool, batch: int, seq: int, check_tokens: int) -> dict:
    """Phase 7c: the ``prefill`` cell (``launch.steps.build_step``:
    ``transformer.forward``, then the last position's logits) at full
    width, ``batch`` sequences of ``seq`` tokens from ``make_inputs``.
    First, at ``check_tokens`` tokens, its last logits against a
    ``decode_step`` chain over the same tokens (the ``decode_attention``
    kernel) within ``SERVE_ATOL``/``SERVE_RTOL``; then the cell timed by
    CUDA events, its logits finite; then one layer's plain
    ``causal_attention`` at the cell's shape beside
    ``scaled_dot_product_attention(is_causal=True)`` (a library figure,
    unused by the port)."""
    from repro_torch import configs, kernels
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps
    from repro_torch.models import layers, transformer

    spec = configs.get(arch, reduced=reduced)
    cfg = spec.config
    dt = layers.dtype_of(cfg.dtype)
    params = transformer.cast_params(
        transformer.init(torch.Generator(device=dev).manual_seed(0), cfg), dt)
    free_device(dev)  # the f32 draw
    out = {"arch": arch, "reduced": reduced, "batch": batch, "seq": seq, "q_chunk": cfg.q_chunk}

    # the cross-check: prefill against a decode_step chain over the same tokens
    cell = ShapeCell("prefill_check", "prefill", {"seq_len": check_tokens, "global_batch": batch})
    toks = steps.make_inputs(spec, cell, np.random.default_rng(1), device=dev)
    got = steps.build_step(spec, cell).fn(params, toks)
    cache = transformer.init_cache(cfg, batch, check_tokens, device=dev)
    kernels.reset_launches()
    for pos in range(check_tokens):
        want, cache = transformer.decode_step(params, cache, toks["tokens"][:, pos:pos + 1], pos,
                                              cfg)
    chain_launches = kernels.launches()["decode_attention"]
    del cache
    diff = (got - want).abs()
    if bool((diff > SERVE_ATOL + SERVE_RTOL * want.abs()).any()) or not bool(
            torch.isfinite(got).all()):
        fail(f"prefill: last logits vs the decode_step chain over {check_tokens} tokens, max "
             f"|err| {float(diff.max())}")
    if dev.type == "cuda" and chain_launches != check_tokens * cfg.n_layers:
        fail(f"prefill: the decode chain launched decode_attention {chain_launches} times")
    out.update(check_tokens=check_tokens, check_max_abs_err=float(diff.max()),
               check_argmax_agree=f"{int((got.argmax(1) == want.argmax(1)).sum())}/{batch}")
    log(f"[prefill] {arch}: last logits of a {check_tokens}-token prefill vs a decode_step chain "
        f"over the same tokens ({chain_launches} decode_attention launches): max |err| "
        f"{out['check_max_abs_err']:.4g} (atol {SERVE_ATOL}, rtol {SERVE_RTOL}), argmax agrees on "
        f"{out['check_argmax_agree']} rows")

    # the cell at its sequence length, cut to ``batch`` sequences
    cell = ShapeCell("prefill_32k", "prefill", {"seq_len": seq, "global_batch": batch})
    toks = steps.make_inputs(spec, cell, np.random.default_rng(0), device=dev)
    step = steps.build_step(spec, cell).fn
    reset_peak(dev)
    logits, host_ms, ms = timed_call(dev, lambda: step(params, toks))
    if tuple(logits.shape) != (batch, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill: logits of shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    out.update(ms=ms, host_ms=host_ms, peak_gb=peak_gb(dev),
               tokens_per_s=None if ms is None else batch * seq / (ms / 1e3))
    log(f"[prefill] {arch} at its widths ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.dtype}), {batch} x {seq} "
        f"tokens, q_chunk {cfg.q_chunk}: {ms} ms by CUDA events ({host_ms:.1f} ms host clock), "
        f"{out['tokens_per_s']} tokens/s, peak {out['peak_gb']} GB; last logits finite, "
        f"shape {tuple(logits.shape)}")

    # one layer's attention at the cell's shape: the plain version and the library's
    gen = torch.Generator(device=dev).manual_seed(2)
    hd = cfg.head_dim
    q = torch.randn((batch, seq, cfg.n_heads, hd), generator=gen, device=dev).to(dt)
    k, v = (torch.randn((batch, seq, cfg.n_kv_heads, hd), generator=gen, device=dev).to(dt)
            for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    lib = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True).transpose(1, 2)
    plain = layers.causal_attention(q, k, v, q_chunk=cfg.q_chunk)
    flops = 4 * batch * cfg.n_heads * hd * seq * (seq + 1) // 2  # QK and PV, the causal half
    n_bytes = 4 * q.numel() * q.element_size() + 4 * k.numel() * k.element_size()
    t_ops, t_bytes = flops / BF16_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    out["attention"] = {
        "shape": [batch, seq, cfg.n_heads, cfg.n_kv_heads, hd],
        "plain_ms": device_ms(lambda: layers.causal_attention(q, k, v, q_chunk=cfg.q_chunk), dev,
                              reps=2, warmup=1),
        "library_ms": device_ms(lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True), dev,
                                reps=5, warmup=1),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_max_abs_err": float((plain.float() - lib.float()).abs().max()),
    }
    a = out["attention"]
    log(f"[prefill] one layer's causal_attention at ({batch}, {seq}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, {hd}) {cfg.dtype}: plain {a['plain_ms']} ms, "
        f"scaled_dot_product_attention(is_causal=True) {a['library_ms']} ms (library figure, "
        f"unused), bound {a['bound_ms']:.4f} ms ({a['bound_by']}: the causal half's "
        f"{flops / 1e12:.2f} TFLOP at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s); plain vs library "
        f"max |diff| {a['library_max_abs_err']:.4g} (bf16 rounding at other places)")
    return out


def retrieval_pairs(cfg, batch, n: int) -> dict:
    """The score batch of the first ``n`` candidates of a retrieval batch:
    the user side repeated, the item the candidate."""
    c = batch["candidates"][:n].long()
    if cfg.kind == "sasrec":
        return {"seq": batch["seq"].expand(n, -1), "target": c}
    sparse = batch["sparse"].long().expand(n, -1).clone()
    sparse[:, 0] = c
    out = {"sparse": sparse}
    if cfg.kind == "din":
        out["hist"] = batch["hist"].expand(n, -1)
    if cfg.kind == "dlrm":
        out["dense"] = batch["dense"].expand(n, -1)
    return out


def phase_recsys(dev, archs, *, reduced: bool, check_rows: int, pairs: int) -> list:
    """Phase 7d: each arch's ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` cells (``launch.steps``, ``make_inputs`` seed 0)
    with seeded f32 weights at published widths: outputs finite; the card
    against the CPU on the same weights (all of ``serve_p99``, the first
    ``check_rows`` rows or candidates of the others); retrieval's first
    ``pairs`` candidates against ``score_fn`` on the same pairs (equal for
    SASRec and wide & deep; DIN's gap logged, ROADMAP queue 3); ms a batch
    and rows/s by CUDA events, peak memory."""
    from repro_torch import configs, tree
    from repro_torch.launch import steps
    from repro_torch.models import recsys

    rows = []
    for arch in archs:
        spec = configs.get(arch, reduced=reduced)
        cfg = spec.config
        params, init_s = timed(dev, lambda: recsys.init(
            torch.Generator(device=dev).manual_seed(0), cfg))
        on_cpu = tree.tree_map(lambda t: t.cpu(), params)
        table_gb = params["embed"].numel() * params["embed"].element_size() / 1e9
        log(f"[recsys] {arch}: mega-table {tuple(params['embed'].shape)} f32 ({table_gb:.2f} GB), "
            f"drawn in {init_s:.2f} s")
        for cell in spec.shapes:
            if cell.kind not in ("serve", "retrieval"):
                continue
            fn = steps.build_step(spec, cell).fn
            batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=dev)
            n = cell.dims.get("n_candidates", cell.dims["batch"])
            reset_peak(dev)
            got = fn(params, batch)
            peak = peak_gb(dev)
            if tuple(got.shape) != (n,) or not bool(torch.isfinite(got).all()):
                fail(f"recsys: {arch}/{cell.name} gave shape {tuple(got.shape)}, finite "
                     f"{bool(torch.isfinite(got).all())}")
            # the card against the CPU on the first rows
            m = min(n, check_rows)
            key = "candidates" if cell.kind == "retrieval" else None
            part = ({**batch, key: batch[key][:m]} if key
                    else {k: v[:m] for k, v in batch.items()})
            want = fn(on_cpu, {k: v.cpu() for k, v in part.items()})
            err = max_err(got[:m].cpu(), want, RECSYS_TOL, RECSYS_TOL,
                          f"recsys {arch}/{cell.name} card vs CPU")
            row = {"arch": arch, "cell": cell.name, "rows": n, "checked_rows": m,
                   "cpu_max_abs_err": err, "peak_gb": peak,
                   "ms": device_ms(lambda: fn(params, batch), dev,
                                   reps=20 if n <= 4096 else 3, warmup=1)}
            row["rows_per_s"] = None if row["ms"] is None else n / (row["ms"] / 1e3)
            if cell.kind == "retrieval":
                k = min(pairs, n)
                scored = recsys.score_fn(params, retrieval_pairs(cfg, batch, k), cfg)
                gap = float((got[:k] - scored).abs().max())
                row["retrieval_vs_score_max_abs_diff"] = gap
                if cfg.kind != "din" and bool(
                        ((got[:k] - scored).abs() > RECSYS_TOL + RECSYS_TOL * scored.abs()).any()):
                    fail(f"recsys: {arch} retrieval != score_fn on its first {k} candidates "
                         f"(max |diff| {gap})")
            rows.append(row)
            log(f"[recsys] {arch}/{cell.name}: {n} rows, {row['ms']} ms a batch, "
                f"{row['rows_per_s']} rows/s (CUDA events), peak {peak} GB; finite; the first {m} "
                f"== CPU (max |err| {err:.3g}, tol {RECSYS_TOL})"
                + (f"; the first {min(pairs, n)} candidates vs score_fn on the same pairs: max "
                   f"|diff| {row['retrieval_vs_score_max_abs_diff']:.4g}"
                   + (" (DIN's profile-row read, ROADMAP queue 3: a diagnostic)"
                      if cfg.kind == "din" else "") if cell.kind == "retrieval" else ""))
            del got, want, batch
        del params, on_cpu
        free_device(dev)
    return rows


def phase_lke(dev, *, n_keys: int, dim: int, n_queries: int) -> dict:
    """Phase 7e: ``LearnedKeyedEmbedding`` over ``n_keys`` sorted unique
    64-bit raw ids (seed 0) with a ``(n_keys + 1, dim)`` table; a batch of
    ``n_queries`` raw ids, three quarters present keys and a quarter
    absent.  One index (``lookup(backend="kernel")``: one ``rmi_search``
    launch, counted) and a 4-shard tier (one ``batched_rmi_search``
    launch, counted): ranks == ``"ref"`` == numpy ``searchsorted`` bit for
    bit, each vector its key's row and the OOV row exactly where the id
    is absent; the kernel against its twin on the path's operands; build
    seconds, ``translate`` and ``lookup`` ms (CUDA events)."""
    from repro_torch import index as tix
    from repro_torch import kernels
    from repro_torch.core import keys as keymod
    from repro_torch.core.cdf import sorted_unique
    from repro_torch.models.embedding import LearnedKeyedEmbedding

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    raw = sorted_unique(rng.integers(0, 2**64 - 1, n_keys, dtype=np.uint64))
    while len(raw) < n_keys:  # a collision of 64-bit draws: top up
        raw = sorted_unique(np.concatenate([raw, rng.integers(0, 2**64 - 1, n_keys - len(raw),
                                                             dtype=np.uint64)]))
    n_present = 3 * n_queries // 4
    absent = not_in(rng.integers(0, 2**64 - 1, n_queries, dtype=np.uint64), raw)
    queries = np.concatenate([rng.choice(raw, n_present),
                              rng.permutation(absent)[:n_queries - n_present]])
    order = rng.permutation(len(queries))
    queries, present = queries[order], (np.arange(len(queries)) < n_present)[order]
    want = np.searchsorted(raw, queries, side="right").astype(np.int64) - 1
    log(f"[lke] {n_keys} raw ids, {len(queries)} queries ({n_present} present) made in "
        f"{time.perf_counter() - t0:.1f} s")
    q_dev = keymod.encode(queries, dev)
    present_dev = torch.from_numpy(present).to(dev)
    out = {"n_keys": n_keys, "dim": dim, "n_queries": len(queries), "present": n_present,
           "launches": {}, "rows": []}
    for n_shards, name in ((1, "rmi_search"), (4, "batched_rmi_search")):
        lke, build_s = timed(dev, lambda: LearnedKeyedEmbedding.build(
            raw, dim, seed=0, n_shards=n_shards, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        vecs = lke.lookup(q_dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = kernels.launches()
        out["launches"][name] = launches[name]
        if dev.type == "cuda" and (launches[name] != 1 or sum(launches.values()) != 1):
            fail(f"lke: {n_shards} shard(s) launched {json.dumps(launches)}, expected one {name}")
        ranks = lke.translate(q_dev)
        if not (np.array_equal(ranks.cpu().numpy(), want)
                and torch.equal(ranks, lke.translate(q_dev, backend="ref"))):
            fail(f"lke: {n_shards} shard(s): kernel ranks != ref or numpy searchsorted")
        row = torch.where(present_dev, torch.clamp(ranks, min=0), lke.table.shape[0] - 1)
        if not torch.equal(vecs, lke.table[row]) or not torch.equal(
                vecs, lke.lookup(q_dev, backend="ref")):
            fail(f"lke: {n_shards} shard(s): vectors != the table's rows (OOV where absent)")
        # the kernel against its twin on the operands the path gives it, and
        # both timed there beside the bound (the method of phases 4-5)
        if n_shards == 1:
            impl = tix.impls.query_impl(lke.index.kind)
            args, kwargs = impl.operands(lke.index, lke.keys, q_dev)
            search, plain, table = impl.search, impl.plain, lke.keys
        else:
            sidx = lke.sharded
            impl = tix.impls.query_impl(sidx.kind)
            bq = q_dev[None, :].expand(n_shards, q_dev.numel())
            args, kwargs = impl.batched_operands(sidx.index, sidx.tables, bq)
            search, plain, table = impl.batched_search, impl.batched_plain, sidx.tables
        raw_k, twin = search(*args, **kwargs), plain(*args, **kwargs)
        err = int((raw_k.long() - twin.long()).abs().max())
        if err:
            fail(f"lke: {name} vs its twin on the path's operands, max |err| {err}")
        del raw_k, twin
        m = measure(dev, search, plain, args, kwargs, table, n_shards * q_dev.numel(),
                    lambda: lke.translate(q_dev),
                    lambda: torch.searchsorted(lke.keys, q_dev, right=True))
        r = {"n_shards": n_shards, "kernel": name, "build_s": build_s, "max_abs_err": err, **m,
             "translate_ms": m["lookup_ms"], "searchsorted_ms": m["library_ms"],
             "lookup_ms": device_ms(lambda: lke.lookup(q_dev), dev),
             "ref_translate_ms": device_ms(lambda: lke.translate(q_dev, backend="ref"), dev,
                                           reps=3, warmup=1)}
        out["rows"].append(r)
        log(f"[lke] {n_shards} shard(s), RMI b {max(2, n_keys // 128)}: built in {build_s:.1f} s; "
            f"lookup launched {json.dumps({k: v for k, v in launches.items() if v})}; ranks == "
            f"ref == numpy, vectors == rows (OOV on {len(queries) - n_present} absent ids); "
            f"{name} == twin on the path's operands; {name} {r['ms']} ms, its twin "
            f"{r['plain_ms']} ms, bound {r['bound_ms']} ms ({r['bound_by']}: "
            f"{r['bound_bytes']} B, {r['table_sectors']} table sectors, "
            f"{r['probes_per_query']:.2f} probes a query); translate {r['translate_ms']} ms, "
            f"lookup {r['lookup_ms']} ms, ref translate {r['ref_translate_ms']} ms, "
            f"torch.searchsorted {r['searchsorted_ms']} ms (CUDA events)")
        del lke, vecs, ranks, row
        free_device(dev)
    return out


def phase_embedding_ranks(dev, arch, *, reduced: bool) -> dict:
    """Phase 7e, the row-sharded mega-table on ranks: ``arch``'s table at
    published widths (seeded f32), spread over ``RANKS`` spawned ranks on
    the one card in a gloo group (``flat_dp``: each rank exchanges a
    quarter of the batch), each holding its contiguous row shard.
    ``models.embedding.sharded_lookup`` on ``serve_p99``'s ids in
    ``"a2a"`` at ``cap_factor=4.0`` and in ``"allreduce"`` == the one-rank
    gather bit for bit; at 2.0 (the recsys lookups' capacity) on the same
    ids and on a skewed batch (every id in the last shard), zero vectors
    exactly on the host model's drop set and the gathered row elsewhere;
    ``score_fn`` on each rank's shard == one rank (``"allreduce"``) and ==
    one rank with the host model's drops zeroed (``"a2a"``), within
    ``RECSYS_TOL``; ms a call by mode (CUDA events between barriers)."""
    import shutil

    import torch.multiprocessing as mp

    from repro_torch import configs
    from repro_torch.dist import collectives
    from repro_torch.launch import steps
    from repro_torch.models import recsys

    work = ROOT / "build" / "embedding_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    spec = configs.get(arch, reduced=reduced)
    cfg = spec.config
    if cfg.total_rows % RANKS:
        fail(f"ranks: {arch}'s {cfg.total_rows} rows do not split over {RANKS} ranks")
    rows_per = cfg.total_rows // RANKS
    cell = next(c for c in spec.shapes if c.name == "serve_p99")
    batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=dev)
    params = recsys.init(torch.Generator(device=dev).manual_seed(0), cfg)
    ids = batch["sparse"].long() + torch.from_numpy(recsys.field_offsets(cfg)).to(dev)[None, :]
    rng = np.random.default_rng(3)
    skew = torch.from_numpy(rng.integers((RANKS - 1) * rows_per, RANKS * rows_per,
                                         tuple(ids.shape))).to(dev)
    np.savez(work / "inputs.npz", ids=ids.cpu().numpy(), skew=skew.cpu().numpy(),
             sparse=batch["sparse"].cpu().numpy())
    # the host model of the exchange at 2.0: each rank's quarter of the batch
    cap = collectives.exchange_capacity(ids.numel() // RANKS, RANKS, 2.0)
    dropped = {k: host_drop_model(np.clip(x.cpu().numpy().reshape(-1) // rows_per, 0, RANKS - 1),
                                  RANKS, cap).reshape(tuple(ids.shape))
               for k, x in (("ids", ids), ("skew", skew))}
    gathered = {"ids": params["embed"][ids].cpu().numpy(),
                "skew": params["embed"][skew].cpu().numpy()}
    score = {"allreduce": recsys.score_fn(params, batch, cfg).cpu().numpy()}
    # one rank with the host model's drops zeroed: both of the score's
    # lookups (the deep table and the wide column) read the same ids
    keep = torch.from_numpy(~dropped["ids"]).to(dev)
    lookup = recsys.sharded_lookup
    recsys.sharded_lookup = lambda table, x, ctx=None, **kw: lookup(table, x) * keep[..., None].to(
        table.dtype)
    try:
        score["a2a"] = recsys.score_fn(params, batch, cfg).cpu().numpy()
    finally:
        recsys.sharded_lookup = lookup
    del params, batch, keep
    free_device(dev)
    (work / "job.json").write_text(json.dumps({"device": dev.type, "arch": arch,
                                               "reduced": reduced}))
    t0 = time.perf_counter()
    procs = mp.start_processes(embedding_rank, args=(RANKS, str(work)), nprocs=RANKS, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not procs.join(timeout=1.0):
            if time.monotonic() > deadline:
                fail(f"phase 7e: the {RANKS} ranks ran past 300 s")
    finally:
        for proc in procs.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(5)
    ranks_s = time.perf_counter() - t0
    out = {"arch": arch, "rows": cfg.total_rows, "batch": int(ids.shape[0]),
           "fields": int(ids.shape[1]), "ranks_s": ranks_s, "cap_at_2": cap,
           "dropped_at_2": {k: int(v.sum()) for k, v in dropped.items()}, "times": []}
    for r in range(RANKS):
        with np.load(work / f"emb_rank{r}.npz") as z:
            got = {k: z[k] for k in z.files}
        for mode in ("a2a", "allreduce"):
            if not np.array_equal(got[mode], gathered["ids"]):
                fail(f"ranks: rank {r} {mode} != the one-rank gather")
            diff = np.abs(got[f"score_{mode}"] - score[mode])
            if not np.all(diff <= RECSYS_TOL + RECSYS_TOL * np.abs(score[mode])):
                fail(f"ranks: rank {r} score_fn ({mode}) != one rank, max |err| {diff.max()}")
        for k in ("ids", "skew"):
            s, d = got[f"{k}_at_2"], dropped[k]
            if not (np.all(s[d] == 0) and np.array_equal(s[~d], gathered[k][~d])):
                fail(f"ranks: rank {r} {k} a2a at 2.0: zeros off the host model's drop set")
        out["times"].append(json.loads((work / f"emb_rank{r}.json").read_text()))
    for t in out["times"]:
        log(f"[ranks] rank {t['rank']}: " + ", ".join(
            f"{k} {v[0]} ms ({v[1]:.3f} host ms)" for k, v in t["times"].items()))
    n = dropped["ids"].size
    log(f"[ranks] {arch}'s mega-table ({cfg.total_rows} x {cfg.embed_dim}) over {RANKS} gloo "
        f"ranks on one {dev.type} device, {rows_per} rows a rank: serve_p99's ({ids.shape[0]}, "
        f"{ids.shape[1]}) ids in a2a@4.0 and allreduce == the one-rank gather on every rank; at "
        f"2.0 (cap {cap}) the exchange drops {out['dropped_at_2']['ids']} of serve_p99's {n} ids "
        f"(the fields' rows pile into the last shards) and {out['dropped_at_2']['skew']} of the "
        f"skewed batch's, exactly on the host model's sets; score_fn on the shards == one rank "
        f"(allreduce) and == one rank with those drops zeroed (a2a); {ranks_s:.1f} s")
    return out


def embedding_rank(rank: int, world: int, work_dir: str) -> None:
    """One rank of phase 7e's sharded table (spawned; joins the gloo group,
    runs, leaves).  Any failure raises, which fails the parent's join."""
    import torch.distributed as dist

    work = Path(work_dir)
    job = json.loads((work / "job.json").read_text())
    if job["device"] == "cuda":
        job["device"] = "cuda:0"
        torch.cuda.set_device(0)
    else:  # the CPU rehearsal: the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{work / 'pg_init'}", rank=rank,
                            world_size=world)
    try:
        result = embedding_rank_body(rank, world, work, job)
    finally:
        dist.destroy_process_group()
    (work / f"emb_rank{rank}.json").write_text(json.dumps(result))


def embedding_rank_body(rank: int, world: int, work: Path, job: dict) -> dict:
    from dataclasses import replace

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import configs
    from repro_torch.dist import ShardingCtx
    from repro_torch.models import embedding, recsys

    dev = torch.device(job["device"])
    ctx = ShardingCtx(mesh=DeviceMesh(dev.type, torch.arange(world).reshape(1, world),
                                      mesh_dim_names=("data", "model")), profile="flat_dp")
    cfg = configs.get(job["arch"], reduced=job["reduced"]).config
    # every rank draws the seeded weights, then keeps its row shard
    mine = recsys.local_params(recsys.init(torch.Generator(device=dev).manual_seed(0), cfg, ctx),
                               ctx)
    mine = {k: (v.clone() if k in ("embed", "wide") else v) for k, v in mine.items()}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with np.load(work / "inputs.npz") as z:
        data = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
    group = ctx.group("row")
    arrays, times = {}, {}
    for name, ids, mode, cap in (("a2a", "ids", "a2a", 4.0), ("allreduce", "ids", "allreduce", 2.0),
                                 ("ids_at_2", "ids", "a2a", 2.0), ("skew_at_2", "skew", "a2a", 2.0)):
        out, dev_ms, host_ms = _rank_ms(lambda: embedding.sharded_lookup(
            mine["embed"], data[ids], ctx, mode=mode, cap_factor=cap), dev, group)
        arrays[name], times[name] = out.cpu().numpy(), (dev_ms, host_ms)
    for mode in ("a2a", "allreduce"):
        c = replace(cfg, lookup_mode=mode)
        out, dev_ms, host_ms = _rank_ms(lambda: recsys.score_fn(
            mine, {"sparse": data["sparse"]}, c, ctx), dev, group)
        arrays[f"score_{mode}"], times[f"score_{mode}"] = out.cpu().numpy(), (dev_ms, host_ms)
    np.savez(work / f"emb_rank{rank}.npz", **arrays)
    return {"rank": rank, "times": times}


# -- phase 9: training -------------------------------------------------------------------------

#: phase 9's card-vs-CPU checks: losses and gradient norms within TRAIN_RTOL;
#: AdamW's first moment after one step (``0.1 *`` the clipped gradients)
#: within TRAIN_GRAD_RTOL of each leaf's largest magnitude (f32 compute, no
#: TF32: the sums run in other orders); the parameters within 2 lr, and
#: within 1e-2 lr on all but 0.1% of the elements (a gradient sign may
#: differ where it is ~0, which moves AdamW's step by up to 2 lr)
TRAIN_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
#: phase 9e's (DimeNet) widening of the two.  Its padded layout gathers the
#: messages from a bf16 copy, so the backward of that gather is a scatter-add
#: in bf16, and CUDA's ``index_add_`` sums it in no fixed order (one bf16 ulp
#: is 2^-8 of an element; the CPU parity tests measured <= 2.4e-4 of a leaf's
#: largest magnitude against the reference): ``grad_norm`` and the first
#: moment within GNN_GRAD_RTOL, a parameter off by more than 1e-2 lr on up to
#: GNN_OFF_SHARE of a leaf's elements (a gradient sign flips where it is ~0).
#: The loss within GNN_LOSS_RTOL: the forward's f32 segment sums are CUDA
#: ``index_add_`` too, in no fixed order, and the gate ``rbf @ w_rbf_g``
#: multiplies the messages block by block, which carries those rounding
#: differences on (7.4e-6 seen on the reduced config, against 1e-5)
GNN_LOSS_RTOL, GNN_GRAD_RTOL, GNN_OFF_SHARE = 5e-5, 2e-3, 1e-2
#: phase 9e's learning rate at published widths: that gate takes DimeNet's
#: outputs to ~1e5-1e6 at init (losses 1e5-1e12), and AdamW's first steps
#: at lr 1e-3 or 1e-4 raised ``molecule``'s loss; at 1e-5 it fell in all of
#: four seeds (a CPU probe of the full-width cell)
GNN_LR = 1e-5
#: the archs phase 9b trains at published widths (DLRM-MLPerf's 96.1 GB
#: table waits for four cards, ROADMAP queue 1, item 4)
TRAIN_RECSYS_ARCHS = ("din", "wide-deep", "sasrec")


def train_step_check(dev, bundle, state, batch, lr: float, what: str, *,
                     loss_rtol: float = TRAIN_RTOL, norm_rtol: float = TRAIN_RTOL,
                     grad_rtol: float = TRAIN_GRAD_RTOL, off_share: float = 1e-3) -> dict:
    """One step of ``bundle.fn`` from the same ``state`` and ``batch`` on
    the card and on the CPU (the CPU copies made here): loss
    (``loss_rtol``), grad norm (``norm_rtol``), first moment
    (``grad_rtol``) and parameters (off by more than 1e-2 lr on at most
    ``off_share`` of a leaf) within the tolerances above."""
    from repro_torch import tree

    cpu_state = tree.tree_map(lambda t: t.cpu(), state)
    got_s, got_m = bundle.fn(state, batch)
    want_s, want_m = bundle.fn(cpu_state, {k: v.cpu() for k, v in batch.items()})
    return compare_step(what, got_s, got_m, want_s, want_m, lr, "on the card", "on the CPU",
                        loss_rtol=loss_rtol, norm_rtol=norm_rtol, grad_rtol=grad_rtol,
                        off_share=off_share)


def compare_step(what, got_s, got_m, want_s, want_m, lr: float, got_is: str, want_is: str, *,
                 loss_rtol: float = TRAIN_RTOL, norm_rtol: float = TRAIN_RTOL,
                 grad_rtol: float = TRAIN_GRAD_RTOL, off_share: float = 1e-3) -> dict:
    """Two results of one train step (states with ``params`` and
    ``opt["m"]``, and metrics) held to :func:`train_step_check`'s
    tolerances; the states' leaves may lie on any device."""
    from repro_torch import tree

    out = {}
    for k, rtol in (("loss", loss_rtol), ("grad_norm", norm_rtol)):
        g, w = float(got_m[k]), float(want_m[k])
        if not np.isfinite(g) or abs(g - w) > rtol * abs(w):
            fail(f"train check {what}: {k} {g} {got_is} vs {w} {want_is}")
        out[f"{k}_rel_err"] = abs(g - w) / max(abs(w), 1e-30)
    m_used, p_err, p_off = 0.0, 0.0, 0.0
    for path, g, w in zip(*tree.flatten_with_paths(got_s["opt"]["m"]),
                          tree.leaves(want_s["opt"]["m"])):
        g, w = g.cpu(), w.cpu()
        # 1e-9 absolute where a gradient is zero in exact arithmetic (DIN's
        # last attention bias: the softmax is shift-invariant)
        allowed = max(grad_rtol * float(w.abs().max()), 1e-9)
        err = float((g - w).abs().max())
        if err > allowed:
            fail(f"train check {what}: first moment {path} off by {err} (allowed {allowed})")
        m_used = max(m_used, err / allowed)
    for path, g, w in zip(*tree.flatten_with_paths(got_s["params"]), tree.leaves(want_s["params"])):
        diff = (g.cpu() - w.cpu()).abs()
        share = float((diff > 1e-2 * lr).float().mean())
        if float(diff.max()) > 2 * lr or share > off_share:
            fail(f"train check {what}: parameters {path} off by {float(diff.max())} (lr {lr}), "
                 f"{share} of them by more than 1e-2 lr")
        p_err, p_off = max(p_err, float(diff.max())), max(p_off, share)
    out.update(grad_tol_used=m_used, param_max_abs_err=p_err, param_off_share=p_off)
    return out


def phase_train_lm(dev, arch, *, reduced: bool, batch: int, microbatches: int, steps_n: int,
                   check_tokens: int) -> dict:
    """Phase 9a: ``arch``'s ``train`` cell at its published widths (f32
    master weights, the config's compute dtype, remat, the chunked loss)
    through ``launch.steps.build_step`` and ``train.loop.run``: ``batch``
    sequences of the cell's length a step from ``data.TokenBatcher`` over a
    seeded ``synth_corpus`` of the model's vocabulary, ``microbatches``
    microbatches, AdamW, ``warmup_cosine(warmup=2)``, clip 1.0.  Every loss
    finite, the last below the first.  First, a check at 2 layers and
    ``check_tokens`` tokens in f32: one step on the card == the CPU."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.data import TokenBatcher, synth_corpus
    from repro_torch.launch import steps
    from repro_torch.train import TrainConfig, init_train_state, loop

    spec = configs.get(arch, reduced=reduced)
    cfg = spec.config
    cell = next(c for c in spec.shapes if c.kind == "train")
    seq = cell.dims["seq_len"]
    corpus, corpus_s = timed(dev, lambda: synth_corpus(vocab_size=cfg.vocab, n_docs=2000,
                                                       mean_len=512, seed=0, device=dev))
    out = {"arch": arch, "reduced": reduced, "batch": batch, "seq": seq,
           "microbatches": microbatches, "corpus_tokens": len(corpus.tokens),
           "corpus_s": corpus_s}

    # the check: 2 layers at full width, f32 compute, one step card == CPU
    small = replace(spec, config=replace(cfg, n_layers=min(2, cfg.n_layers), dtype="float32"))
    tcfg = TrainConfig(total_steps=steps_n, warmup=2)
    bundle = steps.build_step(small, cell, tcfg=tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(1), bundle.init_fn, tcfg)
    check_batch = TokenBatcher(corpus, 1, check_tokens, seed=1).batch_at(0)
    out["check"], check_s = timed(dev, lambda: train_step_check(
        dev, bundle, state, check_batch, tcfg.lr, f"{arch} 2 layers"))
    del state, bundle
    free_device(dev)
    log(f"[train] {arch} at 2 layers, {check_tokens} tokens, f32: one step on the card == the "
        f"CPU (loss rel err {out['check']['loss_rel_err']:.3g}, grad_norm "
        f"{out['check']['grad_norm_rel_err']:.3g}, first moment at {out['check']['grad_tol_used']:.3g}"
        f" of its tolerance, params {out['check']['param_max_abs_err']:.3g}) in {check_s:.1f} s")

    tcfg = TrainConfig(total_steps=steps_n, warmup=2, microbatches=microbatches)
    bundle = steps.build_step(spec, cell, tcfg=tcfg)
    state, init_s = timed(dev, lambda: init_train_state(torch.Generator(device=dev).manual_seed(0),
                                                        bundle.init_fn, tcfg))
    batcher = TokenBatcher(corpus, batch, seq, seed=0)
    metrics, step_s = [], []

    def step_fn(st, b):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = bundle.fn(st, b)
        metrics.append({k: float(v) for k, v in m.items()})
        step_s.append(time.perf_counter() - t0)
        return st, m

    reset_peak(dev)
    state, report = loop.run(step_fn, state, batcher.batch_at,
                             loop.LoopConfig(total_steps=steps_n, log_every=0), log=log)
    peak = peak_gb(dev)
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or report.steps_run != steps_n:
        fail(f"train: {arch} losses {losses} (finite, the last below the first)")
    tokens = batch * seq
    steady = step_s[1:] if len(step_s) > 1 else step_s
    ms = 1e3 * float(np.mean(steady))
    flops = 6 * cfg.params_count * tokens
    out.update(init_s=init_s, peak_gb=peak, losses=losses,
               grad_norms=[m["grad_norm"] for m in metrics],
               lr_scales=[m["lr_scale"] for m in metrics], step_ms=[1e3 * s for s in step_s],
               ms=ms, tokens_per_s=tokens / (ms / 1e3), params=cfg.params_count,
               six_n_t_tflop=flops / 1e12,
               bf16_peak_share=(flops / BF16_OPS_PER_S) / (ms / 1e3) if dev.type == "cuda"
               else None)
    log(f"[train] {arch} at its widths ({cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.params_count:,} f32 parameters, {cfg.dtype} compute, remat {cfg.remat}, xent_chunk "
        f"{cfg.xent_chunk}): {batch} x {seq} tokens a step in {microbatches} microbatches, "
        f"AdamW, warmup_cosine(warmup=2), clip 1.0; corpus {len(corpus.tokens):,} tokens "
        f"({corpus_s:.1f} s), init {init_s:.1f} s")
    for i, m in enumerate(metrics):
        log(f"[train]   step {i + 1}: loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, "
            f"lr_scale {m['lr_scale']:.4f}, {1e3 * step_s[i]:.1f} ms (host clock around a sync)")
    log(f"[train] {arch}: {ms:.1f} ms a step (mean of steps 2-{steps_n}), "
        f"{out['tokens_per_s']:.1f} tokens/s, peak {peak} GB; 6·N·tokens "
        f"{out['six_n_t_tflop']:.1f} TFLOP a step = {flops / BF16_OPS_PER_S * 1e3:.1f} ms at "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s beside {ms:.1f} ms: "
        f"{out['bf16_peak_share']} of the bf16 peak")
    del state, bundle, corpus
    free_device(dev)
    return out


def phase_train_recsys(dev, archs, *, reduced: bool, steps_n: int) -> list:
    """Phase 9b: each arch's ``train_batch`` cell at published widths (f32,
    seeded weights): ``steps_n`` AdamW steps (lr 1e-3, ``warmup_cosine``
    with warmup 1) on one repeated batch from ``make_inputs`` (seed 0),
    every loss finite and below the one before; then one further step
    under ``grad_compression="int8"``.  First, card == CPU on the reduced
    config.  Returns each arch's row and the SASRec state for 9c."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch import tree
    from repro_torch.train import TrainConfig, init_train_state

    rows = []
    kept = None
    for arch in archs:
        row = {"arch": arch}
        tcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=steps_n)
        small = configs.get(arch, reduced=True)
        cell = next(c for c in small.shapes if c.kind == "train")
        bundle = steps.build_step(small, cell, tcfg=tcfg)
        state = init_train_state(torch.Generator(device=dev).manual_seed(1), bundle.init_fn, tcfg)
        batch = steps.make_inputs(small, cell, np.random.default_rng(1), device=dev)
        row["check"] = train_step_check(dev, bundle, state, batch, tcfg.lr, f"{arch} reduced")

        spec = configs.get(arch, reduced=reduced)
        cell = next(c for c in spec.shapes if c.kind == "train")
        bundle = steps.build_step(spec, cell, tcfg=tcfg)
        state, init_s = timed(dev, lambda: init_train_state(
            torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg))
        batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=dev)
        n = cell.dims["batch"]
        reset_peak(dev)
        losses, ms = [], []
        for _ in range(steps_n):
            (state, m), _, dev_ms = timed_call(dev, lambda: bundle.fn(state, batch))
            losses.append(float(m["loss"]))
            ms.append(dev_ms)
        peak = peak_gb(dev)
        if not all(np.isfinite(losses)) or not all(b < a for a, b in zip(losses, losses[1:])):
            fail(f"train: {arch} losses {losses} (finite and falling)")
        # one further step with int8 gradient compression (zeroed error buffers)
        ctcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=steps_n, grad_compression="int8")
        cbundle = steps.build_step(spec, cell, tcfg=ctcfg)
        cstate = {**state, "comp_err": tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), state["params"])}
        (cstate, cm), _, c_ms = timed_call(dev, lambda: cbundle.fn(cstate, batch))
        closs = float(cm["loss"])
        errs = tree.leaves(cstate["comp_err"])
        if not np.isfinite(closs) or not all(bool(torch.isfinite(e).all()) for e in errs):
            fail(f"train: {arch} int8 step loss {closs}, error buffers finite "
                 f"{[bool(torch.isfinite(e).all()) for e in errs]}")
        step_ms = None if ms[0] is None else float(np.mean(ms[1:] if len(ms) > 1 else ms))
        row.update(rows=n, init_s=init_s, losses=losses, step_ms=ms, ms=step_ms,
                   rows_per_s=None if step_ms is None else n / (step_ms / 1e3), peak_gb=peak,
                   int8_loss=closs, int8_ms=c_ms,
                   params=sum(t.numel() for t in tree.leaves(state["params"])))
        log(f"[train] {arch}/{cell.name} at its widths ({row['params']:,} f32 parameters): reduced "
            f"card == CPU (loss rel err {row['check']['loss_rel_err']:.3g}, first moment at "
            f"{row['check']['grad_tol_used']:.3g} of its tolerance); {n} rows, losses "
            f"{', '.join(f'{l:.5f}' for l in losses)} (falling), {step_ms} ms a step (CUDA "
            f"events, steps 2-{steps_n}; first {ms[0]}), {row['rows_per_s']} rows/s, peak "
            f"{peak} GB; one int8-compressed step: loss {closs:.5f}, {c_ms} ms")
        rows.append(row)
        if arch == "sasrec":
            kept = (spec, cell, tcfg, state, batch)
        del state, cstate, batch, bundle, cbundle
        free_device(dev)
    return rows, kept


def phase_train_checkpoint(dev, kept, work: Path) -> dict:
    """Phase 9c: SASRec's train state from 9b saved with
    ``checkpoint.save`` (async) under ``work``, restored onto the card
    into a zeroed template: every leaf bit-equal to the saved one; one
    further step from the restored state against one from the saved
    state (loss within ``TRAIN_RTOL``: CUDA's scatter-adds sum in no fixed
    order)."""
    import shutil

    from repro_torch.launch import steps
    from repro_torch import tree
    from repro_torch.train import checkpoint

    spec, cell, tcfg, state, batch = kept
    shutil.rmtree(work, ignore_errors=True)
    gb = sum(t.numel() * t.element_size() for t in tree.leaves(state)) / 1e9
    handle, copy_s = timed(dev, lambda: checkpoint.save(work, state, 3))
    _, join_s = timed(dev, handle.join)
    template = tree.tree_map(torch.zeros_like, state)
    (restored, step), restore_s = timed(dev, lambda: checkpoint.restore(work, template))
    same = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree.leaves(restored), tree.leaves(state)))
    if step != 3 or not same:
        fail(f"train checkpoint: restored step {step}, bit-equal {same}")
    fn = steps.build_step(spec, cell, tcfg=tcfg).fn
    want = float(fn(state, batch)[1]["loss"])
    got = float(fn(restored, batch)[1]["loss"])
    if not abs(got - want) <= TRAIN_RTOL * abs(want):
        fail(f"train checkpoint: the step after the restore gives loss {got}, the saved state {want}")
    shutil.rmtree(work, ignore_errors=True)
    out = {"gb": gb, "host_copy_s": copy_s, "write_s": join_s, "restore_s": restore_s,
           "loss_after": got, "loss_uninterrupted": want, "leaves": len(tree.leaves(state))}
    log(f"[train] checkpoint of SASRec's train state ({gb:.3f} GB, {out['leaves']} leaves): host "
        f"copy {copy_s:.2f} s, async write joined after {join_s:.2f} s, restore onto the card "
        f"{restore_s:.2f} s, bit-equal; the next step's loss {got:.6f} vs {want:.6f} uninterrupted")
    return out


def phase_train_data(dev, *, n_docs: int, n_offsets: int, vocab: int) -> dict:
    """Phase 9d: ``synth_corpus`` of ``n_docs`` documents (mean length
    512) and ``doc_of`` of ``n_offsets`` seeded offsets on the card (the
    port's ``PGMModel.predecessor`` over the flipped keys): ranks ==
    ``torch.searchsorted(right=True) - 1`` on the same keys; ms by CUDA
    events."""
    from repro_torch.data import synth_corpus

    corpus, build_s = timed(dev, lambda: synth_corpus(vocab_size=vocab, n_docs=n_docs,
                                                      mean_len=512, seed=0, device=dev))
    offsets = torch.from_numpy(np.random.default_rng(2).integers(
        0, len(corpus.tokens), n_offsets)).to(dev)
    got, host_ms, ms = timed_call(dev, lambda: corpus.doc_of(offsets))
    want, s_host_ms, s_ms = timed_call(dev, lambda: torch.searchsorted(
        corpus.table, offsets ^ (-(1 << 63)), right=True) - 1)
    if not torch.equal(got, want):
        fail(f"train data: doc_of differs from searchsorted on {int((got != want).sum())} offsets")
    out = {"docs": n_docs, "tokens": len(corpus.tokens), "offsets": n_offsets, "build_s": build_s,
           "doc_of_ms": device_ms(lambda: corpus.doc_of(offsets), dev, reps=5, warmup=1),
           "searchsorted_ms": device_ms(lambda: torch.searchsorted(
               corpus.table, offsets ^ (-(1 << 63)), right=True), dev, reps=5, warmup=1),
           "pgm_levels": len(corpus.pgm.level_sizes), "pgm_segments": corpus.pgm.n_segments_l0}
    log(f"[train] synth_corpus of {n_docs:,} documents ({out['tokens']:,} tokens, PGM eps 16: "
        f"{out['pgm_segments']} segments, {out['pgm_levels']} levels) in {build_s:.1f} s; doc_of "
        f"{n_offsets:,} offsets: {out['doc_of_ms']} ms (CUDA events), == searchsorted "
        f"({out['searchsorted_ms']} ms)")
    return out


#: the cells phase 9e trains at published widths; ogb_products' 61,859,328
#: padded edges need 31.7 GB for one (E, 128) f32 message tensor and 63.3 GB
#: for one block's (E, 2, 128) gathered messages, past one card: it runs
#: reduced only until four cards hold its edges (ROADMAP queue 1, item 4)
GNN_CELLS = ("full_graph_sm", "minibatch_lg", "molecule")


def dimenet_step_flops(cfg, n_nodes: int, n_edges: int, t_max: int) -> int:
    """The matrix products of one DimeNet train step (padded layout): the
    forward's, times 3 (the backward's two products a forward one).
    Elementwise work, gathers and segment sums are left out."""
    d, nb, rows = cfg.d_hidden, cfg.n_bilinear, n_edges * t_max
    embed = n_nodes * (cfg.d_feat or 0) * d + n_edges * (cfg.n_radial * d + 3 * d * d)
    block = (rows * (d * d + cfg.n_sbf * nb + d * nb * d + nb * d)  # w_kj, w_sbf, W, bmm
             + n_edges * (4 * d * d + 2 * cfg.n_radial * d) + n_nodes * d * d)
    return 3 * 2 * (embed + cfg.n_blocks * block + n_nodes * d * cfg.n_out)


def phase_train_gnn(dev, *, reduced: bool, steps_n: int) -> dict:
    """Phase 9e: DimeNet's ``graph_train`` cells.  First, on the reduced
    config, one step of each of the four cells in both triplet layouts on
    the card == the CPU (``GNN_GRAD_RTOL``, ``GNN_OFF_SHARE``).  Then
    ``GNN_CELLS`` at published widths (6 blocks, d 128, n_bilinear 8, the
    padded layout; ``reduced`` takes the reduced config) and
    ``ogb_products`` reduced, each through ``launch.steps.build_step`` and
    ``train.loop.run``: ``steps_n`` AdamW steps (lr ``GNN_LR``,
    ``warmup_cosine`` with warmup 1) on the cell's batch of seed 0
    (``make_inputs``), every loss finite and below the one before; ms a step (CUDA events), edges/s,
    peak GB, each step's loss and ``grad_norm``.  No kernel of the port
    runs: the launch counts are read to show it."""
    from dataclasses import replace

    from repro_torch import configs, kernels
    from repro_torch.launch import steps
    from repro_torch.train import TrainConfig, init_train_state, loop

    t0 = time.perf_counter()
    before = dict(kernels.launches())
    tcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=steps_n)
    out = {"checks": [], "cells": [], "lr": GNN_LR}
    small = configs.get("dimenet", reduced=True)
    for layout in ("padded", "flat"):
        spec = replace(small, config=replace(small.config, triplet_layout=layout))
        for cell in spec.shapes:
            bundle = steps.build_step(spec, cell, tcfg=tcfg)
            state = init_train_state(torch.Generator(device=dev).manual_seed(1), bundle.init_fn,
                                     tcfg)
            batch = steps.make_inputs(spec, cell, np.random.default_rng(1), device=dev)
            row = train_step_check(dev, bundle, state, batch, tcfg.lr,
                                   f"dimenet {cell.name} {layout} reduced",
                                   loss_rtol=GNN_LOSS_RTOL, norm_rtol=GNN_GRAD_RTOL,
                                   grad_rtol=GNN_GRAD_RTOL, off_share=GNN_OFF_SHARE)
            out["checks"].append({"cell": cell.name, "layout": layout, **row})
    log(f"[train] dimenet reduced, 4 cells x 2 layouts: one step on the card == the CPU (worst "
        f"loss rel err {max(r['loss_rel_err'] for r in out['checks']):.3g}, grad_norm "
        f"{max(r['grad_norm_rel_err'] for r in out['checks']):.3g}, first moment at "
        f"{max(r['grad_tol_used'] for r in out['checks']):.3g} of its tolerance, params "
        f"{max(r['param_max_abs_err'] for r in out['checks']):.3g}, "
        f"{max(r['param_off_share'] for r in out['checks']):.3g} of a leaf off by > 1e-2 lr)")

    full = configs.get("dimenet", reduced=reduced)
    runs = [(full, name) for name in GNN_CELLS] + [(small, "ogb_products")]
    tcfg = TrainConfig(lr=GNN_LR, warmup=1, total_steps=steps_n)
    for spec, name in runs:
        cut = reduced or spec is small
        cell = next(c for c in spec.shapes if c.name == name)
        bundle = steps.build_step(spec, cell, tcfg=tcfg)
        cfg = bundle.cfg
        state, init_s = timed(dev, lambda: init_train_state(
            torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg))
        batch, batch_s = timed(dev, lambda: steps.make_inputs(spec, cell, np.random.default_rng(0),
                                                              device=dev))
        n_edges, t_max = batch["tri_kj"].shape
        n_nodes = batch["pos"].shape[0]
        metrics, step_ms = [], []

        def step_fn(st, b):
            (st, m), host_ms, dev_ms = timed_call(dev, lambda: bundle.fn(st, b))
            metrics.append({k: float(v) for k, v in m.items()})
            step_ms.append(dev_ms if dev_ms is not None else host_ms)
            return st, m

        reset_peak(dev)
        state, report = loop.run(step_fn, state, lambda step: batch,
                                 loop.LoopConfig(total_steps=steps_n, log_every=0), log=log)
        peak = peak_gb(dev)
        losses = [m["loss"] for m in metrics]
        if (report.steps_run != steps_n or not all(np.isfinite(losses))
                or not all(b < a for a, b in zip(losses, losses[1:]))):
            fail(f"train: dimenet {name} losses {losses} (finite and falling)")
        ms = float(np.mean(step_ms[1:] if len(step_ms) > 1 else step_ms))
        flops = dimenet_step_flops(cfg, n_nodes, n_edges, t_max)
        row = {"cell": name, "reduced": cut, "nodes": n_nodes, "edges": n_edges,
               "t_max": t_max, "n_blocks": cfg.n_blocks, "d_hidden": cfg.d_hidden,
               "layout": cfg.triplet_layout, "init_s": init_s, "batch_s": batch_s,
               "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics],
               "step_ms": step_ms, "ms": ms, "edges_per_s": n_edges / (ms / 1e3),
               "peak_gb": peak, "matmul_tflop": flops / 1e12,
               "f32_floor_ms": flops / SCALAR_OPS_PER_S * 1e3}
        out["cells"].append(row)
        log(f"[train] dimenet/{name} {'reduced' if cut else 'at its widths'} "
            f"({cfg.n_blocks} blocks, d {cfg.d_hidden}, {cfg.triplet_layout}, t_max {t_max}): "
            f"{n_nodes:,} nodes, {n_edges:,} edges; batch {batch_s:.2f} s, init {init_s:.2f} s")
        for i, m in enumerate(metrics):
            log(f"[train]   step {i + 1}: loss {m['loss']:.6g}, grad_norm {m['grad_norm']:.6g}, "
                f"{step_ms[i]:.2f} ms")
        log(f"[train] dimenet/{name}: {ms:.2f} ms a step (steps 2-{steps_n}, "
            f"{'CUDA events' if dev.type == 'cuda' else 'host clock'}), "
            f"{row['edges_per_s']:.4g} edges/s, peak {peak} GB; matrix products "
            f"{row['matmul_tflop']:.3f} TFLOP a step = {row['f32_floor_ms']:.2f} ms at "
            f"{SCALAR_OPS_PER_S / 1e12:.0f} TFLOP/s f32")
        del state, batch, bundle
        free_device(dev)
    out["launches"] = {k: v - before.get(k, 0) for k, v in kernels.launches().items()
                       if v != before.get(k, 0)}
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 9e done in {out['seconds']:.1f} s; kernel launches {out['launches']}")
    return out


def phase_train(dev, *, lm: dict, recsys: dict, data: dict, gnn: dict) -> dict:
    """Phase 9: training (9a the LM, 9b the recsys models, 9c a checkpoint
    round trip, 9d the token pipeline's learned lookup, 9e DimeNet).  No
    kernel of the port runs here; the launch counts are read to show it."""
    from repro_torch import kernels, tree

    t0 = time.perf_counter()
    kernels.reset_launches()
    out = {"lm": phase_train_lm(dev, "qwen2-0.5b", **lm)}
    out["recsys"], kept = phase_train_recsys(dev, TRAIN_RECSYS_ARCHS, **recsys)
    out["checkpoint"] = phase_train_checkpoint(dev, kept, ROOT / "build" / "train_ckpt")
    SASREC_STATE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(tree.tree_map(lambda t: t.cpu(), kept[3]), SASREC_STATE)  # phase 10b's
    del kept
    free_device(dev)
    out["data"] = phase_train_data(dev, **data)
    free_device(dev)
    out["gnn"] = phase_train_gnn(dev, **gnn)
    out["launches"] = {k: v for k, v in kernels.launches().items() if v}
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 9 done in {out['seconds']:.1f} s; kernel launches {out['launches']}")
    return out


# -- phase 10: ranks and launch ----------------------------------------------------------------

#: phase 10's gloo ranks on the one card: 10a and 10c on 2, 10b on 4
RANK_WORK = ROOT / "build" / "ranks"
#: phase 9c's SASRec train state, kept on disk for 10b's elastic restore
SASREC_STATE = RANK_WORK / "sasrec_state.pt"
#: 10d's FLOP gates: the dry run's count of the 9a and 9e cells == the
#: ``FlopCounterMode`` count of the same step run on the card (one code
#: path, fake tensors against real ones) within DRY_FLOP_RTOL; DimeNet's
#: within DRY_MODEL_RTOL of :func:`dimenet_step_flops`, which counts each
#: product three times where the feature projection has no input gradient
#: (0.6% of minibatch_lg's products).  The LM's count is printed beside
#: 9a's 6·N·tokens, with no gate: remat recomputes the layers' projections
#: (not the attention products, whose outputs the backward keeps), the
#: loss chunks recompute the head, and the embedding is a gather
DRY_FLOP_RTOL, DRY_MODEL_RTOL = 1e-6, 0.03


def spawn_ranks(name: str, world: int, job: dict, timeout: float) -> tuple:
    """Run ``train_rank`` on ``world`` spawned ranks in one gloo group (all
    on the card, or the CPU in the rehearsal) with ``job`` in a fresh
    ``build/ranks/<name>``; returns the work dir and each rank's result."""
    import shutil

    import torch.multiprocessing as mp

    work = RANK_WORK / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "job.json").write_text(json.dumps(job))
    # the ranks share one card: segments that grow in place keep each
    # rank's allocator from holding GBs it cannot use (10e-ii peaks at
    # ~18 GB a rank, four of them on 80 GB); read by each rank at its
    # first allocation, the parent's allocator is set already
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    procs = mp.start_processes(train_rank, args=(world, str(work)), nprocs=world, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not procs.join(timeout=1.0):
            if time.monotonic() > deadline:
                fail(f"phase 10 {name}: the {world} ranks ran past {timeout} s")
    finally:
        for proc in procs.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(5)
    return work, [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]


def train_rank(rank: int, world: int, work_dir: str) -> None:
    """One rank of a phase-10 job (spawned; joins the gloo group, runs the
    job's body, leaves).  Any failure raises, which fails the parent's
    join."""
    import torch.distributed as dist

    work = Path(work_dir)
    job = json.loads((work / "job.json").read_text())
    if job["device"] == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:  # the CPU rehearsal: the ranks share the host's cores
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{work / 'pg_init'}", rank=rank,
                            world_size=world)
    try:
        result = RANK_BODIES[job["kind"]](rank, world, work, job, dev)
    finally:
        dist.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(result))


#: 10a's rules: data parallelism alone over ``data`` (``fsdp``, ``tp`` and
#: ``ep`` on no axis), so its ranks hold whole replicas and its step stays
#: bit-equal to 9a's; 10e places the same model over (2, 2)
DP_ONLY = {"dp": ("data",), "fsdp": (), "tp": (), "ep": (), "edge": ("data", "model"),
           "row": ("data", "model")}


def _ctx(dev, world: int, shape, profile: str, rules=None):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import ShardingCtx

    mesh = DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=("data", "model"))
    return ShardingCtx(mesh=mesh, profile=profile, rules=dict(rules or {}))


#: the weights of :func:`digest`: word ``i`` of a leaf counts ``i * A + B``
_DIGEST_A, _DIGEST_B = -7046029254386353131, 7640891576956012809


def digest(state) -> list:
    """Each leaf's bits as a 64-bit checksum: its 32-bit words (16-bit for
    a 2-byte dtype) times position weights, summed in int64 arithmetic
    that wraps.  Equal states give equal lists; phase 10 compares the
    ranks' and the one-rank step's this way instead of moving GBs."""
    from repro_torch import tree

    out = []
    for t in tree.leaves(state):
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        words = raw.view(torch.int32) if raw.numel() % 4 == 0 else raw.view(torch.int16)
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        step = 1 << 26
        for a in range(0, words.numel(), step):
            w = torch.arange(a, min(a + step, words.numel()), dtype=torch.int64, device=t.device)
            total += (words[a:a + step].to(torch.int64) * (w * _DIGEST_A + _DIGEST_B)).sum()
        out.append(int(total))
    return out


def _events_ms(dev, fn, reps: int = 1):
    """``fn()`` ``reps`` times between a barrier and CUDA events: the mean
    ms (host ms off the card) and the last result."""
    import torch.distributed as dist

    dist.barrier()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return 1e3 * (time.perf_counter() - t0) / reps, out
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for a block (warnings where an op has none):
    10a's gated steps, whose bf16 products and scatter-adds otherwise sum
    in another order from one run to the next."""
    old, warn = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old, warn_only=warn)


def _cpu_result(state, metrics) -> dict:
    from repro_torch import tree

    return {"params": tree.tree_map(lambda t: t.cpu(), state["params"]),
            "opt": {"m": tree.tree_map(lambda t: t.cpu(), state["opt"]["m"])},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def rank_dp_lm(rank, world, work, job, dev) -> dict:
    """10a on a rank: the LM's ``train`` cell over a (world, 1) mesh, data
    parallel alone (:data:`DP_ONLY`: whole replicas), one microbatch a
    rank, from the seed-0 state on the saved global batch: one step,
    gated and timed (deterministic algorithms; a second, timed step is cut
    for the run's time), its state's :func:`digest` (rank 0 saves the state
    when it differs from the one-rank step's); the gradient all-reduce
    timed alone (every parameter-shaped f32 leaf over ``dp``)."""
    from dataclasses import replace

    from repro_torch import configs, tree
    from repro_torch.dist import collectives
    from repro_torch.launch import steps
    from repro_torch.train import TrainConfig, init_train_state

    spec = configs.get(job["arch"], reduced=job["reduced"])
    spec = replace(spec, config=replace(spec.config, dtype=job["dtype"]))
    cell = next(c for c in spec.shapes if c.kind == "train")
    ctx = _ctx(dev, world, (world, 1), "tp_fsdp", DP_ONLY)
    tcfg = TrainConfig(total_steps=job["steps_n"], warmup=2)
    bundle = steps.build_step(spec, cell, ctx, tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg)
    batch = {k: v.to(dev) for k, v in torch.load(job["batch"]).items()}
    reset_peak(dev)
    with deterministic():  # the one step, gated and timed (a second one is cut for time)
        ms, (state, m) = _events_ms(dev, lambda: bundle.fn(state, batch))
    dig = digest({"params": state["params"], "m": state["opt"]["m"]})
    if rank == 0 and dig != job["digest"]:
        torch.save(_cpu_result(state, m), work / "got_lm.pt")
    leaves = tree.leaves(state["params"])
    ar_ms, _ = _events_ms(dev, lambda: [collectives.psum_if_mapped(
        p, ctx.mesh_axes("dp"), ctx) for p in leaves])
    return {"rank": rank, "digest": dig, "metrics": {k: float(v) for k, v in m.items()},
            "ms": ms, "allreduce_ms": ar_ms, "peak_gb": peak_gb(dev),
            "grad_bytes": sum(t.numel() * t.element_size() for t in leaves)}


def rank_dp_recsys(rank, world, work, job, dev) -> dict:
    """10b on a rank: wide & deep's ``train`` cell over a (1, world)
    ``flat_dp`` mesh in each lookup mode (``cap_factor`` 4.0: nothing
    drops), from the seed-0 state's row shard on the seed-0 batch: this
    rank's state saved; then SASRec's 9c state placed over (1, world)
    (``DTensor`` leaves on the host), saved, and restored over (world, 1)
    with ``restore(shardings=)``, onto the card (each local block == the
    saved leaf's) and onto the host (every ``full_tensor()`` == the saved
    leaf)."""
    import functools
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch import configs, tree
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.train import TrainConfig, checkpoint, init_train_state

    out = {"rank": rank, "modes": {}}
    spec = configs.get(job["arch"], reduced=job["reduced"])
    cell = next(c for c in spec.shapes if c.kind == "train")
    ctx = _ctx(dev, world, (1, world), "flat_dp")
    lookup = recsys.sharded_lookup
    recsys.sharded_lookup = functools.partial(lookup, cap_factor=4.0)
    try:
        for mode in ("a2a", "allreduce"):
            mspec = replace(spec, config=replace(spec.config, lookup_mode=mode))
            tcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=3)
            bundle = steps.build_step(mspec, cell, ctx, tcfg)
            state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn,
                                     tcfg)
            batch = steps.make_inputs(mspec, cell, np.random.default_rng(0), device=dev)
            reset_peak(dev)
            ms, (state, m) = _events_ms(dev, lambda: bundle.fn(state, batch))
            torch.save(_cpu_result(state, m), work / f"got_{mode}_{rank}.pt")
            out["modes"][mode] = {"ms": ms, "loss": float(m["loss"]), "peak_gb": peak_gb(dev)}
            del state, batch, bundle
    finally:
        recsys.sharded_lookup = lookup
    # gloo cannot gather a DTensor held on the card (its all_gather_into_tensor
    # of CUDA tensors crashed a rank): the state is placed, saved and
    # gathered on a host mesh, and restored onto the card block by block
    host = torch.device("cpu")
    saved = torch.load(job["sasrec"])
    put = _ctx(host, world, (1, world), "flat_dp")
    shard = steps.fit_tree(saved, steps.state_shardings(saved, "recsys", put), put.mesh)
    coord = put.coordinate()
    placed = tree.unflatten(saved, [_as_dtensor(s.local_block(t, coord).contiguous(), s, t)
                                    for t, s in zip(tree.leaves(saved),
                                                    tree.flatten_up_to(saved, shard))])
    checkpoint.save(work / "ckpt", placed, 3).join(timeout=300)
    dist.barrier()
    out["restore"] = {"leaves": len(tree.leaves(saved))}
    for where in (dev, host):
        take = _ctx(where, world, (world, 1), "flat_dp")
        shard = steps.fit_tree(saved, steps.state_shardings(saved, "recsys", take), take.mesh)
        (got, step), restore_s = timed(where, lambda: checkpoint.restore(work / "ckpt", saved,
                                                                          shardings=shard))
        if where.type == dev.type and dev.type == "cuda":
            c = take.coordinate()
            out["restore"].update(step=step, restore_s=restore_s, blocks_same=all(
                t.to_local().is_cuda and bool(torch.equal(t.to_local().cpu(), s.local_block(w, c)))
                for t, w, s in zip(tree.leaves(got), tree.leaves(saved),
                                   tree.flatten_up_to(saved, shard))))
        else:
            out["restore"].update(
                sharded=sum(t.to_local().shape != t.shape for t in tree.leaves(got)),
                same=all(bool(torch.equal(t.full_tensor(), w))
                         for t, w in zip(tree.leaves(got), tree.leaves(saved))))
            out["restore"].setdefault("restore_s", restore_s)
    return out


def _as_dtensor(local, sharding, whole):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def rank_edge_gnn(rank, world, work, job, dev) -> dict:
    """10c on a rank: DimeNet's ``minibatch_lg`` with its edges over a (1,
    world) ``flat_dp`` mesh, from the seed-0 state on the seed-0 batch: one
    step, gated and timed (a second, timed step is cut for the run's time),
    and its :func:`digest` (rank 0 saves the state when it differs from the
    one-rank step's); one all-gather of a block's bf16 messages timed
    alone."""
    from repro_torch import configs
    from repro_torch.dist import collectives
    from repro_torch.launch import steps
    from repro_torch.train import TrainConfig, init_train_state

    spec = configs.get("dimenet", reduced=job["reduced"])
    cell = next(c for c in spec.shapes if c.name == job["cell"])
    ctx = _ctx(dev, world, (1, world), "flat_dp")
    tcfg = TrainConfig(lr=GNN_LR, warmup=1, total_steps=3)
    bundle = steps.build_step(spec, cell, ctx, tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg)
    batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=dev)
    reset_peak(dev)
    ms, (state, m) = _events_ms(dev, lambda: bundle.fn(state, batch))  # gated and timed
    dig = digest({"params": state["params"], "m": state["opt"]["m"]})
    if rank == 0 and dig != job["digest"]:
        torch.save(_cpu_result(state, m), work / "got_gnn.pt")
    e_loc = batch["edge_src"].shape[0] // world
    msg = torch.zeros((e_loc, bundle.cfg.d_hidden), dtype=torch.bfloat16, device=dev)
    ag_ms, _ = _events_ms(dev, lambda: collectives.all_gather(msg, ctx.group("edge")), reps=3)
    return {"rank": rank, "digest": dig, "metrics": {k: float(v) for k, v in m.items()},
            "ms": ms, "allgather_ms": ag_ms, "peak_gb": peak_gb(dev), "edges_a_rank": e_loc}


def rank_two(rank, world, work, job, dev) -> dict:
    """10a then 10c on one set of 2 ranks (one spawn: a spawn costs ~10 s)."""
    lm = rank_dp_lm(rank, world, work, job["lm"], dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"lm": lm, "gnn": rank_edge_gnn(rank, world, work, job["gnn"], dev)}


def rank_four(rank, world, work, job, dev) -> dict:
    """10b, 10e then 10f on one set of 4 ranks (one spawn)."""
    recsys = rank_dp_recsys(rank, world, work, job["recsys"], dev)
    free_device(dev)
    placed = rank_placed(rank, world, work, job["placed"], dev)
    free_device(dev)
    return {"recsys": recsys, "placed": placed,
            "decode": rank_decode(rank, world, work, job["decode"], dev)}


RANK_BODIES = {"two": rank_two, "four": rank_four}


def _same_step(what, ranks, want_digest, got_file, want, lr, **tol) -> dict:
    """The gate of a step over ranks against the one-rank step: every
    rank's :func:`digest` equal (their states bit-equal), and equal to the
    one-rank step's (then nothing moved and every error is 0) or within
    ``tol`` of it (:func:`compare_step` on rank 0's saved state)."""
    if any(r["digest"] != ranks[0]["digest"] for r in ranks):
        fail(f"phase 10 {what}: the ranks' states differ after the step")
    if ranks[0]["digest"] == want_digest:
        loss = ranks[0]["metrics"]["loss"]
        err = abs(loss - want["metrics"]["loss"]) / max(abs(want["metrics"]["loss"]), 1e-30)
        rtol = tol.get("loss_rtol", TRAIN_RTOL)
        if err > rtol:
            fail(f"train check {what}: loss {loss} over ranks vs {want['metrics']['loss']} on one")
        gn = ranks[0]["metrics"]["grad_norm"] - want["metrics"]["grad_norm"]
        if gn:
            fail(f"train check {what}: grad_norm differs though the states are bit-equal")
        return {"loss_rel_err": err, "grad_norm_rel_err": 0.0, "grad_tol_used": 0.0,
                "param_max_abs_err": 0.0, "param_off_share": 0.0, "bit_equal": True}
    got = torch.load(got_file)
    out = compare_step(what, got, ranks[0]["metrics"], want, want["metrics"], lr, "over ranks",
                       "on one", **tol)
    out["bit_equal"] = False
    return out


def prepare_dp_lm(dev, arch, *, reduced: bool, batch: int, steps_n: int,
                  dtype: str | None = None) -> tuple:
    """Phase 10a's one-rank half: ``arch``'s ``train_4k`` at its widths on
    phase 9a's first batch (``batch`` sequences from the same
    ``TokenBatcher``) from the seed-0 state, one step as 9a runs it (2
    microbatches, deterministic algorithms), the loss of each half, and
    the step's FLOPs (``FlopCounterMode`` in a call of its own: the mode
    changes how some bf16 sums round).  ``dtype`` overrides the compute
    dtype (the CPU rehearsal's f32: CPU bf16 products round otherwise in
    processes with other thread counts).  Returns the one-rank result and
    the ranks' job (2 ranks, one microbatch of half the batch a rank)."""
    from dataclasses import replace

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.data import TokenBatcher, synth_corpus
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.train import TrainConfig, init_train_state

    spec = configs.get(arch, reduced=reduced)
    dtype = dtype or spec.config.dtype
    spec = replace(spec, config=replace(spec.config, dtype=dtype))
    cfg = spec.config
    cell = next(c for c in spec.shapes if c.kind == "train")
    seq = cell.dims["seq_len"]
    corpus = synth_corpus(vocab_size=cfg.vocab, n_docs=2000, mean_len=512, seed=0, device=dev)
    b = TokenBatcher(corpus, batch, seq, seed=0).batch_at(0)
    del corpus
    tcfg = TrainConfig(total_steps=steps_n, warmup=2, microbatches=2)
    bundle = steps.build_step(spec, cell, tcfg=tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg)
    with torch.no_grad():
        halves = [float(transformer.loss_fn(state["params"], {k: v[i * batch // 2:(i + 1) * batch
                                                                   // 2] for k, v in b.items()},
                                             cfg)) for i in range(2)]
    with deterministic():
        want_s, want_m = bundle.fn(state, b)
    want_digest = digest({"params": want_s["params"], "m": want_s["opt"]["m"]})
    want = _cpu_result(want_s, want_m)
    want["metrics"]["loss"] = float(np.mean(halves))  # the ranks report the dp mean
    del want_s
    with FlopCounterMode(display=False) as fc:  # a call of its own: the mode moves bf16 sums
        bundle.fn(state, b)
    batch_file = RANK_WORK / "dp_lm_batch.pt"
    batch_file.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.cpu() for k, v in b.items()}, batch_file)
    prep = {"arch": arch, "batch": batch, "seq": seq, "lr": tcfg.lr, "want": want,
            "digest": want_digest, "flops": float(fc.get_total_flops())}
    job = {"arch": arch, "reduced": reduced, "steps_n": steps_n, "dtype": dtype,
           "batch": str(batch_file), "digest": want_digest}
    return prep, job


def finish_dp_lm(dev, prep: dict, work: Path, ranks: list) -> dict:
    """Phase 10a's gate and its figures: ms a step, the gradient
    all-reduce's ms, tokens/s, peak GB a rank."""
    arch, batch, seq = prep["arch"], prep["batch"], prep["seq"]
    check = _same_step(f"{arch} dp over 2 ranks", ranks, prep["digest"], work / "got_lm.pt",
                       prep["want"], prep["lr"])
    ms = max(r["ms"] for r in ranks)
    out = {"arch": arch, "batch": batch, "seq": seq, "ranks": ranks, "check": check,
           "one_rank_flops": prep["flops"], "ms": ms, "tokens_per_s": batch * seq / (ms / 1e3),
           "allreduce_ms": max(r["allreduce_ms"] for r in ranks),
           "peak_gb": [r["peak_gb"] for r in ranks]}
    log(f"[ranks] 10a {arch} at its widths over 2 gloo ranks on one {dev.type} device ({batch} x "
        f"{seq} tokens, {batch // 2} sequences a rank, one microbatch): states bit-equal across "
        f"ranks; == the one-rank step ({'bit for bit' if check['bit_equal'] else 'within tolerance'}"
        f"; loss rel err {check['loss_rel_err']:.3g} against the halves' mean, "
        f"grad_norm {check['grad_norm_rel_err']:.3g}, first moment at "
        f"{check['grad_tol_used']:.3g} of its tolerance, params {check['param_max_abs_err']:.3g}); "
        f"{ms:.1f} ms a step (CUDA events, the gated step), {out['tokens_per_s']:.1f} tokens/s, "
        f"gradient all-reduce {out['allreduce_ms']:.1f} ms ({ranks[0]['grad_bytes'] / 1e9:.3f} GB "
        f"over gloo), peak {out['peak_gb']} GB a rank")
    return out


#: phase 10e's gates: the placed step (bf16 compute over a (2, 2) mesh)
#: against the one-rank step.  A row-parallel product over 2 ``tp`` ranks
#: rounds each half to bf16 (unit roundoff 2^-8) and their sum again, and
#: each ``fsdp`` reduce-scatter sums bf16 gradients, where one rank rounds a
#: product once and sums its microbatches in f32: so the repo's bf16
#: tolerances for two rounding orders (``test_torch_train.BF16_LOSS_TOL``
#: and ``BF16_GRAD_TOL``).  The loss, a mean over the batch's tokens, and
#: the global norm within PLACED_RTOL relative; the first moment (0.1 x the
#: clipped gradient) within PLACED_GRAD_RTOL of each leaf's largest
#: magnitude; the parameters (10e-i) as :func:`compare_step` holds them,
#: over the elements whose gradient exceeds that tolerance (below it a
#: gradient's sign may differ, and AdamW then moves it 2 lr the other way)
PLACED_RTOL, PLACED_GRAD_RTOL = 2e-3, 0.05
#: phase 10e's mesh: (data 2, model 2) under ``tp_fsdp`` on 4 gloo ranks
PLACED_MESH = (2, 2)


def save_placed_want(want: dict, path: Path, with_params: bool) -> list:
    """The one-rank step's first moment (bf16: 2^-9 relative, far inside
    ``PLACED_GRAD_RTOL``) and, when asked, its f32 parameters, saved for
    the ranks to read block by block (``mmap``); returns each moment
    leaf's largest magnitude (flattened order)."""
    from repro_torch import tree

    m = want["opt"]["m"]
    out = {"opt": {"m": tree.tree_map(lambda t: t.to(torch.bfloat16), m)}}
    if with_params:
        out["params"] = want["params"]
    torch.save(out, path)
    return [float(t.abs().max()) for t in tree.leaves(m)]


def prepare_placed_moe(dev, *, reduced: bool, layers: int | None, batch: int,
                       dtype: str | None = None) -> tuple:
    """Phase 10e-ii's one-rank half: moonshot-v1-16b-a3b at its widths, its
    depth cut to ``layers``, ``batch`` sequences of the ``train_4k``
    cell's length from ``TokenBatcher``, one step from the seed-0 state in
    one microbatch a ``dp`` shard (so each routes its tokens at the
    shard's capacity, as a rank of the mesh does), deterministic
    algorithms.  Returns the figures the ranks are held to and their job."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.data import TokenBatcher, synth_corpus
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.train import TrainConfig, init_train_state

    arch = "moonshot-v1-16b-a3b"
    spec = configs.get(arch, reduced=reduced)
    spec = replace(spec, config=replace(spec.config, n_layers=layers or spec.config.n_layers,
                                        dtype=dtype or spec.config.dtype))
    cfg = spec.config
    cell = next(c for c in spec.shapes if c.kind == "train")
    seq = cell.dims["seq_len"]
    corpus = synth_corpus(vocab_size=cfg.vocab, n_docs=2000, mean_len=512, seed=0, device=dev)
    b = TokenBatcher(corpus, batch, seq, seed=0).batch_at(0)
    del corpus
    dp = PLACED_MESH[0]
    tcfg = TrainConfig(total_steps=4, warmup=2, microbatches=dp)
    bundle = steps.build_step(spec, cell, tcfg=tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg)
    rows = batch // dp
    with torch.no_grad():
        loss = float(np.mean([float(transformer.loss_fn(state["params"], {
            k: v[i * rows:(i + 1) * rows] for k, v in b.items()}, cfg)) for i in range(dp)]))
    with deterministic():
        want_s, want_m = bundle.fn(state, b)
    del state
    from repro_torch import tree

    want = {"opt": {"m": tree.tree_map(lambda t: t.cpu(), want_s["opt"]["m"])},
            "metrics": {k: float(v) for k, v in want_m.items()}}
    want["metrics"]["loss"] = loss  # the ranks report the dp mean
    del want_s
    free_device(dev)
    batch_file = RANK_WORK / "placed_moe_batch.pt"
    torch.save({k: v.cpu() for k, v in b.items()}, batch_file)
    maxes = save_placed_want(want, RANK_WORK / "placed_moe_want.pt", with_params=False)
    prep = {"arch": arch, "layers": layers, "batch": batch, "seq": seq, "lr": tcfg.lr,
            "metrics": want["metrics"], "m_max": maxes}
    job = {"arch": arch, "reduced": reduced, "layers": layers, "dtype": cfg.dtype,
           "batch": str(batch_file), "want": str(RANK_WORK / "placed_moe_want.pt"),
           "m_max": maxes, "params": False, "timed_step": False}
    return prep, job


def placed_job_lm(prep: dict, job: dict) -> tuple:
    """Phase 10e-i's figures and job: 10a's model, batch and one-rank step
    (9a's), its moments and parameters saved for the ranks."""
    want = prep["want"]
    maxes = save_placed_want(want, RANK_WORK / "placed_lm_want.pt", with_params=True)
    figures = {"arch": prep["arch"], "layers": None, "batch": prep["batch"], "seq": prep["seq"],
               "lr": prep["lr"], "metrics": want["metrics"], "m_max": maxes}
    return figures, {"arch": prep["arch"], "reduced": job["reduced"], "layers": None,
                     "dtype": job["dtype"], "batch": job["batch"],
                     "want": str(RANK_WORK / "placed_lm_want.pt"), "m_max": maxes,
                     "params": True, "timed_step": False}


def _placed_errors(state, want_file: str, placement, m_max: list, lr: float,
                   with_params: bool) -> dict:
    """This rank's blocks against the same blocks of the one-rank step's
    state (the gathered state compared block by block, read from
    ``want_file`` by ``mmap``): per leaf the first moment's largest error
    and, with parameters, the share of the block whose gradient passes the
    tolerance and moved more than 1e-2 lr off, and the largest move."""
    from repro_torch import tree

    want = torch.load(want_file, mmap=True, weights_only=True)
    coord = placement.ctx.coordinate()
    shard = dict(zip(tree.flatten_with_paths(placement.whole)[0], placement.shardings()))
    paths_m, got_m = tree.flatten_with_paths({"opt": {"m": state["opt"]["m"]}})
    paths_p, got_p = tree.flatten_with_paths({"params": state["params"]})
    want_p = tree.leaves(want["params"]) if with_params else [None] * len(got_p)
    out = {"m_err": [], "p_off": [], "p_err": []}
    for i, (path, g, w, top) in enumerate(zip(paths_m, got_m, tree.leaves(want["opt"]["m"]),
                                              m_max)):
        wb = shard[path].local_block(w, coord).to(g.device, torch.float32)
        out["m_err"].append(float((g.float() - wb).abs().max()))
        if with_params:
            pw = shard[paths_p[i]].local_block(want_p[i], coord).to(g.device)
            diff = (got_p[i] - pw).abs()
            real = wb.abs() > PLACED_GRAD_RTOL * top
            out["p_off"].append(int(((diff > 1e-2 * lr) & real).sum()) / diff.numel())
            out["p_err"].append(float(diff.max()))
    return out


def rank_placed(rank, world, work, job, dev) -> dict:
    """10e on a rank: 10e-i (qwen2-0.5b) then 10e-ii (moonshot, depth cut)
    placed over the (2, 2) ``tp_fsdp`` mesh: each rank draws every leaf
    from the seed-0 generator and keeps its block, one gated step on the
    saved global batch (deterministic algorithms), its blocks held against
    the one-rank step's, then a second step timed where the job asks for
    one (none does: the gated step is the timed one, a second step cut for
    the run's time); then one forward's FSDP gathers
    (every placed weight's block cast to bf16 and gathered over ``fsdp``)
    and one tensor-parallel all-reduce of a layer's activations, timed
    alone; state bytes and peak GB of the rank."""
    from dataclasses import replace

    from repro_torch import configs, tree
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import StatePlacement
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.train import TrainConfig, init_train_state

    out = {}
    for part in ("lm", "moe"):
        j = job[part]
        spec = configs.get(j["arch"], reduced=j["reduced"])
        cfg = replace(spec.config, dtype=j["dtype"])
        if j["layers"]:
            cfg = replace(cfg, n_layers=j["layers"])
        spec = replace(spec, config=cfg)
        cell = next(c for c in spec.shapes if c.kind == "train")
        ctx = _ctx(dev, world, PLACED_MESH, "tp_fsdp")
        tcfg = TrainConfig(total_steps=4, warmup=2)
        bundle = steps.build_step(spec, cell, ctx, tcfg)
        reset_peak(dev)
        state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg)
        placement = StatePlacement(ctx, "lm", init_train_state(
            None, lambda _: bundle.init_fn.whole, tcfg))
        state_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(state))
        whole_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(placement.whole))
        batch = {k: v.to(dev) for k, v in torch.load(j["batch"]).items()}
        with deterministic():
            ms, (state, m) = _events_ms(dev, lambda: bundle.fn(state, batch))
        errs = _placed_errors(state, j["want"], placement, j["m_max"], tcfg.lr, j["params"])
        if j["timed_step"]:  # a second step, timed alone
            ms, (state, _) = _events_ms(dev, lambda: bundle.fn(state, batch))
        peak = peak_gb(dev)
        plan = transformer.placement(cfg, ctx)
        gathers = [(t, pl) for t, pl in zip(tree.leaves(state["params"]), tree.leaves(plan))
                   if any(lg == "fsdp" and a for lg, a in pl.dims)]
        del state

        def fsdp_pass():
            for t, pl in gathers:
                i = next(i for i, (lg, _) in enumerate(pl.dims) if lg == "fsdp")
                collectives.all_gather_dim(t.to(torch.bfloat16), pl.axes(i), ctx, i)

        gather_ms, _ = _events_ms(dev, fsdp_pass)
        rows = batch["tokens"].shape[0] // ctx.n("dp")
        act = torch.ones((rows, batch["tokens"].shape[1], cfg.d_model), dtype=torch.bfloat16,
                         device=dev)
        ar_ms, _ = _events_ms(dev, lambda: collectives.reduce_from(act, ctx.mesh_axes("tp"),
                                                                  ctx), reps=3)
        out[part] = {"rank": rank, "metrics": {k: float(v) for k, v in m.items()},
                     "ms": ms, "errs": errs, "peak_gb": peak,
                     "timed": "the second step" if j["timed_step"] else "the gated step",
                     "state_bytes": state_bytes, "whole_bytes": whole_bytes,
                     "fsdp_gather_ms": gather_ms,
                     "gathered_bytes": sum(t.numel() * 2 * ctx.n("fsdp") for t, _ in gathers),
                     "tp_allreduce_ms": ar_ms, "tp_allreduce_bytes": act.numel() * 2,
                     # a tp all-reduce per layer's attention and FFN in the forward, again
                     # in remat's recompute, and each copy_to's backward
                     "tp_allreduces_a_step": 6 * cfg.n_layers}
        del gathers, act
        free_device(dev)
    return out


def finish_placed(dev, prep: dict, ranks: list) -> dict:
    """Phase 10e's gates (every rank's metrics equal; loss, global norm,
    first moment and, for 10e-i, parameters within the ``PLACED_*``
    tolerances of the one-rank step) and its figures."""
    out = {}
    for part, label in (("lm", "10e-i"), ("moe", "10e-ii")):
        p, rs = prep[part], [r[part] for r in ranks]
        if any(r["metrics"] != rs[0]["metrics"] for r in rs):
            fail(f"phase {label}: the ranks' metrics differ: {[r['metrics'] for r in rs]}")
        got, want = rs[0]["metrics"], p["metrics"]
        check = {}
        for k in ("loss", "grad_norm"):
            err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            if not np.isfinite(got[k]) or err > PLACED_RTOL:
                fail(f"phase {label}: {k} {got[k]} placed vs {want[k]} on one rank")
            check[f"{k}_rel_err"] = err
        m_err = [max(r["errs"]["m_err"][i] for r in rs) for i in range(len(p["m_max"]))]
        used = [e / max(PLACED_GRAD_RTOL * top, 1e-9) for e, top in zip(m_err, p["m_max"])]
        if max(used) > 1:
            fail(f"phase {label}: first moment off by {m_err} against maxima {p['m_max']}")
        check["grad_tol_used"] = max(used)
        if rs[0]["errs"]["p_err"]:
            p_err = max(max(r["errs"]["p_err"]) for r in rs)
            share = max(max(r["errs"]["p_off"]) for r in rs)
            if p_err > 2 * p["lr"] * (1 + 1e-3) or share > 1e-3:
                fail(f"phase {label}: parameters off by {p_err} (lr {p['lr']}), {share} of a "
                     "leaf by more than 1e-2 lr where its gradient passes the tolerance")
            check.update(param_max_abs_err=p_err, param_off_share=share)
        ms = max(r["ms"] for r in rs)
        tokens = p["batch"] * p["seq"]
        o = {"arch": p["arch"], "batch": p["batch"], "seq": p["seq"], "check": check, "ms": ms,
             "tokens_per_s": tokens / (ms / 1e3), "peak_gb": [r["peak_gb"] for r in rs],
             "state_bytes": [r["state_bytes"] for r in rs], "whole_bytes": rs[0]["whole_bytes"],
             "fsdp_gather_ms": max(r["fsdp_gather_ms"] for r in rs),
             "gathered_bytes": rs[0]["gathered_bytes"],
             "tp_allreduce_ms": max(r["tp_allreduce_ms"] for r in rs),
             "tp_allreduce_bytes": rs[0]["tp_allreduce_bytes"],
             "tp_allreduces_a_step": rs[0]["tp_allreduces_a_step"], "metrics": got}
        out[part] = o
        depth = (f", depth cut to {p['layers']} of 48 layers (the whole depth with AdamW is the "
                 "115 GB that waits for four cards)" if p.get("layers") else "")
        log(f"[ranks] {label} {p['arch']} at its widths{depth}, placed over a (data 2, model 2) "
            f"tp_fsdp mesh of 4 gloo ranks on one {dev.type} device ({p['batch']} x {p['seq']} "
            f"tokens, {p['batch'] // 2} a dp rank): == the one-rank step (loss rel err "
            f"{check['loss_rel_err']:.3g}, grad_norm {check['grad_norm_rel_err']:.3g}, first "
            f"moment at {check['grad_tol_used']:.3g} of its tolerance"
            + (f", params {check['param_max_abs_err']:.3g}, off share "
               f"{check['param_off_share']:.3g}" if "param_off_share" in check else "")
            + f"); {ms:.1f} ms a step (CUDA events, {rs[0]['timed']}), {o['tokens_per_s']:.1f} "
            f"tokens/s; one forward's FSDP gathers {o['fsdp_gather_ms']:.1f} ms "
            f"({o['gathered_bytes'] / 1e9:.3f} GB gathered, bf16), one tp all-reduce "
            f"{o['tp_allreduce_ms']:.2f} ms ({o['tp_allreduce_bytes'] / 1e6:.1f} MB, "
            f"{o['tp_allreduces_a_step']} a step); state {[b / 1e9 for b in o['state_bytes']]} GB "
            f"a rank against {o['whole_bytes'] / 1e9:.3f} GB whole"
            + (" (10a's replica on each rank)" if part == "lm" else "")
            + f", peak {o['peak_gb']} GB a rank")
    return out


#: phase 10f's rules: 10e's ``tp_fsdp`` rules with the sequence axes a
#: deployment names (``transformer.cache_logical_axes``): ``seqm`` on the
#: model axis (decode_32k: batch on data, sequence on model) and ``sp`` on
#: the whole mesh (long_500k)
DECODE_SEQ_RULES = {"seqm": ("model",), "sp": ("data", "model")}


def decode_rules(layout: str):
    """10f's rules: 10e's ``tp_fsdp`` alone (``"tp_fsdp"``: None), with the
    sequence axes of :data:`DECODE_SEQ_RULES` named (``"seq"``), or those
    with ``fsdp`` on no axis (``"serve"``: tensor and data parallelism, the
    weights held, not gathered a step, as a serving deployment holds
    them)."""
    if layout == "tp_fsdp":
        return None
    from repro_torch.dist.sharding import _rules_for

    rules = dict(_rules_for("tp_fsdp", ("data", "model")), **DECODE_SEQ_RULES)
    if layout == "serve":
        rules["fsdp"] = ()
    return rules


def fill_cache(cache: dict, batch: int, row0: int, seq0: int, draw: int, seed: int,
               layer0: int = 0) -> None:
    """Seeded values in a cache block ``(layers, rows, positions, Hkv, D)``
    that holds layers ``[layer0, ...)``, rows ``[row0, ...)`` of a batch of
    ``batch`` and positions ``[seq0, ...)``: each (layer, run of ``draw``
    positions) of the whole cache is drawn from its own seed and the
    block's rows and positions cut out of it, so a rank makes its own
    block and the one-rank half the whole cache, with the same values."""
    n_layers, rows, s_blk, hkv, hd = cache["k"].shape
    dev = cache["k"].device
    gen = torch.Generator(device=dev)
    for li in range(n_layers):
        for j in range(seq0 // draw, (seq0 + s_blk + draw - 1) // draw):
            lo, hi = max(j * draw, seq0), min((j + 1) * draw, seq0 + s_blk)
            for kv, name in enumerate(("k", "v")):
                gen.manual_seed(seed + 2 * ((layer0 + li) * 1_000_003 + j) + kv)
                vals = torch.randn((batch, draw, hkv, hd), generator=gen, device=dev,
                                   dtype=cache[name].dtype)
                cache[name][li, :, lo - seq0:hi - seq0] = vals[row0:row0 + rows,
                                                               lo - j * draw:hi - j * draw]


def _decode_spec(p: dict, dtype):
    """The arch config, cell dims and seq_shard of a 10f part."""
    from dataclasses import replace

    from repro_torch import configs

    spec = configs.get(p["arch"], reduced=p["reduced"])
    cfg = replace(spec.config, dtype=dtype or spec.config.dtype)
    if p.get("layers"):
        cfg = replace(cfg, n_layers=p["layers"])
    cell = next(c for c in spec.shapes if c.name == p["cell"])
    b = p.get("batch") or cell.dims["global_batch"]
    s = p.get("seq") or cell.dims["seq_len"]
    return cfg, b, s, bool(cell.dims.get("seq_shard"))


#: 10f's gate on the K/V rows that the steps wrote in the layers after
#: the first, in bf16 ulps of the RMS of each written head vector (the D
#: values of one row, position and KV head; near-zero values take their
#: vector's scale).  The first layer's rows come from the same embedding
#: rows and agree within ``ATT_TOL[bf16]`` (bit for bit on the card); the
#: later ones carry the residual stream's drift over the ranks (the ``tp``
#: partial sums of ``wo`` and ``wd`` rounded to bf16 before the sum, the
#: sequence blocks combined in another order than one kernel call).  Set
#: between the readings (PERF.md §6): the largest sound one (29 ulps
#: on an H100, 31 in a CPU bf16 run) and the control, a stale row (the
#: seeded value the step should have overwritten: 287.5 ulps at the
#: least), which every run reads too and which must exceed it
CACHE_ULPS = 96


def rms_ulps(diff, ref):
    """``diff`` in bf16 ulps (``2^(floor(log2 x) - 7)``) of the RMS of
    each head vector of ``ref`` (its last dim)."""
    rms = ref.float().pow(2).mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
    return diff / torch.exp2(torch.floor(torch.log2(rms)) - 7)


def block_kernel_ms(dev, cfg, cache: dict, p: dict, b: int, s: int, ss: bool, gen) -> tuple:
    """The kernel on rank 0's block of the first layer, called as the
    placed step calls it (its rows and sequence block, ``return_lse``
    where the sequence is split; its query heads and their slice of the
    KV heads where ``tp`` splits the heads and the sequence is whole),
    timed on the one card in the parent: its ms and the block's (rows,
    positions, KV heads)."""
    import math

    from repro_torch.dist import ShardingCtx
    from repro_torch.dist.sharding import AbstractMesh, mesh_shape
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import transformer

    ctx = ShardingCtx(mesh=AbstractMesh(PLACED_MESH, ("data", "model")), profile="tp_fsdp",
                      rules=dict(decode_rules(p["layout"]) or {}))
    cplan = transformer.cache_placement(cfg, ctx, b, s, ss)
    plan = transformer.placement(cfg, ctx)
    att = transformer._layer_plan(plan)["wo"].axes(0) if plan is not None else ()
    n = math.prod(mesh_shape(ctx.mesh)[a] for a in att)
    b_loc, s_blk = cplan.block[1:3] if cplan is not None else (b, s)
    seq = cplan.axes(2) if cplan is not None else ()
    k, v = (cache[x][0][:b_loc, :s_blk].contiguous() for x in ("k", "v"))
    nq = cfg.n_heads
    if att and not seq and cfg.n_heads % n == 0:
        h0, nk = transformer._decode_heads(cfg, n, 0)
        k, v, nq = k[:, :, h0:h0 + nk], v[:, :, h0:h0 + nk], cfg.n_heads // n
    q = torch.randn((b_loc, nq, cfg.head_dim), generator=gen, device=dev).to(k.dtype)
    kv_len = torch.full((b_loc,), min(p["pos0"] + p["steps"], s_blk), dtype=torch.int32,
                        device=dev)
    ms = device_ms(lambda: decode_attention(q, k, v, kv_len, return_lse=bool(seq)), dev)
    return ms, [b_loc, s_blk, int(k.shape[2])]


def prepare_decode(dev, job: dict) -> tuple:
    """Phase 10f's one-rank halves, before the spawn of 4 ranks: for each
    part, the seed's whole parameters and seeded whole cache, ``steps``
    one-card ``decode_step`` calls at the cache's last positions (an MoE's
    rows one ``dp`` shard at a time, each routed at its shard's capacity
    as on the mesh), the logits and the rows written saved for the ranks,
    the kernel's ms on the whole cache's first layer and on rank 0's
    block of it (:func:`block_kernel_ms`); then the one-rank engine's
    first tick's logits.  Everything is freed before the ranks start."""
    from repro_torch.kernels.decode_attention import _sm_count, decode_attention, split_plan
    from repro_torch.models import transformer
    from repro_torch.serve import DecodeEngine

    prep, parts = {}, {}
    for name, p in job["cells"].items():
        t0 = time.perf_counter()
        cfg, b, s, ss = _decode_spec(p, job["dtype"])
        params = transformer.init(torch.Generator(device=dev).manual_seed(p["seed"]), cfg)
        cache = transformer.init_cache(cfg, b, s, device=dev)
        fill_cache(cache, b, 0, 0, job["draw"], p["seed"])
        gen = torch.Generator(device=dev).manual_seed(p["seed"] + 1)
        tokens = torch.randint(0, cfg.vocab, (p["steps"], b, 1), generator=gen, device=dev,
                               dtype=torch.int32)
        pos0 = s - 1 - p["steps"]
        parts_n = PLACED_MESH[0] if cfg.moe and b % PLACED_MESH[0] == 0 else 1
        rows = b // parts_n
        logits = []
        for i in range(p["steps"]):
            step = []
            for j in range(parts_n):
                part = {k: v[:, j * rows:(j + 1) * rows] for k, v in cache.items()}
                step.append(transformer.decode_step(params, part, tokens[i, j * rows:(j + 1) * rows],
                                                    pos0 + i, cfg)[0])
            logits.append(torch.cat(step))
        del part, step  # views of the cache: it is freed below
        logits = torch.stack(logits)
        if not bool(torch.isfinite(logits).all()):
            fail(f"phase 10f-{name}: the one-rank logits are not finite")
        q = torch.randn((b, cfg.n_heads, cfg.head_dim), generator=gen, device=dev).to(
            cache["k"].dtype)
        kv_len = torch.full((b,), pos0 + p["steps"], dtype=torch.int32, device=dev)
        kernel_ms = device_ms(lambda: decode_attention(q, cache["k"][0], cache["v"][0], kv_len),
                              dev)
        block_ms, block = block_kernel_ms(dev, cfg, cache, dict(p, pos0=pos0), b, s, ss, gen)
        # the one-card call's split: (tile, shares a (row, KV head)) and its blocks
        plan = split_plan(b, cfg.n_kv_heads, cfg.head_dim, s, cache["k"].element_size(),
                          _sm_count(dev)) if dev.type == "cuda" else None
        want = RANK_WORK / f"decode_{name}_want.pt"
        torch.save({"logits": logits.cpu(), "tokens": tokens.cpu(),
                    "rows": {k: v[:, :, pos0:pos0 + p["steps"]].cpu() for k, v in cache.items()}},
                   want)
        cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        prep[name] = {"arch": p["arch"], "batch": b, "seq": s, "seq_shard": ss,
                      "layout": p["layout"],
                      "layers": cfg.n_layers, "steps": p["steps"], "pos0": pos0,
                      "one_card_kernel_ms": kernel_ms, "block_kernel_ms": block_ms,
                      "one_card_split": None if plan is None else {
                          "tile": plan[0], "n_split": plan[1],
                          "blocks": b * cfg.n_kv_heads * plan[1]},
                      "kernel_block": block, "whole_cache_gb": cache_bytes / 1e9,
                      "prepare_s": time.perf_counter() - t0}
        parts[name] = dict(p, want=str(want), pos0=pos0)
        del params, cache, logits, q
        free_device(dev)
    e = job["engine"]
    cfg, _, _, _ = _decode_spec(e, job["dtype"])
    rng = np.random.default_rng(e["seed"])
    prompts = [rng.integers(0, cfg.vocab, e["prompt"]).tolist() for _ in range(e["requests"])]
    params = transformer.init(torch.Generator(device=dev).manual_seed(e["seed"]), cfg)
    # the one-rank engine up to its first tick: the gate's logits
    first, _, ticks, run_s = serve_first_tick(
        DecodeEngine(params, cfg, batch_slots=e["slots"], max_seq=e["max_seq"]), prompts,
        e["max_new"], max_ticks=1)
    del params
    free_device(dev)  # the engine died with serve_first_tick's frame
    want = RANK_WORK / "decode_engine_want.pt"
    torch.save({"first": first.cpu()}, want)
    prep["engine"] = {"arch": e["arch"], "layers": cfg.n_layers, "slots": e["slots"],
                      "max_seq": e["max_seq"], "requests": e["requests"], "first_tick_s": run_s}
    parts["engine"] = dict(e, want=str(want), prompts=prompts)
    return prep, {"dtype": job["dtype"], "draw": job["draw"], "parts": parts}


def serve_first_tick(eng, prompts: list, max_new: int, max_ticks: int = 10_000) -> tuple:
    """Serve ``prompts`` (``max_new`` tokens each) on ``eng`` for at most
    ``max_ticks`` ticks: the first decode tick's logits (f32), every
    request's tokens, the ticks and the host seconds.  The engine is
    referenced from this frame alone, so it is freed when the call
    returns."""
    from repro_torch.serve import Request

    first, decode = [], eng._decode

    def spy(*args):
        logits, cache = decode(*args)
        if not first:
            first.append(logits.float())
        return logits, cache

    eng._decode = spy
    reqs = [Request(rid=i, prompt=np.asarray(pr, np.int32), max_new_tokens=max_new)
            for i, pr in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    ticks = eng.run_until_drained(max_ticks)
    run_s = time.perf_counter() - t0
    return first[0], [r.out_tokens for r in reqs], ticks, run_s


def _block_origin(ctx, plan, block: tuple) -> tuple:
    """The first row and position of this rank's cache block."""
    rows, seq = (plan.axes(1), plan.axes(2)) if plan is not None else ((), ())
    return (ctx.axes_group(rows)[1] * block[1] if rows else 0,
            ctx.axes_group(seq)[1] * block[2] if seq else 0)


def _decode_cache_errors(cache: dict, want_rows: dict, p: dict, b: int, origin: tuple,
                         seed: int, draw: int) -> dict:
    """This rank's cache block after the steps against the one-rank
    cache's same block, a layer at a time: every position the steps did
    not write bit-equal to the seeded values; the rows the one-rank steps
    wrote at ``pos0 ...`` within ``ATT_TOL[bf16]`` in the first layer and
    within :data:`CACHE_ULPS` (:func:`rms_ulps`) in the later ones.
    Returns each class's largest error and count beyond, and the control:
    the fewest ulps by which any written head vector of a later layer
    would be off had the step left it stale (its seeded value)."""
    n_layers, rows, s_blk = cache["k"].shape[:3]
    row0, seq0 = origin
    atol, rtol = ATT_TOL[torch.bfloat16]
    out = {"unwritten_bad": 0, "first_err": 0.0, "first_bad": 0, "later_ulps": 0.0,
           "later_bad": 0, "stale_min_ulps": None}
    # local position -> the (last) step that wrote it
    written = {min(max(p["pos0"] + t, 0), p["seq"] - 1) - seq0: t for t in range(p["steps"])}
    written = {at: t for at, t in written.items() if 0 <= at < s_blk}
    for li in range(n_layers):
        fresh = {k: torch.empty_like(v[li:li + 1]) for k, v in cache.items()}
        fill_cache(fresh, b, row0, seq0, draw, seed, layer0=li)
        for k in fresh:
            got, want = cache[k][li], fresh[k][0]
            keep = torch.ones(s_blk, dtype=torch.bool, device=got.device)
            keep[list(written)] = False
            out["unwritten_bad"] += int((got[:, keep] != want[:, keep]).sum())
            for at, t in written.items():
                w = want_rows[k][li, row0:row0 + rows, t].to(got.device).float()
                diff = (got[:, at].float() - w).abs()
                if li == 0:
                    out["first_err"] = max(out["first_err"], float(diff.max()))
                    out["first_bad"] += int((diff > atol + rtol * w.abs()).sum())
                    continue
                u = rms_ulps(diff, w)
                out["later_ulps"] = max(out["later_ulps"], float(u.max()))
                out["later_bad"] += int((u > CACHE_ULPS).sum())
                stale = float(rms_ulps((want[:, at].float() - w).abs(), w).amax(dim=-1).min())
                old = out["stale_min_ulps"]
                out["stale_min_ulps"] = stale if old is None else min(old, stale)
    return out


def rank_decode(rank, world, work, job, dev) -> dict:
    """10f on a rank, on 10e's (data 2, model 2) mesh: for each part the
    seed's parameters placed (each leaf drawn whole, the block kept), the
    rank's seeded cache block, ``steps`` placed ``decode_step`` calls on
    the saved tokens (CUDA events between barriers; the launch count), the
    logits against the one-rank half's, the cache block against its one;
    one layer's FSDP gathers and the combine of one layer (collectives,
    so timed on the ranks) timed; cache and peak GB, the part's seconds.
    Then the engine under the context on the saved requests: its tokens,
    its first tick's logits against the one-rank engine's."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.serve import DecodeEngine

    out = {}
    for name, p in job["parts"].items():
        t0 = time.perf_counter()
        cfg, b, s, ss = _decode_spec(p, job["dtype"])
        ctx = _ctx(dev, world, PLACED_MESH, "tp_fsdp", decode_rules(p["layout"]))
        reset_peak(dev)
        params = transformer.init(torch.Generator(device=dev).manual_seed(p["seed"]), cfg, ctx)
        if name == "engine":
            eng = DecodeEngine(params, cfg, ctx=ctx, batch_slots=p["slots"], max_seq=p["max_seq"])
            del params
            cache_gb = sum(t.numel() * t.element_size() for t in eng.cache.values()) / 1e9
            kernels.reset_launches()
            dist.barrier()
            first, tokens, ticks, run_s = serve_first_tick(eng, p["prompts"], p["max_new"])
            del eng
            want = torch.load(p["want"])["first"].to(dev)
            diff = (first - want).abs()
            out[name] = {"tokens": tokens, "ticks": ticks, "run_s": run_s,
                         "steps": sum(len(pr) for pr in p["prompts"]) + ticks,
                         "launches": kernels.launches()["decode_attention"],
                         "first_max_abs_err": float(diff.max()),
                         "first_bad": int((diff > SERVE_ATOL + SERVE_RTOL * want.abs()).sum()),
                         "cache_gb": cache_gb, "peak_gb": peak_gb(dev),
                         "part_s": time.perf_counter() - t0}
            del first, want, diff
            free_device(dev)
            continue
        plan = transformer.cache_placement(cfg, ctx, b, s, ss)
        cache = transformer.init_cache(cfg, b, s, device=dev, ctx=ctx, seq_shard=ss)
        origin = _block_origin(ctx, plan, tuple(cache["k"].shape))
        fill_cache(cache, b, *origin, job["draw"], p["seed"])
        want = torch.load(p["want"])
        tokens = want["tokens"].to(dev)
        kernels.reset_launches()
        ms, logits = [], []
        for i in range(p["steps"]):
            t, (lg, cache) = _events_ms(dev, lambda i=i: transformer.decode_step(
                params, cache, tokens[i], p["pos0"] + i, cfg, ctx, seq_shard=ss, max_seq=s))
            ms.append(t)
            logits.append(lg)
        launches = kernels.launches()["decode_attention"]
        logits = torch.stack(logits)
        wl = want["logits"].to(dev)
        diff = (logits - wl).abs()
        bad = int((diff > SERVE_ATOL + SERVE_RTOL * wl.abs()).sum()) + int(
            (~torch.isfinite(logits)).sum())
        logits_err = float(diff.max())
        cache_check = _decode_cache_errors(cache, want["rows"], dict(p, seq=s), b, origin,
                                           p["seed"], job["draw"])
        del wl, diff, want
        # one layer's FSDP gathers and the combine of one layer
        dt = L.dtype_of(cfg.dtype)
        lplan = transformer._layer_plan(transformer.placement(cfg, ctx))
        lp = {k: ({e: w[0] for e, w in v.items()} if k == "moe" else v[0])
              for k, v in params["layers"].items()}
        gather_ms, (gathered, _, _) = _events_ms(dev, lambda: transformer._layer_weights(
            lp, dt, ctx, lplan))
        gathered_bytes = sum(t.numel() * t.element_size() for k, t in gathered.items()
                             if k != "moe" and k.startswith("w"))
        del gathered
        seq = plan.axes(2) if plan is not None else ()
        combine_ms = None
        if seq:
            gen = torch.Generator(device=dev).manual_seed(rank)
            o = torch.randn((cache["k"].shape[1], cfg.n_heads, cfg.head_dim), generator=gen,
                            device=dev)
            lse = torch.randn(o.shape[:2], generator=gen, device=dev)
            combine_ms = _events_ms(dev, lambda: L.combine_softmax_shards(o, lse, seq, ctx, dt),
                                    reps=3)[0]
            del o, lse
        out[name] = {"ms": ms, "launches": launches, "logits_digest": digest([logits]),
                     "logits_max_abs_err": logits_err,
                     "logits_bad": bad, "cache": cache_check,
                     "block": list(cache["k"].shape), "origin": list(origin),
                     "cache_gb": sum(t.numel() * t.element_size() for t in cache.values()) / 1e9,
                     "peak_gb": peak_gb(dev), "fsdp_gather_ms": gather_ms,
                     "fsdp_gathered_bytes": gathered_bytes, "combine_ms": combine_ms,
                     "part_s": time.perf_counter() - t0}
        del params, cache, logits, lp
        free_device(dev)
    return out


def decode_job(reduced: bool, dtype, *, draw: int, batch: int, moe_seq: int) -> dict:
    """Phase 10f's parts on qwen2-0.5b (moonshot-v1-16b-a3b for 10f-iii),
    3 steps each at the cache's last positions: 10f-i ``decode_32k`` with
    ``seqm`` on model, its batch cut to ``batch`` (128 at full scale: the
    parent's whole cache and the ranks' would take turns on one card);
    10f-ii ``long_500k`` at its full length with ``sp`` on the whole mesh;
    10f-iii the MoE at 10e-ii's depth (2 layers) from its seed-0
    parameters, 8 slots of ``moe_seq`` positions, the cache on ``dp``
    alone (the kernel on each rank's heads, a slice of the cache's);
    10f-iv the engine, 8 slots x 512 positions, 8 requests of 8 new
    tokens from one-token prompts, under the serving layout (``tp`` and
    ``dp``, ``seqm`` on model, the weights held: ``decode_rules``).
    ``draw`` positions a seeded draw."""
    qwen = {"arch": "qwen2-0.5b", "reduced": reduced, "steps": 3}
    return {"dtype": dtype, "draw": draw, "cells": {
        "i": dict(qwen, cell="decode_32k", batch=batch, layout="seq", seed=11),
        "ii": dict(qwen, cell="long_500k", layout="seq", seed=12),
        "iii": {"arch": "moonshot-v1-16b-a3b", "reduced": reduced, "steps": 3,
                "cell": "decode_32k", "batch": 8, "seq": moe_seq, "layout": "tp_fsdp",
                "layers": None if reduced else 2, "seed": 0}},
        "engine": dict(qwen, cell="decode_32k", layout="serve", seed=11, slots=8,
                       max_seq=128 if reduced else 512, requests=8, max_new=8, prompt=1)}


def finish_decode(dev, prep: dict, ranks: list) -> dict:
    """Phase 10f's gates (each part: every rank's logits equal, within
    ``SERVE_ATOL``/``SERVE_RTOL`` of the one-rank steps', each cache block
    against the one-rank cache's as :func:`_decode_cache_errors` holds it,
    the stale control beyond :data:`CACHE_ULPS`, ``layers`` kernel
    launches a step on every rank; the engine: every rank's tokens equal,
    its first tick's logits within the serve tolerance of the one-rank
    engine's, ``layers`` launches a step) and its figures."""
    out = {}
    labels = {"i": "10f-i", "ii": "10f-ii", "iii": "10f-iii", "engine": "10f-iv"}
    for name, p in prep.items():
        label, rs = labels[name], [r[name] for r in ranks]
        if name == "engine":
            if any(r["tokens"] != rs[0]["tokens"] for r in rs):
                fail(f"phase {label}: the ranks' engines served different tokens")
            if any(r["first_bad"] for r in rs):
                fail(f"phase {label}: the first tick's logits are off the one-rank engine's by "
                     f"{[r['first_max_abs_err'] for r in rs]}")
            if dev.type == "cuda" and any(r["launches"] != p["layers"] * r["steps"] for r in rs):
                fail(f"phase {label}: decode_attention launched {[r['launches'] for r in rs]} "
                     f"times, expected {p['layers']} x {rs[0]['steps']} steps on each rank")
            o = dict(p, ranks_ticks=rs[0]["ticks"], ranks_run_s=max(r["run_s"] for r in rs),
                     first_max_abs_err=max(r["first_max_abs_err"] for r in rs),
                     launches=[r["launches"] for r in rs], cache_gb=rs[0]["cache_gb"],
                     peak_gb=[r["peak_gb"] for r in rs], part_s=max(r["part_s"] for r in rs))
            out[name] = o
            log(f"[ranks] {label} DecodeEngine(ctx=...) {p['arch']} at its widths on the 4 ranks "
                f"(tp on model and dp on data, the weights held, no fsdp; seqm on model: a "
                f"batch half and a sequence half of the cache a rank), "
                f"{p['slots']} slots x {p['max_seq']} positions, {p['requests']} requests: every "
                f"rank served the same tokens; first tick's logits max |err| "
                f"{o['first_max_abs_err']:.4g} against the one-rank engine's first tick "
                f"({p['first_tick_s']:.2f} s there); {o['ranks_ticks']} ticks, {rs[0]['steps']} "
                f"steps in {o['ranks_run_s']:.1f} s on the ranks; launches {o['launches']}; "
                f"cache {o['cache_gb']:.4f} GB, peak {o['peak_gb']} GB a rank; the part "
                f"{o['part_s']:.1f} s")
            continue
        if any(r["logits_digest"] != rs[0]["logits_digest"] for r in rs):
            fail(f"phase {label}: the ranks returned different logits")
        if any(r["logits_bad"] for r in rs):
            fail(f"phase {label}: logits off the one-rank steps' by "
                 f"{[r['logits_max_abs_err'] for r in rs]} (atol {SERVE_ATOL}, rtol {SERVE_RTOL})")
        if any(r["cache"][k] for r in rs for k in ("unwritten_bad", "first_bad", "later_bad")):
            fail(f"phase {label}: cache blocks off the one-rank cache (later layers' bound "
                 f"{CACHE_ULPS} ulps): {[r['cache'] for r in rs]}")
        stale = [r["cache"]["stale_min_ulps"] for r in rs
                 if r["cache"]["stale_min_ulps"] is not None]
        if p["layers"] > 1 and (not stale or min(stale) <= CACHE_ULPS):
            fail(f"phase {label}: the cache gate cannot see a stale row: {stale} ulps against "
                 f"the bound {CACHE_ULPS}")
        want_launches = p["layers"] * p["steps"]
        if dev.type == "cuda" and any(r["launches"] != want_launches for r in rs):
            fail(f"phase {label}: decode_attention launched {[r['launches'] for r in rs]} times, "
                 f"expected {p['layers']} x {p['steps']} on each rank")
        ms = [max(r["ms"][i] for r in rs) for i in range(p["steps"])]
        combine = [r["combine_ms"] for r in rs if r["combine_ms"] is not None]
        o = dict(p, step_ms=ms, logits_max_abs_err=max(r["logits_max_abs_err"] for r in rs),
                 cache_first_err=max(r["cache"]["first_err"] for r in rs),
                 cache_later_ulps=max(r["cache"]["later_ulps"] for r in rs),
                 cache_stale_min_ulps=min(stale) if stale else None,
                 launches=[r["launches"] for r in rs], block=rs[0]["block"],
                 cache_gb=[r["cache_gb"] for r in rs], peak_gb=[r["peak_gb"] for r in rs],
                 fsdp_gather_ms=max(r["fsdp_gather_ms"] for r in rs),
                 fsdp_gathered_bytes=rs[0]["fsdp_gathered_bytes"],
                 combine_ms=max(combine) if combine else None,
                 part_s=max(r["part_s"] for r in rs))
        out[name] = o
        layout = "sp on the whole mesh" if p["seq_shard"] else (
            "seqm on model" if p["layout"] != "tp_fsdp" else "the batch on data alone")
        log(f"[ranks] {label} {p['arch']} decode at its widths, {p['layers']} layers, "
            f"{p['batch']} x {p['seq']} positions ({layout}), "
            f"a rank's block {o['block']}: {p['steps']} steps at pos {p['pos0']}.. == the one-rank "
            f"steps (logits max |err| {o['logits_max_abs_err']:.4g}; the rows written max |err| "
            f"{o['cache_first_err']:.3g} in the first layer, {o['cache_later_ulps']:.4g} ulps of "
            f"their head vectors' RMS in the later ones (bound {CACHE_ULPS}; a stale row "
            f"{o['cache_stale_min_ulps']} ulps at the least); the rest bit-equal); "
            f"ms a step {ms} (CUDA events between barriers); one layer's "
            f"FSDP gathers {o['fsdp_gather_ms']} ms ({o['fsdp_gathered_bytes'] / 1e6:.1f} MB); "
            f"the combine {o['combine_ms']} ms a layer; the kernel on rank 0's block "
            f"{p['kernel_block']} {p['block_kernel_ms']} ms against {p['one_card_kernel_ms']} ms "
            f"on the whole cache (one card, in the parent; split {p['one_card_split']}); cache {o['cache_gb']} GB a rank "
            f"({p['whole_cache_gb']:.2f} GB whole); peak {o['peak_gb']} GB a rank; launches "
            f"{o['launches']}; the part {o['part_s']:.1f} s on the ranks")
    return out


def prepare_dp_recsys(dev, arch, *, reduced: bool, world: int, sasrec: Path) -> tuple:
    """Phase 10b's one-rank half: ``arch``'s ``train_batch`` at published
    widths, one step on this process from the seed-0 state and batch
    (rows rounded to ``world`` shards as the ranks' are).  Returns it and
    the ranks' job."""
    from repro_torch import configs
    from repro_torch.dist.sharding import AbstractMesh, ShardingCtx
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.train import TrainConfig, init_train_state

    spec = configs.get(arch, reduced=reduced)
    cell = next(c for c in spec.shapes if c.kind == "train")
    tcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=3)
    shaped = ShardingCtx(mesh=AbstractMesh((1, world), ("data", "model")), profile="flat_dp")
    bundle = steps.build_step(spec, cell, tcfg=tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                             lambda g: recsys.init(g, spec.config, shaped), tcfg)
    batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=dev)
    (want_s, want_m), _, one_ms = timed_call(dev, lambda: bundle.fn(state, batch))
    want = _cpu_result(want_s, want_m)
    del state, want_s, batch, bundle
    free_device(dev)
    prep = {"arch": arch, "world": world, "want": want, "one_ms": one_ms, "lr": tcfg.lr,
            "cell": cell}
    return prep, {"arch": arch, "reduced": reduced, "sasrec": str(sasrec)}


def finish_dp_recsys(dev, prep: dict, work: Path, ranks: list, ranks_s: float) -> dict:
    """Phase 10b: the ranks' step in each lookup mode against the one-rank
    step (each rank's table shards and every replicated leaf within 9's
    tolerances), and SASRec's 9c state saved over (1, world) and restored
    over (world, 1), bit-equal."""
    from repro_torch import tree

    arch, world, want, one_ms, cell = (prep[k] for k in ("arch", "world", "want", "one_ms",
                                                          "cell"))
    out = {"arch": arch, "world": world, "one_rank_ms": one_ms, "ranks": ranks, "checks": {},
           "ranks_s": ranks_s}
    for mode in ("a2a", "allreduce"):
        parts = [torch.load(work / f"got_{mode}_{r}.pt") for r in range(world)]

        def whole(key):
            paths = tree.flatten_with_paths(parts[0][key])[0]
            return tree.unflatten(parts[0][key], [
                torch.cat([tree.leaves(p[key])[i] for p in parts])
                if path.endswith(("['embed']", "['wide']")) else tree.leaves(parts[0][key])[i]
                for i, path in enumerate(paths)])

        for r in range(1, world):  # the replicated leaves: the same on every rank
            for key in ("params",):
                for path, a, b in zip(*tree.flatten_with_paths(parts[r][key]),
                                      tree.leaves(parts[0][key])):
                    if not path.endswith(("['embed']", "['wide']")) and not torch.equal(a, b):
                        fail(f"phase 10b: {mode} rank {r}'s {path} differs from rank 0's")
        got = {"params": whole("params"), "opt": whole("opt")}
        out["checks"][mode] = compare_step(f"{arch} {mode} over {world} ranks", got,
                                           parts[0]["metrics"], want, want["metrics"],
                                           prep["lr"], f"over {world} ranks", "on one")
    if not all(r["restore"]["same"] and r["restore"].get("blocks_same", True) for r in ranks):
        fail(f"phase 10b: SASRec's state restored over ({world}, 1) != saved over (1, {world})")
    rs = ranks[0]["restore"]
    log(f"[ranks] 10b {arch}/{cell.name} at its widths over {world} gloo ranks (flat_dp, a row "
        f"shard and a quarter of the {cell.dims['batch']} rows a rank, cap_factor 4.0): tables "
        f"and replicated leaves == one rank in a2a (first moment at "
        f"{out['checks']['a2a']['grad_tol_used']:.3g} of its tolerance) and allreduce "
        f"({out['checks']['allreduce']['grad_tol_used']:.3g}); ms a step "
        + ", ".join(f"{m} {max(r['modes'][m]['ms'] for r in ranks):.2f}" for m in ("a2a", "allreduce"))
        + f" (one rank {one_ms}); SASRec's 9c state saved over (1, {world}) and restored over "
        f"({world}, 1): {rs['leaves']} leaves ({rs['sharded']} row-sharded), full_tensor() on "
        f"the host and every block on the {dev.type} bit-equal, restore {rs['restore_s']:.2f} s")
    return out


def prepare_edge_gnn(dev, *, reduced: bool, cell_name: str) -> tuple:
    """Phase 10c's one-rank half: DimeNet's ``cell_name`` at published
    widths, one step from the seed-0 state on the seed-0 batch and its
    FLOPs (a call of its own, as 10a's).  Returns the one-rank result and
    the ranks' job (the edges over 2 ranks)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.train import TrainConfig, init_train_state

    spec = configs.get("dimenet", reduced=reduced)
    cell = next(c for c in spec.shapes if c.name == cell_name)
    tcfg = TrainConfig(lr=GNN_LR, warmup=1, total_steps=3)
    bundle = steps.build_step(spec, cell, tcfg=tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), bundle.init_fn, tcfg)
    batch = steps.make_inputs(spec, cell, np.random.default_rng(0), device=dev)
    n_edges, t_max = batch["tri_kj"].shape
    n_nodes = batch["pos"].shape[0]
    want_s, want_m = bundle.fn(state, batch)
    want_digest = digest({"params": want_s["params"], "m": want_s["opt"]["m"]})
    want = _cpu_result(want_s, want_m)
    del want_s
    with FlopCounterMode(display=False) as fc:  # a call of its own, as 10a's
        bundle.fn(state, batch)
    prep = {"cell": cell_name, "reduced": reduced, "nodes": n_nodes, "edges": n_edges,
            "t_max": t_max, "want": want, "digest": want_digest,
            "flops": float(fc.get_total_flops()),
            "model_flops": dimenet_step_flops(bundle.cfg, n_nodes, n_edges, t_max)}
    return prep, {"reduced": reduced, "cell": cell_name, "digest": want_digest}


def finish_edge_gnn(dev, prep: dict, work: Path, ranks: list) -> dict:
    """Phase 10c's gate (9e's tolerances) and its figures: ms a step, one
    message all-gather's ms, peak GB a rank."""
    name, n_edges = prep["cell"], prep["edges"]
    check = _same_step(f"dimenet {name} over 2 edge ranks", ranks, prep["digest"],
                       work / "got_gnn.pt", prep["want"], GNN_LR, loss_rtol=GNN_LOSS_RTOL,
                       norm_rtol=GNN_GRAD_RTOL, grad_rtol=GNN_GRAD_RTOL, off_share=GNN_OFF_SHARE)
    ms = max(r["ms"] for r in ranks)
    out = {"cell": name, "nodes": prep["nodes"], "edges": n_edges, "t_max": prep["t_max"],
           "check": check, "ranks": ranks, "ms": ms, "edges_per_s": n_edges / (ms / 1e3),
           "allgather_ms": max(r["allgather_ms"] for r in ranks),
           "peak_gb": [r["peak_gb"] for r in ranks], "one_rank_flops": prep["flops"],
           "model_flops": prep["model_flops"]}
    log(f"[ranks] 10c dimenet/{name} {'reduced' if prep['reduced'] else 'at its widths'} "
        f"({prep['nodes']:,} nodes, {n_edges:,} edges, {n_edges // 2:,} a rank) over 2 gloo ranks: "
        f"states bit-equal across ranks; == one rank ({'bit for bit' if check['bit_equal'] else 'within tolerance'}; "
        f"loss rel err {check['loss_rel_err']:.3g}, grad_norm {check['grad_norm_rel_err']:.3g}, "
        f"first moment at {check['grad_tol_used']:.3g} of its tolerance); {ms:.2f} ms a step (the gated step), "
        f"{out['edges_per_s']:.4g} edges/s, one bf16 message all-gather "
        f"{out['allgather_ms']:.2f} ms, peak {out['peak_gb']} GB a rank")
    return out


DRY_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
from dataclasses import replace
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.train import TrainConfig
job = json.loads(sys.argv[2])
out = {}
for name, c in job.items():
    spec = configs.get(c["arch"], reduced=c["reduced"])
    cell = next(x for x in spec.shapes if x.name == c["cell"])
    if "dims" in c:
        cell = replace(cell, dims=dict(cell.dims, **c["dims"]))
    if c.get("dtype"):
        spec = replace(spec, config=replace(spec.config, dtype=c["dtype"]))
    tcfg = TrainConfig(microbatches=c["microbatches"]) if c["arch"] != "dimenet" else None
    out[name] = dryrun.run_cell(spec, cell, tuple(c["mesh"]), tcfg=tcfg, verbose=False,
                                rules=c.get("rules"))
print(json.dumps(out))
"""


def start_dryruns(lm: dict, gnn: dict) -> object:
    """Phase 10d's dry runs, started in a CPU subprocess when the run
    starts, so they finish beside the host builds of phases 4-5 and not
    beside phase 10's gloo ranks (which they slowed 2.6-fold on a busy
    host): the 9a cell (its batch, 2 microbatches, one rank), 10a's (2
    ranks, one microbatch), 9e's ``minibatch_lg`` (one rank).  Its output
    goes to files under ``build/`` (a pipe nobody reads could fill); the
    process is killed at exit if it still runs."""
    import atexit
    import subprocess

    job = {"9a": {"arch": "qwen2-0.5b", "reduced": lm["reduced"], "cell": "train_4k",
                  "dims": {"global_batch": lm["batch"]}, "microbatches": 2, "mesh": [1, 1],
                  "dtype": lm.get("dtype")},
           "10a": {"arch": "qwen2-0.5b", "reduced": lm["reduced"], "cell": "train_4k",
                   "dims": {"global_batch": lm["batch"]}, "microbatches": 1, "mesh": [2, 1],
                   "dtype": lm.get("dtype"), "rules": DP_ONLY},
           "9e": {"arch": "dimenet", "reduced": gnn["reduced"], "cell": gnn["cell"],
                  "mesh": [1, 1]}}
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out_dir = ROOT / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "dryrun.out", "w") as out, open(out_dir / "dryrun.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", DRY_SCRIPT, str(ROOT), json.dumps(job)],
                                stdout=out, stderr=err, text=True, env=env)
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc


def phase_dryrun_check(proc, lm_out: dict, gnn_out: dict, dp_out: dict, measured: dict) -> dict:
    """Phase 10d: the dry runs against the card.  FLOPs: the 9a cell's ==
    the counter's count of the one-rank step run on the card (10a) within
    ``DRY_FLOP_RTOL`` (beside 9a's 6·N·tokens); 9e's ``minibatch_lg`` ==
    its step on the card (10c) and within ``DRY_MODEL_RTOL`` of
    :func:`dimenet_step_flops`.  Memory: each predicted peak beside the
    measured ``max_memory_allocated`` (9a, 9e, 10a) as a ratio."""
    from repro_torch import configs

    proc.wait(timeout=900)
    out_s = (ROOT / "build" / "dryrun.out").read_text()
    if proc.returncode != 0:
        err_s = (ROOT / "build" / "dryrun.err").read_text()
        fail(f"phase 10d: the dry runs failed:\n{err_s[-3000:]}")
    dry = json.loads(out_s.strip().splitlines()[-1])
    cfg = configs.get("qwen2-0.5b", reduced=lm_out["reduced"]).config
    checks = {
        "9a_vs_card": (dry["9a"]["flops"], dp_out["one_rank_flops"], DRY_FLOP_RTOL),
        "9e_vs_card": (dry["9e"]["flops"], gnn_out["one_rank_flops"], DRY_FLOP_RTOL),
        "9e_vs_model": (dry["9e"]["flops"], gnn_out["model_flops"], DRY_MODEL_RTOL),
    }
    for name, (got, want, rtol) in checks.items():
        if not abs(got - want) <= rtol * want:
            fail(f"phase 10d: dry-run FLOPs {name}: {got:.6g} against {want:.6g} (rtol {rtol})")
    six_nt = 6 * cfg.params_count * lm_out["batch"] * lm_out["seq"]
    out = {"entries": dry, "flops": {k: {"dry": g, "want": w, "rel": g / w - 1}
                                      for k, (g, w, _) in checks.items()},
           "six_n_t": six_nt, "memory": {}}
    for name, gb in measured.items():
        pred = dry[name]["memory"]["peak_bytes"] / 1e9
        out["memory"][name] = {"predicted_gb": pred, "measured_gb": gb,
                               "ratio": None if gb is None else pred / gb}
    log(f"[ranks] 10d dry runs (fake tensors, H100 roofline): 9a {dry['9a']['flops']:.6g} FLOPs "
        f"== the card's count {dp_out['one_rank_flops']:.6g}, {dry['9a']['flops'] / six_nt:.4f} x "
        f"6·N·tokens; 9e {dry['9e']['flops']:.6g} == the card's "
        f"{gnn_out['one_rank_flops']:.6g}, {out['flops']['9e_vs_model']['rel']:+.4f} against "
        f"dimenet_step_flops; 10a collectives {dry['10a']['collectives']['total'] / 1e9:.4f} GB a "
        f"rank; peaks predicted / measured: " + ", ".join(
            f"{k} {v['predicted_gb']:.2f} / {v['measured_gb']} GB" for k, v in out["memory"].items()))
    return out


def phase_ranks(dev, dry, *, lm: dict, recsys: dict, gnn: dict, placed: dict, decode: dict,
                measured: dict) -> dict:
    """Phase 10: training over ranks and the launch layer (10a the LM's
    data-parallel step, 10b the recsys exchanges under autograd and the
    elastic restore, 10c the edge-sharded DimeNet, 10d the dry run against
    the card, 10e the LM family placed over fsdp, tp and ep, 10f decode
    under the mesh).  Only 10f runs a kernel of the port: its one-rank
    halves here (counted below) and its ranks (counted on each rank)."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.reset_launches()
    try:
        lm_prep, lm_job = prepare_dp_lm(dev, "qwen2-0.5b", reduced=lm["reduced"],
                                        batch=lm["batch"], steps_n=lm["steps_n"],
                                        dtype=lm.get("dtype"))
        free_device(dev)
        gnn_prep, gnn_job = prepare_edge_gnn(dev, reduced=gnn["reduced"], cell_name=gnn["cell"])
        free_device(dev)
        t1 = time.perf_counter()
        work, ranks = spawn_ranks("two", 2, {"kind": "two", "device": dev.type, "lm": lm_job,
                                             "gnn": gnn_job}, 600)
        log(f"[ranks] 10a + 10c: 2 gloo ranks in {time.perf_counter() - t1:.1f} s")
        out = {"dp_lm": finish_dp_lm(dev, lm_prep, work, [r["lm"] for r in ranks]),
               "edge_gnn": finish_edge_gnn(dev, gnn_prep, work, [r["gnn"] for r in ranks])}
        placed_lm, placed_lm_job = placed_job_lm(lm_prep, lm_job)
        del lm_prep, gnn_prep
        free_device(dev)
        # 10b and 10e (the LM family placed over (data 2, model 2)) share one
        # spawn of 4 ranks; their one-rank halves run first
        recsys_prep, recsys_job = prepare_dp_recsys(dev, "wide-deep", reduced=recsys["reduced"],
                                                    world=4, sasrec=SASREC_STATE)
        placed_moe, placed_moe_job = prepare_placed_moe(dev, reduced=placed["reduced"],
                                                        layers=placed["moe_layers"],
                                                        batch=placed["moe_batch"],
                                                        dtype=lm.get("dtype"))
        free_device(dev)
        t1 = time.perf_counter()
        decode_prep, decode_job = prepare_decode(dev, decode)
        free_device(dev)  # the ranks share the card: the parent holds nothing there
        log(f"[ranks] 10f one-rank halves in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        work, ranks = spawn_ranks("four", 4, {
            "kind": "four", "device": dev.type, "recsys": recsys_job,
            "placed": {"lm": placed_lm_job, "moe": placed_moe_job}, "decode": decode_job}, 900)
        ranks_s = time.perf_counter() - t1
        log(f"[ranks] 10b + 10e + 10f: 4 gloo ranks in {ranks_s:.1f} s")
        out["dp_recsys"] = finish_dp_recsys(dev, recsys_prep, work,
                                            [r["recsys"] for r in ranks], ranks_s)
        out["placed"] = finish_placed(dev, {"lm": placed_lm, "moe": placed_moe},
                                      [r["placed"] for r in ranks])
        out["decode"] = finish_decode(dev, decode_prep, [r["decode"] for r in ranks])
        free_device(dev)
        measured = dict(measured, **{"10a": max(out["dp_lm"]["peak_gb"], key=lambda x: x or 0)})
        lm_out = dict(lm, seq=out["dp_lm"]["seq"])
        out["dryrun"] = phase_dryrun_check(dry, lm_out, out["edge_gnn"], out["dp_lm"], measured)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    out["launches"] = {k: v for k, v in kernels.launches().items() if v}
    out["seconds"] = time.perf_counter() - t0
    log(f"[ranks] phase 10 done in {out['seconds']:.1f} s; kernel launches {out['launches']}")
    return out

def time_attention(dev, label, q, k, v, kv_len) -> dict:
    from repro_torch.kernels import decode_attention as att
    from repro_torch.kernels.decode_attention import _decode_body, decode_attention

    got = decode_attention(q, k, v, kv_len)
    want = _decode_body(q, k, v, kv_len)
    b, s, hkv, d = k.shape
    sm = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    tile, n_split = att.split_plan(b, hkv, d, s, q.element_size(), sm)
    mma = q.dtype == torch.bfloat16 and d in att.MMA_DIMS
    row = {"case": label, "shape": list(k.shape), "heads": q.shape[1], "dtype": str(q.dtype),
           "max_abs_err": max_err(got, want, *ATT_TOL[q.dtype], label),
           "plan": {"kernel": mma and "tensor cores" or "CUDA cores", "tile": tile,
                    "n_split": n_split, "stages": att.STAGES,
                    "threads": att.MMA_THREADS if mma else att.THREADS,
                    "blocks": b * hkv * n_split, "sms": sm}}
    del got, want
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(k.shape[1], device=dev)[None, :] < kv_len.long()[:, None])[:, None, None, :]
    row.update(
        ms=device_ms(lambda: decode_attention(q, k, v, kv_len), dev),
        plain_ms=device_ms(lambda: _decode_body(q, k, v, kv_len), dev, reps=5, warmup=1),
        library_ms=device_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True), dev,
                             reps=5, warmup=1),
    )
    row.update(attention_bound(q, k, kv_len))
    if dev.type == "cuda":
        # the split's effect: the same call at other shares per (row, KV head)
        row["n_split_ms"] = {}
        for n in sorted({1, 2, 4, 8, 16, 32, 64, n_split}):
            with forced_split(n):
                row["n_split_ms"][n] = device_ms(lambda: decode_attention(q, k, v, kv_len), dev)
    log(f"[times] decode_attention {label}: kernel {row['ms']} ms, twin {row['plain_ms']} ms, "
        f"sdpa {row['library_ms']} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{row['bound_bytes'] / 1e9:.3f} GB); max |err| {row['max_abs_err']:.3g}; "
        f"plan {json.dumps(row['plan'])}; ms by n_split {json.dumps(row.get('n_split_ms'))}")
    return row


def combine_blocks(outs, lses):
    """One row's attention from its sequence blocks' ``(out, lse)``: the
    single-process form of ``layers.combine_softmax_shards``, in f32."""
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(dim=0))[..., None]
    return (w * torch.stack(outs)).sum(dim=0) / w.sum(dim=0)


def time_attention_lse(dev, label, q, k, v, kv_len) -> dict:
    """Row 10c: ``decode_attention(..., return_lse=True)`` at a shape,
    row 0 given ``kv_len = 0``.  Gates: ``(out, lse)`` within
    ``ATT_TOL[f32]`` of the twin's, on the whole cache and on each of 2
    and 4 sequence blocks (some past a row's ``kv_len``); the f32 output
    rounded == the default path's output, bit for bit; each split's blocks
    combined on the card within ``ATT_TOL`` of the dtype of the one call.
    Times: the kernel with and without the lse, the twin, SDPA (the
    output alone) and the bound (out and lse written in f32)."""
    from repro_torch.kernels.decode_attention import _decode_body, decode_attention

    kv_len = kv_len.clone()
    kv_len[0] = 0
    f32 = ATT_TOL[torch.float32]
    got, lse = decode_attention(q, k, v, kv_len, return_lse=True)
    want, want_lse = _decode_body(q, k, v, kv_len, return_lse=True)
    err = max(max_err(got, want, *f32, f"{label} out (lse path)"),
              max_err(lse, want_lse, *f32, f"{label} lse"))
    one = decode_attention(q, k, v, kv_len)
    if not torch.equal(got.to(q.dtype), one):
        fail(f"{label}: the lse path's output rounded != the default path's output")
    del want, want_lse
    combine_err = {}
    b, s, hkv, d = k.shape
    for n in (2, 4):
        s_loc, outs, lses, past = s // n, [], [], 0
        for i in range(n):
            blk = slice(i * s_loc, (i + 1) * s_loc)
            kb, vb = k[:, blk].contiguous(), v[:, blk].contiguous()
            nb = torch.clamp(kv_len - i * s_loc, 0, s_loc).to(torch.int32)
            past += int((nb == 0).sum())
            o, l_ = decode_attention(q, kb, vb, nb, return_lse=True)
            wo, wl = _decode_body(q, kb, vb, nb, return_lse=True)
            err = max(err, max_err(o, wo, *f32, f"{label} block {i} of {n} out"),
                      max_err(l_, wl, *f32, f"{label} block {i} of {n} lse"))
            outs.append(o)
            lses.append(l_)
            del kb, vb, wo, wl
        if past == 0:
            fail(f"{label}: no block of the {n}-way split lies past a row's kv_len")
        combined = combine_blocks(outs, lses).to(q.dtype)
        combine_err[n] = max_err(combined, one, *ATT_TOL[q.dtype], f"{label} {n} blocks combined")
        del outs, lses, combined
    n_valid = int(torch.clamp(kv_len.long(), 0, s).sum())
    n_bytes = (q.numel() * q.element_size() + q.numel() * 4 + lse.numel() * 4
               + 2 * n_valid * hkv * d * k.element_size())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(s, device=dev)[None, :] < kv_len.long()[:, None])[:, None, None, :]
    row = {"case": label, "shape": list(k.shape), "heads": q.shape[1], "dtype": str(q.dtype),
           "max_abs_err": err, "combine_max_abs_err": combine_err,
           "ms": device_ms(lambda: decode_attention(q, k, v, kv_len, return_lse=True), dev),
           "no_lse_ms": device_ms(lambda: decode_attention(q, k, v, kv_len), dev),
           "plain_ms": device_ms(lambda: _decode_body(q, k, v, kv_len, return_lse=True), dev,
                                 reps=5, warmup=1),
           "library_ms": device_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True),
                                   dev, reps=5, warmup=1)}
    row.update(float_bound(n_bytes, 4 * n_valid * q.shape[1] * d))
    log(f"[times] decode_attention return_lse {label}: kernel {row['ms']} ms with the lse, "
        f"{row['no_lse_ms']} ms without, twin {row['plain_ms']} ms, sdpa (output alone) "
        f"{row['library_ms']} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); (out, lse) "
        f"== twin max |err| {err:.3g} (whole, 2 and 4 blocks); blocks combined == one call, max "
        f"|err| {combine_err}")
    return row


def phase_times(dev, *, att_a, att_b, bag_a, bag_b) -> tuple:
    """Phase 8: kernel times at the serving shapes, and the embedding bag's
    path (``ops.embedding_bag``), counted."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import _bag_body

    att_rows = []
    b, hq, hkv, d, s = att_a
    q, k, v = attention_inputs(dev, b, hq, hkv, d, s, torch.bfloat16, seed=1)
    kv_len = torch.randint(1, s + 1, (b,), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev, dtype=torch.int32)
    att_rows.append(time_attention(dev, f"decode_32k B{b} {hq}/{hkv}x{d} S{s} bf16, kv_len U[1,S]",
                                   q, k, v, kv_len))
    att_rows.append(time_attention_lse(
        dev, f"decode_32k B{b} {hq}/{hkv}x{d} S{s} bf16, kv_len U[1,S] (row 0: 0), return_lse",
        q, k, v, kv_len))
    del q, k, v
    from repro_torch.kernels import cuda_lib

    for src in ("decode_attention.cu", "rmi_search.cu", "pgm_search.cu", "kary_search.cu",
                "rs_search.cu", "embedding_bag.cu"):
        for ln in cuda_lib.ptxas_report().get(src, []):
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln:
                log(f"[times] ptxas {src}: {ln}")
    b, hq, hkv, d, s = att_b
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(dev, b, hq, hkv, d, s, dtype, seed=2)
        kv_len = torch.full((b,), s, dtype=torch.int32, device=dev)
        name = "f32" if dtype == torch.float32 else "bf16"
        att_rows.append(time_attention(dev, f"roofline B{b} {hq}/{hkv}x{d} S{s} {name}, full",
                                       q, k, v, kv_len))
        del q, k, v
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the embedding bag's path: ops.embedding_bag on both cases (counted)
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    # the roofline shape's bags are sorted random ids; the large table's
    # bags hold n_items / bags items each
    for label, (v_, d, n_items, bags), fixed in (("roofline", bag_a, False),
                                                ("large table", bag_b, True)):
        table = torch.randn((v_, d), generator=gen, device=dev)
        ids = torch.randint(0, v_, (n_items,), generator=gen, device=dev, dtype=torch.int32)
        if fixed:
            seg = torch.arange(bags, device=dev, dtype=torch.int32).repeat_interleave(n_items // bags)
        else:
            seg = torch.sort(torch.randint(0, bags, (n_items,), generator=gen, device=dev,
                                           dtype=torch.int32)).values
        w = torch.randn((n_items,), generator=gen, device=dev)
        cases.append((label, table, ids, seg, w, bags))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    outs = [ops.embedding_bag(t, i, sg, w, num_bags=nb) for _, t, i, sg, w, nb in cases]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    bag_launches = kernels.launches()["embedding_bag"]
    if dev.type == "cuda" and bag_launches != len(cases):
        fail(f"embedding_bag launched {bag_launches} times on its path, expected {len(cases)}")
    bag_rows = []
    for (label, table, ids, seg, w, bags), got in zip(cases, outs):
        want = _bag_body(table, ids, seg, w, num_bags=bags)
        offsets = torch.searchsorted(seg.long(), torch.arange(bags, device=dev))
        lib = torch.nn.functional.embedding_bag
        row = {"case": f"{label} V{table.shape[0]} D{table.shape[1]} N{ids.numel()} B{bags}",
               "max_abs_err": max_err(got, want, BAG_TOL, BAG_TOL, f"embedding_bag {label}")}
        lib_out = lib(ids.long(), table, offsets, mode="sum", per_sample_weights=w)
        max_err(lib_out, want, BAG_TOL, BAG_TOL, f"F.embedding_bag {label} (the yardstick's inputs)")

        def kernel(table=table, ids=ids, seg=seg, w=w, bags=bags):
            return ops.embedding_bag(table, ids, seg, w, num_bags=bags)

        def library(table=table, ids=ids, offsets=offsets.to(torch.int32), w=w):
            return lib(ids, table, offsets, mode="sum", per_sample_weights=w)

        row.update(
            ms=device_ms(kernel, dev),
            plain_ms=device_ms(lambda: _bag_body(table, ids, seg, w, num_bags=bags), dev, reps=5,
                               warmup=1),
            library_ms=device_ms(library, dev),
            graph_ms=graph_ms(kernel, dev),
            library_graph_ms=graph_ms(library, dev),
            host_us=host_us(kernel, dev),
            library_host_us=host_us(library, dev),
        )
        row.update(bag_bound(table, ids, bags))
        bag_rows.append(row)
        log(f"[times] embedding_bag {row['case']}: kernel {row['ms']} ms ({row['graph_ms']} ms "
            f"replayed from a CUDA graph, {row['host_us']} us to enqueue), twin {row['plain_ms']} "
            f"ms, F.embedding_bag {row['library_ms']} ms ({row['library_graph_ms']} ms from a "
            f"graph, {row['library_host_us']} us to enqueue), bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bound_bytes'] / 1e6:.1f} MB); "
            f"max |err| {row['max_abs_err']:.3g}")
    del cases, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return att_rows, bag_rows, bag_launches


def serve_kernels_line(parity_errs, serve, moe_served, mesh_launches, att_rows, bag_rows,
                       bag_launches) -> list:
    """The kernels-line entries of the two float kernels: the headline case
    is qwen2's decode_32k cell and the 2 GiB bag; every case is listed.
    ``mesh_launches``: phase 10f's decode_attention launches, summed over
    its ranks."""
    out = []
    att_paths = {"serve": serve["decode_attention_launches"],
                 "moe_serve": moe_served["decode_attention_launches"],
                 "decode_mesh": mesh_launches}
    for name, rows, paths, extra_err in (
        ("decode_attention", att_rows, att_paths,
         max(serve["max_abs_err"], moe_served["max_abs_err"])),
        ("embedding_bag", bag_rows, {"ops": bag_launches}, 0.0),
    ):
        head = rows[0] if name == "decode_attention" else rows[-1]
        spec = SERVE_KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max([parity_errs[name], extra_err] + [r["max_abs_err"] for r in rows]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "path": spec["path"], "headline_case": head["case"],
            "cases": [{k: r.get(k) for k in ("case", "ms", "graph_ms", "host_us", "plain_ms",
                                             "bound_ms", "bound_by", "library_ms",
                                             "library_graph_ms", "library_host_us",
                                             "max_abs_err")} for r in rows],
        })
    return out


def kernels_line(rows, launches, headline_table: str) -> dict:
    out = []
    for name, spec in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        head = next(r for r in mine if r["table"] == headline_table and r["kind"] == spec["headline"])
        out.append({
            "name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "twin_equal": all(r["twin_equal"] for r in mine),
            "headline_case": f"{headline_table}/{spec['headline']}",
            "cases": [{k: r[k] for k in ("table", "kind", "ms", "plain_ms", "bound_ms",
                                         "library_ms", "lookup_ms", "max_abs_err")} for r in mine],
        })
    return {"kernels": out}


def main(argv=None) -> int:
    # before the first cuBLAS handle: phase 10a runs its gated steps with
    # deterministic algorithms, which cuBLAS honours only with this config
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 3-10 on the CPU twins at a tiny size (no device result)")
    ap.add_argument("--out", type=Path, default=None, help="also write every row as JSON here")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    if args.cpu_rehearsal:
        dev, info = torch.device("cpu"), None
        sys.path.insert(0, str(ROOT / "src"))
        parity_n, full_n, full_nq, shard_nq = 4096, 1 << 14, 1 << 12, 1 << 10
        sweep_stride = 1
        mutation_batches, tier_fresh = (1 << 4, 1 << 6, 1 << 8), 1 << 8
        serve = {"reduced": True, "max_seq": 128, "long_prompt": 40}
        hotcache = {"batch": 1 << 10, "batches": 2, "n_insert": 1 << 8}
        pool = {"seqs": 8, "positions": 512, "page": 16}
        moe_serve = {"reduced": True, "max_seq": 64}
        prefill = {"reduced": True, "batch": 2, "seq": 128, "check_tokens": 32}
        recsys = {"reduced": True, "check_rows": 64, "pairs": 64}
        lke = {"n_keys": 1 << 14, "dim": 18, "n_queries": 1 << 12}
        times = {"att_a": (4, 14, 2, 64, 512), "att_b": (2, 32, 8, 128, 256),
                 "bag_a": (4096, 128, 8192, 1024), "bag_b": (1 << 14, 128, 1 << 14, 1 << 10)}
        train = {"lm": {"reduced": True, "batch": 8, "microbatches": 2, "steps_n": 6,
                        "check_tokens": 32},
                 "recsys": {"reduced": True, "steps_n": 3},
                 "data": {"n_docs": 2000, "n_offsets": 1 << 12, "vocab": 256},
                 "gnn": {"reduced": True, "steps_n": 3}}
        ranks_cfg = {"lm": {"reduced": True, "batch": 8, "steps_n": 6, "dtype": "float32"},
                     "recsys": {"reduced": True}, "gnn": {"reduced": True, "cell": "minibatch_lg"},
                     "placed": {"reduced": True, "moe_layers": None, "moe_batch": 4},
                     "decode": decode_job(True, "float32", draw=32, batch=4, moe_seq=64)}
    else:
        info = phase_device()
        dev = torch.device("cuda")
        sys.path.insert(0, str(ROOT / "src"))
        phase_build()
        from repro_torch.data import TIERS

        parity_n, full_n, full_nq, shard_nq = 65536, TIERS["L4"], 1 << 22, 1 << 20
        sweep_stride = 2  # 5f-a sweeps 2^23 of the table's keys (cut for the run's time)
        mutation_batches, tier_fresh = (1 << 10, 1 << 12, 1 << 14, 1 << 16), 1 << 16
        # max_seq: the sequence length of the decode_32k shape cell
        # long_prompt: ~716 positions (45 tiles of 16) for the first ticks
        serve = {"reduced": False, "max_seq": 32768, "long_prompt": 700}
        # phase 5g: serve_slo.py's cache A/B traffic at 2^16 queries a batch
        # (its 1,024 is the CPU smoke shape), 3 batches a phase (8, then 4,
        # before: cut for the run's time limit); 5h: 8 sequences of decode_32k's
        # 32,768 positions; 7b: moonshot at its published widths, a 2,048-
        # position cache (6.4 GB beside 57.8 GB of bf16 weights)
        hotcache = {"batch": 1 << 16, "batches": 3, "n_insert": 1 << 16}
        pool = {"seqs": 8, "positions": 32768, "page": 16}
        moe_serve = {"reduced": False, "max_seq": 2048}
        # 7c: prefill_32k's 32,768 tokens, 1 sequence (cut from 32, and from
        # 2 for phase 10's time), checked against a 256-step decode chain; 7d: the
        # recsys cells at published widths; 7e: DIN's 10,000,000-item
        # vocabulary as raw 64-bit ids, 2^22 ids a batch
        prefill = {"reduced": False, "batch": 1, "seq": 32768, "check_tokens": 256}
        recsys = {"reduced": False, "check_rows": RECSYS_CHECK_ROWS, "pairs": RETRIEVAL_PAIRS}
        lke = {"n_keys": 10_000_000, "dim": 18, "n_queries": 1 << 22}
        # decode_attention: qwen2-0.5b's decode_32k cell (B 128) and
        # benchmarks/kernel_roofline.py's flash-decode shape; embedding_bag:
        # that benchmark's shape and a 2 GiB table (beyond L2), 2^16 bags of 16
        times = {"att_a": (128, 14, 2, 64, 32768), "att_b": (8, 32, 8, 128, 32768),
                 "bag_a": (4096, 128, 8192, 1024), "bag_b": (1 << 22, 128, 1 << 20, 1 << 16)}
        # 9a: qwen2-0.5b's train_4k at its widths, 8 sequences of 4,096 tokens
        # a step (cut from 256) in 2 microbatches, 2 steps (cut from 6, 4, 3
        # for phase 10's time), checked at 2
        # layers and 256 tokens; 9b: the recsys train_batch (65,536 rows) at
        # published widths, 3 steps; 9d: 200,000 documents (~1.4e8 tokens),
        # 2^22 offsets; 9e: DimeNet's graph cells at published widths, 3 steps
        train = {"lm": {"reduced": False, "batch": 8, "microbatches": 2, "steps_n": 2,
                        "check_tokens": 256},
                 "recsys": {"reduced": False, "steps_n": 3},
                 "data": {"n_docs": 200_000, "n_offsets": 1 << 22, "vocab": 151936},
                 "gnn": {"reduced": False, "steps_n": 3}}
        # 10a: 9a's first batch (8 x 4,096 tokens) over 2 ranks, 4 sequences
        # a rank; 10b: wide & deep's train_batch over 4 ranks; 10c:
        # minibatch_lg at published widths over 2 edge ranks; 10d: their dry runs
        # 10e: 10e-i 10a's model and batch placed over (data 2, model 2);
        # 10e-ii moonshot at its widths, its depth cut to 2 of 48 layers (the
        # whole depth with AdamW is 115 GB), 2 x 4,096 tokens; 10f: decode on
        # the same mesh (decode_job: decode_32k's batch cut from 128 to 32)
        ranks_cfg = {"lm": {"reduced": False, "batch": 8, "steps_n": 6},
                     "recsys": {"reduced": False},
                     "gnn": {"reduced": False, "cell": "minibatch_lg"},
                     "placed": {"reduced": False, "moe_layers": 2, "moe_batch": 2},
                     "decode": decode_job(False, None, draw=1024, batch=32, moe_seq=2048)}
    # f32 matrix products in full f32 (no TF32) in the twins and the reference math
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dry = start_dryruns(ranks_cfg["lm"], ranks_cfg["gnn"])  # phase 10d, on the host

    t0 = time.perf_counter()
    phase_parity(dev, parity_n)
    log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows, launches, tables = phase_full(dev, full_n, full_nq, ("amzn64", "osm"))
    log(f"[full] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tier_rows, tier_launches, locality, tier_built = phase_tier(dev, tables, 4, shard_nq)
    log(f"[tier] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # phases 5b-5c at scale on the lead table (osm's repeat of them is cut)
    lead_tables = {"amzn64": tables["amzn64"]}
    sharded_rows, sharded_launches, scale = phase_sharded(dev, lead_tables, tier_built, parity_n)
    # phase 5's fit="host" leaves, which phase 5e's device fits must equal
    host_fits = {key: (bm.index.static, bm.index.to_numpy(), build_s,
                       [m["info"] for m in bm.meta]) for key, (bm, build_s) in tier_built.items()}
    del tier_built
    log(f"[sharded] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    collective_launches, collective_ranks = phase_collective(dev, lead_tables, scale, parity_n)
    del scale
    log(f"[collective] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mutation_rows = phase_mutation(dev, tables, mutation_batches, tier_fresh)
    log(f"[mutation] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fits = phase_device_fits(dev, tables, host_fits, shard_nq, "amzn64")
    del host_fits
    log(f"[fits] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tuner = phase_tuner(dev, tables, full_nq, shard_nq, "amzn64", stride=sweep_stride)
    log(f"[tuner] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hot, hot_cache = phase_hotcache(dev, tables["amzn64"][0], **hotcache)
    log(f"[hotcache] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paged = phase_paged_pool(dev, **pool)
    log(f"[paged] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parity_errs = phase_float_parity(dev, 600)
    log(f"[float] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served = phase_serve(dev, "qwen2-0.5b", slots=8, n_requests=16, max_new=16, ref_ticks=4,
                         **serve)
    free_device(dev)
    log(f"[serve] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # 8 requests, one wave of the 8 slots (cut from 16 for phase 10's time)
    moe_served = phase_moe_serve(dev, "moonshot-v1-16b-a3b", slots=8, n_requests=8, max_new=16,
                                 ref_ticks=4, tier=hot_cache, **moe_serve)
    del hot_cache
    free_device(dev)
    log(f"[moe] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    prefilled = phase_prefill(dev, "qwen2-0.5b", **prefill)
    free_device(dev)
    log(f"[prefill] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scored = phase_recsys(dev, RECSYS_ARCHS, **recsys)
    log(f"[recsys] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    keyed = phase_lke(dev, **lke)
    ranked = phase_embedding_ranks(dev, "wide-deep", reduced=recsys["reduced"])
    log(f"[lke] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    att_rows, bag_rows, bag_launches = phase_times(dev, **times)
    att_rows.append(moe_served["attention_row"])
    log(f"[times] done in {time.perf_counter() - t0:.1f} s")
    free_device(dev)
    trained = phase_train(dev, **train)
    free_device(dev)
    lg = next(c for c in trained["gnn"]["cells"] if c["cell"] == ranks_cfg["gnn"]["cell"])
    ranked_train = phase_ranks(dev, dry, **ranks_cfg, measured={"9a": trained["lm"]["peak_gb"],
                                                           "9e": lg["peak_gb"]})
    by_path = {k: {"tier": tier_launches[k], "sharded": sharded_launches[k],
                   "fits": fits["launches"][k], "tuner": tuner["launches"][k],
                   "hotcache": hot["launches"][k]} for k in BATCHED}
    by_path.update({k: {"single": launches[k], "a2a": collective_launches["a2a"][k],
                        "allgather": collective_launches["allgather"][k],
                        "fits": fits["launches"][k], "tuner": tuner["launches"][k]}
                    for k in SINGLE})
    for k, n in keyed["launches"].items():  # the learned-keyed embedding (phase 7e)
        by_path[k]["lke"] = n
    mesh_launches = sum(sum(part["launches"]) for part in ranked_train["decode"].values())
    launches = {**{k: sum(paths.values()) for k, paths in by_path.items()},
                "decode_attention": (served["decode_attention_launches"]
                                     + moe_served["decode_attention_launches"] + mesh_launches),
                "embedding_bag": bag_launches}
    line = kernels_line(rows + tier_rows, launches, "amzn64")
    for entry in line["kernels"]:
        if entry["name"] in by_path:
            entry["launches_by_path"] = by_path[entry["name"]]
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [
                r["max_abs_err"] for r in sharded_rows if r["kernel"] == entry["name"]] + [
                st["max_abs_err"] for r in collective_ranks for name, st in r["stages"].items()
                if KERNEL_OF[name.split("_", 1)[1]] == entry["name"]] + [
                r["max_abs_err"] for r in keyed["rows"] if r["kernel"] == entry["name"]])
    line["kernels"] += serve_kernels_line(parity_errs, served, moe_served, mesh_launches,
                                          att_rows, bag_rows, bag_launches)
    for name, key in (("corridor_scan", "corridor"), ("corridor_scan_exact", "corridor_exact")):
        corridor = fits[key]
        corridor["launches_by_path"] = {"fits": corridor["launches"],
                                        "tuner": tuner["launches"][name]}
        corridor["launches"] = sum(corridor["launches_by_path"].values())
        corridor["path"] += ("; build_grid(fit=auto) in tune.sweep, TunedTier device refresh "
                             "(phase 5f)")
        line["kernels"].append(corridor)
        launches[name] = corridor["launches"]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": info, "rows": rows, "tier_rows": tier_rows,
                                        "sharded_rows": sharded_rows, "locality": locality,
                                        "collective_ranks": collective_ranks,
                                        "mutation_rows": mutation_rows, "serve": served,
                                        "hotcache": hot, "paged_pool": paged,
                                        "moe_serve": moe_served, "prefill": prefilled,
                                        "recsys": scored, "lke": keyed,
                                        "embedding_ranks": ranked, "train": trained,
                                        "ranks": ranked_train,
                                        "attention_rows": att_rows, "bag_rows": bag_rows,
                                        "fit_rows": fits["rows"], "grid_rows": fits["grid"],
                                        "refresh_rows": fits["refresh"], "tuner": tuner,
                                        **line}, indent=1))
    if dev.type != "cuda":
        log("[rehearsal] CPU rehearsal passed; no device result")
        return 0
    if any(launches[name] == 0 for name in (*KERNELS, *SERVE_KERNELS, "corridor_scan",
                                            "corridor_scan_exact")) or any(
            by_path[name][path] == 0 for name in SINGLE for path in ("a2a", "allgather")) or (
            by_path["batched_rmi_search"]["hotcache"] == 0) or any(
            by_path[name]["lke"] == 0 for name in ("rmi_search", "batched_rmi_search")):
        fail(f"a kernel of a path never launched: {json.dumps(by_path)}")
    if mesh_launches == 0:
        fail("decode_attention never launched on phase 10f's ranks")
    log(f"[device] nvidia-smi: {info['nvidia_smi']}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
