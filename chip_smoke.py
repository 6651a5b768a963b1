#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # all phases, one GPU
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases (each prints its seconds):

1. The card (name, count, ``nvidia-smi`` name and power limit); build every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
   parallel).
2. Each kernel against its plain PyTorch version on the card: l2/ip/cos,
   ragged shapes, ids < 0, all-invalid rows, visited words with bit 31 set
   and a partial last word, batched and unbatched matrices, M = 8 and 16,
   aligned and offset code tables, and the main path's shapes. The
   NN-Descent pass kernel (gather_distance_pool) also at ragged shapes (n
   past one window, n = 1, C = 1, d = 5 / 8 / 17 / 128, ids past n,
   all-INVALID rows), at shapes its plan sends to the direct kernel (d =
   960 at n = 30001 and 1M, n = 5M at d = 8) and, bit for bit against the
   generic gather kernel (1024 rows a launch), wherever d is a multiple
   of 32 and at n=1M, C=240, d=64 on a uniform pool and on a real pool
   drawn by ``nndescent._candidate_pool``. The beam's hop kernel
   (gather_distance_masked) also bit for bit against the generic masked
   kernel wherever d is a multiple of 32, the n=1M hop included, with a
   row of visited ids and ids past n - 1. The sq8 hop kernel
   (gather_sq8_masked) also bit for bit against the generic sq8 kernel, on
   the word path and on the byte path (a table at a d-byte offset, odd d).
   The ADC hop kernel (gather_adc_masked) bit for bit against the generic
   ADC kernel and the plain version (M = 4, 8, 16 and 40, the n=1M hop
   included, padding, visited ids and ids past n - 1);
   pq_adc on both routes, the interleaved kernel and the generic one, bit
   for bit against each other and the plain version (the pq_search chunk
   Q=64 x n=1M, Q past one group of 16, a partial row tile, odd n, a single
   LUT), each case's route checked by its launch count.
   distance_matrix on both routes: ground-truth chunks (the last one
   ragged), the GD batch (x is y and x != y), ragged q / n / d, d = 960, a
   batch on the 128 tile, zero rows, an operand at a 4-byte offset; every
   small-route case also bit for bit against the 32 x 32 tile. Gathers
   (float and sq8): rtol 1e-5, atol 1e-5, masked ids identical. ADC
   (gather_adc_masked, pq_adc): bit-identical, as kernel and plain version
   sum the M entries in the same order. Matrix: rtol 1e-4, atol 1e-4 (x d
   for l2): the kernel sums in another order than the library product, and
   the expanded l2 form's absolute error grows with the squared norms.
   The unmasked gather's pair kernel (what ``gather_distance`` runs) bit
   for bit against the generic kernel and within gather_tol(d) of the
   plain version: R = 1, 10, 32, 64 and 1,824 (the forest rerank's),
   all-INVALID rows, d = 4, 32, 64, 128, 130, 960, l2/ip/cos, query rows
   and base at a 4-byte offset. The paper's hop (1,000 queries
   x R = 20) at d = 4 and d = 128. The pool kernel at the RAND10M4D pass
   (n = 10M, d = 4, C = 240: 2.4e9 pairs, past 2**31; the direct kernel)
   against the plain version on the rows past pair 2**31 and a sample.
3. Smoke world (n=20_000, d=32) through ``repro_torch.launch.serve`` under
   ``--scorer exact``, ``sq8`` and ``pq``, and from ``--entry hierarchy``:
   each recall@10 must reach the JAX reference's CPU figure on the same
   world (``scripts/reference_smoke_recall.py``) less its slack.
4. Full-width world (n=1_000_000, d=64; NN-Descent k=20, 15 rounds, GD, PQ
   M=8 K=256 15 iterations; 8 batches of 64 queries, ef=64, k=10, random
   entries) through the same entry point under ``--scorer pq``; the same
   stream and seeds through the same Searcher under ``exact`` and ``sq8``;
   the PQ baseline ``pq_search`` over the 512 queries (rerank 64). Each path
   runs with the launch counts set to 0 just before it and read just after.
   The exact and sq8 rungs share the pq run's build and ground truth, so
   the exact entry point (``--scorer exact``, which builds with no
   compress stage) is driven at full width only in pieces, and the build
   kernels' counts (gather_distance, distance_matrix) come from the pq run.
   Then every batch again per scorer, kernel path and plain path in
   lock-step from the same graph, entries and scorer state: ids, n_comps
   and n_steps must be identical except rows whose first divergence is a
   float32 near-tie (at most 1% of rows). Each rung once more with its
   generic kernel scoring every hop: ids, dists, n_comps and n_steps
   bit-identical. ``gd_prune`` of the build's k-NN graph
   through the small route and through the 32 x 32 tile: kept ids
   identical. Ground truth through the plain distance matrix
   on the card: ids that differ are near-ties within the matrix tolerance.
   flash_attention against its plain version (dense, chunked over batch
   so its (S, S) scores fit): fp32 and bf16; causal, causal + window,
   non-causal, non-causal + window; GQA ratios 1 to 8; dh 40, 64, 80 and
   128; a ragged tail, S = 127 / 128 / 129 around the bf16 kernel's
   128-row tile, S = 1, a window of 128 (a key-tile edge); TinyLlama's
   layer shape (B=8, S=2048, 32/4, dh=64). Past 128 (the bf16 kernel's
   64-key stages, the fp32 kernel's 16 columns a thread): dh = dhv = 256
   and DeepSeek's dh 192 / dhv 128, fp32 and bf16, causal with and
   without a window, S = 65 / 127 / 129 / 300 around the tiles, ragged head
   dims (200 / 160, 64 / 256, 160 / 200); Gemma3's layer shape (B=8,
   S=2048, 16/8, dh=256) with its local window of 1024 and without.
   fp32: rtol 2e-5, atol 2e-5 (the reference's own kernel tests); bf16:
   rtol 1e-2, atol 1e-5, one bf16 ulp (<= 2^-7 relative) of a cast from
   fp32 values that agree to ~1e-6.
   flash_attention_bwd (the attention backward) against its plain version
   within BWD_TOL: bf16 through the tensor-core route (preprocess, dq and
   dk / dv wgmma kernels, from the forward's saved log-sum-exp), bf16 and
   fp32 through the first backward's FMA pair (the fp32 route and the
   yardstick): the five LMs' layer shapes at one batch row (TinyLlama 32/4
   dh 64, Qwen3 32/4 dh 128, Gemma3 16/8 dh 256 global and local with its
   window of 1024, DeepSeek's MLA 128/128 dh 192 / dhv 128; S = 2048),
   ragged S (1, 17, 1000), G = 1 and 8, windows with and without causal, a
   given scale, ragged head dims (dhv 36: rows not 16-byte multiples),
   strided operands; at each bf16 case the forward's lse
   within 1e-5 of the plain log-sum-exp, its output bit for bit the
   forward's without lse, two backward calls bit for bit; the autograd
   Function on CUDA tensors launches the forward and backward kernels once
   each (fp32 and bf16). Then each layer at its training batch (TinyLlama
   8, the others 2) per recorded launch: the tensor-core route by kernel
   beside its bound (the five products over the visible pairs at the bf16
   tensor-core peak), the route with P and dS rounded to bf16 alone (what
   the hi + lo split costs), the FMA yardstick, its plain version and
   scaled_dot_product_attention's backward.
4b. The hierarchy path at full width: ``serve --entry hierarchy`` on the
   n=1M world (HNSW over the shared NN-Descent graph; its layers, build
   stages, peak memory and seed-phase comps; every kernel of the path
   launched, no yardstick), then on the same Searcher and bottom layer
   the same stream from random (flat-HNSW), hubs, projection and lsh
   entries and the hierarchy under term="stable": recall@1, recall@10,
   comps/query, qps and steps/batch of each. The device-busy share of a
   hierarchy batch and of its descent. The hierarchy rung again with
   ``ops.gather_distance`` on the generic kernel (ids, dists, n_comps,
   n_steps bit-identical) and on the plain versions (rows that differ
   printed, recall@10 within PLAIN_RECALL_SLACK). The gather calls of
   the path's seed phases are recorded for phase 5.
5. Per-kernel times at the main path's shapes, their bounds, the plain
   versions' times, the yardstick kernel where one is kept, and one
   library call where there is one. Times are
   device time from torch.profiler (CUPTI), so a tiny kernel is not billed
   the host's launch gaps; back-to-back wall per call (CUDA events) is
   printed beside it. Every row is timed per recorded launch of its
   kernel's symbol (the profiler has been seen to drop a launch from a
   window), and one call of the hop, of the sq8 hop, of a ground-truth
   chunk and of a GD block is checked to run its symbol once. The hop
   beside the generic masked kernel, the sq8 hop beside the generic sq8
   kernel, the ADC hop beside the generic ADC kernel, and the launch floor (a one-element fill); the pq_search pass (8
   launches of 64 queries) on the interleaved kernel beside the generic
   one, per pass and per launch, both again on a table of equal code rows
   (every generic lookup a broadcast), the same bytes written by ``fill_``,
   and ``embedding_bag`` (mode sum) as its library call, ground truth (62 launches) beside ``cdist**2``, the GD block
   (65,536 x 20 x 20 x 64, x is y) on the small route beside the 32 x 32
   tile and ``cdist**2``. The NN-Descent scoring pass on both pools beside the
   generic gather kernel in the same run, each of its four kernels per
   recorded launch and summed, the bytes its design moves, and
   ``gather_distance``'s pair kernel beside the generic kernel at the
   rerank, a descent step, a layer start and the hubs scan (phase 4b's
   recorded calls). Last, the device-busy
   share of one served batch under the exact and the pq scorer, and one
   full-world NN-Descent round under the profiler. flash_attention (bf16): one call runs
   ``flash_attention_wgmma_kernel`` once (by symbol, under the profiler),
   its SASS holds HGMMA (``cuobjdump``), one layer at the reference's
   prefill_32k shape (B=32, S=32768) is timed beside SDPA, and Gemma3-12B's
   layer (B=8, S=2048, 16/8, dh=256; global, and local with its window of
   1024) per recorded launch beside its plain version and SDPA (the
   window as a boolean mask), and DeepSeek-V3's MLA prefill layer (B=8,
   S=2048, 128/128, dh=192, dhv=128, the ``<192, 128>`` instantiation) held
   to its plain version within FLASH_TOL and timed beside it and SDPA (the
   kernels SDPA picks printed), into the row's ``shapes``.
6. LM serving at full width: TinyLlama-1.1B (22 layers, d=2048, GQA 32/4,
   bf16, random weights from seed 0) through ``repro_torch.models``: (a)
   init on the card; (b) ``prefill`` of 8 x 2048 tokens, whose attention
   launches the flash kernel once a layer; (c) the same prefill with the
   plain attention on two batches: last-position logits within
   LM_LOGIT_RTOL of the largest logit, the same argmax on >= 15 of 16 rows;
   (d) fp32 weights: a 2 x 128 prompt fed token by token through
   ``decode_step`` gives ``forward``'s logits at every position within
   1e-3 relative; (e) the serve entry point ``--arch tinyllama-1.1b
   --batch 8 --tokens 32 --max-len 2048``. One prefill call and 8 decode
   steps (batch 8, caches of 2048) also run under the profiler: device-busy
   share and the device ops that lead.
12. MoE, hybrid and MLA LM serving at full width (after phase 6, before phase 7,
   on an empty card): Qwen3-30B-A3B (48 layers, 128 experts top-8, GShard
   dispatch at capacity_factor 1.25) and Gemma3-12B (48 layers, 5 local
   (window 1024) : 1 global, d_head 256), bf16, random weights from seed 0.
   For each: (a) init on the card, the parameter count within 1% of the
   published size (and equal to the count from the config's fields), peak
   GiB; (b) ``prefill`` of B x 2048 (Qwen3 B=4, Gemma3 B=8), one flash
   launch a layer and no other kernel of the port, finite logits, tokens/s;
   for Qwen3 the assignments dropped past capacity; (c) the same prefill
   with the plain attention on two batches: in lock-step, the kernel beside
   the plain attention on every layer's q, k and v, each within FLASH_TOL
   (the share of outputs a bf16 ulp apart printed per layer kind); the
   same argmax on all rows but one; last-position logits within
   LM_LOGIT_RTOL of the largest, or no further from the plain path's than
   those of the same model on PyTorch's own bf16 attention
   (scaled_dot_product_attention). Over 48 bf16 layers of random weights a
   perturbation of any size grows to ~5% of the largest logit: on an H100
   at 700 W, Gemma3's kernel path sat 5.3% from the plain one (~0.1% of
   each layer's outputs one bf16 ulp apart), the library's 6.5% (13-39%
   apart); TinyLlama's 22 layers (phase 6) stay within LM_LOGIT_RTOL; (d)
   fp32 weights at full width, prefill == decode within 1e-3 relative; (e)
   ``serve --arch <arch> --batch 8 --tokens 32 --max-len 2048``. One
   prefill and 2 decode steps also run under the profiler (busy share, the
   leading ops, and the device time split by record_function labels into
   flash, the SwiGLUs and the MoE's router and dispatch, expert products and
   combine). Cuts: Qwen3's
   prefill batch is 4, not 8 (its 56.9 GiB of weights leave less room than
   TinyLlama's); (d) runs 2 layers of Qwen3 (at capacity_factor E / K =
   16, so C = S and prefill drops nothing, as decode's C = 1 never does; at
   1.25 the reference's own prefill and decode differ) and 6 layers of
   Gemma3 (one 5 : 1 period) with local_window 128 on 2 x 192 tokens, so
   that the decode rings wrap. Third, DeepSeek-V3-671B at its published widths
   (d=7168; MLA: 128 heads, q_lora_rank 1536, kv_lora_rank 512, dn / dr / dv
   = 128 / 64 / 128; 256 experts top-8 of d_ff 2048 and one shared expert;
   dense d_ff 18432; vocab 129,280; bf16, seed 0) with its depth cut to the
   3 dense-FFN layers and 1 MoE layer, plus the MTP head's weights
   (15,797,352,448 parameters; the full config's 671,712,655,360, ~1.25 TiB,
   do not fit one card; both counts checked exactly): (b) prefill 8 x 2048,
   each MLA layer's attention one flash launch at dh = 192, dhv = 128 (4
   launches), the device time split into MLA projections, flash, the
   SwiGLUs (dense and shared expert), router and dispatch, expert products
   and combine; (c) as above; (d) one dense and one MoE layer in fp32
   (14,630,385,664 parameters, 54.5 GiB; capacity_factor E / K = 32) on 2 x
   192 tokens: the absorbed decode against the decompressed prefill; (e)
   ``serve.serve_lm`` on the cut model (batch 8, 32 tokens, caches of 2048)
   and ``serve --arch deepseek-v3-671b --smoke`` through ``serve.main``.

13. LM training (after phase 12, before phase 7): (a) TinyLlama-1.1B at
   its published widths (22 layers, d=2048, 32/4, d_ff 5632, vocab 32000;
   bf16, remat as published, random weights from seed 0) with AdamW at the
   reference's defaults on 8 x 2048 tokens of ``lm_batch_for_step(0, step,
   ...)`` for 20 steps, the launch counts set to 0 just before: ms a step,
   tokens/s, peak GiB, the loss at the first and last step (finite, and it
   must fall), flash forward and backward launches a step (2 x 22 and 22:
   remat runs each block's forward twice), a checkpoint at step 10, and one
   step under the profiler split into forward, recompute, backward (the
   flash backward in it) and optimizer, with its device-busy share; (b) a
   new model and optimizer restored from the step-10 checkpoint and run to
   step 20: every parameter and optimizer tensor bit-identical to (a)'s;
   (c) TinyLlama cut to 2 layers, one step of 2 x 2048 on the kernel route
   and, through ``ops_replaced``, on the plain route (the plain forward and
   backward), bf16 and fp32: per-parameter gradients within LM_GRAD_TOL of
   their max-abs; (d) DeepSeek-V3 at its published widths cut to 1 dense
   and 1 MoE layer plus the MTP head (bf16, remat, Adafactor), 4 steps of 2
   x 2048 (cut to 1 x 2048 if the peak passes 76 GiB): the nll, aux and MTP
   parts finite, peak, ms a step, 3 backward launches a step (two MLA layers
   and the MTP block at dh 192 / dhv 128), and one step under the profiler
   split as (a)'s; (e) the five smoke configs in
   fp32, 3 steps on the card and on the CPU from the same weights and
   batches: losses within 1e-5 relative.

7. The paper's experiment through ``repro_torch.paper`` (the counterpart
   of the reference's ``benchmarks/run.py``), 1,000 queries a world, at the
   datasets' full sizes: the SIFT1M stand-in (n=1M, d=128: tab1's LID,
   fig3, fig4, fig5, fig6), the GIST1M stand-in (n=1M, d=960: tab1, fig5)
   and RAND10M4D (n=10M, d=4: tab1, fig4, fig6). First, before any world
   is built (after the n=10M world's build, chip runs saw the profiler
   lose every window): the forest rerank's pair-kernel call at its
   real R (SIFT1M, RAND10M4D) bit for bit against the generic kernel and
   within gather_tol(d) of the plain version, and each world's shapes per
   recorded launch into the kernels line's rows: the NN-Descent pass
   beside the generic gather kernel, a hop of 1,000 queries, the forest
   rerank, the ground-truth scan, each with its bound. Then each world
   prints its build seconds and peak memory of ground truth, KGraph, GD,
   DPG and HNSW, the index bytes and the reference's ``tab1/``, ``fig*/``
   lines; every kernel of the path launched over the worlds' runs
   (gather_distance_pool, distance_matrix on both routes, the hop, the pair
   kernel, pq_adc; each row's ``paper_launches``); ``dpg_prune`` of
   SIFT1M's KGraph on the card against the CPU over 10,000 vertices
   (near-tie rows at most 1%, counted); a lock-step search over SIFT1M's
   GD graph, kernel path against plain path; the reference's end-to-end
   floor (``tests/test_system.py``: the SIFT1M stand-in at scale 0.004,
   recall@1 >= 0.9 at fewer than n/4 comps).

8. The saved, tiered and filtered index, on phase 4's searcher (it runs
   after phase 5, before phase 6 frees that searcher). Each step's seconds
   come from CUDA events. (a) ``core.io.save_index`` into a temporary
   directory (removed at the end): unsharded, in 65,536-row f32 shards
   and in bf16 shards; each loaded back with every array bit-identical to
   the live searcher's (a bf16 base to its bf16 cast); bytes and seconds.
   (b) ``serve --index <saved> --scorer pq --base-placement disk`` with the
   launch counts set to 0 before it: no pool kernel, no GD block, no PQ
   training, ``distance_matrix`` exactly as often as the stream's ground
   truth, and ids, dists, n_comps, n_steps bit-identical to phase 4's
   device run. (c) pq and sq8 at device, host and disk (the disk tier
   reranking off the artifact's shard files), f32 and bf16 stores: f32
   answers bit-identical across placements, host bytes equal to device
   bytes, disk bills whole pages, bf16 rows 2d bytes less a reranked row;
   qps and recall@10 of each. (d) ``search_stream`` over the 512 queries
   (tile_q=64) on host and disk, bit-identical to its tiles' searches.
   (e) metadata from the seed (tenant in [0, 16), tag in [0, 64),
   timestamp a permutation) and the filters tenant=3, tags_any=(5, 9), a
   time range of 192 ids (the exact-scan route) and deny_ids = the
   unfiltered top-10s, each under exact (device) and pq (device, host,
   disk): no answer outside the allowed set, recall@10 against ground
   truth over the allowed set (1.0 on the exact-scan route), pq's
   placements bit-identical, and kernel path against plain path in
   lock-step (graph route) or the scan's pair kernel against the plain
   gather (near-tie rows at most 1%). (f) a batch's tier gather split into
   its host part and the H2D copy, the device-busy share of a host-tier
   batch, and the launches over phase 8's runs into the kernels line
   (``phase8_launches``).

9. Streaming mutation on phase 4's world and searcher (after phase 8,
   before phase 6 frees them); each step's seconds from CUDA events. (a)
   ``MutableIndex.from_build`` over the NN-Descent + GD graph, its edge
   distances through the pair kernel (held to the plain gather). (b) 150
   inserts (cut from 1,000: host-bound) drawn from the seed at
   insert_ef=32 with GD inline (the reference's ``--serve-mutate``
   settings); the first doubles the
   capacity to 2M (its seconds and the bytes of each device mirror);
   insert_rate and an insert's ms by part; one insert's device-busy
   share; then 20% of the original ids deleted. (c) The 8 x 64 stream at
   ef=64, k=10 under exact/device, pq/device, pq/disk and sq8/disk: no
   dead or unallocated id in any answer, recall@10 against ground truth
   over the live set, pq's placements bit-identical, kernel path against
   plain path in lock-step with the tombstones (exact and pq), and 64
   inserted points searched as queries (printed, not gated). (g) The new
   shapes per recorded launch beside their plain versions, library calls
   and bounds: the Q=1 hop over the 2M capacity rows, the exact scan's
   forward (128-row block x 2M) and reverse (2M x 128-row block) calls
   with the one-row operand's bits and time beside them, the inline GD
   select's 32 x 32 block, the 1M x 20 edge-distance pass. (d) compact
   with a seed against ``build_index`` of the ~801k survivors with the
   same spec and seed: neighbors, hubs and base bit-identical,
   ``last_id_map``, version, staleness. (e) checkpoint into a temporary
   directory (removed), ``load_index`` and ``from_artifact``: arrays and a
   batch from the same entries bit-identical. (f) ``construct=
   "incremental"``: exact mode (insert_ef=0, graph_k=20) on the smoke
   world's first 5,000 points bit-identical to ``construct="exact"``; beam
   mode (insert_ef=64, GD inline) through ``serve.build_searcher`` on the
   smoke world's first 100 points (cut: an insert's Q=1 beam is
   host-bound; cut from 2,000, then 500), recall@10 of
   512 queries against NN-Descent + GD over the same points. The launches
   over phase 9's driven runs go into the kernels line
   (``phase9_launches``), the new shapes into the rows' ``shapes``.

10. The continuous-batching server (``repro_torch.launch.server``, driven
   by ``launch.loadgen``) on phase 4's world and searcher (after phase 9,
   before phase 6 frees them); exact, ef=64, k=10, random entries, a
   256-row query pool from the seed. (a) ``serve --arch ann --smoke
   --serve`` at the reference's defaults (200 requests of 1-8 rows at 500
   rows/s offered, buckets 1-16, 4 live, 16 queued): completed + shed =
   200, every completed request bit-identical to its direct search (rerun
   off the timed path), served recall@1 equal to the direct twins'. (b)
   ``loadgen.serving_sweep`` over 48 requests (cut from 120, then 80:
   host-bound): closed-batch capacity, the
   paced single-request wall, then the open loop at 0.5x and 3x capacity
   (the reference's 0.05x point is cut: ~5 minutes of arrivals alone):
   p50/p90/p99, queue and service ms, sustained qps, shed, fill, buckets,
   the largest live window; parity 1.0, completed + shed = 48,
   timestamps in order, shed > 0 at 3x. (c) closed loops of 9 requests
   under pq (device, host) and sq8, and exact with phase 8's tenant=3
   filter on every third request: each bit-identical to its direct search.
   (d) a ``MutableIndex`` of phase 4's graph (the first insert doubles the
   capacity to 2M), a snapshot Searcher serving 16 requests, 99 more
   inserts (insert_ef=32, GD inline) and 250 deletes, a hot swap with 8
   requests queued at the flip, 24 more requests (counts cut from 40,
   499 and 120: host-bound): the snapshot answers
   as before the inserts, each mirror cloned once (its ms by CUDA events
   and bytes printed), each side bit-identical to direct search on its
   version, 0 dead or unallocated ids, nothing loaded or built after the
   flip (``server.prepared_state``), ``warm_s``. (e) one bucket-16 request
   under the profiler (device-busy share), and time in queue against time
   in service at each sweep point. The launches over phase 10's driven
   runs go into the kernels line (``phase10_launches``); every kernel of
   the path must have launched.
11. Sharded search and build (``repro_torch.distributed.sharded_ann``, the
   engine's shard helpers) on phase 4's world and searcher (after phase 10,
   before phase 6 frees them); 8 batches of 64, ef=64, k=10. (a)
   ``shard_build`` with P=4 under phase 4's BuildSpec (NN-Descent k=20, 15
   rounds, GD, pq M=8 K=256): each shard's stage seconds and graph-recall
   proxy. (b) ``emulated_shard_search`` over the 4 shards (entries from
   ``shard_entries``) under exact and pq: recall@10 against phase 4's
   ground truth, comps/query, wall a batch; again with shard 0 dead: no
   answer in [0, 250,000), recall lower. (c) ``distributed_search`` on a
   one-rank NCCL group (``make_flat_group``; no gloo fallback) over phase
   4's whole graph as P=1: exact and pq ids, dists and n_comps
   bit-identical to ``Searcher.search`` on the same entries; pq on the
   host and disk tiers with the device run's ids. (d) the all-gather and
   merge at Q=64, k=10, CUDA events. One card gives no multi-GPU figure.
   The launches over phase 11's runs go into the kernels line
   (``phase11_launches``); every kernel of the path must have launched.

Prints a ``{"kernels": [...]}`` line (each row also names the ``kernel``
symbol timed and its ``yardstick``) and the card's ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero on any failed check,
without a GPU, or when the repository's sources are not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# recall@10 of the JAX reference on the smoke world, on the CPU
# (scripts/reference_smoke_recall.py [--scorer sq8|pq], seed 0)
REF_SMOKE_RECALL10 = 0.741406261920929
REF_SMOKE_RECALL10_SQ8 = 0.743359386920929
REF_SMOKE_RECALL10_PQ = 0.6996093988418579
# exact and sq8: the port's CPU figure sat within 0.006 of the reference's
# (NN-Descent and the random entries draw from other generators). pq also
# trains its codebooks from another generator: over seeds 0-2 the port's CPU
# recall@10 sat 0.004-0.008 below the reference's, so 0.03 is over 3x that.
RECALL_SLACK = 0.02
PQ_RECALL_SLACK = 0.03
SMOKE_FLOORS = {"exact": (REF_SMOKE_RECALL10, RECALL_SLACK),
                "sq8": (REF_SMOKE_RECALL10_SQ8, RECALL_SLACK),
                "pq": (REF_SMOKE_RECALL10_PQ, PQ_RECALL_SLACK)}
# recall@10 of the JAX reference on the smoke world from the hierarchy
# (scripts/reference_smoke_recall.py --entry hierarchy: HNSW, no diversify
# stage, seed 0; recall@1 0.8301); the port's CPU figure was 0.7449
# (levels and layer graphs drawn by other generators). The reference's own
# CLI, `python -m repro.launch.serve --arch ann --smoke --entry hierarchy`,
# reports recall@1 only, on its jax.random world: 0.750 over 16 queries.
REF_SMOKE_RECALL10_HIERARCHY = 0.7433593273162842
# phase 4b: the hierarchy rung on the plain versions against the kernels'
PLAIN_RECALL_SLACK = 0.005
SCORERS = ("exact", "sq8", "pq")
PQ_SEARCH_RERANK = 64
# phase 8: the artifact's shards, the stream's tiles, and the filtered runs
PHASE8_SHARD_ROWS = 65_536
PHASE8_TILE_Q = 64
PHASE8_FILTER_RUNS = (("exact", "device"), ("pq", "device"), ("pq", "host"), ("pq", "disk"))
PHASE8_KERNELS = ("gather_distance", "gather_distance_masked", "gather_adc_masked",
                  "gather_sq8_masked", "distance_matrix")
# phase 9: the mutation path on phase 4's world (the reference's
# --serve-mutate settings: insert_ef=32, GD inline; 20% of the ids deleted as
# in its tests) and the incremental construct's cuts. Inserts and the
# incremental construct are host-bound (a Q=1 beam each); their counts are
# cut to keep the script within half its time limit.
PHASE9_INSERTS = 150   # cut from 1,000
PHASE9_PROFILED_INSERTS = 5
PHASE9_INSERT_EF = 32
PHASE9_DELETE_SHARE = 0.2
PHASE9_SELF_QUERIES = 64
PHASE9_CHECK_ROWS = 65_536
PHASE9_EXACT_POINTS = 5_000   # of the smoke world's 20,000
PHASE9_BEAM_POINTS = 100   # cut from 2,000, then 500
PHASE9_RUNS = (("exact", "device"), ("pq", "device"), ("pq", "disk"), ("sq8", "disk"))
PHASE9_KERNELS = ("gather_distance", "gather_distance_pool", "gather_distance_masked",
                  "gather_adc_masked", "gather_sq8_masked", "distance_matrix",
                  "distance_matrix_small")
# phase 10: the continuous-batching server on phase 4's world. The sweep
# leaves out the reference's 0.05x load point: at ~0.1 s a request its 120
# Poisson arrivals alone would take ~5 minutes. Requests and inserts are
# host-bound (~0.13 s a request, ~0.065 s an insert); their counts are cut
# to keep the script within half its time limit.
PHASE10_LOAD_FACTORS = (0.5, 3.0)
PHASE10_SWEEP_REQUESTS = 48   # cut from 120, then 80
PHASE10_POOL = 256
PHASE10_PARITY_REQUESTS = 9   # cut from 32
PHASE10_INSERTS = 100   # cut from 500
PHASE10_DELETES = 250
PHASE10_PRE_SWAP_REQUESTS = 16   # cut from 40
PHASE10_QUEUED_AT_FLIP = 8
PHASE10_POST_SWAP_REQUESTS = 24   # cut from 120
PHASE10_KERNELS = ("gather_distance", "gather_distance_pool", "gather_distance_masked",
                   "gather_adc_masked", "gather_sq8_masked", "distance_matrix",
                   "distance_matrix_small")
# phase 11: sharded search on phase 4's world, P shards of n/P rows each
PHASE11_SHARDS = 4
PHASE11_SEED = 11
PHASE11_MERGE_REPS = 200
PHASE11_KERNELS = ("gather_distance", "gather_distance_pool", "gather_distance_masked",
                   "distance_matrix_small", "gather_adc_masked")
# phase 7: the paper's worlds (repro_torch.data.synthetic) and the figures
# each runs; PAPER_SCALE lists a cut of n where the run needs one (none)
PAPER_WORLDS = (("SIFT1M", ("fig3", "fig4", "fig5", "fig6")),
                ("GIST1M", ("fig5",)),
                ("RAND10M4D", ("fig4", "fig6")))
PAPER_SCALE: dict[str, float] = {}
PAPER_QUERIES = 1000
PAPER_KERNELS = ("gather_distance_pool", "distance_matrix", "distance_matrix_small",
                 "gather_distance_masked", "gather_distance", "pq_adc")
DPG_SAMPLE = 10_000
FOREST_R = 12 * 152   # the forest rerank's R on SIFT1M: 12 trees x leaf_cap 152
GATHER_TOL = dict(rtol=1e-5, atol=1e-5)


def gather_tol(d: int) -> dict:
    """GATHER_TOL up to d = 128; past it the absolute tolerance grows as
    d / 64, as the sums that kernel and plain version order differently do
    (the generic gather kernel is 6.1e-5 from the plain version for ip at
    d = 960)."""
    return GATHER_TOL if d <= 128 else dict(rtol=1e-5, atol=1e-5 * d / 64)
MATRIX_RTOL, MATRIX_ATOL = 1e-4, 1e-4
NEAR_TIE_ROWS_MAX = 0.01
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-5)}
# the attention backward against its plain version: |got - want| <= rtol
# |want| + atol m per gradient, m the largest max-abs of the call's dq, dk
# and dv. Both compute the same fp32 sums on the same inputs in another order
# (the kernels tile over 32-128 keys or queries, the plain version is dense;
# the tensor-core route's products take P and dS as bf16 hi + lo, to ~2^-17:
# rounded to bf16 alone they leave this tolerance); a dq or
# dk element sums ~S terms of dS = P (dP - D), which cancel (at S = 1 exactly:
# dq is 0 up to the rounding of dP - D), so the difference scales with the
# call's gradients, not with the element: atol is relative to m. bf16: both
# round the fp32 result to bf16, one ulp (<= 2^-8 relative) apart where the
# fp32 values straddle a rounding boundary.
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
# phase 2 / 13: each LM's attention layer at its training batch (label, B,
# S, Hq, Hkv, dh, dhv, window, scale): TinyLlama at phase 13's batch of 8,
# the others at 2 (DeepSeek's phase 13 (d) batch)
BWD_MODEL_SHAPES = (("TinyLlama-1.1B layer", 8, 2048, 32, 4, 64, 64, None, None),
                    ("Qwen3-30B-A3B layer", 2, 2048, 32, 4, 128, 128, None, None),
                    ("Gemma3-12B global layer", 2, 2048, 16, 8, 256, 256, None, None),
                    ("Gemma3-12B local layer", 2, 2048, 16, 8, 256, 256, 1024, None),
                    ("DeepSeek-V3 MLA layer", 2, 2048, 128, 128, 192, 128, None,
                     192 ** -0.5))
# phase 6 (c): bf16 rounds at other places in the kernel's and the plain
# attention's fp32 sums (a one-ulp flip in ~1e-4 of the outputs), which 22
# bf16 layers carry to the logits
LM_LOGIT_RTOL = 0.05
LM_ARGMAX_ROWS = 15
LM_DECODE_RTOL = 1e-3
# phase 12: (arch, prefill batch, depth or None for the config's, (d)'s
# depth, (d)'s tokens a row, (d)'s local_window or None) and each arch's
# parameter count: Qwen3-30B-A3B's published 30.5B, DeepSeek-V3's 671B; for
# Gemma3-12B the reference config's 12.8e9 (its LM head is untied, Google's
# ties it to the embedding). DeepSeek-V3 is cut to its 3 dense-FFN layers and
# one MoE layer (the full config's 1.25 TiB does not fit one card), (d) to one
# dense and one MoE layer; PHASE12_COUNTS holds the parameter counts of the
# reference's init_params shapes at the full config, that depth and (d)'s.
PHASE12_ARCHS = (("qwen3-moe-30b-a3b", 4, None, 2, 128, None),
                 ("gemma3-12b", 8, None, 6, 192, 128),
                 ("deepseek-v3-671b", 8, 4, 2, 192, None))
PHASE12_PARAMS = {"qwen3-moe-30b-a3b": 30.5e9, "gemma3-12b": 12.8e9, "deepseek-v3-671b": 671e9}
PHASE12_COUNTS = {"deepseek-v3-671b": (671_712_655_360, 15_797_352_448, 14_630_385_664)}
# phase 13: TinyLlama's training run and checkpoint step, its batch (the
# reference's train_4k batch of 8 at S = 2048), the lock-step's batch, and
# DeepSeek-V3's cut run (batch cut to 1 if the peak passes PHASE13_PEAK_GIB)
PHASE13_STEPS = 20
PHASE13_CKPT_STEP = 10
PHASE13_BATCH, PHASE13_SEQ = 8, 2048
PHASE13_LOCKSTEP_BATCH = 2
PHASE13_DEEPSEEK_BATCH, PHASE13_DEEPSEEK_STEPS = 2, 4
PHASE13_PEAK_GIB = 76.0
# (c): each parameter's gradient on the kernel route within this share of its
# max-abs from the plain route's. fp32: the two sum in another order; bf16:
# 2 layers of bf16 activations carry the attention's one-ulp differences
# (as LM_LOGIT_RTOL holds the logits)
LM_GRAD_TOL = {torch.bfloat16: 0.05, torch.float32: 1e-3}
WINDOW_PAD_S = 0.05   # window_pad's quiet time at each end of a profiler window
# published H100 SXM peaks: HBM3 bandwidth, dense FP32 rate and the dense
# bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
METRICS = ("l2", "ip", "cos")
# the kernels' symbols, as the profiler names them (phase 5 matches on them)
HOP_KERNEL = "gather_distance_hop_kernel"
PAIR_KERNEL = "gather_distance_pairs_kernel"
GENERIC_GATHER_KERNEL = "gather_distance_kernel"
MATRIX_KERNEL = "distance_matrix_large_kernel"
SMALL_MATRIX_KERNEL = "distance_matrix_small_kernel"
TILE32_MATRIX_KERNEL = "distance_matrix_kernel"
SQ8_HOP_KERNEL = "gather_sq8_hop_kernel"
GENERIC_SQ8_KERNEL = "gather_sq8_kernel"
ADC_HOP_KERNEL = "gather_adc_hop_kernel"
GENERIC_ADC_KERNEL = "gather_adc_kernel"
SCAN_KERNEL = "pq_adc_interleaved_kernel"
GENERIC_SCAN_KERNEL = "pq_adc_kernel"


def phase(name: str):
    print(f"\n=== {name}", flush=True)
    return time.perf_counter()


def done(t0: float, name: str) -> None:
    torch.cuda.synchronize()
    print(f"[{name}] {time.perf_counter() - t0:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """The ``..._kernel`` identifier of a mangled symbol (length-prefixed,
    the length perhaps run together with a hash before it) with its
    integer template arguments, e.g. ``gather_sq8_kernelILi0ELb1EE``."""
    for m in re.finditer(r"\d+", mangled):
        for cut in range(len(m[0])):
            end = m.end() + int(m[0][cut:])
            name = mangled[m.end():end]
            if name.endswith("_kernel") and name[:1].isalpha():
                args = re.match(r"I(?:L[a-z]\d+E)+E", mangled[end:])
                return name + (args[0] if args else "")
    return mangled[:72]


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output: its
    name, registers and spills."""
    out, fn, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = _kernel_name(m[1])
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}; {spill}")
        elif "Performance Loss" in line or "setmaxnreg" in line:
            out.append(line.strip())
    return out


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def window_pad() -> None:
    """Quiet time at each end of a profiler window. The profiler keeps only
    device events that fall inside its window by their timestamps; on the
    H100 this script has lost whole one-call windows, and the first launch
    of longer ones, once heavy work (passes over 2.4e9 pairs, the n=10M
    build) had run, while 64-call windows of the same kernel kept all of
    theirs: the events fell just outside the window's ends."""
    torch.cuda.synchronize()
    time.sleep(WINDOW_PAD_S)


def device_events(fn, reps: int, match: str | None = None, tries: int = 3) -> list:
    """The device ops (torch.profiler key averages, CUPTI) of ``reps`` calls
    of ``fn`` after a warm-up call; ``match`` keeps only those whose name
    contains it. The profiler has been seen to record none of a window's
    kernels: such a window is taken again, up to ``tries`` windows, and the
    caller fails if the last one is empty too."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window_pad()
            for _ in range(reps):
                fn()
            window_pad()
        kept = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (match is None or match in e.key)]
        if sum(e.self_device_time_total for e in kept) > 0:
            return kept
        print(f"  (the profiler recorded no device time for {match or fn}; "
              f"taking the window again)")
    return kept


def lost_window_ms(fn, reps: int, label: str) -> float:
    """CUDA-event milliseconds a ``fn`` call, where the profiler recorded
    no device time for ``label`` in any of its windows (seen on the H100
    after heavy work, for every launch of a window). The events also time
    the host's launch gaps, so a short kernel reads slower than it runs."""
    ms = cuda_ms(fn, reps, warmup=1)
    print(f"  (the profiler recorded no device time for {label}; timed with CUDA events "
          f"instead: {ms:.4f} ms a call over {reps} calls, launch gaps included)")
    return ms


def mean_ms(kept: list, reps: int, label: str, launches: int | None = None) -> float:
    """Mean device milliseconds a call of the ops ``kept`` from ``reps``
    calls. With ``launches`` (ops a call), the mean is taken per recorded
    op: the profiler has been seen to leave one kernel of a window out (9
    of 10), which would bill the call for 10% less."""
    total_us = sum(e.self_device_time_total for e in kept)
    check(total_us > 0, f"the profiler recorded no device time for {label}")
    if launches is None:
        return total_us / 1e3 / reps
    n = sum(e.count for e in kept)
    check(0 < n <= launches * reps, f"{n} launches of {label} in {reps} calls")
    if n < launches * reps:
        print(f"  (the profiler recorded {n} of {launches * reps} {label} launches; "
              f"the mean is per recorded launch)")
    return total_us / 1e3 / n * launches


def device_ms(fn, reps: int, match: str | None = None,
              launches: int | None = None) -> float:
    """Mean device milliseconds per ``fn`` call: the summed duration of the
    kernels (and copies) it ran on the card, read from torch.profiler
    (CUPTI), per recorded launch with ``launches`` (:func:`mean_ms`).
    Unlike event timing, this excludes the host's launch gaps; where the
    profiler lost every window, the call is timed with CUDA events
    (:func:`lost_window_ms`)."""
    kept = device_events(fn, reps, match)
    if sum(e.self_device_time_total for e in kept) <= 0:
        return lost_window_ms(fn, reps, str(match or fn))
    return mean_ms(kept, reps, str(match or fn), launches)


def device_ms_by_kernel(fn, reps: int, match: str,
                        launches: dict[str, int]) -> dict[str, float]:
    """:func:`device_ms` for each kernel of a call that launches several:
    ``launches`` maps the part of a kernel's name after ``match`` to its
    launches a call. Each mean is per recorded launch of that kernel, so a
    launch the profiler drops is billed at its own kernel's mean; a kernel
    of ``match`` outside ``launches`` fails the check. Where the profiler
    recorded no device time for one of the kernels, the whole call is timed
    with CUDA events instead, under the key ``call``."""
    events = device_events(fn, reps, match)
    parts = {part: [e for e in events if match + part in e.key] for part in launches}
    check(sum(len(v) for v in parts.values()) == len(events),
          f"{match} kernels outside {sorted(launches)}: {[e.key for e in events]}")
    if any(sum(e.self_device_time_total for e in kept) <= 0 for kept in parts.values()):
        return {"call": lost_window_ms(fn, reps, f"every kernel of {match}*")}
    return {part: mean_ms(kept, reps, match + part, launches[part])
            for part, kept in parts.items()}


def kernels_of_one_call(fn, tries: int = 3) -> list[str]:
    """Names of the kernels one ``fn`` call runs on the card, one entry per
    launch (torch.profiler, a window of one call after a warm-up call). The
    window opens with a fill kernel: the profiler has been seen to leave the
    first kernel of a window out, and the fill takes that place; fills are
    not listed. A window in which the profiler recorded none of the call's
    kernels is lost and taken again, up to ``tries`` windows; an empty list
    means every window was lost (:func:`counted_launches` then stands in)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.zeros(1, device="cuda")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.fill_(1.0)
            window_pad()
            fn()
            window_pad()
        called = [e.key for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "FillFunctor" not in e.key for _ in range(e.count)]
        if called:
            return called
        print("  (the profiler recorded none of the call's kernels; taking the window again)")
    return []


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    """(least ms on the card, what bounds it) at the published peaks."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    diff = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


# -- phase 2 -----------------------------------------------------------------


def _ids_and_bitmap(rng, Q, R, n, dev):
    from repro_torch.core import convert

    ids = rng.integers(-1, n, size=(Q, R)).astype(np.int32)
    if Q > 1:
        ids[0] = -1                                  # an all-invalid row
    if Q > 2 and R >= 4:                             # bit 31, the last word
        ids[1, :4] = [min(31, n - 1), min(63, n - 1), n - 1, ((n - 1) // 32) * 32]
    visited = rng.integers(0, 2**32, size=(Q, (n + 31) // 32), dtype=np.uint64)
    visited = visited.astype(np.uint32)
    visited[:, 0] |= np.uint32(1 << 31)
    return (convert.tensor(ids, torch.int32, dev),
            convert.bitmap_from_uint32(visited, dev))


def check_kernels(full_base: torch.Tensor, errs: dict) -> None:
    from repro_torch.kernels import distance_matrix as kdm
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import ref

    dev = full_base.device
    rng = np.random.default_rng(1)
    n_full, d_full = full_base.shape
    small_base = {(1000, 17): None, (1, 1): None, (70, 8): None, (30001, 4): None,
                  (30001, 128): None}
    for key in small_base:
        small_base[key] = torch.randn(key, device=dev)
    gather_cases = [  # (label, Q, R, base, queries from base rows?)
        ("hop Q=64 R=20 n=1M d=64", 64, 20, full_base, False),
        ("paper hop Q=1000 R=20 n=30001 d=4", 1000, 20, small_base[(30001, 4)], False),
        ("paper hop Q=1000 R=20 n=30001 d=128", 1000, 20, small_base[(30001, 128)], False),
        ("nndescent Q=1024 R=240 n=1M d=64", 1024, 240, full_base, True),
        ("ragged Q=7 R=33 n=1000 d=17", 7, 33, small_base[(1000, 17)], False),
        ("partial word Q=5 R=40 n=70 d=8", 5, 40, small_base[(70, 8)], False),
        ("tiny Q=1 R=1 n=1 d=1", 1, 1, small_base[(1, 1)], False),
    ]
    for label, Q, R, base, from_base in gather_cases:
        n, d = base.shape
        queries = (base[:Q].contiguous() if from_base
                   else torch.randn((Q, d), device=dev))
        ids, visited = _ids_and_bitmap(rng, Q, R, n, dev)
        if Q > 3:   # the hop kernel's masking: every id visited, ids past n - 1
            visited[2] = -1
            ids[3, ::2] = n + torch.arange(ids[3, ::2].numel(), device=dev,
                                           dtype=torch.int32) % 40
        for metric in METRICS:
            got = kgd.gather_distance(queries, ids, base, metric)
            want = ref.gather_distance_ref(queries, ids, base, metric)
            torch.testing.assert_close(got, want, **GATHER_TOL)
            gd_, gi_ = kgd.gather_distance_masked(queries, ids, base, visited, metric)
            wd_, wi_ = ref.gather_distance_masked_ref(queries, ids, base, visited, metric)
            check(torch.equal(gi_, wi_), f"masked ids differ: {label} {metric}")
            torch.testing.assert_close(gd_, wd_, **GATHER_TOL)
            ed_, ei_ = kgd.gather_distance_masked_generic(queries, ids, base, visited, metric)
            check(torch.equal(ei_, wi_), f"generic masked ids differ: {label} {metric}")
            torch.testing.assert_close(ed_, wd_, **GATHER_TOL)
            if d % 32 == 0:
                check(torch.equal(gd_, ed_) and torch.equal(gi_, ei_),
                      f"the hop kernel differs from the generic masked kernel: {label} {metric}")
            errs["gather_distance"] = max(errs["gather_distance"], max_abs_err(got, want))
            errs["gather_distance_masked"] = max(errs["gather_distance_masked"],
                                                 max_abs_err(gd_, wd_))
        print(f"  gather_distance, gather_distance_masked (hop and generic kernels) {label}: "
              f"l2/ip/cos agree (rtol {GATHER_TOL['rtol']}, atol {GATHER_TOL['atol']})"
              + ("; the hop kernel bit-identical to the generic masked kernel"
                 if d % 32 == 0 else ""))

    gd_ids = torch.randint(0, n_full, (65536, 20), device=dev)
    gd_rows = full_base[gd_ids]

    def rnd(*shape, zero_row=None):
        t = torch.randn(shape, device=dev)
        if zero_row is not None:
            t[..., zero_row, :] = 0.0
        return t
    offset = torch.zeros(512 * d_full + 1, device=dev)
    offset[1:] = torch.randn(512 * d_full, device=dev)
    matrix_cases = [  # (label, x, y)
        ("ground truth 512 x 16384 x 64", rnd(512, d_full), full_base[:16384]),
        ("ground truth's last chunk 512 x 576 x 64", rnd(512, d_full),
         full_base[-(n_full % 16384):]),
        ("GD batch 65536 x 20 x 20 x 64, x is y", gd_rows, gd_rows),
        ("GD batch 65536 x 20 x 20 x 64, x != y", gd_rows, full_base[gd_ids.flip(1)]),
        ("small route 1000 x 20 x 20 x 64, zero rows", rnd(1000, 20, 64, zero_row=3),
         rnd(1000, 20, 64, zero_row=-1)),
        ("small route 3 x 32 x 32 x 960", rnd(3, 32, 960), rnd(3, 32, 960)),
        ("small route x at a 4-byte offset 300 x 20 x 20 x 64",
         torch.cat([torch.zeros(1, device=dev), rnd(300 * 20 * 64)])[1:].view(300, 20, 64),
         rnd(300, 20, 64)),
        ("small route 2 x 1 x 1 x 1", rnd(2, 1, 1), rnd(2, 1, 1)),
        ("ragged 37 x 101 x 24", rnd(37, 24), rnd(101, 24)),
        ("ragged 129 x 257 x 130, zero rows", rnd(129, 130, zero_row=1),
         rnd(257, 130, zero_row=-1)),
        ("GIST1M width 300 x 1000 x 960, zero rows", rnd(300, 960, zero_row=0),
         rnd(1000, 960, zero_row=7)),
        ("batch on the 128 tile 3 x 200 x 150 x 64", rnd(3, 200, 64), rnd(3, 150, 64)),
        ("x at a 4-byte offset 512 x 16384 x 64", offset[1:].view(512, d_full),
         full_base[:16384]),
        ("ragged batch 5 x 7 x 3 x 130", rnd(5, 7, 130), rnd(5, 3, 130)),
        ("tile edges 3 x 33 x 65 x 16", rnd(3, 33, 16), rnd(3, 65, 16)),
        ("tiny 1 x 1 x 1", rnd(1, 1), rnd(1, 1)),
    ]
    for label, x, y in matrix_cases:
        d = x.shape[-1]
        tile = kdm.matrix_route(x.shape[0] if x.dim() == 3 else 1, x.shape[-2],
                                y.shape[-2], d)[0]
        small = tile == kdm.SMALL_TILE
        key = "distance_matrix_small" if small else "distance_matrix"
        for metric in METRICS:
            got = kdm.distance_matrix(x, y, metric)
            want = ref.distance_matrix_ref(x, y, metric)
            torch.testing.assert_close(
                got, want, rtol=MATRIX_RTOL,
                atol=MATRIX_ATOL * (d if metric == "l2" else 1))
            if small:
                check(torch.equal(got, kdm.distance_matrix_tile32(x, y, metric)),
                      f"the small route differs from the 32 x 32 tile: {label} {metric}")
            errs[key] = max(errs[key], max_abs_err(got, want))
        print(f"  distance_matrix {label} ({'small route' if small else 'tile 128'}): "
              f"l2/ip/cos agree (rtol {MATRIX_RTOL}, atol {MATRIX_ATOL} x d for l2)"
              + ("; bit-identical to the 32 x 32 tile" if small else ""))
    del gd_rows



def check_pair_kernel(full_base: torch.Tensor, errs: dict) -> None:
    """The unmasked gather's pair kernel (what ``gather_distance`` runs at
    every shape) bit for bit against the generic kernel, and within
    gather_tol(d) of the plain version, at the hierarchy path's R (1: a
    layer start, 10: a descent step at M = 10, 32: the hubs scan, 64: the
    rerank) and d = 32, 64 (the n=1M base), 130 and 960: rows that are all
    INVALID (a late descent step's finished rows) come back +inf, ids past
    n - 1 read row n - 1; query rows and base at a 4-byte offset (scalar
    loads) too."""
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import ref

    dev = full_base.device
    gen = torch.Generator(device=dev).manual_seed(2)

    def offset_view(t):
        flat = torch.zeros(t.numel() + 1, device=dev)
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)

    bases = {64: full_base}
    for d, n in ((4, 30001), (32, 30001), (128, 30001), (130, 30001), (960, 5000)):
        bases[d] = torch.randn((n, d), device=dev, generator=gen)
    Q = 64
    for d, base in bases.items():
        n = base.shape[0]
        views = [("aligned", base)]
        if d != 64:
            views.append(("base at a 4-byte offset", offset_view(base)))
        for R in (1, 10, 32, 64, FOREST_R):
            ids = torch.randint(0, n, (Q, R), generator=gen, device=dev, dtype=torch.int32)
            ids[0] = -1                                   # a finished row
            ids[5::3] = -1                                # a third of them, as late in a descent
            ids[3, ::2] = n + torch.arange(ids[3, ::2].numel(), device=dev,
                                           dtype=torch.int32) % 40
            q = torch.randn((Q, d), device=dev, generator=gen)
            for label, b in views + [("query rows at a 4-byte offset", base)]:
                qv = offset_view(q) if label.startswith("query") else q
                for metric in METRICS:
                    got = kgd.gather_distance(qv, ids, b, metric)
                    check(torch.equal(got, kgd.gather_distance_generic(qv, ids, b, metric)),
                          f"the pair kernel differs from the generic kernel: d={d} R={R} "
                          f"{label} {metric}")
                    want = ref.gather_distance_ref(qv, ids, b, metric)
                    torch.testing.assert_close(got, want, **gather_tol(d))
                    check(bool(torch.isinf(got[0]).all()) and bool(torch.isinf(got[5]).all()),
                          f"padding rows not +inf: d={d} R={R} {label} {metric}")
                    errs["gather_distance"] = max(errs["gather_distance"], max_abs_err(got, want))
        print(f"  gather_distance (pair kernel) d={d} n={n}: R = 1, 10, 32, 64, {FOREST_R} x "
              f"l2/ip/cos x "
              f"{', '.join(v for v, _ in views)}, query rows at a 4-byte offset: bit-identical "
              f"to the generic kernel, within {gather_tol(d)} of the plain version; "
              f"all-INVALID rows +inf")


def gather_kernel_pass(base, pool, metric="l2", chunk=1024):
    """The NN-Descent scoring pass on the generic gather kernel, as it ran
    before the pool kernel: once per ``chunk`` rows, the rows' own base rows as queries."""
    from repro_torch.kernels import gather_distance as kgd

    return torch.cat([kgd.gather_distance_generic(base[lo:lo + chunk],
                                                  pool[lo:lo + chunk].contiguous(), base,
                                                  metric)
                      for lo in range(0, base.shape[0], chunk)])


def uniform_pool(n: int, C: int, seed: int) -> torch.Tensor:
    """The stand-in candidate pool: uniform random ids, about 4% INVALID."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pool = torch.randint(-1, n, (n, C), generator=gen, device="cuda", dtype=torch.int32)
    pool[:, ::24] = -1
    return pool


def nndescent_state(base: torch.Tensor, rounds: int):
    """A full-world NN-Descent state after ``rounds`` rounds of the build's
    own loop (default config, seed 0): (ids, dists, isnew, generator, cfg)."""
    from repro_torch.core import nndescent as nd
    from repro_torch.core.topk import dedup_by_id

    cfg = nd.NNDescentConfig()
    gen = torch.Generator(device=base.device).manual_seed(0)
    ids = nd._random_init(gen, base.shape[0], cfg.k)
    dists, ids = dedup_by_id(nd._score_chunked(base, ids, "l2", cfg.chunk), ids)
    isnew = torch.ones_like(ids, dtype=torch.bool)
    for _ in range(rounds):
        ids, dists, isnew, _ = nd._round(base, ids, dists, isnew, gen, cfg, "l2")
    return ids, dists, isnew, gen, cfg


def real_pool(base: torch.Tensor) -> torch.Tensor:
    """A candidate pool as a round draws it (``nndescent._candidate_pool``
    through ``_round_pool``) from the full-world k-NN graph after 2 rounds."""
    from repro_torch.core import nndescent as nd

    ids, _, isnew, gen, cfg = nndescent_state(base, 2)
    return nd._round_pool(ids, isnew, gen, cfg)


def check_pool_kernel(full_base: torch.Tensor, errs: dict) -> None:
    """gather_distance_pool against its plain version (``gather_tol``) at ragged
    shapes, staged and direct (d = 960 at n = 30001 and 1M, GIST1M's width;
    n = 5M, past 8192 buckets), and bit for bit against the generic gather
    kernel (one launch per 1024 rows) wherever d is a multiple of 32: there
    and at the NN-Descent pass shape on a uniform and on a real pool, for
    l2 / ip / cos."""
    from repro_torch.kernels import gather_distance_pool as kgp
    from repro_torch.kernels import ref

    dev = full_base.device
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    rng = np.random.default_rng(3)
    cases = [(3000, 240, 8, "staged"), (3000, 20, 17, "staged"), (30001, 240, 64, "staged"),
             (1, 1, 64, "staged"), (7, 3, 5, "staged"), (5000, 240, 128, "staged"),
             (30001, 4, 960, "direct"), (1_000_000, 20, 960, "direct"),
             (5_000_000, 20, 8, "direct")]
    for n, C, d, route in cases:
        check((kgp.pool_plan(n, d, C, l2) is None) == (route == "direct"),
              f"gather_distance_pool n={n} C={C} d={d} is not {route}")
        base = torch.randn((n, d), device=dev)
        pool = torch.from_numpy(rng.integers(-1, n + 2, size=(n, C)).astype(np.int32)).to(dev)
        if n > 3:
            pool[3] = -1                                 # an all-INVALID row
        for metric in METRICS:
            got = kgp.gather_distance_pool(base, pool, metric)
            want = ref.gather_distance_pool_ref(base, pool, metric)
            torch.testing.assert_close(got, want, **gather_tol(d))
            if d % 32 == 0:
                check(torch.equal(got, gather_kernel_pass(base, pool, metric)),
                      f"gather_distance_pool differs from the generic gather kernel: "
                      f"n={n} C={C} d={d}")
            if d <= 128:   # the kernels line reports GATHER_TOL's widths
                errs["gather_distance_pool"] = max(errs["gather_distance_pool"],
                                                   max_abs_err(got, want))
        timing = ""
        if n * C >= 1 << 24:   # a pass past L2: l2 beside the generic kernel, CUDA events
            k_ms = cuda_ms(lambda: kgp.gather_distance_pool(base, pool), reps=2, warmup=1)
            g_ms = cuda_ms(lambda: gather_kernel_pass(base, pool), reps=2, warmup=1)
            timing = f"; a pass {k_ms:.3f} ms, the generic gather kernel {g_ms:.3f} ms"
        del base, pool
        print(f"  gather_distance_pool n={n} C={C} d={d} ({route}): l2/ip/cos agree (rtol "
              f"{gather_tol(d)['rtol']}, atol {gather_tol(d)['atol']:.3g})"
              + ("; bit-identical to the generic gather kernel" if d % 32 == 0 else "")
              + timing)
    check_pool_past_int32(errs)
    n = full_base.shape[0]
    for label, pool in (("uniform", uniform_pool(n, 240, 4)), ("real", real_pool(full_base))):
        for metric in METRICS:
            got = kgp.gather_distance_pool(full_base, pool, metric)
            check(torch.equal(got, gather_kernel_pass(full_base, pool, metric)),
                  f"gather_distance_pool differs from the generic gather kernel: "
                  f"{label} pool {metric}")
            if label == "uniform":
                want = ref.gather_distance_pool_ref(full_base, pool, metric)
                torch.testing.assert_close(got, want, **GATHER_TOL)
                errs["gather_distance_pool"] = max(errs["gather_distance_pool"],
                                                   max_abs_err(got, want))
        print(f"  gather_distance_pool NN-Descent pass n={n} C={pool.shape[1]} d="
              f"{full_base.shape[1]}, {label} pool ({float(pool.ge(0).float().mean()):.3f} "
              f"valid): l2/ip/cos bit-identical to the generic gather kernel")
        del pool

def check_pool_past_int32(errs: dict) -> None:
    """gather_distance_pool at the RAND10M4D pass (n = 10M, d = 4, C = 240:
    2.4e9 pairs, past 2**31), which its plan sends to the direct kernel:
    the rows past pair 2**31 and a random sample against the plain version
    (gather_tol), for l2 / ip / cos. The pass is timed beside the generic
    gather kernel (CUDA events)."""
    from repro_torch.kernels import gather_distance_pool as kgp
    from repro_torch.kernels import ref

    n, C, d = 10_000_000, 240, 4
    l2 = torch.cuda.get_device_properties("cuda").L2_cache_size
    check(kgp.pool_plan(n, d, C, l2) is None, "the n=10M, d=4 pass is not direct")
    gen = torch.Generator(device="cuda").manual_seed(8)
    base = torch.rand((n, d), device="cuda", generator=gen)
    pool = uniform_pool(n, C, 8)
    pool[-3] = -1                                        # an all-INVALID row
    pool[-2, ::5] = n - 1
    past = (2**31) // C
    rows = torch.cat([torch.arange(past - 4096, n, device="cuda"),
                      torch.randint(0, past, (32768,), generator=gen, device="cuda")])
    for metric in METRICS:
        got = kgp.gather_distance_pool(base, pool, metric)[rows]
        want = ref.gather_distance_ref(base[rows], pool[rows], base, metric)
        torch.testing.assert_close(got, want, **GATHER_TOL)
        errs["gather_distance_pool"] = max(errs["gather_distance_pool"], max_abs_err(got, want))
    k_ms = cuda_ms(lambda: kgp.gather_distance_pool(base, pool), reps=2, warmup=1)
    g_ms = cuda_ms(lambda: gather_kernel_pass(base, pool), reps=1, warmup=1)
    print(f"  gather_distance_pool n={n} C={C} d={d} (direct; {n * C:.3g} pairs, past 2**31): "
          f"l2/ip/cos agree with the plain version on {rows.numel()} rows ({n - past + 4096} "
          f"of them from pair {(past - 4096) * C} on); a pass {k_ms:.3f} ms, the generic "
          f"gather kernel {g_ms:.3f} ms")
    del base, pool
    torch.cuda.empty_cache()


def check_compressed_kernels(full_base: torch.Tensor, errs: dict) -> None:
    """gather_sq8_masked, gather_adc_masked and pq_adc against their plain
    versions; each table is also checked at a d- or M-byte offset, which
    takes the kernels' byte-load path."""
    from repro_torch.core.scorers import build_sq8
    from repro_torch.kernels import gather_adc as kga
    from repro_torch.kernels import gather_sq8 as kgs
    from repro_torch.kernels import pq_adc as kpa
    from repro_torch.kernels import ref

    dev = full_base.device
    rng = np.random.default_rng(2)
    n_full = full_base.shape[0]
    sq8_cases = [  # (label, Q, R, base of n + 1 rows: n rows at two offsets)
        ("hop Q=64 R=20 n=1M d=64", 64, 20, torch.cat([full_base, full_base[:1]])),
        ("ragged Q=7 R=33 n=1000 d=17", 7, 33, torch.randn((1001, 17), device=dev)),
        ("partial word Q=5 R=40 n=70 d=8", 5, 40, torch.randn((71, 8), device=dev)),
        ("tiny Q=1 R=1 n=1 d=1", 1, 1, torch.randn((2, 1), device=dev)),
        ("ragged Q=9 R=37 n=700 d=130", 9, 37, torch.randn((701, 130), device=dev)),
        ("words, no 16-byte loads Q=6 R=70 n=300 d=100", 6, 70,
         torch.randn((301, 100), device=dev)),
    ]
    for label, Q, R, rows in sq8_cases:
        codes, scale, mn = build_sq8(rows)
        n = codes.shape[0] - 1
        queries = torch.randn((Q, codes.shape[1]), device=dev)
        ids, visited = _ids_and_bitmap(rng, Q, R, n, dev)
        if Q > 3:   # the hop kernel's masking: every id visited, ids past n - 1
            visited[2] = -1
            ids[3, ::2] = n + torch.arange(ids[3, ::2].numel(), device=dev,
                                           dtype=torch.int32) % 40
        for table in (codes[:n], codes[1:]):
            for metric in METRICS:
                gd_, gi_ = kgs.gather_sq8_masked(queries, ids, table, scale, mn,
                                                 visited, metric)
                wd_, wi_ = ref.gather_sq8_masked_ref(queries, ids, table, scale, mn,
                                                     visited, metric)
                ed_, ei_ = kgs.gather_sq8_masked_generic(queries, ids, table, scale, mn,
                                                         visited, metric)
                check(torch.equal(gi_, wi_), f"sq8 masked ids differ: {label} {metric}")
                torch.testing.assert_close(gd_, wd_, **GATHER_TOL)
                torch.testing.assert_close(ed_, wd_, **GATHER_TOL)
                check(torch.equal(gd_, ed_) and torch.equal(gi_, ei_),
                      f"the sq8 hop kernel differs from the generic sq8 kernel: {label} "
                      f"{metric} (table at {table.data_ptr() % 16} bytes past 16)")
                errs["gather_sq8_masked"] = max(errs["gather_sq8_masked"],
                                                max_abs_err(gd_, wd_))
        print(f"  gather_sq8_masked {label}: l2/ip/cos agree (rtol "
              f"{GATHER_TOL['rtol']}, atol {GATHER_TOL['atol']}), aligned and offset; "
              f"the hop kernel bit-identical to the generic sq8 kernel")

    adc_cases = [  # (label, Q, R, n, M, K)
        ("hop Q=64 R=20 n=1M M=8 K=256", 64, 20, n_full, 8, 256),
        ("hop Q=64 R=20 n=1M M=16 K=256", 64, 20, n_full, 16, 256),
        ("ragged Q=7 R=33 n=1000 M=16 K=16", 7, 33, 1000, 16, 16),
        ("partial word Q=5 R=40 n=70 M=8 K=256", 5, 40, 70, 8, 256),
        ("tiny Q=1 R=1 n=1 M=8 K=1", 1, 1, 1, 8, 1),
        ("M=4 Q=9 R=37 n=700 K=256", 9, 37, 700, 4, 256),
        ("two runs M=40 Q=9 R=37 n=700 K=16", 9, 37, 700, 40, 16),
    ]
    for label, Q, R, n, M, K in adc_cases:
        codes = torch.randint(0, K, (n + 1, M), device=dev, dtype=torch.uint8)
        luts = torch.randn((Q, M, K), device=dev)
        ids, visited = _ids_and_bitmap(rng, Q, R, n, dev)
        if Q > 3:   # the hop kernel's masking: every id visited, ids past n - 1
            visited[2] = -1
            ids[3, ::2] = n + torch.arange(ids[3, ::2].numel(), device=dev,
                                           dtype=torch.int32) % 40
        for table in (codes[:n], codes[1:]):
            gd_, gi_ = kga.gather_adc_masked(ids, table, luts, visited)
            wd_, wi_ = ref.gather_adc_masked_ref(ids, table, luts, visited)
            check(torch.equal(gi_, wi_), f"ADC masked ids differ: {label}")
            check(torch.equal(gd_, wd_), f"ADC scores not bit-identical: {label}")
            ed_, ei_ = kga.gather_adc_masked_generic(ids, table, luts, visited)
            check(torch.equal(ed_, gd_) and torch.equal(ei_, gi_),
                  f"the ADC hop kernel differs from the generic kernel: {label}")
            errs["gather_adc_masked"] = max(errs["gather_adc_masked"],
                                            max_abs_err(gd_, wd_))
            errs["gather_adc_masked_generic"] = max(errs["gather_adc_masked_generic"],
                                                    max_abs_err(ed_, wd_))
        print(f"  gather_adc_masked {label}: the hop kernel and the generic kernel "
              f"bit-identical to the plain version, aligned and offset")

    pq_cases = [  # (label, Q, n, M, K); Q = 0 is a single LUT
        ("pq_search chunk Q=64 n=1M M=8 K=256", 64, n_full, 8, 256),
        ("query groups Q=21 n=9001 M=16 K=256", 21, 9001, 16, 256),
        ("query groups Q=21 n=9001 M=16 K=16", 21, 9001, 16, 16),
        ("partial tile Q=33 n=130 M=4 K=256", 33, 130, 4, 256),
        ("odd n Q=16 n=1001 M=8 K=16", 16, 1001, 8, 16),
        ("one LUT n=1000 M=8 K=256", 0, 1000, 8, 256),
        ("generic M=4 Q=3 n=33 K=16", 3, 33, 4, 16),
    ]
    for label, Q, n, M, K in pq_cases:
        codes = torch.randint(0, K, (n + 1, M), device=dev, dtype=torch.uint8)
        luts = torch.randn((max(Q, 1), M, K), device=dev)
        luts = luts if Q else luts[0]
        routes = []
        for table in (codes[:n], codes[1:]):
            route = kpa.scan_route(max(Q, 1), M, K, table.data_ptr())
            before = dict(kpa.LAUNCHES)
            got = kpa.pq_adc(table, luts)
            ran = [k for k, v in kpa.LAUNCHES.items() if v > before[k]]
            check(ran == [{"interleaved": "pq_adc", "generic": "pq_adc_generic"}[route]],
                  f"pq_adc ran {ran} on the {route} route: {label}")
            routes.append(route)
            want = ref.pq_adc_ref(table, luts)
            check(torch.equal(got, want), f"pq_adc not bit-identical: {label}")
            gen = kpa.pq_adc_generic(table, luts)
            check(torch.equal(gen, want), f"pq_adc_generic not bit-identical: {label}")
            errs["pq_adc"] = max(errs["pq_adc"], max_abs_err(got, want))
            errs["pq_adc_generic"] = max(errs["pq_adc_generic"], max_abs_err(gen, want))
        print(f"  pq_adc {label} (routes {' / '.join(routes)}): bit-identical, aligned and "
              f"offset, and so is the generic kernel")


def plain_flash_attention(q, k, v, causal=True, window=None, softmax_scale=None):
    """The flash kernel's plain version one batch row at a time, so its
    dense (S, S) scores of every head fit at the full shape."""
    from repro_torch.kernels import ref

    return torch.cat([ref.flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                              causal, window, softmax_scale)
                      for b in range(q.shape[0])])


def check_flash_attention(errs: dict) -> None:
    from repro_torch.kernels import flash_attention as kfa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, B, S, Hq, Hkv, dh, dhv, dtype, causal, window, scale)
        ("TinyLlama layer B=8 S=2048 32/4 dh=64 bf16 causal",
         8, 2048, 32, 4, 64, 64, bf16, True, None, None),
        ("B=2 S=256 8/8 dh=64 fp32 causal", 2, 256, 8, 8, 64, 64, f32, True, None, None),
        ("B=2 S=256 8/8 dh=64 bf16 causal", 2, 256, 8, 8, 64, 64, bf16, True, None, None),
        ("B=2 S=512 8/1 dh=128 fp32 causal window 100",
         2, 512, 8, 1, 128, 128, f32, True, 100, None),
        ("B=2 S=512 8/1 dh=128 bf16 causal window 100",
         2, 512, 8, 1, 128, 128, bf16, True, 100, None),
        ("Danube heads B=2 S=1000 32/8 dh=80 bf16 causal window 129",
         2, 1000, 32, 8, 80, 80, bf16, True, 129, None),
        ("B=2 S=300 4/4 dh=80 fp32 non-causal (ragged tail)",
         2, 300, 4, 4, 80, 80, f32, False, None, None),
        ("B=1 S=200 8/2 dh=64 fp32 non-causal window 50",
         1, 200, 8, 2, 64, 64, f32, False, 50, None),
        ("B=1 S=130 16/2 dh=128 dhv=32 fp32 causal scale 0.2",
         1, 130, 16, 2, 128, 32, f32, True, None, 0.2),
        ("B=3 S=64 8/2 dh=16 fp32 causal window 1 (diagonal only)",
         3, 64, 8, 2, 16, 16, f32, True, 1, None),
        ("tiny B=1 S=1 1/1 dh=1 fp32 causal", 1, 1, 1, 1, 1, 1, f32, True, None, None),
        ("B=2 S=300 8/2 dh=40 bf16 causal (dh no multiple of 16)",
         2, 300, 8, 2, 40, 40, bf16, True, None, None),
        ("B=2 S=127 4/2 dh=64 bf16 causal", 2, 127, 4, 2, 64, 64, bf16, True, None, None),
        ("B=2 S=128 4/2 dh=64 bf16 causal", 2, 128, 4, 2, 64, 64, bf16, True, None, None),
        ("B=2 S=129 4/2 dh=64 bf16 causal", 2, 129, 4, 2, 64, 64, bf16, True, None, None),
        ("B=2 S=512 8/2 dh=64 bf16 causal window 128 (a key-tile edge)",
         2, 512, 8, 2, 64, 64, bf16, True, 128, None),
        ("tiny B=1 S=1 1/1 dh=64 bf16 causal", 1, 1, 1, 1, 64, 64, bf16, True, None, None),
        # head dims past 128: 64-key stages in the bf16 kernel, NE = 16 in
        # the fp32 one; DeepSeek's 192 / 128 and Gemma3's 256
        ("Gemma3 layer B=8 S=2048 16/8 dh=256 bf16 causal window 1024",
         8, 2048, 16, 8, 256, 256, bf16, True, 1024, None),
        ("Gemma3 layer B=8 S=2048 16/8 dh=256 bf16 causal (global)",
         8, 2048, 16, 8, 256, 256, bf16, True, None, None),
        ("B=2 S=300 8/2 dh=256 fp32 causal", 2, 300, 8, 2, 256, 256, f32, True, None, None),
        ("B=2 S=300 8/2 dh=256 fp32 causal window 70",
         2, 300, 8, 2, 256, 256, f32, True, 70, None),
        ("B=2 S=300 8/2 dh=256 bf16 causal window 70",
         2, 300, 8, 2, 256, 256, bf16, True, 70, None),
        ("B=2 S=129 4/2 dh=256 bf16 causal", 2, 129, 4, 2, 256, 256, bf16, True, None, None),
        ("B=2 S=127 4/2 dh=256 bf16 non-causal window 64 (a key-stage edge)",
         2, 127, 4, 2, 256, 256, bf16, False, 64, None),
        ("B=1 S=65 4/4 dh=256 bf16 non-causal", 1, 65, 4, 4, 256, 256, bf16, False, None, None),
        ("DeepSeek heads B=2 S=300 8/8 dh=192 dhv=128 bf16 causal scale 192^-0.5",
         2, 300, 8, 8, 192, 128, bf16, True, None, 192 ** -0.5),
        ("B=2 S=300 8/8 dh=192 dhv=128 bf16 causal window 100",
         2, 300, 8, 8, 192, 128, bf16, True, 100, None),
        ("B=2 S=300 8/8 dh=192 dhv=128 fp32 causal", 2, 300, 8, 8, 192, 128, f32, True,
         None, None),
        ("B=2 S=200 8/2 dh=192 dhv=128 fp32 non-causal window 50",
         2, 200, 8, 2, 192, 128, f32, False, 50, None),
        ("B=2 S=129 4/2 dh=200 dhv=160 bf16 causal (ragged head dims)",
         2, 129, 4, 2, 200, 160, bf16, True, None, None),
        ("B=1 S=130 4/2 dh=64 dhv=256 bf16 causal", 1, 130, 4, 2, 64, 256, bf16, True,
         None, None),
        ("B=1 S=130 4/2 dh=160 dhv=200 fp32 causal", 1, 130, 4, 2, 160, 200, f32, True,
         None, None),
    ]
    for label, B, S, Hq, Hkv, dh, dhv, dt, causal, window, scale in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v = rnd(B, S, Hq, dh), rnd(B, S, Hkv, dh), rnd(B, S, Hkv, dhv)
        got = kfa.flash_attention(q, k, v, causal, window, scale)
        want = plain_flash_attention(q, k, v, causal, window, scale)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dt]
        err = max_abs_err(got.float(), want.float())
        excess = float(((got.float() - want.float()).abs()
                        - tol["atol"] - tol["rtol"] * want.float().abs()).max())
        print(f"  flash_attention {label}: max abs error {err:.3g} "
              f"(rtol {tol['rtol']}, atol {tol['atol']})")
        check(got.shape == want.shape and got.dtype == dt, f"flash_attention shape/dtype: {label}")
        check(bool(torch.isfinite(got).all()), f"flash_attention non-finite output: {label}")
        check(excess <= 0.0, f"flash_attention outside its tolerance: {label}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    q = torch.zeros((1, 4, 1, 257), device=dev)
    with contextlib.suppress(ValueError):
        kfa.flash_attention(q, q, q)
        check(False, "flash_attention took dh=257")
    print("  flash_attention raises on dh=257")


def plain_flash_lse(q, k, v, causal=True, window=None, softmax_scale=None):
    """The forward's plain log-sum-exp (fp32 (B, Hq, S), log2 unit) one
    batch row at a time."""
    from repro_torch.kernels import ref

    return torch.cat([ref.flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal,
                                              window, softmax_scale, True)[1]
                      for b in range(q.shape[0])])


def plain_flash_attention_bwd(q, k, v, out, dout, causal=True, window=None,
                              softmax_scale=None):
    """The backward kernel's plain version one batch row at a time, so its
    dense fp32 (S, S) tensors of every head fit at the model shapes."""
    from repro_torch.kernels import ref

    rows = [ref.flash_attention_bwd_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], out[b:b + 1],
                                        dout[b:b + 1], causal, window, softmax_scale)
            for b in range(q.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*rows))


def bwd_excess(got, want, dt, scale: float) -> tuple[float, float]:
    """(largest abs difference, largest excess over BWD_TOL) of one gradient:
    |got - want| <= rtol |want| + atol scale, scale the largest max-abs of
    the call's three plain gradients (:func:`bwd_scale`)."""
    tol = BWD_TOL[dt]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), float((diff - tol["rtol"] * w.abs() - tol["atol"] * scale).max())


def bwd_scale(grads) -> float:
    return max(float(x.float().abs().max()) for x in grads if x.numel())


def _bwd_bytes(B, S, Hq, Hkv, dh, dhv, itemsize):
    """q, k, v, o and do read once, dq, dk and dv written once."""
    return float(itemsize) * B * S * (2 * Hq * dh + 2 * Hkv * dh + 2 * Hkv * dhv + 2 * Hq * dhv)


def _sdpa_bwd_ms(q, k, v, dout, window, scale) -> tuple[float | None, str]:
    """CUDA-event ms of scaled_dot_product_attention's backward (the
    library's yardstick; the port never calls it) at the layer's shape, the
    window as a boolean mask; None with the reason where it refuses."""
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    try:
        out = _sdpa_layer(qs, ks, vs, window, scale)
        ms = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True),
                     reps=3, warmup=1)
    except RuntimeError as e:
        return None, f"refused: {str(e).splitlines()[0][:120]}"
    kernels = sorted({n for n in kernels_of_one_call(
        lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True))})
    return ms, f"runs {kernels}"


def check_flash_attention_bwd(errs: dict) -> dict:
    """The backward (flash_attention_bwd) against its plain version on the
    card, within BWD_TOL: bf16 through the tensor-core route (the
    preprocess, dq and dk / dv wgmma kernels, from the forward's saved
    lse), fp32 and bf16 through the first backward's FMA pair (the fp32 route, and the
    bf16 route's yardstick): the five LMs' layer shapes at one batch row,
    ragged S (1, 17, 1000), G = 1 and 8, windows with and without causal, a
    given scale, ragged head dims and strided operands. At every bf16 case
    the forward's lse is held within 1e-5 of the plain log-sum-exp, its
    output bit for bit to the forward without lse, and two backward calls
    to each other bit for bit. The autograd Function on CUDA tensors runs
    the kernels and not the plain version, in both dtypes. Then each model
    shape at its training batch, per recorded launch (torch.profiler): the
    tensor-core route by kernel, beside its bound (the five products at
    the bf16 tensor-core peak, or the bytes), the same route with P and dS
    rounded to bf16 alone (``flash_attention_bwd_unsplit``, the split's
    cost), the FMA yardstick, the plain version and
    scaled_dot_product_attention's backward. Returns the kernels line's row
    (its launches come from phase 13)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f"{label}, B=1", 1, S, Hq, Hkv, dh, dhv, True, window, scale)
             for label, _, S, Hq, Hkv, dh, dhv, window, scale in BWD_MODEL_SHAPES]
    cases += [  # (label, B, S, Hq, Hkv, dh, dhv, causal, window, scale)
        ("S=1 1/1 dh=64", 1, 1, 1, 1, 64, 64, True, None, None),
        ("S=17 8/1 dh=64 (G=8) scale 0.3", 2, 17, 8, 1, 64, 64, True, None, 0.3),
        ("S=1000 4/4 dh=128 (G=1) window 129", 2, 1000, 4, 4, 128, 128, True, 129, None),
        ("S=1000 16/2 dh=80 (G=8) non-causal window 50", 1, 1000, 16, 2, 80, 80, False, 50,
         None),
        ("S=200 4/2 dh=32 non-causal, no window", 1, 200, 4, 2, 32, 32, False, None, None),
        ("S=300 8/2 dh=200 dhv=160 (ragged head dims)", 1, 300, 8, 2, 200, 160, True, None,
         None),
        ("S=130 4/2 dh=64 dhv=256", 1, 130, 4, 2, 64, 256, True, None, None),
        ("S=65 4/1 dh=16 window 1 (the diagonal only)", 2, 65, 4, 1, 16, 16, True, 1, None),
        ("S=90 4/2 dh=40 dhv=36 (rows not 16-byte multiples)", 1, 90, 4, 2, 40, 36, True, None,
         None),
    ]

    def held(label, route, got, want, dt):
        worst, scale_g = [], bwd_scale(want)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            check(a.shape == b.shape and a.dtype == dt,
                  f"flash_attention_bwd {route} {name} shape/dtype: {label}")
            check(bool(torch.isfinite(a).all()), f"flash_attention_bwd {route} non-finite "
                                                 f"{name}: {label}")
            err, excess = bwd_excess(a, b, dt, scale_g)
            worst.append((name, err, excess))
            check(excess <= 0.0, f"flash_attention_bwd {route} {name} outside BWD_TOL "
                                 f"({excess:.3g} over): {label} {dt}")
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
        print(f"  flash_attention_bwd {label} {str(dt)[6:]} {route}: max abs error "
              + ", ".join(f"{n} {e:.3g} (excess {x:.2g})" for n, e, x in worst))

    lse_err = 0.0
    for label, B, S, Hq, Hkv, dh, dhv, causal, window, scale in cases:
        for dt in (bf16, f32):
            def rnd(*shape):
                return torch.randn(shape, generator=g, device=dev).to(dt)
            q, k, v, dout = rnd(B, S, Hq, dh), rnd(B, S, Hkv, dh), rnd(B, S, Hkv, dhv), \
                rnd(B, S, Hq, dhv)
            out = kfa.flash_attention(q, k, v, causal, window, scale)
            want = plain_flash_attention_bwd(q, k, v, out, dout, causal, window, scale)
            if dt == bf16:
                out2, lse = kfa.flash_attention(q, k, v, causal, window, scale, return_lse=True)
                err = float((lse - plain_flash_lse(q, k, v, causal, window, scale)).abs().max())
                lse_err = max(lse_err, err)
                check(torch.equal(out2, out), f"the forward's output changed with lse: {label}")
                check(err <= 1e-5, f"the forward's lse is {err:.3g} from the plain one: {label}")
                got = kfa.flash_attention_bwd(q, k, v, out, dout, causal, window, scale,
                                              lse=lse)
                again = kfa.flash_attention_bwd(q, k, v, out, dout, causal, window, scale,
                                                lse=lse)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"two tensor-core backward calls differ in bits: {label}")
                held(label, "wgmma", got, want, dt)
                del out2, lse, again
            got = kfa.flash_attention_bwd_fma(q, k, v, out, dout, causal, window, scale)
            held(label, "fma", got, want, dt)
            del q, k, v, dout, out, got, want
    print(f"  the forward's lse against the plain log-sum-exp: largest difference "
          f"{lse_err:.3g} (tolerance 1e-5)")
    # strided operands: q, k, v views into one packed projection, dout a transpose
    B, S, H, dh = 2, 300, 4, 64
    for dt in (f32, bf16):
        packed = torch.randn((B, S, 3 * H * dh), generator=g, device=dev).to(dt)
        packed = packed.view(B, S, 3, H, dh)
        q, k, v = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
        dout = torch.randn((B, H, S, dh), generator=g, device=dev).to(dt).transpose(1, 2)
        out, lse = (kfa.flash_attention(q, k, v, return_lse=True) if dt == bf16
                    else (kfa.flash_attention(q, k, v), None))
        got = kfa.flash_attention_bwd(q, k, v, out, dout, lse=lse)
        want = plain_flash_attention_bwd(q, k, v, out, dout)
        check(all(bwd_excess(a, b, dt, bwd_scale(want))[1] <= 0.0 for a, b in zip(got, want)),
              f"flash_attention_bwd outside BWD_TOL on strided operands ({dt})")
        # the autograd Function on CUDA: one forward and one backward launch, no plain call
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = ops.launch_counts()
        ops.flash_attention(*leaves).backward(dout)
        after = ops.launch_counts()
        check(after["flash_attention"] - before["flash_attention"] == 1
              and after["flash_attention_bwd"] - before["flash_attention_bwd"] == 1,
              "the autograd Function did not launch the forward and backward kernels once each")
        check(all(bwd_excess(leaf.grad, b, dt, bwd_scale(want))[1] <= 0.0
                  for leaf, b in zip(leaves, want)),
              f"autograd through ops.flash_attention on CUDA differs from the plain backward "
              f"({dt})")
        del packed, q, k, v, dout, out, lse, got, want, leaves
    print("  flash_attention_bwd: strided operands within BWD_TOL; autograd through "
          "ops.flash_attention on CUDA launched 1 forward + 1 backward kernel (fp32, bf16)")

    shapes = []
    tc_parts = {"preprocess_kernel": 1, "dq_wgmma_kernel": 1, "dkdv_wgmma_kernel": 1}
    for label, B, S, Hq, Hkv, dh, dhv, window, scale in BWD_MODEL_SHAPES:
        q = torch.randn((B, S, Hq, dh), generator=g, device=dev).to(bf16)
        k = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(bf16)
        v = torch.randn((B, S, Hkv, dhv), generator=g, device=dev).to(bf16)
        dout = torch.randn((B, S, Hq, dhv), generator=g, device=dev).to(bf16)
        out, lse = kfa.flash_attention(q, k, v, True, window, scale, return_lse=True)

        def kern():
            return kfa.flash_attention_bwd(q, k, v, out, dout, True, window, scale, lse=lse)

        def unsplit():
            return kfa.flash_attention_bwd_unsplit(q, k, v, out, dout, True, window, scale,
                                                   lse=lse)

        def fma():
            return kfa.flash_attention_bwd_fma(q, k, v, out, dout, True, window, scale)
        parts = device_ms_by_kernel(kern, reps=5, match="flash_bwd_", launches=tc_parts)
        k_ms = sum(parts.values())
        u_ms = sum(device_ms_by_kernel(unsplit, reps=5, match="flash_bwd_",
                                       launches=tc_parts).values())
        y_ms = sum(device_ms_by_kernel(fma, reps=2, match="flash_bwd_",
                                       launches={"dq_kernel": 1, "dkdv_kernel": 1}).values())
        p_ms = device_ms(lambda: plain_flash_attention_bwd(q, k, v, out, dout, True, window,
                                                           scale), reps=1)
        l_ms, l_note = _sdpa_bwd_ms(q, k, v, dout, window, scale)
        # the five products over the visible pairs: q.k, dS k, dS^T q (dh);
        # do.v, P^T do (dhv)
        flops = _attention_flops(B, S, Hq, 3 * dh, window, dhv=2 * dhv)
        b_ms, b_by = bound(_bwd_bytes(B, S, Hq, Hkv, dh, dhv, 2), flops, BF16_FLOP_PER_S)
        print(f"  flash_attention_bwd {label} B={B} S={S} {Hq}/{Hkv} dh={dh} dhv={dhv} bf16 "
              f"causal{'' if window is None else f' window {window}'}: tensor-core route "
              f"{k_ms:.4f} ms on the device ({', '.join(f'{n} {m:.4f}' for n, m in parts.items())}; "
              f"{flops / k_ms / 1e9:.1f} TFLOP/s of the five products); P and dS bf16 alone "
              f"{u_ms:.4f} ms; the FMA pair {y_ms:.3f} ms; plain {p_ms:.2f} ms (one batch "
              f"row at a time), SDPA backward "
              f"{'not timed' if l_ms is None else f'{l_ms:.4f} ms'} ({l_note}), bound "
              f"{b_ms:.4f} ms ({b_by}: {flops:.4e} flops)")
        shapes.append(dict(shape=f"{label}, B={B} x S={S}, {Hq}/{Hkv}, dh={dh}, dhv={dhv}, "
                                 f"bf16, causal" + ("" if window is None else f", window {window}"),
                           ms=k_ms, parts=parts, unsplit_ms=u_ms, yardstick_ms=y_ms,
                           plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
        del q, k, v, dout, out, lse
    first = shapes[0]
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/layers.py:60",
                replaces_note="no Pallas kernel: the gradient the reference's autodiff "
                              "takes of its attention_full",
                launches=None, max_abs_err=errs["flash_attention_bwd"], ms=first["ms"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=first["library_ms"],
                kernel="flash_bwd_preprocess_kernel + flash_bwd_dq_wgmma_kernel + "
                       "flash_bwd_dkdv_wgmma_kernel",
                yardstick="flash_bwd_dq_kernel + flash_bwd_dkdv_kernel (fp32 FMA)",
                yardstick_ms=first["yardstick_ms"], shapes=shapes[1:])


class _PlainFlash(torch.autograd.Function):
    """The attention's plain route on the card, differentiable: the flash
    kernel's plain version forward and the backward kernel's plain version
    backward (phase 13 (c)'s yardstick; launches no kernel of the port)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale):
        out = plain_flash_attention(q, k, v, causal, window, softmax_scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, window, softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*plain_flash_attention_bwd(q, k, v, out, dout, *ctx.mask), None, None, None)


def plain_flash_differentiable(q, k, v, causal=True, window=None, softmax_scale=None):
    return _PlainFlash.apply(q, k, v, causal, window, softmax_scale)


# -- phase 4: kernel path against plain path, in lock-step -------------------


class _PlainScorer:
    """A registered scorer's accounting with other scoring: "<name>-plain"
    (its plain version) or "<name>-<suffix>" beside the kernel's "<name>"."""

    def __init__(self, name: str, score_fn, suffix: str = "plain"):
        from repro_torch.core.scorers import get_scorer

        self.kernel = get_scorer(name)
        self.name = f"{name}-{suffix}"
        self.needs_rerank = self.kernel.needs_rerank
        self.needs_base = self.kernel.needs_base
        self.score_fn = score_fn

    def score(self, state, queries, base, ids, visited, *, metric, r_tile):
        return self.score_fn(state, queries, base, ids, visited, metric)

    def scale_comps(self, state, n_comps, d):
        return self.kernel.scale_comps(state, n_comps, d)

    def scored_bytes(self, state, n_raw, d):
        return self.kernel.scored_bytes(state, n_raw, d)


def register_plain_scorers():
    from repro_torch.core.scorers import register_scorer
    from repro_torch.kernels import ref

    plain = {
        "exact": lambda st, q, b, i, v, m: ref.gather_distance_masked_ref(q, i, b, v, m),
        "sq8": lambda st, q, b, i, v, m: ref.gather_sq8_masked_ref(q, i, *st, v, m),
        "pq": lambda st, q, b, i, v, m: ref.gather_adc_masked_ref(i, *st, v),
    }
    for name, fn in plain.items():
        register_scorer(_PlainScorer(name, fn))


def generic_hop_rung(searcher, spec, stream, seeds, served) -> None:
    """The rung of ``spec.scorer`` again with its generic kernel scoring
    every hop (exact and sq8: scorer "<name>-generic"; pq: the scorer with
    ``ops.gather_adc_masked`` on the generic kernel, as its state holds the
    batch's LUTs): ids, dists, n_comps and n_steps must equal the served
    run's, bit for bit, as the hop kernel's distances are the generic
    kernel's."""
    from repro_torch.core.scorers import register_scorer
    from repro_torch.kernels import gather_adc as kga
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import gather_sq8 as kgs
    from repro_torch.kernels import ops

    spec_g = spec
    if spec.scorer == "sq8":   # the searcher builds no state for "sq8-generic"
        sq = tuple(searcher.sq8_index())

        def generic(st, q, b, i, v, m):
            return kgs.gather_sq8_masked_generic(q, i, *sq, v, m)
    elif spec.scorer == "exact":
        def generic(st, q, b, i, v, m):
            return kgd.gather_distance_masked_generic(q, i, b, v, m)
    if spec.scorer != "pq":
        register_scorer(_PlainScorer(spec.scorer, generic, suffix="generic"))
        spec_g = spec._replace(scorer=f"{spec.scorer}-generic")
    hop = ops.gather_adc_masked
    ops.gather_adc_masked = kga.gather_adc_masked_generic
    before = ops.launch_counts()
    try:
        for q, seed, res in zip(stream, seeds, served):
            got = searcher.search(q, spec_g, seed)
            check(torch.equal(got.ids, res.ids) and torch.equal(got.dists, res.dists)
                  and torch.equal(got.n_comps, res.n_comps)
                  and int(got.n_steps) == int(res.n_steps),
                  f"the {spec.scorer} rung on its generic kernel differs (batch seed {seed})")
    finally:
        ops.gather_adc_masked = hop
    ran = {k: v - before[k] for k, v in ops.launch_counts().items() if v > before[k]}
    generic_name = {"exact": "gather_distance_masked_generic",
                    "sq8": "gather_sq8_masked_generic",
                    "pq": "gather_adc_masked_generic"}[spec.scorer]
    check(ran.get(generic_name, 0) > 0 and all("masked" not in k or k == generic_name
                                               for k in ran),
          f"the {spec.scorer} rung on its generic kernel ran {ran}")
    print(f"{spec.scorer} rung on its generic kernel: {len(stream)} batches, ids, dists, "
          f"n_comps and n_steps bit-identical to the hop kernel's ({ran})")


# -- phase 4b: the hierarchy path ---------------------------------------------


def recording(fn, record):
    """``fn`` (an ``ops.gather_distance``) that first hands (queries, ids)
    of every call to ``record``."""
    def recorded(queries, ids, base, metric="l2"):
        record(queries, ids.clone())
        return fn(queries, ids, base, metric)
    return recorded


@contextlib.contextmanager
def ops_replaced(**fns):
    """The ``ops`` entry points named replaced by ``fns`` for the block."""
    from repro_torch.kernels import ops

    real = {name: getattr(ops, name) for name in fns}
    for name, fn in fns.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def rung_line(name: str, sm: dict, n_batches: int) -> str:
    steps = sm["steps_per_batch"]
    return (f"{name}: {sm['queries']} queries in {sm['seconds'] * 1e3:.1f} ms "
            f"({sm['qps']:.1f} qps), recall@1 {sm['recall@1']:.4f}, recall@10 "
            f"{sm['recall@10']:.4f}, comps/query {sm['comps_per_query']:.1f} (seed phase "
            f"{sm['seed_comps_per_query']:.1f}), {steps:.1f} steps/batch, "
            f"{sm['seconds'] * 1e3 / n_batches / steps:.3f} ms/step")


def hierarchy_path(dev) -> tuple[dict, dict]:
    """Phase 4b: ``serve --entry hierarchy`` at full width (HNSW over the
    n=1M world: NN-Descent bottom graph shared, upper layers by NN-Descent
    or exactly, GD-pruned, reverse-unioned), its layers, build stages and
    seed phase; on the same Searcher and bottom layer, the same stream from
    the random (flat-HNSW), hubs, projection and lsh entries and the
    hierarchy under term="stable" (fig4 and fig6's comparison on the card);
    the hierarchy rung again on the generic gather kernel (bit-identical)
    and on the plain versions (recall@10 within PLAIN_RECALL_SLACK). Returns
    the path's launch counts and the gather calls recorded from its seed
    phases (descent steps, layer starts, hubs scans) for phase 5."""
    from repro_torch.core import engine
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve

    ops.reset_launch_counts()
    for key in engine.DESCENT_STEPS:
        engine.DESCENT_STEPS[key] = 0
    run = serve.serve_ann(serve.parser().parse_args(
        ["--arch", "ann", "--device", "cuda", "--entry", "hierarchy"]))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    descent = dict(engine.DESCENT_STEPS)
    rep = run.build.report
    layers = rep.layers
    print(f"hnsw layers: {[(la['nodes'], la['source'], la['max_degree'], la['dropped_reverse_edges']) for la in layers]} "
          f"(nodes, source, degree cap, dropped reverse edges; bottom first), entry point "
          f"{int(run.searcher.hierarchy.entry_point)}")
    print(f"hnsw build: rounds {rep.rounds}, update curve {list(rep.update_curve)}, "
          f"graph-recall proxy {rep.graph_recall_proxy}, bottom degree "
          f"min/mean/max {rep.degree['min']}/{rep.degree['mean']}/{rep.degree['max']}, "
          f"index memory {rep.memory_bytes / 2**20:.1f} MiB; construct "
          f"{rep.wall_construct_s:.2f} s (NN-Descent + every layer), diversify "
          f"{rep.wall_diversify_s:.2f} s, compress {rep.wall_compress_s:.2f} s, total "
          f"{rep.wall_total_s:.2f} s; peak memory per stage (GiB) "
          f"{ {k: round(v / 2**30, 2) for k, v in rep.peak_memory_bytes.items()} }")
    check(len(layers) >= 4 and layers[0]["nodes"] == run.summary["n"]
          and layers[0]["source"] == "bottom_graph",
          f"the full-width HNSW has too few layers or no shared bottom graph: {layers}")
    # a warm-up, the served batches, and their seeds again (seed-phase comps)
    check(descent["descents"] == 2 * len(run.stream) + 1,
          f"{descent['descents']} descents for {len(run.stream)} batches")
    n_b = len(run.stream)
    print(f"hierarchy seed phase: {run.summary['seed_comps_per_query']:.1f} comps/query, "
          f"{descent['steps'] / descent['descents']:.1f} descent steps a batch over "
          f"{len(layers) - 1} layers")
    print(rung_line("hierarchy", run.summary, n_b))
    rec10 = run.summary["recall@10"]
    check(np.isfinite(rec10) and 0.0 < rec10 <= 1.0, "hierarchy recall@10 out of range")
    print(f"launches over the hierarchy path: {launches}")
    for k in ("gather_distance", "gather_distance_pool", "distance_matrix",
              "distance_matrix_small", "gather_distance_masked"):
        check(launches[k] > 0, f"{k} never launched over the hierarchy path")
    for k in ("gather_distance_generic", "gather_distance_masked_generic"):
        check(launches[k] == 0, f"{k} launched over the hierarchy path")

    s, k = run.searcher, run.spec.k
    rungs = [(e, run.spec._replace(entry=e)) for e in ("random", "hubs", "projection", "lsh")]
    rungs.append(("hierarchy, term=stable", run.spec._replace(term="stable")))
    warm = torch.from_numpy(serve.numpy_queries(s.base.shape[1], run.stream[0].shape[0], 1,
                                                99)[0]).to(dev)
    for name, spec in rungs:
        s.search(warm, spec, serve.batch_seed(0, -1))    # prepares the sketches
        results, dt = serve.serve_batches(s, spec, run.stream, run.seeds)
        nq = sum(q.shape[0] for q in run.stream)
        sm = {"queries": nq, "seconds": dt, "qps": nq / dt,
              **serve.summarize(results, run.ground_truth, k),
              "seed_comps_per_query": serve.seed_comps(s, spec, run.stream, run.seeds)}
        print(rung_line(name, sm, n_b))
        check(0.0 < sm["recall@10"] <= 1.0, f"recall@10 out of range ({name})")

    # where a hierarchy batch's time goes: the whole batch, its seed phase
    batch_share(run, run.spec)
    busy_share(lambda: s.seed(run.stream[0], run.spec, run.seeds[0]),
               "the hierarchy seed phase (descent) of a batch")

    # the hierarchy rung on the generic gather kernel: bit for bit
    before = ops.launch_counts()
    with ops_replaced(gather_distance=kgd.gather_distance_generic):
        for q, seed, res in zip(run.stream, run.seeds, run.results):
            got = s.search(q, run.spec, seed)
            check(torch.equal(got.ids, res.ids) and torch.equal(got.dists, res.dists)
                  and torch.equal(got.n_comps, res.n_comps)
                  and int(got.n_steps) == int(res.n_steps),
                  f"the hierarchy rung on the generic gather kernel differs (batch seed {seed})")
    ran = {key: v - before[key] for key, v in ops.launch_counts().items() if v > before[key]}
    check(ran.get("gather_distance_generic", 0) > 0 and "gather_distance" not in ran,
          f"the hierarchy rung on the generic kernel ran {ran}")
    print(f"hierarchy rung on the generic gather kernel: {n_b} batches, ids, dists, n_comps "
          f"and n_steps bit-identical to the pair kernel's ({ran})")

    # the hierarchy rung on the plain versions
    before = ops.launch_counts()
    with ops_replaced(gather_distance=ref.gather_distance_ref,
                      gather_distance_masked=ref.gather_distance_masked_ref):
        plain, _ = serve.serve_batches(s, run.spec, run.stream, run.seeds)
    check(ops.launch_counts() == before, "a kernel ran on the plain hierarchy rung")
    differ = sum(int((p.ids != r.ids).any(dim=1).sum()) for p, r in zip(plain, run.results))
    plain_rec = serve.summarize(plain, run.ground_truth, k)["recall@10"]
    print(f"hierarchy rung on the plain versions: {differ} of {sum(q.shape[0] for q in run.stream)} "
          f"rows differ in ids, recall@10 {plain_rec:.4f} against the kernels' {rec10:.4f}")
    check(abs(plain_rec - rec10) <= PLAIN_RECALL_SLACK,
          f"the plain hierarchy rung's recall@10 is {plain_rec:.4f}, the kernels' {rec10:.4f}")

    # the gather calls of the path's seed phases, for phase 5
    calls = {"descent step": [], "layer start": [], "hubs scan": []}
    M = s.hierarchy.layers_neighbors[1].shape[1]

    def record(queries, ids):
        key = {M: "descent step", 1: "layer start"}.get(ids.shape[1])
        if key:
            calls[key].append((queries, ids))
    with ops_replaced(gather_distance=recording(ops.gather_distance, record)):
        serve.seed_comps(s, run.spec, run.stream, run.seeds)
    with ops_replaced(gather_distance=recording(
            ops.gather_distance, lambda queries, ids: calls["hubs scan"].append((queries, ids)))):
        serve.seed_comps(s, run.spec._replace(entry="hubs"), run.stream, run.seeds)
    check(all(calls.values()), f"no gather call recorded for {[k for k, v in calls.items() if not v]}")
    return launches, calls


# -- phase 7: the paper's experiment --------------------------------------------


def forest_rerank_check(base, q, name: str, errs: dict):
    """The RP forest's rerank (12 trees, as fig3 builds it) at its real R:
    the pair kernel bit for bit against the generic kernel and within
    gather_tol(d) of the plain version. Returns the candidates (Q, R) for
    the timing."""
    from repro_torch.baselines import tree
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import ref

    forest = tree.build_forest(base, n_trees=12)
    cand = tree.forest_candidates(q, forest)
    got = kgd.gather_distance(q, cand, base)
    check(torch.equal(got, kgd.gather_distance_generic(q, cand, base)),
          f"the forest rerank's pair kernel differs from the generic kernel ({name})")
    want = ref.gather_distance_ref(q, cand, base)
    torch.testing.assert_close(got, want, **gather_tol(base.shape[1]))
    errs["gather_distance"] = max(errs["gather_distance"], max_abs_err(got, want))
    valid = float(cand.ge(0).float().mean())
    print(f"forest rerank ({name}): 12 trees of depth {forest.depth}, leaf_cap "
          f"{forest.leaves.shape[2]}; Q={cand.shape[0]} x R={cand.shape[1]} ({valid:.3f} valid) "
          f"at d={base.shape[1]}: bit-identical to the generic kernel, within "
          f"{gather_tol(base.shape[1])} of the plain version")
    return cand


def dpg_card_vs_cpu(world, name: str, sample: int) -> None:
    """``dpg_prune`` of the world's KGraph on the card against the same code
    on the CPU for ``sample`` vertices (evenly spaced): kept ids identical
    except near-tie rows (the cosine sums run in another order), at most
    NEAR_TIE_ROWS_MAX of them, counted."""
    from repro_torch.core import diversify
    from repro_torch.core.topk import INVALID, sort_by_distance

    g = world.kgraph
    n, L = g.neighbors.shape
    kept = diversify.dpg_prune(world.base, g)
    rows = torch.arange(sample, device=world.base.device) * (n // sample)
    _, ids = sort_by_distance(g.dists[rows].cpu(), g.neighbors[rows].cpu())
    keep = diversify.dpg_keep(world.base.cpu(), rows.cpu(), ids, L // 2)
    kept_cpu = torch.where(keep, ids, torch.full_like(ids, INVALID))
    _, order = torch.sort((~keep).to(torch.int8), dim=1, stable=True)
    kept_cpu = kept_cpu.gather(1, order)
    differ = int((kept[rows].cpu() != kept_cpu).any(1).sum())
    print(f"dpg_prune ({name}): card vs CPU over {sample} vertices, {differ} near-tie rows "
          f"differ (at most {NEAR_TIE_ROWS_MAX:.0%} allowed); {int(kept.ge(0).sum())} kept")
    check(differ <= NEAR_TIE_ROWS_MAX * sample, f"dpg_prune: too many rows differ ({name})")


def system_floor(dev) -> None:
    """The reference's end-to-end floor (tests/test_system.py) on the card:
    the SIFT1M stand-in at scale 0.004 (50 queries), NN-Descent k=16 and 10
    rounds, GD, 8 random entries, ef=48: recall@1 >= 0.9 at fewer than n/4
    comps a query."""
    from repro_torch.core import beam_search, bruteforce, diversify, nndescent
    from repro_torch.data.synthetic import make_ann_dataset

    base, queries, metric = make_ann_dataset("SIFT1M", scale=0.004, n_queries=50, device=dev)
    gt = bruteforce.ground_truth(queries, base, 1, metric)
    g = nndescent.build_knn_graph(base, nndescent.NNDescentConfig(k=16, rounds=10),
                                  metric=metric)
    gd = diversify.build_gd_graph(base, g, metric=metric)
    ent = beam_search.random_entries(torch.Generator(device=dev).manual_seed(0),
                                     base.shape[0], 50, 8)
    res = beam_search.beam_search(queries, base, gd.neighbors, ent, ef=48, k=1, metric=metric)
    recall = float((res.ids[:, 0] == gt[:, 0]).float().mean())
    comps = float(res.n_comps.float().mean())
    print(f"end-to-end floor (tests/test_system.py) on the card: n={base.shape[0]}, recall@1 "
          f"{recall:.3f} (floor 0.9) at {comps:.1f} comps/query (under n/4 = "
          f"{base.shape[0] / 4:.0f})")
    check(recall >= 0.9 and comps < base.shape[0] / 4, "the end-to-end floor failed")


def paper_inputs(dev, errs: dict) -> list[dict]:
    """Each paper world's dataset at its full size (PAPER_SCALE cuts it
    where set) with PAPER_QUERIES queries, and, for SIFT1M and RAND10M4D,
    the forest rerank's candidates (checked by ``forest_rerank_check``)."""
    from repro_torch.data.synthetic import make_ann_dataset

    out = []
    for name, figs in PAPER_WORLDS:
        scale = PAPER_SCALE.get(name, 1.0)
        base, queries, metric = make_ann_dataset(name, scale=scale,
                                                 n_queries=PAPER_QUERIES, device=dev)
        w = dict(name=name, figs=figs, scale=scale, base=base, queries=queries,
                 metric=metric)
        if name in ("SIFT1M", "RAND10M4D"):
            w["rerank"] = forest_rerank_check(base, queries, name, errs)
        out.append(w)
    return out


def paper_world(w: dict, launches: dict) -> None:
    """One paper world through ``repro_torch.paper``: tab1's LID, the
    AnnWorld build (ground truth, KGraph, GD, DPG, HNSW: seconds, peak GiB,
    index bytes), the figures, each printing the reference's lines, and
    each recall curve the figures drew (first draw; wall per ef). The
    launch counts of that run are added to ``launches``; then the world's
    checks (SIFT1M: DPG card vs CPU, the lock-step search)."""
    from repro_torch.kernels import ops
    from repro_torch.paper import bench_util, run as paper_run, tab1_datasets

    name = w["name"]
    before = ops.launch_counts()
    t0 = time.perf_counter()
    tab1_datasets.run(scale=w["scale"], names=[name], device=w["base"].device)
    print(f"# dataset {name}: n={w['base'].shape[0]} d={w['base'].shape[1]} "
          f"metric={w['metric']}, {w['queries'].shape[0]} queries (scale {w['scale']})",
          flush=True)
    world = bench_util.AnnWorld(w["base"], w["queries"], metric=w["metric"])
    print(world.summary_line(name), flush=True)
    curves = {}
    curve = world.recall_curve

    def recorded(graph, *args, **kw):
        rows = curve(graph, *args, **kw)
        label = next(k for k in ("kgraph", "gd", "dpg", "hnsw") if getattr(world, k) is graph)
        curves.setdefault((label, kw.get("entry", "random")), rows)
        return rows
    world.recall_curve = recorded
    for fig in w["figs"]:
        paper_run.FIGS[fig].run(world, name)
    torch.cuda.synchronize()
    for (label, entry), rows in curves.items():
        print(f"curve {name}/{label}/{entry} (ef: recall@1, comps, wall ms of "
              f"{w['queries'].shape[0]} queries): "
              + "; ".join(f"{r['ef']}: {r['recall']:.4f}, {r['comps']:.1f}, "
                          f"{r['wall'] * 1e3:.1f}" for r in rows))
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    print(f"# done {name} ({time.perf_counter() - t0:.1f} s); launches {counts}", flush=True)
    if name == "SIFT1M":
        dpg_card_vs_cpu(world, name, DPG_SAMPLE)
        searcher = world.searcher_for(world.gd)
        spec = searcher.spec(ef=64, k=1, n_entries=8)
        served = searcher.search(w["queries"], spec, world.seed)
        lockstep_rung(searcher, spec, [w["queries"]], [world.seed], [served])


def paper_phase(dev, errs: dict, rows: list) -> dict:
    """Phase 7: the paper's worlds. First every world's data, its forest
    rerank check and the timing of its shapes (``time_paper_shapes``):
    after the n=10M world's build torch.profiler has been seen to lose
    every window, so nothing is profiled after a world is built. Then each
    world in PAPER_WORLDS order, and the reference's end-to-end floor.
    Every kernel of the path launched over the worlds' runs; each row
    gains its launches there as ``paper_launches``. Returns the path's
    launch counts."""
    register_plain_scorers()
    inputs = paper_inputs(dev, errs)
    time_paper_shapes(inputs, rows)
    launches: dict[str, int] = {}
    for w in inputs:
        paper_world(w, launches)
        torch.cuda.empty_cache()
    del inputs
    system_floor(dev)
    print(f"launches over the paper path: {launches}")
    check(all(launches.get(k, 0) > 0 for k in PAPER_KERNELS),
          f"a kernel of the paper path never launched: {launches}")
    for r in rows:
        if r["name"] in PAPER_KERNELS:
            r["paper_launches"] = launches[r["name"]]
    return launches


@contextlib.contextmanager
def kept_knn_graph(holder: dict):
    """The GD diversifier keeps the k-NN graph it prunes in ``holder``
    while the block runs."""
    from repro_torch.core import build as cbuild

    gd = cbuild.DIVERSIFIERS["gd"]

    def keep(base, graph, spec):
        holder["graph"] = graph
        return gd(base, graph, spec)
    cbuild.DIVERSIFIERS["gd"] = keep
    try:
        yield
    finally:
        cbuild.DIVERSIFIERS["gd"] = gd


def gd_prune_on_both_routes(base, graph) -> None:
    """``gd_prune`` of the full world's k-NN graph through the small route
    and again through the 32 x 32 tile: the kept ids must be identical."""
    from repro_torch.core.diversify import gd_prune
    from repro_torch.kernels import distance_matrix as kdm
    from repro_torch.kernels import ops

    before = kdm.LAUNCHES["distance_matrix_small"]
    kept = gd_prune(base, graph)
    small = kdm.LAUNCHES["distance_matrix_small"] - before
    kernel = ops.distance_matrix
    ops.distance_matrix = kdm.distance_matrix_tile32
    try:
        before = kdm.LAUNCHES["distance_matrix_tile32"]
        kept32 = gd_prune(base, graph)
        tile32 = kdm.LAUNCHES["distance_matrix_tile32"] - before
    finally:
        ops.distance_matrix = kernel
    check(small > 0 and tile32 == small, f"gd_prune launched the small route {small} times "
          f"and the 32 x 32 tile {tile32}")
    check(torch.equal(kept, kept32), "gd_prune keeps other ids on the small route than on "
          "the 32 x 32 tile")
    print(f"gd_prune of the full world's k-NN graph ({tuple(graph.neighbors.shape)}): "
          f"{small} launches of each route, kept ids identical "
          f"({int(kept.ge(0).sum())} kept)")


def ground_truth_against_plain(run) -> None:
    """Ground truth at full width through the kernel and through the
    distance matrix's plain version on the card: the ids must agree except
    near-ties, where the k-th distances agree within the matrix tolerance."""
    from repro_torch.core import bruteforce
    from repro_torch.kernels import ops, ref

    qs = torch.cat(run.stream)
    base = run.searcher.base
    k, d = run.spec.k, base.shape[1]
    kd, ki = bruteforce.exact_search(qs, base, k)
    check(torch.equal(ki, run.ground_truth), "ground truth differs from the served run's")
    kernel = ops.distance_matrix
    ops.distance_matrix = ref.distance_matrix_ref
    try:
        pd, pi = bruteforce.exact_search(qs, base, k)
    finally:
        ops.distance_matrix = kernel
    differ = ki != pi
    tie = torch.isclose(kd, pd, rtol=MATRIX_RTOL, atol=MATRIX_ATOL * d)
    worst = float((kd - pd).abs()[differ].max()) if bool(differ.any()) else 0.0
    print(f"ground truth {qs.shape[0]} x {base.shape[0]} x {d}, top-{k}: kernel vs plain "
          f"distance matrix, {int(differ.sum())} of {ki.numel()} ids differ in "
          f"{int(differ.any(1).sum())} rows, each a near-tie (largest distance gap at a "
          f"differing id {worst:.3g}; tolerance rtol {MATRIX_RTOL}, atol {MATRIX_ATOL} x d); "
          f"largest gap over all {float((kd - pd).abs().max()):.3g}")
    check(bool(tie.all()), "the kernel's ground-truth distances differ from the plain version's")
    check(bool(tie[differ].all()), "a ground-truth id differs without a near-tie")


def lockstep(searcher, spec, queries, entries, state, deny=None):
    """Run the beam with the CUDA kernel (scorer ``spec.scorer``) and with
    the plain version side by side, from the same entries, scorer state,
    the searcher's tombstones and filter ``deny`` words. Returns (kernel
    result, plain result, {row: near-tie?} for each row at its first
    divergence)."""
    from repro_torch.core import beam_search as bs

    args = (queries, searcher.base, searcher.neighbors)
    entries = entries.to(torch.int32)
    kernel, plain = spec.scorer, f"{spec.scorer}-plain"
    dead = searcher.tombstones
    sk = bs._init_state(*args, entries, spec.ef, spec.metric, 0, kernel, state, dead, deny)
    sp = bs._init_state(*args, entries, spec.ef, spec.metric, 0, plain, state, dead, deny)
    max_steps = bs.default_max_steps(spec.ef, spec.expand_width)
    first: dict[int, bool] = {}

    def record(a, b):
        diff = ((a.cand_ids != b.cand_ids).any(1) | (a.done != b.done)
                | (a.n_comps != b.n_comps))
        for r in torch.nonzero(diff).flatten().tolist():
            if r in first:
                continue
            pos = (a.cand_ids[r] != b.cand_ids[r])
            if pos.any():  # ids swapped or cut at the list's end
                tie = bool(torch.isclose(a.cand_dists[r][pos], b.cand_dists[r][pos],
                                         **GATHER_TOL).all())
            else:          # only the stop decision differs: best vs worst
                best = a.cand_dists[r].masked_fill(a.expanded[r], float("inf")).min()
                tie = bool(torch.isclose(best, a.cand_dists[r, -1], **GATHER_TOL))
            first[r] = tie

    record(sk, sp)
    while True:
        go_k = sk.step < max_steps and not bool(sk.done.all())
        go_p = sp.step < max_steps and not bool(sp.done.all())
        if not (go_k or go_p):
            break
        if go_k:
            sk = bs._step(sk, *args, spec.metric, spec.expand_width, 0, kernel, state)
        if go_p:
            sp = bs._step(sp, *args, spec.metric, spec.expand_width, 0, plain, state)
        record(sk, sp)
    tail = (spec.k, spec.metric, 0)
    return (bs._finalize(sk, queries, searcher.base, *tail, kernel, state, spec.rerank),
            bs._finalize(sp, queries, searcher.base, *tail, plain, state, spec.rerank),
            first)


def lockstep_rung(searcher, spec, stream, seeds, served) -> None:
    """Every served batch of one scorer again, kernel and plain path in
    lock-step; checks the kernel path against the served run and counts
    the rows where the two paths differ. Under ``spec.filter`` both paths
    start from the served run's redrawn entries and carry its deny words."""
    rows_total = rows_diff = near_ties = 0
    cf = None if spec.filter is None else searcher.compiled_filter(spec.filter)
    for q, seed, res in zip(stream, seeds, served):
        entries, _ = searcher.seed(q, spec, seed)
        entries = searcher._remap_entries(entries, cf, seed)
        state = searcher.scorer_state(q, spec)
        kres, pres, first = lockstep(searcher, spec, q, entries, state,
                                     None if cf is None else cf.deny)
        check(torch.equal(kres.ids, res.ids) and torch.equal(kres.n_comps, res.n_comps),
              f"the lock-step kernel path differs from the served run ({spec.scorer})")
        rows_total += q.shape[0]
        differ = ((kres.ids != pres.ids).any(1) | (kres.n_comps != pres.n_comps))
        if int(kres.n_steps) != int(pres.n_steps):
            print(f"  {spec.scorer} batch seed {seed}: n_steps kernel "
                  f"{int(kres.n_steps)} vs plain {int(pres.n_steps)}")
        for r in torch.nonzero(differ).flatten().tolist():
            rows_diff += 1
            tie = first.get(r, False)
            near_ties += tie
            print(f"  {spec.scorer} row {r} (batch seed {seed}): ids/comps differ, "
                  f"first divergence {'is a float32 near-tie' if tie else 'is NOT a near-tie'}"
                  f": kernel comps {int(kres.n_comps[r])}, plain {int(pres.n_comps[r])}")
        check(int(kres.n_steps) == int(pres.n_steps) or differ.any(),
              f"n_steps differ with identical rows ({spec.scorer})")
    print(f"plain re-run ({spec.scorer}): {rows_total} rows, {rows_diff} differ, "
          f"{near_ties} traced to near-ties (at most {NEAR_TIE_ROWS_MAX:.0%} allowed)")
    check(rows_diff == near_ties, f"a row differs without a near-tie ({spec.scorer})")
    check(near_ties <= NEAR_TIE_ROWS_MAX * rows_total,
          f"too many near-tie rows ({spec.scorer})")


# -- phase 5 -----------------------------------------------------------------


def one_kernel(fn, symbol: str, label: str) -> None:
    """Check under the profiler that one ``fn`` call runs ``symbol`` once
    and nothing else on the card, so a per-launch time matched on the
    symbol times what the path runs."""
    ran = kernels_of_one_call(fn)
    if not ran:
        counted_launches(fn, label)
        return
    print(f"  {label} runs: {[name[:90] for name in ran]}")
    check(len(ran) == 1 and symbol in ran[0], f"{label} did not run {symbol} exactly once")


def counted_launches(fn, label: str) -> None:
    """Where the profiler lost every window of :func:`kernels_of_one_call`:
    the wrappers' launch counts stand in, and one ``fn`` call must add
    exactly one launch over all of them."""
    from repro_torch.kernels import ops

    before = sum(ops.launch_counts().values())
    fn()
    torch.cuda.synchronize()
    n = sum(ops.launch_counts().values()) - before
    print(f"  {label}: the profiler recorded none of its kernels in any window; the "
          f"wrappers' launch counts stand in: {n} launch a call")
    check(n == 1, f"{label} launched {n} kernels of the port a call, not 1")


def time_pair_kernel(base, q, gen, errs: dict, launches: dict, pair_calls: dict) -> dict:
    """gather_distance's pair kernel and the generic kernel, each per
    recorded launch in the same run, at four shapes: the rerank (64 queries
    x 64 fresh random ids a launch, as beam_search._finalize and pq_search
    issue it) and the calls phase 4b recorded on the hierarchy path, cycled
    in order: a descent step (Q=64 x R=M, its finished rows' slots
    INVALID), a layer start (Q=64 x R=1) and the hubs scan (Q=64 x R=32).
    The bound counts what each shape's data needs: every query row, id and
    output once, each distinct valid row once, 3d flops a valid pair. The
    kernels-line row keeps the rerank's numbers and lists every shape."""
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import ref

    n, d = base.shape
    Q, R = 64, 64
    calls = {"rerank": [(q, torch.randint(0, n, (Q, R), generator=gen, device=base.device,
                                           dtype=torch.int32)) for _ in range(64)],
             **pair_calls}
    shapes = []
    for label, cs in calls.items():
        it = iter(range(10**9))

        def pick():
            return cs[next(it) % len(cs)]

        def pair():
            return kgd.gather_distance(*pick(), base)

        def generic():
            return kgd.gather_distance_generic(*pick(), base)

        def plain():
            return ref.gather_distance_ref(*pick(), base)
        Qs, Rs = cs[0][1].shape
        one_kernel(pair, PAIR_KERNEL, f"gather_distance at the {label}")
        k_ms = device_ms(pair, reps=640, match=PAIR_KERNEL, launches=1)
        g_ms = device_ms(generic, reps=640, match=GENERIC_GATHER_KERNEL, launches=1)
        call_ms = cuda_ms(pair, reps=640)
        p_ms = device_ms(plain, reps=64)
        valid = sum(float(ids.ge(0).sum()) for _, ids in cs) / len(cs)
        uniq = sum(float(torch.unique(ids[ids >= 0]).numel()) for _, ids in cs) / len(cs)
        nbytes = Qs * d * 4 + Qs * Rs * 4 + uniq * 4 * d + Qs * Rs * 4
        b_ms, b_by = bound(nbytes, valid * 3 * d)
        shapes.append(dict(shape=label, Q=Qs, R=Rs, calls=len(cs),
                           padded_share=1.0 - valid / (Qs * Rs), distinct_rows=uniq, ms=k_ms,
                           generic_ms=g_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           call_ms=call_ms))
        print(f"  gather_distance {label} Q={Qs} R={Rs} d={d} ({len(cs)} id sets, "
              f"{100 * (1 - valid / (Qs * Rs)):.1f}% padding, {uniq:.1f} distinct rows a "
              f"launch): {PAIR_KERNEL} {k_ms * 1e3:.3f} us on the device per recorded "
              f"launch, the generic kernel {g_ms * 1e3:.3f} us in the same run "
              f"({g_ms / k_ms:.2f}x); {call_ms:.4f} ms a call back to back; plain "
              f"{p_ms:.4f} ms; bound {b_ms * 1e3:.4f} us ({b_by}, {nbytes / 1e6:.4f} MB)")
    rr = shapes[0]
    return dict(name="gather_distance", route="cuda",
                source="src/repro_torch/kernels/csrc/gather_distance.cu",
                replaces="src/repro/kernels/gather_distance.py:176",
                launches=launches["gather_distance"], max_abs_err=errs["gather_distance"],
                ms=rr["ms"], plain_ms=rr["plain_ms"], bound_ms=rr["bound_ms"],
                bound_by=rr["bound_by"], library_ms=None, kernel=PAIR_KERNEL,
                yardstick=dict(kernel=GENERIC_GATHER_KERNEL, ms=rr["generic_ms"]),
                shapes=shapes)


def pool_pass_ms(base, pool) -> tuple[float, str, int]:
    """(device ms of one ``gather_distance_pool`` pass, its route, its
    launches): the staged plan's four kernels each per recorded launch and
    summed, or the direct kernel's one launch a call timed with CUDA events
    (100-300 ms a launch at these shapes, so the host's launch gap is lost
    in it; the profiler kept as few as 1 of 3 such launches, and once
    none)."""
    from repro_torch.kernels import gather_distance_pool as kgp
    from repro_torch.kernels import ops

    n, d = base.shape
    plan = kgp.pool_plan(n, d, pool.shape[1],
                         torch.cuda.get_device_properties(base.device).L2_cache_size)
    if plan is None:
        return cuda_ms(lambda: ops.gather_distance_pool(base, pool), reps=3, warmup=1), \
            "direct", 1
    calls = len(plan.calls())
    by_kernel = device_ms_by_kernel(
        lambda: ops.gather_distance_pool(base, pool), reps=3, match="gather_distance_pool_",
        launches={k: calls for k in ("hist", "scan", "scatter", "score")})
    return sum(by_kernel.values()), "staged", kgp.KERNELS_A_CALL * calls


def time_paper_shapes(inputs: list, rows: list) -> None:
    """The paper worlds' shapes, each per recorded launch, into the rows'
    ``shapes``: the NN-Descent pass at each world's (n, d) on a uniform pool
    of C=240 (the generic gather kernel beside it, 1024 rows a launch); a
    hop of 1,000 queries x R=20 uniform random ids (where a GD graph's rows
    of random vertices land in a 1M-10M base; the generic masked kernel
    beside it); the forest rerank (the pair kernel at R = 12 x leaf_cap,
    beside the generic kernel); the ground-truth scan of 1,000 queries.
    Bounds as in the rows: each byte once, 3d flops a valid pair (2d + 3 a
    matrix entry)."""
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import ops

    by_name = {r["name"]: r for r in rows}
    for w in inputs:
        base, q = w["base"], w["queries"]
        n, d = base.shape
        dev = base.device
        gen = torch.Generator(device=dev).manual_seed(7)
        label = f"{w['name']} (n={n}, d={d})"

        # the NN-Descent scoring pass
        C = 240
        pool = uniform_pool(n, C, 6)
        k_ms, route, n_launch = pool_pass_ms(base, pool)
        g_ms = device_ms(lambda: gather_kernel_pass(base, pool), reps=1,
                         match=GENERIC_GATHER_KERNEL, launches=-(-n // 1024))
        n_valid = float(pool.ge(0).sum())
        b_ms, b_by = bound(n * d * 4 + 2 * n * C * 4, n_valid * 3 * d)
        by_name["gather_distance_pool"].setdefault("shapes", []).append(dict(
            shape=f"NN-Descent pass, {label}, C={C}, uniform pool", route=route,
            launches=n_launch, ms=k_ms, generic_ms=g_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"  gather_distance_pool pass {label} C={C} ({route}, {n_launch} launches): "
              f"{k_ms:.3f} ms {'on the device' if route == 'staged' else 'a call (CUDA events)'}"
              f", the generic gather kernel {g_ms:.3f} ms "
              f"({g_ms / k_ms:.2f}x); bound {b_ms:.3f} ms ({b_by})")
        del pool
        torch.cuda.empty_cache()

        # the beam's hop at the paper's batch: 1,000 queries x R=20
        Q, R = q.shape[0], 20
        sets = [torch.randint(0, n, (Q, R), generator=gen, device=dev, dtype=torch.int32)
                for _ in range(16)]
        visited = torch.zeros((Q, (n + 31) // 32), dtype=torch.int32, device=dev)
        it = iter(range(10**9))

        def hop():
            return ops.gather_distance_masked(q, sets[next(it) % 16], base, visited)

        def hop_generic():
            return kgd.gather_distance_masked_generic(q, sets[next(it) % 16], base, visited)
        k_ms = device_ms(hop, reps=64, match=HOP_KERNEL, launches=1)
        g_ms = device_ms(hop_generic, reps=64, match=GENERIC_GATHER_KERNEL, launches=1)
        hop_bytes = Q * d * 4 + Q * R * 4 + Q * R * (4 * d + 4) + Q * R * 8
        b_ms, b_by = bound(hop_bytes, Q * R * 3 * d)
        by_name["gather_distance_masked"].setdefault("shapes", []).append(dict(
            shape=f"hop, {label}, Q={Q} x R={R}", ms=k_ms, generic_ms=g_ms, bound_ms=b_ms,
            bound_by=b_by))
        print(f"  gather_distance_masked hop {label} Q={Q} R={R}: {HOP_KERNEL} "
              f"{k_ms * 1e3:.3f} us per recorded launch, the generic masked kernel "
              f"{g_ms * 1e3:.3f} us ({g_ms / k_ms:.2f}x); bound {b_ms * 1e3:.3f} us ({b_by})")
        del visited, sets

        # the forest rerank at its real R
        if "rerank" in w:
            cand = w["rerank"]
            Qr, Rr = cand.shape
            k_ms = device_ms(lambda: kgd.gather_distance(q, cand, base), reps=20,
                             match=PAIR_KERNEL, launches=1)
            g_ms = device_ms(lambda: kgd.gather_distance_generic(q, cand, base), reps=20,
                             match=GENERIC_GATHER_KERNEL, launches=1)
            valid = float(cand.ge(0).sum())
            uniq = float(torch.unique(cand[cand >= 0]).numel())
            nbytes = Qr * d * 4 + Qr * Rr * 4 + uniq * 4 * d + Qr * Rr * 4
            b_ms, b_by = bound(nbytes, valid * 3 * d)
            by_name["gather_distance"]["shapes"].append(dict(
                shape=f"forest rerank, {label}", Q=Qr, R=Rr, padded_share=1 - valid / (Qr * Rr),
                distinct_rows=uniq, ms=k_ms, generic_ms=g_ms, bound_ms=b_ms, bound_by=b_by))
            print(f"  gather_distance forest rerank {label} Q={Qr} R={Rr} "
                  f"({100 * (1 - valid / (Qr * Rr)):.1f}% padding, {uniq:.0f} distinct rows): "
                  f"{PAIR_KERNEL} {k_ms:.4f} ms per recorded launch, the generic kernel "
                  f"{g_ms:.4f} ms ({g_ms / k_ms:.2f}x); bound {b_ms:.4f} ms ({b_by})")

        # the ground-truth scan: 1,000 queries in 16384-row chunks
        chunks = [base[lo:lo + 16384] for lo in range(0, n, 16384)]
        k_ms = device_ms(lambda: [ops.distance_matrix(q, c) for c in chunks], reps=1,
                         match=MATRIX_KERNEL, launches=len(chunks))
        nq = q.shape[0]
        b_ms, b_by = bound(nq * d * 4 + n * d * 4 + nq * n * 4, 2.0 * nq * n * d + 3.0 * nq * n)
        by_name["distance_matrix"].setdefault("shapes", []).append(dict(
            shape=f"ground truth, {label}, {nq} queries", launches=len(chunks), ms=k_ms,
            bound_ms=b_ms, bound_by=b_by))
        print(f"  distance_matrix ground truth {label} {nq} queries ({len(chunks)} launches): "
              f"{k_ms:.3f} ms per recorded launch x {len(chunks)}, bound {b_ms:.3f} ms ({b_by}; "
              f"{k_ms / b_ms:.2f}x)")


def time_kernels(run, errs: dict, launches: dict, pair_calls: dict) -> list[dict]:
    from repro_torch.core.nndescent import NNDescentConfig
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = run.searcher
    base, nbrs = s.base, s.neighbors
    n, d = base.shape
    dev = base.device
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []

    # gather_distance_masked at the hop shape: neighbor rows of 64 vertices,
    # a fresh id set per launch so the gathered rows are not L2-resident
    Q, R = 64, nbrs.shape[1]
    q = run.stream[0]
    sets = [nbrs[torch.randint(0, n, (Q,), generator=gen, device=dev)].contiguous()
            for _ in range(64)]
    visited = torch.zeros((Q, (n + 31) // 32), dtype=torch.int32, device=dev)
    it = iter(range(10**9))

    def hop():
        return ops.gather_distance_masked(q, sets[next(it) % 64], base, visited)

    def hop_generic():
        return kgd.gather_distance_masked_generic(q, sets[next(it) % 64], base, visited)

    def hop_plain():
        return ref.gather_distance_masked_ref(q, sets[next(it) % 64], base, visited)
    one_kernel(hop, HOP_KERNEL, "a hop")
    k_ms = device_ms(hop, reps=640, match=HOP_KERNEL, launches=1)
    g_ms = device_ms(hop_generic, reps=640, match=GENERIC_GATHER_KERNEL, launches=1)
    call_ms = cuda_ms(hop, reps=640)
    p_ms = device_ms(hop_plain, reps=64)
    valid = float(torch.stack(sets).ge(0).sum()) / len(sets)
    hop_bytes = Q * d * 4 + Q * R * 4 + valid * (4 * d + 4) + Q * R * 8
    b_ms, b_by = bound(hop_bytes, valid * 3 * d)
    rows.append(dict(name="gather_distance_masked", route="cuda",
                     source="src/repro_torch/kernels/csrc/gather_distance.cu",
                     replaces="src/repro/kernels/gather_distance.py:230",
                     launches=launches["gather_distance_masked"],
                     max_abs_err=errs["gather_distance_masked"], ms=k_ms,
                     plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     kernel=HOP_KERNEL, yardstick=dict(kernel=GENERIC_GATHER_KERNEL, ms=g_ms)))
    print(f"  gather_distance_masked hop Q=64 R={R} d={d} ({valid:.1f} valid ids a hop): "
          f"{HOP_KERNEL} {k_ms * 1e3:.3f} us on the device per recorded launch, the generic "
          f"masked kernel {g_ms * 1e3:.3f} us in the same run ({g_ms / k_ms:.2f}x); "
          f"{call_ms:.4f} ms a call back to back, host-bound; plain {p_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}, {hop_bytes / 1e6:.3f} MB)")

    # gather_distance_pool over one NN-Descent scoring pass (n x C=240), on
    # the uniform stand-in pool and on a real pool, beside the generic
    # gather kernel (1024 rows a launch) on the same pools
    from repro_torch.kernels import gather_distance_pool as kgp

    C = 240
    chunk = NNDescentConfig().chunk
    plan = kgp.pool_plan(n, d, C, torch.cuda.get_device_properties(dev).L2_cache_size)
    check(plan is not None, "the NN-Descent pass shape is not staged")
    pools = {"uniform": uniform_pool(n, C, 5), "real": real_pool(base)}
    before = kgp.LAUNCHES["gather_distance_pool"]
    ops.gather_distance_pool(base, pools["uniform"])
    pass_launches = kgp.LAUNCHES["gather_distance_pool"] - before
    calls = len(plan.calls())
    check(pass_launches == kgp.KERNELS_A_CALL * calls,
          f"{pass_launches} launches a pass, not {kgp.KERNELS_A_CALL} x {calls}")
    old_launches = -(-n // chunk)
    print(f"  NN-Descent pass plan: {plan}; {pass_launches} launches a pass "
          f"({calls} calls of hist, scan, scatter, score)")
    pass_row = None
    for label, pool in pools.items():
        by_kernel = device_ms_by_kernel(
            lambda: ops.gather_distance_pool(base, pool), reps=3,
            match="gather_distance_pool_",
            launches={k: calls for k in ("hist", "scan", "scatter", "score")})
        k_ms = sum(by_kernel.values())
        print(f"  gather_distance_pool pass by kernel, {label} pool (ms a pass, each per "
              f"recorded launch of {calls}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items()))
        call_ms = cuda_ms(lambda: ops.gather_distance_pool(base, pool), reps=3, warmup=1)
        o_ms = device_ms(lambda: gather_kernel_pass(base, pool), reps=3,
                         match=GENERIC_GATHER_KERNEL, launches=old_launches)
        o_call = cuda_ms(lambda: gather_kernel_pass(base, pool), reps=3, warmup=1)
        n_valid = float(pool.ge(0).sum())
        # the queries are base rows, so the base is read once; then the ids in
        # and the distances out
        pass_bytes = n * d * 4 + 2 * n * C * 4
        b_ms, b_by = bound(pass_bytes, n_valid * 3 * d)
        # what the design moves through HBM: each window stages the buckets
        # it touches, the pool is read twice, the entries written and read
        # once, the distances written once, the query rows read once
        staged = 0.0
        for w in range(plan.n_windows):
            ids = pool[w * plan.window:(w + 1) * plan.window]
            ids = ids[ids >= 0].clamp(max=n - 1) >> plan.log_rows
            staged += float(torch.unique(ids).numel()) * (1 << plan.log_rows) * d * 4
        design = staged + 2 * n * C * 4 + 2 * n_valid * 4 + n * C * 4 + n * d * 4
        print(f"  gather_distance_pool NN-Descent pass, {label} pool n={n} C={C} d={d} "
              f"({n_valid / (n * C):.3f} valid): kernel {k_ms:.3f} ms on the device over "
              f"{pass_launches} launches ({call_ms:.3f} ms CUDA-event wall); the generic "
              f"gather kernel {o_ms:.3f} ms over {old_launches} launches ({o_call:.3f} ms wall), "
              f"{o_ms / k_ms:.2f}x; bound {b_ms:.3f} ms ({b_by}); the design moves "
              f"{design / 1e9:.2f} GB through HBM ({staged / 1e9:.2f} GB of staged buckets), "
              f"{design / k_ms / 1e6:.0f} GB/s; rows read a pair {n_valid * 4 * d / 1e9:.1f} GB")
        if label == "uniform":
            def plain_pass():
                ref.gather_distance_pool_ref(base, pool, "l2", chunk)
            p_ms = device_ms(plain_pass, reps=1)
            pass_row = dict(name="gather_distance_pool", route="cuda",
                            source="src/repro_torch/kernels/csrc/gather_distance_pool.cu",
                            replaces="src/repro/kernels/gather_distance.py:176",
                            launches=launches["gather_distance_pool"],
                            max_abs_err=errs["gather_distance_pool"], ms=k_ms,
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            kernel="gather_distance_pool_{hist,scan,scatter,score}_kernel",
                            yardstick=dict(kernel=GENERIC_GATHER_KERNEL, ms=o_ms))
            print(f"  gather_distance_pool plain version, uniform pool: {p_ms:.3f} ms")
    rows.append(pass_row)
    del pools

    # gather_distance (the pair kernel beside the generic one) at the
    # rerank shape and the hierarchy path's shapes from phase 4b
    rows.append(time_pair_kernel(base, q, gen, errs, launches, pair_calls))

    # distance_matrix over the ground-truth scan: 512 queries x 1M in
    # 16384-row chunks, as exact_search issues them
    qs = torch.cat(run.stream)
    gt_chunk = 16384
    chunks = [base[lo:lo + gt_chunk] for lo in range(0, n, gt_chunk)]

    def scan(fn):
        return lambda: [fn(c) for c in chunks]
    one_kernel(lambda: ops.distance_matrix(qs, chunks[0]), MATRIX_KERNEL, "a ground-truth chunk")
    k_ms = device_ms(scan(lambda c: ops.distance_matrix(qs, c)), reps=3,
                     match=MATRIX_KERNEL, launches=len(chunks))
    p_ms = device_ms(scan(lambda c: ref.distance_matrix_ref(qs, c)), reps=3)
    l_ms = device_ms(scan(lambda c: torch.cdist(qs, c) ** 2), reps=3)
    nq = qs.shape[0]
    gt_bytes = nq * d * 4 + n * d * 4 + nq * n * 4
    b_ms, b_by = bound(gt_bytes, 2.0 * nq * n * d + 3.0 * nq * n)
    rows.append(dict(name="distance_matrix", route="cuda",
                     source="src/repro_torch/kernels/csrc/distance_matrix.cu",
                     replaces="src/repro/kernels/distance_matrix.py:62",
                     launches=launches["distance_matrix"],
                     max_abs_err=errs["distance_matrix"], ms=k_ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=l_ms, kernel=MATRIX_KERNEL,
                     yardstick=None))
    print(f"  distance_matrix ground truth {nq} x {n} x {d} ({len(chunks)} launches): "
          f"{MATRIX_KERNEL} {k_ms:.3f} ms per recorded launch x {len(chunks)} "
          f"({2.0 * nq * n * d / k_ms / 1e9:.1f} TFLOP/s, {k_ms / b_ms:.2f}x its bound), "
          f"plain {p_ms:.3f} ms, cdist**2 {l_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
          f"bytes {gt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")

    # what bounds the 128 tile: its FMA rate where the per-tile costs
    # (first loads, 64 KB of stores a tile) are spread over 128 k-steps, not
    # 8, beside PyTorch's fp32 product (TF32 off) at both widths
    mm_ms = device_ms(scan(lambda c: qs @ c.T), reps=3)
    wide = 1024
    xw = torch.randn((nq, wide), generator=gen, device=dev)
    yw = torch.randn((gt_chunk, wide), generator=gen, device=dev)
    w_ms = device_ms(lambda: ops.distance_matrix(xw, yw), reps=10, match=MATRIX_KERNEL,
                     launches=1)
    wmm_ms = device_ms(lambda: xw @ yw.T, reps=10)
    w_flops = 2.0 * nq * gt_chunk * wide
    print(f"  what bounds {MATRIX_KERNEL}: the product alone through torch.mm (fp32, TF32 "
          f"off) over the same scan {mm_ms:.3f} ms ({2.0 * nq * n * d / mm_ms / 1e9:.1f} "
          f"TFLOP/s); one {nq} x {gt_chunk} x {wide} launch {w_ms:.3f} ms "
          f"({w_flops / w_ms / 1e9:.1f} TFLOP/s, {w_flops / w_ms / 1e9 / FP32_FLOP_PER_S * 1e12:.0%} "
          f"of the fp32 peak), torch.mm {wmm_ms:.3f} ms ({w_flops / wmm_ms / 1e9:.1f} TFLOP/s)")
    del xw, yw

    # distance_matrix at the GD shape: one 65536-vertex block of (20, 20)
    # matrices over gathered candidate rows (x is y, as gd_prune calls it),
    # the small route beside the 32 x 32 tile
    from repro_torch.kernels import distance_matrix as kdm

    L = nbrs.shape[1]
    cand = nbrs[:65536].clamp(min=0).long()
    rows_g = base[cand]
    one_kernel(lambda: ops.distance_matrix(rows_g, rows_g), SMALL_MATRIX_KERNEL, "a GD block")
    k_ms = device_ms(lambda: ops.distance_matrix(rows_g, rows_g), reps=20,
                     match=SMALL_MATRIX_KERNEL, launches=1)
    t_ms = device_ms(lambda: kdm.distance_matrix_tile32(rows_g, rows_g), reps=20,
                     match=TILE32_MATRIX_KERNEL, launches=1)
    call_ms = cuda_ms(lambda: ops.distance_matrix(rows_g, rows_g), reps=20)
    p_ms = device_ms(lambda: ref.distance_matrix_ref(rows_g, rows_g), reps=20)
    l_ms = device_ms(lambda: torch.cdist(rows_g, rows_g) ** 2, reps=20)
    B = rows_g.shape[0]
    gd_bytes = B * L * d * 4 + B * L * L * 4   # x is y: rows in once, matrices out
    b_ms2, b_by2 = bound(gd_bytes, 2.0 * B * L * L * d + 3.0 * B * L * L)
    rows.append(dict(name="distance_matrix_small", route="cuda",
                     source="src/repro_torch/kernels/csrc/distance_matrix.cu",
                     replaces="src/repro/kernels/distance_matrix.py:62",
                     launches=launches["distance_matrix_small"],
                     max_abs_err=errs["distance_matrix_small"], ms=k_ms, plain_ms=p_ms,
                     bound_ms=b_ms2, bound_by=b_by2, library_ms=l_ms,
                     kernel=SMALL_MATRIX_KERNEL,
                     yardstick=dict(kernel=TILE32_MATRIX_KERNEL, ms=t_ms)))
    print(f"  distance_matrix GD block {B} x {L} x {L} x {d}: {SMALL_MATRIX_KERNEL} "
          f"{k_ms:.4f} ms per recorded launch ({call_ms:.4f} ms a call back to back; "
          f"{gd_bytes / k_ms / 1e9:.2f} TB/s, {k_ms / b_ms2:.2f}x its bound), the 32 x 32 "
          f"tile {t_ms:.4f} ms in the same run ({t_ms / k_ms:.2f}x); plain {p_ms:.4f} ms, "
          f"cdist**2 {l_ms:.4f} ms, bound {b_ms2:.4f} ms ({b_by2}); a full 1M pass is "
          f"{n / B:.2f} such blocks")
    return rows


def time_compressed_kernels(run, errs: dict, launches: dict, exact_hop_ms: float) -> list[dict]:
    """gather_sq8_masked and gather_adc_masked at one hop, each beside its
    generic kernel, and the launch floor beside them and the exact hop
    (``exact_hop_ms``, timed by time_kernels); pq_adc over one pq_search pass
    beside its generic kernel and ``embedding_bag``. No single PyTorch call
    computes a masked hop (the codes gather and the visited mask come
    first), so their ``library_ms`` is null."""
    import torch.nn.functional as F

    from repro_torch.baselines.pq import build_adc_luts
    from repro_torch.kernels import gather_adc as kga
    from repro_torch.kernels import gather_sq8 as kgs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pq_adc as kpa

    s = run.searcher
    nbrs = s.neighbors
    n, d = s.base.shape
    dev = s.base.device
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []

    # the hops: neighbor rows of 64 vertices, a fresh id set per launch
    Q, R = 64, nbrs.shape[1]
    q = run.stream[0]
    sets = [nbrs[torch.randint(0, n, (Q,), generator=gen, device=dev)].contiguous()
            for _ in range(64)]
    valid = float(torch.stack(sets).ge(0).sum()) / len(sets)
    visited = torch.zeros((Q, (n + 31) // 32), dtype=torch.int32, device=dev)
    it = iter(range(10**9))
    sq = tuple(s.sq8_index())
    idx = s.pq_index(run.spec)
    M, K = idx.M, idx.K
    luts = build_adc_luts(q, idx.codebooks).contiguous()

    def lut_entries(ids):  # distinct (query, m, code) entries a hop reads
        ok = ids >= 0
        rows = torch.arange(Q, device=dev).unsqueeze(1).expand_as(ids)[ok]
        codes = idx.codes[ids[ok].long()].long()
        keys = (rows.unsqueeze(1) * M + torch.arange(M, device=dev)) * K + codes
        return torch.unique(keys).numel()
    entries = sum(lut_entries(ids) for ids in sets) / len(sets)
    hops = [  # name, kernel, plain, symbol, generic, generic symbol, bytes, flops, replaces, source
        ("gather_sq8_masked",
         lambda ids: ops.gather_sq8_masked(q, ids, *sq, visited),
         lambda ids: ref.gather_sq8_masked_ref(q, ids, *sq, visited),
         SQ8_HOP_KERNEL,
         lambda ids: kgs.gather_sq8_masked_generic(q, ids, *sq, visited), GENERIC_SQ8_KERNEL,
         # queries, scale + mn, ids in; one d-byte row and one visited word
         # per valid id; dists and ids out
         Q * d * 4 + 2 * d * 4 + Q * R * 4 + valid * (d + 4) + Q * R * 8,
         valid * 4 * d, "src/repro/kernels/gather_sq8.py:116", "gather_sq8.cu"),
        ("gather_adc_masked",
         lambda ids: ops.gather_adc_masked(ids, idx.codes, luts, visited),
         lambda ids: ref.gather_adc_masked_ref(ids, idx.codes, luts, visited),
         ADC_HOP_KERNEL,
         lambda ids: kga.gather_adc_masked_generic(ids, idx.codes, luts, visited),
         GENERIC_ADC_KERNEL,
         # ids in; one M-byte row and one visited word per valid id; the
         # distinct LUT entries those rows index, 4 B each (not whole LUTs:
         # a hop reads at most 160 of a query's 2,048); dists and ids out
         Q * R * 4 + valid * (M + 4) + entries * 4 + Q * R * 8,
         valid * M, "src/repro/kernels/gather_adc.py:119", "gather_adc.cu"),
    ]
    # the launch floor: the device time of a one-element fill, per recorded launch
    one = torch.empty(1, device=dev)
    floor_ms = device_ms(lambda: one.fill_(1.0), reps=640, match="FillFunctor", launches=1)
    hop_ms = {"gather_distance_masked": exact_hop_ms}
    for name, kern, plain, match, generic, g_match, nbytes, flops, replaces, src in hops:
        one_kernel(lambda: kern(sets[0]), match, f"a {name} hop")
        k_ms = device_ms(lambda: kern(sets[next(it) % 64]), reps=640, match=match, launches=1)
        g_ms = device_ms(lambda: generic(sets[next(it) % 64]), reps=640, match=g_match,
                         launches=1)
        hop_ms[name] = k_ms
        line = (f"  {name} hop: {match} {k_ms * 1e3:.3f} us per recorded launch, the "
                f"generic kernel {g_ms * 1e3:.3f} us in the same run ({g_ms / k_ms:.2f}x)")
        print(line)
        call_ms = cuda_ms(lambda: kern(sets[next(it) % 64]), reps=640)
        p_ms = device_ms(lambda: plain(sets[next(it) % 64]), reps=64)
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(name=name, route="cuda",
                         source=f"src/repro_torch/kernels/csrc/{src}",
                         replaces=replaces, launches=launches[name],
                         max_abs_err=errs[name], ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None, kernel=match,
                         yardstick=dict(kernel=g_match, ms=g_ms)))
        print(f"  {name} hop Q={Q} R={R} d={d} M={M}: kernel {k_ms:.4f} ms on the "
              f"device per recorded launch ({call_ms:.4f} ms a call back to back, "
              f"host-bound), plain "
              f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.3f} MB)")
    print(f"  gather_adc_masked hop reads {entries:.1f} distinct LUT entries of "
          f"{Q * M * K}: {entries * 4 / 1e3:.2f} KB at 4 B each, "
          f"{entries * 32 / 1e3:.2f} KB at 32-byte sectors (bound counts 4 B)")
    print(f"  launch floor (a one-element fill_, device time per recorded launch): "
          f"{floor_ms * 1e3:.3f} us; the hops: "
          + ", ".join(f"{k} {v * 1e3:.3f} us ({(v - floor_ms) * 1e3:.3f} above it)"
                      for k, v in hop_ms.items()))

    # pq_adc over one pq_search pass: 512 queries in 64-row launches, the
    # interleaved kernel beside the generic one in the same run
    qs = torch.cat(run.stream)
    all_luts = build_adc_luts(qs, idx.codebooks).contiguous()
    chunks = [all_luts[lo:lo + 64] for lo in range(0, qs.shape[0], 64)]
    nl = len(chunks)
    one_kernel(lambda: ops.pq_adc(idx.codes, chunks[0]), SCAN_KERNEL, "a pq_adc chunk")

    def scan(fn, codes=idx.codes):
        return lambda: [fn(codes, c) for c in chunks]
    k_ms = device_ms(scan(ops.pq_adc), reps=3, match=SCAN_KERNEL, launches=nl)
    g_ms = device_ms(scan(kpa.pq_adc_generic), reps=3, match=GENERIC_SCAN_KERNEL, launches=nl)
    call_ms = cuda_ms(scan(ops.pq_adc), reps=3)
    # what bounds each kernel: the same pass on a code table whose rows are
    # all equal, where every lookup of the generic kernel's warp is a
    # broadcast (one wavefront) and the interleaved kernel's is as before
    same = idx.codes[:1].expand(n, M).contiguous()
    ke_ms = device_ms(scan(ops.pq_adc, same), reps=3, match=SCAN_KERNEL, launches=nl)
    ge_ms = device_ms(scan(kpa.pq_adc_generic, same), reps=3, match=GENERIC_SCAN_KERNEL,
                      launches=nl)
    del same
    # the write floor: a pass's 2.05 GB of scores written by fill_ alone
    outs = [torch.empty((c.shape[0], n), device=dev) for c in chunks]
    w_ms = device_ms(lambda: [o.fill_(1.0) for o in outs], reps=3, match="FillFunctor",
                     launches=nl)
    del outs
    p_ms = device_ms(scan(ref.pq_adc_ref), reps=1)
    # the library call: embedding_bag sums rows codes[i, m] + m * K of the
    # LUTs laid out (M * K, 64); idx and the layouts are made outside the
    # timed window, and its (n, 64) output is pq_adc's transposed
    bag_idx = idx.codes.long() + torch.arange(M, device=dev) * K
    bag_w = [c.reshape(c.shape[0], M * K).T.contiguous() for c in chunks]

    def bags():
        return [F.embedding_bag(bag_idx, w, mode="sum") for w in bag_w]
    l_ms = device_ms(bags, reps=3)
    l_call = cuda_ms(bags, reps=3)
    bag0 = F.embedding_bag(bag_idx, bag_w[0], mode="sum").T
    want0 = ref.pq_adc_ref(idx.codes, chunks[0])
    print(f"  embedding_bag (mode sum) on chunk 0: its transposed output "
          f"{'equals' if torch.equal(bag0, want0) else 'differs from'} the plain version bit "
          f"for bit (max abs difference {max_abs_err(bag0, want0):.3g})")
    del bag_idx, bag_w, bag0, want0
    nq = qs.shape[0]
    pass_bytes = n * M + nq * M * K * 4 + nq * n * 4   # codes, LUTs in; scores out
    b_ms, b_by = bound(pass_bytes, nq * n * M)
    rows.append(dict(name="pq_adc", route="cuda",
                     source="src/repro_torch/kernels/csrc/pq_adc.cu",
                     replaces="src/repro/kernels/pq_adc.py:41",
                     launches=launches["pq_adc"], max_abs_err=errs["pq_adc"],
                     ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=l_ms, kernel=SCAN_KERNEL, ms_per_launch=k_ms / nl,
                     yardstick=dict(kernel=GENERIC_SCAN_KERNEL, ms=g_ms)))
    print(f"  pq_adc pq_search pass {nq} x {n} x M={M} ({nl} launches of 64): "
          f"{SCAN_KERNEL} {k_ms:.4f} ms a pass on the device ({k_ms / nl:.4f} ms per recorded "
          f"launch; {call_ms:.4f} ms wall; {nq * n * 4 / k_ms / 1e9:.2f} TB/s of scores, "
          f"{k_ms / b_ms:.2f}x its bound), the generic kernel {g_ms:.4f} ms a pass "
          f"({g_ms / nl:.4f} a launch; {g_ms / k_ms:.2f}x) in the same run; embedding_bag "
          f"{l_ms:.4f} ms a pass on the device ({l_call:.4f} ms wall); plain {p_ms:.3f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}, {pass_bytes / 1e9:.3f} GB once)")
    print(f"  pq_adc on a table of equal rows (every generic lookup a broadcast): "
          f"{SCAN_KERNEL} {ke_ms:.4f} ms a pass ({ke_ms / k_ms:.3f}x its uniform-code time), "
          f"the generic kernel {ge_ms:.4f} ms ({ge_ms / g_ms:.3f}x); the pass's scores "
          f"written by fill_ alone {w_ms:.4f} ms ({nq * n * 4 / w_ms / 1e9:.2f} TB/s)")
    return rows


def hgmma_count(symbol: str) -> dict[str, int]:
    """HGMMA instructions in each compiled instance of ``symbol`` in the
    built flash_attention library (``cuobjdump -sass``)."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(maxsplit=1)[0]
        if symbol in name:   # ..._kernelILi64ELi128EE... -> "<64, 128>"
            dims = re.search(r"kernelILi(\d+)ELi(\d+)E", name)
            counts[f"<{dims[1]}, {dims[2]}>" if dims else name] = section.count("HGMMA")
    return counts


def _sdpa(q, k, v, scale=None):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True, scale=scale).transpose(1, 2)


def _attention_flops(B, S, Hq, dh, window=None, dhv=None):
    """QK^T (dh) and PV (dhv, dh where not given) over the visible (q, k)
    pairs of a causal layer (the last ``window`` keys of each query where
    one is given)."""
    pairs = S * (S + 1) / 2 if window is None else sum(min(q + 1, window) for q in range(S))
    return 2.0 * B * Hq * pairs * (dh + (dh if dhv is None else dhv))


def _sdpa_layer(q, k, v, window=None, scale=None):
    """:func:`_sdpa`, or :func:`_sdpa_window` where there is a window."""
    return _sdpa(q, k, v, scale) if window is None else _sdpa_window(q, k, v, window, scale)


def _sdpa_window(q, k, v, window, scale=None):
    """scaled_dot_product_attention with the causal window as a boolean mask."""
    import torch.nn.functional as F

    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True, scale=scale).transpose(1, 2)


def time_gemma3_layer(g) -> list[dict]:
    """flash_attention at one Gemma3-12B prefill layer (B=8, S=2048, 16/8,
    dh=256, bf16): the global layer (causal) and a local one (window 1024),
    each per recorded launch beside its plain version (the whole batch at
    once) and scaled_dot_product_attention (the local one with the window
    as a boolean mask); the 256-thread, 64-key-stage instantiation."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    symbol = "flash_attention_wgmma_kernel"
    B, S, Hq, Hkv, dh = 8, 2048, 16, 8, 256
    q = torch.randn((B, S, Hq, dh), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(torch.bfloat16)
    shapes = []
    for label, window in (("global", None), ("local, window 1024", 1024)):
        def lib():
            return _sdpa_layer(q, k, v, window)
        k_ms = device_ms(lambda: ops.flash_attention(q, k, v, window=window), reps=10,
                         match=symbol, launches=1)
        call_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, window=window), reps=10)
        p_ms = device_ms(lambda: ref.flash_attention_ref(q, k, v, window=window), reps=2)
        l_ms = cuda_ms(lib, reps=10)
        lib_err = max_abs_err(lib().float(), ops.flash_attention(q, k, v, window=window).float())
        flops = _attention_flops(B, S, Hq, dh, window)
        nbytes = 2.0 * (2 * B * S * Hq * dh + 2 * B * S * Hkv * dh)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        print(f"  flash_attention Gemma3 {label} layer B={B} S={S} {Hq}/{Hkv} dh={dh} bf16 "
              f"causal: kernel {k_ms:.4f} ms on the device ({call_ms:.4f} ms a call back to "
              f"back; {flops / k_ms / 1e9:.1f} TFLOP/s of visible-pair flops), plain "
              f"{p_ms:.3f} ms, scaled_dot_product_attention {l_ms:.4f} ms (kernel / SDPA "
              f"{k_ms / l_ms:.2f}x; max abs difference {lib_err:.3g}), bound {b_ms:.4f} ms "
              f"({b_by}: {flops:.3e} flops at the bf16 tensor-core peak; {nbytes / 1e6:.1f} MB)")
        shapes.append(dict(shape=f"Gemma3-12B {label} layer, B={B} x S={S}, {Hq}/{Hkv}, "
                                 f"dh={dh}, bf16", ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                           bound_ms=b_ms, bound_by=b_by))
    return shapes


def time_mla_layer(g, errs: dict) -> dict:
    """flash_attention at one DeepSeek-V3 MLA prefill layer (B=8, S=2048,
    128/128 heads, dh=192, dhv=128, bf16, causal, scale 192 ** -0.5; the K
    operand materialised as the model's is): the `<192, 128>` instantiation
    per recorded launch, held to its plain version within FLASH_TOL, the
    plain version's time (one batch row at a time: the whole batch's fp32
    scores would be 17 GB) and scaled_dot_product_attention's, with the
    kernels SDPA runs (its backend) printed."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    symbol = "flash_attention_wgmma_kernel"
    B, S, H, dh, dhv = 8, 2048, 128, 192, 128
    scale = dh ** -0.5
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, H, dh), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, H, dhv), generator=g, device=dev).to(torch.bfloat16)

    def kern():
        return ops.flash_attention(q, k, v, softmax_scale=scale)

    def plain():
        return plain_flash_attention(q, k, v, True, None, scale)

    def lib():
        return _sdpa(q, k, v, scale)
    got, want = kern(), plain()
    tol = FLASH_TOL[torch.bfloat16]
    err = max_abs_err(got.float(), want.float())
    excess = float(((got.float() - want.float()).abs() - tol["atol"]
                    - tol["rtol"] * want.float().abs()).max())
    apart = float((got != want).float().mean())
    check(excess <= 0.0, "flash_attention outside its tolerance at DeepSeek's MLA layer")
    errs["flash_attention"] = max(errs["flash_attention"], err)
    lib_err = max_abs_err(lib().float(), want.float())
    del got, want
    k_ms = device_ms(kern, reps=10, match=symbol, launches=1)
    call_ms = cuda_ms(kern, reps=10)
    p_ms = device_ms(plain, reps=2)
    l_ms = cuda_ms(lib, reps=10)
    sdpa_kernels = sorted(set(kernels_of_one_call(lib)))
    flops = _attention_flops(B, S, H, dh, dhv=dhv)
    nbytes = 2.0 * (2 * B * S * H * dh + 2 * B * S * H * dhv)   # q, k; v, o
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    print(f"  flash_attention DeepSeek-V3 MLA layer B={B} S={S} {H}/{H} dh={dh} dhv={dhv} "
          f"bf16 causal: kernel {k_ms:.4f} ms on the device ({call_ms:.4f} ms a call back to "
          f"back; {flops / k_ms / 1e9:.1f} TFLOP/s of visible-pair flops), max abs difference "
          f"to the plain version {err:.3g} (largest excess over FLASH_TOL {excess:.3g}; "
          f"{apart:.3%} of outputs apart), plain {p_ms:.3f} ms (one batch row at a time), "
          f"scaled_dot_product_attention {l_ms:.4f} ms (kernel / SDPA {k_ms / l_ms:.2f}x; "
          f"{lib_err:.3g} from the plain version; SDPA runs {sdpa_kernels}), bound "
          f"{b_ms:.4f} ms ({b_by}: {flops:.4e} flops at the bf16 tensor-core peak; "
          f"{nbytes / 1e6:.1f} MB)")
    return dict(shape=f"DeepSeek-V3 MLA prefill layer, B={B} x S={S}, {H}/{H}, dh={dh}, "
                      f"dhv={dhv}, bf16, causal", ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=b_ms, bound_by=b_by, library_kernels=sdpa_kernels)


def time_flash_attention(errs: dict) -> dict:
    """flash_attention at one TinyLlama prefill layer (B=8, S=2048, 32/4,
    dh=64, bf16, causal): the tensor-core kernel (once a call, by its
    symbol; HGMMA in its SASS), its plain version (dense, the whole batch at
    once) and PyTorch's scaled_dot_product_attention; then one layer at the
    reference's prefill_32k shape (B=32, S=32768) beside SDPA, where no plain
    check fits. The row's launches come from phase 6's prefill."""
    from repro_torch.kernels import ops, ref

    symbol = "flash_attention_wgmma_kernel"
    hgmma = hgmma_count(symbol)
    print(f"  HGMMA instructions in the SASS of {symbol}<DH, DV>: {hgmma}")
    check(len(hgmma) == 6 and all(n > 0 for n in hgmma.values()),
          f"no HGMMA in the SASS of {symbol}")

    dev = torch.device("cuda")
    B, S, Hq, Hkv, dh = 8, 2048, 32, 4, 64
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((B, S, Hq, dh), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(torch.bfloat16)
    before = ops.launch_counts()["flash_attention"]
    ops.flash_attention(q, k, v)
    check(ops.launch_counts()["flash_attention"] == before + 1,
          "a bf16 flash_attention call did not launch its kernel exactly once")
    ran = kernels_of_one_call(lambda: ops.flash_attention(q, k, v))
    if ran:
        print(f"  one bf16 flash_attention call runs: {ran}")
        check(sum(symbol in name for name in ran) == 1 and len(ran) == 1,
              f"a bf16 flash_attention call did not run {symbol} exactly once")
    else:
        counted_launches(lambda: ops.flash_attention(q, k, v), "a bf16 flash_attention call")
    k_ms = device_ms(lambda: ops.flash_attention(q, k, v), reps=10, match=symbol,
                     launches=1)
    call_ms = cuda_ms(lambda: ops.flash_attention(q, k, v), reps=10)
    p_ms = device_ms(lambda: ref.flash_attention_ref(q, k, v), reps=2)
    # CUDA events: torch.profiler records no device time for this call
    l_ms = cuda_ms(lambda: _sdpa(q, k, v), reps=10)
    sdpa_err = max_abs_err(_sdpa(q, k, v).float(), ops.flash_attention(q, k, v).float())
    flops = _attention_flops(B, S, Hq, dh)
    nbytes = 2.0 * (2 * B * S * Hq * dh + 2 * B * S * Hkv * dh)   # q, o; k, v
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    print(f"  flash_attention TinyLlama layer B={B} S={S} {Hq}/{Hkv} dh={dh} bf16 "
          f"causal: kernel {k_ms:.4f} ms on the device, 1 {symbol} launch a call "
          f"({call_ms:.4f} ms a call back to back; {flops / k_ms / 1e9:.1f} TFLOP/s of "
          f"visible-pair flops, {1.5 * flops / k_ms / 1e9:.1f} with the split P.V), plain "
          f"{p_ms:.3f} ms, scaled_dot_product_attention {l_ms:.4f} ms a call back to back "
          f"(kernel / SDPA {k_ms / l_ms:.2f}x; max abs difference to the kernel "
          f"{sdpa_err:.3g}), bound {b_ms:.4f} ms ({b_by}: {flops:.3e} flops at the bf16 "
          f"tensor-core peak; {nbytes / 1e6:.1f} MB, {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    del q, k, v
    shapes = time_gemma3_layer(g)
    shapes.append(time_mla_layer(g, errs))

    B, S = 32, 32768
    q = torch.randn((B, S, Hq, dh), generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn((B, S, Hkv, dh), generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn((B, S, Hkv, dh), generator=g, device=dev, dtype=torch.bfloat16)
    big_ms = cuda_ms(lambda: ops.flash_attention(q, k, v), reps=3, warmup=1)
    got = ops.flash_attention(q, k, v)
    check(bool(torch.isfinite(got).all()), "prefill_32k layer: non-finite output")
    flops = _attention_flops(B, S, Hq, dh)
    big_b_ms, big_b_by = bound(2.0 * (2 * B * S * Hq * dh + 2 * B * S * Hkv * dh), flops,
                               BF16_FLOP_PER_S)
    s_ms = cuda_ms(lambda: _sdpa(q, k, v), reps=3, warmup=1)
    want = _sdpa(q, k, v)
    diff = max(max_abs_err(got[b].float(), want[b].float()) for b in range(B))
    print(f"  flash_attention prefill_32k layer B={B} S={S} {Hq}/{Hkv} dh={dh} bf16 causal "
          f"(q, k, v, o {(2 * q.numel() + 2 * k.numel()) * 2 / 1e9:.2f} GB): kernel "
          f"{big_ms:.2f} ms a call ({flops / big_ms / 1e9:.1f} TFLOP/s, CUDA events, 3 "
          f"reps), scaled_dot_product_attention {s_ms:.2f} ms (kernel / SDPA "
          f"{big_ms / s_ms:.2f}x), max abs difference {diff:.3g}, bound {big_b_ms:.2f} ms "
          f"({big_b_by}, {flops:.3e} flops)")
    del q, k, v, got, want
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:125",
                launches=None, max_abs_err=errs["flash_attention"], ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                kernel="flash_attention_wgmma_kernel", yardstick=None, shapes=shapes)


# -- phase 6 -----------------------------------------------------------------


def profiled_calls(fn, label: str, calls: int = 1, tries: int = 3):
    """(device ops, their microseconds, wall microseconds, the last
    result) of ``calls`` runs of ``fn`` under torch.profiler (CUPTI), after
    a warm-up call. A window in which the profiler recorded no device time
    is taken again, up to ``tries`` windows; after that the busy share is
    not measured (0 device microseconds), which is printed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window_pad()
            t = time.perf_counter()
            for _ in range(calls):
                res = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
            window_pad()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in on_card)
        if dev_us > 0:
            return on_card, dev_us, wall_us, res
    print(f"  {label}: busy share not measured (the profiler recorded no device time "
          f"in {tries} windows); {wall_us / 1e3 / calls:.2f} ms wall a call")
    return on_card, 0.0, wall_us, res


def device_profile(fn, label: str, calls: int = 1, top: int = 6) -> tuple[list, float]:
    """Wall and device time of ``calls`` runs of ``fn`` under torch.profiler
    (CUPTI): the busy share and the device ops that take most of it.
    Returns the device ops and their total microseconds (0 where the
    profiler lost every window)."""
    on_card, dev_us, wall_us, _ = profiled_calls(fn, label, calls)
    if dev_us <= 0:
        return on_card, dev_us
    print(f"  {label} under the profiler: {wall_us / 1e3 / calls:.2f} ms wall a call, "
          f"{dev_us / 1e3 / calls:.3f} ms on the device ({dev_us / wall_us:.1%} busy, "
          f"{1 - dev_us / wall_us:.1%} idle), {sum(e.count for e in on_card) / calls:.0f} "
          f"device ops a call")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.key[:70]:70s} {e.self_device_time_total / calls / 1e3:9.3f} ms "
              f"({e.self_device_time_total / dev_us:.1%}) x{e.count / calls:.0f}")
    return on_card, dev_us


def round_profile(base: torch.Tensor) -> None:
    """One full-world NN-Descent round (the third, from the state after two)
    under the profiler: device-busy share, the scoring pass's share and the
    device ops that lead."""
    from repro_torch.core import nndescent as nd

    ids, dists, isnew, gen, cfg = nndescent_state(base, 2)
    on_card, dev_us = device_profile(
        lambda: nd._round(base, ids, dists, isnew, gen, cfg, "l2"),
        "one full-world NN-Descent round (n=1M, k=20, C=240)", top=10)
    if dev_us <= 0:
        return
    mine = [e for e in on_card if "gather_distance_pool_" in e.key]
    us = sum(e.self_device_time_total for e in mine)
    print(f"  the scoring pass (gather_distance_pool_*): {us / 1e3:.3f} ms "
          f"({us / dev_us:.1%} of the round's device time), "
          f"{sum(e.count for e in mine)} launches")
    del ids, dists, isnew


@contextlib.contextmanager
def plain_attention():
    """``attention_full`` on the flash kernel's plain version (chunked over
    batch) while the block runs."""
    from repro_torch.kernels import ops

    kernel = ops.flash_attention
    ops.flash_attention = plain_flash_attention
    try:
        yield
    finally:
        ops.flash_attention = kernel


def lm_serving() -> int:
    """Phase 6; returns the flash kernel's launches in one prefill call."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = get_arch("tinyllama-1.1b").model_cfg
    B, S = 8, 2048
    t = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = tf.param_count(model)
    print(f"(a) {cfg.name}: {n_params:,} parameters ({cfg.n_layers} layers, d={cfg.d_model}, "
          f"GQA {cfg.n_heads}/{cfg.n_kv}, d_head={cfg.d_head}, d_ff={cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype}) initialised on the card in "
          f"{time.perf_counter() - t:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(1.0e9 < n_params < 1.2e9, "TinyLlama-1.1B parameter count out of range")

    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S))).to(dev)
               for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits = tf.prefill(model, prompts[0])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    launches = counts["flash_attention"]
    print(f"(b) prefill {B} x {S}: launches {counts}")
    check(launches == cfg.n_layers, f"prefill launched flash_attention {launches} times, "
          f"not once per layer ({cfg.n_layers})")
    check(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "prefill logits are not finite (B, vocab)")
    ms = cuda_ms(lambda: tf.prefill(model, prompts[0]), reps=3, warmup=1)
    print(f"(b) prefill {B} x {S} tokens: {ms:.1f} ms a call, {B * S / ms * 1e3:,.0f} "
          f"tokens/s, {launches} flash_attention launches a call; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_profile(lambda: tf.prefill(model, prompts[0]), f"prefill {B} x {S}")

    kern = torch.cat([logits, tf.prefill(model, prompts[1])])
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with plain_attention():
        plain = torch.cat([tf.prefill(model, p) for p in prompts])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3 / len(prompts)
    check(ops.launch_counts()["flash_attention"] == 0, "the plain prefill launched the kernel")
    err = max_abs_err(kern, plain)
    top = float(plain.abs().max())
    same = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    print(f"(c) kernel vs plain attention, last-position logits of {kern.shape[0]} rows: "
          f"max abs difference {err:.4g} (largest logit {top:.4g}; tolerance "
          f"{LM_LOGIT_RTOL} x that), argmax agrees on {same} of {kern.shape[0]}; the "
          f"plain prefill takes {plain_ms:.1f} ms a call (host clock)")
    check(err <= LM_LOGIT_RTOL * top, "prefill logits: kernel and plain attention disagree")
    check(same >= LM_ARGMAX_ROWS, "prefill argmax: kernel and plain attention disagree")
    del logits, kern, plain

    caches = tf.init_cache(cfg, B, S, dev)
    tok = torch.zeros((B,), dtype=torch.long, device=dev)
    step = iter(range(S))

    def decode():
        tf.decode_step(model, tok, torch.full((B,), next(step), dtype=torch.int32,
                                              device=dev), caches)
    device_profile(decode, f"decode step, batch {B}, caches of {S}", calls=8)
    del model, caches

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = tf.init_params(cfg32, seed=0, device=dev)
    Bd, Sd = 2, 128
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(Bd, Sd))).to(dev)
    ops.reset_launch_counts()
    full = (tf.forward(model, toks) @ model.lm_head).float()
    check(ops.launch_counts()["flash_attention"] == cfg.n_layers,
          "the fp32 forward did not go through the kernel")
    caches = tf.init_cache(cfg32, Bd, Sd, dev)
    t = time.perf_counter()
    steps = torch.stack([tf.decode_step(model, toks[:, i],
                                        torch.full((Bd,), i, dtype=torch.int32, device=dev),
                                        caches) for i in range(Sd)], 1)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t
    rel = max_abs_err(full, steps) / float(full.abs().max())
    print(f"(d) fp32 prefill == decode, {Bd} x {Sd}: max abs difference / largest logit "
          f"{rel:.3g} (tolerance {LM_DECODE_RTOL}); {Sd} decode steps in {dec_s:.2f} s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(rel <= LM_DECODE_RTOL, "fp32 decode logits differ from forward's")
    del model, caches, full, steps

    run = serve.main(["--arch", "tinyllama-1.1b", "--batch", "8", "--tokens", "32",
                      "--max-len", "2048", "--device", "cuda"])
    print(f"(e) serve: {run.tok_per_s:,.1f} tok/s, {run.ms_per_token:.2f} ms/token "
          f"(8 sequences, 32 greedy steps, caches of 2048)")
    check(run.tokens.shape == (8, 32) and bool(((run.tokens >= 0)
                                                 & (run.tokens < cfg.vocab)).all()),
          "the serve loop's tokens are out of range")
    return launches


# -- phase 13: LM training -------------------------------------------------------


@contextlib.contextmanager
def train_stages(flag: dict):
    """record_function labels on a training step's parts while the block is
    open: ``train: forward`` (the loss), ``train: recompute`` (a block's
    forward run again inside the backward, where ``cfg.remat`` checkpoints
    it: ``flag["bwd"]`` is set between the loss and the optimizer) and
    ``train: optimizer``; the rest of the step is the backward."""
    from torch.profiler import record_function

    from repro_torch.models import transformer as T

    block_forward = T.Block.forward

    def labelled(self, x, positions):
        if flag["bwd"]:
            with record_function("train: recompute"):
                return block_forward(self, x, positions)
        return block_forward(self, x, positions)
    T.Block.forward = labelled
    try:
        yield
    finally:
        T.Block.forward = block_forward


def labelled_train_step(opt_update):
    """``make_train_step`` over ``loss_fn`` and ``opt_update`` wrapped in
    :func:`train_stages`' labels, and the flag they share."""
    from torch.profiler import record_function

    from repro_torch.models import transformer as T
    from repro_torch.train.train_loop import make_train_step

    flag = {"bwd": False}

    def loss_fn(model, batch):
        with record_function("train: forward"):
            out = T.loss_fn(model, batch)
        flag["bwd"] = True
        return out

    def update(grads, state, params):
        flag["bwd"] = False
        with record_function("train: optimizer"):
            return opt_update(grads, state, params)
    return make_train_step(loss_fn, update), flag


def train_step_profile(step_fn, flag, label: str) -> None:
    """One training step under the profiler after a warm-up step: wall, the
    device-busy share, and the device time of the forward, the recompute,
    the backward (the rest), the flash backward kernel inside it and the
    optimizer (the labels of :func:`train_stages`)."""
    from torch.profiler import ProfilerActivity, profile

    names = ("train: forward", "train: recompute", "train: optimizer")
    cuda_type = torch.autograd.DeviceType.CUDA
    with train_stages(flag):
        step_fn()
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                window_pad()
                t = time.perf_counter()
                step_fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t) * 1e6
                window_pad()
            events = prof.key_averages()
            on_card = [e for e in events if e.device_type == cuda_type and e.key not in names]
            dev_us = sum(e.self_device_time_total for e in on_card)
            if dev_us > 0:
                break
        else:
            print(f"  {label}: busy share and stages not measured (the profiler recorded no "
                  f"device time in 3 windows); {wall_us / 1e3:.1f} ms wall")
            return
    by = {n: sum(e.device_time_total for e in events
                 if e.key == n and e.device_type != cuda_type) for n in names}
    flash_bwd = sum(e.self_device_time_total for e in on_card if "flash_bwd_" in e.key)
    flash_fwd = sum(e.self_device_time_total for e in on_card if "flash_attention" in e.key)
    backward = dev_us - sum(by.values())
    print(f"  {label} under the profiler: {wall_us / 1e3:.1f} ms wall, {dev_us / 1e3:.1f} ms on "
          f"the device ({dev_us / wall_us:.1%} busy, {1 - dev_us / wall_us:.1%} idle), "
          f"{sum(e.count for e in on_card)} device ops")
    split = [("forward", by["train: forward"]), ("recompute", by["train: recompute"]),
             ("backward (the rest)", backward), ("optimizer", by["train: optimizer"])]
    if backward < 0:
        # the profiler has billed a label more device time than the step had
        print(f"    the labels' split is not measured: their device times "
              f"{ {n: round(us / 1e3, 1) for n, us in split} } ms overlap")
        split = []
    for name, us in (*split, ("flash backward", flash_bwd),
                     ("flash forward (forward + recompute)", flash_fwd)):
        print(f"    {name:38s} {us / 1e3:9.1f} ms ({us / dev_us:.1%})")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.key[:70]:70s} {e.self_device_time_total / 1e3:9.1f} ms x{e.count}")


def _state_equal(a: dict, b: dict) -> list[str]:
    """Keys of two checkpoint trees whose tensors differ in any bit."""
    from repro_torch.train import checkpoint as ckpt

    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    return sorted(k for k in fa.keys() | fb.keys()
                  if k not in fa or k not in fb or not torch.equal(fa[k], fb[k]))


def lm_training() -> dict[str, int]:
    """Phase 13. (a) TinyLlama-1.1B at published widths (bf16, remat) with
    AdamW at the reference's defaults on 8 x 2048 tokens of
    ``lm_batch_for_step(0, step, ...)`` for PHASE13_STEPS steps, the launch
    counts set to 0 just before; a checkpoint at step PHASE13_CKPT_STEP;
    one step profiled by stage. (b) a new model and optimizer restored from
    that checkpoint run to step PHASE13_STEPS: parameters and optimizer state
    bit-identical to (a)'s. (c) TinyLlama cut to 2 layers, one step on the
    kernel route and on the plain route (``ops_replaced``): per-parameter
    gradients within LM_GRAD_TOL. (d) DeepSeek-V3 at published widths cut to
    1 dense + 1 MoE layer + the MTP head, Adafactor. (e) the five smoke
    configs in fp32, 3 steps on the card and on the CPU. Returns (a)'s
    launches per kernel."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.data.synthetic import lm_batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_loop import make_train_step, trainable

    dev = torch.device("cuda")
    ad = configs.get_arch("tinyllama-1.1b")
    cfg = ad.model_cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab, cfg.remat)
          == (22, 2048, 32, 4, 5632, 32000, True) and ad.optimizer == "adamw",
          "TinyLlama's config is not the published one")
    B, S = PHASE13_BATCH, PHASE13_SEQ

    def batch(step, rows=B):
        return lm_batch_for_step(0, step, rows, S, cfg.vocab, dev)

    # (a)
    t = time.perf_counter()
    model = T.init_params(cfg, 0, dev)
    named = trainable(model)
    opt_init, opt_update = make_optimizer(ad.optimizer)
    state = opt_init(named)
    step_fn = make_train_step(T.loss_fn, opt_update)
    torch.cuda.synchronize()
    print(f"(a) TinyLlama-1.1B, {T.param_count(model):,} parameters, bf16, remat, AdamW "
          f"(reference defaults): init {time.perf_counter() - t:.2f} s")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-train-")
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, secs = [], []
        for step in range(PHASE13_STEPS):
            b = batch(step)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, state, metrics = step_fn(model, state, b)
            losses.append(float(metrics["loss"]))
            secs.append(time.perf_counter() - t)
            if step + 1 == PHASE13_CKPT_STEP:
                t = time.perf_counter()
                path = ckpt.save(tmp, step + 1, {"params": named, "opt": state})
                size = sum(f.stat().st_size for f in Path(path).iterdir())
                print(f"    checkpoint at step {step + 1}: {size / 2**30:.2f} GiB in "
                      f"{time.perf_counter() - t:.1f} s")
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = secs[1:]
        ms = 1e3 * sum(steady) / len(steady)
        print(f"(a) {PHASE13_STEPS} steps of {B} x {S}: loss {losses[0]:.4f} at step 0, "
              f"{losses[-1]:.4f} at step {PHASE13_STEPS - 1} (every step: "
              f"{[round(x, 4) for x in losses]}); {ms:.1f} ms a step after the first "
              f"({1e3 * secs[0]:.1f} ms), {B * S / ms * 1e3:,.0f} tokens/s; peak "
              f"{peak:.2f} GiB; flash launches a step: forward "
              f"{launches['flash_attention'] / PHASE13_STEPS:g}, backward "
              f"{launches['flash_attention_bwd'] / PHASE13_STEPS:g}")
        print(f"    ms a step: {[round(1e3 * x, 1) for x in secs]}; right after the last: "
              f"{nvidia_smi_line('clocks.sm,clocks.max.sm,power.draw,temperature.gpu')} "
              f"(SM clock, its max, power draw, temperature)")
        check(all(np.isfinite(losses)), "TinyLlama training: a non-finite loss")
        check(losses[-1] < losses[0], "TinyLlama training: the loss did not fall")
        check(launches["flash_attention_bwd"] == cfg.n_layers * PHASE13_STEPS
              and launches["flash_attention"] == 2 * cfg.n_layers * PHASE13_STEPS,
              f"TinyLlama training launched {launches['flash_attention']} forward and "
              f"{launches['flash_attention_bwd']} backward flash kernels, not 2 x 22 and 22 a "
              f"step (remat runs each block's forward twice)")
        check(all(v == 0 for k, v in launches.items()
                  if k not in ("flash_attention", "flash_attention_bwd")),
              f"TinyLlama training launched another kernel of the port: {launches}")
        b0 = batch(PHASE13_STEPS)
        labelled, flag = labelled_train_step(opt_update)
        probe = {"state": state}

        def one_step():
            probe["state"] = labelled(model, probe["state"], b0)[1]
        # on copies: the profiled steps must not move (a)'s end state
        final = {"params": {n: p.detach().clone() for n, p in named.items()}, "opt": state}
        train_step_profile(one_step, flag, "(a) one TinyLlama training step")
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(final["params"][n])
        del probe, b0

        # (b)
        t = time.perf_counter()
        model2 = T.Transformer(cfg, dev)
        named2 = trainable(model2)
        restored = ckpt.restore(tmp, PHASE13_CKPT_STEP, {"params": named2,
                                                         "opt": opt_init(named2)})[0]
        with torch.no_grad():
            for n, p in named2.items():
                p.copy_(restored["params"][n])
        state2 = restored["opt"]
        del restored
        print(f"(b) a new model and optimizer restored from step {PHASE13_CKPT_STEP} in "
              f"{time.perf_counter() - t:.1f} s")
        for step in range(PHASE13_CKPT_STEP, PHASE13_STEPS):
            _, state2, _ = step_fn(model2, state2, batch(step))
        torch.cuda.synchronize()
        differ = _state_equal(final, {"params": named2, "opt": state2})
        print(f"(b) resumed to step {PHASE13_STEPS}: {len(differ)} of "
              f"{len(ckpt.flatten(final))} parameter and optimizer tensors differ in any bit")
        check(not differ, f"the restart is not bit-identical: {differ[:5]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, named, state, model2, named2, state2, final
    torch.cuda.empty_cache()

    # (c)
    for dt in (torch.bfloat16, torch.float32):
        small = dataclasses.replace(cfg, n_layers=2, dtype=dt)
        lm = T.init_params(small, 0, dev)
        leaves = trainable(lm)
        b = batch(0, rows=PHASE13_LOCKSTEP_BATCH)
        ops.reset_launch_counts()
        loss_k, _ = T.loss_fn(lm, b)
        grads_k = torch.autograd.grad(loss_k, list(leaves.values()))
        loss_k = float(loss_k.detach())
        k_launch = ops.launch_counts()
        ops.reset_launch_counts()
        with ops_replaced(flash_attention=plain_flash_differentiable):
            loss_p, _ = T.loss_fn(lm, b)
            grads_p = torch.autograd.grad(loss_p, list(leaves.values()))
            loss_p = float(loss_p.detach())
        p_launch = ops.launch_counts()
        check(k_launch["flash_attention_bwd"] == 2 and p_launch["flash_attention_bwd"] == 0
              and p_launch["flash_attention"] == 0,
              f"(c) the routes' launches: kernel {k_launch}, plain {p_launch}")
        worst = max(((float((gk.float() - gp.float()).abs().max())
                      / max(float(gp.float().abs().max()), 1e-30)), n)
                    for n, gk, gp in zip(leaves, grads_k, grads_p))
        print(f"(c) lock-step, TinyLlama cut to 2 layers, {PHASE13_LOCKSTEP_BATCH} x {S} "
              f"{str(dt)[6:]}: loss {loss_k:.6f} (kernel) against {loss_p:.6f} "
              f"(plain); the largest per-parameter gradient difference {worst[0]:.3g} of that "
              f"gradient's max-abs ({worst[1]}; tolerance {LM_GRAD_TOL[dt]})")
        check(worst[0] <= LM_GRAD_TOL[dt], f"(c) {str(dt)[6:]} gradients of the two routes "
                                           f"differ past LM_GRAD_TOL at {worst[1]}")
        del lm, leaves, grads_k, grads_p, loss_k, loss_p
    torch.cuda.empty_cache()

    # (d)
    dad = configs.get_arch("deepseek-v3-671b")
    dcfg = dataclasses.replace(dad.model_cfg, n_layers=2, n_dense_prefix=1)
    t = time.perf_counter()
    dmodel = T.init_params(dcfg, 0, dev)
    dnamed = trainable(dmodel)
    dinit, dupdate = make_optimizer(dad.optimizer)
    dstate = dinit(dnamed)
    dstep = make_train_step(T.loss_fn, dupdate)
    print(f"(d) DeepSeek-V3 at published widths cut to 1 dense + 1 MoE layer + MTP: "
          f"{T.param_count(dmodel):,} parameters, bf16, remat, Adafactor (reference "
          f"defaults): init {time.perf_counter() - t:.2f} s")
    rows, cut = PHASE13_DEEPSEEK_BATCH, None
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    parts, secs = [], []
    for step in range(PHASE13_DEEPSEEK_STEPS):
        b = lm_batch_for_step(0, step, rows, S, dcfg.vocab, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, dstate, m = dstep(dmodel, dstate, b)
        loss, nll, aux = (float(m[k]) for k in ("loss", "nll", "aux"))
        secs.append(time.perf_counter() - t)
        parts.append((loss, nll, aux, (loss - nll - aux) / dcfg.mtp_weight))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if peak > PHASE13_PEAK_GIB and rows > 1:
            rows, cut = 1, f"batch cut to 1 x {S}: the peak {peak:.2f} GiB passed {PHASE13_PEAK_GIB}"
            print(f"(d) {cut}")
    dl = ops.launch_counts()
    print(f"(d) {PHASE13_DEEPSEEK_STEPS} steps of {rows} x {S}: (loss, nll, aux, MTP nll) a step "
          f"{[tuple(round(x, 5) for x in p) for p in parts]}; {1e3 * sum(secs[1:]) / (len(secs) - 1):.1f} "
          f"ms a step after the first ({1e3 * secs[0]:.1f} ms); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; flash launches forward "
          f"{dl['flash_attention']}, backward {dl['flash_attention_bwd']}"
          + (f"; cut: {cut}" if cut else ""))
    check(all(np.isfinite(p).all() for p in parts), "DeepSeek training: a non-finite loss part")
    check(dl["flash_attention_bwd"] == 3 * PHASE13_DEEPSEEK_STEPS,
          "DeepSeek training did not run the backward kernel in its 2 MLA layers and the MTP "
          "block each step")
    dlabelled, dflag = labelled_train_step(dupdate)
    dprobe = {"state": dstate}
    db = lm_batch_for_step(0, PHASE13_DEEPSEEK_STEPS, rows, S, dcfg.vocab, dev)

    def d_one_step():
        dprobe["state"] = dlabelled(dmodel, dprobe["state"], db)[1]
    train_step_profile(d_one_step, dflag, "(d) one DeepSeek-V3 training step")
    del dmodel, dnamed, dstate, dprobe, db
    torch.cuda.empty_cache()

    # (e)
    for arch_id in configs.list_archs():
        sad = configs.get_arch(arch_id)
        scfg = sad.smoke_cfg
        cpu_model = T.init_params(scfg, 0, "cpu")
        card_model = T.Transformer(scfg, dev)
        with torch.no_grad():
            for (_, a), (_, c) in zip(cpu_model.named_parameters(), card_model.named_parameters()):
                c.copy_(a)
        runs = []
        for lm, where in ((cpu_model, "cpu"), (card_model, dev)):
            init_, update_ = make_optimizer(sad.optimizer)
            st = init_(trainable(lm))
            fn = make_train_step(T.loss_fn, update_)
            out = []
            for step in range(3):
                _, st, m = fn(lm, st, lm_batch_for_step(0, step, 2, 64, scfg.vocab, where))
                out.append(float(m["loss"]))
            runs.append(out)
        rel = max(abs(a - b) / abs(a) for a, b in zip(*runs))
        print(f"(e) {arch_id} smoke, fp32, {sad.optimizer}, 3 steps of 2 x 64: losses on the "
              f"CPU {[round(x, 6) for x in runs[0]]}, on the card {[round(x, 6) for x in runs[1]]}; "
              f"largest relative difference {rel:.3g}")
        check(rel <= 1e-5, f"(e) {arch_id}: the card's losses differ from the CPU's past 1e-5")
    return launches


# -- phase 12: MoE and hybrid LM serving ----------------------------------------


class lm_stages:
    """While active: ``models.layers``' stages run under
    ``torch.profiler.record_function`` labels, which the model calls through
    the module: MLA ("attention: MLA projections", ``mla_forward``: its
    PyTorch ops; the flash kernel, a ctypes launch, belongs to no range and
    :func:`stage_profile` reads it by its symbol), the SwiGLUs ("mlp:
    SwiGLU", the dense layers' and the shared experts') and the MoE stages
    ("moe: router and dispatch", "moe: expert products", "moe: combine");
    and ``dropped`` lists each ``moe_route`` call's assignments past
    capacity (device tensors, read at the end), one per MoE layer in a
    prefill."""

    LABELS = {"mla_forward": "attention: MLA projections", "swiglu": "mlp: SwiGLU",
              "moe_route": "moe: router and dispatch", "moe_dispatch": "moe: router and dispatch",
              "moe_experts": "moe: expert products", "moe_combine": "moe: combine"}

    def __init__(self, count_drops: bool = False):
        self.count_drops = count_drops
        self.dropped = []
        self.assignments = 0

    def __enter__(self):
        from torch.profiler import record_function

        from repro_torch.models import layers

        self.saved = {name: getattr(layers, name) for name in self.LABELS}

        def wrap(name, fn):
            def run(*args, **kw):
                with record_function(self.LABELS[name]):
                    out = fn(*args, **kw)
                if name == "moe_route" and self.count_drops:
                    self.dropped.append((~out.keep).sum())
                    self.assignments += out.keep.numel()
                return out
            return run
        for name, fn in self.saved.items():
            setattr(layers, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        for name, fn in self.saved.items():
            setattr(layers, name, fn)


def stage_profile(fn, label: str, calls: int = 1, top: int = 6, tries: int = 3) -> None:
    """:func:`device_profile` of ``calls`` runs of ``fn`` with the model's
    stages labelled (:class:`lm_stages`), from the same window: the busy
    share, the device ops that lead, and the device time under each label
    (the kernels its record_function range launched) and of the flash
    kernel (by its symbol) per call and as a share of the window's. Where
    the ranges carry no device time, the spans of their GPU annotations
    stand in (gaps included), which is printed."""
    from torch.profiler import ProfilerActivity, profile

    names = sorted(set(lm_stages.LABELS.values()))
    cuda_type = torch.autograd.DeviceType.CUDA
    with lm_stages():
        fn()
        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                window_pad()
                t = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t) * 1e6
                window_pad()
            events = prof.key_averages()
            on_card = [e for e in events if e.device_type == cuda_type and e.key not in names]
            dev_us = sum(e.self_device_time_total for e in on_card)
            if dev_us > 0:
                break
        else:
            print(f"  {label}: busy share and stages not measured (the profiler recorded "
                  f"no device time in {tries} windows); {wall_us / 1e3 / calls:.2f} ms wall a call")
            return
    print(f"  {label} under the profiler (stages labelled): {wall_us / 1e3 / calls:.2f} ms "
          f"wall a call, {dev_us / 1e3 / calls:.3f} ms on the device ({dev_us / wall_us:.1%} "
          f"busy, {1 - dev_us / wall_us:.1%} idle), {sum(e.count for e in on_card) / calls:.0f} "
          f"device ops a call")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.key[:70]:70s} {e.self_device_time_total / calls / 1e3:9.3f} ms "
              f"({e.self_device_time_total / dev_us:.1%}) x{e.count / calls:.0f}")
    by = {n: sum(e.device_time_total for e in events
                 if e.key == n and e.device_type != cuda_type) for n in names}
    how = "kernels under each label"
    if not any(by.values()):
        by = {n: sum(e.self_device_time_total for e in events
                     if e.key == n and e.device_type == cuda_type) for n in names}
        how = "spans of the labels' GPU annotations, gaps included"
    by["attention: flash (its kernel)"] = sum(e.self_device_time_total for e in on_card
                                              if "flash_attention" in e.key)
    print(f"  {label}, stages ({how}):")
    for n, us in sorted(by.items()):
        if us:
            print(f"    {n:30s} {us / 1e3 / calls:9.3f} ms ({us / dev_us:.1%})")


@contextlib.contextmanager
def library_attention():
    """``attention_full`` on PyTorch's own bf16 attention while the block
    runs: scaled_dot_product_attention, causal, the window as a boolean
    mask (the yardstick of phase 12 (c), used nowhere in the port)."""
    from repro_torch.kernels import ops

    kernel = ops.flash_attention
    ops.flash_attention = lambda q, k, v, causal=True, window=None, softmax_scale=None: (
        _sdpa_layer(q, k, v, window, softmax_scale))
    try:
        yield
    finally:
        ops.flash_attention = kernel


def lockstep_attention(model, tokens) -> list[tuple]:
    """The plain prefill of ``tokens`` with the flash kernel and the
    library's attention (scaled_dot_product_attention, as in
    :func:`library_attention`) run beside the plain attention at every
    layer on the same q, k and v: per layer, its window, the kernel's
    largest difference and largest excess over FLASH_TOL, and the share of
    the kernel's and of the library's outputs that differ from the plain
    ones (bf16: one ulp or more)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    kernel, layers = ops.flash_attention, []

    def both(q, k, v, causal=True, window=None, softmax_scale=None):
        want = plain_flash_attention(q, k, v, causal, window, softmax_scale)
        got = kernel(q, k, v, causal, window, softmax_scale)
        lib = _sdpa_layer(q, k, v, window, softmax_scale)
        tol = FLASH_TOL[q.dtype]
        diff = (got.float() - want.float()).abs()
        layers.append((window, float(diff.max()),
                       float((diff - tol["atol"] - tol["rtol"] * want.float().abs()).max()),
                       float((diff > 0).float().mean()), float((lib != want).float().mean())))
        return want
    ops.flash_attention = both
    try:
        tf.prefill(model, tokens)
    finally:
        ops.flash_attention = kernel
    return layers


def expected_lm_params(cfg) -> int:
    """The parameters of ``cfg`` counted from its fields alone: embed, head,
    final norm; per layer two norms, the attention (GQA: q/k/v/o; MLA: w_dq,
    q_norm, w_uq, w_dkv, kv_norm, w_kr, w_uk, w_uv, wo) and the MLP (a
    SwiGLU of d_ff in the dense prefix and where there is no MoE, else the
    router, experts and shared experts); the MTP head's proj (2D, D), dense
    block and norm where ``cfg.mtp``."""
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    if cfg.attention == "mla":
        a = cfg.mla
        ql, r, A = a.q_lora_rank, a.kv_lora_rank, a.n_heads
        attn = (D * ql + ql + ql * A * (a.qk_nope_dim + a.qk_rope_dim) + D * r + r
                + D * a.qk_rope_dim + r * A * (a.qk_nope_dim + a.v_head_dim)
                + A * a.v_head_dim * D)
    else:
        attn = D * H * dh * 2 + D * Hkv * dh * 2
    dense = 2 * D + attn + 3 * D * cfg.d_ff
    layer = dense
    if cfg.moe is not None:
        m = cfg.moe
        layer = (2 * D + attn + D * m.n_experts + 3 * m.n_experts * D * m.d_ff
                 + 3 * D * m.shared_d_ff * m.n_shared)
    mtp = 2 * D * D + dense + D if cfg.mtp else 0
    return (2 * cfg.vocab * D + D + cfg.n_dense_prefix * dense + cfg.n_scan_layers * layer
            + mtp)


def lm_arch_serving(arch_id: str, batch: int, depth: int | None, d_layers: int,
                    d_tokens: int, d_window: int | None) -> int:
    """Phase 12 for one arch, at ``depth`` layers (None: the config's);
    returns the flash kernel's launches in one prefill call."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    full = get_arch(arch_id).model_cfg
    cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
    counts_want = PHASE12_COUNTS.get(arch_id)
    B, S = batch, 2048
    torch.cuda.reset_peak_memory_stats()
    t0 = t = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = tf.param_count(model)
    want, full_count = PHASE12_PARAMS[arch_id], expected_lm_params(full)
    m = cfg.moe
    mlp = (f"{m.n_experts} experts top-{m.top_k} d_ff={m.d_ff}, {m.n_shared} shared, "
           f"capacity_factor {m.capacity_factor}" if m else f"d_ff={cfg.d_ff}")
    if cfg.attention == "mla":
        a = cfg.mla
        attn = (f"MLA {a.n_heads} heads, q_lora_rank {a.q_lora_rank}, kv_lora_rank "
                f"{a.kv_lora_rank}, dn/dr/dv {a.qk_nope_dim}/{a.qk_rope_dim}/{a.v_head_dim}")
    else:
        attn = f"GQA {cfg.n_heads}/{cfg.n_kv}, d_head={cfg.d_head}"
    prefix = (f" (the first {cfg.n_dense_prefix} dense, d_ff={cfg.d_ff})"
              if cfg.n_dense_prefix else "")
    print(f"(a) {cfg.name}: {n_params:,} parameters ({expected_lm_params(cfg):,} from the "
          f"config's fields; {cfg.n_layers} of {full.n_layers} layers{prefix}, "
          f"d={cfg.d_model}, {attn}, {mlp}, vocab {cfg.vocab}, the first period's "
          f"windows {[cfg.layer_window(i) for i in range(min(cfg.n_layers, 6))]}"
          f"{', MTP weights carried' if cfg.mtp else ''}, {cfg.dtype}) initialised on the "
          f"card in {time.perf_counter() - t:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the full config "
          f"{full_count:,} from its fields (published {want:.4g})")
    check(abs(full_count - want) <= 0.01 * want,
          f"{full.name} parameter count {full_count:,} is not within 1% of {want:.4g}")
    check(n_params == expected_lm_params(cfg),
          f"{cfg.name} parameter count {n_params:,} is not the count from its fields")
    if counts_want is not None:
        check((full_count, n_params) == counts_want[:2],
              f"{cfg.name} parameter counts {(full_count, n_params)} are not the reference's "
              f"{counts_want[:2]}")

    rng = np.random.default_rng(12)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S))).to(dev)
               for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits = tf.prefill(model, prompts[0])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    launches = counts["flash_attention"]
    print(f"(b) prefill {B} x {S}: launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    check(launches == cfg.n_layers, f"{cfg.name} prefill launched flash_attention {launches} "
          f"times, not once per layer ({cfg.n_layers})")
    check(sum(counts.values()) == launches, "the prefill launched a kernel other than flash")
    check(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill logits are not finite (B, vocab)")
    ms = cuda_ms(lambda: tf.prefill(model, prompts[0]), reps=3, warmup=1)
    print(f"(b) prefill {B} x {S} tokens: {ms:.1f} ms a call, {B * S / ms * 1e3:,.0f} "
          f"tokens/s, {launches} flash_attention launches a call; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if cfg.moe is not None:
        with lm_stages(count_drops=True) as st:
            tf.prefill(model, prompts[0])
        per_layer = [int(d) for d in st.dropped]
        dropped, each = sum(per_layer), st.assignments // len(per_layer)
        print(f"(b) MoE at capacity_factor {cfg.moe.capacity_factor}: {dropped:,} of "
              f"{st.assignments:,} assignments dropped ({dropped / st.assignments:.2%}; C = "
              f"{max(int(cfg.moe.capacity_factor * S * cfg.moe.top_k / cfg.moe.n_experts), 1)} "
              f"slots per expert per row); by layer, share of {each:,}: "
              f"{[round(d / each, 3) for d in per_layer]}")
    stage_profile(lambda: tf.prefill(model, prompts[0]), f"prefill {B} x {S}")
    print(f"  [(a), (b)] {time.perf_counter() - t0:.1f} s")

    kern = torch.cat([logits, tf.prefill(model, prompts[1])])
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with plain_attention():
        plain = torch.cat([tf.prefill(model, p) for p in prompts])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3 / len(prompts)
    check(ops.launch_counts()["flash_attention"] == 0, "the plain prefill launched the kernel")
    with library_attention():
        lib = torch.cat([tf.prefill(model, p) for p in prompts])
    err, lib_err = max_abs_err(kern, plain), max_abs_err(lib, plain)
    top = float(plain.abs().max())
    same = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    lib_same = int((lib.argmax(-1) == plain.argmax(-1)).sum())
    rows = kern.shape[0]
    print(f"(c) kernel vs plain attention, last-position logits of {rows} rows: max abs "
          f"difference {err:.4g} (largest logit {top:.4g}; tolerance {LM_LOGIT_RTOL} x that, "
          f"or the library's distance), argmax agrees on {same} of {rows}; the library's bf16 "
          f"attention (scaled_dot_product_attention) on the same model: {lib_err:.4g}, argmax "
          f"{lib_same} of {rows}; the plain prefill takes {plain_ms:.1f} ms a call (host "
          f"clock)")
    layers = lockstep_attention(model, prompts[0])
    for window in sorted({w for w, *_ in layers}, key=str):
        mine = [r for r in layers if r[0] == window]
        print(f"(c) lock-step, the kernel beside the plain attention on each layer's q, k, v "
              f"({len(mine)} layers, window {window}): max abs difference "
              f"{max(r[1] for r in mine):.3g}, largest excess over the tolerance "
              f"{max(r[2] for r in mine):.3g}, outputs that differ "
              f"{min(r[3] for r in mine):.3%}-{max(r[3] for r in mine):.3%} (the library's "
              f"{min(r[4] for r in mine):.3%}-{max(r[4] for r in mine):.3%})")
    check(len(layers) == cfg.n_layers and all(r[2] <= 0.0 for r in layers),
          f"{cfg.name}: a layer's kernel output is outside the tolerance of the plain one")
    check(err <= max(LM_LOGIT_RTOL * top, lib_err),
          f"{cfg.name} prefill logits: kernel and plain disagree")
    check(same >= rows - 1, f"{cfg.name} prefill argmax: kernel and plain attention disagree")
    del logits, kern, plain, lib

    caches = tf.init_cache(cfg, B, S, dev)
    tok = torch.zeros((B,), dtype=torch.long, device=dev)
    step = iter(range(S))

    def decode():
        tf.decode_step(model, tok, torch.full((B,), next(step), dtype=torch.int32,
                                              device=dev), caches)
    stage_profile(decode, f"decode step, batch {B}, caches of {S}", calls=2)
    print(f"  [(c), decode profile] {time.perf_counter() - t0:.1f} s")
    del caches, prompts
    if depth is not None:   # the full config does not fit the card: serve the cut model
        run = serve.serve_lm(model, batch=8, tokens=32, max_len=2048)
        print(f"(e) serve_lm on the {depth}-layer model: {run.tok_per_s:,.1f} tok/s, "
              f"{run.ms_per_token:.2f} ms/token (8 sequences, 32 greedy steps, caches of "
              f"2048); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(run.tokens.shape == (8, 32) and bool(((run.tokens >= 0)
                                                     & (run.tokens < cfg.vocab)).all()),
              f"{cfg.name}: the serve loop's tokens are out of range")
    del model
    torch.cuda.empty_cache()

    over = dict(dtype=torch.float32, n_layers=d_layers)
    if cfg.n_dense_prefix:    # one dense layer, then the MoE layers
        over["n_dense_prefix"] = 1
    if cfg.moe is not None:   # C = S: prefill drops nothing, as decode (C = 1) never does
        over["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    if d_window is not None:
        over["local_window"] = d_window
    cfg32 = dataclasses.replace(cfg, **over)
    model = tf.init_params(cfg32, seed=0, device=dev)
    n32 = tf.param_count(model)
    check(n32 == expected_lm_params(cfg32) and (counts_want is None or n32 == counts_want[2]),
          f"{cfg32.name} fp32 parameter count {n32:,} is not the expected one")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, d_tokens))).to(dev)
    ops.reset_launch_counts()
    full_logits = (tf.forward(model, toks) @ model.lm_head).float()
    check(ops.launch_counts()["flash_attention"] == d_layers,
          "the fp32 forward did not go through the kernel")
    caches = tf.init_cache(cfg32, 2, d_tokens, dev)
    t = time.perf_counter()
    steps = torch.stack([tf.decode_step(model, toks[:, i],
                                        torch.full((2,), i, dtype=torch.int32, device=dev),
                                        caches) for i in range(d_tokens)], 1)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t
    rel = max_abs_err(full_logits, steps) / float(full_logits.abs().max())
    rings = sorted({next(iter(c.values())).shape[1] for c in caches})
    print(f"(d) fp32 prefill == decode at full width, {d_layers} layers "
          f"({cfg32.n_dense_prefix} dense), {n32:,} parameters, 2 x {d_tokens} "
          f"(cache slots {rings}{', capacity_factor ' + str(cfg32.moe.capacity_factor) if cfg32.moe else ''}): "
          f"max abs difference / largest logit {rel:.3g} (tolerance {LM_DECODE_RTOL}); "
          f"{d_tokens} decode steps in {dec_s:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(rel <= LM_DECODE_RTOL, f"{cfg.name} fp32 decode logits differ from forward's")
    del model, caches, full_logits, steps
    torch.cuda.empty_cache()
    print(f"  [(d)] {time.perf_counter() - t0:.1f} s")

    argv = ["--arch", arch_id, "--batch", "8", "--tokens", "32", "--max-len", "2048",
            "--device", "cuda"] + (["--smoke"] if depth is not None else [])
    run = serve.main(argv)
    vocab = get_arch(arch_id).smoke_cfg.vocab if depth is not None else cfg.vocab
    print(f"(e) serve {' '.join(argv)}: {run.tok_per_s:,.1f} tok/s, {run.ms_per_token:.2f} "
          f"ms/token (8 sequences, 32 greedy steps, caches of 2048); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(run.tokens.shape == (8, 32) and bool(((run.tokens >= 0) & (run.tokens < vocab)).all()),
          f"{cfg.name}: the serve loop's tokens are out of range")
    torch.cuda.empty_cache()
    return launches


def moe_hybrid_serving() -> int:
    """Phase 12; returns the flash kernel's launches over one prefill call of
    each arch."""
    total = 0
    for arch_id, batch, depth, d_layers, d_tokens, d_window in PHASE12_ARCHS:
        t = time.perf_counter()
        print(f"--- {arch_id}")
        total += lm_arch_serving(arch_id, batch, depth, d_layers, d_tokens, d_window)
        print(f"  [{arch_id}] {time.perf_counter() - t:.1f} s")
    return total


def busy_share(fn, label: str):
    """Device-busy share of one ``fn`` call after a warm-up call: kernel
    time on the card (torch.profiler, CUPTI) over the call's wall time;
    prints it and the leading device ops, returns the call's result."""
    on_card, dev_us, wall_us, res = profiled_calls(fn, label)
    if dev_us <= 0:
        return res
    steps = f", {int(res.n_steps)} steps" if hasattr(res, "n_steps") else ""
    print(f"  {label} under the profiler: {wall_us / 1e3:.2f} ms wall, "
          f"{dev_us / 1e3:.3f} ms on the device ({dev_us / wall_us:.1%} busy, "
          f"{1 - dev_us / wall_us:.1%} idle){steps}, {len(on_card)} distinct device ops")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.key[:70]:70s} {e.self_device_time_total:9.1f} us x{e.count}")
    return res


def batch_share(run, spec) -> None:
    """:func:`busy_share` of the first served batch under ``spec``."""
    q, seed = run.stream[0], run.seeds[0]
    entry = "" if spec.entry == "random" else f"{spec.entry} "
    busy_share(lambda: run.searcher.search(q, spec, seed), f"{entry}{spec.scorer} beam batch")


# -- phase 8: the saved, tiered and filtered index ----------------------------


def event_s(fn):
    """(result, seconds) of one ``fn`` call between two CUDA events, the
    device synchronised before and after."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end) / 1e3


def add_launches(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase8_metadata(n: int, seed: int = 0) -> dict:
    """The filters' columns, from ``seed``: tenant uniform in [0, 16), tag
    uniform in [0, 64), timestamp a permutation of [0, n)."""
    rng = np.random.default_rng(seed + 8)
    return {"tenant": rng.integers(0, 16, n).astype(np.int32),
            "tag": rng.integers(0, 64, n).astype(np.int32),
            "timestamp": rng.permutation(n).astype(np.int64)}


def same_result(a, b) -> bool:
    return (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.n_comps, b.n_comps) and int(a.n_steps) == int(b.n_steps))


def check_artifact(art, s, label: str, bf16: bool) -> None:
    """Every array of a loaded artifact against the live searcher's, bit for
    bit (a bf16-sharded base against the bf16 cast of the live one)."""
    from repro_torch.core import io as index_io
    from repro_torch.core.base_store import bf16_bits, bf16_to_f32

    def host(t):
        return t.detach().cpu().numpy()

    base = host(s.base)
    pairs = {"base": (art.base, bf16_to_f32(bf16_bits(base)) if bf16 else base),
             "neighbors": (art.neighbors, host(s.neighbors)),
             "hubs": (art.hubs, host(s.hubs)),
             "pq_codebooks": (art.pq.codebooks, host(s.pq.codebooks)),
             "pq_codes": (art.pq.codes, host(s.pq.codes)),
             "key": (art.key, index_io.key_payload(s.rng_seed))}
    pairs.update({f"meta_{k}": (art.metadata[k], v) for k, v in s.metadata.items()})
    for name, (got, want) in pairs.items():
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        check(got.dtype == want.dtype and np.array_equal(got, want),
              f"{label}: the reloaded {name} differs from the live searcher's")


def filtered_ground_truth(queries, base, allow, k: int, chunk: int = 64):
    """Top-k ids over the allowed set: ``distance_matrix`` chunks with the
    denied columns set to +inf."""
    from repro_torch.core.topk import topk_smallest
    from repro_torch.kernels import ops

    out = []
    for lo in range(0, queries.shape[0], chunk):
        dm = ops.distance_matrix(queries[lo:lo + chunk], base)
        out.append(topk_smallest(dm.masked_fill(~allow[None, :], float("inf")), k)[1])
    return torch.cat(out).to(torch.int32)


def brute_against_plain(s, spec, stream) -> None:
    """The exact-scan route with the pair kernel and with the plain gather,
    on every batch: ids that differ must be near-ties, at most 1% of rows."""
    from repro_torch.kernels import ref

    cf = s.compiled_filter(spec.filter)
    rows = differ = 0
    for q in stream:
        kres = s._filtered_brute(q, cf, spec)
        with ops_replaced(gather_distance=ref.gather_distance_ref):
            pres = s._filtered_brute(q, cf, spec)
        rows += q.shape[0]
        differ += int((kres.ids != pres.ids).any(1).sum())
        check(bool(torch.isclose(kres.dists, pres.dists, **GATHER_TOL).all()),
              "the exact-scan route's distances differ from the plain gather's")
    print(f"  exact-scan route, pair kernel vs plain gather: {rows} rows, {differ} differ "
          f"(near-ties only; at most {NEAR_TIE_ROWS_MAX:.0%} allowed)")
    check(differ <= NEAR_TIE_ROWS_MAX * rows, "too many near-tie rows on the exact-scan route")


def tier_gather_split(s, spec, q, seed, store) -> tuple[float, float, int]:
    """One batch's tier gather in two parts: the host part of
    ``gather_start`` (ids to the host, rows sliced into a pinned buffer,
    copy issued; host clock over 20 calls, each synchronised) and the copy
    of those bytes from pinned memory to the card (CUDA events, 20 copies).
    Returns (host ms, copy ms, bytes)."""
    p = s._host_start(q, spec, seed)
    p.staged.wait()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        staged = store.gather_start(p.cand)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) / 20 * 1e3
    rows = staged.rows
    pinned = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    dst = torch.empty_like(rows)
    copy_ms = cuda_ms(lambda: dst.copy_(pinned, non_blocking=True), reps=20)
    return host_ms, copy_ms, rows.numel() * rows.element_size()


def save_and_load(s, tmp: str) -> dict:
    """(a): the index saved unsharded, in f32 shards and in bf16 shards,
    each loaded back and held to the live searcher. Returns the paths."""
    from repro_torch.core import io as index_io

    n = s.base.shape[0]
    paths = {}
    for label, kw in (("unsharded", {}),
                      ("f32-shards", dict(shard_rows=PHASE8_SHARD_ROWS)),
                      ("bf16-shards", dict(shard_rows=PHASE8_SHARD_ROWS, shard_dtype="bf16"))):
        art = index_io.IndexArtifact.from_searcher(s)
        path, save_s = event_s(lambda: index_io.save_index(os.path.join(tmp, label), art, **kw))
        files = [path]
        if kw:
            files += [os.path.join(tmp, f) for f in
                      index_io.shard_file_names(path, -(-n // kw["shard_rows"]))]
        nbytes = sum(os.path.getsize(f) for f in files)
        loaded, load_s = event_s(lambda: index_io.load_index(path))
        check_artifact(loaded, s, label, bf16="bf16" in label)
        print(f"save/load {label}: {nbytes:,} bytes in {len(files)} files, saved in "
              f"{save_s:.3f} s, loaded in {load_s:.3f} s; every array bit-identical to the "
              f"live searcher's{' (the base: its bf16 cast)' if 'bf16' in label else ''}")
        paths[label] = path
    return paths


def reloaded_entry_point(run, path: str, launches8: dict) -> None:
    """(b): ``serve --index <saved> --scorer pq --base-placement disk``:
    no build kernel, no k-means, and the in-memory device run's answers."""
    from repro_torch.core.bruteforce import ground_truth
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    args = serve.parser().parse_args(["--arch", "ann", "--device", "cuda", "--scorer", "pq",
                                      "--index", path, "--base-placement", "disk"])
    ops.reset_launch_counts()
    r, serve_s = event_s(lambda: serve.serve_ann(args))
    lc = ops.launch_counts()
    add_launches(launches8, lc)
    ops.reset_launch_counts()
    ground_truth(torch.cat(run.stream), run.searcher.base, run.spec.k, run.searcher.metric)
    gt_launches = ops.launch_counts()["distance_matrix"]
    print(f"reloaded entry point (--index, --base-placement disk): {serve_s:.2f} s, launches "
          f"{lc}; the stream's ground truth alone launches distance_matrix {gt_launches} times")
    check(r.build is None and not r.searcher._pq and r.searcher.pq is not None,
          "the reloaded entry point built or trained")
    check(lc["gather_distance_pool"] == 0 and lc["distance_matrix_small"] == 0
          and lc["distance_matrix"] == gt_launches,
          "the reloaded entry point launched a build kernel")
    for a, b, qa, qb in zip(r.results, run.results, r.stream, run.stream):
        check(torch.equal(qa, qb) and same_result(a, b),
              "the reloaded disk-tier run differs from the in-memory device run")
    print(f"  its {len(r.results)} batches: ids, dists, n_comps and n_steps bit-identical to "
          f"the in-memory searcher's under device placement; recall@10 "
          f"{r.summary['recall@10']:.4f}, {r.summary['qps']:.1f} qps, "
          f"{r.summary['tier_gathered_bytes']:,} tier bytes")
    r.searcher.base_store("disk").close()


def placements(run, launches8: dict) -> dict:
    """(c): pq and sq8 at device, host and disk (f32 and bf16 stores).
    Returns qps by (scorer, placement, dtype)."""
    from repro_torch.core.topk import recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    s = run.searcher
    d, ef, nq = s.base.shape[1], run.spec.ef, sum(q.shape[0] for q in run.stream)
    by, qps = {}, {}
    for scorer in ("pq", "sq8"):
        for placement in ("device", "host", "disk"):
            for dtype in (("f32", "bf16") if placement != "device" else ("f32",)):
                sp = run.spec._replace(scorer=scorer, base_placement=placement, store_dtype=dtype)
                s.search(run.stream[0], sp, serve.batch_seed(0, -1))
                ops.reset_launch_counts()
                res, secs = serve.serve_batches(s, sp, run.stream, run.seeds)
                add_launches(launches8, ops.launch_counts())
                sm = serve.summarize(res, run.ground_truth, run.spec.k)
                by[(scorer, placement, dtype)] = res
                qps[(scorer, placement, dtype)] = nq / secs
                print(f"{scorer} {placement} {dtype}: {nq / secs:.1f} qps, recall@10 "
                      f"{sm['recall@10']:.4f}, bytes/query {sm['bytes_per_query']:.1f}, "
                      f"{sm['steps_per_batch']:.1f} steps/batch")
        for a, h, dk in zip(*(by[(scorer, p, "f32")] for p in ("device", "host", "disk"))):
            check(same_result(a, h) and same_result(a, dk),
                  f"{scorer}: the placements' answers differ")
            check(torch.equal(a.bytes_touched, h.bytes_touched),
                  f"{scorer}: host bytes differ from device bytes")
            pages = dk.bytes_touched - (h.bytes_touched - ef * 4 * d)
            check(bool((pages > 0).all() and (pages % 4096 == 0).all()),
                  f"{scorer}: the disk tier does not bill whole pages")
        for h, hb in zip(by[(scorer, "host", "f32")], by[(scorer, "host", "bf16")]):
            check(torch.equal(h.bytes_touched - hb.bytes_touched,
                              torch.full_like(h.bytes_touched, ef * 2 * d)),
                  f"{scorer}: bf16 rows are not 2d bytes less a reranked row")
        rec = {dt: recall_at_k(torch.cat([x.ids for x in by[(scorer, "host", dt)]]),
                               run.ground_truth) for dt in ("f32", "bf16")}
        print(f"  {scorer}: device, host and disk (f32) bit-identical (ids, dists, n_comps, "
              f"n_steps), host bytes = device bytes, disk billed in whole pages; bf16 rows "
              f"{2 * d} bytes less a reranked row, recall@10 bf16 {rec['bf16']:.4f} vs f32 "
              f"{rec['f32']:.4f}")
    return qps


def streaming(run, launches8: dict) -> None:
    """(d): search_stream over the whole stream against per-tile searches."""
    from repro_torch.core.engine import _fold
    from repro_torch.kernels import ops

    s = run.searcher
    all_q = torch.cat(run.stream)
    for placement in ("host", "disk"):
        sp = run.spec._replace(base_placement=placement)
        ops.reset_launch_counts()
        st, st_s = event_s(lambda: s.search_stream(all_q, sp, 7, tile_q=PHASE8_TILE_Q))
        add_launches(launches8, ops.launch_counts())
        for i, lo in enumerate(range(0, all_q.shape[0], PHASE8_TILE_Q)):
            one = s.search(all_q[lo:lo + PHASE8_TILE_Q], sp, _fold(7, i))
            sl = slice(lo, lo + PHASE8_TILE_Q)
            check(torch.equal(st.ids[sl], one.ids) and torch.equal(st.dists[sl], one.dists)
                  and torch.equal(st.n_comps[sl], one.n_comps)
                  and torch.equal(st.bytes_touched[sl], one.bytes_touched),
                  f"search_stream ({placement}) differs from its tiles' searches")
        print(f"search_stream {placement} (tile_q={PHASE8_TILE_Q}): {all_q.shape[0]} queries in "
              f"{st_s:.3f} s ({all_q.shape[0] / st_s:.1f} qps), bit-identical to the per-tile "
              f"searches")


def filtered(run, launches8: dict, dev) -> None:
    """(e): four filters under exact (device) and pq (device, host, disk)."""
    from repro_torch.core.engine import filtered_brute_cutoff
    from repro_torch.core.filters import FilterSpec
    from repro_torch.core.topk import recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    s = run.searcher
    n = s.base.shape[0]
    all_q = torch.cat(run.stream)
    unfiltered = set()
    for scorer in ("exact", "pq"):
        res, _ = serve.serve_batches(s, run.spec._replace(scorer=scorer), run.stream, run.seeds)
        unfiltered |= {int(i) for x in res for i in x.ids.flatten().tolist() if i >= 0}
    filters = {"tenant=3": FilterSpec(tenant=3),
               "tags_any=(5, 9)": FilterSpec(tags_any=(5, 9)),
               "time_range=(0, 191)": FilterSpec(time_range=(0, 191)),
               "deny_ids=unfiltered top-10": FilterSpec(deny_ids=tuple(sorted(unfiltered)))}
    for name, f in filters.items():
        cf, compile_s = event_s(lambda: s.compiled_filter(f))
        allow = torch.zeros(n, dtype=torch.bool, device=dev)
        allow[cf.allowed_ids[:cf.n_allowed].long()] = True
        gt = filtered_ground_truth(all_q, s.base, allow, run.spec.k)
        brute = cf.n_allowed <= filtered_brute_cutoff(run.spec)
        print(f"filter {name}: {cf.n_allowed:,} allowed, compiled in {compile_s:.3f} s, "
              f"{'exact-scan' if brute else 'graph'} route")
        got = {}
        for scorer, placement in PHASE8_FILTER_RUNS:
            sp = run.spec._replace(scorer=scorer, base_placement=placement, filter=f)
            ops.reset_launch_counts()
            res, secs = serve.serve_batches(s, sp, run.stream, run.seeds)
            add_launches(launches8, ops.launch_counts())
            ids = torch.cat([x.ids for x in res])
            check(bool(((ids < 0) | allow[ids.clamp(min=0).long()]).all()),
                  f"filter {name}: an answer outside the allowed set ({scorer} {placement})")
            rec = recall_at_k(ids, gt)
            got[(scorer, placement)] = res
            print(f"  {scorer} {placement}: recall@10 {rec:.4f} over the allowed set, "
                  f"{all_q.shape[0] / secs:.1f} qps, comps/query "
                  f"{float(torch.cat([x.n_comps for x in res]).float().mean()):.1f}")
            if brute:
                check(rec == 1.0, f"filter {name}: the exact-scan route's recall@10 < 1")
        for placement in ("host", "disk"):
            check(all(same_result(a, b) for a, b in zip(got[("pq", "device")],
                                                      got[("pq", placement)])),
                  f"filter {name}: pq {placement} differs from pq device")
        if brute:
            brute_against_plain(s, run.spec._replace(filter=f), run.stream)
        else:
            for scorer in ("exact", "pq"):
                lockstep_rung(s, run.spec._replace(scorer=scorer, filter=f), run.stream,
                              run.seeds, got[(scorer, "device")])


def saved_tiered_filtered(run, rows: list, dev) -> None:
    """Phase 8 on phase 4's world and searcher (module docstring). Each
    driven run's launches are summed into the rows as ``phase8_launches``."""
    import shutil
    import tempfile

    from repro_torch.core import io as index_io
    from repro_torch.core.base_store import BaseStore

    s = run.searcher
    s.metadata = phase8_metadata(s.base.shape[0])
    launches8: dict[str, int] = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-index-")
    try:
        paths = save_and_load(s, tmp)
        reloaded_entry_point(run, paths["unsharded"], launches8)
        # the disk tier reranks straight off the artifact's shard files
        for label in ("f32-shards", "bf16-shards"):
            s.attach_store(BaseStore.from_shards(*index_io.open_base_shards(paths[label]),
                                                 device=s.device))
        qps = placements(run, launches8)
        streaming(run, launches8)
        filtered(run, launches8, dev)
        sp = run.spec._replace(base_placement="host")
        for placement in ("host", "disk"):
            host_ms, copy_ms, nbytes = tier_gather_split(
                s, sp._replace(base_placement=placement), run.stream[0], run.seeds[0],
                s.base_store(placement))
            print(f"{placement} tier gather of one batch ({nbytes:,} bytes of rows): host part "
                  f"{host_ms:.3f} ms (ids to the host, rows sliced into pinned memory, copy "
                  f"issued), H2D copy {copy_ms:.4f} ms (CUDA events)")
        busy_share(lambda: s.search(run.stream[0], sp, run.seeds[0]), "pq host-tier batch")
        print(f"qps by (scorer, placement, store): "
              f"{ {' '.join(key): round(v, 1) for key, v in qps.items()} }")
    finally:
        for store in s._stores.values():
            store.close()
        s._stores.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"launches over phase 8's runs: {launches8}")
    check(all(launches8.get(name, 0) > 0 for name in PHASE8_KERNELS),
          f"a kernel of phase 8's path never launched: {launches8}")
    for r in rows:
        r["phase8_launches"] = launches8.get(r["name"], 0)


# -- phase 9: streaming mutation ------------------------------------------------


def counted(launches: dict, fn):
    """``fn()`` with the launch counts set to 0 just before it and added to
    ``launches`` just after."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    add_launches(launches, ops.launch_counts())
    return res


def mutable_wrap(run, launches9: dict):
    """(a): ``MutableIndex.from_build`` over phase 4's NN-Descent + GD graph;
    its edge distances (NaN out of GD) recomputed through the pair kernel,
    held to the plain gather on the first 65,536 rows."""
    from repro_torch.core.mutable import MutableIndex
    from repro_torch.kernels import ref

    s = run.searcher
    midx, secs = event_s(lambda: counted(launches9, lambda: MutableIndex.from_build(
        s.base, run.build, rng_seed=0, insert_ef=PHASE9_INSERT_EF, diversify="gd")))
    nb = s.neighbors[:PHASE9_CHECK_ROWS]
    want = ref.gather_distance_ref(s.base[:PHASE9_CHECK_ROWS], nb.clamp(min=0), s.base)
    want = torch.where(nb >= 0, want, torch.full_like(want, float("inf")))
    got = torch.from_numpy(midx.dists[:PHASE9_CHECK_ROWS].copy()).to(s.device)
    err = max_abs_err(got, want)
    print(f"(a) MutableIndex.from_build over the n={midx.n_alloc:,} NN-Descent + GD graph "
          f"(R={midx.R}): {secs:.3f} s, its {midx.n_alloc:,} x {midx.R} edge distances "
          f"through the pair kernel; the first {PHASE9_CHECK_ROWS:,} rows against the plain "
          f"gather: max abs error {err:.3g}")
    check(bool(torch.isclose(got, want, **GATHER_TOL).all()),
          "the mutable index's edge distances differ from the plain gather's")
    return midx


def mutable_inserts(midx, launches9: dict, seed: int = 9):
    """(b): PHASE9_INSERTS inserts drawn from ``seed`` (the first one doubles
    the capacity), then PHASE9_DELETE_SHARE of the original ids deleted.
    Returns (inserted points, their ids, the deleted ids)."""
    from repro_torch.kernels import ops

    n0, d = midx.n_alloc, midx.d
    rng = np.random.default_rng(seed)
    # spare rows for profiler windows taken again (device_profile)
    xs = rng.standard_normal((PHASE9_INSERTS + 8 * PHASE9_PROFILED_INSERTS, d),
                             dtype=np.float32)
    first, first_s = event_s(lambda: counted(launches9, lambda: midx.insert(xs[0])))
    mirrors = {name: t.numel() * t.element_size() for name, t in
               (("base", midx._base_dev), ("neighbors", midx._nbrs_dev),
                ("alive", midx._alive_dev), ("tombstones", midx._tomb_dev))}
    print(f"(b) first insert (id {first}): {first_s:.3f} s, the capacity doubled "
          f"{n0:,} -> {midx.capacity:,} in {midx.part_s['grow']:.3f} s; bytes per device "
          f"mirror {mirrors}")
    check(midx.capacity == 2 * n0 and first == n0, "the first insert did not double the capacity")
    rest = PHASE9_INSERTS - 1 - PHASE9_PROFILED_INSERTS
    ids, rest_s = event_s(lambda: counted(launches9, lambda: midx.insert_batch(xs[1:1 + rest])))
    tail = iter(xs[1 + rest:])
    ops.reset_launch_counts()
    device_profile(lambda: midx.insert(next(tail)),
                   "one insert (Q=1 beam at ef=32, GD select, link, row writes)",
                   calls=PHASE9_PROFILED_INSERTS - 1)
    torch.cuda.synchronize()
    add_launches(launches9, ops.launch_counts())
    new_ids = np.arange(n0, midx.n_alloc)
    xs = xs[: new_ids.size]
    check(new_ids.size >= PHASE9_INSERTS and np.array_equal(ids, new_ids[1:1 + rest]),
          "inserts were not given consecutive ids")
    split = midx.insert_ms()
    print(f"  {rest} inserts in {rest_s:.2f} s; insert_rate {midx.insert_rate:.1f} inserts/s "
          f"over all {midx.total_inserts}; ms an insert by part (device synchronised at each "
          f"part's end): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    dead = rng.choice(n0, size=int(PHASE9_DELETE_SHARE * n0), replace=False)
    _, del_s = event_s(lambda: midx.delete(dead))
    print(f"  deleted {dead.size:,} of the original ids in {del_s:.3f} s: n_live "
          f"{midx.n_live:,}, n_dead {midx.n_dead:,}, staleness {midx.staleness:.4f}, "
          f"stats {midx.stats()}")
    check(midx.n_live == n0 + new_ids.size - dead.size, "n_live after the deletes")
    return xs, new_ids, dead


def mutable_search(run, midx, xs, new_ids, launches9: dict) -> dict:
    """(c): the stream under exact/device, pq/device, pq/disk and sq8/disk
    on the mutated index: no dead or unallocated id in any answer,
    recall@10 over the live set, pq's placements bit-identical, kernel path
    against plain path in lock-step with the tombstones, and inserted
    points searched as queries. Returns the served results by run."""
    from repro_torch.core.topk import recall_at_k
    from repro_torch.launch import serve

    s9 = midx.searcher()
    dev = s9.device
    all_q = torch.cat(run.stream)
    alive = midx._alive_dev
    gt, gt_s = event_s(lambda: counted(launches9, lambda: filtered_ground_truth(
        all_q, s9.base, alive, run.spec.k)))
    print(f"(c) searcher over the {midx.capacity:,}-row mirrors ({midx.n_live:,} live); "
          f"ground truth over the live set in {gt_s:.3f} s")
    specs = {(sc, pl): run.spec._replace(scorer=sc, base_placement=pl) for sc, pl in PHASE9_RUNS}
    _, pq_s = event_s(lambda: counted(launches9, lambda: s9.pq_index(specs[("pq", "device")])))
    _, spill_s = event_s(lambda: s9.base_store("disk"))
    pq_spec = specs[("pq", "device")]
    print(f"  pq table (M={pq_spec.pq_m}, K={pq_spec.pq_k}) trained on the capacity rows in "
          f"{pq_s:.2f} s; the base "
          f"spilled to the disk tier in {spill_s:.2f} s")
    served = {}
    nq = all_q.shape[0]
    for key, sp in specs.items():
        res, secs = event_s(lambda: counted(launches9, lambda: serve.serve_batches(
            s9, sp, run.stream, run.seeds)[0]))
        ids = torch.cat([x.ids for x in res])
        valid = ids >= 0
        bad = valid & ((ids >= midx.n_alloc) | ~alive[ids.clamp(min=0).long()])
        served[key] = res
        print(f"  {key[0]} {key[1]}: {nq / secs:.1f} qps, recall@10 over the live set "
              f"{recall_at_k(ids, gt):.4f}, comps/query "
              f"{float(torch.cat([x.n_comps for x in res]).float().mean()):.1f}, dead or "
              f"unallocated ids in the answers: {int(bad.sum())}")
        check(int(bad.sum()) == 0, f"a dead or unallocated id answered ({key})")
        check(bool(valid.any()), f"no answers at all ({key})")
    check(all(same_result(a, b) for a, b in zip(served[("pq", "device")],
                                              served[("pq", "disk")])),
          "pq disk differs from pq device on the mutated index")
    print("  pq device and disk: ids, dists, n_comps and n_steps bit-identical")
    for scorer in ("exact", "pq"):
        lockstep_rung(s9, specs[(scorer, "device")], run.stream, run.seeds,
                      served[(scorer, "device")])
    x64 = torch.from_numpy(xs[:PHASE9_SELF_QUERIES]).to(dev)
    res = counted(launches9, lambda: s9.search(x64, specs[("exact", "device")], 5))
    hits = int((res.ids[:, 0].cpu().numpy() == new_ids[:PHASE9_SELF_QUERIES]).sum())
    print(f"  {PHASE9_SELF_QUERIES} inserted points searched as queries (exact, ef="
          f"{run.spec.ef}): {hits} find themselves at rank 1 (not gated: this world's "
          f"recall@1 is 0.0645)")
    for store in s9._stores.values():
        store.close()
    s9._stores.clear()
    return served


def mutable_compact(midx, dev, launches9: dict):
    """(d): compact with a seed, then ``build_index`` of the survivors with
    the same spec and seed: neighbors and base bit-identical on the card."""
    from repro_torch.core.build import BuildSpec, build_index
    from repro_torch.core.topk import INVALID

    spec9 = BuildSpec(graph_k=20, nd_rounds=15)
    alive = midx.alive
    survivors = midx.base[alive].copy()
    n_alloc = midx.n_alloc
    cres, c_s = event_s(lambda: counted(launches9, lambda: midx.compact(spec9, seed=9)))
    fresh, f_s = event_s(lambda: build_index(torch.from_numpy(survivors).to(dev), spec9, seed=9))
    rep = cres.report
    differ = int((cres.graph.neighbors != fresh.graph.neighbors).any(1).sum())
    print(f"(d) compact of {survivors.shape[0]:,} survivors: {c_s:.2f} s (rounds {rep.rounds}, "
          f"graph-recall proxy {rep.graph_recall_proxy}, construct {rep.wall_construct_s:.2f} "
          f"s, diversify {rep.wall_diversify_s:.2f} s); report stamps staleness "
          f"{rep.staleness}, inserts {rep.inserts}, insert_rate {rep.insert_rate}; a fresh "
          f"build of the survivors {f_s:.2f} s (rounds {fresh.report.rounds}); rows whose "
          f"neighbors differ: {differ}")
    check(differ == 0 and torch.equal(cres.graph.neighbors, fresh.graph.neighbors),
          "compaction differs from a fresh build of the survivors on the card")
    check(torch.equal(cres.hubs, fresh.hubs), "compaction's hubs differ from the fresh build's")
    check(np.array_equal(midx.base, survivors), "the compacted base is not the survivors")
    id_map = midx.last_id_map
    check(id_map.shape == (n_alloc,) and bool((id_map[~alive] == INVALID).all())
          and np.array_equal(id_map[alive], np.arange(survivors.shape[0])),
          "last_id_map does not map the survivors in order")
    check(midx.version == 1 and midx.staleness == 0.0 and midx.n_dead == 0,
          "compaction did not reset the index")
    print("  neighbors, hubs and base bit-identical to the fresh build; last_id_map, "
          "version 1, staleness 0")
    return spec9, cres


def mutable_checkpoint(run, midx, spec9, cres, dev) -> None:
    """(e): checkpoint into a temporary directory, then load_index and
    from_artifact: every array bit-identical, and a batch from the same
    entries bit-identical to the compacted index's."""
    import shutil
    import tempfile

    from repro_torch.core import io as index_io
    from repro_torch.core.beam_search import random_entries
    from repro_torch.core.mutable import MutableIndex

    tmp = tempfile.mkdtemp(prefix="chip-smoke-mutable-")
    try:
        (path, ck), ck_s = event_s(lambda: midx.checkpoint(os.path.join(tmp, "mutable"), spec9,
                                                           seed=9))
        check(torch.equal(ck.graph.neighbors, cres.graph.neighbors),
              "the checkpoint's rebuild differs from the compaction's")
        nbytes = os.path.getsize(path)
        art, load_s = event_s(lambda: index_io.load_index(path))
        m2, wrap_s = event_s(lambda: MutableIndex.from_artifact(art, device=dev))
        for name in ("base", "neighbors", "dists", "alive"):
            check(np.array_equal(getattr(m2, name), getattr(midx, name)),
                  f"the reloaded {name} differs")
        check(art.provenance["mutable_version"] == midx.version == 2
              and m2.rng_seed == midx.rng_seed, "the checkpoint's version or key")
        q = run.stream[0]
        gen = torch.Generator(device=dev).manual_seed(11)
        ent = random_entries(gen, midx.n_alloc, q.shape[0], run.spec.num_seeds)
        sp = run.spec._replace(scorer="exact")
        a = midx.search(q, sp, entries=ent)
        b = m2.search(q, sp, entries=ent)
        check(same_result(a, b), "the reloaded index answers otherwise than the compacted one")
        print(f"(e) checkpoint (compact again, then save): {ck_s:.2f} s, {nbytes:,} bytes; "
              f"load_index {load_s:.3f} s, from_artifact {wrap_s:.3f} s (edge distances "
              f"recomputed); base, neighbors, dists and alive bit-identical, version "
              f"{art.provenance['mutable_version']}; a batch from the same entries "
              f"bit-identical (ids, dists, n_comps, n_steps)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def incremental_construct(dev, launches9: dict) -> None:
    """(f): the incremental construct on the smoke world: exact mode on
    its first PHASE9_EXACT_POINTS points bit-identical to
    ``construct="exact"``; beam mode (insert_ef=64, GD
    inline) through ``serve.build_searcher`` on the first
    PHASE9_BEAM_POINTS points against NN-Descent + GD over the same points."""
    from repro_torch.core.bruteforce import ground_truth
    from repro_torch.core.build import BuildSpec, build_index
    from repro_torch.core.topk import recall_at_k
    from repro_torch.launch import serve

    n, d = serve.SMOKE_WORLD
    base = torch.from_numpy(serve.numpy_world(n, d, 0)[:PHASE9_EXACT_POINTS]).to(dev)
    n = base.shape[0]
    kw = dict(diversify="none", graph_k=20)
    inc, inc_s = event_s(lambda: counted(launches9, lambda: build_index(
        base, BuildSpec(construct="incremental", insert_ef=0, **kw), seed=0)))
    bat, bat_s = event_s(lambda: build_index(base, BuildSpec(construct="exact", **kw), seed=0))
    same = (torch.equal(inc.graph.neighbors, bat.graph.neighbors)
            and torch.equal(inc.graph.dists, bat.graph.dists))
    print(f"(f) construct=incremental, insert_ef=0, n={n:,}, d={d}, graph_k=20: {inc_s:.2f} s "
          f"({inc.report.insert_rate:.1f} inserts/s, {1e3 / inc.report.insert_rate:.3f} ms an "
          f"insert); construct=exact {bat_s:.2f} s; neighbors and dists bit-identical: {same}")
    check(same, "exact-mode incremental differs from construct='exact' on the card")
    sub = base[:PHASE9_BEAM_POINTS].contiguous()
    (s_inc, r_inc), b_s = event_s(lambda: counted(launches9, lambda: serve.build_searcher(
        sub, construct="incremental", seed=0)))
    (s_nd, r_nd), nd_s = event_s(lambda: serve.build_searcher(sub, construct="nndescent",
                                                              seed=0))
    stream = [torch.from_numpy(q).to(dev) for q in serve.numpy_queries(d, 64, 8, 0)]
    seeds = [serve.batch_seed(0, b) for b in range(len(stream))]
    gt = ground_truth(torch.cat(stream), sub, 10)
    rec = {}
    for name, s in (("incremental", s_inc), ("nndescent", s_nd)):
        res, _ = serve.serve_batches(s, s.spec(ef=64, k=10), stream, seeds)
        rec[name] = recall_at_k(torch.cat([x.ids for x in res]), gt)
    print(f"  construct=incremental (insert_ef=64, GD inline) on the first "
          f"{PHASE9_BEAM_POINTS:,} points (cut: an insert's Q=1 beam is host-bound): "
          f"{b_s:.2f} s, {r_inc.report.insert_rate:.1f} inserts/s, degree mean "
          f"{r_inc.report.degree['mean']}; recall@10 of {len(stream) * 64} queries (ef=64) "
          f"{rec['incremental']:.4f} against nndescent + gd's {rec['nndescent']:.4f} over "
          f"the same points (built in {nd_s:.2f} s)")
    check(r_inc.report.inserts == PHASE9_BEAM_POINTS and 0.0 < rec["incremental"] <= 1.0,
          "the beam-mode incremental construct")


def time_mutation_shapes(run, midx, rows: list, errs: dict) -> None:
    """(g): the mutation path's new shapes per recorded launch, each beside
    its plain version (and the library call where there is one) on the
    same inputs, held to it, into the rows' ``shapes``: the Q=1 hop, the
    exact scan's forward and reverse blocks over the capacity rows (and the
    one-row operand's bits and time beside them), the GD select's 32 x 32
    block and the 1M x 20 edge-distance pass."""
    from repro_torch.kernels import gather_distance as kgd
    from repro_torch.kernels import ops, ref
    from repro_torch.core.mutable import SCAN_BLOCK

    by_name = {r["name"]: r for r in rows}
    base = midx._base_dev
    C, d = base.shape
    dev = base.device
    gen = torch.Generator(device=dev).manual_seed(12)
    n = midx.n_alloc

    def add(name, shape, k_ms, p_ms, nbytes, flops, lib_ms=None, **extra):
        b_ms, b_by = bound(nbytes, flops)
        by_name[name].setdefault("shapes", []).append(dict(
            shape=shape, launches=1, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, **extra))
        print(f"  {name} {shape}: {k_ms * 1e3:.3f} us per recorded launch, plain "
              f"{p_ms * 1e3:.3f} us" + ("" if lib_ms is None else f", library {lib_ms * 1e3:.3f} us")
              + f"; bound {b_ms * 1e3:.3f} us ({b_by}; {k_ms / b_ms:.1f}x)")

    # the insert's beam hop: Q=1 x R=20 over the capacity rows
    R = midx.R
    sets = [torch.randint(0, n, (1, R), generator=gen, device=dev, dtype=torch.int32)
            for _ in range(16)]
    x = base[:1].clone()
    visited = torch.zeros((1, (C + 31) // 32), dtype=torch.int32, device=dev)
    it = iter(range(10**9))
    k_ms = device_ms(lambda: ops.gather_distance_masked(x, sets[next(it) % 16], base, visited),
                     reps=64, match=HOP_KERNEL, launches=1)
    p_ms = cuda_ms(lambda: ref.gather_distance_masked_ref(x, sets[next(it) % 16], base, visited),
                   reps=64)
    kd, ki = ops.gather_distance_masked(x, sets[0], base, visited)
    pd, pi = ref.gather_distance_masked_ref(x, sets[0], base, visited)
    check(torch.equal(ki, pi) and bool(torch.isclose(kd, pd, **GATHER_TOL).all()),
          "the Q=1 hop differs from the plain version")
    errs["gather_distance_masked"] = max(errs["gather_distance_masked"], max_abs_err(kd, pd))
    add("gather_distance_masked", f"insert hop, Q=1 x R={R}, d={d}, over {C:,} rows", k_ms, p_ms,
        d * 4 + R * 4 + R * (4 * d + 4) + R * 8, R * 3 * d)

    # the exact scan: forward (128-row block x C) and reverse (C x 128 block)
    block = torch.zeros((SCAN_BLOCK, d), dtype=torch.float32, device=dev)
    block[0] = base[n // 2]
    scan_bytes = SCAN_BLOCK * d * 4 + C * d * 4 + SCAN_BLOCK * C * 4
    scan_flops = 2.0 * SCAN_BLOCK * C * d + 3.0 * SCAN_BLOCK * C
    for label, fn, plain, lib, one in (
            ("forward", lambda: ops.distance_matrix(block, base),
             lambda: ref.distance_matrix_ref(block, base),
             lambda: torch.cdist(block, base) ** 2,
             lambda: ops.distance_matrix(block[:1], base)),
            ("reverse", lambda: ops.distance_matrix(base, block),
             lambda: ref.distance_matrix_ref(base, block),
             lambda: torch.cdist(base, block) ** 2,
             lambda: ops.distance_matrix(base, block[:1]))):
        k_ms = device_ms(fn, reps=5, match=MATRIX_KERNEL, launches=1)
        one_ms = device_ms(one, reps=5, match=MATRIX_KERNEL, launches=1)
        p_ms = cuda_ms(plain, reps=3)
        lib_ms = cuda_ms(lib, reps=3)
        got, want, row = fn(), plain(), one()
        vec = got[0] if label == "forward" else got[:, 0]
        vec1 = row[0] if label == "forward" else row[:, 0]
        same = int((vec != vec1).sum())
        check(bool(torch.isclose(got, want, rtol=MATRIX_RTOL, atol=MATRIX_ATOL * d).all()),
              f"the {label} scan differs from the plain matrix")
        errs["distance_matrix"] = max(errs["distance_matrix"], max_abs_err(got, want))
        one_bound, one_by = bound(d * 4 + C * d * 4 + C * 4, 2.0 * C * d + 3.0 * C)
        print(f"  exact scan {label}: the block's entries of the point against the one-row "
              f"operand's: {same} of {C:,} differ (one-row call {one_ms * 1e3:.3f} us, its own "
              f"bound {one_bound * 1e3:.3f} us ({one_by}; {one_ms / one_bound:.1f}x))")
        shape = (f"exact insert's {label} scan, {SCAN_BLOCK}-row block x {C:,} x {d}"
                 if label == "forward" else
                 f"exact insert's {label} scan, {C:,} x {SCAN_BLOCK}-row block x {d}")
        add("distance_matrix", shape, k_ms, p_ms, scan_bytes, scan_flops, lib_ms,
            one_row_ms=one_ms, one_row_bound_ms=one_bound, one_row_bits_differ=same)
        del got, want, row
        torch.cuda.empty_cache()

    # the GD select's pair matrix at insert_ef=32: 32 x 32 x d, x is y
    ids = torch.randint(0, n, (PHASE9_INSERT_EF,), generator=gen, device=dev)
    rows32 = base[ids]
    k_ms = device_ms(lambda: ops.distance_matrix(rows32, rows32), reps=64,
                     match=SMALL_MATRIX_KERNEL, launches=1)
    p_ms = cuda_ms(lambda: ref.distance_matrix_ref(rows32, rows32), reps=64)
    lib_ms = cuda_ms(lambda: torch.cdist(rows32, rows32) ** 2, reps=64)
    got, want = ops.distance_matrix(rows32, rows32), ref.distance_matrix_ref(rows32, rows32)
    check(bool(torch.isclose(got, want, rtol=MATRIX_RTOL, atol=MATRIX_ATOL * d).all()),
          "the GD select's matrix differs from the plain version")
    errs["distance_matrix_small"] = max(errs["distance_matrix_small"], max_abs_err(got, want))
    L = PHASE9_INSERT_EF
    add("distance_matrix_small", f"inline GD select, {L} x {L} x {d}, x is y", k_ms, p_ms,
        L * d * 4 + L * L * 4, 2.0 * L * L * d + 3.0 * L * L, lib_ms)

    # the edge-distance pass of MutableIndex.from_build: 1M x R pairs
    s = run.searcher
    nb = s.neighbors.clamp(min=0).contiguous()
    N1, R1 = nb.shape
    k_ms = device_ms(lambda: kgd.gather_distance(s.base, nb, s.base), reps=3,
                     match=PAIR_KERNEL, launches=1)
    p_ms = cuda_ms(lambda: ref.gather_distance_ref(s.base, nb, s.base), reps=1, warmup=1)
    got = kgd.gather_distance(s.base[:PHASE9_CHECK_ROWS], nb[:PHASE9_CHECK_ROWS], s.base)
    want = ref.gather_distance_ref(s.base[:PHASE9_CHECK_ROWS], nb[:PHASE9_CHECK_ROWS], s.base)
    check(bool(torch.isclose(got, want, **GATHER_TOL).all()),
          "the edge-distance pass differs from the plain gather")
    errs["gather_distance"] = max(errs["gather_distance"], max_abs_err(got, want))
    add("gather_distance", f"edge distances, {N1:,} x {R1}, d={d}", k_ms, p_ms,
        N1 * d * 4 * 2 + N1 * R1 * 4 * 2, N1 * R1 * 3.0 * d)
    torch.cuda.empty_cache()


def mutation_phase(run, rows: list, errs: dict, dev) -> dict:
    """Phase 9 on phase 4's world (module docstring). Returns the launches
    over its driven runs, by kernel."""
    launches9: dict[str, int] = {}
    t = time.perf_counter()
    midx = mutable_wrap(run, launches9)
    xs, new_ids, dead = mutable_inserts(midx, launches9)
    print(f"  [(a)-(b)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    mutable_search(run, midx, xs, new_ids, launches9)
    print(f"  [(c)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    time_mutation_shapes(run, midx, rows, errs)
    print(f"  [(g)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    spec9, cres = mutable_compact(midx, dev, launches9)
    mutable_checkpoint(run, midx, spec9, cres, dev)
    del midx
    torch.cuda.empty_cache()
    print(f"  [(d)-(e)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    incremental_construct(dev, launches9)
    print(f"  [(f)] {time.perf_counter() - t:.1f} s")
    print(f"launches over phase 9's runs: {launches9}")
    check(all(launches9.get(name, 0) > 0 for name in PHASE9_KERNELS),
          f"a kernel of phase 9's path never launched: {launches9}")
    return launches9


# -- phase 10: the continuous-batching server -----------------------------------


def served_vs_direct(completed, requests, searcher, spec, offset: int = 0):
    """(matched, checked, direct top-1 ids by rid): each completed request
    whose rid - ``offset`` indexes ``requests`` against a direct
    ``Searcher.search`` of its rows with its seed (and its filter), ids,
    dists and n_comps bit for bit; run off the timed path."""
    ok = checked = 0
    top1 = {}
    for req in completed:
        i = req.rid - offset
        if not 0 <= i < len(requests):
            continue
        r = requests[i]
        sp = spec if req.filter is None else spec._replace(filter=req.filter)
        res = searcher.search(torch.from_numpy(r.rows).to(searcher.device), sp, r.seed)
        ids = res.ids.cpu().numpy()
        top1[req.rid] = ids[:, 0]
        checked += 1
        ok += int(np.array_equal(req.ids, ids)
                  and np.array_equal(req.dists, res.dists.cpu().numpy())
                  and np.array_equal(req.n_comps, res.n_comps.cpu().numpy()))
    return ok, checked, top1


def serve_entry_point(launches10: dict) -> None:
    """(a): ``serve --arch ann --smoke --serve`` at the reference's defaults;
    every completed request against its direct search, and the served
    recall@1 against the direct twins' on the completed rows."""
    from repro_torch.launch import loadgen, serve

    run10 = counted(launches10, lambda: serve.serve_ann(serve.parser().parse_args(
        ["--arch", "ann", "--smoke", "--device", "cuda", "--serve"])))
    st = run10.summary["serve"]
    sv = run10.served
    reqs, s = sv.streams[0]
    ok, checked, top1 = served_vs_direct(sv.server.completed, reqs, s, run10.spec)
    hits = sum(int((top1[rid] == sv.ground_truth[reqs[rid].start:
                                                  reqs[rid].start + len(top1[rid]), 0]).sum())
               for rid in top1)
    twin_r1 = hits / max(sum(len(v) for v in top1.values()), 1)
    served_r1, _ = loadgen._recall_comps(sv.server.completed, reqs, sv.ground_truth)
    print(f"(a) serve --smoke --serve: {st['completed']} completed + {st['shed']} shed of "
          f"{st['requests']} (offered {st['offered_qps']:.0f} rows/s), p50 {st.get('p50_ms')} ms, "
          f"p99 {st.get('p99_ms')} ms, largest live window {st['max_live']}; parity "
          f"{ok}/{checked}; served recall@1 {served_r1:.4f}, direct twins {twin_r1:.4f}")
    check(st["completed"] + st["shed"] == st["requests"] == 200,
          "serve --serve: completed + shed != 200")
    check(ok == checked == st["completed"], "serve --serve: a served request differs from "
                                            "its direct search")
    check(served_r1 == twin_r1, "serve --serve: served recall@1 differs from the direct twins'")


def sweep(run, spec, pool, gt, launches10: dict) -> dict:
    """(b): closed-batch capacity, the paced single-request wall, and the
    open loop at PHASE10_LOAD_FACTORS x capacity over PHASE10_SWEEP_REQUESTS
    requests."""
    from repro_torch.launch import loadgen

    out = counted(launches10, lambda: loadgen.serving_sweep(
        run.searcher, spec, pool, gt, load_factors=PHASE10_LOAD_FACTORS,
        n_requests=PHASE10_SWEEP_REQUESTS, seed=0, out=lambda m: print(f"(b) {m}")))
    print(f"(b) capacity {out['serving_capacity_qps']} rows/s, paced single-request wall p99 "
          f"{out['serving_ref_wall_ms']} ms, direct twins recall@1 "
          f"{out['serving_batch_recall_at_1']}, comps/query "
          f"{out['serving_batch_comps_per_query']}")
    for row in out["serving_sweep"]:
        lf = row["load_factor"]
        check(row["parity"] == 1.0, f"sweep x{lf}: parity {row['parity']}")
        check(row["completed"] + row["shed"] == PHASE10_SWEEP_REQUESTS,
              f"sweep x{lf}: completed + shed != {PHASE10_SWEEP_REQUESTS}")
        check(row["timestamps_ordered"], f"sweep x{lf}: timestamps out of order")
    check(out["serving_sweep"][-1]["shed"] > 0,
          f"sweep x{PHASE10_LOAD_FACTORS[-1]}: nothing shed (the shedding path never ran)")
    return out


def scorer_parity(run, spec, pool, launches10: dict) -> None:
    """(c): closed loops of PHASE10_PARITY_REQUESTS requests under pq
    (device and host) and sq8 (device), and one where every third request
    carries the tenant=3 filter: every request bit-identical to its direct
    search."""
    from repro_torch.core.filters import FilterSpec
    from repro_torch.launch import loadgen
    from repro_torch.launch.server import AnnServer

    s = run.searcher
    reqs = loadgen.make_requests(pool, PHASE10_PARITY_REQUESTS, loadgen.REQUEST_SIZES, 3,
                                 base_seed=11)
    tenant = FilterSpec(tenant=3)
    cases = {"pq device": (spec._replace(scorer="pq"), False),
             "pq host": (spec._replace(scorer="pq", base_placement="host"), False),
             "sq8 device": (spec._replace(scorer="sq8"), False),
             "exact + tenant=3 on every third": (spec, True)}
    try:
        for label, (sp, filt) in cases.items():
            server = AnnServer(s, sp, loadgen.SWEEP_CONFIG)
            server.warmup()

            def drive():
                for i, r in enumerate(reqs):
                    server.submit_wait(r.rows, r.seed,
                                       filter=tenant if filt and i % 3 == 0 else None)
                server.drain()

            _, secs = event_s(lambda: counted(launches10, drive))
            ok, checked, _ = served_vs_direct(server.completed, reqs, s, sp)
            st = server.stats()
            print(f"(c) {label}: {checked} requests in {secs:.2f} s, p50 {st['p50_ms']} ms, "
                  f"parity {ok}/{checked}")
            check(ok == checked == PHASE10_PARITY_REQUESTS,
                  f"{label}: a served request differs from its direct search")
            if filt:
                allowed = s.metadata["tenant"] == 3
                bad = sum(int((~allowed[req.ids[req.ids >= 0]]).sum())
                          for req in server.completed if req.filter is not None)
                check(bad == 0, f"{label}: {bad} answers outside tenant 3")
    finally:
        store = s._stores.pop(("host", "f32"), None)
        if store is not None:
            store.close()


def serve_mutate(run, spec, pool, launches10: dict) -> dict:
    """(d): a MutableIndex over phase 4's graph (the first insert doubles
    the capacity to 2M), a snapshot Searcher serving a first stream,
    PHASE10_INSERTS inserts (insert_ef=32, GD inline) and PHASE10_DELETES
    deletes, a hot swap with requests queued at the flip, a second stream
    of PHASE10_POST_SWAP_REQUESTS requests."""
    from repro_torch.core.mutable import MutableIndex
    from repro_torch.launch import loadgen
    from repro_torch.launch.server import AnnServer, prepared_state

    s = run.searcher
    midx = counted(launches10, lambda: MutableIndex.from_build(
        s.base, run.build, rng_seed=0, insert_ef=PHASE9_INSERT_EF, diversify="gd"))
    n0, d = midx.n_alloc, midx.d
    xs = np.random.default_rng(10).standard_normal((PHASE10_INSERTS, d), dtype=np.float32)
    counted(launches10, lambda: midx.insert(xs[0]))       # the capacity doubles to 2M
    s0 = midx.searcher()
    q = torch.from_numpy(pool[:64]).to(s.device)
    snap_before = s0.search(q, spec, 5)
    mirrors = {name: getattr(midx, attr) for name, attr in
               (("base", "_base_dev"), ("neighbors", "_nbrs_dev"), ("tombstones", "_tomb_dev"))}
    clone_ms = {name: event_s(lambda t=t: t.clone())[1] * 1e3 for name, t in mirrors.items()}
    clone_bytes = {name: t.numel() * t.element_size() for name, t in mirrors.items()}
    print(f"(d) MutableIndex over n={n0:,} (capacity {midx.capacity:,} after the first insert); "
          f"a clone of each mirror (the copy a write to a shared mirror makes; CUDA events): "
          + ", ".join(f"{k} {clone_ms[k]:.3f} ms / {clone_bytes[k]:,} bytes" for k in clone_ms))

    reqs_a = loadgen.make_requests(pool, PHASE10_PRE_SWAP_REQUESTS, loadgen.REQUEST_SIZES, 4,
                                   base_seed=41)
    reqs_q = loadgen.make_requests(pool, PHASE10_QUEUED_AT_FLIP, loadgen.REQUEST_SIZES, 5,
                                   base_seed=42)
    reqs_b = loadgen.make_requests(pool, PHASE10_POST_SWAP_REQUESTS, loadgen.REQUEST_SIZES, 6,
                                   base_seed=43)
    server = AnnServer(s0, spec, loadgen.SWEEP_CONFIG)
    server.warmup()
    counted(launches10, lambda: loadgen.run_closed_loop(server, reqs_a))

    (_, mut_s) = event_s(lambda: counted(launches10, lambda: midx.insert_batch(xs[1:])))
    dead = np.random.default_rng(0).choice(n0, size=PHASE10_DELETES, replace=False)
    midx.delete(dead)
    print(f"  {PHASE10_INSERTS - 1} more inserts in {mut_s:.2f} s "
          f"({(PHASE10_INSERTS - 1) / mut_s:.1f}/s), {dead.size} deletes; clones made: "
          f"{midx.cow_clones} ({midx.cow_bytes:,} bytes)")
    check(midx.cow_clones == 3 and midx.cow_bytes == sum(clone_bytes.values()),
          "the inserts after searcher() did not clone each shared mirror once")
    snap_after = s0.search(q, spec, 5)
    check(same_result(snap_before, snap_after),
          "the Searcher taken before the inserts answers differently after them")

    for r in reqs_q:
        server.submit(r.rows, r.seed, advance=False)
    s1 = midx.searcher()
    version = counted(launches10, lambda: server.swap(s1, seed=23))
    ev = server.swap_events[-1]
    at_flip = prepared_state(s1)
    counted(launches10, lambda: (server.drain(), loadgen.run_closed_loop(server, reqs_b)))
    after = prepared_state(s1)
    na = len(reqs_a)
    ok_a, n_a, _ = served_vs_direct(server.completed, reqs_a, s0, spec)
    ok_q, n_q, _ = served_vs_direct(server.completed, reqs_q, s1, spec, offset=na)
    ok_b, n_b, _ = served_vs_direct(server.completed, reqs_b, s1, spec,
                                    offset=na + len(reqs_q))
    alive = midx._alive
    post = [r for r in server.completed if r.rid >= na]
    bad = sum(int(((req.ids >= midx.n_alloc) | ~alive[np.clip(req.ids, 0, None)])
                  [req.ids >= 0].sum()) for req in post)
    st = server.stats()
    print(f"  hot swap v{version}: warm_s {ev['warm_s']} ({ev['live_at_flip']} live / "
          f"{ev['queued_at_flip']} queued at the flip); parity before {ok_a}/{n_a}, queued "
          f"{ok_q}/{n_q}, after {ok_b}/{n_b}; dead or unallocated ids in answers: {bad}; "
          f"shed {st['shed']}; state at the flip {at_flip}, after the requests {after}")
    check(ev["queued_at_flip"] == PHASE10_QUEUED_AT_FLIP and ok_q == n_q == len(reqs_q),
          "the requests queued at the flip were not answered by the new version")
    check(ok_a == n_a == na and ok_b == n_b == len(reqs_b),
          "a served request differs from direct search on the version that served it")
    check(bad == 0, f"{bad} dead or unallocated ids served after the swap")
    check(after == at_flip, "a kernel library or per-index state was built after the flip")
    check(st["shed"] == 0, "a closed-loop request was shed")
    return {"warm_s": ev["warm_s"], "clone_ms": clone_ms, "clone_bytes": clone_bytes}


def request_profile(run, spec, pool, sweep_out: dict) -> None:
    """(e): one bucket-16 request under the profiler (device-busy share),
    and the time in queue against the time in service at each sweep point."""
    from repro_torch.launch import loadgen
    from repro_torch.launch.server import AnnServer

    server = AnnServer(run.searcher, spec, loadgen.SWEEP_CONFIG)
    rows = pool[:16]
    busy_share(lambda: server._search_padded(rows, 77, 16), "(e) one bucket-16 request")
    for row in sweep_out["serving_sweep"]:
        print(f"(e) x{row['load_factor']}: mean time in queue {row['mean_queue_ms']} ms, "
              f"in service {row['mean_service_ms']} ms (admit -> complete)")


def serving_phase(run, rows: list, dev) -> dict:
    """Phase 10 on phase 4's world (module docstring). Returns the launches
    over its driven runs, by kernel."""
    from repro_torch.core.bruteforce import ground_truth

    launches10: dict[str, int] = {}
    spec = run.spec._replace(scorer="exact")
    d = run.searcher.base.shape[1]
    pool = np.random.default_rng(1010).standard_normal((PHASE10_POOL, d), dtype=np.float32)
    gt = ground_truth(torch.from_numpy(pool).to(dev), run.searcher.base, 1).cpu().numpy()
    t = time.perf_counter()
    serve_entry_point(launches10)
    print(f"  [(a)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    sweep_out = sweep(run, spec, pool, gt, launches10)
    print(f"  [(b)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    scorer_parity(run, spec, pool, launches10)
    print(f"  [(c)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    serve_mutate(run, spec, pool, launches10)
    torch.cuda.empty_cache()
    print(f"  [(d)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    request_profile(run, spec, pool, sweep_out)
    print(f"  [(e)] {time.perf_counter() - t:.1f} s")
    print(f"launches over phase 10's runs: {launches10}")
    check(all(launches10.get(name, 0) > 0 for name in PHASE10_KERNELS),
          f"a kernel of phase 10's path never launched: {launches10}")
    return launches10


# -- phase 11: sharded search ------------------------------------------------------


def shard_builds(run, launches11: dict):
    """(a): ``shard_build`` with P=4 under phase 4's BuildSpec; each shard's
    stage seconds and graph-recall proxy."""
    from repro_torch.distributed.sharded_ann import shard_build

    spec = run.build.report.spec
    sb, s = event_s(lambda: counted(launches11, lambda: shard_build(
        run.searcher.base, PHASE11_SHARDS, spec=spec, seed=PHASE11_SEED)))
    for i, rep in enumerate(sb.reports):
        print(f"  shard {i} ({rep.n:,} rows): build {rep.wall_total_s:.3f} s (construct "
              f"{rep.wall_construct_s:.3f}, diversify {rep.wall_diversify_s:.3f}, compress "
              f"{rep.wall_compress_s:.3f}), rounds {rep.rounds}, graph-recall proxy "
              f"{rep.graph_recall_proxy}")
        check(0.0 < rep.graph_recall_proxy <= 1.0, f"shard {i}'s graph-recall proxy out of range")
    print(f"  shard_build P={PHASE11_SHARDS}: {s:.2f} s (phase 4's single build "
          f"{run.build.report.wall_total_s:.2f} s)")
    check(sb.pq_codes is not None and sb.pq_codes.shape[:2] == sb.nbr_shards.shape[:2],
          "the shard build left no PQ codes")
    return sb


def emulated_runs(run, sb, launches11: dict, dev) -> dict:
    """(b): ``emulated_shard_search`` over the four shards under exact and
    pq, all live and with shard 0 dead: recall@10 against phase 4's ground
    truth, comps/query and wall per batch (the pq LUTs built inside)."""
    from repro_torch.core.engine import emulated_shard_search, shard_entries
    from repro_torch.core.topk import recall_at_k
    from repro_torch.distributed.sharded_ann import pq_shard_state

    P, per = sb.nbr_shards.shape[:2]
    out = {}
    for scorer in ("exact", "pq"):
        spec = run.spec._replace(scorer=scorer)
        for dead in (-1, 0):
            live = torch.ones((P,), dtype=torch.bool, device=dev)
            if dead >= 0:
                live[dead] = False
            ids, comps, walls = [], [], []
            for b, q in enumerate(run.stream):
                gen = torch.Generator(device=dev).manual_seed(PHASE11_SEED * 1000 + b)
                ent = shard_entries(gen, P, q.shape[0], per, spec.num_seeds)

                def one():
                    states = None
                    if scorer == "pq":
                        states = [pq_shard_state(q, sb.pq_codebooks[s], sb.pq_codes[s],
                                                 spec.metric) for s in range(P)]
                    return emulated_shard_search(q, sb.base_shards, sb.nbr_shards, ent, live,
                                                 spec, scorer_states=states)

                torch.cuda.synchronize()
                t = time.perf_counter()
                _, i, c = counted(launches11, one)
                walls.append(time.perf_counter() - t)
                ids.append(i)
                comps.append(c)
            found = torch.cat(ids)
            r = {"recall@10": recall_at_k(found, run.ground_truth),
                 "recall@1": float((found[:, 0] == run.ground_truth[:, 0]).float().mean()),
                 "comps": float(torch.cat(comps).float().mean()),
                 "wall_ms": 1e3 * float(np.mean(walls))}
            out[(scorer, dead)] = r
            print(f"  emulated {scorer}, {'shard 0 dead' if dead == 0 else 'all live'}: "
                  f"recall@10 {r['recall@10']:.4f}, recall@1 {r['recall@1']:.4f}, "
                  f"comps/query {r['comps']:.1f}, wall {r['wall_ms']:.1f} ms a batch of "
                  f"{run.stream[0].shape[0]}")
            if dead >= 0:
                hit = ((found >= dead * per) & (found < (dead + 1) * per)).sum()
                check(int(hit) == 0, f"{int(hit)} answers from the dead shard ({scorer})")
        check(out[(scorer, 0)]["recall@10"] < out[(scorer, -1)]["recall@10"],
              f"recall did not fall with shard 0 dead ({scorer})")
    return out


def one_rank_search(run, launches11: dict, dev) -> dict:
    """(c): ``distributed_search`` on a one-rank NCCL group over phase 4's
    whole graph as P=1: exact and pq bit-identical to ``Searcher.search`` on
    the same entries; pq on the host and disk tiers (the Searcher's stores)
    with the device pq run's ids. Returns the group."""
    import torch.distributed as dist
    from repro_torch.core.engine import gather_rows
    from repro_torch.distributed.sharded_ann import distributed_search
    from repro_torch.launch.mesh import make_flat_group

    fg = make_flat_group(dev)
    backend = dist.get_backend(fg.group)
    print(f"  flat group: backend {backend}, rank {fg.rank} of {fg.size}")
    check(backend == "nccl" and fg.size == 1, "the one-rank group is not NCCL")
    # NCCL sets its communicator up at the first collective: timed apart
    one = torch.zeros((1, 1), device=dev)
    _, first_s = event_s(lambda: gather_rows(one, fg.group))
    print(f"  the first collective (NCCL communicator set-up): {first_s * 1e3:.1f} ms")
    s = run.searcher
    check(s.tombstones is None, "phase 4's searcher carries tombstones")
    live = torch.ones((1,), dtype=torch.bool, device=dev)
    stores = {pl: s.base_store(pl) for pl in ("host", "disk")}
    walls: dict[str, list] = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = counted(launches11, fn)
        walls.setdefault(label, []).append(time.perf_counter() - t)
        return res

    for scorer in ("exact", "pq"):
        spec = run.spec._replace(scorer=scorer)
        kw = dict(ef=spec.ef, k=spec.k, metric=spec.metric, group=fg.group,
                  expand_width=spec.expand_width, r_tile=spec.r_tile, scorer=scorer,
                  rerank=spec.rerank)
        if scorer == "pq":
            kw.update(pq_codebooks=s.pq.codebooks[None], pq_codes=s.pq.codes[None])
        for q, seed in zip(run.stream, run.seeds):
            ent, _ = s.seed(q, spec, seed)
            want = timed(f"Searcher {scorer}", lambda: s.search(q, spec, entries=ent))
            d, i, c = timed(f"distributed {scorer}", lambda: distributed_search(
                q, s.base[None], s.neighbors[None], ent[None], live, **kw))
            check(torch.equal(i, want.ids) and torch.equal(d, want.dists)
                  and torch.equal(c, want.n_comps),
                  f"one-rank distributed_search differs from Searcher.search ({scorer})")
            if scorer != "pq":
                continue
            for pl, store in stores.items():
                _, ti, _ = timed(f"distributed pq {pl}", lambda: distributed_search(
                    q, None, s.neighbors[None], ent[None], live, base_placement=pl,
                    host_base=store, **kw))
                check(torch.equal(ti, i), f"the {pl} tier's ids differ from device pq's")
    for label, w in walls.items():
        print(f"  {label}: {1e3 * float(np.mean(w)):.1f} ms a batch (mean of {len(w)})")
    print("  one rank: exact and pq ids, dists and n_comps bit-identical to Searcher.search "
          "on 8 batches; host and disk pq ids identical to device pq")
    return fg


def merge_ms(run, fg) -> None:
    """(d): the all-gather and merge of (Q=64, k=10) answers on the group,
    by CUDA events."""
    from repro_torch.core.engine import gather_merge, gather_rows, merge_shard_results

    Q, k = run.stream[0].shape[0], run.spec.k
    g = torch.Generator(device=run.searcher.device).manual_seed(PHASE11_SEED)
    d = torch.rand((Q, k), generator=g, device=g.device)
    ids = torch.randint(0, 1_000_000, (Q, k), generator=g, device=g.device, dtype=torch.int32)
    both = cuda_ms(lambda: gather_merge(d, ids, k, fg.group), PHASE11_MERGE_REPS)
    gather = cuda_ms(lambda: (gather_rows(d, fg.group), gather_rows(ids, fg.group)),
                     PHASE11_MERGE_REPS)
    merge = cuda_ms(lambda: merge_shard_results(d, ids, k), PHASE11_MERGE_REPS)
    print(f"  merge at Q={Q}, k={k}, {fg.size} rank(s): all-gather + merge {both:.4f} ms, "
          f"the two all-gathers {gather:.4f} ms, the merge alone {merge:.4f} ms "
          f"(CUDA events, mean of {PHASE11_MERGE_REPS})")


def sharded_phase(run, dev) -> dict:
    """Phase 11 on phase 4's world (module docstring). Returns the launches
    over its driven runs, by kernel."""
    import torch.distributed as dist

    launches11: dict[str, int] = {}
    t = time.perf_counter()
    sb = shard_builds(run, launches11)
    print(f"  [(a)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    emulated_runs(run, sb, launches11, dev)
    del sb
    torch.cuda.empty_cache()
    print(f"  [(b)] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    fg = one_rank_search(run, launches11, dev)
    print(f"  [(c)] {time.perf_counter() - t:.1f} s")
    try:
        merge_ms(run, fg)
    finally:
        dist.destroy_process_group()
    print(f"launches over phase 11's runs: {launches11}")
    check(all(launches11.get(name, 0) > 0 for name in PHASE11_KERNELS),
          f"a kernel of phase 11's path never launched: {launches11}")
    return launches11


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-2 only: build and check the kernels")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = phase("phase 1: card and build")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"card: {kind} (count {count}); nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    tb = time.perf_counter()
    secs = _build.build(_build.SOURCES)
    print(f"built {', '.join(f'{k} ({v:.1f} s)' for k, v in secs.items())} "
          f"in {time.perf_counter() - tb:.1f} s wall")
    for name, log in _build.BUILD_LOG.items():
        for line in ptxas_report(log):
            print(f"  ptxas {name}: {line}")
    done(t0, "phase 1")

    t0 = phase("phase 2: kernels against plain versions")
    n_full, d_full = serve.FULL_WORLD
    full_base = torch.from_numpy(serve.numpy_world(n_full, d_full, 0)).to(dev)
    errs = {name: 0.0 for name in ops.launch_counts()}
    check_kernels(full_base, errs)
    check_pair_kernel(full_base, errs)
    check_pool_kernel(full_base, errs)
    check_compressed_kernels(full_base, errs)
    check_flash_attention(errs)
    bwd_row = check_flash_attention_bwd(errs)
    print(f"  max abs error against the plain versions: {errs}")
    del full_base
    done(t0, "phase 2")
    if args.quick:
        print(json.dumps({"kernels": [bwd_row]}))
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                  "count": count}}))
        return 0

    t0 = phase("phase 3: smoke world (n=20_000, d=32), exact / sq8 / pq")
    for scorer in SCORERS:
        smoke = serve.serve_ann(serve.parser().parse_args(
            ["--arch", "ann", "--smoke", "--device", "cuda", "--scorer", scorer])).summary
        ref10, slack = SMOKE_FLOORS[scorer]
        print(f"smoke {scorer}: recall@10 {smoke['recall@10']:.4f} (JAX reference on "
              f"the CPU {ref10:.4f}; floor {ref10 - slack:.4f}), recall@1 "
              f"{smoke['recall@1']:.4f}, comps/query {smoke['comps_per_query']:.1f}, "
              f"bytes/query {smoke['bytes_per_query']:.0f}, qps {smoke['qps']:.1f}")
        check(smoke["recall@10"] >= ref10 - slack,
              f"smoke-world recall@10 below the floor under --scorer {scorer}")
    smoke = serve.serve_ann(serve.parser().parse_args(
        ["--arch", "ann", "--smoke", "--device", "cuda", "--entry", "hierarchy"])).summary
    floor = REF_SMOKE_RECALL10_HIERARCHY - RECALL_SLACK
    print(f"smoke hierarchy: recall@10 {smoke['recall@10']:.4f} (JAX reference on the CPU "
          f"{REF_SMOKE_RECALL10_HIERARCHY:.4f}; floor {floor:.4f}), recall@1 "
          f"{smoke['recall@1']:.4f}, comps/query {smoke['comps_per_query']:.1f} (seed phase "
          f"{smoke['seed_comps_per_query']:.1f}), layers {smoke['hnsw_layers']}, qps "
          f"{smoke['qps']:.1f}")
    check(smoke["recall@10"] >= floor, "smoke-world recall@10 below the floor under "
                                       "--entry hierarchy")
    done(t0, "phase 3")

    t0 = phase("phase 4: full-width world (n=1_000_000, d=64)")
    launches = {}
    knn = {}
    ops.reset_launch_counts()
    with kept_knn_graph(knn):
        run = serve.serve_ann(serve.parser().parse_args(
            ["--arch", "ann", "--device", "cuda", "--scorer", "pq"]))
    torch.cuda.synchronize()
    launches["pq"] = ops.launch_counts()
    rep = run.build.report
    print(f"build: rounds {rep.rounds}, converged {rep.converged}, update curve "
          f"{list(rep.update_curve)}")
    print(f"build: graph-recall proxy {rep.graph_recall_proxy}, degree "
          f"min/mean/max {rep.degree['min']}/{rep.degree['mean']}/{rep.degree['max']}, "
          f"in-degree {rep.in_degree}, dropped reverse {rep.dropped_reverse_edges}, "
          f"LID {rep.lid}, index memory {rep.memory_bytes / 2**20:.1f} MiB")
    print(f"build: construct {rep.wall_construct_s:.2f} s, diversify "
          f"{rep.wall_diversify_s:.2f} s, compress (PQ M=8 K=256, 15 iterations) "
          f"{rep.wall_compress_s:.2f} s, total {rep.wall_total_s:.2f} s; peak "
          f"memory per stage (GiB) "
          f"{ {k: round(v / 2**30, 2) for k, v in rep.peak_memory_bytes.items()} }")
    check("compress" in rep.peak_memory_bytes and run.searcher.pq is not None,
          "the compress stage left no PQ table")

    d = run.searcher.base.shape[1]
    warm = torch.from_numpy(serve.numpy_queries(d, run.stream[0].shape[0], 1, 99)[0]).to(dev)
    specs = {sc: run.spec._replace(scorer=sc) for sc in SCORERS}
    summaries, served = {"pq": run.summary}, {"pq": run.results}
    for scorer in ("exact", "sq8"):
        ops.reset_launch_counts()
        run.searcher.search(warm, specs[scorer], serve.batch_seed(0, -1))
        results, dt = serve.serve_batches(run.searcher, specs[scorer], run.stream,
                                          run.seeds)
        launches[scorer] = ops.launch_counts()
        nq = sum(q.shape[0] for q in run.stream)
        summaries[scorer] = {"queries": nq, "seconds": dt, "qps": nq / dt,
                             **serve.summarize(results, run.ground_truth, run.spec.k)}
        served[scorer] = results
    for scorer in SCORERS:
        sm = summaries[scorer]
        steps = sm["steps_per_batch"]
        print(f"search {scorer}: {sm['queries']} queries in {sm['seconds'] * 1e3:.1f} ms "
              f"({sm['qps']:.1f} qps), recall@1 {sm['recall@1']:.4f}, recall@10 "
              f"{sm['recall@10']:.4f}, comps/query {sm['comps_per_query']:.1f}, "
              f"bytes/query {sm['bytes_per_query']:.0f}, {steps:.1f} steps/batch, "
              f"{sm['seconds'] * 1e3 / len(run.stream) / steps:.3f} ms/step")
        rec10 = sm["recall@10"]
        check(np.isfinite(rec10) and 0.0 < rec10 <= 1.0, f"recall@10 out of range ({scorer})")

    from repro_torch.baselines.pq import pq_search
    from repro_torch.core.scorers import get_scorer
    from repro_torch.core.topk import recall_at_k

    per_score = {sc: int(get_scorer(sc).scored_bytes(
        run.searcher.scorer_state(run.stream[0], specs[sc]), 1, d)) for sc in SCORERS}
    print(f"bytes per traversal score: {per_score}")
    check(per_score["exact"] > per_score["sq8"] > per_score["pq"],
          "bytes per traversal score do not fall exact > sq8 > pq")
    check(summaries["exact"]["bytes_per_query"] > summaries["sq8"]["bytes_per_query"]
          > summaries["pq"]["bytes_per_query"], "bytes/query do not fall exact > sq8 > pq")

    qs = torch.cat(run.stream)
    ops.reset_launch_counts()
    t = time.perf_counter()
    _, pq_ids, pq_comps = pq_search(qs, run.searcher.base, run.searcher.pq,
                                    k=run.spec.k, rerank=PQ_SEARCH_RERANK)
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t
    launches["pq_search"] = ops.launch_counts()
    gt = run.ground_truth
    pq_r1 = float((pq_ids[:, 0] == gt[:, 0]).float().mean())
    pq_r10 = recall_at_k(pq_ids, gt)
    print(f"pq_search (rerank {PQ_SEARCH_RERANK}): {qs.shape[0]} queries in "
          f"{pq_s * 1e3:.1f} ms ({qs.shape[0] / pq_s:.1f} qps), recall@1 {pq_r1:.4f}, "
          f"recall@10 {pq_r10:.4f}, comps/query {float(pq_comps.float().mean()):.1f}")
    check(0.0 < pq_r10 <= 1.0, "pq_search recall@10 out of range")

    for path, kernels in (("pq", ("gather_distance_pool", "gather_distance", "distance_matrix",
                                  "distance_matrix_small", "gather_adc_masked")),
                          ("exact", ("gather_distance_masked",)),
                          ("sq8", ("gather_sq8_masked", "gather_distance")),
                          ("pq_search", ("pq_adc", "gather_distance"))):
        print(f"launches over the {path} path: {launches[path]}")
        check(all(launches[path][k] > 0 for k in kernels),
              f"a kernel of the {path} path never launched")
    # each kernel's count from the path it belongs to (the pq serve run
    # holds the build: NN-Descent, GD, PQ, and the ground truth)
    kernel_launches = {**launches["pq"],
                       "gather_distance_masked": launches["exact"]["gather_distance_masked"],
                       "gather_sq8_masked": launches["sq8"]["gather_sq8_masked"],
                       "pq_adc": launches["pq_search"]["pq_adc"]}

    register_plain_scorers()
    for scorer in SCORERS:
        lockstep_rung(run.searcher, specs[scorer], run.stream, run.seeds, served[scorer])
    for scorer in SCORERS:
        generic_hop_rung(run.searcher, specs[scorer], run.stream, run.seeds, served[scorer])
    gd_prune_on_both_routes(run.searcher.base, knn.pop("graph"))
    ground_truth_against_plain(run)
    done(t0, "phase 4")

    t0 = phase("phase 4b: the hierarchy path at full width (n=1_000_000, d=64)")
    launches["hierarchy"], pair_calls = hierarchy_path(dev)
    # the pair kernel's launches over both paths that run it
    kernel_launches["gather_distance"] += launches["hierarchy"]["gather_distance"]
    done(t0, "phase 4b")


    t0 = phase("phase 5: per-kernel times at the main path's shapes")
    rows = time_kernels(run, errs, kernel_launches, pair_calls)
    rows += time_compressed_kernels(run, errs, kernel_launches,
                                    next(r["ms"] for r in rows
                                         if r["name"] == "gather_distance_masked"))
    batch_share(run, specs["exact"])
    batch_share(run, specs["pq"])
    round_profile(run.searcher.base)
    flash_row = time_flash_attention(errs)
    done(t0, "phase 5")

    t0 = phase("phase 8: the saved, tiered and filtered index on phase 4's world")
    saved_tiered_filtered(run, rows, dev)
    done(t0, "phase 8")

    t0 = phase("phase 9: streaming mutation on phase 4's world")
    launches9 = mutation_phase(run, rows, errs, dev)
    done(t0, "phase 9")

    t0 = phase("phase 10: the continuous-batching server on phase 4's world")
    launches10 = serving_phase(run, rows, dev)
    done(t0, "phase 10")

    t0 = phase("phase 11: sharded search and build on phase 4's world")
    launches11 = sharded_phase(run, dev)
    del run
    done(t0, "phase 11")

    t0 = phase("phase 6: LM serving, TinyLlama-1.1B at full width")
    flash_row["launches"] = lm_serving()
    rows.append(flash_row)
    done(t0, "phase 6")

    t0 = phase("phase 12: MoE, hybrid and MLA LM serving at full width (Qwen3-30B-A3B, "
               "Gemma3-12B, DeepSeek-V3 at 4 layers)")
    torch.cuda.empty_cache()
    launches12 = moe_hybrid_serving()
    done(t0, "phase 12")

    t0 = phase("phase 13: LM training (TinyLlama-1.1B at full width, its restart and "
               "lock-step; DeepSeek-V3 at 2 layers + MTP; the smoke configs card vs CPU)")
    torch.cuda.empty_cache()
    launches13 = lm_training()
    bwd_row["launches"] = launches13["flash_attention_bwd"]
    rows.append(bwd_row)
    done(t0, "phase 13")

    t0 = phase("phase 7: the paper's experiment (SIFT1M, GIST1M, RAND10M4D stand-ins)")
    paper_phase(dev, errs, rows)
    done(t0, "phase 7")

    for r in rows:
        r["phase9_launches"] = launches9.get(r["name"], 0)
        r["phase10_launches"] = launches10.get(r["name"], 0)
        r["phase11_launches"] = launches11.get(r["name"], 0)
        r["phase12_launches"] = launches12 if r["name"] == "flash_attention" else 0
        r["phase13_launches"] = launches13.get(r["name"], 0)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
