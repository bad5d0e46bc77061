#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``instsearch_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Hopper,
sm_90a). It builds the port's kernels from ``instsearch_torch/csrc/`` and
runs twenty-one phases; each raises on failure and the process exits
non-zero.
Phase 12 runs right after phase 4, while phase 2's and phase 3's stores are
as those phases left them (phase 10 mutates them).

  0. set-up: the card's name and power limit, the kernel build and its time;
  1. every kernel against its plain PyTorch version on the card, at the
     main paths' shapes: 1M x 512 rows, B in {1, 8, 128} (K1 in bf16: {1,
     8, 16, 64, 128}, each timed), k in {1, 10, 100}, padding, a
     50% mask, duplicated rows, fewer valid rows than k, D = 2048 at B = 1
     and 128 (bf16: also k = 200 at B = 1, 8 and 128, phase 11's shapes);
     K1 in bf16 and f32 (scores within SCORE_TOL; every launch through
     the TMA + wgmma pass 1, f32's by split TF32; f32 also over phase
     15a's 10^6 x 136 store at B = 1 and 128, k = 10 and 256, and timed
     there, at D = 512 for B = 1, 8, 128 and k = 10, 100 and at D = 2048
     for B = 1, k = 10, 100 and B = 128, k = 10, beside ``torch.topk(q @
     x.T)`` in f32 with TF32 off), K2
     over int8 and K3 over int4 rows (bit for bit; also B = 65, D = 128
     and B = 128 at D = 128 and 2048, each timed at B = 1 and 128 with
     k = 10 and at B = 1, 8 and 128 with k = 100, K2 beside
     ``torch._int_mm`` + ``torch.topk`` at B = 128; every launch through
     the TMA + wgmma pass 1, ``launches_wgmma``), and the first
     kernel of their launch sequence, the query's quantization, bit for
     bit against ``ops/quantize.py::quantize_rows`` on rows with ties at
     half a step, zero rows, a sign at the row's maximum and bf16 values;
     K4 over 4-bit PQ codes, 1M x 32 bytes (M = 64) with the same cases
     (also B = 65, the mask and duplicates at B = 128) and 1M x 8 bytes
     (M = 16), and 67,108,864 x 32 bytes (2 GiB of codes) at B = 1 and
     128, depth 100 (bit for bit), timed at B = 1 and 128 (k = 10), B = 8
     (k = 100, phase 4's bucket) and over 64M rows; and the first kernel of
     its launch sequence, the lookup table (``pq_table``), bit for bit
     against its plain version at D = 96, 128, 512 and 2048; with kernel
     and plain medians;
  2. the float path through its entry points: a seeded random ResNet-50 at
     224 px (bf16, GeM, whitening to 512) extracts a corpus of 4096 seeded
     images, the index holds them among seeded unit distractor rows (1M x
     512 bf16 in all), and ``ServeCore`` answers image requests of 1, 3, 8
     and 13 exact copies of corpus images. Every top-1 must be its source;
     K1 must launch once per bucket piece; an index whose own config takes
     the scoring oracle must agree;
  3. the quantized paths, ``configs/capacity_int4.json`` and
     ``configs/million_scale_int8.json`` as loaded, with alpha query
     expansion: ResNet-50 at 512 px extracts 1024 seeded images, stored
     among seeded unit distractor rows as 1M int4 (then int8) rows behind
     ``ServeCore``; the same requests. Every top-1 must be its source; K3
     (K2) must launch twice per bucket piece (top-qe_n, then the final
     top-k); the composite with the kernel replaced by its plain version
     must give equal ids and scores. The int8 preset's 8 shards then serve
     the requests on cuda:0 (``ServeCore(sharded=True)``): K2 16 times per
     piece, its answers equal to the single-device route's bit for bit. It
     prints the top-10 overlap with the scoring oracle's route, which
     measures the int8 query's quantization, and is not a check;
  4. the PQ cascade through its entry points: phase 3's int4 store of
     ``configs/capacity_int4.json`` gains ``Index.build_pq()`` with the
     reference's defaults (M = 64, 15 iterations, 262,144-row fit sample,
     depth 100) on the card, and ``ServeCore`` answers the same requests.
     Every top-1 must be its source; K4 must launch twice per bucket piece
     (QE's top-qe_n cascade, then the final one) and K1-K3 never; the
     composite with K4 replaced by its plain version must give equal ids and
     scores. It prints, without checking, the build time, the cascade's
     recall@10 against the exact int4 route, the top-10 overlap with the
     oracle route (f32 lookup table) and the query p50 at B = 1 and 128;
  5. the ViT path through its entry points: a seeded random ViT-B/16 at 224
     px (bf16, GeM, whitening to 512) on the K6 route
     (``vit_attention="pallas"``) extracts 2048 seeded images, stored among
     distractors (1M x 512 bf16) behind ``ServeCore``, the requests of
     phase 2. K6 must launch 12 times and K1 once per bucket piece, no other
     kernel; every top-1 must be its source; the plain route (a config with
     ``vit_attention="xla"``, the same weights) must give the same top-1 and
     descriptors within VIT_ROUTE_COS. Then high resolution on the K5 route
     (``"flash"``): 1024 px (4,097 tokens, B = 4) and 2048 px (16,385
     tokens, B = 1), K5 12 times per backbone pass, descriptors against the
     plain route's where it fits. It prints extraction images/s of each
     route and the query p50 at B = 1 and 128;
  6. the fused-ResNet inference path at full width: ResNet-50 with seeded
     weights and randomized BatchNorm at 224 px, B = 64, through the module
     route (cuDNN, BN unfolded) and ``fused_resnet_apply`` with the default
     ``fused_layers=(2,)`` and with ``(1, 2, 3, 4)``; images/s of each, GeM
     descriptors of the fused routes within FUSED_COS of the module route's
     per image, their whitened descriptors searched (K1) against a 1M x 512
     bf16 store of the module route's among distractors, every top-1 its own
     image; K7 must launch once per identity block (3 and 12 a forward).
     Then one 512 px batch through ``(1, 2, 3, 4)``, against the module;
  7. widths and depths the reference serves: an Index of 65,536 rows of
     D = 31 in bf16, int8 and int4 (padded to the kernels' multiples)
     served through K1-K3 and equal to the plain versions' route, k = 2000
     through the scoring oracle, and ``build_pq`` at D = 96 (M = 12, codes
     padded to whole words) through K4, equal to the unpadded plain
     version bit for bit;
  8. R-MAC and regional re-ranking (workloads 2 and 5) with seeded random
     VGG16 weights: (a) ``configs/paris6k_vgg16_rmac_whiten.json`` as
     loaded, VGG16 at 512 px (bf16, R-MAC) extracting 1024 seeded images at
     the preset's batch 32, whitening fitted on them, stored among seeded
     unit distractor rows (1M x 512 bf16) behind ``ServeCore``: every top-1
     its source, K1 once per bucket piece, the oracle twin agreeing; (b)
     ``configs/rerank_regional_top100.json`` as loaded with the same
     weights: ``Index.build`` over 256 of those images written as PNG files
     (one combined global and regional pass, the regional whitening and
     store with its grid geometry), then the 1M-row store with a [1M, 14,
     512] bf16 regional store made on the card (the corpus's regional rows
     and seeded unit rows for the distractors), the same requests with
     re-rank and with ``spatial_weight = 0.5``
     (``configs/spatial_rerank_top100.json``, the same store behind its
     config): every top-1 its source, K1 once per bucket piece (the
     top-100) and no other kernel, the composite over K1's plain version
     agreeing on fused scores within SCORE_TOL and on ids but at near-ties
     of them, the oracle twin on every top-1; the spatial preset's 2 shards
     on cuda:0 then serve the requests (K1 twice a piece), agreeing with
     its single-device route by the same rule; the query p50 at B = 1, 8
     and 128 with re-rank, with spatial and without either, K1 at depth
     100 beside ``torch.topk(q @ x.T, 100)``, and the re-rank stage's
     device time (CUDA events around ``rerank_from_candidates``); (c) the
     exact-refine tier over
     phase 3's 1M-row int4 store (``configs/capacity_int4.json`` with
     ``refine_dtype="int8"``, refine on, QE off): K3 once per bucket piece
     at depth 100, every top-1 its source, equal ids and scores through
     K3's plain version, the p50 at B = 1 and 128. It fails if TF32 is on;
  9. the sharded index of workload 4, ``configs/oxford105k_sharded8.json``
     as loaded: ResNet-50 at 512 px (bf16, GeM p=3) extracts 4096 seeded
     images, whitened at full width (D = 2048), among seeded unit rows up to
     Oxford105k's 105,133 (106,496 padded rows, 8 shards of 13,312, 0.44 GB
     in bf16), the 8 shards as views of the store on cuda:0 behind
     ``ServeCore(sharded=True)``; the requests of phase 2. Every top-1 must
     be its source; K1 must launch 8 times per bucket piece and no other
     kernel; the sharded search must agree with the single-device one by
     K1's rule (``check_against_plain``) and ``full_ranking`` through
     ``all_scores`` must equal the single-device ranking; the p50 of
     ``query_images`` and of the search alone at B = 1, 8 and 128 by both
     routes, peak device memory. Then (9c) the multi-process form at world
     size 1: ``initialize()`` starts an NCCL group from a loopback address,
     ``build_multihost_index`` holds the same rows as 8 local shards, and
     its search must give phase 9's answer, K1 8 times; its B = 1 p50 beside
     the one-process route's (the group's all_gather at world size 1; a
     collective across cards is not measured on one card);
 10. the live, persistent index through its entry points, with the
     ``[1, N_pad]`` subset mask driven through K1-K4: (a) phase 2's index
     saved and loaded with no extractor (store, ids and names equal bit
     for bit, the rebuilt extractor within 1e-5, ``ServeCore`` on it giving
     phase 2's answers), three subsets defined by request (``half``: every
     second corpus image and half the distractors; ``collection``: 1,000
     corpus images; ``tiny``: 5) whose requests launch K1 once a piece,
     each with the mask, return members only (5 results for ``tiny``), and
     are held to ``topk_matmul_reference`` with the same mask; an ``add``
     of 1,024 new images from PNG files (each its own top-1; the store
     re-pads to 2M rows), a ``remove`` of 512 corpus and 512 added images
     (never returned again, the survivors' rows bit for bit, the subsets
     refreshed), ``range`` at tau 0.9 (the count equal to the plain count
     over the store, with and without a subset) and ``reconstruct``; (b)
     phase 4's int4 store and PQ view saved and loaded (``packed`` equal),
     subset requests through K3 (twice a piece) and through the cascade
     (K4 twice a piece, K1-K3 never), each equal bit for bit to the
     composite over the kernel's plain version with the mask, again after
     an ``add`` past capacity and a ``remove`` the view absorbs (an added
     image found by the cascade); (c) ``configs/million_scale_int8.json``
     as its 8 shards on cuda:0 behind ``ServeCore(sharded=True)``: K2
     twice a piece on each shard with valid rows, each with its slice of
     the mask, equal bit for bit to the single-device subset answer,
     again after an ``add`` and a ``remove`` that cut the shards again. It
     prints, as measurements and not checks, masked against unmasked K1,
     K3 and K4 (K1 beside ``torch.topk`` of the masked product), the
     ``Index.search`` p50 with and without a subset at B = 1, 8 and 128,
     the ``add`` and ``remove`` times, the ``save``/``load`` seconds and
     GB/s, and the peak device memory;
 11. the quality tiers (TF32 must be off): (a)
     ``configs/quality_ladder.json`` as loaded, ResNet-50 at 512 px over
     the scales 1, 0.7071 and 0.5 (bf16, GeM) extracting 4096 seeded
     images, whitened at full width (D = 2048), among seeded unit rows up
     to 1M in bf16; αDBA over the whole store (``augment_database``, K1 once
     a chunk of 128 rows and no other kernel, timed), its first 65,536 rows
     also augmented through K1's plain version (stores within one bf16
     step but on rows with a near-tie at the 10th neighbour); then
     ``ServeCore`` requests of 1, 8 and 13 images with αQE and diffusion at
     depth 200 (K1 twice a piece, every top-1 its source), K1's top-200 on
     the augmented store held to its plain version, and the diffused answers
     to the composite over K1's plain version (scores within DIFF_TOL of the
     row's largest, ids but at near-ties); (b)
     ``configs/local_whiten_rerank.json`` over phase 9's rows and extractor:
     ``fit_local_whitening()`` at its default 256 clusters (k-means,
     moments and the ``eigh`` bank timed apart), requests of 1 and 8 images and one B = 128 batch with
     αQE and the local-whitening re-score (K1 twice a piece, every top-1 its
     source, held to the composite over K1's plain version), save/load with
     the view (answers equal), an add and a remove of 64 rows the view
     absorbs (its store equal to the frozen bank applied to the current
     rows); (c) phase 9's 8 shards on cuda:0: ``search_diffusion`` and
     ``search_lw`` (on (b)'s index cut in 8), ``augment_database(mesh=)``
     and ``knn_graph(mesh=)`` against the single-device route on the same
     store (each route's K1 launches counted and checked: one a busy shard
     a call or chunk; the αDBA near-ties from K1's plain version), and
     ``expert_whiten_fn`` on a 4-shard mesh against
     ``apply_local_whitening``; (d) ``find_duplicates(tau=0.97)`` over phase
     9's rows with 64 planted near-duplicate pairs (all found; K1 once a
     chunk), and αDBA
     with a diffusion search over phase 3's 1M-row int8 store
     (``configs/million_scale_int8.json`` with ``dba_n`` 10 and diffusion),
     K2 held bit for bit (the pass on 65,536 rows and the search on the
     whole store, each through K2's plain version). It prints the αDBA and
     fit times, ``whiten_all_clusters`` beside its bound, the search p50s
     at B = 1, 8 and 128 with and without the stage, and the peak device
     memory.

 12. the ANN tiers, plain PyTorch as the reference's are XLA ops, so no
     kernel of K1-K4 may launch on their routes (the launch counts are
     read around every request): (a) ``configs/capacity_ivfpq.json`` as
     loaded over phase 3's 1M int4 rows, ``build_ivfpq()`` at the
     reference's defaults (C = 1024, nprobe 32, depth 400, m = 64, 15 PQ
     iterations, timed), ``ServeCore`` requests of 1, 3, 8 and 13 images
     (every top-1 its source), recall@10 against the exact int4 route and
     the search p50 at B = 1, 8 and 128; on a 65,536-row cut, full probe
     and depth 65,536 held to the scoring oracle's route by
     ``check_against_plain``; (b) ``build_ivf()`` over phase 2's 1M bf16
     store and over phase 3's rows as ``million_scale_int8.json``'s int8
     store (``ivf_nprobe`` set), requests of 1, 3, 8 and 13 images, full
     probe held to K1's route (bf16) and to the oracle's on the
     bf16-rounded query (int8, the reference's ``_score_rows``), p50 at
     B = 1 and 8; (c) a ``HostRowStore`` of 8,388,608 x 512 int8 rows (a
     4 GiB ``rows.bin`` in a temporary folder, removed at the end; seeded
     unit rows with phase 3's 1,024 corpus descriptors at seeded
     positions), ``IVFPQView.from_host_store`` on the card, and
     ``VectorServeCore`` answering vector requests of 1 and 8 corpus
     descriptors with the host gather (every top-1 its source) and
     ``adc_only``; the ADC selection's device time, the host gather's
     time, both p50s and the peak device memory; (d) the ADC selection
     over 67,108,864 seeded codes (2 GiB; C = 8192, seeded positions,
     depth 400) at B = 1 and 8: its working memory above the view's own
     bytes must stay under 4 GiB (the table is gathered by the codes, never
     expanded one-hot), p50; (e) (a)'s index cut in 8 shards on cuda:0:
     ``search_ivfpq`` held to the single device (ids equal but where an
     ADC near-tie at the depth boundary swaps a candidate, scores within
     1e-6), ``ServeCore(sharded=True)`` requests, then the index saved with
     its view and loaded: the view's arrays and the answers equal bit for
     bit.
 13. the command line and the TCP server on the card, run last: workload
     1 at full width (``configs/oxford5k_resnet50_avgpool.json`` as
     shipped: ResNet-50 at 224 px, average pooling, bf16) over 5,063
     seeded 512 x 384 JPEG files (Oxford5k's count; coloured gratings) in
     a temporary folder, removed at the end. Each process is ``python -m
     instsearch_torch.cli --device cuda ...``. (a) ``build-index`` plain,
     then ``--resumable``, killed by SIGKILL once its manifest lists a
     flushed group and run again: the resumed index equal to the plain
     one bit for bit, rows and names; wall times, images/s and the
     decoder that ran (``native`` or ``cv2``); (b) ``query`` as 8
     processes at once, each top-1 its image; (e) ``serve --port 0`` on
     (a)'s index, 1 then 8 concurrent clients of 64 single-image requests
     (every top-1 its source, at least one batch of more than one row
     under 8 clients, p50/p99 on the host clock), a remove, a query, an
     add, a query and two bad requests on one connection answered in
     order. "Top-1 its source" allows a bf16 near-tie (BF16_TIE): the
     source in the answer within 2^-8 of the first score, counted as
     ``near_tie_swaps``; an answer that misses its source is asked again
     for DEEP_K results, which must hold it and the source within 2^-8
     of the first (``trails_within_tie``), counted as ``source_past_k``.
     Then in this process (``cli.main``, kernels
     counted): (c) ``update-index`` adding 8 images again under new names,
     ``info``, ``dedupe --tau 0.97`` (every planted pair found); (d)
     ``build-index --pq`` over ``configs/compact128_int4.json``, queries
     through the cascade (K4 twice a query, alpha-QE) and at
     ``--pq-depth 0`` (K3 twice); (f) ``evaluate --dataset mini`` with
     workload 1's config, then ``workloads`` over every preset on the mini
     fixture (each line printed; no enabled stage missing). K1-K4 must
     each launch in these parts, K5-K7 never.
 14. fine-tuning at full width, the default ``TrainConfig`` (ResNet-50 at
     224 px, GeM, bf16 compute on f32 masters, AdamW, 8 tuples of 2 + 5
     images: 56 a step), over a seeded labelled tree of 16 classes x 4
     JPEG views of phase 13's gratings in a temporary folder, removed at
     the end: (a) 3 warm-up steps on a fixed batch, then the step's median
     ms, images/s, peak device memory and, under the profiler, the
     device's busy ms and idle share of a step; the loss must fall over 8
     steps; (b) one f32 step (TF32 off) on the card against the same step
     of the port on the CPU with the same weights and 2 tuples: the loss
     within 1e-4 relative, every gradient tensor's cosine at least
     GRAD_COS; the bf16 route's gradients against the f32 route's, their
     cosines printed; (c) ``Trainer(mesh=)`` on an NCCL group of one
     process (``world_of_one``) against ``mesh=None`` for the contrastive
     and the Smooth-AP loss, two steps each, cuDNN deterministic: losses
     and parameters equal; (d) ``remat=True`` against plain: the loss
     within 1e-6 relative, the largest parameter difference printed; (e)
     ``cli finetune --fit-lw --learn-p --eval-dataset mini`` on the tree
     (the frozen and tuned mAP on the mini fixture printed), ``build-index
     --weights`` of its checkpoint over the 64 views and a ``query`` of
     each: every top-1 its own view (within BF16_TIE, as phase 13 rules:
     Lw pulls a class's views within it) and the first 4 results its
     class's views; K1 counted (``launches_train``);
 15. the rest of M7 and M14, right after phase 11 while phase 9's store
     is as phase 9 left it: (a) ``metric="l2"`` over 1M x 128 seeded
     SIFT-shaped integer rows (BIGANN/SIFT1M's base set's shape) and 1,000
     queries as f32, bf16 and int8 stores: the f32 top-10 equal to an exact
     ``torch.cdist`` oracle slot by slot (ties by distance), every f32/bf16
     top-1 its source row, recall@10 of bf16 and int8 printed, K1 and K2
     against their plain versions on the augmented rows, ``search_range``
     by a radius: counts equal to the oracle's (f32) and to a brute-force
     count over each store's rows in f64, f32/bf16 members inside it;
     search p50 at B = 1 and 128; (b) range search through phase 9's 8
     shards against one device: counts equal, members by K1's rule, p50 of
     both routes; (c) phase 9's index saved and ``Index.load(mesh=)`` on 8
     shards of cuda:0: answers bit for bit phase 9's and (b)'s,
     ``to_sharded`` copying nothing, the load time and its peak device
     memory; (d) ResNet-50 at 224 px, bf16, B = 64 on ``make_mesh_2d(2, 1,
     devices=["cuda:0"] * 2)`` against one device (cosine >= FUSED_COS,
     top-1 its own image), ``Index.build(mesh=)`` over 384 PNG files
     against ``Index.build`` (ids and names equal), images/s of both; K1
     and K2 counted (``launches_mesh``);
 16. the ViT's model-parallel forwards (ROADMAP M11) at published widths,
     every mesh position on cuda:0 (``phase16``): tensor parallel through
     ``Extractor(mesh=make_mesh_dp_tp(...))``, the GPipe pipeline and the
     sequence-parallel forward, each against the meshless model on the
     same weights, in one process and (d) as their multi-process forms on
     meshes over a process group (an NCCL group of one process,
     ``MP_GROUP_FORM``); no kernel launches there;
 17. persistence at scale, right after phase 15 while phase 9's store and
     phase 3's rows are there (``phase17``): phase 9's store saved with
     ``streaming=None`` (the port's stream must be chosen), loaded placed
     on 8 shards of cuda:0 and saved again from the placed store; the
     placed ``search`` equal to phase 9's bit for bit, K1 8 times a piece,
     the host's peak memory of the placed load and save at most 2 x one
     shard's bytes + 64 MiB (phase 15c's npz load's printed beside it);
     phase 3's int8 and int4 stores as streams, K2/K3 answers equal to the
     in-memory stores' bit for bit; save_s, load_s and bytes on disk;
 18. mutation of a placed store where it lies, right after phase 17 on its
     streams (``phase18``): remove, add and merge_from on 8 shards of
     cuda:0, each against an unplaced twin bit for bit, with
     ``Index.gather`` refusing (``launches_placed``);
 19. searches through an armed candidate tier on a placed store, right
     after phase 18 on the int8 and int4 streams (``phase19``): PQ and
     IVF-PQ over int4, IVF over int8, fitted on the placed store and on
     its twin alike, answers bit for bit the twin's at B = 1, 8, 128 (with
     αQE, and a subset for PQ), with ``Index.gather`` refusing, peak
     device growth within the twin's + 64 MiB, the PQ cascade once more
     through an NCCL group of one (``launches_placed_tier``);
 20. the port's benchmark stages (``instsearch_torch/bench.py``), last:
     (a) ``python -m instsearch_torch.cli bench --what all`` as a
     user runs it (no ``--device``), at the reference's sizes; its JSON
     line must hold every key the reference's ``run_bench("all")``
     returns, every ``p50_ms`` and ``images_per_sec`` finite and positive,
     every ``spread_ms`` ordered, every ``hbm_bw_gbps`` at most 1.05 x the
     card's published 3,350 GB/s, every ``frac_of_roofline`` at most 1.05,
     every ``path`` a kernel's, and each stage's ``kernel_launches`` its
     kernel's; (b) ``bench_query``'s bf16 p50 at B = 1 and 128 over 1M x
     512 within a factor of 2 of phase 1's CUDA-event medians of K1 at
     those shapes (else the marginal measured the host); (c) in process,
     once each, ``bench_pq``, ``bench_pq_capacity``, ``bench_ivf``,
     ``bench_ivfpq``, ``bench_ivfpq_capacity``, ``bench_host_serve``,
     ``bench_dba``, ``bench_train`` and the ``extended`` group's 4M-row
     int8 and 8M-row int4 capacity queries at the reference's defaults but
     ``bench_host_serve``'s rows (``HOST_SERVE_ROWS``), with the same
     checks, K1-K4 counted a stage (``launches_bench``);
 21. the reference's three walkthroughs on the port, last, in process on
     the card with no ``--device`` (``phase21``): ``examples/
     torch_vector_ops.py`` (top-1 ``[0, 1, 2]``, duplicate groups
     ``[['im7', 'im100']]``, K1 launched), ``examples/torch_end_to_end.py``
     on the mini fixture in a temporary folder (the query of
     ``db_paths[0]`` returns it first, every filtered answer is in the
     subset, the seven mAPs of the quality ladder lie in [0, 100], the
     reloaded index has 56 rows and weights, K2 launched) and
     ``examples/torch_capacity_serving.py`` at 65,536 and 4,194,304 rows
     (``CAPACITY_ROWS``), as a cascade and ``--adc-only`` (the self-match,
     row 7, first in all four); each script's wall seconds and launches
     (``launches_examples``).

Phase 1 also holds K6 (``mha``) and K5 (``flash_mha``) against their plain
versions at B x 12 heads x N tokens x 64: K6 at N = 197 (B = 1 and 64 in
bf16, also with ViT-L/16's 16 heads at B = 64; 8 in f32) and 4,097 (B = 1,
bf16; the bf16 K6's compiled kernel's registers and local memory a thread
are printed, and any local memory fails the phase), K5 at 4,097 (B = 1 and
4, the 1024 px route's batch) and 16,385 (B = 1) in bf16 and 1,025 (B = 2,
f32), by ``check_attention`` (``kernels/vit_attention.py``), which must also
reject two planted faults on every bf16 case (a key tile dropped, logits
rounded to bf16), with the time of PyTorch's
``scaled_dot_product_attention`` on the same tensors as the yardstick,
and K7 (``fused_identity_blocks``) at ResNet-50's four identity-block
stages at both of phase 6's sizes, 224 and 512 px, B = 64, one call per
stage as ``fused_resnet_apply`` makes it, by ``check_fused_call``: each call
equal to its blocks launched one at a time and each block held by
``check_fused_blocks`` (``kernels/fused_resnet.py``), which must reject
three planted faults on every block (a border tap reading the neighbouring
row, a dropped corner tap, the tap sum rounded to bf16); at 224 px with the
module's ``Bottleneck.forward`` on the same activation (cuDNN, several
calls, replayed from a CUDA graph) as the yardstick; the compiled K7
kernel's registers and local memory a thread are printed, and any local
memory (a spill) fails the phase.

Every measured number is printed with the card's nvidia-smi name and power
limit. The line before the last is the kernel summary as JSON: per kernel its
launches on the main path, its largest difference from its plain version,
its median time and its plain version's at 1M rows, B = 1, k = 10 (K1 and
K3 count phase 8's launches too, also apart as ``launches_phase8``, and
carry their times at depth 100 on phase 8's stores, ``ms_b{1,8,128}_k100``,
``plain_ms_b..._k100``, ``library_ms_b..._k100`` (K1 only; null for K3),
``bound_ms_b..._k100``; K2 carries the same keys from phase 1's 1M x 512
store, its library ``torch._int_mm`` + ``torch.topk`` at B = 128; K1-K3
name their pass 1, ``pass1``; K1 splits its launches by store dtype,
``launches_by_store`` (the f32 ones: phase 15a's l2 store and phase 21's
vector walkthrough), and carries the f32 store's times at 1M x 512, B = 1
and 128, k = 10 (``ms_f32``, ``ms_f32_b128``, with ``plain_ms_``,
``library_ms_``, ``bound_ms_`` by split TF32's three products a pair and
``bound_ms_fma_`` by the CUDA cores' f32) and over phase 15a's store at
B = 128, k = 256 (``..._f32_d136_b128_k256``); K1 and K2 count the
sharded routes' launches too,
also apart as ``launches_sharded``; K1-K4
also at B = 128: ``ms_b128``, ``plain_ms_b128``, ``library_ms_b128``,
``bound_ms_b128``; K1-K4 count phase 10's subset requests too, also apart
as ``launches_subset`` (every one of them with the mask), phase 11's
αDBA passes, kNN graphs, duplicate searches and requests, also apart as
``launches_quality``, phase 13's in-process command-line runs, also
apart as ``launches_cli``, and phase 14e's fine-tuning runs, also apart as
``launches_train`` (every kernel's row carries both), and K1-K4 count
phase 15's searches, range searches and placed loads, also apart as
``launches_mesh`` (K1 and K2 launch there), phase 17's searches of
the loaded streams, also apart as ``launches_persist`` (K1-K3), phase
18's placed searches, ``launches_placed``, phase 19's placed tier
searches, ``launches_placed_tier`` (K4), phase 20's benchmark stages,
``launches_bench`` (K1-K4), and phase 21's walkthroughs,
``launches_examples`` (every kernel's row carries it; K1 and K2 launch
there); K1 also at
D = 2048 over 1M rows, B = 128 with k = 10 and B = 1, 8, 128 with k = 200
(``ms_d2048_b{B}_k{k}``, ``plain_ms_...``, ``library_ms_...``,
``bound_ms_...``); K4 also at B =
8, k = 100 (``ms_b8_k100``,
``plain_ms_b8_k100``, ``bound_ms_b8_k100``) and over 64M rows at k = 100
(``ms_64m_b1_k100``, ``bound_ms_64m_b1_k100``, ``ms_64m_b128_k100``,
``bound_ms_64m_b128_k100``); K6 at
[64, 12, 197, 64] bf16 (also at [64, 16, 197, 64]: ``ms_h16``,
``plain_ms_h16``, ``library_ms_h16``, ``bound_ms_h16``), K5 at [1, 12,
16385, 64] bf16 (also at [4, 12,
4097, 64]: ``ms_b4``, ``plain_ms_b4``, ``library_ms_b4``, ``bound_ms_b4``),
K7 at layer 2 of
ResNet-50, [64, 28x28, 512], M = 128, three blocks), the least
time the card could take for that work (``bound_ms``: the larger of the bytes
read and written over 3.35 TB/s and the operations over the published peak
rate for their type) and, where one PyTorch call computes the same function,
that call's median time (``library_ms``, else null). The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout,
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_ROWS = 1 << 20
DIM = 512
CORPUS = 4096
IMAGE = 224
CORPUS_Q = 1024         # phase 3: images extracted at the presets' 512 px
SCORE_TOL = 1e-5        # unit rows: f32 sums in two orders differ far below
SIZES = (1, 3, 8, 13)   # images per served request
K1_BATCHES = (1, 8, 16, 64, 128)   # K1's bf16 query batches in phase 1
# K1's f32 store over 1M x 512 and 1M x 2048, timed in phase 1: (B, k)
F32_TIMED = ((1, 10), (8, 10), (128, 10), (1, 100), (8, 100), (128, 100))
F32_TIMED_D2048 = ((1, 10), (1, 100), (128, 10))
# the route of K1's pass 1 and of K2's and K3's (csrc/topk_wgmma.cuh),
# named in their rows
K1_PASS1 = ("topk_pass1_wgmma: TMA + wgmma (bf16 WgBf16; f32 WgF32, split "
            "TF32), buffered top-k")
INT_PASS1 = {"topk_matmul_int8": "topk_pass1_wgmma<WgInt<false>>: TMA + "
                                 "wgmma s8 x s8, buffered top-k",
             "topk_matmul_int4": "topk_pass1_wgmma<WgInt<true>>: TMA + "
                                 "wgmma u8 x s8 (A nibbles in registers), "
                                 "buffered top-k"}
# K2/K3's timed shapes in phase 1: (B, k)
INT_TIMED = ((1, 10), (128, 10), (1, 100), (8, 100), (128, 100))
# K1 at D = 2048 on the quality tiers' paths (phase 11), timed in phase 1:
# (B, k) of the αDBA / kNN-graph chunk and of diffusion's depth
QUALITY_K1 = ((128, 10), (1, 200), (8, 200), (128, 200))
F4_ROWS = 1 << 16       # phase 7: rows of the odd-width and PQ stores
PQ_ROWS_CAPACITY = 1 << 26   # bench.py::bench_pq_capacity's 64M rows
VIT_CORPUS = 2048       # phase 5: images extracted by ViT-B/16 at 224 px
VIT_LAYERS = 12         # ViT-B/16: one attention launch per layer and pass
# cosine of the L2-normalized GeM descriptors of the kernel routes (f32
# logits) against the plain route (bf16 logits), same weights and images;
# measured 0.999996 at 224 px and above 0.999999 at 1024 and 2048 px on an
# H100, so the bar leaves 25 times that gap
VIT_ROUTE_COS = 0.9999
# F7: K1-K3 at k > 32 over a store with slices past its valid rows
F7_ROWS, F7_VALID, F7_DIM, F7_K = 1024, 56, 64, 200
F7_FULL = 1 << 16       # the full store called before each of them
F7_REPS = 100           # calls a case in phase 1
FUSED_CORPUS = 2048     # phase 6: images through the module route
FUSED_QUERIES = 512     # phase 6: of those, through each fused route
# GeM descriptor cosine of the fused routes against the module route: the
# reference's own bar between its fused path and the Flax forward
# (tests/kernels/test_fused_resnet.py)
FUSED_COS = 0.999
REGIONS = 14            # phase 8: R-MAC regions at 512 px (a 32 x 32 map)
RERANK_DEPTH = 100      # phase 8: the re-rank presets' rerank_depth
RERANK_BUILD = 256      # phase 8b: images Index.build reads from PNG files
OX_CORPUS = 4096        # phase 9: images extracted (whitening keeps 2048 of
#                         at most N - 1 directions)
OX_ROWS = 105_133       # phase 9: Oxford105k's rows
LIVE_ADD = 1024         # phase 10a: images added by request
LIVE_REMOVE = 512       # phase 10a: corpus images (and as many added) removed
LIVE_COLLECTION = 1000  # phase 10a: corpus images in the "collection" subset
QL_CORPUS = 4096        # phase 11a: images extracted (the full-width
#                         whitening keeps 2048 of at most N - 1 directions)
QUALITY_SIZES = (1, 8, 13)   # phase 11a: images per served request
DBA_SLICE = 1 << 16     # phase 11: rows of the αDBA pass held to the plain
#                         version's
LW_MUTATE = 64          # phase 11b: rows added, and removed, under the view
LW_PAIRS = 64           # phase 11d: planted near-duplicate pairs
# diffused scores of two candidate selections: K1 and its plain version
# give global scores within SCORE_TOL, which CG at alpha = 0.99 amplifies
# (condition number up to ~200); the bar is relative to the row's largest
# diffused score
DIFF_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
# dense, published; "tf32" the tensor cores' rate on TF32 operands
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12,
                  "tf32": 495e12}


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def report(card: str, **fields) -> None:
    print(json.dumps({"card": card, **fields}), flush=True)


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of single-call device times (CUDA events) after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_replay(fn):
    """``fn``'s launches captured once in a CUDA graph (after a warm-up on a
    side stream); returns the graph's replay, which runs them without the
    host's launch gaps."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def unit_rows(gen, n, d, dtype):
    import torch
    x = torch.randn(n, d, generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype).contiguous()


def phase1(card: str, gen, topk, ref, check) -> tuple[float, dict]:
    """Kernel against plain version; returns (max error, timings). ``check``
    is the kernel's acceptance rule against its plain version
    (``check_against_plain``): scores within SCORE_TOL, the kernel's own
    (score desc, position asc) order, no repeated position, and positions
    equal except at near-ties of distinct rows."""
    import torch
    dev = torch.device("cuda")

    def case(x, b, k, label, num_valid=None, mask=None, q=None):
        if q is None:
            q = unit_rows(gen, b, x.shape[1], torch.float32)
        before = (topk.launches_wgmma, topk.launches_f32)
        s, i = topk(x, q, k=k, num_valid=num_valid, mask=mask)
        rs, ri = ref(x, q, k=k, num_valid=num_valid, mask=mask)
        torch.cuda.synchronize()
        if (topk.launches_wgmma, topk.launches_f32) != (
                before[0] + 1, before[1] + (x.dtype == torch.float32)):
            fail(f"{label} B={b} k={k}: not one launch through the TMA + "
                 f"wgmma pass 1 (an f32 store's: split TF32)")
        try:
            err = check(x, q, s, i, rs, ri, SCORE_TOL)
        except AssertionError as e:
            fail(f"{label} B={b} k={k}: {e}")
        if num_valid is not None and int(i.max()) >= num_valid:
            fail(f"{label}: a padding row was returned")
        if mask is not None:
            hit = i[i >= 0].long()
            if not bool((mask.reshape(-1)[hit] > 0).all()):
                fail(f"{label}: a masked-out row was returned")
        report(card, phase=1, case=label, n=x.shape[0], d=x.shape[1], b=b,
               k=k, max_abs_err=err)
        errs.append(err)
        return i

    def timed(key, x, b, k, q=None):
        """``timings[key]``: the kernel's, the plain version's and the
        yardstick's CUDA-event medians on one query batch, and the bound:
        the store read once, the query read and the top-k written once, 2
        B N D operations at the store's type; an f32 store's bound also by
        the three TF32 products a pair of its pass 1 (``bound_ms_tf32x3``;
        ``bound_ms_fma`` the CUDA cores' f32, as ``bound_ms``)."""
        n, d = x.shape
        if q is None:
            q = unit_rows(gen, b, d, torch.float32)
        qx = q.to(x.dtype)
        f32 = x.dtype == torch.float32
        nbytes = n * d * x.element_size() + b * d * 4 + b * k * 8
        ops = 2 * b * n * d
        t = {"ms": cuda_median_ms(lambda: topk(x, q, k=k)),
             "plain_ms": cuda_median_ms(lambda: ref(x, q, k=k),
                                        reps=5 if d > DIM else 10,
                                        warmup=1),
             # the yardstick: one product in the store's dtype (f32: TF32
             # off, as main() sets it) and torch.topk, which the port
             # never calls
             "library_ms": cuda_median_ms(lambda: torch.topk(qx @ x.T, k)),
             **bound(nbytes, ops, "f32" if f32 else "bf16")}
        if f32:
            t["bound_ms_fma"] = t["bound_ms"]
            t["bound_ms_tf32x3"] = bound(nbytes, 3 * ops, "tf32")["bound_ms"]
        timings[key] = t

    def tied_copies(dup, base, b):
        """K1 over an f32 store of 1024 base rows repeated, at B = b, k =
        100, held without the plain version over all of it: the plain f32
        product of full-precision rows at B = 128 over 1M rows need not
        give copies of a row the same last bit (the library's sums may run
        in another order in another tile), while the kernel's must tie
        exactly. The kernel's 100 scores must be equal, and within
        SCORE_TOL of the plain version's best over the base rows, its base
        row a best one there; returns the positions."""
        q = unit_rows(gen, b, DIM, torch.float32)
        before = topk.launches_wgmma
        s, i = topk(dup, q, k=100)
        plain = ref(base, q, k=1024)[0]
        torch.cuda.synchronize()
        if topk.launches_wgmma != before + 1:
            fail(f"f32 duplicated rows B={b}: not one launch through the "
                 f"TMA + wgmma pass 1")
        best = plain[:, 0]
        mine = (q @ base.T).gather(1, (i[:, :1] % 1024).long())[:, 0]
        if not (torch.equal(s, s[:, :1].expand_as(s))
                and float((s[:, 0] - best).abs().max()) <= SCORE_TOL
                and float((mine - best).abs().max()) <= SCORE_TOL):
            fail(f"f32 duplicated rows B={b}: copies do not tie, or their "
                 f"base row is not a best one")
        report(card, phase=1, case="float32 duplicated rows (tied copies)",
               n=dup.shape[0], d=DIM, b=b, k=100,
               max_abs_err=float((s[:, 0] - best).abs().max()))
        return i

    errs = []
    timings = {}
    nv = N_ROWS - 1000
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("phase 1: the f32 yardstick needs TF32 off")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        x = unit_rows(gen, N_ROWS, DIM, dtype)
        bf16 = dtype is torch.bfloat16
        short = "bf16" if bf16 else "f32"
        for b in K1_BATCHES if bf16 else (1, 8, 128):
            for k in (1, 10, 100):
                case(x, b, k, f"{name} num_valid=N-1000", num_valid=nv)
        mask = (torch.rand(N_ROWS, generator=gen, device=dev) < 0.5
                ).to(torch.int8)
        for b in (8, 128):
            case(x, b, 10, f"{name} 50% mask", mask=mask)
        case(x, 3, 100, f"{name} 50 valid rows < k", num_valid=50)
        for b, k in ([(b, 10) for b in K1_BATCHES] if bf16 else F32_TIMED):
            timed(f"{short} N=1M D=512 B={b} k={k}", x, b, k)
        del x, mask
        # duplicated rows: every score appears 1024 times, so the top 100
        # are the 100 lowest copies of one base row, in position order
        base = unit_rows(gen, 1024, DIM, dtype)
        dup = base.repeat(N_ROWS // 1024, 1).contiguous()
        for b in (8, 128):
            if bf16 or b == 8:
                i = case(dup, b, 100, f"{name} duplicated rows")
            else:
                i = tied_copies(dup, base, b)
            if not (bool((i // 1024 == torch.arange(100, device=dev)).all())
                    and bool((i % 1024 == i[:, :1] % 1024).all())):
                fail(f"{name} duplicated rows: copies out of position order")
        del base, dup
        # the unwhitened ResNet-50 width, and the quality tiers' shapes at
        # it (phase 11): the αDBA and kNN-graph self-search (B = 128, k =
        # 10) and diffusion's depth (k = 200)
        x = unit_rows(gen, N_ROWS, 2048, dtype)
        for b in ((1, 128) if bf16 else (1,)):
            for k in (10, 100):
                case(x, b, k, f"{name} D=2048", num_valid=nv)
        if bf16:
            for b in (1, 8, 128):
                case(x, b, 200, f"{name} D=2048", num_valid=nv)
        else:
            case(x, 128, 10, f"{name} D=2048", num_valid=nv)
        for b, k in ((1, 10), *QUALITY_K1) if bf16 else F32_TIMED_D2048:
            timed(f"{short} N=1M D=2048 B={b} k={k}", x, b, k)
        del x
        torch.cuda.empty_cache()
    # phase 15a's store: 10^6 rows of 128 columns and the norm column,
    # padded to 136, at k = 10 and search_range's L2_RANGE_M (unit rows)
    x = unit_rows(gen, L2_ROWS, 136, torch.float32)
    for b in (1, 128):
        for k in (10, L2_RANGE_M):
            q = unit_rows(gen, b, 136, torch.float32)
            case(x, b, k, "float32 D=136", q=q)
            timed(f"f32 N=1M D=136 B={b} k={k}", x, b, k, q=q)
    del x
    torch.cuda.empty_cache()
    for shape, t in timings.items():
        report(card, phase=1, timing=shape, **t)
    return max(errs), timings


def planted_faults(q, k, v, flash: bool) -> dict:
    """Two faults a kernel could make, built from its plain version's
    arithmetic (K5's tiles of ``FLASH_KV_BLOCK`` = 128 keys or K6's whole
    rows) on the same inputs; ``check_attention`` must reject both:
      * ``tile dropped``: the middle key tile (128 keys) skipped (an
        off-by-one in the key loop);
      * ``bf16 logits``: the logits rounded to bf16 before the softmax, as
        the plain einsum route keeps them."""
    import math
    import torch
    from instsearch_torch.kernels.vit_attention import FLASH_KV_BLOCK
    n, kb = q.shape[2], FLASH_KV_BLOCK
    skip = n // kb // 2 * kb
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()

    def logits_of(c0, c1, bf16):
        s = qf @ k[:, :, c0:c1].float().transpose(-1, -2) * scale
        return s.bfloat16().float() if bf16 else s

    faults = {}
    for name, drop, bf16 in (("tile dropped", True, False),
                             ("bf16 logits", False, True)):
        if not flash:
            s = logits_of(0, n, bf16)
            if drop:
                s[..., skip:skip + kb] = -math.inf
            e = torch.exp(s - s.amax(-1, keepdim=True))
            p = e / e.sum(-1, keepdim=True)
            faults[name] = (p.to(v.dtype).float() @ v.float()).to(q.dtype)
            continue
        m = torch.full(q.shape[:-1] + (1,), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, device=q.device)
        for c0 in range(0, n, kb):
            if drop and c0 == skip:
                continue
            s = logits_of(c0, c0 + kb, bf16)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(-1, keepdim=True)
            acc = corr * acc + p.to(v.dtype).float() @ v[
                :, :, c0:c0 + kb].float()
            m = m_new
        faults[name] = (acc / l).to(q.dtype)
    return faults


def phase1_attention(card: str, gen) -> tuple[dict, dict]:
    """K6 (mha) and K5 (flash_mha) against their plain versions at the ViT
    shapes: B x 12 heads x N tokens x 64, N = 197 (224 px), 1,025, 4,097
    (1024 px; K5 also at B = 4, the batch of phase 5's 1024 px route) and
    16,385 (2048 px). q, k and v are views of one packed [B, N, 3, 12, 64]
    tensor, the layout of the model's qkv projection that the kernels read
    in place. K5's plain version is the tiled one (kv_block 128, as the
    kernel), which never holds the N x N logits, so it runs over all 12
    heads at once even at 16,385 tokens. Every output must pass
    ``check_attention``; in bf16 the two faults of ``planted_faults`` must
    fail it on the same inputs. K6 also runs at [64, 16, 197, 64] (ViT-L/16's
    heads), and its bf16 kernel must have no local memory (a spill;
    ``mha_kernel_attrs``). Returns (largest error per kernel, timings by
    case)."""
    import torch
    import torch.nn.functional as F
    from instsearch_torch.kernels.vit_attention import (
        attention_error, check_attention, flash_mha, flash_mha_reference, mha,
        mha_kernel_attrs, mha_reference)
    attrs = mha_kernel_attrs()
    report(card, phase=1, kernel="mha", **attrs)
    if attrs["local_bytes"]:
        fail(f"K6 spills: {attrs['local_bytes']} bytes of local memory a "
             f"thread ({attrs['registers']} registers)")
    errs = {"mha": 0.0, "flash_mha": 0.0}
    timings = {}
    for fn, ref, shape, kind in (
            (mha, mha_reference, (1, 12, 197, 64), "bf16"),
            (mha, mha_reference, (64, 12, 197, 64), "bf16"),
            (mha, mha_reference, (64, 16, 197, 64), "bf16"),
            (mha, mha_reference, (8, 12, 197, 64), "f32"),
            (mha, mha_reference, (1, 12, 4097, 64), "bf16"),
            (flash_mha, flash_mha_reference, (1, 12, 4097, 64), "bf16"),
            (flash_mha, flash_mha_reference, (4, 12, 4097, 64), "bf16"),
            (flash_mha, flash_mha_reference, (1, 12, 16385, 64), "bf16"),
            (flash_mha, flash_mha_reference, (2, 12, 1025, 64), "f32")):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        b, h, n, hd = shape
        qkv = torch.randn((b, n, 3, h, hd), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        label = f"{fn.__name__} {kind} {list(shape)}"
        out = fn(q, k, v)
        want = ref(q, k, v)
        torch.cuda.synchronize()
        try:
            got = check_attention(out, want)
        except AssertionError as e:
            fail(f"{label}: against the plain version: {e}")
        errs[fn.__name__] = max(errs[fn.__name__], got["max_abs_err"])
        faults = {}
        if kind == "bf16":
            for name, bad in planted_faults(q, k, v, fn is flash_mha).items():
                try:
                    check_attention(bad, want)
                except AssertionError:
                    faults[name] = attention_error(bad, want)
                    continue
                fail(f"{label}: the planted fault '{name}' passes "
                     f"check_attention")
        report(card, phase=1, kernel=fn.__name__, case=label, **got,
               planted_faults_rejected=faults)
        del out, want
        long = n > 2000
        timings[label] = {
            "ms": cuda_median_ms(lambda: fn(q, k, v), reps=5 if long else 20),
            "plain_ms": cuda_median_ms(lambda: ref(q, k, v),
                                       reps=3 if long else 10, warmup=1),
            # the yardstick, which the port never calls
            "library_ms": cuda_median_ms(
                lambda: F.scaled_dot_product_attention(q, k, v),
                reps=5 if long else 20),
            **bound(4 * b * h * n * hd * q.element_size(),
                    4 * b * h * n * n * hd, kind)}
        report(card, phase=1, timing=label, **timings[label])
        del q, k, v, qkv
        torch.cuda.empty_cache()
    return errs, timings


def resnet50_stages(image: int = IMAGE):
    """ResNet-50's identity-block stages at ``image`` px: (layer, H = W, C,
    M, identity blocks), one K7 call each on ``fused_resnet_apply``'s
    path."""
    from instsearch_torch.kernels.fused_resnet import STAGE_SIZES
    return [(f"layer{i + 1}", image // (4 << i), 256 << i, 64 << i,
             blocks - 1)
            for i, blocks in enumerate(STAGE_SIZES["resnet50"])]


def phase1_fused(card: str, gen, model) -> tuple[float, dict]:
    """K7 (``fused_identity_blocks``) against its plain version at
    ResNet-50's four identity-block stages at both image sizes phase 6
    gives it, 224 and 512 px, B = 64, with the identity blocks of ``model``
    (seeded weights, randomized BN), one call per stage as
    ``fused_resnet_apply`` makes it, each held by ``check_fused_call``. At
    224 px, times per stage: the kernel's call, the plain version's, the
    module's ``Bottleneck.forward`` on the same activation (cuDNN, unfolded
    BN, channels-last: several calls, the yardstick; replayed from a CUDA
    graph, so that the host's launch gaps between its ~10 kernels a block do
    not count, and eager beside it), the bound and the kernel's share of
    it, with the compiled kernel's registers and local (spill) bytes a
    thread, which must be 0. Returns (largest error, timings by stage)."""
    import torch
    from instsearch_torch.kernels.fused_resnet import (
        _stack_identity_weights, check_fused_call, fused_identity_blocks,
        fused_identity_blocks_reference, kernel_attrs, tile_rows)
    attrs = kernel_attrs()
    report(card, phase=1, kernel="fused_identity_blocks", **attrs)
    if attrs["local_bytes"]:
        fail(f"K7 spills: {attrs['local_bytes']} bytes of local memory a "
             f"thread ({attrs['registers']} registers)")
    sd = model.state_dict()
    b = 64
    errs, timings = [], {}
    for image in (IMAGE, 512):
        for layer, hh, c, m, n in resnet50_stages(image):
            op = _stack_identity_weights(sd, layer, [str(j) for j in
                                                     range(1, n + 1)], "cuda")
            x = torch.relu(torch.randn((b, hh * hh, c), generator=gen,
                                       device="cuda")).to(torch.bfloat16)
            label = f"K7 {layer} {image} px n={n} [{b}, {hh}x{hh}, {c}] M={m}"
            try:
                _, got, faults = check_fused_call(x, op, hh, hh)
            except AssertionError as e:
                fail(f"{label}: {e}")
            report(card, phase=1, kernel="fused_identity_blocks", case=label,
                   tile_rows=tile_rows(hh, hh, m),
                   call_equals_blocks_one_by_one=True, blocks=got,
                   planted_faults_rejected=faults)
            errs += [e["max_abs_err"] for e in got]
            if image != IMAGE:
                del x, op
                torch.cuda.empty_cache()
                continue
            blocks = [getattr(model, layer)[j] for j in range(1, n + 1)]
            xc = x.view(b, hh, hh, c).permute(0, 3, 1, 2)  # channels-last

            def module_route():
                y = xc
                for blk in blocks:
                    y = blk(y)
                return y

            hw = hh * hh
            with torch.inference_mode():
                timings[layer] = {
                    "ms": cuda_median_ms(lambda: fused_identity_blocks(
                        x, *op, H=hh, W=hh), reps=10),
                    "plain_ms": cuda_median_ms(
                        lambda: fused_identity_blocks_reference(
                            x, *op, H=hh, W=hh), reps=3, warmup=1),
                    # the yardstick, several calls (cuDNN convolutions, BN,
                    # ReLU and the residual add): what the module route runs
                    "library_ms": cuda_median_ms(graph_replay(module_route),
                                                 reps=10),
                    "library_eager_ms": cuda_median_ms(module_route, reps=10),
                    "library_calls": f"Bottleneck.forward x {n} (cuDNN conv, "
                                     f"BN, ReLU, add), one CUDA graph",
                    **bound(2 * b * hw * c * 2
                            + n * 2 * (2 * c * m + 9 * m * m)
                            + n * 4 * (2 * m + c),
                            2 * b * hw * n * (c * m + 9 * m * m + m * c),
                            "bf16")}
            t = timings[layer]
            report(card, phase=1, timing=f"K7 {layer} [{b}, {hh}x{hh}, {c}] "
                   f"M={m} n={n}", **t, bound_share=t["bound_ms"] / t["ms"],
                   **attrs)
            del x, xc, op
            torch.cuda.empty_cache()
    return max(errs), timings


def quantized_unit_rows(gen, n: int, d: int, quantize):
    """``quantize`` (``quantize_rows`` or ``quantize_rows_int4``) of n
    seeded unit rows, in pieces: the f32 temporaries of 1M x 2048 rows at
    once would take tens of GiB."""
    import torch
    from instsearch_torch.ops.quantize import QuantizedRows
    step = 1 << 17
    parts = [quantize(unit_rows(gen, min(step, n - s), d, torch.float32))
             for s in range(0, n, step)]
    return QuantizedRows(torch.cat([p.values for p in parts]),
                         torch.cat([p.scales for p in parts], dim=1))


def quantizer_rows(gen, d: int):
    """f32 [12, d] query rows that pin ``quantize_rows``' arithmetic (d >=
    16): a zero row (the 1e-12 floor); a row of maximum 127, so the scale is
    exactly 1 and entries at half a step (0.5, 1.5, 2.5, 126.5 and their
    negatives) must round to even; rows of mixed sign whose maximum is a
    negative entry, and a positive one; rows of bf16 values; rows at scales
    1e-30 to 1e30."""
    import torch
    dev = gen.device
    r = torch.randn(12, d, generator=gen, device=dev)
    r[0] = 0.0
    halves = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5,
                           3.5, -3.5, 64.5, -64.5, 0.25, -0.75, 1.0, -1.0],
                          device=dev)
    r[1] = halves.repeat(d // 16 + 1)[:d]
    r[2, 3] = -4.0 * r[2].abs().max()           # the maximum is negative
    r[3, d - 1] = 4.0 * r[3].abs().max()
    r[4:8] = r[4:8].bfloat16().float()
    for j, s in zip(range(8, 12), (1e-30, 1e-3, 1e3, 1e30)):
        r[j] *= s
    return r.contiguous()


def int_mm_topk(st, q, k: int):
    """K2's yardstick: one ``torch._int_mm`` of the int8-quantized query
    ``q`` and rows ``st`` (``QuantizedRows``), scaled as K2 scales, and
    ``torch.topk``; the port never calls it. ``_int_mm`` needs more than 16
    query rows. Returns the call."""
    import torch
    from instsearch_torch.ops.quantize import quantize_rows
    qr = quantize_rows(q)
    q_i8, q_scale = qr.values, qr.scales.reshape(-1)
    x_scale = st.scales.reshape(-1)
    return lambda: torch.topk((torch._int_mm(q_i8, st.values.t()).float()
                               * q_scale[:, None]) * x_scale[None, :], k)


def check_quantizer(card: str, gen, quantize_query) -> None:
    """The first kernel of K2/K3's launch sequence against
    ``quantize_rows``: values, scales and offsets bit for bit."""
    import torch
    from instsearch_torch.ops.quantize import quantize_rows
    for d in (16, 512, 2048):
        for label, q in (("edge rows", quantizer_rows(gen, d)),
                         ("unit rows", unit_rows(gen, 128, d, torch.float32))):
            before = quantize_query.launches
            v, s, off = quantize_query(q)
            qr = quantize_rows(q)
            torch.cuda.synchronize()
            if quantize_query.launches != before + 1:
                fail(f"quantize_query D={d}: no launch counted")
            if not (torch.equal(v, qr.values) and torch.equal(
                    s.view(torch.int32), qr.scales.view(torch.int32))):
                fail(f"quantize_query D={d} {label}: differs from "
                     f"quantize_rows")
            if not torch.equal(off, 8 * qr.values.sum(1, dtype=torch.int32)):
                fail(f"quantize_query D={d} {label}: wrong offsets")
            report(card, phase=1, kernel="quantize_query", case=label, d=d,
                   b=q.shape[0], bit_exact=True)


def check_pq_table(card: str, gen, pq_table, lut) -> None:
    """The first kernel of K4's launch sequence against its plain version
    (``kernels.pq_scan._lut``) on the card: bit for bit, at the default M =
    D / 8 (D = 96: M = 12, padded to G = 8 bytes with zero rows)."""
    import torch
    from instsearch_torch.ops.pq import PQCodebook, default_m
    for d in (96, 128, 512, 2048):
        m = default_m(d)
        groups = -(-(m // 2) // 4) * 4
        cb = PQCodebook(0.25 * torch.randn(m, 16, d // m, generator=gen,
                                           device="cuda"))
        for b in (1, 128):
            q = unit_rows(gen, b, d, torch.float32)
            before = pq_table.launches
            got = pq_table(q, cb, groups)
            want = lut(q, cb, groups)
            torch.cuda.synchronize()
            if pq_table.launches != before + 1:
                fail(f"pq_table D={d}: no launch counted")
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                fail(f"pq_table D={d} B={b}: differs from the plain table")
            report(card, phase=1, kernel="pq_table", d=d, m=m, groups=groups,
                   b=b, bit_exact=True)


def empty_slice_case(gen, kind: str, b: int, masked: bool,
                     reps: int) -> int:
    """F7 (ROADMAP Queue 3) for one store kind (``"bfloat16"`` and
    ``"float32"`` for K1, ``"int8"`` K2, ``"int4"`` K3) and batch: k = F7_K
    over F7_ROWS padded
    rows with F7_VALID valid (the mini fixture's store: three of the four
    256-row slices hold no valid row), with or without a mask, ``reps``
    calls, each right after one over a full F7_FULL-row store of the same
    width, batch and k, whose blocks leave full top-k lists in shared
    memory. Every answer against the plain version (K1 by
    ``check_against_plain``, K2/K3 by ``check_exact``); a position
    outside [-1, F7_VALID) fails before anything is gathered by it.
    Without a barrier after the lists' initialization (an earlier pass 1
    of K2/K3 lacked it; ``csrc/topk_wgmma.cuh`` has one) a warp wrote out
    entries other warps had not set yet. Raises
    ``AssertionError``; returns the calls checked. The wrappers' launch
    counts are left as they were."""
    import torch
    from instsearch_torch.kernels.topk_matmul import (
        check_against_plain, check_exact, topk_matmul, topk_matmul_int4,
        topk_matmul_int4_reference, topk_matmul_int8,
        topk_matmul_int8_reference, topk_matmul_reference)
    from instsearch_torch.ops.quantize import quantize_rows, quantize_rows_int4
    small = unit_rows(gen, F7_ROWS, F7_DIM, torch.float32)
    small[F7_VALID:] = 0
    full = unit_rows(gen, F7_FULL, F7_DIM, torch.float32)
    q = unit_rows(gen, b, F7_DIM, torch.float32)
    mask = ((torch.rand((1, F7_ROWS), generator=gen, device="cuda") < 0.6)
            .to(torch.int8) if masked else None)
    if kind in ("bfloat16", "float32"):
        fn, ref = topk_matmul, topk_matmul_reference
        dtype = getattr(torch, kind)
        s_args, f_args = (small.to(dtype),), (full.to(dtype),)
    else:
        quant = quantize_rows if kind == "int8" else quantize_rows_int4
        fn, ref = ((topk_matmul_int8, topk_matmul_int8_reference)
                   if kind == "int8" else
                   (topk_matmul_int4, topk_matmul_int4_reference))
        s, f = quant(small), quant(full)
        s_args, f_args = (s.values, s.scales), (f.values, f.scales)
    counts = (fn.launches, fn.launches_subset)
    outs = []
    for _ in range(reps):
        fn(*f_args, q, k=F7_K)
        outs.append(fn(*s_args, q, k=F7_K, num_valid=F7_VALID, mask=mask))
    fn.launches, fn.launches_subset = counts
    rs, rp = ref(*s_args, q, k=F7_K, num_valid=F7_VALID, mask=mask)
    for i, (sc, ps) in enumerate(outs):
        bad = (ps < -1) | (ps >= F7_VALID)
        if bool(bad.any()):
            raise AssertionError(
                f"{kind} B={b} mask={masked} call {i}: positions "
                f"{ps[bad][:4].tolist()} outside [-1, {F7_VALID})")
        if kind in ("bfloat16", "float32"):
            check_against_plain(s_args[0], q, sc, ps, rs, rp, SCORE_TOL)
        else:
            check_exact(sc, ps, rs, rp)
    return reps


def check_empty_slices(card: str, gen) -> None:
    """``empty_slice_case`` for K1 (bf16 and f32 stores), K2 and K3 at B =
    1, 8 and 13, with and without a mask."""
    n = 0
    for kind in ("bfloat16", "float32", "int8", "int4"):
        for b in (1, 8, 13):
            for masked in (False, True):
                try:
                    n += empty_slice_case(gen, kind, b, masked, F7_REPS)
                except AssertionError as e:
                    fail(f"phase 1, F7: {e}")
    report(card, phase=1, check="F7 empty slices after full lists",
           k=F7_K, rows=F7_ROWS, valid=F7_VALID, calls_checked=n)


def phase1_int(card: str, gen, kind: str, fn, ref, quantize,
               check_exact) -> tuple[float, dict]:
    """K2 (int8) or K3 (int4) against its plain version; both sum exact
    integers, so every case must agree bit for bit (``check_exact``), and
    every launch must take the TMA + wgmma pass 1 (``launches_wgmma``).
    Returns (max error, timings)."""
    import torch
    from instsearch_torch.ops.quantize import QuantizedRows
    dev = torch.device("cuda")

    def case(st, d, b, k, label, num_valid=None, mask=None):
        q = unit_rows(gen, b, d, torch.float32)
        before = (fn.launches, fn.launches_wgmma)
        s, i = fn(st.values, st.scales, q, k=k, num_valid=num_valid,
                  mask=mask)
        rs, ri = ref(st.values, st.scales, q, k=k, num_valid=num_valid,
                     mask=mask)
        torch.cuda.synchronize()
        if (fn.launches, fn.launches_wgmma) != (before[0] + 1,
                                                before[1] + 1):
            fail(f"{kind} {label} B={b} k={k}: not one launch through the "
                 f"TMA + wgmma pass 1")
        try:
            err = check_exact(s, i, rs, ri)
        except AssertionError as e:
            fail(f"{kind} {label} B={b} k={k}: {e}")
        if num_valid is not None and int(i.max()) >= num_valid:
            fail(f"{kind} {label}: a padding row was returned")
        if mask is not None and not bool((mask[i[i >= 0].long()] > 0).all()):
            fail(f"{kind} {label}: a masked-out row was returned")
        report(card, phase=1, kernel=fn.__name__, case=f"{kind} {label}",
               n=st.values.shape[0], d=d, b=b, k=k, bit_exact=True,
               max_abs_err=err)
        errs.append(err)
        return i

    def tied_copies(dup, base, b):
        """K1 over an f32 store of 1024 base rows repeated, at B = b, k =
        100, held without the plain version over all of it: the plain f32
        product of full-precision rows at B = 128 over 1M rows need not
        give copies of a row the same last bit (the library's sums may run
        in another order in another tile), while the kernel's must tie
        exactly. The kernel's 100 scores must be equal, and within
        SCORE_TOL of the plain version's best over the base rows, its base
        row a best one there; returns the positions."""
        q = unit_rows(gen, b, DIM, torch.float32)
        before = topk.launches_wgmma
        s, i = topk(dup, q, k=100)
        plain = ref(base, q, k=1024)[0]
        torch.cuda.synchronize()
        if topk.launches_wgmma != before + 1:
            fail(f"f32 duplicated rows B={b}: not one launch through the "
                 f"TMA + wgmma pass 1")
        best = plain[:, 0]
        mine = (q @ base.T).gather(1, (i[:, :1] % 1024).long())[:, 0]
        if not (torch.equal(s, s[:, :1].expand_as(s))
                and float((s[:, 0] - best).abs().max()) <= SCORE_TOL
                and float((mine - best).abs().max()) <= SCORE_TOL):
            fail(f"f32 duplicated rows B={b}: copies do not tie, or their "
                 f"base row is not a best one")
        report(card, phase=1, case="float32 duplicated rows (tied copies)",
               n=dup.shape[0], d=DIM, b=b, k=100,
               max_abs_err=float((s[:, 0] - best).abs().max()))
        return i

    errs = []
    timings = {}
    nv = N_ROWS - 1000
    st = quantized_unit_rows(gen, N_ROWS, DIM, quantize)
    # B = 65: a ragged query block of the TMA + wgmma pass 1's 128
    for b in (1, 8, 65, 128):
        for k in (1, 10, 100):
            case(st, DIM, b, k, "num_valid=N-1000", num_valid=nv)
    mask = (torch.rand(N_ROWS, generator=gen, device=dev) < 0.5
            ).to(torch.int8)
    for b in (8, 128):
        case(st, DIM, b, 10, "50% mask", mask=mask)
    case(st, DIM, 3, 100, "50 valid rows < k", num_valid=50)
    row_bytes = DIM // 2 if kind == "int4" else DIM
    for b, k in INT_TIMED:
        q = unit_rows(gen, b, DIM, torch.float32)
        library = (cuda_median_ms(int_mm_topk(st, q, k))
                   if kind == "int8" and b > 16 else None)
        timings[f"{kind} N=1M D=512 B={b} k={k}"] = {
            "ms": cuda_median_ms(lambda: fn(st.values, st.scales, q, k=k)),
            "plain_ms": cuda_median_ms(
                lambda: ref(st.values, st.scales, q, k=k)),
            "library_ms": library,
            **bound(N_ROWS * (row_bytes + 4) + b * DIM * 4 + b * k * 8,
                    2 * b * N_ROWS * DIM, "int8")}
    del st, mask
    # duplicated rows: every stored row appears 1024 times, so the top 100
    # are the 100 lowest copies of one base row, in position order
    base = quantized_unit_rows(gen, 1024, DIM, quantize)
    reps = N_ROWS // 1024
    dup = QuantizedRows(base.values.repeat(reps, 1).contiguous(),
                        base.scales.repeat(1, reps).contiguous())
    for b in (8, 128):
        i = case(dup, DIM, b, 100, "duplicated rows")
        if not (bool((i // 1024 == torch.arange(100, device=dev)).all())
                and bool((i % 1024 == i[:, :1] % 1024).all())):
            fail(f"{kind} duplicated rows: copies out of position order")
    del base, dup
    # the unwhitened ResNet-50 width and the 128 of
    # configs/compact128_int4.json (an int4 row of 64 bytes half fills a
    # 128-byte chunk)
    for d, batches in ((2048, (1, 128)), (128, (8, 128))):
        st = quantized_unit_rows(gen, N_ROWS, d, quantize)
        for b in batches:
            for k in (10, 100):
                case(st, d, b, k, f"D={d}", num_valid=nv)
        del st
    torch.cuda.empty_cache()
    for shape, t in timings.items():
        report(card, phase=1, timing=shape, **t)
    return max(errs), timings


def phase1_pq(card: str, gen, fn, ref, check_exact) -> tuple[float, dict]:
    """K4 over random 4-bit codes against its plain version; both add the
    same bf16 table entries in one order, so every case must agree bit for
    bit (``check_exact``). Returns (max error, timings)."""
    import torch
    from instsearch_torch.ops.pq import PQCodebook
    dev = torch.device("cuda")

    def codes(n, m):
        return torch.randint(-128, 128, (n, m // 2), generator=gen,
                             device=dev, dtype=torch.int8)

    def codebook(m, d):
        return PQCodebook(0.25 * torch.randn(m, 16, d // m, generator=gen,
                                             device=dev))

    def case(x, cb, b, k, label, num_valid=None, mask=None):
        q = unit_rows(gen, b, cb.dim, torch.float32)
        s, i = fn(x, q, cb, k=k, num_valid=num_valid, mask=mask)
        rs, ri = ref(x, q, cb, k=k, num_valid=num_valid, mask=mask)
        torch.cuda.synchronize()
        try:
            err = check_exact(s, i, rs, ri)
        except AssertionError as e:
            fail(f"pq {label} B={b} k={k}: {e}")
        if num_valid is not None and int(i.max()) >= num_valid:
            fail(f"pq {label}: a padding row was returned")
        if mask is not None and not bool((mask[i[i >= 0].long()] > 0).all()):
            fail(f"pq {label}: a masked-out row was returned")
        report(card, phase=1, kernel=fn.__name__, case=f"pq {label}",
               n=x.shape[0], m=cb.m, b=b, k=k, bit_exact=True,
               max_abs_err=err)
        errs.append(err)
        return i

    def bound_pq(n, m, d, b, k):
        return bound(n * m // 2 + b * d * 4 + m * 16 * (d // m) * 4
                     + b * k * 8, b * n * m, "f32")

    def tied_copies(dup, base, b):
        """K1 over an f32 store of 1024 base rows repeated, at B = b, k =
        100, held without the plain version over all of it: the plain f32
        product of full-precision rows at B = 128 over 1M rows need not
        give copies of a row the same last bit (the library's sums may run
        in another order in another tile), while the kernel's must tie
        exactly. The kernel's 100 scores must be equal, and within
        SCORE_TOL of the plain version's best over the base rows, its base
        row a best one there; returns the positions."""
        q = unit_rows(gen, b, DIM, torch.float32)
        before = topk.launches_wgmma
        s, i = topk(dup, q, k=100)
        plain = ref(base, q, k=1024)[0]
        torch.cuda.synchronize()
        if topk.launches_wgmma != before + 1:
            fail(f"f32 duplicated rows B={b}: not one launch through the "
                 f"TMA + wgmma pass 1")
        best = plain[:, 0]
        mine = (q @ base.T).gather(1, (i[:, :1] % 1024).long())[:, 0]
        if not (torch.equal(s, s[:, :1].expand_as(s))
                and float((s[:, 0] - best).abs().max()) <= SCORE_TOL
                and float((mine - best).abs().max()) <= SCORE_TOL):
            fail(f"f32 duplicated rows B={b}: copies do not tie, or their "
                 f"base row is not a best one")
        report(card, phase=1, case="float32 duplicated rows (tied copies)",
               n=dup.shape[0], d=DIM, b=b, k=100,
               max_abs_err=float((s[:, 0] - best).abs().max()))
        return i

    errs = []
    timings = {}
    nv = N_ROWS - 1000
    x, cb = codes(N_ROWS, 64), codebook(64, DIM)
    # B = 65: a ragged query block of the widest (32)
    for b in (1, 8, 65, 128):
        for k in (1, 10, 100):
            case(x, cb, b, k, "M=64 num_valid=N-1000", num_valid=nv)
    mask = (torch.rand(N_ROWS, generator=gen, device=dev) < 0.5
            ).to(torch.int8)
    for b in (8, 128):
        case(x, cb, b, 10, "M=64 50% mask", mask=mask)
    case(x, cb, 3, 100, "M=64 50 valid rows < k", num_valid=50)
    # 1M rows at B = 1 and 128, k = 10, and phase 4's bucket, B = 8 at its
    # depth of 100
    for b, k in ((1, 10), (128, 10), (8, 100)):
        q = unit_rows(gen, b, DIM, torch.float32)
        timings[f"pq N=1M M=64 B={b} k={k}"] = {
            "ms": cuda_median_ms(lambda: fn(x, q, cb, k=k)),
            "plain_ms": cuda_median_ms(lambda: ref(x, q, cb, k=k)),
            "library_ms": None, **bound_pq(N_ROWS, 64, DIM, b, k)}
    # duplicated code rows: every row appears 1024 times, so the top 100
    # are the 100 lowest copies of one base row, in position order
    dup = x[:1024].repeat(N_ROWS // 1024, 1).contiguous()
    for b in (8, 128):
        i = case(dup, cb, b, 100, "M=64 duplicated rows")
        if not (bool((i // 1024 == torch.arange(100, device=dev)).all())
                and bool((i % 1024 == i[:, :1] % 1024).all())):
            fail("pq duplicated rows: copies out of position order")
    del x, dup, mask
    # D = 128 (configs/compact128_int4.json's width): M = 16, 8-byte rows
    x, cb = codes(N_ROWS, 16), codebook(16, 128)
    for k in (10, 100):
        case(x, cb, 1, k, "M=16", num_valid=nv)
    del x
    # bench.py::bench_pq_capacity's store: 64M rows of 32 bytes, depth 100
    n = PQ_ROWS_CAPACITY
    x, cb = codes(n, 64), codebook(64, DIM)
    for b in (1, 128):
        case(x, cb, b, 100, "M=64 N=64M", num_valid=n - 1000)
    prefix = N_ROWS
    for b in (1, 128):
        q = unit_rows(gen, b, DIM, torch.float32)
        t = {"ms": cuda_median_ms(lambda: fn(x, q, cb, k=100), reps=10),
             **bound_pq(n, 64, DIM, b, 100)}
        if b == 1:
            t["plain_ms"] = cuda_median_ms(lambda: ref(x, q, cb, k=100),
                                           reps=3, warmup=1)
        else:      # the plain version over a prefix of the rows only
            xp = x[:prefix]
            t["plain_ms_prefix"] = cuda_median_ms(
                lambda: ref(xp, q, cb, k=100), reps=3, warmup=1)
            t["plain_prefix_rows"] = prefix
        timings[f"pq N=64M M=64 B={b} k=100"] = t
    del x
    torch.cuda.empty_cache()
    for shape, t in timings.items():
        report(card, phase=1, timing=shape, **t)
    return max(errs), timings


def smooth_images(gen, n: int, size: int = IMAGE, batch: int = 256):
    """Seeded uint8 [n, S, S, 3] images: low-frequency colour patterns
    (bilinear up-sampled 8x8 noise) plus pixel noise, made on the card."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    out = np.empty((n, size, size, 3), np.uint8)
    for s in range(0, n, batch):
        m = min(batch, n - s)
        low = torch.rand(m, 3, 8, 8, generator=gen, device="cuda")
        img = F.interpolate(low, size=(size, size), mode="bilinear",
                            align_corners=False)
        img = img + 0.05 * torch.randn(img.shape, generator=gen,
                                       device="cuda")
        img = (img.clamp(0, 1) * 255).round().to(torch.uint8)
        out[s:s + m] = img.permute(0, 2, 3, 1).cpu().numpy()
    return out


def _everyone():
    from instsearch_torch.kernels import (flash_mha, fused_identity_blocks,
                                          mha, pq_topk, topk_matmul,
                                          topk_matmul_int4, topk_matmul_int8)
    return (topk_matmul, topk_matmul_int8, topk_matmul_int4, pq_topk, mha,
            flash_mha, fused_identity_blocks)


def zero_counts(kernels) -> None:
    """Set each kernel's launch count to 0, the count of K1-K3's launches
    through the TMA + wgmma pass 1 (``launches_wgmma``) and of K1's over an
    f32 store (``launches_f32``)."""
    for fn in kernels:
        fn.launches = 0
        for extra in ("launches_wgmma", "launches_f32"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)


def check_pass1(where: str) -> None:
    """Fail unless every K1, K2 and K3 launch since ``zero_counts`` took the
    TMA + wgmma pass 1 (K1's f32 store: split TF32)."""
    from instsearch_torch.kernels import (topk_matmul, topk_matmul_int4,
                                          topk_matmul_int8)
    for fn in (topk_matmul, topk_matmul_int8, topk_matmul_int4):
        if fn.launches_wgmma != fn.launches:
            fail(f"{where}: {fn.__name__} launched {fn.launches} times, "
                 f"{fn.launches_wgmma} of them through the TMA + wgmma "
                 f"pass 1")


def serve_requests(card, phase, core, images, picks, expect):
    """Warm ``core``, set every kernel's count to 0, serve one request per
    pick and read the counts: each kernel in ``expect`` (kernel -> launches
    per piece) must have launched that many times for each bucket piece of
    the requests (a request splits into pieces of the largest bucket, the
    last one padded; a piece is one backbone pass and one search), and no
    other kernel at all. Every top-1 must be its source image. Returns the
    counts by kernel name."""
    everyone = _everyone()
    core.warmup()
    zero_counts(everyone)
    answers = [core.run_queries([(images[p], 10)])[0] for p in picks]
    counts = {fn.__name__: fn.launches for fn in everyone}
    check_pass1(f"phase {phase} requests")
    pieces = sum(-(-len(p) // core.buckets[-1]) for p in picks)
    want = {fn.__name__: expect.get(fn, 0) * pieces for fn in everyone}
    if counts != want:
        fail(f"the requests ({pieces} bucket pieces) launched {counts}, "
             f"not {want}")
    for p, ans in zip(picks, answers):
        top1 = [row[0]["id"] for row in ans["results"]]
        if top1 != p.tolist():
            fail(f"self-retrieval failed: top-1 {top1} for sources "
                 f"{p.tolist()}")
        report(card, phase=phase, request_images=len(p), top1_correct=True,
               top1_score_min=min(row[0]["score"] for row in ans["results"]),
               latency_ms=ans["latency_ms"])
    return counts


def query_latency(card, phase, idx, ex, images, rng, **fields) -> dict:
    """query_images and search p50 over the 1M-row store at B = 1 and 128,
    host clock, synchronized by the results' host copy."""
    lat = {}
    for b in (1, 128):
        batch = images[rng.choice(len(images), size=b, replace=False)]
        qd = ex(batch)
        idx.query_images(batch)                        # warm this shape
        e2e, search = [], []
        for _ in range(20):
            t0 = time.perf_counter()
            idx.query_images(batch)
            e2e.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            idx.search(qd)
            search.append((time.perf_counter() - t0) * 1e3)
        lat[b] = {"query_images_p50_ms": statistics.median(e2e),
                  "search_p50_ms": statistics.median(search)}
        report(card, phase=phase, query_batch=b, rows=N_ROWS, **fields,
               **lat[b])
    return lat


def extract_corpus(card, phase, ex, images, batch: int):
    """Extract ``images`` in batches as Index.build does; prints the rate."""
    import torch
    ex(images[:batch])                                # cuDNN set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = torch.cat([ex(images[s:s + batch])
                     for s in range(0, len(images), batch)])
    torch.cuda.synchronize()
    ips = len(images) / (time.perf_counter() - t0)
    if not bool(torch.isfinite(raw).all()):
        fail("non-finite descriptors")
    report(card, phase=phase, extract_images_per_s=ips, batch=batch,
           images=len(images), backbone=ex.cfg.backbone,
           image=ex.cfg.image_size, dtype=ex.cfg.dtype,
           **({"vit_attention": ex.cfg.vit_attention}
              if ex.cfg.backbone.startswith("vit") else {}))
    return raw, ips


def phase2(card: str, gen, topk, check) -> dict:
    import numpy as np
    import torch
    from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                                  SearchConfig)
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.index import Index
    from instsearch_torch.ops.whitening import apply_whitening, fit_whitening
    from instsearch_torch.serve import ServeCore

    cfg = PipelineConfig(
        extract=ExtractConfig(backbone="resnet50", pooling="gem", gem_p=3.0,
                              image_size=IMAGE, whiten=True, whiten_dim=DIM,
                              dtype="bfloat16", batch_size=64),
        index=IndexConfig(dtype="bfloat16"), search=SearchConfig(k=10))
    ex = Extractor(cfg.extract.replace(whiten=False), seed=0)
    images = smooth_images(gen, CORPUS)
    raw, ips = extract_corpus(card, 2, ex, images, 64)

    ex.whitening = fit_whitening(raw, dim=DIM)
    corpus = apply_whitening(raw, ex.whitening)
    if not bool(torch.isfinite(corpus).all()):
        fail("non-finite whitened descriptors")
    distract = torch.randn(N_ROWS - CORPUS, DIM, generator=gen, device="cuda")
    distract = distract / distract.norm(dim=1, keepdim=True)
    names = ([f"img{i:05d}" for i in range(CORPUS)]
             + [f"distractor{i:07d}" for i in range(N_ROWS - CORPUS)])
    idx = Index.from_descriptors(torch.cat([corpus, distract]), names, cfg,
                                 extractor=ex)
    del distract, raw
    if tuple(idx.descriptors.shape) != (N_ROWS, DIM):
        fail(f"store shape {tuple(idx.descriptors.shape)}")

    core = ServeCore(idx)
    rng = np.random.default_rng(0)
    picks = [rng.choice(CORPUS, size=n, replace=False) for n in SIZES]
    launches = serve_requests(card, 2, core, images, picks,
                              {topk: 1})["topk_matmul"]

    # the scoring oracle's route, an index over the same store whose own
    # config has use_pallas off, gives the same results
    q = ex(images[np.concatenate(picks)])
    ks, ki = idx.search(q)
    before = topk.launches
    ps, pi = idx.with_search(use_pallas=False).search(q)
    if topk.launches != before:
        fail("the oracle route launched the kernel")
    positions = torch.arange(N_ROWS, dtype=idx.ids.dtype)
    if not torch.equal(idx.ids.cpu(), positions):
        fail("store ids are not its row positions")
    on_card = [torch.from_numpy(np.asarray(a)).cuda() for a in (ks, ki, ps, pi)]
    try:
        check(idx.descriptors, q, *on_card, SCORE_TOL)
    except AssertionError as e:
        fail(f"kernel and oracle route: {e}")
    report(card, phase=2, oracle_route_agrees=True, queries=int(ki.shape[0]),
           topk_launches_in_main_path=launches)

    lat = query_latency(card, 2, idx, ex, images, rng)
    return {"launches": launches, "latency": lat, "extract_ips": ips,
            "state": (idx, images, picks)}


def phase3(card: str, gen) -> dict:
    """The quantized stores with alpha-QE, as the two presets configure
    them; one extractor serves both, since their extraction settings are
    the same (checked). Returns the results and, for phase 4, the store's
    rows, names, extractor, images and request picks."""
    import numpy as np
    import torch
    import instsearch_torch.index as tindex
    from instsearch_torch import PipelineConfig
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.kernels import (topk_matmul_int4,
                                          topk_matmul_int4_reference,
                                          topk_matmul_int8,
                                          topk_matmul_int8_reference)
    from instsearch_torch.ops.whitening import apply_whitening, fit_whitening
    from instsearch_torch.serve import ServeCore

    cfg4 = PipelineConfig.load(os.path.join(HERE, "configs",
                                            "capacity_int4.json"))
    cfg8 = PipelineConfig.load(os.path.join(HERE, "configs",
                                            "million_scale_int8.json"))
    if cfg4.extract != cfg8.extract or not (cfg4.search.qe_enabled
                                            and cfg8.search.qe_enabled):
        fail("the two presets no longer share one QE extraction pipeline")
    ex = Extractor(cfg4.extract.replace(whiten=False), seed=0)
    images = smooth_images(gen, CORPUS_Q, size=cfg4.extract.image_size)
    raw, ips = extract_corpus(card, 3, ex, images, cfg4.extract.batch_size)
    ex.whitening = fit_whitening(raw, dim=cfg4.extract.whiten_dim)
    corpus = apply_whitening(raw, ex.whitening)
    if not bool(torch.isfinite(corpus).all()):
        fail("non-finite whitened descriptors")
    dim = corpus.shape[1]
    distract = torch.randn(N_ROWS - CORPUS_Q, dim, generator=gen,
                           device="cuda")
    rows = torch.cat([corpus, distract / distract.norm(dim=1, keepdim=True)])
    del raw, distract
    names = ([f"img{i:05d}" for i in range(CORPUS_Q)]
             + [f"distractor{i:07d}" for i in range(N_ROWS - CORPUS_Q)])
    rng = np.random.default_rng(1)
    picks = [rng.choice(CORPUS_Q, size=n, replace=False) for n in SIZES]

    out = {"extract_ips": ips}
    for kind, path, cfg, kernel, plain in (
            ("int4", "configs/capacity_int4.json", cfg4, topk_matmul_int4,
             topk_matmul_int4_reference),
            ("int8", "configs/million_scale_int8.json", cfg8,
             topk_matmul_int8, topk_matmul_int8_reference)):
        idx = tindex.Index.from_descriptors(rows, names, cfg, extractor=ex)
        width = dim // 2 if kind == "int4" else dim
        if (tuple(idx.descriptors.shape) != (N_ROWS, width)
                or idx.descriptors.dtype != torch.int8
                or tuple(idx.scales.shape) != (1, N_ROWS)):
            fail(f"{kind} store {tuple(idx.descriptors.shape)} "
                 f"{idx.descriptors.dtype}")
        report(card, phase=3, config=path, store=kind, rows=N_ROWS, dim=dim,
               qe_n=cfg.search.qe_n, qe_alpha=cfg.search.qe_alpha,
               shards=cfg.index.num_shards)
        core = ServeCore(idx)
        launches = serve_requests(card, 3, core, images, picks,
                                  {kernel: 2})[kernel.__name__]

        # the composite with the kernel entry replaced by its plain version
        q = ex(images[np.concatenate(picks)])
        ks, ki = idx.search(q)
        entry = kernel.__name__
        setattr(tindex, entry, plain)
        try:
            ps, pi = idx.search(q)
        finally:
            setattr(tindex, entry, kernel)
        if not (np.array_equal(ki, pi) and np.array_equal(ks, ps)):
            fail(f"{kind}: the composite through {entry} and through its "
                 f"plain version differ")
        # the oracle route scores an f32 query against the stored integers,
        # where the kernel quantizes the query to int8 first
        _, oi = idx.with_search(use_pallas=False).search(q)
        overlap = float(np.mean([len(set(a) & set(b)) / len(a)
                                 for a, b in zip(ki.tolist(), oi.tolist())]))
        report(card, phase=3, store=kind, plain_kernel_route_equal=True,
               queries=int(ki.shape[0]), launches_in_main_path=launches,
               top10_overlap_with_oracle_route=overlap)
        lat = query_latency(card, 3, idx, ex, images, rng, store=kind)
        out[kind] = {"launches": launches, "latency": lat,
                     "oracle_overlap": overlap,
                     "sharded_launches": sharded_route(
                         card, 3, idx, images, picks, q, (ks, ki), kernel, 2,
                         equal_answers)}
        del idx, core
        torch.cuda.empty_cache()
    return out, (cfg4, rows, names, ex, images, picks)


def equal_answers(ss, si, ks, ki) -> float:
    """The rule of K2/K3's routes against each other: ids and scores equal
    bit for bit (numpy); returns 0.0, the largest difference."""
    import numpy as np
    if not (np.array_equal(si, ki) and np.array_equal(ss, ks)):
        fail("the sharded route and the single-device route differ")
    return 0.0


def sharded_route(card, phase, idx, images, picks, q, single, kernel,
                  per_piece: int, check, query_regional=None) -> int:
    """The index's own preset shard count S, all on cuda:0, behind
    ``ServeCore(sharded=True)``: the requests, where ``kernel`` must launch
    S times ``per_piece`` per bucket piece (one launch a shard for each of
    the single-device route's) and no other kernel, every top-1 its source;
    then ``search_sharded`` on the descriptors ``q`` against the
    single-device answer ``single`` by ``check(scores, ids, single scores,
    single ids)``. Returns the launches of the requests (0 for a preset of
    one shard)."""
    from instsearch_torch.parallel import make_mesh
    from instsearch_torch.serve import ServeCore
    shards = idx.cfg.index.num_shards
    if shards == 1:
        return 0
    core = ServeCore(idx, sharded=True,
                     mesh=make_mesh(shards, devices=["cuda"] * shards))
    launches = serve_requests(card, phase, core, images, picks,
                              {kernel: shards * per_piece})[kernel.__name__]
    ss, si = idx.search_sharded(core.sidx, q, query_regional=query_regional)
    err = check(ss, si, *single)
    report(card, phase=phase, shards=shards, mesh="cuda:0 x "
           f"{shards}", sharded_equals_single_device=True, max_abs_err=err,
           queries=int(si.shape[0]), sharded_launches_in_main_path=launches,
           ready=core.ready_info())
    return launches


def phase4(card: str, corpus) -> dict:
    """The PQ cascade of configs/capacity_int4.json over phase 3's corpus:
    build_pq with the reference's defaults, then the same requests."""
    import numpy as np
    import torch
    import instsearch_torch.search.pq_view as pq_view
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import pq_topk, pq_topk_reference
    from instsearch_torch.serve import ServeCore

    cfg, rows, names, ex, images, picks = corpus
    idx = Index.from_descriptors(rows, names, cfg, extractor=ex)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    view = idx.build_pq()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if (tuple(view.codes.shape) != (N_ROWS, 32) or view.codes.device.type
            != "cuda" or idx.cfg.search.pq_depth != 100):
        fail(f"PQ view codes {tuple(view.codes.shape)} on "
             f"{view.codes.device}, pq_depth {idx.cfg.search.pq_depth}")
    report(card, phase=4, config="configs/capacity_int4.json",
           store="int4 + PQ", rows=N_ROWS, m=view.m, depth=view.depth,
           fit_sample=262_144, iters=15, build_pq_s=build_s,
           reduced={"rows": f"{PQ_ROWS_CAPACITY} -> {N_ROWS}: the served "
                            f"store is phase 3's 1M-row int4 store (64M "
                            f"f32 source rows would be 128 GiB); phase 1 "
                            f"times the scan over 64M codes"})
    core = ServeCore(idx)
    launches = serve_requests(card, 4, core, images, picks,
                              {pq_topk: 2})["pq_topk"]

    # the composite with the kernel entry replaced by its plain version
    rng = np.random.default_rng(2)
    q = ex(images[np.concatenate(picks)])
    ks, ki = idx.search(q)
    pq_view.pq_topk = pq_topk_reference
    try:
        ps, pi = idx.search(q)
    finally:
        pq_view.pq_topk = pq_topk
    if not (np.array_equal(ki, pi) and np.array_equal(ks, ps)):
        fail("PQ: the composite through pq_topk and through its plain "
             "version differ")
    # recall of the cascade's candidates against the exact int4 route; at
    # k=10 the exact top-10 beyond the source are near-orthogonal distractor
    # and corpus rows, whose order the 4-bit codes cannot resolve
    recall = {k: view.measure_recall(idx, q, k=k) for k in (1, 10)}
    _, oi = idx.with_search(use_pallas=False).search(q)
    overlap = float(np.mean([len(set(a) & set(b)) / len(a)
                             for a, b in zip(ki.tolist(), oi.tolist())]))
    report(card, phase=4, plain_kernel_route_equal=True,
           queries=int(ki.shape[0]), launches_in_main_path=launches,
           recall_at_1_vs_exact_int4=recall[1],
           recall_at_10_vs_exact_int4=recall[10],
           top10_overlap_with_oracle_route=overlap)
    lat = query_latency(card, 4, idx, ex, images, rng, store="int4 + PQ")
    return {"launches": launches, "latency": lat, "build_s": build_s,
            "recall": recall, "oracle_overlap": overlap, "index": idx}


def vit_extract_config(size: int, attention: str, batch: int):
    from instsearch_torch import ExtractConfig
    return ExtractConfig(backbone="vit_b_16", pooling="gem", gem_p=3.0,
                         image_size=size, dtype="bfloat16", batch_size=batch,
                         vit_attention=attention)


def route_cosine(a, b) -> tuple[float, float]:
    """(min, median) row cosine of two descriptor sets."""
    import torch
    cos = torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=1)
    return cos.min().item(), cos.median().item()


def phase5(card: str, gen, topk) -> dict:
    """The ViT serving path: ViT-B/16 at 224 px (bf16, GeM p=3, whitening to
    512) on the K6 route extracts VIT_CORPUS seeded images, stored among
    seeded unit distractors (1M x 512 bf16), behind ServeCore; the requests
    of phase 2. K6 must launch VIT_LAYERS times and K1 once per bucket
    piece, and no other kernel; every top-1 must be its source. The plain
    route (an extractor and index whose own config has vit_attention="xla",
    the same weights and whitening) must give the same top-1 and descriptors
    within VIT_ROUTE_COS. Returns the results and the backbone's weights."""
    import numpy as np
    import torch
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import mha
    from instsearch_torch.ops.whitening import apply_whitening, fit_whitening
    from instsearch_torch.serve import ServeCore

    cfg = PipelineConfig(
        extract=vit_extract_config(IMAGE, "pallas", 64).replace(
            whiten=True, whiten_dim=DIM),
        index=IndexConfig(dtype="bfloat16"), search=SearchConfig(k=10))
    ex = Extractor(cfg.extract.replace(whiten=False), seed=0)
    ex_x = Extractor(cfg.extract.replace(whiten=False, vit_attention="xla"),
                     seed=0)
    ex_x.model.load_state_dict(ex.model.state_dict())
    images = smooth_images(gen, VIT_CORPUS)
    raw, ips = extract_corpus(card, 5, ex, images, 64)
    raw_x, ips_x = extract_corpus(card, 5, ex_x, images, 64)
    raw_cos = route_cosine(raw, raw_x)
    if raw_cos[0] < VIT_ROUTE_COS:
        fail(f"ViT descriptors: K6 route and plain route cosine "
             f"{raw_cos[0]} < {VIT_ROUTE_COS}")

    ex.whitening = ex_x.whitening = fit_whitening(raw, dim=DIM)
    corpus = apply_whitening(raw, ex.whitening)
    if not bool(torch.isfinite(corpus).all()):
        fail("non-finite whitened ViT descriptors")
    distract = torch.randn(N_ROWS - VIT_CORPUS, DIM, generator=gen,
                           device="cuda")
    distract = distract / distract.norm(dim=1, keepdim=True)
    names = ([f"img{i:05d}" for i in range(VIT_CORPUS)]
             + [f"distractor{i:07d}" for i in range(N_ROWS - VIT_CORPUS)])
    idx = Index.from_descriptors(torch.cat([corpus, distract]), names, cfg,
                                 extractor=ex)
    del distract, raw, raw_x
    report(card, phase=5, backbone="vit_b_16", image=IMAGE, tokens=197,
           vit_attention="pallas", store="bf16", rows=N_ROWS, dim=DIM,
           corpus=VIT_CORPUS)
    core = ServeCore(idx)
    rng = np.random.default_rng(5)
    picks = [rng.choice(VIT_CORPUS, size=n, replace=False) for n in SIZES]
    counts = serve_requests(card, 5, core, images, picks,
                            {topk: 1, mha: VIT_LAYERS})

    # the plain route: the same store behind a config with vit_attention xla
    cfg_x = cfg.replace(extract=cfg.extract.replace(vit_attention="xla"))
    idx_x = Index(idx.descriptors, idx.ids, idx.names, cfg_x, ex_x)
    sel = np.concatenate(picks)
    q = ex(images[sel])
    mha.launches = 0
    _, ix = idx_x.query_images(images[sel])
    if mha.launches:
        fail("the plain attention route launched K6")
    if not np.array_equal(ix[:, 0], sel):
        fail(f"plain route: top-1 {ix[:, 0].tolist()} for {sel.tolist()}")
    q_cos = route_cosine(q, ex_x(images[sel]))
    report(card, phase=5, plain_route_top1_correct=True,
           descriptor_cos_vs_plain_min=raw_cos[0],
           descriptor_cos_vs_plain_median=raw_cos[1],
           whitened_query_cos_vs_plain_min=q_cos[0],
           mha_launches_in_main_path=counts["mha"],
           topk_launches_in_main_path=counts["topk_matmul"],
           extract_images_per_s_pallas=ips, extract_images_per_s_xla=ips_x)
    lat = query_latency(card, 5, idx, ex, images, rng, backbone="vit_b_16")
    return {"mha_launches": counts["mha"], "latency": lat, "ips": ips,
            "ips_xla": ips_x, "cos": raw_cos, "q_cos": q_cos,
            "weights": ex.model.state_dict()}


def phase5_highres(card: str, gen, weights) -> dict:
    """High-resolution extraction on the K5 route: ViT-B/16 with phase 5's
    weights at 1024 px (4,097 tokens, batches of 4) and 2048 px (16,385
    tokens, batches of 1), two batches each after a warm-up. K5 must launch
    VIT_LAYERS times per backbone pass and K6 never; the descriptors must be
    within VIT_ROUTE_COS of the plain route's, which must fit at 1024 px and
    is reported at 2048 px where it fits. Returns rates and launches."""
    import torch
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.kernels import flash_mha, mha

    def run(ex, imgs, b):
        ex(imgs[:b])                                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = torch.cat([ex(imgs[s:s + b]) for s in range(0, len(imgs), b)])
        torch.cuda.synchronize()
        return d, len(imgs) / (time.perf_counter() - t0)

    out = {"flash_launches": 0}
    for size, b in ((1024, 4), (2048, 1)):
        tokens = (size // 16) ** 2 + 1
        imgs = smooth_images(gen, 2 * b, size=size, batch=b)
        ex = Extractor(vit_extract_config(size, "flash", b), seed=0)
        ex.model.load_state_dict(weights)
        mha.launches = flash_mha.launches = 0
        d, ips = run(ex, imgs, b)
        passes = 1 + len(imgs) // b                   # warm-up included
        if (flash_mha.launches, mha.launches) != (VIT_LAYERS * passes, 0):
            fail(f"{size} px: K5 launched {flash_mha.launches} times and K6 "
                 f"{mha.launches} in {passes} backbone passes")
        out["flash_launches"] += flash_mha.launches
        del ex
        torch.cuda.empty_cache()
        ex_x = Extractor(vit_extract_config(size, "xla", b), seed=0)
        ex_x.model.load_state_dict(weights)
        torch.cuda.reset_peak_memory_stats()
        try:
            dx, ips_x = run(ex_x, imgs, b)
        except torch.cuda.OutOfMemoryError:
            if size == 1024:
                fail("the plain route ran out of memory at 1024 px")
            dx = ips_x = None
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del ex_x
        torch.cuda.empty_cache()
        if dx is not None:
            cos = route_cosine(d, dx)
            if cos[0] < VIT_ROUTE_COS:
                fail(f"{size} px: K5 route and plain route cosine {cos[0]} "
                     f"< {VIT_ROUTE_COS}")
            fields = {"descriptor_cos_vs_plain_min": cos[0],
                      "extract_images_per_s_xla": ips_x,
                      "xla_peak_gib": peak}
        else:
            fields = {"extract_images_per_s_xla": "out of memory"}
        report(card, phase=5, image=size, tokens=tokens, batch=b,
               vit_attention="flash", extract_images_per_s_flash=ips,
               flash_launches=VIT_LAYERS * passes, **fields)
        out[size] = {"ips": ips, **fields}
    return out


def gem_descriptors(backbone, images, batch: int):
    """L2-normalized GeM (p = 3) descriptors [N, 2048] f32 of uint8
    ``images`` through ``backbone`` (NHWC normalized bf16 -> NHWC feature
    maps), batch by batch, after one warm-up batch; returns (descriptors,
    images/s, forwards run)."""
    import torch
    from instsearch_torch.data.frontend import normalize
    from instsearch_torch.ops.pooling import gem_pool, l2_normalize

    def run(part):
        x = normalize(torch.from_numpy(part).cuda())
        return l2_normalize(gem_pool(backbone(x), 3.0).float())

    with torch.inference_mode():
        run(images[:batch])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = torch.cat([run(images[s:s + batch])
                       for s in range(0, len(images), batch)])
        torch.cuda.synchronize()
    return d, len(images) / (time.perf_counter() - t0), \
        1 + -(-len(images) // batch)


def phase6(card: str, gen, model) -> dict:
    """The fused-ResNet inference path at full width: ResNet-50 with
    ``model``'s seeded weights and randomized BN at 224 px, B = 64, through
    (a) the module route (``model``, cuDNN), (b) ``fused_resnet_apply``
    with the default ``fused_layers=(2,)`` and (c) with ``(1, 2, 3, 4)``.
    (a) extracts FUSED_CORPUS images, (b) and (c) the first FUSED_QUERIES;
    each route's GeM descriptors must be within FUSED_COS of (a)'s per
    image. (b)'s and (c)'s descriptors, whitened by a whitening fitted on
    (a)'s, search a 1M x 512 bf16 store of (a)'s among seeded unit
    distractors (K1): every top-1 must be its own image. K7 must launch
    3 times per forward on (b) and 12 on (c) (one launch a block), never on
    (a). Then one batch of 512 px images (``configs/capacity_int4.json``'s
    size) through (c) and (a), held to the same cosine."""
    import numpy as np
    import torch
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import (fused_identity_blocks,
                                          fused_resnet_apply)
    from instsearch_torch.kernels.fused_resnet import STAGE_SIZES
    from instsearch_torch.ops.whitening import apply_whitening, fit_whitening

    sd = model.state_dict()
    stages = STAGE_SIZES["resnet50"]
    per_forward = {(2,): 3, (1, 2, 3, 4): 12}
    images = smooth_images(gen, FUSED_CORPUS)
    fused_identity_blocks.launches = 0
    raw_a, ips_a, _ = gem_descriptors(model, images, 64)
    if fused_identity_blocks.launches:
        fail("the module route launched K7")
    raw, ips, launches, cos = {}, {}, 0, {}
    for layers, want in per_forward.items():
        route = f"fused_layers={layers}"
        fused_identity_blocks.launches = 0
        raw[layers], ips[layers], forwards = gem_descriptors(
            lambda x: fused_resnet_apply(sd, x, stages, fused_layers=layers),
            images[:FUSED_QUERIES], 64)
        if fused_identity_blocks.launches != want * forwards:
            fail(f"{route}: K7 launched {fused_identity_blocks.launches} "
                 f"times in {forwards} forwards, not {want} a forward")
        launches += fused_identity_blocks.launches
        cos[layers] = route_cosine(raw[layers], raw_a[:FUSED_QUERIES])
        if not bool(torch.isfinite(raw[layers]).all()) \
                or cos[layers][0] < FUSED_COS:
            fail(f"{route}: GeM descriptors against the module route's, "
                 f"cosine {cos[layers][0]} < {FUSED_COS}")
        report(card, phase=6, route=route, image=IMAGE, batch=64,
               images=FUSED_QUERIES, extract_images_per_s=ips[layers],
               k7_launches=fused_identity_blocks.launches, forwards=forwards,
               gem_cos_vs_module_min=cos[layers][0],
               gem_cos_vs_module_median=cos[layers][1])
    report(card, phase=6, route="module (cuDNN, BN unfolded)", image=IMAGE,
           batch=64, images=FUSED_CORPUS, extract_images_per_s=ips_a)

    # search: the whitened fused-route descriptors against the module
    # route's store among distractors
    wh = fit_whitening(raw_a, dim=DIM)
    corpus = apply_whitening(raw_a, wh)
    distract = torch.randn(N_ROWS - FUSED_CORPUS, DIM, generator=gen,
                           device="cuda")
    distract = distract / distract.norm(dim=1, keepdim=True)
    names = ([f"img{i:05d}" for i in range(FUSED_CORPUS)]
             + [f"distractor{i:07d}" for i in range(N_ROWS - FUSED_CORPUS)])
    cfg = PipelineConfig(index=IndexConfig(dtype="bfloat16"),
                         search=SearchConfig(k=10))
    idx = Index.from_descriptors(torch.cat([corpus, distract]), names, cfg)
    del distract, corpus
    own = np.arange(FUSED_QUERIES)
    for layers in per_forward:
        _, ids = idx.search(apply_whitening(raw[layers], wh))
        if not np.array_equal(ids[:, 0], own):
            bad = int((ids[:, 0] != own).sum())
            fail(f"fused_layers={layers}: {bad} of {FUSED_QUERIES} top-1 "
                 f"are not their own image")
    report(card, phase=6, search="whitened fused-route queries vs module-"
           "route store", rows=N_ROWS, dim=DIM, queries=FUSED_QUERIES,
           top1_own_image=True)
    del idx

    # one batch at 512 px through (c), against (a)
    big = smooth_images(gen, 64, size=512, batch=64)
    fused_identity_blocks.launches = 0
    d_c, ips_c, forwards = gem_descriptors(
        lambda x: fused_resnet_apply(sd, x, stages, fused_layers=(1, 2, 3, 4)),
        big, 64)
    if fused_identity_blocks.launches != 12 * forwards:
        fail(f"512 px: K7 launched {fused_identity_blocks.launches} times "
             f"in {forwards} forwards")
    launches += fused_identity_blocks.launches
    d_a, ips_a512, _ = gem_descriptors(model, big, 64)
    cos512 = route_cosine(d_c, d_a)
    if cos512[0] < FUSED_COS:
        fail(f"512 px: fused_layers=(1, 2, 3, 4) against the module route, "
             f"cosine {cos512[0]} < {FUSED_COS}")
    report(card, phase=6, route="fused_layers=(1, 2, 3, 4)", image=512,
           batch=64, images=64, extract_images_per_s=ips_c,
           extract_images_per_s_module=ips_a512, k7_launches=12 * forwards,
           gem_cos_vs_module_min=cos512[0])
    torch.cuda.empty_cache()
    return {"launches": launches, "ips_module": ips_a, "ips": ips,
            "cos": cos, "ips_512": ips_c, "ips_512_module": ips_a512,
            "cos_512": cos512}


def phase7(card: str, gen) -> dict:
    """Widths, depths and PQ sizes the reference serves: an Index of
    F4_ROWS seeded unit rows of D = 31 (a whitening clamped to 32 images)
    in bf16, int8 and int4, its own rows perturbed as queries. The kernel
    route must launch its kernel (the store padded to its multiple) and
    equal the route through the kernel's plain version (bf16 by
    ``check_against_plain``, int8/int4 bit for bit), every top-1 its source;
    k = 2000 must take the scoring oracle (no launch) and agree with f64
    scores of the stored rows on the host: scores within SCORE_TOL, ids
    equal but at near-ties (the host's scores of the two within SCORE_TOL);
    ``build_pq`` at D = 96 (M = 12, codes padded from 6 to 8 bytes)
    must scan through K4 and equal the plain version over the unpadded
    codes bit for bit."""
    import numpy as np
    import torch
    import instsearch_torch.index as tindex
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.kernels import (pq_topk, pq_topk_reference,
                                          topk_matmul, topk_matmul_int4,
                                          topk_matmul_int4_reference,
                                          topk_matmul_int8,
                                          topk_matmul_int8_reference,
                                          topk_matmul_reference)
    from instsearch_torch.kernels.topk_matmul import (check_against_plain,
                                                      check_exact)
    from instsearch_torch.ops.quantize import unpack_int4

    def host_topk(idx, q, k):
        """(scores, ids) of the top k by f64 scores of the stored rows (the
        query as the oracle takes it), padding rows out; and the scores."""
        x = unpack_int4(idx.descriptors) if idx.is_int4 else idx.descriptors
        qq = idx._match_query_dim(q)
        if x.dtype != torch.int8:
            qq = qq.to(x.dtype)
        sc = qq.double().cpu().numpy() @ x.double().cpu().numpy().T
        if idx.scales is not None:
            sc = sc * idx.scales.double().cpu().numpy()
        ids = idx.ids.cpu().numpy()
        sc[:, ids < 0] = -np.inf
        pos = np.argsort(-sc, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(sc, pos, 1), ids[pos], sc

    out = {}
    rows = unit_rows(gen, F4_ROWS, 31, torch.float32)
    names = [f"r{i}" for i in range(F4_ROWS)]
    src = torch.arange(0, F4_ROWS, F4_ROWS // 8, device="cuda")
    q = rows[src] + 0.01 * torch.randn(8, 31, generator=gen, device="cuda")
    for dtype, kernel, plain in (
            ("bfloat16", topk_matmul, topk_matmul_reference),
            ("int8", topk_matmul_int8, topk_matmul_int8_reference),
            ("int4", topk_matmul_int4, topk_matmul_int4_reference)):
        cfg = PipelineConfig(index=IndexConfig(dtype=dtype),
                             search=SearchConfig(k=10))
        idx = tindex.Index.from_descriptors(rows, names, cfg)
        before = (kernel.launches, kernel.launches_wgmma)
        ks, ki = idx.search(q)
        launched = kernel.launches - before[0]
        if kernel.launches_wgmma - before[1] != launched:
            fail(f"D=31 {dtype}: a launch missed the TMA + wgmma pass 1")
        if launched != 1 or not np.array_equal(ki[:, 0], src.cpu().numpy()):
            fail(f"D=31 {dtype}: {launched} launches, top-1 "
                 f"{ki[:, 0].tolist()}")
        entry = kernel.__name__
        setattr(tindex, entry, plain)
        try:
            ps, pi = idx.search(q)
        finally:
            setattr(tindex, entry, kernel)
        on_card = [torch.from_numpy(np.asarray(a)).cuda()
                   for a in (ks, ki, ps, pi)]
        try:
            if dtype == "bfloat16":
                check_against_plain(idx.descriptors, idx._match_query_dim(q),
                                    *on_card, SCORE_TOL)
            else:
                check_exact(*on_card)
        except AssertionError as e:
            fail(f"D=31 {dtype}: kernel and plain version: {e}")
        before = kernel.launches
        ds, di = idx.search(q, cfg.search.replace(k=2000))
        if kernel.launches != before or di.shape != (8, 2000):
            fail(f"D=31 {dtype} k=2000: {kernel.launches - before} "
                 f"launches, shape {di.shape}")
        hs, hi, sc = host_topk(idx, q, 2000)
        err = float(np.abs(np.asarray(ds, np.float64) - hs).max())
        rows_at, slots = np.nonzero(np.asarray(di) != hi)
        # ids are row positions here: the Index numbers its rows
        gap = np.abs(sc[rows_at, np.asarray(di)[rows_at, slots]]
                     - sc[rows_at, hi[rows_at, slots]])
        if err > SCORE_TOL or (gap.size and gap.max() >= SCORE_TOL):
            fail(f"D=31 {dtype} k=2000: scores differ from the host's by "
                 f"{err}, {gap.size} ids differ, largest score gap "
                 f"{gap.max() if gap.size else 0.0}")
        report(card, phase=7, store=dtype, d=31, store_dim=idx.store_dim,
               rows=F4_ROWS, kernel_launches=launched, k2000_oracle=True,
               k2000_max_abs_err=err, k2000_near_tie_swaps=int(gap.size),
               plain_equal=True)
        out[dtype] = idx.store_dim
        del idx

    rows = unit_rows(gen, F4_ROWS, 96, torch.float32)
    cfg = PipelineConfig(index=IndexConfig(dtype="bfloat16"),
                         search=SearchConfig(k=10))
    idx = tindex.Index.from_descriptors(rows, names, cfg)
    view = idx.build_pq(iters=5)
    if view.m != 12 or tuple(view.packed.shape) != (F4_ROWS, 8):
        fail(f"build_pq at D=96: m={view.m}, packed "
             f"{tuple(view.packed.shape)}")
    q = rows[src] + 0.01 * torch.randn(8, 96, generator=gen, device="cuda")
    for k in (10, 100):
        s, i = pq_topk(view.packed, q, view.codebook, k=k)
        rs, ri = pq_topk_reference(view.codes.contiguous(), q, view.codebook,
                                   k=k)
        torch.cuda.synchronize()
        try:
            check_exact(s, i, rs, ri)
        except AssertionError as e:
            fail(f"build_pq at D=96, k={k}: padded codes: {e}")
    before = pq_topk.launches
    _, pi = idx.search(q)
    if pq_topk.launches == before or not np.array_equal(pi[:, 0],
                                                         src.cpu().numpy()):
        fail(f"build_pq at D=96: top-1 {pi[:, 0].tolist()}")
    report(card, phase=7, store="bf16 + PQ", d=96, m=view.m,
           code_bytes=view.packed.shape[1], rows=F4_ROWS,
           padded_scan_bit_exact=True, top1_correct=True)
    out["pq_m"] = view.m
    return out


def check_fused_against_plain(ks, ki, ps, pi, tol: float) -> float:
    """Hold a re-ranked top-k ``(ks, ki)`` to the same composite over the
    plain version's candidates ``(ps, pi)`` (numpy): the same slots empty,
    fused scores within ``tol``, and a slot may hold another id only where
    the plain route's fused scores of the two ids are within ``tol`` (two
    global scores summed in other orders can flip such a near-tie; at the
    last slot the other id may lie past the plain route's k). Returns the
    largest score difference."""
    import numpy as np
    filled = np.isfinite(ps)
    if not np.array_equal(np.isfinite(ks), filled) or not np.array_equal(
            ki >= 0, filled):
        fail("re-rank: kernel and plain routes fill different slots")
    err = float(np.abs(ks - ps)[filled].max()) if filled.any() else 0.0
    if err > tol:
        fail(f"re-rank: fused scores differ by {err} > {tol}")
    last = ki.shape[1] - 1
    for row in range(ki.shape[0]):
        fused = dict(zip(pi[row].tolist(), ps[row].tolist()))
        for slot, (a, b) in enumerate(zip(ki[row].tolist(),
                                          pi[row].tolist())):
            if a == b or (slot == last and a not in fused):
                continue
            if a not in fused or abs(fused[a] - fused[b]) >= tol:
                fail(f"re-rank: query {row} slot {slot} holds {a}, the plain "
                     f"route {b}, beyond a near-tie")
    return err


def regional_unit_rows(gen, n: int, start: int, out, chunk: int = 32768):
    """Fill ``out[start:n]`` ([N, R, D] bf16 on the card) with seeded unit
    regional rows, ``chunk`` rows at a time, so no f32 copy of the whole
    store is ever made."""
    import torch
    _, r, d = out.shape
    for s in range(start, n, chunk):
        m = min(chunk, n - s)
        x = torch.randn(m, r, d, generator=gen, device="cuda")
        out[s:s + m] = (x / x.norm(dim=-1, keepdim=True)).to(out.dtype)


def rerank_latency(card, idx, ex, images, rng, variants) -> dict:
    """query_images and search p50 over the 1M-row store at B = 1, 8 and
    128 for each (label, search config) of ``variants``, host clock,
    synchronized by the results' host copy."""
    import torch
    lat = {}
    for b in (1, 8, 128):
        batch = images[rng.choice(len(images), size=b, replace=False)]
        q, qreg = ex.extract_with_regional(batch)
        for label, scfg in variants:
            idx.query_images(batch, scfg)            # warm this shape
            e2e, search = [], []
            for _ in range(20):
                t0 = time.perf_counter()
                idx.query_images(batch, scfg)
                e2e.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                idx.search(q, scfg, query_regional=qreg)
                search.append((time.perf_counter() - t0) * 1e3)
            lat[(label, b)] = {"query_images_p50_ms": statistics.median(e2e),
                               "search_p50_ms": statistics.median(search)}
            report(card, phase=8, workload=5, stage=label, query_batch=b,
                   rows=N_ROWS, **lat[(label, b)])
        del q, qreg
        torch.cuda.empty_cache()
    return lat


def phase8a(card: str, gen, topk, check) -> dict:
    """Workload 2, configs/paris6k_vgg16_rmac_whiten.json as loaded: VGG16
    at 512 px (bf16, R-MAC at 3 levels) extracts CORPUS_Q seeded images at
    the preset's batch 32, whitening fitted on them; stored among seeded
    unit distractor rows (1M x 512 bf16) behind ServeCore, the requests of
    phase 2. Every top-1 must be its source; K1 must launch once per bucket
    piece; the oracle twin must agree. Returns the results and, for 8b, the
    store's rows, names, the extractor and the images."""
    import numpy as np
    import torch
    from instsearch_torch import PipelineConfig
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.index import Index
    from instsearch_torch.ops.whitening import apply_whitening, fit_whitening
    from instsearch_torch.serve import ServeCore

    path = "configs/paris6k_vgg16_rmac_whiten.json"
    cfg = PipelineConfig.load(os.path.join(HERE, path))
    ex = Extractor(cfg.extract.replace(whiten=False), seed=0)
    images = smooth_images(gen, CORPUS_Q, size=cfg.extract.image_size)
    raw, ips = extract_corpus(card, 8, ex, images, cfg.extract.batch_size)
    ex.whitening = fit_whitening(raw, dim=cfg.extract.whiten_dim or None)
    corpus = apply_whitening(raw, ex.whitening)
    if not bool(torch.isfinite(corpus).all()):
        fail("non-finite whitened VGG16 descriptors")
    dim = corpus.shape[1]
    distract = torch.randn(N_ROWS - CORPUS_Q, dim, generator=gen,
                           device="cuda")
    rows = torch.cat([corpus, distract / distract.norm(dim=1, keepdim=True)])
    del raw, distract
    names = ([f"img{i:05d}" for i in range(CORPUS_Q)]
             + [f"distractor{i:07d}" for i in range(N_ROWS - CORPUS_Q)])
    idx = Index.from_descriptors(rows, names, cfg, extractor=ex)
    if tuple(idx.descriptors.shape) != (N_ROWS, dim):
        fail(f"store shape {tuple(idx.descriptors.shape)}")
    report(card, phase=8, workload=2, config=path, backbone="vgg16",
           image=cfg.extract.image_size, pooling="rmac",
           rmac_levels=cfg.extract.rmac_levels, store="bf16", rows=N_ROWS,
           dim=dim, corpus=CORPUS_Q)
    core = ServeCore(idx)
    rng = np.random.default_rng(8)
    picks = [rng.choice(CORPUS_Q, size=n, replace=False) for n in SIZES]
    launches = serve_requests(card, 8, core, images, picks,
                              {topk: 1})["topk_matmul"]
    q = ex(images[np.concatenate(picks)])
    ks, ki = idx.search(q)
    ps, pi = idx.with_search(use_pallas=False).search(q)
    on_card = [torch.from_numpy(np.asarray(a)).cuda() for a in (ks, ki, ps, pi)]
    try:
        check(idx.descriptors, q, *on_card, SCORE_TOL)
    except AssertionError as e:
        fail(f"workload 2: kernel and oracle route: {e}")
    report(card, phase=8, workload=2, oracle_route_agrees=True,
           queries=int(ki.shape[0]), topk_launches_in_main_path=launches)
    lat = query_latency(card, 8, idx, ex, images, rng, workload=2)
    del idx, core
    torch.cuda.empty_cache()
    return ({"launches": launches, "latency": lat, "extract_ips": ips},
            (rows, names, ex, images, picks))


def depth_timings(card, kind: str, fn, ref, check, x, scales, q,
                  num_valid) -> dict:
    """``fn`` (K1 or K3) at the re-rank depth on the phase's own store and
    query rows at B = 1, 8 and 128 (the rows repeated up to B): held to its
    plain version by ``check(q, scores, pos, plain scores, plain pos)`` and
    timed beside it and, for K1 over a store of valid rows only, beside
    ``torch.topk(q @ x.T, 100)``. Returns timings by B."""
    import numpy as np
    import torch
    args = (x,) if scales is None else (x, scales)
    width = x.shape[1] * (2 if kind == "int4" else 1)
    out = {}
    for b in (1, 8, 128):
        qq = q[torch.from_numpy(np.resize(np.arange(len(q)), b)).cuda()]
        s, i = fn(*args, qq, k=RERANK_DEPTH, num_valid=num_valid)
        rs, ri = ref(*args, qq, k=RERANK_DEPTH, num_valid=num_valid)
        try:
            err = check(qq, s, i, rs, ri)
        except AssertionError as e:
            fail(f"{fn.__name__} at depth {RERANK_DEPTH}, B={b}: {e}")
        # the yardstick where one PyTorch call computes K1's function (every
        # row valid): one bf16 product and torch.topk; none for K3
        qb = qq.to(torch.bfloat16)
        out[b] = {"ms": cuda_median_ms(lambda: fn(*args, qq, k=RERANK_DEPTH,
                                                  num_valid=num_valid)),
                  "plain_ms": cuda_median_ms(
                      lambda: ref(*args, qq, k=RERANK_DEPTH,
                                  num_valid=num_valid), reps=5),
                  "library_ms": (cuda_median_ms(
                      lambda: torch.topk(qb @ x.T, RERANK_DEPTH))
                      if kind == "bf16" and num_valid == x.shape[0]
                      else None),
                  **bound(x.numel() * x.element_size() + b * width * 4
                          + b * RERANK_DEPTH * 8,
                          2 * b * x.shape[0] * width,
                          "bf16" if kind == "bf16" else "int8")}
        report(card, phase=8, kernel=fn.__name__, store=kind, rows=N_ROWS,
               b=b, k=RERANK_DEPTH, max_abs_err=err, **out[b])
    return out


def phase8b(card: str, gen, topk, topk_ref, check, corpus) -> dict:
    """Workload 5, configs/rerank_regional_top100.json as loaded, with 8a's
    weights: Index.build over RERANK_BUILD of 8a's images written as PNG
    files (the combined single-pass extraction, the regional whitening and
    attach_regional_store with its grid geometry through the entry point);
    then the R1M-scale store: 8a's 1M rows with the corpus's regional rows
    (one combined pass) and seeded unit regional rows for the distractors,
    made on the card, a [1M, 14, 512] bf16 store. ServeCore answers the
    requests with re-rank, then with spatial_weight = 0.5
    (configs/spatial_rerank_top100.json, one shard). Every top-1 must be
    its source; K1 must launch once per bucket piece (the top-100) and no
    other kernel; the composite over K1's plain version must agree by
    check_fused_against_plain; the oracle twin on every top-1; K1 itself at
    depth 100 on these queries by ``check`` (``check_against_plain``)."""
    import tempfile

    import cv2
    import numpy as np
    import torch
    import instsearch_torch.index as tindex
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index, attach_regional_store
    from instsearch_torch.search.rerank import rerank_from_candidates
    from instsearch_torch.serve import ServeCore

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("TF32 is on: the region products would not be f32")
    rows, names, ex, images, picks = corpus
    path = "configs/rerank_regional_top100.json"
    cfg = PipelineConfig.load(os.path.join(HERE, path))
    sp_path = "configs/spatial_rerank_top100.json"
    cfg_sp = PipelineConfig.load(os.path.join(HERE, sp_path))
    if (cfg.extract != ex.cfg.replace(whiten=True)
            or cfg_sp.search != cfg.search.replace(spatial_weight=0.5)
            or cfg_sp.index.replace(num_shards=1) != cfg.index
            or cfg.search.rerank_depth != RERANK_DEPTH
            or N_ROWS % (cfg_sp.index.row_tile * cfg_sp.index.num_shards)):
        fail("the re-rank presets no longer share workload 2's extraction "
             "or differ from each other beyond spatial_weight and shards, "
             "or their stores' layouts differ")

    # Index.build over files: one combined pass, whitening fitted on the
    # global descriptors, the regional store whitened and attached
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(RERANK_BUILD):
            p = os.path.join(tmp, f"img{i:05d}.png")
            if not cv2.imwrite(p, images[i][:, :, ::-1]):
                fail(f"cannot write {p}")
            paths.append(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = Index.build(paths, cfg, seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    r_build = built.regional
    if (r_build is None or r_build.dtype != torch.bfloat16
            or tuple(r_build.shape[1:]) != (REGIONS, built.dim)
            or built.regional_geom is None
            or built.regional_geom.shape != (REGIONS, 3)
            or built.num_valid != RERANK_BUILD):
        shape = None if r_build is None else tuple(r_build.shape)
        fail(f"Index.build's regional store {shape} / geometry "
             f"{built.regional_geom}")
    norms = r_build[:RERANK_BUILD].float().norm(dim=-1)
    if float((norms - 1).abs().max()) > 1e-2:
        fail("Index.build's regional rows are not unit-norm")
    sel = np.arange(0, RERANK_BUILD, RERANK_BUILD // 8)
    _, bi = built.query_images(images[sel])
    if not np.array_equal(bi[:, 0], sel):
        fail(f"Index.build: top-1 {bi[:, 0].tolist()} for {sel.tolist()}")
    report(card, phase=8, workload=5, config=path, index_build_images=
           RERANK_BUILD, index_build_s=build_s,
           regional_store=list(r_build.shape),
           geometry_regions=len(built.regional_geom), top1_correct=True)
    del built, r_build
    torch.cuda.empty_cache()

    # the R1M-scale store: the corpus's regional rows from one combined
    # pass, seeded unit rows for the distractors, all made on the card
    idx = Index.from_descriptors(rows, names, cfg, extractor=ex)
    dim = idx.dim
    reg = torch.empty((N_ROWS, REGIONS, dim), dtype=torch.bfloat16,
                      device="cuda")
    bs = cfg.extract.batch_size
    for s in range(0, CORPUS_Q, bs):
        part = ex.extract_regional(images[s:s + bs])
        reg[s:s + len(part)] = part.to(reg.dtype)
    regional_unit_rows(gen, N_ROWS, CORPUS_Q, reg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    attach_regional_store(idx, reg)
    torch.cuda.synchronize()
    attach_s = time.perf_counter() - t0
    del reg
    torch.cuda.empty_cache()
    if (tuple(idx.regional.shape) != (N_ROWS, REGIONS, dim)
            or idx.regional.dtype != torch.bfloat16
            or idx.regional.device.type != "cuda"
            or idx.regional_geom is None):
        fail(f"regional store {tuple(idx.regional.shape)} "
             f"{idx.regional.dtype} on {idx.regional.device}")
    report(card, phase=8, workload=5, store="bf16", rows=N_ROWS,
           regional_store=[N_ROWS, REGIONS, dim],
           regional_store_gb=idx.regional.numel() * 2 / 1e9,
           attach_regional_store_s=attach_s, rerank_depth=RERANK_DEPTH,
           peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)

    sel = np.concatenate(picks)
    q, qreg = ex.extract_with_regional(images[sel])
    out = {"launches": 0, "sharded_launches": 0}
    # the spatial preset's 2 shards pad 1M rows as its 1 shard does, so its
    # index is the same tensors behind its own config
    spatial = idx.with_search(spatial_weight=0.5)
    spatial.cfg = cfg_sp
    for label, twin in (("rerank", idx), ("spatial", spatial)):
        core = ServeCore(twin)
        out["launches"] += serve_requests(card, 8, core, images, picks,
                                          {topk: 1})["topk_matmul"]
        ks, ki = twin.search(q, query_regional=qreg)
        tindex.topk_matmul = topk_ref
        try:
            ps, pi = twin.search(q, query_regional=qreg)
        finally:
            tindex.topk_matmul = topk
        err = check_fused_against_plain(ks, ki, ps, pi, SCORE_TOL)
        before = topk.launches
        _, oi = twin.with_search(use_pallas=False).search(
            q, query_regional=qreg)
        if topk.launches != before:
            fail("the oracle route launched the kernel")
        if not (np.array_equal(oi[:, 0], sel)
                and np.array_equal(ki[:, 0], sel)):
            fail(f"{label}: top-1 {ki[:, 0].tolist()} (oracle "
                 f"{oi[:, 0].tolist()}) for {sel.tolist()}")
        report(card, phase=8, workload=5, stage=label,
               plain_kernel_route_agrees=True, max_abs_err=err,
               oracle_top1_agrees=True, queries=int(ki.shape[0]),
               shards=twin.cfg.index.num_shards)
        out["sharded_launches"] += sharded_route(
            card, 8, twin, images, picks, q, (ks, ki), topk, 1,
            lambda *answers: check_fused_against_plain(*answers, SCORE_TOL),
            query_regional=qreg)

    out["k1_depth"] = depth_timings(
        card, "bf16", topk, topk_ref,
        lambda qq, s, i, rs, ri: check(idx.descriptors, qq, s, i, rs, ri,
                                       SCORE_TOL),
        idx.descriptors, None, q, idx.num_valid)
    # the re-rank stage alone on the card, on K1's candidates
    stage = {}
    for b in (1, 8, 128):
        rep = torch.from_numpy(np.resize(np.arange(len(sel)), b)).cuda()
        qq, qr = q[rep], qreg[rep]
        g, pos = topk(idx.descriptors, qq, k=RERANK_DEPTH,
                      num_valid=idx.num_valid)
        for label, kw in (("rerank", {}),
                          ("spatial", {"spatial_weight": 0.5,
                                       "vote_matrix": idx.vote_matrix})):
            stage[(label, b)] = cuda_median_ms(
                lambda: rerank_from_candidates(idx.regional, idx.ids, g, pos,
                                               qr, k=10, **kw))
        report(card, phase=8, workload=5, query_batch=b,
               rerank_stage_ms=stage[("rerank", b)],
               rerank_spatial_stage_ms=stage[("spatial", b)],
               topk_depth100_ms=cuda_median_ms(
                   lambda: topk(idx.descriptors, qq, k=RERANK_DEPTH,
                                num_valid=idx.num_valid)))
    rng = np.random.default_rng(9)
    out["latency"] = rerank_latency(
        card, idx, ex, images, rng,
        (("rerank", cfg.search),
         ("spatial", cfg.search.replace(spatial_weight=0.5)),
         ("global only", cfg.search.replace(rerank_enabled=False))))
    out.update(stage=stage, build_s=build_s, attach_s=attach_s)
    del idx
    torch.cuda.empty_cache()
    return out


def phase8c(card: str, int4_corpus, kernel, plain, check_exact) -> dict:
    """The exact-refine tier over phase 3's 1M-row int4 store: the preset
    configs/capacity_int4.json with refine_dtype="int8" (a [1M, 1, 512]
    int8 copy of the rows), refine_enabled and QE off, behind ServeCore,
    phase 3's requests. Every top-1 must be its source; K3 must launch once
    per bucket piece (the top-100); the composite over K3's plain version
    must give equal ids and scores (K3 is bit-exact), and K3 itself at depth
    100 on these queries bit for bit (``check_exact``)."""
    import numpy as np
    import torch
    import instsearch_torch.index as tindex
    from instsearch_torch.index import Index
    from instsearch_torch.serve import ServeCore

    cfg4, rows, names, ex, images, picks = int4_corpus
    changed = {"refine_dtype": "'' -> int8", "refine_enabled": "false -> "
               "true", "qe_enabled": "true -> false: one K3 scan of depth "
               "100, then the refine"}
    cfg = cfg4.replace(
        index=cfg4.index.replace(refine_dtype="int8"),
        search=cfg4.search.replace(refine_enabled=True, qe_enabled=False))
    idx = Index.from_descriptors(rows, names, cfg, extractor=ex)
    if (not idx.has_refine_store or idx.regional.dtype != torch.int8
            or tuple(idx.regional.shape) != (N_ROWS, 1, idx.dim)):
        fail(f"refine store {tuple(idx.regional.shape)}")
    report(card, phase=8, store="int4 + int8 refine", config=
           "configs/capacity_int4.json", changed=changed, rows=N_ROWS,
           refine_store=list(idx.regional.shape),
           rerank_depth=cfg.search.rerank_depth)
    core = ServeCore(idx)
    launches = serve_requests(card, 8, core, images, picks,
                              {kernel: 1})[kernel.__name__]
    q = ex(images[np.concatenate(picks)])
    ks, ki = idx.search(q)
    tindex.topk_matmul_int4 = plain
    try:
        ps, pi = idx.search(q)
    finally:
        tindex.topk_matmul_int4 = kernel
    if not (np.array_equal(ki, pi) and np.array_equal(ks, ps)):
        fail("refine: the composite through topk_matmul_int4 and through "
             "its plain version differ")
    report(card, phase=8, store="int4 + int8 refine",
           plain_kernel_route_equal=True, queries=int(ki.shape[0]),
           launches_in_main_path=launches)
    k3_depth = depth_timings(
        card, "int4", kernel, plain,
        lambda qq, s, i, rs, ri: check_exact(s, i, rs, ri),
        idx.descriptors, idx.scales, q, idx.num_valid)
    lat = query_latency(card, 8, idx, ex, images, np.random.default_rng(10),
                        store="int4 + int8 refine")
    del idx, core
    torch.cuda.empty_cache()
    return {"launches": launches, "latency": lat, "k3_depth": k3_depth}


def workload4_rows(card, gen, cfg):
    """Workload 4's rows: ResNet-50 at the preset's 512 px extracts
    OX_CORPUS seeded images, whitened at full width (fitted on them), among
    seeded unit distractor rows up to Oxford105k's OX_ROWS. Returns the
    rows, names, the extractor and the images."""
    import torch
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.ops.whitening import apply_whitening, fit_whitening
    ex = Extractor(cfg.extract.replace(whiten=False), seed=0)
    images = smooth_images(gen, OX_CORPUS, size=cfg.extract.image_size)
    raw, ips = extract_corpus(card, 9, ex, images, cfg.extract.batch_size)
    ex.whitening = fit_whitening(raw, dim=cfg.extract.whiten_dim or None)
    corpus = apply_whitening(raw, ex.whitening)
    if corpus.shape[1] != raw.shape[1] or not bool(
            torch.isfinite(corpus).all()):
        fail(f"workload 4: whitened descriptors {tuple(corpus.shape)} (the "
             f"preset keeps all {raw.shape[1]} directions)")
    distract = torch.randn(OX_ROWS - OX_CORPUS, corpus.shape[1],
                           generator=gen, device="cuda")
    rows = torch.cat([corpus, distract / distract.norm(dim=1, keepdim=True)])
    names = ([f"img{i:05d}" for i in range(OX_CORPUS)]
             + [f"distractor{i:06d}" for i in range(OX_ROWS - OX_CORPUS)])
    return rows, names, ex, images, ips


def sharded_latency(card, idx, sidx, ex, images, rng) -> dict:
    """query_images and search p50 at B = 1, 8 and 128, through the sharded
    index and on one device, host clock, synchronized by the results' host
    copy."""
    lat = {}
    for b in (1, 8, 128):
        batch = images[rng.choice(len(images), size=b, replace=False)]
        qd = ex(batch)
        for route, query, search in (
                ("sharded",
                 lambda: idx.query_images(batch, sharded_index=sidx),
                 lambda: idx.search_sharded(sidx, qd)),
                ("single device", lambda: idx.query_images(batch),
                 lambda: idx.search(qd))):
            query()                                  # warm this shape
            e2e, alone = [], []
            for _ in range(20):
                t0 = time.perf_counter()
                query()
                e2e.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                search()
                alone.append((time.perf_counter() - t0) * 1e3)
            lat[(route, b)] = {"query_images_p50_ms": statistics.median(e2e),
                               "search_p50_ms": statistics.median(alone)}
            report(card, phase=9, workload=4, route=route, query_batch=b,
                   rows=OX_ROWS, **lat[(route, b)])
    return lat


def phase9(card: str, gen, topk, topk_ref, check) -> dict:
    """Workload 4, configs/oxford105k_sharded8.json as loaded: ResNet-50 at
    512 px (bf16, GeM p=3), PCA-whitening at full width (D = 2048) fitted on
    OX_CORPUS seeded images, stored among seeded unit rows up to OX_ROWS
    (Oxford105k's 105,133) in a bf16 store of the preset's 8 shards of
    row_tile-multiples, all on cuda:0, behind ServeCore(sharded=True). Every
    top-1 must be its source; K1 must launch 8 times per bucket piece and no
    other kernel; the sharded search must agree with the single-device one
    by K1's rule (``check``), both must agree with K1's plain version
    (``topk_ref``) over the whole store, each shard's own K1 call at every
    bucket batch with the plain version on its slice, and ``full_ranking``
    through ``all_scores`` must equal the single-device ranking. Returns
    the results and, for 9c, the index, the queries and the sharded
    answer."""
    import numpy as np
    import torch
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import make_mesh
    from instsearch_torch.serve import ServeCore

    path = "configs/oxford105k_sharded8.json"
    cfg = PipelineConfig.load(os.path.join(HERE, path))
    e, ic, sc = cfg.extract, cfg.index, cfg.search
    if ((e.backbone, e.image_size, e.pooling, e.gem_p, e.whiten_dim, e.dtype)
            != ("resnet50", 512, "gem", 3.0, 0, "bfloat16")
            or (ic.dtype, ic.num_shards, ic.row_tile) != ("bfloat16", 8, 1024)
            or sc.k != 10 or sc.qe_enabled or sc.rerank_enabled):
        fail(f"{path} is no longer workload 4's configuration")
    shards = ic.num_shards
    torch.cuda.reset_peak_memory_stats()
    rows, names, ex, images, ips = workload4_rows(card, gen, cfg)
    idx = Index.from_descriptors(rows, names, cfg, extractor=ex)
    del rows
    torch.cuda.empty_cache()
    n_pad = -(-OX_ROWS // (ic.row_tile * shards)) * ic.row_tile * shards
    if (tuple(idx.descriptors.shape) != (n_pad, 2048)
            or idx.descriptors.dtype != torch.bfloat16):
        fail(f"workload 4 store {tuple(idx.descriptors.shape)} "
             f"{idx.descriptors.dtype}")
    mesh = make_mesh(shards, devices=["cuda"] * shards)
    core = ServeCore(idx, sharded=True, mesh=mesh)
    sidx = core.sidx
    per = sidx.rows_per_shard
    views = all(sh.x.data_ptr() == idx.descriptors.data_ptr()
                + j * per * idx.descriptors.stride(0) * 2
                for j, sh in enumerate(sidx.shards))
    if not views or [sh.num_valid for sh in sidx.shards] != [
            max(0, min(OX_ROWS - j * per, per)) for j in range(shards)]:
        fail("workload 4: the shards are not views of the store's row "
             "slices with their valid rows")
    report(card, phase=9, workload=4, config=path, backbone="resnet50",
           image=e.image_size, dim=idx.dim, corpus=OX_CORPUS, rows=OX_ROWS,
           padded_rows=n_pad, shards=shards, rows_per_shard=per,
           mesh=f"cuda:0 x {shards}", store_gb=idx.descriptors.numel() * 2
           / 1e9, ready=core.ready_info(),
           reduced={"corpus": f"{OX_CORPUS} extracted images among "
                    f"{OX_ROWS - OX_CORPUS} seeded unit rows (Oxford105k: "
                    f"5,063 images and 100k Flickr distractors; seeded "
                    f"random weights)"})
    rng = np.random.default_rng(4)
    picks = [rng.choice(OX_CORPUS, size=n, replace=False) for n in SIZES]
    launches = serve_requests(card, 9, core, images, picks,
                              {topk: shards})["topk_matmul"]

    q = ex(images[np.concatenate(picks)])
    ks, ki = idx.search(q)
    ss, si = sidx.search(q)
    if not torch.equal(idx.ids.cpu(), torch.arange(n_pad, dtype=idx.ids.dtype)
                       .masked_fill(torch.arange(n_pad) >= OX_ROWS, -1)):
        fail("workload 4: store ids are not its row positions")
    on_card = [torch.from_numpy(a).cuda() for a in (ks, ki)]
    try:
        err = check(idx.descriptors, q, ss, si, *on_card, SCORE_TOL)
    except AssertionError as why:
        fail(f"workload 4: sharded and single-device search: {why}")
    # K1 against its plain version at this path's shapes: both routes'
    # answers against the plain top-k over the whole store, and each
    # shard's K1 call (its view of the store, its valid rows; the last
    # shard ends in padding) at every bucket batch against the plain
    # version on the same slice
    qm = sidx._match_query_dim(q)
    plain = topk_ref(idx.descriptors, qm, k=sc.k, num_valid=OX_ROWS)
    errs = [err]
    for label, (s, i) in (("sharded", (ss, si)), ("single-device", on_card)):
        try:
            errs.append(check(idx.descriptors, qm, s, i, *plain, SCORE_TOL))
        except AssertionError as why:
            fail(f"workload 4: the {label} search against K1's plain "
                 f"version: {why}")
    shard_calls = 0
    for b in core.buckets:
        for j, sh in enumerate(sidx.shards):
            got = topk(sh.x, qm[:b], k=sc.k, num_valid=sh.num_valid)
            want = topk_ref(sh.x, qm[:b], k=sc.k, num_valid=sh.num_valid)
            try:
                errs.append(check(sh.x, qm[:b], *got, *want, SCORE_TOL))
            except AssertionError as why:
                fail(f"workload 4: shard {j}'s K1 call at B={b} "
                     f"(num_valid {sh.num_valid}) against its plain "
                     f"version: {why}")
            shard_calls += 1
    err = max(errs)
    want = idx.full_ranking(q[:4])
    got = sidx.full_ranking(q[:4])
    if not np.array_equal(got, want):
        fail(f"workload 4: full_ranking through all_scores differs from the "
             f"single-device ranking at {int((got != want).sum())} places")
    report(card, phase=9, workload=4, sharded_agrees_with_single_device=True,
           both_agree_with_plain=True, shard_calls_held_to_plain=shard_calls,
           shard_num_valid=[sh.num_valid for sh in sidx.shards],
           buckets=core.buckets, max_abs_err=err, queries=int(ki.shape[0]),
           full_ranking_equal=True, ranked=list(got.shape),
           topk_launches_in_main_path=launches)
    lat = sharded_latency(card, idx, sidx, ex, images, rng)
    mem = {"peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "device_gb_now": torch.cuda.memory_allocated() / 1e9}
    report(card, phase=9, workload=4, **mem)
    return ({"launches": launches, "latency": lat, "extract_ips": ips, **mem},
            (idx, sidx, q, ss, si, images))


def phase9c(card: str, topk, topk_ref, check, ox) -> dict:
    """The multi-process form at world size 1 on NCCL: ``initialize()`` from
    a loopback MASTER_ADDR and a free port, ``build_multihost_index`` over
    phase 9's rows as 8 local shards on cuda:0 (the process's rows are all
    of them), and the same search, which must give phase 9's answer; the
    group's default backend also gathers CPU shards (gloo), held to K1's
    plain version. It shows the NCCL gather is wired; one card cannot
    measure a collective across cards."""
    import numpy as np
    import torch
    from instsearch_torch.parallel import (build_multihost_index,
                                           global_shard_mesh,
                                           local_row_range)
    idx, sidx, q, ss, si, _ = ox
    shards = idx.cfg.index.num_shards
    with world_of_one() as dist:
        mesh = global_shard_mesh(["cuda"] * shards)
        lo, hi = local_row_range(idx.descriptors.shape[0])
        mh = build_multihost_index(idx.descriptors[lo:hi],
                                   idx.ids.cpu().numpy(), mesh=mesh,
                                   k=idx.cfg.search.k, dim=idx.dim)
        if mh.mesh.group is None or mh.mesh.num_shards != shards:
            fail("the multi-process mesh holds no group")
        topk.launches = 0
        ms, mi = mh.search(q)
        launches = topk.launches
        if launches != shards:
            fail(f"the multi-process search launched K1 {launches} times, "
                 f"not {shards}")
        if not (torch.equal(mi, si) and torch.equal(ms, ss)):
            fail("the multi-process search differs from phase 9's")
        # the same group gathers CPU shards through its gloo half: two CPU
        # shards of the store's first rows against the plain top-k there
        n = 2 * idx.cfg.index.row_tile * shards
        rows, qc = idx.descriptors[:n].cpu(), q.float().cpu()
        cpu_mh = build_multihost_index(rows, np.arange(n),
                                       mesh=global_shard_mesh(["cpu"] * 2),
                                       k=idx.cfg.search.k, dim=idx.dim)
        try:
            check(rows, qc, *cpu_mh.search(qc),
                  *topk_ref(rows, qc, k=idx.cfg.search.k), SCORE_TOL)
        except AssertionError as why:
            fail(f"the multi-process search over CPU shards: {why}")
        # the search at B = 1 with and without the group's all_gather, in
        # turns (host clock, synchronized by the ids' host copy)
        qb = q[:1]
        times = {"nccl group": [], "one process": []}
        for _ in range(21):
            for label, fn in (("nccl group", mh.search),
                              ("one process", sidx.search)):
                t0 = time.perf_counter()
                fn(qb)[1].cpu()
                times[label].append((time.perf_counter() - t0) * 1e3)
        p50 = {label: statistics.median(t[1:]) for label, t in times.items()}
        report(card, phase=9, workload=4, multi_process=True,
               backend=dist.get_backend(), world=dist.get_world_size(),
               shards=mh.mesh.num_shards, equals_phase9=True,
               cpu_shards_agree_with_plain=True, topk_launches=launches,
               search_b1_p50_ms=p50)
    return {"launches": launches, "search_b1_p50_ms": p50}


def subset_requests(card, tag, core, images, picks, subset: str, kernel,
                    per_piece: int) -> list:
    """Set every kernel's count to 0, serve one request per pick under the
    registered ``subset`` and read the counts: ``kernel`` must have launched
    ``per_piece`` times for each bucket piece, each launch with the mask
    (``launches_subset``), and no other kernel at all. Every returned name
    must be a member. Returns the answers."""
    everyone = _everyone()
    zero_counts(everyone)
    for fn in everyone:
        if hasattr(fn, "launches_subset"):
            fn.launches_subset = 0
    answers = [core.run_queries([(images[p], 10)], subset=subset)[0]
               for p in picks]
    check_pass1(f"{tag}: subset {subset!r} requests")
    pieces = sum(-(-len(p) // core.buckets[-1]) for p in picks)
    want = {fn.__name__: (per_piece * pieces if fn is kernel else 0)
            for fn in everyone}
    counts = {fn.__name__: fn.launches for fn in everyone}
    if counts != want or kernel.launches_subset != per_piece * pieces:
        fail(f"{tag}: subset {subset!r} requests ({pieces} bucket pieces) "
             f"launched {counts} ({kernel.launches_subset} with the mask), "
             f"not {want}")
    members = set(core.subsets[subset].names)
    for ans in answers:
        got = {r["name"] for row in ans["results"] for r in row}
        if not got <= members:
            fail(f"{tag}: subset {subset!r} returned non-members "
                 f"{sorted(got - members)[:3]}")
    return answers


def write_png(images, folder: str, prefix: str) -> list:
    import cv2
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, im in enumerate(images):
        p = os.path.join(folder, f"{prefix}{i:04d}.png")
        if not cv2.imwrite(p, im[:, :, ::-1]):
            fail(f"cannot write {p}")
        paths.append(p)
    return paths


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def masked_timings(card, tag, kernel, args, n: int, masks, qs, library=None,
                   name: "str | None" = None):
    """``kernel(*args, q, k=10, num_valid=n, mask=m)`` over the first ``n``
    rows at each query batch of ``qs``, unmasked and under each mask (CUDA
    events); ``library(q, m)``, when given, is a PyTorch yardstick for the
    same function."""
    out = {}
    for b, q in qs.items():
        row = {}
        for label, m in (("none", None), *masks.items()):
            row[f"{label}_ms"] = cuda_median_ms(
                lambda: kernel(*args, q, k=10, num_valid=n, mask=m))
            if library is not None:
                row[f"{label}_library_ms"] = cuda_median_ms(
                    lambda: library(q, m))
        out[b] = row
        report(card, phase=10, case=tag, kernel=name or kernel.__name__,
               rows=n,
               query_batch=b, k=10, **row)
    return out


def search_p50(card, tag, idx, q_by_b, subsets) -> dict:
    """``Index.search`` p50 (host clock, synchronized by the results' host
    copy) without a subset and under each, at each query batch."""
    out = {}
    for b, q in q_by_b.items():
        row = {}
        for label, sub in (("none", None), *subsets.items()):
            idx.search(q, subset=sub)
            t = []
            for _ in range(15):
                t0 = time.perf_counter()
                idx.search(q, subset=sub)
                t.append((time.perf_counter() - t0) * 1e3)
            row[f"{label}_p50_ms"] = statistics.median(t)
        out[b] = row
        report(card, phase=10, case=tag, query_batch=b, rows=N_ROWS, **row)
    return out


def phase10(card: str, gen, w1, pq_idx, corpus, check, check_exact) -> dict:
    """The live, persistent index through its entry points: (a) workload
    1 (phase 2's index), (b) the capacity tier (phase 4's int4 store and PQ
    view), (c) the million-scale int8 preset as 8 shards on cuda:0; all
    temporary files in one folder, removed at the end."""
    import shutil
    import tempfile
    import torch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase10_")
    out, peak = {}, {}
    try:
        for part, run in (
                ("a", lambda: phase10a(card, gen, w1, check, tmp)),
                ("b", lambda: phase10b(card, gen, pq_idx, corpus,
                                       check_exact, tmp)),
                ("c", lambda: phase10c(card, gen, corpus, tmp))):
            torch.cuda.reset_peak_memory_stats()
            out[part] = run()
            peak[part] = torch.cuda.max_memory_allocated() / 2 ** 30
            if part == "a":
                w1 = None           # phase 2's index is no longer needed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report(card, phase=10, peak_device_memory_gib=peak)
    return out


def phase10a(card, gen, w1, check, tmp) -> dict:
    import numpy as np
    import torch
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import topk_matmul, topk_matmul_reference
    from instsearch_torch.serve import ServeCore

    idx, images, picks = w1
    want = [ServeCore(idx).run_queries([(images[p], 10)])[0] for p in picks]
    folder = os.path.join(tmp, "workload1")
    _, save_s = timed(lambda: idx.save(folder, streaming=False))
    npz = os.path.getsize(os.path.join(folder, "index.npz"))
    live, load_s = timed(lambda: Index.load(folder))
    if not (torch.equal(live.descriptors, idx.descriptors)
            and torch.equal(live.ids, idx.ids) and live.names == idx.names
            and live.device == idx.device):
        fail("workload 1: the loaded store, ids or names differ")
    err = (live.extractor(images[:64]) - idx.extractor(images[:64])
           ).abs().max().item()
    if err > 1e-5:
        fail(f"workload 1: the rebuilt extractor is {err} off")
    core = ServeCore(live)
    got = [core.run_queries([(images[p], 10)])[0] for p in picks]
    if [g["results"] for g in got] != [w["results"] for w in want]:
        fail("workload 1: the loaded index answers otherwise")
    del idx, w1, want
    report(card, phase=10, workload=1, save_s=save_s, load_s=load_s,
           npz_bytes=npz, save_gb_per_s=npz / save_s / 1e9,
           load_gb_per_s=npz / load_s / 1e9, store_equal=True,
           extractor_max_abs_err=err, answers_equal=True)

    # subsets: defined by request, K1 once a piece with the mask, held to
    # its plain version with the same mask
    rng = np.random.default_rng(10)
    names = live.names
    corpus = names[:CORPUS]
    specs = {"half": corpus[::2] + names[CORPUS::2],
             "collection": [corpus[i] for i in sorted(
                 rng.choice(CORPUS, LIVE_COLLECTION, replace=False))],
             "tiny": [corpus[i] for i in rng.choice(CORPUS, 5,
                                                    replace=False)]}
    for nm, members in specs.items():
        r = core.handle_line(json.dumps({"define_subset": {
            "name": nm, "members": members}}))
        if r.get("count") != len(members):
            fail(f"workload 1: define_subset {nm}: {r}")
    launches = {}
    q = live.extractor(images[np.concatenate(picks)])
    for nm in specs:
        answers = subset_requests(card, "workload 1", core, images, picks,
                                  nm, topk_matmul, 1)
        launches[nm] = topk_matmul.launches_subset
        if nm == "tiny" and any(len(row) != 5 for a in answers
                                for row in a["results"]):
            fail("workload 1: the 5-member subset did not answer 5 results")
        sub = core.subsets[nm]
        ks, ki = live.search(q, subset=sub)
        rs, ri = topk_matmul_reference(live.descriptors, q, k=10,
                                       num_valid=live.num_valid,
                                       mask=sub.mask)
        try:
            check(live.descriptors, q, torch.from_numpy(ks).to(live.device),
                  torch.from_numpy(ki).to(live.device), rs, ri, SCORE_TOL)
        except AssertionError as why:
            fail(f"workload 1, subset {nm}: {why}")
        report(card, phase=10, workload=1, subset=nm, count=sub.count,
               topk_launches_with_mask=launches[nm],
               members_only=True, held_to_plain=True)

    timings = {"masked_k1": masked_timings(
        card, "K1 bf16 masked vs unmasked", topk_matmul,
        (live.descriptors,), live.num_valid,
        {"half": core.subsets["half"].mask,
         "tiny": core.subsets["tiny"].mask},
        {1: q[:1].contiguous(), 128: live.extractor(images[:128])},
        library=lambda qq, m: torch.topk(
            (qq.to(torch.bfloat16) @ live.descriptors.T).float()
            if m is None else (qq.to(torch.bfloat16) @ live.descriptors.T
                               ).float().masked_fill(m == 0, float("-inf")),
            10))}
    timings["search_p50"] = search_p50(
        card, "workload 1 search", live,
        {b: live.extractor(images[rng.choice(CORPUS, b)])
         for b in (1, 8, 128)},
        {nm: core.subsets[nm] for nm in ("half", "tiny")})

    # add new images from PNG files: each one's top-1 is itself
    new = smooth_images(gen, LIVE_ADD)
    paths = write_png(new, os.path.join(tmp, "add"), "add")
    nv0 = live.num_valid
    # the parts of the add and remove below, timed alone: decoding and
    # extracting the files, and rebuilding one subset from its names (a
    # re-padding add and a remove rebuild all three)
    _, extract_s = timed(lambda: live.extractor.extract_paths(paths))
    _, subset_s = timed(lambda: live.make_subset(names=specs["half"]))
    r, add_s = timed(lambda: core.handle_line(json.dumps({"add": paths})))
    if r.get("added") != LIVE_ADD or r.get("rows") != nv0 + LIVE_ADD:
        fail(f"workload 1: add answered {r}")
    _, i = live.query_images(new)
    if not np.array_equal(i[:, 0],
                          live.ids[nv0:nv0 + LIVE_ADD].cpu().numpy()):
        fail("workload 1: an added image is not its own top-1")

    # remove corpus images and as many of the added ones
    removed = ([corpus[i] for i in rng.choice(CORPUS, LIVE_REMOVE,
                                              replace=False)]
               + [f"add{i:04d}" for i in range(0, 2 * LIVE_REMOVE, 2)])
    before = live.descriptors[:live.num_valid].clone()
    pos = {nm: p for p, nm in enumerate(live.names)}
    gone = {int(live.ids[pos[nm]]) for nm in removed}
    r, remove_s = timed(lambda: core.handle_line(json.dumps(
        {"remove": removed})))
    if r.get("removed") != 2 * LIVE_REMOVE:
        fail(f"workload 1: remove answered {r}")
    perm = torch.tensor([pos[nm] for nm in live.names], device=live.device)
    if not torch.equal(live.descriptors[:live.num_valid], before[perm]):
        fail("workload 1: a surviving row changed in the remove")
    del before
    counts = {}
    for nm, members in specs.items():
        sub = core.subsets[nm]
        counts[nm] = sub.count
        if (sub.count != len(set(members) - set(removed))
                or sub.layout_gen != live._layout_gen):
            fail(f"workload 1: subset {nm} not refreshed ({sub})")
    gone_rows = [int(p) for p in rng.choice(CORPUS, 64)]
    _, i = live.query_images(images[gone_rows])
    if set(i.reshape(-1).tolist()) & gone:
        fail("workload 1: a removed image came back")
    report(card, phase=10, workload=1, added=LIVE_ADD, add_s=add_s,
           extract_paths_s=extract_s, make_subset_half_s=subset_s,
           removed=2 * LIVE_REMOVE, remove_s=remove_s, rows=live.num_valid,
           padded_rows=live.descriptors.shape[0],
           subsets_after_remove=counts, added_top1_itself=True,
           survivors_bit_equal=True, removed_never_returned=True)

    # range: the count equals the plain count over the dequantized store;
    # every member's plain score clears tau
    survivor = next(p for p in range(CORPUS) if corpus[p] not in removed)
    path = write_png(images[survivor:survivor + 1], os.path.join(tmp, "rng"),
                     "range")[0]
    qr = live.extractor(images[survivor:survivor + 1])
    for sub_name in (None, "half"):
        spec = {"image": path, "tau": 0.9}
        if sub_name:
            spec["subset"] = sub_name
        r = core.handle_line(json.dumps({"range": spec}))
        if "error" in r:
            fail(f"workload 1: range answered {r}")
        ok = live.ids >= 0
        if sub_name:
            ok = ok & (core.subsets[sub_name].mask[0] > 0)
        plain = (qr @ live.descriptors.float().T)[0]
        count = int(((plain >= 0.9) & ok).sum())
        ids_pos = {int(v): p for p, v in enumerate(live.ids.tolist())}
        low = min((plain[ids_pos[x["id"]]].item() for x in r["results"]),
                  default=1.0)
        if r["count"] != count or low < 0.9 - SCORE_TOL:
            fail(f"workload 1: range count {r['count']} (plain {count}), "
                 f"lowest member's plain score {low}")
        report(card, phase=10, workload=1, range_tau=0.9, subset=sub_name,
               count=count, members=len(r["results"]),
               truncated=r["truncated"], equals_plain_count=True)
    nm16 = live.names[100:116]
    r = core.handle_line(json.dumps({"reconstruct": {"names": nm16}}))
    want16 = live.descriptors[100:116, :live.dim].float().cpu().numpy()
    if not np.array_equal(np.asarray(r["vectors"], np.float32), want16):
        fail("workload 1: reconstruct differs from the stored rows")
    report(card, phase=10, workload=1, reconstruct_equal=True, rows=16)
    return {"launches": sum(launches.values()),
            "launches_subset": sum(launches.values()), "timings": timings,
            "add_s": add_s, "remove_s": remove_s, "save_s": save_s,
            "load_s": load_s, "npz_bytes": npz}


def _int4_routes(card, tag, live, images, picks, members):
    """The capacity tier under a subset, exact route (K3 twice a piece with
    QE) and cascade (K4 twice a piece, K1-K3 never), each equal bit for bit
    to the same composite over the kernel's plain version with the mask.
    Returns the subset launches of each."""
    import numpy as np
    import instsearch_torch.index as tindex
    import instsearch_torch.search.pq_view as pq_view
    from instsearch_torch.kernels import (pq_topk, pq_topk_reference,
                                          topk_matmul_int4,
                                          topk_matmul_int4_reference)
    from instsearch_torch.serve import ServeCore
    q = live.extractor(images[np.concatenate(picks)])
    out = {}
    for route, idx, kernel, module, plain in (
            ("exact", live.with_search(pq_depth=0), topk_matmul_int4,
             tindex, topk_matmul_int4_reference),
            ("cascade", live, pq_topk, pq_view, pq_topk_reference)):
        core = ServeCore(idx)
        core.define_subset("half", members)
        subset_requests(card, f"{tag} {route}", core, images, picks, "half",
                        kernel, 2)
        out[route] = kernel.launches_subset
        sub = core.subsets["half"]
        ks, ki = idx.search(q, subset=sub)
        setattr(module, kernel.__name__, plain)
        try:
            ps, pi = idx.search(q, subset=sub)
        finally:
            setattr(module, kernel.__name__, kernel)
        if not (np.array_equal(ks, ps) and np.array_equal(ki, pi)):
            fail(f"{tag} {route}: the subset composite through "
                 f"{kernel.__name__} and its plain version differ")
        report(card, phase=10, case=tag, route=route, subset_count=sub.count,
               launches_with_mask=out[route], plain_equal=True)
    return out


def phase10b(card, gen, pq_idx, corpus, check_exact, tmp) -> dict:
    import numpy as np
    import torch
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import pq_topk, topk_matmul_int4

    _, _, names, _, images, picks = corpus
    folder = os.path.join(tmp, "capacity")
    _, save_s = timed(lambda: pq_idx.save(folder, streaming=False))
    npz = os.path.getsize(os.path.join(folder, "index.npz"))
    live, load_s = timed(lambda: Index.load(folder))
    if not (torch.equal(live.pq.packed, pq_idx.pq.packed)
            and torch.equal(live.descriptors, pq_idx.descriptors)
            and torch.equal(live.scales, pq_idx.scales)):
        fail("capacity tier: the loaded store or PQ codes differ")
    report(card, phase=10, case="capacity_int4 + PQ", save_s=save_s,
           load_s=load_s, npz_bytes=npz, packed_equal=True)
    del pq_idx
    members = names[:CORPUS_Q:2] + names[CORPUS_Q::2]
    before = _int4_routes(card, "capacity tier", live, images, picks,
                          members)
    half = live.make_subset(names=members)
    qs = {1: live.extractor(images[:1]), 128: live.extractor(images[:128])}
    timings = {
        "masked_k3": masked_timings(
            card, "K3 int4 masked vs unmasked", topk_matmul_int4,
            (live.descriptors, live.scales), live.num_valid,
            {"half": half.mask},
            {b: live._match_query_dim(q) for b, q in qs.items()}),
        "masked_k4": masked_timings(
            card, "K4 pq masked vs unmasked",
            lambda packed, q, **kw: pq_topk(packed, q, live.pq.codebook,
                                            **kw),
            (live.pq.packed,), live.num_valid, {"half": half.mask}, qs,
            name="pq_topk")}

    # an add past capacity (the view grows and absorbs) and a remove
    new = smooth_images(gen, 64, size=live.cfg.extract.image_size)
    paths = write_png(new, os.path.join(tmp, "add_int4"), "cap")
    nv0 = live.num_valid
    live.add(paths=paths)
    removed = names[1:CORPUS_Q:4] + ["cap0001", "cap0005"]
    live.remove(removed)
    _, i = live.query_images(new[8:16])
    want = [live.ids[live.names.index(f"cap{j:04d}")].item()
            for j in range(8, 16)]
    if (i[:, 0].tolist() != want
            or live.num_valid != nv0 + len(new) - len(removed)):
        fail(f"capacity tier: the cascade did not find the added images "
             f"({i[:, 0].tolist()} for {want})")
    alive = set(live.names)
    after = _int4_routes(card, "capacity tier after add/remove", live,
                         images, picks, [m for m in members if m in alive])
    report(card, phase=10, case="capacity tier after add/remove",
           rows=live.num_valid, padded_rows=live.descriptors.shape[0],
           pq_rows=live.pq.packed.shape[0], added_found_by_cascade=True)
    return {"launches_k3": before["exact"] + after["exact"],
            "launches_k4": before["cascade"] + after["cascade"],
            "timings": timings, "save_s": save_s, "load_s": load_s}


def phase10c(card, gen, corpus, tmp) -> dict:
    """configs/million_scale_int8.json as its 8 shards on cuda:0 behind
    ServeCore(sharded=True): a subset request runs K2 twice a piece on each
    shard with valid rows, each with its slice of the mask, equal bit for
    bit to the single-device subset answer; again after an add and a
    remove, which cut the shards again."""
    import numpy as np
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import topk_matmul_int8
    from instsearch_torch.parallel import make_mesh
    from instsearch_torch.serve import ServeCore

    _, rows, names, ex, images, picks = corpus
    cfg = PipelineConfig.load(os.path.join(HERE, "configs",
                                           "million_scale_int8.json"))
    idx = Index.from_descriptors(rows, names, cfg, extractor=ex)
    shards = cfg.index.num_shards
    core = ServeCore(idx, sharded=True,
                     mesh=make_mesh(shards, devices=[idx.device] * shards))
    members = names[:CORPUS_Q:2] + names[CORPUS_Q::2]
    q = ex(images[np.concatenate(picks)])
    total = 0

    def check(tag):
        alive = set(idx.names)
        core.define_subset("half", [m for m in members if m in alive])
        busy = sum(sh.num_valid > 0 for sh in core.sidx.shards)
        subset_requests(card, tag, core, images, picks, "half",
                        topk_matmul_int8, 2 * busy)
        n = topk_matmul_int8.launches_subset
        sub = core.subsets["half"]
        ss, si = idx.search_sharded(core.sidx, q, subset=sub)
        ks, ki = idx.search(q, subset=sub)
        equal_answers(ss, si, ks, ki)
        report(card, phase=10, case=tag, shards=shards, busy_shards=busy,
               launches_with_mask=n, sharded_equals_single_device=True)
        return n

    total += check("million_scale_int8 sharded")
    new = smooth_images(gen, 32, size=cfg.extract.image_size)
    paths = write_png(new, os.path.join(tmp, "add_int8"), "sh")
    for req in ({"add": paths}, {"remove": names[1:CORPUS_Q:8]}):
        before = core.sidx
        r = core.handle_line(json.dumps(req))
        if "error" in r or core.sidx is before:
            fail(f"sharded: {req.keys()} answered {r} without re-sharding")
    total += check("million_scale_int8 sharded after add/remove")
    return {"launches": total}


def near_tie_rows(a, b, tie_rows) -> int:
    """Hold two augmented stores (f32 rows ``a``, ``b`` [n, D] on the
    card) to each other: each element within one bf16 step (at most 2^-7
    of its magnitude: the two f32 buffers may round to bf16 on either side
    of a midpoint), except on rows where ``tie_rows`` (a bool [n]) marks a
    near-tie at the k-th neighbour, which the two top-k routes may break
    either way. Returns the count of rows that differ beyond a step (all
    of them near-ties)."""
    import torch
    bar = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7 + 1e-7
    beyond = ((a - b).abs() > bar).any(dim=1)
    if bool((beyond & ~tie_rows).any()):
        rows = torch.nonzero(beyond & ~tie_rows)[:3, 0].tolist()
        fail(f"αDBA: rows {rows} differ beyond one bf16 step without a "
             f"near-tie at the k-th neighbour")
    return int(beyond.sum())


def dba_against_plain(card, tag, cfg, rows, kernel, plain, exact: bool):
    """αDBA over the first DBA_SLICE ``rows`` through ``kernel`` and through
    its plain version (``instsearch_torch.index``'s entry replaced): K2/K3
    (``exact``) must give stores equal bit for bit, K1 stores within one
    bf16 step but on rows whose k-th and (k+1)-th neighbours (the plain
    version's scores) are within SCORE_TOL. Returns the seconds of the
    kernel pass."""
    import torch
    import instsearch_torch.index as tindex
    names = [f"r{i}" for i in range(DBA_SLICE)]
    got = tindex.Index.from_descriptors(rows[:DBA_SLICE], names, cfg)
    want = tindex.Index.from_descriptors(rows[:DBA_SLICE], names, cfg)
    _, t = timed(got.augment_database)
    entry = kernel.__name__
    setattr(tindex, entry, plain)
    try:
        want.augment_database()
    finally:
        setattr(tindex, entry, kernel)
    if exact:
        if not (torch.equal(got.descriptors, want.descriptors)
                and torch.equal(got.scales, want.scales)):
            fail(f"{tag}: αDBA through {entry} and through its plain "
                 f"version differ")
        differ = 0
    else:
        n = cfg.index.dba_n
        a = got._rows_f32_chunk(0, DBA_SLICE)
        b = want._rows_f32_chunk(0, DBA_SLICE)
        # the plain version's k-th and (k+1)-th scores of each original row
        orig = tindex.Index.from_descriptors(rows[:DBA_SLICE], names, cfg)
        ties = torch.zeros(DBA_SLICE, dtype=torch.bool, device=a.device)
        for s in range(0, DBA_SLICE, 1024):
            q = orig._query_rows(s, 1024)
            sc, _ = plain(orig.descriptors, q, k=n + 1)
            ties[s:s + 1024] = (sc[:, n - 1] - sc[:, n]) < SCORE_TOL
        differ = near_tie_rows(a, b, ties)
    report(card, phase=11, case=tag, dba_slice_rows=DBA_SLICE,
           dba_n=cfg.index.dba_n, kernel=entry, held_to_plain=True,
           bit_for_bit=exact, rows_beyond_one_bf16_step_at_near_ties=differ,
           dba_slice_s=t)
    return t


def p50_ms(fn, reps: int = 10) -> float:
    fn()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(t)


def against_plain_candidates(tag, idx, q, kernel, plain, rel_tol: float):
    """``idx.search(q)`` (a re-scoring composite) through ``kernel`` and
    through its plain version: the same slots filled, scores within
    ``rel_tol`` of the largest plain score, ids equal but at near-ties
    (``check_fused_against_plain``). Returns the largest difference."""
    import numpy as np
    import instsearch_torch.index as tindex
    ks, ki = idx.search(q)
    entry = kernel.__name__
    setattr(tindex, entry, plain)
    try:
        ps, pi = idx.search(q)
    finally:
        setattr(tindex, entry, kernel)
    scale = float(np.abs(ps[np.isfinite(ps)]).max())
    try:
        return check_fused_against_plain(ks, ki, ps, pi,
                                         rel_tol * max(1.0, scale))
    except SystemExit:
        print(f"chip_smoke: {tag}: the composite through {entry} and "
              f"through its plain version", file=sys.stderr)
        raise


def count_launches(fn):
    """``fn()`` with every kernel's count set to 0 before and read after ->
    (result, counts by kernel name)."""
    everyone = _everyone()
    zero_counts(everyone)
    out = fn()
    check_pass1(getattr(fn, "__name__", "a counted run"))
    return out, {k.__name__: k.launches for k in everyone}


def phase11(card: str, gen, topk, topk_ref, check, int8_store, ox) -> dict:
    """The quality tiers: (a) configs/quality_ladder.json, (b)
    configs/local_whiten_rerank.json, (c) their sharded forms and the
    expert-parallel whitening, (d) near-duplicates and the int8 store."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the graph, the bank and the moments need f32")
    torch.cuda.reset_peak_memory_stats()
    out = {"a": phase11a(card, gen, topk, topk_ref, check)}
    out["b"], lw_idx = phase11b(card, gen, topk, topk_ref, ox)
    out["c"] = phase11c(card, topk_ref, lw_idx, ox)
    out["d"] = phase11d(card, gen, lw_idx, ox, int8_store)
    out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    report(card, phase=11, peak_device_memory_gib=out["peak_device_gib"])
    return out


def phase11a(card, gen, topk, topk_ref, check) -> dict:
    """configs/quality_ladder.json as loaded: ResNet-50 at 512 px over the
    preset's three scales (bf16, GeM p=3), whitening at full width fitted
    on QL_CORPUS seeded images, stored among seeded unit rows up to 1M in
    bf16; αDBA over the whole store (timed; its slice held to the pass
    through K1's plain version), then ServeCore requests with αQE and
    diffusion at depth 200."""
    import numpy as np
    import torch
    from instsearch_torch import PipelineConfig
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.index import Index
    from instsearch_torch.ops.whitening import apply_whitening, fit_whitening
    from instsearch_torch.serve import ServeCore

    path = "configs/quality_ladder.json"
    cfg = PipelineConfig.load(os.path.join(HERE, path))
    e, ic, sc = cfg.extract, cfg.index, cfg.search
    if ((e.backbone, e.image_size, tuple(e.scales), e.pooling, e.whiten_dim,
         e.dtype) != ("resnet50", 512, (1.0, 0.7071, 0.5), "gem", 0,
                      "bfloat16")
            or (ic.dtype, ic.dba_n, ic.dba_alpha) != ("bfloat16", 10, 3.0)
            or not (sc.qe_enabled and sc.diffusion_enabled)
            or (sc.diffusion_depth, sc.k) != (200, 10)):
        fail(f"{path} is no longer the quality ladder's configuration")
    ex = Extractor(e.replace(whiten=False), seed=0)
    images = smooth_images(gen, QL_CORPUS, size=e.image_size)
    raw, ips = extract_corpus(card, 11, ex, images, e.batch_size)
    ex.whitening = fit_whitening(raw, dim=None)
    corpus = apply_whitening(raw, ex.whitening)
    if corpus.shape[1] != 2048 or not bool(torch.isfinite(corpus).all()):
        fail(f"quality ladder: whitened descriptors {tuple(corpus.shape)}")
    distract = torch.randn(N_ROWS - QL_CORPUS, 2048, generator=gen,
                           device="cuda")
    rows = torch.cat([corpus, distract / distract.norm(dim=1, keepdim=True)])
    del raw, distract
    names = ([f"img{i:05d}" for i in range(QL_CORPUS)]
             + [f"distractor{i:07d}" for i in range(N_ROWS - QL_CORPUS)])
    slice_s = dba_against_plain(card, "quality ladder, bf16", cfg, rows,
                                topk, topk_ref, exact=False)
    idx = Index.from_descriptors(rows, names, cfg, extractor=ex)
    del rows
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (_, dba_s), counts = count_launches(lambda: timed(idx.augment_database))
    dba_launches = counts["topk_matmul"]
    chunks = -(-N_ROWS // sc.query_chunk)
    if counts != {**{k: 0 for k in counts}, "topk_matmul": chunks}:
        fail(f"quality ladder: αDBA launched {counts}, not K1 {chunks} "
             f"times (one a chunk)")
    dba_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    report(card, phase=11, config=path, rows=N_ROWS, dim=idx.dim,
           corpus=QL_CORPUS, extract_images_per_s=ips, scales=list(e.scales),
           dba_s=dba_s, dba_chunks=chunks, dba_k1_launches=dba_launches,
           dba_ms_per_chunk=dba_s / chunks * 1e3,
           dba_bound_ms_per_chunk=bound(
               N_ROWS * 2048 * 2 + sc.query_chunk * 2048 * 2,
               2 * sc.query_chunk * N_ROWS * 2048, "bf16")["bound_ms"],
           dba_peak_device_gib=dba_peak, dba_slice_s=slice_s,
           reduced={"corpus": f"{QL_CORPUS} extracted images among "
                    f"{N_ROWS - QL_CORPUS} seeded unit rows (ROxford5k: "
                    f"4,993 images, R1M's distractors; seeded random "
                    f"weights)"})
    rng = np.random.default_rng(11)
    picks = [rng.choice(QL_CORPUS, size=n, replace=False)
             for n in QUALITY_SIZES]
    core = ServeCore(idx)
    launches = serve_requests(card, 11, core, images, picks,
                              {topk: 2})["topk_matmul"]
    q = ex(images[np.concatenate(picks)])
    # K1's top-200 on the augmented store against its plain version, then
    # the whole composite over K1's plain candidates
    qm = idx._match_query_dim(q)
    try:
        err = check(idx.descriptors, qm,
                    *topk(idx.descriptors, qm, k=sc.diffusion_depth,
                          num_valid=N_ROWS),
                    *topk_ref(idx.descriptors, qm, k=sc.diffusion_depth,
                              num_valid=N_ROWS), SCORE_TOL)
    except AssertionError as why:
        fail(f"quality ladder: K1 at depth 200 against its plain version: "
             f"{why}")
    diff_err = against_plain_candidates("quality ladder", idx, q, topk,
                                        topk_ref, DIFF_TOL)
    qd = {b: ex(images[:b]) for b in (1, 8, 128)}
    lat = {b: {"search_p50_ms": p50_ms(lambda: idx.search(qd[b])),
               "search_no_diffusion_p50_ms": p50_ms(lambda: idx.search(
                   qd[b], sc.replace(diffusion_enabled=False)))}
           for b in qd}
    report(card, phase=11, config=path, diffusion_depth=sc.diffusion_depth,
           requests_top1_correct=True, k1_launches_in_requests=launches,
           k1_depth200_max_abs_err=err, held_to_plain_candidates=True,
           diffusion_max_abs_err=diff_err, diffusion_rel_tol=DIFF_TOL,
           search_p50_ms=lat)
    return {"launches": dba_launches + launches, "dba_s": dba_s,
            "dba_peak_gib": dba_peak, "latency": lat, "max_abs_err": err}


def phase11b(card, gen, topk, topk_ref, ox):
    """configs/local_whiten_rerank.json over phase 9's rows and extractor
    (the presets' extraction differs only in batch_size): a bf16 store of
    OX_ROWS at D = 2048, ``fit_local_whitening()`` at its default size
    (k-means, moments and bank timed apart), ServeCore requests and one
    B = 128 batch with αQE and the local-whitening re-score, save/load with
    the view, an add and a remove of LW_MUTATE rows absorbed by the view.
    Returns the results and the index, for (c) and (d)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import instsearch_torch.ops.local_whiten as lwmod
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index
    from instsearch_torch.serve import ServeCore

    idx9, _, _, _, _, images = ox
    path = "configs/local_whiten_rerank.json"
    cfg = PipelineConfig.load(os.path.join(HERE, path))
    sc = cfg.search
    if (cfg.extract.replace(batch_size=0)
            != idx9.cfg.extract.replace(batch_size=0)
            or not (sc.lw_enabled and sc.qe_enabled)
            or (sc.rerank_depth, sc.k, cfg.index.dtype)
            != (100, 10, "bfloat16")):
        fail(f"{path} is no longer the local-whitening preset over "
             f"workload 4's extraction")
    rows = idx9._rows_f32_chunk(0, idx9.descriptors.shape[0])[:OX_ROWS]
    idx = Index.from_descriptors(rows, idx9.names, cfg,
                                 extractor=idx9.extractor)
    del rows
    # the fit, its parts timed by wrapping the module's functions
    parts = {}

    def clock(name, fn):
        def run(*a, **kw):
            out, t = timed(lambda: fn(*a, **kw))
            parts[name] = parts.get(name, 0.0) + t
            return out
        return run

    saved = {n: getattr(lwmod, n) for n in
             ("fit_kmeans", "cluster_moments", "bank_from_moments")}
    for n, fn in saved.items():
        setattr(lwmod, n, clock(n, fn))
    torch.cuda.reset_peak_memory_stats()
    try:
        view, fit_s = timed(idx.fit_local_whitening)
    finally:
        for n, fn in saved.items():
            setattr(lwmod, n, fn)
    bank_gb = view.params.P.numel() * 4 / 1e9
    report(card, phase=11, config=path, rows=OX_ROWS, dim=idx.dim,
           n_clusters=view.n_clusters, bank_gb=bank_gb, fit_s=fit_s,
           kmeans_s=parts["fit_kmeans"], moments_s=parts["cluster_moments"],
           bank_eigh_s=parts["bank_from_moments"],
           whiten_store_s=fit_s - sum(parts.values()),
           fit_peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
           cluster_sizes_min_max=[int(v) for v in torch.bincount(
               view.assign[:OX_ROWS].long(),
               minlength=view.n_clusters).aminmax()])
    want = 1 << int(round(np.log2(np.sqrt(OX_ROWS))))     # 256
    if view.n_clusters != want:
        fail(f"local whitening: {view.n_clusters} clusters at the default "
             f"size, not {want} (~sqrt(N) as a power of two)")
    rng = np.random.default_rng(12)
    picks = [rng.choice(OX_CORPUS, size=n, replace=False) for n in (1, 8)]
    core = ServeCore(idx)
    launches = serve_requests(card, 11, core, images, picks,
                              {topk: 2})["topk_matmul"]
    big = rng.choice(OX_CORPUS, size=128, replace=False)
    q = idx.extractor(images[big])
    (s, i), counts = count_launches(lambda: idx.search(q))
    # the composite runs in pieces that keep the all-expert query block
    # and the candidate gather under 256 MiB (Index._search_lw)
    piece = (256 << 20) // (view.n_clusters * view.dim * 4
                            + sc.rerank_depth * view.dim * 8)
    want = {**{k: 0 for k in counts}, "topk_matmul": 2 * -(-128 // piece)}
    if counts != want or not np.array_equal(i[:, 0], big):
        fail(f"local whitening, B=128: launched {counts}, top-1 equal to "
             f"the source for {int((i[:, 0] == big).sum())} of 128")
    launches += counts["topk_matmul"]
    err = against_plain_candidates("local whitening", idx, q, topk,
                                   topk_ref, SCORE_TOL)
    qd = {b: q[:b] for b in (1, 8, 128)}
    lat = {b: {"search_p50_ms": p50_ms(lambda: idx.search(qd[b])),
               "search_no_lw_p50_ms": p50_ms(lambda: idx.search(
                   qd[b], sc.replace(lw_enabled=False)))}
           for b in qd}
    # the bank read of one all-expert whitening at B = 1 and 128
    from instsearch_torch.search.lw_rerank import whiten_all_clusters
    p = view.params
    whiten_ms = {b: cuda_median_ms(lambda: whiten_all_clusters(
        q[:b], p.P, p.mu), reps=10) for b in (1, 128)}
    report(card, phase=11, config=path, requests_top1_correct=True,
           batch128_top1_correct=True, k1_launches=launches,
           held_to_plain_candidates=True, lw_max_abs_err=err,
           search_p50_ms=lat, whiten_all_clusters_ms=whiten_ms,
           whiten_all_clusters_bound={
               b: bound(bank_gb * 1e9 + b * view.n_clusters * view.dim * 4,
                        2 * b * view.n_clusters * view.dim * 2048, "f32")
               for b in (1, 128)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase11_")
    try:
        _, save_s = timed(lambda: idx.save(tmp))
        copy, load_s = timed(lambda: Index.load(tmp, extractor=idx.extractor))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not (torch.equal(copy.lw.store, view.store)
            and torch.equal(copy.lw.params.P, view.params.P)):
        fail("local whitening: the view loaded differs from the one saved")
    for a, b in zip(copy.search(q), idx.search(q)):
        if not np.array_equal(a, b):
            fail("local whitening: answers differ after save/load")
    del copy
    # an add and a remove, absorbed by the view: the absorbed store equals
    # the frozen bank applied to the index's current rows (one bf16 step)
    new = smooth_images(gen, LW_MUTATE, size=cfg.extract.image_size)
    fresh = [f"new{i:03d}" for i in range(LW_MUTATE)]
    idx.add(descriptors=idx.extractor(new), names=fresh)
    gone = ([f"img{i:05d}" for i in range(LW_MUTATE // 2)]
            + fresh[:LW_MUTATE // 2])
    idx.remove(gone)
    from instsearch_torch.ops.local_whiten import (apply_local_whitening,
                                                   route)
    nv = idx.num_valid
    cur = idx._rows_f32_chunk(0, idx.descriptors.shape[0])[:nv]
    want = apply_local_whitening(cur, view.params)
    got = idx.lw.store[:nv].float()
    if not (torch.equal(idx.lw.assign[:nv].long(), route(cur, view.params))
            and bool(((got - want).abs() <= want.abs() * 2.0 ** -7
                      + 1e-6).all())):
        fail("local whitening: the view did not absorb the add and remove")
    s, i = idx.search(idx.extractor(new[LW_MUTATE // 2:]))
    kept = [idx.name_of(int(v)) for v in i[:, 0]]
    if kept != fresh[LW_MUTATE // 2:]:
        fail("local whitening: an added image is not its own top-1")
    _, i = idx.search(idx.extractor(images[:LW_MUTATE // 2]))
    if set(i.reshape(-1).tolist()) & set(range(LW_MUTATE // 2)):
        fail("local whitening: a removed image was returned")
    report(card, phase=11, config=path, save_s=save_s, load_s=load_s,
           saved_answers_equal=True, added=LW_MUTATE, removed=len(gone),
           view_absorbed=True, added_top1_correct=True,
           removed_never_returned=True)
    return ({"launches": launches, "fit_s": fit_s, "parts": parts,
             "latency": lat, "whiten_ms": whiten_ms, "save_s": save_s,
             "load_s": load_s, "max_abs_err": err}, idx)


def phase11c(card, topk_ref, lw_idx, ox) -> dict:
    """The sharded forms on phase 9's 8 shards on cuda:0, each against the
    single-device route on the same store: diffusion and the
    local-whitening re-score over (b)'s index cut into the 8 shards, αDBA
    and the kNN graph through the mesh over phase 9's store; then the
    expert-parallel whitening on a 4-shard mesh against
    ``apply_local_whitening``. Every route's K1 launches are counted and
    checked, the single-device ones too."""
    import numpy as np
    import torch
    from instsearch_torch.index import Index
    from instsearch_torch.ops.local_whiten import apply_local_whitening
    from instsearch_torch.parallel import expert_whiten_fn, make_mesh

    idx9, _, q9, _, _, _ = ox
    shards = idx9.cfg.index.num_shards
    mesh = make_mesh(shards, devices=["cuda"] * shards)
    q = q9[:16]
    dcfg = lw_idx.cfg.search.replace(lw_enabled=False, diffusion_enabled=True,
                                     qe_enabled=False)
    sidx = lw_idx.to_sharded(mesh=mesh)
    launches, errs = {}, {}

    def busy(sharded):
        """The shards that hold a valid row: a shard of pure padding
        launches nothing."""
        return sum(1 for sh in sharded.shards if sh.num_valid)

    def k1(tag, fn, want):
        """``fn()`` with the counts read around it; K1 launched ``want``
        times and no other kernel."""
        out, counts = count_launches(fn)
        if counts != {**{k: 0 for k in counts}, "topk_matmul": want}:
            fail(f"{tag} launched {counts}, not K1 {want} times")
        launches[tag] = want
        return out

    ss, si = k1("diffusion, sharded",
                lambda: lw_idx.search_sharded(sidx, q, dcfg), busy(sidx))
    ks, ki = k1("diffusion", lambda: lw_idx.search(q, dcfg), 1)
    scale = float(np.abs(ks[np.isfinite(ks)]).max())
    errs["diffusion"] = check_fused_against_plain(ss, si, ks, ki,
                                                  DIFF_TOL * max(1.0, scale))
    ss, si = k1("local whitening, sharded",
                lambda: lw_idx.search_sharded(sidx, q), 2 * busy(sidx))
    ks, ki = k1("local whitening", lambda: lw_idx.search(q), 2)
    errs["lw"] = check_fused_against_plain(ss, si, ks, ki, SCORE_TOL)
    # αDBA and the kNN graph through the mesh, on phase 9's store
    rows = idx9._rows_f32_chunk(0, idx9.descriptors.shape[0])[:OX_ROWS]
    cfg = idx9.cfg.replace(index=idx9.cfg.index.replace(dba_n=10))
    one = Index.from_descriptors(rows, idx9.names, cfg)
    many = Index.from_descriptors(rows, idx9.names, cfg)
    del rows
    chunks = -(-OX_ROWS // cfg.search.query_chunk)
    _, dba_one_s = k1("αDBA", lambda: timed(one.augment_database), chunks)
    _, dba_mesh_s = k1("αDBA, sharded",
                       lambda: timed(lambda: many.augment_database(mesh=mesh)),
                       chunks * busy(many.to_sharded(mesh=mesh)))
    # near-ties at the k-th neighbour, from the plain version's scores over
    # the original store
    n = cfg.index.dba_n
    ties = torch.zeros(one.descriptors.shape[0], dtype=torch.bool,
                       device="cuda")
    for s in range(0, OX_ROWS, 1024):
        sc, _ = topk_ref(idx9.descriptors, idx9._query_rows(s, 1024),
                         k=n + 1, num_valid=OX_ROWS)
        ties[s:s + 1024] = (sc[:, n - 1] - sc[:, n]) < SCORE_TOL
    n_pad = one.descriptors.shape[0]
    dba_differ = near_tie_rows(one._rows_f32_chunk(0, n_pad),
                               many._rows_f32_chunk(0, n_pad), ties)
    del one, many
    kchunks = -(-idx9.num_valid // (idx9.cfg.search.query_chunk or 128))
    ks, ki = k1("kNN graph", lambda: idx9.knn_graph(k=10), kchunks)
    ms, mi = k1("kNN graph, sharded",
                lambda: idx9.knn_graph(k=10, mesh=mesh),
                kchunks * busy(idx9.to_sharded(mesh=mesh)))
    errs["knn_graph"] = check_fused_against_plain(ms, mi, ks, ki, SCORE_TOL)
    # the expert-parallel whitening on 4 shards of the bank
    ep_mesh = make_mesh(4, devices=["cuda"] * 4)
    x = lw_idx._rows_f32_chunk(0, 4096)
    ep = expert_whiten_fn(ep_mesh)(lw_idx.lw.params, x)
    single = apply_local_whitening(x, lw_idx.lw.params)
    errs["ep"] = float((ep - single).abs().max())
    if errs["ep"] > 1e-6:
        fail(f"expert-parallel whitening differs from apply_local_whitening "
             f"by {errs['ep']}")
    report(card, phase=11, shards=shards, mesh=f"cuda:0 x {shards}", diffusion_sharded_equals_single=True,
           lw_sharded_equals_single=True, dba_mesh_equals_single=True,
           dba_rows_beyond_one_bf16_step_at_near_ties=dba_differ,
           dba_single_s=dba_one_s, dba_mesh_s=dba_mesh_s,
           knn_graph_mesh_equals_single=True, ep_shards=4,
           ep_equals_single=errs["ep"] == 0.0, max_abs_err=errs,
           k1_launches=launches)
    return {"launches": sum(launches.values()), "errs": errs,
            "dba_one_s": dba_one_s, "dba_mesh_s": dba_mesh_s}


def phase11d(card, gen, lw_idx, ox, int8_store) -> dict:
    """Near-duplicates over phase 9's rows with LW_PAIRS planted pairs (a
    corpus row and a copy moved by a seeded ~8 degrees): every planted pair
    found by ``find_duplicates(tau=0.97)``; then αDBA and one diffusion
    search over phase 3's 1M-row int8 store (configs/million_scale_int8.json
    with the quality ladder's dba_n and diffusion), K2 held bit for bit:
    the pass on a slice and the search on the whole store, each through K2
    and through its plain version."""
    import numpy as np
    import torch
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import (topk_matmul_int8,
                                          topk_matmul_int8_reference)

    idx9 = ox[0]
    rows = idx9._rows_f32_chunk(0, idx9.descriptors.shape[0])[:OX_ROWS]
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    src = torch.randperm(OX_CORPUS, generator=g, device="cuda")[:LW_PAIRS]
    noise = torch.randn(LW_PAIRS, rows.shape[1], generator=g, device="cuda")
    noise -= (noise * rows[src]).sum(1, keepdim=True) * rows[src]
    dup = rows[src] + 0.15 * noise / noise.norm(dim=1, keepdim=True)
    dup /= dup.norm(dim=1, keepdim=True)
    names = list(idx9.names) + [f"dup{i:02d}" for i in range(LW_PAIRS)]
    idx = Index.from_descriptors(torch.cat([rows, dup]), names, idx9.cfg)
    del rows
    chunks = -(-idx.num_valid // (idx.cfg.search.query_chunk or 128))
    ((pairs, scores), t), counts = count_launches(
        lambda: timed(lambda: idx.find_duplicates(tau=0.97)))
    if counts != {**{k: 0 for k in counts}, "topk_matmul": chunks}:
        fail(f"find_duplicates launched {counts}, not K1 {chunks} times "
             f"(one a chunk)")
    dup_launches = chunks
    found = {tuple(p) for p in pairs.tolist()}
    planted = {(int(a), OX_ROWS + j) for j, a in enumerate(src.tolist())}
    if not planted <= found:
        fail(f"find_duplicates found {len(planted & found)} of the "
             f"{LW_PAIRS} planted pairs")
    groups, counts = count_launches(
        lambda: idx.find_duplicates(tau=0.97, group=True))
    if counts["topk_matmul"] != chunks:
        fail(f"find_duplicates(group=True) launched {counts}, not K1 "
             f"{chunks} times")
    dup_launches += chunks
    report(card, phase=11, rows=idx.num_valid, planted_pairs=LW_PAIRS,
           planted_found=True, pairs_found=len(found),
           groups=len(groups), find_duplicates_s=t,
           k1_launches=dup_launches)
    del idx

    _, rows8, names8, ex3, images3, picks3 = int8_store
    cfg8 = PipelineConfig.load(os.path.join(HERE, "configs",
                                            "million_scale_int8.json"))
    cfg = cfg8.replace(
        index=cfg8.index.replace(dba_n=10),
        search=cfg8.search.replace(diffusion_enabled=True))
    dba_against_plain(card, "int8 store", cfg, rows8, topk_matmul_int8,
                      topk_matmul_int8_reference, exact=True)
    idx = Index.from_descriptors(rows8, names8, cfg, extractor=ex3)
    (_, dba_s), counts = count_launches(lambda: timed(idx.augment_database))
    chunks = -(-N_ROWS // cfg.search.query_chunk)
    if counts["topk_matmul_int8"] != chunks:
        fail(f"int8 αDBA launched {counts}, not K2 {chunks} times")
    q = ex3(images3[np.concatenate(picks3)])
    (ks, ki), c2 = count_launches(lambda: idx.search(q))
    import instsearch_torch.index as tindex
    tindex.topk_matmul_int8 = topk_matmul_int8_reference
    try:
        ps, pi = idx.search(q)
    finally:
        tindex.topk_matmul_int8 = topk_matmul_int8
    if not (np.array_equal(ki, pi) and np.array_equal(ks, ps)):
        fail("int8 store: αDBA + diffusion through K2 and through its plain "
             "version differ")
    if not np.array_equal(ki[:, 0], np.concatenate(picks3)):
        fail("int8 store: a diffused top-1 is not its source")
    report(card, phase=11, config="configs/million_scale_int8.json + dba_n "
           "10 + diffusion", rows=N_ROWS, dba_s=dba_s, dba_k2_launches=
           counts["topk_matmul_int8"], search_k2_launches=c2[
               "topk_matmul_int8"], k2_bit_for_bit=True, top1_correct=True)
    return {"launches_k2": counts["topk_matmul_int8"]
            + c2["topk_matmul_int8"], "launches_k1": dup_launches,
            "dba_s": dba_s}


# ---------------------------------------------------------------------------
# Phase 12: the ANN tiers (IVF, IVF-PQ, the host row store). They run plain
# PyTorch in the port as XLA ops in the reference: no kernel of K1-K4 may
# launch on their routes.

HOST_ROWS = 1 << 23     # phase 12c: rows of the host store (4 GiB of int8)
ADC_CLUSTERS = 8192     # phase 12d: clusters of the 64M-code view
ADC_MEMORY_BOUND = 4 << 30   # phase 12d: bytes above the view's own
FULL_PROBE_ROWS = 1 << 16    # phase 12a: rows of the full-probe cut


def p50s(fn, batches, make) -> dict:
    """Host-clock p50 of ``fn(make(b))`` at each batch ``b`` (the result
    read back to the host, so synchronized)."""
    return {b: p50_ms(lambda q=make(b): fn(q)) for b in batches}


def phase12(card: str, gen, w1, corpus) -> dict:
    """The ANN tiers through their entry points: (a) the IVF-PQ preset,
    (b) IVF over phase 2's bf16 and phase 3's int8 stores, (c) the host
    row store behind ``VectorServeCore``, (d) the ADC selection over 64M
    codes, (e) the IVF-PQ index sharded 8 ways on cuda:0, saved and
    loaded. Temporary files in one folder, removed at the end."""
    import shutil
    import tempfile
    import torch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase12_")
    out = {}
    try:
        for part, run in (
                ("a", lambda: phase12a(card, corpus)),
                ("b", lambda: phase12b(card, w1, corpus)),
                ("c", lambda: phase12c(card, gen, corpus, tmp)),
                ("d", lambda: phase12d(card, gen)),
                ("e", lambda: phase12e(card, out["a"].pop("index"), corpus,
                                       tmp))):
            torch.cuda.reset_peak_memory_stats()
            out[part] = run()
            out[part]["peak_device_memory_gib"] = (
                torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report(card, phase=12, peak_device_memory_gib={
        p: r["peak_device_memory_gib"] for p, r in out.items()})
    return out


def ivfpq_preset(corpus):
    """configs/capacity_ivfpq.json as loaded over phase 3's rows, whose
    extraction settings it shares (checked)."""
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index
    cfg4, rows, names, ex, images, picks = corpus
    cfg = PipelineConfig.load(os.path.join(HERE, "configs",
                                           "capacity_ivfpq.json"))
    if cfg.extract != cfg4.extract or cfg.index.dtype != "int4":
        fail("capacity_ivfpq.json no longer shares phase 3's extraction "
             "and int4 store")
    return cfg, Index.from_descriptors(rows, names, cfg, extractor=ex)


def phase12a(card, corpus) -> dict:
    """capacity_ivfpq.json over phase 3's 1M int4 rows: build_ivfpq with the
    reference's defaults, ServeCore requests (no K1-K4 launch, every top-1
    its source), recall@10 against the exact int4 route, p50s; then on a
    65,536-row cut, full probe and depth >= the rows against the oracle
    route by check_against_plain."""
    import numpy as np
    import torch
    from instsearch_torch.index import Index
    from instsearch_torch.kernels.topk_matmul import check_against_plain
    from instsearch_torch.serve import ServeCore

    cfg, idx = ivfpq_preset(corpus)
    _, rows, names, ex, images, picks = corpus
    view, build_s = timed(lambda: idx.build_ivfpq())
    if (view.device.type != "cuda" or view.m != 64 or view.depth != 400
            or idx.cfg.search.ivfpq_nprobe != 32
            or view.codes.dtype != torch.int8):
        fail(f"IVF-PQ view on {view.device}, m {view.m}, depth "
             f"{view.depth}, nprobe {idx.cfg.search.ivfpq_nprobe}")
    report(card, phase=12, part="a", config="configs/capacity_ivfpq.json",
           store="int4 + IVF-PQ", rows=N_ROWS, n_clusters=view.n_clusters,
           nprobe=view.nprobe, m=view.m, depth=view.depth,
           bucket_capacity=view.bucket_capacity,
           spill_rows=int((view.spill_pos >= 0).sum()),
           scan_fraction=view.scan_fraction(), build_ivfpq_s=build_s,
           qe_enabled=cfg.search.qe_enabled,
           reduced={"rows": f"{PQ_ROWS_CAPACITY} -> {N_ROWS}: phase 3's "
                            f"1M-row int4 store; phase 12d runs the ADC "
                            f"selection over 64M codes"})
    core = ServeCore(idx)
    serve_requests(card, 12, core, images, picks, {})   # no kernel at all
    rng = np.random.default_rng(12)
    q = ex(images[np.concatenate(picks)])
    recall = view.measure_recall(idx, q, k=10)
    lat = p50s(idx.search, (1, 8, 128),
               lambda b: ex(images[rng.choice(len(images), b,
                                              replace=False)]))
    report(card, phase=12, part="a", recall_at_10_vs_exact_int4=recall,
           search_p50_ms=lat, ready=core.ready_info())

    # full probe, depth >= the valid rows: the exact route's answer
    cut = Index.from_descriptors(rows[:FULL_PROBE_ROWS],
                                 names[:FULL_PROBE_ROWS], cfg)
    full = cut.build_ivfpq(depth=FULL_PROBE_ROWS)
    scfg = cut.cfg.search.replace(ivfpq_nprobe=full.n_clusters,
                                  qe_enabled=False)
    s, i = cut.search(q, scfg)
    ps, pi = cut.with_search(use_pallas=False).search(
        q, scfg.replace(ivfpq_nprobe=0))
    x = cut._rows_f32_chunk(0, FULL_PROBE_ROWS)
    on_card = [torch.from_numpy(np.asarray(a)).cuda() for a in (s, i, ps, pi)]
    try:
        err = check_against_plain(x, q, *on_card, SCORE_TOL)
    except AssertionError as e:
        fail(f"IVF-PQ at full probe and depth: {e}")
    report(card, phase=12, part="a", full_probe_rows=FULL_PROBE_ROWS,
           full_probe_equals_oracle_route=True, max_abs_err=err,
           queries=int(i.shape[0]))
    del cut, full, core
    return {"build_s": build_s, "recall_at_10": recall, "p50_ms": lat,
            "index": idx}


def phase12b(card, w1, corpus) -> dict:
    """build_ivf over phase 2's 1M bf16 store and over phase 3's rows as
    million_scale_int8.json's int8 store: requests (no K1-K4 launch, every
    top-1 its source), full probe against K1's route (bf16) and the oracle
    route on the bf16-rounded query (int8, the reference's _score_rows
    semantics) by check_against_plain, p50s."""
    import numpy as np
    import torch
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index
    from instsearch_torch.kernels.topk_matmul import check_against_plain
    from instsearch_torch.serve import ServeCore

    idx2, images2, picks2 = w1
    cfg8 = PipelineConfig.load(os.path.join(HERE, "configs",
                                            "million_scale_int8.json"))
    _, rows, names, ex, images3, picks3 = corpus
    int8 = Index.from_descriptors(
        rows, names, cfg8.replace(search=cfg8.search.replace(ivf_nprobe=32)),
        extractor=ex)
    out = {}
    rng = np.random.default_rng(13)
    for kind, exact, images, picks in (
            ("bf16", idx2, images2, picks2), ("int8", int8, images3, picks3)):
        twin = exact.with_search()          # phase 2's index stays as it is
        view, build_s = timed(lambda: twin.build_ivf())
        report(card, phase=12, part="b", store=kind, rows=N_ROWS,
               n_clusters=view.n_clusters, nprobe=view.nprobe,
               bucket_capacity=view.bucket_capacity,
               spill_rows=int((view.spill_pos >= 0).sum()),
               scan_fraction=view.scan_fraction(), build_ivf_s=build_s,
               qe_enabled=twin.cfg.search.qe_enabled)
        serve_requests(card, 12, ServeCore(twin), images, picks, {})
        ex_k = twin.extractor
        q = ex_k(images[np.concatenate(picks)])
        scfg = twin.cfg.search.replace(ivf_nprobe=view.n_clusters,
                                       qe_enabled=False)
        s, i = twin.search(q, scfg)
        if kind == "bf16":          # K1's route: the bf16-rounded query
            ps, pi = exact.search(q, scfg.replace(ivf_nprobe=0))
            x = exact.descriptors
        else:                       # the oracle on the bf16-rounded query
            ps, pi = exact.with_search(use_pallas=False).search(
                q.to(torch.bfloat16).float(), scfg.replace(ivf_nprobe=0))
            x = exact._rows_f32_chunk(0, N_ROWS)
        on_card = [torch.from_numpy(np.asarray(a)).cuda()
                   for a in (s, i, ps, pi)]
        try:
            err = check_against_plain(x, q, *on_card, SCORE_TOL)
        except AssertionError as e:
            fail(f"IVF over {kind} at full probe: {e}")
        del x
        recall = view.measure_recall(twin, q, k=10)
        lat = p50s(twin.search, (1, 8),
                   lambda b: ex_k(images[rng.choice(len(images), b,
                                                    replace=False)]))
        report(card, phase=12, part="b", store=kind,
               full_probe_equals_exact_route=True, max_abs_err=err,
               recall_at_10_vs_exact=recall, search_p50_ms=lat)
        out[kind] = {"build_s": build_s, "p50_ms": lat, "recall_at_10":
                     recall}
        del twin, view
    del int8
    return out


def phase12c(card, gen, corpus, tmp) -> dict:
    """A HostRowStore of 8,388,608 x 512 int8 rows (seeded unit rows, the
    1,024 corpus descriptors among them at seeded positions), the IVF-PQ
    view fitted from it on the card, VectorServeCore answering vector
    requests of 1 and 8 corpus descriptors with the host gather (every
    top-1 its source) and ADC-only."""
    import numpy as np
    import torch
    from instsearch_torch.search.ivfpq import HostRowStore, IVFPQView
    from instsearch_torch.serve import VectorServeCore

    _, rows, _, _, _, _ = corpus
    corpus_q = rows[:CORPUS_Q].float()
    rng = np.random.default_rng(14)
    where = rng.choice(HOST_ROWS, size=CORPUS_Q, replace=False)
    at = {int(p): j for j, p in enumerate(where)}
    values = np.empty((HOST_ROWS, DIM), np.int8)
    scales = np.empty((HOST_ROWS,), np.float32)
    t0 = time.perf_counter()
    step = min(1 << 18, HOST_ROWS)
    for s in range(0, HOST_ROWS, step):
        x = torch.randn(step, DIM, generator=gen, device="cuda")
        x = x / x.norm(dim=1, keepdim=True)
        mine = [(p - s, j) for p, j in at.items() if s <= p < s + step]
        if mine:
            loc, j = zip(*mine)
            x[list(loc)] = corpus_q[list(j)]
        sc = x.abs().amax(dim=1) / 127.0
        sc = torch.where(sc > 0, sc, torch.ones_like(sc))
        values[s:s + step] = torch.clamp(torch.round(x / sc[:, None]), -127,
                                         127).to(torch.int8).cpu().numpy()
        scales[s:s + step] = sc.cpu().numpy()
    store = HostRowStore.create(os.path.join(tmp, "host"), values,
                                scales=scales)
    write_s = time.perf_counter() - t0
    del values
    torch.cuda.reset_peak_memory_stats()
    view, build_s = timed(lambda: IVFPQView.from_host_store(store))
    report(card, phase=12, part="c", host_rows=HOST_ROWS, dim=DIM,
           rows_bin_bytes=os.path.getsize(os.path.join(tmp, "host",
                                                       "rows.bin")),
           write_s=write_s, from_host_store_s=build_s,
           n_clusters=view.n_clusters, nprobe=view.nprobe, m=view.m,
           depth=view.depth, bucket_capacity=view.bucket_capacity,
           codes_bytes=view.codes.numel() + view.spill_codes.numel())
    out = {"build_s": build_s}
    q8 = corpus_q[:8].cpu().numpy()
    for mode, adc_only in (("host gather", False), ("adc_only", True)):
        core = VectorServeCore(store, view, adc_only=adc_only)
        core.warmup()
        top1 = []
        for b in (1, 8):
            ans = core.handle_line(json.dumps({"vectors": q8[:b].tolist()}))
            if "error" in ans:
                fail(f"VectorServeCore ({mode}): {ans['error']}")
            top1 += [r[0]["id"] == int(where[j])
                     for j, r in enumerate(ans["results"])]
        if not adc_only and not all(top1):
            fail(f"VectorServeCore (host gather): top-1 not its source "
                 f"({sum(top1)} of {len(top1)})")
        lat = p50s(lambda q: core.run_queries([(q, 10)]), (1, 8),
                   lambda b: q8[:b])
        report(card, phase=12, part="c", mode=mode,
               top1_is_source=f"{sum(top1)}/{len(top1)}",
               run_queries_p50_ms=lat, ready=core.ready_info())
        out[mode] = {"p50_ms": lat, "top1": sum(top1) / len(top1)}
    # the two halves of a host-gather query: the ADC selection on the card
    # (CUDA events) and the host gather and re-score (host clock)
    times = {}
    for b in (1, 8):
        adc_ms = cuda_median_ms(lambda: view._select(q8[:b], view.depth,
                                                     None, None))
        pos = view._select(q8[:b], view.depth, None, None)[1].cpu().numpy()

        def host():
            r = store.gather(pos)
            return np.einsum("bkd,bd->bk", r, q8[:b], dtype=np.float32)
        times[b] = {"adc_select_device_ms": adc_ms,
                    "host_gather_rescore_ms": p50_ms(host)}
    report(card, phase=12, part="c", split=times,
           peak_device_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["split"] = times
    del view, store
    return out


def phase12d(card, gen) -> dict:
    """The ADC selection over 67,108,864 seeded codes (2 GiB, C = 8192
    buckets of 8192 slots, seeded positions) at depth 400, B = 1 and 8: the
    working memory above the view's own bytes must stay under 4 GiB (the
    table is gathered by the codes, never expanded one-hot)."""
    import numpy as np
    import torch
    from instsearch_torch.ops.pq import PQCodebook
    from instsearch_torch.search.ivfpq import IVFPQView

    n, c = PQ_ROWS_CAPACITY, ADC_CLUSTERS
    m_cap = n // c
    cent = torch.randn(c, DIM, generator=gen, device="cuda")
    cent = cent / cent.norm(dim=1, keepdim=True)
    codes = torch.randint(-128, 128, (c, m_cap, 32), generator=gen,
                          device="cuda", dtype=torch.int8)
    pos = torch.randperm(n, generator=gen, device="cuda").to(
        torch.int32).reshape(c, m_cap)
    pq = 0.05 * torch.randn(64, 16, DIM // 64, generator=gen, device="cuda")
    empty = torch.zeros((0,), dtype=torch.int32, device="cuda")
    view = IVFPQView(cent, codes, pos, torch.zeros((0, 32), dtype=torch.int8,
                                                   device="cuda"),
                     empty, empty.clone(), PQCodebook(pq), nprobe=32,
                     depth=400)
    view_bytes = sum(t.numel() * t.element_size()
                     for t in (cent, codes, pos, pq))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {}
    for b in (1, 8):
        q = torch.randn(b, DIM, generator=gen, device="cuda")
        q = (q / q.norm(dim=1, keepdim=True)).cpu().numpy()
        s, i = view.search_adc(q, k=10)
        if not (np.isfinite(s).all() and (i >= 0).all()):
            fail("ADC at 64M codes: empty or non-finite answers")
        out[b] = p50_ms(lambda: view.search_adc(q, k=10))
    above = torch.cuda.max_memory_allocated() - base
    if above > ADC_MEMORY_BOUND:
        fail(f"ADC at 64M codes took {above / 2**30:.2f} GiB above the "
             f"view's own bytes (bound 4 GiB)")
    report(card, phase=12, part="d", codes=n, code_bytes=n * 32,
           n_clusters=c, bucket_capacity=m_cap, depth=400, nprobe=32,
           view_bytes=view_bytes, working_memory_gib=above / 2 ** 30,
           search_adc_p50_ms=out)
    del view, codes, pos
    return {"p50_ms": out, "working_memory_gib": above / 2 ** 30}


def phase12e(card, idx, corpus, tmp) -> dict:
    """(a)'s index cut in 8 shards on cuda:0: ``search_ivfpq`` against the
    single-device cascade (ids equal but where an ADC near-tie at the depth
    boundary swaps a candidate, exact scores within 1e-6), and the sharded
    ServeCore's requests (every top-1 its source, no K1-K4 launch); then
    the index saved with its view and loaded: answers equal bit for bit."""
    import numpy as np
    import torch
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import make_mesh
    from instsearch_torch.search.ivfpq import _adc_select
    from instsearch_torch.serve import ServeCore

    _, _, _, ex, images, picks = corpus
    view = idx.ivfpq
    mesh = make_mesh(8, devices=["cuda"] * 8)
    sidx = idx.to_sharded(mesh=mesh)
    q = ex(images[np.concatenate(picks)])
    ss, si = (t.cpu().numpy() for t in sidx.search_ivfpq(q, k=10))
    s1, i1 = idx.search(q, idx.cfg.search.replace(qe_enabled=False))
    qm = idx._match_query_dim(q.float())
    swapped = 0
    for r in np.flatnonzero((si != i1).any(axis=1)):
        # the single device's whole ADC ranking of this query: a swapped id
        # must sit at the depth boundary within an ADC near-tie
        a_s, a_p = _adc_select(*view.arrays, qm[r:r + 1], depth=1 << 30,
                               nprobe=view.nprobe)
        a_s, a_p = a_s[0].cpu().numpy(), a_p[0].cpu().numpy()
        edge = a_s[view.depth - 1]
        tol = 1e-5 * max(1.0, float(np.abs(a_s[np.isfinite(a_s)]).max()))
        for pid in set(si[r]) ^ set(i1[r]):
            got = a_s[a_p == pid]
            if not (len(got) and abs(float(got[0]) - edge) <= tol):
                fail(f"sharded IVF-PQ: id {pid} differs beyond an ADC "
                     f"near-tie at the depth boundary")
        swapped += 1
    same = si == i1
    err = float(np.abs(ss[same] - s1[same]).max())
    if err > 1e-6:
        fail(f"sharded IVF-PQ scores differ by {err} > 1e-6")
    core = ServeCore(idx, sharded=True, mesh=mesh)
    serve_requests(card, 12, core, images, picks, {})
    report(card, phase=12, part="e", shards=8, mesh="cuda:0 x 8",
           sharded_equals_single_device=True, rows_swapped_at_depth=swapped,
           max_abs_err=err, queries=int(si.shape[0]),
           sharded_requests_top1_correct=True)

    folder = os.path.join(tmp, "ivfpq_index")
    _, save_s = timed(lambda: idx.save(folder))
    live, load_s = timed(lambda: Index.load(folder, extractor=ex))
    for name in ("centroids", "codes", "bucket_pos", "spill_codes",
                 "spill_pos", "spill_cluster"):
        if not torch.equal(getattr(live.ivfpq, name), getattr(view, name)):
            fail(f"the loaded IVF-PQ view's {name} differ")
    a = idx.search(q)
    b = live.search(q)
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        fail("the loaded IVF-PQ index answers otherwise")
    report(card, phase=12, part="e", save_s=save_s, load_s=load_s,
           view_equal=True, answers_equal_bit_for_bit=True)
    del live, sidx, core
    return {"swapped": swapped, "save_s": save_s, "load_s": load_s}


OX5K_IMAGES = 5063      # phase 13: Oxford5k's image count
OX5K_H, OX5K_W = 384, 512   # phase 13: the JPEG files' size
CLI_DUPES = 8           # phase 13c: images written again under new names
CLI_QUERIES = 8         # phase 13b: database images queried, one process each
SERVE_REQUESTS = 64     # phase 13e: single-image requests per client
SERVE_CLIENTS = 8       # phase 13e: concurrent clients
WORKLOAD1 = "configs/oxford5k_resnet50_avgpool.json"
# phase 13's bf16 store and bf16-rounded query: each component of either
# operand rounds by at most 2^-9 relative, so a score of unit vectors moves
# by up to ~2^-8, in one direction for most components when the descriptor
# is itself a scaled bf16 vector (measured: self-scores 0.9971-1.0002 on
# the card). Random average-pooled ResNet-50 descriptors of 5,063 images
# put ~1% of them within 1.5e-3 of their nearest neighbour, so there a
# source may trail a neighbour by less than this and still be right.
BF16_TIE = 2.0 ** -8
# phase 13: the depth at which a query that missed its source in its top-k
# is asked again (trails_within_tie). Self-scores go as low as ~0.997, and
# in a crowded part of the 5,063 more than k neighbours may lie above one
# within BF16_TIE (a served top-5 once held five at 0.9974-0.9978, and not
# its source)
DEEP_K = 64
COMPACT = "configs/compact128_int4.json"    # phase 13d: the int4 preset


def grating_images(gen, n: int, batch: int = 128):
    """Seeded uint8 [b, OX5K_H, OX5K_W, 3] batches of one to four coloured
    sine gratings (random frequency, orientation, phase, colour and
    amplitude; the first always at 0.3-0.6) on a random base colour with
    pixel noise, made on the card:
    a random ResNet-50's average-pooled features of such images spread
    wider than of smooth noise, so self-retrieval among 5,063 of them is
    decided by the descriptors, not by their common direction."""
    import torch
    yy, xx = torch.meshgrid(torch.arange(OX5K_H, device="cuda"),
                            torch.arange(OX5K_W, device="cuda"),
                            indexing="ij")
    for s in range(0, n, batch):
        b = min(batch, n - s)

        def rand(*shape):
            return torch.rand(b, *shape, generator=gen, device="cuda")

        freq = 0.005 + 0.295 * rand(4, 1, 1)
        theta = torch.pi * rand(4, 1, 1)
        phase = 2 * torch.pi * rand(4, 1, 1)
        amp = 0.6 * rand(4) * (rand(4) < 0.75)
        amp[:, 0] = 0.3 + 0.3 * rand()      # never a flat image
        colour = (2 * rand(4, 3) - 1) * amp[..., None]
        waves = torch.sin(2 * torch.pi * freq * (
            xx * torch.cos(theta) + yy * torch.sin(theta)) + phase)
        img = torch.einsum("bkhw,bkc->bhwc", waves, colour)
        img = img + (0.2 + 0.6 * rand(3))[:, None, None, :]
        img = img + 0.15 * rand(1, 1, 1) * torch.randn(
            img.shape, generator=gen, device="cuda")
        yield (img.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()


def write_jpegs(gen, folder: str, n: int) -> list[str]:
    """``n`` seeded grating images as JPEG files ``ox{i:05d}.jpg`` (cv2, 8
    writer threads)."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    os.makedirs(folder, exist_ok=True)
    paths = [os.path.join(folder, f"ox{i:05d}.jpg") for i in range(n)]

    def write(path, img):
        if not cv2.imwrite(path, img[:, :, ::-1]):
            raise OSError(f"cannot write {path}")

    with ThreadPoolExecutor(8) as pool:
        start = 0
        for batch in grating_images(gen, n):
            list(pool.map(write, paths[start:start + len(batch)], batch))
            start += len(batch)
    return paths


def top1_is_source(results: list, name: str) -> bool:
    """``results`` (best first, with names and scores) answer a query of
    the image ``name``: it is first, or in the list within BF16_TIE of the
    first's score (a tie the bf16 roundings decide)."""
    if results and results[0]["name"] == name:
        return True
    own = [e["score"] for e in results if e["name"] == name]
    return bool(own) and results[0]["score"] - own[0] <= BF16_TIE


def trails_within_tie(results: list, deeper: list, name: str) -> bool:
    """A top-k answer ``results`` that misses its source ``name`` is still
    right where more than k neighbours lie within BF16_TIE above the
    source: ``deeper``, the same image asked again for DEEP_K results,
    holds every entry of ``results`` at its score and starts at its first
    (each within BF16_TIE: the two requests may be extracted in batches of
    other sizes), and ranks ``name`` within BF16_TIE of its first. A query
    or a list gone wrong gives other rows, or the source far below."""
    got = {e["name"]: e["score"] for e in deeper}
    return (bool(results) and bool(deeper)
            and all(e["name"] in got
                    and abs(got[e["name"]] - e["score"]) <= BF16_TIE
                    for e in results)
            and abs(deeper[0]["score"] - results[0]["score"]) <= BF16_TIE
            and top1_is_source(deeper, name))


def cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    return env


def cli_command(*argv) -> list[str]:
    """``python -m instsearch_torch.cli --device cuda ...``: every process of
    phase 13 names the card, so none can run anywhere else."""
    return [sys.executable, "-m", "instsearch_torch.cli", "--device", "cuda",
            *argv]


def run_cli(*argv, timeout: float = 300) -> tuple[list[dict], float]:
    """One CLI process to its end -> (its JSON lines, wall seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run(cli_command(*argv), capture_output=True, text=True,
                         cwd=HERE, env=cli_env(), timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"cli {' '.join(argv[:1])} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")], wall


def cli_in_process(*argv) -> list[dict]:
    """``instsearch_torch.cli.main`` in this process (its kernel launches
    counted by the caller) -> its JSON lines."""
    import contextlib
    import io

    from instsearch_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", "cuda", *argv])
    if rc != 0:
        fail(f"cli {argv[0]} in process exited {rc}")
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase13(card: str, gen) -> dict:
    """The command line and the TCP server on the card, workload 1 at full
    width (ResNet-50 at 224 px, ``configs/oxford5k_resnet50_avgpool.json``
    as shipped) over 5,063 seeded JPEG files in a temporary folder."""
    import shutil
    import tempfile

    from instsearch_torch.data import native_frontend
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase13_")
    try:
        return _phase13(card, gen, tmp, native_frontend.available())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase13(card, gen, tmp, native: bool) -> dict:
    import shutil

    import numpy as np
    decoder = "native" if native else "cv2"
    images = os.path.join(tmp, "images")
    t0 = time.perf_counter()
    paths = write_jpegs(gen, images, OX5K_IMAGES)
    report(card, phase=13, wrote_jpegs=len(paths), size=f"{OX5K_W}x{OX5K_H}",
           write_s=time.perf_counter() - t0, decoder=decoder)
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]

    # (a) build-index: plain, then resumable, killed after its first flush
    plain = os.path.join(tmp, "plain")
    out, wall = run_cli("build-index", "--images", images, "--out", plain,
                        "--config", WORKLOAD1)
    dim = out[0]["dim"]
    if out != [{"indexed": OX5K_IMAGES, "quarantined": 0, "dim": dim,
                "out": plain}]:
        fail(f"build-index printed {out}")
    report(card, phase=13, run="build-index", dim=dim, wall_s=wall,
           images_per_s=OX5K_IMAGES / wall, decoder=decoder)
    resumed = os.path.join(tmp, "resumed")
    manifest = resumed + ".build/manifest.json"
    proc = subprocess.Popen(
        cli_command("build-index", "--images", images, "--out", resumed,
                    "--config", WORKLOAD1, "--resumable"),
        cwd=HERE, env=cli_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    t0 = time.perf_counter()
    done = []
    try:
        while not done and proc.poll() is None:
            time.sleep(0.02)
            try:
                with open(manifest) as f:
                    done = json.load(f)["completed"]
            except (OSError, ValueError):
                pass
    finally:
        proc.kill()
        proc.wait(timeout=60)
    killed_s = time.perf_counter() - t0
    if not done or len(done) * 1024 >= OX5K_IMAGES:
        fail(f"the resumable build was not cut mid-way (groups {done})")
    out, wall = run_cli("build-index", "--images", images, "--out", resumed,
                        "--config", WORKLOAD1, "--resumable")
    if out[0]["indexed"] != OX5K_IMAGES:
        fail(f"resumed build-index printed {out}")
    a, b = saved_arrays(plain), saved_arrays(resumed)
    with open(os.path.join(plain, "meta.json")) as f:
        meta_a = json.load(f)
    with open(os.path.join(resumed, "meta.json")) as f:
        meta_b = json.load(f)
    if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                       for k in a):
        fail("the resumed index's rows differ from the uninterrupted one's")
    if meta_a["names"] != meta_b["names"] or meta_a["names"] != names:
        fail("the resumed index's names differ")
    report(card, phase=13, run="build-index --resumable",
           killed_after_groups=len(done), killed_after_s=killed_s,
           resume_wall_s=wall,
           resume_images_per_s=(OX5K_IMAGES - 1024 * len(done)) / wall,
           bit_equal_to_plain=True, decoder=decoder)

    # (b) query: 8 processes at once, each top-1 its own image
    rng = np.random.default_rng(13)
    picks = rng.choice(OX5K_IMAGES, size=CLI_QUERIES, replace=False)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        cli_command("query", "--index", plain, "--image", paths[i]),
        cwd=HERE, env=cli_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in picks]
    swaps = past_k = 0
    for i, p in zip(picks, procs):
        stdout, stderr = p.communicate(timeout=300)
        if p.returncode != 0:
            fail(f"query exited {p.returncode}: {stderr[-2000:]}")
        res = json.loads(stdout.strip().splitlines()[-1])["results"]
        if not top1_is_source(res, names[i]):
            deeper = run_cli("query", "--index", plain, "--image", paths[i],
                             "-k", str(DEEP_K))[0][-1]["results"]
            if not trails_within_tie(res, deeper, names[i]):
                fail(f"query {names[i]}: {res[:3]}; asked for {DEEP_K}: "
                     f"{deeper[:8]}")
            past_k += 1
        swaps += res[0]["name"] != names[i]
    report(card, phase=13, run="query", processes=CLI_QUERIES,
           top1_correct=True, near_tie_swaps=swaps, source_past_k=past_k,
           wall_s=time.perf_counter() - t0)

    # (e) the TCP server, before (c) adds rows to the index on disk
    serve = serve_tcp_clients(card, plain, paths, names, rng)

    counts: dict = {}
    # (c) the same images again under new names, added, then info and dedupe
    dupes = [int(i) for i in rng.choice(OX5K_IMAGES, size=CLI_DUPES,
                                        replace=False)]
    dupe_dir = os.path.join(tmp, "dupes")
    os.makedirs(dupe_dir)
    for i in dupes:
        shutil.copy(paths[i], os.path.join(dupe_dir, f"copy_{names[i]}.jpg"))
    out, c = count_launches(lambda: cli_in_process(
        "update-index", "--index", plain, "--add", dupe_dir))
    add_counts(counts, c)
    if out[0]["added"] != CLI_DUPES:
        fail(f"update-index printed {out}")
    info = cli_in_process("info", "--index", plain)[0]
    if info["rows"] != OX5K_IMAGES + CLI_DUPES or info["dim"] != dim:
        fail(f"info printed {info}")
    t0 = time.perf_counter()
    (dd,), c = count_launches(lambda: cli_in_process(
        "dedupe", "--index", plain, "--tau", "0.97"))
    add_counts(counts, c)
    planted = {tuple(sorted((names[i], f"copy_{names[i]}"))) for i in dupes}
    scored = {tuple(sorted((p["a"], p["b"]))): p["score"]
              for p in dd["pairs"]}
    if not planted <= set(scored):
        fail(f"dedupe missed planted pairs {sorted(planted - set(scored))}")
    others = [v for k, v in scored.items() if k not in planted]
    report(card, phase=13, run="dedupe", tau=0.97, n_pairs=dd["n_pairs"],
           n_groups=dd["n_groups"], planted_pairs_found=CLI_DUPES,
           least_planted_score=min(scored[k] for k in planted),
           best_other_score=max(others) if others else None,
           seconds=time.perf_counter() - t0, info_bytes=info["bytes"])

    # (d) the int4 preset with a PQ view, queried by the cascade and exactly
    pq = os.path.join(tmp, "pq")
    t0 = time.perf_counter()
    (built,), c = count_launches(lambda: cli_in_process(
        "build-index", "--images", images, "--out", pq, "--config", COMPACT,
        "--pq"))
    add_counts(counts, c)
    report(card, phase=13, run="build-index --pq", config=COMPACT,
           pq=built["pq"],
           wall_s=time.perf_counter() - t0,
           images_per_s=OX5K_IMAGES / (time.perf_counter() - t0))
    for extra, kernel in (([], "pq_topk"), (["--pq-depth", "0"],
                                            "topk_matmul_int4")):
        for i in picks[:2]:
            (ans,), c = count_launches(lambda: cli_in_process(
                "query", "--index", pq, "--image", paths[i], *extra))
            add_counts(counts, c)
            if not top1_is_source(ans["results"], names[i]):
                fail(f"query {extra} on the PQ index: {ans['results'][:3]}")
            if c[kernel] != 2:          # alpha-QE: top-qe_n, then top-k
                fail(f"query {extra} launched {c}")
    report(card, phase=13, run="query --pq / --pq-depth 0", top1_correct=True)

    # (f) evaluate on the mini fixture with workload 1, then every preset
    data = os.path.join(tmp, "data")
    (ev,), c = count_launches(lambda: cli_in_process(
        "evaluate", "--dataset", "mini", "--data-root", data, "--config",
        WORKLOAD1))
    add_counts(counts, c)
    report(card, phase=13, run="evaluate", config=WORKLOAD1,
           dataset=ev["dataset"], protocol=ev["protocol"], mAP=ev["mAP"])
    t0 = time.perf_counter()
    lines, c = count_launches(lambda: cli_in_process(
        "workloads", "--data-root", data))
    add_counts(counts, c)
    from instsearch_torch.workloads import list_presets
    if [ln["workload"] for ln in lines] != list_presets():
        fail(f"workloads printed {[ln.get('workload') for ln in lines]}")
    for ln in lines:
        # every stage the preset enables ran; the sharded ranking is
        # printed, not checked: its alpha-QE takes the kernels' route (an
        # int8 store quantizes the query) where the single-device protocol
        # ranking expands through the f32 scoring oracle, as the
        # reference's does on its chip
        if ln["stages_missing"] or not np.isfinite(ln["mAP"]):
            fail(f"workload {ln['workload']}: {ln}")
        report(card, phase=13, run="workloads", **{
            k: ln[k] for k in ("workload", "mAP", "num_shards", "build_sec",
                               "sharded_matches_single") if k in ln})
    report(card, phase=13, run="workloads", presets=len(lines),
           seconds=time.perf_counter() - t0, launches=c)

    for name in ("topk_matmul", "topk_matmul_int8", "topk_matmul_int4",
                 "pq_topk"):
        if not counts.get(name):
            fail(f"{name} never launched in phase 13's in-process parts: "
                 f"{counts}")
    for name in ("mha", "flash_mha", "fused_identity_blocks"):
        if counts.get(name):
            fail(f"{name} launched {counts[name]} times in phase 13")
    report(card, phase=13, launches_cli=counts)
    return {"launches": counts, "serve": serve}


def _send(f, req) -> tuple[dict, float]:
    t0 = time.perf_counter()
    f.write((req if isinstance(req, str) else json.dumps(req)) + "\n")
    f.flush()
    return json.loads(f.readline()), (time.perf_counter() - t0) * 1e3


def serve_tcp_clients(card, index, paths, names, rng) -> dict:
    """``cli serve --port 0`` as a process on (a)'s index: 1 client, then
    SERVE_CLIENTS at once, each sending SERVE_REQUESTS single-image requests
    (every top-1 its source, host-clock round trips); a remove, a query, an
    add and a query on one connection answered in order; a bad request
    answered with an error, the server serving on."""
    import socket
    import threading

    import numpy as np
    proc = subprocess.Popen(cli_command("serve", "--index", index, "--port",
                                        "0"),
                            cwd=HERE, env=cli_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        if not line:
            fail(f"serve exited: {proc.stderr.read()[-2000:]}")
        ready = json.loads(line)
        report(card, phase=13, run="serve", ready=ready,
               start_s=time.perf_counter() - t0)
        from instsearch_torch.data import frontend
        decode = []
        for i in range(SERVE_REQUESTS):
            t0 = time.perf_counter()
            frontend.load_square(paths[i], 224)
            decode.append((time.perf_counter() - t0) * 1e3)
        report(card, phase=13, run="serve", host_decode_p50_ms=float(
            np.percentile(decode, 50)), decoder="cv2 (load_square)")

        def client(picks, out, errors):
            try:
                with socket.create_connection(("127.0.0.1", ready["port"]),
                                              timeout=120) as s:
                    f = s.makefile("rw")
                    for i in picks:
                        ans, ms = _send(f, {"image": paths[i], "k": 5})
                        res = ans["results"][0]
                        past_k = not top1_is_source(res, names[i])
                        if past_k and not answered(f, i, res):
                            raise AssertionError(
                                f"{names[i]} in a batch of "
                                f"{ans['batch_rows']}: {res}")
                        out.append((ms, ans["batch_rows"],
                                    res[0]["name"] != names[i],
                                    ans["latency_ms"], past_k))
            except Exception as e:        # noqa: BLE001 — reported below
                errors.append(repr(e))

        deep_ranks = []     # (image, rank, gap to the first) of each

        def answered(f, i, res) -> bool:
            """``res`` missed image i: asked again deeper on connection f,
            is it a crowd within BF16_TIE (trails_within_tie)?"""
            deeper = _send(f, {"image": paths[i], "k": DEEP_K})[0]
            deeper = deeper.get("results", [[]])[0]
            if trails_within_tie(res, deeper, names[i]):
                r = [e["name"] for e in deeper].index(names[i])
                deep_ranks.append((names[i], r, deeper[0]["score"]
                                   - deeper[r]["score"]))
                return True
            print(f"chip_smoke: {names[i]} asked for {DEEP_K}: "
                  f"{deeper[:8]}", file=sys.stderr, flush=True)
            return False

        stats = {}
        for n in (1, SERVE_CLIENTS):
            outs = [[] for _ in range(n)]
            errors: list = []
            threads = [threading.Thread(target=client, args=(
                rng.choice(len(paths), SERVE_REQUESTS, replace=False),
                outs[j], errors)) for j in range(n)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            if errors or any(t.is_alive() for t in threads):
                fail(f"serve with {n} clients: {errors[:3]}")
            ms = np.array([o[0] for out in outs for o in out])
            rows = np.array([o[1] for out in outs for o in out])
            device = np.array([o[3] for out in outs for o in out])
            stats[n] = {"p50_ms": float(np.percentile(ms, 50)),
                        "p99_ms": float(np.percentile(ms, 99)),
                        "requests_per_s": len(ms) / wall,
                        "max_batch_rows": int(rows.max()),
                        "batched_share": float(np.mean(rows > 1)),
                        "mean_batch_rows": float(rows.mean()),
                        # the dispatcher's device pass (extraction and
                        # search) of the request's batch, as it reports it
                        "pass_p50_ms": float(np.percentile(device, 50)),
                        "near_tie_swaps": sum(o[2] for out in outs
                                              for o in out),
                        "source_past_k": sum(o[4] for out in outs
                                             for o in out)}
            report(card, phase=13, run="serve", clients=n,
                   requests=len(ms), top1_correct=True, **stats[n])
        if stats[SERVE_CLIENTS]["max_batch_rows"] < 2:
            fail("no request was micro-batched under "
                 f"{SERVE_CLIENTS} clients")

        with socket.create_connection(("127.0.0.1", ready["port"]),
                                      timeout=120) as s:
            f = s.makefile("rw")
            i = int(rng.integers(len(paths)))
            steps = [({"remove": [names[i]]}, "removed"),
                     ({"image": paths[i], "k": 5}, "absent"),
                     ({"add": [paths[i]]}, "added"),
                     ({"image": paths[i], "k": 5}, "found"),
                     ({"image": "/nonexistent.jpg"}, "error"),
                     ("not json", "error"),
                     ({"image": paths[0], "k": 5}, "serving")]
            for req, want in steps:
                ans, _ = _send(f, req)
                res = ans["results"][0] if "results" in ans else None
                # only the step's own check runs: "found" and "serving"
                # may ask the server again
                ok = {"removed": lambda: ans.get("removed") == 1,
                      "absent": lambda: res is not None and names[i] not in
                      [e["name"] for e in res],
                      "added": lambda: ans.get("added") == 1,
                      "found": lambda: res is not None and (top1_is_source(
                          res, names[i]) or answered(f, i, res)),
                      "error": lambda: "error" in ans,
                      "serving": lambda: res is not None and (top1_is_source(
                          res, names[0]) or answered(f, 0, res))}[want]()
                if not ok:
                    fail(f"serve {req}: {ans}")
        report(card, phase=13, run="serve", mutations_in_order=True,
               bad_request_answered=True, source_past_k_deep=deep_ranks)
    finally:
        proc.kill()
        proc.wait(timeout=60)
    return stats


TRAIN_CLASSES = 16      # phase 14: classes of the labelled tree
TRAIN_VIEWS = 4         # phase 14: JPEG views of each class
TRAIN_WARMUP = 3        # phase 14a: steps before the timed ones
TRAIN_TIMED = 10        # phase 14a: timed steps on the fixed batch
TRAIN_FALL = 8          # phase 14a: steps over which the loss must fall
GRAD_COS = 0.9999       # phase 14b: per-tensor cosine, card f32 vs CPU f32


@contextlib.contextmanager
def world_of_one():
    """A ``torch.distributed`` group of this one process on the loopback,
    started by ``parallel.initialize()`` at its default backend (gloo for
    CPU tensors, NCCL for CUDA ones) and torn down after."""
    import socket

    import torch.distributed as dist
    from instsearch_torch.parallel import initialize
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # one process on the loopback: NCCL's and gloo's bootstraps stay on it
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", NCCL_SOCKET_IFNAME="lo",
               GLOO_SOCKET_IFNAME="lo")
    os.environ.update(env)
    try:
        backend = str(dist.get_backend()) if initialize() else "none"
        if "cuda:nccl" not in backend:
            fail(f"initialize() did not start a group with NCCL for CUDA "
                 f"tensors (backend: {backend})")
        yield dist
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for v in env:
            os.environ.pop(v, None)


def write_train_tree(gen, folder: str) -> list[str]:
    """``folder/views/c{c:02d}v{v}.jpg``: one seeded grating a class (phase
    13's images), each view of it shifted, its brightness scaled and pixel
    noise added, as the mini fixture makes its views; and the labelled tree
    ``folder/tree/class{c:02d}/`` of links to them. Returns the views'
    paths, class-major."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(14)
    views = os.path.join(folder, "views")
    os.makedirs(views)
    paths = []
    bases = np.concatenate(list(grating_images(gen, TRAIN_CLASSES)))
    for c, base in enumerate(bases):
        d = os.path.join(folder, "tree", f"class{c:02d}")
        os.makedirs(d)
        for v in range(TRAIN_VIEWS):
            img = (np.roll(base.astype(np.float32),
                           tuple(rng.integers(-24, 25, 2)), axis=(0, 1))
                   * rng.uniform(0.85, 1.15)
                   + rng.normal(0, 6.0, base.shape))
            paths.append(os.path.join(views, f"c{c:02d}v{v}.jpg"))
            if not cv2.imwrite(paths[-1], np.clip(img, 0, 255).astype(
                    np.uint8)[:, :, ::-1]):
                fail(f"cannot write {paths[-1]}")
            os.symlink(paths[-1], os.path.join(d, f"c{c:02d}v{v}.jpg"))
    return paths


def grad_cosines(a: dict, b: dict) -> dict:
    """Per-tensor cosine of two gradient dicts (f64 on the host)."""
    out = {}
    for name, g in a.items():
        x = g.double().cpu().flatten()
        y = b[name].double().cpu().flatten()
        out[name] = float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))
    return out


def train_steps(cfg, batch, steps: int, **kw):
    """A seeded ``Trainer`` (``kw``: mesh) on the card -> (its losses over
    ``steps`` steps on ``batch``, the trainer)."""
    from instsearch_torch.train import Trainer
    tr = Trainer(cfg, seed=0, **kw)
    return [tr.step(batch)["loss"] for _ in range(steps)], tr


def max_param_diff(a, b) -> float:
    return max(float((a.params[n].detach() - b.params[n].detach()).abs()
                     .max()) for n in a.params)


def phase14(card: str, gen) -> dict:
    """Fine-tuning on the card at full width: the default ``TrainConfig``
    (ResNet-50 at 224 px, GeM, bf16, 8 tuples of 2 + 5 images) over a
    seeded labelled tree of JPEG files in a temporary folder, removed at
    the end."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase14_")
    try:
        return _phase14(card, gen, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase14(card, gen, tmp) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from instsearch_torch.config import TrainConfig
    from instsearch_torch.data import frontend
    from instsearch_torch.train import Trainer
    t_phase = time.perf_counter()
    paths = write_train_tree(gen, tmp)
    tree, views = os.path.join(tmp, "tree"), os.path.join(tmp, "views")
    cfg = TrainConfig()
    t = 2 + cfg.num_negatives
    images = np.stack([frontend.load_square(p, cfg.image_size)
                       for p in paths])
    # tuple i: two views of class i, then view 0 of the next classes
    tuples = [[TRAIN_VIEWS * i, TRAIN_VIEWS * i + 1]
              + [TRAIN_VIEWS * ((i + j) % TRAIN_CLASSES)
                 for j in range(1, t - 1)] for i in range(TRAIN_CLASSES)]
    batch = images[np.asarray(tuples[:cfg.batch_size])]  # [8, 7, S, S, 3]
    small = images[np.asarray(tuples[:2])]               # [2, 7, S, S, 3]

    # (a) the step on a fixed batch: time, rate, memory; the loss falls
    tr = Trainer(cfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        t0 = time.perf_counter()
        losses.append(tr.step(batch)["loss"])     # the float syncs
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not np.all(np.isfinite(losses)):
        fail(f"phase 14a: a loss is not finite: {losses}")
    if not losses[TRAIN_FALL - 1] < losses[0]:
        fail(f"phase 14a: the loss did not fall over {TRAIN_FALL} steps: "
             f"{losses[:TRAIN_FALL]}")
    step_ms = statistics.median(times[TRAIN_WARMUP:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            tr.step(batch)
        wall = (time.perf_counter() - t0) * 1e3 / 3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 3e3
    if busy <= 0:
        fail("phase 14a: the profiler recorded no device operation")
    n_img = cfg.batch_size * t
    report(card, phase=14, part="a", backbone=cfg.backbone,
           image_size=cfg.image_size, dtype=cfg.dtype, pooling=cfg.pooling,
           loss=cfg.loss, images_per_step=n_img, step_ms_p50=step_ms,
           step_ms_min=min(times[TRAIN_WARMUP:]),
           images_per_s=n_img / step_ms * 1e3, peak_gib=peak,
           profiled_step_ms=wall, device_busy_ms=busy,
           idle_share=1 - busy / wall,
           idle_share_unprofiled=1 - busy / step_ms,
           losses=losses[:TRAIN_FALL])
    del tr
    torch.cuda.empty_cache()

    # (b) one f32 step on the card against the same step on the CPU, and
    # the bf16 route's gradients against the f32 route's
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("phase 14b: TF32 is on")
    f32 = cfg.replace(dtype="float32")
    card_f32 = Trainer(f32, seed=0)
    loss_card, g_card = card_f32.value_and_grad(small)
    t0 = time.perf_counter()
    loss_cpu, g_cpu = Trainer(f32, variables=card_f32.variables,
                              device="cpu").value_and_grad(small)
    cpu_s = time.perf_counter() - t0
    rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    cos = grad_cosines(g_card, g_cpu)
    worst = min(cos, key=cos.get)
    if rel > 1e-4 or cos[worst] < GRAD_COS:
        fail(f"phase 14b: the card's f32 step against the CPU's: loss "
             f"{float(loss_card)} vs {float(loss_cpu)}, lowest gradient "
             f"cosine {cos[worst]} ({worst})")
    _, g_bf16 = Trainer(cfg, variables=card_f32.variables).value_and_grad(
        small)
    cos_bf16 = grad_cosines(g_bf16, g_card)
    report(card, phase=14, part="b", loss_card=float(loss_card),
           loss_cpu=float(loss_cpu), loss_rel_diff=rel,
           grad_cos_min=cos[worst], grad_cos_min_tensor=worst,
           cpu_step_s=cpu_s, bf16_vs_f32_grad_cos_min=min(cos_bf16.values()),
           bf16_vs_f32_grad_cos_median=statistics.median(cos_bf16.values()),
           tensors=len(cos))
    del card_f32, g_card, g_cpu, g_bf16

    # (c) the data-parallel form on an NCCL group of one process, and (d)
    # remat, each against the plain trainer; cuDNN's deterministic
    # algorithms, so that two runs of one arithmetic agree bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        with world_of_one() as dist:
            for loss in ("contrastive", "smoothap"):
                c = cfg.replace(loss=loss, batch_size=2)
                plain, tp = train_steps(c, small, 2)
                dp, td = train_steps(c, small, 2, mesh=dist.group.WORLD)
                diff = max_param_diff(tp, td)
                if plain != dp or diff != 0.0:
                    fail(f"phase 14c: {loss} under an NCCL group of one "
                         f"differs: losses {dp} vs {plain}, parameters by "
                         f"{diff}")
                report(card, phase=14, part="c", loss=loss,
                       backend=str(dist.get_backend()), losses=dp,
                       max_param_diff=diff)
        c = cfg.replace(batch_size=2)
        plain, tp = train_steps(c, small, 1)
        remat, tr_ = train_steps(c.replace(remat=True), small, 1)
        rel = abs(remat[0] - plain[0]) / abs(plain[0])
        if rel > 1e-6:
            fail(f"phase 14d: remat's loss {remat[0]} vs plain {plain[0]}")
        report(card, phase=14, part="d", loss_plain=plain[0],
               loss_remat=remat[0], loss_rel_diff=rel,
               max_param_diff=max_param_diff(tp, tr_))
        del tp, td, tr_
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # (e) the command line: finetune with Lw and the frozen-versus-tuned
    # report, build-index --weights over the tree, a query of every view
    ckpt = os.path.join(tmp, "tuned")
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    (ft,), counts = count_launches(lambda: cli_in_process(
        "finetune", "--images", tree, "--out", ckpt, "--fit-lw",
        "--learn-p", "--eval-dataset", "mini", "--eval-data-root", data))
    ft_s = time.perf_counter() - t0
    for f in (os.path.join(ckpt, "torch_weights.pt"), ckpt + ".meta.json",
              ckpt + ".whitening.npz"):
        if not os.path.isfile(f):
            fail(f"phase 14e: finetune wrote no {f}")
    report(card, phase=14, part="e", run="finetune", seconds=ft_s, **ft)
    idx = os.path.join(tmp, "idx")
    (built,), c = count_launches(lambda: cli_in_process(
        "build-index", "--images", views, "--out", idx, "--weights", ckpt))
    add_counts(counts, c)
    with open(ckpt + ".meta.json") as fh:
        meta = json.load(fh)
    lw = np.load(ckpt + ".whitening.npz")
    if built["indexed"] != len(paths) or built["dim"] != lw["P"].shape[0]:
        fail(f"phase 14e: build-index --weights printed {built}")
    # Lw pulls a class's views together: a view's own entry may trail
    # another view of its class by a bf16 near-tie, and the first
    # TRAIN_VIEWS results must be its class's views
    ties = 0
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        (ans,), c = count_launches(lambda: cli_in_process(
            "query", "--index", idx, "--image", p))
        add_counts(counts, c)
        top = ans["results"]
        if not top1_is_source(top, name) or {
                e["name"][:3] for e in top[:TRAIN_VIEWS]} != {name[:3]}:
            fail(f"phase 14e: query of {name}: {top[:TRAIN_VIEWS + 1]}")
        ties += top[0]["name"] != name
    if not counts.get("topk_matmul"):
        fail(f"phase 14e launched no K1: {counts}")
    report(card, phase=14, part="e", run="build-index --weights + query",
           gem_p=meta["gem_p"], dim=built["dim"], queries=len(paths),
           top1_correct=True, class_views_first=True, near_tie_swaps=ties,
           launches_train=counts,
           phase_s=time.perf_counter() - t_phase)
    return {"launches": counts}


L2_ROWS = 1_000_000     # phase 15a: rows of BIGANN/SIFT1M's base set
L2_DIM = 128            # phase 15a: its width
L2_QUERIES = 1000       # phase 15a: its query set's size
L2_RANGE_K = 16         # phase 15a: the radius lies near the 16th neighbour
L2_RANGE_M = 256        # phase 15a/b: max_results (K1/K2's route: <= K_MAX)
L2_INT8_RECALL = 0.9    # phase 15a: least recall@10 of the int8 l2 store
DP_BATCH = 64           # phase 15d: images a data-parallel batch
DP_BUILD = 384          # phase 15d: image files the two builds read


def sift_like_rows(gen, n: int, d: int, chunk: int = 1 << 18):
    """Seeded rows shaped like SIFT's: non-negative integers below 129
    (``round(128 u^2)``, u uniform), made on the card, f32. Integer rows and
    queries keep every product, norm and squared distance below 2^24, so
    f32 holds them exactly: the l2 scores of an f32 store, the oracle's
    distances and the radius test are exact, ties are exact ties."""
    import torch
    out = torch.empty((n, d), dtype=torch.float32, device="cuda")
    for s in range(0, n, chunk):
        u = torch.rand((min(chunk, n - s), d), generator=gen, device="cuda")
        out[s:s + len(u)] = (128.0 * u * u).round()
    return out


def l2_oracle(x, q, k: int, chunk: int = 1 << 16, integer: bool = True):
    """Exact squared distances by ``torch.cdist`` (the direct form, no
    matmul expansion, in f64, squared, and with ``integer`` rounded: every
    squared distance of integer rows is an integer) over row chunks -> the
    ``k`` nearest ``(d2 [Q, k] f32, rows [Q, k] int64)``, ties by the lower
    row, and a function counting the rows within a radius the same way."""
    import torch
    q64 = q.double()

    def d2(start):
        d = torch.cdist(q64, x[start:start + chunk].double(),
                        compute_mode="donot_use_mm_for_euclid_dist")
        return ((d * d).round() if integer else d * d).float()

    best_d, best_i = None, None
    for s in range(0, x.shape[0], chunk):
        dd = d2(s)
        ii = torch.arange(s, s + dd.shape[1], device=q.device).expand_as(dd)
        if best_d is not None:
            dd = torch.cat([best_d, dd], 1)
            ii = torch.cat([best_i, ii], 1)
        # rows arrive in ascending order: a stable sort keeps the lower
        # row first among equal distances
        dd, order = torch.sort(dd, dim=1, stable=True)
        best_d, best_i = dd[:, :k], torch.gather(ii, 1, order[:, :k])

    def count(r2: float):
        n = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
        members = []
        for s in range(0, x.shape[0], chunk):
            hit = d2(s) <= r2
            n += hit.sum(1)
            members.append(hit)
        return n, members
    return best_d, best_i, count


def l2_stored_counts(idx, q, thr, block: int = 100):
    """A brute-force range count over an l2 index's stored rows in f64 (the
    script's own arithmetic: the dequantized components against the
    query, less the stored norm column, at least the f32 threshold ``thr
    [Q]``) -> ``(counts [Q], inside [Q, N_pad] bool)``."""
    import torch
    d = idx.user_dim
    rows = idx.descriptors[:, :d + 1].float()
    if idx.scales is not None:          # dequantized in f32, as searched
        rows = rows * idx.scales[0, :, None]
    rows = rows.double()
    counts, inside = [], []
    for s in range(0, q.shape[0], block):
        sc = q[s:s + block].double() @ rows[:, :d].T - rows[:, d][None, :]
        hit = (sc >= thr[s:s + block, None]) & (idx.ids[None, :] >= 0)
        counts.append(hit.sum(1))
        inside.append(hit)
    return torch.cat(counts), torch.cat(inside)


def phase15(card: str, gen, topk, topk_ref, int8_kernel, int8_ref, check,
            check_exact, ox) -> dict:
    """The rest of M7 and M14: (a) an l2 raw-vector index at SIFT1M's scale,
    (b) range search through phase 9's mesh, (c) phase 9's store saved and
    loaded placed on that mesh, (d) data-parallel extraction and
    ``Index.build(mesh=)``. Temporary files in one folder, removed at the
    end. Returns the K1 and K2 launches of the phase's main paths."""
    import shutil
    import tempfile
    import torch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase15_")
    out = {}
    try:
        for part, run in (
                ("a", lambda: phase15a(card, gen, topk, topk_ref,
                                       int8_kernel, int8_ref, check,
                                       check_exact)),
                ("b", lambda: phase15b(card, topk, topk_ref, check, ox)),
                ("c", lambda: phase15c(card, topk, ox, out["b"], tmp)),
                ("d", lambda: phase15d(card, gen, tmp))):
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            out[part] = run()
            out[part]["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {name: sum(r.get("launches", {}).get(name, 0)
                          for r in out.values())
                for name in ("topk_matmul", "topk_matmul_int8",
                             "topk_matmul_f32")}
    report(card, phase=15, launches=launches,
           seconds={p: r["seconds"] for p, r in out.items()})
    return {"launches": launches, **out}


def phase15a(card, gen, topk, topk_ref, int8_kernel, int8_ref, check,
             check_exact) -> dict:
    """``metric="l2"`` over L2_ROWS x L2_DIM seeded SIFT-shaped rows (the
    shape of the public BIGANN/SIFT1M base set, made from the seed, nothing
    downloaded) and L2_QUERIES integer queries near seeded rows, as f32,
    bf16 and int8 stores through ``Index.from_descriptors`` and
    ``search``/``search_range``. The f32 store's top-10 must equal the
    exact oracle's (``torch.cdist``, f32, exact on integers) slot by slot,
    ties counted by distance; every store's top-1 on the bf16 and f32
    stores must be the source row; the bf16 store's recall@10 against the
    oracle is printed. The norm column sets an int8 row's scale (the
    reference's documented cost), which at SIFT's norms puts every
    component below one step, so the int8 store holds the rows as a user
    who picks int8 + l2 would give them: centered on the rows' mean and
    divided by their median norm (norm column ~0.5, the largest component
    ~0.2, some 50 steps); on it the top-1 must be the source row and
    recall@10 against that data's own oracle at least L2_INT8_RECALL. K1
    (f32, bf16 store) and K2
    (int8) at B = 128 on the stores' augmented rows against their plain
    versions (``check_against_plain``, ``check_exact``). ``search_range``
    by a radius between two integers near the 16th neighbour: the f32
    store's counts equal the oracle's chunked count and its members are
    the oracle's rows within it; each store's counts equal a brute-force
    count over its stored rows in f64 (the script's own arithmetic), and
    the f32/bf16 members are a subset of it (K2 quantizes the query, so an
    int8 member near the radius may lie outside the f32 count's). The
    B = 1 and B = 128 p50s of ``search``."""
    import numpy as np
    import torch
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.index import Index

    x = sift_like_rows(gen, L2_ROWS, L2_DIM)
    rng = np.random.default_rng(15)
    src = torch.as_tensor(rng.choice(L2_ROWS, size=L2_QUERIES,
                                     replace=False), device="cuda")
    q = x[src] + torch.randint(-3, 4, (L2_QUERIES, L2_DIM), generator=gen,
                               device="cuda").float()
    t0 = time.perf_counter()
    od, oi, count = l2_oracle(x, q, k=L2_RANGE_K)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    if not bool((oi[:, 0] == src).all()):
        fail("phase 15a: the oracle's nearest row is not every query's "
             "source")
    # a radius between two integers (every squared distance is one), near
    # the 16th neighbour
    r2 = float(od[:, L2_RANGE_K - 1].median()) + 0.5
    ocount, _ = count(r2)
    report(card, phase=15, part="a", rows=L2_ROWS, dim=L2_DIM,
           queries=L2_QUERIES, oracle_s=oracle_s, radius=r2 ** 0.5,
           oracle_count_median=float(ocount.float().median()),
           source="BIGANN/SIFT1M base set's shape (1M x 128, 1,000 "
           "queries), seeded integer rows, nothing downloaded")
    # the int8 store's rows: centered, divided by the median norm
    mu = x.mean(0)
    scale = float((x - mu).norm(dim=1).median())
    x8, q8 = (x - mu) / scale, (q - mu) / scale
    od8, oi8, count8 = l2_oracle(x8, q8, k=L2_RANGE_K, integer=False)
    r2_8 = float(od8[:, L2_RANGE_K - 1].median())
    report(card, phase=15, part="a", int8_rows="centered, / median norm",
           median_norm=scale, radius=r2_8 ** 0.5,
           oracle_count_median=float(count8(r2_8)[0].float().median()))
    data = {"float32": (x, q, oi, r2), "bfloat16": (x, q, oi, r2),
            "int8": (x8, q8, oi8, r2_8)}
    res = {"launches": {}, "p50_ms": {}, "recall10": {}}
    for dtype, (x, q, oi, r2) in data.items():
        tau = r2 ** 0.5
        cfg = PipelineConfig(index=IndexConfig(dtype=dtype, metric="l2"),
                             search=SearchConfig(k=10))
        idx = Index.from_descriptors(x, [f"v{i}" for i in range(L2_ROWS)],
                                     cfg)
        if idx.dim != L2_DIM + 1 or idx.user_dim != L2_DIM:
            fail(f"phase 15a: l2 store widths {idx.dim}/{idx.user_dim}")
        chunk = cfg.search.query_chunk
        pieces = -(-L2_QUERIES // chunk)

        def main_path(idx=idx):
            return idx.search(q), idx.search_range(q, tau,
                                                   max_results=L2_RANGE_M)
        ((s, i), (rs, ri, rc)), counts = count_launches(main_path)
        kernel = topk if dtype != "int8" else int8_kernel
        if counts != {**{n: 0 for n in counts},
                      kernel.__name__: 2 * pieces}:
            fail(f"phase 15a {dtype}: search and search_range launched "
                 f"{counts}, not {kernel.__name__} {2 * pieces} times")
        f32_store = 2 * pieces if dtype == "float32" else 0
        if topk.launches_f32 != f32_store:
            fail(f"phase 15a {dtype}: {topk.launches_f32} K1 launches over "
                 f"an f32 store, not {f32_store}")
        res["launches"][kernel.__name__] = (
            res["launches"].get(kernel.__name__, 0) + 2 * pieces)
        res["launches"]["topk_matmul_f32"] = (
            res["launches"].get("topk_matmul_f32", 0) + f32_store)
        i_t = torch.as_tensor(i, device="cuda").long()
        want = oi[:, :10]
        recall = float((i_t[:, :, None] == want[:, None, :]).any(2)
                       .float().mean())
        res["recall10"][dtype] = recall
        if dtype == "float32":
            # slot by slot: the distance of the row returned equals the
            # oracle's at that slot (ties by distance), scores exact
            got_d = ((x[i_t] - q[:, None, :]) ** 2).sum(-1)
            if not (torch.equal(got_d, od[:, :10])
                    and torch.equal(torch.as_tensor(s, device="cuda"),
                                    -od[:, :10])):
                fail("phase 15a: the f32 l2 top-10 differs from the exact "
                     "oracle's")
        if not bool((i_t[:, 0] == src).all()):
            fail(f"phase 15a {dtype}: a top-1 is not its source row")
        if dtype == "int8" and recall < L2_INT8_RECALL:
            fail(f"phase 15a int8: recall@10 {recall} against the exact "
                 f"oracle, below {L2_INT8_RECALL}")
        # K1/K2 against their plain versions on the augmented rows, B = 128
        qm = idx._match_query_dim(q[:128])
        if dtype == "int8":
            try:
                check_exact(*int8_kernel(idx.descriptors, idx.scales, qm,
                                         k=10, num_valid=L2_ROWS),
                            *int8_ref(idx.descriptors, idx.scales, qm, k=10,
                                      num_valid=L2_ROWS))
            except AssertionError as why:
                fail(f"phase 15a int8: K2 against its plain version: {why}")
        else:
            try:
                check(idx.descriptors, qm,
                      *topk(idx.descriptors, qm, k=10, num_valid=L2_ROWS),
                      *topk_ref(idx.descriptors, qm, k=10,
                                num_valid=L2_ROWS), 1e-3)
            except AssertionError as why:
                fail(f"phase 15a {dtype}: K1 against its plain version: "
                     f"{why}")
        # range search: the counts, and the members against the stored rows
        thr = (((q * q).sum(1) - np.float32(r2)) / np.float32(2.0)).double()
        brute, inside = l2_stored_counts(idx, q, thr)
        rc_t = torch.as_tensor(rc, device="cuda").long()
        if not torch.equal(rc_t, brute):
            fail(f"phase 15a {dtype}: range counts differ from the "
                 f"brute-force count over the stored rows at "
                 f"{int((rc_t != brute).sum())} queries")
        ri_t = torch.as_tensor(ri, device="cuda").long()
        filled = ri_t >= 0
        members_inside = bool(torch.gather(
            inside, 1, ri_t.clamp(min=0))[filled].all())
        if dtype != "int8" and not members_inside:
            fail(f"phase 15a {dtype}: a range member lies outside the "
                 f"radius")
        if dtype == "float32":
            if not torch.equal(rc_t, ocount):
                fail("phase 15a: the f32 range counts differ from the "
                     "oracle's")
            n_in = torch.minimum(ocount, torch.full_like(ocount,
                                                         L2_RANGE_M))
            if not torch.equal(filled.sum(1), n_in):
                fail("phase 15a: the f32 range members are not every row "
                     "within the radius (up to max_results)")
        res["p50_ms"][dtype] = {
            b: p50_ms(lambda b=b, idx=idx: idx.search(q[:b]))
            for b in (1, 128)}
        report(card, phase=15, part="a", dtype=dtype,
               store=list(idx.descriptors.shape),
               recall_at_10_vs_oracle=recall,
               f32_top10_equals_oracle=dtype == "float32",
               top1_is_source=bool((i_t[:, 0] == src).all()),
               range_counts_equal_brute_force=True,
               range_members_inside=members_inside,
               range_count_median=float(rc_t.float().median()),
               search_p50_ms=res["p50_ms"][dtype], launches=counts)
        del idx
        torch.cuda.empty_cache()
    return res


def range_members_agree(store, qm, thr: float, a, b, tol: float) -> None:
    """Two range answers ``(scores, ids)`` over a store whose ids are its
    positions: the same members but rows whose plain f32 score lies within
    ``tol`` of ``thr`` (two orders of K1's sums may put such a row on
    either side), common members' scores within ``tol``."""
    import torch
    from instsearch_torch.search.bruteforce import masked_scores
    for row in range(qm.shape[0]):
        sa = dict(zip(a[1][row].tolist(), a[0][row].tolist()))
        sb = dict(zip(b[1][row].tolist(), b[0][row].tolist()))
        sa.pop(-1, None)
        sb.pop(-1, None)
        odd = sorted(set(sa) ^ set(sb))
        if odd:
            plain = masked_scores(store[torch.as_tensor(odd,
                                                        device=qm.device)],
                                  qm[row:row + 1])[0]
            if bool(((plain - thr).abs() > tol).any()):
                fail(f"range members differ beyond near-ties of the "
                     f"threshold at query {row}: rows {odd[:5]}")
        for r in set(sa) & set(sb):
            if abs(sa[r] - sb[r]) > tol:
                fail(f"range member {r} of query {row}: scores {sa[r]} "
                     f"and {sb[r]}")


def phase15b(card, topk, topk_ref, check, ox) -> dict:
    """Range search through phase 9's mesh (8 shards on cuda:0, D = 2048,
    bf16): ``Index.search_range(mesh=)`` against the single-device route on
    phase 9's queries, with a threshold near their 32nd-best score and
    max_results = L2_RANGE_M. Counts equal; members equal but at near-ties
    of the threshold (K1's rule, ``range_members_agree``); the uncut
    top-L2_RANGE_M of the mesh's merge against the single-device K1 call
    by ``check_against_plain``; K1 8 times a piece on the mesh route, once
    on one device. The p50 of both routes at B = 1 and at all the
    queries."""
    import torch
    idx, sidx, q, _, _, _ = ox
    mesh = sidx.mesh
    shards = mesh.num_shards
    one = idx.search(q, idx.cfg.search.replace(k=64))[0]
    tau = float(torch.as_tensor(one[:, 31]).median())
    m = L2_RANGE_M
    single, c1 = count_launches(lambda: idx.search_range(q, tau,
                                                         max_results=m))
    meshed, c8 = count_launches(lambda: idx.search_range(
        q, tau, max_results=m, mesh=mesh))
    pieces = -(-q.shape[0] // idx.cfg.search.query_chunk)
    if c1["topk_matmul"] != pieces or c8["topk_matmul"] != shards * pieces:
        fail(f"phase 15b: K1 launched {c1['topk_matmul']} times on one "
             f"device and {c8['topk_matmul']} through the mesh, not "
             f"{pieces} and {shards * pieces}")
    if not (single[2] == meshed[2]).all():
        fail(f"phase 15b: mesh range counts {meshed[2].tolist()} differ "
             f"from one device's {single[2].tolist()}")
    qm = sidx._match_query_dim(q)
    range_members_agree(idx.descriptors, qm, tau, meshed, single, SCORE_TOL)
    try:
        err = check(idx.descriptors, qm, *sidx.search(qm, k=m),
                    *topk(idx.descriptors, qm, k=m, num_valid=idx.num_valid),
                    SCORE_TOL)
    except AssertionError as why:
        fail(f"phase 15b: the mesh's top-{m} against one device's: {why}")
    p50 = {route: {b: p50_ms(lambda b=b, kw=kw: idx.search_range(
                       q[:b], tau, max_results=m, **kw))
                   for b in (1, q.shape[0])}
           for route, kw in (("mesh", {"mesh": mesh}), ("one device", {}))}
    report(card, phase=15, part="b", rows=idx.num_valid, shards=shards,
           tau=tau, queries=int(q.shape[0]), max_results=m,
           counts=single[2].tolist(), counts_equal=True,
           members_agree_by_k1_rule=True, max_abs_err=err,
           search_range_p50_ms=p50,
           launches={"single": c1["topk_matmul"], "mesh": c8["topk_matmul"]})
    return {"launches": {"topk_matmul": c1["topk_matmul"]
                         + c8["topk_matmul"]},
            "tau": tau, "answer": meshed, "p50_ms": p50}


def phase15c(card, topk, ox, res_b, tmp) -> dict:
    """``Index.load(mesh=)``: phase 9's index saved (npz, forced) and
    loaded with ``make_mesh(8, devices=["cuda:0"] * 8)``. Its ``search`` must equal
    phase 9's sharded answer bit for bit (the same K1 calls on the same
    rows), its ``search_range`` 15b's mesh answer, its ``knn_graph`` of the
    first rows the unsharded index's; ``to_sharded`` with the mesh must
    reuse the placed shards (``data_ptr``); serving must leave the store
    placed; K1 8 times a piece. The save and load times, the load's peak
    device memory above what was allocated before it and its host peak
    (``HostPeak``, which phase 17 prints beside the stream's)."""
    import numpy as np
    import torch
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import make_mesh
    idx, _, q, ss, si, _ = ox
    path = os.path.join(tmp, "ox105k")
    _, save_s = timed(lambda: idx.save(path, streaming=False))
    mesh = make_mesh(8, devices=["cuda:0"] * 8)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with HostPeak() as host:
        loaded, load_s = timed(lambda: Index.load(path, mesh=mesh))
    peak = torch.cuda.max_memory_allocated() - base
    parts = [sh.x for sh in loaded.placement.shards]
    if not loaded.placed or len(parts) != 8:
        fail("phase 15c: the loaded store is not placed in 8 shards")
    sidx = loaded.to_sharded(mesh)
    if any(sh.x.data_ptr() != p.data_ptr()
           for sh, p in zip(sidx.shards, parts)):
        fail("phase 15c: to_sharded copied the placed shards")
    (ls, li), counts = count_launches(lambda: loaded.search(q))
    pieces = -(-q.shape[0] // loaded.cfg.search.query_chunk)
    if counts["topk_matmul"] != 8 * pieces:
        fail(f"phase 15c: the placed search launched K1 "
             f"{counts['topk_matmul']} times, not {8 * pieces}")
    if not (np.array_equal(li, si.cpu().numpy())
            and np.array_equal(ls, ss.cpu().numpy())):
        fail("phase 15c: the placed index's answers differ from phase 9's")
    rs, ri, rc = loaded.search_range(q, res_b["tau"],
                                     max_results=L2_RANGE_M)
    ms, mi, mc = res_b["answer"]
    if not (np.array_equal(ri, mi) and np.array_equal(rs, ms)
            and np.array_equal(rc, mc)):
        fail("phase 15c: the placed range search differs from 15b's mesh "
             "answer")
    if not loaded.placed:
        fail("phase 15c: serving gathered the placed store")
    p50 = {b: p50_ms(lambda b=b: loaded.search(q[:b])) for b in (1, 8)}
    report(card, phase=15, part="c", rows=loaded.num_valid, shards=8,
           save_s=save_s, load_s=load_s,
           store_gb=sum(p.numel() * p.element_size() for p in parts) / 1e9,
           load_peak_device_gb_above_before=peak / 1e9,
           load_peak_host_bytes={"rss": host.rss, "traced": host.traced},
           equals_phase9=True, to_sharded_copies_nothing=True,
           search_p50_ms=p50, launches=counts["topk_matmul"])
    return {"launches": {"topk_matmul": counts["topk_matmul"]},
            "load_s": load_s, "peak_gb": peak / 1e9,
            "host_peak": {"rss": host.rss, "traced": host.traced}}


def phase15d(card, gen, tmp) -> dict:
    """Data-parallel extraction: a seeded ResNet-50 at 224 px in bf16
    (GeM p = 3) over ``make_mesh_2d(2, 1, devices=["cuda:0"] * 2)``, B =
    DP_BATCH, against the single-device ``Extractor`` with the same
    weights: every image's descriptor within FUSED_COS (cosine) of the
    single route's and its own top-1 among them (the two routes run the
    backbone at other batch sizes). Then ``Index.build(mesh=)`` over
    DP_BUILD seeded PNG files against ``Index.build`` on one device: ids
    and names equal, every row within FUSED_COS. Images/s of both routes,
    extraction alone and the whole build; ``default_data_mesh()`` is None
    on one card."""
    import torch
    from instsearch_torch import ExtractConfig, IndexConfig, PipelineConfig
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import default_data_mesh, make_mesh_2d
    if default_data_mesh() is not None:
        fail("phase 15d: default_data_mesh() on one card is not None")
    cfg = ExtractConfig(backbone="resnet50", pooling="gem", gem_p=3.0,
                        image_size=IMAGE, whiten=False, dtype="bfloat16",
                        batch_size=DP_BATCH)
    mesh = make_mesh_2d(2, 1, devices=["cuda:0"] * 2)
    single = Extractor(cfg, seed=0)
    dp = Extractor(cfg, seed=0, mesh=mesh)
    dp.model.load_state_dict(single.model.state_dict())
    if dp.dp_size != 2:
        fail(f"phase 15d: the extractor's data axis holds {dp.dp_size}")
    images = smooth_images(gen, DP_BUILD)

    def cosines(a, b):
        a = torch.nn.functional.normalize(a.float(), dim=1)
        b = torch.nn.functional.normalize(b.float(), dim=1)
        return (a * b).sum(1), (a @ b.T).argmax(1)

    a, b = dp(images[:DP_BATCH]), single(images[:DP_BATCH])
    cos, top1 = cosines(a, b)
    if (float(cos.min()) < FUSED_COS
            or not bool((top1 == torch.arange(DP_BATCH,
                                              device="cuda")).all())):
        fail(f"phase 15d: data-parallel descriptors against one device: "
             f"min cosine {float(cos.min())}")
    ips = {}
    for route, ex in (("data parallel", dp), ("one device", single)):
        ex(images[:DP_BATCH])
        _, sec = timed(lambda ex=ex: [ex(images[s:s + DP_BATCH]) for s in
                                      range(0, DP_BUILD, DP_BATCH)])
        ips[route] = DP_BUILD / sec
    paths = write_png(images, os.path.join(tmp, "dp"), "img")
    pcfg = PipelineConfig(extract=cfg, index=IndexConfig(dtype="bfloat16"))
    built, build_ips = {}, {}
    for route, kw in (("data parallel", {"mesh": mesh}), ("one device", {})):
        built[route], sec = timed(lambda kw=kw: Index.build(paths, pcfg,
                                                            seed=0, **kw))
        build_ips[route] = DP_BUILD / sec
    got, want = built["data parallel"], built["one device"]
    bcos, _ = cosines(got.descriptors[:got.num_valid].float(),
                      want.descriptors[:want.num_valid].float())
    if (got.names != want.names or not torch.equal(got.ids, want.ids)
            or float(bcos.min()) < FUSED_COS):
        fail("phase 15d: Index.build(mesh=) differs from Index.build")
    report(card, phase=15, part="d", backbone="resnet50", image=IMAGE,
           dtype="bfloat16", batch=DP_BATCH, mesh="data 2 x shard 1 on "
           "cuda:0", min_cosine=float(cos.min()),
           build_min_cosine=float(bcos.min()), images=DP_BUILD,
           extract_images_per_s=ips, build_images_per_s=build_ips,
           ids_equal=True)
    return {"launches": {}, "extract_ips": ips, "build_ips": build_ips}


MP_BATCH = 16           # phase 16a/b: images through the TP and PP routes
SP_SIZE = 1024          # phase 16c: side of the SP route's images (4,097
SP_BATCH = 4            # tokens, padded to 4,100 over 4 shards)
MP_REL = 1e-4           # phase 16: f32 patch maps, relative to max |ref|


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def gem_cosines(cfg, a, b):
    """Per-image cosine of the GeM descriptors of two patch-map batches."""
    from instsearch_torch.ops import l2_normalize, pool
    da = l2_normalize(pool(a, cfg).float(), axis=-1)
    db = l2_normalize(pool(b, cfg).float(), axis=-1)
    return (da * db).sum(-1)


def images_per_s(fn, batch: int) -> float:
    return batch / cuda_median_ms(fn, reps=5, warmup=1) * 1e3


def peak_gb(fn) -> float:
    """Device memory one call of ``fn`` allocated at its peak above what
    was allocated before it."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def mp_models(name: str, gen, size: int):
    """A seeded ViT in bf16 (the plain attention route) at ``size`` px, its
    f32 twin with the same weights, and the config of their GeM."""
    import torch
    from instsearch_torch import ExtractConfig
    from instsearch_torch.models import get_backbone
    cfg = ExtractConfig(backbone=name, pooling="gem", gem_p=3.0,
                        image_size=size, whiten=False, dtype="bfloat16",
                        batch_size=MP_BATCH)
    model = get_backbone(name, attention="xla")[0].init_weights(gen)
    f32 = get_backbone(name, dtype=torch.float32, attention="xla")[0]
    f32.load_state_dict(model.state_dict())
    return cfg, model, f32


def check_route(card, part, cfg, route, got_bf16, want_bf16, got_f32,
                want_f32, **fields) -> dict:
    cos = gem_cosines(cfg, got_bf16, want_bf16)
    err = rel_err(got_f32, want_f32)
    if float(cos.min()) < FUSED_COS or err > MP_REL:
        fail(f"phase 16{part} {route}: GeM cosine {float(cos.min())} "
             f"(bar {FUSED_COS}), f32 patch maps {err} of max |ref| (bar "
             f"{MP_REL})")
    out = {"route": route, "min_cosine_bf16": float(cos.min()),
           "f32_rel_err": err, **fields}
    report(card, phase=16, part=part, devices="cuda:0 repeated (one card)",
           **out)
    return out


# phase 16d: the group form the multi-process routes run in on one card.
# tools/cuda_group_probe.py on the H100 (torch 2.11, NCCL 2.28.9): two
# processes on cuda:0 over gloo run all_reduce, all_gather and broadcast on
# CUDA tensors but not all_to_all (SP) nor isend/recv (PP); NCCL refuses
# two ranks on one device ("Duplicate GPU detected"). So (d) runs one
# process as an NCCL group of one (world_of_one), through the same code
# path as a world of many: every line of every mesh has its subgroup and
# every cross-process step its collective.
MP_GROUP_FORM = "NCCL group of one process (world_of_one)"


def phase16(card: str, gen) -> dict:
    """The model-parallel ViT forwards (ROADMAP M11) at published widths,
    every mesh position on cuda:0: (a) tensor parallel, ViT-L/16 at 224
    px, B = 16, through ``Extractor(mesh=make_mesh_dp_tp(1, 4))`` and
    ``(2, 2)``, and ViT-B/16 at tp = 8 (12 heads: the gathered attention),
    the split layers' bytes a shard printed; (b) the GPipe pipeline,
    ViT-L/16, 4 stages, ``n_micro`` 4, B = 16, on a ``'pipe'`` mesh and on
    ``('data', 'pipe')`` = (2, 2); (c) sequence parallel, ViT-B/16 at
    1024 px (4,097 tokens, padded to 4,100), B = 4, sp = 4 and ``('data',
    'seq')`` = (2, 2), with the peak device memory of one forward beside
    the meshless forward's; (d) each of those meshes again as a mesh over
    a process group (``MP_GROUP_FORM``): the multi-process routes, every
    cross-process step a collective (TP's all_reduce and all_gather, PP's
    broadcast, SP's two all_to_alls a block, the data axis's all_gather),
    their images/s beside the one-process route's. Each route against the
    meshless model on the same weights: bf16 GeM descriptors' cosine >=
    FUSED_COS, f32 patch maps within MP_REL of max |ref| (TF32 off).
    Images/s of each route and of the meshless forward: single runs on one
    card, the devices repeated, so they say nothing of several cards. No
    kernel launches (the split heads attend on the plain route)."""
    out, counts = count_launches(lambda: _phase16(card, gen))
    if any(counts.values()):
        fail(f"phase 16 launched {counts}")
    return out


def _phase16(card, gen) -> dict:
    import torch
    from instsearch_torch.data import frontend
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.parallel import (ShardMesh, make_device_mesh,
                                           pipelined_vit_fn, place_pp,
                                           place_sp, place_tp,
                                           sequence_parallel_vit_fn)
    from instsearch_torch.parallel.mesh import axis_groups
    from instsearch_torch.parallel.tp import (TensorParallelViT,
                                              split_layer_bytes)
    t_phase = time.perf_counter()
    cuda = torch.device("cuda:0")
    res = {"a": [], "b": [], "c": [], "d": []}
    images = torch.as_tensor(smooth_images(gen, MP_BATCH), device=cuda)
    x16 = frontend.normalize(images, dtype=torch.bfloat16)
    x32 = frontend.normalize(images, dtype=torch.float32)

    with world_of_one() as dist, torch.no_grad():
        world = dist.group.WORLD
        report(card, phase=16, part="d", group_form=MP_GROUP_FORM,
               backend=str(dist.get_backend()),
               world_size=dist.get_world_size())

        def grid(shape, names, group=None):
            return make_device_mesh(shape, names, [cuda] * (shape[0]
                                                            * shape[1]),
                                    group)

        # (a) tensor parallel through the Extractor; (d) over the group
        for name, meshes in (("vit_l_16", ((1, 4), (2, 2))),
                             ("vit_b_16", ((1, 8),))):
            cfg, model, f32 = mp_models(name, gen, IMAGE)
            single = Extractor(cfg, model.state_dict())
            want16, want32 = model(x16), f32(x32)
            base = images_per_s(lambda: single(images), MP_BATCH)
            for data, tp in meshes:
                one_ips = None
                for group in (None, world):
                    part = "a" if group is None else "d"
                    mesh = grid((data, tp), ("data", "model"), group)
                    ex = Extractor(cfg.replace(vit_attention="flash"),
                                   model.state_dict(), mesh=mesh)
                    if ex.cfg.vit_attention != "xla" or ex.dp_size != data:
                        fail(f"phase 16{part}: {ex.cfg.vit_attention}, "
                             f"{ex.dp_size} data positions")
                    desc = torch.nn.functional.cosine_similarity(
                        ex(images), single(images), dim=-1)
                    if float(desc.min()) < FUSED_COS:
                        fail(f"phase 16{part} {name} {data}x{tp}: Extractor"
                             f" descriptors' cosine {float(desc.min())}")
                    line = axis_groups(mesh, "model")[0]
                    if (line.group is None) != (group is None):
                        fail(f"phase 16{part}: the model line's group is "
                             f"{line.group}")
                    got16 = TensorParallelViT(model, line)(x16)
                    got32 = TensorParallelViT(f32, line)(x32)
                    sizes = split_layer_bytes(place_tp(mesh, model=model)[0])
                    if sizes["shard_bytes"] != [sizes["whole_bytes"]
                                                // tp] * tp:
                        fail(f"phase 16{part}: split layers' bytes {sizes}")
                    ips = images_per_s(lambda: ex(images), MP_BATCH)
                    fields = {} if group is None else {
                        "one_process_images_per_s": one_ips,
                        "group_form": MP_GROUP_FORM}
                    res[part].append(check_route(
                        card, part, cfg, f"tp {name} data {data} x model "
                        f"{tp}", got16, want16, got32, want32,
                        batch=MP_BATCH, image=IMAGE, heads=model.num_heads,
                        head_split=model.num_heads % tp == 0,
                        extractor_min_cosine=float(desc.min()),
                        split_layer_bytes_per_shard=sizes["shard_bytes"][0],
                        split_layer_bytes_whole=sizes["whole_bytes"],
                        images_per_s=ips, meshless_images_per_s=base,
                        **fields))
                    one_ips = ips
                    del ex
            if name == "vit_l_16":
                vit_l = (cfg, model, f32, want16, want32)
            del single
        # (b) the GPipe pipeline, ViT-L/16; (d) over the group
        cfg, model, f32, want16, want32 = vit_l
        base = images_per_s(lambda: model(x16), MP_BATCH)
        one_ips = {}
        for group in (None, world):
            part = "b" if group is None else "d"
            for mesh in (ShardMesh((cuda,) * 4, group, "pipe"),
                         grid((2, 2), ("data", "pipe"), group)):
                fwd16 = pipelined_vit_fn(model, mesh, n_micro=4)
                p16 = place_pp(mesh, model)
                got16 = fwd16(*p16, x16)
                got32 = pipelined_vit_fn(f32, mesh, n_micro=4)(
                    *place_pp(mesh, f32), x32)
                route = f"pp vit_l_16 {mesh.shape}"
                ips = images_per_s(lambda: fwd16(*p16, x16), MP_BATCH)
                fields = {} if group is None else {
                    "one_process_images_per_s": one_ips[route],
                    "group_form": MP_GROUP_FORM}
                res[part].append(check_route(
                    card, part, cfg, route, got16, want16, got32, want32,
                    batch=MP_BATCH, image=IMAGE, n_micro=4,
                    images_per_s=ips, meshless_images_per_s=base, **fields))
                one_ips[route] = ips
        del vit_l, model, f32, want16, want32
        torch.cuda.empty_cache()
        # (c) sequence parallel, ViT-B/16 at 1024 px; (d) over the group
        cfg, model, f32 = mp_models("vit_b_16", gen, SP_SIZE)
        hi = torch.as_tensor(smooth_images(gen, SP_BATCH, size=SP_SIZE),
                             device=cuda)
        h16 = frontend.normalize(hi, dtype=torch.bfloat16)
        h32 = frontend.normalize(hi, dtype=torch.float32)
        want16, want32 = model(h16), f32(h32)
        tokens = (SP_SIZE // model.patch_size) ** 2 + 1
        base = images_per_s(lambda: model(h16), SP_BATCH)
        base_gb = peak_gb(lambda: model(h16))
        one_ips = {}
        for group in (None, world):
            part = "c" if group is None else "d"
            for mesh in (ShardMesh((cuda,) * 4, group, "seq"),
                         grid((2, 2), ("data", "seq"), group)):
                fwd16 = sequence_parallel_vit_fn(model, mesh)
                p16 = place_sp(mesh, model=model)
                got16 = fwd16(p16, h16)
                got32 = sequence_parallel_vit_fn(f32, mesh)(
                    place_sp(mesh, model=f32), h32)
                route = f"sp vit_b_16 {mesh.shape}"
                ips = images_per_s(lambda: fwd16(p16, h16), SP_BATCH)
                fields = {} if group is None else {
                    "one_process_images_per_s": one_ips[route],
                    "group_form": MP_GROUP_FORM}
                res[part].append(check_route(
                    card, part, cfg, route, got16, want16, got32, want32,
                    batch=SP_BATCH, image=SP_SIZE, tokens=tokens,
                    padded_tokens=-(-tokens // 4) * 4, images_per_s=ips,
                    meshless_images_per_s=base,
                    peak_gb=peak_gb(lambda: fwd16(p16, h16)),
                    meshless_peak_gb=base_gb, **fields))
                one_ips[route] = ips
        del model, f32, want16, want32
    torch.cuda.empty_cache()
    report(card, phase=16, seconds=time.perf_counter() - t_phase)
    return res


PERSIST_SLACK = 64 << 20   # phase 17: host bytes allowed above 2 shards


class HostPeak:
    """The host memory a block takes: ``rss`` is the peak of the process's
    resident set (``VmRSS`` of /proc/self/status, sampled every 0.5 ms by a
    thread) above its level at entry, mapped file pages included;
    ``traced`` the peak of ``tracemalloc`` (numpy's buffers) over the
    block. Both in bytes."""

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def __enter__(self):
        import threading
        import tracemalloc
        self.base = self.top = self._rss()
        self._stop = threading.Event()

        def sample():
            while not self._stop.is_set():
                self.top = max(self.top, self._rss())
                time.sleep(0.0005)
        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        tracemalloc.start()
        return self

    def __exit__(self, *exc):
        import tracemalloc
        self.traced = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        self._stop.set()
        self._thread.join()
        self.rss = max(self.top, self._rss()) - self.base
        return False


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(base, f))
               for base, _, files in os.walk(path) for f in files)


def saved_arrays(path: str) -> dict:
    """An index directory's arrays as numpy, name -> array, whichever form
    ``Index.save`` chose (bf16 rows of the stream as their bits)."""
    import numpy as np
    from instsearch_torch.utils.checkpoint import open_tree
    with open(os.path.join(path, "meta.json")) as f:
        fmt = json.load(f)["format"]
    if fmt == "npz":
        npz = np.load(os.path.join(path, "index.npz"))
        return {k: npz[k] for k in npz.files}
    return {k: leaf[...] for k, leaf in
            open_tree(os.path.join(path, "store")).items()}


def phase17(card, ox, corpus, npz_peak: int, tmp: str) -> dict:
    """Persistence at scale (ROADMAP Queue 1 items 4 and 5): the port's
    stream (``Index.save`` with ``streaming=None``, ``store/`` a sharded
    tree of ``utils/checkpoint.py``). (a) Phase 9's store (workload 4:
    105,133 x 2048 bf16, 106,496 padded rows) saved, loaded with
    ``make_mesh(8, devices=["cuda:0"] * 8)`` and saved again from the
    placed store: the placed ``search`` equal to phase 9's answers bit for
    bit with K1 8 times a piece; the host's peak memory (``HostPeak``)
    during the placed load and the placed save at most 2 x one shard's
    bytes + PERSIST_SLACK, printed beside phase 15c's npz load's. (b)
    Phase 3's int8 and int4 stores (1M x 512, the presets' αQE) rebuilt
    from its rows, saved as the stream and loaded back: the stores equal
    and K2/K3's answers equal the in-memory store's bit for bit, with the
    same launches. save_s, load_s and bytes on disk are printed, not
    bound. The three streams stay in ``tmp`` (the caller's temporary
    folder) for phase 18. Returns the loaded stores' K1-K3 launches
    (``launches_persist``) and the streams' paths."""
    import shutil
    import numpy as np
    import torch
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import make_mesh
    t_phase = time.perf_counter()
    launches, streams = {}, {}
    idx, _, q, ss, si, _ = ox
    first = os.path.join(tmp, "ox105k")
    with HostPeak() as save_peak:
        _, save_s = timed(lambda: idx.save(first))
    with open(os.path.join(first, "meta.json")) as f:
        fmt = json.load(f)["format"]
    if fmt != Index.STREAM_FORMAT:
        fail(f"phase 17: streaming=None wrote {fmt!r} for a "
             f"{idx.descriptors.numel() * 2 / 1e9:.2f} GB store")
    mesh = make_mesh(8, devices=["cuda:0"] * 8)
    with HostPeak() as load_peak:
        loaded, load_s = timed(lambda: Index.load(
            first, extractor=idx.extractor, mesh=mesh))
    parts = [sh.x for sh in loaded.placement.shards]
    shard = parts[0].numel() * parts[0].element_size()
    if not loaded.placed or len(parts) != 8 or not torch.equal(
            torch.cat(parts), idx.descriptors):
        fail("phase 17: the placed stream is not phase 9's store in 8 "
             "shards")
    (ls, li), counts = count_launches(lambda: loaded.search(q))
    pieces = -(-q.shape[0] // loaded.cfg.search.query_chunk)
    if counts["topk_matmul"] != 8 * pieces:
        fail(f"phase 17: the placed search launched K1 "
             f"{counts['topk_matmul']} times, not {8 * pieces}")
    if not (np.array_equal(li, si.cpu().numpy())
            and np.array_equal(ls, ss.cpu().numpy())):
        fail("phase 17: the placed stream's answers differ from phase "
             "9's")
    launches["topk_matmul"] = counts["topk_matmul"]
    again = os.path.join(tmp, "ox105k_again")
    with HostPeak() as psave_peak:
        _, psave_s = timed(lambda: loaded.save(again))
    if not loaded.placed:
        fail("phase 17: saving the placed store gathered it")
    a, b = saved_arrays(first), saved_arrays(again)
    if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                       for k in a):
        fail("phase 17: the placed save differs from the first save")
    del a, b
    limit = 2 * shard + PERSIST_SLACK
    for what, peak in (("placed load", load_peak),
                       ("placed save", psave_peak)):
        if max(peak.rss, peak.traced) > limit:
            fail(f"phase 17: the {what} took {peak.rss} host bytes "
                 f"(RSS) and {peak.traced} (traced), above 2 x "
                 f"{shard} + {PERSIST_SLACK}")
    report(card, phase=17, part="a", rows=loaded.num_valid,
           padded_rows=loaded.n_pad, shards=8, shard_bytes=shard,
           format=fmt, disk_bytes=dir_bytes(first), save_s=save_s,
           load_s=load_s, placed_save_s=psave_s,
           host_peak_bytes={
               "save_unplaced": {"rss": save_peak.rss,
                                 "traced": save_peak.traced},
               "placed_load": {"rss": load_peak.rss,
                               "traced": load_peak.traced},
               "placed_save": {"rss": psave_peak.rss,
                               "traced": psave_peak.traced},
               "npz_placed_load_phase15c": npz_peak},
           host_peak_limit_bytes=limit, equals_phase9=True,
           launches=counts["topk_matmul"])
    del loaded, parts
    streams["ox"] = first
    shutil.rmtree(again, ignore_errors=True)
    torch.cuda.empty_cache()

    cfg4, rows, names, ex, images, picks = corpus
    cfg8 = PipelineConfig.load(os.path.join(HERE, "configs",
                                            "million_scale_int8.json"))
    q3 = ex(images[np.concatenate(picks)])
    for kind, cfg, kernel in (("int8", cfg8, "topk_matmul_int8"),
                              ("int4", cfg4, "topk_matmul_int4")):
        mem = Index.from_descriptors(rows, names, cfg, extractor=ex)
        (ms, mi), want = count_launches(lambda: mem.search(q3))
        path = os.path.join(tmp, kind)
        _, save_s = timed(lambda: mem.save(path))
        with open(os.path.join(path, "meta.json")) as f:
            fmt = json.load(f)["format"]
        back, load_s = timed(lambda: Index.load(path, extractor=ex))
        if fmt != Index.STREAM_FORMAT or not (
                torch.equal(back.descriptors, mem.descriptors)
                and torch.equal(back.scales, mem.scales)
                and torch.equal(back.ids, mem.ids)):
            fail(f"phase 17: the {kind} stream ({fmt}) loaded another "
                 f"store")
        (bs, bi), got = count_launches(lambda: back.search(q3))
        if got != want or got[kernel] == 0:
            fail(f"phase 17: {kind} launches {got}, in memory {want}")
        if not (np.array_equal(bi, mi) and np.array_equal(bs, ms)):
            fail(f"phase 17: the loaded {kind} store's answers differ")
        launches[kernel] = got[kernel]
        report(card, phase=17, part="b", store=kind, rows=back.num_valid,
               format=fmt, disk_bytes=dir_bytes(path), save_s=save_s,
               load_s=load_s, answers_equal=True, queries=int(
                   mi.shape[0]), launches=got[kernel])
        del mem, back
        streams[kind] = path
        torch.cuda.empty_cache()
    report(card, phase=17, seconds=time.perf_counter() - t_phase,
           launches=launches)
    return {"launches": launches, "streams": streams}


PLACED_REMOVE = 512     # phase 18a: names removed, 64 on each shard
PLACED_ADD = 1024       # phase 18a/b: seeded unit rows added
PLACED_DONOR = 256      # phase 18a: rows of the placed donor merged
PLACED_INT_REMOVE = 2048   # phase 18b: names removed from the int8/int4 stores
PLACED_SLACK = 64 << 20    # phase 18a: device bytes allowed above one shard
PLACED_BATCHES = (1, 8, 128)


def spread_names(idx, n: int, seed: int) -> list:
    """``n`` names of ``idx`` spread over its shards' valid rows (as many
    from each, the last valid rows of the tail among them), by a seeded
    generator."""
    import numpy as np
    sidx = idx.placement
    c, shards = sidx.rows_per_shard, len(sidx.shards)
    rng = np.random.default_rng(seed)
    tail = list(range(idx.num_valid - 8, idx.num_valid))
    pos = set(tail)
    for j in range(shards):
        lo, hi = j * c, min((j + 1) * c, idx.num_valid)
        want = (n - len(tail)) // shards + (j < (n - len(tail)) % shards)
        pool = np.setdiff1d(np.arange(lo, hi), tail)
        pos.update(rng.choice(pool, size=want, replace=False).tolist())
    return [idx.names[p] for p in sorted(pos)]


def device_growth(fn):
    """``fn()`` -> (result, seconds, the peak of device memory allocated
    during it above the level before it, in bytes)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, sec = timed(fn)
    return out, sec, torch.cuda.max_memory_allocated() - base


@contextlib.contextmanager
def refusing_gather(*indexes):
    """``Index.gather`` raising on these instances for the block."""
    def refuse():
        raise RuntimeError("the placed store was gathered")
    for idx in indexes:
        idx.gather = refuse
    try:
        yield
    finally:
        for idx in indexes:
            del idx.gather


def placed_against_twin(tag, placed, twin, mesh, batches, kernel) -> int:
    """The placed parts equal to the twin's store bit for bit, ids and names
    equal, and each batch's answers equal to the twin's through the same
    8-shard route bit for bit, ``kernel`` launched by the placed search as
    often as by the twin's route and at least 8 times a piece -> the placed
    searches' launches of ``kernel``."""
    import numpy as np
    import torch
    parts = torch.cat([sh.x for sh in placed.placement.shards])
    if not (parts.shape == twin.descriptors.shape and torch.equal(
            parts.view(torch.uint8), twin.descriptors.view(torch.uint8))):
        fail(f"phase 18: {tag}: the placed parts differ from the twin's "
             f"store")
    del parts
    if twin.scales is not None and not torch.equal(
            torch.cat([sh.scales for sh in placed.placement.shards], 1),
            twin.scales):
        fail(f"phase 18: {tag}: the placed scales differ")
    if not (torch.equal(placed.ids, twin.ids) and placed.names == twin.names):
        fail(f"phase 18: {tag}: ids or names differ from the twin's")
    counts = [sh.num_valid for sh in placed.placement.shards]
    c = placed.placement.rows_per_shard
    if counts != [max(0, min(twin.num_valid - j * c, c))
                  for j in range(len(counts))]:
        fail(f"phase 18: {tag}: shard valid counts {counts}")
    tsidx = twin.to_sharded(mesh=mesh)
    launches = 0
    for qb in batches:
        (ps, pi), got = count_launches(lambda: placed.search(qb))
        (ts, ti), want = count_launches(
            lambda: twin.search_sharded(tsidx, twin._match_query_dim(qb)))
        pieces = -(-qb.shape[0] // placed.cfg.search.query_chunk)
        if got != want or got[kernel] < 8 * pieces:
            fail(f"phase 18: {tag}: B={qb.shape[0]} launches {got}, the "
                 f"twin's {want}")
        if not (np.array_equal(pi, ti) and np.array_equal(ps, ts)):
            fail(f"phase 18: {tag}: B={qb.shape[0]} answers differ from the "
                 f"twin's")
        launches += got[kernel]
    return launches


def phase18(card, ox, ex, streams) -> dict:
    """Mutating a placed store where it lies (ROADMAP Queue 1 item 3), right
    after phase 17 on its streams. (a) Phase 9's store (105,133 x 2048 bf16
    in 106,496 padded rows) loaded placed on 8 shards of cuda:0 and, the
    twin, unplaced; with ``Index.gather`` refusing on the placed indexes:
    ``remove`` of PLACED_REMOVE names (every shard, the tail included),
    ``add`` of PLACED_ADD seeded unit rows, ``merge_from`` a PLACED_DONOR-row
    donor loaded placed. After each: the parts equal the twin's store bit
    for bit, ids and names equal, search at B = 1, 8, 128 equal to the
    twin's through the same 8-shard route bit for bit (K1 8 times a piece);
    the device memory's peak growth over each placed operation at most one
    shard's bytes + PLACED_SLACK (a gather takes the whole store). Each
    added row must be its own top-1 (within BF16_TIE) and no removed name
    may come back. (b) Phase 17's int8 and int4 streams (1M x 512) loaded
    placed and unplaced, with phase 3's extractor ``ex``: ``remove`` of
    PLACED_INT_REMOVE names, ``add`` of PLACED_ADD rows, K2/K3 answers
    equal to the twin's bit for bit.
    add_s, remove_s and merge_s of both are printed, not bound. Returns the
    placed searches' K1-K3 launches (``launches_placed``)."""
    import numpy as np
    import torch
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import make_mesh
    t_phase = time.perf_counter()
    idx, _, q, _, _, _ = ox
    mesh = make_mesh(8, devices=["cuda:0"] * 8)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    launches = {}

    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device="cuda")
        return x / x.norm(dim=1, keepdim=True)

    def batches(pool):
        return [pool[:b] for b in PLACED_BATCHES]

    placed = Index.load(streams["ox"], extractor=idx.extractor, mesh=mesh)
    twin = Index.load(streams["ox"], extractor=idx.extractor,
                      device="cuda:0")
    shard = (placed.placement.shards[0].x.numel()
             * placed.placement.shards[0].x.element_size())
    pool = q.repeat(-(-128 // q.shape[0]), 1)[:128]
    removed = spread_names(placed, PLACED_REMOVE, 18)
    removed_rows = twin.reconstruct(names=removed[:128])
    added = unit(PLACED_ADD, placed.dim)
    added_names = [f"placed_add{i}" for i in range(PLACED_ADD)]
    donor_rows = unit(PLACED_DONOR, placed.dim)
    donor_path = os.path.join(os.path.dirname(streams["ox"]), "donor")
    Index.from_descriptors(donor_rows, [f"placed_donor{i}" for i in range(
        PLACED_DONOR)], placed.cfg, device="cuda:0").save(donor_path)
    donor = Index.load(donor_path, mesh=mesh)
    twin_donor = Index.load(donor_path, device="cuda:0")
    ops = (("remove", lambda i: i.remove(removed)),
           ("add", lambda i: i.add(descriptors=added, names=added_names)),
           ("merge", lambda i: i.merge_from(
               donor if i is placed else twin_donor)))
    res, n1 = {}, 0
    for op, fn in ops:
        with refusing_gather(placed, donor):
            got, sec, grown = device_growth(lambda: fn(placed))
        want, twin_sec = timed(lambda: fn(twin))
        if got != want or not placed.placed or not donor.placed:
            fail(f"phase 18a: {op} gave {got} (placed: {placed.placed}), "
                 f"the twin {want}")
        if grown > shard + PLACED_SLACK:
            fail(f"phase 18a: the placed {op} grew device memory by {grown} "
                 f"bytes, above one shard ({shard}) + {PLACED_SLACK}")
        with refusing_gather(placed):
            n1 += placed_against_twin(f"18a {op}", placed, twin, mesh,
                                      batches(pool), "topk_matmul")
        res[op] = {"placed_s": sec, "twin_s": twin_sec,
                   "placed_peak_growth_bytes": grown}
    with refusing_gather(placed):
        (s, i), _ = count_launches(lambda: placed.search(removed_rows))
        names = {placed.name_of(j) for j in i.reshape(-1) if j >= 0}
        if names & set(removed):
            fail("phase 18a: a removed name came back")
        (s, i), _ = count_launches(lambda: placed.search(added))
    own = placed.ids[placed.num_valid - PLACED_DONOR - PLACED_ADD:
                     placed.num_valid - PLACED_DONOR].cpu().numpy()
    hit = i == own[:, None]
    if not (hit.any(axis=1) & (s[:, 0] - np.where(hit, s, -np.inf).max(
            axis=1) <= BF16_TIE)).all():
        fail("phase 18a: an added row is not its own top-1")
    launches["topk_matmul"] = n1
    report(card, phase=18, part="a", rows=placed.num_valid,
           padded_rows=placed.n_pad, shards=8, shard_bytes=shard,
           store_bytes=shard * 8, removed=len(removed), added=PLACED_ADD,
           merged=PLACED_DONOR, placed_gathered=False,
           add_s=res["add"]["placed_s"], remove_s=res["remove"]["placed_s"],
           merge_s=res["merge"]["placed_s"],
           twin_add_s=res["add"]["twin_s"],
           twin_remove_s=res["remove"]["twin_s"],
           twin_merge_s=res["merge"]["twin_s"],
           peak_growth_bytes={op: r["placed_peak_growth_bytes"]
                              for op, r in res.items()},
           peak_growth_limit_bytes=shard + PLACED_SLACK,
           equal_to_twin=True, launches=n1)
    del placed, twin, donor, twin_donor
    torch.cuda.empty_cache()

    for kind, kernel in (("int8", "topk_matmul_int8"),
                         ("int4", "topk_matmul_int4")):
        placed = Index.load(streams[kind], extractor=ex, mesh=mesh)
        twin = Index.load(streams[kind], extractor=ex, device="cuda:0")
        removed = spread_names(placed, PLACED_INT_REMOVE, 180)
        added = unit(PLACED_ADD, placed.dim)
        names = [f"placed_{kind}_add{i}" for i in range(PLACED_ADD)]
        out = {}
        for op, fn in (("remove", lambda i: i.remove(removed)),
                       ("add", lambda i: i.add(descriptors=added,
                                               names=names))):
            with refusing_gather(placed):
                _, sec, grown = device_growth(lambda: fn(placed))
            _, twin_sec = timed(lambda: fn(twin))
            out[op] = (sec, twin_sec, grown)
        pool = torch.cat([added[:64], torch.as_tensor(twin.reconstruct(
            names=twin.names[:64]), device="cuda")])
        with refusing_gather(placed):
            n = placed_against_twin(f"18b {kind}", placed, twin, mesh,
                                    batches(pool), kernel)
        launches[kernel] = n
        report(card, phase=18, part="b", store=kind, rows=placed.num_valid,
               removed=len(removed), added=PLACED_ADD,
               remove_s=out["remove"][0], add_s=out["add"][0],
               twin_remove_s=out["remove"][1], twin_add_s=out["add"][1],
               peak_growth_bytes={op: v[2] for op, v in out.items()},
               placed_gathered=False, equal_to_twin=True, launches=n)
        del placed, twin
        torch.cuda.empty_cache()
    report(card, phase=18, seconds=time.perf_counter() - t_phase,
           launches=launches)
    return {"launches": launches}


PLACED_TIER_SAMPLE = 65_536   # phase 19: rows the views' fits read
PLACED_TIER_ITERS = 4         # phase 19: k-means and PQ iterations a fit
PLACED_TIER_SUBSET = 10       # phase 19: every 10th name in the PQ subset


def view_arrays(idx, view: str) -> dict:
    """A candidate tier's view (``idx.pq``, ``idx.ivf`` or ``idx.ivfpq``)
    as its arrays by name (None where absent)."""
    v = getattr(idx, view)
    if view == "pq":
        return {"centroids": v.codebook.centroids, "packed": v.packed,
                "rotation": v.rotation}
    if view == "ivf":
        return v._state()
    return {"centroids": v.centroids, "codes": v.codes,
            "bucket_pos": v.bucket_pos, "spill_codes": v.spill_codes,
            "spill_pos": v.spill_pos, "spill_cluster": v.spill_cluster,
            "pq_centroids": v.codebook.centroids, "rotation": v.rotation}


def same_bits(a, b) -> bool:
    """Two numpy arrays or two tensors equal byte for byte (so scores
    compare as f32 bits), with the same shape and dtype."""
    import numpy as np
    import torch
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and (not a.numel() or torch.equal(
                    a.contiguous().view(torch.uint8),
                    b.contiguous().view(torch.uint8))))
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def phase19(card, corpus, streams) -> dict:
    """Searching a placed store through its armed candidate tier where it
    lies (ROADMAP Queue 1 item 2, F9), right after phase 18 on phase 17's
    int8 and int4 streams (1M x 512). Each store is loaded placed on 8
    shards of cuda:0 and, the twin, unplaced, with ``Index.gather``
    refusing on the placed index; a view is fitted on both with the same
    seed and sample (PLACED_TIER_SAMPLE rows, PLACED_TIER_ITERS
    iterations: PQ and, on a second pair, IVF-PQ over int4, IVF over int8)
    and must be equal bit for bit. Then at B = 1, 8, 128 the tier alone,
    with the presets' αQE and, for the PQ cascade, under a subset (every
    PLACED_TIER_SUBSET-th name): ids and scores (as f32 bits) equal to the
    twin's, the store still placed, every kernel launched as often as by
    the twin (K4 at least once a piece on the PQ cascade), and the
    device's peak growth over the placed search at most the twin's plus
    PLACED_SLACK (a gather would take the whole 256 MB or 512 MB store).
    The int4 PQ cascade runs once more through an NCCL group of one process
    (``world_of_one``), whose placed store reads its candidates' rows
    through the collective ``ShardedIndex.read_rows``. The p50s of placed
    against twin are printed, not bound. Returns the placed tier searches'
    K4 launches (``launches_placed_tier``)."""
    import numpy as np
    import torch
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import make_mesh
    t_phase = time.perf_counter()
    _, _, _, ex, images, picks = corpus
    mesh = make_mesh(8, devices=["cuda:0"] * 8)
    fits = {"pq": lambda i: i.build_pq(sample=PLACED_TIER_SAMPLE,
                                       iters=PLACED_TIER_ITERS),
            "ivfpq": lambda i: i.build_ivfpq(
                sample=PLACED_TIER_SAMPLE, kmeans_iters=PLACED_TIER_ITERS,
                pq_iters=PLACED_TIER_ITERS),
            "ivf": lambda i: i.build_ivf(sample=PLACED_TIER_SAMPLE,
                                         iters=PLACED_TIER_ITERS)}
    q3 = torch.as_tensor(ex(images[np.concatenate(picks)]),
                         device="cuda").float()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    launches, groups = 0, 0

    def against_twin(tag, placed, twin, scfg, qb, sub=None):
        """One placed search against the twin's -> the placed launches."""
        kw_p = {} if sub is None else {"subset": sub[0]}
        kw_t = {} if sub is None else {"subset": sub[1]}
        with refusing_gather(placed):
            ((ps, pi), got), _, grown = device_growth(
                lambda: count_launches(lambda: placed.search(qb, scfg,
                                                             **kw_p)))
        ((ts, ti), want), _, twin_grown = device_growth(
            lambda: count_launches(lambda: twin.search(qb, scfg, **kw_t)))
        pieces = -(-qb.shape[0] // scfg.query_chunk)
        if got != want or (scfg.pq_depth and got["pq_topk"] < pieces):
            fail(f"phase 19: {tag}: launches {got}, the twin's {want}")
        if not (same_bits(pi, ti) and same_bits(ps, ts)):
            fail(f"phase 19: {tag}: the answers differ from the twin's")
        if not placed.placed:
            fail(f"phase 19: {tag}: the placed store was gathered")
        if grown > twin_grown + PLACED_SLACK:
            fail(f"phase 19: {tag}: the placed search grew device memory "
                 f"by {grown} bytes, the twin's by {twin_grown} (+ "
                 f"{PLACED_SLACK} allowed)")
        return got["pq_topk"], grown, twin_grown

    for kind, view in (("int4", "pq"), ("int4", "ivfpq"), ("int8", "ivf")):
        placed = Index.load(streams[kind], extractor=ex, mesh=mesh)
        twin = Index.load(streams[kind], extractor=ex, device="cuda:0")
        store = sum(sh.x.numel() * sh.x.element_size()
                    for sh in placed.placement.shards)
        with refusing_gather(placed):
            _, fit_s = timed(lambda: fits[view](placed))
        _, twin_fit_s = timed(lambda: fits[view](twin))
        a, b = view_arrays(placed, view), view_arrays(twin, view)
        differ = [k for k in a if not same_bits(a[k], b[k])]
        if differ or not placed.placed:
            fail(f"phase 19: the {view} view fitted on the placed {kind} "
                 f"store differs from the twin's in {differ} (placed: "
                 f"{placed.placed})")
        near = torch.as_tensor(twin.reconstruct(
            names=twin.names[::twin.num_valid // 96][:96]), device="cuda")
        near = near + 0.05 * torch.randn(near.shape, generator=gen,
                                         device="cuda")
        pool = torch.cat([q3, near / near.norm(dim=1, keepdim=True)])[:128]
        plain = twin.cfg.search.replace(qe_enabled=False)
        variants = {"tier": plain, "qe": plain.replace(qe_enabled=True)}
        sub = None
        if view == "pq":
            members = twin.names[::PLACED_TIER_SUBSET]
            sub = (placed.make_subset(names=members),
                   twin.make_subset(names=members))
            variants["subset"] = plain
        n, grown = 0, {}
        for label, scfg in variants.items():
            for b in PLACED_BATCHES:
                tag = f"{kind} {view} {label} B={b}"
                k, g, tg = against_twin(tag, placed, twin, scfg, pool[:b],
                                        sub if label == "subset" else None)
                n += k
                grown[f"{label}_b{b}"] = {"placed": g, "twin": tg}
        p50 = {}
        for b in PLACED_BATCHES:
            with refusing_gather(placed):
                p = p50_ms(lambda: placed.search(pool[:b], plain))
            p50[f"b{b}"] = {"placed": p, "twin": p50_ms(
                lambda: twin.search(pool[:b], plain))}
        launches += n
        report(card, phase=19, store=kind, view=view, rows=placed.num_valid,
               shards=8, store_bytes=store, placed_gathered=False,
               fit_sample=PLACED_TIER_SAMPLE, fit_iters=PLACED_TIER_ITERS,
               fit_s=fit_s, twin_fit_s=twin_fit_s, views_equal=True,
               equal_to_twin=True, variants=sorted(variants),
               peak_growth_bytes=grown, slack_bytes=PLACED_SLACK,
               search_p50_ms=p50, launches_pq_topk=n,
               reduced={"fit": f"sample {PLACED_TIER_SAMPLE} rows and "
                               f"{PLACED_TIER_ITERS} iterations (the "
                               f"reference's defaults: 262,144 and 15/10) "
                               f"to keep the phase near a minute"})
        if view == "pq":
            answers = {(label, b): twin.search(pool[:b], scfg)
                       for label, scfg in variants.items() if label != "subset"
                       for b in PLACED_BATCHES}
            with world_of_one() as dist:
                gmesh = make_mesh(8, devices=["cuda:0"] * 8,
                                  group=dist.group.WORLD)
                grp = Index.load(streams[kind], extractor=ex, mesh=gmesh)
                grp.pq, grp.cfg = placed.pq, placed.cfg
                if grp.placement.mesh.group is None:
                    fail("phase 19: the group-of-one mesh holds no group")
                for (label, b), (ts, ti) in answers.items():
                    with refusing_gather(grp):
                        (gs, gi), got = count_launches(
                            lambda: grp.search(pool[:b], variants[label]))
                    pieces = -(-b // plain.query_chunk)
                    if got["pq_topk"] < pieces or not grp.placed:
                        fail(f"phase 19: group of one, {label} B={b}: "
                             f"launches {got}, placed {grp.placed}")
                    if not (same_bits(gi, ti) and same_bits(gs, ts)):
                        fail(f"phase 19: group of one, {label} B={b}: the "
                             f"answers differ from the twin's")
                    groups += got["pq_topk"]
                report(card, phase=19, store=kind, view=view,
                       group_form=MP_GROUP_FORM,
                       backend=dist.get_backend(), equal_to_twin=True,
                       placed_gathered=False, launches_pq_topk=groups)
                del grp
        del placed, twin, sub
        torch.cuda.empty_cache()
    report(card, phase=19, seconds=time.perf_counter() - t_phase,
           launches_pq_topk=launches + groups)
    return {"launches": {"pq_topk": launches + groups}}


HBM_PUBLISHED_GBPS = 3350.0  # the card's published HBM3 rate
ROOF_SLACK = 1.05       # phase 20: a reading may pass the published rate or
#                         the measured roofline by 5% (the probe's own jitter)
BENCH_ALL_TIMEOUT = 600  # s, phase 20a's command
# phase 20c: bench_host_serve's rows, the reference's 67,108,864 cut 8-fold:
# its 32 GiB store file would take most of the phase's time to write; the
# 4 GiB one keeps the gather random over a file beyond the card's L2 and the
# host's caches alike (it is evicted for the cold read)
HOST_SERVE_ROWS = 1 << 23
# the reference's run_bench("all") keys, instsearch_tpu/bench.py:1885-1916
BENCH_ALL_KEYS = (
    "platform", "device", "extraction", "extraction_e2e", "query",
    "query_b128", "query_int8", "query_int8_b128", "query_int4",
    "query_int4_b128", "query_filtered", "query_e2e", "hbm_bw_gbps",
    "query_sweep", "qe", "qe_b128", "rerank", "rerank_b32", "diffusion",
    "refine", "lw", "lw_b32", "sharded_overhead", "protocol_eval_105k")
# the kernel each stage of the table in PERF.md §6 reaches ("yes")
BENCH_KERNELS = {
    "query": "topk_matmul", "query_b128": "topk_matmul",
    "query_int8": "topk_matmul_int8", "query_int8_b128": "topk_matmul_int8",
    "query_int4": "topk_matmul_int4", "query_int4_b128": "topk_matmul_int4",
    "query_filtered": "topk_matmul", "query_e2e": "topk_matmul",
    "query_sweep_65536": "topk_matmul", "query_sweep_262144": "topk_matmul",
    "qe": "topk_matmul", "qe_b128": "topk_matmul", "rerank": "topk_matmul",
    "rerank_b32": "topk_matmul", "diffusion": "topk_matmul",
    "refine": "topk_matmul_int4", "lw": "topk_matmul",
    "lw_b32": "topk_matmul", "sharded_overhead": "topk_matmul",
    "pq": "pq_topk", "pq_capacity": "pq_topk", "dba": "topk_matmul",
    "ivf": "topk_matmul", "ivfpq": "topk_matmul",
    "query_capacity_int8_4M": "topk_matmul_int8",
    "query_capacity_int4_8M": "topk_matmul_int4"}
BENCH_PATHS = ("kernel", "kernel-int8", "kernel-int4")


def check_bench(tag: str, out, seen=None) -> None:
    """Every ``p50_ms`` and ``images_per_sec`` finite and positive, every
    ``spread_ms`` ordered, every ``hbm_bw_gbps`` within ROOF_SLACK of the
    published rate, every ``frac_of_roofline`` within ROOF_SLACK of 1, and
    every ``path`` a kernel's, anywhere in a stage's output."""
    import math
    if isinstance(out, list):
        for i, v in enumerate(out):
            check_bench(f"{tag}[{i}]", v)
        return
    if not isinstance(out, dict):
        return
    for key, v in out.items():
        where = f"{tag}.{key}"
        if key in ("p50_ms", "images_per_sec", "step_ms", "rows_per_sec",
                   "images_per_sec_e2e", "e2e_p50_ms"):
            if not (isinstance(v, (int, float)) and math.isfinite(v)
                    and v > 0):
                fail(f"phase 20: {where} = {v}")
        elif key == "spread_ms" and not v[0] <= v[1]:
            fail(f"phase 20: {where} = {v} (p10 > p90)")
        elif key == "hbm_bw_gbps" and not (
                0 < v <= ROOF_SLACK * HBM_PUBLISHED_GBPS):
            fail(f"phase 20: {where} = {v} GB/s, past the card's "
                 f"{HBM_PUBLISHED_GBPS} x {ROOF_SLACK}")
        elif key == "frac_of_roofline" and not 0 < v <= ROOF_SLACK:
            fail(f"phase 20: {where} = {v}")
        elif key == "path" and v not in BENCH_PATHS:
            fail(f"phase 20: {where} = {v!r}: not a kernel's route")
        else:
            check_bench(where, v)


def bench_summary(card: str, tag: str, out: dict) -> None:
    """One report line of a stage's scalar numbers (and its per-batch
    entries', flattened)."""
    flat = {}
    for key, v in out.items():
        if isinstance(v, (int, float, str)) or key == "spread_ms":
            flat[key] = v
        elif key in ("per_batch", "recall_at_k_vs_nprobe",
                     "recall_at_k_vs_depth", "host_quality"):
            flat[key] = v
    report(card, phase=20, stage=tag, **flat)


def bench_kernels(tag: str, counts: dict) -> None:
    """The stage's kernel (``BENCH_KERNELS``) launched at least once."""
    want = BENCH_KERNELS.get(tag)
    if want is not None and counts.get(want, 0) < 1:
        fail(f"phase 20: {tag} launched no {want} ({counts})")


def phase20(card: str, timings: dict) -> dict:
    """The port's benchmark stages on the card (module docstring, item 20):
    (a) ``cli bench --what all`` as a process, (b) its bf16 query p50s
    against phase 1's K1 medians, (c) the other stages in process, once
    each. Returns ``{"launches": counts by kernel}``."""
    import torch

    from instsearch_torch import bench
    t_phase = time.perf_counter()
    launches: dict = {}

    # (a) the command a user runs, at the reference's sizes
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "instsearch_torch.cli", "bench", "--what",
         "all"], capture_output=True, text=True, cwd=HERE, env=cli_env(),
        timeout=BENCH_ALL_TIMEOUT)
    wall = time.perf_counter() - t0
    for ln in proc.stderr.splitlines():
        if ln.startswith("{"):          # the stages' progress lines
            report(card, phase=20, part="a", **json.loads(ln))
    if proc.returncode != 0:
        fail(f"phase 20: cli bench --what all exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        fail(f"phase 20: cli bench printed {len(lines)} JSON lines")
    out = json.loads(lines[0])
    missing = [k for k in BENCH_ALL_KEYS if k not in out]
    if missing:
        fail(f"phase 20: cli bench lacks the reference's keys {missing}")
    if out["platform"] != "cuda":
        fail(f"phase 20: cli bench ran on {out['platform']}")
    check_bench("all", {key: out[key] for key in BENCH_ALL_KEYS[2:]})
    for key in BENCH_ALL_KEYS[2:]:
        if isinstance(out[key], dict):
            bench_summary(card, key, out[key])
    for st in out["query_sweep"][:2]:
        bench_summary(card, f"query_sweep_{st['n']}", st)
    for tag, counts in out["kernel_launches"].items():
        bench_kernels(tag, counts)
        add_counts(launches, counts)
    report(card, phase=20, part="a", command_s=wall,
           hbm_bw_gbps=out["hbm_bw_gbps"], peak_gib=out.get("peak_gib"))

    # (b) the method measures the kernel: the marginal p50 of bench_query
    # against phase 1's single-call CUDA-event medians of K1
    for tag, shape in (("query", "bf16 N=1M D=512 B=1 k=10"),
                       ("query_b128", "bf16 N=1M D=512 B=128 k=10")):
        got, k1 = out[tag]["p50_ms"], timings[shape]["ms"]
        report(card, phase=20, part="b", stage=tag, bench_p50_ms=got,
               phase1_k1_ms=k1, ratio=got / k1)
        if not 0.5 <= got / k1 <= 2.0:
            fail(f"phase 20: {tag} p50 {got:.4f} ms against phase 1's K1 "
                 f"{k1:.4f} ms: past a factor of 2")

    # (c) the other stages, in process, once each
    dev = torch.device("cuda")
    stages = (
        ("pq", bench.bench_pq, {}),
        ("pq_capacity", bench.bench_pq_capacity, {}),
        ("ivf", bench.bench_ivf, {}),
        ("ivfpq", bench.bench_ivfpq, {}),
        ("ivfpq_capacity", bench.bench_ivfpq_capacity, {}),
        ("host_serve", bench.bench_host_serve, {"n": HOST_SERVE_ROWS}),
        ("dba", bench.bench_dba, {}),
        ("train", bench.bench_train, {}),
        ("query_capacity_int8_4M", bench.bench_query,
         {"n": 4_194_304, "dtype": "int8"}),
        ("query_capacity_int4_8M", bench.bench_query,
         {"n": 8_388_608, "dtype": "int4"}))
    results = {}
    for tag, fn, kw in stages:
        if tag == "host_serve":     # the deployment latency's ADC part
            kw = dict(kw, adc_chained_ms={
                b: e["p50_ms"] for b, e in
                results["ivfpq_capacity"]["per_batch"].items()})
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res, counts = count_launches(lambda: fn(device=dev, **kw))
        wall = time.perf_counter() - t0
        results[tag] = res
        check_bench(tag, res)
        bench_kernels(tag, counts)
        add_counts(launches, counts)
        bench_summary(card, tag, res)
        report(card, phase=20, part="c", stage=tag, wall_s=wall,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               launches={k: v for k, v in counts.items() if v})
        del res
        torch.cuda.empty_cache()
    if "production_p50_ms" not in results["host_serve"]:
        fail("phase 20: bench_host_serve composed no production_p50_ms")
    report(card, phase=20, wall_s=time.perf_counter() - t_phase,
           launches=launches)
    return {"launches": launches}


# phase 21: the capacity walkthrough's row counts, its default and the
# size its docstring names for a real drive (a 512 MiB int8 host file)
CAPACITY_ROWS = (65_536, 4_194_304)


def run_walkthrough(name: str, argv: list) -> tuple[list[str], dict, float]:
    """``examples/<name>.py``'s ``main(argv)`` in this process on the card,
    its printed lines captured -> (lines, kernel launches, wall seconds);
    the launches also hold K1's over an f32 store, ``topk_matmul_f32``.
    A non-zero return or an exception (the capacity script asserts its
    self-match) fails the phase."""
    import io
    import runpy
    main = runpy.run_path(os.path.join(HERE, "examples", f"{name}.py"))[
        "main"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc, counts = count_launches(lambda: main(argv))
    except Exception as e:          # noqa: BLE001 -- reported, then failed
        fail(f"phase 21: {name} {argv} raised {type(e).__name__}: {e}; "
             f"printed {buf.getvalue()[-2000:]}")
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 21: {name} {argv} returned {rc}")
    from instsearch_torch.kernels import topk_matmul
    counts["topk_matmul_f32"] = topk_matmul.launches_f32
    return buf.getvalue().strip().splitlines(), counts, wall


def _line_after(name: str, lines: list[str], prefix: str) -> str:
    hit = [ln[len(prefix):].strip() for ln in lines if ln.startswith(prefix)]
    if len(hit) != 1:
        fail(f"phase 21: {name} printed {len(hit)} lines {prefix!r}: "
             f"{lines}")
    return hit[0]


def phase21(card: str) -> dict:
    """The reference's three walkthroughs on the port
    (``examples/torch_*.py``, module docstring, item 21), in process on the
    card at their own sizes. Returns ``{"launches": counts by kernel}``."""
    import ast

    import torch
    t_phase = time.perf_counter()
    launches: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase21_")
    try:
        # vector ops: K1 over the bf16 and the f32 (l2) stores
        lines, counts, wall = run_walkthrough("torch_vector_ops", [])
        top1 = ast.literal_eval(_line_after("vector ops", lines, "top-1:")
                                .split(" scores:")[0])
        groups = ast.literal_eval(_line_after("vector ops", lines,
                                              "duplicate groups:"))
        if top1 != [0, 1, 2] or groups != [["im7", "im100"]]:
            fail(f"phase 21: vector ops top-1 {top1}, duplicate groups "
                 f"{groups}")
        if counts["topk_matmul"] < 1:
            fail(f"phase 21: vector ops launched no K1 ({counts})")
        add_counts(launches, counts)
        report(card, phase=21, script="torch_vector_ops", wall_s=wall,
               top1=top1, duplicate_groups=groups,
               launches={k: v for k, v in counts.items() if v}, lines=lines)
        torch.cuda.empty_cache()

        # end to end on the mini fixture: K2 over the int8 store
        data, work = os.path.join(tmp, "data"), os.path.join(tmp, "e2e")
        os.makedirs(work)
        lines, counts, wall = run_walkthrough(
            "torch_end_to_end", ["--data-root", data, "--workdir", work])
        from instsearch_torch.eval import load_dataset
        ds = load_dataset("mini", data)
        first = os.path.splitext(os.path.basename(ds.db_paths[0]))[0]
        got = [nm for nm, _ in ast.literal_eval(
            _line_after("end to end", lines, "query results:"))]
        filtered = [nm for nm, _ in ast.literal_eval(
            _line_after("end to end", lines, "filtered results:"))]
        if not got or got[0] != first:
            fail(f"phase 21: the query of {first} returned {got}")
        if not filtered or not set(filtered) <= set(ds.imlist[::2]):
            fail(f"phase 21: filtered answers {filtered} outside the subset")
        maps = {}
        for ln in lines:
            if " mAP " in ln:
                tag, rest = ln.split(" mAP ", 1)
                maps[tag.strip()] = float(rest.split()[0])
        ladder = {"base", "alpha-QE", "regional re-rank", "diffusion",
                  "re-rank + spatial", "local whitening",
                  "alpha-DBA (offline)"}
        if not ladder <= set(maps) or not all(0.0 <= v <= 100.0
                                              for v in maps.values()):
            fail(f"phase 21: the quality ladder's mAPs {maps}")
        if "reloaded: 56 rows, weights" not in lines:
            fail(f"phase 21: the reloaded index: {lines}")
        if counts["topk_matmul_int8"] < 1:
            fail(f"phase 21: end to end launched no K2 ({counts})")
        add_counts(launches, counts)
        report(card, phase=21, script="torch_end_to_end", wall_s=wall,
               top1=got[0], maps=maps,
               launches={k: v for k, v in counts.items() if v}, lines=lines)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()

        # capacity serving: the IVF-PQ cascade and ADC-only, torch ops
        for n in CAPACITY_ROWS:
            for flags in ([], ["--adc-only"]):
                work = os.path.join(tmp, "capacity")
                lines, counts, wall = run_walkthrough(
                    "torch_capacity_serving",
                    ["--n", str(n), "--workdir", work] + flags)
                resp = json.loads(next(ln for ln in lines
                                       if ln.startswith('{"results"')))
                top = resp["results"][0][0]
                if top["id"] != 7:
                    fail(f"phase 21: capacity n={n} {flags}: the "
                         f"self-match lost to {top}")
                add_counts(launches, counts)
                report(card, phase=21, script="torch_capacity_serving",
                       n=n, mode="adc-only" if flags else "cascade",
                       wall_s=wall, top1=top,
                       launches={k: v for k, v in counts.items() if v},
                       lines=lines)
                shutil.rmtree(work, ignore_errors=True)
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report(card, phase=21, wall_s=time.perf_counter() - t_phase,
           launches=launches)
    return {"launches": launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    for need in ("instsearch_torch", "configs"):
        if not os.path.isdir(os.path.join(HERE, need)):
            fail(f"run from a checkout of the repository ({need}/ not found "
                 f"beside this script)")
    sys.path.insert(0, HERE)
    from instsearch_torch.kernels import _build
    from instsearch_torch.kernels.fused_resnet import randomize_bn
    from instsearch_torch.models import get_backbone
    from instsearch_torch.kernels.pq_scan import (_lut, pq_table, pq_topk,
                                                  pq_topk_reference)
    from instsearch_torch.kernels.topk_matmul import (
        check_against_plain, check_exact, quantize_query, topk_matmul,
        topk_matmul_int4, topk_matmul_int4_reference, topk_matmul_int8,
        topk_matmul_int8_reference, topk_matmul_reference)
    from instsearch_torch.ops.quantize import quantize_rows, quantize_rows_int4

    # phase 0
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    report(card, phase=0, kernel_build_s=time.perf_counter() - t0,
           library=os.path.relpath(_build.library_path(), HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    err, timings = phase1(card, gen, topk_matmul, topk_matmul_reference,
                          check_against_plain)
    errs = {"bf16": err}
    for kind, fn, ref, quant in (
            ("int8", topk_matmul_int8, topk_matmul_int8_reference,
             quantize_rows),
            ("int4", topk_matmul_int4, topk_matmul_int4_reference,
             quantize_rows_int4)):
        errs[kind], t = phase1_int(card, gen, kind, fn, ref, quant,
                                   check_exact)
        timings.update(t)
    check_quantizer(card, gen, quantize_query)
    check_empty_slices(card, gen)
    check_pq_table(card, gen, pq_table, _lut)
    errs["pq"], t = phase1_pq(card, gen, pq_topk, pq_topk_reference,
                              check_exact)
    timings.update(t)
    att_errs, att_timings = phase1_attention(card, gen)
    resnet = get_backbone("resnet50")[0].init_weights(gen)
    randomize_bn(resnet, gen)
    fused_err, fused_timings = phase1_fused(card, gen, resnet)
    res = phase2(card, gen, topk_matmul, check_against_plain)
    res3, corpus = phase3(card, gen)
    res4 = phase4(card, corpus)
    # phase 12 needs phase 2's and phase 3's stores, which phase 10 mutates
    phase12(card, gen, res["state"], corpus)
    res5 = phase5(card, gen, topk_matmul)
    res5hr = phase5_highres(card, gen, res5.pop("weights"))
    res6 = phase6(card, gen, resnet)
    phase7(card, gen)
    del resnet
    res8a, vgg_corpus = phase8a(card, gen, topk_matmul, check_against_plain)
    res8b = phase8b(card, gen, topk_matmul, topk_matmul_reference,
                    check_against_plain, vgg_corpus)
    del vgg_corpus
    res8c = phase8c(card, corpus, topk_matmul_int4,
                    topk_matmul_int4_reference, check_exact)
    torch.cuda.empty_cache()
    res9, ox = phase9(card, gen, topk_matmul, topk_matmul_reference,
                      check_against_plain)
    res9c = phase9c(card, topk_matmul, topk_matmul_reference,
                    check_against_plain, ox)
    res10 = phase10(card, gen, res.pop("state"), res4.pop("index"), corpus,
                    check_against_plain, check_exact)
    torch.cuda.empty_cache()
    res11 = phase11(card, gen, topk_matmul, topk_matmul_reference,
                    check_against_plain, corpus, ox)
    torch.cuda.empty_cache()
    res15 = phase15(card, gen, topk_matmul, topk_matmul_reference,
                    topk_matmul_int8, topk_matmul_int8_reference,
                    check_against_plain, check_exact, ox)
    mesh = res15["launches"]
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase17_")
    try:
        res17 = phase17(card, ox, corpus, res15["c"]["host_peak"], tmp)
        torch.cuda.empty_cache()
        placed = phase18(card, ox, corpus[3],
                         res17["streams"])["launches"]
        torch.cuda.empty_cache()
        placed_tier = phase19(card, corpus, res17["streams"])["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    persist = res17["launches"]
    del corpus, ox
    torch.cuda.empty_cache()
    cli = phase13(card, gen)["launches"]
    torch.cuda.empty_cache()
    train = phase14(card, gen)["launches"]
    torch.cuda.empty_cache()
    phase16(card, gen)
    torch.cuda.empty_cache()
    bench = phase20(card, timings)["launches"]
    torch.cuda.empty_cache()
    examples = phase21(card)["launches"]
    phase8 = {"topk_matmul": res8a["launches"] + res8b["launches"],
              "topk_matmul_int4": res8c["launches"]}
    # the sharded routes' launches, on the main path too (phases 3, 8b, 9,
    # 9c; phase 9 has no single-device request)
    sharded = {"topk_matmul": res8b["sharded_launches"] + res9["launches"]
               + res9c["launches"],
               "topk_matmul_int8": res3["int8"]["sharded_launches"]}
    depth = {"topk_matmul": res8b["k1_depth"],
             "topk_matmul_int4": res8c["k3_depth"]}
    # phase 10's subset requests, every launch with the mask
    subset = {"topk_matmul": res10["a"]["launches_subset"],
              "topk_matmul_int8": res10["c"]["launches"],
              "topk_matmul_int4": res10["b"]["launches_k3"],
              "pq_topk": res10["b"]["launches_k4"]}
    # phase 11's quality tiers: the αDBA passes and the requests
    quality = {"topk_matmul": res11["a"]["launches"] + res11["b"]["launches"]
               + res11["c"]["launches"] + res11["d"]["launches_k1"],
               "topk_matmul_int8": res11["d"]["launches_k2"]}

    rows = []
    for name, file, replaces, shape, launches in (
            ("topk_matmul", "topk_matmul.cu", "topk_matmul.py:608",
             "bf16 N=1M D=512", res["launches"]),
            ("topk_matmul_int8", "topk_matmul_int.cu", "topk_matmul.py:475",
             "int8 N=1M D=512", res3["int8"]["launches"]),
            ("topk_matmul_int4", "topk_matmul_int.cu", "topk_matmul.py:397",
             "int4 N=1M D=512", res3["int4"]["launches"]),
            ("pq_topk", "pq_scan.cu", "pq_scan.py:223", "pq N=1M M=64",
             res4["launches"])):
        t = timings[f"{shape} B=1 k=10"]
        kind = shape.split()[0]
        rows.append({"name": name, "route": "cuda",
                     "source": f"instsearch_torch/csrc/{file}",
                     "replaces": f"instsearch_tpu/kernels/{replaces}",
                     **({"pass1": K1_PASS1} if name == "topk_matmul" else
                        {"pass1": INT_PASS1[name]} if name in INT_PASS1
                        else {}),
                     "launches": (launches + phase8.get(name, 0)
                                  + sharded.get(name, 0) + subset[name]
                                  + quality.get(name, 0) + cli.get(name, 0)
                                  + train.get(name, 0) + mesh.get(name, 0)
                                  + persist.get(name, 0)
                                  + placed.get(name, 0)
                                  + placed_tier.get(name, 0)
                                  + bench.get(name, 0)
                                  + examples.get(name, 0)),
                     "launches_phase8": phase8.get(name, 0),
                     "launches_sharded": sharded.get(name, 0),
                     "launches_subset": subset[name],
                     "launches_quality": quality.get(name, 0),
                     "launches_cli": cli.get(name, 0),
                     "launches_train": train.get(name, 0),
                     "launches_mesh": mesh.get(name, 0),
                     "launches_persist": persist.get(name, 0),
                     "launches_placed": placed.get(name, 0),
                     "launches_placed_tier": placed_tier.get(name, 0),
                     "launches_bench": bench.get(name, 0),
                     "launches_examples": examples.get(name, 0),
                     "max_abs_err": errs[kind],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
        t = timings[f"{shape} B=128 k=10"]      # the batched query's B
        rows[-1].update(ms_b128=t["ms"], plain_ms_b128=t["plain_ms"],
                        library_ms_b128=t["library_ms"],
                        bound_ms_b128=t["bound_ms"])
        if name == "topk_matmul_int8":   # phase 1's store, depth 100
            depth[name] = {b: timings[f"{shape} B={b} k={k}"]
                           for b, k in INT_TIMED if k == 100}
        for b, t in depth.get(name, {}).items():   # phase 8, depth 100
            rows[-1].update({f"ms_b{b}_k100": t["ms"],
                             f"plain_ms_b{b}_k100": t["plain_ms"],
                             f"library_ms_b{b}_k100": t["library_ms"],
                             f"bound_ms_b{b}_k100": t["bound_ms"]})
        if name == "topk_matmul":   # D = 2048, phase 11's shapes
            for b, k in QUALITY_K1:
                t = timings[f"bf16 N=1M D=2048 B={b} k={k}"]
                rows[-1].update({
                    f"{key}_d2048_b{b}_k{k}": t[key]
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
            # by store dtype: the f32 stores' launches on the main paths
            # (phase 15a's l2 store, phase 21's vector walkthrough), and
            # the f32 store's times (its bound by split TF32's three
            # products a pair; bound_ms_fma_... the CUDA cores')
            f32 = mesh.get("topk_matmul_f32", 0) + examples.get(
                "topk_matmul_f32", 0)
            rows[-1]["launches_by_store"] = {
                "bfloat16": rows[-1]["launches"] - f32, "float32": f32}
            for tag, shape in (("f32", "f32 N=1M D=512 B=1 k=10"),
                               ("f32_b128", "f32 N=1M D=512 B=128 k=10"),
                               ("f32_d136_b128_k256",
                                "f32 N=1M D=136 B=128 k=256")):
                t = timings[shape]
                rows[-1].update({f"ms_{tag}": t["ms"],
                                 f"plain_ms_{tag}": t["plain_ms"],
                                 f"library_ms_{tag}": t["library_ms"],
                                 f"bound_ms_{tag}": t["bound_ms_tf32x3"],
                                 f"bound_ms_fma_{tag}": t["bound_ms_fma"]})
        if name == "pq_topk":   # phase 4's bucket, and 64M rows at depth 100
            t = timings["pq N=1M M=64 B=8 k=100"]
            rows[-1].update(ms_b8_k100=t["ms"], plain_ms_b8_k100=t["plain_ms"],
                            bound_ms_b8_k100=t["bound_ms"])
            for b in (1, 128):
                t = timings[f"pq N=64M M=64 B={b} k=100"]
                rows[-1].update({f"ms_64m_b{b}_k100": t["ms"],
                                 f"bound_ms_64m_b{b}_k100": t["bound_ms"]})
    for name, replaces, shape, launches in (
            ("mha", "vit_attention.py:103", "mha bf16 [64, 12, 197, 64]",
             res5["mha_launches"]),
            ("flash_mha", "vit_attention.py:190",
             "flash_mha bf16 [1, 12, 16385, 64]", res5hr["flash_launches"])):
        t = att_timings[shape]
        rows.append({"name": name, "route": "cuda",
                     "source": "instsearch_torch/csrc/vit_attention.cu",
                     "replaces": f"instsearch_tpu/kernels/{replaces}",
                     "launches": (launches + train.get(name, 0)
                                  + examples.get(name, 0)),
                     "launches_cli": cli.get(name, 0),
                     "launches_train": train.get(name, 0),
                     "launches_examples": examples.get(name, 0),
                     "max_abs_err": att_errs[name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    t = att_timings["mha bf16 [64, 16, 197, 64]"]          # ViT-L/16's heads
    rows[-2].update(ms_h16=t["ms"], plain_ms_h16=t["plain_ms"],
                    library_ms_h16=t["library_ms"], bound_ms_h16=t["bound_ms"])
    t = att_timings["flash_mha bf16 [4, 12, 4097, 64]"]    # the 1024 px batch
    rows[-1].update(ms_b4=t["ms"], plain_ms_b4=t["plain_ms"],
                    library_ms_b4=t["library_ms"], bound_ms_b4=t["bound_ms"])
    t = fused_timings["layer2"]
    rows.append({"name": "fused_identity_blocks", "route": "cuda",
                 "source": "instsearch_torch/csrc/fused_resnet.cu",
                 "replaces": "instsearch_tpu/kernels/fused_resnet.py:138",
                 "launches": (res6["launches"]
                              + train.get("fused_identity_blocks", 0)
                              + examples.get("fused_identity_blocks", 0)),
                 "launches_cli": cli.get("fused_identity_blocks", 0),
                 "launches_train": train.get("fused_identity_blocks", 0),
                 "launches_examples": examples.get("fused_identity_blocks",
                                                   0),
                 "max_abs_err": fused_err,
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
